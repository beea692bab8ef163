#!/usr/bin/env python3
"""Drive the PyTorch port's search paths (flat index, IVF, streaming
stores and the graph index), its serving operations layer (the host
rerank tier, the guarded lifecycle, the coalescing frontend), its sharded
placement, the paper's baselines and its OI-13M configuration, the
recommenders' serving and candidate retrieval, and its LM serving paths
(dense and mixture-of-experts), and its training (the LMs at published
widths, MIND train-then-retrieve, the training CLI's drill, the GCN at
its four published graph shapes), and the step bundles of every serving
and search kind, then the dry run against those steps and the four
examples, on one NVIDIA GPU.

    python3 chip_smoke.py                  # the whole check
    python3 chip_smoke.py --kernels-only   # build + phase 2 only
    python3 chip_smoke.py --kernel-timing  # build + every kernel's time

Phases (any failure raises and the script exits non-zero):

1. Card and build: print the card, turn TF32 off, build the CUDA kernels
   from ``src/repro_torch/csrc`` (one nvcc per source, in parallel), and
   print every kernel's registers and spills (``-Xptxas -v``).
2. Kernels against their plain PyTorch versions at ragged shapes: M and N
   off the tiles, k in {1, 10, 49, 100, 200, 1000}, ip_topk at d in {1, 3,
   160, 512, 513, 516} (rows off 16-byte alignment), u8 and f32 codes,
   row_ids with -1, gathered and sorted layouts, IVF schedules with pad
   slots (middle, end, a whole row), slack blocks and k above the valid row
   count, exact ties, every kind of ``testing.IVF_SCHEDULES`` (bit for bit
   on integer data) and whole lists cut into pieces; the dense kernels
   (sq_dot, gleanvec_ip, dense gleanvec_sq) with layout blocks off the
   tile, ``scorer_scores`` of every scorer class with dead columns, and
   graph hops (u8 and f32, d in {160, 33}, S up to 4096, B in {96, 128,
   200}, pads, repeats, dead rows, in-beam candidates, half-empty beams,
   exact ties); whole graph traversals (graph_beam_search) bit for bit on
   integer data against their plain version (u8 and f32, d in {160, 33},
   B in {96, 128}, expand 1 and 4, pad edges, dead rows and a dead entry,
   a hit max_hops cap, exact ties, and the graph path's per-query shape
   (C 48, d 160, R 28, B 128, expand 4) in u8 and f32; ids, values and
   every query's hops);
   kmeans_assign at C up to 300 and D up to 7000 (a tie across
   tiles of centers); the gathered GleanVec path at C = 100 tags with an
   empty tag and with one tag (the bucketing bit for bit, top-k and dense);
   the sorted gleanvec_sq_topk and sq_dot on the pipelined scan bit for bit
   on integer data (layout blocks 1, 64, 200, 256, 512, 4096, k up to 200,
   u8 and f32, a tie across layout blocks of different tags; sq_dot at d in
   {1, 3, 160, 513} with rows off alignment; the sorted dense gleanvec_sq
   at layout blocks 1, 64, 200, 256, 768 and 4096 with ragged last blocks);
   flash_attention (S in {1, 77,
   100, 127, 128, 129, 130, 300, 4097}, dh in {8, 16, 20, 64, 72, 80, 96,
   120, 128}, GQA groups 1, 4, 5, 6 and 8 (5 and 6: the MoE prefills'
   heads at dh 128), window None / 1 / 48 / 127 / 128 / 129 / 4096, causal
   and not, bf16 and f32, transposed views; each case names the kernel it
   took and a digest of its output).
3. The flat main path: synthetic OOD data (D = 512), LeanVec-Sphering
   (d = 160) and GleanVec (C = 48, d = 160) fits, then for each of the 7
   scorer modes an encoded scorer behind a ServingEngine (batch 1024,
   k = 10, kappa = 100; kappa = 10 for ``full``) answering 5 batches, with
   QPS, p50, p99 and recall@10 against the mode's floor; sphering-int8
   once more at kappa = 200 (recall@10 beside kappa = 100's). Launch
   counters are zeroed just before and read just after.
3b. The IVF path on the same data and fit: an aligned IVF (the GleanVec
   clustering, nprobe = 12, reduced-space probe) in front of both sorted
   modes behind a ServingEngine (same batch, k, kappa, 5 batches), with
   the same readings and the counters zeroed just before and read just
   after, and a digest of the fine step's values and ids on the batch's
   probes (k = 100; two trees' runs compare bit for bit through it); then
   fused against gathered fine step on the first 200,000 rows.
3c. The stream (paper Section 3.2) on the same data: a fixed-capacity store
   of 2,000,000 slots holding the first 70 %, models fit on
   in-distribution queries, OOD traffic, then 3 cycles of serve one batch
   (recall@10 against the exact top-10 over the live rows, against its
   floor), ``scorer_scores`` + top-k against the fused scan on 64 queries,
   insert 200,000 rows, refresh and swap -- the six DR modes over the flat
   index, both sorted modes over the aligned IVF (nprobe 12, reduced probe)
   with 10,000 removes per cycle. Counters zeroed just before, read just
   after.
3d. The graph path on the first 1,000,000 rows, models of phase 3: the
   device build (k-NN self-join through ``ip_topk``, detour prune, reverse
   fill, entry points through ``kmeans_assign``), then beam search (beam
   128, max_hops 200, expand 4) behind a ServingEngine (batch 1024, k = 10,
   kappa = 100, 5 batches) with both sorted modes fused (the whole search
   of a batch one ``graph_beam_search`` launch, ``graph_scan_beam_step``
   never) and sphering gathered: QPS, p50, p99, recall@10 against the
   exact top-10 on the card and its floor, hops per batch, device kernels
   and host syncs a batch (none inside ``candidates`` on the fused path),
   the kernel's share of a batch; counters zeroed just before the build,
   and the kernel table's launches are those of the build, each mode's
   serving and the churn's updates and serving, each read just after it
   (the checks' launches are logged apart). The fused candidates and hops
   equal those
   of the per-hop loop (``_beam_loop`` through ``graph_scan_beam_step``) on
   the same batch. The fused gleanvec-int8-sorted graph once more with
   its rerank store demoted to host memory (as phase 3f's host tier).
   Then fused against gathered (one hop captured from the
   per-hop loop through kernel and plain version; whole traversals at
   expand 1 and 4), and churn on a streaming store: 10,000 removes, 2,000
   inserts linked by ``insert_ids``, ``refreshed``, swapped and served.
3f. The serving operations layer on phase 3's data and fits, counters
   zeroed just before and read just after (ip_topk, gleanvec_sq_topk,
   ivf_scan_topk and kmeans_assign must launch). The host rerank tier
   over flat gleanvec-int8-sorted, flat sphering-int8 and the aligned IVF
   (each on its own copy of the rows): 5 batches with the store on the
   card, ``demote_rerank_tier`` (device memory must fall by n * D * 4 B),
   the same 5 batches through the pipelined submit (ids equal bit for bit,
   ``host_bytes_ratio`` 1.00: the copies' bytes, added up copy by copy,
   equal the candidate rows'; the scan's timing is left out of the
   counts here and in 3d), with p50 / p99 / QPS of both tiers, the
   prefetch split into host gather and H2D copy, and the 5 batches' wall
   beside scan + prefetch. A guarded stream (capacity 2,000,000, 70 % to
   start, gleanvec-int8-sorted, store in host memory, a one-batch canary,
   min_overlap 0.3): 3 cycles of serve, insert 200,000 rows and
   ``RefreshSupervisor.refresh_and_swap`` (recall@10 against its floor,
   insert and refresh ms, every swap's ``memory_allocated`` delta, which
   must be 0), every lifecycle drill of ``faults.FAULTS`` (the snapshot
   drill on a store of the first 200,000 rows). The coalescing frontend
   over that engine with a ``RefreshWorker`` on its own CUDA stream: 4
   open-loop clients x 2,048 requests without a deadline (request p50 /
   p99, buckets, no refusal) and with a deadline of 2 x batch p50
   (``shed_rate``), dispatcher batches inside the worker's first and
   second full-width refresh (at least 1 each; p50 inside and outside),
   one batch of 8, 64 and 1024 through ``search_with`` alone and beside a
   1024-query loop of it on a side stream, coalesced ids equal to
   ``submit``'s in every bucket, and every drill of
   ``faults.FRONTEND_FAULTS``.
3g. The sharded placement (``distributed.build_sharded_index``) on phase
   3's data and fits: S = 4 shards (the reference CLI's ``--shards 4``)
   searched one after the other on the card, layout blocks 4096 as the
   single-device scorers, each run beside the single-device run of the
   same call (p50, p99, QPS, recall@10 against the path's floor, build s,
   peak device memory, launches a batch by kernel, stored rows, device
   time by kernel of one search): flat sphering-int8, gleanvec-int8-sorted
   and gleanvec-sorted, then the aligned IVF (nprobe 12, reduced probe)
   in both sorted modes, then the fused graph over the first 1,000,000
   rows (a device build a shard; host syncs a batch and none inside
   ``candidates``; fused against gathered per-shard graphs, overlap >=
   0.99). Each search kernel launches 4 times a batch. gleanvec-sorted's
   candidates equal the single-device ones (a row's encoding does not
   depend on its shard); the int8 modes fit their scales per shard, so
   theirs equal ``testing.sharded_as_one``'s scan, and the single-device
   sphering-int8 scorer in 4 row shards merges to its own scan. The host
   tier through ``build_sharded_artifacts(spill_host=True)`` (device
   memory freed n * D * 4, ids equal the device tier's, the gather ms of
   the per-shard buffers beside one ``HostStore``'s); ``refreshed`` +
   ``engine.swap`` on the IVF and the graph (ids unchanged). Its main-path
   launches are added to the kernel table's rows.
3h. The contract audit (``repro_torch.analysis``), counters zeroed just
   before and read just after (its launches are checks, not in the kernel
   table). (a) ``run.run_audit(device="cuda")``: the source lint, the
   protocol rules and the 35-cell serving matrix (7 modes x flat, IVF,
   graph, sharded, host-rerank) at the reference's small shapes, with the
   rule counts, every failure, and a line a topology with the most syncs,
   device kernels and peak memory above the start of its cells. (b) The
   trace rules at full width on the states of phases 3-3g: the flat path
   in 7 modes (no (1024, n_rows) buffer, 8.2 GB at 2M rows, and a peak
   below its bytes), the aligned IVF in both sorted modes (also no (1024,
   nprobe * max_len)), the fused graph (exactly one graph_search_kernel),
   the host tier (no (2M, 512) f32 buffer on the card), S = 4 shards (no
   (1024, rows of a shard)), every cell without a host sync in
   ``state_candidates``; ``SwapWithoutCopy`` on one stream cycle's swap.
   A failure ``run.KNOWN_DEVIATIONS`` does not list, or a listed one that
   passes, fails the phase.
4. Each kernel at its path's shapes and inputs: its time beside its bound,
   its plain version's time, the time of the composed PyTorch calls that
   compute the same function (``library_ms``), and its agreement with the
   plain version; kmeans_assign at C = 48 and 100; ip_topk's scan, fold and
   merge (flat linear modes, graph self-join); the gathered kernels'
   bucketing step on its own; the GleanVec top-k and sq_dot with their
   device time by kernel; ivf_scan_topk with its time at k = 1, its fold
   profile and its device time by kernel, the sorted top-k also at the
   stream's layout block 256 (its final sorted stores, with a digest of the
   dense sorted scores); graph_beam_search on each fused mode's batch
   beside its plain version and the gathered torch traversal.
3j. The paper's linear baselines and flexible d on phase 3's data (n =
   2M, D 512; d 160, C 48 from ``gleanvec-paper``): SVD, LeanVec-FW,
   LeanVec-ES, LeanVec-ES+FW (``core.baselines``, on the moments of the
   learning queries and all rows), LeanVec-Sphering, GleanVec, and the
   full-rotation model truncated to d in {64, 128, 160, 256}: each fit's
   seconds, ``metrics.leanvec_loss`` on a sample (and the same loss pair
   by pair), the objective each fit minimises (per learning pair, in
   f64), recall@10 through
   ``bruteforce.search`` (ip_topk) or ``search_gleanvec`` and the rerank
   at kappa 100 against phase 3's floors for the linear and GleanVec
   modes. The d = 160 truncation's candidates equal the direct d = 160
   fit's up to score ties; the two models' moments recomputed twice, the
   eigensolver run twice and their Stiefel factors by principal angles
   (ROADMAP C 5). The d = 160 scans' launches go to phase 3's
   rows; the truncations to d = 64, 128 and 256 get ip_topk rows of their
   own.
3i. The paper's configuration at full width, after phases 3-4's tensors
   are freed: ``gleanvec-paper``'s learn_oi13m (n = 13,000,000, D 512,
   10,000 learning queries; rows drawn on the card in chunks,
   ``data.vectors.make_dataset_device``, 26.6 GB, 3.1 x 2^31 elements):
   the exact top-10 through ``bruteforce.search`` (ip_topk over the full
   rows), GleanVec (C 48, d 160) and LeanVec-Sphering fits;
   search_oi13m (gathered, ``bruteforce.search_gleanvec``) and
   search_oi13m_sorted (``search_gleanvec_sorted``, ids through
   ``sort_by_tag``'s permutation), each layout freed before the next,
   batch 1024, k 10, kappa 100, the rerank over the full rows: p50, QPS,
   recall@10 against its floor, peak memory; each kernel's top-kappa
   against its plain version on 64 of the served queries; then the rows
   of gleanvec_sq_topk (both layouts), kmeans_assign and ip_topk at 13M
   for the kernel table (ip_topk's library yardstick is one (1024, 13M)
   f32 product, 53.2 GB beside the 26.6 GB of rows, with everything else
   freed first). search_rqa10m and search_t2i10m run in phase 3o.
3k. The recommenders at full width with random weights drawn on the
   card: MIND (4M items, D 64) user_embedding and ctr_loss at serve_p99
   (512) and serve_bulk (262,144, the in-batch softmax in chunks of
   users), then retrieval_cand: the first 1M items behind
   ``serve.retrieval`` in all seven modes (d 16, C 16, fits on 10,000
   users), ``retrieve`` at batch 1 and 512, k 10, kappa 100: p50 and
   recall@10 against mode full (a parity reading: the weights are
   random), mode full held against ``torch.topk``, each run's kernel row
   for the table; BST (4M x 32) and FM (3.9M x 10) the same serving and
   retrieval in mode full (BST also both sorted modes); DLRM's
   user_embedding (the bottom MLP, no table) at full width and its CTR
   forward at the smoke config (the full table, 96.1 GB in f32, fits no
   card).
3e. LM serving, after the search phases' tensors are freed: h2o-danube-
   3-4b at its published widths with random weights drawn on the card,
   ``generate`` at B = 4, s0 = 8192, n_new = 32 (greedy): prefill ms and
   tokens/s, decode ms per token, flash_attention launches (one per layer
   of the prefill, never the plain version, every one picking
   ``flash_wgmma_kernel``), peak device memory; the first decode step
   against a prefill over the same s0 + 1 tokens; the kernel's share of
   the prefill's device time and its launches there (``torch.profiler``,
   by the kernel's name: all of them ``flash_wgmma_kernel``); the kernel
   against its plain version on layer 0's captured q, k, v. Then phase 4's
   row of flash_attention at that shape, with
   ``scaled_dot_product_attention`` (a dense causal + window mask) as its
   library yardstick, and the same inputs without the window beside SDPA's
   flash backend at ``is_causal=True``.
3l. MoE serving, after phase 3e's weights are freed: grok-1-314b (8
   experts top-2, groups of 256) at its published widths cut to 4 of 64
   layers, then, once its weights are freed, llama4-maverick-400b-a17b
   (128 experts top-1, groups of 1024) cut to 1 of 48, random bf16
   weights drawn on the card; ``generate`` at B = 4, s0 = 4096, n_new = 16
   (cut from prefill_32k): prefill ms and tokens/s, decode ms per token,
   peak memory, each prefill layer's dropped token choices and expert
   load; flash_attention once per layer of the prefill, every launch
   ``flash_wgmma_kernel`` (GQA groups 6 and 5), never the plain version;
   the prompt kept and every logit finite; the last of the prompt's
   trailing tokens decoded one by one after a prefill over the rest
   against the prefill over all s0 (a prefill over s0 + 1 tokens does
   not cut into whole groups), asserted where no token choice was
   dropped; the prefill's time by part (flash_attention from
   ``torch.profiler``, expert products and routing / dispatch / combine
   from CUDA events) and a decode step's kernels; ``moe_apply`` on layer
   0's first group in bf16 against f32 compute, the f32 call against the
   CPU's, and at decode_32k's 128 tokens; flash_attention's kernel-table
   row at each prefill's shape beside SDPA's flash backend.
3m. Training, after phase 3l's weights are freed (random weights drawn on
   the card; every reading beside the card's name and power limit).
   (a) h2o-danube-3-4b at its published widths, all 24 layers: train_4k's
   seq 4096 with the batch cut from 256 to 4 (TRAIN_ACCUM 4: a microbatch
   of 1), AdamW, remat "nothing", 4 steps through ``make_train_step`` and
   ``train_loss``: ms, tokens/s, loss, grad norm, lr, peak memory and model
   TFLOP/s (6 x active x tokens + the attention term) a step, finite
   metrics and 0 host syncs in step 1 asserted; one microbatch's device
   time by kernel (``torch.profiler``); ``chunked_attention`` on layer 0's
   q, k, v against ``flash_attention`` at phase 2's attention tolerance;
   one full-width layer's loss and gradients at seq 256 against the CPU
   path. (b) qwen2-72b at its published widths cut from 80 to 2 layers,
   its own setup (Adafactor, TRAIN_ACCUM 8, loss_chunks 16), seq 4096,
   batch 8, 3 steps, the same readings and asserts. (c) MIND train-then-
   retrieve (``examples/train_recsys_retrieval.py`` at published widths):
   the train_batch bundle (65,536 users, AdamW lr 1e-3) for 5 steps, then
   GleanVec (d 16, C 16) fitted on the first 1,000,000 rows of the learned
   item table and ``serve.retrieval`` from the trained user tower at batch
   1 and 512 in modes full and gleanvec-sorted (p50, recall@10
   against full, kernel-table rows; ip_topk, gleanvec_sq_topk and
   kmeans_assign must launch). (d) ``python -m repro_torch.launch.train``
   on the card (danube smoke, 8 steps, checkpoints every 2): a run with
   REPRO_FAIL_AT_STEP=5 exits 42, its ``--resume`` ends where an
   uninterrupted run ends (final loss and step-8 state within DRILL_*).
3n. GNN training, after phase 3m's tensors are freed: gcn-cora at its
   published widths (2 layers, d_hidden 16) on each of its four published
   shapes with no cut -- full_graph_sm (Cora: 2,708 nodes, 10,556 edges,
   F 1433), ogb_products (2,449,029 nodes, 61,859,140 edges), minibatch_lg
   (232,965 nodes, 114,615,892 edges in CSR, 1,024 seeds, fanouts 15 /
   10) and molecule (128 graphs of 30 nodes and 64 edges) -- through
   ``build_bundle`` and its ``make_train_step`` on random weights and the
   training CLI's graphs drawn on the card (the graph maker timed apart): ms a
   step (median and max after the first), edges / seeds / graphs a second,
   peak GB, finite losses and grad norms, every step after the first under
   ``set_sync_debug_mode("error")``. Cora and minibatch_lg: the loss and
   every gradient on the card against the CPU path (the same draws);
   ogb_products: step 0's f32 loss against the same code in f64 on the
   card, the step's bandwidth bound (``gcn_step_bytes``) and its device
   time by kind of kernel. Then ``python -m repro_torch.launch.train
   --arch gcn-cora --shape minibatch_lg --steps 4`` on the card must exit
   0 and print its steps. The GNN reaches no kernel of the table.
3o. The step bundles of every serving and search kind, after phase 3n's
   tensors are freed, each cell through ``build_bundle`` (the GPU, the
   host mesh) on data drawn on the card from BUNDLE_SEED, each step's ms
   (median and max of 5 after a warm-up), rate, peak above its data and
   host syncs, each cell's data freed before the next. (a)
   ``gleanvec-paper``'s search_oi13m, search_oi13m_sorted, search_rqa10m
   (D 768) and search_t2i10m (d 192) at their published n (13,000,704 /
   10,002,432 rows, padded to 4096-row blocks), batch 1024, kappa 100, k
   10, the full rows their cluster's view plus N(0, 0.05^2) noise (so the
   rerank reorders the candidates): no host sync
   (``set_sync_debug_mode("error")``), one B1 launch a step (the counter
   and ``torch.profiler``, a session that records nothing taken again,
   up to PROFILE_SESSIONS),
   ids valid without repeats, each value its id's full-precision score,
   recall@10 against ``ip_topk`` over the full rows above the reduced
   scan's own top 10's, the step on the first 999,424 rows
   against the same step on the kernel's plain version; kernel-table rows
   at the RQA-10M and T2I-10M shapes. (b) learn_oi13m's data pass (n
   1,000,448, m 10,000, C 48, d 160): ms, the work done beside the
   reference's model flops, the centers and every cluster's A^T B against
   the same pass in f64; a kmeans_assign row. (c) h2o-danube-3-4b at its
   published widths, all 24 layers: prefill_32k with the batch cut from
   32 to 4 (tokens/s, model TFLOP/s, 24 ``flash_wgmma_kernel`` launches a
   step and their share of it), flash_attention's row at S 32768;
   decode_32k at batch 128 (48.3 GB of cache) and long_500k (pos 524,287,
   the ring's last slot) with a 0-d tensor ``pos``: no host sync, logits
   equal to the int pos's, the bandwidth bound. (d) BST, MIND, FM and DLRM
   (its table cut to DLRM_ROWS_CAP rows a field) serve_p99, serve_bulk
   and retrieval_cand (1,000,000 candidates); DLRM's
   ``make_sharded_lookup`` on a one-rank NCCL group over a (1, 1) mesh
   equal to ``embedding_lookup`` exactly, in its serve step too. Last, how
   many of 40 short ``torch.profiler`` sessions record no device event at
   that point of the process (a reading, not a check).
3p. The dry run (``repro_torch.launch.dryrun``) and the spec-sheet H100
   roofline (``repro_torch.utils.roofline.H100``, its HBM and SMs printed
   beside ``torch.cuda.get_device_properties(0)``), after 3o. (a) Every
   step phase 3o measured, traced on fake CUDA tensors of 3o's shapes on
   one device: the predicted bound (compute, memory) beside 3o's median,
   the predicted peak above the data beside 3o's; fails if a step ran
   faster than DRYRUN_BOUND_SLACK x its bound (a wrong count) or if the
   dry run's argument bytes differ from the bytes of the storages 3o
   allocated. (b) DRYRUN_CELLS (one a family) at full size on both
   production meshes, (16, 16) and (2, 16, 16), in the fake process group
   of 256 / 512 ranks: each record's trace seconds, bound and collectives.
   (c) ``examples/torch_{quickstart,serve_vector_search,
   streaming_updates,train_recsys_retrieval}.py`` at their defaults, each
   in a process of its own on the card, the four at once: rc 0, wall
   seconds, recall.

Then the card's name and power limit, one JSON line with the kernel table,
and the last line ``{"ok": true, "device": {...}}``.

Imports nothing of JAX and nothing of the JAX package. Needs a CUDA
device and the repository's ``src/repro_torch`` beside this file.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import hashlib
import importlib
import inspect
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, NamedTuple

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# Published H100 SXM rates (NVIDIA data sheet) used for the bounds: fp32
# outside the tensor cores, dense bf16 on the tensor cores, and HBM3
# bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

# Database rows of the main path: the paper's OI-13M widths with the
# database cut from 13M (PERF.md, "Cells").
N_ROWS = 2_000_000

# recall@10 floors of the main path (PERF.md, "Recall floors"): the JAX
# reference's own recall on the CPU at the same widths and smaller n, less
# the mode's own measured drop per decade of n and a 0.05 margin.
RECALL_FLOORS = {
    "full": 0.999,
    "sphering": 0.95,
    "gleanvec": 0.95,
    "sphering-int8": 0.126,
    "gleanvec-int8": 0.95,
    "gleanvec-sorted": 0.95,
    "gleanvec-int8-sorted": 0.95,
}

# recall@10 floors of the IVF path (PERF.md, "Recall floors"), set by the
# same rule from the reference's own IVF recall on the CPU.
IVF_RECALL_FLOORS = {"gleanvec-sorted": 0.95, "gleanvec-int8-sorted": 0.95}
IVF_NPROBE = 12
PARITY_ROWS = 200_000       # rows of the fused-vs-gathered check
WIDE_KAPPA = 200            # sphering-int8's second flat search (phase 3)

# The stream (phase 3c): 70 % of N_ROWS to start, then STREAM_CYCLES cycles
# of STREAM_INSERTS inserts (and STREAM_REMOVES removes on the IVF runs).
STREAM_N0 = 1_400_000
STREAM_CYCLES = 3
STREAM_INSERTS = 200_000
STREAM_REMOVES = 10_000
DENSE_CHECK_QUERIES = 64    # queries of the per-cycle scorer_scores check
# recall@10 floors per cycle (PERF.md, "Recall floors of the stream"), from
# the reference's own stream runs on the CPU: set before the first chip run
# from sizes up to 200,000, revised after it with the reference's runs at
# 500,000 (its recall falls faster beyond 200,000 than the smaller sizes
# showed); no port reading entered them.
STREAM_FLOORS = {
    "sphering": (0.136, 0.829, 0.828),
    "gleanvec": (0.0, 0.773, 0.777),
    "sphering-int8": (0.012, 0.230, 0.250),
    "gleanvec-int8": (0.0, 0.771, 0.776),
    "gleanvec-sorted": (0.0, 0.773, 0.777),
    "gleanvec-int8-sorted": (0.0, 0.771, 0.776),
}
STREAM_IVF_FLOORS = {"gleanvec-sorted": (0.0, 0.773, 0.777),
                     "gleanvec-int8-sorted": (0.0, 0.771, 0.776)}

# The serving operations layer (phase 3f) on phase 3's data and fits: the
# host rerank tier serves HOST_BATCHES batches of the main path's shape;
# the guarded stream uses the reference CLI's canary floor; the snapshot
# drill runs on a store of the first SNAPSHOT_ROWS rows (cut from the full
# store: two snapshots of it would write ~9 GB); the frontend takes
# FRONTEND_CLIENTS open-loop clients of FRONTEND_REQUESTS / FRONTEND_CLIENTS
# single-query requests each, and its drills the reference drills' traffic
# at a batch of FRONTEND_DRILL_BATCH.
HOST_BATCHES = 5
OPS_MIN_OVERLAP = 0.3
SNAPSHOT_ROWS = 200_000
FRONTEND_REQUESTS, FRONTEND_CLIENTS = 8192, 4
FRONTEND_DRILL_BATCH = 64

KERNEL_FILES = {
    "ip_topk": ("src/repro_torch/csrc/ip_topk.cu",
                "src/repro/kernels/ip_topk/ip_topk.py:94"),
    "gleanvec_sq_topk": ("src/repro_torch/csrc/gleanvec_sq.cu",
                         "src/repro/kernels/gleanvec_sq/gleanvec_sq.py:226"),
    "kmeans_assign": ("src/repro_torch/csrc/kmeans_assign.cu",
                      "src/repro/kernels/kmeans_assign/kmeans_assign.py:43"),
    "ivf_scan_topk": ("src/repro_torch/csrc/ivf_scan.cu",
                      "src/repro/kernels/ivf_scan/ivf_scan.py:145"),
    "sq_dot": ("src/repro_torch/csrc/dense_scores.cu",
               "src/repro/kernels/sq_dot/sq_dot.py:50"),
    "gleanvec_ip": ("src/repro_torch/csrc/dense_scores.cu",
                    "src/repro/kernels/gleanvec_ip/gleanvec_ip.py:70"),
    "gleanvec_sq": ("src/repro_torch/csrc/dense_scores.cu",
                    "src/repro/kernels/gleanvec_sq/gleanvec_sq.py:178"),
    "graph_scan_beam_step": ("src/repro_torch/csrc/graph_scan.cu",
                             "src/repro/kernels/graph_scan/graph_scan.py:177"),
    "graph_beam_search": ("src/repro_torch/csrc/graph_scan.cu",
                          "src/repro/kernels/graph_scan/graph_scan.py:177"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention/"
                        "flash_attention.py:109"),
}

# The sharded placement (phase 3g): the reference CLI's --shards 4 example,
# built as --shards builds it (build_sharded_index's default layout block,
# 256; the single-device runs keep build_scorer's 4096, as the CLI without
# --shards); each mode read beside its single-device run, SHARD_EXACT_MODES
# also checked equal to it (their rows' encodings do not depend on the
# shard; the int8 modes fit scales per shard and are checked against
# testing.sharded_as_one, the aligned IVF against per-shard builds).
SHARDS = 4
SHARD_FLAT_MODES = ("sphering-int8", "gleanvec-int8-sorted",
                    "gleanvec-sorted")
SHARD_IVF_MODES = ("gleanvec-int8-sorted", "gleanvec-sorted")
SHARD_EXACT_MODES = ("gleanvec-sorted",)
SHARD_HOST_MODE = "gleanvec-int8-sorted"

# The graph path (phase 3d): the first GRAPH_ROWS rows of phase 3's data
# (PERF.md, "Cells": the device build's self-join is cut from 2M), the
# reference CLI's degree (24 + 4 random edges, 16 entries), beam 128,
# max_hops 200, expand 4.
GRAPH_ROWS = 1_000_000
GRAPH_BEAM, GRAPH_HOPS, GRAPH_EXPAND = 128, 200, 4
# recall@10 floors (PERF.md, "Recall floors of the graph path"): set before
# the first chip run from the reference's own graph recall on the CPU
# (n = 5,000-20,000 GleanVec, 5,000-200,000 sphering) by the stream's rule:
# lowest recall - drop per decade (sphering's where it exceeds the mode's
# own) x decades left to 1M - 0.05.
GRAPH_RECALL_FLOORS = {"gleanvec-sorted": 0.857,
                       "gleanvec-int8-sorted": 0.857, "sphering": 0.840}
GRAPH_FUSED = ("gleanvec-sorted", "gleanvec-int8-sorted")
GRAPH_MIN_OVERLAP = 0.99    # fused vs gathered kappa-candidate overlap
GRAPH_MAX_RECALL_GAP = 0.005
CHURN_REMOVES, CHURN_INSERTS = 10_000, 2_000

# LM serving (phase 3e): h2o-danube-3-4b at its published widths, random
# weights from LM_SEED; batch and prompt cut from lm_common.LM_SHAPES
# "prefill_32k" (B = 32, S = 32768) for the run's time limit (PERF.md,
# "Cells"). The prompt is two windows (4096), so the window mask is active
# and the prefill's window fills the ring slots in order.
LM_ARCH = "h2o-danube-3-4b"
LM_BATCH, LM_PROMPT, LM_NEW, LM_SEED = 4, 8192, 32, 0
# the kernel the prefill's attention must take (bf16, dh 120, the
# transformer's (B, S, H, dh) views), by its name in the profiler
LM_FLASH_KERNEL = "flash_wgmma_kernel"
# first decode step against a prefill over the same s0 + 1 tokens, both in
# bf16 on the card: the reference's own bf16 tolerance for its LM
# (|a - b| <= 0.2 + 0.02 |b|), from bf16 roundings in another order
LM_LOGIT_RTOL, LM_LOGIT_ATOL = 2e-2, 2e-1

# MoE serving (phase 3l): grok-1-314b and llama4-maverick-400b-a17b at
# their published widths, random bf16 weights drawn on the card from
# MOE_SEED, the depth cut to fit one H100 80GB (experts a layer: grok-1
# 8 x 3 x 6144 x 32768 x 2 B = 9.66 GB, 4 layers ~42.5 GB with attention,
# embedding and head; maverick 128 x 3 x 5120 x 8192 x 2 B = 32.2 GB, 1
# layer ~36.5 GB, 2 would be 68.8 GB before activations); the prompt cut
# from prefill_32k as phase 3e's; one moe_apply at decode_32k's batch.
MOE_ARCHS = (("grok-1-314b", 4, "grok-1"),
             ("llama4-maverick-400b-a17b", 1, "maverick"))
MOE_BATCH, MOE_PROMPT, MOE_NEW, MOE_SEED = 4, 4096, 16, 26
MOE_DECODE_TOKENS = 128
# moe_apply in bf16 against f32 compute on the same inputs and weights
# (the router is f32 in both: the same choices). bf16 rounds the up and
# gate products, their product and the output, each to 2^-9 relative:
# about 2^-8 rms relative on a hidden unit, and the down product's sum of
# 8192-32768 such independent errors keeps that share of the output's rms
# (~0.4 %); the worst of ~1.5M outputs sits near 5.5 sigma, ~2 % of the
# rms. 5 % of the rms (12 sigma) plus the reference's bf16 rtol for the
# output's own rounding.
MOE_BF16_RTOL, MOE_BF16_ATOL_RMS = 2e-2, 5e-2
# the f32 call on the card against the CPU's: f32 sums of widths up to
# 32,768 in another order, ~1e-5 of the rms; ten times that
MOE_F32_RTOL, MOE_F32_ATOL_RMS = 1e-4, 1e-4
# The paper's configuration (phase 3i): gleanvec-paper's learn_oi13m and
# search_oi13m shapes as published (configs/gleanvec_paper.py), rows drawn
# on the card from PAPER_SEED; PAPER_BATCHES batches a layout; each
# kernel's top-kappa held against its plain version on CHECK_QUERIES of the
# served queries. recall@10 floor, set before the first run at 13M: phase
# 3's GleanVec floor (0.95 at 2M) less 0.05 for the 0.81 decade of n more.
PAPER_SEED, PAPER_BATCHES, CHECK_QUERIES = 13, 5, 64
PAPER_RECALL_FLOOR = 0.90
# The linear baselines (phase 3j) on phase 3's data: the loss on the first
# BASELINE_SAMPLE rows, the full-rotation model cut to each of
# BASELINE_TRUNCATIONS.
BASELINE_SAMPLE = 100_000
BASELINE_TRUNCATIONS = (64, 128, 160, 256)
# Recsys retrieval (phase 3k): d and C of the reduced modes, the batches
# of retrieval_cand (batch 1) and serve_p99 (512), the users the models
# learn from.
RETRIEVAL_D, RETRIEVAL_C, RETRIEVAL_BATCHES = 16, 16, (1, 512)
RECSYS_SEED, RECSYS_LEARN_USERS = 5, 10_000
# Training (phase 3m), random weights drawn on the card from TRAIN_SEED.
# (a) h2o-danube-3-4b at its published widths, all 24 layers: train_4k's
# seq 4096, its batch cut from 256 to 4 (its TRAIN_ACCUM 4 keeps a
# microbatch of 1), AdamW, remat "nothing", 4 steps. (b) qwen2-72b at its
# published widths cut from 80 to 2 layers (4.25 B parameters: the head
# and embedding hold 2.49 B of them), its own setup (Adafactor lr 1e-2,
# TRAIN_ACCUM 8, f32 accumulation, loss_chunks 16), seq 4096, batch 8, 3
# steps. (c) MIND's train_batch bundle for MIND_TRAIN_STEPS steps, then
# retrieval_cand over the learned items in MIND_TRAIN_MODES (phase 3k's d
# and C).
TRAIN_ARCH, TRAIN_DEPTH, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = (
    "h2o-danube-3-4b", 24, 4, 4096, 4)
QWEN_ARCH, QWEN_DEPTH, QWEN_BATCH, QWEN_STEPS = "qwen2-72b", 2, 8, 3
TRAIN_SEED = 27
MIND_TRAIN_STEPS = 5
MIND_TRAIN_MODES = ("full", "gleanvec-sorted")
# One full-width danube layer at seq TRAIN_CHECK_SEQ, batch 1, card
# against CPU in bf16 compute: the CPU parity tests' bf16 tolerance (the
# loss within 2e-3 relative, each gradient leaf within 4e-2 of its norm;
# bf16 roundings in another order: 1.6e-2 measured at the smoke widths).
TRAIN_CHECK_SEQ = 256
TRAIN_LOSS_RTOL, TRAIN_GRAD_RTOL = 2e-3, 4e-2
# The driver's drill (phase 3m (d), the smoke config, f32): a resumed run
# against an uninterrupted one. On the card the embedding's backward may
# add in another order, and Adam moves an element by about lr a step
# whatever its gradient's size, so an element may move otherwise by up to
# ~2 lr a step: lr <= 3e-4 * 8 / 100 (warm-up) over the 4 resumed steps,
# 2e-4; the loss within 1e-3 relative.
DRILL_ATOL, DRILL_LOSS_RTOL = 2e-4, 1e-3
# GNN training (phase 3n): gcn-cora at its published widths (2 layers,
# d_hidden 16) on each of its four published shapes, no cut, through
# build_bundle and its make_train_step; random weights and graphs drawn on
# the card from GNN_SEED; GNN_STEPS steps a shape.
GNN_SEED = 28
GNN_STEPS = {"full_graph_sm": 10, "ogb_products": 5, "minibatch_lg": 10,
             "molecule": 10}
# Card against CPU on the same weights and graph (Cora; minibatch_lg with
# the same draws): the CPU parity tests' f32 tolerances (f32 sums in
# another order: index_add's atomics, cuBLAS against the CPU's products).
GNN_LOSS_RTOL, GNN_GRAD_RTOL = 1e-5, 1e-4
# ogb_products' step-0 loss in f32 against the same code in f64 on the
# card: f32 sums of ~25 messages a node and widths <= 100, ~1e-6 relative.
GNN_F64_RTOL = 1e-5
# The step bundles of every serving and search kind (phase 3o): each cell
# through build_bundle on data drawn on the card from BUNDLE_SEED, its step
# timed BUNDLE_REPS times after a warm-up (median and max); the search
# steps also on a BUNDLE_CHECK_ROWS prefix against the kernel's plain
# version. gleanvec_sq_topk gets kernel-table rows at the RQA-10M and
# T2I-10M shapes (OI-13M's are phase 3i's rows). The prefill's batch is cut
# from 32 to PREFILL_BATCH (one MLP activation at 32 x 32768 x 10240 bf16
# is 21 GB); DLRM's table to DLRM_ROWS_CAP rows a field (14.9 GB of f32,
# 96.1 GB uncut). The data pass against f64 on the step's tags: the
# centers within LEARN_CENTER_TOL, each cluster's A^T B within
# LEARN_ATB_TOL of its norm (f32 moments of ~21,000 rows a cluster).
BUNDLE_SEED = 29
BUNDLE_REPS = 5
BUNDLE_CHECK_ROWS = 1_000_000
VS_ROW_CELLS = {"search_rqa10m": "rqa10m gathered D=768",
                "search_t2i10m": "t2i10m gathered d=192"}
PREFILL_BATCH = 4
DLRM_ROWS_CAP = 5_000_000
LEARN_CENTER_TOL, LEARN_ATB_TOL = 1e-5, 1e-3
# the search cells' full rows: their cluster's view of the reduced rows plus
# VS_NOISE N(0, 1) in every coordinate, so the rerank reorders the reduced
# scan's candidates. A profiled step whose events the profiler lost
# (``trace_rules.profile_kernels``: its pads not recorded on both sides) is
# profiled again in a new session, PROFILE_PAUSE_S later, up to
# PROFILE_SESSIONS sessions.
VS_NOISE = 0.05
PROFILE_SESSIONS = 15
PROFILE_PAUSE_S = 2.0
# Phase 3p: a measured 3o step faster than DRYRUN_BOUND_SLACK x the dry
# run's predicted bound means a wrong count; DRYRUN_CELLS are traced at
# full size on both production meshes, one a family.
DRYRUN_BOUND_SLACK = 0.9
DRYRUN_CELLS = (("gleanvec-paper", "search_oi13m"),
                ("h2o-danube-3-4b", "prefill_32k"),
                ("dlrm-mlperf", "serve_p99"), ("gcn-cora", "ogb_products"))
T_IMPORT = time.perf_counter()


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def timed(fn, reps: int):
    """Mean milliseconds of ``fn`` over ``reps`` back-to-back runs after two
    warm-ups, from CUDA events; returns (ms, last result). Two, so that the
    caching allocator holds a block for the result alive across a call and
    one for the next: a multi-GB output (the dense kernels' 8.2 GB) is
    otherwise allocated inside the timed runs (sq_dot on the stream's
    store read 40.8 ms with one warm-up, 19.6 with two, H100)."""
    out = fn()
    out = fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps, out


def timed_once(fn):
    """Milliseconds of a single run of ``fn`` (no warm-up)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end), out


def ptxas_summary(text: str) -> list:
    """One line per kernel of an ``nvcc -Xptxas -v`` log: the mangled
    entry name, its registers and its spill stores and loads; and ptxas's
    notes on wgmma (serialised pipelines) and setmaxnreg (ignored)."""
    out, name, spill = [], None, ""
    for ln in text.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1] if "'" in ln else ln.strip()
        elif "spill stores" in ln:
            spill = ln.strip()
        elif "Used" in ln and "registers" in ln and name:
            regs = ln.split("Used", 1)[1].split("registers")[0].strip()
            out.append(f"{name}: {regs} registers; {spill}")
            name, spill = None, ""
        elif "wgmma.mma_async" in ln or "setmaxnreg" in ln:
            out.append(f"  note: {ln.strip()}")
    return out


def bound_ms(flops: float, nbytes: float, peak: float = PEAK_FP32_FLOPS):
    t_ops = flops / peak * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def row_norm_max(x: torch.Tensor) -> float:
    x = x.reshape(-1, x.shape[-1])
    best = 0.0
    for s in range(0, x.shape[0], 1 << 20):
        best = max(best, float(torch.linalg.norm(
            x[s:s + (1 << 20)].to(torch.float32), dim=1).max()))
    return best


# ---------------------------------------------------------------------------
# Phase 2: kernels against plain versions at ragged shapes.
# ---------------------------------------------------------------------------


def check_topk(label, kernel_out, plain_out, tol, testing):
    rep = testing.assert_topk_close(kernel_out, plain_out, tol, label)
    log(f"  {label}: max_abs_err={rep['max_abs_err']:.3e} "
        f"max_rel_err={rep['max_rel_err']:.3e} "
        f"id_agreement={rep['id_agreement']:.4f} tol={tol:.3e}")
    return rep


def check_kmeans(label, x, centers, kernel_out, plain_out, testing):
    """Max similarities agree within the fp32 reordering bound; a tag may
    differ only where the plain version scores the kernel's center within
    that bound of its own maximum (a near-tie)."""
    tags_k, sims_k = kernel_out
    tags_p, sims_p = plain_out
    tol = testing.dot_tol(row_norm_max(x), row_norm_max(centers),
                          x.shape[1])
    err = float((sims_k - sims_p).abs().max())
    diff = torch.nonzero(tags_k != tags_p).squeeze(1)
    if diff.numel():
        alt = (x[diff].to(torch.float32)
               * centers[tags_k[diff].long()]).sum(dim=1)
        worst = float((sims_p[diff] - alt).abs().max())
    else:
        worst = 0.0
    agree = 1.0 - diff.numel() / max(1, tags_k.numel())
    log(f"  {label}: max_abs_err={err:.3e} tag_agreement={agree:.6f} "
        f"worst_tag_gap={worst:.3e} tol={tol:.3e}")
    if err > tol or worst > tol:
        raise AssertionError(f"{label}: kmeans_assign disagrees with its "
                             f"plain version beyond tol={tol:.3e}")
    return err


def phase_kernels(K, testing, gen):
    log("phase 2: kernels against plain versions at ragged shapes "
        "(tolerance: fp32 sums in another order, testing.dot_tol)")
    dev = torch.device("cuda")

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    def codes(n, d, u8):
        if u8:
            return torch.randint(0, 256, (n, d), generator=gen, device=dev,
                                 dtype=torch.uint8)
        return randn(n, d)

    # (130, 20011, 513, 49): the graph device build's self-join shape
    # before its rows were padded (unaligned rows: 4-byte copies); d = 516
    # after; d in {1, 3} and u8 at d = 513: 4-byte copies and byte loads
    for m, n, d, k, u8 in [(37, 5003, 160, 10, False),
                           (37, 5003, 160, 100, True),
                           (130, 20011, 512, 10, False),
                           (130, 20011, 513, 49, False),
                           (3, 50, 20, 100, False),
                           (1024, 4097, 516, 49, False),
                           (1000, 3001, 513, 100, True),
                           (1, 2999, 3, 1, False),
                           (1000, 5003, 1, 10, True),
                           (1024, 3001, 160, 200, True)]:
        q, x = randn(m, d), codes(n, d, u8)
        tol = testing.dot_tol(row_norm_max(q), row_norm_max(x), d)
        check_topk(f"ip_topk M={m} N={n} d={d} k={k} "
                   f"{'u8' if u8 else 'f32'}", K.ip_topk(q, x, k),
                   K.ip_topk_plain(q, x, k), tol, testing)
        if d == 516:                    # rows one row into x: not 16-B aligned
            check_topk(f"ip_topk M={m} N={n - 1} d={d} k={k} f32 rows off "
                       "16-byte alignment", K.ip_topk(q, x[1:], k),
                       K.ip_topk_plain(q, x[1:], k), tol, testing)

    for m, c, d, n, k, u8, masked in [(9, 48, 160, 7001, 100, True, True),
                                      (6, 5, 33, 3000, 10, False, False),
                                      (70, 8, 64, 2000, 100, False, True)]:
        qs, qlo = randn(m, c, d), randn(m, c)
        x = codes(n, d, u8)
        tags = torch.randint(0, c, (n,), generator=gen, device=dev,
                             dtype=torch.int32)
        rid = None
        if masked:
            rid = torch.arange(n, dtype=torch.int32, device=dev)
            drop = torch.rand(n, generator=gen, device=dev) < 0.1
            rid = torch.where(drop, torch.full_like(rid, -1), rid)
        tol = testing.dot_tol(row_norm_max(qs), row_norm_max(x), d,
                              float(qlo.abs().max()))
        check_topk(f"gleanvec_sq_topk gathered M={m} C={c} d={d} N={n} "
                   f"k={k} {'u8' if u8 else 'f32'} row_ids="
                   f"{'with -1' if masked else 'none'}",
                   K.gleanvec_sq_topk(qs, qlo, tags, x, k, row_ids=rid),
                   K.gleanvec_sq_topk_plain(qs, qlo, tags, x, k,
                                            row_ids=rid), tol, testing)

    for m, c, d, lb, nb, cut, k, u8 in [(70, 6, 160, 4096, 5, 0, 100, True),
                                        (5, 7, 48, 64, 40, 0, 10, False),
                                        (3, 4, 16, 200, 7, 37, 100, False)]:
        n = nb * lb - cut
        qs, qlo = randn(m, c, d), randn(m, c)
        x = codes(n, d, u8)
        btags = torch.randint(0, c, (nb,), generator=gen, device=dev,
                              dtype=torch.int32)
        perm = torch.randperm(n, generator=gen, device=dev).to(torch.int32)
        perm[torch.rand(n, generator=gen, device=dev) < 0.2] = -1
        tol = testing.dot_tol(row_norm_max(qs), row_norm_max(x), d,
                              float(qlo.abs().max()))
        check_topk(f"gleanvec_sq_topk sorted M={m} C={c} d={d} "
                   f"layout_block={lb} N={n} k={k} {'u8' if u8 else 'f32'}",
                   K.gleanvec_sq_topk(qs, qlo, btags, x, k, row_ids=perm,
                                      layout_block=lb),
                   K.gleanvec_sq_topk_plain(qs, qlo, btags, x, k,
                                            row_ids=perm, layout_block=lb),
                   tol, testing)

    # exact ties: identical rows must come out in ascending id order
    q, x = randn(4, 32), randn(1, 32).expand(1000, 32).contiguous()
    _, ids = K.ip_topk(q, x, 100)
    want = torch.arange(100, dtype=torch.int32, device=dev).expand(4, -1)
    if not torch.equal(ids, want):
        raise AssertionError("ip_topk: equal scores must break toward the "
                             "smaller id")
    log("  ip_topk exact ties: ids ascending as required")

    for m, c, d, lb, nb, cut, s, k, u8, slack in [
            (37, 48, 160, 4096, 7, 0, 5, 100, True, 1),
            (70, 7, 33, 200, 40, 37, 12, 10, False, 2),
            (130, 5, 48, 64, 9, 0, 6, 100, False, 0),
            (9, 3, 16, 32, 6, 5, 4, 100, True, 1)]:
        n = nb * lb - cut
        qs, qlo = randn(m, c, d), randn(m, c)
        x = codes(n, d, u8)
        btags = torch.randint(0, c, (nb,), generator=gen, device=dev,
                              dtype=torch.int32)
        rid = torch.randperm(n, generator=gen, device=dev).to(torch.int32)
        rid[torch.rand(n, generator=gen, device=dev) < 0.15] = -1
        if slack:
            rid[(nb - slack) * lb:] = -1           # all-padding slack blocks
        sched = torch.stack([torch.randperm(nb, generator=gen, device=dev)[:s]
                             for _ in range(m)]).to(torch.int32)
        sched[:, s // 2] = -1                      # pad slot in the middle
        sched[::2, -1] = -1                        # and at the end
        sched[1] = -1                              # an all-pad row
        tol = testing.dot_tol(row_norm_max(qs), row_norm_max(x), d,
                              float(qlo.abs().max()))
        got = K.ivf_scan_topk(qs, qlo, btags, rid, x, sched, k, lb)
        want = K.ivf_scan_topk_plain(qs, qlo, btags, rid, x, sched, k, lb)
        check_topk(f"ivf_scan_topk M={m} C={c} d={d} layout_block={lb} "
                   f"N={n} S={s} k={k} {'u8' if u8 else 'f32'} "
                   f"slack={slack}", got, want, tol, testing)
        if not torch.equal(got[1] < 0, want[1] < 0) \
                or not bool((got[1][1] == -1).all()):
            raise AssertionError("ivf_scan_topk: -1 ids differ from the "
                                 "plain version's")
    # exact ties: identical rows come out in ascending id order
    lb = 64
    x = randn(1, 16).expand(4 * lb, 16).contiguous()
    rid = torch.randperm(4 * lb, generator=gen, device=dev).to(torch.int32)
    sched = torch.tensor([[2, -1, 0], [3, 1, -1]], dtype=torch.int32,
                         device=dev)
    _, ids = K.ivf_scan_topk(randn(2, 1, 16), torch.zeros(2, 1, device=dev),
                             torch.zeros(4, dtype=torch.int32, device=dev),
                             rid, x, sched, 100, lb)
    for r, blocks in enumerate(([2, 0], [3, 1])):
        pool = torch.cat([rid[b * lb:(b + 1) * lb] for b in blocks])
        if not torch.equal(ids[r], torch.sort(pool).values[:100]):
            raise AssertionError("ivf_scan_topk: equal scores must break "
                                 "toward the smaller id")
    log("  ivf_scan_topk exact ties: ids ascending as required")

    # C up to 300 (three tiles of 100 centers), D up to 7000 and off 4
    for n, d, c in [(10007, 512, 48), (999, 100, 7), (300, 64, 64),
                    (3001, 7000, 300), (4097, 513, 129), (3001, 3, 7),
                    (999, 512, 1), (5000, 513, 100)]:
        x = randn(n, d)
        cent = randn(c, d)
        check_kmeans(f"kmeans_assign N={n} D={d} C={c}", x, cent,
                     K.kmeans_assign(x, cent), K.kmeans_assign_plain(x, cent),
                     testing)
    cent = randn(8, 64)
    cent[5] = cent[2]
    cent[7] = cent[2]
    x = cent[2].expand(50, 64).contiguous() + 0.0
    tags, _ = K.kmeans_assign(x, cent)
    if not bool((tags == 2).all()):
        raise AssertionError("kmeans_assign: a tie must go to the first "
                             "center")
    log("  kmeans_assign exact ties: first center wins")
    phase_wide_kernels(K, testing, gen)
    phase_ivf_kernels(K, testing, gen)
    phase_pipelined_kernels(K, testing, gen)
    phase_dense_kernels(K, testing, gen)
    phase_graph_kernels(K, testing, gen)
    phase_search_kernels(K, gen)
    phase_flash_kernels(K, testing, gen)


def phase_wide_kernels(K, testing, gen):
    """The shapes above the kernels' one-pass limits against the plain
    versions: top-k at k = 200 and 1000 (ip_topk, both gleanvec_sq_topk
    layouts, ivf_scan_topk; k above the row count), a beam of 200,
    kmeans_assign at C = 100 and 300 (a tie across tiles of centers), and
    the gathered GleanVec path at C = 100 tags with an empty tag and with a
    single tag: the bucketing (bit for bit), the fused top-k and the dense
    kernels; then exact ties through three passes."""
    dev = torch.device("cuda")
    gsq = importlib.import_module("repro_torch.kernels.gleanvec_sq")
    buffer_floats = gsq.DENSE_BUFFER

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    def codes(n, d, u8):
        if u8:
            return torch.randint(0, 256, (n, d), generator=gen, device=dev,
                                 dtype=torch.uint8)
        return randn(n, d)

    def tags_of(n, c, empty=None, single=None):
        if single is not None:
            return torch.full((n,), single, dtype=torch.int32, device=dev)
        t = torch.randint(0, c, (n,), generator=gen, device=dev,
                          dtype=torch.int32)
        if empty is not None:
            t[t == empty] = (empty + 1) % c
        return t

    for m, n, d, k, u8 in [(37, 5003, 160, 200, True),
                           (70, 20011, 160, 1000, False),
                           (3, 150, 20, 200, False)]:
        q, x = randn(m, d), codes(n, d, u8)
        tol = testing.dot_tol(row_norm_max(q), row_norm_max(x), d)
        check_topk(f"ip_topk M={m} N={n} d={d} k={k} "
                   f"{'u8' if u8 else 'f32'}", K.ip_topk(q, x, k),
                   K.ip_topk_plain(q, x, k), tol, testing)

    for m, c, d, n, k, u8, masked, empty, single in [
            (9, 100, 160, 7001, 200, True, True, 7, None),
            (70, 100, 64, 20011, 1000, False, True, None, None),
            (33, 48, 160, 9000, 200, False, False, None, 5),
            (5, 100, 33, 300, 200, True, False, 0, None)]:
        qs, qlo = randn(m, c, d), randn(m, c)
        x = codes(n, d, u8)
        tags = tags_of(n, c, empty, single)
        rid = None
        if masked:
            rid = torch.arange(n, dtype=torch.int32, device=dev)
            drop = torch.rand(n, generator=gen, device=dev) < 0.1
            rid = torch.where(drop, torch.full_like(rid, -1), rid)
        tol = testing.dot_tol(row_norm_max(qs), row_norm_max(x), d,
                              float(qlo.abs().max()))
        what = (f"C={c} d={d} N={n} {'u8' if u8 else 'f32'}"
                + (f" empty tag {empty}" if empty is not None else "")
                + (f" single tag {single}" if single is not None else ""))
        got = K.bucket_rows_by_tag(tags, c)
        want = K.bucket_rows_by_tag_plain(tags, c)
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"bucket_rows_by_tag {what}: differs from "
                                 "its plain version")
        log(f"  bucket_rows_by_tag {what}: equal to its plain version "
            f"({got[1].numel()} tiles)")
        check_topk(f"gleanvec_sq_topk gathered M={m} {what} k={k} row_ids="
                   f"{'with -1' if masked else 'none'}",
                   K.gleanvec_sq_topk(qs, qlo, tags, x, k, row_ids=rid),
                   K.gleanvec_sq_topk_plain(qs, qlo, tags, x, k,
                                            row_ids=rid), tol, testing)
        want = K.gleanvec_sq_plain(qs, qlo, tags, x)
        check_dense(f"gleanvec_sq gathered M={m} {what}",
                    K.gleanvec_sq(qs, qlo, tags, x), want, tol)
        gsq.DENSE_BUFFER = 1          # query chunks of 64 through the buffer
        try:
            check_dense(f"gleanvec_sq gathered M={m} {what} in chunks of 64 "
                        "queries", K.gleanvec_sq(qs, qlo, tags, x), want, tol)
        finally:
            gsq.DENSE_BUFFER = buffer_floats
        if not u8:
            check_dense(f"gleanvec_ip M={m} {what}",
                        K.gleanvec_ip(qs, tags, x),
                        K.gleanvec_ip_plain(qs, tags, x),
                        testing.dot_tol(row_norm_max(qs), row_norm_max(x), d))

    for m, c, d, lb, nb, cut, k, u8 in [(70, 6, 160, 4096, 5, 0, 200, True),
                                        (9, 7, 48, 64, 300, 37, 1000, False)]:
        n = nb * lb - cut
        qs, qlo = randn(m, c, d), randn(m, c)
        x = codes(n, d, u8)
        btags = torch.randint(0, c, (nb,), generator=gen, device=dev,
                              dtype=torch.int32)
        perm = torch.randperm(n, generator=gen, device=dev).to(torch.int32)
        perm[torch.rand(n, generator=gen, device=dev) < 0.2] = -1
        tol = testing.dot_tol(row_norm_max(qs), row_norm_max(x), d,
                              float(qlo.abs().max()))
        check_topk(f"gleanvec_sq_topk sorted M={m} C={c} d={d} "
                   f"layout_block={lb} N={n} k={k} {'u8' if u8 else 'f32'}",
                   K.gleanvec_sq_topk(qs, qlo, btags, x, k, row_ids=perm,
                                      layout_block=lb),
                   K.gleanvec_sq_topk_plain(qs, qlo, btags, x, k,
                                            row_ids=perm, layout_block=lb),
                   tol, testing)

    for m, c, d, lb, nb, cut, s, k, u8, slack in [
            (37, 48, 160, 4096, 7, 0, 5, 200, True, 1),
            (70, 7, 33, 200, 40, 37, 12, 1000, False, 2)]:
        n = nb * lb - cut
        qs, qlo = randn(m, c, d), randn(m, c)
        x = codes(n, d, u8)
        btags = torch.randint(0, c, (nb,), generator=gen, device=dev,
                              dtype=torch.int32)
        rid = torch.randperm(n, generator=gen, device=dev).to(torch.int32)
        rid[torch.rand(n, generator=gen, device=dev) < 0.15] = -1
        rid[(nb - slack) * lb:] = -1               # all-padding slack blocks
        sched = torch.stack([torch.randperm(nb, generator=gen, device=dev)[:s]
                             for _ in range(m)]).to(torch.int32)
        sched[:, s // 2] = -1
        sched[1] = -1                              # an all-pad row
        tol = testing.dot_tol(row_norm_max(qs), row_norm_max(x), d,
                              float(qlo.abs().max()))
        got = K.ivf_scan_topk(qs, qlo, btags, rid, x, sched, k, lb)
        want = K.ivf_scan_topk_plain(qs, qlo, btags, rid, x, sched, k, lb)
        check_topk(f"ivf_scan_topk M={m} C={c} d={d} layout_block={lb} "
                   f"N={n} S={s} k={k} {'u8' if u8 else 'f32'} "
                   f"slack={slack}", got, want, tol, testing)
        if not torch.equal(got[1] < 0, want[1] < 0):
            raise AssertionError("ivf_scan_topk: -1 ids differ from the "
                                 "plain version's")

    for m, c, d, lb, nb, s, b, u8, full in [
            (37, 48, 160, 256, 40, 112, 200, True, True),
            (9, 5, 33, 64, 50, 300, 200, False, False)]:
        args, lb = hop_inputs(gen, m, c, d, lb, nb, s, b, u8, full)
        check_hop(K, testing, f"graph_scan_beam_step M={m} C={c} d={d} "
                  f"layout_block={lb} N={lb * nb} S={s} B={b} "
                  f"{'u8' if u8 else 'f32'} beam={'full' if full else 'half'}",
                  args, lb)

    for n, d, c in [(10007, 512, 100), (999, 100, 100), (5000, 64, 129)]:
        x = randn(n, d)
        cent = randn(c, d)
        check_kmeans(f"kmeans_assign N={n} D={d} C={c}", x, cent,
                     K.kmeans_assign(x, cent), K.kmeans_assign_plain(x, cent),
                     testing)
    cent = randn(300, 64)
    cent[250] = cent[3]                       # in the third tile of centers
    cent[120] = cent[3]                       # and in the second
    x = cent[3].expand(50, 64).contiguous() + 0.0
    tags, _ = K.kmeans_assign(x, cent)
    if not bool((tags == 3).all()):
        raise AssertionError("kmeans_assign: a tie across tiles of centers "
                             "must go to the first center")
    log("  kmeans_assign C=300 exact ties across center tiles: first center "
        "wins")

    # exact ties through three passes: identical rows, ids ascending
    x = randn(1, 32).expand(1000, 32).contiguous()
    want = torch.arange(300, dtype=torch.int32, device=dev).expand(4, -1)
    _, ids = K.ip_topk(randn(4, 32), x, 300)
    tags = tags_of(1000, 100)
    qv = randn(4, 1, 32).expand(4, 100, 32).contiguous()
    _, ids_g = K.gleanvec_sq_topk(qv, torch.zeros(4, 100, device=dev), tags,
                                  x, 300)
    if not (torch.equal(ids, want) and torch.equal(ids_g, want)):
        raise AssertionError("ip_topk / gathered gleanvec_sq_topk at k=300: "
                             "equal scores must break toward the smaller id")
    log("  ip_topk and gathered gleanvec_sq_topk k=300 exact ties: ids "
        "ascending as required")


# (B, H, KV, S, dh, window, causal, dtype, strided): S off the 64-query
# tile (1, 77, 300, 4097), dh in {8, 16, 20, 64, 120, 128} (8 and 16 are
# the smoke configs', 20 takes the mma.sync kernel's unaligned loads, 120
# danube's, 128 the others'), group 1, 4 and 8, window None / 48 / 4096,
# causal and not, bf16 and f32, (B, S, H, dh) tensors passed transposed.
# bf16 with dh 72-128 takes the wgmma kernel: the rows after those put S
# and the window on its 128-query and 128-key tiles' edges (1, 127, 128,
# 129, 300, 4097; 1, 127, 128, 129, 4096) at dh 72, 80, 96, 120 and 128.
# The last six are the MoE prefills' heads (phase 3l): dh 128, causal, no
# window, GQA group 6 (grok-1's 48 / 8, an even group: the kernel's
# cluster of two heads) and 5 (maverick's 40 / 8, odd), S 129, 300 and
# 4097 off the tiles, half of them transposed.
FLASH_CASES = [
    (1, 4, 4, 1, 16, None, True, torch.float32, False),
    (2, 8, 2, 77, 64, None, True, torch.bfloat16, False),
    (1, 8, 1, 300, 120, 48, True, torch.bfloat16, True),
    (2, 4, 4, 300, 128, None, False, torch.float32, True),
    (1, 32, 8, 4097, 120, 4096, True, torch.bfloat16, True),
    (1, 8, 1, 300, 16, 48, False, torch.bfloat16, False),
    (2, 16, 2, 77, 120, 48, True, torch.float32, False),
    (1, 4, 1, 4097, 64, 4096, True, torch.float32, True),
    (1, 8, 2, 130, 8, None, True, torch.bfloat16, False),
    (1, 4, 2, 100, 20, None, True, torch.bfloat16, True),
    (2, 8, 8, 77, 128, None, False, torch.bfloat16, False),
    (1, 4, 2, 300, 20, 48, True, torch.float32, False),
    (2, 8, 2, 1, 120, None, True, torch.bfloat16, True),
    (2, 8, 2, 127, 120, 1, True, torch.bfloat16, True),
    (2, 8, 8, 128, 72, 127, True, torch.bfloat16, False),
    (2, 8, 1, 129, 128, 128, True, torch.bfloat16, True),
    (2, 8, 2, 300, 120, 129, True, torch.bfloat16, True),
    (2, 4, 4, 129, 96, 129, False, torch.bfloat16, False),
    (1, 16, 2, 300, 80, None, False, torch.bfloat16, True),
    (2, 8, 2, 4097, 128, 129, True, torch.bfloat16, False),
    (2, 32, 8, 4097, 120, 4096, True, torch.bfloat16, True),
    (1, 48, 8, 129, 128, None, True, torch.bfloat16, False),
    (2, 48, 8, 300, 128, None, True, torch.bfloat16, True),
    (1, 48, 8, 4097, 128, None, True, torch.bfloat16, False),
    (1, 40, 8, 129, 128, None, True, torch.bfloat16, True),
    (2, 40, 8, 300, 128, None, True, torch.bfloat16, False),
    (1, 40, 8, 4097, 128, None, True, torch.bfloat16, True),
]


def phase_ivf_kernels(K, testing, gen):
    """ivf_scan_topk on every kind of probe schedule the kernel must take
    (``testing.IVF_SCHEDULES``: whole lists, a pad slot inside a list,
    non-contiguous blocks, a tag change inside consecutive blocks, a
    duplicated block and list, all pad, no queries, 256-row layout blocks
    with slack blocks), u8 and f32, k in {1, 10, 100, 200}: on random data
    against the plain version, on small integers bit for bit against the
    exact top-k (``testing.exact_ivf_topk``). Then whole lists of 4096-row
    blocks at M = 300, C = 48, d = 160 (long runs cut into pieces, a skewed
    probe) at k = 100 and 200 against the plain version."""
    dev = torch.device("cuda")
    for kind in testing.IVF_SCHEDULES:
        for u8 in (False, True):
            worst = 0.0
            for integer in (False, True):
                args = testing.ivf_schedule_case(kind, u8, seed=11,
                                                 integer=integer)
                lb = args[6]
                t = [torch.from_numpy(a).to(dev) for a in args[:6]]
                for k in (1, 10, 100, 200):
                    got = K.ivf_scan_topk(*t, k, lb)
                    if t[0].shape[0] == 0:
                        if got[0].shape != (0, k) or got[1].shape != (0, k):
                            raise AssertionError("ivf_scan_topk: M = 0 "
                                                 "gives the wrong shapes")
                    elif integer:
                        want = testing.exact_ivf_topk(*t, k, lb)
                        if not (torch.equal(got[0], want[0])
                                and torch.equal(got[1], want[1])):
                            raise AssertionError(
                                f"ivf_scan_topk {kind} "
                                f"{'u8' if u8 else 'f32'} k={k}: not the "
                                "exact top-k on integer data")
                    else:
                        tol = testing.dot_tol(row_norm_max(t[0]),
                                              row_norm_max(t[4]),
                                              t[4].shape[1],
                                              float(t[1].abs().max()))
                        want = K.ivf_scan_topk_plain(*t, k, lb)
                        rep = testing.assert_topk_close(
                            got, want, tol, f"ivf_scan_topk {kind} k={k}")
                        worst = max(worst, rep["max_abs_err"])
                        if not torch.equal(got[1] < 0, want[1] < 0):
                            raise AssertionError(
                                f"ivf_scan_topk {kind} k={k}: -1 ids differ "
                                "from the plain version's")
            log(f"  ivf_scan_topk schedule={kind} {'u8' if u8 else 'f32'} "
                f"k in (1, 10, 100, 200): max_abs_err={worst:.3e} against "
                "the plain version, bit for bit on integer data")
    from repro_torch.core.scorer import _list_block_ranges
    m, c, d, lb = 300, 48, 160, 4096
    sizes = torch.randint(1, 8, (c,), generator=gen, device=dev)
    btags = torch.repeat_interleave(torch.arange(c, device=dev),
                                    sizes).to(torch.int32)
    nb = btags.numel()
    rid = torch.randperm(nb * lb, generator=gen, device=dev).to(torch.int32)
    rid[torch.rand(nb * lb, generator=gen, device=dev) < 0.05] = -1
    weight = 1.0 / torch.arange(1, c + 1, device=dev, dtype=torch.float32)
    probe = torch.multinomial(weight.expand(m, c), IVF_NPROBE,
                              generator=gen)
    sched = _list_block_ranges(btags, c)[probe].reshape(m, -1)
    qs = torch.randn(m, c, d, generator=gen, device=dev)
    qlo = torch.randn(m, c, generator=gen, device=dev)
    for u8 in (False, True):
        x = (torch.randint(0, 256, (nb * lb, d), generator=gen, device=dev,
                           dtype=torch.uint8) if u8 else
             torch.randn(nb * lb, d, generator=gen, device=dev))
        tol = testing.dot_tol(row_norm_max(qs), row_norm_max(x), d,
                              float(qlo.abs().max()))
        for k in (100, 200):
            args = (qs, qlo, btags, rid, x, sched, k, lb)
            check_topk(f"ivf_scan_topk whole lists M={m} C={c} d={d} "
                       f"layout_block={lb} N={nb * lb} S={sched.shape[1]} "
                       f"k={k} {'u8' if u8 else 'f32'}",
                       K.ivf_scan_topk(*args), K.ivf_scan_topk_plain(*args),
                       tol, testing)
        del x


def check_flash(K, testing, label, q, k, v, causal, window):
    """The kernel against its plain version on the same inputs
    (``testing.attention_error``'s tolerance); returns the largest gap."""
    before = K.flash_attention.launches
    got = K.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    if K.flash_attention.launches != before + 1:
        raise AssertionError(f"{label}: the kernel was not launched")
    want = K.flash_attention_plain(q, k, v, causal=causal, window=window)
    err, used = testing.attention_error(
        got, want, testing.attention_abs_mix(q, k, v, causal, window))
    log(f"  flash_attention[{label}] {flash_kernel_name(q, k, v)}: "
        f"max_abs_err={err:.3e} (worst element at {used:.3f} of its "
        f"tolerance), digest {digest(got)}")
    if used > 1:
        raise AssertionError(f"flash_attention[{label}]: kernel and plain "
                             "version disagree")
    return err


def phase_flash_kernels(K, testing, gen):
    """flash_attention against its plain version at ragged shapes."""
    dev = torch.device("cuda")
    for b, h, kv, s, dh, window, causal, dtype, strided in FLASH_CASES:
        def make(heads):
            if strided:                 # (B, S, heads, dh) viewed (B, heads, S, dh)
                return torch.randn(b, s, heads, dh, generator=gen,
                                   device=dev).to(dtype).transpose(1, 2)
            return torch.randn(b, heads, s, dh, generator=gen,
                               device=dev).to(dtype)
        q, k, v = make(h), make(kv), make(kv)
        label = (f"B={b} H={h} KV={kv} S={s} dh={dh} window={window} "
                 f"causal={causal} {str(dtype)[6:]}"
                 f"{' strided' if strided else ''}")
        check_flash(K, testing, label, q, k, v, causal, window)


def hop_inputs(gen, m, c, d, lb, nb, s, b, u8, full):
    """Random inputs of one graph hop on the card: pad slots (-1) anywhere,
    repeated neighbor rows, dead rows (``row_ids`` -1), candidates already
    in the beam (the beam is drawn from rows, and some of those rows are
    among each query's neighbors), and a beam that is full or half empty
    (-1 ids at NEG_INF). Returns the wrapper's positional arguments and
    ``layout_block``."""
    dev = torch.device("cuda")
    n = lb * nb
    qs = torch.randn(m, c, d, generator=gen, device=dev)
    qlo = torch.randn(m, c, generator=gen, device=dev)
    btags = torch.randint(0, c, (nb,), generator=gen, device=dev,
                          dtype=torch.int32)
    rid = torch.randperm(n, generator=gen, device=dev).to(torch.int32)
    rid[torch.rand(n, generator=gen, device=dev) < 0.1] = -1
    codes = (torch.randint(0, 256, (n, d), generator=gen, device=dev,
                           dtype=torch.uint8) if u8
             else torch.randn(n, d, generator=gen, device=dev))
    nbr = torch.randint(0, n, (m, s), generator=gen, device=dev,
                        dtype=torch.int32)
    nbr[torch.rand(m, s, generator=gen, device=dev) < 0.15] = -1
    nbr[:, 1::7] = nbr[:, :1]                     # repeated rows
    beam_rows = torch.rand(m, n, generator=gen, device=dev).argsort(
        dim=1)[:, :b].to(torch.int32)
    nbr[:, 2:6] = beam_rows[:, :4]                # candidates in the beam
    beam_ids = rid[beam_rows.long()]
    beam_vals = 3 * torch.randn(m, b, generator=gen, device=dev)
    if not full:
        beam_ids[:, b // 2:] = -1
    beam_vals = torch.where(beam_ids >= 0, beam_vals,
                            torch.full_like(beam_vals, -3.4e38))
    return (qs, qlo, btags, rid, codes, nbr, beam_vals, beam_ids), lb


def check_hop(K, testing, label, args, lb):
    """The kernel against its plain version on the same hop: the top-B
    lists within ``testing.dot_tol``, the -1 slots in the same places."""
    got = K.graph_scan_beam_step(*args, layout_block=lb)
    want = K.graph_scan_beam_step_plain(*args, layout_block=lb)
    qs, qlo, codes = args[0], args[1], args[4]
    tol = testing.dot_tol(row_norm_max(qs), row_norm_max(codes),
                          qs.shape[2], float(qlo.abs().max()))
    rep = check_topk(label, got, want, tol, testing)
    if not torch.equal(got[1] < 0, want[1] < 0):
        raise AssertionError(f"{label}: -1 ids differ from the plain "
                             "version's")
    return rep


def phase_graph_kernels(K, testing, gen):
    """graph_scan_beam_step against its plain version: u8 and f32, d in
    {160, 33} (16-byte loads and the ragged path), S in {28, 112, 300, 4096}
    (expand 1, expand 4, wide, the largest taken), B in {96, 128}, full and
    half-empty beams, with pads, repeats, dead rows and in-beam candidates
    in every case; then exact ties."""
    dev = torch.device("cuda")
    for m, c, d, lb, nb, s, b, u8, full in [
            (37, 48, 160, 256, 40, 28, 128, True, True),
            (70, 7, 33, 100, 30, 112, 96, False, False),
            (9, 5, 160, 64, 50, 300, 128, False, False),
            (130, 3, 33, 37, 60, 112, 128, True, True),
            (64, 48, 160, 4096, 3, 112, 96, False, True),
            (3, 4, 64, 128, 64, 4096, 128, True, False)]:
        args, lb = hop_inputs(gen, m, c, d, lb, nb, s, b, u8, full)
        check_hop(K, testing, f"graph_scan_beam_step M={m} C={c} d={d} "
                  f"layout_block={lb} N={lb * nb} S={s} B={b} "
                  f"{'u8' if u8 else 'f32'} beam={'full' if full else 'half'}",
                  args, lb)
    # exact ties: identical rows score alike; the smaller id wins, as the
    # plain version orders them
    n, d = 512, 16
    x = torch.randn(1, d, generator=gen, device=dev).expand(n, d).contiguous()
    rid = torch.randperm(n, generator=gen, device=dev).to(torch.int32)
    nbr = torch.randperm(n, generator=gen, device=dev)[:300].to(
        torch.int32).expand(2, 300).contiguous()
    args = (torch.randn(2, 1, d, generator=gen, device=dev),
            torch.zeros(2, 1, device=dev),
            torch.zeros(n // 64, dtype=torch.int32, device=dev), rid, x, nbr,
            torch.full((2, 128), -3.4e38, device=dev),
            torch.full((2, 128), -1, dtype=torch.int32, device=dev))
    got = K.graph_scan_beam_step(*args, layout_block=64)
    want = K.graph_scan_beam_step_plain(*args, layout_block=64)
    pool = torch.sort(rid[nbr[0].long()]).values[:128]
    if not (torch.equal(got[1], want[1]) and torch.equal(got[1][0], pool)):
        raise AssertionError("graph_scan_beam_step: equal scores must "
                             "break toward the smaller id")
    log("  graph_scan_beam_step exact ties: ids ascending as required")


def search_inputs(gen, m, c, d, lb, nb, r, b, u8, ties=False):
    """Integer inputs of a whole traversal on the card (every score exact
    in fp32 in any order): a table of r sorted rows per vertex with -1
    edges, repeated edges and dead rows (``row_ids`` -1); an entry beam of
    16 ids in slot order with a -1 entry and a dead entry (id >= 0 at
    NEG_INF, as ``score_ids`` scores a removed id), the rest -1. ``ties``:
    every row holds the same codes, so every score ties. Returns the
    wrapper's positional arguments and ``layout_block``."""
    dev = torch.device("cuda")
    n = lb * nb

    def ints(lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=gen, device=dev)

    qs, qlo = ints(-3, 4, m, c, d).float(), ints(-50, 51, m, c).float()
    btags = ints(0, c, nb).to(torch.int32)
    rid = torch.randperm(n, generator=gen, device=dev).to(torch.int32)
    rid[torch.rand(n, generator=gen, device=dev) < 0.1] = -1
    codes = ints(0, 4, 1 if ties else n, d)
    codes = codes.to(torch.uint8) if u8 else codes.float() - 2
    codes = codes.expand(n, d).contiguous()
    tbl = ints(0, n, n, r).to(torch.int32)
    tbl[torch.rand(n, r, generator=gen, device=dev) < 0.15] = -1
    tbl[:, 1] = tbl[:, 0]                          # repeated edges
    entries = torch.randperm(n, generator=gen, device=dev)[:16].to(
        torch.int32)
    bi = torch.full((m, b), -1, dtype=torch.int32, device=dev)
    bi[:, :16] = entries
    bi[:, 5] = -1
    bv = ints(-500, 501, m, b).float()
    bv = torch.where(bi >= 0, bv, torch.full_like(bv, -3.4e38))
    bv[:, 9] = -3.4e38                             # a dead entry
    return (qs, qlo, btags, rid, codes, tbl, bv, bi), lb


def phase_search_kernels(K, gen):
    """graph_beam_search against its plain version on integer data: the
    beams (values and ids) and every query's hop count bit for bit, u8 and
    f32, d in {160, 33}, B in {96, 128}, expand 1 and 4, layout blocks on
    and off the tile, a max_hops cap that stops every query, and exact ties
    everywhere; the first two cases are the graph path's per-query shape
    (C 48, d 160, layout block 256, R 28, B 128, expand 4)."""
    for m, c, d, lb, nb, r, b, e, u8, hops, ties in [
            (37, 48, 160, 256, 40, 28, 128, 4, True, 200, False),
            (64, 48, 160, 256, 40, 28, 128, 4, False, 200, False),
            (70, 7, 33, 100, 30, 28, 96, 1, False, 200, False),
            (130, 5, 160, 64, 50, 24, 128, 4, False, 3, False),
            (9, 3, 33, 37, 60, 28, 96, 4, True, 200, False),
            (64, 4, 160, 4096, 3, 28, 128, 1, True, 40, False),
            (20, 6, 160, 64, 40, 28, 128, 4, False, 200, True),
            (11, 3, 33, 64, 40, 28, 96, 1, True, 200, True)]:
        args, lb = search_inputs(gen, m, c, d, lb, nb, r, b, u8, ties)
        got = K.graph_beam_search(*args, layout_block=lb, max_hops=hops,
                                  expand=e)
        want = K.graph_beam_search_plain(*args, layout_block=lb,
                                         max_hops=hops, expand=e)
        label = (f"graph_beam_search M={m} C={c} d={d} layout_block={lb} "
                 f"N={lb * nb} R={r} B={b} expand={e} max_hops={hops} "
                 f"{'u8' if u8 else 'f32'}{' ties' if ties else ''}")
        if not all(torch.equal(a, w) for a, w in zip(got, want)):
            bad = int((got[1] != want[1]).any(dim=1).sum())
            raise AssertionError(f"{label}: differs from its plain version "
                                 f"in {bad} rows (hops {got[2].tolist()[:8]}"
                                 f" vs {want[2].tolist()[:8]})")
        h = want[2]
        log(f"  {label}: equal to its plain version (integer data); hops "
            f"per query {int(h.min())}-{int(h.max())}")


def phase_pipelined_kernels(K, testing, gen):
    """The sorted gleanvec_sq_topk and sq_dot on the pipelined scan, on
    small-integer data (every score exact in fp32 in any order): the sorted
    top-k equal to ``testing.exact_sorted_topk`` bit for bit at layout
    blocks L in {1, 64, 200, 256, 512, 4096} (one view a tile, tiles cut at
    L's end; two views at L = 256), u8 and f32 codes, row_ids with -1, k in
    {1, 10, 100, 200}, ragged M and N, and at the stream's shape family
    (M = 1030, C = 48, d = 160, L = 256); a tie across layout blocks of
    different tags; the sorted dense gleanvec_sq equal to its plain version
    bit for bit at L in {1, 64, 200, 256, 768, 4096} (two views a tile at
    256 and 768), ragged last blocks; sq_dot equal to its plain version bit
    for bit at d in {1, 3, 160, 513}, rows off 4-byte alignment."""
    dev = torch.device("cuda")

    def ints(lo, hi, *shape, u8=False):
        if u8:
            return torch.randint(lo, hi, shape, generator=gen, device=dev,
                                 dtype=torch.uint8)
        return torch.randint(lo, hi, shape, generator=gen,
                             device=dev).float()

    def sorted_case(m, n, c, d, lb, u8, ks):
        qs, qlo = ints(-3, 4, m, c, d), ints(-50, 51, m, c)
        x = ints(0, 4, n, d, u8=True) if u8 else ints(-3, 4, n, d)
        btags = torch.randint(0, c, (-(-n // lb),), generator=gen,
                              device=dev, dtype=torch.int32)
        rid = torch.randperm(n, generator=gen, device=dev).to(torch.int32)
        rid[torch.rand(n, generator=gen, device=dev) < 0.2] = -1
        for k in ks:
            got = K.gleanvec_sq_topk(qs, qlo, btags, x, k, row_ids=rid,
                                     layout_block=lb)
            want = testing.exact_sorted_topk(qs, qlo, btags, x, rid, k, lb)
            label = (f"gleanvec_sq_topk sorted L={lb} "
                     f"{'u8' if u8 else 'f32'} M={m} N={n} C={c} d={d} k={k}")
            if not (torch.equal(got[0], want[0])
                    and torch.equal(got[1], want[1])):
                raise AssertionError(f"{label}: differs from the exact top-k")
        log(f"  gleanvec_sq_topk sorted L={lb} {'u8' if u8 else 'f32'} M={m} "
            f"N={n} C={c} d={d} k={ks}: equal to the exact top-k (integer "
            "data)")

    for lb in (1, 64, 200, 256, 512, 4096):
        for u8 in (False, True):
            n = 1000 if lb == 1 else max(2999, 3 * lb + 37)
            sorted_case(1, n, 3, 20, lb, u8, (1, 10, 100, 200))
            sorted_case(130, n, 5, 33, lb, u8, (1, 10, 100, 200))
    sorted_case(1030, 20011, 48, 160, 256, True, (100, 200))
    sorted_case(1030, 20011, 48, 160, 256, False, (100,))

    # equal scores through different views: view t reads depth t of rows
    # that hold 2 at every depth
    for lb in (64, 256, 4096):
        c, d, nb = 4, 16, 6
        n = nb * lb
        qs = torch.zeros(3, c, d, device=dev)
        for t in range(c):
            qs[:, t, t] = 1.0
        btags = (torch.arange(nb, device=dev) % c).to(torch.int32)
        rid = torch.randperm(n, generator=gen, device=dev).to(torch.int32)
        vals, ids = K.gleanvec_sq_topk(qs, torch.zeros(3, c, device=dev),
                                       btags, torch.full((n, d), 2.0,
                                                         device=dev),
                                       200, row_ids=rid, layout_block=lb)
        if not (torch.equal(ids, torch.sort(rid).values[:200].expand(3, -1))
                and bool((vals == 2.0).all())):
            raise AssertionError(f"gleanvec_sq_topk sorted L={lb}: a tie "
                                 "across layout blocks must go to the "
                                 "smaller ids")
    log("  gleanvec_sq_topk sorted exact ties across layout blocks of "
        "different tags: ids ascending as required")

    # the sorted dense gleanvec_sq: one view a tile (L off 512: 1, 64,
    # 200, 4096) and two (256, 768), ragged last blocks
    for lb, nb, cut in ((1, 900, 0), (64, 40, 5), (200, 13, 37),
                        (256, 31, 100), (256, 40, 0), (768, 7, 300),
                        (4096, 3, 1000)):
        for u8 in (False, True):
            n, m, c, d = nb * lb - cut, 130, 5, 33 if lb < 256 else 160
            qs, qlo = ints(-3, 4, m, c, d), ints(-50, 51, m, c)
            x = ints(0, 4, n, d, u8=True) if u8 else ints(-3, 4, n, d)
            btags = torch.randint(0, c, (-(-n // lb),), generator=gen,
                                  device=dev, dtype=torch.int32)
            if not torch.equal(
                    K.gleanvec_sq(qs, qlo, btags, x, layout_block=lb),
                    K.gleanvec_sq_plain(qs, qlo, btags, x, layout_block=lb)):
                raise AssertionError(f"gleanvec_sq sorted L={lb} N={n} "
                                     f"{'u8' if u8 else 'f32'}: differs from "
                                     "its plain version (integer data)")
        log(f"  gleanvec_sq sorted L={lb} N={n} M={m} C={c} d={d} u8 and "
            "f32: equal to its plain version (integer data)")

    for d in (1, 3, 160, 513):
        for m, n, shift in ((70, 5003, 0), (1030, 2049, 1), (64, 512, 3)):
            q, lo = ints(-3, 4, m, d), ints(-40, 41, m)
            codes = ints(0, 256, n * d + shift, u8=True)[shift:].view(n, d)
            if not torch.equal(K.sq_dot_folded(q, lo, codes),
                               K.sq_dot_folded_plain(q, lo, codes)):
                raise AssertionError(f"sq_dot M={m} N={n} d={d} shift={shift}:"
                                     " differs from its plain version")
        log(f"  sq_dot d={d} (M, N) in (70, 5003), (1030, 2049), (64, 512), "
            "rows off alignment: equal to its plain version (integer data)")


def check_dense(label, got, want, tol):
    """Dense scores: equal where either side is masked (NEG_INF), within
    ``tol`` elsewhere; returns the largest gap."""
    if got.shape != want.shape:
        raise AssertionError(f"{label}: shape {tuple(got.shape)} vs "
                             f"{tuple(want.shape)}")
    err = 0.0
    for s in range(0, got.shape[0], 64):       # bounded temporaries
        g, w = got[s:s + 64], want[s:s + 64]
        dead_g, dead_w = g < -1e37, w < -1e37
        if not torch.equal(dead_g, dead_w):
            raise AssertionError(f"{label}: masked columns differ")
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{label}: non-finite scores")
        gap = (g - w).abs().masked_fill(dead_g, 0.0)
        err = max(err, float(gap.max()) if gap.numel() else 0.0)
    log(f"  {label}: max_abs_err={err:.3e} tol={tol:.3e}")
    if err > tol:
        raise AssertionError(f"{label}: beyond tol={tol:.3e}")
    return err


def phase_dense_kernels(K, testing, gen):
    """sq_dot, gleanvec_ip and dense gleanvec_sq against their plain
    versions (M and N off the tiles, u8 and f32, gathered and sorted,
    layout blocks off the 128-row tile, a ragged last block), then
    ``scorer_scores`` of every scorer class with dead columns against the
    same scorer on the CPU (plain versions)."""
    from repro_torch.core import scorer as sc
    dev = torch.device("cuda")

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    def tags_of(n, c):
        return torch.randint(0, c, (n,), generator=gen, device=dev,
                             dtype=torch.int32)

    def u8(n, d):
        return torch.randint(0, 256, (n, d), generator=gen, device=dev,
                             dtype=torch.uint8)

    for m, n, d in [(37, 5003, 160), (130, 20011, 48), (3, 50, 20)]:
        q, codes = randn(m, d), u8(n, d)
        lo, delta = randn(d), torch.rand(d, generator=gen, device=dev) + 0.01
        qs, qlo = q * delta, q @ lo
        tol = testing.dot_tol(row_norm_max(qs), row_norm_max(codes), d,
                              float(qlo.abs().max()))
        want = K.sq_dot_folded_plain(qs, qlo, codes)
        check_dense(f"sq_dot M={m} N={n} d={d}", K.sq_dot(q, codes, lo, delta),
                    want, tol)
        check_dense(f"sq_dot_folded M={m} N={n} d={d}",
                    K.sq_dot_folded(qs, qlo, codes), want, tol)

    for m, c, d, n in [(9, 48, 160, 7001), (70, 8, 64, 2000), (6, 5, 33, 3000)]:
        qv, x, tags = randn(m, c, d), randn(n, d), tags_of(n, c)
        tol = testing.dot_tol(row_norm_max(qv), row_norm_max(x), d)
        check_dense(f"gleanvec_ip M={m} C={c} d={d} N={n}",
                    K.gleanvec_ip(qv, tags, x),
                    K.gleanvec_ip_plain(qv, tags, x), tol)

    for m, c, d, n, is_u8 in [(9, 48, 160, 7001, True), (70, 8, 64, 2000, False),
                              (130, 5, 33, 3000, True)]:
        qs, qlo, tags = randn(m, c, d), randn(m, c), tags_of(n, c)
        x = u8(n, d) if is_u8 else randn(n, d)
        tol = testing.dot_tol(row_norm_max(qs), row_norm_max(x), d,
                              float(qlo.abs().max()))
        check_dense(f"gleanvec_sq gathered M={m} C={c} d={d} N={n} "
                    f"{'u8' if is_u8 else 'f32'}",
                    K.gleanvec_sq(qs, qlo, tags, x),
                    K.gleanvec_sq_plain(qs, qlo, tags, x), tol)

    for m, c, d, lb, nb, cut, is_u8 in [(70, 6, 160, 4096, 5, 0, True),
                                        (5, 7, 48, 64, 40, 0, False),
                                        (3, 4, 16, 200, 7, 37, False),
                                        (130, 3, 40, 300, 9, 0, True)]:
        n = nb * lb - cut
        qs, qlo, btags = randn(m, c, d), randn(m, c), tags_of(nb, c)
        x = u8(n, d) if is_u8 else randn(n, d)
        tol = testing.dot_tol(row_norm_max(qs), row_norm_max(x), d,
                              float(qlo.abs().max()))
        check_dense(f"gleanvec_sq sorted M={m} C={c} d={d} layout_block={lb} "
                    f"N={n} {'u8' if is_u8 else 'f32'}",
                    K.gleanvec_sq(qs, qlo, btags, x, layout_block=lb),
                    K.gleanvec_sq_plain(qs, qlo, btags, x, layout_block=lb),
                    tol)

    # the lowering: every class, dead columns (live mask / perm -1)
    m, c, d, dim, n, lb = 33, 6, 40, 64, 3000, 120
    live = torch.rand(n, generator=gen, device=dev) > 0.2
    perm = torch.randperm(n, generator=gen, device=dev).to(torch.int32)
    perm[~live] = -1
    qlow_a, a_c = randn(d, dim), randn(c, d, dim)
    lo, delta = randn(d), torch.rand(d, generator=gen, device=dev) + 0.01
    lo_c, delta_c = randn(c, d), torch.rand(c, d, generator=gen,
                                            device=dev) + 0.01
    scorers = {
        "LinearScorer": sc.LinearScorer(x_low=randn(n, d), a=qlow_a,
                                        live=live),
        "QuantizedScorer": sc.QuantizedScorer(codes=u8(n, d), lo=lo,
                                              delta=delta, a=qlow_a,
                                              live=live),
        "GleanVecScorer": sc.GleanVecScorer(x_low=randn(n, d),
                                            tags=tags_of(n, c), a=a_c,
                                            live=live),
        "GleanVecQuantizedScorer": sc.GleanVecQuantizedScorer(
            codes=u8(n, d), tags=tags_of(n, c), lo=lo_c, delta=delta_c,
            a=a_c, live=live),
        "SortedGleanVecScorer": sc.SortedGleanVecScorer(
            x_low=randn(n, d), block_tags=tags_of(-(-n // lb), c), perm=perm,
            inv_perm=perm, a=a_c),
        "SortedGleanVecQuantizedScorer": sc.SortedGleanVecQuantizedScorer(
            codes=u8(n, d), block_tags=tags_of(-(-n // lb), c), perm=perm,
            inv_perm=perm, lo=lo_c, delta=delta_c, a=a_c),
    }
    q = randn(m, dim)
    for name, s in scorers.items():
        cpu = type(s)(*(None if t is None else t.cpu() for t in s))
        qstate = s.prepare_queries(q)
        got = K.scorer_scores(s, q)
        qs, lo_max = qstate, 0.0
        if isinstance(qstate, tuple):
            qs, lo_max = qstate.q_scaled, float(qstate.q_lo.abs().max())
            qstate = type(qstate)(*(t.cpu() for t in qstate))
        else:
            qstate = qstate.cpu()
        want = K.scorer_scores_prepared(cpu, qstate).to(dev)
        rows = s.x_low if hasattr(s, "x_low") else s.codes
        tol = testing.dot_tol(row_norm_max(qs), row_norm_max(rows), d, lo_max)
        check_dense(f"scorer_scores {name} (dead columns)", got, want, tol)


# ---------------------------------------------------------------------------
# Phase 3: the main path.
# ---------------------------------------------------------------------------


def phase_main(K):
    from repro_torch.core import gleanvec as gv
    from repro_torch.core import leanvec_sphering as lvs
    from repro_torch.core import metrics
    from repro_torch.core import search as msearch
    from repro_torch.core.scorer import MODES
    from repro_torch.data import vectors
    from repro_torch.serve.engine import ServingEngine

    dev = torch.device("cuda")
    log(f"phase 3: main path, n={N_ROWS} D=512 d=160 C=48 batch=1024 "
        "k=10 kappa=100")
    t0 = time.perf_counter()
    ds = vectors.make_dataset("smoke", n=N_ROWS, d=512, n_queries=1024,
                              ood=True, seed=0, gt_device=dev)
    log(f"  data: {time.perf_counter() - t0:.1f} s (host generator, ground "
        "truth on the card)")
    x = torch.as_tensor(ds.database, device=dev)
    flat_kernels = (K.ip_topk, K.gleanvec_sq_topk, K.kmeans_assign)
    for fn in all_counters(K):
        fn.launches = 0

    t0 = time.perf_counter()
    sph = lvs.fit(ds.queries_learn, x, 160, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    glv = gv.fit(ds.queries_learn, x, c=48, d=160, generator=gen,
                 device=dev)
    torch.cuda.synchronize()
    log(f"  fit: {time.perf_counter() - t0:.1f} s "
        f"(kmeans_assign launches so far: {K.kmeans_assign.launches})")

    per_mode, states, flat_p50 = {}, {}, {}
    for mode in MODES:
        model = None if mode == "full" else (
            sph if mode.startswith("sphering") else glv)
        before = {fn.__name__: fn.launches for fn in flat_kernels}
        t0 = time.perf_counter()
        art = msearch.build_artifacts(mode, x, model, device=dev)
        torch.cuda.synchronize()
        t_build = time.perf_counter() - t0
        kappa = 10 if mode == "full" else 100
        engine = ServingEngine(msearch.make_state(art), k=10, kappa=kappa,
                               batch_size=1024, dim=512)
        ids = None
        for _ in range(5):
            ids = engine.submit(ds.queries_test)
        rec = metrics.recall_at_k(ids, ds.gt[:, :10])
        s = engine.stats
        delta = {fn.__name__: fn.launches - before[fn.__name__]
                 for fn in flat_kernels}
        per_mode[mode] = delta
        flat_p50[mode] = s.percentile_ms(50)
        log(f"  mode={mode} encode={t_build:.2f}s batches={s.n_batches} "
            f"QPS={s.qps:.0f} p50={s.percentile_ms(50):.1f}ms "
            f"p99={s.percentile_ms(99):.1f}ms recall@10={rec:.4f} "
            f"(floor {RECALL_FLOORS[mode]}) launches={delta}")
        if not np.all((ids >= -1) & (ids < N_ROWS)) or ids.shape != (1024, 10):
            raise AssertionError(f"{mode}: malformed ids {ids.shape}")
        if rec < RECALL_FLOORS[mode]:
            raise AssertionError(f"{mode}: recall@10 {rec:.4f} below its "
                                 f"floor {RECALL_FLOORS[mode]}")
        q = torch.as_tensor(ds.queries_test, device=dev)
        states[mode] = (art.scorer, art.scorer.prepare_queries(q), kappa)
        if mode == "sphering-int8":     # kappa is this mode's lever
            wide = ServingEngine(msearch.make_state(art), k=10,
                                 kappa=WIDE_KAPPA, batch_size=1024, dim=512)
            ids = wide.submit(ds.queries_test)
            rec_wide = metrics.recall_at_k(ids, ds.gt[:, :10])
            log(f"  mode={mode} kappa={WIDE_KAPPA}: recall@10="
                f"{rec_wide:.4f} (kappa={kappa}: {rec:.4f}) "
                f"batch={wide.stats.percentile_ms(50):.1f}ms")
            if ids.shape != (1024, 10) or rec_wide < rec:
                raise AssertionError(f"{mode}: kappa={WIDE_KAPPA} recall "
                                     f"{rec_wide:.4f} below kappa={kappa}'s")
            del wide
        del engine
    totals = {fn.__name__: fn.launches for fn in all_counters(K)}
    log(f"  main-path launches: {totals}")
    for fn in flat_kernels:
        if totals[fn.__name__] <= 0:
            raise AssertionError(f"{fn.__name__} was not launched on the "
                                 "main path")
    return ds, x, sph, glv, states, per_mode, totals, flat_p50


def all_counters(K):
    """Every kernel wrapper's launch counter."""
    return (K.ip_topk, K.gleanvec_sq_topk, K.kmeans_assign, K.ivf_scan_topk,
            K.sq_dot, K.gleanvec_ip, K.gleanvec_sq, K.graph_scan_beam_step,
            K.graph_beam_search, K.flash_attention)


# ---------------------------------------------------------------------------
# Phase 3b: the IVF path.
# ---------------------------------------------------------------------------


def phase_ivf(K, testing, ds, x, glv, states):
    """Aligned IVF (nprobe 12, reduced probe) in front of both sorted
    modes, then fused against gathered on the first PARITY_ROWS rows.
    Returns ({mode: (scorer, qstate, probe)}, {mode: launches})."""
    import dataclasses
    from repro_torch.core import metrics
    from repro_torch.core import scorer as sc
    from repro_torch.core import search as msearch
    from repro_torch.index import ivf
    from repro_torch.serve.engine import ServingEngine

    dev = torch.device("cuda")
    log(f"phase 3b: IVF path, aligned, nprobe={IVF_NPROBE}, reduced probe, "
        "batch=1024 k=10 kappa=100")
    q = torch.as_tensor(ds.queries_test, device=dev)
    for fn in all_counters(K):
        fn.launches = 0
    per_mode, inputs = {}, {}
    for mode in IVF_RECALL_FLOORS:
        scorer = states[mode][0]
        before = {fn.__name__: fn.launches for fn in all_counters(K)}
        t0 = time.perf_counter()
        index = ivf.with_reduced_centers(
            ivf.build_aligned(glv, x, nprobe=IVF_NPROBE, device=dev), scorer,
            glv)
        torch.cuda.synchronize()
        t_build = time.perf_counter() - t0
        art = msearch.SearchArtifacts(scorer=scorer, x_full=x, model=glv)
        engine = ServingEngine(msearch.make_state(art, index=index), k=10,
                               kappa=100, batch_size=1024, dim=512)
        ids = None
        for _ in range(5):
            ids = engine.submit(ds.queries_test)
        rec = metrics.recall_at_k(ids, ds.gt[:, :10])
        st = engine.stats
        delta = {fn.__name__: fn.launches - before[fn.__name__]
                 for fn in all_counters(K)}
        per_mode[mode] = delta
        log(f"  mode={mode} index build={t_build:.2f}s "
            f"batches={st.n_batches} QPS={st.qps:.0f} "
            f"p50={st.percentile_ms(50):.1f}ms "
            f"p99={st.percentile_ms(99):.1f}ms recall@10={rec:.4f} "
            f"(floor {IVF_RECALL_FLOORS[mode]}) launches={delta}")
        if not np.all((ids >= -1) & (ids < N_ROWS)) or ids.shape != (1024, 10):
            raise AssertionError(f"ivf {mode}: malformed ids {ids.shape}")
        if rec < IVF_RECALL_FLOORS[mode]:
            raise AssertionError(f"ivf {mode}: recall@10 {rec:.4f} below "
                                 f"its floor {IVF_RECALL_FLOORS[mode]}")
        for name in ("ivf_scan_topk", "kmeans_assign"):
            if delta[name] <= 0:
                raise AssertionError(f"ivf {mode}: {name} was not launched")
        qstate = index.prepare_queries(scorer, q)
        probe = torch.sort(ivf.coarse_scores(index, qstate), dim=1,
                           descending=True, stable=True).indices[:, :IVF_NPROBE]
        inputs[mode] = (scorer, qstate.qstate, probe)
        vals, ids = K.ivf_scan_topk(*ivf_args(scorer, qstate.qstate, probe,
                                              100))
        log(f"  mode={mode} fine step on this batch's probes (k=100): "
            f"digest of values and ids {digest(vals, ids)}")
        del engine, vals, ids
    totals = {fn.__name__: fn.launches for fn in all_counters(K)}
    log(f"  IVF-path launches: {totals}")

    log(f"  fused vs gathered fine step on the first {PARITY_ROWS} rows "
        "(testing.assert_topk_close, tolerance testing.dot_tol)")
    xs = x[:PARITY_ROWS]
    for mode in IVF_RECALL_FLOORS:
        scorer = sc.build_scorer(mode, xs, glv, device=dev)
        index = ivf.with_reduced_centers(
            ivf.build_aligned(glv, xs, nprobe=IVF_NPROBE, device=dev),
            scorer, glv)
        t0 = time.perf_counter()
        fused = index.search(q, scorer, 100)
        torch.cuda.synchronize()
        t_fused = time.perf_counter() - t0
        t0 = time.perf_counter()
        gathered = dataclasses.replace(index, aligned_layout=False).search(
            q, scorer, 100)
        torch.cuda.synchronize()
        t_gathered = time.perf_counter() - t0
        qs = scorer.prepare_queries(q)
        lo = 0.0
        if isinstance(qs, tuple):
            qs, lo = qs.q_scaled, float(qs.q_lo.abs().max())
        rows = scorer.x_low if hasattr(scorer, "x_low") else scorer.codes
        tol = testing.dot_tol(row_norm_max(qs), row_norm_max(rows),
                              rows.shape[1], lo)
        check_topk(f"ivf {mode} fused vs gathered (n={PARITY_ROWS}; "
                   f"{t_fused * 1e3:.1f} ms vs {t_gathered * 1e3:.1f} ms "
                   "host clock)", fused, gathered, tol, testing)
    return inputs, per_mode


# ---------------------------------------------------------------------------
# Phase 3c: the stream.
# ---------------------------------------------------------------------------


def dense_check(K, testing, scorer, queries, k):
    """``scorer_scores`` + ``torch.topk`` against the fused scan
    (``scorer_topk``) on the same queries and store: dead slots must never
    win, and the two must agree within ``testing.dot_tol``."""
    from repro_torch.core import scorer as sc
    qstate = scorer.prepare_queries(queries)
    scores = K.scorer_scores_prepared(scorer, qstate)
    vals, idx = torch.topk(scores, k, dim=1)
    del scores
    if isinstance(scorer, (sc.SortedGleanVecScorer,
                           sc.SortedGleanVecQuantizedScorer)):
        ids = scorer.perm[idx]
    else:
        ids = scorer.translate_ids(idx.to(torch.int32))
    fused = K.scorer_topk_prepared(scorer, qstate, k)
    qs, lo = qstate, 0.0
    if isinstance(qstate, tuple):
        qs, lo = qstate.q_scaled, float(qstate.q_lo.abs().max())
    rows = scorer.x_low if hasattr(scorer, "x_low") else scorer.codes
    tol = testing.dot_tol(row_norm_max(qs), row_norm_max(rows),
                          rows.shape[1], lo)
    rep = testing.assert_topk_close((vals, ids), fused, tol,
                                    "scorer_scores vs fused scan")
    if bool((ids < 0).any()) or bool((fused[1] < 0).any()):
        raise AssertionError("a dead slot won the dense or the fused scan")
    return rep["max_abs_err"]


def phase_stream(K, testing, ds, x):
    """The stream at capacity N_ROWS: six DR modes over the flat index, both
    sorted modes over the aligned IVF. Returns ({(index, mode): scorer},
    launches of the whole phase, {(index, mode): launches of that run})."""
    from repro_torch.core import gleanvec as gv
    from repro_torch.core import leanvec_sphering as lvs
    from repro_torch.core import streaming
    from repro_torch.launch import serve
    from repro_torch.serve.engine import ServingEngine

    dev = torch.device("cuda")
    n0, cap = STREAM_N0, N_ROWS
    log(f"phase 3c: stream, capacity={cap} n0={n0} cycles={STREAM_CYCLES} "
        f"inserts/cycle={STREAM_INSERTS} (IVF: removes/cycle="
        f"{STREAM_REMOVES}) D=512 d=160 C=48 batch=1024 k=10 kappa=100")
    for fn in all_counters(K):
        fn.launches = 0
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    q_init = ds.database[rng.integers(0, n0, 1024)] \
        + 0.1 * rng.standard_normal((1024, 512)).astype(np.float32)
    sph = lvs.fit(q_init, x[:n0], 160, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    glv = gv.fit(q_init, x[:n0], c=48, d=160, generator=gen, device=dev)
    slack = serve.stream_slack_blocks(glv, x[n0:])
    torch.cuda.synchronize()
    log(f"  fit on in-distribution queries: {time.perf_counter() - t0:.1f} s; "
        f"sorted slack_blocks={slack} (block {serve.STREAM_SORT_BLOCK})")
    obs = ds.queries_test[:1024]
    q_check = torch.as_tensor(obs[:DENSE_CHECK_QUERIES], device=dev)
    runs = [("flat", m, STREAM_FLOORS[m]) for m in STREAM_FLOORS] + \
        [("ivf", m, STREAM_IVF_FLOORS[m]) for m in STREAM_IVF_FLOORS]
    finals, below, per_run = {}, [], {}
    for index, mode, floors in runs:
        model = sph if mode.startswith("sphering") else glv
        before = {fn.__name__: fn.launches for fn in all_counters(K)}
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state = serve.build_stream(
            mode, x, n0, cap, model, index=index, nprobe=IVF_NPROBE,
            reduced_probe=True, slack_blocks=slack,
            list_slack=4 * (cap - n0) // glv.n_clusters, device=dev)
        engine = ServingEngine(state, k=10, kappa=100, batch_size=1024,
                               dim=512)
        stream = streaming.init_from_artifacts(state.artifacts, q_init,
                                               refresh_every=STREAM_INSERTS)
        torch.cuda.synchronize()
        log(f"  {index} {mode}: build {time.perf_counter() - t0:.2f} s")
        for cycle in range(STREAM_CYCLES):
            served = engine.submit(obs)
            rec = serve.live_recall(engine, obs, served)
            err = dense_check(K, testing, engine.state.artifacts.scorer,
                              q_check, 100)
            stream = streaming.observe_queries(stream, obs)
            start = n0 + cycle * STREAM_INSERTS
            rows = x[start:start + STREAM_INSERTS]
            remove = None
            if index == "ivf":
                remove = torch.arange(cycle * STREAM_REMOVES,
                                      (cycle + 1) * STREAM_REMOVES,
                                      device=dev)
            version = engine.version
            stream, rep = serve.stream_cycle(engine, stream, rows,
                                             remove=remove)
            live = int(streaming.live_mask(engine.state.artifacts).sum())
            log(f"    cycle {cycle}: recall@10={rec:.4f} (floor "
                f"{floors[cycle]}) insert={rep['insert_ms']:.1f}ms "
                f"refresh={rep['refresh_ms']:.1f}ms "
                f"cond={rep['condition']:.3g} swaps ok (version {version} -> "
                f"{engine.version}) live_rows={live} batch_ms="
                f"{engine.stats.latencies_ms[-1]:.1f} dense_vs_fused_err="
                f"{err:.3e}")
            if not np.all((served >= -1) & (served < cap)) \
                    or served.shape != (1024, 10):
                raise AssertionError(f"stream {mode}: malformed ids")
            if rec < floors[cycle]:          # every run is read first
                below.append(f"{index} {mode} cycle {cycle}: recall@10 "
                             f"{rec:.4f} below its floor {floors[cycle]}")
            if engine.version != version + 2:
                raise AssertionError("a stream swap did not install")
        delta = {fn.__name__: fn.launches - before[fn.__name__]
                 for fn in all_counters(K)}
        log(f"    launches={delta} peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
        finals[(index, mode)] = engine.state.artifacts.scorer
        per_run[(index, mode)] = delta
        del engine, state, stream
    totals = {fn.__name__: fn.launches for fn in all_counters(K)}
    log(f"  stream launches: {totals}")
    if below:
        raise AssertionError("stream recall below its floor: "
                             + "; ".join(below))
    for name in ("sq_dot", "gleanvec_ip", "gleanvec_sq", "gleanvec_sq_topk",
                 "ivf_scan_topk", "kmeans_assign"):
        if totals[name] <= 0:
            raise AssertionError(f"{name} was not launched on the stream "
                                 "path")
    return finals, totals, per_run


# ---------------------------------------------------------------------------
# Phase 3d: the graph path.
# ---------------------------------------------------------------------------


def counts(K):
    return {fn.__name__: fn.launches for fn in all_counters(K)}


def capture_hops(K, fn):
    """Run ``fn`` (a per-hop fused traversal) and return the inputs of
    every hop as the sorted scorers hand them to the lowering
    (``kernels.scorer_scan_neighbors``): [(scorer, qstate, nbr_rows,
    beam_vals, beam_ids), ...], and ``fn``'s result."""
    orig = K.scorer_scan_neighbors
    seen = []

    def spy(scorer, qstate, nbr_rows, beam_vals, beam_ids, tn=8):
        seen.append((scorer, qstate, nbr_rows.clone(), beam_vals.clone(),
                     beam_ids.clone()))
        return orig(scorer, qstate, nbr_rows, beam_vals, beam_ids, tn)

    K.scorer_scan_neighbors = spy
    try:
        out = fn()
    finally:
        K.scorer_scan_neighbors = orig
    return seen, out


def per_hop_search(index, scorer, qstate, k, expand):
    """The fused traversal as the per-hop loop (``graph._beam_loop`` with
    ``graph.fused_hop_step``: one ``graph_scan_beam_step`` launch and a
    host sync a hop), cut to the top k as ``candidates`` cuts it: (vals,
    ids, hops)."""
    from repro_torch.index import graph
    m = (qstate.q_scaled if isinstance(qstate, tuple) else qstate).shape[0]
    step = graph.fused_hop_step(qstate, scorer, index, index.beam, expand)
    vals, ids, hops, _ = graph._beam_loop(
        graph._score_ids_of(qstate, scorer), index, m, index.beam,
        index.max_hops, expand, fused_step=step)
    sel = graph._best_slots(vals, k)
    return torch.gather(vals, 1, sel), torch.gather(ids, 1, sel), hops


def capture_hop(K, fn, which: int):
    """The inputs of the ``which``-th hop of ``fn`` (:func:`capture_hops`)."""
    seen, _ = capture_hops(K, fn)
    if len(seen) <= which:
        raise AssertionError(f"the traversal ran {len(seen)} fused hops, "
                             f"fewer than {which + 1}")
    return seen[which]


def hop_args(hop):
    """The kernel's positional arguments and layout block of a captured
    hop."""
    scorer, qstate, nbr_rows, bv, bi = hop
    if isinstance(qstate, tuple):
        qs, qlo, codes = qstate.q_scaled, qstate.q_lo, scorer.codes
    else:
        qs, codes = qstate, scorer.x_low
        qlo = torch.zeros(qs.shape[:2], dtype=torch.float32, device=qs.device)
    return ((qs, qlo, scorer.block_tags, scorer.perm, codes, nbr_rows, bv,
             bi), scorer.layout_block)


def overlap(a, b) -> float:
    """Mean share of common ids of two (m, kappa) candidate sets (-1 slots
    are no members)."""
    hit = (a[:, :, None] == b[:, None, :]).any(dim=2) & (a >= 0)
    size = torch.maximum((a >= 0).sum(dim=1), (b >= 0).sum(dim=1))
    return float((hit.sum(dim=1) / size.clamp(min=1)).mean())


def kernel_share(fn) -> str:
    """Device time of the traversal kernel and of every kernel in one call
    of ``fn`` (``torch.profiler``), beside its host-clock time."""
    from repro_torch.analysis.trace_rules import device_split
    wall, busy, hit, kernels, hits = device_split(fn, "graph_search_kernel")
    if busy <= 0:
        return (f"split not measured (no device time recorded; batch "
                f"{wall:.1f} ms under the profiler)")
    return (f"under the profiler: batch {wall:.1f} ms host clock, device "
            f"busy {busy:.2f} ms ({kernels} kernels), of it "
            f"graph_beam_search {hit:.3f} ms ({hits} launches)")


def fused_vs_gathered(K, testing, label, art, index, q, expand, gt):
    """One hop captured from the per-hop fused loop through the kernel and
    the plain version, then the whole traversal fused against gathered:
    kappa-candidate overlap and recall@10 after the rerank. ``gt``: a
    function of served ids -> recall@10. Returns the captured hop."""
    from repro_torch.core import search as msearch
    from repro_torch.index import graph
    gathered = dataclasses.replace(index, expand=expand, fused=False,
                                   nbr_rows=None)
    fused = graph.with_fused_scan(gathered, art.scorer)
    qstate = fused.prepare_queries(art.scorer, q)
    hop = capture_hop(K, lambda: per_hop_search(fused, art.scorer, qstate,
                                                100, expand), which=3)
    args, lb = hop_args(hop)
    check_hop(K, testing, f"{label} expand={expand} captured hop 3: kernel "
              "vs plain", args, lb)
    cf = fused.candidates(qstate, art.scorer, 100)[1]
    cg = gathered.candidates(qstate, art.scorer, 100)[1]
    ov = overlap(cf, cg)
    rf = gt(msearch.multi_step_search(q, art, fused, 10, 100).cpu().numpy())
    rg = gt(msearch.multi_step_search(q, art, gathered, 10,
                                      100).cpu().numpy())
    log(f"  {label} expand={expand}: fused vs gathered kappa-candidate "
        f"overlap={ov:.4f} (min {GRAPH_MIN_OVERLAP}) recall@10 fused="
        f"{rf:.4f} gathered={rg:.4f} (max gap {GRAPH_MAX_RECALL_GAP})")
    if ov < GRAPH_MIN_OVERLAP or abs(rf - rg) > GRAPH_MAX_RECALL_GAP:
        raise AssertionError(f"{label} expand={expand}: fused and gathered "
                             "traversals disagree")
    return hop


def phase_graph(K, testing, ds, x, sph, glv):
    """The graph path on the first GRAPH_ROWS rows. Returns ({(mode,
    expand): captured hop}, launches of the main path (the build, the
    serving and the churn's updates and serving; no check's), {mode: hops,
    host syncs and graph_beam_search launches a batch}, {fused mode: the
    traversal kernel's inputs on the batch, its work, the prepared queries,
    the scorer and the gathered graph})."""
    from repro_torch.analysis.trace_rules import device_split, sync_count
    from repro_torch.core import metrics
    from repro_torch.core import search as msearch
    from repro_torch.core import streaming
    from repro_torch.data import vectors
    from repro_torch.index import graph
    from repro_torch.launch import serve
    from repro_torch.serve.engine import ServingEngine

    dev = torch.device("cuda")
    n = GRAPH_ROWS
    xg = x[:n]
    log(f"phase 3d: graph path, n={n} D=512 d=160 C=48, degree 24 + 4 "
        f"random, beam={GRAPH_BEAM} max_hops={GRAPH_HOPS} "
        f"expand={GRAPH_EXPAND}, batch=1024 k=10 kappa=100")
    q = torch.as_tensor(ds.queries_test, device=dev)
    gt = vectors.exact_topk(ds.queries_test, xg, 10, device=dev)
    for fn in all_counters(K):
        fn.launches = 0
    t0 = time.perf_counter()
    steps = {}
    g = graph.build(xg, r=24, n_random=4, n_entries=16, seed=0,
                    method="auto", device=dev, timings=steps)
    torch.cuda.synchronize()
    built = counts(K)
    main = dict(built)
    log(f"  build (device, method=auto): {time.perf_counter() - t0:.1f} s = "
        + ", ".join(f"{k} {v:.1f} s" for k, v in steps.items())
        + f"; ip_topk launches={built['ip_topk']} kmeans_assign launches="
        f"{built['kmeans_assign']}; degree {g.neighbors.shape[1]}, "
        f"{g.entries.numel()} entries")
    if built["ip_topk"] <= 0 or built["kmeans_assign"] <= 0:
        raise AssertionError("the graph build did not launch ip_topk and "
                             "kmeans_assign")
    g = dataclasses.replace(g, beam=GRAPH_BEAM, max_hops=GRAPH_HOPS,
                            expand=GRAPH_EXPAND)
    arts, per_batch, searches = {}, {}, {}
    for mode in (*GRAPH_FUSED, "sphering"):
        fused = mode in GRAPH_FUSED
        art = msearch.build_artifacts(mode, xg, sph if mode == "sphering"
                                      else glv, device=dev)
        index = graph.with_fused_scan(g, art.scorer) if fused else g
        before = counts(K)
        engine = ServingEngine(msearch.make_state(art, index=index), k=10,
                               kappa=100, batch_size=1024, dim=512)
        ids = None
        for _ in range(5):
            ids = engine.submit(ds.queries_test)
        delta = {k: v - before[k] for k, v in counts(K).items()}
        for k, v in delta.items():
            main[k] += v
        rec = metrics.recall_at_k(ids, gt)
        st = engine.stats
        served, qps = st.n_batches, st.qps
        p50, p99 = st.percentile_ms(50), st.percentile_ms(99)
        qstate = art.scorer.prepare_queries(q)
        cand = graph._beam_qstate(qstate, art.scorer, index, 100,
                                  GRAPH_BEAM, GRAPH_HOPS,
                                  expand=GRAPH_EXPAND)
        hops = int(cand[2])
        syncs_cand = sync_count(lambda: index.candidates(qstate, art.scorer,
                                                         100))
        syncs_batch = sync_count(lambda: engine.submit(ds.queries_test))
        # the engine's warm-up batch (built at construction) is one more
        per_batch[mode] = {"hops": hops, "syncs": syncs_batch,
                           "search": delta["graph_beam_search"]
                           / (served + 1), "p50": p50, "p99": p99,
                           "qps": qps, "recall": rec, "syncs_cand": syncs_cand,
                           "build_s": sum(steps.values())}
        log(f"  mode={mode} {'fused' if fused else 'gathered'}: batches="
            f"{served} QPS={qps:.0f} p50={p50:.1f}ms "
            f"p99={p99:.1f}ms recall@10={rec:.4f} (floor "
            f"{GRAPH_RECALL_FLOORS[mode]}) hops/batch={hops} ms/hop="
            f"{p50 / max(hops, 1):.3f} host syncs: {syncs_batch} a batch, "
            f"{syncs_cand} in candidates; graph_beam_search launches="
            f"{delta['graph_beam_search']} graph_scan_beam_step launches="
            f"{delta['graph_scan_beam_step']}")
        log("    " + kernel_share(lambda: engine.submit(ds.queries_test)))
        _, busy, _, kernels, _ = device_split(
            lambda: index.candidates(qstate, art.scorer, 100), "graph_search")
        log(f"    candidates alone (the traversal and what feeds it, the "
            f"prepared queries given): {kernels} device kernels, device busy "
            f"{busy:.3f} ms")
        if not np.all((ids >= -1) & (ids < n)) or ids.shape != (1024, 10):
            raise AssertionError(f"graph {mode}: malformed ids {ids.shape}")
        if rec < GRAPH_RECALL_FLOORS[mode]:
            raise AssertionError(f"graph {mode}: recall@10 {rec:.4f} below "
                                 f"its floor {GRAPH_RECALL_FLOORS[mode]}")
        want = (served + 1, 0) if fused else (0, 0)
        got = (delta["graph_beam_search"], delta["graph_scan_beam_step"])
        if got != want:
            raise AssertionError(f"graph {mode}: (graph_beam_search, "
                                 f"graph_scan_beam_step) launches {got} on "
                                 f"the {'fused' if fused else 'gathered'} "
                                 f"path over {served} batches and the "
                                 f"warm-up, not {want}")
        if fused:
            if syncs_cand:
                raise AssertionError(f"graph {mode}: {syncs_cand} host syncs "
                                     "inside the fused candidates")
            seen, loop = capture_hops(K, lambda: per_hop_search(
                index, art.scorer, qstate, 100, GRAPH_EXPAND))
            same = (torch.equal(cand[0], loop[0])
                    and torch.equal(cand[1], loop[1]) and hops == loop[2])
            log(f"    fused candidates (kappa 100) and hops against the "
                f"per-hop loop over graph_scan_beam_step on the same batch: "
                f"{'equal' if same else 'DIFFERENT'} (hops {hops} / "
                f"{loop[2]}, digests {digest(*cand[:2])} / "
                f"{digest(*loop[:2])})")
            if not same:
                raise AssertionError(f"graph {mode}: the traversal kernel "
                                     "differs from the per-hop loop")
            entry = graph._entry_beam(graph._score_ids_of(qstate, art.scorer),
                                      index, q.shape[0], GRAPH_BEAM)
            args, lb = hop_args((art.scorer, qstate, index.nbr_rows,
                                 *entry))
            searches[mode] = (args, lb, search_work(seen), qstate,
                              art.scorer, g)
            del seen
        arts[mode] = art
        del engine
    # the fused graph with its rerank store in host memory
    before = counts(K)

    def host_graph():
        art = msearch.build_artifacts("gleanvec-int8-sorted", xg.clone(),
                                      glv, device=dev)
        return art, graph.with_fused_scan(g, art.scorer)

    timing = host_tier_run(K, "fused graph gleanvec-int8-sorted",
                           host_graph, ds.queries_test, n)
    for k, v in counts(K).items():
        main[k] += v - before[k] - timing[k]
    checks = {k: v - main[k] for k, v in counts(K).items()}
    log(f"  graph-path launches, build + serving: {main}; the checks' "
        f"(the per-hop loop, sync counts, profiles, the host tier's scan "
        f"timing): {checks}")

    def recall_all(ids):
        return metrics.recall_at_k(ids, gt)

    hops = {}
    for mode in GRAPH_FUSED:
        for expand in (1, 4):
            hops[(mode, expand)] = fused_vs_gathered(
                K, testing, f"graph {mode}", arts[mode], g, q, expand,
                recall_all)
    del arts

    # churn on a streaming store: removes, inserts, insert_ids, refreshed
    mode = "gleanvec-int8-sorted"
    cap = n + CHURN_INSERTS
    new_rows = x[n:cap]
    t0 = time.perf_counter()
    art = streaming.build_streaming_artifacts(
        mode, xg, glv, capacity=cap, sort_block=serve.STREAM_SORT_BLOCK,
        slack_blocks=serve.stream_slack_blocks(glv, new_rows), device=dev)
    index = graph.with_fused_scan(graph.with_capacity(g, cap), art.scorer)
    engine = ServingEngine(msearch.make_state(art, index=index), k=10,
                           kappa=100, batch_size=1024, dim=512)
    torch.cuda.synchronize()
    entries = set(g.entries.tolist())
    order = torch.randperm(n, generator=torch.Generator().manual_seed(1))
    removed = torch.tensor([i for i in order[:CHURN_REMOVES + 64].tolist()
                            if i not in entries][:CHURN_REMOVES],
                           dtype=torch.int32, device=dev)
    before = counts(K)
    t1 = time.perf_counter()
    art = streaming.remove_rows(art, removed)
    index = index.refreshed(art.scorer, art.model)
    art, new_ids = streaming.insert_rows(
        art, new_rows, ids=torch.arange(n, cap, dtype=torch.int32,
                                        device=dev))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    index = graph.insert_ids(index, new_rows, new_ids, art.scorer,
                             art.x_full)
    index = index.refreshed(art.scorer, art.model)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    engine.swap(engine.state._replace(artifacts=art, index=index))
    served = engine.submit(ds.queries_test)
    delta = {k: v - before[k] for k, v in counts(K).items()}
    for k, v in delta.items():
        main[k] += v
    rec = serve.live_recall(engine, ds.queries_test, served)
    log(f"  churn ({mode}, capacity {cap}): store build "
        f"{t1 - t0:.1f} s; remove {CHURN_REMOVES} + insert {CHURN_INSERTS} "
        f"rows {(t2 - t1) * 1e3:.0f} ms; insert_ids + refreshed "
        f"{(t3 - t2) * 1e3:.0f} ms = {(t3 - t2) * 1e3 / CHURN_INSERTS:.2f} "
        f"ms per inserted row (a sequential host loop); served recall@10="
        f"{rec:.4f} over the live rows; graph_beam_search launches="
        f"{delta['graph_beam_search']}")
    if np.isin(served, removed.cpu().numpy()).any():
        raise AssertionError("churn: a removed id was returned")
    if delta["graph_beam_search"] <= 0 or delta["graph_scan_beam_step"]:
        raise AssertionError("churn: the fused graph did not serve through "
                             "graph_beam_search alone")
    linked = np.isin(new_ids.cpu().numpy(), index.neighbors.cpu().numpy())
    log(f"    inserted rows with an in-edge: {int(linked.sum())} of "
        f"{CHURN_INSERTS}")

    def recall_live(ids):
        return serve.live_recall(engine, ds.queries_test, ids)

    fused_vs_gathered(K, testing, "churned graph", art, index, q,
                      GRAPH_EXPAND, recall_live)
    del engine, art, index
    log(f"  graph-path main-path launches (build, serving, churn): {main}")
    return hops, main, per_batch, searches


# ---------------------------------------------------------------------------
# Phase 3f: the serving operations layer.
# ---------------------------------------------------------------------------


def host_tier_run(K, label, make, queries, n_rows):
    """``make()`` -> (artifacts, index) with a rerank store no one else
    holds. Serve HOST_BATCHES batches with the store on the card, demote
    it, serve the same batches from pinned host memory. Raises unless the
    demotion freed n_rows * D * 4 bytes of device memory, the ids are
    equal bit for bit and the bytes the rerank's copies moved to the card
    equal the candidate rows' (host_bytes_ratio 1.00). Returns the
    launches of the scan's timing, which are not the path's."""
    from repro_torch.core import search as msearch
    from repro_torch.serve.engine import ServingEngine

    q5 = np.concatenate([queries] * HOST_BATCHES)
    art, index = make()
    engine = ServingEngine(msearch.make_state(art, index=index), k=10,
                           kappa=100, batch_size=1024, dim=512)
    ids_dev = engine.submit(q5)
    sd = engine.stats
    dev_p50, dev_p99, dev_qps = (sd.percentile_ms(50), sd.percentile_ms(99),
                                 sd.qps)
    qd = torch.as_tensor(queries, device="cuda")
    before = counts(K)
    scan_ms, _ = timed(lambda: msearch.state_candidates(qd, engine.state,
                                                        100), 3)
    timing = {k: v - before[k] for k, v in counts(K).items()}
    del engine, qd
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    art = msearch.demote_rerank_tier(art)
    torch.cuda.synchronize()
    t_demote = time.perf_counter() - t0
    mem1 = torch.cuda.memory_allocated()
    store = msearch.host_tier(art)
    engine = ServingEngine(msearch.make_state(art, index=index), k=10,
                           kappa=100, batch_size=1024, dim=512)
    del art, index
    t0 = time.perf_counter()
    ids_host = engine.submit(q5)
    wall = (time.perf_counter() - t0) * 1e3
    s = engine.stats
    same = np.array_equal(ids_dev, ids_host)
    freed = mem0 - mem1
    need = n_rows * 512 * 4
    log(f"  host tier {label}: demote {t_demote:.2f} s (pinned "
        f"{store.pinned}), device memory {mem0 / 1e9:.2f} -> "
        f"{mem1 / 1e9:.2f} GB (freed {freed / 1e9:.3f} GB, n*D*4 = "
        f"{need / 1e9:.3f} GB); ids of {HOST_BATCHES} batches "
        f"{'equal' if same else 'DIFFERENT'} to the device tier's; "
        f"host_bytes_ratio={s.host_bytes_ratio:.2f}")
    log(f"    device tier: p50={dev_p50:.1f}ms p99={dev_p99:.1f}ms "
        f"QPS={dev_qps:.0f}; host tier: p50={s.percentile_ms(50):.1f}ms "
        f"p99={s.percentile_ms(99):.1f}ms QPS={s.qps:.0f}; prefetch p50="
        f"{np.median(s.prefetch_ms):.2f}ms (host gather p50="
        f"{np.median(s.gather_ms):.2f}ms, H2D copy p50="
        f"{np.median(s.copy_ms):.2f}ms of {1024 * 100 * 512 * 4 / 1e6:.0f} "
        f"MB); {HOST_BATCHES} batches' wall {wall:.1f}ms against scan "
        f"{scan_ms:.2f}ms x {HOST_BATCHES} + prefetch sum "
        f"{sum(s.prefetch_ms):.1f}ms = "
        f"{scan_ms * HOST_BATCHES + sum(s.prefetch_ms):.1f}ms")
    if freed < need:
        raise AssertionError(f"host tier {label}: demotion freed "
                             f"{freed} B < n*D*4 = {need} B")
    if not same:
        raise AssertionError(f"host tier {label}: ids differ from the "
                             "device tier's")
    if s.host_bytes_ratio != 1.0:
        raise AssertionError(f"host tier {label}: host_bytes_ratio "
                             f"{s.host_bytes_ratio}")
    del engine
    torch.cuda.synchronize()
    return timing


@contextlib.contextmanager
def set_rows_spy():
    """Yield a list that receives the milliseconds of every
    ``HostStore.set_rows`` call made inside the block."""
    from repro_torch.core import rerank_tier
    inner = rerank_tier.HostStore.set_rows
    times = []

    def spy(self, ids, rows):
        t0 = time.perf_counter()
        out = inner(self, ids, rows)
        times.append((time.perf_counter() - t0) * 1e3)
        return out

    rerank_tier.HostStore.set_rows = spy
    try:
        yield times
    finally:
        rerank_tier.HostStore.set_rows = inner


def swap_spy(engine, deltas):
    """Record ``torch.cuda.memory_allocated`` around every swap of
    ``engine`` into ``deltas``."""
    inner = engine.swap

    def swap(state):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        inner(state)
        torch.cuda.synchronize()
        deltas.append(torch.cuda.memory_allocated() - before)

    engine.swap = swap


def open_loop(fe, queries, n_clients, deadline_ms=None):
    """Each of ``n_clients`` threads enqueues its share of ``queries`` (one
    request a row) without waiting, then collects its futures. Returns
    (served, refused) counts; every request is one or the other."""
    import threading
    from repro_torch.serve import frontend

    served, refused = [0] * n_clients, [0] * n_clients

    def client(c):
        futs = []
        for i in range(c, len(queries), n_clients):
            try:
                futs.append(fe.enqueue(queries[i], deadline_ms=deadline_ms))
            except frontend.Rejected:
                refused[c] += 1
        for f in futs:
            try:
                f.result(120)
                served[c] += 1
            except frontend.Rejected:
                refused[c] += 1

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(n_clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
        if t.is_alive():
            raise AssertionError("a frontend client did not finish")
    return sum(served), sum(refused)


def phase_ops(K, ds, x, sph, glv):
    """The serving operations layer on phase 3's data and fits: the host
    rerank tier (flat gleanvec-int8-sorted and sphering-int8, the aligned
    IVF), the guarded lifecycle of a stream with the store in host memory
    and every lifecycle drill, and the coalescing frontend with a
    background refresh worker and every frontend drill. Returns the path's
    launches."""
    import shutil
    import tempfile
    import threading

    from repro_torch.core import search as msearch
    from repro_torch.core import streaming
    from repro_torch.index import ivf
    from repro_torch.launch import serve
    from repro_torch.serve import faults, frontend, lifecycle
    from repro_torch.serve.engine import ServingEngine

    dev = torch.device("cuda")
    queries = ds.queries_test
    log(f"phase 3f: serving operations, n={N_ROWS} D=512 d=160 C=48 "
        "batch=1024 k=10 kappa=100")
    t_phase = time.perf_counter()
    for fn in all_counters(K):
        fn.launches = 0

    def flat(mode, model):
        return lambda: (msearch.build_artifacts(mode, x.clone(), model,
                                                device=dev), None)

    def aligned():
        xc = x.clone()
        art = msearch.build_artifacts("gleanvec-int8-sorted", xc, glv,
                                      device=dev)
        idx = ivf.with_reduced_centers(
            ivf.build_aligned(glv, xc, nprobe=IVF_NPROBE, device=dev),
            art.scorer, glv)
        return art, idx

    timings = [host_tier_run(K, "flat gleanvec-int8-sorted",
                             flat("gleanvec-int8-sorted", glv), queries,
                             N_ROWS),
               host_tier_run(K, "flat sphering-int8",
                             flat("sphering-int8", sph), queries, N_ROWS),
               host_tier_run(K, "aligned IVF gleanvec-int8-sorted",
                             aligned, queries, N_ROWS)]

    # -- the guarded lifecycle of a stream, store in host memory ----------
    mode, n0, cap = "gleanvec-int8-sorted", STREAM_N0, N_ROWS
    obs = queries[:1024]
    t0 = time.perf_counter()
    slack = serve.stream_slack_blocks(glv, x[n0:])
    state = serve.build_stream(mode, x, n0, cap, glv, slack_blocks=slack,
                               host_rerank=True, device=dev)
    engine = ServingEngine(state, k=10, kappa=100, batch_size=1024, dim=512)
    guarded = lifecycle.GuardedEngine(engine, canary_queries=obs,
                                      min_overlap=OPS_MIN_OVERLAP)
    supervisor = lifecycle.RefreshSupervisor(guarded)
    rng = np.random.default_rng(0)
    q_init = ds.database[rng.integers(0, n0, 1024)] \
        + 0.1 * rng.standard_normal((1024, 512)).astype(np.float32)
    stream = streaming.init_from_artifacts(state.artifacts, q_init,
                                           refresh_every=STREAM_INSERTS)
    del state
    torch.cuda.synchronize()
    deltas = []
    swap_spy(engine, deltas)
    log(f"  guarded stream ({mode}, capacity {cap}, n0 {n0}, host tier, "
        f"canary one batch, min_overlap {OPS_MIN_OVERLAP}): build "
        f"{time.perf_counter() - t0:.1f} s")
    for cycle in range(STREAM_CYCLES):
        mask = streaming.live_mask(guarded.state.artifacts)
        live = int(mask.sum())
        if not bool(mask[:live].all()):     # live ids are 0 .. live - 1
            raise AssertionError("guarded stream: live ids not contiguous")
        served = guarded.submit(obs)
        supervisor.note_queries(obs)
        gt = vectors_exact(obs, x[:live])
        rec = recall(served, gt)
        stream = streaming.observe_queries(stream, obs)
        rows = x[live:live + STREAM_INSERTS]
        n_swaps = len(deltas)
        t0 = time.perf_counter()
        with set_rows_spy() as set_ms:
            stream = serve.stream_insert(guarded, stream, rows)
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        stream, rep = supervisor.refresh_and_swap(stream)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        log(f"    cycle {cycle}: recall@10={rec:.4f} (floor "
            f"{STREAM_FLOORS[mode][cycle]}) insert={(t1 - t0) * 1e3:.1f}ms "
            f"(the host store's set_rows {sum(set_ms):.1f}ms, no new "
            f"buffer) refresh={(t2 - t1) * 1e3:.1f}ms ({rep.outcome}/"
            f"{rep.source}, cond {rep.condition:.3g}, attempts "
            f"{rep.attempts}) version="
            f"{guarded.version} swaps' device-memory deltas "
            f"{deltas[n_swaps:]} B; canary overlap "
            f"{guarded.health.last_overlap:.3f}"
            + (f"; failed attempts: {rep.errors}" if rep.errors else ""))
        if rep.outcome != "ok" or len(deltas) != n_swaps + 2:
            raise AssertionError(f"guarded stream cycle {cycle}: a swap "
                                 "was refused")
        if rec < STREAM_FLOORS[mode][cycle]:
            raise AssertionError(f"guarded stream cycle {cycle}: recall@10 "
                                 f"{rec:.4f} below its floor")
    if lifecycle.nonfinite_leaves(guarded.state):
        raise AssertionError("guarded stream: non-finite served state")

    # every lifecycle drill once, as the CLI's --inject-fault defines it
    for kind in ("corrupt-scorer", "scramble-scorer", "poison-queries",
                 "wrong-dim-queries"):
        t0 = time.perf_counter()
        serve._fault_drill(kind, guarded, supervisor, stream, obs, None)
        log(f"    ({kind}: {time.perf_counter() - t0:.1f} s)")
    for kind in ("refresh-exception", "nan-moments"):
        t0 = time.perf_counter()
        drilled, fn, check = serve._fault_drill(kind, guarded, supervisor,
                                                stream, obs, None)
        drilled, rep = supervisor.refresh_and_swap(drilled, refresh_fn=fn)
        check(rep)
        if kind == "refresh-exception":
            stream = drilled
        else:
            recovered = supervisor.recover(drilled)
            stream, rep = supervisor.refresh_and_swap(recovered)
            if rep.outcome != "ok" or supervisor.n_recoveries < 1:
                serve._drill_fail("post-recovery refresh did not swap")
            log("  drill PASS: nan-moments -> degraded -> recovered -> "
                "swapped")
        log(f"    ({kind}: {time.perf_counter() - t0:.1f} s)")
    if any(deltas):
        raise AssertionError(f"a swap allocated device memory: {deltas}")
    log(f"  {len(deltas)} swaps, device-memory deltas all 0 B")

    # the snapshot drill on a store of the first SNAPSHOT_ROWS rows
    t0 = time.perf_counter()
    m, m0 = SNAPSHOT_ROWS, int(SNAPSHOT_ROWS * 0.7)
    small = serve.build_stream(
        mode, x[:m], m0, m, glv,
        slack_blocks=serve.stream_slack_blocks(glv, x[m0:m]),
        host_rerank=True, device=dev)
    s_eng = ServingEngine(small, k=10, kappa=100, batch_size=1024, dim=512)
    s_guard = lifecycle.GuardedEngine(s_eng, canary_queries=obs,
                                      min_overlap=OPS_MIN_OVERLAP)
    s_stream = streaming.init_from_artifacts(small.artifacts, q_init)
    snap_dir = tempfile.mkdtemp(prefix="smoke-snap-")
    try:
        log(f"  truncated-snapshot drill on a store of the first {m} rows "
            "(cut from the full store to bound disk and time)")
        serve._fault_drill("truncated-snapshot", s_guard,
                           lifecycle.RefreshSupervisor(s_guard), s_stream,
                           obs, snap_dir)
    finally:
        shutil.rmtree(snap_dir, ignore_errors=True)
    log(f"    (truncated-snapshot: {time.perf_counter() - t0:.1f} s)")
    del small, s_eng, s_guard, s_stream

    # -- the coalescing frontend with a background refresh worker ---------
    worker = frontend.RefreshWorker(supervisor, stream).start()
    fe = frontend.ServingFrontend(guarded, capacity=FRONTEND_REQUESTS)
    try:
        log(f"  frontend: buckets {fe.buckets}, batch shapes run "
            f"{engine.n_compiles}")
        traffic = np.concatenate(
            [queries] * (FRONTEND_REQUESTS // len(queries)))
        st = engine.stats
        base = (st.n_rejected, st.n_shed, len(st.request_ms))
        t0 = time.perf_counter()
        n_ok, n_ref = open_loop(fe, traffic, FRONTEND_CLIENTS)
        wall = time.perf_counter() - t0
        req = list(st.request_ms)[base[2]:]
        rej, shed = st.n_rejected - base[0], st.n_shed - base[1]
        log(f"    {FRONTEND_CLIENTS} clients x "
            f"{FRONTEND_REQUESTS // FRONTEND_CLIENTS} requests, no deadline: "
            f"served {n_ok} in {wall:.2f} s, request p50="
            f"{np.percentile(req, 50):.1f}ms p99={np.percentile(req, 99):.1f}"
            f"ms, buckets used {sorted(fe.dispatched_shapes)}, "
            f"n_rejected={rej} n_shed={shed}")
        if n_ok != FRONTEND_REQUESTS or rej or shed:
            raise AssertionError("frontend: requests refused without a "
                                 "deadline")
        batch_p50 = float(np.percentile(list(st.latencies_ms)[-64:], 50))
        deadline = 2 * batch_p50
        before = (st.n_queries, st.n_rejected, st.n_shed)
        n_ok, n_ref = open_loop(fe, traffic, FRONTEND_CLIENTS,
                                deadline_ms=deadline)
        off = n_ok + n_ref
        log(f"    same traffic, deadline {deadline:.1f}ms (2 x batch p50 "
            f"{batch_p50:.1f}ms): served {n_ok}, rejected "
            f"{st.n_rejected - before[1]}, shed {st.n_shed - before[2]}, "
            f"shed_rate {n_ref / off:.3f} (a reading)")

        # serving overlaps a full-width refresh: the worker's first cycle
        # (its stream's first allocations) and its second
        for nth in ("first", "second"):
            stop = threading.Event()
            spans0 = len(fe.batch_spans)

            def keep_serving():
                while not stop.is_set():
                    serve.frontend_traffic(fe, queries[:64], n_clients=4)

            feeder = threading.Thread(target=keep_serving)
            feeder.start()
            try:
                time.sleep(0.5)
                n_cycles = worker.n_cycles
                worker.observe(obs)
                worker.request_refresh()
                if not serve._await(lambda: worker.n_cycles > n_cycles, 60):
                    raise AssertionError("frontend: the refresh never "
                                         "finished")
                time.sleep(0.5)
            finally:
                stop.set()
                feeder.join(120)
            c0, c1 = worker.cycle_spans[-1]
            spans = list(fe.batch_spans)[spans0:]
            inside = [(b1 - b0) * 1e3 for b0, b1 in spans
                      if b0 >= c0 and b1 <= c1]
            outside = [(b1 - b0) * 1e3 for b0, b1 in spans
                       if b1 < c0 or b0 > c1]
            p_in = np.percentile(inside, 50) if inside else float("nan")
            p_out = np.percentile(outside, 50) if outside else float("nan")
            log(f"    the worker's {nth} refresh, {(c1 - c0) * 1e3:.0f}ms on "
                f"its stream ({worker.supervisor.reports[-1].outcome}): "
                f"{len(inside)} dispatcher batches started and finished "
                f"inside it, p50 {p_in:.2f}ms inside, {p_out:.2f}ms outside "
                f"({len(outside)} batches)")
            if not inside:
                raise AssertionError("frontend: no batch completed inside "
                                     "the refresh")
            if worker.supervisor.reports[-1].outcome != "ok":
                raise AssertionError("frontend: the background refresh "
                                     "failed")

        # one batch through search_with (the dispatcher's call), alone and
        # beside a one-batch canary loop on a side stream
        def one_batch_ms(b, reps):
            out = []
            for _ in range(reps):
                t = time.perf_counter()
                engine.search_with(queries[:b], engine.state)
                out.append((time.perf_counter() - t) * 1e3)
            return float(np.median(out))

        sizes = {8: 30, 64: 30, 1024: 10}
        alone = {b: one_batch_ms(b, r) for b, r in sizes.items()}
        stop = threading.Event()
        canary_stream = torch.cuda.Stream()

        def canary_loop():
            with torch.cuda.stream(canary_stream):
                while not stop.is_set():
                    engine.search_with(obs, engine.state)

        looper = threading.Thread(target=canary_loop)
        looper.start()
        try:
            time.sleep(0.3)
            beside = {b: one_batch_ms(b, r) for b, r in sizes.items()}
        finally:
            stop.set()
            looper.join(60)
        log("    search_with over the host tier, median ms by batch: alone "
            + ", ".join(f"{b}: {v:.2f}" for b, v in alone.items())
            + "; beside a 1024-query search_with loop on a side stream "
            + ", ".join(f"{b}: {v:.2f}" for b, v in beside.items()))

        # coalesced ids equal submit's, one bucket of each size
        fe_b = frontend.ServingFrontend(guarded, capacity=1024, start=False,
                                        warmup=False)
        for b in fe.buckets:
            futs = [fe_b.enqueue(q) for q in queries[:b]]
            fe_b.drain_once()
            got = np.stack([f.result(60) for f in futs])
            if not np.array_equal(got, guarded.submit(queries[:b])):
                raise AssertionError(f"frontend: bucket {b}'s ids differ "
                                     "from submit's")
        log(f"    coalesced ids equal submit's in every bucket "
            f"{fe.buckets}")

        # every frontend drill once
        for kind in faults.FRONTEND_FAULTS:
            t0 = time.perf_counter()
            fn, release = serve.drill_refresh_fn(kind)
            worker.refresh_fn = fn
            try:
                serve.frontend_drill(kind, FRONTEND_DRILL_BATCH, 512, fe,
                                     guarded, worker, fn, release, queries)
            finally:
                if release is not None:
                    release.set()
                worker.refresh_fn = streaming.refresh
            log(f"    ({kind}: {time.perf_counter() - t0:.1f} s)")
        if lifecycle.nonfinite_leaves(guarded.state):
            raise AssertionError("frontend: non-finite served state")
    finally:
        fe.close()
        stopped = worker.stop(timeout=60)
    if not stopped or worker.crashed is not None:
        raise AssertionError(f"frontend: worker did not stop cleanly "
                             f"(crashed={worker.crashed!r})")
    timing = {k: sum(t[k] for t in timings) for k in timings[0]}
    launches = {k: v - timing[k] for k, v in counts(K).items()}
    log(f"  serving-operations launches: {launches}; the host tier's scan "
        f"timings' (not counted): {timing} "
        f"({time.perf_counter() - t_phase:.0f} s)")
    for name in ("gleanvec_sq_topk", "ip_topk", "ivf_scan_topk",
                 "kmeans_assign"):
        if launches[name] <= 0:
            raise AssertionError(f"{name} was not launched on the serving "
                                 "operations path")
    del guarded, supervisor, engine, stream, worker, fe
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return launches


def vectors_exact(queries, rows):
    from repro_torch.data import vectors
    return vectors.exact_topk(queries, rows, 10, device=torch.device("cuda"))


def recall(ids, gt) -> float:
    from repro_torch.core import metrics
    return metrics.recall_at_k(ids, gt)


# ---------------------------------------------------------------------------
# Phase 3g: the sharded placement.
# ---------------------------------------------------------------------------


def serve_reading(engine, queries, batches: int = 5):
    """Serve ``batches`` batches; (ids of the last, stats)."""
    ids = None
    for _ in range(batches):
        ids = engine.submit(queries)
    return ids, engine.stats


def reading(label, st, rec, build_s, peak, launches) -> str:
    return (f"{label}: build={build_s:.2f}s batches={st.n_batches} "
            f"QPS={st.qps:.0f} p50={st.percentile_ms(50):.2f}ms "
            f"p99={st.percentile_ms(99):.2f}ms recall@10={rec:.4f} "
            f"peak={peak / 1e9:.2f}GB launches/batch={launches}")


def per_batch_launches(delta, batches: int) -> dict:
    """Launches a batch of each kernel a serving run launched (the
    engine's warm-up batch is one more)."""
    return {k: v / (batches + 1) for k, v in delta.items() if v}


def sharded_run(K, label, make, queries, gt, floor):
    """Build (``make() -> (artifacts, index)``, timed) and serve 5 batches
    behind a ServingEngine, counters read just after; the peak device
    memory over the build and the serving above what was held before.
    Returns (engine, ids, launches of the build and serving, stats)."""
    from repro_torch.core import metrics
    from repro_torch.core import search as msearch
    from repro_torch.serve.engine import ServingEngine

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    before = counts(K)
    t0 = time.perf_counter()
    art, index = make()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    built = {k: v - before[k] for k, v in counts(K).items()}
    engine = ServingEngine(msearch.make_state(art, index=index), k=10,
                           kappa=100, batch_size=1024, dim=512)
    ids, st = serve_reading(engine, queries)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    delta = {k: v - before[k] for k, v in counts(K).items()}
    rec = metrics.recall_at_k(ids, gt)
    served = {k: v - built[k] for k, v in delta.items()}
    line = reading(label, st, rec, build_s, peak,
                   per_batch_launches(served, st.n_batches))
    log(f"  {line} (floor {floor})")
    if ids.shape != (1024, 10) or not np.all(ids >= -1):
        raise AssertionError(f"{label}: malformed ids {ids.shape}")
    if rec < floor:
        raise AssertionError(f"{label}: recall@10 {rec:.4f} below its "
                             f"floor {floor}")
    return engine, ids, delta, st


def table_rows(kind: str, mode: str, delta: dict) -> dict:
    """The kernel table's row of each kernel a sharded run launched."""
    rows = {"kmeans_assign": "kmeans_assign[C=48]"}
    if kind == "flat":
        rows["ip_topk"] = f"ip_topk[{mode}]"
        rows["gleanvec_sq_topk"] = f"gleanvec_sq_topk[{mode}]"
    elif kind == "ivf":
        rows["ivf_scan_topk"] = f"ivf_scan_topk[{mode}]"
    else:
        rows["graph_beam_search"] = (f"graph_beam_search[{mode} expand="
                                     f"{GRAPH_EXPAND} B={GRAPH_BEAM}]")
        rows["ip_topk"] = "ip_topk[graph self-join d=513 k=49]"
    out = {}
    for k, v in delta.items():
        if v:
            if k not in rows:
                raise AssertionError(f"sharded {kind} {mode}: {k} launched "
                                     "outside its path's kernels")
            out[rows[k]] = out.get(rows[k], 0) + v
    return out


def add_launches(table: list, extra: dict) -> None:
    """Add a phase's launches (3g, 3j) to the kernel table's rows."""
    names = {row["name"]: row for row in table}
    for name, v in extra.items():
        if name not in names:
            raise AssertionError(f"no kernel-table row {name} for "
                                 f"{v} launches")
        names[name]["launches"] += v


def merge_counts(acc: dict, more: dict) -> None:
    for k, v in more.items():
        acc[k] = acc.get(k, 0) + v


def log_layout_and_split(index, stacked, single, q, single_call):
    """The rows a sharded scorer stores (its sorted layouts pad each
    cluster of each shard to whole blocks) beside the single-device
    scorer's, and the device time by kernel of one candidates call of
    each (``torch.profiler``)."""
    rows = stacked.codes if hasattr(stacked, "codes") else stacked.x_low
    one = single.codes if hasattr(single, "codes") else single.x_low
    log(f"    stored rows: sharded {rows.shape[0]} x {rows.shape[1]} = "
        f"{rows.shape[0] * rows.shape[1]} against {one.shape[0]}")
    log("    device time by kernel, one search of the batch (torch.profiler)"
        f": single-device: {device_breakdown(single_call)}")
    split = device_breakdown(lambda: index.search(q, stacked, 100))
    log(f"      sharded: {split}")


def refresh_swap(label, engine, index, stacked, model, queries, ids):
    """(e) ``ShardedIndex.refreshed`` under the same model and
    ``engine.swap``: the swap check accepts the restacked index and the
    ids of the next batch are ``ids``."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    new = index.refreshed(stacked, model)
    engine.swap(engine.state._replace(index=new))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    same = np.array_equal(engine.submit(queries), ids)
    log(f"  (e) {label}: ShardedIndex.refreshed + engine.swap under the "
        f"same model accepted ({ms:.1f} ms), ids "
        f"{'unchanged' if same else 'CHANGED'}")
    if not same:
        raise AssertionError(f"{label}: the refreshed swap changed the ids")


def phase_sharded(K, testing, ds, x, glv, sph, single_graph):
    """The sharded placement (``distributed.build_sharded_index``, S =
    SHARDS, searched one shard after the other on the card) on phase 3's
    data and fits, each run beside the single-device run of the same
    call. Returns {kernel-table row: launches of the sharded main path}."""
    from repro_torch.analysis.trace_rules import sync_count
    from repro_torch.core import rerank_tier
    from repro_torch.core import scorer as sc
    from repro_torch.core import search as msearch
    from repro_torch.data import vectors
    from repro_torch.index import distributed, ivf
    from repro_torch.index.protocol import FlatIndex
    from repro_torch.serve.engine import ServingEngine

    dev = torch.device("cuda")
    block = inspect.signature(distributed.build_sharded_index) \
        .parameters["sort_block"].default
    log(f"phase 3g: sharded placement, S={SHARDS} shards searched one after "
        f"the other, n={N_ROWS} D=512 d=160 C=48 batch=1024 k=10 kappa=100 "
        f"(sharded layout block {block}, the default --shards serves; the "
        f"single-device runs keep build_scorer's 4096)")
    t_phase = time.perf_counter()
    q = torch.as_tensor(ds.queries_test, device=dev)
    gt = ds.gt[:, :10]
    extra = {}

    def tol_of(stacked):
        tol = 0.0
        for s in range(stacked[0].shape[0]):
            one = distributed._take_shard(stacked, s)
            qs, lo = one.prepare_queries(q), 0.0
            if isinstance(qs, tuple):
                qs, lo = qs.q_scaled, float(qs.q_lo.abs().max())
            rows = one.x_low if hasattr(one, "x_low") else one.codes
            tol = max(tol, testing.dot_tol(row_norm_max(qs),
                                           row_norm_max(rows), rows.shape[1],
                                           lo))
        return tol

    # -- (a) the flat path ------------------------------------------------
    for mode in SHARD_FLAT_MODES:
        model = sph if mode.startswith("sphering") else glv
        floor = RECALL_FLOORS[mode]
        single_scorer = {}

        def make_single():
            art = msearch.build_artifacts(mode, x, model, device=dev)
            single_scorer["s"] = art.scorer
            return art, None

        for fn in all_counters(K):
            fn.launches = 0
        eng_1, ids_1, _, _ = sharded_run(
            K, f"flat {mode} single", make_single, ds.queries_test, gt, floor)
        del eng_1
        for fn in all_counters(K):
            fn.launches = 0
        built = {}

        def make_sharded():
            sh, st = distributed.build_sharded_index(
                "flat", mode, x, model, n_shards=SHARDS, device=dev)
            built["index"], built["scorer"] = sh, st
            return msearch.SearchArtifacts(scorer=st, x_full=x,
                                           model=model), sh

        eng_s, ids_s, delta, st_s = sharded_run(
            K, f"flat {mode} S={SHARDS}", make_sharded, ds.queries_test, gt,
            floor)
        kernel = "ip_topk" if mode.startswith("sphering") \
            else "gleanvec_sq_topk"
        if delta[kernel] != SHARDS * (st_s.n_batches + 1):
            raise AssertionError(f"sharded flat {mode}: {delta[kernel]} "
                                 f"{kernel} launches, not {SHARDS} a batch")
        merge_counts(extra, table_rows("flat", mode, delta))
        sh, st = built["index"], built["scorer"]
        single = single_scorer["s"]
        got = sh.search(q, st, 100)
        want = FlatIndex().search(q, single, 100)
        same10 = float(np.mean(np.sort(ids_s, 1) == np.sort(ids_1, 1)))
        log(f"    candidates (kappa 100) sharded vs single-device: "
            f"overlap={overlap(got[1], want[1]):.4f}; final top-10 equal "
            f"in {same10:.4f} of the slots (sorted per query)")
        log_layout_and_split(sh, st, single, q, lambda: FlatIndex().search(
            q, single, 100))
        if mode in SHARD_EXACT_MODES:
            check_topk(f"  flat {mode} sharded vs single-device candidates "
                       "(a row's encoding does not depend on its shard)",
                       got, want, tol_of(st), testing)
        else:
            one = testing.sharded_as_one(st)
            tol = max(tol_of(st), tol_of(distributed.stack_shards([one])))
            check_topk(f"  flat {mode} sharded vs one scan of the shards' "
                       "own int8 encodings (testing.sharded_as_one; each "
                       "shard fits its own scales)", got,
                       FlatIndex().search(q, one, 100), tol, testing)
            del one
        if mode == "sphering-int8":
            tol = tol_of(distributed.stack_shards([single]))
            check_topk(f"  flat {mode} the single-device scorer in "
                       f"{SHARDS} row shards (shard_rows, globalize_ids), "
                       "merged, vs its scan", testing.row_shards_merged(
                           q, single, SHARDS, 100), want, tol, testing)
        del eng_s, got, want, single, single_scorer, built, sh, st

    # -- (d) the host tier over (a): per-shard host buffers ---------------
    mode = SHARD_HOST_MODE
    q5 = np.concatenate([ds.queries_test] * HOST_BATCHES)
    kw = dict(n_shards=SHARDS, device=dev)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    before = counts(K)
    sh, art = distributed.build_sharded_artifacts("flat", mode, x.clone(),
                                                  glv, **kw)
    torch.cuda.synchronize()
    held_dev = torch.cuda.memory_allocated() - base
    engine = ServingEngine(msearch.make_state(art, index=sh), k=10,
                           kappa=100, batch_size=1024, dim=512)
    ids_dev, sd = serve_reading(engine, q5, 1)
    del engine, art, sh
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    xc = x.clone()
    sh, art = distributed.build_sharded_artifacts("flat", mode, xc, glv,
                                                  spill_host=True, **kw)
    del xc
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    held_host = torch.cuda.memory_allocated() - base
    store = msearch.host_tier(art)
    engine = ServingEngine(msearch.make_state(art, index=sh), k=10,
                           kappa=100, batch_size=1024, dim=512)
    ids_host, s = serve_reading(engine, q5, 1)
    merge_counts(extra, table_rows("flat", mode, {
        k: v - before[k] for k, v in counts(K).items()}))
    freed = held_dev - held_host
    need = N_ROWS * 512 * 4
    same = np.array_equal(ids_dev, ids_host)
    single = art._replace(x_full=rerank_tier.demote(x))
    eng_1 = ServingEngine(msearch.make_state(single, index=sh), k=10,
                          kappa=100, batch_size=1024, dim=512)
    ids_1, s1 = serve_reading(eng_1, q5, 1)
    log(f"  (d) host tier, build_sharded_artifacts(spill_host=True) "
        f"{t_build:.2f} s: {type(store).__name__} of {store.n_shards} "
        f"shards (pinned {store.pinned}); device memory held "
        f"{held_dev / 1e9:.3f} -> {held_host / 1e9:.3f} GB (freed "
        f"{freed / 1e9:.3f} GB, "
        f"n*D*4 = {need / 1e9:.3f} GB); ids of {HOST_BATCHES} batches "
        f"{'equal' if same else 'DIFFERENT'} to the device tier's; "
        f"host_bytes_ratio={s.host_bytes_ratio:.2f}")
    log(f"    device tier p50={sd.percentile_ms(50):.2f}ms QPS={sd.qps:.0f}; "
        f"ShardedHostStore p50={s.percentile_ms(50):.2f}ms "
        f"p99={s.percentile_ms(99):.2f}ms QPS={s.qps:.0f} gather p50="
        f"{np.median(s.gather_ms):.2f}ms copy p50={np.median(s.copy_ms):.2f}"
        f"ms; one HostStore of the same rows behind the same index p50="
        f"{s1.percentile_ms(50):.2f}ms QPS={s1.qps:.0f} gather p50="
        f"{np.median(s1.gather_ms):.2f}ms (ids "
        f"{'equal' if np.array_equal(ids_1, ids_host) else 'DIFFERENT'})")
    if freed < need or not same or s.host_bytes_ratio != 1.0 \
            or not np.array_equal(ids_1, ids_host):
        raise AssertionError("sharded host tier: memory, ids or bytes wrong")
    del engine, eng_1, art, single, sh, store

    # -- (b) the aligned IVF ----------------------------------------------
    for mode in SHARD_IVF_MODES:
        floor = IVF_RECALL_FLOORS[mode]
        single_parts = {}

        def make_single():
            scorer = sc.build_scorer(mode, x, glv, device=dev)
            index = ivf.with_reduced_centers(
                ivf.build_aligned(glv, x, nprobe=IVF_NPROBE, device=dev),
                scorer, glv)
            single_parts["p"] = (scorer, index)
            return msearch.SearchArtifacts(scorer=scorer, x_full=x,
                                           model=glv), index

        for fn in all_counters(K):
            fn.launches = 0
        eng_1, ids_1, _, _ = sharded_run(
            K, f"ivf {mode} single", make_single, ds.queries_test, gt, floor)
        del eng_1
        for fn in all_counters(K):
            fn.launches = 0
        built = {}

        def make_sharded():
            sh, st = distributed.build_sharded_index(
                "ivf", mode, x, glv, n_shards=SHARDS, aligned=True,
                reduced_probe=True, nprobe=IVF_NPROBE, device=dev)
            built["p"] = (sh, st)
            return msearch.SearchArtifacts(scorer=st, x_full=x,
                                           model=glv), sh

        eng_s, ids_s, delta, st_s = sharded_run(
            K, f"ivf {mode} S={SHARDS}", make_sharded, ds.queries_test, gt,
            floor)
        if delta["ivf_scan_topk"] != SHARDS * (st_s.n_batches + 1):
            raise AssertionError(f"sharded ivf {mode}: "
                                 f"{delta['ivf_scan_topk']} ivf_scan_topk "
                                 f"launches, not {SHARDS} a batch")
        merge_counts(extra, table_rows("ivf", mode, delta))
        sh, st = built["p"]
        scorer, index = single_parts["p"]
        got = sh.search(q, st, 100)
        want = index.search(q, scorer, 100)
        same10 = float(np.mean(np.sort(ids_s, 1) == np.sort(ids_1, 1)))
        log(f"    candidates sharded vs single-device: overlap="
            f"{overlap(got[1], want[1]):.4f}; final top-10 equal in "
            f"{same10:.4f} of the slots")
        log_layout_and_split(sh, st, scorer, q, lambda: index.search(
            q, scorer, 100))
        if mode in SHARD_EXACT_MODES:
            check_topk(f"  ivf {mode} sharded vs single-device candidates "
                       "(one quantizer serves every shard)", got, want,
                       tol_of(st), testing)
        else:
            refresh_swap(f"ivf {mode}", eng_s, sh, st, glv, ds.queries_test,
                         ids_s)
        per, parts = x.shape[0] // SHARDS, []
        for s in range(SHARDS):
            rows = x[s * per:(s + 1) * per]
            one = sc.build_scorer(mode, rows, glv, block=block, device=dev)
            idx = ivf.with_reduced_centers(ivf.build_aligned(
                glv, rows, nprobe=IVF_NPROBE, device=dev), one, glv)
            vals, ids = idx.search(q, one, 100)
            parts.append((vals, idx.globalize_ids(one, ids, s * per)))
            del one, idx
        check_topk(f"  ivf {mode} sharded vs each shard built on its own "
                   "(build_aligned + with_reduced_centers over its rows, its "
                   "own scorer), searched alone, lifted, merged by hand",
                   got, testing.merged_shards(parts, 100), tol_of(st),
                   testing)
        del parts
        del eng_s, got, want, built, single_parts, sh, st, scorer, index

    # -- (c) the fused graph on the first GRAPH_ROWS rows -----------------
    mode = "gleanvec-int8-sorted"
    xg = x[:GRAPH_ROWS]
    gt_g = vectors.exact_topk(ds.queries_test, xg, 10, device=dev)
    for fn in all_counters(K):
        fn.launches = 0
    built = {}

    def make_graph():
        sh, st = distributed.build_sharded_index(
            "graph", mode, xg, glv, n_shards=SHARDS, beam=GRAPH_BEAM,
            max_hops=GRAPH_HOPS, expand=GRAPH_EXPAND, fused_graph=True,
            graph_kwargs={"r": 24, "n_random": 4, "n_entries": 16,
                          "seed": 0, "method": "device"}, device=dev)
        built["p"] = (sh, st)
        return msearch.SearchArtifacts(scorer=st, x_full=xg, model=glv), sh

    floor = GRAPH_RECALL_FLOORS[mode]
    eng_s, ids_s, delta, st_s = sharded_run(
        K, f"graph {mode} fused S={SHARDS} (n={GRAPH_ROWS})", make_graph,
        ds.queries_test, gt_g, floor)
    merge_counts(extra, table_rows("graph", mode, delta))
    sh, st = built["p"]
    searches = delta["graph_beam_search"]
    if searches != SHARDS * (st_s.n_batches + 1) \
            or delta["graph_scan_beam_step"]:
        raise AssertionError(f"sharded graph: {searches} graph_beam_search "
                             f"launches, not {SHARDS} a batch")
    qs = sh.prepare_queries(st, q)
    syncs_cand = sync_count(lambda: sh.candidates(qs, st, 100))
    syncs_batch = sync_count(lambda: eng_s.submit(ds.queries_test))
    one = single_graph[mode]
    log(f"    host syncs: {syncs_batch} a batch, {syncs_cand} in candidates "
        f"(single-device, phase 3d: {one['syncs']} a batch, "
        f"{one['syncs_cand']} in candidates); single-device: build="
        f"{one['build_s']:.2f}s QPS={one['qps']:.0f} p50={one['p50']:.2f}ms "
        f"p99={one['p99']:.2f}ms recall@10={one['recall']:.4f} "
        f"graph_beam_search/batch={one['search']:.0f}, hops {one['hops']}")
    if syncs_cand:
        raise AssertionError(f"sharded graph: {syncs_cand} host syncs inside "
                             "candidates")
    gathered = dataclasses.replace(sh, sub_index=dataclasses.replace(
        sh.sub_index, fused=False, nbr_rows=None))
    cf = sh.candidates(qs, st, 100)
    cg = gathered.candidates(qs, st, 100)
    ov = overlap(cf[1], cg[1])
    log(f"    fused vs gathered per-shard graphs (padding rows of the "
        f"stacked layouts never reached): kappa-candidate overlap={ov:.4f} "
        f"(min {GRAPH_MIN_OVERLAP})")
    if ov < GRAPH_MIN_OVERLAP:
        raise AssertionError("sharded graph: fused and gathered disagree")
    refresh_swap(f"graph {mode}", eng_s, sh, st, glv, ds.queries_test,
                 eng_s.submit(ds.queries_test))
    del eng_s, sh, st, built, gathered, cf, cg
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"  sharded main-path launches by kernel-table row: {extra} "
        f"({time.perf_counter() - t_phase:.0f} s)")
    return extra


# ---------------------------------------------------------------------------
# Phase 3h: the contract audit.
# ---------------------------------------------------------------------------


def phase_contracts(K, ds, x, sph, glv, states, searches):
    """The contract audit on the card: (a) ``run_audit`` over the serving
    matrix (7 modes x 5 topologies, the reference's small shapes), then
    (b) the trace rules at full width on the states of phases 3-3g (built
    again where a phase freed them). Any failure ``KNOWN_DEVIATIONS`` does
    not list, or a listed one that passes, fails the phase. Counters zeroed
    just before and read just after (the audit's launches are checks: they
    stay out of the kernel table)."""
    from repro_torch.analysis import run, trace_rules as tr
    from repro_torch.analysis.registry import run_rules
    from repro_torch.core import search as msearch
    from repro_torch.core import streaming
    from repro_torch.index import distributed, graph, ivf
    from repro_torch.launch import serve
    from repro_torch.serve.engine import ServingEngine

    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    for fn in all_counters(K):
        fn.launches = 0
    log("phase 3h: contract audit (repro_torch.analysis) -- (a) the "
        f"matrix: {run.N} rows, D={run.D}, d={run.D_LOW}, C={run.C}, "
        f"batch {run.M}, kappa {run.KAPPA}")
    report = run.run_audit(out=None, device=dev,
                           log=lambda m: log("  " + m))
    for topo in run.TOPOLOGIES:
        cells = [t for c, t in report.cells.items()
                 if c.startswith(topo + "/")]
        counted = [t.n_kernels for t in cells if t.n_kernels is not None]
        log(f"  {topo}: most syncs {max(t.syncs for t in cells)}, most "
            f"device kernels {max(counted, default='not counted')}, largest "
            f"peak above start {max(t.peak_bytes for t in cells) / 1e6:.3f}"
            " MB over its 7 cells")
    if report.code:
        raise AssertionError(
            f"contract audit: {len(report.unlisted)} unlisted failures, "
            f"stale listings {report.stale}")

    log(f"  (b) full width: n={N_ROWS} D=512 d=160 C=48 batch=1024, "
        "state_candidates of each cell traced (ops, syncs, peak memory "
        "above the start, device kernels)")
    q = torch.as_tensor(ds.queries_test, device=dev)
    results = []

    def cell(target, fn, args, rules):
        t = tr.StepTrace.of(fn, *args, label=target)
        res = run_rules(t, [tr.NoHostSyncInStep(), *rules], target=target)
        results.extend(res)
        bad = [r for r in res if not r.passed]
        log(f"    {target}: {'FAIL' if bad else 'ok'} syncs={t.syncs} "
            f"device kernels={t.n_kernels} peak above start="
            f"{t.peak_bytes / 1e6:.1f} MB ops={len(t.ops)}"
            + "".join(f"; {r.rule}: {r.evidence}" for r in bad))
        return t

    for mode in states:
        scorer, _, kappa = states[mode]
        art = msearch.SearchArtifacts(scorer=scorer, x_full=x)
        budget = [tr.NoDenseScoreMatrix(1024, scorer.n_rows),
                  tr.LaunchBudget(run.STEP_LAUNCHES)]
        cell(f"flat/{mode}", msearch.state_candidates,
             (q, msearch.make_state(art), kappa), budget)
        if mode in IVF_RECALL_FLOORS:
            index = ivf.with_reduced_centers(
                ivf.build_aligned(glv, x, nprobe=IVF_NPROBE, device=dev),
                scorer, glv)
            cell(f"ivf/{mode}", msearch.state_candidates,
                 (q, msearch.make_state(art, index=index), 100),
                 [*budget, tr.NoDenseScoreMatrix(
                     1024, index.nprobe * index.max_len)])
            del index
    # (1024, expand * degree) is not checked here: it is the shape of the
    # entry beam's padding, (1024, beam - entries) = (1024, 112)
    for mode in GRAPH_FUSED:
        _, _, _, _, scorer, g = searches[mode]
        index = graph.with_fused_scan(g, scorer)
        art = msearch.SearchArtifacts(scorer=scorer, x_full=x[:GRAPH_ROWS])
        cell(f"graph/{mode}", msearch.state_candidates,
             (q, msearch.make_state(art, index=index), 100),
             [tr.NoDenseScoreMatrix(1024, scorer.n_rows),
              tr.LaunchBudget(run.STEP_LAUNCHES,
                              exact={run.TRAVERSAL_KERNEL: 1})])
        del index, art
    mode = "gleanvec-int8-sorted"
    host = msearch.demote_rerank_tier(msearch.SearchArtifacts(
        scorer=states[mode][0], x_full=x, model=glv))
    cell(f"host-rerank/{mode}", msearch.state_candidates,
         (q, msearch.make_state(host), 100),
         [tr.NoDenseScoreMatrix(N_ROWS, 512, dtypes=("f32",)),
          tr.NoDenseScoreMatrix(1024, states[mode][0].n_rows)])
    del host
    for mode in ("sphering-int8", "gleanvec-int8-sorted"):
        model = sph if mode.startswith("sphering") else glv
        sh, stacked = distributed.build_sharded_index(
            "flat", mode, x, model, n_shards=SHARDS, device=dev)
        per = distributed._take_shard(stacked, 0).n_rows
        cell(f"sharded/{mode}", sh.search_local, (q, stacked, 100),
             [tr.NoDenseScoreMatrix(1024, per),
              tr.NoDenseScoreMatrix(1024, states[mode][0].n_rows),
              tr.LaunchBudget(SHARDS * run.STEP_LAUNCHES)])
        del sh, stacked

    # one stream cycle's swap: insert, refresh, then swap under the rule
    state = serve.build_stream(mode, x, STREAM_N0, N_ROWS, glv,
                               slack_blocks=serve.stream_slack_blocks(
                                   glv, x[STREAM_N0:]), device=dev)
    engine = ServingEngine(state, k=10, kappa=100, batch_size=1024, dim=512)
    del state
    stream = streaming.init_from_artifacts(engine.state.artifacts,
                                           ds.queries_test)
    stream = serve.stream_insert(engine, stream,
                                 x[STREAM_N0:STREAM_N0 + STREAM_INSERTS])
    new = streaming.refresh_state(engine.state, streaming.refresh(stream))
    torch.cuda.synchronize()
    res = run_rules(tr.SwapCase(engine, new, keep=glv),
                    [tr.SwapWithoutCopy()], target=f"flat/{mode}:swap")
    results.extend(res)
    log(f"    flat/{mode}:swap (capacity {N_ROWS}, {STREAM_INSERTS} "
        f"inserts, refresh): {'ok' if res[0].passed else 'FAIL'} "
        f"{res[0].evidence}")
    del engine, new, stream

    unlisted, stale = run.verdict(results)
    launched = counts(K)
    log(f"  phase 3h launches (checks, not in the kernel table): "
        f"{launched}; {len(results)} full-width results, "
        f"{sum(not r.passed for r in results)} failed "
        f"({time.perf_counter() - t_phase:.0f} s)")
    if unlisted or stale:
        raise AssertionError(
            "full-width contracts: unlisted failures "
            + "; ".join(f"{r.rule}[{r.target}]: {r.evidence}"
                        for r in unlisted) + f"; stale listings {stale}")
    for name in ("ip_topk", "gleanvec_sq_topk", "ivf_scan_topk",
                 "graph_beam_search"):
        if launched[name] <= 0:
            raise AssertionError(f"phase 3h: {name} was not launched")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 3e: LM serving.
# ---------------------------------------------------------------------------


def phase_lm(K, testing):
    """``generate`` for danube at full width on the card: prefill (every
    layer's attention through ``flash_attention``) then LM_NEW - 1 decode
    steps. Counters zeroed just before and read just after. Returns the
    captured layer-0 (q, k, v) of the prefill (the kernel's (B, H, S, dh)
    views) and the kernel's launches on the path."""
    from repro_torch.analysis.trace_rules import device_split
    from repro_torch.configs import lm_common, registry
    from repro_torch.models import attention
    from repro_torch.models import transformer as tfm
    from repro_torch.serve import decode

    dev = torch.device("cuda")
    cfg = registry.get(LM_ARCH).make_config()
    log(f"phase 3e: LM serving, {cfg.name} at full width ({cfg.n_layers} "
        f"layers, d_model {cfg.d_model}, {cfg.n_heads} heads / "
        f"{cfg.n_kv_heads} KV, d_head {cfg.d_head}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab}, window {cfg.swa_window}, bf16), B={LM_BATCH} "
        f"s0={LM_PROMPT} n_new={LM_NEW} (cut from prefill_32k: B="
        f"{lm_common.LM_SHAPES['prefill_32k']['batch']}, S="
        f"{lm_common.LM_SHAPES['prefill_32k']['seq']})")
    t0 = time.perf_counter()
    params = tfm.init(cfg, seed=LM_SEED, device=dev)
    torch.cuda.synchronize()
    n_par = tfm.param_count(params)
    log(f"  init on the card: {n_par / 1e9:.3f} B parameters, "
        f"{n_par * 2 / 2**30:.2f} GiB bf16, "
        f"{(time.perf_counter() - t0) * 1e3:.0f} ms")
    gen = torch.Generator(device=dev).manual_seed(LM_SEED + 1)
    prompt = torch.randint(0, cfg.vocab, (LM_BATCH, LM_PROMPT),
                           generator=gen, device=dev)
    # warm-up at full size: cuBLAS handles, the kernel's library, and the
    # caching allocator's blocks, so the readings below are steady state
    decode.generate(params, prompt, 2, cfg, device=dev)
    torch.cuda.synchronize()

    # spies: CUDA events around the prefill and each decode step, layer 0's
    # attention inputs, the first decode step's logits
    events, seen = {"prefill": [], "decode": []}, {}
    orig_pre, orig_dec = tfm.prefill_step, tfm.decode_step
    orig_fa = attention.flash_attention

    def timed_call(kind, fn, *a):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*a)
        end.record()
        events[kind].append((start, end))
        return out

    def spy_pre(*a):
        return timed_call("prefill", orig_pre, *a)

    def spy_dec(*a):
        out = timed_call("decode", orig_dec, *a)
        seen.setdefault("logits", out[0].clone())
        return out

    def spy_fa(q, k, v, causal=True, window=None):
        if "qkv" not in seen:
            seen["qkv"] = (q.clone(), k.clone(), v.clone(), window)
        seen.setdefault("kernels", []).append(flash_kernel_name(q, k, v))
        return orig_fa(q, k, v, causal=causal, window=window)

    tfm.prefill_step, tfm.decode_step = spy_pre, spy_dec
    attention.flash_attention = spy_fa
    # the kernel's module (the package attribute of that name is the
    # wrapper): its plain version refuses to run during the main path
    fa_mod = importlib.import_module("repro_torch.kernels.flash_attention")

    def refuse(*a, **k):
        raise AssertionError("flash_attention_plain ran on the main path")

    fa_mod.flash_attention_plain = refuse
    for fn in all_counters(K):
        fn.launches = 0
    try:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        tokens = decode.generate(params, prompt, LM_NEW, cfg, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        tfm.prefill_step, tfm.decode_step = orig_pre, orig_dec
        attention.flash_attention = orig_fa
        fa_mod.flash_attention_plain = K.flash_attention_plain
    launches = K.flash_attention.launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    pre_ms = sum(a.elapsed_time(b) for a, b in events["prefill"])
    dec_ms = [a.elapsed_time(b) for a, b in events["decode"]]
    others = {fn.__name__: fn.launches for fn in all_counters(K)
              if fn is not K.flash_attention and fn.launches}
    log(f"  generate: {wall * 1e3:.1f} ms host clock; prefill "
        f"{pre_ms:.1f} ms ({LM_BATCH * LM_PROMPT / pre_ms * 1e3:.0f} "
        f"tokens/s); decode {np.mean(dec_ms):.2f} ms per token (median "
        f"{np.median(dec_ms):.2f}, {len(dec_ms)} steps, B={LM_BATCH}); "
        f"peak device memory {peak:.2f} GiB")
    picked = sorted(set(seen["kernels"]))
    log(f"  flash_attention launches: {launches} (one per layer of the "
        f"prefill: {cfg.n_layers}), kernel picked: {', '.join(picked)}; "
        f"other kernels launched: {others or 0}")
    if launches != cfg.n_layers or others:
        raise AssertionError("the prefill did not run each layer's "
                             "attention through the kernel exactly once")
    if picked != [LM_FLASH_KERNEL]:
        raise AssertionError(f"the prefill's attention took {picked}, not "
                             f"{LM_FLASH_KERNEL}")

    # outputs: tokens in range, then the first decode step against a
    # prefill over the same s0 + 1 tokens
    if tokens.shape != (LM_BATCH, LM_PROMPT + LM_NEW) or not torch.equal(
            tokens[:, :LM_PROMPT], prompt):
        raise AssertionError(f"generate returned {tuple(tokens.shape)}")
    new = tokens[:, LM_PROMPT:]
    if int(new.min()) < 0 or int(new.max()) >= cfg.vocab:
        raise AssertionError("generated tokens out of the vocabulary")
    step1 = seen["logits"]
    ref, _ = tfm.prefill_step(params, tokens[:, :LM_PROMPT + 1], cfg)
    gap = (step1 - ref).abs()
    excess = float((gap - LM_LOGIT_ATOL - LM_LOGIT_RTOL * ref.abs()).max())
    same = float((step1.argmax(-1) == ref.argmax(-1)).float().mean())
    log(f"  first decode step vs prefill over {LM_PROMPT + 1} tokens: max "
        f"|gap| {float(gap.max()):.4f} (|logit| <= "
        f"{float(ref.abs().max()):.2f}; tol {LM_LOGIT_ATOL} + "
        f"{LM_LOGIT_RTOL} |logit|), same argmax in {same:.2f} of the "
        f"batch; greedy tokens of row 0: {new[0, :8].tolist()}")
    if not (bool(torch.isfinite(step1).all()) and excess <= 0):
        raise AssertionError("the decode step disagrees with the prefill")
    del ref

    busy, fa, _, fa_n, _ = profiled_step(
        lambda: tfm.prefill_step(params, prompt, cfg), LM_FLASH_KERNEL,
        "phase 3e prefill", want=cfg.n_layers)
    log(f"  prefill under torch.profiler: device busy {busy:.1f} ms, of "
        f"it flash_attention ({LM_FLASH_KERNEL}, {fa_n} launches) "
        f"{fa:.1f} ms ({fa / busy:.1%})")

    cache = tfm.init_cache(cfg, LM_BATCH, LM_PROMPT + LM_NEW, device=dev)
    wall, busy, _, n_kern, _ = device_split(
        lambda: tfm.decode_step(params, cache, new[:, 0], LM_PROMPT, cfg),
        LM_FLASH_KERNEL)
    step = float(np.mean(dec_ms))
    log(f"  one decode step under torch.profiler: {wall:.1f} ms host clock "
        "(the profiler's own cost included), "
        + (f"device busy {busy:.1f} ms in {n_kern} kernels: "
           f"{1 - busy / step:.0%} of the unprofiled {step:.2f} ms step "
           "idle, bound by eager launches"
           if busy > 0 else "device split not measured"))
    del cache

    q, k, v, window = seen["qkv"]
    check_flash(K, testing, f"captured layer 0 B={q.shape[0]} H={q.shape[1]}"
                f" KV={k.shape[1]} S={q.shape[2]} dh={q.shape[3]} window="
                f"{window} bf16 strided", q, k, v, True, window)
    del params, tokens, prompt, seen
    torch.cuda.empty_cache()
    return (q, k, v, window), launches


def sdpa_library(q, k, v, window, reps):
    """``flash_attention``'s library call, timed (mean of ``reps``):
    ``scaled_dot_product_attention`` with a boolean causal + window mask (a
    dense (S, S) mask: it computes every KV tile). Returns (ms, output, how
    the KV heads were given)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    s, h, kv = q.shape[2], q.shape[1], k.shape[1]
    pos = torch.arange(s, device=q.device)
    mask = pos[:, None] >= pos[None, :]
    if window:
        mask &= (pos[:, None] - pos[None, :]) < window
    with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION,
                      SDPBackend.CUDNN_ATTENTION]):
        try:
            ms, out = timed(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask, enable_gqa=True), reps)
            return ms, out, "enable_gqa=True"
        except RuntimeError as e:      # no fused backend takes GQA + mask
            log(f"    SDPA enable_gqa with a mask: {str(e)[:120]}")
            kr = k.repeat_interleave(h // kv, dim=1)
            vr = v.repeat_interleave(h // kv, dim=1)
            ms, out = timed(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    q, kr, vr, attn_mask=mask), reps)
            return ms, out, "k, v repeated to H heads outside the timing"


def sdpa_flash_causal(q, k, v, reps):
    """The fair yardstick of ``flash_attention(q, k, v, True, None)``:
    ``scaled_dot_product_attention`` on PyTorch's flash backend with
    ``is_causal=True`` (it skips the masked KV tiles as the kernel does),
    timed (mean of ``reps``). Returns (ms, output, how the KV heads were
    given)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    h, kv = q.shape[1], k.shape[1]
    with sdpa_kernel([SDPBackend.FLASH_ATTENTION]):
        try:
            ms, out = timed(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    q, k, v, is_causal=True, enable_gqa=True), reps)
            return ms, out, "enable_gqa=True"
        except RuntimeError as e:      # the backend does not take GQA
            log(f"    SDPA flash backend with enable_gqa: {str(e)[:120]}")
            kr = k.repeat_interleave(h // kv, dim=1)
            vr = v.repeat_interleave(h // kv, dim=1)
            ms, out = timed(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    q, kr, vr, is_causal=True), reps)
            return ms, out, "k, v repeated to H heads outside the timing"


def causal_yardstick(K, testing, q, k, v, check: bool) -> str:
    """``flash_attention`` without a window beside PyTorch's flash backend
    at causal (the same function, both skipping masked tiles): one log
    line. With ``check`` the kernel's output is held against the plain
    version and the library's against the kernel's."""
    flops, nbytes = flash_work(q, k, v, None)
    bnd, by = bound_ms(flops, nbytes, PEAK_BF16_FLOPS)
    ms, out_k = timed(lambda: K.flash_attention(q, k, v, True, None), 5)
    lib_ms, out_l, how = sdpa_flash_causal(q, k, v, 3)
    line = (f"causal, no window: ms={ms:.3f} ({flops / ms / 1e9:.1f} "
            f"TFLOP/s) library_ms={lib_ms:.3f} (SDPA flash backend, "
            f"is_causal=True, {how}; {flops / lib_ms / 1e9:.1f} TFLOP/s) "
            f"bound_ms={bnd:.3f} ({by}) share_of_bound={bnd / ms:.1%}")
    if check:
        abs_mix = testing.attention_abs_mix(q, k, v, True, None)
        out_p = K.flash_attention_plain(q, k, v, True, None)
        err, used = testing.attention_error(out_k, out_p, abs_mix)
        lib_err, lib_used = testing.attention_error(out_l, out_k, abs_mix)
        line += (f"; kernel vs plain max_abs_err={err:.3e} (worst element "
                 f"at {used:.3f} of its tolerance), library vs kernel "
                 f"{lib_err:.2e} ({lib_used:.3f})")
        if used > 1:
            raise AssertionError("flash_attention vs plain, causal without "
                                 "a window at the LM shape")
    return line


def flash_kernel_name(q, k, v) -> str:
    """The kernel ``flash_attention`` picks for these inputs."""
    fa_mod = importlib.import_module("repro_torch.kernels.flash_attention")
    pick = getattr(fa_mod, "_variant", None)
    return fa_mod.VARIANTS[pick(q, k, v)] if pick else "one bf16 kernel"


def flash_profile(q, k, v, window) -> str:
    """Where the wgmma kernel's consumers spend their cycles (its clock64
    profile, thread 0 of each consumer warpgroup), where the tree has
    one."""
    fa_mod = importlib.import_module("repro_torch.kernels.flash_attention")
    if not hasattr(fa_mod, "wgmma_profile"):
        return "no clock64 profile in this tree"
    prof = fa_mod.wgmma_profile(q, k, v, True, window)
    total = max(prof["kernel"], 1)
    return ("share of the consumers' cycles (clock64, thread 0 of each): "
            + ", ".join(f"{p} {prof[p] / total:.1%}"
                        for p in fa_mod.PROFILE_PARTS[1:]))


def flash_work(q, k, v, window):
    """(flops, bytes) of one causal (windowed) attention forward: 4 dh flops
    a (query, key) pair it keeps; q, k and v read once, the output written
    once."""
    b, h, s, dh = q.shape
    pairs = int(np.minimum(np.arange(s, dtype=np.int64) + 1,
                           window if window else s).sum())
    return (4.0 * dh * h * b * pairs,
            (2 * q.numel() + k.numel() + v.numel()) * q.element_size())


def lm_timing(K, testing, qkv, launches):
    """``flash_attention`` at the LM path's captured shape: its time beside
    its bf16 tensor-core bound, its plain version and the library call
    (``scaled_dot_product_attention`` with a boolean causal + window mask,
    timed as a yardstick only); then the same inputs without the window
    beside SDPA's flash backend at ``is_causal=True``, the fair yardstick
    (both skip the masked tiles)."""
    q, k, v, window = qkv
    b, h, s, dh = q.shape
    kv = k.shape[1]
    flops, nbytes = flash_work(q, k, v, window)
    ms, out_k = timed(lambda: K.flash_attention(q, k, v, True, window), 5)
    plain_ms, out_p = timed_once(
        lambda: K.flash_attention_plain(q, k, v, True, window))
    abs_mix = testing.attention_abs_mix(q, k, v, True, window)
    err, used = testing.attention_error(out_k, out_p, abs_mix)
    if used > 1:
        raise AssertionError("flash_attention vs plain at the LM shape")
    # the tolerance's power at this shape: faults planted in the plain
    # version (the first two must fail it)
    planted = (
        ("each row's oldest 64 keys dropped (a KV tile at the window's "
         "edge)", True, lambda: K.flash_attention_plain(
             q, k, v, True, window - 64)),
        ("row sums 3 % off", True,
         lambda: (out_p.to(torch.float32) * 1.03).to(out_p.dtype)),
        ("each row's oldest key dropped (the window off by one)", False,
         lambda: K.flash_attention_plain(q, k, v, True, window - 1)))
    for what, must, fault in planted if window else ():
        f_err, f_used = testing.attention_error(fault(), out_p, abs_mix)
        verdict = "caught" if f_used > 1 else "not caught"
        log(f"    planted fault, {what}: max_abs_err {f_err:.3e}, worst "
            f"element at {f_used:.2f} of its tolerance ({verdict})")
        if must and f_used <= 1:
            raise AssertionError(f"the attention tolerance misses: {what}")
    del out_p
    lib_ms, out_l, how = sdpa_library(q, k, v, window, 3)
    lib_err, lib_used = testing.attention_error(out_l, out_k, abs_mix)
    del abs_mix
    b16, by = bound_ms(flops, nbytes, PEAK_BF16_FLOPS)
    b32, _ = bound_ms(flops, nbytes)
    log(f"  flash_attention[B={b} H={h} KV={kv} S={s} dh={dh} W={window} "
        f"bf16, {flash_kernel_name(q, k, v)}]: ms={ms:.3f} "
        f"plain_ms={plain_ms:.3f} bound_ms={b16:.3f} "
        f"({by}; {flops / 1e12:.3f} TFLOP over 989 TFLOP/s bf16, "
        f"{nbytes / 1e9:.3f} GB over 3.35 TB/s; {b32:.2f} ms at the 67 "
        f"TFLOP/s fp32 FMA rate) achieved {flops / ms / 1e9:.1f} TFLOP/s; "
        f"max_abs_err={err:.3e} (worst element at {used:.3f} of its "
        f"tolerance); "
        f"library_ms={lib_ms:.3f} (SDPA, {how}, a dense (S, S) mask: it "
        f"computes every KV tile; vs kernel max_abs_err "
        f"{lib_err:.2e}, worst element at {lib_used:.3f} of the kernel's "
        f"tolerance) "
        f"launches={launches}")
    log("    " + causal_yardstick(K, testing, q, k, v, check=True))
    log("    " + flash_profile(q, k, v, window))
    src, repl = KERNEL_FILES["flash_attention"]
    return {"name": f"flash_attention[danube prefill B={b} S={s}]",
            "route": "cuda", "source": src, "replaces": repl,
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b16, "bound_by": by,
            "library_ms": lib_ms}


# ---------------------------------------------------------------------------
# Phase 3l: MoE serving.
# ---------------------------------------------------------------------------


def moe_tail(cfg, batch: int, s0: int) -> int:
    """The fewest trailing prompt tokens to decode one by one after a
    prefill over the rest, such that that prefill and the one over all
    ``s0`` tokens both cut into whole MoE groups: ``moe_apply`` refuses a
    token count off its group, as the reference asserts, so at these
    shapes no prefill over s0 + 1 tokens exists."""
    def whole(s):
        return (batch * s) % min(cfg.moe.group_size, batch * s) == 0

    if not whole(s0):
        raise AssertionError(f"{cfg.name}: B={batch} x s0={s0} tokens do "
                             "not cut into whole groups")
    return next(t for t in range(1, s0) if whole(s0 - t))


def routing_reading(r, n_experts: int):
    """One ``moe.route`` result: (dropped choices, their share, expert load
    min and max -- kept choices over all groups --, the largest demand of
    one group on one expert)."""
    g = r.idx.shape[0]
    idx = r.idx.reshape(g, -1)
    demand = torch.zeros(g, n_experts, device=idx.device).scatter_add_(
        1, idx, torch.ones_like(idx, dtype=torch.float32))
    load = torch.zeros(g, n_experts, device=idx.device).scatter_add_(
        1, idx, r.keep.reshape(g, -1).to(torch.float32)).sum(0)
    dropped = int((~r.keep).sum())
    return (dropped, dropped / r.keep.numel(), int(load.min()),
            int(load.max()), int(demand.max()))


def moe_error(got: torch.Tensor, want: torch.Tensor, rtol: float,
              atol_rms: float):
    """(max |got - want|, the worst element's share of its tolerance
    ``rtol |want| + atol_rms rms(want)``) in f32."""
    got, want = got.to(torch.float32), want.to(torch.float32)
    rms = float(want.square().mean().sqrt())
    gap = (got - want).abs()
    used = float((gap / (rtol * want.abs() + atol_rms * rms)).max())
    return float(gap.max()), used


def moe_layer_checks(cfg, p0, x_first, tg):
    """``moe_apply`` on layer 0's parameters at published width, on its
    first group of the prefill's MoE input: bf16 against f32 compute on
    the card, and the f32 call on the card against the same call on the
    CPU; then decode_32k's B = 128 tokens (one group) timed in bf16 beside
    f32. Fails the phase on a gap past its tolerance."""
    from repro_torch.models import moe
    mc = cfg.moe
    # the f32 calls take x upcast (exactly), so that their output is not
    # rounded to x's bf16 on the way out
    x1 = x_first[:tg]
    y16, a16 = moe.moe_apply(p0, x1, mc, cfg.act, cfg.glu, torch.bfloat16)
    y32, a32 = moe.moe_apply(p0, x1.float(), mc, cfg.act, cfg.glu,
                             torch.float32)
    err, used = moe_error(y16, y32, MOE_BF16_RTOL, MOE_BF16_ATOL_RMS)
    log(f"  moe_apply layer 0, one group of {tg} tokens: bf16 vs f32 "
        f"compute max_abs_err={err:.3e} (worst element at {used:.3f} of "
        f"{MOE_BF16_RTOL} |y| + {MOE_BF16_ATOL_RMS} rms(y); rms(y) "
        f"{float(y32.square().mean().sqrt()):.4f}), aux {float(a16):.6f} / "
        f"{float(a32):.6f}")
    if used > 1 or float(a16) != float(a32):
        raise AssertionError(f"{cfg.name}: moe_apply in bf16 disagrees with "
                             "f32 compute")
    r_dev = moe.route(p0["router"], x1[None], mc)
    p_cpu = {k: v.cpu() for k, v in p0.items()}
    t0 = time.perf_counter()
    r_cpu = moe.route(p_cpu["router"], x1.cpu()[None], mc)
    y_cpu, a_cpu = moe.moe_apply(p_cpu, x1.float().cpu(), mc, cfg.act,
                                 cfg.glu, torch.float32)
    cpu_s = time.perf_counter() - t0
    del p_cpu
    same_route = (torch.equal(r_dev.idx.cpu(), r_cpu.idx)
                  and torch.equal(r_dev.pos.cpu(), r_cpu.pos))
    srt = r_cpu.probs.sort(dim=-1, descending=True).values
    k = mc.top_k
    margin = float((srt[..., :k] - srt[..., 1:k + 1]).min())
    err, used = moe_error(y32.cpu(), y_cpu, MOE_F32_RTOL, MOE_F32_ATOL_RMS)
    log(f"  moe_apply layer 0 f32, card vs CPU ({cpu_s:.1f} s on the CPU): "
        f"routing {'identical' if same_route else 'DIFFERS'} (smallest "
        f"margin of a choice {margin:.2e}), max_abs_err={err:.3e} (worst "
        f"element at {used:.3f} of {MOE_F32_RTOL} |y| + {MOE_F32_ATOL_RMS} "
        f"rms(y)), aux gap {abs(float(a32) - float(a_cpu)):.2e}")
    if not same_route or used > 1 or abs(float(a32) - float(a_cpu)) > 1e-6:
        raise AssertionError(f"{cfg.name}: moe_apply f32 on the card "
                             "disagrees with the CPU's")
    del y16, y32, y_cpu
    x128 = x_first[:MOE_DECODE_TOKENS]
    ms, (y16, _) = timed(lambda: moe.moe_apply(p0, x128, mc, cfg.act,
                                               cfg.glu, torch.bfloat16), 5)
    y32, _ = moe.moe_apply(p0, x128.float(), mc, cfg.act, cfg.glu,
                           torch.float32)
    err, used = moe_error(y16, y32, MOE_BF16_RTOL, MOE_BF16_ATOL_RMS)
    cap = moe._capacity(MOE_DECODE_TOKENS, mc)
    nbytes = sum(v.numel() * v.element_size() for v in p0.values())
    bnd, by = bound_ms(2.0 * (3 if cfg.glu else 2) * mc.n_experts * cap
                       * cfg.d_model * cfg.d_ff, nbytes, PEAK_BF16_FLOPS)
    log(f"  moe_apply at decode_32k's B={MOE_DECODE_TOKENS} tokens (one "
        f"group, capacity {cap}): {ms:.3f} ms bf16, bound {bnd:.3f} ms "
        f"({by}: {nbytes / 1e9:.2f} GB of router and experts at 3.35 TB/s); "
        f"vs f32 max_abs_err={err:.3e} (worst element at {used:.3f} of its "
        "tolerance)")
    if used > 1:
        raise AssertionError(f"{cfg.name}: moe_apply at B=128 in bf16 "
                             "disagrees with f32 compute")


def moe_flash_row(K, testing, label, qkv, launches):
    """``flash_attention`` at an MoE prefill's captured layer-0 shape
    (causal, no window): the kernel-table row, its library yardstick
    SDPA's flash backend at ``is_causal=True``."""
    q, k, v = qkv
    b, h, s, dh = q.shape
    flops, nbytes = flash_work(q, k, v, None)
    ms, out_k = timed(lambda: K.flash_attention(q, k, v, True, None), 5)
    plain_ms, out_p = timed_once(
        lambda: K.flash_attention_plain(q, k, v, True, None))
    err, used = testing.attention_error(
        out_k, out_p, testing.attention_abs_mix(q, k, v, True, None))
    if used > 1:
        raise AssertionError(f"flash_attention vs plain at {label}")
    del out_p
    lib_ms, _, how = sdpa_flash_causal(q, k, v, 3)
    bnd, by = bound_ms(flops, nbytes, PEAK_BF16_FLOPS)
    log(f"  flash_attention[{label} B={b} H={h} KV={k.shape[1]} (group "
        f"{h // k.shape[1]}) S={s} dh={dh} causal bf16, "
        f"{flash_kernel_name(q, k, v)}]: ms={ms:.3f} ({flops / ms / 1e9:.1f} "
        f"TFLOP/s) plain_ms={plain_ms:.3f} bound_ms={bnd:.3f} ({by}) "
        f"share_of_bound={bnd / ms:.1%} library_ms={lib_ms:.3f} (SDPA flash "
        f"backend, is_causal=True, {how}) max_abs_err={err:.3e} (worst "
        f"element at {used:.3f} of its tolerance) launches={launches}")
    src, repl = KERNEL_FILES["flash_attention"]
    return {"name": f"flash_attention[{label} prefill B={b} S={s}]",
            "route": "cuda", "source": src, "replaces": repl,
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by,
            "library_ms": lib_ms}


def moe_run(K, testing, cfg, published: int, label: str):
    """``generate`` for one MoE config at published widths and cut depth;
    returns its ``flash_attention`` kernel-table row."""
    from repro_torch.analysis.trace_rules import device_split
    from repro_torch.configs import lm_common
    from repro_torch.models import attention, moe
    from repro_torch.models import transformer as tfm
    from repro_torch.serve import decode

    dev = torch.device("cuda")
    mc = cfg.moe
    b, s0, n_new, n_layers = MOE_BATCH, MOE_PROMPT, MOE_NEW, cfg.n_layers
    tg = min(mc.group_size, b * s0)
    cap = moe._capacity(tg, mc)
    ffn = 3 if cfg.glu else 2
    expert_bytes = ffn * mc.n_experts * cfg.d_model * cfg.d_ff * 2
    ref_shape = lm_common.LM_SHAPES["prefill_32k"]
    log(f"phase 3l: MoE serving, {cfg.name} at published widths (d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads / {cfg.n_kv_heads} KV: GQA "
        f"group {cfg.n_heads // cfg.n_kv_heads}, d_head {cfg.d_head}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab}, {mc.n_experts} experts top-"
        f"{mc.top_k}, capacity factor {mc.capacity_factor}, group "
        f"{mc.group_size}, bf16), depth cut from {published} to {n_layers} "
        f"layers ({expert_bytes / 1e9:.2f} GB of experts a layer); generate "
        f"at B={b} s0={s0} n_new={n_new} (cut from prefill_32k: B="
        f"{ref_shape['batch']}, S={ref_shape['seq']}): {b * s0} prompt "
        f"tokens in {b * s0 // tg} groups of {tg}, capacity {cap} an expert "
        f"a group; card {card_line()}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = tfm.init(cfg, seed=MOE_SEED, device=dev)
    torch.cuda.synchronize()
    n_par = tfm.param_count(params)
    log(f"  init on the card: {n_par / 1e9:.3f} B parameters, "
        f"{n_par * 2 / 1e9:.2f} GB bf16, "
        f"{(time.perf_counter() - t0) * 1e3:.0f} ms")
    gen = torch.Generator(device=dev).manual_seed(MOE_SEED + 1)
    prompt = torch.randint(0, cfg.vocab, (b, s0), generator=gen, device=dev)
    decode.generate(params, prompt, 2, cfg, device=dev)     # warm-up
    torch.cuda.synchronize()

    events, seen = {"prefill": [], "decode": []}, {"routes": [],
                                                   "kernels": [], "steps": []}
    orig_pre, orig_dec = tfm.prefill_step, tfm.decode_step
    orig_fa, orig_route = attention.flash_attention, moe.route
    orig_apply, orig_experts = moe.moe_apply, moe._experts

    def timed_call(kind, fn, *a):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*a)
        end.record()
        events[kind].append((start, end))
        return out

    def spy_pre(*a):
        out = timed_call("prefill", orig_pre, *a)
        seen["prefill"] = out[0].clone()
        return out

    def spy_dec(*a):
        out = timed_call("decode", orig_dec, *a)
        seen["steps"].append(out[0])
        return out

    def spy_fa(q, k, v, causal=True, window=None):
        if "qkv" not in seen:
            seen["qkv"] = (q.clone(), k.clone(), v.clone())
        seen["kernels"].append(flash_kernel_name(q, k, v))
        return orig_fa(q, k, v, causal=causal, window=window)

    def spy_route(*a):
        seen["routes"].append(orig_route(*a))
        return seen["routes"][-1]

    def spy_apply(p, x, *a):
        if "moe_x" not in seen:
            seen["moe_x"] = x.reshape(-1, x.shape[-1])[
                :max(tg, MOE_DECODE_TOKENS)].clone()
        return orig_apply(p, x, *a)

    tfm.prefill_step, tfm.decode_step = spy_pre, spy_dec
    attention.flash_attention = spy_fa
    moe.route, moe.moe_apply = spy_route, spy_apply
    fa_mod = importlib.import_module("repro_torch.kernels.flash_attention")

    def refuse(*a, **k):
        raise AssertionError("flash_attention_plain ran on the main path")

    fa_mod.flash_attention_plain = refuse
    for fn in all_counters(K):
        fn.launches = 0
    try:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        tokens = decode.generate(params, prompt, n_new, cfg, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        tfm.prefill_step, tfm.decode_step = orig_pre, orig_dec
        attention.flash_attention = orig_fa
        moe.route, moe.moe_apply = orig_route, orig_apply
        fa_mod.flash_attention_plain = K.flash_attention_plain
    launches = K.flash_attention.launches
    peak = torch.cuda.max_memory_allocated() / 1e9
    pre_ms = sum(a.elapsed_time(e) for a, e in events["prefill"])
    dec_ms = [a.elapsed_time(e) for a, e in events["decode"]]
    others = {fn.__name__: fn.launches for fn in all_counters(K)
              if fn is not K.flash_attention and fn.launches}
    log(f"  generate: {wall * 1e3:.1f} ms host clock; prefill {pre_ms:.1f} "
        f"ms ({b * s0 / pre_ms * 1e3:.0f} tokens/s); decode "
        f"{np.mean(dec_ms):.2f} ms per token (median {np.median(dec_ms):.2f}"
        f", {len(dec_ms)} steps, B={b}); peak device memory {peak:.2f} GB")
    picked = sorted(set(seen["kernels"]))
    log(f"  flash_attention launches: {launches} (one per layer of the "
        f"prefill: {n_layers}), kernel picked: {', '.join(picked)}; other "
        f"kernels launched: {others or 0}")
    if launches != n_layers or others:
        raise AssertionError("the prefill did not run each layer's "
                             "attention through the kernel exactly once")
    if picked != [LM_FLASH_KERNEL]:
        raise AssertionError(f"the prefill's attention took {picked}, not "
                             f"{LM_FLASH_KERNEL}")
    drops = 0
    for i, r in enumerate(seen["routes"][:n_layers]):
        n_drop, share, lo, hi, demand = routing_reading(r, mc.n_experts)
        drops += n_drop
        log(f"  prefill layer {i}: {n_drop} of {r.keep.numel()} token "
            f"choices dropped ({share:.2%}); expert load (kept choices, all "
            f"groups) min {lo} max {hi} (mean {b * s0 * mc.top_k // mc.n_experts}"
            f"); largest demand of a group on an expert {demand} (capacity "
            f"{cap})")
    dec_drops = sum(routing_reading(r, mc.n_experts)[0]
                    for r in seen["routes"][n_layers:])
    log(f"  decode: {len(seen['routes']) - n_layers} MoE calls of one group "
        f"of {b} tokens (capacity {moe._capacity(b, mc)}), {dec_drops} "
        "choices dropped")

    # outputs: the prompt kept, tokens in range, every logit finite
    if tokens.shape != (b, s0 + n_new) or not torch.equal(tokens[:, :s0],
                                                          prompt):
        raise AssertionError(f"generate returned {tuple(tokens.shape)}")
    new = tokens[:, s0:]
    if int(new.min()) < 0 or int(new.max()) >= cfg.vocab:
        raise AssertionError("generated tokens out of the vocabulary")
    if not all(bool(torch.isfinite(lg).all())
               for lg in [seen["prefill"]] + seen["steps"]):
        raise AssertionError("generate gave logits that are not finite")

    # decode against prefill: the prompt's last `tail` tokens decoded one by
    # one after a prefill over the rest, the last step against generate's
    # prefill over all s0 tokens
    tail = moe_tail(cfg, b, s0)
    chain = []
    moe.route = lambda *a: chain.append(orig_route(*a)) or chain[-1]
    try:
        _, cache = tfm.prefill_step(params, prompt[:, :s0 - tail], cfg)
        full = tfm.init_cache(cfg, b, s0, device=dev)
        for kk in ("k", "v"):
            full[kk][:, :, :s0 - tail] = cache[kk]
        del cache
        for pos in range(s0 - tail, s0):
            step, full = tfm.decode_step(params, full, prompt[:, pos], pos,
                                         cfg)
    finally:
        moe.route = orig_route
    del full
    drops += sum(routing_reading(r, mc.n_experts)[0] for r in chain)
    ref = seen["prefill"]
    gap = (step - ref).abs()
    excess = float((gap - LM_LOGIT_ATOL - LM_LOGIT_RTOL * ref.abs()).max())
    same = float((step.argmax(-1) == ref.argmax(-1)).float().mean())
    log(f"  decode vs prefill: a prefill over {s0 - tail} tokens, then "
        f"{tail} decode steps (the fewest that leave both prefills whole "
        f"groups), the last step against the prefill over {s0}: max |gap| "
        f"{float(gap.max()):.4f} (|logit| <= {float(ref.abs().max()):.2f}; "
        f"tol {LM_LOGIT_ATOL} + {LM_LOGIT_RTOL} |logit|), same argmax in "
        f"{same:.2f} of the batch; {drops} token choices dropped in the two "
        "prefills and the steps: "
        + ("asserted" if drops == 0 else "not asserted (a dropped choice "
           "changes its token's output)")
        + f"; greedy tokens of row 0: {new[0, :8].tolist()}")
    if not bool(torch.isfinite(step).all()) or (drops == 0 and excess > 0):
        raise AssertionError("the decode step disagrees with the prefill")
    del ref, step

    # prefill time by part: flash_attention from torch.profiler, the MoE
    # layer and its expert products from CUDA events on one more prefill
    busy, fa_ms, _, fa_n, _ = profiled_step(
        lambda: tfm.prefill_step(params, prompt, cfg), LM_FLASH_KERNEL,
        f"phase 3l {label} prefill", want=n_layers)
    parts = {"moe": [], "experts": []}

    def evented(kind, fn):
        def run(*a):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*a)
            end.record()
            parts[kind].append((start, end))
            return out
        return run

    moe.moe_apply = evented("moe", orig_apply)
    moe._experts = evented("experts", orig_experts)
    try:
        total_ms, _ = timed_once(lambda: tfm.prefill_step(params, prompt, cfg))
    finally:
        moe.moe_apply, moe._experts = orig_apply, orig_experts
    moe_ms, exp_ms = (sum(a.elapsed_time(e) for a, e in parts[k])
                      for k in ("moe", "experts"))
    exp_flops = (2.0 * ffn * mc.n_experts * (b * s0 // tg) * cap
                 * cfg.d_model * cfg.d_ff * n_layers)
    log(f"  prefill by part ({total_ms:.1f} ms, CUDA events): expert "
        f"products {exp_ms:.1f} ms ({exp_ms / total_ms:.1%}; {exp_flops:.3e}"
        f" flops over {mc.n_experts * (b * s0 // tg) * cap} slots a layer, "
        f"{exp_flops / exp_ms / 1e9:.0f} TFLOP/s), routing + dispatch + "
        f"combine {moe_ms - exp_ms:.1f} ms ({(moe_ms - exp_ms) / total_ms:.1%})"
        + f"; flash_attention under torch.profiler {fa_ms:.1f} ms of "
        f"{busy:.1f} busy ({fa_ms / busy:.1%}, {fa_n} launches); the rest "
        f"(projections, norms, head) {total_ms - moe_ms - fa_ms:.1f} ms")

    cache = tfm.init_cache(cfg, b, s0 + n_new, device=dev)
    wall, busy, _, n_kern, _ = device_split(
        lambda: tfm.decode_step(params, cache, new[:, 0], s0, cfg),
        LM_FLASH_KERNEL)
    step_ms = float(np.mean(dec_ms))
    log(f"  one decode step under torch.profiler: {wall:.1f} ms host clock, "
        + (f"device busy {busy:.1f} ms in {n_kern} kernels ("
           f"{1 - busy / step_ms:.0%} of the unprofiled {step_ms:.2f} ms "
           f"step idle); expert weights read a step "
           f"{expert_bytes * n_layers / 1e9:.1f} GB, "
           f"{expert_bytes * n_layers / 3.35e9:.1f} ms at 3.35 TB/s"
           if busy > 0 else "device split not measured"))
    del cache

    p0 = tfm._layer(params["layers"], 0)["moe"]
    moe_layer_checks(cfg, p0, seen["moe_x"], tg)
    row = moe_flash_row(K, testing, label, seen["qkv"], launches)
    del params, p0, seen, tokens, prompt, new
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return row


def phase_moe(K, testing):
    """Phase 3l: grok-1-314b, then llama4-maverick-400b-a17b, each freed
    before the next is drawn. Returns flash_attention's kernel-table rows
    at their prefill shapes."""
    from repro_torch.configs import registry
    t_phase = time.perf_counter()
    rows = []
    for arch, depth, label in MOE_ARCHS:
        cfg = registry.get(arch).make_config()
        rows.append(moe_run(K, testing, dataclasses.replace(
            cfg, n_layers=depth), cfg.n_layers, label))
    log(f"  phase 3l: {time.perf_counter() - t_phase:.0f} s")
    return rows


# ---------------------------------------------------------------------------
# Phase 3m: training.
# ---------------------------------------------------------------------------


def train_setup(arch: str, cfg):
    """The training step of ``arch``'s config module (its optimizer,
    accumulation and accumulation dtype, as ``launch.steps`` builds the
    bundle) for ``cfg`` (the module's config, depth possibly cut):
    returns (step, opt_init, optimizer config, accumulation)."""
    from repro_torch.configs import registry
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tfm
    from repro_torch.train.trainstep import make_train_step
    module = registry.get(arch)
    abstract = tfm.blocked_view(steps._abstract(
        lambda: tfm.init(cfg, device="cpu")), cfg)
    _, opt_init, opt_cfg, accum_dtype = steps._opt_setup(module, abstract,
                                                         smoke=False)
    accum = getattr(module, "TRAIN_ACCUM", 1)
    step = make_train_step(lambda p, b: tfm.train_loss(p, b, cfg), opt_cfg,
                           accum_steps=accum, accum_dtype=accum_dtype)
    return step, opt_init, opt_cfg, accum, accum_dtype


def train_run(label, step, params, opt, batch_of, n_steps, tokens, flops):
    """``n_steps`` steps on ``batch_of(i)``, each timed with CUDA events
    (the step waits for nothing; its metrics are read after the timing),
    with the peak device memory of the step. Step 1 runs under
    ``set_sync_debug_mode`` and must make no host sync. Every loss and
    grad norm must be finite. ``tokens``: the tokens (or users) a step;
    ``flops``: its model flops (None: no TFLOP/s reading). Returns (params,
    opt, the step readings)."""
    from repro_torch.analysis.trace_rules import sync_count
    readings = []
    for i in range(n_steps):
        batch = batch_of(i)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        out = {}

        def one():
            start.record()
            out["r"] = step(params, opt, batch)
            end.record()

        syncs = None
        if i == 1:
            syncs = sync_count(one)
        else:
            one()
        end.synchronize()
        params, opt, metrics = out["r"]
        ms = start.elapsed_time(end)
        peak = torch.cuda.max_memory_allocated() / 1e9
        m = {k: float(v) for k, v in metrics.items()}
        rate = "" if flops is None else (
            f" model {flops / ms / 1e9:.1f} TFLOP/s "
            f"({flops / ms / 1e9 / (PEAK_BF16_FLOPS / 1e12):.1%} of "
            f"{PEAK_BF16_FLOPS / 1e12:.0f} bf16)")
        log(f"  {label} step {i}: {ms:.1f} ms, {tokens / ms * 1e3:.0f} "
            f"{'tokens' if flops is not None else 'users'}/s, loss "
            f"{m['loss']:.5f} grad_norm {m['grad_norm']:.5f} lr "
            f"{m['lr']:.3e}, peak {peak:.2f} GB{rate}"
            + (f"; host syncs in the step: {syncs}" if syncs is not None
               else ""))
        if not (np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])):
            raise AssertionError(f"{label} step {i}: non-finite metrics {m}")
        if syncs:
            raise AssertionError(f"{label} step {i}: {syncs} host syncs")
        readings.append((ms, peak, m))
        del batch
    return params, opt, readings


def train_profile(label, fn, micro_ms):
    """Device time by kernel of ``fn`` (one microbatch's forward and
    backward) under ``torch.profiler``: busy ms against the unprofiled
    microbatch's ``micro_ms``, the share of the matrix products (cuBLAS /
    CUTLASS kernels by name) and the largest kernels."""
    from repro_torch.analysis.trace_rules import profile_kernels
    _, rows, _ = profile_kernels(fn)
    busy = sum(us for _, _, us in rows) / 1e3
    if busy <= 0:
        log(f"  {label} microbatch by kernel: not measured (no device time "
            "recorded)")
        return
    gemm = sum(us for name, _, us in rows if any(
        k in name.lower() for k in ("gemm", "nvjet", "xmma", "cutlass")))
    top = sorted(rows, key=lambda r: -r[2])[:8]
    log(f"  {label} one microbatch under torch.profiler: device busy "
        f"{busy:.1f} ms ({sum(c for _, c, _ in rows)} kernels) against "
        f"{micro_ms:.1f} ms unprofiled ({1 - busy / micro_ms:.1%} idle); "
        f"matrix products {gemm / 1e3:.1f} ms ({gemm / 1e3 / busy:.1%}); "
        "largest: " + "; ".join(
            f"{name[:70]} x{c} {us / 1e3:.1f} ms" for name, c, us in top))


def worst_leaf_gap(grads_g, grads_c):
    """(gap, path) of the gradient leaf of ``grads_g`` (on the card) whose
    distance from ``grads_c``'s (on the CPU) is largest relative to the
    CPU leaf's norm."""
    from repro_torch import tree
    worst, where = 0.0, ""
    paths, leaves, _ = tree.flatten_with_paths(grads_g)
    for path, g, c in zip(paths, leaves, tree.leaves(grads_c)):
        g, c = g.float().cpu(), c.float()
        err = float(torch.linalg.vector_norm(g - c)
                    / torch.linalg.vector_norm(c).clamp(min=1e-30))
        if err > worst:
            worst, where = err, path
    return worst, where


def train_layer_check(cfg, params, seed):
    """``train_loss`` and its gradients of one full-width layer (layer 0
    of ``params`` with the embedding, final norm and head) at seq
    TRAIN_CHECK_SEQ, batch 1, on the card against the port's CPU path on
    the same bf16 weights and tokens."""
    from repro_torch import tree
    from repro_torch.models import transformer as tfm
    from repro_torch.train import data
    from repro_torch.train.trainstep import value_and_grad
    one = dataclasses.replace(cfg, n_layers=1)

    def first(stacked):
        if isinstance(stacked, dict):
            return {k: first(v) for k, v in stacked.items()}
        return stacked[:1]

    p1 = {**params, "layers": first(params["layers"])}
    batch = data.lm_batch(seed, 0, 1, TRAIN_CHECK_SEQ, cfg.vocab,
                          device="cuda")
    t0 = time.perf_counter()
    loss_g, grads_g = value_and_grad(
        lambda p, b: tfm.train_loss(p, b, one), p1, batch)
    cpu = tree.structure(p1).unflatten([t.cpu() for t in tree.leaves(p1)])
    loss_c, grads_c = value_and_grad(
        lambda p, b: tfm.train_loss(p, b, one), cpu,
        {k: v.cpu() for k, v in batch.items()})
    worst, where = worst_leaf_gap(grads_g, grads_c)
    rel = abs(float(loss_g) - float(loss_c)) / abs(float(loss_c))
    log(f"  one full-width layer at seq {TRAIN_CHECK_SEQ}, batch 1, card vs "
        f"CPU ({time.perf_counter() - t0:.1f} s): loss {float(loss_g):.6f} "
        f"vs {float(loss_c):.6f} (rel {rel:.2e}, tol {TRAIN_LOSS_RTOL}); "
        f"worst gradient leaf {where} at {worst:.2e} of its norm (tol "
        f"{TRAIN_GRAD_RTOL})")
    if rel > TRAIN_LOSS_RTOL or worst > TRAIN_GRAD_RTOL:
        raise AssertionError("the card's train_loss or gradients disagree "
                             "with the CPU path")


def train_attention_check(K, testing, cfg, params, batch):
    """Layer 0's q, k, v of a forward of ``train_loss`` (one microbatch):
    ``chunked_attention`` (the training path) against ``flash_attention``
    (the serving kernel) at phase 2's attention tolerance."""
    from repro_torch.models import attention
    from repro_torch.models import transformer as tfm
    seen = []
    orig = attention.chunked_attention

    def spy(q, k, v, causal=True, window=None, q_chunk=512):
        if not seen:
            seen.append((q.clone(), k.clone(), v.clone(), window, q_chunk))
        return orig(q, k, v, causal, window, q_chunk)

    attention.chunked_attention = spy
    try:
        with torch.no_grad():
            tfm.train_loss(params, batch, cfg)
    finally:
        attention.chunked_attention = orig
    q, k, v, window, q_chunk = seen[0]
    with torch.no_grad():
        got = orig(q, k, v, True, window, q_chunk).transpose(1, 2)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    with uncounted(K):
        want = K.flash_attention(qt, kt, vt, causal=True, window=window)
    torch.cuda.synchronize()
    err, used = testing.attention_error(
        got, want, testing.attention_abs_mix(qt, kt, vt, True, window))
    log(f"  chunked_attention vs flash_attention ({flash_kernel_name(qt, kt, vt)}) "
        f"on layer 0's q, k, v (B={q.shape[0]} S={q.shape[1]} H="
        f"{q.shape[2]} KV={k.shape[2]} dh={q.shape[3]} window={window}, "
        f"bf16): max_abs_err={err:.3e}, worst element at {used:.3f} of "
        "phase 2's attention tolerance")
    if used > 1:
        raise AssertionError("chunked_attention disagrees with "
                             "flash_attention")


def lm_train(K, testing, arch, depth, batch, seq, n_steps, label,
             checks: bool):
    """An LM's training at published widths (depth cut to ``depth``) on
    random bf16 weights drawn on the card; returns the step readings."""
    from repro_torch.configs import registry
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tfm
    from repro_torch.train import data
    from repro_torch.train.trainstep import value_and_grad
    dev = torch.device("cuda")
    full = registry.get(arch).make_config()
    cfg = dataclasses.replace(full, n_layers=depth)
    step, opt_init, opt_cfg, accum, accum_dtype = train_setup(arch, cfg)
    t0 = time.perf_counter()
    params = tfm.init(cfg, seed=TRAIN_SEED, device=dev)
    opt = opt_init(params)
    torch.cuda.synchronize()
    n_par = tfm.param_count(params)
    active, _ = steps._lm_active_params(cfg)
    flops = 6.0 * active * batch * seq + steps._lm_attn_flops_train(
        cfg, batch, seq)
    log(f"phase 3m ({label}): {cfg.name} training at published widths, "
        f"{depth} of {full.n_layers} layers, {n_par / 1e9:.3f} B "
        f"parameters ({n_par * 2 / 1e9:.2f} GB bf16), "
        f"{type(opt_cfg).__name__}{tuple(opt_cfg)}, accumulation {accum} "
        f"in {str(accum_dtype)[6:]}, remat {cfg.remat_policy!r}, "
        f"loss_chunks {cfg.loss_chunks}, q_chunk {cfg.q_chunk}, seq {seq}, "
        f"batch {batch} (train_4k: {full.name} batch 256), model flops a "
        f"step {flops:.3e}; init {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB with the optimizer "
        "state")

    def batch_of(i):
        return data.lm_batch(TRAIN_SEED, i, batch, seq, cfg.vocab,
                             device=dev)

    if checks:
        train_attention_check(K, testing, cfg, params, {
            k: v[:batch // accum] for k, v in batch_of(0).items()})
    params, opt, readings = train_run(label, step, params, opt, batch_of,
                                      n_steps, batch * seq, flops)
    ms = [r[0] for r in readings[1:]]
    micro = {k: v[:batch // accum] for k, v in batch_of(0).items()}
    train_profile(label, lambda: value_and_grad(
        lambda p, b: tfm.train_loss(p, b, cfg), params, micro),
        float(np.median(ms)) / accum)
    log(f"  {label}: median step {np.median(ms):.1f} ms over steps 1-"
        f"{n_steps - 1}, {batch * seq / np.median(ms) * 1e3:.0f} tokens/s, "
        f"model {flops / np.median(ms) / 1e9:.1f} TFLOP/s, peak "
        f"{max(r[1] for r in readings):.2f} GB")
    if checks:
        del opt
        torch.cuda.empty_cache()
        train_layer_check(cfg, params, TRAIN_SEED)
    del params
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return readings


def mind_train(K, testing):
    """examples/train_recsys_retrieval.py at published widths: MIND's
    train_batch bundle for MIND_TRAIN_STEPS steps, then GleanVec fitted on
    the first n_candidates rows of the learned item table and served from
    the trained user tower. Returns the kernel-table rows of the
    retrieval (launches: this phase's main path)."""
    from repro_torch.configs import registry
    from repro_torch.launch import steps
    from repro_torch.models import recsys
    from repro_torch.train import data
    dev = torch.device("cuda")
    bundle = steps.build_bundle("mind", "train_batch", device=dev)
    cfg, b = bundle.config, bundle.args[2]["seq"].shape[0]
    gen = torch.Generator(device=dev).manual_seed(TRAIN_SEED)
    params = recsys.mind.init(gen, cfg, device=dev)
    opt = bundle.opt_init(params)
    log(f"phase 3m (c): MIND train-then-retrieve at published widths "
        f"({cfg.n_items} items, seq {cfg.seq_len}, d {cfg.embed_dim}, "
        f"{cfg.n_interests} interests, {cfg.capsule_iters} capsule "
        f"iterations), train_batch {b}, AdamW lr 1e-3, "
        f"{MIND_TRAIN_STEPS} steps; model flops a step "
        f"{bundle.model_flops:.3e}")

    def batch_of(i):
        return data.mind_batch(TRAIN_SEED, i, b, cfg.seq_len, cfg.n_items,
                               device=dev)

    params, opt, readings = train_run("mind", bundle.fn, params, opt,
                                      batch_of, MIND_TRAIN_STEPS, b, None)
    losses = [r[2]["loss"] for r in readings]
    log(f"  mind: losses {[round(x, 5) for x in losses]}, median step "
        f"{np.median([r[0] for r in readings[1:]]):.1f} ms")
    del opt
    n_cand = registry.get("mind").SHAPES["retrieval_cand"]["n_candidates"]
    for fn in all_counters(K):
        fn.launches = 0
    with torch.no_grad():
        users = {m: recsys.mind.user_embedding(params, data.mind_batch(
            TRAIN_SEED, 1000 + m, m, cfg.seq_len, cfg.n_items, device=dev),
            cfg) for m in RETRIEVAL_BATCHES}
        learn = recsys.mind.user_embedding(params, data.mind_batch(
            TRAIN_SEED, 999, RECSYS_LEARN_USERS, cfg.seq_len, cfg.n_items,
            device=dev), cfg)
        rows = retrieval_runs(K, testing, "mind-trained",
                              params["item_emb"][:n_cand].contiguous(),
                              learn, users, MIND_TRAIN_MODES)
    launches = counts(K)
    log(f"  phase 3m (c) retrieval launches: {launches}")
    for name in ("ip_topk", "gleanvec_sq_topk", "kmeans_assign"):
        if launches[name] <= 0:
            raise AssertionError(f"phase 3m (c): {name} was not launched")
    del params, users, learn
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return rows


def checkpoint_leaves(ckpt_dir) -> dict:
    """{leaf path: array} of the newest checkpoint under ``ckpt_dir``."""
    from repro_torch.train import checkpoint
    step = checkpoint.latest_step(str(ckpt_dir))
    d = Path(ckpt_dir) / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    return step, {leaf["path"]: np.load(d / leaf["file"])
                  for leaf in manifest["leaves"]}


def train_drill():
    """The driver on the card (no --device): a run that exits 42 at
    REPRO_FAIL_AT_STEP=5 and an uninterrupted run side by side, then the
    first resumed; the resumed run's step-8 checkpoint and final loss
    against the uninterrupted run's within DRILL_ATOL / DRILL_LOSS_RTOL."""
    import os
    import tempfile
    base = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
            TRAIN_ARCH, "--shape", "train_4k", "--smoke", "--steps", "8",
            "--ckpt-every", "2"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("REPRO_FAIL_AT_STEP", None)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        drill, whole = Path(tmp) / "drill", Path(tmp) / "whole"

        def start(args, fail=None):
            e = dict(env) if fail is None else dict(
                env, REPRO_FAIL_AT_STEP=str(fail))
            return subprocess.Popen(base + args, env=e, cwd=ROOT,
                                    stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True)

        def finish(proc):
            out, err = proc.communicate(timeout=300)
            return proc.returncode, out, err

        runs = [start(["--ckpt-dir", str(drill)], fail=5),
                start(["--ckpt-dir", str(whole)])]
        (rc_f, out_f, err_f), (rc_w, out_w, err_w) = map(finish, runs)
        rc_r, out_r, err_r = finish(start(["--ckpt-dir", str(drill),
                                           "--resume"]))
        for name, rc, want, err in (("drill", rc_f, 42, err_f),
                                    ("uninterrupted", rc_w, 0, err_w),
                                    ("resume", rc_r, 0, err_r)):
            if rc != want:
                raise AssertionError(f"driver {name} run exited {rc} (want "
                                     f"{want}): {err[-2000:]}")
        if "[resume] restored step 4" not in out_r:
            raise AssertionError(f"the resume did not restore step 4: "
                                 f"{out_r[-1000:]}")
        final = [float(ln.split()[2]) for out in (out_r, out_w)
                 for ln in out.splitlines() if ln.startswith("final loss")]
        (sa, a), (sb, b) = checkpoint_leaves(drill), checkpoint_leaves(whole)
        if sa != 8 or sb != 8 or sorted(a) != sorted(b):
            raise AssertionError("the two runs' last checkpoints differ in "
                                 "step or leaves")
        gap = max(float(np.abs(a[k].astype(np.float64)
                               - b[k].astype(np.float64)).max()) for k in a)
        loss_rel = abs(final[0] - final[1]) / abs(final[1])
        log(f"phase 3m (d): the driver on the card ({TRAIN_ARCH} smoke, 8 "
            f"steps, checkpoints every 2): the drill exited 42 at step 5, "
            f"--resume restored step 4; final loss {final[0]!r} vs "
            f"uninterrupted {final[1]!r} (rel {loss_rel:.2e}, tol "
            f"{DRILL_LOSS_RTOL}); step-8 state: {len(a)} leaves, largest "
            f"|gap| {gap:.3e} (tol {DRILL_ATOL}); "
            f"{time.perf_counter() - t0:.1f} s")
        if loss_rel > DRILL_LOSS_RTOL or gap > DRILL_ATOL:
            raise AssertionError("the resumed run does not end where the "
                                 "uninterrupted one ends")


def phase_train(K, testing):
    """Phase 3m: (a) h2o-danube-3-4b and (b) qwen2-72b training at
    published widths, (c) MIND train-then-retrieve, (d) the driver's
    drill. Returns the kernel-table rows of (c)'s retrieval."""
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"phase 3m: training on {card_line()}; "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated at the "
        "start")
    lm_train(K, testing, TRAIN_ARCH, TRAIN_DEPTH, TRAIN_BATCH, TRAIN_SEQ,
             TRAIN_STEPS, "(a) danube", checks=True)
    lm_train(K, testing, QWEN_ARCH, QWEN_DEPTH, QWEN_BATCH, TRAIN_SEQ,
             QWEN_STEPS, "(b) qwen2", checks=False)
    rows = mind_train(K, testing)
    train_drill()
    log(f"  phase 3m: {time.perf_counter() - t_phase:.0f} s on "
        f"{card_line()}")
    return rows


# ---------------------------------------------------------------------------
# Phase 3n: GNN training.
# ---------------------------------------------------------------------------


def gcn_step_bytes(n: int, e: int, f: int, widths) -> dict:
    """The bytes a full-graph GCN training step moves in its message
    passing, counted from ``models/gnn.py`` (each op's inputs read once and
    outputs written once): the edge coefficients (in-degree ``index_add``,
    two ``index_select`` of ``rsqrt(deg)``, their product); per layer of
    output width H forward the gather ``h[src]`` (E int32 ids, E x H rows
    read and written), its scale by ``coef`` in place and the ``index_add``
    into dst, and backward the same three (the gradient's gather at dst,
    the scale, the ``index_add`` at src); the features read by layer 1's
    forward and its weight gradient. Node-sized elementwise traffic (the
    self-loop term, bias, relu, the loss) is left out: a lower bound."""
    coef = 4 * e + 2 * 12 * e + 12 * e
    per_layer = {h: 2 * (20 * e * h + 12 * e) for h in widths}
    feats = 2 * 4 * n * f
    return {"coef": coef, "layers": per_layer, "feats": feats,
            "total": coef + sum(per_layer.values()) + feats}


def gnn_grads_check(label, loss_fn, params, batch):
    """``value_and_grad`` of ``loss_fn`` on the card against the CPU path
    on copies of the same weights and batch: the loss within GNN_LOSS_RTOL,
    each gradient leaf within GNN_GRAD_RTOL of its norm."""
    from repro_torch import tree
    from repro_torch.train.trainstep import value_and_grad
    t0 = time.perf_counter()
    loss_g, grads_g = value_and_grad(loss_fn, params, batch)
    cpu = tree.structure(params).unflatten(
        [t.cpu() for t in tree.leaves(params)])
    loss_c, grads_c = value_and_grad(loss_fn, cpu,
                                     {k: v.cpu() for k, v in batch.items()})
    worst, where = worst_leaf_gap(grads_g, grads_c)
    rel = abs(float(loss_g) - float(loss_c)) / abs(float(loss_c))
    log(f"  {label} card vs CPU ({time.perf_counter() - t0:.1f} s): loss "
        f"{float(loss_g):.7f} vs {float(loss_c):.7f} (rel {rel:.2e}, tol "
        f"{GNN_LOSS_RTOL}); worst gradient leaf {where} at {worst:.2e} of "
        f"its norm (tol {GNN_GRAD_RTOL})")
    if rel > GNN_LOSS_RTOL or worst > GNN_GRAD_RTOL:
        raise AssertionError(f"{label}: the card's loss or gradients "
                             "disagree with the CPU path")


def gnn_f64_loss(params, batch, cfg) -> float:
    """The full-graph loss of ``params`` on ``batch`` with weights,
    features and compute in f64 (no gradient), on the card."""
    from repro_torch.models import gnn
    with torch.no_grad():
        p64 = {"w": [{k: v.double() for k, v in w.items()}
                     for w in params["w"]]}
        b64 = dict(batch, feats=batch["feats"].double())
        loss = gnn.full_graph_loss(p64, b64, dataclasses.replace(
            cfg, param_dtype=torch.float64, compute_dtype=torch.float64))
        return float(loss)


def gnn_profile(label, fn, step_ms):
    """One step's device time by kind of kernel under ``torch.profiler``:
    gathers (``index_select``: ``vectorized_gather_kernel`` for rows of 16
    f32, ``_scatter_gather_elementwise_kernel`` otherwise, on torch 2.11),
    ``index_add`` (``indexFuncLargeIndex``), products, elementwise,
    reductions and the rest, and the largest kernels."""
    from repro_torch.analysis.trace_rules import profile_kernels
    _, rows, _ = profile_kernels(fn)
    busy = sum(us for _, _, us in rows) / 1e3
    if busy <= 0:
        log(f"  {label} step by kernel: not measured (no device time "
            "recorded)")
        return
    kinds = (("gathers", ("gather", "indexselect", "index_select")),
             ("index_add", ("indexfunc", "index_add")),
             ("products", ("gemm", "nvjet", "xmma", "cutlass")),
             ("elementwise", ("elementwise", "vectorized")),
             ("reductions", ("reduce",)))
    split = {k: 0.0 for k, _ in kinds}
    split["other"] = 0.0
    for name, _, us in rows:
        low = name.lower()
        kind = next((k for k, keys in kinds if any(x in low for x in keys)),
                    "other")
        split[kind] += us / 1e3
    top = sorted(rows, key=lambda r: -r[2])[:6]
    log(f"  {label} one step under torch.profiler: device busy {busy:.1f} "
        f"ms ({sum(c for _, c, _ in rows)} kernels) against {step_ms:.1f} "
        "ms unprofiled; " + ", ".join(f"{k} {v:.1f} ms ({v / busy:.1%})"
                                      for k, v in split.items())
        + "; largest: " + "; ".join(f"{name[:60]} x{c} {us / 1e3:.1f} ms"
                                    for name, c, us in top))


def no_host_sync(fn):
    """``fn()`` under ``set_sync_debug_mode("error")``: a host sync raises."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)


def gnn_shape(shape_name: str, n_steps: int):
    """``gcn-cora`` at ``shape_name``: the bundle's step on random weights
    drawn on the card and the training CLI's graph (drawn on the card, timed
    apart), ``n_steps`` steps timed with CUDA events, every step after the
    first under ``no_host_sync``; the shape's check; the rate and peak."""
    from repro_torch.configs import registry
    from repro_torch.launch import steps, train
    from repro_torch.models import gnn
    dev = torch.device("cuda")
    module = registry.get("gcn-cora")
    shape = module.SHAPES[shape_name]
    bundle = steps.build_bundle("gcn-cora", shape_name, device=dev)
    cfg = bundle.config
    params = gnn.init(cfg, generator=torch.Generator(device=dev).manual_seed(
        GNN_SEED), device=dev)
    opt = bundle.opt_init(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    maker_ms, graph = timed_once(
        lambda: train.make_graph(module, bundle, GNN_SEED))
    batch_ms, first = timed_once(
        lambda: train.make_batch(module, bundle, 0, GNN_SEED, graph))
    maker_peak = torch.cuda.max_memory_allocated() / 1e9
    kind = shape["kind"]
    loss_fn = {"gnn_full": gnn.full_graph_loss,
               "gnn_minibatch": gnn.minibatch_loss,
               "gnn_batched": gnn.batched_graphs_loss}[kind]
    if kind == "gnn_full":
        n, e = shape["n_nodes"], shape["n_edges"]
        per_step, unit = e * cfg.n_layers, "edges"
        what = (f"n {n:,}, E {e:,}, F {shape['d_feat']}, C "
                f"{shape['n_classes']}")
    elif kind == "gnn_minibatch":
        per_step, unit = shape["batch_nodes"], "seeds"
        what = (f"n {shape['n_nodes']:,}, E {shape['n_edges']:,} in CSR, F "
                f"{shape['d_feat']}, C {shape['n_classes']}, "
                f"{shape['batch_nodes']} seeds, fanouts {cfg.fanouts}")
    else:
        per_step, unit = shape["batch"], "graphs"
        what = (f"{shape['batch']} graphs of {shape['n_nodes']} nodes and "
                f"{shape['n_edges']} edges, F {shape['d_feat']}, C "
                f"{shape['n_classes']}")
    log(f"phase 3n ({shape_name}): {what}; graph maker on the card "
        f"{maker_ms:.1f} ms (+ step 0's batch {batch_ms:.1f} ms), peak "
        f"{maker_peak:.2f} GB; model flops a step {bundle.model_flops:.3e}")

    def step_loss(p, b):
        return loss_fn(p, b, cfg)

    f64 = None
    if shape_name == "ogb_products":
        f64 = gnn_f64_loss(params, first, cfg)
        torch.cuda.empty_cache()
    elif kind != "gnn_batched":
        gnn_grads_check(shape_name, step_loss, params, first)
    readings = []
    for i in range(n_steps):
        batch = first if i == 0 else train.make_batch(module, bundle, i,
                                                      GNN_SEED, graph)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = bundle.fn(params, opt, batch) if i == 0 else \
            no_host_sync(lambda: bundle.fn(params, opt, batch))
        end.record()
        end.synchronize()
        params, opt, metrics = out
        ms = start.elapsed_time(end)
        m = {k: float(v) for k, v in metrics.items()}
        readings.append((ms, torch.cuda.max_memory_allocated() / 1e9, m))
        if not (np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])):
            raise AssertionError(f"{shape_name} step {i}: non-finite "
                                 f"metrics {m}")
    ms = [r[0] for r in readings[1:]]
    med = float(np.median(ms))
    log(f"  {shape_name}: {n_steps} steps, ms a step "
        f"{[round(r[0], 2) for r in readings]}; median {med:.2f}, max "
        f"{max(ms):.2f} over steps 1-{n_steps - 1}; "
        f"{per_step / med * 1e3:,.0f} {unit}/s; peak {max(r[1] for r in readings):.2f} GB; losses "
        f"{[round(r[2]['loss'], 5) for r in readings]}; grad norms "
        f"{[round(r[2]['grad_norm'], 5) for r in readings]}; host syncs in "
        f"steps 1-{n_steps - 1}: 0 (set_sync_debug_mode error)")
    if f64 is not None:
        rel = abs(readings[0][2]["loss"] - f64) / abs(f64)
        log(f"  {shape_name} step 0's loss f32 {readings[0][2]['loss']!r} vs "
            f"f64 {f64!r} on the card (rel {rel:.2e}, tol {GNN_F64_RTOL})")
        if rel > GNN_F64_RTOL:
            raise AssertionError("ogb_products: the f32 loss disagrees with "
                                 "f64")
        need = gcn_step_bytes(shape["n_nodes"], shape["n_edges"],
                              shape["d_feat"],
                              [cfg.d_hidden] * (cfg.n_layers - 1)
                              + [cfg.n_classes])
        bound = need["total"] / PEAK_BYTES_PER_S * 1e3
        log(f"  {shape_name} step's bandwidth bound: "
            f"{need['total'] / 1e9:.1f} GB the message passing moves "
            f"(coefficients {need['coef'] / 1e9:.2f}, layers "
            + ", ".join(f"H {h} {b / 1e9:.1f}"
                        for h, b in need["layers"].items())
            + f", features {need['feats'] / 1e9:.2f}) / "
            f"{PEAK_BYTES_PER_S / 1e12:.2f} TB/s = {bound:.1f} ms; the median "
            f"step {med:.1f} ms is {bound / med:.1%} of it "
            f"({need['total'] / med / 1e6:.0f} GB/s)")
        gnn_profile(shape_name, lambda: bundle.fn(params, opt, first), med)
    del params, opt, graph, first, batch, out
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def gnn_cli():
    """``python -m repro_torch.launch.train --arch gcn-cora --shape
    minibatch_lg --steps 4`` on the card (no --smoke, no --device): it must
    exit 0 and print steps 0 and 3 and its final loss."""
    import os
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           "gcn-cora", "--shape", "minibatch_lg", "--steps", "4"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("REPRO_FAIL_AT_STEP", None)
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, env=env, cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    lines = proc.stdout.splitlines()
    shown = [ln for ln in lines if ln.startswith(("step", "final", "done"))]
    log(f"phase 3n (launch.train): {' '.join(cmd[1:])} exited "
        f"{proc.returncode} in {time.perf_counter() - t0:.1f} s: " + " | ".join(shown))
    steps_seen = {int(ln.split()[1]) for ln in lines
                  if ln.startswith("step ")}
    if proc.returncode != 0 or not {0, 3} <= steps_seen or not any(
            ln.startswith("final loss") for ln in lines):
        raise AssertionError(f"the GNN training CLI run failed: "
                             f"{proc.stderr[-2000:]}")


def phase_gnn():
    """Phase 3n: gcn-cora trained at its four published shapes, then the
    training CLI on minibatch_lg."""
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"phase 3n: GNN training on {card_line()}; "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated at the "
        "start")
    for shape_name, n_steps in GNN_STEPS.items():
        gnn_shape(shape_name, n_steps)
    gnn_cli()
    log(f"  phase 3n: {time.perf_counter() - t_phase:.0f} s on "
        f"{card_line()}")


# ---------------------------------------------------------------------------
# Phase 3o: the step bundles of every serving and search kind at published
# widths.
# ---------------------------------------------------------------------------


def bundle_ms(fn):
    """(median ms, max ms, last output) of ``fn`` over BUNDLE_REPS runs
    after a warm-up."""
    times, out = event_ms(fn, BUNDLE_REPS)
    return times[BUNDLE_REPS // 2], times[-1], out


def zero_counters(K) -> None:
    for fn in all_counters(K):
        fn.launches = 0


def peak_gb(base: int) -> float:
    return (torch.cuda.max_memory_allocated() - base) / 1e9


def profiled_step(fn, key, label, want=None):
    """One call of ``fn`` under ``torch.profiler``
    (``trace_rules.profile_kernels``, pads on both sides): (device busy
    ms, ms of the kernels whose name holds ``key``, kernels, their
    launches, sessions taken). A session that records no device activity
    of the call, or not its pads on both sides (events lost), is taken
    again in a new session after PROFILE_PAUSE_S, up to PROFILE_SESSIONS;
    raises if none records the whole call, or if ``want`` is given and the
    launches differ."""
    from repro_torch.analysis.trace_rules import profile_kernels
    for n in range(1, PROFILE_SESSIONS + 1):
        _, rows, intact = profile_kernels(fn)
        if intact and rows:
            break
        log(f"  {label}: profiler session {n} lost the step's device "
            "events")
        time.sleep(PROFILE_PAUSE_S)
    else:
        raise AssertionError(f"{label}: torch.profiler lost the step's "
                             f"device events in {n} sessions")
    busy = sum(us for _, _, us in rows) / 1e3
    hit_ms = sum(us for name, _, us in rows if key in name) / 1e3
    hits = sum(c for name, c, _ in rows if key in name)
    kernels = sum(c for _, c, _ in rows)
    if want is not None and hits != want:
        raise AssertionError(f"{label}: {hits} {key} launches in a step "
                             f"under the profiler, {want} expected")
    return busy, hit_ms, kernels, hits, n


def profiler_empty_sessions(n: int = 40) -> str:
    """How many of ``n`` short ``torch.profiler`` sessions (four 4096^3
    f32 products each, back to back, no pads) record no device event, at
    this point of the process."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    x = torch.randn(4096, 4096, device="cuda")
    empty = 0
    for _ in range(n):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(4):
                x @ x
            torch.cuda.synchronize()
        empty += not any(getattr(e, "device_type", None) == DeviceType.CUDA
                         for e in prof.events())
    return (f"torch.profiler {time.perf_counter() - T_IMPORT:.0f} s into the "
            f"process: {empty} of {n} short sessions (four 4096^3 products, "
            "no pads) recorded no device event")


def vs_bundle_inputs(bundle, gen, n_rows=None):
    """A search bundle's arguments on the card: queries, tags, reduced rows
    (N(0, 1)) and per-cluster views A_c with orthonormal rows, the full
    rows their cluster's view plus noise (x_full = A_t^T x_low + VS_NOISE
    z): the rerank reorders the reduced scan's top kappa, and the top k
    is close to the exact one."""
    q, tags, x_low, x_full, a = bundle.args
    c, d, dim = a.shape
    n = x_low.shape[0]
    dev = torch.device("cuda")
    a = torch.linalg.qr(torch.randn(c, dim, d, device=dev, generator=gen)
                        )[0].transpose(1, 2).contiguous()
    tags = torch.randint(0, c, tags.shape, device=dev, generator=gen,
                         dtype=torch.int32)
    rows = tags.long().repeat_interleave(n // tags.shape[0])
    x_low = torch.randn((n, d), device=dev, generator=gen)
    x_full = torch.empty((n, dim), device=dev)
    for t in range(c):
        idx = torch.nonzero(rows == t)[:, 0]
        x_full.index_copy_(0, idx, x_low.index_select(0, idx) @ a[t])
    del rows
    for part in x_full.split(1 << 20):          # no full-size temporary
        part.add_(torch.randn(part.shape, device=dev, generator=gen),
                  alpha=VS_NOISE)
    return [torch.randn(q.shape, device=dev, generator=gen), tags, x_low,
            x_full, a]


def vs_plain_step(K, steps_mod, args, kappa, k, layout_block):
    """The search step on the kernel's plain version: views, the plain
    top kappa, the same rerank and merge."""
    from repro_torch.index.distributed import _merge_topk
    q, tags, x_low, x_full, a = args
    views = torch.einsum("cdk,mk->mcd", a, q)
    qlo = torch.zeros(views.shape[:2], device=q.device)
    _, ids = K.gleanvec_sq_topk_plain(views, qlo, tags, x_low, kappa,
                                      layout_block=layout_block)
    return _merge_topk(steps_mod.vs_rerank(q, ids, x_full), ids, k)


def vs_search_cell(K, testing, shape_name, gen, measured):
    """One ``vs_search*`` cell through ``build_bundle`` at its published
    n: the step's ms (median, max), QPS, peak, host syncs (none, under
    ``set_sync_debug_mode("error")``), B1 launches (the counter and the
    profiler: one a batch); ids valid without repeats, each value the
    full-precision score of its id, recall@k against the exact top k
    (ip_topk over the full rows) above the reduced scan's own top k's (the
    rerank and kappa > k show), and on the first ~1M rows the step equal
    to the same step on the kernel's plain version. Returns (its launches
    of gleanvec_sq_topk, its kernel-table row or None)."""
    from repro_torch.configs import registry
    from repro_torch.core.scorer import GleanVecScorer
    from repro_torch.launch import steps as steps_mod
    shape = registry.get("gleanvec-paper").SHAPES[shape_name]
    sorted_layout = shape["kind"] == "vs_search_sorted"
    bundle = steps_mod.build_bundle("gleanvec-paper", shape_name)
    kappa, k = shape["kappa"], shape["k"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    args = vs_bundle_inputs(bundle, gen)
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    q, tags, x_low, x_full, a = args
    n, d = x_low.shape
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    zero_counters(K)
    med, mx, (vals, ids) = bundle_ms(lambda: bundle.fn(*args))
    launches = K.gleanvec_sq_topk.launches
    peak = peak_gb(base)
    measured.append(measured_step(shape_name, bundle.fn, args,
                                  bundle.model_flops, med, peak))
    with uncounted(K):
        no_host_sync(lambda: bundle.fn(*args))
        key = "ip_scan_kernel" if sorted_layout else "gemm_scan_topk_kernel"
        busy, b1_ms, kernels, hits, sessions = profiled_step(
            lambda: bundle.fn(*args), key, f"phase 3o {shape_name}", want=1)
        if launches != 1 + BUNDLE_REPS:
            raise AssertionError(f"phase 3o {shape_name}: {launches} "
                                 "gleanvec_sq_topk launches counted")
        ids_l = ids.long()
        if ids.shape != (q.shape[0], k) or bool((ids_l < 0).any()) \
                or bool((ids_l >= n).any()):
            raise AssertionError(f"phase 3o {shape_name}: malformed ids")
        srt = torch.sort(ids_l, dim=1).values
        if bool((srt[:, 1:] == srt[:, :-1]).any()):
            raise AssertionError(f"phase 3o {shape_name}: a repeated id")
        tol = testing.dot_tol(row_norm_max(q), row_norm_max(x_full),
                              x_full.shape[1])
        full = torch.bmm(x_full[ids_l], q[:, :, None])[..., 0]
        err = float((full - vals).abs().max())
        if err > tol:
            raise AssertionError(f"phase 3o {shape_name}: a value is not "
                                 f"its id's score ({err:.3e} > {tol:.3e})")
        exact = K.ip_topk(q, x_full, k)[1].long()
        _, reduced = steps_mod.vs_candidates(
            torch.einsum("cdk,mk->mcd", a, q), tags, x_low, k,
            sorted_layout)
        recall, recall_reduced = (
            float((r.long()[:, :, None] == exact[:, None, :]).any(-1)
                  .float().mean()) for r in (ids, reduced))
        if not recall > recall_reduced:
            raise AssertionError(f"phase 3o {shape_name}: recall@{k} "
                                 f"{recall:.4f}, the reduced scan's own "
                                 f"{recall_reduced:.4f}")
        n0 = BUNDLE_CHECK_ROWS - BUNDLE_CHECK_ROWS % steps_mod.VS_BLOCK
        pre = [q, tags[:n0 // steps_mod.VS_BLOCK] if sorted_layout
               else tags[:n0], x_low[:n0], x_full[:n0], a]
        got = bundle.fn(*pre)
        want = vs_plain_step(K, steps_mod, pre, kappa, k,
                             steps_mod.VS_BLOCK if sorted_layout else 0)
        rep = testing.assert_topk_close(got, want, tol, f"phase 3o "
                                        f"{shape_name} {n0} rows vs plain")
        del pre, got, want, full, exact, reduced
        row = None
        if shape_name in VS_ROW_CELLS:
            views = torch.einsum("cdk,mk->mcd", a, q)
            calls = mode_calls(K, "gleanvec", GleanVecScorer(x_low=x_low,
                                                             tags=tags),
                               views, kappa)
            row = time_kernel("gleanvec_sq_topk", VS_ROW_CELLS[shape_name],
                              calls, launches, testing)
            del calls, views
    b1_bound, _ = bound_ms(2.0 * q.shape[0] * n * d, 0)
    profile = (f"{key} {hits} a step, {b1_ms:.2f} of {busy:.2f} ms busy "
               f"({kernels} kernels, profiler session {sessions})")
    log(f"  {shape_name} ({'sorted' if sorted_layout else 'gathered'}, n={n}"
        f" D={x_full.shape[1]} d={d} C={a.shape[0]} batch={q.shape[0]} "
        f"kappa={kappa} k={k}): data drawn {draw_s:.1f} s "
        f"({(x_full.numel() + x_low.numel()) * 4 / 1e9:.1f} GB); step "
        f"median={med:.2f} ms max={mx:.2f} ms QPS={q.shape[0] / med * 1e3:.0f}"
        f" model TFLOP/s={bundle.model_flops / med / 1e9:.1f} peak above the "
        f"data={peak:.2f} GB host syncs=0; profile: {profile}; B1 bound "
        f"{b1_bound:.1f} ms; recall@{k} {recall:.4f} against the exact top "
        f"{k} (the reduced scan's own top {k}: {recall_reduced:.4f}); {n0}-"
        f"row prefix vs plain "
        f"max_abs_err={rep['max_abs_err']:.2e}; gleanvec_sq_topk "
        f"launches={launches}")
    del args, q, tags, x_low, x_full, a, vals, ids
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return launches, row


def learn_f64(x, q, tags, centers_in, c, d):
    """The data pass in f64 on the card, on the f32 step's tags (a row
    within rounding of two centers could take either): (new centers, A^T
    B of every cluster)."""
    x, q = x.double(), q.double()
    x_unit = x / x.norm(dim=1, keepdim=True)
    tags = tags.long()
    sums = torch.zeros((c, x.shape[1]), dtype=torch.float64,
                       device=x.device).index_add_(0, tags, x_unit)
    new = sums / sums.norm(dim=1, keepdim=True)
    evals, u = torch.linalg.eigh(q.T @ q)
    s = torch.sqrt(torch.clamp(evals, min=0.0))
    w = (u * s) @ u.T
    w_pinv = (u * torch.where(s > 1e-4 * s.max(), 1 / s, 0 * s)) @ u.T
    atb = []
    for t in range(c):
        xc = x[tags == t]
        m = w @ (xc.T @ xc) @ w
        ev, vecs = torch.linalg.eigh(0.5 * (m + m.T))
        p = vecs[:, torch.argsort(-ev)[:d]].T
        atb.append((p @ w_pinv).T @ (p @ w))
    return new, torch.stack(atb)


def vs_learn_cell(K, testing, gen, measured):
    """``learn_oi13m``'s data pass (n 1,000,448, m 10,000, C 48, d 160) on
    rows and queries N(0, 1) on their first d coordinates and N(0, 0.01)
    on the rest (every fit's top-d eigenspace stands clear of the rest, so
    A^T B is fixed to the f32 moments' rounding): ms, peak, the work done
    beside the reference's model flops; the centers and every cluster's
    A^T B against the same pass in f64 on the step's tags. Returns the
    kmeans_assign row."""
    from repro_torch.configs import registry
    from repro_torch.core import spherical_kmeans as skm
    from repro_torch.launch import steps as steps_mod
    shape = registry.get("gleanvec-paper").SHAPES["learn_oi13m"]
    c, d = shape["C"], shape["d"]
    bundle = steps_mod.build_bundle("gleanvec-paper", "learn_oi13m")
    (n, dim), (m, _) = bundle.args[0].shape, bundle.args[1].shape
    dev = torch.device("cuda")
    scale = torch.where(torch.arange(dim, device=dev) < d, 1.0, 0.1)
    x = torch.randn((n, dim), device=dev, generator=gen) * scale
    q = torch.randn((m, dim), device=dev, generator=gen) * scale
    centers = skm.normalize_rows(torch.randn((c, dim), device=dev,
                                             generator=gen))
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    zero_counters(K)
    med, mx, (cent, a, b) = bundle_ms(lambda: bundle.fn(x, q, centers))
    launches = K.kmeans_assign.launches
    peak = peak_gb(base)
    measured.append(measured_step("learn_oi13m", bundle.fn,
                                  (x, q, centers), bundle.model_flops, med,
                                  peak))
    with uncounted(K):
        x_unit = skm.normalize_rows(x)
        want_c, want_atb = learn_f64(x, q, skm.assign(x_unit, centers),
                                     centers, c, d)
        c_err = float((cent.double() - want_c).abs().max())
        atb = torch.einsum("cdk,cdj->ckj", a.double(), b.double())
        rel = float(((atb - want_atb).flatten(1).norm(dim=1)
                     / want_atb.flatten(1).norm(dim=1)).max())
        if c_err > LEARN_CENTER_TOL or rel > LEARN_ATB_TOL \
                or not bool(torch.isfinite(a).all()):
            raise AssertionError(f"phase 3o learn_oi13m vs f64: centers "
                                 f"{c_err:.2e}, A^T B {rel:.2e}")
        row = kmeans_row(K, testing, f"learn_oi13m n={n} C={c}", x_unit,
                         centers, launches)
    done = 2.0 * n * c * dim + 2.0 * m * dim * dim + 2.0 * n * dim * dim \
        + 2.0 * n * dim
    log(f"  learn_oi13m (n={n} m={m} D={dim} C={c} d={d}): step "
        f"median={med:.1f} ms max={mx:.1f} ms peak above the data="
        f"{peak:.2f} GB; work done {done / 1e12:.3f} TFLOP (the moments "
        f"by cluster: 1/C of the reference's masked products) beside the "
        f"reference's model flops {bundle.model_flops / 1e12:.3f} TFLOP; "
        f"vs f64: centers max_abs_err={c_err:.2e} (tol {LEARN_CENTER_TOL}),"
        f" A^T B worst relative {rel:.2e} (tol {LEARN_ATB_TOL}); "
        f"kmeans_assign launches={launches}")
    del x, x_unit, q, cent, a, b, atb, want_atb
    torch.cuda.empty_cache()
    return row


def prefill_flash_row(K, testing, b, s, window, launches):
    """flash_attention at the prefill bundle's shape (B, H 32, KV 8, S, dh
    120, the window; q, k, v as the prefill passes them: (B, S, heads, dh)
    views) on random data: the kernel-table row, its library yardstick SDPA
    with a dense causal + window mask."""
    from repro_torch.configs import registry
    cfg = registry.get(LM_ARCH).make_config()
    g = torch.Generator(device="cuda").manual_seed(BUNDLE_SEED)

    def heads(n):
        return torch.randn((b, s, n, cfg.d_head), device="cuda", generator=g,
                           dtype=torch.bfloat16).transpose(1, 2)
    q, k, v = heads(cfg.n_heads), heads(cfg.n_kv_heads), \
        heads(cfg.n_kv_heads)
    flops, nbytes = flash_work(q, k, v, window)
    ms, out_k = timed(lambda: K.flash_attention(q, k, v, True, window), 3)
    plain_ms, out_p = timed_once(
        lambda: K.flash_attention_plain(q, k, v, True, window))
    err, used = testing.attention_error(
        out_k, out_p, testing.attention_abs_mix(q, k, v, True, window))
    if used > 1:
        raise AssertionError(f"flash_attention vs plain at S={s}")
    del out_p
    lib_ms, _, how = sdpa_library(q, k, v, window, 2)
    bnd, by = bound_ms(flops, nbytes, PEAK_BF16_FLOPS)
    log(f"  flash_attention[danube prefill B={b} S={s} W={window}, "
        f"{flash_kernel_name(q, k, v)}]: ms={ms:.3f} ({flops / ms / 1e9:.1f} "
        f"TFLOP/s) plain_ms={plain_ms:.3f} bound_ms={bnd:.3f} ({by}) "
        f"library_ms={lib_ms:.3f} (SDPA, {how}, a dense (S, S) mask) "
        f"max_abs_err={err:.3e} (worst element at {used:.3f} of its "
        f"tolerance) launches={launches}")
    src, repl = KERNEL_FILES["flash_attention"]
    return {"name": f"flash_attention[danube prefill B={b} S={s}]",
            "route": "cuda", "source": src, "replaces": repl,
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by,
            "library_ms": lib_ms}


def lm_bundle_cells(K, testing, measured):
    """h2o-danube-3-4b's prefill_32k (batch cut), decode_32k and long_500k
    bundles at published widths on one set of random weights. Returns the
    flash_attention row."""
    from repro_torch.analysis.trace_rules import profile_kernels
    from repro_torch.configs import registry
    from repro_torch.launch import steps as steps_mod
    from repro_torch.models import transformer as tfm
    dev = torch.device("cuda")
    shapes = registry.get(LM_ARCH).SHAPES
    gen = torch.Generator(device=dev).manual_seed(BUNDLE_SEED)
    pre = steps_mod.build_bundle(LM_ARCH, "prefill_32k")
    cfg = pre.config
    params = tfm.init(cfg, seed=BUNDLE_SEED, device=dev)
    w_gb = tfm.param_count(params) * 2 / 1e9
    b, s = PREFILL_BATCH, shapes["prefill_32k"]["seq"]
    tokens = torch.randint(0, cfg.vocab, (b, s), device=dev, generator=gen,
                           dtype=torch.int32)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    zero_counters(K)
    med, mx, (logits, cache) = bundle_ms(lambda: pre.fn(params, tokens))
    launches = K.flash_attention.launches
    peak = peak_gb(base)
    with uncounted(K):
        busy, fa_ms, kernels, hits, sessions = profiled_step(
            lambda: pre.fn(params, tokens), LM_FLASH_KERNEL,
            "phase 3o prefill_32k", want=cfg.n_layers)
    keep = tfm.cache_len(cfg, s)
    if launches != (1 + BUNDLE_REPS) * cfg.n_layers \
            or logits.shape != (b, cfg.vocab) \
            or not bool(torch.isfinite(logits).all()) \
            or cache["k"].shape != (cfg.n_layers, b, keep, cfg.n_kv_heads,
                                    cfg.d_head):
        raise AssertionError(f"phase 3o prefill_32k: {launches} launches, "
                             f"{hits} {LM_FLASH_KERNEL} a step, or "
                             "malformed outputs")
    flops = pre.model_flops * b / pre.args[1].shape[0]
    measured.append(measured_step(f"prefill_32k B={b}", pre.fn,
                                  (params, tokens), flops, med, peak))
    log(f"  prefill_32k (B {pre.args[1].shape[0]} cut to {b}, S={s}, all "
        f"{cfg.n_layers} layers, {w_gb:.1f} GB weights): median={med:.1f} ms"
        f" max={mx:.1f} ms tokens/s={b * s / med * 1e3:.0f} model TFLOP/s="
        f"{flops / med / 1e9:.1f} peak above the weights={peak:.2f} GB; "
        f"profile: {hits} {LM_FLASH_KERNEL} a step ({fa_ms:.1f} of "
        f"{busy:.1f} ms busy, {fa_ms / max(busy, 1e-9):.1%}; {kernels} "
        f"kernels, profiler session {sessions}); flash_attention "
        f"launches={launches}")
    del logits, cache, tokens
    torch.cuda.empty_cache()
    with uncounted(K):
        row = prefill_flash_row(K, testing, b, s, cfg.swa_window, launches)
    torch.cuda.empty_cache()
    for shape_name in ("decode_32k", "long_500k"):
        bun = steps_mod.build_bundle(LM_ARCH, shape_name)
        cache_abs, tok_abs = bun.args[1], bun.args[2]
        nb, seq = tok_abs.shape[0], shapes[shape_name]["seq"]
        cache = {k_: torch.empty(v.shape, dtype=v.dtype, device=dev)
                 for k_, v in cache_abs.items()}
        for t in cache.values():
            for layer in t:
                layer.normal_(generator=gen)
        tok = torch.randint(0, cfg.vocab, (nb,), device=dev, generator=gen,
                            dtype=torch.int32)
        pos = torch.tensor(seq - 1, dtype=torch.int32, device=dev)
        slot = (seq - 1) % cache["k"].shape[2]
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        med, mx, (logits, _) = bundle_ms(lambda: bun.fn(params, cache, tok,
                                                        pos))
        peak = peak_gb(base)
        measured.append(measured_step(shape_name, bun.fn,
                                      (params, cache, tok, pos),
                                      bun.model_flops, med, peak))
        no_host_sync(lambda: bun.fn(params, cache, tok, pos))
        with uncounted(K):
            _, rows, intact = profile_kernels(
                lambda: bun.fn(params, cache, tok, pos))
        again, _ = bun.fn(params, cache, tok, seq - 1)
        if not torch.equal(again, logits) or logits.shape != (nb, cfg.vocab)\
                or not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"phase 3o {shape_name}: the tensor pos "
                                 "and the int pos disagree, or bad logits")
        c_bytes = sum(t.numel() for t in cache.values()) * 2
        bnd = (c_bytes + w_gb * 1e9) / PEAK_BYTES_PER_S * 1e3
        log(f"  {shape_name} (batch {nb}, pos {seq - 1} -> ring slot {slot} "
            f"of {cache['k'].shape[2]}, cache {c_bytes / 1e9:.1f} GB): "
            f"median={med:.2f} ms max={mx:.2f} ms tokens/s="
            f"{nb / med * 1e3:.0f} bound={bnd:.2f} ms (cache + weights read "
            f"once at 3.35 TB/s) peak above the cache={peak:.2f} GB; host "
            "syncs=0 (tensor pos); " + (
                f"{sum(c for _, c, _ in rows)} kernels, "
                f"{sum(us for _, _, us in rows) / 1e3:.2f} ms busy (idle "
                f"{1 - sum(us for _, _, us in rows) / 1e3 / med:.1%})"
                if intact else "device time not measured (the profiler "
                "lost the step's events)") + "; int pos logits equal")
        del cache, logits, again
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()
    return row


def recsys_cell(label, fn, args, b, kind, measured, model_flops):
    """One serve or retrieval call: ms (median, max), rows or users a
    second, peak and host syncs; finite scores, ids valid and distinct."""
    from repro_torch.analysis.trace_rules import sync_count
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    med, mx, out = bundle_ms(lambda: fn(*args))
    peak = peak_gb(base)
    measured.append(measured_step(label, fn, args, model_flops, med, peak))
    syncs = sync_count(lambda: fn(*args))
    if kind == "recsys_serve":
        ok = out.shape == (b,) and bool(torch.isfinite(out.float()).all())
    else:
        srt = torch.sort(out.long(), dim=1).values
        ok = out.shape == (b, 10) and bool((out >= 0).all()) \
            and bool((out < args[2].shape[0]).all()) \
            and not bool((srt[:, 1:] == srt[:, :-1]).any())
    if not ok:
        raise AssertionError(f"phase 3o {label}: malformed outputs")
    log(f"  {label} (batch {b}): median={med:.3f} ms max={mx:.3f} ms "
        f"{b / med * 1e3:.0f} users/s peak above the start={peak:.3f} GB "
        f"host syncs={syncs}")


def recsys_bundle_cells(measured):
    """The recommenders' serve_p99, serve_bulk and retrieval_cand bundles
    at published widths (DLRM with its table cut); then DLRM's
    ``make_sharded_lookup`` on a one-rank NCCL group, (1, 1) mesh."""
    from repro_torch import tree
    from repro_torch.configs import registry
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch import train
    from repro_torch.models import recsys
    dev = torch.device("cuda")
    for arch in ("bst", "mind", "fm", "dlrm-mlperf"):
        module = registry.get(arch)
        model = module.MODEL
        cfg = module.make_config()
        note = ""
        if model == "dlrm":
            full_rows = cfg.padded_total_vocab
            cfg = dataclasses.replace(cfg, vocab_sizes=tuple(
                min(v, DLRM_ROWS_CAP) for v in cfg.vocab_sizes))
            note = (f"; table cut from {full_rows:,} to "
                    f"{cfg.padded_total_vocab:,} rows (each field <= "
                    f"{DLRM_ROWS_CAP:,})")
        gen = torch.Generator(device=dev).manual_seed(BUNDLE_SEED)
        params = getattr(recsys, model).init(gen, cfg, device=dev)
        log(f"  {arch}: {sum(t.numel() for t in tree.leaves(params)) * 4 / 1e9:.2f}"
            f" GB of f32 parameters{note}")
        for shape_name, shape in module.SHAPES.items():
            if shape["kind"] == "recsys_train":
                continue
            bun = steps_mod.build_bundle(arch, shape_name)
            batch = train.recsys_batch(model, cfg, shape["batch"],
                                       BUNDLE_SEED, 0, dev)
            if shape["kind"] == "recsys_serve":
                fn = steps_mod.recsys_serve_fn(model, cfg)
                args = (params, batch)
            else:
                fn = steps_mod.retrieval_fn(model, cfg)
                cands = torch.randn(bun.args[2].shape, device=dev,
                                    generator=gen)
                args = (params, batch, cands)
            recsys_cell(f"{arch}:{shape_name}", fn, args, shape["batch"],
                        shape["kind"], measured, bun.model_flops)
            del batch, args
        if model == "dlrm":
            dlrm_sharded_lookup(params, cfg)
        del params
        torch.cuda.empty_cache()


def dlrm_sharded_lookup(params, cfg):
    """``make_sharded_lookup`` on a one-rank NCCL group ((1, 1) mesh) over
    the cut table: equal to ``embedding_lookup`` exactly, inside the serve
    step too; p50 ms of both lookups at serve_bulk's batch."""
    import socket

    import torch.distributed as dist

    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch import train
    from repro_torch.models import embedding, recsys
    dev = torch.device("cuda", torch.cuda.current_device())
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0, device_id=dev)
    try:
        dm = mesh_mod.device_mesh(mesh_mod.Mesh(("data", "model"), (1, 1)))
        lookup = embedding.make_sharded_lookup(dm, cfg.padded_total_vocab,
                                               cfg.embed_dim)
        batch = train.recsys_batch("dlrm", cfg, 262_144, BUNDLE_SEED, 1,
                                   dev)
        offs = torch.as_tensor(recsys.dlrm.offsets(cfg), device=dev)
        idx = batch["sparse"] + offs[None, :]
        sh_ms, got = p50_ms(lambda: lookup(params["table"], idx))
        pl_ms, want = p50_ms(lambda: embedding.embedding_lookup(
            params["table"], idx))
        serve_sh = steps_mod.recsys_serve_fn("dlrm", cfg, lookup)(params,
                                                                  batch)
        serve = steps_mod.recsys_serve_fn("dlrm", cfg)(params, batch)
        if not (torch.equal(got, want) and torch.equal(serve_sh, serve)):
            raise AssertionError("phase 3o: make_sharded_lookup is not the "
                                 "plain lookup")
        log(f"  dlrm make_sharded_lookup (one-rank NCCL group, (1, 1) "
            f"mesh, batch 262,144 x 26 ids): equal to embedding_lookup and "
            f"its serve step to the plain one; p50 {sh_ms:.3f} ms vs plain "
            f"{pl_ms:.3f} ms")
    finally:
        dist.destroy_process_group()


def phase_bundles(K, testing):
    """Phase 3o: every serving and search kind of ``build_bundle`` on the
    card. Returns (kernel-table rows, launches to add to phase 3i's
    rows, each cell's :class:`Measured` step for phase 3p)."""
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"phase 3o: step bundles on {card_line()}; "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated at the "
        "start")
    gen = torch.Generator(device="cuda").manual_seed(BUNDLE_SEED)
    rows, extra, measured = [], {}, []
    for shape_name in ("search_oi13m", "search_oi13m_sorted",
                       "search_rqa10m", "search_t2i10m"):
        launches, row = vs_search_cell(K, testing, shape_name, gen, measured)
        if row is None:
            layout = "sorted" if shape_name.endswith("sorted") else "gathered"
            extra[f"gleanvec_sq_topk[oi13m {layout}]"] = launches
        else:
            rows.append(row)
    rows.append(vs_learn_cell(K, testing, gen, measured))
    rows.append(lm_bundle_cells(K, testing, measured))
    recsys_bundle_cells(measured)
    log("  " + profiler_empty_sessions())
    log(f"  phase 3o: {time.perf_counter() - t_phase:.0f} s on "
        f"{card_line()}")
    return rows, extra, measured


# ---------------------------------------------------------------------------
# Phase 3p: the dry run and the H100 roofline against phase 3o's steps.
# ---------------------------------------------------------------------------


class Measured(NamedTuple):
    """One phase 3o step as phase 3p reads it: ``args`` as ``meta``
    tensors of the shapes 3o allocated, ``arg_bytes`` the bytes of their
    storages on the card, ``ms`` the step's median, ``peak_gb`` the peak
    above its data."""
    label: str
    fn: Any
    args: Any
    arg_bytes: int
    model_flops: float
    ms: float
    peak_gb: float


def measured_step(label, fn, args, model_flops, ms, peak) -> Measured:
    """A :class:`Measured` of a step run on ``args`` (no reference to them
    is kept: 3o frees each cell's data)."""
    from torch.utils._pytree import tree_leaves, tree_map
    stores = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
              for t in tree_leaves(args) if isinstance(t, torch.Tensor)}
    meta = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device="meta")
                    if isinstance(t, torch.Tensor) else t, args)
    return Measured(label, fn, meta, sum(stores.values()), model_flops, ms,
                    peak)


def dryrun_of_measured(m: Measured):
    """The dry run's record of ``m``'s step on one device at its shapes."""
    from repro_torch.launch import dryrun, steps
    from repro_torch.launch.mesh import Mesh
    one = Mesh(("data",), (1,))
    trace = dryrun.trace_step(m.fn, m.args, device="cuda")
    bundle = steps.StepBundle(name=m.label, fn=m.fn, args=m.args, config=None,
                              device=torch.device("cuda"),
                              model_flops=m.model_flops)
    return dryrun.record_of("3o", m.label, "one", bundle, one, trace,
                            "traced")


def tflops_by_dtype(rec) -> dict:
    return {k: round(v / 1e12, 4)
            for k, v in rec["cost"]["flops_by_dtype"].items()}


def example_runs(names, timeout: int = 300) -> dict:
    """``examples/torch_<name>.py`` at its defaults on the card, each in a
    process of its own, all started together: {name: (rc, wall s from
    the start to its exit, its recall@10 / agreement / QPS lines)}."""
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen(
        [sys.executable, str(ROOT / "examples" / f"torch_{name}.py")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
        for name in names}
    out = {}
    try:
        for name, proc in procs.items():
            stdout, stderr = proc.communicate(
                timeout=max(1.0, timeout - (time.perf_counter() - t0)))
            keep = [ln.strip() for ln in stdout.splitlines()
                    if "recall@10" in ln or "agreement" in ln or "QPS" in ln]
            if proc.returncode != 0:
                log(stdout[-2000:] + stderr[-3000:])
            out[name] = (proc.returncode, time.perf_counter() - t0, keep)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return out


def phase_dryrun(measured) -> None:
    """Phase 3p: (a) the dry run of every step phase 3o measured, at 3o's
    shapes on one device, beside 3o's ms and peak; fails if a step ran
    faster than DRYRUN_BOUND_SLACK x its predicted bound (the count is
    wrong) or if the dry run's argument bytes are not those 3o allocated.
    (b) One full-size cell a family on both production meshes (the fake
    process group of 256 / 512 ranks on this torch), each trace's
    seconds. (c) The four examples at their defaults on the card, in
    processes of their own started together."""
    from repro_torch.launch import dryrun
    from repro_torch.utils import roofline
    t_phase = time.perf_counter()
    props = torch.cuda.get_device_properties(0)
    h = roofline.H100
    log(f"phase 3p: the dry run and the H100 roofline on {card_line()}; "
        f"spec sheet (roofline.H100): {h.hbm_bytes / 1e9:.0f} GB HBM at "
        f"{h.hbm_bw / 1e12:.2f} TB/s, {h.n_sms} SMs, {h.peak_flops / 1e12:.1f}"
        f" / {h.peak_flops_f32 / 1e12:.1f} TFLOP/s bf16 / f32; this card: "
        f"{props.total_memory / 1e9:.1f} GB, {props.multi_processor_count} "
        f"SMs ({props.name})")
    log("  (a) phase 3o's steps: predicted (dry run, spec-sheet H100) "
        "beside measured")
    for m in measured:
        rec = dryrun_of_measured(m)
        rf, mem = rec["roofline"], rec["memory"]
        bound_ms = rf["bound_s"] * 1e3
        above = (mem["temp_bytes"] + mem["output_bytes"]
                 - mem["alias_bytes"]) / 1e9
        log(f"    {m.label}: measured {m.ms:.3f} ms, predicted bound "
            f"{bound_ms:.3f} ms ({rf['bottleneck']}; compute "
            f"{rf['compute_s'] * 1e3:.3f} / memory {rf['memory_s'] * 1e3:.3f}"
            f" ms; {rec['cost']['flops'] / 1e12:.4f} TFLOP "
            f"{tflops_by_dtype(rec)}"
            f", {rec['cost']['bytes_written'] / 1e9:.3f} GB written), "
            f"measured / bound {m.ms / max(bound_ms, 1e-9):.2f}; peak above "
            f"the data measured {m.peak_gb:.3f} GB, predicted {above:.3f} GB;"
            f" argument bytes {mem['argument_bytes']:,} (allocated "
            f"{m.arg_bytes:,}); traced in {rec['trace_s']:.2f} s, "
            f"{rec['ops']} ops")
        if m.ms < DRYRUN_BOUND_SLACK * bound_ms:
            raise AssertionError(f"phase 3p {m.label}: measured {m.ms:.3f} "
                                 f"ms < {DRYRUN_BOUND_SLACK} x the predicted "
                                 f"bound {bound_ms:.3f} ms")
        if mem["argument_bytes"] != m.arg_bytes:
            raise AssertionError(f"phase 3p {m.label}: argument bytes "
                                 f"{mem['argument_bytes']} != allocated "
                                 f"{m.arg_bytes}")
    log("  (b) full-size cells on the production meshes (fake process "
        "group)")
    for arch, shape in DRYRUN_CELLS:
        for mk in ("single", "multi"):
            rec = dryrun.run_cell(arch, shape, mk, device="cuda")
            rf, mem = rec["roofline"], rec["memory"]
            log(f"    {arch}:{shape}:{mk} split={rec['split']} "
                f"trace_s={rec['trace_s']:.2f} peak/dev="
                f"{mem['peak_bytes'] / 1e9:.2f} GB (args "
                f"{mem['argument_bytes'] / 1e9:.2f}) bound "
                f"{rf['bound_s'] * 1e3:.3f} ms ({rf['bottleneck']}; compute "
                f"{rf['compute_s'] * 1e3:.3f} / memory "
                f"{rf['memory_s'] * 1e3:.3f} / collective "
                f"{rf['collective_s'] * 1e3:.3f} ms; "
                f"{rec['collectives']['count']} collectives, "
                f"{rec['collectives']['bytes'] / 1e6:.2f} MB)")
            if not rec["ok"] or rf["bound_s"] <= 0:
                raise AssertionError(f"phase 3p {arch}:{shape}:{mk}")
    log("  (c) the examples at their defaults on the card, the four at "
        "once")
    runs = example_runs(("quickstart", "serve_vector_search",
                         "streaming_updates", "train_recsys_retrieval"))
    for name, (rc, wall, lines) in runs.items():
        log(f"    examples/torch_{name}.py: rc={rc} wall={wall:.1f} s; "
            + " | ".join(lines))
        if rc != 0 or not lines:
            raise AssertionError(f"phase 3p: examples/torch_{name}.py "
                                 f"failed (rc {rc})")
    log(f"  phase 3p: {time.perf_counter() - t_phase:.0f} s on "
        f"{card_line()}")


# ---------------------------------------------------------------------------
# Phase 4: each kernel at the main path's shapes.
# ---------------------------------------------------------------------------


def topk_of_candidates(cand_v, cand_i, k):
    """The k best of per-group candidate lists (M, G, k'): one torch.topk."""
    m = cand_v.shape[0]
    v, sel = torch.topk(cand_v.reshape(m, -1), k, dim=1)
    return v, torch.gather(cand_i.reshape(m, -1), 1, sel)


def per_cluster_library(qs, qlo, tags, x, k, row_ids, layout_block):
    """The library composition of a GleanVec scan (``library_ms``): per
    cluster, ``torch.matmul`` of the queries' cluster view against the
    cluster's rows plus ``q_lo``, masked, then ``torch.topk``, then one
    ``torch.topk`` over the per-cluster candidates. Sorted layout: each
    cluster is a contiguous run of blocks; gathered layout: the rows are
    grouped by tag here, inside the timed call."""
    m, c, _ = qs.shape
    cand_v = torch.full((m, c, k), -3.4e38, device=qs.device)
    cand_i = torch.full((m, c, k), -1, dtype=torch.int64, device=qs.device)
    if layout_block > 0:
        counts = torch.bincount(tags.long(), minlength=c) * layout_block
        ends = torch.cumsum(counts, 0).tolist()
        groups = [(int(e - n), int(e)) for e, n in zip(ends, counts.tolist())]
    else:
        order = torch.argsort(tags.long(), stable=True)
        groups = torch.split(order, torch.bincount(tags.long(),
                                                   minlength=c).tolist())
    for ci, g in enumerate(groups):
        if layout_block > 0:
            rows = x[g[0]:g[1]].to(torch.float32)
            ids = row_ids[g[0]:g[1]].long()
        else:
            rows = x[g].to(torch.float32)
            ids = g
        if rows.shape[0] == 0:
            continue
        sc = qs[:, ci] @ rows.T + qlo[:, ci:ci + 1]
        if layout_block > 0:
            sc = sc.masked_fill(ids[None, :] < 0, -3.4e38)
        kk = min(k, rows.shape[0])
        v, sel = torch.topk(sc, kk, dim=1)
        cand_v[:, ci, :kk] = v
        cand_i[:, ci, :kk] = ids[sel]
    return topk_of_candidates(cand_v, cand_i, k)


def ivf_library(qs, qlo, scorer, probe, k):
    """The library composition of the IVF fine step: per probed cluster,
    ``torch.matmul`` of the queries that probe it against the cluster's
    rows plus ``q_lo``, masked, then ``torch.topk``; then one
    ``torch.topk`` over each query's nprobe candidate lists."""
    m, nprobe = probe.shape
    lb = scorer.layout_block
    rows_all = scorer.x_low if hasattr(scorer, "x_low") else scorer.codes
    cand_v = torch.full((m, nprobe, k), -3.4e38, device=qs.device)
    cand_i = torch.full((m, nprobe, k), -1, dtype=torch.int64,
                        device=qs.device)
    counts = torch.bincount(scorer.block_tags.long(),
                            minlength=qs.shape[1]) * lb
    ends = torch.cumsum(counts, 0).tolist()
    for ci, (end, cnt) in enumerate(zip(ends, counts.tolist())):
        qm, slot = torch.nonzero(probe == ci, as_tuple=True)
        if qm.numel() == 0 or cnt == 0:
            continue
        r0 = end - cnt
        rows = rows_all[r0:end].to(torch.float32)
        ids = scorer.perm[r0:end].long()
        sc = qs[qm, ci] @ rows.T + qlo[qm, ci][:, None]
        sc = sc.masked_fill(ids[None, :] < 0, -3.4e38)
        kk = min(k, cnt)
        v, sel = torch.topk(sc, kk, dim=1)
        cand_v[qm, slot, :kk] = v
        cand_i[qm, slot, :kk] = ids[sel]
    return topk_of_candidates(cand_v, cand_i, k)


def mode_calls(K, mode, scorer, qstate, kappa):
    """(kernel call, plain call, flops, bytes, tolerance, library call) of
    the scan a mode's FlatIndex runs, on its own inputs. The library call
    is ``torch.matmul`` + ``torch.topk`` for the linear modes and the
    per-cluster composition of :func:`per_cluster_library` for the
    GleanVec family (its dense (M * C, N) scores would take 393 GB)."""
    from repro_torch import testing
    if mode in ("full", "sphering", "sphering-int8"):
        q = qstate if mode != "sphering-int8" else qstate.q_scaled
        x = scorer.x_low if mode != "sphering-int8" else scorer.codes
        m, d = q.shape
        n = x.shape[0]
        flops = 2.0 * m * n * d
        nbytes = q.numel() * 4 + x.numel() * x.element_size() + m * kappa * 8
        tol = testing.dot_tol(row_norm_max(q), row_norm_max(x), d)

        def library():
            return torch.topk(q @ x.to(torch.float32).T, kappa, dim=1)
        return (lambda: K.ip_topk(q, x, kappa),
                lambda: K.ip_topk_plain(q, x, kappa), flops, nbytes, tol,
                library)
    if mode.endswith("int8") or mode.endswith("int8-sorted"):
        qs, qlo, x = qstate.q_scaled, qstate.q_lo, scorer.codes
    else:
        qs, x = qstate, scorer.x_low
        qlo = torch.zeros(qs.shape[:2], dtype=torch.float32, device=qs.device)
    m, c, d = qs.shape
    if mode.endswith("sorted"):
        tags, rid, lb = scorer.block_tags, scorer.perm, scorer.layout_block
        n = int((rid >= 0).sum())
        extra = tags.numel() * 4 + n * 4
    else:
        tags, rid, lb = scorer.tags, None, 0
        n = x.shape[0]
        extra = n * 4
    flops = 2.0 * m * n * d
    nbytes = (qs.numel() + qlo.numel()) * 4 + n * d * x.element_size() \
        + extra + m * kappa * 8
    tol = testing.dot_tol(row_norm_max(qs), row_norm_max(x), d,
                          float(qlo.abs().max()))
    return (lambda: K.gleanvec_sq_topk(qs, qlo, tags, x, kappa, row_ids=rid,
                                       layout_block=lb),
            lambda: K.gleanvec_sq_topk_plain(qs, qlo, tags, x, kappa,
                                             row_ids=rid, layout_block=lb),
            flops, nbytes, tol,
            lambda: per_cluster_library(qs, qlo, tags, x, kappa, rid, lb))


def ivf_args(scorer, qstate, probe, kappa):
    """The arguments of ``ivf_scan_topk`` for a sorted scorer's prepared
    queries and their probed clusters: (q_scaled, q_lo, block_tags, perm,
    rows, sched, kappa, layout_block)."""
    if isinstance(qstate, tuple):
        qs, qlo, x = qstate.q_scaled, qstate.q_lo, scorer.codes
    else:
        qs, x = qstate, scorer.x_low
        qlo = torch.zeros(qs.shape[:2], dtype=torch.float32, device=qs.device)
    sched = scorer.list_block_ranges[probe].reshape(qs.shape[0], -1)
    return (qs, qlo, scorer.block_tags, scorer.perm, x, sched, kappa,
            scorer.layout_block)


def ivf_calls(K, testing, scorer, qstate, probe, kappa):
    """(kernel call, plain call, flops, bytes, tolerance, library call) of
    the IVF fine step on the IVF phase's inputs (the work:
    :func:`ivf_work`)."""
    args = ivf_args(scorer, qstate, probe, kappa)
    qs, qlo, x = args[0], args[1], args[4]
    flops, nbytes = ivf_work(*args)
    tol = testing.dot_tol(row_norm_max(qs), row_norm_max(x), qs.shape[2],
                          float(qlo.abs().max()))
    return (lambda: K.ivf_scan_topk(*args),
            lambda: K.ivf_scan_topk_plain(*args), flops, nbytes, tol,
            lambda: ivf_library(qs, qlo, scorer, probe, kappa))


def ivf_work(qs, qlo, btags, rid, x, sched, kappa, lb):
    """(flops, bytes) the IVF fine step needs on this schedule: flops count
    the valid rows of each query's scheduled blocks, bytes read each
    scheduled block once."""
    m, _, d = qs.shape
    valid_rows = (rid.reshape(-1, lb) >= 0).sum(dim=1)
    ok = sched >= 0
    pairs = int(valid_rows[sched.clamp(min=0).long()][ok].sum())
    blocks = torch.unique(sched[ok]).numel()
    return 2.0 * pairs * d, (qs.numel() + qlo.numel() + sched.numel()) * 4 \
        + blocks * (lb * (d * x.element_size() + 4) + 4) + m * kappa * 8


def device_breakdown(fn, reps: int = 3) -> str:
    """Device time per call of each CUDA kernel ``fn`` launches, from
    ``torch.profiler`` (``key_averages``), with the launches it recorded in
    ``reps`` calls; "not measured" when the profiler records no device time
    on this machine."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
    except RuntimeError as e:          # no CUPTI tracing here
        return f"not measured ({e})"
    parts = []
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = getattr(ev, "cuda_time_total", 0)
        if us > 0:
            parts.append((us / reps / 1e3, ev.key, ev.count))
    if not parts:
        return "not measured (no device time recorded)"
    parts.sort(reverse=True)
    return "; ".join(f"{key[:60]}={ms:.3f}ms ({n} in {reps} calls)"
                     for ms, key, n in parts)


def ip_topk_split(K, q, x, k) -> str:
    """Where an ip_topk call's device time goes: scan and merge kernels
    (``torch.profiler``), and the fold's share of the scan from the
    kernel's own clock64 profile (thread 0 of each block: the kernel, its
    folds, and the folds' compares + appends, barrier wait, inserts and
    closing vote)."""
    ipk = importlib.import_module("repro_torch.kernels.ip_topk")
    prof = ipk.fold_profile(q, x, min(k, K.PASS_K))
    total = max(prof["kernel"], 1)
    parts = ", ".join(f"{p} {prof[p] / total:.1%}"
                      for p in ipk.FOLD_PARTS[1:])
    return (f"share of the scan's cycles (clock64, thread 0): {parts}; "
            "device time by kernel (torch.profiler): "
            + device_breakdown(lambda: K.ip_topk(q, x, k)))


def ivf_split(K, args) -> str:
    """Where an ivf_scan_topk call's time goes: its device time by kernel
    (``torch.profiler``), its time at k = 1 beside its time at the call's
    k (the fold's share estimated as 1 - t(k = 1) / t(k), public wrappers
    only, so any tree's kernel reads the same way), and, where the kernel
    has one, its own clock64 fold profile (``fold_profile``: thread 0 of
    each block, one pass)."""
    ivs = importlib.import_module("repro_torch.kernels.ivf_scan")
    k = args[6]
    t_k, _ = timed(lambda: K.ivf_scan_topk(*args), 3)
    t_1, _ = timed(lambda: K.ivf_scan_topk(*args[:6], 1, args[7]), 3)
    out = (f"at k = {k} {t_k:.3f} ms, at k = 1 (the least fold) {t_1:.3f} "
           f"ms: fold share ~{1 - t_1 / t_k:.1%}")
    if hasattr(ivs, "fold_profile"):
        prof = ivs.fold_profile(*args[:6], min(k, K.PASS_K), args[7])
        total = max(prof["kernel"], 1)
        out += "; share of the scan's cycles (clock64, thread 0): " + \
            ", ".join(f"{p} {prof[p] / total:.1%}"
                      for p in ivs.FOLD_PARTS[1:])
    return out + "; device time by kernel (torch.profiler): " + \
        device_breakdown(lambda: K.ivf_scan_topk(*args))


def digest(*tensors) -> str:
    """A SHA-256 prefix of the tensors' bytes: equal digests in two runs
    mean bit-identical results. The bytes go through a uint8 view, so any
    type (bf16 too, which numpy lacks) hashes as its raw bytes."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().reshape(-1).view(torch.uint8)
                 .numpy().tobytes())
    return h.hexdigest()[:16]


def device_digest(t: torch.Tensor) -> str:
    """A checksum of a tensor's 32-bit words computed on the card, for
    outputs of gigabytes: the int64 sum of the words and of each word times
    its position mod 65521. Equal in two runs: the bits agree but for a
    vanishing chance."""
    w = t.contiguous().view(torch.int32).reshape(-1)
    s1 = s2 = 0
    step = 1 << 26
    for a in range(0, w.numel(), step):
        c = w[a:a + step].to(torch.int64)
        pos = torch.arange(a, a + c.numel(), device=w.device) % 65521
        s1 += int(c.sum())
        s2 += int((c * pos).sum())
    return f"{s1 & 0xffffffffffff:012x}{s2 & 0xffffffffffff:012x}"


def time_kernel(name, label, calls, launches, testing, reps: int = 3):
    """Time one kernel call (mean of ``reps``) beside its plain version and
    library composition (``None``: none that fits on the card, and
    ``library_ms`` null); returns its row of the kernel table."""
    kern, plain, flops, nbytes, tol, library = calls
    ms, out_k = timed(kern, reps)
    plain_ms, out_p = timed_once(plain)
    rep = check_topk(f"{name}[{label}] vs plain", out_k, out_p, tol, testing)
    b, by = bound_ms(flops, nbytes)
    lib_ms = None
    if library is not None:             # None: no one call fits the card
        lib_ms, out_l = timed(library, 2)
        check_topk(f"{name}[{label}] library composition vs kernel", out_l,
                   out_k, tol, testing)
        del out_l
    lib = "null" if lib_ms is None else f"{lib_ms:.3f}"
    log(f"  {name}[{label}]: ms={ms:.3f} plain_ms={plain_ms:.3f} "
        f"bound_ms={b:.3f} ({by}) library_ms={lib} launches={launches}")
    src, repl = KERNEL_FILES[name]
    return {"name": f"{name}[{label}]", "route": "cuda", "source": src,
            "replaces": repl, "launches": launches,
            "max_abs_err": rep["max_abs_err"], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
            "library_ms": lib_ms}


def per_cluster_dense_library(qs, qlo, tags, x, layout_block):
    """The library composition of dense GleanVec scores: per cluster,
    ``torch.matmul`` of the queries' view against the cluster's rows (plus
    ``q_lo``), scattered into the cluster's columns. Sorted layout: each
    cluster is a contiguous run of blocks; gathered: the rows are grouped
    by tag here, inside the timed call."""
    m, c, _ = qs.shape
    n = x.shape[0]
    out = torch.empty((m, n), dtype=torch.float32, device=qs.device)
    if layout_block > 0:
        counts = (torch.bincount(tags.long(), minlength=c)
                  * layout_block).tolist()
        ends = np.cumsum(counts).tolist()
        for ci, (end, cnt) in enumerate(zip(ends, counts)):
            if cnt:
                out[:, end - cnt:end] = qs[:, ci] @ x[end - cnt:end].to(
                    torch.float32).T + qlo[:, ci:ci + 1]
        return out
    order = torch.argsort(tags.long(), stable=True)
    groups = torch.split(order, torch.bincount(tags.long(),
                                               minlength=c).tolist())
    for ci, g in enumerate(groups):
        if g.numel():
            out[:, g] = qs[:, ci] @ x[g].to(torch.float32).T \
                + qlo[:, ci:ci + 1]
    return out


def time_dense(name, label, kern, plain, library, flops, nbytes, tol,
               launches):
    """Time one dense kernel beside its plain version and its library
    call, each checked against the kernel; returns its table row."""
    ms, out_k = timed(kern, 3)
    log(f"  {name}[{label}] output digest {device_digest(out_k)}")
    plain_ms, out_p = timed_once(plain)
    err = check_dense(f"{name}[{label}] vs plain", out_k, out_p, tol)
    del out_p
    lib_ms, out_l = timed(library, 2)
    check_dense(f"{name}[{label}] library vs kernel", out_l, out_k, tol)
    del out_l, out_k
    b, by = bound_ms(flops, nbytes)
    log(f"  {name}[{label}]: ms={ms:.3f} plain_ms={plain_ms:.3f} "
        f"bound_ms={b:.3f} ({by}) library_ms={lib_ms:.3f} "
        f"launches={launches}")
    src, repl = KERNEL_FILES[name]
    return {"name": f"{name}[{label}]", "route": "cuda", "source": src,
            "replaces": repl, "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
            "library_ms": lib_ms}


def stream_timing(K, testing, finals, totals, runs, queries):
    """The three dense kernels at the stream's shapes: M = 1024 queries
    against each final stream store (capacity or sorted rows, d = 160);
    and the sorted gleanvec_sq_topk on the final sorted stores (layout
    block 256), its launches those of the stream's sorted runs (flat and
    IVF: the fused scan of each cycle's dense check)."""
    table = []
    s = finals[("flat", "sphering-int8")]
    qst = s.prepare_queries(queries)
    q, lo_v, codes = qst.q_scaled, qst.q_lo, s.codes
    m, d = q.shape
    n = codes.shape[0]
    tol = testing.dot_tol(row_norm_max(q), row_norm_max(codes), d,
                          float(lo_v.abs().max()))
    table.append(time_dense(
        "sq_dot", "sphering-int8", lambda: K.sq_dot_folded(q, lo_v, codes),
        lambda: K.sq_dot_folded_plain(q, lo_v, codes),
        lambda: q @ codes.to(torch.float32).T + lo_v[:, None],
        2.0 * m * n * d, (q.numel() + m + m * n) * 4 + codes.numel(), tol,
        totals["sq_dot"]))
    log("  sq_dot[sphering-int8] device time by kernel (torch.profiler): "
        + device_breakdown(lambda: K.sq_dot_folded(q, lo_v, codes)))
    del q, lo_v, qst
    for mode in ("gleanvec-sorted", "gleanvec-int8-sorted"):
        s = finals[("flat", mode)]
        calls = mode_calls(K, mode, s, s.prepare_queries(queries), 100)
        label = f"{mode} stream L={s.layout_block}"
        table.append(time_kernel(
            "gleanvec_sq_topk", label, calls,
            sum(runs[(index, mode)]["gleanvec_sq_topk"]
                for index in ("flat", "ivf")), testing))
        log(f"  gleanvec_sq_topk[{label}] device time by kernel "
            "(torch.profiler): " + device_breakdown(calls[0]))
        del calls
    s = finals[("flat", "gleanvec")]
    qv = s.prepare_queries(queries)
    m, c, d = qv.shape
    n = s.x_low.shape[0]
    zeros = torch.zeros((m, c), dtype=torch.float32, device=qv.device)
    tol = testing.dot_tol(row_norm_max(qv), row_norm_max(s.x_low), d)
    table.append(time_dense(
        "gleanvec_ip", "gleanvec", lambda: K.gleanvec_ip(qv, s.tags, s.x_low),
        lambda: K.gleanvec_ip_plain(qv, s.tags, s.x_low),
        lambda: per_cluster_dense_library(qv, zeros, s.tags, s.x_low, 0),
        2.0 * m * n * d, (qv.numel() + m * n + n * d + n) * 4, tol,
        totals["gleanvec_ip"]))
    table.append(time_dense(
        "gleanvec_sq", "gathered f32",
        lambda: K.gleanvec_sq(qv, zeros, s.tags, s.x_low),
        lambda: K.gleanvec_sq_plain(qv, zeros, s.tags, s.x_low),
        lambda: per_cluster_dense_library(qv, zeros, s.tags, s.x_low, 0),
        2.0 * m * n * d, (qv.numel() + zeros.numel() + m * n + n * d + n) * 4,
        tol, totals["gleanvec_sq"]))
    del qv, zeros
    for label, key in (("gathered u8", ("flat", "gleanvec-int8")),
                       ("sorted f32", ("flat", "gleanvec-sorted")),
                       ("sorted u8", ("flat", "gleanvec-int8-sorted"))):
        s = finals[key]
        qst = s.prepare_queries(queries)
        if isinstance(qst, tuple):
            qs, qlo = qst.q_scaled, qst.q_lo
        else:
            qs = qst
            qlo = torch.zeros(qs.shape[:2], dtype=torch.float32,
                              device=qs.device)
        x = s.codes if hasattr(s, "codes") else s.x_low
        tags = s.block_tags if hasattr(s, "block_tags") else s.tags
        lb = s.layout_block if hasattr(s, "block_tags") else 0
        m, c, d = qs.shape
        n = x.shape[0]
        tol = testing.dot_tol(row_norm_max(qs), row_norm_max(x), d,
                              float(qlo.abs().max()))
        table.append(time_dense(
            "gleanvec_sq", label,
            lambda: K.gleanvec_sq(qs, qlo, tags, x, layout_block=lb),
            lambda: K.gleanvec_sq_plain(qs, qlo, tags, x, layout_block=lb),
            lambda: per_cluster_dense_library(qs, qlo, tags, x, lb),
            2.0 * m * n * d, (qs.numel() + qlo.numel() + m * n
                              + tags.numel()) * 4
            + n * d * x.element_size(), tol, totals["gleanvec_sq"]))
        if lb == 0:
            log(f"  gleanvec_sq[{label}] device time by kernel "
                "(torch.profiler): " + device_breakdown(
                    lambda: K.gleanvec_sq(qs, qlo, tags, x), reps=2))
        del qs, qlo, qst
    return table


def hop_library(qs, qlo, btags, rid, codes, nbr, bv, bi, lb):
    """The library composition of one hop (``library_ms``): the port's
    gathered hop as composed torch calls -- sort the neighbor rows and mark
    repeats, gather rows and views, multiply and sum, mask, then ``cat``
    and ``torch.topk``."""
    n = codes.shape[0]
    m = nbr.shape[0]
    rows = torch.sort(torch.where((nbr >= 0) & (nbr < n), nbr,
                                  torch.full_like(nbr, n)), dim=1).values
    valid = rows < n
    dup = torch.cat([torch.zeros_like(valid[:, :1]),
                     rows[:, 1:] == rows[:, :-1]], dim=1)
    safe = torch.where(valid, rows, torch.zeros_like(rows)).long()
    tag = btags[safe // lb].long()
    sc = torch.sum(qs[torch.arange(m, device=qs.device)[:, None], tag]
                   * codes[safe].to(torch.float32), dim=-1) \
        + torch.gather(qlo, 1, tag)
    ids = rid[safe]
    ok = valid & ~dup & (ids >= 0) \
        & ~(ids[:, :, None] == bi[:, None, :]).any(dim=2)
    sc = torch.where(ok, sc, torch.full_like(sc, -3.4e38))
    ids = torch.where(ok, ids, torch.full_like(ids, -1))
    v, sel = torch.topk(torch.cat([bv, sc], dim=1), bv.shape[1], dim=1)
    return v, torch.gather(torch.cat([bi, ids], dim=1), 1, sel)


def hop_work(qs, qlo, btags, rid, codes, nbr, bv, bi, lb):
    """(flops, bytes) one hop needs on these inputs: per query its distinct
    valid neighbor rows (4 bytes of id and 4 of block tag each), the codes
    of those it scores (live, not in the beam; 2 d flops each), the view
    row of each distinct (query, tag) among them, the neighbor rows, and
    the beam read and written."""
    n = codes.shape[0]
    m, c, d = qs.shape
    rows = torch.sort(torch.where((nbr >= 0) & (nbr < n), nbr,
                                  torch.full_like(nbr, n)), dim=1).values
    valid = rows < n
    first = valid & torch.cat([torch.ones_like(valid[:, :1]),
                               rows[:, 1:] != rows[:, :-1]], dim=1)
    safe = torch.where(valid, rows, torch.zeros_like(rows)).long()
    ids = rid[safe]
    scored = first & (ids >= 0) & ~(ids[:, :, None] == bi[:, None, :]).any(2)
    pairs = (torch.arange(m, device=qs.device)[:, None] * c
             + btags[safe // lb].long())[scored]
    n_scored = int(scored.sum())
    nbytes = int(first.sum()) * 8 + n_scored * d * codes.element_size() \
        + torch.unique(pairs).numel() * (d + 1) * 4 + nbr.numel() * 4 \
        + 2 * bv.numel() * 8
    return 2.0 * d * n_scored, float(nbytes)


def search_work(hops):
    """(flops, bytes) a whole traversal needs on the inputs of its hops
    (the per-hop loop's, :func:`capture_hops`): at each hop, for the
    queries still searching, the neighbor rows read from the table (4 bytes
    each), each distinct valid row's id and block tag (8 bytes), and the
    codes of the rows it scores (live, not in the beam; 2 d flops each);
    over the search, the view row (d + 1 floats) of each distinct (query,
    tag) it scores once, the entry beam read and the final beam and hop
    counts written once."""
    flops = nbytes = 0.0
    pairs = []
    for hop in hops:
        (qs, qlo, btags, rid, codes, nbr, bv, bi), lb = hop_args(hop)
        act = (nbr >= 0).any(dim=1)
        nbr, bi = nbr[act], bi[act]
        n = codes.shape[0]
        m, c, d = qs.shape
        rows = torch.sort(torch.where((nbr >= 0) & (nbr < n), nbr,
                                      torch.full_like(nbr, n)), dim=1).values
        valid = rows < n
        first = valid & torch.cat([torch.ones_like(valid[:, :1]),
                                   rows[:, 1:] != rows[:, :-1]], dim=1)
        safe = torch.where(valid, rows, torch.zeros_like(rows)).long()
        ids = rid[safe]
        scored = first & (ids >= 0) \
            & ~(ids[:, :, None] == bi[:, None, :]).any(2)
        q_idx = torch.nonzero(act).squeeze(1)
        pairs.append((q_idx[:, None] * c + btags[safe // lb].long())[scored])
        n_scored = int(scored.sum())
        flops += 2.0 * d * n_scored
        nbytes += nbr.numel() * 4 + int(first.sum()) * 8 \
            + n_scored * d * codes.element_size()
    (qs, _, _, _, _, _, bv, _), _ = hop_args(hops[0])
    d = qs.shape[2]
    nbytes += torch.unique(torch.cat(pairs)).numel() * (d + 1) * 4 \
        + 2 * bv.numel() * 8 + bv.shape[0] * 4
    return flops, float(nbytes)


def search_split(K, args, kw, hops) -> str:
    """graph_beam_search's own ``clock64`` profile
    (``graph_scan.search_profile``): each part's share of the kernel's
    cycles and its cycles a hop a block."""
    from repro_torch.kernels.graph_scan import search_profile
    prof = search_profile(*args, **kw)
    total = max(prof["kernel"], 1)
    per_hop = max(int(hops.sum()), 1)
    return ("share of the kernel's cycles (clock64, thread 0): " + ", ".join(
        f"{part} {cyc / total:.1%} ({cyc / per_hop:.0f} a hop)"
        for part, cyc in prof.items() if part != "kernel")
        + f"; {total / per_hop:.0f} cycles a hop a block")


def graph_timing(K, testing, x, hops, totals, per_batch, searches):
    """``graph_scan_beam_step`` on the captured hops (expand 1 and 4, u8
    and f32), ``graph_beam_search`` on each fused mode's batch, and
    ``ip_topk`` at the graph build's self-join shape. ``totals`` are the
    main path's launches: the per-hop kernel's are 0, since a fused graph
    serves through ``graph_beam_search`` and only the checks hop."""
    from repro_torch.index import graph
    table = []
    for (mode, expand), hop in hops.items():
        args, lb = hop_args(hop)
        qs, qlo, codes = args[0], args[1], args[4]
        flops, nbytes = hop_work(*args, lb)
        tol = testing.dot_tol(row_norm_max(qs), row_norm_max(codes),
                              qs.shape[2], float(qlo.abs().max()))
        label = (f"{'u8' if codes.dtype == torch.uint8 else 'f32'} "
                 f"expand={expand} S={args[5].shape[1]}")
        table.append(time_kernel(
            "graph_scan_beam_step", label,
            (lambda: K.graph_scan_beam_step(*args, layout_block=lb),
             lambda: K.graph_scan_beam_step_plain(*args, layout_block=lb),
             flops, nbytes, tol, lambda: hop_library(*args, lb)),
            totals["graph_scan_beam_step"], testing, reps=50))
    for mode, (args, lb, work, qstate, scorer, gathered) in searches.items():
        qs, qlo, codes = args[0], args[1], args[4]
        tol = testing.dot_tol(row_norm_max(qs), row_norm_max(codes),
                              qs.shape[2], float(qlo.abs().max()))
        kw = dict(layout_block=lb, max_hops=GRAPH_HOPS, expand=GRAPH_EXPAND)
        ms, out_k = timed(lambda: K.graph_beam_search(*args, **kw), 20)
        plain_ms, out_p = timed_once(
            lambda: K.graph_beam_search_plain(*args, **kw))
        lib_ms, out_l = timed(lambda: graph._beam_qstate(
            qstate, scorer, gathered, GRAPH_BEAM, GRAPH_BEAM, GRAPH_HOPS,
            expand=GRAPH_EXPAND), 2)
        rep = testing.topk_agreement(out_k[:2], out_p[:2], tol)
        lib = testing.topk_agreement(out_k[:2], out_l[:2], tol)
        b, by = bound_ms(*work)
        pb = per_batch[mode]
        label = (f"graph_beam_search[{mode} expand={GRAPH_EXPAND} "
                 f"B={GRAPH_BEAM}]")
        log(f"  {label}: ms={ms:.3f} plain_ms={plain_ms:.3f} bound_ms="
            f"{b:.4f} ({by}; flops {work[0]:.3e}, bytes {work[1]:.3e}) "
            f"library_ms={lib_ms:.3f} (the gathered torch traversal) "
            f"launches={totals['graph_beam_search']}; hops max "
            f"{int(out_k[2].max())}, per query {int(out_k[2].min())}-"
            f"{int(out_k[2].max())} (mean {float(out_k[2].float().mean()):.1f})"
            f"; vs plain: max_abs_err={rep['max_abs_err']:.3e} "
            f"id_agreement={rep['id_agreement']:.4f} hops equal "
            f"{torch.equal(out_k[2], out_p[2])}; vs gathered: id_agreement="
            f"{lib['id_agreement']:.4f} (on real-valued data the plain "
            f"version sums in torch's order, so near ties may reorder a "
            f"beam and a query's hops; phase 2 holds the two bit for bit "
            f"on integer data at this shape); served path a batch: "
            f"{pb['search']:.0f} launch, {pb['hops']} hops, {pb['syncs']} "
            f"host syncs")
        if min(rep["id_agreement"], lib["id_agreement"]) < GRAPH_MIN_OVERLAP:
            raise AssertionError(f"{label}: beams disagree with the plain "
                                 "version or the gathered traversal")
        log(f"    {label} " + search_split(K, args, kw, out_k[2]))
        src, repl = KERNEL_FILES["graph_beam_search"]
        table.append({"name": label, "route": "cuda", "source": src,
                      "replaces": repl,
                      "launches": totals["graph_beam_search"],
                      "max_abs_err": rep["max_abs_err"], "ms": ms,
                      "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
                      "library_ms": lib_ms})
        del out_k, out_p, out_l
    # the build's self-join batch as _device_knn lays it out: rows [x,
    # -|x|^2 / 2] and queries [q, 1], zero columns up to a multiple of 4
    # (513 -> 516); the bound counts the 513 columns the data needs
    xg = x[:GRAPH_ROWS]
    dx = xg.shape[1]
    width = -(-(dx + 1) // 4) * 4
    xa = torch.zeros((GRAPH_ROWS, width), device=xg.device)
    xa[:, :dx] = xg
    xa[:, dx] = -0.5 * torch.sum(xg * xg, dim=1)
    qa = torch.zeros((1024, width), device=xg.device)
    qa[:, :dx] = xg[:1024]
    qa[:, dx] = 1.0
    m, d = qa.shape[0], dx + 1
    tol = testing.dot_tol(row_norm_max(qa), row_norm_max(xa), d)
    table.append(time_kernel(
        "ip_topk", f"graph self-join d={d} k=49",
        (lambda: K.ip_topk(qa, xa, 49), lambda: K.ip_topk_plain(qa, xa, 49),
         2.0 * m * GRAPH_ROWS * d, (m + GRAPH_ROWS) * d * 4 + m * 49 * 8,
         tol, lambda: torch.topk(qa @ xa.T, 49, dim=1)),
        totals["ip_topk"], testing))
    log("    ip_topk[graph self-join] " + ip_topk_split(K, qa, xa, 49))
    return table


def phase_timing(K, testing, x, glv, states, per_mode, totals, ivf_inputs,
                 ivf_launches, flat_p50):
    from repro_torch.core.spherical_kmeans import normalize_rows
    log("phase 4: kernels at their paths' shapes (CUDA events; bound = "
        "max(flops / 67 TFLOP/s fp32, bytes / 3.35 TB/s); library = "
        "composed PyTorch calls of the same function)")
    table = []
    for mode, (scorer, qstate, kappa) in states.items():
        name = "ip_topk" if mode in ("full", "sphering", "sphering-int8") \
            else "gleanvec_sq_topk"
        table.append(time_kernel(name, mode,
                                 mode_calls(K, mode, scorer, qstate, kappa),
                                 per_mode[mode][name], testing))
        if name == "ip_topk":
            q = qstate if mode != "sphering-int8" else qstate.q_scaled
            xs = scorer.x_low if mode != "sphering-int8" else scorer.codes
            log(f"    ip_topk[{mode}] " + ip_topk_split(K, q, xs, kappa))
        if name == "gleanvec_sq_topk":
            log(f"    flat {mode} batch p50 (phase 3): "
                f"{flat_p50[mode]:.1f} ms; device time by kernel "
                "(torch.profiler): " + device_breakdown(
                    mode_calls(K, mode, scorer, qstate, kappa)[0]))
    tags = states["gleanvec-int8"][0].tags
    c = glv.centers.shape[0]
    bucket_ms, _ = timed(lambda: K.bucket_rows_by_tag(tags, c), 20)
    log(f"  bucket_rows_by_tag (the gathered kernels' first step, N="
        f"{tags.numel()} C={c}): {bucket_ms:.4f} ms; device time by kernel "
        "(torch.profiler): "
        + device_breakdown(lambda: K.bucket_rows_by_tag(tags, c)))
    for mode, (scorer, qstate, probe) in ivf_inputs.items():
        calls = ivf_calls(K, testing, scorer, qstate, probe, 100)
        table.append(time_kernel("ivf_scan_topk", mode, calls,
                                 ivf_launches[mode]["ivf_scan_topk"],
                                 testing))
        log(f"  ivf_scan_topk[{mode}] "
            + ivf_split(K, ivf_args(scorer, qstate, probe, 100)))
    x_unit = normalize_rows(x)
    # the main path's C = 48 (the GleanVec fit's centers), and the paper's
    # largest C = 100 (off the main path: gleanvec.fit(C=100) and
    # ivf.build(n_lists=100) reach it); launches: the kernel's on the main
    # path, which runs C = 48
    for cent in (glv.centers.contiguous(), normalize_rows(x[:100])):
        table.append(kmeans_row(K, testing, f"C={cent.shape[0]}", x_unit,
                                cent, totals["kmeans_assign"]))
    return table


def clocks_during(fn, seconds: float = 1.5) -> str:
    """The SM clock and power draw (``nvidia-smi``, every 100 ms) while
    ``fn`` runs back to back for about ``seconds``: medians."""
    mon = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                            "--format=csv,noheader,nounits", "-lms", "100"],
                           stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
                           text=True)
    try:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            fn()
            torch.cuda.synchronize()
    finally:
        mon.terminate()
        out = mon.communicate(timeout=30)[0]
    rows = [ln.split(",") for ln in out.splitlines() if ln.count(",") == 1]
    if not rows:
        return "clocks not read"
    mhz = sorted(float(r[0]) for r in rows)
    watts = sorted(float(r[1]) for r in rows)
    return (f"sm clock {mhz[len(mhz) // 2]:.0f} MHz, power "
            f"{watts[len(watts) // 2]:.0f} W (median of {len(rows)})")


def kernel_timing(K, gen, only=()):
    """Every kernel (or those named in ``only``) at the main path's shapes
    on random data drawn on the
    card, through the public wrappers only, so that this script times
    another tree's kernels with the same calls (phase 4 times them on the
    main path's own inputs): ip_topk as `full`, sphering, sphering-int8 and
    the graph build's padded self-join; kmeans_assign at C = 48 and 100;
    gleanvec_sq_topk (C = 48, d = 160, kappa = 100, u8 and f32) sorted at
    the flat path's layout block 4096 and the stream's 256, and gathered;
    ivf_scan_topk (nprobe 12, layout blocks 4096 and 256); the dense sq_dot,
    gleanvec_sq (gathered, and sorted at 256) and gleanvec_ip at the
    stream's shape; graph_scan_beam_step (B 128, S 28 and 112); and
    flash_attention at the LM prefill's shape. Each beside its library
    call and its bound, ip_topk with its scan / fold / merge, the GleanVec
    scans and sq_dot with their device time by kernel."""
    from types import SimpleNamespace
    from repro_torch.core.scorer import _list_block_ranges
    dev = torch.device("cuda")

    def want(name):
        return not only or name in only
    log("kernel timing (random data; CUDA events, mean of 3 after two "
        "warm-ups)")

    def report(label, fn, library, flops, nbytes, reps=3):
        ms, _ = timed(fn, reps)
        lib_ms, _ = timed(library, 2)
        b, by = bound_ms(flops, nbytes)
        log(f"  {label}: ms={ms:.3f} library_ms={lib_ms:.3f} "
            f"bound_ms={b:.3f} ({by}) share_of_bound={b / ms:.1%}; "
            f"{clocks_during(fn)}")

    def codes(n, d, u8):
        return (torch.randint(0, 256, (n, d), generator=gen, device=dev,
                              dtype=torch.uint8) if u8 else
                torch.randn(n, d, generator=gen, device=dev))

    def sorted_layout(nb, lb, c, dead):
        """Block tags in tag order and row ids with a share of -1."""
        btags = torch.sort(torch.randint(0, c, (nb,), generator=gen,
                                         device=dev,
                                         dtype=torch.int32)).values
        rid = torch.randperm(nb * lb, generator=gen, device=dev).to(
            torch.int32)
        rid[torch.rand(nb * lb, generator=gen, device=dev) < dead] = -1
        return btags, rid

    m = 1024
    if want("ip_topk"):
        for label, n, d, k, u8 in (("full", N_ROWS, 512, 10, False),
                                   ("sphering", N_ROWS, 160, 100, False),
                                   ("sphering-int8", N_ROWS, 160, 100, True)):
            q = torch.randn(m, d, generator=gen, device=dev)
            x = codes(n, d, u8)
            report(f"ip_topk[{label}]", lambda: K.ip_topk(q, x, k),
                   lambda: torch.topk(q @ x.to(torch.float32).T, k, dim=1),
                   2.0 * m * n * d, (m + n * x.element_size() / 4) * d * 4
                   + m * k * 8)
            log(f"    {ip_topk_split(K, q, x, k)}")
            log(f"    at k = 1 (the least fold): "
                f"{timed(lambda: K.ip_topk(q, x, 1), 3)[0]:.3f} ms")
            del q, x
        xg = torch.randn(GRAPH_ROWS, 512, generator=gen, device=dev)
        xa = torch.zeros((GRAPH_ROWS, 516), device=dev)
        xa[:, :512] = xg
        xa[:, 512] = -0.5 * torch.sum(xg * xg, dim=1)
        qa = torch.zeros((m, 516), device=dev)
        qa[:, :512] = xg[:m]
        qa[:, 512] = 1.0
        del xg
        report("ip_topk[graph self-join d=513 k=49]",
               lambda: K.ip_topk(qa, xa, 49),
               lambda: torch.topk(qa @ xa.T, 49, dim=1),
               2.0 * m * GRAPH_ROWS * 513,
               (m + GRAPH_ROWS) * 513 * 4 + m * 49 * 8)
        log(f"    {ip_topk_split(K, qa, xa, 49)}")
        log(f"    at k = 1 (the least fold): "
            f"{timed(lambda: K.ip_topk(qa, xa, 1), 3)[0]:.3f} ms")
        del qa, xa
    if want("kmeans_assign"):
        x = torch.nn.functional.normalize(
            torch.randn(N_ROWS, 512, generator=gen, device=dev), dim=1)
        for c in (48, 100):
            cent = x[torch.randperm(N_ROWS, generator=gen, device=dev)[:c]]
            report(f"kmeans_assign[C={c}]", lambda: K.kmeans_assign(x, cent),
                   lambda: torch.max(x @ cent.T, dim=1),
                   2.0 * N_ROWS * c * 512, (N_ROWS + c) * 512 * 4 + N_ROWS * 8)
        del x
    c, d, k = 48, 160, 100
    qs = torch.randn(m, c, d, generator=gen, device=dev)
    qlo = torch.randn(m, c, generator=gen, device=dev)
    if want("gleanvec_sq_topk"):
        for lb in (4096, 256):
            nb = -(-N_ROWS // lb)                    # clusters in tag order
            btags, rid = sorted_layout(nb, lb, c, 0.05)
            live = int((rid >= 0).sum())
            for u8 in (False, True):
                x = codes(nb * lb, d, u8)
                label = (f"gleanvec_sq_topk[sorted L={lb} "
                         f"{'u8' if u8 else 'f32'}]")

                def fn():
                    return K.gleanvec_sq_topk(qs, qlo, btags, x, k,
                                              row_ids=rid, layout_block=lb)
                report(label, fn,
                       lambda: per_cluster_library(qs, qlo, btags, x, k, rid,
                                                   lb),
                       2.0 * m * live * d, (qs.numel() + qlo.numel()) * 4
                       + live * d * x.element_size() + nb * 4 + live * 4
                       + m * k * 8)
                log(f"    device time by kernel (torch.profiler): "
                    + device_breakdown(fn))
                del x
    tags = torch.randint(0, c, (N_ROWS,), generator=gen, device=dev,
                         dtype=torch.int32)
    if want("gleanvec_sq_topk"):
        for u8 in (False, True):
            x = codes(N_ROWS, d, u8)

            def fn():
                return K.gleanvec_sq_topk(qs, qlo, tags, x, k)
            report(f"gleanvec_sq_topk[gathered {'u8' if u8 else 'f32'}]", fn,
                   lambda: per_cluster_library(qs, qlo, tags, x, k, None, 0),
                   2.0 * m * N_ROWS * d, (qs.numel() + qlo.numel()) * 4
                   + N_ROWS * (d * x.element_size() + 4) + m * k * 8)
            log(f"    device time by kernel (torch.profiler): "
                + device_breakdown(fn))
            del x
    # the IVF fine step: each query probes IVF_NPROBE of the C clusters,
    # at the flat path's layout block and the stream's
    if want("ivf_scan_topk"):
        probe = torch.rand(m, c, generator=gen, device=dev).argsort(dim=1)[
            :, :IVF_NPROBE]
        for lb in (4096, 256):
            nb = -(-N_ROWS // lb)
            btags, rid = sorted_layout(nb, lb, c, 0.05)
            sched = _list_block_ranges(btags, c)[probe].reshape(m, -1)
            for u8 in (False, True):
                x = codes(nb * lb, d, u8)
                args = (qs, qlo, btags, rid, x, sched, k, lb)
                layout = SimpleNamespace(layout_block=lb, codes=x,
                                         block_tags=btags, perm=rid)
                report(f"ivf_scan_topk[nprobe={IVF_NPROBE} L={lb} "
                       f"{'u8' if u8 else 'f32'}]",
                       lambda: K.ivf_scan_topk(*args),
                       lambda: ivf_library(qs, qlo, layout, probe, k),
                       *ivf_work(*args))
                log(f"    {ivf_split(K, args)}")
                del x, args, layout
    # the dense kernels at the stream's shape (one (M, N) f32 output)
    if want("gleanvec_sq"):
        for label, lb, u8 in (("gathered f32", 0, False),
                              ("gathered u8", 0, True),
                              ("sorted f32 L=256", 256, False),
                              ("sorted u8 L=256", 256, True)):
            nb = -(-N_ROWS // lb) if lb else 0
            n = nb * lb if lb else N_ROWS
            t = sorted_layout(nb, lb, c, 0.0)[0] if lb else tags
            x = codes(n, d, u8)
            report(f"gleanvec_sq[{label}]",
                   lambda: K.gleanvec_sq(qs, qlo, t, x, layout_block=lb),
                   lambda: per_cluster_dense_library(qs, qlo, t, x, lb),
                   2.0 * m * n * d, (qs.numel() + qlo.numel() + m * n
                                     + t.numel()) * 4
                   + n * d * x.element_size())
            log("    output digest " + device_digest(
                K.gleanvec_sq(qs, qlo, t, x, layout_block=lb)))
            del x
    if want("gleanvec_ip"):
        x = codes(N_ROWS, d, False)
        zeros = torch.zeros((m, c), device=dev)
        report("gleanvec_ip[gathered f32]", lambda: K.gleanvec_ip(qs, tags, x),
               lambda: per_cluster_dense_library(qs, zeros, tags, x, 0),
               2.0 * m * N_ROWS * d, (qs.numel() + m * N_ROWS + N_ROWS * d
                                      + N_ROWS) * 4)
        del x, zeros
    del tags
    # one graph hop at the graph path's shapes: batch 1024, beam 128, S
    # neighbor rows (pads, repeats, dead rows) of a 1M-row sorted layout
    if want("graph_scan_beam_step"):
        lb = 4096
        nb = -(-GRAPH_ROWS // lb)
        n = nb * lb
        btags, rid = sorted_layout(nb, lb, c, 0.05)
        beam_rows = (torch.arange(GRAPH_BEAM, device=dev) * (n // GRAPH_BEAM))[
            None] + torch.randint(0, n // GRAPH_BEAM, (m, 1), generator=gen,
                                  device=dev)
        beam_ids = rid[beam_rows]
        beam_vals = torch.where(beam_ids >= 0,
                                3 * torch.randn(m, GRAPH_BEAM, generator=gen,
                                                device=dev),
                                torch.full((m, GRAPH_BEAM), -3.4e38,
                                           device=dev))
        beam_vals, order = torch.sort(beam_vals, dim=1, descending=True)
        beam_ids = torch.gather(beam_ids, 1, order)
        for u8 in (False, True):
            x = codes(n, d, u8)
            for s in (28, 112):
                nbr = torch.randint(0, n, (m, s), generator=gen, device=dev,
                                    dtype=torch.int32)
                nbr[torch.rand(m, s, generator=gen, device=dev) < 0.15] = -1
                nbr[:, 1::7] = nbr[:, :1]                 # repeated rows
                args = (qs, qlo, btags, rid, x, nbr, beam_vals, beam_ids)
                report(f"graph_scan_beam_step[{'u8' if u8 else 'f32'} S={s}]",
                       lambda: K.graph_scan_beam_step(*args, layout_block=lb),
                       lambda: hop_library(*args, lb), *hop_work(*args, lb),
                       reps=50)
            del x
        del btags, rid, beam_ids, beam_vals
    del qs, qlo
    if want("sq_dot"):
        q = torch.randn(m, d, generator=gen, device=dev)
        lo = torch.randn(m, generator=gen, device=dev)
        x = codes(N_ROWS, d, True)
        report("sq_dot[stream shape]", lambda: K.sq_dot_folded(q, lo, x),
               lambda: q @ x.to(torch.float32).T + lo[:, None],
               2.0 * m * N_ROWS * d, (q.numel() + m + m * N_ROWS) * 4
               + x.numel())
        log("    device time by kernel (torch.profiler): " + device_breakdown(
            lambda: K.sq_dot_folded(q, lo, x), reps=2))
        del q, lo, x
    # flash_attention at the LM prefill's shape (h2o-danube-3-4b heads)
    if want("flash_attention"):
        b, h, kv, s, dh, window = LM_BATCH, 32, 8, LM_PROMPT, 120, 4096
        q, k_, v = (torch.randn(b, heads, s, dh, generator=gen,
                                device=dev).to(torch.bfloat16)
                    for heads in (h, kv, kv))
        ms, _ = timed(lambda: K.flash_attention(q, k_, v, True, window), 5)
        lib_ms, _, how = sdpa_library(q, k_, v, window, 3)
        bnd, by = bound_ms(*flash_work(q, k_, v, window), PEAK_BF16_FLOPS)
        log(f"  flash_attention[B={b} H={h} KV={kv} S={s} dh={dh} W={window} "
            f"bf16, {flash_kernel_name(q, k_, v)}]: ms={ms:.3f} "
            f"library_ms={lib_ms:.3f} (SDPA, {how}, a dense (S, S) mask) "
            f"bound_ms={bnd:.3f} ({by}) share_of_bound={bnd / ms:.1%}; "
            + clocks_during(lambda: K.flash_attention(q, k_, v, True,
                                                      window)))
        log("    " + causal_yardstick(K, None, q, k_, v, check=False))
        log("    " + flash_profile(q, k_, v, window))
        del q, k_, v
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# Phases 3i-3k: the paper's configuration at full width, the linear
# baselines and flexible d, recsys serving and candidate retrieval.
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def uncounted(K):
    """Launches inside do not count (the kernel-against-plain checks and
    the timings): every launch counter is restored on exit."""
    saved = {fn: fn.launches for fn in all_counters(K)}
    try:
        yield
    finally:
        for fn, v in saved.items():
            fn.launches = v


def served_batches(fn, q, batches: int = PAPER_BATCHES):
    """``fn(q) -> (cand_vals, cand_ids, ids)`` for a warm-up and
    ``batches`` batches, each timed on the host clock to its ids on the
    host. Returns (last result, p50 ms, QPS over the batches)."""
    times, out = [], None
    for i in range(batches + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(q)
        out[2].cpu()
        if i:
            times.append(time.perf_counter() - t0)
    return out, sorted(times)[len(times) // 2] * 1e3, \
        q.shape[0] * batches / sum(times)


def event_ms(fn, reps: int = 5):
    """Milliseconds of ``reps`` runs of ``fn`` after a warm-up, each timed
    by CUDA events, sorted; returns (times, last output)."""
    out = fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times), out


def p50_ms(fn, reps: int = 5):
    """p50 milliseconds of ``fn`` over ``reps`` runs after a warm-up (CUDA
    events); returns (ms, last output)."""
    times, out = event_ms(fn, reps)
    return times[reps // 2], out


def kmeans_row(K, testing, label, x_unit, cent, launches):
    """kmeans_assign's kernel-table row against ``cent`` at ``x_unit``'s
    shape: time, plain time, bound and ``torch.max(x @ centers.T)``."""
    n, d = x_unit.shape
    c = cent.shape[0]
    ms, out_k = timed(lambda: K.kmeans_assign(x_unit, cent), 3)
    plain_ms, out_p = timed_once(lambda: K.kmeans_assign_plain(x_unit, cent))
    err = check_kmeans(f"kmeans_assign[{label}] vs plain", x_unit, cent,
                       out_k, out_p, testing)
    lib_ms, _ = timed(lambda: torch.max(x_unit @ cent.T, dim=1), 3)
    b, by = bound_ms(2.0 * n * c * d, n * d * 4 + c * d * 4 + n * 8)
    log(f"  kmeans_assign[{label}]: ms={ms:.3f} plain_ms={plain_ms:.3f} "
        f"bound_ms={b:.3f} ({by}) library_ms={lib_ms:.3f} "
        f"launches={launches}")
    src, repl = KERNEL_FILES["kmeans_assign"]
    return {"name": f"kmeans_assign[{label}]", "route": "cuda",
            "source": src, "replaces": repl, "launches": launches,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b, "bound_by": by, "library_ms": lib_ms}


def phase_paper(K, testing):
    """Phase 3i: ``gleanvec-paper``'s learn_oi13m, search_oi13m and
    search_oi13m_sorted at their published shapes on rows drawn on the
    card. Returns the kernel-table rows of its shapes (their launches are
    this phase's)."""
    from repro_torch.configs import registry
    from repro_torch.core import gleanvec as gv
    from repro_torch.core import leanvec_sphering as lvs
    from repro_torch.core import search as msearch
    from repro_torch.core.scorer import (GleanVecScorer, LinearScorer,
                                         SortedGleanVecScorer)
    from repro_torch.core.spherical_kmeans import normalize_rows
    from repro_torch.data import vectors
    from repro_torch.index import bruteforce as bf

    shapes = registry.get("gleanvec-paper").SHAPES
    learn, srch = shapes["learn_oi13m"], shapes["search_oi13m"]
    n, dim, d, c = learn["n"], learn["D"], learn["d"], learn["C"]
    batch, k, kappa = srch["batch"], srch["k"], srch["kappa"]
    dev = torch.device("cuda")
    log(f"phase 3i: gleanvec-paper learn_oi13m (n={n} D={dim} d={d} C={c} "
        f"m={learn['m_queries']}), search_oi13m gathered and sorted "
        f"(batch={batch} k={k} kappa={kappa}); search_rqa10m and "
        "search_t2i10m in phase 3o")
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ds = vectors.make_dataset_device(
        n, dim, learn["m_queries"], batch,
        torch.Generator(device=dev).manual_seed(PAPER_SEED), ood=True)
    torch.cuda.synchronize()
    x, q = ds.database, ds.queries_test
    log(f"  data on the card: {time.perf_counter() - t0:.1f} s, "
        f"{x.numel()} elements ({x.numel() / (1 << 31):.2f} x 2^31), "
        f"{x.numel() * 4 / 1e9:.1f} GB")
    art = msearch.SearchArtifacts(scorer=None, x_full=x)
    for fn in all_counters(K):
        fn.launches = 0

    # the exact top-k: bruteforce.search -> ip_topk over the full rows
    t0 = time.perf_counter()
    gt_vals, gt = bf.search(q, x, k, device=dev)
    torch.cuda.synchronize()
    log(f"  exact top-{k} (bruteforce.search -> ip_topk, {n} x {dim}): "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
    gt_np = gt.cpu().numpy()

    t0 = time.perf_counter()
    glv = gv.fit(ds.queries_learn, x, c=c, d=d, generator=torch.Generator(
        device=dev).manual_seed(0), device=dev)
    torch.cuda.synchronize()
    fit_glv = time.perf_counter() - t0
    fit_launches = K.kmeans_assign.launches
    t0 = time.perf_counter()
    sph = lvs.fit(ds.queries_learn, x, d, device=dev)
    torch.cuda.synchronize()
    log(f"  learn: GleanVec fit {fit_glv:.1f} s ({fit_launches} "
        f"kmeans_assign launches), LeanVec-Sphering fit "
        f"{time.perf_counter() - t0:.2f} s; peak so far "
        f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB")
    if not (torch.isfinite(glv.a).all() and torch.isfinite(sph.a).all()):
        raise AssertionError("phase 3i: a fit is not finite")
    del sph

    def gathered(qb):
        views = gv.project_queries_eager(glv, qb)
        cv, ci = bf.search_gleanvec(views, tags, x_low, kappa, device=dev)
        return cv, ci, msearch.rerank(qb, art, ci, k)

    def sorted_layout(qb):
        views = gv.project_queries_eager(glv, qb)
        cv, rows = bf.search_gleanvec_sorted(views, btags, xs, kappa,
                                             device=dev)
        ci = torch.where(rows >= 0, perm[rows.clamp(min=0).long()],
                         torch.full_like(rows, -1))
        return cv, ci, msearch.rerank(qb, art, ci, k)

    views = gv.project_queries_eager(glv, q)
    sub = slice(0, CHECK_QUERIES)
    qlo = torch.zeros(views.shape[:2], device=dev)
    readings, per_layout, rows = {}, {}, []
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tags, x_low = gv.encode_database(glv, x)
    torch.cuda.synchronize()
    encode_s = time.perf_counter() - t0
    for layout in ("gathered", "sorted"):
        if layout == "sorted":
            t0 = time.perf_counter()
            xs, btags, perm = gv.sort_by_tag(tags, x_low, block=4096)
            del tags, x_low                   # free the gathered layout
            torch.cuda.synchronize()
            encode_s = time.perf_counter() - t0
            torch.cuda.reset_peak_memory_stats()
        before = K.gleanvec_sq_topk.launches
        fn = gathered if layout == "gathered" else sorted_layout
        (cv, ci, ids), p50, qps = served_batches(fn, q)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        per_layout[layout] = K.gleanvec_sq_topk.launches - before
        ids_np = ids.cpu().numpy()
        rec = recall(ids_np, gt_np)
        readings[layout] = (p50, qps, rec)
        log(f"  search_oi13m{'_sorted' if layout == 'sorted' else ''} "
            f"({layout}): {'sort_by_tag' if layout == 'sorted' else 'encode'}"
            f"={encode_s:.2f}s batches={PAPER_BATCHES} p50={p50:.2f}ms "
            f"QPS={qps:.0f} recall@{k}={rec:.4f} (floor "
            f"{PAPER_RECALL_FLOOR}) peak={peak / 1e9:.1f}GB "
            f"launches={per_layout[layout]}")
        if ids_np.shape != (batch, k) or not np.all((ids_np >= -1)
                                                    & (ids_np < n)):
            raise AssertionError(f"phase 3i {layout}: malformed ids")
        if rec < PAPER_RECALL_FLOOR:
            raise AssertionError(f"phase 3i {layout}: recall@{k} {rec:.4f} "
                                 f"below its floor {PAPER_RECALL_FLOOR}")
        with uncounted(K):
            if layout == "gathered":
                scorer = GleanVecScorer(x_low=x_low, tags=tags)
                mode = "gleanvec"
            else:
                ident = torch.arange(xs.shape[0], dtype=torch.int32,
                                     device=dev)
                scorer = SortedGleanVecScorer(x_low=xs, block_tags=btags,
                                              perm=ident, inv_perm=ident)
                mode = "gleanvec-sorted"
            calls = mode_calls(K, mode, scorer, views, kappa)
            if layout == "gathered":
                plain = K.gleanvec_sq_topk_plain(views[sub], qlo[sub], tags,
                                                 x_low, kappa)
            else:
                pv, pr = K.gleanvec_sq_topk_plain(views[sub], qlo[sub], btags,
                                                  xs, kappa,
                                                  layout_block=4096)
                plain = (pv, torch.where(pr >= 0, perm[pr.clamp(min=0).long()],
                                         torch.full_like(pr, -1)))
            check_topk(f"gleanvec_sq_topk[oi13m {layout}] {CHECK_QUERIES} "
                       "served queries vs plain", (cv[sub], ci[sub]), plain,
                       calls[4], testing)
            rows.append(time_kernel("gleanvec_sq_topk", f"oi13m {layout}",
                                    calls, per_layout[layout], testing))
            del calls, scorer, plain
    del xs, btags, perm, cv, ci, ids
    with uncounted(K):
        x_unit = normalize_rows(x)
        rows.append(kmeans_row(K, testing, f"oi13m C={c}", x_unit,
                               glv.centers.contiguous(),
                               K.kmeans_assign.launches))
        del x_unit
        check_topk(f"ip_topk[oi13m exact k={k}] {CHECK_QUERIES} served "
                   "queries vs plain", (gt_vals[sub], gt[sub]),
                   K.ip_topk_plain(q[sub], x, k),
                   testing.dot_tol(row_norm_max(q), row_norm_max(x), dim),
                   testing)
        # the library yardstick, torch.topk(q @ x.T), holds a (1024, 13M)
        # f32 product (53.2 GB) beside the 26.6 GB of rows: only x and q
        # stay on the card
        ip_launches = K.ip_topk.launches
        del glv, views, art, ds
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        calls = mode_calls(K, "full", LinearScorer(x_low=x), q, k)
        torch.cuda.reset_peak_memory_stats()
        rows.append(time_kernel("ip_topk", f"oi13m exact k={k}", calls,
                                ip_launches, testing))
        log(f"  ip_topk[oi13m exact k={k}] library yardstick: peak "
            f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB of "
            f"{torch.cuda.get_device_properties(0).total_memory / 1e9:.1f}")
        del calls
    launches = counts(K)
    log(f"  phase 3i launches: {launches}; p50 gathered / sorted "
        f"{readings['gathered'][0]:.2f} / {readings['sorted'][0]:.2f} ms "
        f"({time.perf_counter() - t_phase:.0f} s)")
    for name in ("ip_topk", "gleanvec_sq_topk", "kmeans_assign"):
        if launches[name] <= 0:
            raise AssertionError(f"phase 3i: {name} was not launched")
    del x, q, gt, gt_vals
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return rows


def pair_loss(approx: torch.Tensor, exact: torch.Tensor) -> float:
    """Mean squared score error over (query, row) pairs: Problem (3)'s
    loss per pair, which ``metrics.leanvec_loss`` computes through the
    moments of a linear model."""
    return float(torch.mean((approx.double() - exact.double()) ** 2))


def truncation_reading(q_learn, x, d, direct, cut, q, xs):
    """Why the full rotation cut to d and the direct d fit read different
    losses though the code makes them equal row for row (ROADMAP C 5):
    both fits' moments recomputed twice and compared element by element,
    the eigensolver run twice on one matrix, the eigenvalue gap at d, the
    two models' Stiefel factors by principal angles, and the cut's A and B
    recomputed from its P with the direct fit's product shapes ((d, D) @
    (D, D), where the cut's came out of (D, D) @ (D, D)), with the loss of
    each on the test queries ``q`` and the rows ``xs``."""
    from repro_torch.core import leanvec_sphering as lvs
    from repro_torch.core import linalg, metrics

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    kq = [linalg.second_moment(q_learn) for _ in range(2)]
    kx = [linalg.second_moment(x) for _ in range(2)]
    log(f"  C 5: K_Q twice: {'bit for bit' if torch.equal(*kq) else 'differ'}"
        f" (max rel gap {rel(*kq):.2e}); K_X twice: "
        f"{'bit for bit' if torch.equal(*kx) else 'differ'} (max rel gap "
        f"{rel(*kx):.2e})")
    w, _ = linalg.sphering_from_moment(kq[0])
    m = w @ kx[0] @ w
    m = 0.5 * (m + m.T)
    runs = [torch.linalg.eigh(m) for _ in range(2)]
    evals = runs[0][0].flip(0)
    log(f"  C 5: eigh twice on one matrix: "
        f"{'bit for bit' if torch.equal(runs[0][1], runs[1][1]) else 'differ'}"
        f"; eigenvalues {d - 2}..{d + 1} (descending, 0-based): "
        f"{[float(v) for v in evals[d - 2:d + 2]]} (gap at d: "
        f"{float((evals[d - 1] - evals[d]) / evals[d - 1]):.2e} relative)")
    again = [lvs.fit_from_moments(kq[0], kx[0], dd).p for dd in (d, x.shape[1])]
    refit = lvs.fit(q_learn, x, d, device=x.device).p
    cos = torch.linalg.svdvals(direct.p.double() @ cut.p.double().T)
    log(f"  C 5: from one pair of moments the d fit's P "
        f"{'equals' if torch.equal(again[0], again[1][:d]) else 'differs from'}"
        f" the full fit's first {d} rows (and the phase's direct fit's: "
        f"{torch.equal(again[0], direct.p)}); the direct fit run again now: "
        f"P bit for bit {torch.equal(refit, direct.p)}; the phase's two fits:"
        f" P bit for bit {torch.equal(direct.p, cut.p)}, principal angles cos min "
        f"{float(cos.min()):.6f} ({int((cos < 1 - 1e-3).sum())} of {d} "
        f"below 0.999), max |A gap| {float((direct.a - cut.a).abs().max()):.3e}"
        f", max |B gap| {float((direct.b - cut.b).abs().max()):.3e}")
    p_cut = cut.p.contiguous()
    a2, b2 = p_cut @ cut.w_pinv, p_cut @ cut.w
    s = torch.linalg.svdvals(cut.w_pinv)
    s = s[s > 1e-6 * s.max()]       # the cut directions read ~1e-9 x max
    losses = [float(metrics.leanvec_loss(a.contiguous(), b.contiguous(), q,
                                         xs))
              for a, b in ((direct.a, direct.b), (cut.a, cut.b), (a2, b2))]
    log(f"  C 5: the cut's A and B from its P in the direct fit's shapes: "
        f"bit for bit the direct fit's {torch.equal(a2, direct.a)} / "
        f"{torch.equal(b2, direct.b)}; loss direct / cut / recomputed "
        f"{losses[0]:.6g} / {losses[1]:.6g} / {losses[2]:.6g}; max |A| "
        f"{float(direct.a.abs().max()):.3e}, W+ condition over the kept "
        "directions "
        f"{float(s.max() / s.min()):.3e}")


def phase_baselines(K, testing, ds, x):
    """Phase 3j: the paper's linear baselines (SVD, LeanVec-FW, -ES,
    -ES+FW) beside LeanVec-Sphering, GleanVec and the full-rotation
    model's truncations on phase 3's data (n = 2M, D 512, d 160): fit
    seconds, the loss on a sample, recall@10 through ``bruteforce``'s
    scans and the rerank at kappa 100. Returns its launches at the d =
    160 shapes (phase 3's rows) and the kernel-table rows of the
    truncations' other widths (their launches are their own scans')."""
    from repro_torch.configs import registry
    from repro_torch.core import baselines
    from repro_torch.core import gleanvec as gv
    from repro_torch.core import leanvec_sphering as lvs
    from repro_torch.core import linalg, metrics
    from repro_torch.core import search as msearch
    from repro_torch.core.scorer import LinearScorer
    from repro_torch.index import bruteforce as bf

    dev = torch.device("cuda")
    shape = registry.get("gleanvec-paper").SHAPES["search_oi13m"]
    d, c, k, kappa = shape["d"], shape["C"], shape["k"], shape["kappa"]
    log(f"phase 3j: linear baselines and flexible d on phase 3's data "
        f"(n={x.shape[0]} D={x.shape[1]} d={d}, moments of its "
        f"{ds.queries_learn.shape[0]} learning queries and all rows; loss "
        f"on {BASELINE_SAMPLE} rows x {ds.queries_test.shape[0]} queries; "
        f"recall@{k} with the rerank at kappa={kappa})")
    t_phase = time.perf_counter()
    q_learn = torch.as_tensor(ds.queries_learn, device=dev)
    q = torch.as_tensor(ds.queries_test, device=dev)
    xs = x[:BASELINE_SAMPLE]
    exact = q @ xs.T
    art = msearch.SearchArtifacts(scorer=None, x_full=x)
    for fn in all_counters(K):
        fn.launches = 0
    k_q, k_x = linalg.second_moment(q_learn), linalg.second_moment(x)
    # the fits' objective per (learning query, row) pair, in f64: in f32
    # the moment form loses its sign at this n (K_X's top eigenvalues are
    # ~1e9, the loss lives in the rest)
    k_q64 = q_learn.double().T @ q_learn.double()
    k_x64 = sum(c.double().T @ c.double() for c in torch.split(x, 1 << 18))
    pairs = q_learn.shape[0] * x.shape[0]

    def fit(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    linear = {}
    for name, fn in (
            ("SVD", lambda: baselines.svd_fit(k_x, d)),
            ("LeanVec-FW", lambda: baselines.leanvec_fw(k_q, k_x, d)),
            ("LeanVec-ES", lambda: baselines.leanvec_es(k_q, k_x, d)),
            ("LeanVec-ES+FW", lambda: baselines.leanvec_es_fw(k_q, k_x, d)),
            ("LeanVec-Sphering", lambda: lvs.fit(q_learn, x, d,
                                                 device=dev))):
        linear[name] = fit(fn)
    full, full_s = fit(lambda: lvs.full_rotation_model(q_learn, x,
                                                       device=dev))
    for dt in BASELINE_TRUNCATIONS:
        linear[f"full rotation d={dt}"] = (full.truncate(dt), full_s)
    del full
    glv, glv_s = fit(lambda: gv.fit(q_learn, x, c=c, d=d,
                                    generator=torch.Generator(
                                        device=dev).manual_seed(0),
                                    device=dev))
    objective, cands, rows = {}, {}, []
    for name, (model, secs) in linear.items():
        a, b = model.a.contiguous(), model.b.contiguous()
        loss = float(metrics.leanvec_loss(a, b, q, xs))
        objective[name] = float(baselines.leanvec_loss_from_moments(
            a.double(), b.double(), k_q64, k_x64)) / pairs
        q_low, x_low = q @ a.T, x @ b.T
        before = K.ip_topk.launches
        cand = bf.search(q_low, x_low, kappa, device=dev)
        if a.shape[0] != d:             # its own row of the kernel table
            scan_launches = K.ip_topk.launches - before
            K.ip_topk.launches = before
            with uncounted(K):
                rows.append(time_kernel(
                    "ip_topk", f"full rotation d={a.shape[0]}",
                    mode_calls(K, "sphering", LinearScorer(x_low=x_low),
                               q_low, kappa), scan_launches, testing))
        del q_low, x_low
        ids = msearch.rerank(q, art, cand[1], k).cpu().numpy()
        rec = recall(ids, ds.gt[:, :k])
        cands[name] = cand
        log(f"  {name}: d={a.shape[0]} fit={secs:.3f}s loss={loss:.6g} "
            f"(pairwise on the sample: "
            f"{pair_loss((q @ a.T) @ (xs @ b.T).T, exact):.6g}; the fit's "
            f"objective per learning pair, f64: {objective[name]:.6g}) "
            f"recall@{k}={rec:.4f} (floor {RECALL_FLOORS['sphering']})")
        if not np.isfinite(loss) or not objective[name] >= 0.0 \
                or ids.shape != (q.shape[0], k):
            raise AssertionError(f"phase 3j {name}: loss {loss}, objective "
                                 f"{objective[name]} or ids {ids.shape} "
                                 "malformed")
        if rec < RECALL_FLOORS["sphering"]:
            raise AssertionError(f"phase 3j {name}: recall@{k} {rec:.4f} "
                                 f"below the linear modes' floor")
    tags, x_low = gv.encode_database(glv, x)
    views = gv.project_queries_eager(glv, q)
    cand = bf.search_gleanvec(views, tags, x_low, kappa, device=dev)
    ids = msearch.rerank(q, art, cand[1], k).cpu().numpy()
    t_s, low_s = gv.encode_database(glv, xs)
    approx = K.gleanvec_sq_plain(views, torch.zeros(views.shape[:2],
                                                    device=dev), t_s, low_s)
    rec = recall(ids, ds.gt[:, :k])
    log(f"  GleanVec: d={d} C={c} fit={glv_s:.3f}s "
        f"loss={pair_loss(approx, exact):.6g} (pairwise on the sample; no "
        f"moment form) recall@{k}={rec:.4f} (floor "
        f"{RECALL_FLOORS['gleanvec']})")
    if rec < RECALL_FLOORS["gleanvec"]:
        raise AssertionError(f"phase 3j GleanVec: recall@{k} {rec:.4f} below "
                             "its floor")
    del tags, x_low, approx, t_s, low_s
    tol = testing.dot_tol(row_norm_max(q @ linear["LeanVec-Sphering"][0].a.T),
                          row_norm_max(xs @ linear["LeanVec-Sphering"][0].b.T),
                          d)
    check_topk(f"truncation d={d} vs the direct d={d} fit (candidates)",
               cands[f"full rotation d={d}"], cands["LeanVec-Sphering"],
               tol, testing)
    truncation_reading(q_learn, x, d, linear["LeanVec-Sphering"][0],
                       linear[f"full rotation d={d}"][0], q, xs)
    launches = counts(K)
    log(f"  phase 3j launches: {launches} "
        f"({time.perf_counter() - t_phase:.0f} s)")
    for name in ("ip_topk", "gleanvec_sq_topk", "kmeans_assign"):
        if launches[name] <= 0:
            raise AssertionError(f"phase 3j: {name} was not launched")
    return launches, rows


def recsys_serve(label, ns, params, cfg, make_batch, note=""):
    """``user_embedding`` and ``ctr_loss`` at serve_p99 and serve_bulk:
    p50 ms (CUDA events), users/s and the peak device memory above the
    start."""
    from repro_torch.configs.recsys_common import RECSYS_SHAPES
    for shape in ("serve_p99", "serve_bulk"):
        b = RECSYS_SHAPES[shape]["batch"]
        batch = make_batch(b)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reps = 5 if shape == "serve_p99" else 1
        ue_ms, u = p50_ms(lambda: ns.user_embedding(params, batch, cfg),
                          reps)
        loss_ms, loss = p50_ms(lambda: ns.ctr_loss(params, batch, cfg), reps)
        peak = torch.cuda.max_memory_allocated() - base
        log(f"  {label} {shape} (batch {b}{note}): user_embedding "
            f"p50={ue_ms:.3f}ms ({b / ue_ms * 1e3:.0f} users/s) "
            f"ctr_loss p50={loss_ms:.3f}ms loss={float(loss):.5f} "
            f"peak above the start={peak / 1e9:.2f}GB")
        if u.shape[0] != b or not bool(torch.isfinite(u).all()) \
                or not bool(torch.isfinite(loss)):
            raise AssertionError(f"{label} {shape}: malformed outputs")
        del batch, u, loss


def retrieval_runs(K, testing, label, cands, learn_q, users, modes):
    """``retrieval_cand``: ``cands`` behind ``build_retrieval_index`` in
    ``modes`` (d = 16, C = 16 fits on ``learn_q``), ``retrieve`` at each
    batch of ``users`` ({batch: (B, D)}): p50, recall@10 against mode
    full (a parity reading: the weights are random), and each run's
    kernel row. Returns the rows."""
    from repro_torch.core import gleanvec as gv
    from repro_torch.core import leanvec_sphering as lvs
    from repro_torch.serve import retrieval

    dev = torch.device("cuda")
    k, kappa = 10, 100
    kmeans_before = K.kmeans_assign.launches
    models = {}
    if any(m.startswith("sphering") for m in modes):
        models["sphering"] = lvs.fit(learn_q, cands, RETRIEVAL_D, device=dev)
    if any(m.startswith("gleanvec") for m in modes):
        models["gleanvec"] = gv.fit(learn_q, cands, c=RETRIEVAL_C,
                                    d=RETRIEVAL_D, generator=torch.Generator(
                                        device=dev).manual_seed(0),
                                    device=dev)
    rows, full_ids = [], {}
    for mode in modes:
        model = None if mode == "full" else models[
            "sphering" if mode.startswith("sphering") else "gleanvec"]
        t0 = time.perf_counter()
        idx = retrieval.build_retrieval_index(cands, mode, model,
                                              device=dev)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        for b, u in users.items():
            before = counts(K)
            ms, ids = p50_ms(lambda: retrieval.retrieve(idx, u, k, kappa))
            delta = {n: v - before[n] for n, v in counts(K).items() if
                     v - before[n]}
            ids_np = ids.cpu().numpy()
            if mode == "full":          # exact: held against torch.topk
                full_ids[b] = ids_np
                scores = u @ cands.T
                check_topk(f"{label} full M={b} vs torch.topk",
                           (torch.gather(scores, 1, ids.long()), ids),
                           torch.topk(scores, k, dim=1),
                           testing.dot_tol(row_norm_max(u),
                                           row_norm_max(cands),
                                           cands.shape[1]), testing)
                del scores
            rec = recall(ids_np, full_ids[b])
            per_call = {n: v / 6 for n, v in delta.items()}
            log(f"  {label} retrieval_cand mode={mode} batch={b}: "
                f"build={build_s:.2f}s p50={ms:.3f}ms recall@{k} vs full="
                f"{rec:.4f} (random weights: a parity reading, not a "
                f"quality figure) launches/call={per_call}")
            n_cand = cands.shape[0]
            if ids_np.shape != (b, k) or not np.all((ids_np >= 0)
                                                    & (ids_np < n_cand)):
                raise AssertionError(f"{label} {mode} M={b}: malformed ids")
            name = "ip_topk" if mode in ("full", "sphering",
                                         "sphering-int8") \
                else "gleanvec_sq_topk"
            if delta.get(name, 0) <= 0:
                raise AssertionError(f"{label} {mode}: {name} not launched")
            with uncounted(K):
                qstate = idx.scorer.prepare_queries(u)
                rows.append(time_kernel(
                    name, f"{label} {mode} M={b}",
                    mode_calls(K, mode, idx.scorer, qstate,
                               k if mode == "full" else kappa),
                    delta[name], testing))
        del idx
    if "gleanvec" in models:
        from repro_torch.core.spherical_kmeans import normalize_rows
        with uncounted(K):
            rows.append(kmeans_row(
                K, testing, f"{label} C={RETRIEVAL_C} D={cands.shape[1]}",
                normalize_rows(cands), models["gleanvec"].centers.contiguous(),
                K.kmeans_assign.launches - kmeans_before))
    return rows


def phase_recsys(K, testing):
    """Phase 3k: the recommenders at full width with random weights
    drawn on the card: MIND (serve_p99, serve_bulk, retrieval_cand in the
    seven modes at batch 1 and 512), BST and FM (serving; retrieval in
    mode full, BST also in the sorted modes), DLRM (user_embedding at full
    width, the CTR forward at the smoke config). Returns the kernel-table
    rows of its retrieval runs."""
    from repro_torch.configs import registry
    from repro_torch.core.scorer import MODES
    from repro_torch.models import layers, recsys
    from repro_torch.train import data

    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    log("phase 3k: recsys serving and candidate retrieval (random weights "
        "from seeds, on the card; retrieval_cand: the first 1,000,000 "
        f"items, d={RETRIEVAL_D} C={RETRIEVAL_C} kappa=100 k=10)")
    for fn in all_counters(K):
        fn.launches = 0
    rows = []
    gen = torch.Generator(device=dev).manual_seed(RECSYS_SEED)
    n_cand = registry.get("mind").SHAPES["retrieval_cand"]["n_candidates"]

    cfg = registry.get("mind").make_config()
    params = recsys.mind.init(gen, cfg, device=dev)
    recsys_serve("mind", recsys.mind, params, cfg, lambda b: data.mind_batch(
        RECSYS_SEED, 0, b, cfg.seq_len, cfg.n_items, device=dev))
    users = {b: recsys.mind.user_embedding(params, data.mind_batch(
        RECSYS_SEED, 2, b, cfg.seq_len, cfg.n_items, device=dev), cfg)
        for b in RETRIEVAL_BATCHES}
    learn = recsys.mind.user_embedding(params, data.mind_batch(
        RECSYS_SEED, 1, RECSYS_LEARN_USERS, cfg.seq_len, cfg.n_items,
        device=dev), cfg)
    rows += retrieval_runs(K, testing, "mind",
                           params["item_emb"][:n_cand].contiguous(), learn,
                           users, MODES)
    del params, users, learn

    cfg = registry.get("bst").make_config()
    params = recsys.bst.init(gen, cfg, device=dev)
    recsys_serve("bst", recsys.bst, params, cfg, lambda b: data.bst_batch(
        RECSYS_SEED, 0, b, cfg.seq_len, cfg.n_items, device=dev))
    users = {b: recsys.bst.user_embedding(params, data.bst_batch(
        RECSYS_SEED, 2, b, cfg.seq_len, cfg.n_items, device=dev), cfg)
        for b in RETRIEVAL_BATCHES}
    learn = recsys.bst.user_embedding(params, data.bst_batch(
        RECSYS_SEED, 1, RECSYS_LEARN_USERS, cfg.seq_len, cfg.n_items,
        device=dev), cfg)
    rows += retrieval_runs(K, testing, "bst",
                           params["item_emb"][:n_cand].contiguous(), learn,
                           users, ("full", "gleanvec-sorted",
                                   "gleanvec-int8-sorted"))
    del params, users, learn

    cfg = registry.get("fm").make_config()
    params = recsys.fm.init(gen, cfg, device=dev)
    vocab = (cfg.vocab_per_field,) * cfg.n_sparse

    def fm_batch(b, step=0):
        return data.criteo_batch(RECSYS_SEED, step, b, 0, vocab, device=dev)

    recsys_serve("fm", recsys.fm, params, cfg, fm_batch)
    users = {b: recsys.fm.user_embedding(params, fm_batch(b, 2), cfg)
             for b in RETRIEVAL_BATCHES}
    rows += retrieval_runs(K, testing, "fm",
                           params["v"][:n_cand].contiguous(), None, users,
                           ("full",))
    del params, users

    cfg = registry.get("dlrm-mlperf").make_config()
    bot = {"bot": layers.mlp_init(gen, (cfg.n_dense,) + cfg.bot_mlp,
                                  cfg.param_dtype, device=dev)}
    for b in (512, 262144):
        batch = data.criteo_batch(RECSYS_SEED, 0, b, cfg.n_dense,
                                  cfg.vocab_sizes, device=dev)
        ms, u = p50_ms(lambda: recsys.dlrm.user_embedding(bot, batch, cfg))
        log(f"  dlrm-mlperf user_embedding (the bottom MLP at full width, "
            f"bf16; no table) batch {b}: p50={ms:.3f}ms "
            f"({b / ms * 1e3:.0f} users/s) out={tuple(u.shape)}")
        if u.shape != (b, cfg.bot_mlp[-1]) or not bool(
                torch.isfinite(u).all()):
            raise AssertionError("dlrm user_embedding: malformed output")
    smoke = registry.get("dlrm-mlperf").make_config(smoke=True)
    sp = recsys.dlrm.init(gen, smoke, device=dev)
    recsys_serve("dlrm-mlperf", recsys.dlrm, sp, smoke,
                 lambda b: data.criteo_batch(RECSYS_SEED, 0, b, smoke.n_dense,
                                             smoke.vocab_sizes, device=dev),
                 note=f"; smoke config: the full table is "
                 f"{cfg.padded_total_vocab} x {cfg.embed_dim} f32 = "
                 f"{cfg.padded_total_vocab * cfg.embed_dim * 4 / 1e9:.1f} GB, "
                 "more than one card holds")
    launches = counts(K)
    log(f"  phase 3k launches: {launches} "
        f"({time.perf_counter() - t_phase:.0f} s)")
    for name in ("ip_topk", "gleanvec_sq_topk", "kmeans_assign"):
        if launches[name] <= 0:
            raise AssertionError(f"phase 3k: {name} was not launched")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after phase 2 (build + ragged checks)")
    ap.add_argument("--kernel-timing", nargs="*", metavar="KERNEL",
                    help="after the build, time every kernel (or those "
                    "named) at the main path's shapes on random data "
                    "through the public wrappers (no phase 2), then stop")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import kernels as K
    from repro_torch import testing

    t_start = time.perf_counter()
    log("phase 1: card and build")
    card = card_line()
    log(f"  card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # --kernel-timing with names builds only their sources
    sources = K.KERNEL_SOURCES
    if args.kernel_timing:
        sources = tuple(dict.fromkeys(Path(KERNEL_FILES[n][0]).stem
                                      for n in args.kernel_timing))
    t0 = time.perf_counter()
    built = K.build(sources)
    log(f"  build: {time.perf_counter() - t0:.1f} s wall, per source "
        + ", ".join(f"{k}={v:.1f}s" for k, v in built.items()))
    for name in sources:
        log_path = Path(f"{K.library_path(name)}.log")
        if log_path.exists():
            log(f"  {name} ptxas (-Xptxas -v):")
            for line in ptxas_summary(log_path.read_text()):
                log(f"    {line}")

    gen = torch.Generator(device="cuda").manual_seed(0)
    if args.kernel_timing is not None:
        kernel_timing(K, gen, args.kernel_timing)
        log(f"kernel timing: done ({time.perf_counter() - t_start:.0f} s)")
        return 0
    phase_kernels(K, testing, gen)
    torch.cuda.synchronize()
    if args.kernels_only:
        log(f"kernels-only: stopping after phase 2 "
            f"({time.perf_counter() - t_start:.0f} s)")
        return 0

    ds, x, sph, glv, states, per_mode, totals, flat_p50 = phase_main(K)
    ivf_inputs, ivf_launches = phase_ivf(K, testing, ds, x, glv, states)
    finals, stream_totals, stream_runs = phase_stream(K, testing, ds, x)
    hops, graph_totals, per_batch, searches = phase_graph(K, testing, ds, x,
                                                          sph, glv)
    phase_ops(K, ds, x, sph, glv)
    sharded_launches = phase_sharded(K, testing, ds, x, glv, sph, per_batch)
    phase_contracts(K, ds, x, sph, glv, states, searches)
    table = phase_timing(K, testing, x, glv, states, per_mode, totals,
                         ivf_inputs, ivf_launches, flat_p50)
    del states, ivf_inputs
    table += stream_timing(K, testing, finals, stream_totals, stream_runs,
                           torch.as_tensor(ds.queries_test,
                                           device=torch.device("cuda")))
    del finals
    table += graph_timing(K, testing, x, hops, graph_totals, per_batch,
                          searches)
    baseline_launches, baseline_rows = phase_baselines(K, testing, ds, x)
    table += baseline_rows
    del ds, x, sph, glv, hops, stream_totals, graph_totals, searches
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    table += phase_paper(K, testing)
    table += phase_recsys(K, testing)
    qkv, lm_launches = phase_lm(K, testing)
    log("phase 4 (LM): flash_attention at the prefill's captured shape")
    table.append(lm_timing(K, testing, qkv, lm_launches))
    del qkv
    table += phase_moe(K, testing)
    table += phase_train(K, testing)
    phase_gnn()
    bundle_rows, bundle_launches, measured = phase_bundles(K, testing)
    table += bundle_rows
    phase_dryrun(measured)
    del measured
    add_launches(table, bundle_launches)
    add_launches(table, sharded_launches)
    # phase 3j's d = 160 scans run the linear mode's shape and the
    # gathered GleanVec one at 2M rows (d = 64, 128 and 256 have rows of
    # their own)
    add_launches(table, {
        "ip_topk[sphering]": baseline_launches["ip_topk"],
        "gleanvec_sq_topk[gleanvec]": baseline_launches["gleanvec_sq_topk"],
        "kmeans_assign[C=48]": baseline_launches["kmeans_assign"]})
    torch.cuda.synchronize()
    log(f"total: {time.perf_counter() - t_start:.0f} s")
    print(card_line(), flush=True)
    print(json.dumps({"kernels": table}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

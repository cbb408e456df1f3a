#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's engine batch path, its QueryServer, the
sharded backend, the paper's three projection revisions, the selection
entry points, the LM serving path (``qwen3-8b`` at full width, bf16 and
int8; ``qwen3-moe-235b-a22b`` at full width, 12 of its 94 layers;
``mamba2-1.3b`` and ``recurrentgemma-9b`` at full width and depth;
``qwen2-vl-72b`` at full width, 32 of its 80 layers; ``seamless-m4t-medium``
at full width and depth) and the training path (``qwen3-8b`` at full
width, 8 of its 36 layers, and ``recurrentgemma-9b`` at full width, 3 of
its 38, from a record store on the card) on one NVIDIA GPU, also through
the sharding layer (an NCCL world of one).

    python3 chip_smoke.py [--rows N] [--build-rows M] [--seed S] [--reps R]

Builds the CUDA kernels from ``src/repro_torch/csrc`` (nvcc, sm_90a), then,
on a fact table S of ``benchmark_schema(64, 4)`` (16 int32 columns, the
paper's Fig. 13 upper end: 2 GiB of user data, 33,554,432 rows, 72 bytes a
row stored with the two MVCC words; ``--rows`` cuts it) whose key column
``A2`` is uniform in ``[0, 2 * M)``, and a dimension table R of the same
schema with M = 1,048,576 rows (``--build-rows``) and ``A2 = arange(M)`` as
its primary key — the setup of ``benchmarks/fig12_join.py``, about half the
probe rows matching — all made from ``--seed``:

1. prints the card (``nvidia-smi`` name and power limit, torch and CUDA);
2. times the kernel build (one ``nvcc`` a source, all at once) and prints
   the ``-Xptxas -v`` reports of ``rm_flash.cu``, ``rm_flash_bwd.cu``,
   ``rm_project.cu``, ``rm_spans.cu``, ``rm_join.cu``, ``rm_scan.cu``,
   ``rm_w8.cu``, ``rm_moe.cu`` and ``rm_rglru.cu``: each
   kernel's registers, shared memory and spills;
3. at 5,000 rows, for each revision (``bsl``, ``pck``, ``mlp``), runs the
   engine batch and the tick script below on a card engine and server and a
   CPU one and holds their results equal; then a WAL round: a card server
   with a ``WriteAheadLog`` through tick C's writes, the table recovered
   from the log, and tick C's reads served again from it on a fresh server,
   with equal results;
4. holds every kernel against its plain PyTorch version on the card at the
   path's shapes, and times both (CUDA events around the call, host work
   included, median of ``--reps`` after a warm-up; for the kernel and the
   library call also ``device_ms``, their kernels' device time alone from
   ``torch.profiler``, or ``device_ms_estimated`` where the trace lost
   launches), beside the least time the card could take and one library
   call where one computes the same (or, footnoted, less) work — the
   selection at four selectivities (90/50/10/1 %), one line each;
5. drives the engine through ``BatchExecutor`` / ``execute_many`` on the
   card — solo project, filter, aggregate and group-by, a mixed batch of 7
   ops, then 4,096 appends, 64 updates and 64 deletes and the same batch
   under a snapshot over base plus tail chunks — checks every result
   against a numpy oracle from the host table, and checks that each of the
   five scan kernels was launched by that run;
6. drives a ``QueryServer`` on the card through three ticks: A, the join
   ``S.A2 = R.A2`` alone on S (the probe streams the row store, cold build)
   beside a streamed projection; B, the same join (build cache hit); C,
   4,096 inserts, 64 updates and 64 deletes on S, then a filtered sum, a
   group-by average, a projection, the join and a two-join chain in one
   tick, all pinned to the tick's snapshot and riding one shared scan (the
   joins probe its packed block).  Every ticket is held against a numpy
   oracle, and the hash-join probe must have launched in ticks A and C;
   Then the sharded phase, on S as ``--seed`` built it and the same R: a
   ``ShardedEngine(num_shards=4)`` beside a single-device engine, step for
   step and timed apart — the upload (the same bytes; each shard its
   ``shard_ranges`` rows), the 7-op batch, a lone aggregate, 4,096 appends
   (exactly one shard gains a chunk), 64 updates and 64 deletes and the
   batch under a snapshot, the solo join (one broadcast of the build
   partitions: ``3 * parts.nbytes`` collective bytes, one collective op; a
   warm repeat adds nothing) — packed blocks, masks and join outputs
   bit-equal to the single engine's, everything against numpy; a permanent
   ``shard_pass`` fault on shard 1 (one failover, shard 1's bytes, the
   fused scan kernel launched for its chunks, equal results) and a
   malformed request that raises without a failover; the path's kernels
   against their plain versions on shard 0's rows; ``QueryServer(
   num_shards=4)`` through ticks A/B/C; the free ``dist_project``,
   ``dist_aggregate``, ``dist_groupby`` and ``dist_join`` over 4 shards,
   against numpy, and at 5,003 rows (one padding row) card against CPU;
7. the paper's Fig. 6 revision study on the card: for each revision an
   engine serves a solo projection of S for 1, 4 and 11 columns (11 is the
   configuration port's cap, ``MAX_ENABLED_COLUMNS``), each held bit-equal
   to numpy and to the ``mlp`` result, checks that the revision's kernel
   launched, and times the engine call and the kernel alone;
8. the selection entry points on S's device words: ``project_multi`` of
   three views and ``select_compact`` + ``densify`` at the four
   selectivities, every result against numpy;
9. releases S, R and the engines, then the LM phases:
   a. card against CPU: the smokes of ``qwen3-8b`` and of the two QKV-bias
      decoders, ``qwen1.5-110b`` and ``internlm2-20b``, each served by a
      ``ServeSession`` on the card (decode steps replayed from a CUDA
      graph) and one on the CPU with the same weights (drawn from
      ``--seed``), 5 requests over 2 slots: at float32 compute the token
      lists are equal and every prefill's and decode step's logits agree
      within 1e-4; at bfloat16 compute every prefill's logits agree within
      5e-2 (the card's kernel scales q in float32, the CPU's blockwise path
      in bf16, and the two frameworks round bf16 matmuls apart); then
      ``qwen3-8b-smoke`` int8-quantized at float32 compute (the W8 kernel
      in its decode steps), tokens equal and logits within 1e-4; then the
      two MoE smokes (``qwen3-moe-235b-a22b``'s and
      ``llama4-maverick-400b-a17b``'s) at float32, tokens equal and logits
      within 1e-4, the MoE kernel launched twice a layer in every decode
      step and every prefill of at most 16 rows an expert, its plain
      version never; then the two recurrent smokes (``mamba2-1.3b``'s and
      ``recurrentgemma-9b``'s) at float32 (tokens equal, logits within
      1e-4) and bf16 (prefill logits within 5e-2), the flash kernel once per
      attention layer and prefill, the scan kernel once per RG-LRU layer
      and prefill, and ``mamba2-1.3b``'s smoke int8-quantized at float32
      (the W8 kernel on ``w_zx`` and ``w_out``), tokens equal and logits
      within 1e-4; then the smokes of the two families ``ServeSession``
      does not serve (as the reference's does not), ``qwen2-vl-72b``'s
      (M-RoPE ids of text, a 2 x 2 grid and text; embeddings in) and
      ``seamless-m4t-medium``'s (8 encoder frames), driven through
      ``prefill`` and ``make_decode_step`` admission by admission (two
      admissions of 2 rows, 6 new positions each): at float32 every logit
      within 1e-4 and the tokens equal, at bf16 the prefills within 5e-2,
      the flash kernel once per attention layer (the encoder's too) and
      prefill;
   b. the flash-attention kernel against its plain version on the card
      (bf16 within 2^-7 of each value plus 2e-3) at the serving path's
      prefill shape (B 8, S 2,048, 32 query / 8 KV heads, D 128, causal),
      there also its float32 build (within 1e-4), and at a ``gemma3-27b``
      local layer's (32 / 16 heads, window 1,024) and a
      ``recurrentgemma-9b`` local layer's (16 query heads on one KV head, D
      256, window 2,048: ``flash_attention_d256``), a ``qwen2-vl-72b``
      prefill's (64 / 8 heads, S 1,975: ``flash_attention_vlm``), a
      ``seamless-m4t-medium`` encoder's (16 / 16 heads of 64,
      bidirectional, 264 frames: ``flash_attention_encoder``) and its
      decoder prefill's (S 1,975: ``flash_attention_decoder``), timed
      beside its bound and one ``scaled_dot_product_attention`` call (a
      yardstick the port never calls);
   c. the W8 kernel (``csrc/rm_w8.cu``) against its plain version (the
      dequant, then ``torch.matmul``) and against the exact product at a
      qwen3-8b layer's decode launches (M 8; K 4,096: wq, wk, wv as one
      group of N 4,096, 1,024, 1,024, wo of N 4,096, w_gate, w_up as one
      group of N 12,288 each; w_down, K 12,288, N 4,096), bf16 and float32
      (``W8_SUM_RTOL``), each grouped output bit-equal to its product
      launched alone, timed beside its bound, one ``torch.matmul`` of x
      against the weight dequantized beforehand and, where the installed
      torch runs it on the card, ``torch._weight_int8pack_mm`` on a
      transposed copy of the int8 weight (two yardsticks the port never
      calls), all as a decode step runs them: weights cold, launches
      replayed from a CUDA graph; a layer's sum against its bound;
   c2. the MoE kernel (``csrc/rm_moe.cu``) at one ``qwen3-moe-235b-a22b``
      layer's decode step (128 experts of d 4,096 and f 1,536, cap 4, the
      buffer dispatched from 8 tokens routed through a router drawn from
      ``--seed``), bf16 and float32: each of its two stages against the
      exact product of the touched experts and against its plain version
      (``MOE_SUM_RTOL``, carried through ``silu``), rows past each count and
      untouched experts exactly zero, equal on a rerun and in a graph's
      replay; timed beside its bound (the touched experts' bytes), its plain
      version and the dense form's three ``torch.bmm`` (a yardstick the
      port's decode step never calls);
   c3. the RG-LRU scan kernel (``csrc/rm_rglru.cu``) at
      ``recurrentgemma-9b``'s prefill (B 8, S 2,048, W 4,096, float32, ``a``
      in (0, 1)): bit-equal to its plain version (the sequential float32
      loop) and on a rerun, timed beside its bound by bytes (3 · B · S · W ·
      4 B over the memory rate: 0.2404 ms) and its plain version, with its
      launch plan (a warp a block, the ring's stages and fill form); no
      library call computes it (``library_ms`` null);
   d. ``qwen3-8b`` at full width and depth (36 layers, d_model 4,096,
      8,190,735,360 weights in bf16) initialised on the card from
      ``--seed``, a ``ServeSession`` of 8 slots and ``max_len`` 2,112
      serving 16 requests with prompts of 1,024–2,048 tokens and 16 new
      tokens each, its decode steps replayed from a CUDA graph: every
      request gets 16 tokens inside the vocab, every logit row is finite,
      the flash kernel launched once per layer and prefill, and its output
      on the q, k, v of layers 0 and 35 (taken with a forward hook in the
      first prefill) is the path's and matches the plain version as in b;
      one replayed decode step is bit-equal to an eager ``decode_step`` on
      a copy of the same cache; then one more prefill, one replayed and one
      eager decode step are warmed, timed and traced (``torch.profiler``:
      device-busy time, launches, the profiled step's idle share, top
      kernels); then the 16 requests are served once more under
      ``torch.profiler``, to the same tokens, and the kernels the trace
      holds are counted (at least one of each the run ran, and no more:
      a trace of about 100,000 kernels can lose records);
   e. the same model int8-quantized in place (``quantize_for_serving``,
      timed, its peak memory) and the same 16 requests served and checked
      as in d, 252 W8 products (7 of 36 layers) in 144 launches (4 a
      layer: q, k and v one group, gate and up one) by the wrapper in the
      warm-up step and as many recorded by the capture, so 252 × (ticks +
      1) products in 144 × (ticks + 1) launches in the run, 144 W8 kernels
      and no split-K reduction in the trace of a replayed step (taken once
      more if it lost records) with their device time, some in the traced
      serving run, and the dequant's device time in an int8 prefill;
   f. ``qwen3-moe-235b-a22b`` at full width (d_model 4,096, 64 / 4 heads of
      128, qk-norm, 128 experts of 1,536, top-8), its depth cut to 12 of 94
      layers (printed as ``reduced``), initialised on the card from
      ``--seed`` and serving the same 16 requests as in d, checked as there
      (the flash kernel at a GQA group of 16 on layers 0 and 11): 24 MoE
      launches in the warm-up step and 24 recorded by the capture, none
      from the plain version, the MoE kernels in the trace of a replayed
      step with their device time, each layer's touched experts (read back
      from the eager step) and the step's bound by bytes; the serving run's
      peak must leave 4 GiB of the card;
   g. ``mamba2-1.3b`` at full width and depth (48 ``ssd`` layers, d_model
      2,048, 1,446,603,776 weights in bf16; ``lm_serve_ssm``) and
   h. ``recurrentgemma-9b`` at full width and depth (26 ``rglru`` and 12
      ``local`` layers, d_model 4,096, 10,444,877,824 weights, the RG-LRU
      gates float32; ``lm_serve_hybrid``), each serving the same 16
      requests and checked as in d (no flash launch in the SSM; in the
      hybrid the flash kernel on attention layers 2 and 35 and the scan
      kernel on RG-LRU layer 0 against their plain versions, one scan
      launch per RG-LRU layer and prefill, none in a decode step), with
      each step's bound by bytes (every weight but the embedding, the KV
      rings read, the recurrent states read and written), the peak memory
      of a prefill and of the run, and the hybrid's float32 gate products'
      share of its profiled prefill;
   i. ``seamless-m4t-medium`` at full width and depth (12 encoder and 12
      decoder layers, d_model 1,024, 16 / 16 heads of 64; ``lm_serve_encdec``)
      and
   j. ``qwen2-vl-72b`` at full width (d_model 8,192, 64 / 8 heads of 128,
      QKV bias, M-RoPE), its depth cut to 32 of 80 layers (``reduced``;
      ``lm_serve_vlm``), each weights and inputs drawn from ``--seed``,
      served admission by admission through ``prefill`` and a graphed
      ``make_decode_step`` (:func:`drive`): two admissions of 8 requests
      (1,841 and 1,975 positions: the VLM's image-and-text embeddings with
      M-RoPE ids of a 64-token text prefix, a 32 x 32 grid of patches and
      text; the encoder-decoder's 264 frames, ``LM_MAX_LEN // 8``, and
      tokens) of 16 new positions, 30 replayed steps: tokens inside the
      vocab, finite logits, the flash kernel exactly 32 x 2 and (12 + 12)
      x 2 times and none in a step, its output on the first and last
      attention layer against its plain version, a replayed step
      bit-equal to an eager one (the cross K/V included), a profiled
      prefill and replayed and eager step, the prefill's product
      operations and the step's bound by bytes (the decoder's weights,
      ``lm_head``, the KV cache and the cross K/V read); each run's peak
      must leave 4 GiB of the card;
10. the train phase:
   a. the wide projections (rows over 2,048 words): record stores on the card
      of 4,096 samples at S 2,048 and 4,096 (4,101- and 8,197-word rows,
      67 and 134 MB), their ``(tokens, labels)`` view (4,096 and 8,192
      packed words) through ``mlp`` (the span kernel), ``pck`` and
      ``bsl``, and 16 of their tokens through ``mlp``, each one launch,
      bit-equal to the plain version, timed beside its bound by bytes and
      ``index_select``, the host share of each call (``host_ms``: its
      ``kernel_ms`` less its device time) beside the library call's device
      time (``wide_projection`` lines);
   b. the flash gradient (``FlashAttention``: the forward kernel with the
      row lse stored, then one launch of the backward kernel,
      ``rm_flash_bwd.cu``) in all its forms: the tensor cores at a
      qwen3-8b training layer (B 2, S 2,048, 32 / 8 heads, D 128, bf16),
      causal, with a window of 1,024 and bidirectional, and at D 256
      (a warpgroup each for dK and dV) at recurrentgemma-9b's local
      attention (16 / 1 heads, bf16); the CUDA cores in float32 at
      ``train_reference``'s two smokes: the output within
      ``FLASH_TOL``; in bf16 dq, dk and dv no further from the float32
      gradients than ``FLASH_GRAD_BF16_FACTOR`` times the plain bf16
      recompute, within ``FLASH_GRAD_BF16_TOL`` of it and within
      ``FLASH_GRAD_PLAIN_STEPS`` bf16 steps of the kernel's plain version
      (``flash_attention_backward_torch``) on the same output and lse; in
      float32 within ``FLASH_GRAD_F32_TOL`` of both; two backward calls
      bit-equal; the forward's output bit-equal with the lse stored and
      without; the forward's and backward's times (the backward kernel
      alone too, with its device time) beside their bounds, the plain
      versions' and the forward and backward of one
      ``scaled_dot_product_attention`` call under autograd on the same
      inputs, with the backend that ran it (a yardstick the port never
      calls; ``flash_backward`` lines); then the card tests' gradient cases
      in bf16 and float32, checked alike, untimed, with the largest reading
      of each limit (``flash_backward_cases``);
   c. the scan's gradient (``rm_rglru_scan_backward_kernel``) at the
      hybrid's prefill shape (B 8) and at ``train_rg``'s microbatch (B 2):
      one launch of the forward kernel and one of the gradient's under
      autograd, da and dx bit-equal to the plain reverse loop; the
      gradient kernel's time (events and device) beside its bound by bytes
      (a, h and dh read and da and dx written once: 0.4007 / 0.1002 ms),
      and the forward's at B 2 beside its bound (0.0601 ms), bit-equal to
      the plain loop, with its plan (``scan_backward`` lines);
   d. the main path: ``qwen3-8b`` at full width, its depth cut to 8 of 36
      layers (``train_config`` with ``reduced``; 2,788,235,264 weights,
      44.6 GB of float32 masters, gradients and AdamW moments), trained
      from a record store on the card (4,096 samples of 2,048 tokens)
      through ``TrainPipeline(batch_size=8)`` and ``make_train_step`` (4
      microbatches of 2 × 2,048): 1 warm-up and 3 timed steps, each loss
      and ``grad_norm`` finite, the projection kernel twice a batch, the
      flash kernel twice an attending layer and microbatch (the forward and
      the checkpointed group's recompute) and the backward kernel once,
      tokens/s,
      ``train_mfu`` (model operations over the step time at 989 TFLOP/s),
      the update's ms, the peak (4 GiB of the card left), one profiled
      step (device-busy ms, launches, idle share, time by kind, top
      kernels) (``train``);
   e. the sharded step: the same model through the sharding layer in an
      NCCL world of one (``make_mesh((1, 1), ("data", "model"))``, the
      state as ``DTensor``s placed by the mesh's specs,
      ``make_sharded_train_step``) against one unsharded step from the same
      weights and batch — loss, ``grad_norm`` and every parameter and
      moment leaf bit-equal —, the unsharded step's peak split by what holds
      it (the allocator's trace), 3 sharded steps with the projection,
      flash and flash-backward launches counted as in d, their time and
      peak beside d's; ``psum_bf16``, ``psum_int8_ef`` and the exact
      reduction over NCCL bit-equal to gloo on the CPU, and
      ``pipeline_apply`` at one stage against the sequential function
      (``train_sharded``);
   f. the trainer at the qwen3-8b smoke on the card: 6 steps saving every
      3, a fresh state restored bit-equal, the batch stream after the seek
      equal to the unbroken one, 2 more steps (``trainer``);
   g. one float32 train step of the qwen3-8b and recurrentgemma-9b smokes
      card against CPU: losses within 1e-5, ``grad_norm`` within 1e-4
      relative (``train_reference``);
   g2. ``recurrentgemma-9b`` at full width, one (rglru, rglru, local) unit
      of its 38 layers (``train_rg_config`` with ``reduced``; 2,753,646,592
      weights, 44.06 GB of float32 state), trained as d (the same store
      size, batch, microbatches and steps), the vocabulary its own
      256,000: losses finite, the flash kernel twice and its backward —
      the tensor-core form at D 256 — once a local layer and microbatch,
      the scan kernel twice and its gradient's kernel once an RG-LRU layer
      and microbatch, step seconds, tokens/s, ``train_mfu``, the peak, a
      profiled step's flash-backward and scan-backward device ms
      (``train_rg``);
   h. one more step of d under the roofline counter
      (``roofline.analysis.count_step``): counted FLOPs and bytes, the
      three terms at the H100's data-sheet figures, the lower bound beside
      the measured step, ``useful_flops_ratio`` and the counter's overhead
      (``roofline``, printed after ``train``);
   i. decode-SP: ``qwen3-8b`` bf16 at full width and depth, one decode
      step through the sequence-parallel form under a ``(1, 1)`` NCCL mesh
      against the one-device step on a copy of the same prefilled cache:
      logits within 0.1, greedy tokens equal, both steps' ms
      (``decode_sp``);
   j. the MoE block's expert-parallel forms at a world of one, one
      ``qwen3-moe-235b-a22b`` layer at full width, decode- and
      prefill-sized: ``local_gather`` bit-equal to the one-device block,
      ``local_stationary`` bit-equal to its dense form and the MoE kernel
      held to that form on the block's buffer, each call's ms beside its
      ``moe_ffn`` launches (``moe_expert_parallel``);
   k. ``python -m repro_torch.launch.dryrun --arch qwen3-8b --shape
      train_4k --mesh single`` in a subprocess: its terms (counts at the
      data sheet's figures), dominant term and wall seconds (``dryrun``);
11. checks that no engine the script built ever tripped its circuit breaker
    or rerouted a dispatch to a plain version (no fault plan is installed);
12. prints the ``{"kernels": [...]}`` line, then ``{"ok": true, ...}`` last.

Every kernel's ``launches`` is counted on its path alone (counts set to 0
just before the path, read just after): the engine phase for the five scan
kernels, the server phase for the probe, the revision phase for BSL and
PCK, the selection phase for ``project_multi`` and ``select_compact``, the
LM serve phases' runs for ``flash_attention`` (none in the SSM's; the
VLM's and the encoder-decoder's included), the
hybrid serve phase for ``rglru_scan`` and the int8 run for
``w8_matmul`` — its wrapper launches in the warm-up step before the graph's
capture; the graph's replays launch it without the wrapper, and the
line's ``w8_kernels_run`` (launches) and ``w8_products_run`` (products)
add them from the capture's records and the replay count —, the MoE serve
phase for ``moe_ffn`` (its warm-up step's launches; ``moe_kernels_run``
adds the replays'); the sharded
phase's own path (its
sharded engine's and server's runs and the free operators, not the single
engine beside them) adds its launches of the fused scan, the projection,
aggregate and group-by kernels and the probe; the train phase's main path
(d) adds its launches of the projection and flash kernels, and the sharded
step's (e) its launches of those and of ``flash_attention_backward``,
whose only paths they are (its line in ``kernels`` takes its times from
the causal ``flash_backward`` line); ``train_rg`` (g2) adds its launches
of the projection, flash, flash-backward and scan kernels, and is the only
path of ``rglru_scan_backward`` (its line in ``kernels`` takes its times
from the B 8 ``scan_backward`` line).

Every phase prints one JSON line.  Any failure ends the run with a
traceback and a non-zero exit; without a CUDA device, or without the port
beside it (the script alone in a directory), it exits 2 before printing
any result.
"""

from __future__ import annotations

import argparse
import contextlib
import cProfile
import gc
import json
import math
import os
import pstats
import resource
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROWS = 33_554_432  # 2 GiB of 64-byte rows
BUILD_ROWS = 1_048_576  # the dimension table: 18 MiB of hash buckets
STREAM_CHUNK_ROWS = 4_194_304
SECTOR = 32
# per request and row: the predicate and two MVCC compares, an add, a count
OPS_PER_ROW = 5
SUM_RTOL = 1e-5  # |a - b| <= 1e-5 * sum(|v|) over the summed rows

REPLACES = {
    "project": "src/repro/kernels/rme_project.py:47",
    "filter_project": "src/repro/kernels/rme_filter.py:26",
    "aggregate": "src/repro/kernels/rme_aggregate.py:30",
    "groupby_sum": "src/repro/kernels/rme_aggregate.py:120",
    "scan_multi": "src/repro/kernels/rme_scan_multi.py:217",
    "hash_join": "src/repro/kernels/rme_join.py:219",
    "project_pck": "src/repro/kernels/rme_project.py:53",
    "project_bsl": "src/repro/kernels/rme_project.py:68",
    "project_multi": "src/repro/kernels/rme_project_multi.py:36",
    "select_compact": "src/repro/kernels/rme_select.py:35",
    "flash_attention": "src/repro/kernels/flash_attention.py:36",
}
# kernels with no Pallas counterpart: what of the reference each replaces
FUSIONS = {"w8_matmul": "src/repro/models/layers.py:51",
           "moe_ffn": "src/repro/models/layers.py:583",
           "rglru_scan": "src/repro/models/layers.py:1031",
           "rglru_scan_backward": "src/repro/models/layers.py:1031",
           "flash_attention_backward": "src/repro/models/layers.py:292"}
SOURCES = {"hash_join": "src/repro_torch/csrc/rm_join.cu",
           "flash_attention": "src/repro_torch/csrc/rm_flash.cu",
           "flash_attention_backward": "src/repro_torch/csrc/rm_flash_bwd.cu",
           "w8_matmul": "src/repro_torch/csrc/rm_w8.cu",
           "moe_ffn": "src/repro_torch/csrc/rm_moe.cu",
           "rglru_scan": "src/repro_torch/csrc/rm_rglru.cu",
           "rglru_scan_backward": "src/repro_torch/csrc/rm_rglru.cu",
           "project_pck": "src/repro_torch/csrc/rm_project.cu",
           "project_bsl": "src/repro_torch/csrc/rm_project.cu",
           "select_compact": "src/repro_torch/csrc/rm_project.cu"}  # else rm_scan.cu
ENGINE_KERNELS = ("project", "filter_project", "aggregate", "groupby_sum",
                  "scan_multi")
REVISIONS = ("mlp", "bsl", "pck")  # mlp first: the others are held to it
# the revision study's views of S: 1, 4 and 11 columns (the port's cap)
REVISION_VIEWS = {1: ["A1"], 4: ["A1", "A5", "A9", "A13"],
                  11: [f"A{i}" for i in range(1, 12)]}
MULTI_VIEWS = (["A1"], ["A2", "A3"], ["A1", "A5", "A9", "A13"])
# benchmarks/fig_selectivity.py: A1, A9 where A3 > k, A3 uniform in
# [-1000, 1000), 512-row blocks
SELECTIVITIES = ((90, -800), (50, 0), (10, 800), (1, 980))
SELECT_BLOCK_ROWS = 512
# the LM serving path: qwen3-8b, 8 slots of 2,112 positions, prompts of
# 1,024-2,048 tokens, 16 new tokens each
LM_ARCH = "qwen3-8b"
LM_SLOTS = 8
LM_MAX_LEN = 2112
LM_PROMPT = (1024, 2048)
LM_MAX_NEW = 16
LM_REQUESTS = 16
LM_CHECK_LAYERS = (0, 35)
# the card-against-CPU smokes: qwen3-8b's, the two QKV-bias decoders', then
# the two MoE decoders' — at float32 only: at bf16 an MoE decoder's routing
# follows the router's bf16 logits, which the card's and the CPU's other
# roundings upstream can flip from one expert to another
LM_REFERENCE_ARCHS = ("qwen3-8b", "qwen1.5-110b", "internlm2-20b", "qwen3-moe-235b-a22b",
                      "llama4-maverick-400b-a17b", "mamba2-1.3b", "recurrentgemma-9b")
# the two families ServeSession does not serve (as the reference's does
# not), compared card against CPU through prefill and make_decode_step, two
# admissions of 2 rows: the VLM backbone (embeddings in, M-RoPE) and the
# encoder-decoder (FRAMES_SMOKE encoder frames: 64 // 8, the cross length of
# its init_cache, so the second admission's cache is adopted in place)
LM_INPUT_ARCHS = ("qwen2-vl-72b", "seamless-m4t-medium")
SMOKE_PROMPTS = (12, 20)
FRAMES_SMOKE = 8
# the int8 smokes compared card against CPU at float32: the W8 kernel on a
# dense decoder's products and on the SSD's w_zx / w_out
LM_INT8_ARCHS = ("qwen3-8b", "mamba2-1.3b")
LM_MOE_ARCHS = ("qwen3-moe-235b-a22b", "llama4-maverick-400b-a17b")
# the MoE serving cell: qwen3-moe-235b-a22b at full width, its depth cut to
# fit one card (12 of 94 layers: 62.2 GB of bf16 weights), the dense cell's
# traffic; its peak must leave MOE_FREE_BYTES of the card
MOE_ARCH = "qwen3-moe-235b-a22b"
MOE_LAYERS = 12
MOE_FREE_BYTES = 4 << 30
# the MoE kernel phase: one qwen3-moe-235b layer's decode step, E 128 experts
# of d 4,096 and f 1,536 with cap 4 rows (8 tokens, top-8), the counts from
# a routing of 8 tokens through a router drawn from --seed
MOE_SHAPE = {"E": 128, "d": 4096, "f": 1536, "top_k": 8, "tokens": 8}
# the recurrent serving cells, at full width and depth on the dense cell's
# traffic: the SSM (48 ssd layers) and the hybrid (26 rglru + 12 local
# layers, MQA at head_dim 256, window 2,048), whose flash check hooks
# attention layers 2 and 35 and whose scan check hooks RG-LRU layer 0
SSM_ARCH = "mamba2-1.3b"
HYBRID_ARCH = "recurrentgemma-9b"
HYBRID_CHECK_LAYERS = (2, 35)
HYBRID_SCAN_LAYERS = (0,)
# the VLM serving cell: qwen2-vl-72b at full width, its depth cut to fit one
# card (32 of 80 layers: 56.2 GB of bf16 layer weights), two admissions of 8
# image-and-text prompts (a VLM_PREFIX-token text prefix, a VLM_GRID x
# VLM_GRID grid of merged patches, then text) of VLM_PROMPTS positions,
# LM_MAX_NEW new positions each; its peak must leave MOE_FREE_BYTES of the card
VLM_ARCH = "qwen2-vl-72b"
VLM_LAYERS = 32
VLM_PROMPTS = (1841, 1975)
VLM_PREFIX = 64
VLM_GRID = 32
# the encoder-decoder serving cell: seamless-m4t-medium at full width and
# depth, ENCDEC_FRAMES encoder frames a request (LM_MAX_LEN // 8: the cross
# length of its init_cache) and decoder prompts of VLM_PROMPTS tokens
ENCDEC_ARCH = "seamless-m4t-medium"
ENCDEC_FRAMES = LM_MAX_LEN // 8
# the scan kernel phase: recurrentgemma-9b's prefill of the serving cells,
# B 8 slots, S 2,048, W 4,096 lanes; the gradient's also at train_rg's
# microbatch of B 2
RGLRU_SHAPE = (8, 2048, 4096)
RGLRU_TRAIN_SHAPE = (2, 2048, 4096)
# a qwen3-8b layer's decode products at M = 8 rows, as the layer launches
# them: (name, K, N of each record of the launch) — wq, wk, wv one group;
# wo; w_gate, w_up one group; w_down
W8_GROUPS = (("qkv", 4096, (4096, 1024, 1024)), ("wo", 4096, (4096,)),
             ("gate_up", 4096, (12288, 12288)), ("w_down", 12288, (4096,)))
W8_ROWS = LM_SLOTS
# the W8 lines' timing: the copies of a launch's int8 weights launched in
# turn (8: more bytes than the 50 MB L2 for every launch), one graph of them
# replayed W8_GRAPH_REPS times
W8_COPIES = 8
W8_GRAPH_REPS = 20
# (name, B, S, H, KH, D, causal, window): the prefill of a qwen3-8b layer,
# of a gemma3-27b local layer and of a recurrentgemma-9b local layer (MQA:
# 16 query heads on one KV head, D 256) on the path's batch; then the
# qwen2-vl-72b prefill's (64 / 8 heads, the longer admission), the
# seamless-m4t-medium encoder's (16 / 16 heads of 64, bidirectional, 264
# frames: two 128-row query tiles and one of 8) and its decoder prefill's
FLASH_SHAPES = (("flash_attention", 8, 2048, 32, 8, 128, True, None),
                ("flash_attention_window", 8, 2048, 32, 16, 128, True, 1024),
                ("flash_attention_d256", 8, 2048, 16, 1, 256, True, 2048),
                ("flash_attention_vlm", 8, 1975, 64, 8, 128, True, None),
                ("flash_attention_encoder", 8, 264, 16, 16, 64, False, None),
                ("flash_attention_decoder", 8, 1975, 16, 16, 64, True, None))
# the kernel against its plain version, |got - want| <= atol + rtol·|want|:
# bf16 output, one rounding step of the output (2^-7 of its value) plus the
# rounding of p to bf16 before PV, which the two take at other running maxima
# (the bf16 kernel's 128-key tiles against the plain version's 256), on
# outputs near 0; float32 output: summation order alone
FLASH_TOL = {"bfloat16": (2.0 ** -7, 2e-3), "float32": (0.0, 1e-4)}
# the W8 kernel against the exact product of x and the dequantized weight:
# the float32 sum within W8_SUM_RTOL of sum(|x| |w|) (its order), and in bf16
# also half a bf16 step of the value (the output's one rounding); against
# the plain version (cuBLAS, reduced-precision bf16 reductions off) the same
# sum term twice and one whole bf16 step (two roundings)
W8_SUM_RTOL = 1e-5
# the MoE kernel's two products held as the W8 kernel's (moe_limits): each
# float32 sum within MOE_SUM_RTOL of sum(|x| |w|) plus half a step of the
# dtype; silu's slope is at most 1.1 (SILU_SLOPE); against the plain
# version each limit twice
MOE_SUM_RTOL = W8_SUM_RTOL
SILU_SLOPE = 1.1


# the train phase: qwen3-8b at full width, its depth cut to
# TRAIN_LAYERS of 36 (float32 masters, gradients and AdamW moments: 16 B a
# parameter, 44.6 GB at 8 layers), trained from a record store on the card
# of TRAIN_SAMPLES samples of TRAIN_SEQ tokens (synthetic_corpus, seed 1),
# TRAIN_BATCH samples a step in the config's grad_accum (4) microbatches;
# 1 warm-up step and TRAIN_STEPS timed ones; its peak must leave
# MOE_FREE_BYTES of the card
TRAIN_ARCH = "qwen3-8b"
TRAIN_LAYERS = 8
TRAIN_SEQ = 2048
TRAIN_SAMPLES = 4096
TRAIN_BATCH = 8
TRAIN_STEPS = 3
TRAIN_OPT = {"lr": 1e-3, "warmup_steps": 2, "decay_steps": 4}
# train_rg: recurrentgemma-9b at full width, one (rglru, rglru, local) unit
# of its 38 layers (2,753,646,592 weights, 44.06 GB of float32 state, as
# qwen3-8b's 8 layers hold 44.61 GB), the same store size, batch and steps:
# its local layer's gradient is the flash backward at D 256
TRAIN_RG_ARCH = "recurrentgemma-9b"
TRAIN_RG_LAYERS = 3
# the wide projections of fault 3.2: record stores of TRAIN_SAMPLES samples
# at these lengths (4,101- and 8,197-word rows), their (tokens, labels) view
WIDE_SEQS = (2048, 4096)
WIDE_NARROW = 16  # packed words of the narrow view: the first 16 tokens
# calls a wide line's kernel_ms and library_ms are the medians of (at least):
# a call's host share varies by some 10 µs from call to call, as much as
# the span kernel's lead over index_select at S 2,048
WIDE_REPS = 50
# the flash backward at a qwen3-8b training layer (B 2, S 2,048, 32 / 8
# heads, D 128, bf16: the tensor-core form): causal, a window of 1,024 and
# bidirectional; the tensor-core form's D 256 (a warpgroup each for dK and
# dV) at recurrentgemma-9b's local attention at a train S (16 / 1 heads,
# its window of 2,048, bf16: what train_rg launches); the CUDA-core form in
# float32 at train_reference's microbatches of the two smokes (2 × 128
# tokens: qwen3-8b's 6 / 2 heads, D 16; recurrentgemma's 4 / 1, D 16, its
# window of 32); the plain versions walk the keys in steps of
# TRAIN_ATTN_CHUNK
FLASH_BACKWARD_SHAPES = (
    ("flash_backward", 2, 2048, 32, 8, 128, True, None, "bfloat16"),
    ("flash_backward_window", 2, 2048, 32, 8, 128, True, 1024, "bfloat16"),
    ("flash_backward_bidirectional", 2, 2048, 32, 8, 128, False, None, "bfloat16"),
    ("flash_backward_d256", 2, 2048, 16, 1, 256, True, 2048, "bfloat16"),
    ("flash_backward_f32", 2, 128, 6, 2, 16, True, None, "float32"),
    ("flash_backward_f32_window", 2, 128, 4, 1, 16, True, 32, "float32"))
# the card tests' FLASH_GRAD_CASES (tests/test_torch_cuda.py), each in bf16
# and float32, (B, S, H, KH, D, causal, window): every form, GQA groups 2,
# 4, 8 and 16, ragged S, windows, bidirectional; the readings only, untimed
FLASH_BACKWARD_CASES = ((2, 256, 8, 2, 64, True, None), (1, 200, 16, 1, 128, True, None),
                        (2, 256, 32, 8, 128, True, 100), (1, 192, 4, 1, 256, False, None),
                        (1, 130, 64, 4, 128, False, 48), (2, 1024, 16, 1, 256, True, 700),
                        (1, 333, 4, 2, 256, True, None), (2, 300, 8, 1, 256, False, 100),
                        (2, 256, 8, 2, 32, True, None), (1, 150, 4, 4, 16, False, 40))
TRAIN_ATTN_CHUNK = 1024
# the backward kernel's dq, dk and dv (errors as shares of each gradient's
# largest magnitude).  bf16: the kernel rounds P and dS to bf16 before their
# products and the plain bf16 recompute (autograd of flash_attention_torch)
# rounds P and the gradients of its casts elsewhere, so neither is exact:
# the kernel's distance from the float32 gradients (the plain version on the
# inputs widened) at most FLASH_GRAD_BF16_FACTOR times the recompute's, and
# the kernel within FLASH_GRAD_BF16_TOL of the recompute (2^-6: 4 steps of
# bf16 at the largest value).  float32: within FLASH_GRAD_F32_TOL of the
# recompute (summation order).  Against the kernel's plain version
# (flash_attention_backward_torch on the same out and lse), the same
# arithmetic: float32 within FLASH_GRAD_F32_TOL (summation order); bf16
# within FLASH_GRAD_PLAIN_STEPS steps of bf16 at the gradient's largest
# value (bf16_step): the two sum in float32 in other orders, and a P or dS
# may round to the neighbouring bf16 value (the kernel's exp2 against the
# plain exp), so their float32 sums differ by far less than a step, yet
# each is rounded once to bf16 and that can put an element one step of its
# own (at most one at the largest value) from the other's
FLASH_GRAD_BF16_FACTOR = 2.0
FLASH_GRAD_BF16_TOL = 2.0 ** -6
FLASH_GRAD_F32_TOL = 1e-5
FLASH_GRAD_PLAIN_STEPS = 2
# card against CPU, one float32 train step of each smoke: the loss within
# TRAIN_LOSS_TOL, grad_norm within TRAIN_GNORM_RTOL relative
TRAIN_REFERENCE_ARCHS = ("qwen3-8b", "recurrentgemma-9b")
# decode-SP: qwen3-8b bf16 (36 layers), SP_BATCH prompts of SP_PROMPT
# tokens in a cache of SP_MAX_LEN slots, one step; its logits against the
# one-device step's within SP_LOGIT_TOL (the bf16 decode logits' tolerance
# of tests/test_torch_lm.py).  The SP form attends over its chunk as the
# one-device form does (layers._decode_attend) and weighs it by l / l = 1
# at one sequence rank, where no collective is called, so the logits are
# expected bit-equal (printed)
SP_BATCH = 4
SP_PROMPT = 1024
SP_MAX_LEN = 2048
SP_LOGIT_TOL = 1e-1
SP_REPS = 5
TRAIN_LOSS_TOL = 1e-5
TRAIN_GNORM_RTOL = 1e-4


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=ROWS)
    ap.add_argument("--build-rows", type=int, default=BUILD_ROWS)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=10)
    return ap.parse_args(argv)


# ------------------------------------------------------------------ timing
def time_ms(torch, fn, reps: int) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(torch, fn, reps: int) -> tuple[float | None, list, float | None]:
    """Device time per call of ``fn`` without its host work: the kernels it
    launches (one stream, so they do not overlap), from ``torch.profiler``
    over ``reps`` calls after a warm-up; ``[kernel, ms per call, launches
    per call]`` for each; and an estimate.  Each trace first runs ``reps``
    calls in the profiler's warm-up step, whose events it drops: late in
    this script, traces without one kept only some calls' kernels of SDPA's
    backward (run by autograd), where a fresh process kept all.  A trace
    that holds no device time, or lost launches (a kernel counted other
    than a multiple of ``reps`` times), is taken again, three traces in
    all; if the last loses launches too, the time is ``None`` and the
    estimate is each kernel's mean time a launch times its traced launches
    a call, rounded (at least one) — which misses a kernel whose launches
    were all lost.  The estimate is ``None`` where the time was measured."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        traced: list = []
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                     on_trace_ready=lambda p: traced.append(p.key_averages())) as prof:
            for _ in range(2):  # the warm-up step, then the traced one
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        kernels = [e for e in (traced[0] if traced else [])
                   if getattr(e, "device_type", None) == DeviceType.CUDA and dev_us(e) > 0]
        split = [[e.key[:60], dev_us(e) / 1e3 / reps, e.count / reps] for e in kernels]
        if kernels and not any(e.count % reps for e in kernels):
            return sum(dev_us(e) for e in kernels) / 1e3 / reps, split, None
    if not kernels:
        return None, split, None
    per_call = [dev_us(e) / e.count * max(1, round(e.count / reps)) for e in kernels]
    return None, split, sum(per_call) / 1e3


def device_fields(torch, fn, reps: int, prefix: str = "") -> dict:
    """A kernel line's ``device_ms``, ``device_ms_estimated`` and split,
    ``device_kernels`` (each key after ``prefix``)."""
    ms, split, estimate = device_ms(torch, fn, reps)
    return {f"{prefix}device_ms": ms, f"{prefix}device_ms_estimated": estimate,
            f"{prefix}device_kernels": split}


_SIDE_STREAM: list = []  # graph_ms's one side stream, made at its first call


def graph_ms(torch, fns, reps: int) -> float:
    """Milliseconds a launch of ``fns`` (a list of calls): run once on a side
    stream, captured in one CUDA graph on that stream, and ``reps`` replays
    of it timed by CUDA events, over the calls.  Every call uses the same
    side stream: cuBLAS keeps a workspace allocated for each stream it ran
    on, which a new stream a call would add to the memory in use."""
    if not _SIDE_STREAM:
        _SIDE_STREAM.append(torch.cuda.Stream())
    side = _SIDE_STREAM[0]
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up outside the capture
        for fn in fns:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for fn in fns:
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / reps / len(fns)


def sector_bytes(words: set[int], rows: int, row_bytes: int) -> int:
    """Bytes of the distinct 32-byte sectors holding ``words`` of every row
    (the buffer starts sector-aligned).  The pattern repeats every
    ``SECTOR / gcd(row_bytes, SECTOR)`` rows, each period sector-aligned."""
    period = SECTOR // math.gcd(row_bytes, SECTOR)

    def count(n: int) -> int:
        return len({(r * row_bytes + 4 * w) // SECTOR for r in range(n) for w in words})

    full, rem = divmod(rows, period)
    return (full * count(period) + count(rem)) * SECTOR


def hw():
    """The card's data-sheet figures (memory rate, float32 rate outside the
    tensor cores, dense bf16 tensor-core rate): the port's
    ``roofline.analysis.HW``, on the path once :func:`main` has found it."""
    from repro_torch.roofline.analysis import HW

    return HW


def bound(read_words: set[int], out_bytes: int, rows: int, row_bytes: int,
          ops_per_row: int) -> tuple[float, str]:
    """The least time of the work on the card, in ms, and what bounds it."""
    t_bytes = (sector_bytes(read_words, rows, row_bytes) + out_bytes) / hw().hbm_bw
    t_ops = rows * ops_per_row / hw().fp32_flops
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


# ------------------------------------------------------------ comparisons
def sum_err(torch, got, want, absval) -> float:
    """|got - want|, asserted within SUM_RTOL * absval."""
    err = (got.double() - want.double()).abs()
    assert torch.all(err <= SUM_RTOL * absval.double() + 1e-3), (got, want, absval)
    return float(err.max())


def compare(torch, kind: str, got, want, words, req) -> float:
    """Hold a kernel result against the plain version's; returns max |diff|."""
    if kind in ("project",):
        assert torch.equal(got, want)
        return 0.0
    if kind == "filter":
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        return 0.0
    from repro_torch.kernels import common

    mask = common.row_mask(words, req.pred_word, req.pred_dtype, req.pred_op,
                           common.pred_k_bits(req.pred_k, req.pred_dtype),
                           req.ts_word, req.ts)
    absvals = common.masked_values(words[:, req.agg_word], req.agg_dtype, mask).abs()
    if kind == "aggregate":
        assert got[1].item() == want[1].item(), (got, want)
        return sum_err(torch, got[0], want[0], absvals.sum())
    assert torch.equal(got[1], want[1]), (got[1], want[1])
    g = common.group_ids(words[:, req.group_word], req.num_groups).long()
    per_group = torch.zeros(req.num_groups, dtype=torch.float64, device=words.device)
    per_group.index_add_(0, g, absvals.double())
    return sum_err(torch, got[0], want[0], per_group)


def count_ok(got: float, true: int, chunks: int = 1) -> bool:
    """A float32 count against the exact one.  Counts travel as float32 (the
    reference's ``[sum, count]`` contract): above 2^24 each chunk's count is
    rounded once and each cross-chunk add once more, half an ulp each."""
    return abs(float(got) - true) <= (2 * chunks - 1) * 2.0 ** -24 * true


def kind_of(req, KR) -> str:
    return {KR.ProjectRequest: "project", KR.FilterRequest: "filter",
            KR.AggregateRequest: "aggregate", KR.GroupByRequest: "groupby"}[type(req)]


# ------------------------------------------------------------------ phases
def card(torch) -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    info = {"phase": "card", "nvidia_smi": smi,
            "name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
            "torch": torch.__version__, "cuda": torch.version.cuda}
    emit(info)
    return info


def build_table(rows: int, seed: int, build_rows: int):
    """The fact table S: columns uniform in [-1000, 1000), the join key A2
    uniform in [0, 2 * build_rows) so about half the rows match R."""
    from repro_torch.core import RelationalTable, benchmark_schema

    schema = benchmark_schema(64, 4)
    rng = np.random.default_rng(seed)
    cols = {c.name: rng.integers(-1000, 1000, rows, dtype=np.int32)
            for c in schema.columns}
    cols["A2"] = rng.integers(0, 2 * build_rows, rows, dtype=np.int32)
    return RelationalTable.from_columns(schema, cols)


def build_dimension(rows: int, seed: int):
    """The dimension table R: primary key A2 = arange(rows), the other
    columns uniform in [-1000, 1000)."""
    from repro_torch.core import RelationalTable, benchmark_schema

    schema = benchmark_schema(64, 4)
    rng = np.random.default_rng(seed + 7)
    cols = {c.name: rng.integers(-1000, 1000, rows, dtype=np.int32)
            for c in schema.columns}
    cols["A2"] = np.arange(rows, dtype=np.int32)
    return RelationalTable.from_columns(schema, cols)


def path_requests(table, ts: int | None):
    """The kernel requests the engine's batches lower to."""
    from repro_torch.core import AggregateOp, GroupByOp, RelationalMemoryEngine
    from repro_torch.core.requests import FilterOp, ProjectOp

    eng = RelationalMemoryEngine(device="cpu")  # only to register views
    return {
        "project": ProjectOp(eng.register(table, ["A1", "A5", "A9", "A13"])).lower(),
        "filter": FilterOp(eng.register(table, ["A2", "A3"]), "A4", "gt", 0,
                           ts).lower(),
        "aggregate": AggregateOp(table, "A6", "A7", "lt", 100, ts).lower(),
        "groupby": GroupByOp(table, "A16", "A8", 16, snapshot_ts=ts).lower(),
        "aggregate2": AggregateOp(table, "A9", "A10", "gt", -500, ts).lower(),
    }


def kernels_phase(torch, table, dim, reps: int) -> dict:
    """Each kernel against its plain version at the path's shapes."""
    from repro_torch.kernels import ops as K
    from repro_torch.kernels import rme_scan_multi as KR
    from repro_torch.kernels.common import geometry_words

    words = torch.from_numpy(table.words()).cuda()
    n, row_words = words.shape
    row_bytes = row_words * 4
    reqs = path_requests(table, table.now())
    p, f, a, g = reqs["project"], reqs["filter"], reqs["aggregate"], reqs["groupby"]
    fused = [p, f, a, g, reqs["aggregate2"]]

    def solo(name, req):
        if name == "project":
            return lambda w: K.project(w, req.geom), lambda w: K.project_torch(w, req.geom)
        if name == "filter_project":
            kw = dict(pred_word=req.pred_word, pred_dtype=req.pred_dtype,
                      pred_op=req.pred_op, pred_k=req.pred_k, ts=req.ts,
                      ts_word=req.ts_word)
            return (lambda w: K.filter_project(w, req.geom, **kw),
                    lambda w: K.filter_project_torch(w, req.geom, **kw))
        kw = dict(agg_word=req.agg_word, agg_dtype=req.agg_dtype,
                  pred_word=req.pred_word, pred_dtype=req.pred_dtype,
                  pred_op=req.pred_op, pred_k=req.pred_k, ts=req.ts,
                  ts_word=req.ts_word)
        if name == "aggregate":
            return lambda w: K.aggregate(w, **kw), lambda w: K.aggregate_torch(w, **kw)
        kw.update(group_word=req.group_word, num_groups=req.num_groups)
        return lambda w: K.groupby_sum(w, **kw), lambda w: K.groupby_sum_torch(w, **kw)

    def touched(req) -> set[int]:
        return {o // 4 + j for o, w in KR.request_intervals(req) for j in range(w // 4)}

    def out_bytes(req) -> int:
        if isinstance(req, KR.ProjectRequest):
            return n * req.geom.out_bytes_per_row
        if isinstance(req, KR.FilterRequest):
            return n * (req.geom.out_bytes_per_row + 1)
        return KR.reduced_result_bytes(req)

    # library yardsticks: one PyTorch call each, on inputs prepared beforehand
    idx = torch.tensor(geometry_words(p.geom), dtype=torch.long, device="cuda")
    from repro_torch.kernels import common
    a_vals = common.masked_values(
        words[:, a.agg_word], a.agg_dtype,
        common.row_mask(words, a.pred_word, a.pred_dtype, a.pred_op,
                        common.pred_k_bits(a.pred_k, a.pred_dtype), a.ts_word, a.ts))
    g_ids = common.group_ids(words[:, g.group_word], g.num_groups).long()
    g_vals = common.masked_values(
        words[:, g.agg_word], g.agg_dtype,
        common.row_mask(words, g.pred_word, g.pred_dtype, g.pred_op,
                        common.pred_k_bits(g.pred_k, g.pred_dtype), g.ts_word, g.ts))
    library = {
        "project": lambda: torch.index_select(words, 1, idx),
        "aggregate": lambda: torch.sum(a_vals),
        "groupby_sum": lambda: torch.zeros(g.num_groups, device="cuda").index_add_(
            0, g_ids, g_vals),
    }

    results = {}
    cases = [("project", p), ("filter_project", f), ("aggregate", a),
             ("groupby_sum", g), ("scan_multi", fused)]
    for name, req in cases:
        if name == "scan_multi":
            run = lambda w: K.scan_multi(w, fused)  # noqa: E731
            plain = lambda w: K.scan_multi_torch(w, fused)  # noqa: E731
            got, want = run(words), plain(words)
            torch.cuda.synchronize()
            err = max(compare(torch, kind_of(r, KR), x, y, words, r)
                      for r, x, y in zip(fused, got, want))
            read = set().union(*(touched(r) for r in fused))
            outb = sum(out_bytes(r) for r in fused)
            ops = OPS_PER_ROW * len(fused)
        else:
            run, plain = solo(name, req)
            got, want = run(words), plain(words)
            torch.cuda.synchronize()
            err = compare(torch, kind_of(req, KR), got, want, words, req)
            read, outb, ops = touched(req), out_bytes(req), OPS_PER_ROW
        bound_ms, bound_by = bound(read, outb, n, row_bytes, ops)
        line = {
            "phase": "kernel", "name": name,
            "kernel_ms": time_ms(torch, lambda: run(words), reps),
            **device_fields(torch, lambda: run(words), reps),
            "plain_ms": time_ms(torch, lambda: plain(words), max(3, reps // 3)),
            "library_ms": (time_ms(torch, library[name], reps)
                           if name in library else None),
            **(device_fields(torch, library[name], reps, "library_")
               if name in library else {"library_device_ms": None}),
            "bound_ms": bound_ms, "bound_by": bound_by, "max_abs_err": err,
            "rows": n, "row_bytes": row_bytes,
        }
        emit(line)
        results[name] = line
    results.update(join_kernel_phase(torch, words, dim, table.now(), reps))
    results.update(slice3_kernel_phase(torch, words, table, p, reps))
    del words
    torch.cuda.empty_cache()
    return results


def slice3_kernel_phase(torch, words, table, p, reps: int) -> dict:
    """The BSL and PCK projections at the path's projection, the multi-view
    projection of three views, and the selection at four selectivities,
    each against its plain version."""
    from repro_torch.core import TableGeometry
    from repro_torch.kernels import ops as K
    from repro_torch.kernels.common import geometry_words

    n, row_words = words.shape
    row_bytes = row_words * 4
    idx = torch.tensor(geometry_words(p.geom), dtype=torch.long, device="cuda")
    proj_words = set(geometry_words(p.geom))
    out = {}

    def line(name, run, plain, same, read, outb, library, **extra):
        got, want = run(), plain()
        torch.cuda.synchronize()
        assert same(got, want), name
        del got, want
        bound_ms, bound_by = bound(read, outb, n, row_bytes, OPS_PER_ROW)
        row = {"phase": "kernel", "name": name,
               "kernel_ms": time_ms(torch, run, reps),
               **device_fields(torch, run, reps),
               "plain_ms": time_ms(torch, plain, max(3, reps // 3)),
               "library_ms": time_ms(torch, library, reps) if library else None,
               **(device_fields(torch, library, reps, "library_")
                  if library else {"library_device_ms": None}),
               "bound_ms": bound_ms, "bound_by": bound_by, "max_abs_err": 0.0,
               "rows": n, "row_bytes": row_bytes, **extra}
        emit(row)
        return row

    for rev in ("bsl", "pck"):
        out[f"project_{rev}"] = line(
            f"project_{rev}", lambda: K.project(words, p.geom, rev),
            lambda: K.project_torch(words, p.geom), torch.equal, proj_words,
            n * p.geom.out_bytes_per_row, lambda: torch.index_select(words, 1, idx))
    geoms = [TableGeometry.from_schema(table.schema, v, n) for v in MULTI_VIEWS]
    out["project_multi"] = line(
        "project_multi", lambda: K.project_multi(words, geoms),
        lambda: K.project_multi_torch(words, geoms),
        lambda a, b: all(torch.equal(x, y) for x, y in zip(a, b)),
        {w for g in geoms for w in geometry_words(g)},
        n * sum(g.out_bytes_per_row for g in geoms), None,
        library_call="none: no one call writes several packed views")
    sel = TableGeometry.from_schema(table.schema, ["A1", "A9"], n)
    n_blocks = -(-n // SELECT_BLOCK_ROWS)
    for pct, k in SELECTIVITIES:
        kw = dict(pred_word=table.schema.word_offset("A3"), pred_op="gt", pred_k=k,
                  block_rows=SELECT_BLOCK_ROWS)
        counts = K.select_compact(words, sel, **kw)[1]
        kept = int(counts.sum())
        del counts
        row = line(
            "select_compact", lambda: K.select_compact(words, sel, **kw),
            lambda: K.select_compact_torch(words, sel, **kw),
            lambda a, b: torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]),
            set(geometry_words(sel)) | {kw["pred_word"]},
            n_blocks * (SELECT_BLOCK_ROWS * sel.out_bytes_per_row + 4), None,
            selectivity_pct=pct, pred_k=k, kept_rows=kept,
            library_call="none: no one call compacts per block")
        if pct == 50:
            out["select_compact"] = row
    return out


def join_bound(torch, words, parts, key_word, val_word, ts_word,
               build_ts, key_matches: int) -> tuple[float, str]:
    """The probe's least time: the sectors of the key, payload and (when
    tested) timestamp words of every row, each bucket array once, 9 output
    bytes a row; operations: the hash (2), the C key compares and the probe
    row's two MVCC compares a row, and per key match the build row's two
    MVCC compares and an add."""
    n, row_words = words.shape
    read = {key_word, val_word} | ({ts_word, ts_word + 1} if ts_word >= 0 else set())
    t_bytes = (sector_bytes(read, n, row_words * 4) + parts.nbytes + 9 * n) / hw().hbm_bw
    ops = n * (2 + parts.capacity + (2 if ts_word >= 0 else 0))
    ops += key_matches * (3 if build_ts else 1)
    t_ops = ops / hw().fp32_flops
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def join_kernel_phase(torch, words, dim, ts: int, reps: int) -> dict:
    """The hash-join probe against its plain version in both forms the
    server path gives it: the row store (S's words, snapshot tests on both
    sides) and a packed {A1, A2} block (the shared scan's output)."""
    from repro_torch.kernels import ops as K

    dw = dim.words()
    parts = K.build_partitions(dw[:, 1], dw[:, 2], dw[:, dim.ts_begin_word],
                               dw[:, dim.ts_end_word], device="cuda")
    sorted_keys = torch.sort(torch.from_numpy(dw[:, 1].copy()).cuda()).values
    packed = words[:, :2].contiguous()
    out = {}
    forms = [("hash_join", words, 1, 0, 16, True),
             ("hash_join_packed", packed, 1, 0, -1, True)]
    for name, w, key_word, val_word, ts_word, build_ts in forms:
        args = (key_word, val_word, ts_word, ts, build_ts)
        got = K.hash_join(w, parts, *args)
        want = K.hash_join_torch(w, parts, *args)
        torch.cuda.synchronize()
        for g, x in zip(got, want):
            assert g.dtype == x.dtype and torch.equal(g, x), name
        err = max(float((g.long() - x.long()).abs().max()) if g.numel() else 0.0
                  for g, x in zip(got[:2], want[:2]))
        probe_keys = w[:, key_word].contiguous()  # prepared beforehand
        pos = torch.searchsorted(sorted_keys, probe_keys).clamp_(0, sorted_keys.numel() - 1)
        key_matches = int((sorted_keys[pos] == probe_keys).sum())
        del got, want, pos
        bound_ms, bound_by = join_bound(torch, w, parts, key_word, val_word,
                                        ts_word, build_ts, key_matches)
        line = {
            "phase": "kernel", "name": name,
            "kernel_ms": time_ms(torch, lambda: K.hash_join(w, parts, *args), reps),
            **device_fields(torch, lambda: K.hash_join(w, parts, *args), reps),
            "plain_ms": time_ms(torch, lambda: K.hash_join_torch(w, parts, *args),
                                max(3, reps // 3)),
            # the sort-probe route's one call: a binary search of the probe
            # keys in the sorted build keys — less work than the probe (no
            # payload, no MVCC tests, no match mask)
            "library_ms": time_ms(torch, lambda: torch.searchsorted(sorted_keys, probe_keys),
                                  reps),
            **device_fields(torch, lambda: torch.searchsorted(sorted_keys, probe_keys),
                            reps, "library_"),
            "library_call": "torch.searchsorted (does less work)",
            "bound_ms": bound_ms, "bound_by": bound_by, "max_abs_err": err,
            "rows": w.shape[0], "row_bytes": w.shape[1] * 4,
            "buckets": parts.num_buckets, "capacity": parts.capacity,
            "bucket_bytes": parts.nbytes, "key_matches": key_matches,
        }
        emit(line)
        out[name] = line
    del packed
    return out


def revision_phase(torch, table, reps: int, breakers: list) -> dict:
    """The paper's Fig. 6 study on the card: a solo projection of S for 1, 4
    and 11 columns through an engine of each revision.  The ``mlp`` result
    is held against numpy and the others against it on the card; each
    revision's kernel must have launched.  Then each is timed: the engine
    call (CUDA events around ``execute_many``, host work included) and the
    kernel alone."""
    from repro_torch.core import ProjectOp, RelationalMemoryEngine
    from repro_torch.kernels import _cuda
    from repro_torch.kernels import ops as K

    w = table.words()
    want: dict = {}
    ops: dict = {}
    _cuda.reset_launches()
    for rev in REVISIONS:
        eng = RelationalMemoryEngine(revision=rev)  # on the card
        breakers.append(eng.breaker)
        for q, cols in REVISION_VIEWS.items():
            op = ProjectOp(eng.register(table, cols))
            got = eng.execute_many([op])[0]
            if rev == "mlp":
                idx = [table.schema.word_offset(c) for c in cols]
                assert np.array_equal(got.cpu().numpy(), w[:, idx]), (rev, q)
                want[q] = got
            else:
                assert torch.equal(got, want[q]), (rev, q)
            ops[rev, q] = (eng, op)
    torch.cuda.synchronize()
    launches = {k: _cuda.LAUNCHES[k] for k in ("project", "project_bsl", "project_pck")}
    assert launches == {"project": 3, "project_bsl": 3, "project_pck": 3}, launches
    del want
    table_ms = []
    for (rev, q), (eng, op) in ops.items():
        words = eng.device_words(table)
        geom = op.view.geometry
        table_ms.append({
            "revision": rev, "q": q,
            "engine_ms": time_ms(torch, lambda: eng.execute_many([op]), reps),
            "kernel_ms": time_ms(torch, lambda: K.project(words, geom, rev), reps),
        })
    out = {"phase": "revisions", "rows": table.row_count, "launches": launches,
           "fig6": table_ms}
    emit(out)
    del ops
    gc.collect()
    torch.cuda.empty_cache()
    return out


def selection_phase(torch, table, breakers: list) -> dict:
    """The selection entry points on S's device words: three views in one
    ``project_multi`` pass, then ``select_compact`` and ``densify`` at the
    four selectivities — every result against numpy."""
    from repro_torch.core import RelationalMemoryEngine, TableGeometry
    from repro_torch.kernels import _cuda
    from repro_torch.kernels import ops as K

    eng = RelationalMemoryEngine()  # on the card
    breakers.append(eng.breaker)
    words = eng.device_words(table)
    w = table.words()
    n = table.row_count
    word = table.schema.word_offset
    _cuda.reset_launches()
    geoms = [TableGeometry.from_schema(table.schema, v, n) for v in MULTI_VIEWS]
    for v, got in zip(MULTI_VIEWS, K.project_multi(words, geoms)):
        assert np.array_equal(got.cpu().numpy(), w[:, [word(c) for c in v]]), v
    sel = TableGeometry.from_schema(table.schema, ["A1", "A9"], n)
    kept = {}
    for pct, k in SELECTIVITIES:
        blocks, counts = K.select_compact(words, sel, pred_word=word("A3"),
                                          pred_op="gt", pred_k=k,
                                          block_rows=SELECT_BLOCK_ROWS)
        m = w[:, word("A3")] > k
        want_counts = np.add.reduceat(m, np.arange(0, n, SELECT_BLOCK_ROWS))
        assert np.array_equal(counts.cpu().numpy(), want_counts), pct
        dense = K.densify(blocks, counts, int(m.sum()))
        assert np.array_equal(dense.cpu().numpy(), w[m][:, [word("A1"), word("A9")]]), pct
        kept[pct] = int(m.sum())
        del blocks, counts, dense
    torch.cuda.synchronize()
    launches = {k: _cuda.LAUNCHES[k] for k in ("project_multi", "select_compact")}
    assert launches == {"project_multi": 1, "select_compact": len(SELECTIVITIES)}, launches
    out = {"phase": "selection", "rows": n, "launches": launches,
           "kept_rows": kept}
    emit(out)
    del words
    return out


# --------------------------------------------------------------- LM phases
def lm_prompts(rng, n: int, lo: int, hi: int, vocab: int) -> list:
    return [rng.integers(0, vocab, int(n_tok)).astype(np.int32)
            for n_tok in rng.integers(lo, hi + 1, n)]


def host_usage() -> dict:
    """This process's host counters (all its threads): CPU seconds in user
    and kernel mode, the times a thread gave up its core to wait, and page
    faults; the calling thread's own kernel-mode seconds; and the caching
    allocator's counters on the card: device allocations and frees
    (``cudaMalloc`` / ``cudaFree``, each a call into the driver) and the
    allocations it retried after freeing its cache."""
    import torch

    r = resource.getrusage(resource.RUSAGE_SELF)
    me = resource.getrusage(resource.RUSAGE_THREAD)
    mem = torch.cuda.memory_stats()
    return {"user_s": r.ru_utime, "sys_s": r.ru_stime, "voluntary_switches": r.ru_nvcsw,
            "minor_faults": r.ru_minflt, "calling_thread_sys_s": me.ru_stime,
            "device_allocs": mem.get("num_device_alloc", 0),
            "device_frees": mem.get("num_device_free", 0),
            "alloc_retries": mem.get("num_alloc_retries", 0)}


def recorded(torch, fn, log: list, sync: bool, usage: list):
    """``fn`` (a session's prefill or decode step) timed on the host clock,
    synced on both sides when ``sync``; appends ``(seconds, logits)`` to
    ``log`` and, to ``usage``, what :func:`host_usage` counted in the call
    (a wall time far above its CPU seconds waited: on the device, a lock or
    the scheduler)."""
    def run(*args):
        if sync:
            torch.cuda.synchronize()
        before = host_usage()
        t0 = time.perf_counter()
        logits, cache = fn(*args)
        if sync:
            torch.cuda.synchronize()
        log.append((time.perf_counter() - t0, logits))
        usage.append({k: v - before[k] for k, v in host_usage().items()})
        return logits, cache
    return run


def serve_session(torch, model, prompts, slots: int, max_len: int, max_new: int,
                  sync: bool):
    """Serve ``prompts`` on a fresh session; returns the requests, the
    recorded prefills and decode steps, the session's decode step, and the
    host counters of each prefill and of the first decode step."""
    from repro_torch.serve import Request, ServeSession

    sess = ServeSession(model, batch_slots=slots, max_len=max_len)
    prefills, decodes, usage = [], [], {"prefills": [], "ticks": []}
    step = sess.decode_fn
    sess.prefill_fn = recorded(torch, sess.prefill_fn, prefills, sync, usage["prefills"])
    sess.decode_fn = recorded(torch, sess.decode_fn, decodes, sync, usage["ticks"])
    reqs = [Request(rid=i, prompt=p, max_new=max_new) for i, p in enumerate(prompts)]
    for r in reqs:
        sess.submit(r)
    sess.run_to_completion()
    usage["first_tick"] = usage.pop("ticks")[0]
    return reqs, prefills, decodes, step, usage


@contextlib.contextmanager
def counted_plain_moe():
    """Count the calls of the MoE kernel's plain version inside the block:
    yields a one-element list that holds the count when the block ends."""
    from repro_torch.kernels import moe_ffn as MF

    calls = [0]
    real = MF.moe_ffn_torch

    def plain(*args):
        calls[0] += 1
        return real(*args)

    MF.moe_ffn_torch = plain
    try:
        yield calls
    finally:
        MF.moe_ffn_torch = real


def w8_per_step(model) -> tuple[int, int]:
    """The W8 kernel's launches and products in one decode step of
    ``model`` int8-quantized, at bf16 (a group of int8 products that share x
    is one launch: q, k and v; a gated FFN's gate and up): an attention
    layer's wq, wk, wv and wo, an SSD's w_zx and w_out, an RG-LRU's w_branch
    and w_out, then the FFN's (an MoE layer's experts stay bf16).  At
    float32 each product is a launch of its own."""
    launches = products = 0
    for layer in model.layers:
        groups = [1, 1] if layer.kind in ("ssd", "rglru") else [3, 1]
        if layer.kind not in ("ssd", "moe"):
            groups += [2, 1] if layer.mlp_kind in ("swiglu", "geglu") else [1, 1]
        launches += len(groups)
        products += sum(groups)
    return launches, products


def layer_counts(model) -> tuple[int, int]:
    """The flash kernel's layers (attention: ``attn``, ``local``, ``moe``)
    and the scan kernel's (``rglru``) in ``model``."""
    kinds = [layer.kind for layer in model.layers]
    return sum(k not in ("ssd", "rglru") for k in kinds), kinds.count("rglru")


def lm_reference_phase(torch, seed: int) -> dict:
    """Each smoke of ``LM_REFERENCE_ARCHS`` served on the card (graphed
    decode steps) and on the CPU (eager) with the same weights: float32
    compute token lists equal and logits within 1e-4; bfloat16 compute
    prefill logits within 5e-2 (the MoE decoders at float32 only).  Then
    the smokes of ``LM_INT8_ARCHS`` int8-quantized at float32 compute (the
    W8 kernel in every decode step and the prefill of rows <= 64): tokens
    equal and logits within 1e-4.  The flash kernel launches once per
    attention layer and prefill, the scan kernel once per RG-LRU layer and
    prefill.  The MoE decoders' expert FFN runs the MoE kernel in every
    decode step and in each prefill whose capacity is at most
    ``MOE_DECODE_ROWS`` rows an expert, and its plain version never."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import _cuda
    from repro_torch.models.layers import (MOE_DECODE_ROWS, W8_DECODE_ROWS, moe_capacity,
                                           quantize_for_serving)
    from repro_torch.models.lm import DecoderLM, moe_spec

    out = {"phase": "lm_reference"}
    runs = [(arch, dtype, tol, False) for arch in LM_REFERENCE_ARCHS
            for dtype, tol in (("float32", 1e-4), ("bfloat16", 5e-2))
            if arch not in LM_MOE_ARCHS or dtype == "float32"]
    runs += [(arch, "float32", 1e-4, True) for arch in LM_INT8_ARCHS]
    for arch, dtype, tol, int8 in runs:
        cfg = dataclasses.replace(get_smoke_config(arch), compute_dtype=dtype)
        cpu = DecoderLM(cfg, device="cpu", seed=seed)
        card = DecoderLM(cfg, device="cuda", seed=None)
        if int8:
            quantize_for_serving(cpu)
            quantize_for_serving(card)
        card.load_state_dict(cpu.state_dict())
        prompts = lm_prompts(np.random.default_rng(seed + 5), 5, 3, 24, cfg.vocab)
        _cuda.reset_launches()
        with counted_plain_moe() as plain_calls:
            got = serve_session(torch, card, prompts, 2, 64, 6, True)
        launches = dict(_cuda.LAUNCHES)
        want = serve_session(torch, cpu, prompts, 2, 64, 6, False)
        attention, rglru = layer_counts(card)
        assert launches["flash_attention"] == attention * len(got[1]), (launches, len(got[1]))
        assert launches["rglru_scan"] == rglru * len(got[1]), (launches, len(got[1]))
        # the wrapper's launches: each prefill of at most W8_DECODE_ROWS rows
        # (2 slots x its longest prompt) and the warm-up step before the
        # capture, a launch a product at float32; the replays launch without it
        rows = [2 * max(len(p) for p in prompts[i:i + 2]) for i in range(0, len(prompts), 2)]
        want_w8 = w8_per_step(card)[1] * (1 + sum(r <= W8_DECODE_ROWS for r in rows))
        assert launches["w8_matmul"] == (want_w8 if int8 else 0), (launches, rows)
        # two MoE launches a layer in the warm-up step and in each prefill of
        # at most MOE_DECODE_ROWS rows an expert
        want_moe = (2 * cfg.n_layers * (1 + sum(moe_capacity(moe_spec(cfg), r) <= MOE_DECODE_ROWS
                                                for r in rows)) if cfg.n_experts else 0)
        assert launches["moe_ffn"] == want_moe and plain_calls == [0], (launches, plain_calls)
        tokens_equal = [r.out for r in got[0]] == [r.out for r in want[0]]
        pairs = list(zip(got[1], want[1]))
        if dtype == "float32":
            assert tokens_equal, ([r.out for r in got[0]], [r.out for r in want[0]])
            pairs += list(zip(got[2], want[2]))
        assert len(got[1]) == len(want[1]) == 3  # three admissions of <= 2
        err = 0.0
        for (_, a), (_, b) in pairs:
            torch.testing.assert_close(a.cpu(), b, rtol=tol, atol=tol)
            err = max(err, float((a.cpu() - b).abs().max()))
        out[f"{cfg.name}{'-int8' if int8 else ''}-{dtype}"] = {
            "tokens_equal": tokens_equal, "max_abs_err": err,
            "logit_sets": len(pairs), "tolerance": tol,
            "flash_launches": launches["flash_attention"],
            "w8_launches": launches["w8_matmul"], "moe_launches": launches["moe_ffn"],
            "rglru_launches": launches["rglru_scan"]}
        del cpu, card
    emit(out)
    return out


def mrope_positions(slots: int, s: int, prefix: int, grid: int) -> np.ndarray:
    """M-RoPE ids (B, 3, S) of a real image-and-text prompt: a ``prefix``
    text tokens at ``(p, p, p)``, a ``grid`` x ``grid`` grid of merged
    patches at ``(prefix, prefix + row, prefix + col)``, then text one more
    in all three components a token from ``prefix + grid``."""
    pos = np.zeros((3, s), np.int64)
    pos[:, :prefix] = np.arange(prefix)
    n = min(grid * grid, s - prefix)
    r, c = np.divmod(np.arange(n), grid)
    pos[:, prefix:prefix + n] = prefix
    pos[1, prefix:prefix + n] += r
    pos[2, prefix:prefix + n] += c
    pos[:, prefix + n:] = prefix + grid + np.arange(s - prefix - n)
    return np.broadcast_to(pos, (slots, 3, s)).copy()


def input_admissions(torch, cfg, lengths, slots: int, max_new: int, frames: int,
                     draw, ints, prefix: int, grid: int) -> list:
    """An admission for each prompt length: the prefill batch on every slot
    and, for a model without token embeddings, the (B, 1, D) embeddings its
    ``max_new - 1`` decode steps take (else ``None``: they take the greedy
    tokens).  The VLM's batch is ``embeds`` drawn by ``draw`` (the
    reference's ``normal(0, 0.5)``) with :func:`mrope_positions`; the
    encoder-decoder's is ``frames`` encoder frames drawn so and ``tokens``
    drawn by ``ints``."""
    out = []
    for s in lengths:
        if not cfg.embed_inputs:
            batch = {"embeds": draw((slots, s, cfg.d_model)),
                     "positions": torch.from_numpy(mrope_positions(slots, s, prefix, grid))}
            out.append((batch, [draw((slots, 1, cfg.d_model)) for _ in range(max_new - 1)]))
        else:
            batch = {"tokens": ints((slots, s))}
            if cfg.is_encdec:
                batch["enc_embeds"] = draw((slots, frames, cfg.d_model))
            out.append((batch, None))
    return out


def drive(torch, model, admissions, max_len: int, max_new: int, sync: bool):
    """Serve ``admissions`` through ``model.prefill`` and one
    ``make_decode_step(model)`` (on the card a CUDA graph captured at its
    first call, each later admission's cache copied into the captured one):
    what ``ServeSession`` does for a token-input decoder, admission by
    admission, for the two families it does not serve.  Each admission's
    first token comes from its prefill's logits (greedy), then ``max_new -
    1`` decode steps at positions S, S + 1, ... take the last token or the
    admission's next embeddings.  Returns each admission's tokens (B,
    max_new) on the host, the prefills and decode steps as (seconds on the
    host clock, synced when ``sync``; logits), and the step."""
    from repro_torch.serve.engine import make_decode_step

    def timed(fn, *args):
        if sync:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = fn(*args)
        if sync:
            torch.cuda.synchronize()
        return time.perf_counter() - t0, logits, cache

    step = make_decode_step(model)
    prefills, decodes, tokens = [], [], []
    for batch, step_inputs in admissions:
        s = (batch["embeds"] if "embeds" in batch else batch["tokens"]).shape[1]
        dt, logits, cache = timed(model.prefill, batch, max_len)
        prefills.append((dt, logits))
        out = [logits.argmax(-1)]
        for t in range(max_new - 1):
            x = out[-1][:, None] if step_inputs is None else step_inputs[t]
            dt, logits, cache = timed(step, cache, x, s + t)
            decodes.append((dt, logits))
            out.append(logits.argmax(-1))
        tokens.append(torch.stack(out, 1).cpu())
        del cache
    return tokens, prefills, decodes, step


def flash_layers(model) -> int:
    """The flash kernel's launches in one prefill of ``model``: one per
    attention layer, the encoder's included (cross-attention is plain)."""
    if hasattr(model, "enc_layers"):
        return len(model.enc_layers) + len(model.layers)
    return layer_counts(model)[0]


def lm_reference_inputs_phase(torch, seed: int) -> dict:
    """Each smoke of ``LM_INPUT_ARCHS`` driven on the card (graphed decode
    steps) and on the CPU (eager) with the same weights and inputs (drawn
    from ``--seed``), two admissions of 2 slots (prompts of
    ``SMOKE_PROMPTS``), 6 new positions each: at float32 compute every
    prefill's and decode step's logits within 1e-4, and the tokens equal
    where they are fed back (the encoder-decoder); at bfloat16 every
    prefill's logits within 5e-2.  The flash kernel launches once per
    attention layer (the encoder's too) and prefill, never in a step."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import _cuda
    from repro_torch.models import build_model

    out = {"phase": "lm_reference_inputs"}
    for arch in LM_INPUT_ARCHS:
        for dtype, tol in (("float32", 1e-4), ("bfloat16", 5e-2)):
            cfg = dataclasses.replace(get_smoke_config(arch), compute_dtype=dtype)
            cpu = build_model(cfg, device="cpu", seed=seed)
            card = build_model(cfg, device="cuda", seed=None)
            card.load_state_dict(cpu.state_dict())
            rng = np.random.default_rng(seed + 5)
            adm = input_admissions(
                torch, cfg, SMOKE_PROMPTS, 2, 6, FRAMES_SMOKE,
                lambda shape: torch.from_numpy(rng.normal(0, 0.5, shape).astype(np.float32)),
                lambda shape: torch.from_numpy(rng.integers(0, cfg.vocab, shape)), 4, 2)
            _cuda.reset_launches()
            got = drive(torch, card, adm, 64, 6, True)
            launches = _cuda.LAUNCHES["flash_attention"]
            step = got[3]
            want = drive(torch, cpu, adm, 64, 6, False)
            assert launches == flash_layers(card) * len(adm), launches
            assert step.captured["flash_attention"] == 0 and step.replays == len(got[2])
            tokens_equal = all(torch.equal(a, b) for a, b in zip(got[0], want[0]))
            pairs = list(zip(got[1], want[1]))
            if dtype == "float32":
                assert tokens_equal or not cfg.embed_inputs, (got[0], want[0])
                pairs += list(zip(got[2], want[2]))
            err = 0.0
            for (_, a), (_, b) in pairs:
                torch.testing.assert_close(a.cpu(), b, rtol=tol, atol=tol)
                err = max(err, float((a.cpu() - b).abs().max()))
            out[f"{cfg.name}-{dtype}"] = {
                "tokens_equal": tokens_equal, "max_abs_err": err, "logit_sets": len(pairs),
                "tolerance": tol, "flash_launches": launches, "replays": step.replays}
            del cpu, card, step, got
    emit(out)
    return out


def flash_check(got, want, dtype: str) -> dict:
    """``got`` within ``FLASH_TOL[dtype]`` of ``want`` everywhere: the
    largest error, and the largest share of its element's limit."""
    rtol, atol = FLASH_TOL[dtype]
    diff = (got.float() - want.float()).abs()
    share = float((diff / (atol + rtol * want.float().abs())).max())
    out = {"max_abs_err": float(diff.max()), "limit_share": share,
           "rtol": rtol, "atol": atol}
    assert share <= 1.0, out
    return out


def flash_bound(b, s, h, kh, d, causal, window, elem_bytes) -> tuple[float, str]:
    """The least time of the attention forward: 4·B·H·D operations per
    unmasked pair (QK and PV, a multiply and an add each) over the rate of
    the inputs' type (bf16 on the tensor cores, float32 outside them),
    against Q, K, V and O moved once."""
    from repro_torch.roofline import analysis as A

    return A.bound_ms(*A.flash_work(b, s, h, kh, d, causal, window, elem_bytes), elem_bytes,
                      ties="operations")


def flash_phase(torch, seed: int, reps: int) -> dict:
    """The kernel against its plain version at the path's shapes, timed
    beside its bound and one ``scaled_dot_product_attention`` call."""
    import torch.nn.functional as Fn

    from repro_torch.kernels import flash_attention as FA
    from repro_torch.roofline import analysis as A

    out = {}
    g = torch.Generator(device="cuda").manual_seed(seed + 9)
    for name, b, s, h, kh, d, causal, window in FLASH_SHAPES:
        q, k, v = (torch.randn((b, s, n, d), generator=g, device="cuda",
                               dtype=torch.bfloat16) for n in (h, kh, kh))
        run = lambda: FA.flash_attention(q, k, v, causal=causal, window=window)  # noqa: E731
        plain = lambda: FA.flash_attention_torch(q, k, v, causal=causal, window=window)  # noqa: E731
        got, want = run(), plain()
        torch.cuda.synchronize()
        check = flash_check(got, want, "bfloat16")
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))  # (B, heads, S, D) views
        if window is None:
            library = lambda: Fn.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, is_causal=causal, enable_gqa=True)
        else:
            i = torch.arange(s, device="cuda")
            dist = i[:, None] - i[None, :]
            mask = (dist >= 0) & (dist < window)
            library = lambda: Fn.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, attn_mask=mask, enable_gqa=True)
        lib_err = float((library().transpose(1, 2).float() - want.float()).abs().max())
        del got, want
        if name == "flash_attention":  # the float32 build at the path's shape too
            q32, k32, v32 = (x.float() for x in (q, k, v))
            f32 = flash_check(FA.flash_attention(q32, k32, v32, causal=causal),
                              FA.flash_attention_torch(q32, k32, v32, causal=causal),
                              "float32")
            f32["kernel_ms"] = time_ms(torch, lambda: FA.flash_attention(
                q32, k32, v32, causal=causal), max(3, reps // 3))
            del q32, k32, v32
        bound_ms, bound_by = flash_bound(b, s, h, kh, d, causal, window, 2)
        line = {"phase": "kernel", "name": name,
                "kernel_ms": time_ms(torch, run, reps),
                **device_fields(torch, run, reps),
                "plain_ms": time_ms(torch, plain, max(3, reps // 3)),
                "library_ms": time_ms(torch, library, reps),
                **device_fields(torch, library, reps, "library_"),
                "library_call": "torch.nn.functional.scaled_dot_product_attention"
                                + (" (bool window mask)" if window is not None
                                   else " (is_causal)" if causal else " (no mask)"),
                "library_max_abs_err": lib_err,
                "bound_ms": bound_ms, "bound_by": bound_by, **check,
                "shape": {"B": b, "S": s, "H": h, "KH": kh, "D": d, "causal": causal,
                          "window": window, "dtype": "bfloat16"},
                "pairs_per_head": A.flash_pairs(s, causal, window)}
        if name == "flash_attention":
            line["float32"] = f32
        emit(line)
        out[name] = line
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
    return out


def w8_bound(m: int, k: int, ns, elem_bytes: int) -> tuple[float, str]:
    """The least time of ``x (m, k) @ dequant(q (k, n), s)`` for each ``n``
    of ``ns``, a group that shares x: the int8 weights, the bf16 scales, x
    (once) and the outputs moved once over the memory rate, against 2·m·k·n
    operations a record over the inputs' rate (bf16 on the tensor cores,
    float32 on the CUDA cores)."""
    from repro_torch.roofline import analysis as A

    return A.bound_ms(*A.w8_work(m, k, ns, elem_bytes), elem_bytes, ties="bytes")


def w8_check(torch, got, x, q, s, want) -> dict:
    """``got`` against the exact product (float64) and against ``want``, the
    plain version, with the limits of ``W8_SUM_RTOL``; raises on a miss."""
    from repro_torch.kernels.w8_matmul import dequantize

    w = dequantize(q, s, x.dtype).double()
    exact = x.double() @ w
    sums = x.double().abs() @ w.abs()
    half_step = 2.0 ** -8 if x.dtype == torch.bfloat16 else 0.0
    err = (got.double() - exact).abs()
    share = float((err / (W8_SUM_RTOL * sums + half_step * exact.abs() + 1e-30)).max())
    plain_err = (got.double() - want.double()).abs()
    plain_share = float((plain_err / (2 * W8_SUM_RTOL * sums + 2 * half_step
                                      * want.double().abs() + 1e-30)).max())
    out = {"max_abs_err": float(plain_err.max()), "max_abs_err_exact": float(err.max()),
           "limit_share": share, "plain_limit_share": plain_share}
    assert share <= 1.0 and plain_share <= 1.0, out
    return out


def int8pack_yardstick(torch, x, copies, want) -> dict:
    """``torch._weight_int8pack_mm`` — x against an ``(N, K)`` int8 copy of
    each record, transposed beforehand, and float32 scales — over the
    ``copies`` as the kernel is timed, where the installed torch runs it on
    the card: a yardstick that reads the same int8 bytes, never called by
    the port.  Where it does not run, says why."""
    try:
        packs = [[(q.t().contiguous(), s.float().reshape(-1)) for q, s in c] for c in copies]
        got = [torch._weight_int8pack_mm(x, wt, sc) for wt, sc in packs[0]]
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError, AttributeError) as e:
        return {"int8pack_ms": None, "int8pack_error": str(e).splitlines()[0][:200]}
    err = max(float((a.float() - b.float()).abs().max()) for a, b in zip(got, want))
    ms = graph_ms(torch, [lambda p=p: [torch._weight_int8pack_mm(x, wt, sc) for wt, sc in p]
                          for p in packs], W8_GRAPH_REPS)
    del packs, got
    return {"int8pack_ms": ms, "int8pack_max_abs_err": err}


def w8_phase(torch, seed: int) -> dict:
    """The W8 kernel against its plain version at a qwen3-8b layer's four
    decode launches (``W8_GROUPS``), in bf16 and float32: each output
    within the limits of :func:`w8_check`, equal on a rerun and bit-equal to
    its product launched alone.  Each launch is timed beside its bound, its
    plain version and one ``torch.matmul`` of the same x against each
    weight dequantized beforehand (it reads twice the bytes of a bf16 weight
    and does no dequant), in bf16 also ``torch._weight_int8pack_mm``
    (:func:`int8pack_yardstick`).  All are timed as a decode step meets
    them: over ``W8_COPIES`` copies of the weights in turn (cold in L2), the
    launches captured in one CUDA graph (no host work between them),
    ``W8_GRAPH_REPS`` replays between CUDA events.  Returns, as
    ``w8_matmul``, a layer's four bf16 launches summed against their
    bound."""
    from repro_torch.kernels import w8_matmul as W8
    from repro_torch.models.layers import quantize_weight

    g = torch.Generator(device="cuda").manual_seed(seed + 13)
    lines = {}
    for group, k, ns in W8_GROUPS:
        recs = []
        for n in ns:
            rec = quantize_weight(torch.randn((k, n), generator=g, device="cuda") * k ** -0.5)
            recs.append((rec.q, rec.s))
        copies = [recs] + [[(q.clone(), s) for q, s in recs] for _ in range(W8_COPIES - 1)]
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn((W8_ROWS, k), generator=g, device="cuda").to(dtype)
            got = W8.w8_matmul_group(x, recs)
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
            want = [W8.w8_matmul_torch(x, q, s) for q, s in recs]
            torch.cuda.synchronize()
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = True
            again = W8.w8_matmul_group(x, recs)  # a fixed order of the split-K sums
            alone = [W8.w8_matmul(x, q, s) for q, s in recs]  # the same sums in a group
            assert all(torch.equal(a, b) and torch.equal(a, c)
                       for a, b, c in zip(got, again, alone)), group
            checks = [w8_check(torch, y, x, q, s, w) for y, (q, s), w in zip(got, recs, want)]
            ws = [[W8.dequantize(q, s, dtype) for q, s in c] for c in copies]
            bound_ms, bound_by = w8_bound(W8_ROWS, k, ns, x.element_size())
            name = f"w8_matmul_{group}_{str(dtype).split('.')[1]}"
            line = {"phase": "kernel", "name": name,
                    "kernel_ms": graph_ms(torch, [lambda c=c: W8.w8_matmul_group(x, c)
                                                  for c in copies], W8_GRAPH_REPS),
                    "plain_ms": graph_ms(torch, [
                        lambda c=c: [W8.w8_matmul_torch(x, q, s) for q, s in c]
                        for c in copies], W8_GRAPH_REPS),
                    "library_ms": graph_ms(torch, [lambda w=w: [torch.matmul(x, wi) for wi in w]
                                                   for w in ws], W8_GRAPH_REPS),
                    "library_call": "torch.matmul (weight dequantized beforehand)",
                    **(int8pack_yardstick(torch, x, copies, want)
                       if dtype == torch.bfloat16 else {}),
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "max_abs_err": max(c["max_abs_err"] for c in checks),
                    "max_abs_err_exact": max(c["max_abs_err_exact"] for c in checks),
                    "limit_share": max(c["limit_share"] for c in checks),
                    "plain_limit_share": max(c["plain_limit_share"] for c in checks),
                    "grouped_equal_alone": True,
                    "shape": {"M": W8_ROWS, "K": k, "N": list(ns), "dtype": str(dtype)}}
            emit(line)
            lines[name] = line
            del x, ws, got, want, again, alone
        del recs, copies
        torch.cuda.empty_cache()
    bf16 = [lines[f"w8_matmul_{group}_bfloat16"] for group, _, _ in W8_GROUPS]
    packs = [ln["int8pack_ms"] for ln in bf16]
    layer = {"phase": "kernel", "name": "w8_matmul", "per": "a qwen3-8b layer's 7 decode "
             "products in 4 launches, bf16, M 8",
             **{key: sum(ln[key] for ln in bf16)
                for key in ("kernel_ms", "plain_ms", "library_ms", "bound_ms")},
             "int8pack_ms": sum(packs) if None not in packs else None,
             "bound_by": "bytes" if all(ln["bound_by"] == "bytes" for ln in bf16)
             else "operations",
             "max_abs_err": max(ln["max_abs_err"] for ln in lines.values())}
    layer["bound_share"] = layer["bound_ms"] / layer["kernel_ms"]
    emit(layer)
    return {"w8_matmul": layer}


def moe_limits(torch, buf, count, wg, wu) -> tuple:
    """The exact gate/up output (float64) of ``buf``'s kept rows and each
    element's limit: each of the two products within ``MOE_SUM_RTOL ·
    sum(|x| |w|)`` (its float32 sum) plus half a step of the dtype (its
    rounding), carried through ``silu`` (slope at most ``SILU_SLOPE``),
    rounded once more, and the product of the two, rounded once more."""
    hs = 2.0 ** -8 if buf.dtype == torch.bfloat16 else 0.0
    rows = torch.arange(buf.shape[1], device=buf.device)
    x = buf.double() * (rows[None, :] < count[:, None])[..., None]
    wg, wu = wg.double(), wu.double()
    g, u = torch.bmm(x, wg), torch.bmm(x, wu)
    eg = MOE_SUM_RTOL * torch.bmm(x.abs(), wg.abs()) + hs * g.abs()
    eu = MOE_SUM_RTOL * torch.bmm(x.abs(), wu.abs()) + hs * u.abs()
    silu = g * torch.sigmoid(g)
    es = SILU_SLOPE * eg + hs * (silu.abs() + SILU_SLOPE * eg)
    limit = es * (u.abs() + eu) + silu.abs() * eu + hs * (silu.abs() + es) * (u.abs() + eu)
    return silu * u, limit


def moe_check(torch, buf, count, wg, wu, wd) -> dict:
    """Both stages of the MoE kernel on ``buf`` against the exact products
    of its touched experts (float64) and against their plain versions on the
    same inputs, with the limits of :func:`moe_limits` (the down product's:
    ``MOE_SUM_RTOL · sum(|h| |w|)`` plus half a step of the value); the
    rows past each count, and every row of an untouched expert, exactly
    zero.  Raises on a miss."""
    from repro_torch.kernels import moe_ffn as MF

    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    h = MF.moe_gate_up(buf, count, wg, wu)
    out = MF.moe_down(h, count, wd)
    h_plain = MF.moe_gate_up_torch(buf, count, wg, wu)
    out_plain = MF.moe_down_torch(h, count, wd)
    end_to_end = MF.moe_ffn_torch(buf, count, wg, wu, wd)
    torch.cuda.synchronize()
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = True
    rows = torch.arange(buf.shape[1], device=buf.device)
    past = rows[None, :] >= count[:, None]
    assert not h[past].any() and not out[past].any()
    t = torch.nonzero(count).flatten()  # the touched experts
    hs = 2.0 ** -8 if buf.dtype == torch.bfloat16 else 0.0
    h_exact, h_limit = moe_limits(torch, buf[t], count[t], wg[t], wu[t])
    ht, wdt = h[t].double(), wd[t].double()
    o_exact = torch.bmm(ht, wdt)
    o_limit = MOE_SUM_RTOL * torch.bmm(ht.abs(), wdt.abs()) + hs * o_exact.abs()

    def share(err, limit):
        return float((err / (limit + 1e-30)).max())

    out = {"touched_experts": int(t.numel()), "kept_rows": int(count.sum()),
           "max_abs_err": float((out.double() - end_to_end.double()).abs().max()),
           "limit_share_gate_up": share((h[t].double() - h_exact).abs(), h_limit),
           "limit_share_down": share((out[t].double() - o_exact).abs(), o_limit),
           "plain_limit_share_gate_up": share((h - h_plain).double().abs()[t], 2 * h_limit),
           "plain_limit_share_down": share((out - out_plain).double().abs()[t], 2 * o_limit)}
    assert max(v for k, v in out.items() if "share" in k) <= 1.0, out
    return out


def moe_bound(touched: int, e: int, cap: int, d: int, f: int, elem: int) -> tuple[float, str]:
    """The least time of the expert FFN: the touched experts' three weights,
    the buffer and the output moved once over the memory rate, against the
    kept rows' products (at most ``cap`` a touched expert, 6·d·f operations
    a row) over the inputs' rate."""
    from repro_torch.roofline import analysis as A

    return A.bound_ms(*A.moe_work(touched, e, cap, d, f, elem), elem, ties="bytes")


def moe_phase(torch, seed: int, reps: int) -> dict:
    """The MoE kernel against its plain version at one qwen3-moe-235b
    layer's decode step (``MOE_SHAPE``: the buffer dispatched from 8 tokens
    routed through a router drawn from ``--seed``, cap 4), bf16 and
    float32: each stage within :func:`moe_check`'s limits, equal on a rerun
    and in a CUDA graph's replay.  Timed beside its bound (by bytes: the
    touched experts' weights), its plain version and ``library_ms``: the
    dense form, three ``torch.bmm`` over every expert (the same function,
    reading every expert's weights; the port's decode step never calls
    it).  Returns the bf16 line as ``moe_ffn``."""
    from repro_torch.kernels import moe_ffn as MF
    from repro_torch.models import layers as L

    e, d, f, k, t = (MOE_SHAPE[n] for n in ("E", "d", "f", "top_k", "tokens"))
    spec = L.MoESpec(d_model=d, d_ff=f, n_experts=e, top_k=k)
    cap = L.moe_capacity(spec, t)
    g = torch.Generator(device="cuda").manual_seed(seed + 17)
    router = torch.randn((d, e), generator=g, device="cuda") * d ** -0.5
    xt = torch.randn((t, d), generator=g, device="cuda")
    r = L.moe_route(spec, torch.softmax(xt @ router, dim=-1), e, 0, cap)
    lines = {}
    for dtype in (torch.bfloat16, torch.float32):
        weights = [(torch.randn((e, a, b), generator=g, device="cuda") * a ** -0.5).to(dtype)
                   for a, b in ((d, f), (d, f), (f, d))]
        x = xt.to(dtype)
        buf = x.new_zeros((e * cap + 1, d))
        buf.index_copy_(0, r.dest, x.index_select(0, r.st))
        buf = buf[:-1].view(e, cap, d)
        check = moe_check(torch, buf, r.count, *weights)
        run = lambda: MF.moe_ffn(buf, r.count, *weights)  # noqa: E731
        got, again = run(), run()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            replayed = run()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(got, again) and torch.equal(got, replayed)
        del graph, replayed, again
        elem = x.element_size()
        bound_ms, bound_by = moe_bound(check["touched_experts"], e, cap, d, f, elem)
        name = f"moe_ffn_{str(dtype).split('.')[1]}"
        line = {"phase": "kernel", "name": name,
                "kernel_ms": time_ms(torch, run, reps),
                "kernel_graph_ms": graph_ms(torch, [run], W8_GRAPH_REPS),
                **device_fields(torch, run, reps),
                "plain_ms": time_ms(torch, lambda: MF.moe_ffn_torch(buf, r.count, *weights),
                                    max(3, reps // 3)),
                "library_ms": time_ms(torch, lambda: MF.expert_ffn_dense(buf, *weights), reps),
                **device_fields(torch, lambda: MF.expert_ffn_dense(buf, *weights), reps,
                                "library_"),
                "library_call": "torch.bmm x3 over every expert (the dense form)",
                "bound_ms": bound_ms, "bound_by": bound_by,
                "dense_bytes": (3 * e * d * f + 2 * e * cap * d) * elem, **check,
                "rerun_and_replay_equal": True,
                "shape": {"E": e, "cap": cap, "d": d, "f": f, "tokens": t, "top_k": k,
                          "dtype": str(dtype)}}
        line["bound_share"] = bound_ms / line["kernel_ms"]
        emit(line)
        lines[name] = line
        del weights, x, buf, got
        torch.cuda.empty_cache()
    emit(read_rate(torch, int(lines["moe_ffn_float32"]["bound_ms"] * 1e-3 * hw().hbm_bw),
                   reps))
    return {"moe_ffn": lines["moe_ffn_bfloat16"]}


def rglru_phase(torch, seed: int, reps: int) -> dict:
    """The RG-LRU scan kernel against its plain version (the sequential
    float32 loop, two launches a step) at recurrentgemma-9b's prefill shape
    (``RGLRU_SHAPE``), ``a`` in (0, 1) and ``x`` normal, drawn from
    ``--seed``: bit-equal, and equal on a rerun.  Timed beside its bound (by
    bytes: a and x read once, h written once); ``library_ms`` is null: no
    one torch call computes a linear recurrence.  Returns the line as
    ``rglru_scan``, with the kernel's launch plan."""
    import dataclasses

    from repro_torch.kernels import _cuda
    from repro_torch.kernels import rglru_scan as RS
    from repro_torch.roofline import analysis as A

    b, s, w = RGLRU_SHAPE
    g = torch.Generator(device="cuda").manual_seed(seed + 21)
    a = torch.rand((b, s, w), generator=g, device="cuda").clamp_(min=1e-6)
    x = torch.randn((b, s, w), generator=g, device="cuda")
    run = lambda: RS.rglru_scan(a, x)  # noqa: E731
    plain = lambda: RS.rglru_scan_torch(a, x)  # noqa: E731
    got, again, want = run(), run(), plain()
    torch.cuda.synchronize()
    bit_equal = torch.equal(got, want)
    assert bit_equal and torch.equal(got, again), float((got - want).abs().max())
    nbytes = A.rglru_scan_work(b, s, w)[1]
    line = {"phase": "kernel", "name": "rglru_scan_float32",
            "kernel_ms": time_ms(torch, run, reps),
            "kernel_graph_ms": graph_ms(torch, [run], W8_GRAPH_REPS),
            **device_fields(torch, run, reps),
            "plain_ms": time_ms(torch, plain, max(3, reps // 3)),
            "library_ms": None,
            "library_call": "none: no one torch call computes a linear recurrence",
            "bound_ms": nbytes / hw().hbm_bw * 1e3, "bound_by": "bytes",
            "bound_bytes": nbytes, "max_abs_err": float((got - want).abs().max()),
            "bit_equal_to_plain": bit_equal, "rerun_equal": True,
            "plan": dataclasses.asdict(_cuda.rglru_scan_plan(a, x)),
            "shape": {"B": b, "S": s, "W": w, "dtype": "float32"}}
    line["bound_share"] = line["bound_ms"] / line["kernel_ms"]
    if line["device_ms"]:
        line["device_bound_share"] = line["bound_ms"] / line["device_ms"]
    emit(line)
    del a, x, got, again, want
    torch.cuda.empty_cache()
    return {"rglru_scan": line}


def read_rate(torch, nbytes: int, reps: int) -> dict:
    """The rate at which one ``torch.sum`` reads ``nbytes`` of float32 on
    this card, timed as the kernel lines are (a graph replayed between CUDA
    events, and ``torch.profiler``'s device time): what the card reads
    against the data sheet's rate, and whether the two timings agree."""
    t = torch.ones(nbytes // 4, device="cuda")
    run = lambda: t.sum()  # noqa: E731
    out = {"phase": "read_rate", "bytes": t.numel() * 4, "call": "torch.sum (float32)",
           "graph_ms": graph_ms(torch, [run], W8_GRAPH_REPS), **device_fields(torch, run, reps)}
    out["graph_rate"] = out["bytes"] / (out["graph_ms"] * 1e-3)
    if out["device_ms"]:
        out["device_rate"] = out["bytes"] / (out["device_ms"] * 1e-3)
    del t
    torch.cuda.empty_cache()
    return out


def profile_step(torch, fn, count=("rm_w8_matmul", "rm_w8_reduce", "rm_moe_ffn"),
                 replays: int = 0) -> dict:
    """One step's time: ``fn`` once to warm up, once on the host clock
    (synced); with ``replays``, the mean over ``replays`` calls between CUDA
    events, five times (``replayed_ms`` their median, ``replayed_ms_runs``
    all five); then once more under ``torch.profiler`` — the sum of its
    kernels' device times (one stream, so they do not overlap), its
    launches, the top five kernels, the launches and the device time of the
    kernels whose names hold one of ``count``, and the idle share of that
    profiled step against its own wall time (the profiler's host cost
    included).  ``None`` where the trace holds no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    unprofiled_ms = (time.perf_counter() - t0) * 1e3
    runs = []
    if replays:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        for _ in range(5):
            start.record()
            for _ in range(replays):
                fn()
            end.record()
            end.synchronize()
            runs.append(start.elapsed_time(end) / replays)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    kernels = [e for e in prof.key_averages()
               if getattr(e, "device_type", None) == DeviceType.CUDA and dev_us(e) > 0]
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3
    top = sorted(kernels, key=dev_us, reverse=True)[:5]
    return {"profiled_wall_ms": wall_ms, "unprofiled_ms": unprofiled_ms,
            "replayed_ms": statistics.median(runs) if runs else None,
            "replayed_ms_runs": runs,
            "device_busy_ms": busy_ms or None,
            "idle_share": (1 - busy_ms / wall_ms) if busy_ms else None,
            "kernel_launches": sum(e.count for e in kernels),
            "counted": {c: sum(e.count for e in kernels if c in e.key) for c in count},
            "counted_ms": {c: sum(dev_us(e) for e in kernels if c in e.key) / 1e3
                           for c in count},
            "top_kernels": [[e.key[:90], dev_us(e) / 1e3, e.count] for e in top]}


def first_admission(torch, prompts, device):
    """The session's first prefill batch: the first ``LM_SLOTS`` prompts,
    left-padded with zeros to the longest, on ``device``."""
    first = prompts[:LM_SLOTS]
    toks = np.zeros((LM_SLOTS, max(len(p) for p in first)), np.int32)
    for slot, p in enumerate(first):
        toks[slot, -len(p):] = p
    return torch.from_numpy(toks).to(device)


def serve_cell(torch, model, cfg, prompts, int8: bool,
               check_layers=LM_CHECK_LAYERS, scan_layers=()) -> dict:
    """Serve ``prompts`` through ``ServeSession`` (graphed decode steps) on
    ``model`` and check what came out; then, on the first admission's
    prompts again, one replayed step against an eager ``decode_step`` on a
    copy of the same cache (bit-equal logits and caches: KV caches and
    recurrent states), and one prefill, one replayed and one eager decode
    step timed and profiled; then the requests served again under the
    profiler (:func:`traced_serve`).  The wrappers' flash, W8, MoE and scan
    launches are counted on the first serving run alone, and the MoE
    kernel's plain version must not run; its host counters
    (:func:`host_usage`) are kept for each prefill and the first tick
    (warm-up, capture, replay).  The flash kernel's output on the attention
    layers ``check_layers`` and the scan kernel's on the RG-LRU layers
    ``scan_layers`` (taken with forward hooks in the first prefill) are
    held against their plain versions.  An MoE model's eager step also
    reads back each layer's touched experts (``touched_experts``)."""
    from repro_torch.kernels import _cuda
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import rglru_scan as RS
    from repro_torch.models import layers as L
    from repro_torch.serve.engine import make_decode_step

    captured: dict = {}

    def capture(key):
        def hook(module, args, result):
            if key not in captured:  # the first prefill's inputs and output
                captured[key] = (args, result)
        return hook

    hooks = [model.layers[i].mixer.attend.register_forward_hook(capture(("flash", i)))
             for i in check_layers]
    hooks += [model.layers[i].mixer.scan.register_forward_hook(capture(("scan", i)))
              for i in scan_layers]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with counted_plain_moe() as plain_moe:
        reqs, prefills, decodes, session_step, usage = serve_session(
            torch, model, prompts, LM_SLOTS, LM_MAX_LEN, LM_MAX_NEW, True)
        torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = {k: _cuda.LAUNCHES[k]
                for k in ("flash_attention", "w8_matmul", "moe_ffn", "rglru_scan")}
    w8_products = _cuda.W8_PRODUCTS["launched"]
    capture_s = session_step.capture_seconds
    replays, recorded = session_step.replays, session_step.captured
    recorded_products = session_step.captured_w8_products
    del session_step
    for hk in hooks:
        hk.remove()
    peak = torch.cuda.max_memory_allocated()
    attention, rglru = layer_counts(model)
    # each prefill: the flash kernel once per attention layer, the scan
    # kernel once per RG-LRU layer; a decode step runs neither
    assert launches["flash_attention"] == attention * len(prefills), (launches, len(prefills))
    assert launches["rglru_scan"] == rglru * len(prefills), (launches, len(prefills))
    assert recorded["flash_attention"] == recorded["rglru_scan"] == 0, recorded
    # the W8 wrapper launches in the warm-up step before the capture alone
    # (every prefill has more than W8_DECODE_ROWS rows): a dense layer's 7
    # products in 4 launches (q, k, v one; wo; gate, up one; w_down), an MoE
    # layer's 4 in 2 (its experts stay bf16); the capture records as many,
    # which each replay launches without the wrapper
    moe_layers = sum(layer.kind == "moe" for layer in model.layers)
    w8_step = w8_per_step(model) if int8 else (0, 0)
    assert launches["w8_matmul"] == w8_step[0], launches
    assert w8_products == w8_step[1], w8_products
    # the MoE kernel: two launches a layer in the warm-up step (every prefill's
    # capacity is above MOE_DECODE_ROWS); its plain version never
    assert launches["moe_ffn"] == 2 * moe_layers and plain_moe == [0], (launches, plain_moe)
    assert recorded["moe_ffn"] == launches["moe_ffn"], recorded
    assert replays == len(decodes), (replays, len(decodes))  # every tick a replay
    assert recorded["w8_matmul"] == launches["w8_matmul"], recorded  # as the warm-up
    assert recorded_products == w8_products, (recorded_products, w8_products)
    assert all(len(r.out) == LM_MAX_NEW for r in reqs), [len(r.out) for r in reqs]
    assert all(0 <= t < cfg.vocab for r in reqs for t in r.out)
    for _, logits in prefills + decodes:
        assert logits.shape == (LM_SLOTS, cfg.padded_vocab)
        assert bool(torch.isfinite(logits).all())
    checked, scan_checked = {}, {}
    for idx in check_layers:
        (q, k, v), result = captured[("flash", idx)]
        again = FA.flash_attention(q, k, v, window=model.layers[idx].spec.window)
        want = FA.flash_attention_torch(q, k, v, window=model.layers[idx].spec.window)
        torch.cuda.synchronize()  # a compare launch, not counted above
        assert torch.equal(again, result), idx  # the path's output is the kernel's
        checked[idx] = {"shape": list(q.shape), "window": model.layers[idx].spec.window,
                        **flash_check(result, want, cfg.compute_dtype)}
    for idx in scan_layers:
        (a, x), result = captured[("scan", idx)]
        again, want = RS.rglru_scan(a, x), RS.rglru_scan_torch(a, x)
        torch.cuda.synchronize()
        assert torch.equal(again, result) and torch.equal(result, want), idx
        scan_checked[idx] = {"shape": list(a.shape), "bit_equal_to_plain": True}
    del captured
    tokens = sum(len(r.out) for r in reqs)
    decode_ms = [1e3 * t for t, _ in decodes]
    # where a step's time goes: the first admission's prefill and one decode
    # step again, after the counts were read
    toks = first_admission(torch, prompts, model.device)
    nxt, pos = toks[:, -1:].contiguous(), toks.shape[1]
    _, cache = model.prefill({"tokens": toks}, LM_MAX_LEN)
    twin = [{n: t.clone() for n, t in c.items()} for c in cache]
    step = make_decode_step(model)
    replayed, _ = step(cache, nxt, pos)
    counts = []  # each MoE layer's kept rows an expert, in the eager step
    real_ffn = L.moe_ffn
    L.moe_ffn = lambda buf, count, *w: counts.append(count) or real_ffn(buf, count, *w)
    try:
        eager, _ = model.decode_step(twin, nxt, pos)
    finally:
        L.moe_ffn = real_ffn
    torch.cuda.synchronize()
    touched = [int((c > 0).sum()) for c in counts]
    assert len(touched) == moe_layers, touched
    replay_equal = torch.equal(replayed, eager) and all(
        torch.equal(a[n], b[n]) for a, b in zip(cache, twin) for n in a)
    assert replay_equal, float((replayed - eager).abs().max())
    del twin, replayed, eager
    profiles = {
        "prefill": profile_step(torch, lambda: model.prefill({"tokens": toks}, LM_MAX_LEN),
                                count=("rm_flash_attention", "rm_rglru_scan", "gemm")),
        "decode_replayed": profile_step(torch, lambda: step(cache, nxt, pos), replays=50),
        "decode_eager": profile_step(torch, lambda: model.decode_step(cache, nxt, pos)),
    }
    # the W8 launches and products the serving run ran: the wrapper's (the
    # warm-up step) and, in each replay, those its capture recorded, whose
    # kernels the trace of a replayed step holds, with no split-K reduction
    # in bf16 (taken once more if it lost records)
    w8_run = launches["w8_matmul"] + replays * recorded["w8_matmul"]
    w8_products_run = w8_products + replays * recorded_products
    moe_run = launches["moe_ffn"] + replays * recorded["moe_ffn"]
    counted = profiles["decode_replayed"]["counted"]
    if (counted["rm_w8_matmul"], counted["rm_moe_ffn"]) != (recorded["w8_matmul"],
                                                            recorded["moe_ffn"]):
        profiles["decode_replayed"] = profile_step(torch, lambda: step(cache, nxt, pos))
    counted = profiles["decode_replayed"]["counted"]
    assert counted["rm_w8_matmul"] == recorded["w8_matmul"], (counted, recorded)
    assert counted["rm_moe_ffn"] == recorded["moe_ffn"], (counted, recorded)
    assert counted["rm_w8_reduce"] == 0, counted
    del cache, step
    ran = {"rm_flash_attention": launches["flash_attention"], "rm_w8_matmul": w8_run}
    if moe_layers:
        ran["rm_moe_ffn"] = moe_run
    if rglru:
        ran["rm_rglru_scan"] = launches["rglru_scan"]
    traced = traced_serve(torch, model, prompts, [r.out for r in reqs], ran)
    out = {"arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
           "weights": "int8" if int8 else cfg.compute_dtype, "dtype": cfg.compute_dtype,
           "slots": LM_SLOTS, "max_len": LM_MAX_LEN, "requests": len(reqs),
           "prompt_tokens": int(sum(len(p) for p in prompts)),
           "prefill_seconds": [t for t, _ in prefills],
           "prefill_lengths": [max(len(p) for p in prompts[i:i + LM_SLOTS])
                               for i in range(0, len(prompts), LM_SLOTS)],
           "decode_steps": len(decodes),
           "decode_tick_ms_median": statistics.median(decode_ms),
           "decode_tick_ms": decode_ms,
           "serve_seconds": serve_s, "generated_tokens": tokens,
           "generated_tokens_per_s": tokens / serve_s,
           # the session's serve time outside its timed prefills and ticks
           "untimed_seconds": serve_s - sum(t for t, _ in prefills + decodes),
           "capture_seconds": capture_s, "host_usage": usage,
           "max_memory_allocated": peak, "launches": launches,
           "replays": replays, "captured": recorded, "w8_kernels_run": w8_run,
           "w8_products": w8_products, "captured_w8_products": recorded_products,
           "w8_products_run": w8_products_run,
           # every W8 kernel's device time in the traced replayed step
           "w8_step_device_ms": sum(v for n, v in profiles["decode_replayed"]["counted_ms"]
                                    .items() if n.startswith("rm_w8")),
           "moe_kernels_run": moe_run,
           "moe_step_device_ms": profiles["decode_replayed"]["counted_ms"]["rm_moe_ffn"],
           "touched_experts": touched,
           "replayed_step_bit_equal_to_eager": replay_equal,
           "kernel_check": checked, "scan_check": scan_checked,
           "profiles": profiles, "traced_run": traced}
    del prefills, decodes
    return out


def traced_serve(torch, model, prompts, tokens: list, ran: dict) -> dict:
    """The same requests served again on a fresh session under
    ``torch.profiler``: the flash and W8 kernels the trace holds — the
    graph's replays included, which no wrapper counts — beside ``ran``,
    what the timed run ran of each; the tokens, which must equal ``tokens``
    (the timed run's); and the session's first tick and capture seconds
    (the profiler's host cost included).  A trace of a whole serving run
    (about 100,000 kernels) can lose records: on an H100 one held 7,677 of
    the 7,812 W8 kernels, with equal tokens.  So it must hold some of each
    kernel the run ran and no more, and ``lost`` says how many it missed;
    the exact counts are the wrappers' launches, the capture's records and
    the replays (:func:`serve_cell`)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    gc.collect()
    torch.cuda.empty_cache()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        reqs, prefills, decodes, step, _ = serve_session(
            torch, model, prompts, LM_SLOTS, LM_MAX_LEN, LM_MAX_NEW, True)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if getattr(e, "device_type", None) == DeviceType.CUDA]
    traced = {name: sum(e.count for e in kernels if name in e.key) for name in ran}
    out = {"launches": traced, "ran": ran,
           "lost": {name: ran[name] - traced[name] for name in ran},
           "prefills": len(prefills), "decode_steps": len(decodes),
           "replays": step.replays,
           "tokens_equal": [r.out for r in reqs] == tokens,
           "first_tick_seconds": decodes[0][0], "capture_seconds": step.capture_seconds}
    assert out["tokens_equal"], out
    assert step.replays == len(decodes), out
    for name, n in ran.items():
        assert (0 < traced[name] <= n) if n else traced[name] == 0, (name, out)
    del step, prefills, decodes, prof
    return out


def lm_serve_phase(torch, seed: int) -> dict:
    """qwen3-8b at full width on the card through ``ServeSession``, in bf16
    and then, on the same model quantized in place by
    ``quantize_for_serving``, int8; the flash kernel's and the W8 kernel's
    launches are counted on these runs alone."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.w8_matmul import dequantize
    from repro_torch.models.layers import QuantizedWeight, quantize_for_serving
    from repro_torch.models.lm import DecoderLM

    cfg = get_config(LM_ARCH)
    baseline = torch.cuda.memory_allocated()  # held before the model: not the cells'
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = DecoderLM(cfg, seed=seed)  # on the card
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights = sum(p.numel() for p in model.parameters())
    assert weights == cfg.param_count() and len(model.layers) == cfg.n_layers == 36
    rng = np.random.default_rng(seed + 11)
    prompts = lm_prompts(rng, LM_REQUESTS, *LM_PROMPT, cfg.vocab)
    bf16 = serve_cell(torch, model, cfg, prompts, int8=False)
    out = {"phase": "lm_serve", "weights": weights, "init_seconds": init_s,
           "baseline_memory_allocated": baseline, **bf16}
    emit(out)

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    quantize_for_serving(model)
    torch.cuda.synchronize()
    quantize_s = time.perf_counter() - t0
    quantize_peak = torch.cuda.max_memory_allocated()
    records = [m for m in model.modules() if isinstance(m, QuantizedWeight)]
    assert len(records) == 7 * cfg.n_layers, len(records)
    int8 = serve_cell(torch, model, cfg, prompts, int8=True)
    # the dequant's share of an int8 prefill: the casts a prefill runs (one
    # for each of the 252 weights: its rows exceed W8_DECODE_ROWS), timed
    # alone by CUDA events (a device-bound loop), against the profiled
    # prefill's device-busy time
    dtype = model.compute_dtype
    def dequant_all():
        for r in records:
            dequantize(r.q, r.s, dtype)

    dequant_ms = time_ms(torch, dequant_all, 3)
    busy = int8["profiles"]["prefill"]["device_busy_ms"]
    int8_line = {"phase": "lm_serve_int8", "quantize_seconds": quantize_s,
                 "quantize_peak_memory": quantize_peak,
                 "int8_weight_bytes": sum(r.q.numel() + 2 * r.s.numel() for r in records),
                 "prefill_dequant_ms": dequant_ms,
                 "prefill_dequant_share": (dequant_ms / busy) if dequant_ms and busy else None,
                 **int8,
                 "bf16": {k: bf16[k] for k in (
                     "prefill_seconds", "decode_tick_ms_median", "generated_tokens_per_s",
                     "max_memory_allocated")}}
    emit(int8_line)
    del model, records
    gc.collect()
    torch.cuda.empty_cache()
    return {"bf16": out, "int8": int8_line}


def moe_step_bound(cfg, touched: list, slots: int, max_len: int) -> tuple[float, dict]:
    """The least time of one decode step of an MoE model, by bytes: every
    layer's attention weights and router, its touched experts' weights, the
    whole KV cache (attention reads every position) and ``lm_head``, read
    once over the memory rate, in bf16."""
    d, hd, h, kh = cfg.d_model, cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    parts = {"attention": cfg.n_layers * (d * hd * (h + 2 * kh) + h * hd * d) * 2,
             "router": cfg.n_layers * d * cfg.n_experts * 2,
             "experts": sum(touched) * 3 * d * cfg.d_ff * 2,
             "kv_cache": cfg.n_layers * 2 * slots * kh * max_len * hd * 2,
             "lm_head": d * cfg.padded_vocab * 2}
    return sum(parts.values()) / hw().hbm_bw * 1e3, parts


def lm_serve_moe_phase(torch, seed: int) -> dict:
    """``qwen3-moe-235b-a22b`` at full width on the card, its depth cut to
    ``MOE_LAYERS`` of 94 layers (one card holds 12: 62.2 GB of bf16
    weights), weights drawn from ``--seed``, serving the dense cell's 16
    requests through ``ServeSession`` (:func:`serve_cell`): every decode
    step's expert FFN on the MoE kernel, two launches a layer, and its plain
    version never; the serving run's peak must leave ``MOE_FREE_BYTES`` of
    the card."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.lm import DecoderLM

    full = get_config(MOE_ARCH)
    cfg = dataclasses.replace(full, n_layers=MOE_LAYERS)
    reduced = {"n_layers": [full.n_layers, cfg.n_layers]}
    emit({"phase": "lm_serve_moe_config", "arch": cfg.name, "reduced": reduced,
          "reason": "one card's 80 GB holds 12 layers of 2.49 B bf16 weights (4.98 GB) "
                    "beside the embedding and lm_head (2.49 GB) and the prefill's transients"})
    gc.collect()
    torch.cuda.empty_cache()
    baseline = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = DecoderLM(cfg, seed=seed)  # on the card
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    weights = sum(p.numel() for p in model.parameters())
    assert weights == cfg.param_count() and len(model.layers) == MOE_LAYERS, weights
    rng = np.random.default_rng(seed + 11)
    prompts = lm_prompts(rng, LM_REQUESTS, *LM_PROMPT, cfg.vocab)
    cell = serve_cell(torch, model, cfg, prompts, int8=False,
                      check_layers=(0, MOE_LAYERS - 1))
    total = torch.cuda.get_device_properties(0).total_memory
    peak = max(cell["max_memory_allocated"], init_peak)
    reserved = torch.cuda.max_memory_reserved()
    bound_ms, parts = moe_step_bound(cfg, cell["touched_experts"], LM_SLOTS, LM_MAX_LEN)
    replayed = cell["profiles"]["decode_replayed"]
    out = {"phase": "lm_serve_moe", "weights": weights,
           "weight_bytes": sum(p.numel() * p.element_size() for p in model.parameters()),
           "reduced": reduced, "init_seconds": init_s, "init_peak_memory": init_peak,
           "baseline_memory_allocated": baseline, "total_memory": total,
           "free_at_peak": total - peak, "max_memory_reserved": reserved,
           "decode_step_bound_ms": bound_ms, "decode_step_bound_bytes": parts,
           "replayed_bound_share": (bound_ms / replayed["replayed_ms"]
                                    if replayed["replayed_ms"] else None), **cell,
           "weight_count": weights}  # the cell's "weights" names their dtype
    emit(out)
    assert total - peak >= MOE_FREE_BYTES, (total, peak)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def step_bound(model, cache) -> tuple[float, dict]:
    """The least time of one decode step of ``model`` over ``cache``, by
    bytes: every weight of the decoder's layers and ``lm_head`` read once
    (not an encoder's, which a step does not run), the step's ``LM_SLOTS``
    input rows (embedding rows gathered, or the embeddings fed), each
    attention layer's KV cache read whole (a step attends over every slot),
    an encoder-decoder's cross K/V read, each recurrent state read and
    written, over the memory rate."""
    kv, cross = ("k", "v"), ("cross_k", "cross_v")

    def cache_bytes(keep):
        return sum(t.nbytes for c in cache for n, t in c.items() if keep(n))

    head = model.lm_head
    parts = {"layers": sum(p.numel() * p.element_size() for p in model.layers.parameters()),
             "lm_head": head.numel() * head.element_size(),
             "embedding_rows": LM_SLOTS * model.cfg.d_model * head.element_size(),
             "kv_cache": cache_bytes(lambda n: n in kv),
             "cross_kv_read": cache_bytes(lambda n: n in cross),
             "state_read_written": 2 * cache_bytes(lambda n: n not in kv + cross)}
    return sum(parts.values()) / hw().hbm_bw * 1e3, parts


def lm_serve_recurrent_phase(torch, seed: int, arch: str, phase: str,
                             check_layers=(), scan_layers=()) -> dict:
    """``arch`` at full width and depth on the card (nothing cut), weights
    drawn from ``--seed``, serving the dense cell's 16 requests through
    ``ServeSession`` (:func:`serve_cell`: a replayed step bit-equal to an
    eager one, states included; the flash kernel on ``check_layers`` and the
    scan kernel on ``scan_layers`` against their plain versions; launch
    counts; a profiled prefill and replayed step).  Adds the step's bound by
    bytes (:func:`step_bound`), the peak memory of one prefill of the first
    admission alone and of the whole run, and for a model with RG-LRU layers
    the float32 gate products' share of the profiled prefill: one ``xr @
    w_a`` at the prefill's shape timed by CUDA events, times two gates and
    the RG-LRU layers, against the prefill's device-busy time."""
    from repro_torch.configs import get_config
    from repro_torch.models.lm import DecoderLM

    cfg = get_config(arch)
    gc.collect()
    torch.cuda.empty_cache()
    baseline = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = DecoderLM(cfg, seed=seed)  # on the card
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    weights = sum(p.numel() for p in model.parameters())
    assert weights == cfg.param_count() and len(model.layers) == cfg.n_layers, weights
    rng = np.random.default_rng(seed + 11)
    prompts = lm_prompts(rng, LM_REQUESTS, *LM_PROMPT, cfg.vocab)
    cell = serve_cell(torch, model, cfg, prompts, int8=False, check_layers=check_layers,
                      scan_layers=scan_layers)
    toks = first_admission(torch, prompts, model.device)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    _, cache = model.prefill({"tokens": toks}, LM_MAX_LEN)
    torch.cuda.synchronize()
    prefill_peak = torch.cuda.max_memory_allocated()
    bound_ms, parts = step_bound(model, cache)
    del cache
    _, rglru = layer_counts(model)
    gates = None
    if rglru:
        w = model.cfg.lru_width or cfg.d_model
        xr = torch.randn((toks.numel(), w), device="cuda")
        w_a = model.layers[0].mixer.w_a
        one = time_ms(torch, lambda: xr @ w_a, 5)
        busy = cell["profiles"]["prefill"]["device_busy_ms"]
        gates = {"one_product_ms": one, "shape": [toks.numel(), w, w], "dtype": str(w_a.dtype),
                 "tf32": torch.backends.cuda.matmul.allow_tf32, "products": 2 * rglru,
                 "prefill_ms": 2 * rglru * one,
                 "prefill_share": (2 * rglru * one / busy) if busy else None}
        del xr
    total = torch.cuda.get_device_properties(0).total_memory
    peak = max(cell["max_memory_allocated"], init_peak, prefill_peak)
    replayed = cell["profiles"]["decode_replayed"]
    out = {"phase": phase,
           "weight_bytes": sum(p.numel() * p.element_size() for p in model.parameters()),
           "reduced": {}, "init_seconds": init_s, "init_peak_memory": init_peak,
           "baseline_memory_allocated": baseline, "total_memory": total,
           "prefill_peak_memory": prefill_peak, "prefill_memory_before": before,
           "free_at_peak": total - peak, "max_memory_reserved": torch.cuda.max_memory_reserved(),
           "decode_step_bound_ms": bound_ms, "decode_step_bound_bytes": parts,
           "replayed_bound_share": (bound_ms / replayed["replayed_ms"]
                                    if replayed["replayed_ms"] else None),
           "gate_products": gates, **cell,
           "weight_count": weights}  # the cell's "weights" names their dtype
    emit(out)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def prefill_products(model, slots: int, s: int, frames: int) -> int:
    """Operations (a multiply and an add each) of a prefill's weight
    products: every 2-D weight of the decoder's layers over ``slots * s``
    tokens; an encoder-decoder's encoder layers and each decoder layer's
    cross ``wk`` / ``wv`` over ``slots * frames`` frames instead.  The
    attention itself (the flash kernel's lines count it) and ``lm_head``
    (one position) are left out."""
    def weights(module, skip=()):
        return sum(p.numel() for n, p in module.named_parameters()
                   if p.dim() == 2 and not n.endswith(skip))

    cross = (".cross.wk", ".cross.wv")
    ops = 2 * slots * s * weights(model.layers, cross)
    if hasattr(model, "enc_layers"):
        ops += 2 * slots * frames * (weights(model.enc_layers) + sum(
            p.numel() for n, p in model.layers.named_parameters() if n.endswith(cross)))
    return ops


def lm_serve_inputs_phase(torch, seed: int, arch: str, phase: str,
                          n_layers: int | None = None) -> dict:
    """``arch`` (one of ``LM_INPUT_ARCHS``) at full width on the card, its
    depth cut to ``n_layers`` where one is given, weights and inputs drawn
    from ``--seed``, serving two admissions of ``LM_SLOTS`` requests (prompts
    of ``VLM_PROMPTS``; the VLM's image-and-text embeddings and M-RoPE ids,
    the encoder-decoder's ``ENCDEC_FRAMES`` frames and tokens) with
    ``LM_MAX_NEW`` new positions each through :func:`drive`, its decode
    steps replayed from a CUDA graph.  Checks what came out (tokens in the
    vocab, finite logits of the padded vocab), the flash kernel's launches
    (once per attention layer, the encoder's included, and prefill; none
    in a step), its output on the first and last attention layer against
    its plain version, and one replayed step bit-equal to an eager one on a
    copy of the same cache (every key).  Prints prefill seconds, the median
    tick, tokens a second, the peak memory (which must leave
    ``MOE_FREE_BYTES`` of the card), a profiled prefill and replayed and
    eager step, the prefill's product operations and bound, and the step's
    bound by bytes (:func:`step_bound`)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import _cuda
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import build_model
    from repro_torch.serve.engine import make_decode_step

    full = get_config(arch)
    cfg = dataclasses.replace(full, n_layers=n_layers) if n_layers else full
    reduced = {"n_layers": [full.n_layers, cfg.n_layers]} if n_layers else {}
    gc.collect()
    torch.cuda.empty_cache()
    baseline = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = build_model(cfg, seed=seed)  # on the card
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    weights = sum(p.numel() for p in model.parameters())
    # param_count counts a token embedding the VLM has not, and no enc_norm
    want = cfg.param_count() + (cfg.d_model if cfg.is_encdec else 0) - (
        0 if cfg.embed_inputs else cfg.padded_vocab * cfg.d_model)
    assert weights == want and len(model.layers) == cfg.n_layers, (weights, want)
    gen = torch.Generator(device="cuda").manual_seed(seed + 11)
    dt = model.compute_dtype
    adm = input_admissions(
        torch, cfg, VLM_PROMPTS, LM_SLOTS, LM_MAX_NEW, ENCDEC_FRAMES,
        lambda shape: torch.randn(shape, generator=gen, device="cuda").mul_(0.5).to(dt),
        lambda shape: torch.randint(0, cfg.vocab, shape, generator=gen, device="cuda"),
        VLM_PREFIX, VLM_GRID)
    attends = ([("enc_layers", 0, model.enc_layers[0].mixer)] if cfg.is_encdec
               else [("layers", 0, model.layers[0].mixer)])
    attends.append(("layers", cfg.n_layers - 1, model.layers[-1].mixer))
    captured: dict = {}

    def capture(key):
        def hook(module, args, result):
            if key not in captured:  # the first prefill's inputs and output
                captured[key] = (args, result, module.spec.causal)
        return hook

    hooks = [mixer.attend.register_forward_hook(capture(f"{where}.{i}"))
             for where, i, mixer in attends]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tokens, prefills, decodes, step = drive(torch, model, adm, LM_MAX_LEN, LM_MAX_NEW, True)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = _cuda.LAUNCHES["flash_attention"]
    replays, recorded, capture_s = step.replays, step.captured, step.capture_seconds
    del step
    for hk in hooks:
        hk.remove()
    serve_peak = torch.cuda.max_memory_allocated()
    assert launches == flash_layers(model) * len(adm), launches
    assert recorded["flash_attention"] == 0 and replays == len(decodes), (recorded, replays)
    assert len(decodes) == len(adm) * (LM_MAX_NEW - 1)
    assert all(t.shape == (LM_SLOTS, LM_MAX_NEW) for t in tokens)
    assert all(0 <= int(t.min()) and int(t.max()) < cfg.vocab for t in tokens)
    for _, logits in prefills + decodes:
        assert logits.shape == (LM_SLOTS, cfg.padded_vocab)
        assert bool(torch.isfinite(logits).all())
    checked = {}
    for key, ((q, k, v), result, causal) in captured.items():
        again = FA.flash_attention(q, k, v, causal=causal)
        want_out = FA.flash_attention_torch(q, k, v, causal=causal)
        torch.cuda.synchronize()  # a compare launch, not counted above
        assert torch.equal(again, result), key  # the path's output is the kernel's
        checked[key] = {"shape": list(q.shape), "kv_heads": k.shape[2], "causal": causal,
                        **flash_check(result, want_out, cfg.compute_dtype)}
    assert len(checked) == 2, sorted(checked)
    del captured
    generated = sum(t.numel() for t in tokens)
    decode_ms = [1e3 * t for t, _ in decodes]
    # where a step's time goes: the first admission's prefill and one decode
    # step again, after the counts were read
    batch, step_inputs = adm[0]
    s = (batch["embeds"] if "embeds" in batch else batch["tokens"]).shape[1]
    logits, cache = model.prefill(batch, LM_MAX_LEN)
    x = logits.argmax(-1)[:, None] if step_inputs is None else step_inputs[0]
    twin = [{n: t.clone() for n, t in c.items()} for c in cache]
    step = make_decode_step(model)
    replayed, _ = step(cache, x, s)
    eager, _ = model.decode_step(twin, x, s)
    torch.cuda.synchronize()
    replay_equal = torch.equal(replayed, eager) and all(
        torch.equal(a[n], b[n]) for a, b in zip(cache, twin) for n in a)
    assert replay_equal, float((replayed - eager).abs().max())
    del twin, replayed, eager, logits
    profiles = {
        "prefill": profile_step(torch, lambda: model.prefill(batch, LM_MAX_LEN),
                                count=("rm_flash_attention", "gemm")),
        "decode_replayed": profile_step(torch, lambda: step(cache, x, s), replays=50),
        "decode_eager": profile_step(torch, lambda: model.decode_step(cache, x, s)),
    }
    bound_ms, parts = step_bound(model, cache)
    del cache, step
    products = prefill_products(model, LM_SLOTS, s, ENCDEC_FRAMES)
    total = torch.cuda.get_device_properties(0).total_memory
    peak = max(torch.cuda.max_memory_allocated(), init_peak)
    replayed_ms = profiles["decode_replayed"]["replayed_ms"]
    busy = profiles["prefill"]["device_busy_ms"]
    out = {"phase": phase, "arch": cfg.name, "layers": cfg.n_layers,
           "encoder_layers": cfg.n_enc_layers, "d_model": cfg.d_model,
           "dtype": cfg.compute_dtype, "reduced": reduced, "weight_count": weights,
           "weight_bytes": sum(p.numel() * p.element_size() for p in model.parameters()),
           "init_seconds": init_s, "init_peak_memory": init_peak,
           "baseline_memory_allocated": baseline, "total_memory": total,
           "max_memory_allocated": peak, "serve_peak_memory": serve_peak,
           "free_at_peak": total - peak,
           "max_memory_reserved": torch.cuda.max_memory_reserved(),
           "slots": LM_SLOTS, "max_len": LM_MAX_LEN, "admissions": len(adm),
           "prefill_lengths": list(VLM_PROMPTS),
           "encoder_frames": ENCDEC_FRAMES if cfg.is_encdec else None,
           "prefill_seconds": [t for t, _ in prefills],
           "decode_steps": len(decodes), "decode_tick_ms_median": statistics.median(decode_ms),
           "decode_tick_ms": decode_ms, "serve_seconds": serve_s,
           "generated_tokens": generated, "generated_tokens_per_s": generated / serve_s,
           "capture_seconds": capture_s, "replays": replays, "captured": recorded,
           "launches": {"flash_attention": launches},
           "replayed_step_bit_equal_to_eager": replay_equal, "kernel_check": checked,
           "prefill_product_ops": products,
           "prefill_products_bound_ms": products / hw().peak_flops * 1e3,
           "prefill_products_bound_share": (products / hw().peak_flops * 1e3 / busy
                                            if busy else None),
           "decode_step_bound_ms": bound_ms, "decode_step_bound_bytes": parts,
           "replayed_bound_share": (bound_ms / replayed_ms) if replayed_ms else None,
           "profiles": profiles}
    emit(out)
    assert total - peak >= MOE_FREE_BYTES, (total, peak)
    del model, adm, prefills, decodes
    gc.collect()
    torch.cuda.empty_cache()
    return out


# the words the mixed batch (and the engine's solo steps) read
BATCH_WORDS = (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 12, 15)
# table uid -> (version, {word: contiguous column}) for the numpy oracles
_HOST_COLUMNS: dict = {}


# ------------------------------------------------------------ train phase
def record_store(torch, seq: int, samples: int, vocab: int):
    """A record store on the card holding ``samples`` samples of ``seq``
    tokens from ``synthetic_corpus(seed=1)``, its rows uploaded."""
    from repro_torch.data import RecordStore, synthetic_corpus

    store = RecordStore(seq_len=seq, device="cuda")
    store.ingest(*synthetic_corpus(samples, seq, vocab, seed=1))
    store.engine.device_words(store.table)
    return store


def wide_projection_phase(torch, reps: int) -> dict:
    """Fault 3.2's repair on the card: the ``(tokens, labels)`` view of a
    record store of ``TRAIN_SAMPLES`` samples at each of ``WIDE_SEQS`` —
    4,096 and 8,192 packed words of 4,101- and 8,197-word rows — through
    the three revisions, and the first ``WIDE_NARROW`` tokens through
    ``mlp`` (the span kernel's host work at a narrow view), each one launch
    and bit-equal to the plain version, timed beside its bound by bytes and
    one ``index_select`` (medians of at least ``WIDE_REPS`` calls);
    ``host_ms`` is a call's ``kernel_ms`` less its device time."""
    from repro_torch.configs import get_config
    from repro_torch.core import TableGeometry
    from repro_torch.kernels import _cuda
    from repro_torch.kernels import ops as K
    from repro_torch.kernels.common import geometry_words

    vocab = get_config(TRAIN_ARCH).vocab
    out = {}
    timed = max(reps, WIDE_REPS)
    for seq in WIDE_SEQS:
        store = record_store(torch, seq, TRAIN_SAMPLES, vocab)
        words = store.engine.device_words(store.table)
        view = store.project(("tokens", "labels")).geometry
        n, row_words = words.shape
        tok_off = store.schema.byte_offset("tokens")
        narrow = TableGeometry(view.row_bytes, view.row_count, (4 * WIDE_NARROW,), (tok_off,))
        cases = [("mlp", "project", view, ""), ("pck", "project_pck", view, ""),
                 ("bsl", "project_bsl", view, ""), ("mlp", "project", narrow, f"_w{WIDE_NARROW}")]
        for rev, name, geom, suffix in cases:
            idx = torch.tensor(geometry_words(geom), dtype=torch.long, device="cuda")
            want = K.project_torch(words, geom)
            bound_ms, bound_by = bound(set(geometry_words(geom)), want.numel() * 4, n,
                                       row_words * 4, 0)
            run = lambda: K.project(words, geom, rev)  # noqa: E731
            library = lambda: words.index_select(1, idx)  # noqa: E731
            _cuda.reset_launches()
            got = run()
            torch.cuda.synchronize()
            assert _cuda.LAUNCHES[name] == 1, dict(_cuda.LAUNCHES)
            assert torch.equal(got, want), (seq, rev, suffix)
            line = {"phase": "wide_projection", "name": f"{name}_s{seq}{suffix}", "kernel": name,
                    "rows": n, "row_words": row_words, "packed_words": want.shape[1],
                    "direct": row_words > _cuda.DIRECT_ROW_WORDS, "bit_equal": True,
                    "max_abs_err": 0.0, "kernel_ms": time_ms(torch, run, timed),
                    **device_fields(torch, run, reps),
                    "plain_ms": time_ms(torch, lambda: K.project_torch(words, geom),
                                        max(3, reps // 3)),
                    "library_ms": time_ms(torch, library, timed),
                    **device_fields(torch, library, reps, "library_"),
                    "library_call": "torch.index_select", "bound_ms": bound_ms,
                    "bound_by": bound_by}
            line["bound_share"] = bound_ms / line["kernel_ms"]
            line["host_ms"] = line["device_ms"] and line["kernel_ms"] - line["device_ms"]
            line["library_host_ms"] = (line["library_device_ms"]
                                       and line["library_ms"] - line["library_device_ms"])
            if line["device_ms"]:
                line["device_bound_share"] = bound_ms / line["device_ms"]
            emit(line)
            out[line["name"]] = line
            del got, want, idx
        del store, words
        gc.collect()
        torch.cuda.empty_cache()
    return out


def bf16_step(x: float) -> float:
    """One step of bf16 (8 significant bits) at ``x`` > 0: 2^-7 of the
    power of two at or below it."""
    return math.ldexp(1.0, math.frexp(x)[1] - 8)


def grad_check(torch, dtype: str, got, recompute, exact, plain) -> dict:
    """The backward kernel's gradients ``got`` (dq, dk, dv) held to the
    limits above: against the bf16 (or float32) ``recompute``, the float32
    ``exact`` ones and the kernel's ``plain`` version.  Each error is the
    largest over the gradient's largest magnitude (``vs_plain_steps``: over
    one bf16 step there); raises past a limit."""
    out: dict = {}
    for key, g, r, x, pl in zip(("dq", "dk", "dv"), got, recompute, exact, plain):
        def err(a, b):
            return float((a.float() - b.float()).abs().max())

        scale, scale32 = float(r.float().abs().max()), float(x.abs().max())
        line = {"vs_recompute": err(g, r) / scale, "vs_plain": err(g, pl) / scale,
                "vs_plain_steps": err(g, pl) / bf16_step(float(pl.float().abs().max())),
                "vs_float32": err(g, x) / scale32, "recompute_vs_float32": err(r, x) / scale32,
                "max_abs_err_plain": err(g, pl), "finite": bool(torch.isfinite(g).all())}
        assert line["finite"], (key, line)
        if dtype == "bfloat16":
            assert line["vs_plain_steps"] <= FLASH_GRAD_PLAIN_STEPS, (key, line)
            assert line["vs_float32"] <= FLASH_GRAD_BF16_FACTOR * line["recompute_vs_float32"], \
                (key, line)
            assert line["vs_recompute"] <= FLASH_GRAD_BF16_TOL, (key, line)
        else:
            assert line["vs_plain"] <= FLASH_GRAD_F32_TOL, (key, line)
            assert line["vs_recompute"] <= FLASH_GRAD_F32_TOL, (key, line)
        out[key] = line
    return out


def flash_fwd_bwd(torch, fn, inputs, dout, **kw):
    """``fn``'s output on leaves made from ``inputs``, and the leaves'
    gradients under ``dout``."""
    leaves = [t.detach().requires_grad_() for t in inputs]
    o = fn(*leaves, **kw)
    return o, torch.autograd.grad(o, leaves, dout.to(o.dtype))


def flash_grad_case(torch, g, b: int, s: int, h: int, kh: int, d: int, causal: bool,
                    window: int | None, dtype: str) -> tuple[dict, dict, tuple]:
    """One gradient through ``FlashAttention`` on the card, q, k, v and
    dout of ``dtype`` drawn from ``g``: one launch of the forward kernel
    (the output within ``FLASH_TOL`` of the plain version) and one of the
    backward kernel (``rm_flash_bwd.cu``), dq, dk and dv held by
    :func:`grad_check` against the plain recompute (autograd of
    ``flash_attention_torch``), the float32 gradients and the kernel's
    plain version (``flash_attention_backward_torch``) on the same output
    and lse; a second backward call bit-equal; the forward's output
    bit-equal with the lse stored and without.  Returns the forward's
    check, the gradients' readings and the backward kernel's arguments."""
    from repro_torch.kernels import _cuda
    from repro_torch.kernels import flash_attention as FA

    base = [torch.randn((b, s, n, d), generator=g, device="cuda", dtype=getattr(torch, dtype))
            for n in (h, kh, kh)]
    dout = torch.randn((b, s, h, d), generator=g, device="cuda", dtype=getattr(torch, dtype))
    kw = dict(causal=causal, window=window, block_k=TRAIN_ATTN_CHUNK)
    _cuda.reset_launches()
    got, grads = flash_fwd_bwd(torch, FA.flash_attention, base, dout, **kw)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["flash_attention"] == 1, dict(_cuda.LAUNCHES)
    assert _cuda.LAUNCHES["flash_attention_backward"] == 1, dict(_cuda.LAUNCHES)
    want, want_grads = flash_fwd_bwd(torch, FA.flash_attention_torch, base, dout, **kw)
    check = flash_check(got.detach(), want.detach(), dtype)
    _, exact = flash_fwd_bwd(torch, FA.flash_attention_torch, [t.float() for t in base],
                             dout, **kw)
    o, lse = _cuda.run_flash(*base, causal, window, lse=True)
    assert torch.equal(o, got) and torch.equal(o, _cuda.run_flash(*base, causal, window))
    args = (*base, o, lse, dout, causal, window)
    assert all(torch.equal(a, c) for a, c in zip(grads, _cuda.run_flash_backward(*args)))
    plain = FA.flash_attention_backward_torch(*args, block_k=TRAIN_ATTN_CHUNK)
    return check, grad_check(torch, dtype, grads, want_grads, exact, plain), args


def flash_backward_phase(torch, seed: int, reps: int) -> dict:
    """``FlashAttention`` at ``FLASH_BACKWARD_SHAPES`` (the train layer's and
    recurrentgemma-9b's local layer's, D 256, in the tensor-core forms, the
    smokes' in float32 on the CUDA cores), each checked by
    :func:`flash_grad_case`, then
    ``FLASH_BACKWARD_CASES`` in bf16 and float32 checked alike, untimed
    (``flash_backward_cases``: every case's readings and the largest of
    each by dtype).  Timed at each shape: the forward alone, forward +
    backward, the backward kernel alone (events and device time), the plain
    recompute's forward + backward and the plain backward; the backward's
    bound is ``roofline.analysis.FLASH_BACKWARD_OPS`` (2.5: the 5 products a
    pair of the least backward against the forward's 2) times the
    forward's operations.  Beside
    them, a yardstick the port never calls: one
    ``scaled_dot_product_attention`` on the same inputs under autograd
    (``is_causal`` with ``enable_gqa``, a bool mask for the window, none
    bidirectional), forward and forward + backward (events), the device
    time of its backward's kernels alone (``library_backward_device_ms``,
    ``backward_over_library_device`` beside the events' ratio), and the
    backend that runs it (``sdpa_backend``)."""
    import torch.nn.functional as Fn

    from repro_torch.kernels import _cuda
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.roofline import analysis as A

    out = {}
    g = torch.Generator(device="cuda").manual_seed(seed + 23)
    for name, b, s, h, kh, d, causal, window, dtype in FLASH_BACKWARD_SHAPES:
        check, grad, args = flash_grad_case(torch, g, b, s, h, kh, d, causal, window, dtype)
        base, dout = list(args[:3]), args[5]
        kw = dict(causal=causal, window=window, block_k=TRAIN_ATTN_CHUNK)
        leaves = [t.detach().requires_grad_() for t in base]
        fwd = lambda: FA.flash_attention(*leaves, **kw)  # noqa: E731
        both = lambda: flash_fwd_bwd(torch, FA.flash_attention, base, dout, **kw)  # noqa: E731
        plain = lambda: flash_fwd_bwd(  # noqa: E731
            torch, FA.flash_attention_torch, base, dout, **kw)
        bwd = lambda: _cuda.run_flash_backward(*args)  # noqa: E731
        plain_bwd = lambda: FA.flash_attention_backward_torch(  # noqa: E731
            *args, block_k=TRAIN_ATTN_CHUNK)
        fwd_bound, by = flash_bound(b, s, h, kh, d, causal, window, base[0].element_size())
        line = {"phase": "flash_backward", "name": name,
                "form": _cuda.flash_backward_form(getattr(torch, dtype), d),
                "forward_ms": time_ms(torch, fwd, reps),
                "forward_backward_ms": time_ms(torch, both, max(3, reps // 3)),
                "backward_kernel_ms": time_ms(torch, bwd, reps),
                **device_fields(torch, bwd, reps, "backward_"),
                "plain_forward_backward_ms": time_ms(torch, plain, 3),
                "plain_backward_ms": time_ms(torch, plain_bwd, 3),
                "forward_bound_ms": fwd_bound, "forward_bound_by": by,
                "backward_bound_ms": A.FLASH_BACKWARD_OPS * fwd_bound, **check,
                "grad": grad, "grad_limits": flash_grad_limits(dtype),
                "shape": {"B": b, "S": s, "H": h, "KH": kh, "D": d, "causal": causal,
                          "window": window, "dtype": dtype, "key_step": TRAIN_ATTN_CHUNK}}
        line["backward_ms"] = line["forward_backward_ms"] - line["forward_ms"]
        line["backward_bound_share"] = line["backward_bound_ms"] / line["backward_kernel_ms"]
        if line["backward_device_ms"]:
            line["backward_device_bound_share"] = (line["backward_bound_ms"]
                                                   / line["backward_device_ms"])
        mask = None
        if window is not None:
            i = torch.arange(s, device="cuda")
            dist = i[:, None] - i[None, :]
            mask = (dist >= 0) & (dist < window)

        def sdpa(q, k, v, **_):
            o = Fn.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask,
                is_causal=causal and mask is None, enable_gqa=True)
            return o.transpose(1, 2)

        backend, kernels = sdpa_backend(torch, lambda: flash_fwd_bwd(torch, sdpa, base, dout),
                                        *(t.transpose(1, 2) for t in leaves), mask, causal)
        line.update({
            "library_call": "torch.nn.functional.scaled_dot_product_attention under autograd"
                            + (" (bool window mask)" if mask is not None
                               else " (is_causal)" if causal else " (no mask)"),
            "library_backend": backend, "library_kernels": kernels,
            "library_forward_ms": time_ms(torch, lambda: sdpa(*leaves), reps),
            "library_forward_backward_ms": time_ms(
                torch, lambda: flash_fwd_bwd(torch, sdpa, base, dout), max(3, reps // 3))})
        line["library_backward_ms"] = (line["library_forward_backward_ms"]
                                       - line["library_forward_ms"])
        line["backward_over_library"] = line["backward_ms"] / line["library_backward_ms"]
        # the device time of the kernels SDPA's backward alone launches: one
        # forward, then its graph walked again and again
        lib_leaves = [t.detach().requires_grad_() for t in base]
        lib_out = sdpa(*lib_leaves)
        lib_dout = dout.to(lib_out.dtype)
        line.update(device_fields(torch, lambda: torch.autograd.grad(  # noqa: E731
            lib_out, lib_leaves, lib_dout, retain_graph=True), reps, "library_backward_"))
        line["backward_over_library_device"] = (
            line["backward_device_ms"] / line["library_backward_device_ms"]
            if line["backward_device_ms"] and line["library_backward_device_ms"] else None)
        del lib_leaves, lib_out, lib_dout
        emit(line)
        out[name] = line
        del base, dout, leaves, args
        torch.cuda.empty_cache()
    cases: dict = {"bfloat16": [], "float32": []}
    largest: dict = {"bfloat16": {}, "float32": {}}
    for dtype, rows in cases.items():
        for case in FLASH_BACKWARD_CASES:
            check, grad, _ = flash_grad_case(torch, g, *case, dtype)
            rows.append({"case": list(case), "limit_share": check["limit_share"],
                         "form": _cuda.flash_backward_form(getattr(torch, dtype), case[4]),
                         "grad": grad})
            for r in grad.values():
                for k, v in r.items():
                    if k.startswith("vs_"):
                        largest[dtype][k] = max(v, largest[dtype].get(k, 0.0))
    emit({"phase": "flash_backward_cases", "cases": cases, "largest": largest,
          "grad_limits": {dtype: flash_grad_limits(dtype) for dtype in cases}})
    torch.cuda.empty_cache()
    return out


def flash_grad_limits(dtype: str) -> dict:
    """The limits :func:`grad_check` holds ``dtype``'s gradients to."""
    if dtype == "bfloat16":
        return {"vs_float32_over_recompute": FLASH_GRAD_BF16_FACTOR,
                "vs_recompute": FLASH_GRAD_BF16_TOL, "vs_plain_steps": FLASH_GRAD_PLAIN_STEPS}
    return {"vs_recompute": FLASH_GRAD_F32_TOL, "vs_plain": FLASH_GRAD_F32_TOL}


def flash_backward_kernel(lines: dict) -> dict:
    """The ``kernels`` entry of the backward kernel, from the causal line:
    the wrapper's time (events), its plain version's, the bound and SDPA's
    backward beside it; the error, the largest against the plain version."""
    line = lines["flash_backward"]
    return {"max_abs_err": max(g["max_abs_err_plain"] for g in line["grad"].values()),
            "kernel_ms": line["backward_kernel_ms"], "plain_ms": line["plain_backward_ms"],
            "bound_ms": line["backward_bound_ms"], "bound_by": line["forward_bound_by"],
            "library_ms": line["library_backward_ms"]}


SDPA_BACKENDS = {0: "math", 1: "flash", 2: "efficient", 3: "cudnn", 4: "overrideable"}


def sdpa_backend(torch, fn, q, k, v, mask, causal: bool) -> tuple[str, list[str]]:
    """The backend ``scaled_dot_product_attention`` runs for ``q``, ``k``,
    ``v`` (``(B, heads, S, D)``, with ``enable_gqa``): the dispatcher's own
    choice (``torch._fused_sdp_choice``, ``torch.nn.attention.SDPBackend``'s
    numbering), and the names of the kernels one traced call of ``fn``
    launched, at most eight (a trace that held none is taken again, up to
    three times; empty if none did)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    choice = torch._fused_sdp_choice(q, k, v, attn_mask=mask, dropout_p=0.0,
                                     is_causal=causal and mask is None, enable_gqa=True)
    fn()
    torch.cuda.synchronize()
    names: list[str] = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = sorted({e.key[:80] for e in prof.key_averages()
                        if getattr(e, "device_type", None) == DeviceType.CUDA})
        if names:
            break
    return SDPA_BACKENDS.get(int(choice), f"unknown ({int(choice)})"), names[:8]


def scan_backward_phase(torch, seed: int, reps: int) -> dict:
    """The scan's gradient at the hybrid's prefill shape (``RGLRU_SHAPE``,
    B 8) and at ``train_rg``'s microbatch (``RGLRU_TRAIN_SHAPE``, B 2): under
    autograd the forward kernel and the gradient's kernel one launch each,
    da and dx bit-equal to the plain reverse loop on the card.  The gradient
    kernel alone (``run_rglru_scan_backward``) timed by events and by device
    beside its bound by bytes (a, h, dh read, da, dx written once); at B 2
    the forward kernel too, beside its own bound.  Returns the ``kernels``
    entry of ``rglru_scan_backward``, from the B 8 line (no one torch call
    computes a reverse linear recurrence: ``library_ms`` null)."""
    import dataclasses

    from repro_torch.kernels import _cuda
    from repro_torch.kernels import rglru_scan as RS
    from repro_torch.roofline import analysis as A

    lines = {}
    for name, (b, s, w) in (("rglru_scan_backward", RGLRU_SHAPE),
                            ("rglru_scan_backward_b2", RGLRU_TRAIN_SHAPE)):
        g = torch.Generator(device="cuda").manual_seed(seed + 29 + b)
        a = torch.rand((b, s, w), generator=g, device="cuda").clamp_(min=1e-6).requires_grad_()
        x = torch.randn((b, s, w), generator=g, device="cuda").requires_grad_()
        dh = torch.randn((b, s, w), generator=g, device="cuda")
        _cuda.reset_launches()
        h = RS.rglru_scan(a, x)
        da, dx = torch.autograd.grad(h, (a, x), dh)
        torch.cuda.synchronize()
        launched = {k: v for k, v in _cuda.LAUNCHES.items() if v}
        assert launched == {"rglru_scan": 1, "rglru_scan_backward": 1}, launched
        a0, h0 = a.detach(), h.detach()
        t0 = time.perf_counter()
        want_da, want_dx = RS.rglru_scan_backward_torch(a0, h0, dh)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = max(float((da - want_da).abs().max()), float((dx - want_dx).abs().max()))
        bit_equal = torch.equal(da, want_da) and torch.equal(dx, want_dx)
        assert bit_equal, err
        kernel = lambda: _cuda.run_rglru_scan_backward(a0, h0, dh)  # noqa: E731
        nbytes = A.rglru_scan_backward_work(b, s, w)[1]
        line = {"phase": "scan_backward", "name": name, "launches": launched,
                "kernel_ms": time_ms(torch, kernel, reps), **device_fields(torch, kernel, reps),
                "plain_ms": plain_ms, "library_ms": None,
                "library_call": "none: no one torch call computes a linear recurrence",
                "bound_ms": nbytes / hw().hbm_bw * 1e3, "bound_by": "bytes",
                "bound_bytes": nbytes, "max_abs_err": err, "bit_equal_to_plain": bit_equal,
                "plan": dataclasses.asdict(_cuda.rglru_backward_plan(b, s, w)),
                "shape": {"B": b, "S": s, "W": w, "dtype": "float32"}}
        line["bound_share"] = line["bound_ms"] / line["kernel_ms"]
        if line["device_ms"]:
            line["device_bound_share"] = line["bound_ms"] / line["device_ms"]
        if b == RGLRU_TRAIN_SHAPE[0]:  # the forward kernel at the microbatch
            forward = lambda: _cuda.run_rglru_scan(a0, x.detach())  # noqa: E731
            fwd_bytes = A.rglru_scan_work(b, s, w)[1]
            fwd_equal = torch.equal(h0, RS.rglru_scan_torch(a0, x.detach()))
            assert fwd_equal, name
            line.update({"forward_kernel_ms": time_ms(torch, forward, reps),
                         **device_fields(torch, forward, reps, "forward_"),
                         "forward_bound_ms": fwd_bytes / hw().hbm_bw * 1e3,
                         "forward_bit_equal_to_plain": fwd_equal,
                         "forward_plan": dataclasses.asdict(_cuda.rglru_scan_plan(a0, x.detach()))})
            line["forward_bound_share"] = line["forward_bound_ms"] / line["forward_kernel_ms"]
            if line["forward_device_ms"]:
                line["forward_device_bound_share"] = (line["forward_bound_ms"]
                                                      / line["forward_device_ms"])
        emit(line)
        lines[name] = line
        del a, x, dh, h, da, dx, a0, h0, want_da, want_dx
        torch.cuda.empty_cache()
    return {"rglru_scan_backward": lines["rglru_scan_backward"]}


def layer_kinds(cfg) -> list[str]:
    """The kinds of ``cfg``'s layers, in order."""
    return list(cfg.block_pattern) * cfg.n_units + list(cfg.tail_pattern)


def attention_layers(cfg) -> int:
    """The layers of ``cfg`` that attend (``attn``, ``local``, ``moe``)."""
    return sum(kind in ("attn", "local", "moe") for kind in layer_kinds(cfg))


def train_model_flops(cfg, tokens: int, seq: int) -> float:
    """Model operations of a train step: 6 × the matmul weights (every
    layer's projections, mixers and FFN, and ``lm_head``: the weights but
    the embedding, a gather) × tokens, plus attention: 3 × 4·H·D a causal
    (query, key) pair in the window, an attending layer (forward, and twice
    that backward)."""
    h, hd = cfg.n_heads, cfg.resolved_head_dim
    matmul = cfg.param_count() - cfg.padded_vocab * cfg.d_model
    window = min(seq, cfg.window) if "local" in cfg.block_pattern else seq
    pairs = sum(min(i + 1, window) for i in range(seq)) * (tokens // seq)
    return 6 * matmul * tokens + 3 * 4 * h * hd * pairs * attention_layers(cfg)


def profiled_train_step(torch, fn) -> dict:
    """One train step under ``torch.profiler``: its wall time, the sum of
    its kernels' device times (one stream), launches, idle share, the top
    kernels, and the device time by kind — cuBLAS GEMMs, the flash kernel,
    the scan kernels of the record store, the rest (elementwise, reductions,
    copies)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    kernels = [e for e in prof.key_averages()
               if getattr(e, "device_type", None) == DeviceType.CUDA and dev_us(e) > 0]
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3

    def kind(key: str) -> str:
        low = key.lower()
        if "rm_flash" in low:
            return "flash"
        if low.startswith(("rm_", "void rm_")):
            return "rme_kernels"
        if any(t in low for t in ("gemm", "cutlass", "xmma", "nvjet", "cublas", "sm90_")):
            return "gemm"
        return "other"

    by_kind: dict = {}
    for e in kernels:
        by_kind[kind(e.key)] = by_kind.get(kind(e.key), 0.0) + dev_us(e) / 1e3
    top = sorted(kernels, key=dev_us, reverse=True)[:8]
    return {"profiled_wall_ms": wall_ms, "device_busy_ms": busy_ms or None,
            "idle_share": (1 - busy_ms / wall_ms) if busy_ms else None,
            "kernel_launches": sum(e.count for e in kernels), "device_ms_by_kind": by_kind,
            "flash_backward_device_ms": sum(dev_us(e) for e in kernels
                                            if "rm_flash_bwd" in e.key) / 1e3,
            "scan_backward_device_ms": sum(dev_us(e) for e in kernels
                                           if "rm_rglru_scan_backward" in e.key) / 1e3,
            "top_kernels": [[e.key[:90], dev_us(e) / 1e3, e.count] for e in top]}


def train_phase(torch, seed: int, smi: str | None = None, arch: str = TRAIN_ARCH,
                layers: int = TRAIN_LAYERS, phase: str = "train") -> dict:
    """The slice's main path: ``arch`` (``qwen3-8b``) at full width,
    ``layers`` (``TRAIN_LAYERS``) of its layers (``reduced``), master
    weights, gradients and AdamW moments in float32, trained from a record
    store on the card through ``TrainPipeline`` and ``make_train_step``
    (the config's ``grad_accum`` microbatches, ``AdamWConfig(**TRAIN_OPT)``):
    1 warm-up and ``TRAIN_STEPS`` timed steps, each loss and ``grad_norm``
    finite, the projection kernel twice a batch, the flash kernel twice an
    attending layer and microbatch (the forward and the checkpointed
    group's recompute) and its backward once, the update's time, the peak
    (``MOE_FREE_BYTES`` of the card left), then one profiled step (its
    flash backward's device ms).  Counts are reset just before the steps.
    The ``train`` phase then takes one more step under the roofline counter
    (:func:`roofline_phase`); ``train_rg`` (:data:`TRAIN_RG_ARCH`) also
    prints the scan kernel's launches and the backward's form."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data import TrainPipeline
    from repro_torch.kernels import _cuda
    from repro_torch.models import build_model
    from repro_torch.train import AdamWConfig, make_train_step
    from repro_torch.train import step as train_step
    from repro_torch.train.step import init_train_state

    full = get_config(arch)
    cfg = dataclasses.replace(full, n_layers=layers)
    emit({"phase": f"{phase}_config", "arch": full.name, "source": full.source,
          "reduced": {"n_layers": [full.n_layers, layers]},
          "weights": cfg.param_count(), "full_weights": full.param_count(),
          "param_dtype": cfg.param_dtype, "compute_dtype": cfg.compute_dtype,
          "state_bytes": 16 * cfg.param_count(), "grad_accum": cfg.grad_accum,
          "scan_unroll": cfg.scan_unroll, "loss_chunk": cfg.loss_chunk,
          "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "samples": TRAIN_SAMPLES,
          "optimizer": TRAIN_OPT})
    t0 = time.perf_counter()
    store = record_store(torch, TRAIN_SEQ, TRAIN_SAMPLES, cfg.vocab)
    store_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda", seed=seed, param_dtype=cfg.param_dtype)
    state = init_train_state(model)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    update = {"ms": []}
    real_update = train_step.adamw_update

    def timed_update(*args):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        result = real_update(*args)
        end.record()
        update["events"] = (start, end)
        return result

    step_fn = make_train_step(model, AdamWConfig(**TRAIN_OPT), grad_accum=cfg.grad_accum)
    batches = TrainPipeline(store, batch_size=TRAIN_BATCH, seed=0).batches()
    tokens = TRAIN_BATCH * TRAIN_SEQ
    rows = []
    train_step.adamw_update = timed_update
    try:
        torch.cuda.reset_peak_memory_stats()
        _cuda.reset_launches()
        for i in range(1 + TRAIN_STEPS):
            batch = next(batches)
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            update["ms"].append(update["events"][0].elapsed_time(update["events"][1]))
            row = {k: float(v) for k, v in metrics.items()}
            row.update(step=i + 1, seconds=dt, warm_up=i == 0)
            assert all(math.isfinite(row[k]) for k in ("loss", "grad_norm")), row
            rows.append(row)
        launches = dict(_cuda.LAUNCHES)
        dout_copies = _cuda.FLASH_DOUT_COPIES["copies"]
        peak = torch.cuda.max_memory_allocated()
    finally:
        train_step.adamw_update = real_update
    free, total = torch.cuda.mem_get_info()
    micro = 1 + TRAIN_STEPS
    attending = attention_layers(cfg)
    assert launches["project"] == 2 * micro, launches  # tokens and labels, as the reference
    assert launches["flash_attention"] == 2 * attending * cfg.grad_accum * micro, launches
    # one gradient an attending layer and microbatch, from the group's recompute
    assert launches["flash_attention_backward"] == attending * cfg.grad_accum * micro, launches
    # the scan's forward twice an RG-LRU layer and microbatch (the forward
    # and the group's recompute), its gradient once
    recurrent = layer_kinds(cfg).count("rglru")
    assert launches.get("rglru_scan", 0) == 2 * recurrent * cfg.grad_accum * micro, launches
    assert (launches.get("rglru_scan_backward", 0)
            == recurrent * cfg.grad_accum * micro), launches
    assert total - peak >= MOE_FREE_BYTES, (peak, total)
    timed = [r["seconds"] for r in rows[1:]]
    step_s = statistics.median(timed)
    flops = train_model_flops(cfg, tokens, TRAIN_SEQ)
    prof = profiled_train_step(torch, lambda: step_fn(state, next(batches)))
    compute = getattr(torch, cfg.compute_dtype)
    line = {"phase": phase, "arch": cfg.name, "reduced": {"n_layers": [full.n_layers, layers]},
            "steps": rows, "step_seconds": step_s, "step_seconds_runs": timed,
            "tokens_per_step": tokens, "tokens_per_s": tokens / step_s,
            "model_flops": flops, "step_bound_s": flops / hw().peak_flops,
            "train_mfu": flops / (step_s * hw().peak_flops),
            "update_ms": update["ms"], "store_seconds": store_s, "init_seconds": init_s,
            "peak_memory": peak, "card_bytes": total, "free_after": total - peak,
            "launches": {k: v for k, v in launches.items() if v},
            "launches_a_step": {k: v / micro for k, v in launches.items() if v},
            "flash_backward_form": _cuda.flash_backward_form(compute, cfg.resolved_head_dim),
            "flash_dout_copies": dout_copies, "profile": prof, "nvidia_smi": smi}
    emit(line)
    if phase == "train":
        roofline_phase(torch, step_fn, state, batches, cfg, step_s, smi)
    del state, model, store, batches, step_fn
    gc.collect()
    torch.cuda.empty_cache()
    return line


def memory_kind(frames: list) -> str:
    """What made a traced allocation, from its Python frames: the update
    (``_update_leaf`` and the norm); in the forward of ``loss``, a
    checkpointed group's output (``forward_groups``), the loss's chunks and
    the ``lm_head`` cast (``forward_loss``), the rest (``forward``: the
    embedding); the backward, which autograd runs on the card's own thread
    where no Python frame is recorded (gradients and ``.grad``, the
    recomputed groups' activations, the flash backward's outputs); or
    other."""
    names = {f["name"] for f in frames}
    if names & {"_update_leaf", "adamw_update", "_step_scalars", "global_norm"}:
        return "update"
    if "loss" in names:
        if "_run_group" in names:
            return "forward_groups"
        return "forward_loss" if "chunked_xent" in names else "forward"
    if not frames or "backward" in names:
        return "backward"
    return "other"


def memory_split(trace: list) -> dict:
    """Replay a step's allocator trace (``torch.cuda.memory._snapshot()``'s
    ``device_traces[0]``): the live bytes it added at their highest, and
    at their highest before the update, by :func:`memory_kind`.  A
    ``backward`` block still live from an earlier microbatch (a new one
    starts at the first forward allocation after a backward one) is a
    float32 gradient sum (``gradient_sums``)."""
    kinds = [memory_kind(e.get("frames", [])) if e["action"] == "alloc" else None
             for e in trace]
    mb, last, micro = 0, None, []
    for k in kinds:
        if k is not None and k.startswith("forward") and last == "backward":
            mb += 1
        if k == "backward" or (k is not None and k.startswith("forward")):
            last = k
        micro.append(mb)
    update = next((i for i, k in enumerate(kinds) if k == "update"), len(trace))

    def live_at(stop: int) -> tuple[dict, int, int]:
        """The blocks live after event ``stop - 1``; the highest total
        before it and the event where it was reached."""
        live, total, best, at = {}, 0, 0, -1
        for i, e in enumerate(trace[:stop]):
            if e["action"] == "alloc":
                live[e["addr"]] = i
                total += e["size"]
                if total > best:
                    best, at = total, i
            elif e["action"] == "free_completed" and e["addr"] in live:
                del live[e["addr"]]
                total -= e["size"]
        return live, best, at

    def split(stop: int) -> dict:
        _, best, at = live_at(stop)
        live, _, _ = live_at(at + 1)
        out = {"bytes": best, "microbatch": micro[at] if at >= 0 else None}
        for i in live.values():
            k = kinds[i]
            if k == "backward" and micro[i] < micro[at]:
                k = "gradient_sums"
            out[k] = out.get(k, 0) + trace[i]["size"]
        return out

    return {"at_peak": split(len(trace)), "before_update": split(update),
            "events": len(trace), "microbatches": mb + 1}


def train_sharded_phase(torch, seed: int, train: dict, smi: str) -> dict:
    """This slice's main path: one ``qwen3-8b`` train step (full width,
    ``TRAIN_LAYERS`` layers, ``reduced``) through the sharding layer in an
    NCCL world of one — ``make_mesh((1, 1), ("data", "model"))``, the state
    placed by the mesh's specs (``shard_train_state``), the step
    ``make_sharded_train_step`` — against one unsharded ``make_train_step``
    from the same weights and batch (the first of ``TrainPipeline(seed=0)``
    over the train phase's record store): loss, ``grad_norm`` and every
    parameter and moment leaf bit-equal (a world of one sums one buffer).
    The unsharded step runs under the allocator's trace
    (``memory_split``: what holds its peak).  Counts are reset just before
    the sharded run — the batch fetched again, the compared step and
    ``TRAIN_STEPS - 1`` more — and read just after: the projection kernel
    twice a batch, the flash forward twice a layer and microbatch, its
    backward once.  Then ``psum_bf16``, ``psum_int8_ef`` and the exact
    reduction on the card over NCCL bit-equal to the CPU over gloo, and
    ``pipeline_apply`` at one stage against the sequential function."""
    import dataclasses
    import tempfile

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.data import TrainPipeline
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed.pipeline import pipeline_apply
    from repro_torch.kernels import _cuda
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.train import AdamWConfig, make_train_step
    from repro_torch.train.sharded import make_sharded_train_step, shard_train_state
    from repro_torch.train.step import init_train_state

    full = get_config(TRAIN_ARCH)
    cfg = dataclasses.replace(full, n_layers=TRAIN_LAYERS)
    opt = AdamWConfig(**TRAIN_OPT)
    torch.cuda.set_device(0)
    root = tempfile.mkdtemp()
    dist.init_process_group("nccl", store=dist.FileStore(os.path.join(root, "store"), 1),
                            rank=0, world_size=1, device_id=torch.device("cuda", 0))
    try:
        store = record_store(torch, TRAIN_SEQ, TRAIN_SAMPLES, cfg.vocab)
        batch = next(TrainPipeline(store, batch_size=TRAIN_BATCH, seed=0).batches())
        model = build_model(cfg, device="cuda", seed=seed, param_dtype=cfg.param_dtype)
        weights = {k: t.detach().cpu() for k, t in model.state_dict().items()}
        param_bytes = sum(t.numel() * t.element_size() for t in weights.values())

        # the unsharded step, under the allocator's trace
        state = init_train_state(model)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.memory._record_memory_history(stacks="python", max_entries=4_000_000)
        state, want_m = make_train_step(model, opt, grad_accum=cfg.grad_accum)(state, batch)
        torch.cuda.synchronize()
        trace = torch.cuda.memory._snapshot()["device_traces"][0]
        torch.cuda.memory._record_memory_history(enabled=None)
        peak_unsharded = torch.cuda.max_memory_allocated()
        memory = {"base": base, "parameters": param_bytes, "moments": 2 * param_bytes,
                  "base_rest": base - 3 * param_bytes, "peak": peak_unsharded,
                  "train_phase_peak": train["peak_memory"], **memory_split(trace)}
        del trace
        want = {part: {k: t.detach().cpu() for k, t in tree.items()} for part, tree in (
            ("params", state["params"]), ("mu", state["opt"]["mu"]),
            ("nu", state["opt"]["nu"]))}
        want_m = {k: v.clone() for k, v in want_m.items()}
        del state
        with torch.no_grad():  # the same weights again, in the model's own tensors
            for k, t in model.state_dict(keep_vars=True).items():
                t.requires_grad_(False)
                t.copy_(weights[k])
        del weights
        gc.collect()
        torch.cuda.empty_cache()

        mesh = make_mesh((1, 1), ("data", "model"))
        state = shard_train_state(init_train_state(model), mesh)
        step_fn = make_sharded_train_step(model, opt, mesh, grad_accum=cfg.grad_accum)
        batches = TrainPipeline(store, batch_size=TRAIN_BATCH, seed=0).batches()
        rows, leaves = [], 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _cuda.reset_launches()
        for i in range(TRAIN_STEPS):
            b = next(batches)
            t0 = time.perf_counter()
            state, m = step_fn(state, b)
            torch.cuda.synchronize()
            rows.append({"step": i + 1, "seconds": time.perf_counter() - t0,
                         **{k: float(v) for k, v in m.items()}})
            if i == 0:  # the compared step: bit-equal to the unsharded one
                assert all(torch.equal(b[k], batch[k]) for k in batch)
                assert set(m) == set(want_m) and all(
                    torch.equal(m[k], want_m[k]) for k in m), (m, want_m)
                for part, tree in (("params", state["params"]), ("mu", state["opt"]["mu"]),
                                   ("nu", state["opt"]["nu"])):
                    for k, t in tree.items():
                        assert torch.equal(t.to_local(), want[part][k].cuda()), (part, k)
                        leaves += 1
                assert int(state["opt"]["step"].to_local()) == 1
                del want
        launches = dict(_cuda.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        free, total = torch.cuda.mem_get_info()
        assert launches["project"] == 2 * TRAIN_STEPS, launches
        assert launches["flash_attention"] == 2 * cfg.n_layers * cfg.grad_accum * TRAIN_STEPS, \
            launches
        assert launches["flash_attention_backward"] == cfg.n_layers * cfg.grad_accum * \
            TRAIN_STEPS, launches
        assert total - peak >= MOE_FREE_BYTES, (peak, total)
        assert all(math.isfinite(r[k]) for r in rows for k in ("loss", "grad_norm")), rows
        placements = {str(p.placements) for p in state["params"].values()}
        del state, step_fn, model, batches, store, batch, b
        gc.collect()
        torch.cuda.empty_cache()

        # the collectives: NCCL on the card against gloo on the CPU
        rng = np.random.default_rng(seed + 41)
        x = torch.from_numpy(rng.normal(0, 1, (4096, 1024)).astype(np.float32))
        res = torch.from_numpy(rng.normal(0, 1e-2, (4096, 1024)).astype(np.float32))
        nccl, gloo = mesh.get_group("data"), dist.new_group([0], backend="gloo")
        collectives = {}
        for name, fn in (("psum_bf16", lambda t, r, g: (C.psum_bf16(t, g),)),
                         ("psum_int8_ef", lambda t, r, g: C.psum_int8_ef(t, r, g)),
                         ("none", lambda t, r, g: (C.tree_psum_compressed(
                             {"a": t.clone()}, None, g, "none")[0]["a"],))):
            card_out = fn(x.cuda(), res.cuda(), nccl)
            host_out = fn(x, res, gloo)
            assert all(torch.equal(a.cpu(), b) for a, b in zip(card_out, host_out)), name
            collectives[name] = "bit-equal"

        # GPipe at one stage: the sequential function
        pmesh = make_mesh((1, 1), ("pod", "data"))
        ws = torch.from_numpy(rng.normal(0, 0.3, (1, 256, 256)).astype(np.float32)).cuda()
        xs = torch.from_numpy(rng.normal(0, 1, (64, 256)).astype(np.float32)).cuda()
        got = pipeline_apply(lambda w, h: torch.relu(h @ w), pmesh, n_microbatches=8)(ws, xs)
        pipe_err = float((got - torch.relu(xs @ ws[0])).abs().max())
        assert pipe_err <= 1e-5, pipe_err
    finally:
        dist.destroy_process_group()
    timed = [r["seconds"] for r in rows[1:]]
    line = {"phase": "train_sharded", "arch": cfg.name, "card": smi,
            "reduced": {"n_layers": [full.n_layers, TRAIN_LAYERS]},
            "mesh": {"data": 1, "model": 1}, "backend": "nccl",
            "placements": sorted(placements), "steps": rows,
            "bit_equal_leaves": leaves, "step_seconds": statistics.median(timed),
            "step_seconds_runs": timed, "first_step_seconds": rows[0]["seconds"],
            "train_step_seconds": train["step_seconds"], "peak_memory": peak,
            "train_peak_memory": train["peak_memory"], "card_bytes": total,
            "free_after": total - peak, "unsharded_memory": memory,
            "launches": {k: v for k, v in launches.items() if v},
            "collectives": collectives, "pipeline_one_stage_max_err": pipe_err}
    emit(line)
    return line


def nccl_world_of_one(torch):
    """An NCCL process group of one rank (a ``FileStore`` in a temp dir) and
    the ``(1, 1)`` ``(data, model)`` mesh over it; destroy it after use."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    torch.cuda.set_device(0)
    root = tempfile.mkdtemp()
    dist.init_process_group("nccl", store=dist.FileStore(os.path.join(root, "store"), 1),
                            rank=0, world_size=1, device_id=torch.device("cuda", 0))
    return make_mesh((1, 1), ("data", "model"))


def decode_sp_phase(torch, seed: int, smi: str) -> dict:
    """Decode-SP on the card: ``qwen3-8b`` bf16 at full width and depth
    (36 layers), ``SP_BATCH`` prompts of ``SP_PROMPT`` tokens prefilled
    into a cache of ``SP_MAX_LEN`` slots, then one decode step through the
    sequence-parallel form under a ``(1, 1)`` NCCL mesh
    (``mesh_axis_rules``: the rules place the cache's sequence dim on
    ``model``, so the SP form runs at ``n_seq = 1``, the cache cut by
    ``launch.specs.shard_cache``) against the one-device eager step on a
    copy of the same prefilled cache: the logits' largest difference within
    ``SP_LOGIT_TOL``, the greedy tokens equal, layer 0's cache written alike
    (its K/V come from the token alone), and each step's time (CUDA
    events, ``SP_REPS`` runs at the same position: a KV write is
    idempotent)."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.distributed.partitioning import mesh_axis_rules
    from repro_torch.launch import specs as S
    from repro_torch.models.lm import DecoderLM

    cfg = get_config(LM_ARCH)
    model = DecoderLM(cfg, seed=seed)
    rng = np.random.default_rng(seed + 51)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (SP_BATCH, SP_PROMPT)).astype(np.int64))
    logits, cache = model.prefill({"tokens": toks.cuda()}, SP_MAX_LEN)
    tok = torch.argmax(logits, -1)[:, None]
    pos = torch.tensor(SP_PROMPT, device="cuda")
    eager = [{k: v.clone() for k, v in c.items()} for c in cache]
    want, _ = model.decode_step(eager, tok, pos)
    mesh = nccl_world_of_one(torch)
    try:
        part = S.shard_cache(mesh, cache)
        with mesh_axis_rules(mesh):
            got, _ = model.decode_step(part, tok, pos)
            sp_ms = time_ms(torch, lambda: model.decode_step(part, tok, pos), SP_REPS)
        eager_ms = time_ms(torch, lambda: model.decode_step(eager, tok, pos), SP_REPS)
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    err = float((got - want).abs().max())
    same = bool(torch.equal(got.argmax(-1), want.argmax(-1)))
    # layer 0's new K/V come from the token alone: the same in both caches
    written = all(torch.equal(part[0][n].to_local(), eager[0][n]) for n in ("k", "v"))
    line = {"phase": "decode_sp", "card": smi, "arch": cfg.name, "layers": cfg.n_layers,
            "logits_bit_equal": bool(torch.equal(got, want)),
            "dtype": cfg.compute_dtype, "mesh": {"data": 1, "model": 1}, "backend": "nccl",
            "batch": SP_BATCH, "prompt": SP_PROMPT, "max_len": SP_MAX_LEN,
            "logits_max_abs_diff": err, "logits_tol": SP_LOGIT_TOL,
            "greedy_equal": same, "layer0_cache_equal_after": written,
            "sp_step_ms": sp_ms, "eager_step_ms": eager_ms}
    emit(line)
    assert err <= SP_LOGIT_TOL and same and written, line
    del model, cache, eager, part
    gc.collect()
    torch.cuda.empty_cache()
    return line


def moe_expert_parallel_phase(torch, seed: int, smi: str) -> dict:
    """The MoE block's expert-parallel forms on the card, called directly at
    a world of one (a ``(1, 1)`` NCCL mesh; the block's dispatch takes them
    only over more than one expert rank): one ``qwen3-moe-235b-a22b`` layer
    at full width (``MOE_SHAPE``: E 128, d 4,096, f 1,536, top-8, bf16),
    decode-sized (8 tokens: cap 4, so the one-device block runs the MoE
    kernel) and prefill-sized (2 × 2,048 tokens: the dense products).
    ``local_gather`` is the one-device block's ``_moe_dispatch_compute``
    over ``[0, E)`` and a sum over a group of one: bit-equal to
    ``moe_block``.  ``local_stationary`` takes the gate and up products
    apart (their sum over the FSDP group comes before the SiLU), as the
    dense form does: bit-equal to the one-device block's dense form (the
    MoE kernel's plain version, ``moe_block`` under grad), and at decode
    size the kernel is held to that plain version on the block's own
    dispatch buffer within the MoE kernel's limits (``moe_check``); its
    largest difference from the kernel's block is printed.  Each call
    timed (CUDA events) beside its ``moe_ffn`` launches."""
    import torch.distributed as dist

    from repro_torch.kernels import _cuda
    from repro_torch.models import layers as L

    e, d, f, k = (MOE_SHAPE[n] for n in ("E", "d", "f", "top_k"))
    spec = L.MoESpec(d_model=d, d_ff=f, n_experts=e, top_k=k)
    moe = L.init_moe(torch.Generator(device="cuda").manual_seed(seed + 61),
                     L.MoE(spec, torch.bfloat16, device="cuda"))
    g = torch.Generator(device="cuda").manual_seed(seed + 62)
    mesh = nccl_world_of_one(torch)
    lines = {}
    try:
        for size, shape in (("decode", (MOE_SHAPE["tokens"], 1, d)), ("prefill", (2, 2048, d))):
            x = torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)
            forms = {"one_device": lambda: L.moe_block(moe, spec, x),
                     "local_gather": lambda: L._moe_local_gather(moe, spec, x, mesh, ("model",)),
                     "local_stationary": lambda: L._moe_local_stationary(
                         moe, spec, x, mesh, ("model",), ("data",), ("data",))}
            out, launches, ms = {}, {}, {}
            for name, fn in forms.items():
                _cuda.reset_launches()
                out[name] = fn()
                torch.cuda.synchronize()
                launches[name] = _cuda.LAUNCHES["moe_ffn"]
                ms[name] = time_ms(torch, fn, 5)
            for p in moe.parameters():
                p.requires_grad_(True)
            with torch.enable_grad():
                dense = L.moe_block(moe, spec, x).detach()
            for p in moe.parameters():
                p.requires_grad_(False)
            torch.cuda.synchronize()
            line = {"phase": "moe_expert_parallel", "card": smi, "size": size,
                    "tokens": x.shape[0] * x.shape[1], "E": e, "d": d, "f": f, "top_k": k,
                    "cap": L.moe_capacity(spec, x.shape[0] * x.shape[1]),
                    "mesh": {"data": 1, "model": 1}, "backend": "nccl",
                    "moe_ffn_launches": launches, "ms": ms,
                    "gather_bit_equal": bool(torch.equal(out["local_gather"],
                                                         out["one_device"])),
                    "stationary_bit_equal_to_dense": bool(
                        torch.equal(out["local_stationary"], dense)),
                    "stationary_max_abs_diff_to_block": float(
                        (out["local_stationary"].float() - out["one_device"].float())
                        .abs().max())}
            if size == "decode":
                xt = x.reshape(-1, d)
                cap = line["cap"]
                r = L.moe_route(spec, torch.softmax((xt @ moe.router).float(), dim=-1), e, 0,
                                cap)
                buf = xt.new_zeros((e * cap + 1, d))
                buf.index_copy_(0, r.dest, xt.index_select(0, r.st))
                line["kernel_check"] = moe_check(torch, buf[:-1].view(e, cap, d), r.count,
                                                 moe.expert_gate, moe.expert_up,
                                                 moe.expert_down)
                assert launches["one_device"] == launches["local_gather"] == 2, launches
            emit(line)
            assert line["gather_bit_equal"] and line["stationary_bit_equal_to_dense"], line
            lines[size] = line
    finally:
        dist.destroy_process_group()
    del moe
    gc.collect()
    torch.cuda.empty_cache()
    return lines


def roofline_phase(torch, step_fn, state, batches, cfg, step_s: float, smi: str) -> dict:
    """One real train step of the train phase under the roofline counter
    (``roofline.analysis.count_step``): its counted product FLOPs and HBM
    bytes (counts, not times), the three terms at the H100's data-sheet
    figures (``Hardware``), ``step_time_lower_bound_s`` beside the train
    phase's measured step seconds, ``useful_flops_ratio`` (the model FLOPs
    of ``train_model_flops`` over the counted ones), and the counter's
    overhead: the counted step's wall seconds over the measured step's."""
    from repro_torch.roofline import analysis as A

    torch.cuda.synchronize()
    batch = next(batches)
    t0 = time.perf_counter()
    (state, metrics), counts = A.count_step(step_fn, state, batch)
    torch.cuda.synchronize()
    counted_s = time.perf_counter() - t0
    assert math.isfinite(float(metrics["loss"])), metrics
    terms = A.roofline_terms(counts["flops"], counts["hbm_bytes"],
                             counts["collectives"]["total"])
    model_flops = train_model_flops(cfg, TRAIN_BATCH * TRAIN_SEQ, TRAIN_SEQ)
    line = {"phase": "roofline", "card": smi, "hardware": vars(A.HW),
            "arch": cfg.name, "reduced": {"n_layers": [36, cfg.n_layers]},
            "counted_flops": counts["flops"], "counted_hbm_bytes": counts["hbm_bytes"],
            "counted_collective_bytes": counts["collectives"]["total"],
            "aten_calls": counts["aten_calls"], "kernels": counts["kernels"],
            "terms_s_at_data_sheet": terms, "dominant": max(terms, key=terms.get),
            "step_time_lower_bound_s": max(terms.values()),
            "measured_step_seconds": step_s, "model_flops": model_flops,
            "useful_flops_ratio": model_flops / counts["flops"],
            "counted_step_seconds": counted_s,
            "counter_overhead": counted_s / step_s - 1.0}
    emit(line)
    return line


def dryrun_phase(smi: str) -> dict:
    """``python -m repro_torch.launch.dryrun --arch qwen3-8b --shape
    train_4k --mesh single`` as a subprocess (its fake process group must
    not meet this process's NCCL groups): its three terms (counts at the
    data sheet's figures), dominant term and wall seconds.  A failing
    subprocess fails the script."""
    import tempfile

    out = tempfile.mkdtemp()
    src = Path(__file__).resolve().parent / "src"
    env = dict(os.environ, PYTHONPATH=str(src))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                           "qwen3-8b", "--shape", "train_4k", "--mesh", "single",
                           "--out", out], capture_output=True, text=True, env=env,
                          timeout=600)
    wall = time.perf_counter() - t0
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    with open(os.path.join(out, "qwen3-8b__train_4k__pod16x16.json")) as fh:
        cell = json.load(fh)
    line = {"phase": "dryrun", "card": smi, "cell": "qwen3-8b × train_4k × pod16x16",
            "terms_s_at_data_sheet": cell["terms"], "dominant": cell["dominant"],
            "step_time_lower_bound_s": cell["step_time_lower_bound_s"],
            "useful_flops_ratio": cell["useful_flops_ratio"],
            "argument_bytes": cell["memory"]["argument_bytes"],
            "count_seconds": cell["count_seconds"], "wall_seconds": wall}
    emit(line)
    return line


def trainer_phase(torch, seed: int) -> dict:
    """The trainer, its checkpoints and a restart on the card, at the
    qwen3-8b smoke config: 6 steps saving every 3, then a fresh state from
    another seed restored from the last checkpoint — every leaf bit-equal
    to the state saved, on the card — the batch stream after the seek equal
    to the unbroken one, and 2 more steps."""
    import dataclasses
    import tempfile

    from repro_torch.configs import get_smoke_config
    from repro_torch.data import TrainPipeline
    from repro_torch.models import build_model
    from repro_torch.train import AdamWConfig, make_train_step
    from repro_torch.train.step import init_train_state
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = get_smoke_config(TRAIN_ARCH)
    store = record_store(torch, 64, 128, cfg.vocab)
    pipe = TrainPipeline(store, batch_size=8, seed=0)
    opt = AdamWConfig(**TRAIN_OPT)
    with tempfile.TemporaryDirectory() as d:
        tcfg = TrainerConfig(total_steps=6, ckpt_dir=d, ckpt_every=3, log_every=1)
        model = build_model(cfg, device="cuda", seed=seed, param_dtype=cfg.param_dtype)
        tr = Trainer(make_train_step(model, opt), init_train_state(model), pipe.batches(), tcfg)
        hist = tr.run()
        saved = sorted(os.listdir(d))
        fresh = build_model(cfg, device="cuda", seed=seed + 1, param_dtype=cfg.param_dtype)
        tr2 = Trainer(make_train_step(fresh, opt), init_train_state(fresh),
                      pipe.batches(start_step=6), dataclasses.replace(tcfg, total_steps=8))
        assert tr2.try_restore() and tr2.step == 6
        leaves = 0
        for part in ("params", "mu", "nu"):
            a = tr.state["params"] if part == "params" else tr.state["opt"][part]
            b = tr2.state["params"] if part == "params" else tr2.state["opt"][part]
            for k in a:
                assert b[k].device.type == "cuda" and torch.equal(a[k], b[k]), (part, k)
                leaves += 1
        assert int(tr2.state["opt"]["step"]) == int(tr.state["opt"]["step"]) == 6
        unbroken = pipe.batches()
        for _ in range(6):
            next(unbroken)
        for x, y in zip([next(unbroken) for _ in range(2)], pipe.batches(start_step=6)):
            assert torch.equal(x["tokens"], y["tokens"]) and torch.equal(x["labels"], y["labels"])
        tr2.run()
        assert tr2.step == 8
    line = {"phase": "trainer", "arch": cfg.name, "checkpoints": saved,
            "restored_leaves_bit_equal": leaves, "losses": [h["loss"] for h in hist],
            "resumed_at": 6, "final_step": tr2.step}
    assert all(math.isfinite(x) for x in line["losses"]), line
    emit(line)
    return line


def train_reference_phase(torch, seed: int) -> dict:
    """Card against CPU: one float32 train step of each of
    ``TRAIN_REFERENCE_ARCHS``' smokes (grad_accum 2) from the same weights
    and batch: the loss within ``TRAIN_LOSS_TOL``, ``grad_norm`` within
    ``TRAIN_GNORM_RTOL`` relative."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    from repro_torch.train import AdamWConfig, make_train_step
    from repro_torch.train.step import init_train_state

    out = {}
    for arch in TRAIN_REFERENCE_ARCHS:
        cfg = dataclasses.replace(get_smoke_config(arch), compute_dtype="float32")
        rng = np.random.default_rng(seed + 31)
        batch = {k: rng.integers(0, cfg.vocab, (4, 128)).astype(np.int32)
                 for k in ("tokens", "labels")}
        host = build_model(cfg, device="cpu", seed=seed, param_dtype="float32")
        card = build_model(cfg, device="cuda", seed=None, param_dtype="float32")
        card.load_state_dict(host.state_dict())
        got = {}
        for where, model in (("cpu", host), ("cuda", card)):
            step = make_train_step(model, AdamWConfig(**TRAIN_OPT), grad_accum=2)
            _, m = step(init_train_state(model),
                        {k: torch.from_numpy(v).to(where) for k, v in batch.items()})
            got[where] = {k: float(v) for k, v in m.items()}
        dl = abs(got["cuda"]["loss"] - got["cpu"]["loss"])
        dg = abs(got["cuda"]["grad_norm"] - got["cpu"]["grad_norm"]) / got["cpu"]["grad_norm"]
        assert dl <= TRAIN_LOSS_TOL and dg <= TRAIN_GNORM_RTOL, (arch, got)
        out[arch] = {"card": got["cuda"], "cpu": got["cpu"], "loss_diff": dl,
                     "grad_norm_rel_diff": dg}
    emit({"phase": "train_reference", **out})
    return out


def host_columns(table, *words) -> list:
    """Contiguous copies of ``table``'s word columns for the numpy oracles.

    A column of the row-major host buffer is a strided read of all of it, so
    each is taken once, a thread a column, and kept while the table's
    version (row count, mutation count) stands: equal versions mean
    byte-identical storage.  A write drops the table's columns.
    """
    ver, cols = _HOST_COLUMNS.get(table.uid, (None, {}))
    if ver != table.version:
        ver, cols = table.version, {}
        _HOST_COLUMNS[table.uid] = (ver, cols)
    w = table.words()
    missing = [i for i in dict.fromkeys(words) if i not in cols]
    if missing:
        with ThreadPoolExecutor(min(8, len(missing))) as pool:
            cols.update(zip(missing, pool.map(
                lambda i: np.ascontiguousarray(w[:, i]), missing)))
    return [cols[i] for i in words]


def same_block(block, cols, mask=None) -> bool:
    """A ``(N, k)`` result block equals ``k`` numpy columns (zero where
    ``mask`` is false), compared a thread a column."""
    b = block.cpu().numpy()
    if b.shape != (len(cols[0]), len(cols)):
        return False

    def eq(i):
        want = cols[i] if mask is None else np.where(mask, cols[i], 0)
        return np.array_equal(b[:, i], want)

    with ThreadPoolExecutor(len(cols)) as pool:
        return all(pool.map(eq, range(len(cols))))


def visible(table, ts: int | None):
    """The rows a snapshot at ``ts`` sees (every row without one)."""
    if ts is None:
        return np.ones(table.row_count, bool)
    begin, end = host_columns(table, 16, 17)
    return (begin <= ts) & (ts < end)


# (table uid, version, ts) -> the mixed batch's expected results; one entry
_BATCH_WANT: dict = {}


def batch_expectation(table, ts: int | None) -> dict:
    """What the mixed batch must return at ``ts``, from numpy over the host
    columns.  Kept for the table's version and ``ts``, so a second engine's
    batch over the same state is only compared."""
    key = (table.uid, table.version, ts)
    if key in _BATCH_WANT:
        return _BATCH_WANT[key]
    w = dict(zip(BATCH_WORDS, host_columns(table, *BATCH_WORDS)))
    vis = None if ts is None else visible(table, ts)

    def seen(m):
        return m if vis is None else m & vis

    def total(col, pred):
        m = seen(pred(w))
        v = np.where(m, w[col], 0)
        return (int(v.sum(dtype=np.int64)), int(np.abs(v, dtype=np.int64).sum()),
                int(m.sum()))

    def filtered():
        m = seen(w[3] > 0)
        return m, [np.where(m, w[1], 0), np.where(m, w[2], 0)]

    def groups():
        gid = np.mod(w[15], 16)
        g = w[7] if vis is None else np.where(vis, w[7], 0)
        return [np.bincount(gid, weights=vis, minlength=16),
                np.bincount(gid, weights=g, minlength=16),
                np.bincount(gid, weights=np.abs(g), minlength=16)]

    # independent pieces, a thread each (numpy lets go of the GIL)
    with ThreadPoolExecutor(4) as pool:
        parts = [pool.submit(total, 5, lambda w: w[6] < 100),
                 pool.submit(total, 8, lambda w: w[9] > -500),
                 pool.submit(filtered), pool.submit(groups)]
        agg, agg2, (fmask, fcols), (count, sums, absval) = [f.result() for f in parts]
    want = {"w": w, "fmask": fmask, "fcols": fcols, "aggs": [agg, agg2],
            "count": count, "sum": sums, "abs": absval}
    _BATCH_WANT.clear()
    _BATCH_WANT[key] = want
    return want


def oracle_batch(table, results, ts: int | None, chunks: int,
                 blocks: bool = True) -> None:
    """The mixed batch's results against numpy over the host table;
    ``blocks=False`` checks the sums and counts alone (for an engine whose
    blocks were already held bit-equal to a checked engine's)."""
    want = batch_expectation(table, ts)
    w = want["w"]
    packed, sub, (fp, fm), (fp2, fm2), agg, (gs, gc), agg2 = results
    if blocks:
        assert same_block(packed, [w[0], w[4], w[8], w[12]])
        assert same_block(sub, [w[0], w[4]])
        same = fp2 is fp and fm2 is fm  # the duplicate filter, deduplicated
        for p_, m_ in [(fp, fm)] + ([] if same else [(fp2, fm2)]):
            assert np.array_equal(m_.cpu().numpy(), want["fmask"])
            assert same_block(p_, want["fcols"])
    for got, (total, absval, count) in zip((agg, agg2), want["aggs"]):
        host = got.cpu().numpy()
        assert count_ok(host[1], count, chunks), (host, count)
        assert abs(host[0] - total) <= SUM_RTOL * absval + 1e-3
    # per-group counts stay below 2^24 at the smoke size: exact
    assert np.array_equal(gc.cpu().numpy(), want["count"].astype(np.float32))
    assert np.all(np.abs(gs.cpu().numpy() - want["sum"]) <= SUM_RTOL * want["abs"] + 1e-3)


def mixed_ops(eng, table, ts):
    from repro_torch.core import AggregateOp, GroupByOp
    from repro_torch.core.requests import FilterOp, ProjectOp

    big = eng.register(table, ["A1", "A5", "A9", "A13"])
    return [
        ProjectOp(big),
        ProjectOp(eng.register(table, ["A1", "A5"])),  # subsumed by `big`
        FilterOp(eng.register(table, ["A2", "A3"]), "A4", "gt", 0, ts),
        FilterOp(eng.register(table, ["A2", "A3"]), "A4", "gt", 0, ts),  # duplicate
        AggregateOp(table, "A6", "A7", "lt", 100, ts),
        GroupByOp(table, "A16", "A8", 16, snapshot_ts=ts),
        AggregateOp(table, "A9", "A10", "gt", -500, ts),
    ]


def engine_phase(torch, table, seed: int, breakers: list) -> dict:
    """The engine batch path on the card, every result against numpy."""
    import dataclasses

    from repro_torch.core import BatchExecutor, RelationalMemoryEngine
    from repro_torch.kernels import _cuda

    eng = RelationalMemoryEngine()  # on the card
    breakers.append(eng.breaker)
    rng = np.random.default_rng(seed + 1)
    steps = []

    def step(name, fn, rows):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        steps.append({"step": name, "seconds": dt, "rows": rows,
                      "rows_per_s": rows / dt if dt > 0 else None})
        return out

    _cuda.reset_launches()
    n = table.row_count
    step("upload", lambda: eng.device_chunks(table), n)

    def solo_project():
        b = BatchExecutor(eng)
        b.add_columns(table, ["A1", "A5", "A9", "A13"])
        return b.submit()[0]

    packed = step("solo_project", solo_project, n)
    w = dict(zip(BATCH_WORDS, host_columns(table, *BATCH_WORDS)))
    assert same_block(packed, [w[0], w[4], w[8], w[12]])
    del packed

    def solo_filter():
        b = BatchExecutor(eng)
        b.add_filter(table, ["A2", "A3"], "A4", "gt", 0)
        return b.submit()[0]

    fp, fm = step("solo_filter", solo_filter, n)
    m = w[3] > 0
    assert np.array_equal(fm.cpu().numpy(), m)
    assert same_block(fp, [w[1], w[2]], m)
    del fp, fm

    s, c = step("solo_aggregate", lambda: eng.aggregate(table, "A6", "A7", "lt", 100), n)
    m = w[6] < 100
    v = w[5][m].astype(np.float64)
    assert count_ok(c, int(m.sum())) and abs(s - v.sum()) <= SUM_RTOL * np.abs(v).sum() + 1e-3

    def solo_groupby():
        b = BatchExecutor(eng)
        b.add_groupby(table, "A16", "A8", 16)
        return b.submit()[0]

    gs, gc = step("solo_groupby", solo_groupby, n)
    gid = np.mod(w[15].astype(np.int64), 16)
    assert np.array_equal(gc.cpu().numpy(), np.bincount(gid, minlength=16).astype(np.float32))
    want = np.bincount(gid, weights=w[7].astype(np.float64), minlength=16)
    absw = np.bincount(gid, weights=np.abs(w[7]).astype(np.float64), minlength=16)
    assert np.all(np.abs(gs.cpu().numpy() - want) <= SUM_RTOL * absw + 1e-3)

    res = step("mixed_batch", lambda: eng.execute_many(mixed_ops(eng, table, None)), n)
    oracle_batch(table, res, None, 1)
    del res

    def writes():
        cols = {c.name: rng.integers(-1000, 1000, 4096, dtype=np.int32)
                for c in table.schema.columns}
        table.append(cols)
        upd = rng.choice(n, 64, replace=False)
        table.update(upd, {"A1": rng.integers(-1000, 1000, 64, dtype=np.int32)})
        table.delete(rng.choice(n, 64, replace=False))

    writes()  # host-side OLTP; the next batch ships only the delta
    ts = table.now()
    res = step("mixed_batch_snapshot",
               lambda: eng.execute_many(mixed_ops(eng, table, ts)), table.row_count)
    chunks = len(eng.device_chunks(table))
    assert chunks == 2, chunks  # the base and one tail of the written rows
    oracle_batch(table, res, ts, chunks)
    del res
    launches = {k: _cuda.LAUNCHES[k] for k in ENGINE_KERNELS}
    idle = [k for k, v in launches.items() if v == 0]
    assert not idle, f"kernels never launched on the engine path: {idle}"
    out = {"phase": "engine", "rows": table.row_count, "chunks": chunks,
           "launches": launches, "steps": steps,
           "stats": dataclasses.asdict(eng.stats)}
    emit(out)
    return out


def host_top(prof: cProfile.Profile, k: int = 8) -> list:
    """The ``k`` functions with the most host self-time in a profile, as
    ``[function, self seconds, cumulative seconds]``."""
    rows = sorted(pstats.Stats(prof).stats.items(), key=lambda kv: -kv[1][2])[:k]
    return [[f"{Path(f).name}:{line}({fn})", tt, ct]
            for (f, line, fn), (_, _, tt, ct, _) in rows]


def server_ticks(torch, server, S, R, seed: int, stream_chunk_rows: int):
    """The serving tick script; yields ``(tick, results, seconds, host_top)``
    after each tick (host clock around submit + drain, synced on both
    sides; the tick runs under ``cProfile``, whose top functions by host
    self-time say where a host-bound tick spends it).

    A: the join alone on S (the probe streams S's row store) and a streamed
       projection; B: the same join again; C: writes on S, then five reads
       of S in one tick, pinned to its snapshot."""
    from repro_torch.core import plan

    rng = np.random.default_rng(seed + 3)

    def join(proj="A3"):
        return plan(S).join(R, key="A2", left_proj="A1", right_proj=proj)

    def tick(submit):
        prof = cProfile.Profile()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prof.enable()
        tickets = submit()
        server.drain()
        results = [tk.result(timeout=900) for tk in tickets]
        torch.cuda.synchronize()
        prof.disable()
        return results, time.perf_counter() - t0, host_top(prof)

    yield ("A", *tick(lambda: [
        server.submit(join()),
        server.submit(plan(S).project("A1", "A4"), stream=True,
                      stream_chunk_rows=stream_chunk_rows)]))
    yield ("B", *tick(lambda: [server.submit(join())]))

    def tick_c():
        n = S.row_count
        cols = {c.name: rng.integers(-1000, 1000, 4096, dtype=np.int32)
                for c in S.schema.columns}
        cols["A2"] = rng.integers(0, 2 * R.row_count, 4096, dtype=np.int32)
        server.submit_insert(S, cols)
        server.submit_update(S, rng.choice(n, 64, replace=False),
                             {"A1": rng.integers(-1000, 1000, 64, dtype=np.int32)})
        server.submit_delete(S, rng.choice(n, 64, replace=False))
        return [server.submit(q) for q in tick_c_reads(S, R)]

    yield ("C", *tick(tick_c))


def tick_c_reads(S, R) -> list:
    """Tick C's five reads of S: a filtered sum, a group-by average, a
    projection, the join and a two-join chain."""
    from repro_torch.core import plan

    def join():
        return plan(S).join(R, key="A2", left_proj="A1", right_proj="A3")

    return [plan(S).filter("A3", "gt", 100).sum("A1"),
            plan(S).groupby("A4", "A1", "avg", 16),
            plan(S).project("A1", "A5"),
            join(),
            join().join(R, key="A2", left_proj="A1", right_proj="A5")]


def join_oracle(S, R, ts: int | None, proj_word: int):
    """(s_proj, r_proj, matched) of ``S.A2 = R.A2`` over S's host words:
    R's key is its row number, so a probe key in range matches row key."""
    s_val, key = host_columns(S, 0, 1)
    vis = visible(S, ts)
    matched = vis & (key >= 0) & (key < R.row_count)
    r_vals, = host_columns(R, proj_word)
    r = np.where(matched, r_vals[np.clip(key, 0, R.row_count - 1)], 0)
    return np.where(vis, s_val, 0), r, matched


def check_join(res, want) -> None:
    for got, exp in zip((res.s_proj, res.r_proj, res.matched), want):
        assert np.array_equal(got.cpu().numpy(), exp)


def server_oracle(torch, tick: str, results, S, R, ts: int | None) -> None:
    """Every ticket of a tick against numpy over the host tables."""
    w = dict(zip((0, 2, 3, 4), host_columns(S, 0, 2, 3, 4)))
    if tick in ("A", "B"):
        check_join(results[0], join_oracle(S, R, None, 2))
        if tick == "A":
            assert same_block(results[1], [w[0], w[3]])
        return
    total, avg, (packed, mask), one, chain = results
    vis = visible(S, ts)
    m = vis & (w[2] > 100)
    v = w[0][m].astype(np.float64)
    assert abs(total - v.sum()) <= SUM_RTOL * np.abs(v).sum() + 1e-3, (total, v.sum())
    gid = np.mod(w[3].astype(np.int64), 16)[vis]
    cnt = np.bincount(gid, minlength=16)
    sums = np.bincount(gid, weights=w[0][vis].astype(np.float64), minlength=16)
    abs_s = np.bincount(gid, weights=np.abs(w[0][vis]).astype(np.float64), minlength=16)
    got = avg.cpu().numpy().astype(np.float64)
    assert np.all(np.abs(got - sums / np.maximum(cnt, 1))
                  <= (SUM_RTOL * abs_s + 1e-3) / np.maximum(cnt, 1)), (got, sums / cnt)
    assert np.array_equal(mask.cpu().numpy(), vis)
    assert same_block(packed, [w[0], w[4]], vis)
    want = join_oracle(S, R, ts, 2)
    check_join(one, want)
    s_want, r3, matched = want
    r5 = join_oracle(S, R, ts, 4)[1]
    assert np.array_equal(chain.matched.cpu().numpy(), matched)
    assert np.array_equal(chain.s_proj.cpu().numpy(), np.where(matched, s_want, 0))
    assert np.array_equal(chain.r_projs[0].cpu().numpy(), r3)
    assert np.array_equal(chain.r_projs[1].cpu().numpy(), r5)


def server_phase(torch, S, R, seed: int, breakers: list) -> dict:
    """A QueryServer on the card, three ticks, every ticket against numpy."""
    import dataclasses

    from repro_torch.core import RelationalMemoryEngine, planner
    from repro_torch.kernels import _cuda
    from repro_torch.serve import QueryServer

    planner.clear_join_build_cache()
    eng = RelationalMemoryEngine()  # on the card
    breakers.append(eng.breaker)
    server = QueryServer(eng)
    _cuda.reset_launches()
    ticks = []
    for name, results, dt, top in server_ticks(torch, server, S, R, seed,
                                               STREAM_CHUNK_ROWS):
        launches = dict(_cuda.LAUNCHES)
        delta = {k: v - sum(t["launches"][k] for t in ticks) for k, v in launches.items()}
        before = ticks[-1]["stats"] if ticks else {}
        stats = dataclasses.asdict(eng.stats)
        ts = max(S.now(), R.now()) if name == "C" else None
        server_oracle(torch, name, results, S, R, ts)
        if name in ("A", "C"):
            assert delta["hash_join"] >= 1, (name, delta)
        if name in ("A", "B"):
            assert stats["join_builds"] == 1, stats  # built in A, cached for B
        if name == "B":
            assert planner.JOIN_BUILD_STATS["hits"] >= 1, planner.JOIN_BUILD_STATS
        if name == "C":
            # all five reads rode one shared pass, not the per-query fallback
            assert stats["shared_scans"] - before["shared_scans"] == 1, stats
        line = {"phase": "server_tick", "tick": name, "seconds": dt,
                "launches": delta, "stats": stats, "host_top": top}
        emit(line)
        ticks.append(line)
        del results
    out = {"phase": "server", "rows": S.row_count, "build_rows": R.row_count,
           "launches": dict(_cuda.LAUNCHES),
           "join_build_stats": dict(planner.JOIN_BUILD_STATS),
           "tick_seconds": {t["tick"]: t["seconds"] for t in ticks},
           "snapshot": server.snapshot()}
    emit(out)
    return out


SHARDS = 4
# the sharded phase's path kernels: rows 1, 2, 4, 5 and 6 of PERF.md's table
SHARDED_KERNELS = ("scan_multi", "project", "aggregate", "groupby_sum", "hash_join")


class PairClock:
    """Times each step on the single engine and then on the sharded one
    (host clock, synced on both sides), and counts the launches of the
    sharded engine's runs alone: the phase's path."""

    def __init__(self, torch):
        from repro_torch.kernels import _cuda

        self.torch, self.cuda = torch, _cuda
        self.steps: list = []
        self.launches = dict.fromkeys(SHARDED_KERNELS, 0)

    def _run(self, fn, count: bool):
        self.torch.cuda.synchronize()
        before = dict(self.cuda.LAUNCHES)
        t0 = time.perf_counter()
        out = fn()
        self.torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if count:
            for k in self.launches:
                self.launches[k] += self.cuda.LAUNCHES[k] - before[k]
        return out, dt

    def pair(self, name: str, single, sharded, rows: int, profile: bool = False):
        """``(single result, sharded result)`` of one step; ``profile`` runs
        the sharded side under cProfile and keeps its top host functions."""
        a, t_single = self._run(single, False)
        prof = cProfile.Profile() if profile else None
        if prof:
            prof.enable()
        b, t_sharded = self._run(sharded, True)
        step = {"step": name, "rows": rows, "single_s": t_single,
                "sharded_s": t_sharded}
        if prof:
            prof.disable()
            step["sharded_host_top"] = host_top(prof)
        self.steps.append(step)
        return a, b

    def solo(self, name: str, fn, rows: int, single_s=None):
        out, dt = self._run(fn, True)
        self.steps.append({"step": name, "rows": rows, "single_s": single_s,
                           "sharded_s": dt})
        return out


def assert_same_blocks(torch, single, sharded) -> None:
    """Packed blocks, masks and join outputs bit-equal on the card."""
    for a, b in zip(flatten(single), flatten(sharded)):
        if isinstance(a, float):
            continue
        for x, y in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            if x.dtype != torch.float32:
                assert torch.equal(x, y), (x, y)


def sharded_holds(torch, eng, table, dim_parts) -> dict:
    """The path's kernels against their plain versions at the shard shapes:
    the fused scan and the probe over shard 0's chunk, the projection,
    aggregate and group-by over shard 0's rows."""
    from repro_torch.kernels import ops as K
    from repro_torch.kernels import rme_scan_multi as KR

    words = eng.rowstore.shard_parts(table)[0][0].words
    reqs = path_requests(table, table.now())
    fused = [reqs[k] for k in ("project", "filter", "aggregate", "groupby", "aggregate2")]
    errs = {"rows": words.shape[0]}
    got, want = K.scan_multi(words, fused), K.scan_multi_torch(words, fused)
    errs["scan_multi"] = max(compare(torch, kind_of(r, KR), x, y, words, r)
                             for r, x, y in zip(fused, got, want))
    del got, want
    p, a, g = reqs["project"], reqs["aggregate"], reqs["groupby"]
    errs["project"] = compare(torch, "project", K.project(words, p.geom),
                              K.project_torch(words, p.geom), words, p)
    akw = dict(agg_word=a.agg_word, pred_word=a.pred_word, pred_op=a.pred_op,
               pred_k=a.pred_k, ts=a.ts, ts_word=a.ts_word)
    errs["aggregate"] = compare(torch, "aggregate", K.aggregate(words, **akw),
                                K.aggregate_torch(words, **akw), words, a)
    gkw = dict(group_word=g.group_word, agg_word=g.agg_word, num_groups=g.num_groups,
               ts=g.ts, ts_word=g.ts_word)
    errs["groupby_sum"] = compare(torch, "groupby", K.groupby_sum(words, **gkw),
                                  K.groupby_sum_torch(words, **gkw), words, g)
    args = (words, dim_parts, 1, 0, table.ts_begin_word, table.now(), True)
    for x, y in zip(K.hash_join(*args), K.hash_join_torch(*args)):
        assert torch.equal(x, y)
    errs["hash_join"] = 0.0
    return errs


def sharded_phase(torch, S, R, seed: int, breakers: list, single_ticks: dict) -> dict:
    """The sharded backend on the card: ``ShardedEngine(num_shards=4)`` beside
    a single-device engine on the same table, step for step; the solo join
    with its broadcast; a sharded ``QueryServer`` through ticks A/B/C; a
    failover that runs the kernel; a real kernel error that propagates; the
    free ``dist_*`` operators; every result against numpy."""
    import dataclasses

    from repro_torch.core import (RelationalMemoryEngine, ShardedEngine, TableGeometry,
                                  compile_plan, faults, plan, planner, shard_ranges)
    from repro_torch.core import distributed as D
    from repro_torch.kernels import _cuda
    from repro_torch.kernels.rme_scan_multi import AggregateRequest
    from repro_torch.serve import QueryServer

    started = time.perf_counter()
    planner.clear_join_build_cache()
    single, eng = RelationalMemoryEngine(), ShardedEngine(num_shards=SHARDS)
    breakers += [single.breaker, eng.breaker]
    clock = PairClock(torch)
    rng = np.random.default_rng(seed + 5)
    n = S.row_count

    # upload: the same bytes as one engine, each shard its shard_ranges rows
    clock.pair("upload", lambda: single.device_chunks(S),
               lambda: eng.rowstore.shard_parts(S), n)
    assert eng.stats.bytes_uploaded == single.stats.bytes_uploaded == n * S.row_bytes
    parts = eng.rowstore.shard_parts(S)
    assert [[c.segments for c in p] for p in parts] == [
        [((start, rows),)] for start, rows in shard_ranges(n, SHARDS)]

    a, b = clock.pair("mixed_batch", lambda: single.execute_many(mixed_ops(single, S, None)),
                      lambda: eng.execute_many(mixed_ops(eng, S, None)), n, profile=True)
    assert_same_blocks(torch, a, b)
    oracle_batch(S, b, None, SHARDS)
    del a, b
    a, b = clock.pair("lone_aggregate", lambda: single.aggregate(S, "A6", "A7", "lt", 100),
                      lambda: eng.aggregate(S, "A6", "A7", "lt", 100), n)
    agg, pred = host_columns(S, 5, 6)
    m = pred < 100
    v = agg[m].astype(np.float64)
    for s_, c_ in (a, b):
        assert count_ok(c_, int(m.sum()), SHARDS)
        assert abs(s_ - v.sum()) <= SUM_RTOL * np.abs(v).sum() + 1e-3

    # writes: 4,096 appends land on one owning shard; then updates, deletes
    before = [len(p) for p in eng.rowstore.shard_parts(S)]
    S.append({c.name: rng.integers(-1000, 1000, 4096, dtype=np.int32)
              for c in S.schema.columns})
    after = [len(p) for p in eng.rowstore.shard_parts(S)]
    assert [x - y for x, y in zip(after, before)] == [1, 0, 0, 0], (before, after)
    S.update(rng.choice(n, 64, replace=False),
             {"A1": rng.integers(-1000, 1000, 64, dtype=np.int32)})
    S.delete(rng.choice(n, 64, replace=False))
    ts = S.now()
    a, b = clock.pair("mixed_batch_snapshot",
                      lambda: single.execute_many(mixed_ops(single, S, ts)),
                      lambda: eng.execute_many(mixed_ops(eng, S, ts)), S.row_count)
    assert_same_blocks(torch, a, b)
    oracle_batch(S, b, ts, SHARDS + 1)
    # the single engine (base + one tail): its blocks equal the sharded ones
    oracle_batch(S, a, ts, 2, blocks=False)
    del a, b

    # the solo join S.A2 = R.A2: one build, one broadcast, every shard probes
    def join(e):
        return compile_plan(plan(S).join(R, key="A2", left_proj="A1", right_proj="A3"), e).run()

    def cold_join(e):
        # both engines share the planner's build cache (keyed by device):
        # each cold side pays the key check and R's build itself
        planner.clear_join_build_cache()
        return join(e)

    coll = (eng.stats.bytes_collective, eng.stats.collective_ops)
    a, b = clock.pair("solo_join", lambda: cold_join(single), lambda: cold_join(eng),
                      S.row_count)
    (bparts, _), = eng._bcast_parts.values()
    assert (eng.stats.bytes_collective - coll[0],
            eng.stats.collective_ops - coll[1]) == ((SHARDS - 1) * bparts.nbytes, 1)
    want = join_oracle(S, R, None, 2)
    for res in (a, b):
        check_join(res, want)
    assert_same_blocks(torch, [a], [b])
    coll = (eng.stats.bytes_collective, eng.stats.collective_ops)
    a, b = clock.pair("solo_join_warm", lambda: join(single), lambda: join(eng), S.row_count)
    assert (eng.stats.bytes_collective, eng.stats.collective_ops) == coll  # cache hit
    check_join(b, want)
    del a, b, want

    # a permanent fault on shard 1: its chunks re-run on the root, through
    # the kernel; a malformed request is a real error and propagates
    ops = lambda: mixed_ops(eng, S, ts)  # noqa: E731
    healthy = eng.execute_many(ops())
    shard1 = eng.rowstore.shard_parts(S)[1]
    chunks = sum(len(p) for p in eng.rowstore.shard_parts(S))
    _cuda.reset_launches()
    fail0 = (eng.stats.failovers, eng.stats.bytes_failover)
    with faults.fault_plan(faults.FaultPlan().inject(
            "shard_pass", kind="permanent", times=None, shard=1)):
        failed = clock.solo("failover_batch", lambda: eng.execute_many(ops()), S.row_count)
    # the faulted pass launched nothing: shard 1's chunks ran by failover
    failover_launches = _cuda.LAUNCHES["scan_multi"] - (chunks - len(shard1))
    assert failover_launches == len(shard1), (dict(_cuda.LAUNCHES), chunks)
    assert (eng.stats.failovers - fail0[0],
            eng.stats.bytes_failover - fail0[1]) == (1, sum(c.words.numel() * 4 for c in shard1))
    for x, y in zip(flatten(healthy), flatten(failed)):
        for p_, q_ in zip(x if isinstance(x, tuple) else (x,), y if isinstance(y, tuple) else (y,)):
            assert torch.equal(p_, q_)
    del healthy, failed
    try:
        eng._serve_scan(S, (AggregateRequest(agg_word=40), AggregateRequest(agg_word=1)))
        raise AssertionError("a malformed request did not raise")
    except ValueError as err:
        assert "outside the" in str(err), err
    assert eng.stats.failovers - fail0[0] == 1 and eng.shard_health() == ["healthy"] * SHARDS

    holds = sharded_holds(torch, eng, S, bparts)
    stats = dataclasses.asdict(eng.stats)
    del single, eng, bparts, parts
    gc.collect()
    torch.cuda.empty_cache()

    # the sharded server through ticks A/B/C
    planner.clear_join_build_cache()
    server = QueryServer(num_shards=SHARDS)  # on the card
    breakers.append(server.engine.breaker)
    seen = dict(_cuda.LAUNCHES)
    for name, results, dt, _ in server_ticks(torch, server, S, R, seed, STREAM_CHUNK_ROWS):
        delta = {k: _cuda.LAUNCHES[k] - seen[k] for k in SHARDED_KERNELS}
        seen = dict(_cuda.LAUNCHES)
        for k, v in delta.items():
            clock.launches[k] += v
        if name in ("A", "C"):
            assert delta["hash_join"] >= 1, (name, delta)
        ts_c = max(S.now(), R.now()) if name == "C" else None
        server_oracle(torch, name, results, S, R, ts_c)
        clock.steps.append({"step": f"server_tick_{name}", "rows": S.row_count,
                            "single_s": single_ticks[name], "sharded_s": dt,
                            "launches": delta})
        del results
    srv_snap = server.snapshot()
    assert srv_snap["engine_collective_ops"] >= 1 and srv_snap["engine_shards_quarantined"] == 0
    del server
    gc.collect()
    torch.cuda.empty_cache()

    # the free operators over 4 shards of the card: rows 2, 4, 5 run
    mesh = [torch.device("cuda")] * SHARDS
    w = S.words()
    n = S.row_count
    words = D.pad_rows_to(torch.from_numpy(w).cuda(), SHARDS)
    r_words = D.pad_rows_to(torch.from_numpy(R.words()).cuda(), SHARDS)
    geom = TableGeometry.from_schema(S.schema, ["A1", "A5"], n)
    s_geom = TableGeometry.from_schema(S.schema, ["A1", "A2"], n)
    r_geom = TableGeometry.from_schema(R.schema, ["A2", "A3"], R.row_count)
    free0 = dict(_cuda.LAUNCHES)
    packed = clock.solo("dist_project", lambda: D.dist_project(words, geom, mesh, valid_rows=n), n)
    c0, c1, c2, c4 = host_columns(S, 0, 1, 2, 4)
    assert same_block(packed[:n], [c0, c4])
    del packed
    agg = clock.solo("dist_aggregate", lambda: D.dist_aggregate(
        words, mesh, agg_word=0, pred_word=2, pred_op="gt", pred_k=100, valid_rows=n), n)
    m = c2 > 100
    v = c0[m].astype(np.float64)
    host = agg.cpu().numpy()
    assert count_ok(host[1], int(m.sum()), SHARDS)
    assert abs(host[0] - v.sum()) <= SUM_RTOL * np.abs(v).sum() + 1e-3
    gs, gc_ = clock.solo("dist_groupby", lambda: D.dist_groupby(
        words, mesh, group_word=1, agg_word=0, num_groups=16, valid_rows=n), n)
    gid = np.mod(c1.astype(np.int64), 16)
    want_c = np.bincount(gid, minlength=16)
    assert all(count_ok(x, int(y), SHARDS) for x, y in zip(gc_.cpu().numpy(), want_c))
    want_s = np.bincount(gid, weights=c0.astype(np.float64), minlength=16)
    abs_s = np.bincount(gid, weights=np.abs(c0).astype(np.float64), minlength=16)
    assert np.all(np.abs(gs.cpu().numpy() - want_s) <= SUM_RTOL * abs_s + 1e-3)
    res = clock.solo("dist_join", lambda: D.dist_join(
        words, r_words, mesh, s_geom, r_geom, s_key_word=1, s_val_word=0, r_key_word=0,
        r_val_word=1, s_valid_rows=n, r_valid_rows=R.row_count), n)
    s_want, r_want, m_want = join_oracle(S, R, None, 2)
    for got, exp in zip(res, (c0, r_want, m_want)):
        assert np.array_equal(got[:n].cpu().numpy(), exp)
    free = {k: _cuda.LAUNCHES[k] - free0[k] for k in ("project", "aggregate", "groupby_sum")}
    assert all(v >= SHARDS for v in free.values()), free  # a launch a shard at least
    del words, r_words, res
    padding = dist_padding_check(torch, seed)

    out = {"phase": "sharded", "seconds": time.perf_counter() - started,
           "shards": SHARDS, "rows": S.row_count,
           "build_rows": R.row_count, "steps": clock.steps,
           "bytes_collective": stats["bytes_collective"],
           "collective_ops": stats["collective_ops"],
           "failovers": stats["failovers"], "bytes_failover": stats["bytes_failover"],
           "failover_scan_launches": failover_launches,
           "launches": clock.launches, "free_operator_launches": free,
           "shard_holds_max_abs_err": holds, "server_snapshot_collective": [
               srv_snap["engine_bytes_collective"], srv_snap["engine_collective_ops"]],
           "padding_check_rows": padding, "stats": stats}
    emit(out)
    missing = [k for k, v in clock.launches.items() if v == 0]
    assert not missing, f"kernels never launched on the sharded path: {missing}"
    return out


def dist_padding_check(torch, seed: int) -> int:
    """The free operators at 5,003 rows (one padding row over 4 shards): the
    card equals the CPU, bit for bit, and padding stays out."""
    from repro_torch.core import TableGeometry
    from repro_torch.core import distributed as D

    S, R = build_table(5003, seed, 1024), build_dimension(1023, seed)
    n, nr = S.row_count, R.row_count
    geom = TableGeometry.from_schema(S.schema, ["A1", "A5"], n)
    s_geom = TableGeometry.from_schema(S.schema, ["A1", "A2"], n)
    r_geom = TableGeometry.from_schema(R.schema, ["A2", "A3"], nr)
    outs = []
    for dev in ("cuda", "cpu"):
        mesh = [torch.device(dev)] * SHARDS
        w = D.pad_rows_to(torch.from_numpy(S.words().copy()).to(dev), SHARDS)
        rw = D.pad_rows_to(torch.from_numpy(R.words().copy()).to(dev), SHARDS)
        assert w.shape[0] == 5004 and rw.shape[0] == 1024
        outs.append([
            D.dist_project(w, geom, mesh, valid_rows=n),
            D.dist_aggregate(w, mesh, agg_word=0, pred_word=2, pred_op="gt",
                             pred_k=10, valid_rows=n),
            *D.dist_groupby(w, mesh, group_word=1, agg_word=0, num_groups=16,
                            valid_rows=n),
            *D.dist_join(w, rw, mesh, s_geom, r_geom, s_key_word=1, s_val_word=0,
                         r_key_word=0, r_val_word=1, s_valid_rows=n, r_valid_rows=nr),
        ])
    for x, y in zip(*outs):
        assert torch.equal(x.cpu(), y), (x, y)
    packed, matched = outs[1][0], outs[1][-1]
    assert not packed[n:].any() and not matched[n:].any()
    return n


def small_reference_check(torch, seed: int, breakers: list) -> None:
    """The card against the CPU on small tables, for every revision: the
    engine batch and the server's tick script; then the WAL round."""
    from repro_torch.core import RelationalMemoryEngine, planner
    from repro_torch.serve import QueryServer

    def engine(device, revision="mlp"):
        eng = RelationalMemoryEngine(device=device, revision=revision)
        breakers.append(eng.breaker)
        return eng

    results = []
    for device in ("cuda", "cpu"):
        out = []
        for revision in REVISIONS:
            table = build_table(5000, seed, 1024)
            eng = engine(device, revision)
            out += eng.execute_many(mixed_ops(eng, table, None))
            table.append({c.name: np.arange(300, dtype=np.int32) - 150
                          for c in table.schema.columns})
            table.delete(np.arange(0, 5000, 9))
            out += eng.execute_many(mixed_ops(eng, table, table.now()))
            planner.clear_join_build_cache()
            S, R = build_table(5000, seed, 1024), build_dimension(1024, seed)
            server = QueryServer(engine(device, revision))
            for name, res, _, _ in server_ticks(torch, server, S, R, seed, 1000):
                server_oracle(torch, name, res, S, R,
                              max(S.now(), R.now()) if name == "C" else None)
                out += flatten(res)
        out += wal_round(torch, seed, lambda: engine(device))
        results.append(out)
    assert len(results[0]) == len(results[1])
    for a, b in zip(*results):
        if isinstance(b, float):
            assert a == b, (a, b)
            continue
        for x, y in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            assert torch.equal(x.cpu(), y), (x, y)
            assert torch.isfinite(y.float()).all()
    emit({"phase": "small_reference", "rows": 5000, "revisions": list(REVISIONS),
          "wal_round": True, "ok": True})


def wal_round(torch, seed: int, engine) -> list:
    """A server with a write-ahead log through the tick script (tick C
    writes S); S recovered from the log; tick C's reads served again from
    the recovered table by a fresh server pinned to the same snapshot.
    Returns tick C's results followed by the recovered server's."""
    from repro_torch.core import RelationalTable, WriteAheadLog, planner
    from repro_torch.serve import QueryServer

    planner.clear_join_build_cache()
    S, R = build_table(5000, seed, 1024), build_dimension(1024, seed)
    wal = WriteAheadLog()
    server = QueryServer(engine(), wal=wal)
    ticks = {name: res for name, res, _, _ in
             server_ticks(torch, server, S, R, seed, 1000)}
    assert server.snapshot()["wal_records"] == 4  # checkpoint + three writes
    recovered = RelationalTable.recover(wal, S.uid)
    assert np.array_equal(recovered.words(), S.words()) and recovered.now() == S.now()
    fresh = QueryServer(engine(), snapshot_reads=True)
    tickets = [fresh.submit(q) for q in tick_c_reads(recovered, R)]
    fresh.drain()
    again = [tk.result(timeout=900) for tk in tickets]
    server_oracle(torch, "C", again, recovered, R, max(recovered.now(), R.now()))
    first, second = flatten(ticks["C"]), flatten(again)
    for a, b in zip(first, second):
        if isinstance(a, float):
            assert a == b, (a, b)
        else:
            for x, y in zip(a if isinstance(a, tuple) else (a,),
                            b if isinstance(b, tuple) else (b,)):
                assert torch.equal(x, y)
    return first + second


def flatten(results) -> list:
    """Server results as a flat list of tensors, tuples and floats."""
    out = []
    for r in results:
        if hasattr(r, "r_projs"):
            out += [r.s_proj, *r.r_projs, r.matched]
        elif hasattr(r, "r_proj"):
            out += [r.s_proj, r.r_proj, r.matched]
        else:
            out.append(r)
    return out


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch" / "__init__.py").is_file():
        print(f"chip_smoke: no port at {src / 'repro_torch'} (run the script from a "
              f"checkout of the repository); nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    from repro_torch.kernels import _cuda

    started = time.perf_counter()
    device = card(torch)
    t0 = time.perf_counter()
    _cuda.load()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": str(_cuda.library_path().name),
          "flash_ptxas": _cuda.ptxas_report("rm_flash.cu"),
          "flash_bwd_ptxas": _cuda.ptxas_report("rm_flash_bwd.cu"),
          "project_ptxas": _cuda.ptxas_report("rm_project.cu"),
          "spans_ptxas": _cuda.ptxas_report("rm_spans.cu"),
          "join_ptxas": _cuda.ptxas_report("rm_join.cu"),
          "scan_ptxas": _cuda.ptxas_report("rm_scan.cu"),
          "w8_ptxas": _cuda.ptxas_report("rm_w8.cu"),
          "moe_ptxas": _cuda.ptxas_report("rm_moe.cu"),
          "rglru_ptxas": _cuda.ptxas_report("rm_rglru.cu")})

    breakers: list = []  # every engine's breaker; the engines themselves are freed
    small_reference_check(torch, args.seed, breakers)
    t0 = time.perf_counter()
    table = build_table(args.rows, args.seed, args.build_rows)
    dim = build_dimension(args.build_rows, args.seed)
    # S as built, for the sharded phase (the engine and server phases write S)
    pristine = {"columns": [(c.name, c.dtype, c.width, c.codec) for c in table.schema.columns],
                "words": table.words().copy(), "clock": table.now()}
    emit({"phase": "data", "rows": table.row_count,
          "row_bytes_stored": table.row_bytes,
          "bytes_stored": table.row_count * table.row_bytes,
          "build_rows": dim.row_count,
          "seconds": time.perf_counter() - t0})
    kernels = kernels_phase(torch, table, dim, args.reps)
    # the main path first, then the revision study and the selection entry
    # points, so the main path's phases see the card as they did before
    engine = engine_phase(torch, table, args.seed, breakers)
    gc.collect()
    torch.cuda.empty_cache()
    server = server_phase(torch, table, dim, args.seed, breakers)
    gc.collect()
    torch.cuda.empty_cache()
    # the sharded backend on S as --seed built it, beside a single engine
    from repro_torch.core import RelationalTable

    fresh = RelationalTable.from_state(pristine)
    del pristine
    sharded = sharded_phase(torch, fresh, dim, args.seed, breakers,
                            server["tick_seconds"])
    del fresh
    gc.collect()
    torch.cuda.empty_cache()
    revisions = revision_phase(torch, table, args.reps, breakers)
    selection = selection_phase(torch, table, breakers)
    # the LM phases, after S, R and the engines are released
    del table, dim
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "released", "memory_allocated": torch.cuda.memory_allocated()})
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 compared card vs CPU
    torch.backends.cudnn.allow_tf32 = False
    lm_reference_phase(torch, args.seed)
    lm_reference_inputs_phase(torch, args.seed)
    kernels.update(flash_phase(torch, args.seed, args.reps))
    kernels.update(w8_phase(torch, args.seed))
    kernels.update(moe_phase(torch, args.seed, args.reps))
    kernels.update(rglru_phase(torch, args.seed, args.reps))
    lm = lm_serve_phase(torch, args.seed)
    moe = lm_serve_moe_phase(torch, args.seed)
    ssm = lm_serve_recurrent_phase(torch, args.seed, SSM_ARCH, "lm_serve_ssm")
    hybrid = lm_serve_recurrent_phase(torch, args.seed, HYBRID_ARCH, "lm_serve_hybrid",
                                      HYBRID_CHECK_LAYERS, HYBRID_SCAN_LAYERS)
    encdec = lm_serve_inputs_phase(torch, args.seed, ENCDEC_ARCH, "lm_serve_encdec")
    vlm = lm_serve_inputs_phase(torch, args.seed, VLM_ARCH, "lm_serve_vlm", VLM_LAYERS)
    # the train phase: fault 3.2's wide projections, the flash and
    # scan backwards, qwen3-8b trained at full width (the main path), the
    # trainer's checkpoint and restart, card against CPU
    gc.collect()
    torch.cuda.empty_cache()
    wide_projection_phase(torch, args.reps)
    kernels["flash_attention_backward"] = flash_backward_kernel(
        flash_backward_phase(torch, args.seed, args.reps))
    kernels.update(scan_backward_phase(torch, args.seed, args.reps))
    train = train_phase(torch, args.seed, device["nvidia_smi"])
    sharded_train = train_sharded_phase(torch, args.seed, train, device["nvidia_smi"])
    trainer_phase(torch, args.seed)
    train_reference_phase(torch, args.seed)
    # recurrentgemma-9b's train line: its local layer's gradient is the
    # flash backward at D 256, which nothing else on a main path launches
    train_rg = train_phase(torch, args.seed, device["nvidia_smi"], TRAIN_RG_ARCH,
                           TRAIN_RG_LAYERS, "train_rg")
    # the last modules: decode-SP, the MoE block's expert-parallel forms and
    # the dry run (the roofline's line comes from the train phase)
    decode_sp_phase(torch, args.seed, device["nvidia_smi"])
    moe_expert_parallel_phase(torch, args.seed, device["nvidia_smi"])
    dryrun_phase(device["nvidia_smi"])
    # each kernel's launches on its own path; "project" is the engine phase's
    # (the revision phase's mlp engines launch it too, counted in its line);
    # the flash kernel's in the seven serving runs (bf16, int8, MoE, the SSM,
    # which has none, the hybrid, the VLM and the encoder-decoder), the W8 kernel's in the int8 run, the
    # MoE kernel's in the MoE run, the scan kernel's in the hybrid run
    launches = {**revisions["launches"], **selection["launches"],
                **engine["launches"], "hash_join": server["launches"]["hash_join"],
                "flash_attention": sum(lm[w]["launches"]["flash_attention"]
                                       for w in ("bf16", "int8"))
                + sum(cell["launches"]["flash_attention"]
                      for cell in (moe, ssm, hybrid, vlm, encdec)),
                "w8_matmul": lm["int8"]["launches"]["w8_matmul"],
                "moe_ffn": moe["launches"]["moe_ffn"],
                "rglru_scan": hybrid["launches"]["rglru_scan"],
                "rglru_scan_backward": 0,
                "flash_attention_backward": train["launches"]["flash_attention_backward"]}
    for k, v in sharded["launches"].items():  # the sharded phase's path too
        launches[k] += v
    for k in ("project", "flash_attention"):  # and the train paths'
        launches[k] += train["launches"][k] + train_rg["launches"][k]
    for k in ("flash_attention_backward", "rglru_scan", "rglru_scan_backward"):
        launches[k] += train_rg["launches"][k]
    for k in ("project", "flash_attention", "flash_attention_backward"):  # the sharded step's
        launches[k] += sharded_train["launches"][k]
    breaker = {k: sum(b.snapshot()[k] for b in breakers)
               for k in ("breaker_trips", "breaker_fallbacks", "breaker_probes",
                         "breaker_open")}
    emit({"phase": "breaker", "engines": len(breakers), **breaker})
    assert not any(breaker.values()), breaker
    assert set(kernels) == set(REPLACES) | set(FUSIONS) | {"hash_join_packed"} | {
        name for name, *_ in FLASH_SHAPES}, sorted(kernels)
    assert len(REPLACES) == 11
    assert all(launches[name] > 0 for name in (*REPLACES, *FUSIONS)), launches
    emit({"phase": "done", "seconds": time.perf_counter() - started})

    emit({"kernels": [{
        "name": name, "route": "cuda",
        "source": SOURCES.get(name, "src/repro_torch/csrc/rm_scan.cu"),
        "replaces": REPLACES.get(name) or FUSIONS[name], "launches": launches[name],
        "max_abs_err": k["max_abs_err"], "ms": k["kernel_ms"],
        "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
        "bound_by": k["bound_by"], "library_ms": k["library_ms"],
    } for name, k in kernels.items() if name in REPLACES or name in FUSIONS]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Chip smoke for the PyTorch / CUDA port (``deepspeed_tpu_torch``) on one GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
Phases, each raising on failure (so the exit code is non-zero):

1. build    -- compile the CUDA kernels from ``deepspeed_tpu_torch/csrc``
               (one nvcc per source, in parallel), then dump each
               library's SASS (one ``cuobjdump`` each, in parallel); all
               the while the checks' halves that launch no kernel run
               (``build_window_references``: the optimizers' updates and
               eigen_check's HVP on the card and the CPU, compress_check's
               transform pairs, the CPU engines of train_check,
               sparse_train_check, schedule_check and compress_check);
               print the build time, the window's and each kernel's
               register / shared-memory report;
   sass     -- for every kernel of the tensor-core libraries (K1 dense,
               K7 block-sparse, K2 / K3 paged, the dequant-matmuls K4 /
               K5), its HGMMA, HMMA and FFMA instruction counts
               (``cuobjdump -sass``) beside ptxas's registers and spills;
               fails if an attention kernel or a dequant-matmul product
               kernel holds no HGMMA, a K2 / K3 kernel spills, a
               dequant-matmul kernel holds HMMA, or one of its
               one-CTA-an-SM kernels launches with other than
               QMM_LAUNCH_REGS registers; and the row quantizers'
               (``quantize.cu``) F2FP, F2I and 16-byte load / store counts
               (``rowq_sass``, with calls and local-memory traffic: fails
               if a quantize kernel has no 16-byte load or store, or an
               fp8 one no F2FP);
2. kernels  -- each kernel against its plain PyTorch version on the card,
               bf16 inputs, the plain version computing in fp32, at the
               serving path's shapes (tolerance KERNEL_TOL; K1f's o also
               BWD_TOL per 64-row block, at head_dim 64 / 256 and a query
               group of 71), and the
               training backward (K1f's lse, the dq and dk/dv kernels) at
               s 4096 and 4097, packed batches with segments and soft cap,
               s 200, head_dim 64 and 256, and groups of 71 (falcon_7b's
               71 query heads on 1 kv head) and 7 (qwen2_7b's 28 on 4;
               BWD_TOL, LSE_TOL); K1f / K1b at head_dim 80 and 96 through
               the ``flash_attention`` entry's zero padding to 128
               (``PADDED_CASES``: o, dq, dk, dv against the plain versions
               at the real head dim, one launch of each kernel); the
               dequant-matmuls (K4 int8 / e4m3, K5 fp6) at every llama3_8b
               serving-matmul shape, M 1, 16, 300, 512 and 2048, and ragged
               and unaligned shapes with a bias (QMM_TOL, relative
               Frobenius), every weight code decoded exactly (x = the
               identity, bit-identical); the row quantizers (K6a/b/c)
               byte-identical on ``row_quant_inputs``: [4096, 14336] bf16
               rows with zero, inf, NaN, subnormal and outlier rows, N not
               a multiple of 16, fp32 / fp16 rows, rows wider than the
               registers hold and an unaligned base;
               K2 and K3 (``DECODE_CASES``, ``CTX_CASES``) at head_dim 64 /
               128 / 256, query groups 1, 4, 7, 16 and 71, blocks of 8, 16
               and 32: idle slots, a 4,096-key slot and context, -1 and
               out-of-range ids, soft caps, verify-shaped packs whose
               contexts end mid-page, pad rows exactly 0; the partial modes
               (seq-sharded serving, ``CTX_PARTIAL_CASES``,
               ``DECODE_PARTIAL_CASES``) on each shard's view of pools
               striped over 2 or 4 shards (K3 with include_pack on and
               off), rows with no key on a shard exactly (0, -1e30, 0), and
               the shards' partials merged against K3 / K2 on the whole
               pool;
3. engine   -- ``InferenceEngineV2`` on ``llama3_proxy_410m`` (24 layers,
               bf16, random weights from a seed): 64 prompts of 128 tokens
               through ``put``, then 64 greedy ``step``s; the flash and
               decode kernels must have launched layers x dispatches times,
               and a few sequences are replayed through the port's own
               model runner on the CPU in fp32 (near-argmax check);
   megastep -- the same engine cell as ``bench.py:1071-1110`` runs it:
               the 64 prompts through ``put``, 8 per-tick ``step``s, then
               ``step_n(64)``, every tick a replay of the tick's CUDA graph
               (captured by the warm-up's ``step_n(2)``): wall ms per token
               of the burst and of the per-tick ticks, a profiled
               ``step_n(16)`` (device ms per tick, idle share, host-to-device
               and device-to-host copies per burst), launches per replay;
               one burst of 64 ticks, K2 24 times a replayed tick, 4 streams
               near-argmax on the CPU, 0 blocks after ``close()``; the token
               match with the engine phase's per-tick streams reported;
   megastep_stops -- one burst of 16 ticks whose rows end mid-burst at a
               stop token, an emission cap and ``max_seq_len``, against a
               free burst: every run ends exactly there, the descriptors'
               lengths and block lists and the block-table rows agree, no
               leak;
   megastep_serve -- ``bench.py --serving --megastep`` (TPU branch,
               uncut): 16 requests of a 512-token system prompt + a 64-token
               suffix, 48 greedy tokens, Poisson(2) arrivals, 8 slots, 256
               blocks, ``decode_megastep`` 1 and 8 on fresh engines in turns
               (1, 8, 8, 1): effective tokens/s, decode tick p50, host syncs
               per token; 16/16 finish, bursts only at 8, no leak, 4 fused
               streams near-argmax on the CPU;
4. scheduler -- the shared-prefix workload through ``engine.scheduler``
               (16 requests of a 512-token system prompt + 64-token suffix,
               32 new tokens each, prefix caching, chunked prefill); the
               packed-context kernel must have launched;
   router   -- ``bench.py --serving --router`` (TPU branch, uncut) on the
               410M model: 48 requests (half on a shared 128-token system
               prompt, each with a 32-token suffix), 24 greedy tokens, 8
               slots, 192 blocks of 32, buckets 64-512, prefix caching;
               the single engine, then the router over 2 workers: 48/48
               finished, prefix hits, namespaces serve / serve2, zero-leak
               closes, each worker's memory growth within 10 % of its KV
               pool (shared weights), 4 routed streams near-argmax on the
               CPU; routed and single-engine tokens/s, per-worker launches;
   router_handoff -- 3 workers (1 prefill), the 512-token prompt migrating
               at first token with ``handoff_fmt`` 'none' then 'int8': one
               handoff each, the wire bytes exact ('none': 12,582,912 B)
               or within [1, 1.5) x the elements ('int8'); then the pages
               once more into a decode worker whose burst graph was
               captured before, and ``step_n(16)`` replays it over the
               injected pool near-argmax; extract / codec / inject ms;
   router_check -- the 410M model cut to 2 layers through the same router
               and handoffs, every routed and handoff stream near-argmax
               against the port on the CPU in fp32 (the int8 stream on a
               CPU engine holding the card's dequantized pages); the int8
               codec's bytes on the card's pages equal JAX's numpy codec;
   router_fleet -- telemetry on, 3 workers (1 prefill), a fleet collector
               thread: merged ttft / e2e percentiles equal the pooled
               samples, the stitched trace's route and handoff spans, SLO
               availability 1.0, deferred spans resolved with device time,
               and a telemetry-off twin with equal router stats (the
               telemetry tax printed);
   router_chaos -- the bench's storm (FaultInjector seed 0) on a single
               engine, then on the router with a worker kill (seed 1):
               availability >= the baseline, one worker death, SLO
               availability = the terminal states, zero leaks;
   kernel_errors_surface -- one worker's paged-decode launches made to
               raise ``KernelError``: ``router.tick()`` raises it, no
               request FAILED, no retry, no worker death;
   remote_router -- ``build_remote_router`` over 2 subprocess workers on
               this card (``python -m deepspeed_tpu_torch.serving.remote``,
               each its own CUDA context, seeded weights and pool; the
               kernels built above, so a child only loads them): the router
               workload after a rehearsal, per tick, then with
               ``decode_megastep`` 8 pushed to both children: 48/48 each,
               4 streams near-argmax, each child's launches (its ``stats``
               reply) show K1f, K2 and K3, the megastep pass's K2 layers x
               burst ticks, no death, 0-block audits, children reaped;
               tokens/s beside the in-process router and single engine,
               and an in-process router warmed alike run alternately with
               the children over COMPARE_ROUNDS fresh draws (medians and
               spread of each side); then ``serve_worker_main`` over a pipe to one child: one
               request, a clean exit on EOF with a 0-block audit;
   remote_handoff -- 3 children (1 prefill): the 512-token prompt migrating
               across processes in 'none' and 'int8', wire bytes equal to
               router_handoff's exactly, near-argmax; extract / codec /
               inject / wire ms, the prefill child's reply-cache bytes;
   remote_fleet -- the same 3 children with a collector pulling every 25 ms
               over their metrics channels: merged percentiles = the pooled
               samples, a clock offset per worker, SLO availability 1.0;
   remote_chaos -- ``bench.py:591-660``'s seeded network storm on 3 children
               and a real SIGKILL of worker 1 at router tick 6: all
               terminal, availability >= router_chaos's, one death found by
               lease, replays near-argmax, survivors 0 blocks, the killed
               child reaped;
   adapt_serve -- ``bench.py --serving --adapt``'s drift twin at its
               accelerator sizes: static vs ``attach_controller``, the
               injected bad retune rolled back, 4 streams near-argmax;
   autotune_serve -- ``autotune_serving`` on the 410M model over the rows
               the port builds, their serve_replicas 2 twins refused with
               the port's text; the winner rebuilt and served;
   spec_serve -- the workload of ``bench.py --serving --spec`` on the same
               model (16 requests of a random 96-token base + an 8-token
               pattern repeated to 64, 64 greedy tokens each, 8 slots, 96
               blocks, prefix caching, ``spec_max_draft`` 4): speculation
               off, on, on, off, on fresh engines, each after a rehearsal;
               verify ticks, accepted drafts, the leak check, the
               packed-context kernel launched at least layers x verify
               ticks times, and 4 streams replayed on the CPU in fp32
               (near-argmax); accept rate, tokens per target forward and
               tokens/s off and on;
   longctx_check -- the 410M model at full width with 2 layers, bf16,
               ``seq_shards`` 2 and 4: three streams of the shared-prefix
               workload and a 1,100-token prompt through the scheduler,
               replayed on the CPU in fp32 on one pool (near-argmax); the
               partial kernels launched layers x S times per decode tick
               and per context pack, K2 and K3 never; then the prompts
               through ``put`` and one ``step_n(8)`` burst at each S, the
               decode partial layers x S times a replayed tick, near-argmax;
   longctx  -- the workload of ``bench.py --serving --longctx`` (TPU
               branch, uncut): 8 requests of a 256-token system prompt +
               a 64-token suffix, 32 greedy tokens, Poisson(2) arrivals,
               4 slots, 96 blocks of 32; the seq_shards = 2 engine and its
               single-pool twin in turns (S2, single, single, S2):
               effective tokens/s, decode tick p50, twin token match, a
               profiled tick each; then a 1,792-token prompt that a
               48-block single slice rejects (pool_impossible, budget 48)
               and the S = 2 engine serves to 32 tokens, leak-free;
   gpt2_serve -- ``gpt2_small`` at full depth (12 layers, 12 heads of 64,
               MHA), bf16: the engine phase's shape (K1f and K2 at head_dim
               64 launched 12 x packs and 12 x ticks, a one-tick profile),
               its burst (the megastep phase's shape with ``step_n(16)``,
               K2 at head_dim 64 12 times a replayed tick), then the spec
               workload with speculation on; near-argmax replays of all;
   Block-sparse attention (K7f's o and lse, K7b's dq and dk/dv;
               ``SPARSE_CASES``) at b 2, s 4096, hq 8 / hkv 2, hd 128 under
               fixed(128, 4, 1) and bigbird(128), a packed batch with
               segments and soft cap 30 at s 1024, hd 64 under
               fixed(128, 2, 1), a block-256 layout, hd 256, a group of 71,
               a block-512 layout (four forward CTAs a block) and a packed
               batch whose key ids differ from the rows' (KERNEL_TOL and
               BWD_TOL on o, LSE_TOL, BWD_TOL); the fused AdamW (K8)
               on an odd-sized buffer of 2^24 + 37 elements at steps 1 and
               1000, wd 0 and 0.1, aligned and not (K8_TOL), and a
               ``finite = False`` step that changes no bit;
5. train_check -- ``llama3_proxy_410m`` at full width with 2 layers, the
               bench config at seq 512, micro 2, GAS 2: two steps on the card
               in bf16 and through the port on the CPU in fp32 from the
               same weights and batch; step-1 loss within TRAIN_LOSS_RTOL,
               the cosine similarity of layer 0's wq / wk / wv / wo
               gradients above GRAD_COS_MIN, the flash kernels launched
               layers x micro-batches times per step and K8 once;
   sparse_train_check -- the same with ``sparse_attention`` fixed(128, 2, 1)
               (8 of 10 causal blocks active) and FusedAdam: the sparse
               kernels launched layers x micro-batches times per step, the
               flash kernels never, K8 once a step;
6. train    -- the training flagship (``bench.py:42-109``) at full width
               and depth: ``initialize`` -> one warm-up ``train_batch`` ->
               TRAIN_STEPS steps of ``train_on_loader``; loss finite and
               falling, flash_fwd / flash_bwd_dq / flash_bwd_dkv launched
               24 x 2 times per step and K8 once; step time, tokens/s, MFU,
               peak memory and a one-step profile (with the attention
               kernels' device ms and their share); then K8 timed on the
               engine's own flat buffers (430,752,768 elements) beside
               ``torch._fused_adamw_`` over the same leaves;
   train_shim -- the flagship again from the same seed, two steps through
               the reference's ``forward`` / ``backward`` / ``step``: each
               step's mean micro-batch loss against the train phase's first
               two ``train_batch`` losses (SHIM_LOSS_RTOL), boundaries, and
               the launches of two ``train_batch`` steps;
   sampling -- ``sample`` with top-p on CUDA over 256 rows of llama3's
               vocab (ROADMAP queue 3 fault 1's reproduction first) whose
               fp32 cumulative probability may never reach top_p: valid
               tokens, nothing masked in those rows, and such rows seen;
   checkpoint -- resumable training on the same flagship (prefetch depth 2)
               through ``initialize(training_data=<token rows from the
               seed>)``: run A takes 3 steps; run B takes 1 and calls
               ``save_checkpoint`` with batches parked in the prefetcher;
               run C loads into a fresh engine and takes 2.  Fails unless
               C's state after the load is byte-equal to B's at the save
               (masters, moments, counters, LR, sampler position), C's
               losses equal A's 2nd and 3rd to the bit, and K1f / K1b / K8
               launch 48 / 48 / 1 times a step; then the same with
               ``checkpoint.async_save``, where the step after the save
               must start before the write ends and ``latest`` move only
               at the commit.  Prints bytes, save (blocking and commit),
               load and sha256 seconds, and the free disk it checked
               first;
   hf_roundtrip -- ``export_hf_checkpoint`` of the 410M model's bf16
               parameters, ``initialize(model=<dir>)`` (masters equal to
               them in fp32) and ``load_hf_checkpoint`` streamed onto the
               card in bf16 (leaves bitwise equal; host peak beside the
               tree's bytes); greedy serving of 4 prompts x 16 tokens from
               both trees token-identical (K1f, K2 layers x dispatches);
   schedule_check -- the flagship's width at 2 layers with a seqlen
               curriculum cutting 1,024 tokens to 520 (K1 on a partial
               tile), the card against the CPU in fp32 with train_check's
               limits, unmasked and under a layer mask that drops layer 1;
               K1f / K1b kept layers x GAS a step, and the flops
               profiler's K1 count equal to its closed form;
   schedule_train -- the flagship at full depth with the curriculum
               (512 -> 4096), progressive layer drop, the CSV monitor,
               wall_clock_breakdown, memory_breakdown and the flops
               profiler on: 8 ``train_batch`` steps, then 3 of
               ``train_on_loader`` over an indexed dataset analyzed by
               ``DataAnalyzer`` (``data_analysis_path``); every step at
               the scheduler's length, K1f / K1b kept layers x GAS, the
               CSV's losses those of ``get_last_loss``, every drawn sample
               within the difficulty; prints the profiler's MFU beside the
               train phase's, and the step time with wall_clock_breakdown
               off and on and with the count on;
   compress_check -- the flagship's width at 2 layers: the compression
               transform (QAT with an 8 -> 4 bit ramp on the MLP, l1
               pruning of the attention, half the kv groups by head pruning
               with wo related, half the MLP rows with w_down related) on
               the card against the CPU in fp32 at steps before, at and
               after the offsets and in bf16 at and after them, bit for
               bit, and
               ``redundancy_clean``'s kept units and shrunk tree; then
               engines with every technique and 8-bit activations, the card
               against the CPU in bf16 with train_check's limits;
   compress_train -- the train cell with every technique on, 4 timed
               steps beside the train phase's step, the transform's device
               ms by profile; l1's kept count per leaf, half the units
               kept, the shrunk tree's fp32 logits the masked tree's
               within CLEAN_RTOL (and a tree keeping the pruned units
               beyond it), the sort's threshold ``kthvalue``'s (both
               timed);
   kd_train -- a 12-layer student from the 24-layer teacher's odd layers
               (``layer_reduction_init``) trained by ``make_kd_loss_fn``:
               K1f (24 + 12) x GAS, K1b 12 x GAS a step;
   lora_hybrid -- ``LoRACausalLM`` over the 24 layers (r 16, alpha 32)
               trained 3 steps of the train cell: K8 once a step over the
               adapters' elements alone, the bf16 base unchanged to the
               bit, state bytes beside the plain engine's; the hybrid
               engine's ``generate_batch`` (8 x 128 + 32) before and after
               (the streams change; K1f / K2 layers x dispatches); a
               ``decode_megastep`` hybrid's bursts, captured before
               training, token-identical after the refresh to a per-tick
               hybrid; a 2-layer merged copy near-argmax on the CPU;
   eigen_check -- the flagship's width at 2 layers: the fp32
               Hessian-vector product on the card against the CPU
               (HVP_RTOL), the engine's ``block_eigenvalues`` at every
               second step (its training on K1, the estimator on the plain
               body), and a double backward through K1 and K7 raising;
   sparse_train -- the flagship with ``sparse_attention`` fixed(128, 4, 1)
               (192 of 528 causal blocks) and FusedAdam: SPARSE_TRAIN_STEPS
               timed steps; sparse_fwd / sparse_bwd_dq / sparse_bwd_dkv 48
               times a step, K8 once, no flash kernel; the profiled step's
               host-to-device copies (the batch only: the layout's tables
               are cached on the card);
   optimizers -- Lamb, Lion, Adagrad and Muon (plain PyTorch updates; JAX
               builds them with optax): 3 updates of the 2-layer
               full-width flagship tree in the engine's layout on the card
               and on the CPU from the same seeded fp32 gradients (max abs
               error over max |p| within OPT_TOL, Muon OPT_NS_TOL); then
               the train flagship with each (one warm-up, 3 timed steps):
               step time and tokens/s beside the train phase's AdamW, the
               update alone (CUDA events, and device ms under the
               profiler) beside its bound,
               ``opt_state_bytes``, finite losses, no K8 launch;
   remat    -- the train flagship under remat none, full, selective, dots
               and offload (micro 8, or all at micro 4 if none does not
               fit): step time, peak memory of the timed steps, K1f / K1b
               launches a step (K1f twice a layer under full and dots),
               the bytes offload moves to the host and back a step;
               peak(full) <= peak(dots) <= peak(none), peak(offload) <
               peak(selective);
   presets_train -- every registered preset but llama3_70b and the two
               covered above, at full width and 2 layers, bf16, its own
               remat and attention: one train step at seq 64 against the
               port on the CPU in fp32 (TRAIN_LOSS_RTOL, GRAD_COS_MIN on
               layer 0's attention gradients), K1f / K1b launches (phi_2
               and gpt_neox_20b through the padding; none for the
               reference attention), peak memory;
   presets_serve -- llama2_7b, mistral_7b, qwen2_7b and opt_6_7b at full
               depth, bf16: 16 prompts of 128 through ``put``, 32 greedy
               ``step``s (K1f and K2 layers x dispatches), a profiled tick;
               a 2-layer full-width copy serves 2 streams that replay on
               the CPU in fp32 (near-argmax); no block in use after
               ``close()``;
7. quant_check -- ``llama3_8b`` at full width, 2 layers: for int8, fp8 and
               fp6 an engine on the card serves 4 prompts of 64 tokens and 8
               greedy steps; the same payloads replay every stream on the
               CPU in fp32 (near-argmax); K4 / K5 launched 15 times a
               forward;
8. quant_serve -- ``llama3_8b`` at full depth (``bench.py --serve8b`` at
               batch 16: 16 prompts of 128, 4 warm-up and 32 timed greedy
               ``step``s) in bf16 (the anchor), int8, fp8 and fp6 from one
               bf16 tree on the card: weight bytes, ms per tick, tokens/s,
               effective weight GB/s, prefill tokens/s, a one-tick profile
               and idle share, launches per forward (K4 / K5: 225); then a
               ``step_n(32)`` burst per format (K4 / K5 225 and K2 32 times
               a replayed tick): wall and device ms per token beside the
               per-tick ones;
9. quantizer -- the quantizer API (K6) on layer 0's w_up of that tree;
10. timings -- per kernel: kernel ms, plain ms, one PyTorch library call's
               ms where one computes the same function, and the card's
               bound for the same work (the backward kernels, and K1f
               again, at the training flagship's per-call shape; K4 / K5
               at M 16 and 512 on every llama3_8b matmul shape, by CUDA-
               graph replay and eager, [4096, 14336] the kernels line's
               entry, beside torch.matmul; K7f / K7b at the sparse
               flagship's per-call shape; K2, K2p, K3 on the scheduler's
               and a verify tick's pack and the partial modes on shard 0 of
               2, each by CUDA-graph replay and eager beside SDPA timed the
               same two ways, ``paged_timings``; K6a / K6b / K6c on
               [4096, 14336] bf16 by CUDA-graph replay and eager,
               ``quant_row_times``),
               K1f / K1b at head_dim 80 and 96 through the padded entry
               at phi_2's and gpt_neox_20b's heads beside SDPA at the real
               head dim (``padded_timings``),
               and K1's and K7's CUDA-core times before their tensor-core
               redesigns (``K1_EARLIER_MS``, ``K7_EARLIER_MS``, from
               PERF.md) as ``earlier_ms``.

Prints one JSON line per phase, the ``kernels`` JSON line, the card's name
and power limit, and last ``{"ok": true, "device": {...}}``.  Exits non-zero
with no result when there is no CUDA device or the package is missing.
"""
from __future__ import annotations

import contextlib
import json
import os
import re
import subprocess
import sys
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# bf16 kernel output vs the fp32 plain version on the same bf16 inputs,
# unit-scale values: bf16 keeps 8 mantissa bits (relative step 2^-8 = 3.9e-3
# near 1), plus a different fp32 summation order.
KERNEL_TOL = 2e-2
# the backward kernels' gradients span orders of magnitude along the
# sequence (dv of key 0 sums over every row, dq of a late row is ~1/sqrt(s)),
# so their error is held relative to the reference block by block: for each
# 64-row block of one head of one batch row (BWD_BLOCK), ||got - ref||_F /
# ||ref||_F <= BWD_TOL, and the same over the whole tensor.  The kernels
# compute in fp32 and round only their bf16 outputs: an error uniform within
# half an ulp (ulp 2^-7 on [1, 2)), about 1.6e-3 relative RMS.  The
# attention forwards' o is held the same way besides KERNEL_TOL: a late row
# that attends thousands of keys has |o| of a few hundredths, where the
# absolute limit alone would let a wrong V tile through (they round P to
# bf16 for the P V product as well, another ~1e-3).
BWD_TOL = 1e-2
BWD_BLOCK = 64
# K1f's lse in fp32 (fast exp / log in the kernel): absolute.
LSE_TOL = 1e-3
# train_check: the card's bf16 step against the CPU's fp32 step on the same
# weights and batch.  bf16 weights and activations through two layers move
# the loss by well under 1 %; a wrong kernel moves it by far more, or turns
# a gradient (a broken dq or dk shows in wq / wk, which the global norm
# would hide).
TRAIN_LOSS_RTOL = 1e-2
GRAD_COS_MIN = 0.99
# timed steps of the train phase, as many as one bench.py loop (each step
# runs the attention kernels 48 times forward and backward: about 1 s)
TRAIN_STEPS = 6
SPARSE_TRAIN_STEPS = 3
# K8 against its plain version on the same fp32 inputs: both compute in
# fp32, in another order and with FMA contraction in the kernel, so each of
# p, m, v is held by max |got - ref| / max |ref| (a few ulps; an element near
# 0 after cancellation in m would make an elementwise ratio meaningless).
K8_TOL = 1e-6
# the training flagship's block-sparse layout: DeepSpeed's `fixed` pattern
# at the smallest block the kernels skip by
SPARSE_FLAGSHIP = {"mode": "fixed", "block": 128, "num_local_blocks": 4, "num_global_blocks": 1}
SPARSE_CHECK = {"mode": "fixed", "block": 128, "num_local_blocks": 2, "num_global_blocks": 1}
# a layout block that holds four forward CTAs' rows
SPARSE_BLOCK512 = {"mode": "fixed", "block": 512, "num_local_blocks": 2, "num_global_blocks": 1}
# the packed K7 case with key ids apart from the rows' (s 1024): every row
# still sees a key of its own id under SPARSE_CHECK (sparse_results asserts)
SPARSE_QSEG_LENS = (300, 400, 200, 124)
SPARSE_KSEG_LENS = (200, 500, 150, 174)
# Near-argmax check of the card's greedy pick against fp32 CPU logits: the
# picked token's CPU logit must be within this fraction of the CPU row's
# logit range (max - min) of the row's maximum.  bf16 weights and
# activations through 24 layers move logits by a few tenths of a percent
# of the range; a wrong kernel moves them by tens of percent.
ARGMAX_TOL_FRAC = 0.02

# quantized serving (K4 / K5): bf16 output vs the fp32 plain version on the
# same bf16 input and payload, relative Frobenius error.  The products are
# exact in both; what differs is the bf16 rounding of the output (about
# 2^-9 / sqrt(3) = 1.1e-3 relative RMS) and the fp32 summation order.
QMM_TOL = 1e-2
# every serving matmul shape of llama3_8b: wq / wo, wk / wv, w_up / w_gate,
# w_down, the vocabulary head
QUANT_SHAPES_8B = [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096), (4096, 128256)]
# rows checked at each of them: decode at batch 1 and 16 (16-token tiles), a
# 300-row pack (a 256-token tile and its ragged edge), prefill of 512 and
# 2048 rows
QUANT_CHECK_M = (1, 16, 300, 512, 2048)

# published peaks of one H100 SXM (dense): bf16 tensor rate, fp32 CUDA-core
# rate, HBM3 rate
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

SEED = 0
DEVICE = "cuda"  # where the input builders put their tensors

# SASS opcodes counted in the tensor-core libraries (K1 dense, K7 block-sparse:
# flash_tc.cuh's bodies; K4 / K5: quant_matmul.cu): the tensor-core products
# (HGMMA: wgmma, HMMA: mma.sync) and fp32 FMAs (the CUDA-core arithmetic)
SASS_OPS = ("HGMMA", "HMMA", "FFMA")
FLASH_SOURCES = ("flash_fwd.cu", "flash_bwd.cu", "sparse_flash.cu")
# K2 and K3 (paged_tc.cuh's body, decode and packed-context instantiations)
PAGED_SOURCES = ("paged_decode.cu", "ctx_attention.cu")
QMM_SOURCE = "quant_matmul.cu"
# the registers a thread of the one-CTA-an-SM dequant-matmul kernels (token
# tiles 128 and 256) launches with: the launch bound's share, which their
# setmaxnreg hand-over from the producer to the consumer warpgroups assumes
# (quant_matmul.cu kLaunchRegs)
QMM_LAUNCH_REGS = 168
QMM_FORMATS = {"0": "int8", "1": "e4m3", "2": "fp6"}
# K1's CUDA-core kernels before the tensor-core redesign (PERF.md section 6:
# PR 2's and PR 4's runs on an H100 80GB HBM3 at 700 W), printed beside this
# run's times in the timings line; never compared or gated
K1_EARLIER_MS = {"flash_fwd": 0.19663, "flash_fwd_train": 28.774, "flash_bwd_dq": 32.868,
                 "flash_bwd_dkv": 47.843, "flash_bwd_pair": 80.978}
# K7's CUDA-core kernels before the tensor-core redesign (PERF.md section 6,
# on an H100 80GB HBM3 at 700 W), at the sparse flagship's per-call shape;
# printed in the timings line beside K1's, never compared or gated
K7_EARLIER_MS = {"sparse_fwd": 9.4238, "sparse_bwd_dq": 11.122, "sparse_bwd_dkv": 14.974,
                 "sparse_bwd_pair": 26.469}


def fail(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(1)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


class GpuBusy:
    """``nvidia-smi``'s utilization.gpu (the share of each sample period in
    which a kernel ran, any context), sampled every 100 ms while the block
    runs: ``.mean`` over the samples (None off the card)."""

    def __enter__(self):
        self.proc, self.mean = None, None
        if DEVICE == "cuda":
            self.proc = subprocess.Popen(
                ["nvidia-smi", "--query-gpu=utilization.gpu", "--format=csv,noheader,nounits",
                 "-lms", "100"], stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        return self

    def __exit__(self, *exc):
        if self.proc is not None:
            self.proc.terminate()
            out, _ = self.proc.communicate(timeout=10)
            vals = [float(v) for v in out.split() if v.replace(".", "", 1).isdigit()]
            self.mean = sum(vals) / len(vals) / 100.0 if vals else None
        return False


# (phase, perf_counter when it emitted): the smoke's timeline, read by main
PHASE_ENDS = []


def emit(obj) -> None:
    if isinstance(obj, dict) and "phase" in obj:
        PHASE_ENDS.append((obj["phase"], time.perf_counter()))
    print(json.dumps(obj), flush=True)


# ---------------------------------------------------------------------------
# inputs of the kernel checks (seeded, built on the card)
# ---------------------------------------------------------------------------
def _randn(torch, shape, gen, dtype):
    return torch.randn(shape, generator=gen, device=DEVICE, dtype=torch.float32).to(dtype)


def flash_case(torch, gen, seg_lens, pad, hq=8, hkv=2, hd=128, cap=None):
    """One packed prefill: contiguous segments of ``seg_lens`` tokens, then
    ``pad`` rows of segment 0."""
    t = sum(seg_lens) + pad
    seg = torch.zeros(t, dtype=torch.int32)
    cur = 0
    for i, n in enumerate(seg_lens):
        seg[cur:cur + n] = i + 1
        cur += n
    q = _randn(torch, (1, t, hq, hd), gen, torch.bfloat16)
    k = _randn(torch, (1, t, hkv, hd), gen, torch.bfloat16)
    v = _randn(torch, (1, t, hkv, hd), gen, torch.bfloat16)
    return dict(q=q, k=k, v=v, segment_ids=seg[None].to(DEVICE), cap=cap)


def _pages(torch, gcpu, nb, stripes=1):
    """``take(n)``: the pages of a fresh chain of ``n``, handed out as the
    striped allocator does (chain position i from stripe i % ``stripes`` of
    the pool's contiguous stripes), drawn at random from each stripe; one
    stripe: consecutive entries of one permutation of the pool."""
    nbl = nb // stripes
    perms = [(s * nbl + torch.randperm(nbl, generator=gcpu)).tolist() for s in range(stripes)]

    def take(n):
        return torch.tensor([perms[i % stripes].pop(0) for i in range(n)], dtype=torch.int32)

    return take


def decode_case(torch, gen, B=64, nb=2048, bs=32, P=128, hq=8, hkv=2, hd=128,
                inactive=8, max_len=1200, min_len=1, stripes=1, first_len=None,
                bad_ids=False):
    """Mixed lengths in [min_len, max_len), -1 table tails, ``inactive``
    slots with len 1 and an all -1 row (how the engine presents an idle
    slot); each slot's pages striped over ``stripes`` seq shards.
    ``first_len``: slot 0's length instead (a long context); ``bad_ids``: a
    -1 and an out-of-range id inside the lengths of slots 0 and 1 (K2 clamps
    both to the pool, its partial mode skips them)."""
    ck = _randn(torch, (nb, bs, hkv, hd), gen, torch.bfloat16)
    cv = _randn(torch, (nb, bs, hkv, hd), gen, torch.bfloat16)
    q = _randn(torch, (B, hq, hd), gen, torch.bfloat16)
    lens = torch.randint(min_len, max_len, (B,), generator=torch.Generator().manual_seed(SEED),
                         dtype=torch.int32)
    if first_len is not None:
        lens[0] = first_len
    take = _pages(torch, torch.Generator().manual_seed(SEED + 1), nb, stripes)
    table = torch.full((B, P), -1, dtype=torch.int32)
    for b in range(B):
        if b >= B - inactive:
            lens[b] = 1
            continue
        n = -(-int(lens[b]) // bs)
        table[b, :n] = take(n)
        if bad_ids and b < 2 and n > 1:
            table[b, 1] = -1 if b == 0 else nb + 3
    return dict(q=q, cache_k=ck, cache_v=cv, block_table=table.to(DEVICE),
                seq_lens=lens.to(DEVICE))


def ctx_case(torch, gen, sfx=(48, 64, 17, 64), ctx=(512, 500, 37, 512), N=8,
             nb=192, bs=32, P=22, hq=8, hkv=2, hd=128, bad_ids=True, stripes=1):
    """A prefix-hit / chunked-prefill pack: segments page-aligned in the pack
    (pad rows between them), context lengths including mid-page ones, table
    tails -1, and (``bad_ids``) an out-of-range id past a context's end;
    each context's pages striped over ``stripes`` seq shards."""
    gcpu = torch.Generator().manual_seed(SEED + 2)
    segs, cur = [], 0
    for n in sfx:
        segs.append((cur, n))
        cur += -(-n // bs) * bs
    t = cur
    seg = torch.zeros(t, dtype=torch.int32)
    rows = torch.randperm(N, generator=gcpu)[:len(sfx)]
    tables = torch.full((N, P), -1, dtype=torch.int32)
    lens = torch.zeros(N, dtype=torch.int32)
    take = _pages(torch, gcpu, nb, stripes)
    for (start, n), r, c in zip(segs, rows.tolist(), ctx):
        seg[start:start + n] = r + 1
        pages = -(-c // bs)
        tables[r, :pages] = take(pages)
        lens[r] = c
        if bad_ids and pages < P:
            tables[r, pages] = nb + 5  # never read: past ctx_len and out of range
    q = _randn(torch, (t, hq, hd), gen, torch.bfloat16)
    k = _randn(torch, (t, hkv, hd), gen, torch.bfloat16)
    v = _randn(torch, (t, hkv, hd), gen, torch.bfloat16)
    ck = _randn(torch, (nb, bs, hkv, hd), gen, torch.bfloat16)
    cv = _randn(torch, (nb, bs, hkv, hd), gen, torch.bfloat16)
    return dict(q=q, k=k, v=v, segment_ids=seg.to(DEVICE), cache_k=ck, cache_v=cv,
                ctx_tables=tables.to(DEVICE), ctx_lens=lens.to(DEVICE))


# gpt2_small's decode shape: 64 slots, hq = hkv = 12 (MHA), hd 64, pages of
# 32, 32 table columns, live lengths 129-256 (a 128-token prompt and up to
# 128 generated tokens)
GPT2_DECODE = dict(B=64, nb=2048, bs=32, P=32, hq=12, hkv=12, hd=64, inactive=0,
                   min_len=129, max_len=257)
# a verify tick's pack: 8 slots x (k + 1 = 5) rows, committed lengths that
# end mid-page, one slot with 0 drafts (1 row) and pad rows after each
VERIFY_CTX = (37, 100, 255, 511, 64, 300, 1, 200)
VERIFY_DRAFTS = (4, 4, 0, 3, 4, 2, 4, 1)


def verify_case(torch, gen, hq, hkv, hd, ctx=VERIFY_CTX, drafts=VERIFY_DRAFTS, K=4,
                nb=256, bs=32, stripes=1):
    """The packed-context kernel's input on a verify tick
    (``engine_v2._spec_tick``): slot i's rows i (K + 1) .. i (K + 1) +
    drafts[i], segment i + 1, the rest pad; its table covers the context
    and the pack's own pages (already written: ``ctx_lens`` masks them),
    striped over ``stripes`` seq shards."""
    gcpu = torch.Generator().manual_seed(SEED + 5)
    N, K1 = len(ctx), K + 1
    P = -(-(max(ctx) + K1) // bs)
    seg = torch.zeros(N * K1, dtype=torch.int32)
    tables = torch.full((N, P), -1, dtype=torch.int32)
    take = _pages(torch, gcpu, nb, stripes)
    for i, (c, n) in enumerate(zip(ctx, drafts)):
        seg[i * K1:i * K1 + n + 1] = i + 1
        pages = -(-(c + n + 1) // bs)
        tables[i, :pages] = take(pages)
    t = N * K1
    return dict(q=_randn(torch, (t, hq, hd), gen, torch.bfloat16),
                k=_randn(torch, (t, hkv, hd), gen, torch.bfloat16),
                v=_randn(torch, (t, hkv, hd), gen, torch.bfloat16),
                segment_ids=seg.to(DEVICE),
                cache_k=_randn(torch, (nb, bs, hkv, hd), gen, torch.bfloat16),
                cache_v=_randn(torch, (nb, bs, hkv, hd), gen, torch.bfloat16),
                ctx_tables=tables.to(DEVICE),
                ctx_lens=torch.tensor(ctx, dtype=torch.int32, device=DEVICE))


# K2 on the card, (label, decode_case arguments, soft cap): head dims 64 /
# 128 / 256, query groups 1, 4, 16 and 71 (falcon_7b's 71 heads on one kv
# head), blocks of 8, 16 and 32, idle slots, a slot of 4,096 keys (many split
# shares long), -1 and out-of-range ids inside a length, soft caps
DECODE_CASES = (
    ("B64_mixed", {}, None),
    ("B64_mixed_cap5", dict(max_len=300), 5.0),
    ("gpt2_B64_hq12_hkv12_hd64_len129-256", GPT2_DECODE, None),
    ("B64_hq8_hkv2_hd64_mixed", dict(hq=8, hkv=2, hd=64, max_len=600), None),
    ("B16_hq8_hkv8_hd128_bs8_badids", dict(B=16, nb=2560, bs=8, P=160, hq=8, hkv=8, inactive=2,
                                           bad_ids=True), None),
    ("B16_hq16_hkv16_hd256_bs16_len4096", dict(B=16, nb=2048, bs=16, P=256, hq=16, hkv=16,
                                               hd=256, inactive=2, first_len=4096), None),
    ("B16_hq8_hkv2_hd256_bs8_cap5", dict(B=16, nb=2560, bs=8, P=160, hq=8, hkv=2, hd=256,
                                         inactive=2), 5.0),
    ("B16_hq16_hkv1_hd128_len4096", dict(B=16, nb=1024, hq=16, hkv=1, inactive=2,
                                         first_len=4096), None),
    ("B16_hq71_hkv1_hd64_bs16_badids", dict(B=16, nb=2048, bs=16, P=80, hq=71, hkv=1, hd=64,
                                            inactive=2, bad_ids=True), None),
    ("B8_hq71_hkv1_hd128_cap5", dict(B=8, nb=512, hq=71, hkv=1, inactive=1), 5.0),
    ("B16_hq28_hkv4_hd128_qwen2", dict(B=16, nb=1024, hq=28, hkv=4, inactive=2), None),
)
# K3 on the card, (label, case kind, its arguments, soft cap): the scheduler's
# and verify ticks' packs, contexts ending mid-page, pad rows between
# segments, out-of-range ids past a context, the same head dims, groups and
# blocks as K2, and a context of 4,096 keys
CTX_CASES = (
    ("T256_N8_ctx512", "ctx", dict(sfx=(64, 64, 64, 64), ctx=(512, 512, 512, 512)), None),
    ("midpage_pad_badids", "ctx", {}, None),
    ("verify_N8x5_hq12_hkv12_hd64_midpage", "verify", dict(hq=12, hkv=12, hd=64), None),
    ("verify_N8x5_hq8_hkv2_hd128_midpage", "verify", dict(hq=8, hkv=2, hd=128), None),
    ("verify_N8x5_hq16_hkv16_hd256_bs16", "verify", dict(hq=16, hkv=16, hd=256, bs=16), None),
    ("verify_N8x5_hq71_hkv1_hd64_cap5", "verify", dict(hq=71, hkv=1, hd=64), 5.0),
    ("midpage_hq8_hkv2_hd256_bs16_cap5", "ctx", dict(hd=256, bs=16, P=40, nb=256), 5.0),
    ("midpage_hq16_hkv1_hd128_bs8", "ctx", dict(hq=16, hkv=1, bs=8, P=80, nb=512), None),
    ("midpage_hq71_hkv1_hd64_bs16", "ctx", dict(hq=71, hkv=1, hd=64, bs=16, P=40, nb=256), None),
    ("ctx4096_hq8_hkv2_hd128", "ctx", dict(sfx=(64, 17), ctx=(4096, 300), P=130, nb=512), None),
    ("verify_N8x5_hq28_hkv4_hd128_qwen2", "verify", dict(hq=28, hkv=4, hd=128), None),
    ("midpage_hq28_hkv4_hd128_bs16_cap5", "ctx", dict(hq=28, hkv=4, bs=16, P=40, nb=256), 5.0),
)
# the partial modes on striped pools, (label, case kind, arguments, shards)
CTX_PARTIAL_CASES = (
    ("sched_T256_N8_4x(512ctx+64sfx)", "ctx", dict(sfx=(64, 64, 64, 64),
                                                   ctx=(512, 512, 512, 512)), 2),
    ("sched_T256_N8_4x(512ctx+64sfx)", "ctx", dict(sfx=(64, 64, 64, 64),
                                                   ctx=(512, 512, 512, 512)), 4),
    ("verify_N8x5_hq12_hkv12_hd64_midpage", "verify", dict(hq=12, hkv=12, hd=64), 2),
    ("verify_N8x5_hq8_hkv2_hd128_midpage", "verify", dict(hq=8, hkv=2, hd=128), 2),
    ("verify_N8x5_hq71_hkv1_hd64", "verify", dict(hq=71, hkv=1, hd=64), 4),
    ("midpage_hq8_hkv2_hd256_bs16", "ctx", dict(hd=256, bs=16, P=40, nb=256), 2),
    ("midpage_hq16_hkv1_hd128_bs8", "ctx", dict(hq=16, hkv=1, bs=8, P=80, nb=512), 4),
)
DECODE_PARTIAL_CASES = (
    ("engine_B64_P128_bs32", {}, 2),
    ("engine_B64_P128_bs32", {}, 4),
    ("gpt2_B64_hq12_hkv12_hd64", GPT2_DECODE, 2),
    ("B16_hq16_hkv16_hd256_bs16", dict(B=16, nb=2048, bs=16, P=80, hq=16, hkv=16, hd=256,
                                       inactive=2), 2),
    ("B16_hq71_hkv1_hd64_bs8", dict(B=16, nb=2560, bs=8, P=160, hq=71, hkv=1, hd=64,
                                    inactive=2), 4),
    ("B16_hq16_hkv1_hd128_len4096", dict(B=16, nb=1024, hq=16, hkv=1, inactive=2,
                                         first_len=4096), 2),
)


def paged_case(torch, gen, kind, kw, stripes=1):
    """A K3 input from ``ctx_case`` or ``verify_case``."""
    if kind == "verify":
        kw = dict(kw)
        return verify_case(torch, gen, kw.pop("hq"), kw.pop("hkv"), kw.pop("hd"),
                           stripes=stripes, **kw)
    return ctx_case(torch, gen, stripes=stripes, **kw)


def _packed_ids(torch, b, s, lens):
    """[b, s] int32 segment ids on the card: each batch row packs segments of
    these lengths as ids 1, 2, ...; the rest pads as segment 0."""
    seg = torch.zeros(b, s, dtype=torch.int32)
    cur = 0
    for i, n in enumerate(lens):
        seg[:, cur:cur + n] = i + 1
        cur += n
    return seg.to(DEVICE)


def bwd_case(torch, gen, b, s, hq, hkv, hd, seg_lens=None, cap=None, kseg_lens=None):
    """q / k / v / dO for the training backward; ``seg_lens``: each batch
    row packs segments of these lengths (the rest pads as segment 0);
    ``kseg_lens``: the keys' ids pack other lengths (JAX's
    ``kv_segment_ids``; the block-sparse kernels take them apart), else the
    keys carry the rows' ids."""
    seg = None if seg_lens is None else _packed_ids(torch, b, s, seg_lens)
    kseg = seg if kseg_lens is None else _packed_ids(torch, b, s, kseg_lens)
    return dict(q=_randn(torch, (b, s, hq, hd), gen, torch.bfloat16),
                k=_randn(torch, (b, s, hkv, hd), gen, torch.bfloat16),
                v=_randn(torch, (b, s, hkv, hd), gen, torch.bfloat16),
                do=_randn(torch, (b, s, hq, hd), gen, torch.bfloat16), seg=seg, kseg=kseg,
                cap=cap)


def rel_errs(torch, got, ref, rows=BWD_BLOCK):
    """(whole-tensor, worst-block) relative Frobenius errors of ``got``
    against ``ref``, both [b, s, h, d]; a block is ``rows`` sequence rows of
    one head of one batch row (the last block of a ragged s is shorter)."""
    e, r = got.float() - ref.float(), ref.float()
    whole = float(e.norm() / r.norm())
    b, s, h, d = r.shape
    pad = -s % rows

    def block_norms(x):
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        return x.reshape(b, (s + pad) // rows, rows, h, d).pow(2).sum((2, 4)).sqrt()

    worst = float((block_norms(e) / block_norms(r).clamp_min(1e-30)).max())
    return whole, worst


def _f32(case):
    return {k: (v.float() if hasattr(v, "dtype") and v.dtype.is_floating_point else v)
            for k, v in case.items()}


def _sass_op(line):
    """The opcode of one ``cuobjdump -sass`` instruction line with its
    modifiers (``LDG.E.128.CONSTANT``; no predicate), or None."""
    if "*/" not in line:
        return None
    words = line.split("*/", 1)[1].split()
    if words and words[0].startswith("@"):
        words = words[1:]
    return words[0].rstrip(";") if words else None


# {source: its library's ``cuobjdump -sass`` text}, for the sass phase
SASS_DUMPS = {}


def build_and_dump(K, out):
    """``K.build()``, then the ``cuobjdump -sass`` of every library the sass
    phase reads into SASS_DUMPS, one process each, all started together.
    Fills ``out["build"]``, or ``out["error"]`` with what it raised."""
    from concurrent.futures import ThreadPoolExecutor

    cuobjdump = os.path.join(os.path.dirname(K._nvcc()), "cuobjdump")
    srcs = (*FLASH_SOURCES, *PAGED_SOURCES, QMM_SOURCE, ROWQ_SOURCE)

    def dump(src):
        return subprocess.run([cuobjdump, "-sass", K._lib_path(src)], capture_output=True,
                              text=True, check=True).stdout

    try:
        out["build"] = K.build()
        with ThreadPoolExecutor(len(srcs)) as pool:
            SASS_DUMPS.update(zip(srcs, pool.map(dump, srcs)))
    except BaseException as exc:  # re-raised by the main thread
        out["error"] = exc


def _sass_functions(src):
    """{mangled kernel name: [its opcodes with modifiers]} of ``src``'s
    library, from its ``cuobjdump -sass`` text in SASS_DUMPS."""
    out, name = {}, None
    for ln in SASS_DUMPS[src].splitlines():
        if "Function :" in ln:
            name = ln.split("Function :", 1)[1].strip()
            out[name] = []
        elif name is not None:
            op = _sass_op(ln)
            if op:
                out[name].append(op)
    return out


def _ptxas_regs(K, src):
    """{mangled kernel name: {registers, spill_stores, spill_loads}} from
    ptxas's report in ``src``'s build log."""
    regs, cur = {}, None
    for ln in K.build_log(src).splitlines():
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            cur = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and cur:
            regs.setdefault(cur, {}).update(spill_stores=int(m.group(1)),
                                            spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m and cur:
            regs.setdefault(cur, {})["registers"] = int(m.group(1))
    return regs


def _flash_kernel_key(mangled):
    """``flash_bwd_dq_kernel<hd 128, DenseWalk>`` from a mangled kernel name
    (its tile shape's first template argument is the head dim, its second
    the tile walk: DenseWalk for K1, TableWalk for K7)."""
    m = re.search(r"(flash_(?:fwd|bwd_dq|bwd_dkv)_kernel)I.*?Li(\d+)E.*?(DenseWalk|TableWalk)",
                  mangled)
    return f"{m.group(1)}<hd {m.group(2)}, {m.group(3)}>" if m else mangled


def _paged_kernel_key(mangled):
    """``decode_kernel<hd 128, nq 8, partial>`` or ``ctx_attn_kernel<hd 128,
    normal>`` from a mangled K2 / K3 kernel name (template arguments: the
    head dim, K2's query heads in the products, the partial switch)."""
    m = re.search(r"(decode_kernel)ILi(\d+)ELi(\d+)ELb([01])E", mangled)
    if m:
        return (f"{m.group(1)}<hd {m.group(2)}, nq {m.group(3)}, "
                f"{'partial' if m.group(4) == '1' else 'normal'}>")
    m = re.search(r"(ctx_attn_kernel)ILi(\d+)ELb([01])E", mangled)
    if m:
        return f"{m.group(1)}<hd {m.group(2)}, {'partial' if m.group(3) == '1' else 'normal'}>"
    return mangled


def _qmm_kernel_key(mangled):
    """``qmm_kernel<fp6, bt 256>`` from a mangled dequant-matmul kernel name
    (template arguments: the weight format, the token tile), or the
    unmangled name of the split-K reduce kernel."""
    m = re.search(r"(qmm_kernel)ILi(\d+)ELi(\d+)E", mangled)
    if m:
        return f"{m.group(1)}<{QMM_FORMATS[m.group(2)]}, bt {m.group(3)}>"
    m = re.search(r"(qmm_\w+?_kernel)", mangled)
    return m.group(1) if m else mangled


def sass_phase(K):
    """Phase 1b: per kernel of the tensor-core libraries (K1, K7, K2 / K3
    and the dequant-matmuls K4 / K5), the SASS counts of ``SASS_OPS`` and
    ptxas's registers and spills; raises when an attention kernel or a
    dequant-matmul product kernel holds no HGMMA (every product is a wgmma),
    a K2 / K3 kernel spills, a dequant-matmul kernel still holds HMMA (the
    mma.sync of its WMMA version), or a dequant-matmul kernel at token tile
    128 or 256 launches with other than ``QMM_LAUNCH_REGS`` registers a
    thread.  The split-K reduce kernel has no product."""
    out = {}
    for src in (*FLASH_SOURCES, *PAGED_SOURCES, QMM_SOURCE):
        counts = {name: {op: sum(o.split(".")[0] == op for o in ops) for op in SASS_OPS}
                  for name, ops in _sass_functions(src).items()}
        regs = _ptxas_regs(K, src)
        for mangled, c in counts.items():
            key = (_qmm_kernel_key(mangled) if src == QMM_SOURCE else
                   _paged_kernel_key(mangled) if src in PAGED_SOURCES else
                   _flash_kernel_key(mangled))
            out[key] = dict(source=src, **c, **regs.get(mangled, {}))
            if src in PAGED_SOURCES and (out[key].get("spill_stores", 0)
                                         or out[key].get("spill_loads", 0)):
                raise AssertionError(f"sass: {key} ({src}) spills: {out[key]}")
            product = src != QMM_SOURCE or key.startswith("qmm_kernel<")
            if product and c["HGMMA"] == 0:
                raise AssertionError(f"sass: {key} ({src}) holds no HGMMA: {c}")
            if src == QMM_SOURCE and c["HMMA"]:
                raise AssertionError(f"sass: {key} ({src}) still holds HMMA: {c}")
            one_cta = re.search(r"bt (128|256)>", key)
            if one_cta and out[key].get("registers") != QMM_LAUNCH_REGS:
                raise AssertionError(
                    f"sass: {key} launches with {out[key].get('registers')} registers a "
                    f"thread; its setmaxnreg hand-over is balanced at {QMM_LAUNCH_REGS}")
        if not counts:
            raise AssertionError(f"sass: no kernel found in {src}")
    return out


ROWQ_SOURCE = "quantize.cu"
ROWQ_TYPES = {"f": "fp32", "13__nv_bfloat16": "bf16", "6__half": "fp16"}
ROWQ_FORMATS = {"0": "int8", "1": "e4m3", "2": "e5m2"}


def _rowq_kernel_key(mangled):
    """``quantize_rows_kernel<bf16, e4m3, cpt 4>`` from a mangled row
    quantizer name (template arguments: input type, code format, chunks a
    thread), or the dequantizer's ``dequantize_rows_kernel<...>``."""
    m = re.search(r"(quantize_rows_kernel)I(f|13__nv_bfloat16|6__half)Li(\d)ELi(\d+)E",
                  mangled)
    if m:
        return (f"{m.group(1)}<{ROWQ_TYPES[m.group(2)]}, {ROWQ_FORMATS[m.group(3)]}, "
                f"cpt {m.group(4)}>")
    m = re.search(r"(dequantize_rows_kernel)ILi(\d)E(f|13__nv_bfloat16|6__half)", mangled)
    if m:
        return f"{m.group(1)}<{ROWQ_FORMATS[m.group(2)]}, {ROWQ_TYPES[m.group(3)]}>"
    return mangled


def rowq_sass(K):
    """The row quantizers' SASS (``quantize.cu``): per kernel the hardware
    fp8 pair conversions (F2FP), the float-to-int conversions (F2I), the
    16-byte loads and stores and all global loads and stores, the calls
    (the IEEE division's slow path is a subroutine) and the local-memory
    stores and loads (``STL`` / ``LDL``: ptxas's spills, which save
    registers around those calls), beside ptxas's registers and spills.
    Raises when a quantize kernel has no 16-byte load or store, or an fp8
    one no F2FP."""
    regs = _ptxas_regs(K, ROWQ_SOURCE)
    out = {}
    for mangled, ops in _sass_functions(ROWQ_SOURCE).items():
        base = [op.split(".")[0] for op in ops]
        c = {op: base.count(op) for op in ("F2FP", "F2I", "LDG", "STG", "CALL", "STL", "LDL")}
        c.update(LDG_128=sum(op.startswith("LDG") and ".128" in op for op in ops),
                 STG_128=sum(op.startswith("STG") and ".128" in op for op in ops))
        key = _rowq_kernel_key(mangled)
        out[key] = dict(source=ROWQ_SOURCE, **c, **regs.get(mangled, {}))
        if not key.startswith("quantize_rows_kernel<"):
            continue
        if not (c["LDG_128"] and c["STG_128"]):
            raise AssertionError(f"sass: {key} has no 16-byte load or store: {c}")
        if ("e4m3" in key or "e5m2" in key) and not c["F2FP"]:
            raise AssertionError(f"sass: {key} holds no F2FP (hardware fp8 pair conversion)")
    if not any(k.startswith("quantize_rows_kernel<") for k in out):
        raise AssertionError(f"sass: no quantize kernel found in {ROWQ_SOURCE}")
    return out


def kernel_checks(torch):
    """Phase 2.  Returns {kernel: max_abs_err} (worst case per kernel)."""
    from deepspeed_tpu_torch.ops.attention import dot_product_attention
    from deepspeed_tpu_torch.ops.kernels import ctx_attention as K3
    from deepspeed_tpu_torch.ops.kernels import flash_attention as K1
    from deepspeed_tpu_torch.ops.kernels import paged_attention as K2

    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    errs = {"flash_fwd": 0.0, "flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0,
            "paged_decode": 0.0, "paged_decode_hd64": 0.0, "ctx_attention": 0.0,
            "ctx_attention_partial": 0.0, "paged_decode_partial": 0.0,
            "sparse_fwd": 0.0,
            "sparse_bwd_dq": 0.0, "sparse_bwd_dkv": 0.0}
    results = []

    def record(name, label, got, ref, tol=KERNEL_TOL, relative=False, err=None):
        """Absolute: max |got - ref| <= tol (or ``err``, computed by the
        caller, <= tol).  ``relative``: the whole-tensor and the worst
        block's relative Frobenius error (``rel_errs``) <= tol."""
        torch.cuda.synchronize()
        if err is None:
            if not bool(torch.isfinite(got).all()):
                raise AssertionError(f"{name} {label}: non-finite output")
            err = float((got.float() - ref.float()).abs().max())
        errs[name] = max(errs[name], err)
        row = dict(kernel=name, case=label, max_abs_err=err, limit=tol)
        if relative:
            whole, worst = rel_errs(torch, got, ref)
            row.update(rel_err=whole, worst_block_rel_err=worst, limit_on="rel_err")
            bad = max(whole, worst) > tol
        else:
            bad = err > tol
        results.append(row)
        if bad:
            raise AssertionError(f"{name} {label}: {row} over the limit {tol}")

    for label, case in (
        ("T2048_16x128", flash_case(torch, gen, [128] * 16, 0)),
        ("T64_50+pad14", flash_case(torch, gen, [50], 14)),
        ("T256_cap2", flash_case(torch, gen, [100, 60], 96, cap=2.0)),
        ("T192_noseg", dict(flash_case(torch, gen, [192], 0), segment_ids=None)),
        ("T300_hd256", flash_case(torch, gen, [100, 200], 0, hd=256)),
        ("T200_hq71_hkv1_hd64", flash_case(torch, gen, [120, 80], 0, hq=71, hkv=1, hd=64)),
        ("T300_hq28_hkv4_hd128", flash_case(torch, gen, [100, 150], 50, hq=28, hkv=4)),
    ):
        got = K1.flash_attention_kernel(case["q"], case["k"], case["v"], case["segment_ids"],
                                        logits_soft_cap=case["cap"])
        f = _f32(case)
        ref = dot_product_attention(f["q"], f["k"], f["v"], causal=True,
                                    segment_ids=case["segment_ids"],
                                    logits_soft_cap=case["cap"])
        record("flash_fwd", label, got, ref)
        record("flash_fwd", label + "_rel", got, ref, tol=BWD_TOL, relative=True)

    for label, kw, cap in DECODE_CASES:
        case = decode_case(torch, gen, **kw)
        name = "paged_decode_hd64" if case["q"].shape[-1] == 64 else "paged_decode"
        got = K2.paged_attention_decode_kernel(**case, logits_soft_cap=cap)
        ref = K2.paged_attention_decode_plain(**_f32(case), logits_soft_cap=cap)
        record(name, label, got, ref)
        del case, got, ref
    for label, kind, kw, cap in CTX_CASES:
        case = paged_case(torch, gen, kind, kw)
        got = K3.paged_attention_packed_ctx_kernel(**case, logits_soft_cap=cap)
        ref = K3.paged_attention_packed_ctx_plain(**_f32(case), logits_soft_cap=cap)
        pad = case["segment_ids"] == 0
        if bool(pad.any()) and bool(got[pad].ne(0).any()):
            raise AssertionError(f"ctx_attention {label}: pad rows not exactly 0")
        record("ctx_attention", label, got, ref)
        del case, got, ref
    _free(torch)
    partial_kernel_checks(torch, gen, record)

    # the training backward: K1f's o and lse against the plain forward, then
    # the dq and dk/dv kernels against the plain FA2 formulas on the same
    # bf16 inputs (and the kernel's own o and lse), in fp32
    for label, case in (
        ("b1_s4096_hq8_hkv2_hd128", bwd_case(torch, gen, 1, 4096, 8, 2, 128)),
        ("b2_s1024_packed_cap2", bwd_case(torch, gen, 2, 1024, 8, 2, 128,
                                          seg_lens=[300, 500, 100, 124], cap=2.0)),
        ("b2_s200_hq8_hkv2_hd128", bwd_case(torch, gen, 2, 200, 8, 2, 128)),
        ("b1_s512_hq4_hkv4_hd64", bwd_case(torch, gen, 1, 512, 4, 4, 64)),
        ("b1_s4097_hq8_hkv2_hd128", bwd_case(torch, gen, 1, 4097, 8, 2, 128)),
        ("b1_s512_hq4_hkv2_hd256", bwd_case(torch, gen, 1, 512, 4, 2, 256)),
        ("b1_s256_hq71_hkv1_hd64", bwd_case(torch, gen, 1, 256, 71, 1, 64)),
        ("b2_s640_hq4_hkv1_hd256_packed_cap5", bwd_case(torch, gen, 2, 640, 4, 1, 256,
                                                        seg_lens=[200, 300, 100], cap=5.0)),
        ("b1_s512_hq28_hkv4_hd128", bwd_case(torch, gen, 1, 512, 28, 4, 128)),
        ("b2_s300_hq28_hkv4_hd128_packed", bwd_case(torch, gen, 2, 300, 28, 4, 128,
                                                    seg_lens=[120, 100, 60])),
    ):
        q, k, v, do, seg, cap = (case[n] for n in ("q", "k", "v", "do", "seg", "cap"))
        sc = q.shape[-1] ** -0.5
        o, lse = K1.flash_attention_kernel(q, k, v, seg, sc, cap, return_lse=True)
        dq, dk, dv = K1.flash_attention_bwd_kernel(q, k, v, seg, o, lse, do, sc, cap)
        f = [x.float() for x in (q, k, v, o, do)]
        o_ref, lse_ref = K1.flash_attention_fwd_plain(f[0], f[1], f[2], seg, sc, cap)
        dq_r, dk_r, dv_r = K1.flash_attention_bwd_plain(f[0], f[1], f[2], seg, f[3], lse,
                                                         f[4], sc, cap)
        record("flash_fwd", label, o, o_ref)
        record("flash_fwd", label + "_rel", o, o_ref, tol=BWD_TOL, relative=True)
        record("flash_fwd", label + "_lse", lse, lse_ref, tol=LSE_TOL)
        record("flash_bwd_dq", label, dq, dq_r, tol=BWD_TOL, relative=True)
        record("flash_bwd_dkv", label + "_dk", dk, dk_r, tol=BWD_TOL, relative=True)
        record("flash_bwd_dkv", label + "_dv", dv, dv_r, tol=BWD_TOL, relative=True)
        del case, q, k, v, do, o, lse, dq, dk, dv, f, o_ref, lse_ref, dq_r, dk_r, dv_r
    _free(torch)
    padded_kernel_checks(torch, gen, record)
    sparse_kernel_checks(torch, record)
    errs["fused_adamw"], adam_cases_ = adam_kernel_checks(torch)
    return errs, results + adam_cases_


# the flash entry's padded head dims (phi_2: 80, gpt_neox_20b: 96), each
# (label, bwd_case arguments): the kernels run at 128 on zero-padded q / k / v
PADDED_CASES = (
    ("b1_s512_hq32_hkv32_hd80_phi2", dict(b=1, s=512, hq=32, hkv=32, hd=80)),
    ("b2_s300_hq8_hkv2_hd80_packed_cap5", dict(b=2, s=300, hq=8, hkv=2, hd=80,
                                                seg_lens=[120, 100, 60], cap=5.0)),
    ("b1_s512_hq16_hkv16_hd96_neox", dict(b=1, s=512, hq=16, hkv=16, hd=96)),
    ("b1_s4097_hq8_hkv8_hd96", dict(b=1, s=4097, hq=8, hkv=8, hd=96)),
)


def padded_kernel_checks(torch, gen, record):
    """K1f / K1b at head dims 80 and 96 through the ``flash_attention`` entry
    (autograd through the zero pad and the slice): o, dq, dk, dv against the
    plain versions at the real head dim in fp32 (KERNEL_TOL on o, BWD_TOL
    relative per block on all four); each case launches K1f once and each
    backward kernel once."""
    from deepspeed_tpu_torch.ops import kernels as K
    from deepspeed_tpu_torch.ops.kernels import flash_attention as K1

    for label, kw in PADDED_CASES:
        c = bwd_case(torch, gen, **kw)
        q, k, v = (c[n].requires_grad_(True) for n in ("q", "k", "v"))
        before = dict(K.LAUNCHES)
        o = K1.flash_attention(q, k, v, segment_ids=c["seg"], logits_soft_cap=c["cap"])
        dq, dk, dv = torch.autograd.grad(o, (q, k, v), c["do"])
        ran = {n: K.LAUNCHES[n] - before[n] for n in ("flash_fwd", "flash_bwd_dq",
                                                      "flash_bwd_dkv")}
        if ran != {"flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}:
            raise AssertionError(f"padded {label}: launches {ran}")
        f = [x.detach().float() for x in (q, k, v)]
        sc = kw["hd"] ** -0.5
        o_ref, lse = K1.flash_attention_fwd_plain(*f, c["seg"], sc, c["cap"])
        refs = K1.flash_attention_bwd_plain(*f, c["seg"], o_ref, lse, c["do"].float(), sc,
                                            c["cap"])
        o = o.detach()
        record("flash_fwd", label, o, o_ref)
        record("flash_fwd", label + "_rel", o, o_ref, tol=BWD_TOL, relative=True)
        for name, suffix, got, ref in (("flash_bwd_dq", "", dq, refs[0]),
                                       ("flash_bwd_dkv", "_dk", dk, refs[1]),
                                       ("flash_bwd_dkv", "_dv", dv, refs[2])):
            record(name, label + suffix, got, ref, tol=BWD_TOL, relative=True)
        del c, q, k, v, o, dq, dk, dv, f, o_ref, lse, refs
    _free(torch)


def shard_view(torch, case, s, stripes, table_key):
    """Seq shard ``s``'s inputs of a striped case: its slice of the pools
    (a view) and its translated table (``paged.seq_shard_tables``)."""
    from deepspeed_tpu_torch.inference.paged import seq_shard_tables

    nb = case["cache_k"].shape[0]
    nbl = nb // stripes
    out = dict(case)
    out["cache_k"] = case["cache_k"][s * nbl:(s + 1) * nbl]
    out["cache_v"] = case["cache_v"][s * nbl:(s + 1) * nbl]
    out[table_key] = seq_shard_tables(case[table_key], nb, stripes)[s]
    return out


def partial_errs(torch, got, ref, label):
    """The error of a partial triple against its plain version, in output
    units: max |acc - acc_ref| / max(l_ref, 1) (the unnormalized acc scales
    with l), |m - m_ref| and |l - l_ref| / max(l_ref, 1).  Rows whose
    reference has no key here (l_ref = 0: pad rows, another shard's slot)
    must come back exactly (0, -1e30, 0)."""
    acc, m, l = got
    acc_r, m_r, l_r = ref
    torch.cuda.synchronize()
    if not all(bool(torch.isfinite(x).all()) for x in got):
        raise AssertionError(f"{label}: non-finite partial")
    scale = l_r.clamp_min(1.0)
    err = max(float(((acc - acc_r).abs() / scale[..., None]).max()),
              float((m - m_r).abs().max()), float(((l - l_r).abs() / scale).max()))
    empty = l_r == 0
    if bool(empty.any()) and not (bool(acc[empty].eq(0).all()) and bool(l[empty].eq(0).all())
                                  and bool(m[empty].eq(-1e30).all())):
        raise AssertionError(f"{label}: a row with no key here is not exactly (0, -1e30, 0)")
    return err, int(empty.sum())


def partial_kernel_checks(torch, gen, record):
    """The partial modes (seq-sharded serving) against their plain versions
    on each shard's view of a striped pool, with ``include_pack`` on and off
    for K3; the S partials merged (``paged.merge_partials``) against the
    non-partial kernel on the whole pool.  Rows with no key on a shard (pad
    rows, idle slots, slots whose pages all lie elsewhere) must be exactly
    (0, -1e30, 0)."""
    from deepspeed_tpu_torch.inference.paged import merge_partials
    from deepspeed_tpu_torch.ops.kernels import ctx_attention as K3
    from deepspeed_tpu_torch.ops.kernels import paged_attention as K2

    def check_triple(name, label, got, ref):
        err, empty = partial_errs(torch, got, ref, f"{name} {label}")
        record(name, f"{label} (empty rows {empty})", None, None, err=err)

    for label, kind, kw, S in CTX_PARTIAL_CASES:
        case = paged_case(torch, gen, kind, kw, stripes=S)
        parts = []
        for s in range(S):
            sh = shard_view(torch, case, s, S, "ctx_tables")
            for inc in (True, False):
                got = K3.paged_attention_packed_ctx_partial_kernel(**sh, include_pack=inc)
                ref = K3.paged_attention_packed_ctx_partial_plain(**_f32(sh), include_pack=inc)
                check_triple("ctx_attention_partial",
                             f"{label}_S{S}_shard{s}_pack{int(inc)}", got, ref)
                if inc == (s == 0):
                    parts.append(got)
        merged = merge_partials(parts, torch.bfloat16)
        full = K3.paged_attention_packed_ctx_kernel(**case)
        if bool(merged[case["segment_ids"] == 0].ne(0).any()):
            raise AssertionError(f"ctx_attention_partial {label}: merged pad rows not 0")
        record("ctx_attention_partial", f"{label}_S{S}_merged_vs_ctx_attention", merged, full)
        del case, parts, merged, full
    for label, kw, S in DECODE_PARTIAL_CASES:
        case = decode_case(torch, gen, stripes=S, **kw)
        parts = []
        for s in range(S):
            sh = shard_view(torch, case, s, S, "block_table")
            got = K2.paged_attention_decode_partial_kernel(**sh)
            ref = K2.paged_attention_decode_partial_plain(**_f32(sh))
            check_triple("paged_decode_partial", f"{label}_S{S}_shard{s}", got, ref)
            parts.append(got)
        merged = merge_partials(parts, torch.bfloat16)
        full = K2.paged_attention_decode_kernel(**case)
        live = case["block_table"][:, 0] >= 0  # K2 clamps an idle slot's -1 to page 0
        if bool(merged[~live].ne(0).any()):
            raise AssertionError(f"paged_decode_partial {label}: merged idle slots not 0")
        record("paged_decode_partial", f"{label}_S{S}_merged_vs_paged_decode", merged[live],
               full[live])
        del case, parts, merged, full
    _free(torch)


def sparse_layout(spec, s):
    """(layout [s / block, s / block] bool, block) of a ``sparse_attention``
    config section at sequence length ``s``."""
    from deepspeed_tpu_torch.config.config import SparseAttentionConfig

    cfg = SparseAttentionConfig(**spec).build()
    return cfg.make_layout(s), cfg.block


def sparse_results(torch, case, layout, block):
    """K7f (o, lse) and K7b (dq, dk, dv) on a ``bwd_case`` against the plain
    versions in fp32 on the same bf16 inputs (the backward's on the
    kernel's own o and lse): a list of (kernel, suffix, got, ref, tol,
    relative).  With segment ids, every query row must see at least one key
    under the layout, the causal mask and the ids (else its lse is -inf and
    the case holds nothing)."""
    from deepspeed_tpu_torch.ops.kernels import sparse_attention as K7

    q, k, v, do, seg, kseg, cap = (case[n] for n in ("q", "k", "v", "do", "seg", "kseg", "cap"))
    if seg is not None:
        s = q.shape[1]
        allowed = (K7.element_mask(layout, block) & torch.ones(s, s, dtype=torch.bool).tril())
        seen = (allowed.to(DEVICE) & (seg[:, :, None] == kseg[:, None, :])).any(-1)
        if not bool(seen.all()):
            raise AssertionError(f"sparse case: {int((~seen).sum())} query rows see no key")
    sc = q.shape[-1] ** -0.5
    plan = K7.sparse_plan(layout, block, True, q.device)
    o, lse = K7.sparse_attention_kernel(q, k, v, seg, kseg, plan, sc, cap)
    dq, dk, dv = K7.sparse_attention_bwd_kernel(q, k, v, seg, kseg, o, lse, do, plan, sc, cap)
    f = [x.float() for x in (q, k, v, o, do)]
    o_ref, lse_ref = K7.sparse_attention_fwd_plain(f[0], f[1], f[2], seg, kseg, plan.tbl,
                                                   plan.cnt, block, sc, cap)
    refs = K7.sparse_attention_bwd_plain(f[0], f[1], f[2], seg, kseg, f[3], lse, f[4],
                                         plan.tbl, plan.cnt, block, sc, cap)
    return [("sparse_fwd", "", o, o_ref, KERNEL_TOL, False),
            ("sparse_fwd", "_rel", o, o_ref, BWD_TOL, True),
            ("sparse_fwd", "_lse", lse, lse_ref, LSE_TOL, False),
            ("sparse_bwd_dq", "", dq, refs[0], BWD_TOL, True),
            ("sparse_bwd_dkv", "_dk", dk, refs[1], BWD_TOL, True),
            ("sparse_bwd_dkv", "_dv", dv, refs[2], BWD_TOL, True)]


# the K7 cases of the kernels phase: (label, ``bwd_case`` arguments, layout)
SPARSE_CASES = (
    ("b2_s4096_hd128_fixed128_4_1", dict(b=2, s=4096, hq=8, hkv=2, hd=128), SPARSE_FLAGSHIP),
    ("b2_s4096_hd128_bigbird128", dict(b=2, s=4096, hq=8, hkv=2, hd=128),
     {"mode": "bigbird", "block": 128}),
    ("b2_s1024_hd64_packed_cap30_fixed128_2_1",
     dict(b=2, s=1024, hq=8, hkv=2, hd=64, seg_lens=[300, 400, 200, 100], cap=30.0),
     SPARSE_CHECK),
    ("b1_s2048_hd128_bslongformer256", dict(b=1, s=2048, hq=8, hkv=2, hd=128),
     {"mode": "bsLongformer", "block": 256, "num_sliding_window_blocks": 3,
      "global_block_indices": [0, 5]}),
    ("b2_s1024_hd256_fixed128_4_1", dict(b=2, s=1024, hq=8, hkv=2, hd=256), SPARSE_FLAGSHIP),
    ("b1_s1024_hq71_hkv1_hd64_fixed128_4_1", dict(b=1, s=1024, hq=71, hkv=1, hd=64),
     SPARSE_FLAGSHIP),
    ("b1_s4096_hd128_fixed512_2_1", dict(b=1, s=4096, hq=8, hkv=2, hd=128), SPARSE_BLOCK512),
    # the keys' ids pack other lengths than the rows': keys 200-299 carry the
    # second segment's id, so a skip that read the rows' ids for the keys
    # would drop their tile
    ("b2_s1024_hd128_packed_kseg_apart_cap5_fixed128_2_1",
     dict(b=2, s=1024, hq=8, hkv=2, hd=128, seg_lens=SPARSE_QSEG_LENS, cap=5.0,
          kseg_lens=SPARSE_KSEG_LENS), SPARSE_CHECK),
)


def sparse_kernel_checks(torch, record):
    """K7f / K7b on ``SPARSE_CASES``, each through ``record``."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 3)
    for label, kw, spec in SPARSE_CASES:
        case = bwd_case(torch, gen, **kw)
        layout, block = sparse_layout(spec, kw["s"])
        for name, suffix, got, ref, tol, rel in sparse_results(torch, case, layout, block):
            record(name, label + suffix, got, ref, tol=tol, relative=rel)
        del case
        _free(torch)


def adam_cases(torch, gen, n):
    """(label, step, wd, p, g, m, v) inputs of K8: fresh moments at step 1,
    moments of a long run at step 1000."""
    for step in (1, 1000):
        p = torch.randn(n, generator=gen, device=DEVICE)
        g = torch.randn(n, generator=gen, device=DEVICE) * 1e-2
        if step == 1:
            m, v = torch.zeros_like(p), torch.zeros_like(p)
        else:
            m = torch.randn(n, generator=gen, device=DEVICE) * 1e-3
            v = (torch.randn(n, generator=gen, device=DEVICE) * 1e-2).square()
        for wd in (0.0, 0.1):
            yield f"N{n}_step{step}_wd{wd}", step, wd, p, g, m, v


def adam_kernel_checks(torch):
    """K8 against its plain version (K8_TOL), aligned and one element off
    16-byte alignment (the kernel's scalar path); then a ``finite = False``
    step through the optimizer after a real one: p, m, v and the count
    bit-identical.  Returns (max abs err, cases)."""
    from deepspeed_tpu_torch.ops.kernels import fused_adam as K8
    from deepspeed_tpu_torch.ops.optimizers import build_optimizer

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 4)
    n = (1 << 24) + 37
    lr = torch.tensor(1e-3, device=DEVICE)
    err, cases = 0.0, []
    for label, step, wd, p, g, m, v in adam_cases(torch, gen, n):
        t = torch.tensor(step, dtype=torch.int32, device=DEVICE)
        for off in (0, 1):
            got = [x.clone()[off:] for x in (p, m, v)]  # off 1: not 16-byte aligned
            ref = [x[off:].clone() for x in (p, m, v)]
            K8.fused_adamw_kernel(got[0], g[off:], got[1], got[2], lr, t, wd=wd)
            K8.fused_adamw_flat_plain(ref[0], g[off:], ref[1], ref[2], lr, t, wd=wd)
            torch.cuda.synchronize()
            row = dict(kernel="fused_adamw", case=label + ("_unaligned" if off else ""),
                       limit=K8_TOL, limit_on="rel_err (max |got - ref| / max |ref|)")
            for name, a, r in zip(("p", "m", "v"), got, ref):
                e = float((a - r).abs().max())
                err = max(err, e)
                row[f"{name}_rel_err"] = e / float(r.abs().max())
            cases.append(row)
            if not all(bool(torch.isfinite(x).all()) for x in got) or max(
                    row[f"{x}_rel_err"] for x in "pmv") > K8_TOL:
                raise AssertionError(f"fused_adamw: {row} over the limit {K8_TOL}")
    opt = build_optimizer("fusedadam", {"weight_decay": 0.1})
    state = opt.init([p])
    opt.step([p], [g], state, lr)
    before = [x.clone() for x in (p, state["mu"][0], state["nu"][0], state["count"])]
    opt.step([p], [g * float("inf")], state, lr, finite=torch.tensor(False, device=DEVICE))
    after = (p, state["mu"][0], state["nu"][0], state["count"])
    same = all(torch.equal(a, b) for a, b in zip(before, after))
    cases.append(dict(kernel="fused_adamw", case=f"N{n}_finite_false", bit_identical=same))
    if not same:
        raise AssertionError("fused_adamw: a finite=False step changed p, m, v or the count")
    return err, cases


# ---------------------------------------------------------------------------
# phase 3: the engine (put + step) on the 410M model
# ---------------------------------------------------------------------------
def cpu_logits(torch, params_cpu, cfg_cpu, token_lists, rows_per_list):
    """fp32 logits through the port's own model runner on the CPU: the
    sequences of ``token_lists`` packed page-aligned into one prefill (no
    KV written: every page id is -1); for each sequence, the logits at its
    ``rows_per_list`` rows."""
    import numpy as np
    from deepspeed_tpu_torch.inference import model_runner
    from deepspeed_tpu_torch.inference.paged import init_paged_cache

    bs = 32
    t = sum(-(-len(toks) // bs) * bs for toks in token_lists)
    tok, seg, pos = (np.zeros(t, np.int32) for _ in range(3))
    idx, cur = [], 0
    for i, (toks, rows) in enumerate(zip(token_lists, rows_per_list)):
        n = len(toks)
        tok[cur:cur + n], seg[cur:cur + n], pos[cur:cur + n] = toks, i + 1, np.arange(n)
        idx.append([cur + r for r in rows])
        cur += -(-n // bs) * bs
    kv = init_paged_cache(cfg_cpu.num_layers, 1, bs, cfg_cpu.num_kv_heads, cfg_cpu.hd,
                          dtype=torch.float32, device="cpu")
    logits, _ = model_runner.prefill_packed(
        params_cpu, cfg_cpu, tok, seg, pos, np.full(t // bs, -1, np.int32),
        np.asarray(sum(idx, []), np.int32), kv)
    return list(torch.split(logits, [len(r) for r in idx]))


def near_argmax(torch, logits, picks):
    """(worst gap, exact picks): the gap of a pick is (max - its logit) /
    (max - min) of its CPU row."""
    top = logits.max(dim=-1).values
    gap = (top - logits.gather(1, picks[:, None])[:, 0]) / (top - logits.min(dim=-1).values)
    return float(gap.max()), int((logits.argmax(dim=-1) == picks).sum())


# K2's device-kernel name in a profile (paged_tc.cuh's decode body)
K2_PROFILE_NAME = "decode_kernel<"


def decode_kernel(cfg):
    """The decode kernel's launch name for ``cfg``'s head_dim."""
    return "paged_decode_hd64" if cfg.hd == 64 else "paged_decode"


def engine_phase(torch, K, gpu, params, cfg, model="llama3_proxy_410m", phase="engine"):
    """``model``'s serving engine at batch 64 (phase 3, and the first half
    of ``gpt2_serve``)."""
    import numpy as np
    from deepspeed_tpu_torch.inference.engine_v2 import InferenceEngineV2
    from deepspeed_tpu_torch.inference.sampling import SamplingParams

    B, prompt_len, steps = 64, 128, 64
    eng = InferenceEngineV2(params, cfg, max_seqs=B, num_blocks=2048, block_size=32,
                            prefill_budget=2048)
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(1, cfg.vocab_size, prompt_len).tolist() for _ in range(B)]
    samp = SamplingParams(temperature=0.0, max_new_tokens=steps + 8)
    # warm-up (cuBLAS handles, allocator pools) on throwaway uids
    warm = list(range(10_001, 10_017))
    eng.put(warm, [prompts[0]] * len(warm), samp)
    eng.step(samp)
    eng.flush(warm)
    torch.cuda.synchronize()

    stats0 = dict(eng.stats)
    K.reset_launches()
    t0 = time.perf_counter()
    first = eng.put(list(range(1, B + 1)), prompts, samp)  # returns host tokens: synced
    prefill_s = time.perf_counter() - t0
    gen = {u: [first[u]] for u in first}
    tick_ms = []
    for _ in range(steps):
        t0 = time.perf_counter()
        out = eng.step(samp)  # fetches the sampled tokens: synced
        tick_ms.append(1e3 * (time.perf_counter() - t0))
        for u, tok in out.items():
            gen[u].append(tok)
    launches = dict(K.LAUNCHES)
    L = cfg.num_layers
    d_prefill = eng.stats["prefill_dispatches"] - stats0["prefill_dispatches"]
    d_ticks = eng.stats["decode_ticks"] - stats0["decode_ticks"]
    if launches["flash_fwd"] != L * d_prefill or d_prefill == 0:
        raise AssertionError(f"flash launches {launches['flash_fwd']} != {L} x {d_prefill}")
    dec = decode_kernel(cfg)
    if launches[dec] != L * d_ticks or d_ticks != steps:
        raise AssertionError(f"{phase}: {dec} launches {launches[dec]} != {L} x {d_ticks}")
    if any(t < 0 for g in gen.values() for t in g):
        raise AssertionError("non-finite logits in the engine phase")

    # decode-tick profile: device time by kernel over 4 more ticks (only the
    # device-side rows: an operator's row repeats its kernels' time)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(4):
            eng.step(samp)
        prof_wall_ms = 1e3 * (time.perf_counter() - t0) / 4
    evs = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    # None ("not measured") when the profiler sees no device activity
    dev_ms = sum(e.self_device_time_total for e in evs) / 1e3 / 4 if evs else None
    k2_ms = sum(e.self_device_time_total for e in evs if K2_PROFILE_NAME in e.key) / 1e3 / 4
    top = sorted(evs, key=lambda e: -e.self_device_time_total)[:8]
    profile_rows = [dict(name=e.key[:60], ms_per_tick=e.self_device_time_total / 1e3 / 4,
                         calls_per_tick=e.count / 4) for e in top]
    assert eng.close()["blocks_in_use"] == 0

    # near-argmax replay of a few sequences on the CPU in fp32
    worst, exact, total = replay_on_cpu(torch, _tree_cpu(params), cfg,
                                        {u: prompts[u - 1] for u in (1, 2, B)}, gen)
    if worst > ARGMAX_TOL_FRAC:
        raise AssertionError(f"card pick off the CPU argmax by {worst:.4f} of the logit "
                             f"range > {ARGMAX_TOL_FRAC}")
    med_tick = sorted(tick_ms)[len(tick_ms) // 2]
    res = dict(phase=phase, model=model, layers=L, head_dim=cfg.hd, batch=B,
               prompt_len=prompt_len, decode_steps=steps, prefill_dispatches=d_prefill,
               prefill_s=prefill_s, prefill_tokens_per_s=B * prompt_len / prefill_s,
               decode_tick_ms_median=med_tick, decode_tick_ms_mean=sum(tick_ms) / steps,
               decode_tokens_per_s=B * 1e3 / med_tick, launches=launches,
               launches_per_forward={"flash_fwd": launches["flash_fwd"] / d_prefill,
                                     dec: launches[dec] / d_ticks},
               argmax_exact=f"{exact}/{total}", argmax_worst_gap_frac=worst,
               profile_tick_wall_ms=prof_wall_ms, profile_tick_device_ms=dev_ms,
               device_idle_share=None if dev_ms is None else 1.0 - dev_ms / med_tick,
               profile_decode_kernel_ms=k2_ms if evs else None,
               profile_top=profile_rows, gpu=gpu)
    emit(res)
    res["streams"] = gen  # the per-tick twin of the burst phase (not printed)
    return res


def _tree_cpu(x):
    """A parameter tree on the CPU in fp32; quantized payloads keep their
    bytes and types."""
    from deepspeed_tpu_torch.ops.quantizer import QUANT_TYPES, map_quant

    if isinstance(x, dict):
        return {k: _tree_cpu(v) for k, v in x.items()}
    if isinstance(x, QUANT_TYPES):
        return map_quant(x, lambda t: t.cpu())
    return x.float().cpu()


def replay_on_cpu(torch, params_cpu, cfg, prompts, gen):
    """Replay streams (``prompts`` {uid: prompt}, ``gen`` {uid: the card's
    greedy picks}) through the port on the CPU in fp32 (one packed
    prefill); returns (worst near-argmax gap, exact picks, picks)."""
    uids = sorted(prompts)
    logits = cpu_logits(torch, params_cpu, cfg.replace(dtype=torch.float32),
                        [prompts[u] + gen[u][:-1] for u in uids],
                        [list(range(len(prompts[u]) - 1, len(prompts[u]) - 1 + len(gen[u])))
                         for u in uids])
    worst, exact = 0.0, 0
    for u, lg in zip(uids, logits):
        w, e = near_argmax(torch, lg, torch.tensor(gen[u]))
        worst, exact = max(worst, w), exact + e
    return worst, exact, sum(len(gen[u]) for u in uids)


# ---------------------------------------------------------------------------
# phase 4: the scheduler on the shared-prefix workload
# ---------------------------------------------------------------------------
def scheduler_phase(torch, K, gpu, params, cfg):
    import numpy as np
    from deepspeed_tpu_torch.inference.engine_v2 import InferenceEngineV2
    from deepspeed_tpu_torch.inference.sampling import SamplingParams

    n_req, sys_len, sfx_len, max_new = 16, 512, 64, 32
    eng = InferenceEngineV2(
        params, cfg, max_seqs=8, num_blocks=192, block_size=32, max_seq_len=704,
        prefill_buckets=(64, 128, 256), prefill_budget=256, prefill_chunk=256,
        enable_prefix_caching=True)
    sched = eng.scheduler
    rng = np.random.default_rng(SEED)
    sys_prompt = rng.integers(1, cfg.vocab_size, sys_len).tolist()
    prompts = {u: sys_prompt + rng.integers(1, cfg.vocab_size, sfx_len).tolist()
               for u in range(1, n_req + 1)}
    samp = SamplingParams(temperature=0.0, max_new_tokens=max_new)
    K.reset_launches()
    t0 = time.perf_counter()
    for u, p in prompts.items():
        sched.submit(u, p, samp)
    results = sched.run()
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    bad = [u for u, r in results.items() if len(r) != max_new
           or sched.requests[u].state != "finished"]
    if bad:
        raise AssertionError(f"requests did not finish with {max_new} tokens: {bad}")
    if launches["ctx_attention"] == 0:
        raise AssertionError("the packed-context kernel never launched")
    L = cfg.num_layers
    if launches["flash_fwd"] + launches["ctx_attention"] != L * eng.stats["prefill_dispatches"]:
        raise AssertionError(f"prefill launches {launches} != {L} x dispatches")
    if launches["paged_decode"] != L * eng.stats["decode_ticks"]:
        raise AssertionError(f"decode launches {launches} != {L} x ticks")
    ctx_dispatches = eng.stats["prefill_dispatches"] - launches["flash_fwd"] // L
    hit = eng.mgr.cached_prompt_tokens / eng.mgr.prompt_tokens_total
    if hit <= 0:
        raise AssertionError("no prefix-cache hits")
    audit = eng.close()
    if audit["blocks_in_use"] != 0:
        raise AssertionError(f"leaked blocks: {audit}")
    done_tokens = sum(len(p) for p in prompts.values()) + n_req * max_new
    res = dict(phase="scheduler", requests=n_req, sys_len=sys_len, sfx_len=sfx_len,
               max_new_tokens=max_new, ticks=sched.tick_no, wall_s=wall,
               effective_tokens_per_s=done_tokens / wall, prefix_hit_rate=hit,
               prefill_tokens_dispatched=eng.stats["prefill_tokens_dispatched"],
               prefill_dispatches=eng.stats["prefill_dispatches"],
               decode_ticks=eng.stats["decode_ticks"], preemptions=sched.stats["preemptions"],
               launches=launches,
               launches_per_forward={"ctx_attention": launches["ctx_attention"] / ctx_dispatches},
               close=audit, gpu=gpu)
    emit(res)
    return res


# ---------------------------------------------------------------------------
# the serve front end: router, paged-KV handoff, fleet plane, chaos, and
# kernel faults surfacing through it (ROADMAP queue 1 item 6, first half)
# ---------------------------------------------------------------------------
# bench.py --serving --router, its TPU branch (bench.py:703-710), uncut
ROUTER_SEC = dict(max_seqs=8, num_blocks=192, block_size=32, max_seq_len=704,
                  prefill_buckets=[64, 128, 256, 512], prefill_budget=512,
                  enable_prefix_caching=True)
ROUTER_SIZES = dict(n_req=48, sys_len=128, sfx_len=32, max_new=24, long_len=512)
ROUTER_DISAGG = 160  # bench.py: min(long_len, sys_len + sfx_len)
ROUTER_MEM_TOL = 0.10  # a worker's memory growth over its KV pool
ROUTER_REPLAYS = (1, 2, 47, 48)  # routed streams replayed on the CPU (near-argmax)
ROUTER_CHECK_LAYERS = 2
ROUTER_CHECK_REQ = 6  # the bench's requests in router_check, each with a 100-token cut
HANDOFF_BURST = 16  # the replayed burst on the handoff's destination
LONG_UID = 9001


def router_workload(cfg, z=ROUTER_SIZES, seed=SEED):
    """bench.py's mixed traffic, drawn in its order from ``seed``: odd uids
    share a system prompt (the affinity population), even uids are cold;
    then the long prompt."""
    import numpy as np

    rng = np.random.default_rng(seed)
    sys_prompt = rng.integers(1, cfg.vocab_size, z["sys_len"]).tolist()
    prompts = {}
    for u in range(1, z["n_req"] + 1):
        sfx = rng.integers(1, cfg.vocab_size, z["sfx_len"]).tolist()
        prompts[u] = (sys_prompt + sfx if u % 2 else
                      rng.integers(1, cfg.vocab_size, z["sys_len"]).tolist() + sfx)
    return prompts, rng.integers(1, cfg.vocab_size, z["long_len"]).tolist()


def _sync(torch):
    if DEVICE == "cuda":
        torch.cuda.synchronize()


def _mem(torch):
    return torch.cuda.memory_allocated() if DEVICE == "cuda" else 0


def pool_bytes(eng):
    """Bytes of an engine's KV pool tensors (their storage, spare rows
    included)."""
    return sum(p.untyped_storage().nbytes() for p in eng._pool_leaves())


def count_worker_launches(K, router):
    """Per-worker kernel launches: each worker's ticks wrapped to add the
    launches they made to that worker's row (the router runs its workers
    one after another in this process)."""
    per = {w.index: {} for w in router.pool.workers}
    for w in router.pool.workers:
        def tick(n=1, w=w, orig=w.begin_tick):
            before = dict(K.LAUNCHES)
            try:
                orig(n)
            finally:
                for k, v in K.LAUNCHES.items():
                    if v != before[k]:
                        per[w.index][k] = per[w.index].get(k, 0) + v - before[k]
        w.begin_tick = tick
    return per


def token_match(a, b):
    pairs = [(x, y) for u in a for x, y in zip(a[u], b[u])]
    return f"{sum(x == y for x, y in pairs)}/{len(pairs)}"


def _gate_audits(phase, audits):
    if any(a["blocks_in_use"] for a in audits):
        raise AssertionError(f"{phase}: leaked blocks at close: {audits}")


def router_phase(torch, K, gpu, params, cfg, params_cpu):
    """``bench.py --serving --router`` (TPU branch, uncut) on the 410M model:
    the single-engine reference, then the router over 2 workers.  Gates:
    48/48 finished, prefix hit rate > 0, namespaces serve / serve2, zero
    blocks in use at every close, each worker's memory growth within
    ``ROUTER_MEM_TOL`` of its KV pool (the workers share the weights), and
    ``ROUTER_REPLAYS`` routed streams near-argmax against the port on the
    CPU in fp32.  Reported: routed and single-engine tokens/s, the token
    match with the single engine, per-worker launches."""
    from deepspeed_tpu_torch.inference.engine_v2 import build_serve_engine
    from deepspeed_tpu_torch.inference.sampling import SamplingParams
    from deepspeed_tpu_torch.serving import build_router

    z = ROUTER_SIZES
    prompts, long_prompt = router_workload(cfg)
    samp = SamplingParams(temperature=0.0, max_new_tokens=z["max_new"])
    ref = build_serve_engine(params, cfg, ROUTER_SEC, device=DEVICE)
    ref.generate(long_prompt[:100], samp)  # warm-up on a cold prompt
    sched = ref.scheduler
    t0 = time.perf_counter()
    for u, p in prompts.items():
        if not sched.try_submit(u, p, samp).accepted:
            raise AssertionError(f"router: the single engine refused uid {u}")
    sched.run()
    _sync(torch)
    single_s = time.perf_counter() - t0
    want = {u: sched.pop_result(u) for u in prompts}
    single_hit = ref.mgr.cached_prompt_tokens / max(ref.mgr.prompt_tokens_total, 1)
    want_long = ref.generate(long_prompt, samp)
    _gate_audits("router", [ref.close()])
    del ref, sched
    if DEVICE == "cuda":
        _free(torch)

    mem0 = _mem(torch)
    router = build_router(params, cfg, ROUTER_SEC, router=dict(n_workers=2), device=DEVICE)
    mem1 = _mem(torch)
    pool = pool_bytes(router.pool.workers[0].engine)
    per_worker_mem = (mem1 - mem0) / 2
    per_worker = count_worker_launches(K, router)
    K.reset_launches()
    t0 = time.perf_counter()
    for u, p in prompts.items():
        if not router.try_submit(u, p, samp).accepted:
            raise AssertionError(f"router: refused uid {u}")
    out = router.run()
    _sync(torch)
    routed_s = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    stats = dict(router.stats)
    hit = router.prefix_hit_rate()
    namespaces = [w.ns for w in router.pool.workers]
    got = {u: out[u][1] for u in prompts}
    unfinished = [u for u in prompts if out[u][0] != "finished" or len(got[u]) != z["max_new"]]
    audits = router.close()
    if unfinished:
        raise AssertionError(f"router: requests not finished with {z['max_new']} tokens: "
                             f"{unfinished}")
    if hit <= 0:
        raise AssertionError("router: affinity routing recovered no prefix hits")
    if namespaces != ["serve", "serve2"]:
        raise AssertionError(f"router: worker namespaces {namespaces}")
    _gate_audits("router", audits)
    if DEVICE == "cuda" and abs(per_worker_mem - pool) > ROUTER_MEM_TOL * pool:
        raise AssertionError(f"router: a worker grew device memory by {per_worker_mem:.0f} B, "
                             f"its KV pool is {pool} B (the weights must be shared)")
    worst, exact, total = replay_on_cpu(torch, params_cpu, cfg,
                                        {u: prompts[u] for u in ROUTER_REPLAYS},
                                        {u: got[u] for u in ROUTER_REPLAYS})
    if worst > ARGMAX_TOL_FRAC:
        raise AssertionError(f"router: a routed pick is off the CPU argmax by {worst:.4f}")
    n_tok = sum(len(p) for p in prompts.values()) + sum(len(g) for g in got.values())
    res = dict(phase="router", model="llama3_proxy_410m", workers=2, requests=z["n_req"],
               finished=z["n_req"] - len(unfinished), sec=ROUTER_SEC,
               routed_wall_s=routed_s, single_wall_s=single_s,
               routed_tokens_per_s=n_tok / routed_s, single_tokens_per_s=n_tok / single_s,
               prefix_hit_rate=hit, single_engine_hit_rate=single_hit, router_stats=stats,
               namespaces=namespaces, close_audits=audits, kv_pool_bytes=pool,
               per_worker_memory_growth_bytes=per_worker_mem if DEVICE == "cuda" else None,
               token_match_single_engine=token_match(got, want), launches=launches,
               launches_per_worker={f"worker{i}": {k: v for k, v in d.items()
                                                   if k in ("flash_fwd", "paged_decode",
                                                            "ctx_attention")}
                                    for i, d in per_worker.items()},
               argmax_replayed_streams=len(ROUTER_REPLAYS), argmax_exact=f"{exact}/{total}",
               argmax_worst_gap_frac=worst, gpu=gpu)
    emit(res)
    res["want_long"] = want_long  # the unmigrated stream (not printed)
    res["routed"] = got  # the routed streams (not printed)
    return res


def _adopt_injected(eng, ho):
    """Admit ``ho``'s sequence on ``eng`` as ``adopt_prefilled`` does
    (fresh exclusive pages, ``seen_tokens`` = the migrated context), outside
    the scheduler, and inject its pages; returns the descriptor."""
    from deepspeed_tpu_torch.serving import inject_request

    seq = eng.mgr.admit(ho.uid, ho.tokens, match_prefix=False)
    eng.mgr.ensure_capacity(seq, 0)
    seq.seen_tokens = ho.n_ctx
    inject_request(eng, ho)
    return seq


def router_handoff_phase(torch, K, gpu, params, cfg, params_cpu, want_long):
    """Prefill/decode disaggregation on the 410M model: 3 workers, worker 0
    in the prefill role, ``disagg_threshold`` 160, the 512-token prompt,
    with ``handoff_fmt`` 'none' and then 'int8'.  Gates: one handoff, one
    MIGRATED on the source and one adoption on a decode worker, each
    worker's memory growth within ``ROUTER_MEM_TOL`` of its pool, the
    'none' wire exactly 2 x layers x 16 pages x 32 x hkv x hd x 2 B, the
    'int8' wire within [1.0, 1.5) x the element count.  After the 'none'
    run, the pages of the same prompt move once more, engine to engine,
    into a decode worker whose greedy burst graph was captured BEFORE
    either handoff: ``step_n(16)`` replays that graph (no recapture) over
    the injected pool and stays near-argmax against the CPU in fp32.
    Reported: extract (device gather + one host copy), codec and inject
    ms, the token match with the unmigrated stream."""
    from deepspeed_tpu_torch.comm import qcomm
    from deepspeed_tpu_torch.inference.sampling import SamplingParams
    from deepspeed_tpu_torch.serving import build_router, extract_request

    z = ROUTER_SIZES
    _, long_prompt = router_workload(cfg)
    samp = SamplingParams(temperature=0.0, max_new_tokens=z["max_new"])
    L, bs = cfg.num_layers, ROUTER_SEC["block_size"]
    n_pages = -(-z["long_len"] // bs)
    els = 2 * L * n_pages * bs * cfg.num_kv_heads * cfg.hd
    runs, launches, tokens = {}, {}, {}
    for fmt in ("none", "int8"):
        mem0 = _mem(torch)
        r = build_router(params, cfg, ROUTER_SEC, device=DEVICE, router=dict(
            n_workers=3, prefill_workers=1, disagg_threshold=ROUTER_DISAGG, handoff_fmt=fmt))
        mem1 = _mem(torch)
        src, dst = r.pool.workers[0].engine, r.pool.workers[1].engine
        pool = pool_bytes(src)
        # every decode worker captures its greedy burst graph now, before
        # any page of a handoff lands in its pool
        for w in r.pool.workers[1:]:
            w.engine.put([20_001], [long_prompt[:64]], samp)
            w.engine.step_n(2, samp)
            w.engine.flush([20_001])
        graph = dst._burst.graphs[GREEDY] if DEVICE == "cuda" else None
        K.reset_launches()
        t0 = time.perf_counter()
        r.submit(1, long_prompt, samp)
        out = r.run()
        _sync(torch)
        wall = time.perf_counter() - t0
        for k, v in K.LAUNCHES.items():
            launches[k] = launches.get(k, 0) + v
        stats = dict(r.stats)
        migrated = dict(r.pool.workers[0].scheduler.stats)["migrated"]
        adopted = [dict(w.scheduler.stats)["adopted"] for w in r.pool.workers[1:]]
        if stats["handoffs"] != 1 or migrated != 1 or sum(adopted) != 1:
            raise AssertionError(f"router_handoff[{fmt}]: handoffs {stats['handoffs']}, "
                                 f"migrated {migrated}, adopted {adopted}")
        if out[1][0] != "finished" or len(out[1][1]) != z["max_new"]:
            raise AssertionError(f"router_handoff[{fmt}]: the long request ended {out[1][0]}")
        wire = stats["handoff_wire_bytes"]
        esize = src.kv[0][0].element_size()  # the pool's dtype: bf16 on the card
        if fmt == "none" and wire != els * esize:
            raise AssertionError(f"router_handoff: 'none' wire {wire} B != {els * esize} B")
        if fmt == "int8" and not els <= wire < 1.5 * els:
            raise AssertionError(f"router_handoff: 'int8' wire {wire} B outside [{els}, "
                                 f"{1.5 * els})")
        if DEVICE == "cuda" and abs((mem1 - mem0) / 3 - pool) > ROUTER_MEM_TOL * pool:
            raise AssertionError(f"router_handoff: a worker grew device memory by "
                                 f"{(mem1 - mem0) / 3:.0f} B, its pool is {pool} B")
        # the same pages once more, engine to engine, each step timed
        uid = 30_001
        src.put([uid], [long_prompt], samp)
        blocks = src.mgr.seqs[uid].blocks[:n_pages]
        _sync(torch)
        t0 = time.perf_counter()
        pages = src.extract_kv_blocks(blocks)
        t1 = time.perf_counter()
        for leaf in (*pages[0], *pages[1]):
            qcomm.quantize_payload(leaf, fmt)
        t2 = time.perf_counter()
        ho = extract_request(src, uid, fmt)
        t3 = time.perf_counter()
        seq = _adopt_injected(dst, ho)
        _sync(torch)
        t4 = time.perf_counter()
        tokens[fmt] = out[1][1]
        run = dict(wall_s=wall, handoff_wire_bytes=wire, wire_bytes_per_element=wire / els,
                   router_stats=stats, extract_ms=1e3 * (t1 - t0), codec_ms=1e3 * (t2 - t1),
                   extract_request_ms=1e3 * (t3 - t2), inject_ms=1e3 * (t4 - t3),
                   token_match_unmigrated=token_match({1: out[1][1]}, {1: want_long}),
                   per_worker_memory_growth_bytes=(mem1 - mem0) / 3 if DEVICE == "cuda"
                   else None)
        if fmt == "none":
            before = dict(K.LAUNCHES)
            dst.step_n(HANDOFF_BURST, samp)
            burst_launches = {k: v - before[k] for k, v in K.LAUNCHES.items() if v != before[k]}
            if DEVICE == "cuda" and dst._burst.graphs.get(GREEDY) is not graph:
                raise AssertionError("router_handoff: the burst graph was recaptured")
            dec = decode_kernel(cfg)
            if DEVICE == "cuda" and burst_launches.get(dec) != L * HANDOFF_BURST:
                raise AssertionError(f"router_handoff: the burst launched {burst_launches}")
            gen = seq.tokens[z["long_len"]:]
            worst, exact, total = replay_on_cpu(torch, params_cpu, cfg, {uid: long_prompt},
                                                {uid: gen})
            if len(gen) != 1 + HANDOFF_BURST or worst > ARGMAX_TOL_FRAC:
                raise AssertionError(f"router_handoff: the burst after the injection is off "
                                     f"the CPU argmax by {worst:.4f} ({len(gen)} tokens)")
            run.update(burst_after_inject=dict(ticks=HANDOFF_BURST, launches=burst_launches,
                                               argmax_exact=f"{exact}/{total}",
                                               argmax_worst_gap_frac=worst))
        dst.flush([uid])
        src.flush([uid])
        audits = r.close()
        _gate_audits(f"router_handoff[{fmt}]", audits)
        run["close_audits"] = audits
        runs[fmt] = run
        del r, src, dst
    res = dict(phase="router_handoff", model="llama3_proxy_410m", workers=3,
               prefill_workers=1, disagg_threshold=ROUTER_DISAGG, long_len=z["long_len"],
               elements=els, kv_pool_bytes=pool, runs=runs, launches=launches, gpu=gpu)
    emit(res)
    res["tokens"] = tokens  # the migrated streams (not printed)
    return res


def _int8_payload_np(page):
    """JAX's numpy int8 codec (comm/qcomm.py:487-520) on one page: the
    reference the port's torch codec is held to, byte for byte."""
    import numpy as np

    flat = np.asarray(page, np.float32).reshape(-1)
    pad = (-flat.shape[0]) % 256
    if pad:
        flat = np.pad(flat, (0, pad))
    buf = flat.reshape(-1, 256)
    s = (np.maximum(np.max(np.abs(buf), axis=-1), 1e-12) / 127.0).astype(np.float32)
    return np.clip(np.round(buf / s[:, None]), -127, 127).astype(np.int8), s


def cpu_forced_logits(torch, eng, seq, forced):
    """fp32 logits of ``seq``'s decode steps on a CPU engine whose pool
    holds its context, feeding ``forced`` (the card's picks) one by one:
    row i scores the token after ``seq.tokens[-1]`` at step i."""
    import numpy as np
    from deepspeed_tpu_torch.inference import model_runner

    B = eng.mgr.max_seqs
    rows = []
    for tok in forced:
        eng.mgr.ensure_capacity(seq, 1)
        eng._set_block_table(seq)
        tokens, lens, active = np.zeros(B, np.int32), np.zeros(B, np.int32), np.zeros(B, bool)
        tokens[seq.slot], lens[seq.slot], active[seq.slot] = seq.tokens[-1], seq.cur_len - 1, True
        logits, eng.kv = model_runner.decode_step(eng.params, eng.cfg, tokens, lens,
                                                  eng._tables_np, active, eng.kv,
                                                  ctx=eng.serving_ctx)
        rows.append(logits[seq.slot].float())
        seq.tokens.append(int(tok))
        seq.seen_tokens = seq.cur_len - 1
    return torch.stack(rows)


def router_check_phase(torch, K, gpu, cfg):
    """The 410M model at full width with ``ROUTER_CHECK_LAYERS`` layers,
    bf16 on the card, through the router (3 workers, 1 prefill, the
    bench's threshold of 160) with 'none' and then 'int8' handoffs,
    against the port on the CPU in fp32: the long prompt first (it
    migrates while the decode workers are idle), then ``ROUTER_CHECK_REQ``
    of the bench's 160-token requests (they route to the prefill worker and
    migrate too) and as many 100-token cuts of them (routed by affinity or
    load, never migrated).  Every stream is near-argmax on every step: a
    migrated stream's first token by a replay of its prompt, its decode on
    a CPU engine holding the card's pages through the same codec (for
    'int8' the dequantized bytes the card's decode read); an unmigrated
    stream by a plain replay.  The int8 codec on the card's pages equals
    JAX's numpy codec byte for byte."""
    import numpy as np
    from deepspeed_tpu_torch.inference.engine_v2 import InferenceEngineV2
    from deepspeed_tpu_torch.inference.sampling import SamplingParams
    from deepspeed_tpu_torch.models.transformer import init_params
    from deepspeed_tpu_torch.serving import build_router

    cfg2 = cfg.replace(num_layers=ROUTER_CHECK_LAYERS)
    params2 = init_params(cfg2, seed=SEED, device=DEVICE)
    params_cpu = _tree_cpu(params2)
    cfg_cpu = cfg2.replace(dtype=torch.float32)
    z = ROUTER_SIZES
    bench_prompts, long_prompt = router_workload(cfg)
    prompts = {LONG_UID: long_prompt}
    for u in range(1, ROUTER_CHECK_REQ + 1):
        prompts[u] = bench_prompts[u]
        prompts[100 + u] = bench_prompts[u][:100]
    samp = SamplingParams(temperature=0.0, max_new_tokens=z["max_new"])
    runs, launches = {}, {}
    for fmt in ("none", "int8"):
        r = build_router(params2, cfg2, ROUTER_SEC, device=DEVICE, router=dict(
            n_workers=3, prefill_workers=1, disagg_threshold=ROUTER_DISAGG, handoff_fmt=fmt))
        w0 = r.pool.workers[0]
        kept = {}

        def keep(uid, fmt, orig=w0.extract_handoff, eng=w0.engine):
            seq = eng.mgr.seqs[uid]
            raw = eng.extract_kv_blocks(seq.blocks[:-(-seq.seen_tokens // eng.block_size)])
            ho = orig(uid, fmt)
            kept[uid] = (ho, raw)
            return ho

        detached = []

        def detach(uid, orig=w0.detach_migrated):
            ok = orig(uid)
            if ok:
                detached.append(uid)
            return ok

        w0.extract_handoff, w0.detach_migrated = keep, detach
        K.reset_launches()
        r.submit(LONG_UID, long_prompt, samp)
        r.tick()
        for u, p in prompts.items():
            if u != LONG_UID:
                r.submit(u, p, samp)
        out = r.run()
        for k, v in K.LAUNCHES.items():
            launches[k] = launches.get(k, 0) + v
        stats = dict(r.stats)
        _gate_audits(f"router_check[{fmt}]", r.close())
        got = {u: out[u][1] for u in prompts}
        if any(out[u][0] != "finished" or len(g) != z["max_new"] for u, g in got.items()):
            raise AssertionError(f"router_check[{fmt}]: unfinished streams")
        if LONG_UID not in detached or stats["handoffs"] != len(detached):
            raise AssertionError(f"router_check[{fmt}]: {stats['handoffs']} handoffs, "
                                 f"{sorted(detached)} detached")
        # a stream extracted but not adopted (a fallback) decoded where it was
        moved = sorted(detached)
        stay = [u for u in prompts if u not in detached]
        if not stay:
            raise AssertionError(f"router_check[{fmt}]: every stream migrated")
        # unmigrated streams, and the migrated ones' first tokens (sampled on
        # the prefill worker from its own exact KV): plain replays
        w_a, e_a, t_a = replay_on_cpu(torch, params_cpu, cfg2,
                                      {u: prompts[u] for u in prompts},
                                      {u: got[u] if u in stay else got[u][:1] for u in prompts})
        # migrated streams' decode: on a CPU engine holding the card's pages
        eng = InferenceEngineV2(params_cpu, cfg_cpu, device="cpu", **dict(
            ROUTER_SEC, max_seqs=len(moved), num_blocks=len(moved) * 24))
        w_b, e_b, t_b = 0.0, 0, 0
        codec_equal = True
        for u in moved:
            ho, raw = kept[u]
            seq = _adopt_injected(eng, ho)
            logits = cpu_forced_logits(torch, eng, seq, got[u][1:])
            w, e = near_argmax(torch, logits, torch.tensor(got[u][1:]))
            w_b, e_b, t_b = max(w_b, w), e_b + e, t_b + len(got[u]) - 1
            eng.flush([u])
            if fmt == "int8":
                for (q, sc, _, _), page in zip(ho.payloads, (*raw[0], *raw[1])):
                    rq, rs = _int8_payload_np(page.float().numpy())
                    codec_equal &= bool(np.array_equal(q.numpy(), rq)
                                        and np.array_equal(sc.numpy(), rs))
        eng.close()
        if not codec_equal:
            raise AssertionError("router_check: the int8 codec's bytes on the card's pages "
                                 "differ from the numpy codec's")
        worst = max(w_a, w_b)
        if worst > ARGMAX_TOL_FRAC:
            raise AssertionError(f"router_check[{fmt}]: a card pick is off the CPU argmax by "
                                 f"{worst:.4f}")
        runs[fmt] = dict(migrated_streams=len(moved), routed_streams=len(stay),
                         replay_argmax_exact=f"{e_a}/{t_a}", replay_worst_gap_frac=w_a,
                         migrated_decode_argmax_exact=f"{e_b}/{t_b}",
                         migrated_decode_worst_gap_frac=w_b,
                         codec_bytes_equal_numpy=codec_equal if fmt == "int8" else None,
                         router_stats=stats)
    res = dict(phase="router_check", model="llama3_proxy_410m", layers=ROUTER_CHECK_LAYERS,
               streams=len(prompts), runs=runs, launches=launches,
               tolerance=ARGMAX_TOL_FRAC, gpu=gpu)
    emit(res)
    return res


def router_fleet_phase(torch, K, gpu, params, cfg):
    """The fleet plane on the 410M model: telemetry on, 3 workers (1
    prefill), a fleet collector thread pulling every 25 ms, the long prompt
    first (it migrates while the decode workers are idle), then the 48
    prompts.  Gates: the merged ttft_ms / e2e_ms p50 / p90 / p99 equal the
    pooled per-worker samples, the stitched trace holds the migrated uid's
    route and handoff spans and at least 2 request pids, SLO availability
    1.0, every deferred span (a prefill pack that samples nothing, probed
    on a decode worker after the run) resolved with device_ms > 0, and a
    telemetry-off twin with equal router stats.  Reported: the twin's token
    match and both wall times (the telemetry tax)."""
    import math

    from deepspeed_tpu_torch.inference.sampling import SamplingParams
    from deepspeed_tpu_torch.serving import build_router
    from deepspeed_tpu_torch.telemetry import (Telemetry, attach_fleet_collector,
                                               fleet_chrome_trace)

    z = ROUTER_SIZES
    prompts, long_prompt = router_workload(cfg)
    samp = SamplingParams(temperature=0.0, max_new_tokens=z["max_new"])
    runs = {}
    for on in (True, False):
        tel = Telemetry(True) if on else None
        r = build_router(params, cfg, ROUTER_SEC, telemetry=tel, device=DEVICE, router=dict(
            n_workers=3, prefill_workers=1, disagg_threshold=ROUTER_DISAGG,
            metrics_pull_interval_ms=25.0 if on else None))
        coll = attach_fleet_collector(r, start=True) if on else None
        K.reset_launches()
        t0 = time.perf_counter()
        r.submit(LONG_UID, long_prompt, samp)
        r.tick()
        for u, p in prompts.items():
            if not r.try_submit(u, p, samp).accepted:
                raise AssertionError(f"router_fleet: refused uid {u}")
        out = r.run()
        _sync(torch)
        wall = time.perf_counter() - t0
        run = dict(out=out, stats=dict(r.stats), wall_s=wall, launches=dict(K.LAUNCHES))
        if on:
            coll.stop(final_pull=True)
            fleet = coll.fleet
            merged = {}
            for metric in ("ttft_ms", "e2e_ms"):
                pooled = sorted(v for st in fleet.histogram_states(metric)
                                for v in st["samples"] or [])
                h = fleet.merged_histogram(metric)
                if h is None or not h.exact or h.count != len(pooled) or not pooled:
                    raise AssertionError(f"router_fleet: {metric} merged {h} vs "
                                         f"{len(pooled)} pooled samples")
                for q in (50, 90, 99):
                    truth = pooled[min(len(pooled), max(1, math.ceil(q / 100 * len(pooled)))) - 1]
                    if h.percentile(q) != truth:
                        raise AssertionError(f"router_fleet: {metric} p{q} {h.percentile(q)} "
                                             f"!= pooled {truth}")
                merged[metric] = dict(count=h.count, **h.quantiles((50, 90, 99)))
            sig = r.signals()
            trace = fleet_chrome_trace(fleet, telemetry=tel)
            xs = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
            mig = {e["name"] for e in xs if e["pid"] == 0
                   and e.get("args", {}).get("uid") == LONG_UID}
            req_pids = {e["pid"] for e in xs if e["pid"] % 2 == 1}
            if not {"route", "handoff"} <= mig or len(req_pids) < 2:
                raise AssertionError(f"router_fleet: trace spans {mig}, request pids {req_pids}")
            if sig["slo"]["availability"] != 1.0 or run["stats"]["handoffs"] < 1:
                raise AssertionError(f"router_fleet: slo {sig['slo']}, stats {run['stats']}")
            # a prefill pack that samples nothing ends with a deferred device
            # reading (a CUDA event), resolved at the flush
            eng = r.pool.workers[1].engine
            seq = eng.mgr.admit(40_001, long_prompt[:256], match_prefix=False)
            eng.mgr.ensure_capacity(seq, 0)
            eng.prefill_entries([(seq, 0, 128)], samp)
            eng.mgr.release(40_001)
            tel.flush()
            deferred = [sp for sp in tel.recorder._spans if sp.t_end is None]
            if not deferred or any(not sp.device_ms or sp.device_ms <= 0 for sp in deferred):
                raise AssertionError(f"router_fleet: deferred spans {[sp.device_ms for sp in deferred]}")
            run.update(merged=merged, slo=sig["slo"], fleet_counters=sig["fleet_counters"],
                       trace_events=len(trace["traceEvents"]), request_pids=sorted(req_pids),
                       deferred_spans=len(deferred),
                       deferred_device_ms=[sp.device_ms for sp in deferred],
                       spans_recorded=len(tel.recorder), pulls=sig["fleet"])
        _gate_audits("router_fleet", r.close())
        runs["on" if on else "off"] = run
    on, off = runs["on"], runs["off"]
    if on["stats"] != off["stats"]:
        raise AssertionError(f"router_fleet: telemetry changed the router stats "
                             f"{on['stats']} vs {off['stats']}")
    match = token_match({u: on["out"][u][1] for u in on["out"]},
                        {u: off["out"][u][1] for u in off["out"]})
    res = dict(phase="router_fleet", model="llama3_proxy_410m", workers=3, prefill_workers=1,
               requests=z["n_req"] + 1, wall_s_on=on["wall_s"], wall_s_off=off["wall_s"],
               telemetry_tax=on["wall_s"] / off["wall_s"] - 1.0, twin_token_match=match,
               router_stats=on["stats"],
               **{k: on[k] for k in ("merged", "slo", "fleet_counters", "trace_events",
                                     "request_pids", "deferred_spans", "deferred_device_ms",
                                     "spans_recorded")},
               launches=on["launches"], gpu=gpu)
    emit(res)
    return res


def router_chaos_phase(torch, K, gpu, params, cfg):
    """``bench.py --serving --router --chaos``'s storm (bench.py:896-960) on
    the 410M model: the single-engine storm baseline (``FaultInjector``
    seed 0: transient and fatal runner exceptions, NaN logits, allocator
    exhaustion, slow ticks), then the router over 2 workers under the same
    storm plus a ``worker_kill`` (seed 1).  Gates: healthy-request
    availability >= the baseline's, one worker death, SLO availability
    equal to the terminal states' count, zero leaks on every worker."""
    from deepspeed_tpu_torch.inference.engine_v2 import build_serve_engine
    from deepspeed_tpu_torch.inference.faults import FaultInjector
    from deepspeed_tpu_torch.inference.sampling import SamplingParams
    from deepspeed_tpu_torch.serving import build_router
    from deepspeed_tpu_torch.telemetry import attach_fleet_collector

    z = ROUTER_SIZES
    prompts, _ = router_workload(cfg)
    samp = SamplingParams(temperature=0.0, max_new_tokens=z["max_new"])
    serve_kw = dict(max_retries=4, retry_backoff_ms=1.0, shed_queue_depth=max(2, z["n_req"] // 4))
    nan_victims, fatal_victims = [5, 9], [3]
    injected = set(nan_victims) | set(fatal_victims)

    def storm():
        return (FaultInjector(seed=0)
                .arm("runner_exception", p=0.05, transient=True)
                .arm("runner_exception", uids=fatal_victims)
                .arm("nan_logits", uids=nan_victims, times=len(nan_victims))
                .arm("alloc_exhaustion", p=0.05, transient=True, times=8)
                .arm("slow_tick", p=0.1, delay_s=0.002, times=10))

    def availability(results):
        healthy = [u for u in prompts if u not in injected]
        return sum(results[u][0] == "finished" for u in healthy) / len(healthy)

    base = build_serve_engine(params, cfg, ROUTER_SEC, serve=serve_kw, faults=storm(),
                              device=DEVICE)
    sched = base.scheduler
    t0 = time.perf_counter()
    for u, p in prompts.items():
        if not sched.try_submit(u, p, samp).accepted:
            raise AssertionError(f"router_chaos: the baseline refused uid {u}")
    sched.run()
    base_s = time.perf_counter() - t0
    base_out = {u: (sched.requests[u].state, sched.pop_result(u)) for u in prompts}
    base_avail = availability(base_out)
    base_stats = {k: base.stats[k] for k in ("failed", "nan_failures", "retries",
                                             "isolation_probes", "shed_transitions")}
    _gate_audits("router_chaos", [base.close()])
    kill = FaultInjector(seed=1).arm("worker_kill", uids=[1], after=4, times=1)
    engine_faults = storm()
    r = build_router(params, cfg, ROUTER_SEC, router=dict(n_workers=2), serve=serve_kw,
                     faults=kill, engine_faults=engine_faults, device=DEVICE)
    coll = attach_fleet_collector(r, start=False)
    K.reset_launches()
    t0 = time.perf_counter()
    backlog = []
    for u, p in prompts.items():
        if not r.try_submit(u, p, samp).accepted:
            backlog.append(u)
    ticks = 0
    while backlog or not r.idle:
        if backlog and r.try_submit(backlog[0], prompts[backlog[0]], samp).accepted:
            backlog.pop(0)
        r.tick()
        ticks += 1
        if ticks > 100_000:
            raise AssertionError("router_chaos: the storm did not converge")
    _sync(torch)
    storm_s = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    out = {u: r.pop_result(u) for u in prompts}
    avail = availability(out)
    coll.pull_once()
    slo = r.signals()["slo"]
    term = [out[u][0] for u in prompts]
    n_fin = sum(s == "finished" for s in term)
    n_err = sum(s in ("failed", "timed_out") for s in term)
    stats = dict(r.stats)
    audits = r.close()
    _gate_audits("router_chaos", audits)
    if abs(slo["availability"] - n_fin / max(n_fin + n_err, 1)) > 1e-12 \
            or slo["finished"] != n_fin or slo["errors"] != n_err:
        raise AssertionError(f"router_chaos: slo {slo} vs {n_fin} finished / {n_err} errors")
    if stats["worker_deaths"] != 1:
        raise AssertionError(f"router_chaos: {stats['worker_deaths']} worker deaths")
    if avail < base_avail:
        raise AssertionError(f"router_chaos: availability {avail} < baseline {base_avail}")
    res = dict(phase="router_chaos", model="llama3_proxy_410m", workers=2,
               requests=z["n_req"], injected=sorted(injected), serve=serve_kw,
               availability=avail, baseline_availability=base_avail, slo=slo,
               router_stats=stats, baseline_stats=base_stats,
               faults_fired={p: engine_faults.fired(p) for p in (
                   "runner_exception", "nan_logits", "alloc_exhaustion", "slow_tick")},
               storm_wall_s=storm_s, baseline_wall_s=base_s, router_ticks=ticks,
               terminal_states={s: term.count(s) for s in sorted(set(term))},
               close_audits=audits, launches=launches, gpu=gpu)
    emit(res)
    return res


def kernel_errors_phase(torch, K, gpu, cfg):
    """A kernel fault inside a worker's tick surfaces: on a 2-worker router
    (the 410M model cut to 2 layers, on the card), worker 1's paged-decode
    launches are made to raise the kernel layer's ``KernelError`` (worker 0
    launches for real).  ``router.tick()`` must raise it; no request may be
    FAILED, no retry or isolation probe counted, no worker marked dead."""
    from deepspeed_tpu_torch.inference.sampling import SamplingParams
    from deepspeed_tpu_torch.models.transformer import init_params
    from deepspeed_tpu_torch.ops.kernels import paged_attention as PA
    from deepspeed_tpu_torch.serving import build_router

    cfg2 = cfg.replace(num_layers=ROUTER_CHECK_LAYERS)
    params2 = init_params(cfg2, seed=SEED, device=DEVICE)
    prompts, _ = router_workload(cfg)
    r = build_router(params2, cfg2, ROUTER_SEC, router=dict(n_workers=2), device=DEVICE,
                     serve=dict(max_retries=3, retry_backoff_ms=0.0))
    samp = SamplingParams(temperature=0.0, max_new_tokens=8)
    for u in range(1, 9):
        r.submit(u, prompts[u], samp)
    r.tick()  # admission and prefill, fault-free
    victim = {p.data_ptr() for p in r.pool.workers[1].engine._pool_leaves()}
    real = PA.launch
    fired = []

    def launch(name, *args):
        if name.startswith("paged_decode") and args[1].value in victim:
            fired.append(name)
            raise K.KernelError(f"CUDA kernel {name} failed to launch: cudaError 719 "
                                "(made to fail on worker 1)")
        return real(name, *args)

    caught = None
    PA.launch = launch
    try:
        r.tick()
    except K.KernelError as e:
        caught = str(e)
    finally:
        PA.launch = real
    engines = [w.engine for w in r.pool.workers]
    failed = [u for w in r.pool.workers for u, q in w.scheduler.requests.items()
              if q.state == "failed"]
    counts = {k: sum(e.stats[k] for e in engines) for k in ("failed", "retries",
                                                            "isolation_probes")}
    stats = dict(r.stats)
    alive = [w.alive for w in r.pool.workers]
    r.close()
    if caught is None or not fired:
        raise AssertionError("kernel_errors_surface: router.tick() did not raise the "
                             "kernel's error")
    if failed or any(counts.values()) or stats["worker_deaths"] or not all(alive):
        raise AssertionError(f"kernel_errors_surface: failed {failed}, counts {counts}, "
                             f"deaths {stats['worker_deaths']}, alive {alive}")
    res = dict(phase="kernel_errors_surface", raised=caught, launches_refused=len(fired),
               failed_requests=0, retries=0, isolation_probes=0, worker_deaths=0, gpu=gpu)
    emit(res)
    return res


# ---------------------------------------------------------------------------
# the out-of-process serve plane: subprocess workers on the card
# ---------------------------------------------------------------------------
REMOTE_PRESET = "llama3_proxy_410m"  # what the children build (CPU rehearsals: "tiny")
# bench.py:553-554's transport knobs for the card storm
REMOTE_KNOBS = dict(heartbeat_interval_ms=40.0, lease_ms=1500.0, rpc_backoff_ms=5.0,
                    rpc_backoff_max_ms=100.0)
REMOTE_READY_S = 300.0  # a child's wait_ready limit
REMOTE_KILL_TICK = 6  # router tick of remote_chaos's real SIGKILL (bench.py:616)
REMOTE_REPLAYS = 4  # replayed streams held near-argmax against the CPU
# alternating in-process / remote rounds of compare_routers (2 for the
# smoke's time limit: each round serves the workload on both routers)
COMPARE_ROUNDS = 2
REMOTE_KERNELS = ("flash_fwd", "paged_decode", "paged_decode_hd64", "ctx_attention")


def remote_spec(cfg, telemetry=False):
    """The children's spec: ``REMOTE_PRESET`` at ``cfg``'s dtype and length,
    weights from ``SEED`` on ``DEVICE`` (the parent's ``params`` are the
    same tensors: one seed, one device type), ``ROUTER_SEC``'s engine."""
    return {"preset": REMOTE_PRESET, "seed": SEED, "dtype": str(cfg.dtype).split(".")[-1],
            "max_seq_len": cfg.max_seq_len, "sec": ROUTER_SEC, "device": DEVICE,
            "telemetry": telemetry}


def child_stats(router):
    """{worker index: its ``stats`` reply} for every live child."""
    return {w.index: w.stats() for w in router.pool.workers if w.alive}


def child_launches(before, after):
    """{worker: {kernel: launches}} made by each child between two stats."""
    out = {}
    for i, st in after.items():
        b = before.get(i, {}).get("launches", {})
        d = {k: v - b.get(k, 0) for k, v in st["launches"].items() if v != b.get(k, 0)}
        out[f"worker{i}"] = d
    return out


def _sum_launches(per_child):
    tot = {}
    for d in per_child.values():
        for k, v in d.items():
            tot[k] = tot.get(k, 0) + v
    return tot


def _counter_diff(a, b):
    return {k: b[k] - a.get(k, 0) for k in b if isinstance(b[k], (int, float))}


def remote_rehearse(router, cfg, samp, n, long_len=0, uid0=60_000):
    """Run every shape once before a measured or chaotic window (first
    kernel loads, cuBLAS handles, a burst graph's capture), on prompts
    that share no prefix with the workload."""
    import numpy as np

    rng = np.random.default_rng(SEED + 101)
    z = ROUTER_SIZES
    uids = []
    for i in range(n):
        uids.append(uid0 + i)
        router.submit(uid0 + i, rng.integers(1, cfg.vocab_size, z["sys_len"]
                                             + z["sfx_len"]).tolist(), samp)
    if long_len:
        uids.append(uid0 + n)
        router.submit(uid0 + n, rng.integers(1, cfg.vocab_size, long_len).tolist(), samp)
    out = router.run()
    for u in uids:
        router.pop_result(u)
    return {u: out[u][0] for u in uids}


def _reap_all(handles):
    return [h.reap() for h in handles]


def _gate_reaped(phase, handles):
    alive = [h.pid for h in handles if h.proc.poll() is None]
    if alive:
        raise AssertionError(f"{phase}: children not reaped: {alive}")


def _routed_pass(torch, router, prompts, samp, uid0):
    """Submit ``prompts`` (uids shifted by ``uid0``), run to the end; returns
    (outputs by workload uid, wall s, children's launches, router stats
    diff, prefix hit rate of the pass, each child's engine-counter diff)."""
    before, rs0 = child_stats(router), dict(router.stats)
    hit0 = [(w.prompt_tokens_total, w.cached_prompt_tokens) for w in router.pool.workers]
    got, wall = _timed_pass(torch, router, prompts, samp, uid0)
    after = child_stats(router)
    pt = sum(w.prompt_tokens_total - a for w, (a, _) in zip(router.pool.workers, hit0))
    ct = sum(w.cached_prompt_tokens - c for w, (_, c) in zip(router.pool.workers, hit0))
    serve = {f"worker{i}": _counter_diff(before[i]["serve"], st["serve"])
             for i, st in after.items()}
    return (got, wall, child_launches(before, after), _counter_diff(rs0, dict(router.stats)),
            ct / pt if pt else 0.0, serve)


def _timed_pass(torch, router, prompts, samp, uid0):
    """Submit ``prompts`` (uids shifted by ``uid0``) to ``router``, run it
    to the end and pop every result; returns ({workload uid: (state,
    tokens)}, wall s)."""
    t0 = time.perf_counter()
    for u, p in prompts.items():
        if not router.try_submit(uid0 + u, p, samp).accepted:
            raise AssertionError(f"routed pass: refused uid {uid0 + u}")
    out = router.run()
    _sync(torch)
    wall = time.perf_counter() - t0
    for u in prompts:
        router.pop_result(uid0 + u)
    return {u: out[uid0 + u] for u in prompts}, wall


def compare_routers(torch, params, cfg, remote, samp, rounds=COMPARE_ROUNDS):
    """The in-process router (2 workers, one process) against ``remote``
    (2 children), warmed alike (``remote_rehearse`` on each) and run
    alternately on the same fresh draws: round k serves draw ``SEED + 10 +
    k`` on both, in-process first in even rounds, remote first in odd ones.
    Each pass runs under ``GpuBusy``, on both sides alike.  Gates: every
    request finishes on both sides, the in-process router's audits hold 0
    blocks.  Reported: each side's tokens/s per round, their medians and
    spread, the ratio of the medians, the token match per round, and
    ``nvidia-smi``'s utilization per pass (a coarse 100 ms sample of any
    kernel running, not a share from a trace)."""
    import statistics

    from deepspeed_tpu_torch.serving import build_router

    z = ROUTER_SIZES
    local = build_router(params, cfg, ROUTER_SEC, router=dict(n_workers=2), device=DEVICE)
    routers = {"inprocess": local, "remote": remote}
    side = {k: dict(tokens_per_s=[], nvidia_smi_utilization=[]) for k in routers}
    match = []
    try:
        remote_rehearse(local, cfg, samp, n=4)
        for k in range(rounds):
            prompts, _ = router_workload(cfg, seed=SEED + 10 + k)
            n_prompt = sum(len(p) for p in prompts.values())
            order = ("inprocess", "remote") if k % 2 == 0 else ("remote", "inprocess")
            toks = {}
            for name in order:
                with GpuBusy() as busy:
                    got, wall = _timed_pass(torch, routers[name], prompts, samp,
                                            uid0=10_000 * (k + 2))
                bad = [u for u in prompts if got[u][0] != "finished"
                       or len(got[u][1]) != z["max_new"]]
                if bad:
                    raise AssertionError(f"compare_routers[{name}, round {k}]: unfinished {bad}")
                toks[name] = {u: got[u][1] for u in prompts}
                n_tok = n_prompt + sum(len(t) for t in toks[name].values())
                side[name]["tokens_per_s"].append(n_tok / wall)
                side[name]["nvidia_smi_utilization"].append(busy.mean)
            match.append(token_match(toks["remote"], toks["inprocess"]))
        audits = local.close()
        local = None
    finally:
        if local is not None:
            local.close()
    _gate_audits("compare_routers", audits)
    for d in side.values():
        v = d["tokens_per_s"]
        d.update(median=statistics.median(v), min=min(v), max=max(v))
    return dict(rounds=rounds, order="in-process first in even rounds, remote first in odd",
                ratio_of_medians=side["remote"]["median"] / side["inprocess"]["median"],
                ratio_per_round=[r / i for r, i in zip(side["remote"]["tokens_per_s"],
                                                       side["inprocess"]["tokens_per_s"])],
                token_match_per_round=match, **side)


def remote_router_phase(torch, K, gpu, params, cfg, params_cpu, rt):
    """``build_remote_router`` over 2 subprocess workers on the card (each
    its own CUDA context, weights and pool), the router phase's workload,
    after a rehearsal: per tick, then ``decode_megastep`` 8 pushed live to
    both children (``apply_knobs``) with the router's ``step_burst`` of 8.
    Gates: 48/48 finished each pass, ``ROUTER_REPLAYS`` near-argmax against
    the CPU, each child's launches show K1f and K2 (and K3 on the affinity
    hits), the megastep pass's K2 launches include burst replays (layers x
    burst ticks), no death, both audits 0 blocks, both children reaped.
    Then ``serve_worker_main`` over a pipe to one child on the card: one
    request, a clean shutdown on EOF with a 0-block audit.  Between the
    two passes, ``compare_routers`` against an in-process router warmed
    alike, alternating (kernels of several contexts time-slice; no MPS).
    Reported: tokens/s beside the router phase's in-process router and
    single engine, the comparison's medians and spread, hit rate, token
    match with the in-process router, each child's ``memory_allocated``."""
    import dataclasses

    from deepspeed_tpu_torch.inference.sampling import SamplingParams
    from deepspeed_tpu_torch.serving import build_remote_router

    z = ROUTER_SIZES
    samp = SamplingParams(temperature=0.0, max_new_tokens=z["max_new"])
    L = cfg.num_layers
    dec = decode_kernel(cfg)
    t0 = time.perf_counter()
    r = build_remote_router(remote_spec(cfg), router=dict(n_workers=2, **REMOTE_KNOBS))
    spawn_s = time.perf_counter() - t0
    handles = [w.handle for w in r.pool.workers]
    passes, launches, audits = {}, {}, None
    try:
        remote_rehearse(r, cfg, samp, n=4)
        for i, (name, fuse) in enumerate((("per_tick", 1), ("megastep", MEGASTEP_FUSE))):
            if fuse > 1:
                staged = r.apply_knobs({"decode_megastep": fuse})
                if any(isinstance(v, str) for v in staged.values()):
                    raise AssertionError(f"remote_router: apply_knobs refused: {staged}")
                r.config = dataclasses.replace(r.config, decode_megastep=fuse)
                remote_rehearse(r, cfg, samp, n=8, uid0=61_000)  # captures the burst graphs
            # the per-tick pass serves the router phase's prompts; the
            # megastep pass a fresh draw of the same shapes (cold caches)
            prompts, _ = router_workload(cfg, seed=SEED + i)
            n_tok_prompt = sum(len(p) for p in prompts.values())
            got, wall, per_child, stats, hit, serve = _routed_pass(
                torch, r, prompts, samp, uid0=1000 * (i + 1))
            unfinished = [u for u in prompts if got[u][0] != "finished"
                          or len(got[u][1]) != z["max_new"]]
            if unfinished:
                raise AssertionError(f"remote_router[{name}]: unfinished {unfinished}")
            tokens = {u: got[u][1] for u in prompts}
            on_card = DEVICE == "cuda"  # a CPU rehearsal launches no kernel
            for w, d in per_child.items():
                if on_card and (not d.get("flash_fwd") or not d.get(dec)):
                    raise AssertionError(f"remote_router[{name}]: {w} launched {d}")
            tot = _sum_launches(per_child)
            if on_card and hit > 0 and not tot.get("ctx_attention"):
                raise AssertionError(f"remote_router[{name}]: hit rate {hit} without K3")
            bursts = {w: d["burst_ticks"] for w, d in serve.items()}
            if fuse > 1:
                ticks = sum(bursts.values())
                if ticks <= 0 or (on_card and tot.get(dec, 0) < L * ticks):
                    raise AssertionError(f"remote_router[megastep]: {ticks} burst ticks, "
                                         f"{tot.get(dec)} {dec} launches")
            worst, exact, total = replay_on_cpu(torch, params_cpu, cfg,
                                                {u: prompts[u] for u in ROUTER_REPLAYS},
                                                {u: tokens[u] for u in ROUTER_REPLAYS})
            if worst > ARGMAX_TOL_FRAC:
                raise AssertionError(f"remote_router[{name}]: a pick is off the CPU argmax "
                                     f"by {worst:.4f}")
            n_tok = n_tok_prompt + sum(len(t) for t in tokens.values())
            passes[name] = dict(
                decode_megastep=fuse, wall_s=wall, tokens_per_s=n_tok / wall,
                prefix_hit_rate=hit, router_stats=stats, launches_per_child=per_child,
                burst_ticks=bursts,
                token_match_inprocess_router=token_match(tokens, rt["routed"]) if i == 0 else None,
                argmax_exact=f"{exact}/{total}", argmax_worst_gap_frac=worst)
            for k, v in tot.items():
                launches[k] = launches.get(k, 0) + v
            if fuse == 1:
                compare = compare_routers(torch, params, cfg, r, samp)
        mem = {f"worker{i}": st["memory_allocated"] for i, st in child_stats(r).items()}
        cache = {f"worker{i}": st["reply_cache_bytes"] for i, st in child_stats(r).items()}
        deaths = dict(r.stats)["worker_deaths"]
        audits = r.close()
    finally:
        if audits is None:
            r.close()
        _reap_all(handles)
    if deaths:
        raise AssertionError(f"remote_router: {deaths} worker deaths no fault caused")
    if any(a is None for a in audits):
        raise AssertionError(f"remote_router: a child returned no audit: {audits}")
    _gate_audits("remote_router", audits)
    _gate_reaped("remote_router", handles)
    pipe = pipe_worker_run(torch, params, cfg, router_workload(cfg)[0][1], samp)
    for k, v in pipe.pop("launches").items():
        launches[k] = launches.get(k, 0) + v
    res = dict(phase="remote_router", model=REMOTE_PRESET, workers=2, requests=z["n_req"],
               transport=REMOTE_KNOBS, spawn_s=spawn_s, passes=passes,
               inprocess_router_tokens_per_s=rt["routed_tokens_per_s"],
               compare_inprocess=compare,
               single_engine_tokens_per_s=rt["single_tokens_per_s"],
               child_memory_allocated=mem, reply_cache_bytes=cache, close_audits=audits,
               stdio_worker=pipe, launches=launches, gpu=gpu)
    emit(res)
    return res


_PIPE_CHILD = r'''
import json, sys, torch
from deepspeed_tpu_torch.models.presets import get_preset
from deepspeed_tpu_torch.models.transformer import init_params
from deepspeed_tpu_torch.serving.pool import serve_worker_main
spec = json.loads(sys.argv[1])
dtype = getattr(torch, spec["dtype"])
cfg = get_preset(spec["preset"], max_seq_len=spec["max_seq_len"], dtype=dtype)
params = init_params(cfg, seed=spec["seed"], device=spec["device"], dtype=dtype)
audit = serve_worker_main(params=params, cfg=cfg, sec=spec["sec"], device=spec["device"])
print("DSTPU_STDIO_AUDIT " + json.dumps(audit), file=sys.stderr, flush=True)
'''


def pipe_worker_run(torch, params, cfg, prompt, samp):
    """``serve_worker_main`` in a child over its stdin / stdout pipe: the
    framed handshake, one request (submit, ticks, pop, stats), then EOF.
    Gates: the request finishes, the child exits 0 with a 0-block audit.
    Reported: whether its tokens equal an in-process engine's serving the
    same request alone."""
    import subprocess
    import tempfile

    from deepspeed_tpu_torch.inference.engine_v2 import build_serve_engine
    from deepspeed_tpu_torch.serving import transport as T

    spec = remote_spec(cfg)
    env = dict(os.environ)
    env["PYTHONPATH"] = HERE + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    err = tempfile.TemporaryFile()
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-c", _PIPE_CHILD, json.dumps(spec)], cwd=HERE,
                            env=env, stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=err)
    try:
        stream = T.FrameStream(rfile=proc.stdout, wfile=proc.stdin)
        ident = T.client_handshake(stream, "rpc", timeout=REMOTE_READY_S)
        up_s = time.perf_counter() - t0
        c = T.RpcClient(lambda: (stream, ident))
        reply, _ = c.call({"op": "submit", "uid": 1, "tokens": list(prompt),
                           "sampling": {"max_new_tokens": samp.max_new_tokens}})
        if not reply["ok"] or reply["result"]["reason"] != "queued":
            raise AssertionError(f"stdio worker: submit {reply}")
        for _ in range(4 * samp.max_new_tokens):
            reply, _ = c.call({"op": "tick"})
            if reply["requests"]["1"]["state"] == "finished":
                break
        res, _ = c.call({"op": "pop", "uid": 1})
        stats, _ = c.call({"op": "stats"})
        proc.stdin.close()  # EOF: the child's clean shutdown
        rc = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        err.seek(0)
        tail = err.read().decode(errors="replace")
        err.close()
    lines = [ln for ln in tail.splitlines() if ln.startswith("DSTPU_STDIO_AUDIT ")]
    audit = json.loads(lines[-1].split(" ", 1)[1]) if lines else None
    tokens = res["result"]["tokens"]
    if rc != 0 or audit is None or audit["blocks_in_use"] or \
            res["result"]["state"] != "finished" or len(tokens) != samp.max_new_tokens:
        raise AssertionError(f"stdio worker: rc {rc}, audit {audit}, result {res['result']}, "
                             f"stderr {tail[-2000:]}")
    ref = build_serve_engine(params, cfg, ROUTER_SEC, device=DEVICE)
    want = ref.generate(list(prompt), samp)
    _gate_audits("stdio worker", [ref.close()])
    return dict(up_s=up_s, exit_code=rc, close_audit=audit, tokens_equal_inprocess=tokens == want,
                token_match_inprocess=token_match({1: tokens}, {1: want}),
                memory_allocated=stats["memory_allocated"],
                launches={k: v for k, v in stats["launches"].items() if v})


def remote_handoff_phase(torch, K, gpu, cfg, params_cpu, rh):
    """Prefill/decode disaggregation across processes: 3 children (worker 0
    prefill, telemetry on), ``disagg_threshold`` 160, the 512-token prompt
    in the formats 'none' and 'int8' (``handoff_fmt`` switched on the
    router between runs), after a rehearsal that migrates a cold long
    prompt.  Gates: one handoff a run, ``handoff_wire_bytes`` equal to the
    in-process ``router_handoff`` run of this smoke exactly, the migrated
    stream near-argmax against the CPU.  Reported: the source's extract
    and encode ms, this side's decode and encode, the adopter's decode
    and inject, the wire ms (round trips less the workers' own time), the
    children's launches, the prefill child's reply-cache bytes.  The same
    pool then runs ``remote_fleet`` (returned for it)."""
    import dataclasses

    from deepspeed_tpu_torch.inference.sampling import SamplingParams
    from deepspeed_tpu_torch.serving import build_remote_router

    z = ROUTER_SIZES
    _, long_prompt = router_workload(cfg)
    samp = SamplingParams(temperature=0.0, max_new_tokens=z["max_new"])
    t0 = time.perf_counter()
    r = build_remote_router(remote_spec(cfg, telemetry=True), router=dict(
        n_workers=3, prefill_workers=1, disagg_threshold=ROUTER_DISAGG,
        metrics_pull_interval_ms=25.0, **REMOTE_KNOBS))
    spawn_s = time.perf_counter() - t0
    handles = [w.handle for w in r.pool.workers]
    runs, launches = {}, {}
    try:
        remote_rehearse(r, cfg, samp, n=3, long_len=z["long_len"])
        src = r.pool.workers[0]
        for i, fmt in enumerate(("none", "int8")):
            r.config = dataclasses.replace(r.config, handoff_fmt=fmt)
            for w in r.pool.workers:
                w.last_handoff_ms, w.last_adopt_ms = {}, {}
            uid = 2000 + i
            before, rs0 = child_stats(r), dict(r.stats)
            t0 = time.perf_counter()
            r.submit(uid, long_prompt, samp)
            out = r.run()
            wall = time.perf_counter() - t0
            after = child_stats(r)
            stats = _counter_diff(rs0, dict(r.stats))
            state, tokens = r.pop_result(uid)
            per_child = child_launches(before, after)
            for k, v in _sum_launches(per_child).items():
                launches[k] = launches.get(k, 0) + v
            want = rh["runs"][fmt]["handoff_wire_bytes"]
            if stats["handoffs"] != 1 or stats["handoff_wire_bytes"] != want:
                raise AssertionError(f"remote_handoff[{fmt}]: {stats['handoffs']} handoffs, "
                                     f"{stats['handoff_wire_bytes']} B on the wire, in-process "
                                     f"{want} B")
            if state != "finished" or len(tokens) != z["max_new"]:
                raise AssertionError(f"remote_handoff[{fmt}]: the long request ended {state}")
            worst, exact, total = replay_on_cpu(torch, params_cpu, cfg, {uid: long_prompt},
                                                {uid: tokens})
            if worst > ARGMAX_TOL_FRAC:
                raise AssertionError(f"remote_handoff[{fmt}]: off the CPU argmax by {worst:.4f}")
            ext = src.last_handoff_ms
            adopt = next(w.last_adopt_ms for w in r.pool.workers if w.last_adopt_ms)
            runs[fmt] = dict(
                wall_s=wall, handoff_wire_bytes=stats["handoff_wire_bytes"],
                inprocess_wire_bytes=want, router_stats=stats,
                extract_ms=ext.get("extract"), source_encode_ms=ext.get("encode"),
                router_decode_ms=ext.get("decode"), router_encode_ms=adopt.get("encode"),
                adopter_decode_ms=adopt.get("decode"), inject_ms=adopt.get("inject"),
                extract_rpc_ms=ext.get("rpc"), adopt_rpc_ms=adopt.get("rpc"),
                wire_ms=(ext["rpc"] - ext["extract"] - ext["encode"])
                + (adopt["rpc"] - adopt["decode"] - adopt.get("inject", 0.0)),
                launches_per_child=per_child,
                token_match_inprocess=token_match({1: tokens}, {1: rh["tokens"][fmt]}),
                argmax_exact=f"{exact}/{total}", argmax_worst_gap_frac=worst)
        cache = src.stats()["reply_cache_bytes"]
    except BaseException:
        r.close()
        _reap_all(handles)
        raise
    res = dict(phase="remote_handoff", model=REMOTE_PRESET, workers=3, prefill_workers=1,
               disagg_threshold=ROUTER_DISAGG, long_len=z["long_len"], spawn_s=spawn_s,
               runs=runs, prefill_reply_cache_bytes=cache, launches=launches, gpu=gpu)
    emit(res)
    return res, r


def reply_cache_cap() -> int:
    """The byte cap of a worker's reply cache: ``WorkerServer``'s default,
    which the subprocess workers run with."""
    import inspect

    from deepspeed_tpu_torch.serving.transport import WorkerServer

    return inspect.signature(WorkerServer).parameters["reply_cache_bytes"].default


def remote_fleet_phase(torch, K, gpu, cfg, r):
    """The fleet plane over the handoff phase's 3 children: a collector
    thread pulling every 25 ms over each child's metrics channel, the long
    prompt first, then the 48.  Gates: merged ttft_ms / e2e_ms p50 / p90 /
    p99 equal the pooled per-worker samples, every worker has a heartbeat
    clock offset with its error bound, SLO availability 1.0, no death,
    every audit 0 blocks, every child reaped, every child's reply cache
    within its byte cap.  Reported: the pulls, the offsets, the children's
    reply-cache bytes after the run."""
    import math

    from deepspeed_tpu_torch.inference.sampling import SamplingParams
    from deepspeed_tpu_torch.telemetry import attach_fleet_collector

    z = ROUTER_SIZES
    prompts, long_prompt = router_workload(cfg)
    samp = SamplingParams(temperature=0.0, max_new_tokens=z["max_new"])
    handles = [w.handle for w in r.pool.workers]
    audits = None
    try:
        coll = attach_fleet_collector(r, start=True)
        before, rs0 = child_stats(r), dict(r.stats)
        t0 = time.perf_counter()
        r.submit(3000 + LONG_UID, long_prompt, samp)
        r.tick()
        for u, p in prompts.items():
            if not r.try_submit(3000 + u, p, samp).accepted:
                raise AssertionError(f"remote_fleet: refused uid {u}")
        out = r.run()
        wall = time.perf_counter() - t0
        coll.stop(final_pull=True)
        after = child_stats(r)
        stats = _counter_diff(rs0, dict(r.stats))
        fleet = coll.fleet
        merged = {}
        for metric in ("ttft_ms", "e2e_ms"):
            pooled = sorted(v for st in fleet.histogram_states(metric) for v in st["samples"] or [])
            h = fleet.merged_histogram(metric)
            if h is None or not h.exact or h.count != len(pooled) or not pooled:
                raise AssertionError(f"remote_fleet: {metric} merged {h} vs {len(pooled)} pooled")
            for q in (50, 90, 99):
                truth = pooled[min(len(pooled), max(1, math.ceil(q / 100 * len(pooled)))) - 1]
                if h.percentile(q) != truth:
                    raise AssertionError(f"remote_fleet: {metric} p{q} {h.percentile(q)} != "
                                         f"pooled {truth}")
            merged[metric] = dict(count=h.count, **h.quantiles((50, 90, 99)))
        offsets = {f"worker{w.index}": r.pool.monitor.clock_offset(w.index)
                   for w in r.pool.workers}
        if any(o is None or o[1] is None or o[1] < 0 for o in offsets.values()):
            raise AssertionError(f"remote_fleet: clock offsets {offsets}")
        sig = r.signals()
        unfinished = [u for u, (s, _) in out.items() if s != "finished"]
        if sig["slo"]["availability"] != 1.0 or unfinished:
            raise AssertionError(f"remote_fleet: slo {sig['slo']}, unfinished {unfinished}")
        cache = {f"worker{i}": st["reply_cache_bytes"] for i, st in after.items()}
        cap = reply_cache_cap()
        if any(b > cap for b in cache.values()):
            raise AssertionError(f"remote_fleet: reply caches {cache} over the byte cap {cap}")
        per_child = child_launches(before, after)
        deaths = dict(r.stats)["worker_deaths"]
        audits = r.close()
    finally:
        if audits is None:
            r.close()
        _reap_all(handles)
    if deaths:
        raise AssertionError(f"remote_fleet: {deaths} worker deaths no fault caused")
    if any(a is None for a in audits):
        raise AssertionError(f"remote_fleet: a child returned no audit: {audits}")
    _gate_audits("remote_fleet", audits)
    _gate_reaped("remote_fleet", handles)
    res = dict(phase="remote_fleet", model=REMOTE_PRESET, workers=3, prefill_workers=1,
               requests=z["n_req"] + 1, wall_s=wall, router_stats=stats, merged=merged,
               clock_offsets=offsets, slo=sig["slo"], pulls=sig["fleet"],
               reply_cache_bytes=cache, reply_cache_cap_bytes=cap, close_audits=audits,
               launches=_sum_launches(per_child), launches_per_child=per_child, gpu=gpu)
    emit(res)
    return res


def remote_chaos_phase(torch, K, gpu, cfg, params_cpu, rt, rc_inproc):
    """``bench.py:591-660``'s seeded network storm on 3 children: the rpc
    injector (seed 2: conn_drop p .04 x 6, conn_delay p .05 4 ms x 12,
    partial_write p .05 x 3) and the heartbeat injector (seed 3:
    heartbeat_loss p .03 x 4, a 0.4 s partition of worker 2 after 40
    checks), armed after a fault-free rehearsal; worker 1's process killed
    with a real SIGKILL at router tick 6.  Gates: every request terminal,
    availability >= ``router_chaos``'s of this run, worker_deaths ==
    discovered_deaths == 1, replays > 0, two survivors' audits with 0
    blocks, the killed child reaped, ``REMOTE_REPLAYS`` replayed streams
    near-argmax against the CPU.  Reported: each network point's fired
    count, replay token identity against the in-process router."""
    from deepspeed_tpu_torch.inference.faults import FaultInjector
    from deepspeed_tpu_torch.inference.sampling import SamplingParams
    from deepspeed_tpu_torch.serving import build_remote_router

    z = ROUTER_SIZES
    prompts, _ = router_workload(cfg)
    samp = SamplingParams(temperature=0.0, max_new_tokens=z["max_new"])
    rpc_faults = (FaultInjector(seed=2, enabled=False)
                  .arm("conn_drop", p=0.04, times=6)
                  .arm("conn_delay", p=0.05, delay_s=0.004, times=12)
                  .arm("partial_write", p=0.05, times=3))
    hb_faults = (FaultInjector(seed=3, enabled=False)
                 .arm("heartbeat_loss", p=0.03, times=4)
                 .arm("partition", uids=[2], after=40, times=1, delay_s=0.4))
    r = build_remote_router(remote_spec(cfg), router=dict(
        n_workers=3, max_replays=3, retry_backoff_ms=10.0, **REMOTE_KNOBS),
        faults=rpc_faults, hb_faults=hb_faults)
    handles = [w.handle for w in r.pool.workers]
    audits = None
    try:
        remote_rehearse(r, cfg, samp, n=6)
        before = child_stats(r)
        rpc_faults.enabled = hb_faults.enabled = True
        t0 = time.perf_counter()
        backlog = [u for u, p in prompts.items() if not r.try_submit(u, p, samp).accepted]
        ticks, lost, killed_pid = 0, [], None
        while backlog or not r.idle:
            if ticks == REMOTE_KILL_TICK:
                victim = r.pool.workers[1]
                lost = sorted(u for u, rec in r._reqs.items()
                              if rec.worker == 1 and rec.phase == "submitted")
                killed_pid = victim.handle.pid
                victim.handle.kill_process()  # SIGKILL: no flag, found by lease
            if backlog and r.try_submit(backlog[0], prompts[backlog[0]], samp).accepted:
                backlog.pop(0)
            r.tick()
            ticks += 1
            if ticks > 50_000:
                raise AssertionError("remote_chaos: the storm did not converge")
        storm_s = time.perf_counter() - t0
        after = child_stats(r)
        out = {u: r.pop_result(u) for u in prompts}
        stats = dict(r.stats)
        audits = r.close()
    finally:
        if audits is None:
            r.close()
        _reap_all(handles)
    terminal = ("finished", "failed", "timed_out", "cancelled")
    if any(s not in terminal for s, _ in out.values()):
        raise AssertionError(f"remote_chaos: non-terminal states {out}")
    avail = sum(s == "finished" for s, _ in out.values()) / len(out)
    if avail < rc_inproc["availability"]:
        raise AssertionError(f"remote_chaos: availability {avail} < in-process "
                             f"{rc_inproc['availability']}")
    if stats["worker_deaths"] != 1 or stats["discovered_deaths"] != 1 or stats["replays"] <= 0:
        raise AssertionError(f"remote_chaos: stats {stats}")
    survivors = [a for a in audits if a is not None]
    if len(survivors) != 2:
        raise AssertionError(f"remote_chaos: survivor audits {audits}")
    _gate_audits("remote_chaos", survivors)
    _gate_reaped("remote_chaos", handles)
    replayed = [u for u in lost if out[u][0] == "finished"][:REMOTE_REPLAYS]
    if len(replayed) < min(REMOTE_REPLAYS, len(lost)) or not lost:
        raise AssertionError(f"remote_chaos: lost {lost}, replayed and finished {replayed}")
    worst, exact, total = replay_on_cpu(torch, params_cpu, cfg,
                                        {u: prompts[u] for u in replayed},
                                        {u: out[u][1] for u in replayed})
    if worst > ARGMAX_TOL_FRAC:
        raise AssertionError(f"remote_chaos: a replayed pick is off the CPU argmax by {worst:.4f}")
    per_child = child_launches(before, after)
    res = dict(phase="remote_chaos", model=REMOTE_PRESET, workers=3, requests=z["n_req"],
               transport=REMOTE_KNOBS, kill_tick=REMOTE_KILL_TICK, killed_pid=killed_pid,
               availability=avail, inprocess_router_chaos_availability=rc_inproc["availability"],
               router_stats=stats, router_ticks=ticks, storm_wall_s=storm_s,
               fired={p: inj.fired(p) for inj, ps in (
                   (rpc_faults, ("conn_drop", "conn_delay", "partial_write")),
                   (hb_faults, ("heartbeat_loss", "partition"))) for p in ps},
               lost_on_kill=lost,
               replay_token_match_inprocess_router=token_match(
                   {u: out[u][1] for u in lost if out[u][0] == "finished"}, rt["routed"]),
               argmax_exact=f"{exact}/{total}", argmax_worst_gap_frac=worst,
               close_audits=audits, launches=_sum_launches(per_child),
               launches_per_child=per_child, gpu=gpu)
    emit(res)
    return res


# bench.py:1638-1651 at its accelerator sizes
# spec_serve, adapt_serve, megastep_serve and longctx serve the flagship's
# first 6 of its 24 layers: they are host-bound
# (a tick's eager launches grow with depth), the engine, megastep,
# scheduler and router phases serve all 24, and the compile phases took
# the seconds (the whole smoke's time limit)
SERVE_CUT_LAYERS = 6


def cut_depth(params, cfg, layers):
    """The first ``layers`` (at most all) of a stacked parameter tree
    (views) and its config."""
    layers = min(layers, cfg.num_layers)

    def cut(node):
        return {k: cut(v) if isinstance(v, dict) else v[:layers] for k, v in node.items()}

    return dict(params, layers=cut(params["layers"])), cfg.replace(num_layers=layers)


ADAPT_SIZES = dict(per_phase=12, sys_len=256, sfx_len=32, long_len=448, max_new=32, tail_new=96)
ADAPT_ENGINE = dict(max_seqs=8, num_blocks=256, block_size=32, max_seq_len=704,
                    prefill_buckets=(64, 128, 256), prefill_budget=256, prefill_chunk=128)
ADAPT_CHUNKS = (256, 32)  # chunk_hi, chunk_lo
ADAPT_CONFIG = dict(enabled=True, epoch_s=0.05, min_window=2, guard_epochs=1,
                    regress_tolerance=1.3, cooldown_epochs=1, max_decode_megastep=8,
                    allow_rebuild=False)
ADAPT_REPLAYS = (1, 13, 25, 26)  # one of phases A and B, two of C


def adapt_serve_phase(torch, K, gpu, params, cfg, params_cpu):
    """``bench.py --serving --adapt``'s drift twin at its accelerator sizes
    (``ADAPT_*``: a prefix-heavy, an incompressible and a long-prompt phase
    of 12 requests, Poisson(2) arrivals): a static engine, then an engine
    with ``attach_controller`` stepped every 2 ticks, each after
    rehearsing every shape the controller can reach; then the guard proof
    on the adaptive engine: an injected bad retune (``prefill_chunk`` 32,
    guarded on TTFT p90) rolled back and its knob restored.  Gates: both
    twins finish every request with its length and no leak, the rollback
    fires and restores the chunk, ``ADAPT_REPLAYS`` streams near-argmax.
    Reported: ``serve_adapt_ab_ratio`` (adaptive over static tokens/s),
    serve-loop ticks, the decision log, the twins' token match."""
    import numpy as np

    from deepspeed_tpu_torch.autotuning import attach_controller
    from deepspeed_tpu_torch.config.config import AdaptationConfig, ServeConfig
    from deepspeed_tpu_torch.inference.engine_v2 import InferenceEngineV2
    from deepspeed_tpu_torch.inference.sampling import SamplingParams

    z, ekw = ADAPT_SIZES, ADAPT_ENGINE
    chunk_hi, chunk_lo = ADAPT_CHUNKS
    samp = SamplingParams(temperature=0.0, max_new_tokens=z["max_new"])
    samp_tail = SamplingParams(temperature=0.0, max_new_tokens=z["tail_new"])
    adapt_cfg = AdaptationConfig(**ADAPT_CONFIG)
    rng = np.random.default_rng(1)
    n = 3 * z["per_phase"]
    sys_prompt = rng.integers(1, cfg.vocab_size, z["sys_len"]).tolist()
    prompts = {}
    for i in range(z["per_phase"]):
        prompts[i + 1] = sys_prompt + rng.integers(1, cfg.vocab_size, z["sfx_len"]).tolist()
    for i in range(z["per_phase"]):
        prompts[z["per_phase"] + i + 1] = rng.integers(
            1, cfg.vocab_size, z["sys_len"] + z["sfx_len"]).tolist()
    for i in range(z["per_phase"]):
        prompts[2 * z["per_phase"] + i + 1] = rng.integers(1, cfg.vocab_size,
                                                           z["long_len"]).tolist()
    arrivals = np.cumsum(rng.poisson(2.0, n))

    def rehearse(eng):
        sched, uid = eng.scheduler, 9000
        for chunk, fuse in ((ekw["prefill_chunk"], 1), (chunk_hi, 2), (chunk_hi, 4),
                            (chunk_hi, 8), (chunk_lo, 1)):
            sched.apply_knobs(prefill_chunk=chunk, decode_megastep=fuse)
            batch = []
            for _ in range(ekw["max_seqs"]):
                uid += 1
                batch.append(uid)
                sched.submit(uid, rng.integers(1, cfg.vocab_size, z["long_len"]).tolist(), samp)
            while not sched.idle:
                sched.tick()
            for u in batch:
                sched.pop_result(u)
        sched.apply_knobs(prefill_chunk=ekw["prefill_chunk"], decode_megastep=1)
        sched.tick()
        eng.telemetry.reset_window()

    def run(adaptive):
        eng = InferenceEngineV2(params, cfg, device=DEVICE, enable_prefix_caching=True,
                                telemetry=True, serve=ServeConfig(decode_megastep=1,
                                                                  adaptation=adapt_cfg), **ekw)
        ctl = attach_controller(eng) if adaptive else None
        sched = eng.scheduler
        rehearse(eng)
        before = dict(K.LAUNCHES)
        submitted, ticks = 0, 0
        t0 = time.perf_counter()
        while submitted < n or not sched.idle:
            while submitted < n and arrivals[submitted] <= sched.tick_no:
                submitted += 1
                sched.submit(submitted, prompts[submitted],
                             samp_tail if submitted > 2 * z["per_phase"] else samp)
            sched.tick()
            ticks += 1
            if ctl is not None and sched.tick_no % 2 == 0:
                ctl.step_epoch()
        _sync(torch)
        dt = time.perf_counter() - t0
        launches = {k: v - before[k] for k, v in K.LAUNCHES.items() if v != before[k]}
        results = {u: sched.pop_result(u) for u in range(1, n + 1)}
        short = [u for u in results if len(results[u]) != (
            z["tail_new"] if u > 2 * z["per_phase"] else z["max_new"])]
        if short:
            raise AssertionError(f"adapt_serve: requests cut short {short}")
        toks = sum(len(p) for p in prompts.values()) + sum(len(r) for r in results.values())
        return dict(eng=eng, ctl=ctl, results=results, wall_s=dt, ticks=ticks,
                    tokens_per_s=toks / dt, knobs=sched.knobs(), launches=launches)

    s = run(False)
    _gate_audits("adapt_serve", [s.pop("eng").close()])
    a = run(True)
    eng, ctl = a.pop("eng"), a.pop("ctl")
    sched = eng.scheduler
    applied = [d for d in ctl.decisions if d["outcome"] == "applied"]
    # the guard proof: an injected bad retune must roll back
    eng.telemetry.reset_window()
    uid = [9500]

    def proof_job():
        uid[0] += 1
        sched.submit(uid[0], rng.integers(1, cfg.vocab_size, z["long_len"]).tolist(), samp)
        while not sched.idle:
            sched.tick()
        sched.pop_result(uid[0])

    for _ in range(4):
        proof_job()
    ctl.inject_retune(_metric="ttft_ms_p90", _better="lower", prefill_chunk=chunk_lo)
    n0 = len(ctl.decisions)
    rollback = None
    for _ in range(24):
        proof_job()
        ctl.step_epoch()
        rollback = next((d for d in ctl.decisions[n0:] if d["action"] == "rollback"
                         and "prefill_chunk" in d["knobs"]), None)
        if rollback is not None:
            break
    sched.tick()
    restored = sched.knobs()["prefill_chunk"]
    _gate_audits("adapt_serve", [eng.close()])
    if rollback is None or restored <= chunk_lo:
        raise AssertionError(f"adapt_serve: injected retune rollback {rollback}, chunk "
                             f"{restored}")
    worst, exact, total = replay_on_cpu(torch, params_cpu, cfg,
                                        {u: prompts[u] for u in ADAPT_REPLAYS},
                                        {u: a["results"][u] for u in ADAPT_REPLAYS})
    if worst > ARGMAX_TOL_FRAC:
        raise AssertionError(f"adapt_serve: an adaptive pick is off the CPU argmax by {worst:.4f}")
    launches = dict(s["launches"])
    for k, v in a["launches"].items():
        launches[k] = launches.get(k, 0) + v
    res = dict(phase="adapt_serve", model="llama3_proxy_410m", sizes=z, engine=ekw,
               adaptation=ADAPT_CONFIG, serve_adapt_ab_ratio=a["tokens_per_s"] / s["tokens_per_s"],
               static=dict((k, s[k]) for k in ("wall_s", "ticks", "tokens_per_s", "knobs")),
               adaptive=dict((k, a[k]) for k in ("wall_s", "ticks", "tokens_per_s", "knobs")),
               retunes_applied=len(applied),
               decisions=[{k: d[k] for k in ("epoch", "action", "knobs", "outcome") if k in d}
                          for d in ctl.decisions],
               rollback=dict(metric=rollback["metric"], baseline=rollback["baseline"],
                             current=rollback["current"], prefill_chunk_restored=restored),
               twin_token_match=token_match(a["results"], s["results"]),
               argmax_exact=f"{exact}/{total}", argmax_worst_gap_frac=worst,
               launches=launches, gpu=gpu)
    emit(res)
    return res


def autotune_serve_phase(torch, K, gpu, params, cfg):
    """``autotune_serving`` on the 410M model over the rows the port builds
    (tp 1, serve_replicas 1, quant None / int8, prefill_chunk None / 128,
    decode_megastep 1 / 4, seq_shards 1) plus their serve_replicas 2
    twins, which a 2-device declaration lets past the roofline and the
    engine refuses (ROADMAP item 7): rungs 0.5 / 1.0, the trial
    runner's shared-prefix workload.  Gates: every refused row's verdict
    carries the port's refusal text, no serve_replicas 1 row's verdict is
    an ``error:`` (a kernel fault raises out of the search), the winner is
    rebuilt and serves its workload leak-free.  Reported: the predicted (roofline) order beside
    the measured order, the leaderboard's rows."""
    from deepspeed_tpu_torch.autotuning import (ServeTrialRunner, ServeWorkload,
                                                autotune_serving, leaderboard, serving_space)

    sp = serving_space(tp=(1,), serve_replicas=(1, 2), quant=(None, "int8"),
                       prefill_chunk=(None, 128), kv_watermark=(0.0625,), spec=(False,),
                       quant_comm=("none",), decode_megastep=(1, 4), seq_shards=(1,))
    base = dict(max_seqs=8, num_blocks=96, block_size=32, prefill_buckets=[64, 128, 256],
                enable_prefix_caching=True)
    wl = ServeWorkload()
    K.reset_launches()
    t0 = time.perf_counter()
    w, trials, tuner = autotune_serving(params, cfg, workload=wl, base=base, space=sp,
                                        rungs=(0.5, 1.0), top_k=16, device=DEVICE, n_devices=2)
    search_s = time.perf_counter() - t0
    refused = [t for t in trials if t.candidate["serve_replicas"] == 2]
    text = "serve_engine.serve_replicas=2 is not ported yet (ROADMAP queue 1 item 7)"
    if not refused or any(text not in t.verdict for t in refused):
        raise AssertionError(f"autotune_serve: refused rows {[t.verdict for t in refused]}")
    built = [t for t in trials if t.candidate["serve_replicas"] == 1]
    errors = [t.verdict for t in built if t.verdict.startswith("error:")]
    if errors:
        raise AssertionError(f"autotune_serve: a buildable row failed: {errors}")
    if w is None or w.candidate["serve_replicas"] != 1:
        raise AssertionError(f"autotune_serve: winner {w}")
    score, metrics = ServeTrialRunner(params, cfg, wl, base=base, device=DEVICE)(w.candidate)
    if metrics["finished"] != wl.n_req:
        raise AssertionError(f"autotune_serve: the rebuilt winner finished {metrics}")
    launches = dict(K.LAUNCHES)
    key = lambda t: json.dumps(t.candidate, sort_keys=True)  # noqa: E731
    predicted = [key(t) for t in sorted(built, key=lambda t: (t.predicted_cost, t.index))]
    final = [t for t in built if t.measured]
    measured = [key(t) for t in sorted(final, key=lambda t: (-t.rung, -t.score, t.index))]
    board = leaderboard(trials, {"model": "llama3_proxy_410m"})
    res = dict(phase="autotune_serve", model="llama3_proxy_410m", rows=len(trials),
               refused_rows=len(refused), refusal=text, search_s=search_s,
               winner=w.candidate, winner_score=w.score, rebuilt_winner_score=score,
               predicted_order=predicted, measured_order=measured,
               leaderboard=[{k: row[k] for k in ("candidate", "predicted_cost", "verdict",
                                                 "score", "rung")} for row in board["trials"]],
               launches=launches, gpu=gpu)
    emit(res)
    return res


# ---------------------------------------------------------------------------
# megastep: device-resident decode bursts (step_n, the scheduler's megastep)
# ---------------------------------------------------------------------------
GREEDY = (0.0, 0, 1.0)  # the greedy sampling triple, a burst graph's key
BURST_REPLAYS = (1, 2, 3, 64)  # the uids of the streams replayed on the CPU


def burst_profile(torch, eng, samp, n):
    """One ``step_n(n)`` burst (its graph captured already) under the
    profiler: wall and device ms per tick, idle share, host-to-device and
    device-to-host copies in the burst, and the top device rows."""
    copies = {}
    wall_ms, dev_ms, rows = _device_profile(torch, lambda: eng.step_n(n, samp), top=8,
                                            htod=copies)
    return dict(ticks=n, wall_ms_per_tick=wall_ms / n,
                device_ms_per_tick=None if dev_ms is None else dev_ms / n,
                idle_share=None if dev_ms is None else 1.0 - dev_ms / wall_ms,
                htod_copies_per_burst=copies["copies"], dtoh_copies_per_burst=copies["dtoh"],
                top=rows)


def burst_graph_launches(eng):
    """The launches recorded in the engine's greedy burst graph (one tick)."""
    return dict(eng._burst.graphs[GREEDY].launches)


def burst_engine_phase(torch, K, gpu, params, cfg, tick_streams, model, phase, n):
    """``bench.py:1071-1110``'s engine cell with the burst: batch 64, 2,048
    blocks of 32, 64 prompts of 128 through ``put`` (the engine phase's
    prompts), 8 per-tick ``step``s, then ``step_n(n)``, every tick of it a
    replay of the greedy tick's graph (captured by the warm-up's
    ``step_n(2)``); then a profiled ``step_n(16)``.  Gates: one burst of
    ``n`` ticks, the decode kernel layers x ``n`` times (layers per
    replay), ``BURST_REPLAYS`` streams near-argmax against the port on the
    CPU in fp32, 0 blocks in use after ``close()``.  The token match with
    the engine phase's per-tick streams (``tick_streams``) is reported,
    not gated (bf16 near-ties)."""
    import numpy as np
    from deepspeed_tpu_torch.inference.engine_v2 import InferenceEngineV2
    from deepspeed_tpu_torch.inference.sampling import SamplingParams

    B, prompt_len, per_tick = 64, 128, 8
    eng = InferenceEngineV2(params, cfg, max_seqs=B, num_blocks=2048, block_size=32,
                            prefill_budget=2048)
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(1, cfg.vocab_size, prompt_len).tolist() for _ in range(B)]
    samp = SamplingParams(temperature=0.0, max_new_tokens=per_tick + n + 8)
    # warm-up (bench.py:1089-1096): a full pack, a tick and a burst, which
    # captures the greedy tick, on throwaway uids
    warm = list(range(10_001, 10_017))
    eng.put(warm, [prompts[0]] * len(warm), samp)
    eng.step(samp)
    eng.step_n(2, samp)
    eng.flush(warm)
    torch.cuda.synchronize()
    uids = list(range(1, B + 1))
    first = eng.put(uids, prompts, samp)
    gen = {u: [first[u]] for u in uids}
    tick_ms = []
    for _ in range(per_tick):
        t0 = time.perf_counter()
        out = eng.step(samp)  # fetches the sampled tokens: synced
        tick_ms.append(1e3 * (time.perf_counter() - t0))
        for u, tok in out.items():
            gen[u].append(tok)
    stats0 = dict(eng.stats)
    K.reset_launches()
    t0 = time.perf_counter()
    eng.step_n(n, samp)  # ends in its one fetch: synced
    burst_ms = 1e3 * (time.perf_counter() - t0)
    launches = dict(K.LAUNCHES)
    d = {k: eng.stats[k] - stats0[k] for k in eng.stats}
    for u in uids:
        gen[u] += eng.mgr.seqs[u].tokens[prompt_len + 1 + per_tick:]
    L, dec = cfg.num_layers, decode_kernel(cfg)
    per_replay = burst_graph_launches(eng)
    if d["decode_bursts"] != 1 or d["burst_ticks"] != n or d["decode_ticks"]:
        raise AssertionError(f"{phase}: stats {d} are not one burst of {n} ticks")
    if per_replay.get(dec) != L or launches[dec] != L * n:
        raise AssertionError(f"{phase}: {dec} launched {launches[dec]} in the burst, "
                             f"{per_replay} a replay; want {L} x {n}")
    if any(len(g) != 1 + per_tick + n or min(g) < 0 for g in gen.values()):
        raise AssertionError(f"{phase}: a stream did not emit {n} burst tokens")
    prof = burst_profile(torch, eng, samp, 16)
    if eng.close()["blocks_in_use"]:
        raise AssertionError(f"{phase}: blocks leaked after close()")
    worst, exact, total = replay_on_cpu(torch, _tree_cpu(params), cfg,
                                        {u: prompts[u - 1] for u in BURST_REPLAYS},
                                        {u: gen[u] for u in BURST_REPLAYS})
    if worst > ARGMAX_TOL_FRAC:
        raise AssertionError(f"{phase}: a card pick is off the CPU argmax by {worst:.4f} of the "
                             f"logit range > {ARGMAX_TOL_FRAC}")
    both = [(a, b) for u in uids for a, b in zip(gen[u], tick_streams[u])]
    med, dev = _median(tick_ms), prof["device_ms_per_tick"]
    res = dict(phase=phase, model=model, layers=L, batch=B, prompt_len=prompt_len,
               per_tick_steps=per_tick, burst_ticks=n, burst_wall_ms=burst_ms,
               burst_ms_per_tick=burst_ms / n, burst_ms_per_token=burst_ms / n / B,
               tick_ms_median=med, tick_ms_per_token=med / B,
               burst_tokens_per_s=B * n * 1e3 / burst_ms, tick_tokens_per_s=B * 1e3 / med,
               host_syncs_per_token={"burst": 1 / (n * B), "per_tick": 1 / B},
               # the profiled burst's device time over the timed burst's wall
               burst_idle_share=None if dev is None else 1.0 - dev / (burst_ms / n),
               burst_profile=prof, launches=launches, launches_per_replay=per_replay,
               stats=d, argmax_replayed_streams=len(BURST_REPLAYS),
               argmax_exact=f"{exact}/{total}", argmax_worst_gap_frac=worst,
               per_tick_token_match=f"{sum(a == b for a, b in both)}/{len(both)}", gpu=gpu)
    emit(res)
    return res


def burst_stops_phase(torch, K, gpu, params, cfg):
    """Stop-exactness of a burst on the card (410M, bf16): four rows, one
    burst of 16 greedy ticks, each row's own end mid-burst: row 1 its stop
    token (the 4th token of a free run), row 2 an emission cap of 5, row 3
    ``max_seq_len`` (its 150-token prompt leaves 9 ticks), row 4 none.
    Against a free burst of the same rows: each run ends exactly there
    (nothing past a stop), the descriptors' lengths and block lists and the
    engine's block-table rows agree, and nothing leaks."""
    import numpy as np
    from deepspeed_tpu_torch.inference.engine_v2 import InferenceEngineV2
    from deepspeed_tpu_torch.inference.sampling import SamplingParams

    n, bs = 16, 32
    rng = np.random.default_rng(SEED + 2)
    prompts = {u: rng.integers(1, cfg.vocab_size, ln).tolist()
               for u, ln in ((1, 40), (2, 40), (3, 150), (4, 40))}
    samp = SamplingParams(temperature=0.0)

    def burst(**kw):
        eng = InferenceEngineV2(params, cfg, max_seqs=4, num_blocks=64, block_size=bs,
                                max_seq_len=160, prefill_buckets=(64, 160),
                                prefill_budget=160)
        eng.put(list(prompts), list(prompts.values()), samp)
        seqs = [eng.mgr.seqs[u] for u in prompts]
        runs = eng._decode_burst(seqs, samp, n, **kw)
        for s in seqs:
            want_blocks = -(-s.cur_len // bs)
            row = eng._tables_np[s.slot]
            if (s.cur_len != len(prompts[s.uid]) + 1 + len(runs[s.uid])
                    or len(s.blocks) != want_blocks or list(row[:want_blocks]) != s.blocks
                    or (row[want_blocks:] != -1).any()):
                raise AssertionError(f"burst_stops: uid {s.uid}: length {s.cur_len}, blocks "
                                     f"{s.blocks}, table row {row.tolist()} for run "
                                     f"{runs[s.uid]}")
        eng.flush(list(prompts))
        audit = eng.close()
        if audit["blocks_in_use"]:
            raise AssertionError(f"burst_stops: leaked blocks {audit}")
        return runs

    free = burst()
    stop = free[1][3]
    runs = burst(stop_tokens={1: stop}, max_emit={2: 5})
    want = {1: free[1][:free[1].index(stop) + 1], 2: free[2][:5], 3: free[3], 4: free[4]}
    if runs != want or len(free[3]) != 160 - 151 or len(free[4]) != n:
        raise AssertionError(f"burst_stops: runs {runs} != {want} (free {free})")
    res = dict(phase="megastep_stops", model="llama3_proxy_410m", burst_ticks=n,
               run_lengths={u: len(r) for u, r in runs.items()},
               free_run_lengths={u: len(r) for u, r in free.items()}, stop_token=stop,
               exact=True, gpu=gpu)
    emit(res)
    return res


# bench.py:1319-1330, `bench.py --serving --megastep`'s TPU branch, uncut
MEGASTEP_ENGINE = dict(max_seqs=8, num_blocks=256, block_size=32, max_seq_len=704,
                       prefill_buckets=(64, 128, 256), prefill_budget=256, prefill_chunk=256,
                       enable_prefix_caching=True)
MEGASTEP_SIZES = dict(n_req=16, sys_len=512, sfx_len=64, max_new=48)
MEGASTEP_FUSE = 8


def megastep_run(torch, K, params, cfg, fuse):
    """One fresh engine through the megastep workload (``bench.py:1343-
    1372``: a shared 512-token system prompt + a 64-token suffix, Poisson(2)
    arrivals in ticks, ``default_rng(0)``) after a one-request rehearsal
    (captures the burst graph).  Returns the results, wall s, counter
    deltas, launches, the host ms of each decode-only tick and of each
    decode tick in it (a burst's ms over its ticks), and the close audit."""
    import numpy as np
    from deepspeed_tpu_torch.inference.engine_v2 import InferenceEngineV2
    from deepspeed_tpu_torch.inference.sampling import SamplingParams

    sz = MEGASTEP_SIZES
    rng = np.random.default_rng(SEED)
    sys_prompt = rng.integers(1, cfg.vocab_size, sz["sys_len"]).tolist()
    prompts = {u: sys_prompt + rng.integers(1, cfg.vocab_size, sz["sfx_len"]).tolist()
               for u in range(1, sz["n_req"] + 1)}
    arrivals = np.cumsum(rng.poisson(2.0, sz["n_req"]))
    eng = InferenceEngineV2(params, cfg, serve={"decode_megastep": fuse}, **MEGASTEP_ENGINE)
    sched = eng.scheduler
    samp = SamplingParams(temperature=0.0, max_new_tokens=sz["max_new"])
    warm = np.random.default_rng(SEED + 3).integers(1, cfg.vocab_size, 64).tolist()
    sched.submit(100_000, warm, SamplingParams(temperature=0.0, max_new_tokens=12))
    sched.run()
    sched.pop_result(100_000)
    torch.cuda.synchronize()
    stats0 = dict(eng.stats)
    tick_ms, per_decode_tick_ms = [], []
    submitted, t0 = 0, time.perf_counter()
    K.reset_launches()
    while submitted < sz["n_req"] or not sched.idle:
        while submitted < sz["n_req"] and arrivals[submitted] <= sched.tick_no:
            submitted += 1
            sched.submit(submitted, prompts[submitted], samp)
        before = dict(eng.stats)
        t = time.perf_counter()
        sched.tick()  # a decoding tick ends in its one fetch: synced
        ms = 1e3 * (time.perf_counter() - t)
        ticks = (eng.stats["decode_ticks"] - before["decode_ticks"]
                 + eng.stats["burst_ticks"] - before["burst_ticks"])
        if ticks and eng.stats["prefill_dispatches"] == before["prefill_dispatches"]:
            tick_ms.append(ms)
            per_decode_tick_ms += [ms / ticks] * ticks
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    results = {u: sched.pop_result(u) for u in prompts}
    d = {k: eng.stats[k] - stats0[k] for k in eng.stats}
    audit = eng.close()
    return dict(prompts=prompts, results=results, wall=wall, d=d, launches=launches,
                tick_ms=tick_ms, per_decode_tick_ms=per_decode_tick_ms, close=audit,
                total_tokens=sum(len(p) for p in prompts.values())
                + sum(len(r) for r in results.values()))


def megastep_serve_phase(torch, K, gpu, params, cfg):
    """``bench.py --serving --megastep`` on the card (TPU branch, uncut):
    ``decode_megastep`` 1 and 8 on fresh engines, in turns (1, 8, 8, 1).
    Gates: every run finishes 16/16 requests with 48 tokens and leaks no
    block; the fused runs burst, the per-tick runs never; the decode kernel
    launched layers x (decode ticks + burst ticks), the prefill kernels
    layers x dispatches.  Reports effective tokens/s, the p50 host ms of a
    decode-only scheduler tick and of a decode tick within it, host syncs
    per token (decode ticks + bursts over emitted tokens, ``bench.py:1378-
    1381``) and the token match of the two settings (not gated: bf16
    near-ties, and the two settings pack their prefills differently); 4
    streams of the first fused run near-argmax against the CPU in fp32."""
    L, sz = cfg.num_layers, MEGASTEP_SIZES
    runs = []
    for fuse in (1, MEGASTEP_FUSE, MEGASTEP_FUSE, 1):
        r = megastep_run(torch, K, params, cfg, fuse)
        d, lc = r["d"], r["launches"]
        bad = [u for u, t in r["results"].items() if len(t) != sz["max_new"]]
        if bad or r["close"]["blocks_in_use"]:
            raise AssertionError(f"megastep_serve x{fuse}: unfinished {bad}, close {r['close']}")
        if (d["decode_bursts"] > 0) != (fuse > 1):
            raise AssertionError(f"megastep_serve x{fuse}: {d['decode_bursts']} bursts")
        if lc["paged_decode"] != L * (d["decode_ticks"] + d["burst_ticks"]):
            raise AssertionError(f"megastep_serve x{fuse}: paged_decode {lc['paged_decode']} != "
                                 f"{L} x {d['decode_ticks']} + {d['burst_ticks']} ticks")
        if lc["flash_fwd"] + lc["ctx_attention"] != L * d["prefill_dispatches"]:
            raise AssertionError(f"megastep_serve x{fuse}: prefill launches {lc}")
        runs.append((fuse, r))

    def summary(fuse, r):
        d = r["d"]
        syncs = d["decode_ticks"] + d["spec_ticks"] + d["decode_bursts"]
        return dict(decode_megastep=fuse, wall_s=r["wall"],
                    effective_tokens_per_s=r["total_tokens"] / r["wall"],
                    decode_only_tick_ms_p50=_median(r["tick_ms"]),
                    decode_tick_ms_p50=_median(r["per_decode_tick_ms"]),
                    host_syncs_per_token=syncs / max(1, d["decode_emitted"]
                                                     + d["burst_emitted"]),
                    decode_ticks=d["decode_ticks"], bursts=d["decode_bursts"],
                    burst_ticks=d["burst_ticks"], prefill_dispatches=d["prefill_dispatches"])

    tick_run = runs[0][1]["results"]
    fused = runs[1][1]
    match = [a == b for u in tick_run for a, b in zip(tick_run[u], fused["results"][u])]
    uids = sorted(fused["prompts"])[:4]
    worst, exact, total = replay_on_cpu(torch, _tree_cpu(params), cfg,
                                        {u: fused["prompts"][u] for u in uids},
                                        {u: fused["results"][u] for u in uids})
    if worst > ARGMAX_TOL_FRAC:
        raise AssertionError(f"megastep_serve: a fused pick is off the CPU argmax by "
                             f"{worst:.4f} of the logit range > {ARGMAX_TOL_FRAC}")
    res = dict(phase="megastep_serve", model="llama3_proxy_410m", layers=L, **sz,
               engine={k: (list(v) if isinstance(v, tuple) else v)
                       for k, v in MEGASTEP_ENGINE.items()},
               runs=[summary(f, r) for f, r in runs],
               token_match=f"{sum(match)}/{len(match)}", argmax_replayed_streams=len(uids),
               argmax_exact=f"{exact}/{total}", argmax_worst_gap_frac=worst,
               launches=fused["launches"], gpu=gpu)
    emit(res)
    return res


# ---------------------------------------------------------------------------
# speculative serving: spec_serve (410M) and gpt2_serve (gpt2_small)
# ---------------------------------------------------------------------------
# the workload of `bench.py --serving --spec` (bench.py:1036-1045,
# _spec_serve_section): a random base of 96 tokens + an 8-token pattern
# repeated to 64, 64 new greedy tokens, through the scheduler
SPEC_SIZES = dict(n_req=16, base_len=96, rep_len=64, max_new=64)
SPEC_ENGINE = dict(max_seqs=8, num_blocks=96, block_size=32, max_seq_len=512,
                   prefill_buckets=(64, 128, 256), prefill_budget=256, prefill_chunk=256,
                   enable_prefix_caching=True, spec_max_draft=4)
SPEC_REPLAYS = 4  # streams replayed on the CPU in fp32 (near-argmax)


def spec_workload(cfg, rng):
    """(pattern, {uid: prompt}) of the repetitive-suffix workload."""
    pattern = rng.integers(1, cfg.vocab_size, 8).tolist()
    n, base, rep = SPEC_SIZES["n_req"], SPEC_SIZES["base_len"], SPEC_SIZES["rep_len"]
    return pattern, {u: rng.integers(1, cfg.vocab_size, base).tolist() + pattern * (rep // 8)
                     for u in range(1, n + 1)}


def _median(xs):
    return sorted(xs)[len(xs) // 2] if xs else None


def decode_tick_profile(torch, eng, pattern, samp, n=3):
    """``n`` decode steps of ``max_seqs`` sequences whose whole history is
    re-paved to the pattern before each step (so, speculating, every one
    drafts a full draft: a verify tick at full width), under the profiler
    after one warm-up step: wall and device ms a tick, idle share,
    host-to-device copies a tick and the top device rows."""
    uids = list(range(20_001, 20_001 + eng.mgr.max_seqs))
    eng.put(uids, [pattern * 3] * len(uids), samp)
    seqs = [eng.mgr.seqs[u] for u in uids]

    def step():
        for s in seqs:
            s.tokens[:] = [pattern[j % len(pattern)] for j in range(len(s.tokens))]
            s.spec_draft_len, s.spec_cooldown = -1, 0
        eng.step(samp)

    step()
    htod = {}
    wall_ms, dev_ms, rows = _device_profile(torch, step, n=n, top=8, htod=htod)
    eng.flush(uids)
    return dict(batch=len(uids), wall_ms=wall_ms, device_ms=dev_ms,
                idle_share=None if dev_ms is None else 1.0 - dev_ms / wall_ms,
                htod_copies=htod["copies"], top=rows)


def spec_run(torch, K, params, cfg, speculate, rng, pattern, prompts, profile=True):
    """One engine through the workload, with ``bench.py:199-221``'s
    rehearsal outside the timed window (the same structure with fresh bases,
    then, speculating, one forced draft tick).  Returns a dict: the results,
    wall seconds, the engine / scheduler counter deltas, the leak check, the
    timed window's launches, the median host ms of its ticks by kind (a
    tick with a verify dispatch, one with a plain decode dispatch, neither
    with a prefill) and, with ``profile``, a profiled full-width tick."""
    from deepspeed_tpu_torch.inference.engine_v2 import InferenceEngineV2
    from deepspeed_tpu_torch.inference.sampling import SamplingParams

    eng = InferenceEngineV2(params, cfg, enable_speculation=speculate, **SPEC_ENGINE)
    sched = eng.scheduler
    samp = SamplingParams(temperature=0.0, max_new_tokens=SPEC_SIZES["max_new"])
    for u, p in prompts.items():
        sched.submit(10_000 + u, rng.integers(1, cfg.vocab_size, SPEC_SIZES["base_len"]).tolist()
                     + p[SPEC_SIZES["base_len"]:], samp)
    sched.run()
    if speculate:  # repave put()'s sampled token so the tick drafts
        eng.put([10_002], [pattern * 3])
        s = eng.mgr.seqs[10_002]
        s.tokens[-1] = s.tokens[-1 - len(pattern)]
        eng.step(samp)
        eng.flush([10_002])
    torch.cuda.synchronize()
    stats0, sched0 = dict(eng.stats), dict(sched.stats)
    ticks = {"verify": [], "plain_decode": []}
    tick = sched.tick

    def timed_tick():  # host clock: every tick ends in a host read
        before = dict(eng.stats)
        t = time.perf_counter()
        out = tick()
        ms = 1e3 * (time.perf_counter() - t)
        if eng.stats["prefill_dispatches"] == before["prefill_dispatches"]:
            if eng.stats["spec_ticks"] > before["spec_ticks"]:
                ticks["verify"].append(ms)
            elif eng.stats["decode_ticks"] > before["decode_ticks"]:
                ticks["plain_decode"].append(ms)
        return out

    sched.tick = timed_tick
    K.reset_launches()
    t0 = time.perf_counter()
    for u, p in prompts.items():
        sched.submit(u, p, samp)
    res = sched.run(wait_for=list(prompts))
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    sched.tick = tick
    alloc = eng.mgr.allocator
    alloc.audit()
    in_use = sum(1 for b in range(alloc.total_blocks) if alloc.refcount(b) > 0)
    leak_ok = in_use == 0 and alloc.free_blocks + alloc.cached_blocks == alloc.total_blocks
    d = {k: eng.stats[k] - stats0[k] for k in eng.stats}
    sd = {k: sched.stats[k] - sched0[k] for k in sched.stats}
    done = all(sched.requests[u].state == "finished" for u in prompts)
    tick_ms = {k: dict(ticks=len(v), median_ms=_median(v)) for k, v in ticks.items()}
    prof = decode_tick_profile(torch, eng, pattern, samp) if profile else None
    eng.close()
    return dict(res=res, wall=wall, d=d, sd=sd, ok=leak_ok and done, launches=launches,
                tick_ms=tick_ms, profile=prof)


def spec_phase(torch, K, gpu, params, cfg, model, phase, twin=True):
    """The repetitive-suffix workload with speculation on; with ``twin``,
    on fresh engines in the order off, on, on, off (the two settings
    compared within one call, in turns).  Raises on a failed leak check, no
    verify tick or no accepted draft, fewer packed-context launches than
    layers x verify ticks, a decode-kernel count off layers x plain decode
    ticks, or a replayed stream off the CPU's near-argmax; the first spec
    run is the main path's.  In bf16, spec on and off may split at
    near-ties (``bench.py:1046``): their token match is reported, not
    gated."""
    import numpy as np

    rng = np.random.default_rng(SEED)
    pattern, prompts = spec_workload(cfg, rng)
    L = cfg.num_layers
    runs = []
    for on in (False, True, True, False) if twin else (True,):
        # only the first run of each setting is profiled
        first = all(o != on for o, _ in runs)
        runs.append((on, spec_run(torch, K, params, cfg, on, rng, pattern, prompts,
                                  profile=first)))
    if not all(r["ok"] for _, r in runs):
        raise AssertionError(f"{phase}: allocator leak check failed or a request did not finish")
    spec = next(r for on, r in runs if on)
    res, d, launches = spec["res"], spec["d"], spec["launches"]
    if d["spec_ticks"] == 0 or d["spec_accepted"] == 0:
        raise AssertionError(f"{phase}: no verify tick or no accepted draft: {d}")
    if launches["ctx_attention"] < L * d["spec_ticks"]:
        raise AssertionError(f"{phase}: ctx_attention launched {launches['ctx_attention']} < "
                             f"{L} x {d['spec_ticks']} verify ticks")
    dec = decode_kernel(cfg)
    if launches[dec] != L * d["decode_ticks"]:
        raise AssertionError(f"{phase}: {dec} launched {launches[dec]} != {L} x "
                             f"{d['decode_ticks']} decode ticks")
    uids = sorted(prompts)[:SPEC_REPLAYS]
    worst, exact, total = replay_on_cpu(torch, _tree_cpu(params), cfg,
                                        {u: prompts[u] for u in uids},
                                        {u: res[u] for u in uids})
    if worst > ARGMAX_TOL_FRAC:
        raise AssertionError(f"{phase}: a card pick is off the CPU argmax by {worst:.4f} of the "
                             f"logit range > {ARGMAX_TOL_FRAC}")
    prompt_tokens = sum(len(p) for p in prompts.values())
    gen_tokens = sum(len(r) for r in res.values())
    seq_forwards = d["spec_seq_forwards"] + d["decode_emitted"]
    walls = {on: [r["wall"] for o, r in runs if o == on] for on in (True, False)}
    out = dict(
        phase=phase, model=model, layers=L, head_dim=cfg.hd, **SPEC_SIZES,
        engine={k: (list(v) if isinstance(v, tuple) else v) for k, v in SPEC_ENGINE.items()},
        accept_rate=d["spec_accepted"] / max(1, d["spec_drafted"]),
        drafted=d["spec_drafted"], accepted=d["spec_accepted"],
        emitted_tokens_per_target_forward=(d["spec_emitted"] + d["decode_emitted"])
        / max(1, seq_forwards),
        verify_ticks=d["spec_ticks"], plain_decode_ticks=d["decode_ticks"],
        preemptions=spec["sd"]["preemptions"],
        drafts_shed=spec["sd"]["drafts_shed"] + d["spec_drafts_shed"],
        run_order=["on" if on else "off" for on, _ in runs], spec_wall_s=walls[True],
        spec_tokens_per_s=(prompt_tokens + gen_tokens) * len(walls[True]) / sum(walls[True]),
        spec_generated_tokens_per_s=gen_tokens * len(walls[True]) / sum(walls[True]),
        tick_ms=[r["tick_ms"] for on, r in runs if on], verify_tick_profile=spec["profile"],
        allocator_leak_check="pass", argmax_replayed_streams=len(uids),
        argmax_exact=f"{exact}/{total}", argmax_worst_gap_frac=worst,
        launches=launches,
        launches_per_verify_tick={"ctx_attention": launches["ctx_attention"] / d["spec_ticks"]},
        gpu=gpu)
    if twin:  # every run emits the same number of tokens (no stop token)
        plain = next(r for on, r in runs if not on)
        same = sum(a == b for u in prompts for a, b in zip(res[u], plain["res"][u]))
        out.update(plain_wall_s=walls[False],
                   plain_tokens_per_s=(prompt_tokens + gen_tokens) * len(walls[False])
                   / sum(walls[False]),
                   plain_generated_tokens_per_s=gen_tokens * len(walls[False]) / sum(walls[False]),
                   spec_vs_plain_speedup=sum(walls[False]) / sum(walls[True]),
                   spec_vs_plain_token_match=same / gen_tokens,
                   plain_preemptions=plain["sd"]["preemptions"],
                   plain_tick_ms=[r["tick_ms"] for on, r in runs if not on],
                   plain_decode_tick_profile=plain["profile"])
    emit(out)
    return out


def gpt2_serve_phase(torch, K, gpu):
    """``gpt2_small`` at full depth (12 layers, hd 64, MHA), bf16, random
    weights from the seed: the engine phase's shape (K1f and K2 at hd 64
    launched 12 x packs and 12 x ticks, a one-tick profile, near-argmax
    replay), its burst (``step_n(16)``: K2 at hd 64 12 times a replayed
    tick, near-argmax replay), then the repetitive-suffix workload through
    the scheduler with speculation on."""
    from deepspeed_tpu_torch.models.presets import get_preset
    from deepspeed_tpu_torch.models.transformer import init_params

    cfg = get_preset("gpt2_small")
    params = init_params(cfg, seed=SEED, device=DEVICE)
    eng = engine_phase(torch, K, gpu, params, cfg, model="gpt2_small", phase="gpt2_serve")
    burst = burst_engine_phase(torch, K, gpu, params, cfg, eng["streams"], "gpt2_small",
                               "gpt2_serve_megastep", n=16)
    spec = spec_phase(torch, K, gpu, params, cfg, "gpt2_small", "gpt2_serve_spec", twin=False)
    del params
    _free(torch)
    return eng, burst, spec


# ---------------------------------------------------------------------------
# seq-sharded long-context serving: longctx_check (2 layers, against the CPU)
# and longctx (`bench.py --serving --longctx`, the TPU branch, uncut)
# ---------------------------------------------------------------------------
# bench.py:1466-1476: aggregate 96 blocks x 32 = 3072 tokens, one slice of
# the two holds 1536; the long prompt (56 blocks) fits the aggregate only
LONGCTX_ENGINE = dict(max_seqs=4, block_size=32, max_seq_len=2048,
                      prefill_buckets=(64, 128, 256, 512, 1024, 2048), prefill_budget=2048,
                      prefill_chunk=256, enable_prefix_caching=True)
LONGCTX_SIZES = dict(n_req=8, sys_len=256, sfx_len=64, max_new=32)
LONGCTX_BLOCKS, LONGCTX_SHARDS, LONGCTX_LONG = 96, 2, 1792


def longctx_workload(cfg, n_req, sys_len, sfx_len):
    """``bench.py:1495-1503``: a shared system prompt + a random suffix per
    request, and Poisson(2) arrival gaps in ticks, from ``default_rng(0)``."""
    import numpy as np

    rng = np.random.default_rng(SEED)
    sys_prompt = rng.integers(1, cfg.vocab_size, sys_len).tolist()
    prompts = {u: sys_prompt + rng.integers(1, cfg.vocab_size, sfx_len).tolist()
               for u in range(1, n_req + 1)}
    return prompts, np.cumsum(rng.poisson(2.0, n_req)).tolist()


def seq_engine(params, cfg, shards, num_blocks):
    """The long-context engine: ``shards`` seq shards of the pool on the
    card (one device repeated), or a single pool at ``shards`` 1."""
    from deepspeed_tpu_torch.inference.engine_v2 import InferenceEngineV2
    from deepspeed_tpu_torch.parallel.topology import initialize_mesh

    grid = initialize_mesh(devices=[DEVICE] * shards, seq=shards) if shards > 1 else None
    return InferenceEngineV2(params, cfg, grid=grid, seq_shards=shards, num_blocks=num_blocks,
                             device=DEVICE, **LONGCTX_ENGINE)


def check_seq_launches(phase, launches, L, S, d):
    """Layers x S partial launches per decode tick and per context pack
    (``d``: the engine's counter deltas), none of the non-partial decode
    and context kernels; at S = 1 the reverse.  Returns (decode ticks,
    context packs)."""
    cold = launches["flash_fwd"] // L
    ctx_packs = d["prefill_dispatches"] - cold
    ticks = d["decode_ticks"]
    dec, ctx = (("paged_decode_partial", "ctx_attention_partial") if S > 1
                else ("paged_decode", "ctx_attention"))
    other = (("paged_decode", "ctx_attention") if S > 1
             else ("paged_decode_partial", "ctx_attention_partial"))
    if launches["flash_fwd"] != L * cold or cold == 0:
        raise AssertionError(f"{phase}: flash_fwd launches {launches['flash_fwd']} != {L} x "
                             f"cold packs")
    if launches[dec] != L * S * ticks or ticks == 0:
        raise AssertionError(f"{phase} S={S}: {dec} launched {launches[dec]} != {L} x {S} x "
                             f"{ticks} decode ticks")
    if launches[ctx] != L * S * ctx_packs or ctx_packs == 0:
        raise AssertionError(f"{phase} S={S}: {ctx} launched {launches[ctx]} != {L} x {S} x "
                             f"{ctx_packs} context packs")
    if any(launches[n] for n in other):
        raise AssertionError(f"{phase} S={S}: {other} launched: {launches}")
    return ticks, ctx_packs


def serve_tick_profile(torch, eng, prompts, samp, n=3):
    """``n`` decode ticks of ``max_seqs`` fresh sequences under the
    profiler, after one warm-up tick: wall and device ms a tick, idle
    share, the top device rows."""
    uids = list(range(30_001, 30_001 + eng.mgr.max_seqs))
    eng.put(uids, [prompts[u] for u in sorted(prompts)[:len(uids)]], samp)
    eng.step(samp)
    wall_ms, dev_ms, rows = _device_profile(torch, lambda: eng.step(samp), n=n, top=8)
    eng.flush(uids)
    return dict(batch=len(uids), wall_ms=wall_ms, device_ms=dev_ms,
                idle_share=None if dev_ms is None else 1.0 - dev_ms / wall_ms, top=rows)


def longctx_run(torch, K, params, cfg, shards, num_blocks, prompts, arrivals, max_new,
                profile=False):
    """One engine through the arrival workload (``bench.py:1505-1520``):
    request i is submitted once the scheduler's tick count reaches
    ``arrivals[i]``.  Returns the results, wall seconds, the engine counter
    deltas, the run's launches, the host ms of each tick that decoded with
    no prefill, and (``profile``) a profiled decode tick."""
    from deepspeed_tpu_torch.inference.sampling import SamplingParams

    eng = seq_engine(params, cfg, shards, num_blocks)
    sched = eng.scheduler
    samp = SamplingParams(temperature=0.0, max_new_tokens=max_new)
    uids = sorted(prompts)
    stats0 = dict(eng.stats)
    tick_ms = []
    submitted = 0
    K.reset_launches()
    t0 = time.perf_counter()
    while submitted < len(uids) or not sched.idle:
        while submitted < len(uids) and arrivals[submitted] <= sched.tick_no:
            sched.submit(uids[submitted], prompts[uids[submitted]], samp)
            submitted += 1
        before = dict(eng.stats)
        t = time.perf_counter()
        sched.tick()  # a decoding tick reads its sampled tokens: synced
        ms = 1e3 * (time.perf_counter() - t)
        if (eng.stats["prefill_dispatches"] == before["prefill_dispatches"]
                and eng.stats["decode_ticks"] > before["decode_ticks"]):
            tick_ms.append(ms)
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    results = {u: sched.pop_result(u) for u in uids}
    bad = [u for u, r in results.items() if len(r) != max_new or min(r) < 0]
    if bad:
        raise AssertionError(f"longctx S={shards}: requests {bad} did not finish with "
                             f"{max_new} tokens")
    d = {k: eng.stats[k] - stats0[k] for k in eng.stats}
    prof = serve_tick_profile(torch, eng, prompts, samp) if profile else None
    audit = eng.close()
    if audit["blocks_in_use"] != 0:
        raise AssertionError(f"longctx S={shards}: leaked blocks {audit}")
    total = sum(len(p) for p in prompts.values()) + sum(len(r) for r in results.values())
    return dict(results=results, wall=wall, d=d, launches=launches, tick_ms=tick_ms,
                tokens_per_s=total / wall, profile=prof, close=audit)


def longctx_burst(torch, K, params, params_cpu, cfg, S, prompts, n=8):
    """The ``longctx_check`` prompts through ``put`` on a fresh S-shard
    engine, then one ``step_n(n)`` burst: the decode partial kernel
    launched layers x S times per tick (first tick eager, the rest replays
    of the captured graph, with the merge), K2 never; every stream
    near-argmax against the port on the CPU in fp32 on one pool."""
    from deepspeed_tpu_torch.inference.sampling import SamplingParams

    eng = seq_engine(params, cfg, S, LONGCTX_BLOCKS)
    samp = SamplingParams(temperature=0.0)
    uids = sorted(prompts)
    first = eng.put(uids, [prompts[u] for u in uids], samp)
    K.reset_launches()
    eng.step_n(n, samp)
    launches = dict(K.LAUNCHES)
    per_replay = burst_graph_launches(eng)
    L = cfg.num_layers
    gen = {u: [first[u]] + eng.mgr.seqs[u].tokens[len(prompts[u]) + 1:] for u in uids}
    if (launches["paged_decode_partial"] != L * S * n or launches["paged_decode"]
            or per_replay.get("paged_decode_partial") != L * S
            or any(len(g) != n + 1 for g in gen.values())):
        raise AssertionError(f"longctx_check S={S}: burst launches {launches}, per replay "
                             f"{per_replay}, runs {[len(g) for g in gen.values()]}")
    if eng.close()["blocks_in_use"]:
        raise AssertionError(f"longctx_check S={S}: the burst leaked blocks")
    worst, exact, total = replay_on_cpu(torch, params_cpu, cfg, prompts, gen)
    if worst > ARGMAX_TOL_FRAC:
        raise AssertionError(f"longctx_check S={S}: a burst pick is off the CPU argmax by "
                             f"{worst:.4f} of the logit range > {ARGMAX_TOL_FRAC}")
    return dict(burst_ticks=n, launches_per_replay=per_replay, argmax_exact=f"{exact}/{total}",
                argmax_worst_gap_frac=worst, launches=launches)


def longctx_check_phase(torch, K, gpu, cfg):
    """``llama3_proxy_410m`` at full width with 2 layers, bf16, random
    weights from the seed, at ``seq_shards`` 2 and 4 on the card: three
    streams of the shared-prefix workload and one 1,100-token prompt
    (chunked prefill over a striped context), 8 greedy tokens each; every
    stream replayed through the port on the CPU in fp32 on one pool
    (near-argmax).  The partial kernels must launch layers x S times per
    decode tick and per context pack, the non-partial ones never.  Then the
    same prompts through ``put`` and one burst at each S
    (``longctx_burst``)."""
    import numpy as np
    from deepspeed_tpu_torch.models.transformer import init_params

    cfg2 = cfg.replace(num_layers=2)
    params = init_params(cfg2, seed=SEED, device=DEVICE)
    prompts, arrivals = longctx_workload(cfg2, 3, LONGCTX_SIZES["sys_len"],
                                         LONGCTX_SIZES["sfx_len"])
    prompts[4] = np.random.default_rng(SEED + 1).integers(1, cfg2.vocab_size, 1100).tolist()
    arrivals.append(arrivals[-1] + 1)
    params_cpu = _tree_cpu(params)
    out = dict(phase="longctx_check", model="llama3_proxy_410m", layers=2,
               prompt_lens=[len(p) for p in prompts.values()], max_new_tokens=8,
               num_blocks=LONGCTX_BLOCKS, engine=dict(LONGCTX_ENGINE), runs={}, gpu=gpu)
    out["engine"]["prefill_buckets"] = list(LONGCTX_ENGINE["prefill_buckets"])
    launches = {n: 0 for n in K.LAUNCHES}
    for S in (2, 4):
        run = longctx_run(torch, K, params, cfg2, S, LONGCTX_BLOCKS, prompts, arrivals, 8)
        ticks, packs = check_seq_launches("longctx_check", run["launches"], 2, S, run["d"])
        worst, exact, total = replay_on_cpu(torch, params_cpu, cfg2, prompts, run["results"])
        if worst > ARGMAX_TOL_FRAC:
            raise AssertionError(f"longctx_check S={S}: a card pick is off the CPU argmax by "
                                 f"{worst:.4f} of the logit range > {ARGMAX_TOL_FRAC}")
        burst = longctx_burst(torch, K, params, params_cpu, cfg2, S, prompts)
        for n, c in (*run["launches"].items(), *burst.pop("launches").items()):
            launches[n] += c
        out["runs"][f"S{S}"] = dict(decode_ticks=ticks, context_packs=packs,
                                    launches={n: c for n, c in run["launches"].items() if c},
                                    argmax_exact=f"{exact}/{total}",
                                    argmax_worst_gap_frac=worst, burst=burst)
    out["launches"] = launches
    emit(out)
    del params, params_cpu
    _free(torch)
    return out


def longctx_phase(torch, K, gpu, params, cfg):
    """The workload of ``bench.py --serving --longctx`` (TPU branch, uncut):
    the S = 2 engine and its single-pool twin (same 96 blocks) in turns,
    S2, single, single, S2, on fresh engines; then the over-one-pool
    contract: the single-slice twin (48 blocks) rejects the 1,792-token
    prompt with ``pool_impossible`` at budget 48, and the S = 2 engine
    serves it to 32 tokens with no leaked block.  The first S = 2 run and
    the long prompt are the main path's; their launches must be layers x 2
    per decode tick and per context pack."""
    import numpy as np
    from deepspeed_tpu_torch.inference.sampling import SamplingParams
    from deepspeed_tpu_torch.inference.scheduler import REJECT_POOL_IMPOSSIBLE

    L, S = cfg.num_layers, LONGCTX_SHARDS
    prompts, arrivals = longctx_workload(cfg, LONGCTX_SIZES["n_req"], LONGCTX_SIZES["sys_len"],
                                         LONGCTX_SIZES["sfx_len"])
    max_new = LONGCTX_SIZES["max_new"]
    runs = []
    for shards in (S, 1, 1, S):
        first = all(sh != shards for sh, _ in runs)
        runs.append((shards, longctx_run(torch, K, params, cfg, shards, LONGCTX_BLOCKS, prompts,
                                         arrivals, max_new, profile=first)))
    per = {}
    for shards in (S, 1):
        mine = [r for sh, r in runs if sh == shards]
        ticks, packs = check_seq_launches("longctx", mine[0]["launches"], L, shards,
                                          mine[0]["d"])
        dec = "paged_decode_partial" if shards > 1 else "paged_decode"
        ctx = "ctx_attention_partial" if shards > 1 else "ctx_attention"
        per[shards] = dict(
            tokens_per_s=[r["tokens_per_s"] for r in mine],
            wall_s=[r["wall"] for r in mine],
            decode_tick_ms_p50=[_median(r["tick_ms"]) for r in mine],
            decode_ticks_timed=[len(r["tick_ms"]) for r in mine],
            decode_ticks=ticks, context_packs=packs,
            launches_per_forward={dec: mine[0]["launches"][dec] / ticks,
                                  ctx: mine[0]["launches"][ctx] / packs},
            tick_profile=mine[0]["profile"])
    s2 = next(r for sh, r in runs if sh == S)
    one = next(r for sh, r in runs if sh == 1)
    gen = sum(len(r) for r in s2["results"].values())
    match = sum(a == b for u in prompts for a, b in zip(s2["results"][u], one["results"][u]))

    # the over-one-pool contract
    samp = SamplingParams(temperature=0.0, max_new_tokens=max_new)
    long_prompt = np.random.default_rng(SEED + 1).integers(1, cfg.vocab_size,
                                                           LONGCTX_LONG).tolist()
    small = seq_engine(params, cfg, 1, LONGCTX_BLOCKS // S)
    verdict = small.scheduler.try_submit(1, long_prompt, samp)
    small.close()
    if (verdict.accepted or verdict.reason != REJECT_POOL_IMPOSSIBLE
            or verdict.budget_blocks != LONGCTX_BLOCKS // S
            or verdict.budget_scope != "replica_pool"):
        raise AssertionError(f"longctx: the single-slice twin did not reject the long prompt "
                             f"as expected: {verdict}")
    eng = seq_engine(params, cfg, S, LONGCTX_BLOCKS)
    sched = eng.scheduler
    res = sched.try_submit(1, long_prompt, samp)
    if not res.accepted:
        raise AssertionError(f"longctx: the S = {S} engine refused the long prompt: {res}")
    stats0 = dict(eng.stats)
    K.reset_launches()
    t0 = time.perf_counter()
    sched.run(wait_for=[1])
    long_s = time.perf_counter() - t0
    long_launches = dict(K.LAUNCHES)
    req = sched.requests[1]
    long_out = sched.pop_result(1)
    if req.state != "finished" or len(long_out) != max_new or min(long_out) < 0:
        raise AssertionError(f"longctx: the long prompt ended {req.state} ({req.error}) with "
                             f"{len(long_out)} tokens")
    d = {k: eng.stats[k] - stats0[k] for k in eng.stats}
    long_ticks, long_packs = check_seq_launches("longctx long prompt", long_launches, L, S, d)
    audit = eng.close()
    if audit["blocks_in_use"] != 0:
        raise AssertionError(f"longctx: the long prompt leaked blocks: {audit}")

    launches = {n: s2["launches"][n] + long_launches[n] for n in K.LAUNCHES}
    out = dict(
        phase="longctx", model="llama3_proxy_410m", layers=L, seq_shards=S,
        **LONGCTX_SIZES, num_blocks=LONGCTX_BLOCKS, run_order=[sh for sh, _ in runs],
        engine={k: (list(v) if isinstance(v, tuple) else v) for k, v in LONGCTX_ENGINE.items()},
        seq_sharded=per[S], single_pool=per[1],
        seq_sharded_vs_single_pool_speed=sum(per[1]["wall_s"]) / sum(per[S]["wall_s"]),
        twin_token_match=match / gen,
        over_one_pool=dict(prompt_len=LONGCTX_LONG, blocks=-(-(LONGCTX_LONG + max_new) // 32),
                           single_slice=dict(reason=verdict.reason,
                                             budget_blocks=verdict.budget_blocks,
                                             budget_scope=verdict.budget_scope),
                           served_tokens=len(long_out), wall_s=long_s, decode_ticks=long_ticks,
                           context_packs=long_packs, close=audit),
        launches=launches,
        launches_per_forward=per[S]["launches_per_forward"], gpu=gpu)
    emit(out)
    return out


# ---------------------------------------------------------------------------
# phases 5-6: training
# ---------------------------------------------------------------------------
def bench_config(micro, gas, sparse=None):
    """The training flagship's engine config (``bench.py:58-68``); with a
    ``sparse_attention`` section ``sparse``, that layout and FusedAdam (the
    block-sparse slice's path)."""
    conf = {
        "train_micro_batch_size_per_gpu": micro,
        "gradient_accumulation_steps": gas,
        "optimizer": {"type": "adamw", "params": {"lr": 1e-4, "weight_decay": 0.1}},
        "zero_optimization": {"stage": 3, "param_persistence_threshold": 0},
        "bf16": {"enabled": True},
        "steps_per_print": 1000000,
    }
    if sparse is not None:
        conf["optimizer"] = {"type": "FusedAdam", "params": {"lr": 1e-4, "weight_decay": 0.1}}
        conf["sparse_attention"] = dict(sparse)
    return conf


ATTN_KERNELS = {False: ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"),
                True: ("sparse_fwd", "sparse_bwd_dq", "sparse_bwd_dkv")}


def check_train_launches(phase, launches, layers, gas, steps, sparse):
    """Per step: the path's three attention kernels layers x GAS times, the
    other path's never, K8 once."""
    want = {n: layers * gas * steps for n in ATTN_KERNELS[sparse]}
    want.update({n: 0 for n in ATTN_KERNELS[not sparse]})
    want["fused_adamw"] = steps
    bad = {n: (launches[n], w) for n, w in want.items() if launches[n] != w}
    if bad:
        raise AssertionError(f"{phase}: launches (got, expected) {bad} in {steps} steps")


def _loss_and_attn_grads(torch, engine, micro):
    """(loss, gradients) of one micro-batch's loss (``micro``: name -> [b,
    s + 1] array, or any batch key the model takes) w.r.t. layer 0's
    attention weights (fp32 masters, through the engine's compute-type
    cast)."""
    from deepspeed_tpu_torch.runtime.precision import cast_floating

    names = ("wq", "wk", "wv", "wo")
    attn = engine.params["layers"]["attn"]
    cp = cast_floating(engine.params, engine.compute_dtype)
    loss = engine.model.loss_fn(cp, {k: torch.as_tensor(v).to(engine.device)
                                     for k, v in micro.items()})
    grads = torch.autograd.grad(loss, [attn[n] for n in names])
    return float(loss.detach()), {n: g[0].float().cpu().flatten() for n, g in zip(names, grads)}


def _attn_grads(torch, engine, micro):
    """``_loss_and_attn_grads``' gradients."""
    return _loss_and_attn_grads(torch, engine, micro)[1]


def grad_cosines(torch, got, ref):
    """{name: cosine similarity of got[name] and ref[name]}, in fp64: a
    float32 reduction over a 4096 x 4096 gradient errs by about 0.5 %, and
    reads above 1."""
    return {n: float(torch.nn.functional.cosine_similarity(got[n].double(), ref[n].double(),
                                                           dim=0)) for n in got}


TRAIN_CHECK = dict(seq=512, micro=2, gas=2, steps=2)


def train_check_reference(torch, sparse=None):
    """train_check's CPU half, which launches no kernel (``main`` runs it
    while the kernels build): the port on the CPU in fp32 from the seeded
    2-layer tree, layer 0's attention gradients of micro-batch 0 and the
    losses of TRAIN_CHECK's steps, with the inputs both engines take."""
    import numpy as np
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.models.presets import get_preset
    from deepspeed_tpu_torch.models.transformer import CausalLM, init_params

    z = TRAIN_CHECK
    cfg = get_preset("llama3_proxy_410m", num_layers=2, loss_chunk_size=2048)
    params = init_params(cfg, seed=SEED, device="cpu", dtype=torch.float32)
    batch = {"input_ids": np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (z["gas"], z["micro"], z["seq"] + 1), dtype=np.int64)}
    conf = bench_config(z["micro"], z["gas"], sparse)
    cpu, _, _, _ = initialize(model=CausalLM(cfg.replace(dtype=torch.float32)), params=params,
                              config={**conf, "bf16": {"enabled": False}}, device="cpu")
    grads = _attn_grads(torch, cpu, {"input_ids": batch["input_ids"][0]})
    losses = [float(cpu.train_batch(batch)) for _ in range(z["steps"])]
    return dict(cfg=cfg, params=params, batch=batch, conf=conf, sparse=sparse, grads=grads,
                losses=losses)


def train_check_phase(torch, K, gpu, ref):
    """Phase 5 (``train_check``), or with the reference of a
    ``sparse_attention`` section the same check of the block-sparse path
    (``sparse_train_check``): the card (bf16) against ``ref``, the CPU
    half of ``train_check_reference``."""
    import numpy as np
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.models.transformer import CausalLM

    z, cfg, sparse, batch = TRAIN_CHECK, ref["cfg"], ref["sparse"], ref["batch"]
    card, _, _, _ = initialize(model=CausalLM(cfg), params=ref["params"], config=ref["conf"])
    g_card = _attn_grads(torch, card, {"input_ids": batch["input_ids"][0]})
    cos = grad_cosines(torch, g_card, ref["grads"])
    K.reset_launches()
    card_losses = [float(card.train_batch(batch)) for _ in range(z["steps"])]
    launches = dict(K.LAUNCHES)
    cpu_losses = ref["losses"]
    phase = "sparse_train_check" if sparse else "train_check"
    check_train_launches(phase, launches, cfg.num_layers, z["gas"], z["steps"],
                         sparse is not None)
    rel = abs(card_losses[0] - cpu_losses[0]) / abs(cpu_losses[0])
    if not all(np.isfinite(card_losses)) or rel > TRAIN_LOSS_RTOL:
        raise AssertionError(f"{phase}: step-1 loss card {card_losses[0]} vs CPU "
                             f"{cpu_losses[0]} (rel {rel} > {TRAIN_LOSS_RTOL})")
    bad = {n: c for n, c in cos.items() if not c > GRAD_COS_MIN}
    if bad:
        raise AssertionError(f"{phase}: gradient cosine similarity {bad} <= {GRAD_COS_MIN}")
    res = dict(phase=phase, model="llama3_proxy_410m", layers=cfg.num_layers,
               seq=z["seq"], micro_batch=z["micro"], gas=z["gas"], steps=z["steps"],
               sparse_attention=sparse, optimizer=ref["conf"]["optimizer"]["type"],
               card_losses=card_losses, cpu_losses=cpu_losses, step1_loss_rel_err=rel,
               grad_cosine_layer0=cos, launches=launches, gpu=gpu)
    emit(res)
    return res


def _device_profile(torch, fn, n=1, top=10, htod=None):
    """(wall ms per call, device ms per call or None, the ``top`` device
    rows, all of them for None) of ``n`` calls of ``fn`` under
    ``torch.profiler`` (device-side rows only: an operator's row repeats
    its kernels' time).  ``htod``, a dict, receives the host-to-device
    copies per call under ``"copies"`` and the device-to-host ones under
    ``"dtoh"``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / n
    evs = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    if htod is not None:
        htod["copies"] = sum(e.count for e in evs if "HtoD" in e.key) / n
        htod["dtoh"] = sum(e.count for e in evs if "DtoH" in e.key) / n
    dev_ms = sum(e.self_device_time_total for e in evs) / 1e3 / n if evs else None
    evs = sorted(evs, key=lambda e: -e.self_device_time_total)[:top]
    rows = [dict(name=e.key[:60], ms_per_call=e.self_device_time_total / 1e3 / n,
                 calls=e.count / n) for e in evs]
    return wall_ms, dev_ms, rows


def train_phase(torch, K, gpu, sparse=None, steps=TRAIN_STEPS):
    """Phase 6: the flagship (``train``), or with a ``sparse_attention``
    section ``sparse`` its block-sparse variant (``sparse_train``)."""
    import itertools

    import numpy as np
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.models.presets import get_preset
    from deepspeed_tpu_torch.models.transformer import CausalLM

    micro, seq, gas = 8, 4096, 2
    model = CausalLM(get_preset("llama3_proxy_410m", loss_chunk_size=2048))
    torch.cuda.reset_peak_memory_stats()
    conf = bench_config(micro, gas, sparse)
    engine, _, _, _ = initialize(model=model, config=conf)
    cfg = model.cfg
    batch = {"input_ids": np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (gas, micro, seq + 1), dtype=np.int64)}
    t0 = time.perf_counter()
    first = float(engine.train_batch(batch))  # warm-up (cuBLAS handles, allocator)
    warm_s = time.perf_counter() - t0
    K.reset_launches()
    step_s, losses = [], []
    t0 = t_prev = time.perf_counter()
    for loss in engine.train_on_loader(itertools.repeat(batch, steps)):
        torch.cuda.synchronize()
        t = time.perf_counter()
        step_s.append(t - t_prev)
        t_prev = t
        losses.append(loss)
    last = engine.get_last_loss()
    loop_s = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    phase = "sparse_train" if sparse else "train"
    check_train_launches(phase, launches, cfg.num_layers, gas, steps, sparse is not None)
    if not (np.isfinite(first) and np.isfinite(last) and last < first):
        raise AssertionError(f"{phase}: loss not finite and falling: first {first}, last {last}")
    peak = torch.cuda.max_memory_allocated()
    htod = {}
    wall_ms, dev_ms, rows = _device_profile(torch, lambda: engine.train_batch(batch), top=None,
                                            htod=htod)
    # the step's attention kernels (K1 on the dense path, K7 on the sparse
    # one: the same three bodies) by kind, and their share of device time
    attn = {}
    for r in rows:
        m = re.search(r"flash_(?:fwd|bwd_dq|bwd_dkv)_kernel", r["name"])
        if m:
            attn[m.group(0)] = attn.get(m.group(0), 0.0) + r["ms_per_call"]
    if htod["copies"] > len(batch):  # the batch's arrays; tables and scalars stay on the card
        raise AssertionError(f"{phase}: {htod['copies']} host-to-device copies in a step, "
                             f"expected at most {len(batch)} (the batch)")
    med = sorted(step_s)[len(step_s) // 2]
    tokens = gas * micro * seq
    res = dict(phase=phase, model="llama3_proxy_410m", layers=cfg.num_layers, seq=seq,
               micro_batch=micro, gas=gas, remat=cfg.remat, loss_chunk_size=cfg.loss_chunk_size,
               optimizer=conf["optimizer"]["type"], sparse_attention=sparse,
               params=model.param_count, warmup_step_s=warm_s, timed_steps=steps,
               step_s=step_s, step_s_median=med, loop_s_per_step=loop_s / steps,
               tokens_per_step=tokens, tokens_per_s=tokens / med,
               loss_first=first, loss_last=last, peak_memory_bytes=peak,
               train_batch_losses=[first] + [float(x) for x in losses],
               launches=launches, launches_per_step={n: launches[n] / steps
                                                     for n in launches},
               profile_step_wall_ms=wall_ms, profile_step_device_ms=dev_ms,
               device_idle_share=None if dev_ms is None else 1.0 - dev_ms / wall_ms,
               profile_htod_copies=htod["copies"], profile_top=rows[:10],
               attention_ms=attn,
               attention_share=None if dev_ms is None else sum(attn.values()) / dev_ms, gpu=gpu)
    if sparse is None:  # MFU counts dense attention: the dense flagship only
        flops_tok = model.flops_per_token(seq)
        res.update(flops_per_token=flops_tok,
                   mfu=tokens / med * flops_tok / PEAK_BF16_FLOPS)
    else:
        layout, block = sparse_layout(sparse, seq)
        res.update(active_blocks=int(np.tril(layout).sum()),
                   causal_blocks=layout.shape[0] * (layout.shape[0] + 1) // 2)
    emit(res)
    if sparse is None:
        res["fused_adamw_timing"] = adam_timing(torch, engine)
    del engine
    return res


# ---------------------------------------------------------------------------
# resumable training (checkpoint/, the data loader) and the HF round trip
# ---------------------------------------------------------------------------
CKPT_PRESET = "llama3_proxy_410m"  # CPU rehearsals: "tiny"
# 4 of the flagship's 24 layers: the resume gates (losses to the bit, state
# byte-equal) hold at any depth, and the deeper saves cost the smoke's time
# limit (24 layers about 20 s more than 12, which the model-shaping phases
# then pushed past 1,100 s; 8 until the compile phases came)
CKPT_SIZES = dict(seq=4096, micro=8, gas=2, rows=64, layers=4)
CKPT_DISK_MARGIN = 1.25  # free disk wanted over two checkpoints' bytes
HF_SERVE = dict(prompts=4, prompt_len=64, new=16)


class TokenRows:
    """``rows`` token rows of ``seq + 1`` ids from the seed: the training
    data ``initialize(training_data=...)`` takes."""

    def __init__(self, vocab, rows, seq, seed=SEED):
        import numpy as np

        self.x = np.random.default_rng(seed).integers(0, vocab, (rows, seq + 1), dtype=np.int64)

    def __len__(self):
        return len(self.x)

    def __getitem__(self, i):
        return {"input_ids": self.x[i]}


def _ckpt_engine(async_save=False):
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.models.presets import get_preset
    from deepspeed_tpu_torch.models.transformer import CausalLM

    z = CKPT_SIZES
    over = dict(loss_chunk_size=2048, num_layers=z["layers"]) \
        if CKPT_PRESET == "llama3_proxy_410m" else \
        dict(max_seq_len=z["seq"] + 1)
    model = CausalLM(get_preset(CKPT_PRESET, **over))
    conf = bench_config(z["micro"], z["gas"])
    conf["train_data"] = {"prefetch_depth": 2}
    conf["checkpoint"] = {"async_save": async_save}
    engine, _, loader, _ = initialize(model=model, config=conf, device=DEVICE,
                                      training_data=TokenRows(model.cfg.vocab_size, z["rows"],
                                                              z["seq"]))
    return engine, loader


def _state_snapshot(torch, engine):
    """A device copy of every leaf of the training state, with the step
    counters, the LR scheduler's state and the loader's position (under a
    live ``train_on_loader``, that of the oldest batch not consumed)."""
    from deepspeed_tpu_torch.checkpoint.saving import train_state

    leaves = {k: v.detach().clone() for k, v in train_state(engine).items()}
    pf = engine._active_prefetcher
    pos = pf.resume_state() if pf is not None else engine.training_dataloader.state_dict()
    return leaves, (engine.global_steps, engine.skipped_steps,
                    engine.lr_scheduler.state_dict(), pos)


def _same_bytes(torch, a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


def _byte_diff(torch, a, b):
    """Names of the leaves whose bytes differ (and the counters, if they do)."""
    bad = [k for k in a[0] if not _same_bytes(torch, a[0][k], b[0][k])]
    if a[1] != b[1]:
        bad.append(f"counters {a[1]} != {b[1]}")
    return bad


def _dir_bytes(path):
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs)


def checkpoint_phase(torch, K, gpu):
    """Resumable training on the training flagship through
    ``initialize(training_data=...)`` at prefetch depth 2: run A takes 3
    steps; run B takes 1 and saves mid-``train_on_loader`` (batches parked
    in the prefetcher); run C loads into a fresh engine and takes 2.  Gates:
    C's state after the load byte-equal to B's at the save (masters,
    moments, counters, LR, sampler position), C's losses equal to A's 2nd
    and 3rd to the bit, K1f / K1b / K8 per step as the train phase's.  Then
    the same with ``checkpoint.async_save``: the ``train_batch`` after the
    save starts before the write ends, ``latest`` moves only at the commit,
    and the resume holds the same gates.  Numbers: bytes, save / load /
    sha256 seconds, free disk."""
    import shutil
    import tempfile

    from deepspeed_tpu_torch.checkpoint import saving

    z = CKPT_SIZES
    root = tempfile.mkdtemp(prefix="dst_ckpt_")
    try:
        free = shutil.disk_usage(root).free
        a, loader = _ckpt_engine()
        want = [float(x) for x in a.train_on_loader(loader, num_steps=3)]
        n_state = sum(v.numel() * v.element_size()
                      for v in saving.train_state(a).values())
        del a, loader
        _free(torch)
        if free < CKPT_DISK_MARGIN * 2 * n_state:
            raise AssertionError(f"checkpoint: {free} B free under {root}, two checkpoints "
                                 f"take {2 * n_state} B")
        runs = {}
        for mode in ("sync", "async"):
            b, loader = _ckpt_engine(async_save=mode == "async")
            gen = b.train_on_loader(loader)
            got = [float(next(gen))]
            parked = b._active_prefetcher.qsize()
            t0 = time.perf_counter()
            b.save_checkpoint(root, tag=mode)
            save_s = time.perf_counter() - t0
            at_save = _state_snapshot(torch, b)
            res = dict(save_s=save_s, parked_batches=parked)
            if mode == "async":
                ce = b._ckpt_engine
                latest_before = saving.get_latest_tag(root)
                t_next = time.perf_counter()
                b_second = float(next(gen))  # the step after the save
                if not (ce.pending and (ce.write_done_at is None or t_next < ce.write_done_at)):
                    raise AssertionError("checkpoint: the train_batch after the async save "
                                         "did not start before the write ended")
                if saving.get_latest_tag(root) != latest_before:
                    raise AssertionError("checkpoint: latest moved before the async commit")
                b.wait_pending_checkpoint()
                res.update(blocking_s=save_s, commit_s=time.perf_counter() - t0,
                           write_s=ce.write_done_at - t0,
                           b_second_loss_equal=b_second == want[1])
            gen.close()
            if saving.get_latest_tag(root) != mode:
                raise AssertionError(f"checkpoint: latest is {saving.get_latest_tag(root)}, "
                                     f"not {mode}")
            t0 = time.perf_counter()
            err = saving.verify_tag(root, mode)
            res["sha256_s"] = time.perf_counter() - t0
            if err is not None:
                raise AssertionError(f"checkpoint: {mode} does not verify: {err}")
            res["bytes_written"] = _dir_bytes(os.path.join(root, mode))
            del b, gen, loader
            _free(torch)
            c, loader = _ckpt_engine(async_save=mode == "async")
            t0 = time.perf_counter()
            path, _ = c.load_checkpoint(root)
            torch.cuda.synchronize() if DEVICE == "cuda" else None
            res["load_s"] = time.perf_counter() - t0
            if not path.endswith(mode):
                raise AssertionError(f"checkpoint: loaded {path}, not {mode}")
            bad = _byte_diff(torch, _state_snapshot(torch, c), at_save)
            if bad:
                raise AssertionError(f"checkpoint {mode}: state after load differs from the "
                                     f"save in {bad[:6]}")
            del at_save
            K.reset_launches()
            got += [float(x) for x in c.train_on_loader(loader, num_steps=2)]
            launches = dict(K.LAUNCHES)
            if DEVICE == "cuda":
                check_train_launches(f"checkpoint {mode}", launches, c.model.cfg.num_layers,
                                     z["gas"], 2, False)
            if got != want:
                # the twin: where the resumed run leaves the uninterrupted one
                first = next(i for i, (x, y) in enumerate(zip(got, want)) if x != y)
                raise AssertionError(f"checkpoint {mode}: losses {got} != uninterrupted "
                                     f"{want}; first divergence at step {first + 1}")
            res.update(losses=got, launches={n: v for n, v in launches.items() if v},
                       launches_per_step={n: v / 2 for n, v in launches.items() if v})
            runs[mode] = res
            del c, loader
            _free(torch)
        out = dict(phase="checkpoint", model=CKPT_PRESET, seq=z["seq"], micro_batch=z["micro"],
                   gas=z["gas"], prefetch_depth=2, free_disk_bytes=free,
                   state_bytes=n_state, uninterrupted_losses=want, runs=runs,
                   launches={n: sum(r["launches"].get(n, 0) for r in runs.values())
                             for n in K.LAUNCHES
                             if any(r["launches"].get(n) for r in runs.values())}, gpu=gpu)
        emit(out)
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)


class HostPeak:
    """Peak resident-set growth of this process while the block runs,
    sampled every millisecond from ``/proc/self/statm``."""

    def __enter__(self):
        import threading

        self.page = os.sysconf("SC_PAGE_SIZE")
        self.base = self.peak = self._rss()
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()
        return self

    def _rss(self):
        with open("/proc/self/statm") as fh:
            return int(fh.read().split()[1]) * self.page

    def _run(self):
        while not self._stop.is_set():
            self.peak = max(self.peak, self._rss())
            time.sleep(0.001)

    def __exit__(self, *exc):
        self._stop.set()
        self._t.join()
        self.peak = max(self.peak, self._rss())
        self.growth = self.peak - self.base
        return False


def _serve_greedy(eng, prompts, samp):
    first = eng.put(list(range(1, len(prompts) + 1)), prompts, samp)
    out = {u: [t] for u, t in first.items()}
    for _ in range(samp.max_new_tokens - 1):
        for u, t in eng.step(samp).items():
            out[u].append(t)
    return out


def hf_roundtrip_phase(torch, K, gpu):
    """``export_hf_checkpoint`` of the 410M model's bf16 parameters (fp32
    safetensors), ``initialize(model=<dir>)`` (masters equal to the
    parameters in fp32) and ``load_hf_checkpoint`` in bf16, streamed onto
    the card (leaves bitwise equal to the originals; host peak against the
    tree's bytes); greedy serving of 4 prompts x 16 tokens from the
    imported tree token-identical to the original's, K1f / K2 launches read
    as the serving phases read them."""
    import shutil
    import tempfile

    import numpy as np
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.checkpoint.hf_import import (export_hf_checkpoint,
                                                          load_hf_checkpoint)
    from deepspeed_tpu_torch.inference.engine_v2 import InferenceEngineV2
    from deepspeed_tpu_torch.inference.sampling import SamplingParams
    from deepspeed_tpu_torch.models.presets import get_preset
    from deepspeed_tpu_torch.models.transformer import init_params

    def flat(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, prefix + k + "/") if isinstance(v, dict) else {prefix + k: v})
        return out

    cfg = get_preset(CKPT_PRESET)
    params = init_params(cfg, seed=SEED, device=DEVICE)
    tree_bytes = sum(v.numel() * v.element_size() for v in flat(params).values())
    root = tempfile.mkdtemp(prefix="dst_hf_")
    try:
        t0 = time.perf_counter()
        file_bytes = export_hf_checkpoint(params, cfg, root)
        export_s = time.perf_counter() - t0
        engine, _, _, _ = initialize(model=root, config=bench_config(1, 1), device=DEVICE)
        masters = flat(engine.params)
        bad = [k for k, v in flat(params).items()
               if not torch.equal(masters[k].detach(), v.float())]
        if bad:
            raise AssertionError(f"hf_roundtrip: the engine's masters differ in {bad[:6]}")
        del engine, masters
        _free(torch)
        with HostPeak() as hp:
            t0 = time.perf_counter()
            loaded, lcfg = load_hf_checkpoint(root, dtype=cfg.dtype, device=DEVICE)
            import_s = time.perf_counter() - t0
        fl, fo = flat(loaded), flat(params)
        bad = [k for k in fo if not _same_bytes(torch, fl[k], fo[k])]
        if set(fl) != set(fo) or bad:
            raise AssertionError(f"hf_roundtrip: imported leaves differ: {bad[:6]}")
        from deepspeed_tpu_torch.checkpoint.safetensors_io import SafetensorsReader, list_shards

        largest = max(e["data_offsets"][1] - e["data_offsets"][0]  # the largest HF tensor
                      for path in list_shards(root)
                      for e in SafetensorsReader(path).header.values())
        rng = np.random.default_rng(SEED)
        z = HF_SERVE
        prompts = [rng.integers(1, cfg.vocab_size, z["prompt_len"]).tolist()
                   for _ in range(z["prompts"])]
        samp = SamplingParams(temperature=0.0, max_new_tokens=z["new"])
        streams, launches = {}, {}
        for name, tree, c in (("original", params, cfg), ("imported", loaded, lcfg)):
            eng = InferenceEngineV2(tree, c, max_seqs=z["prompts"], num_blocks=64,
                                    block_size=32, prefill_budget=512, device=DEVICE)
            K.reset_launches()
            streams[name] = _serve_greedy(eng, prompts, samp)
            launches[name] = dict(K.LAUNCHES)
            d_prefill, d_ticks = eng.stats["prefill_dispatches"], eng.stats["decode_ticks"]
            if eng.close()["blocks_in_use"]:
                raise AssertionError("hf_roundtrip: blocks left in use")
            if DEVICE == "cuda":
                L = c.num_layers
                if launches[name]["flash_fwd"] != L * d_prefill or \
                        launches[name]["paged_decode"] != L * d_ticks or not d_ticks:
                    raise AssertionError(f"hf_roundtrip {name}: launches {launches[name]} vs "
                                         f"{L} x ({d_prefill}, {d_ticks})")
        if streams["imported"] != streams["original"]:
            raise AssertionError("hf_roundtrip: the imported tree's tokens differ")
        out = dict(phase="hf_roundtrip", model=CKPT_PRESET, file_bytes=file_bytes,
                   tree_bytes=tree_bytes, export_s=export_s, import_s=import_s,
                   import_host_peak_bytes=hp.growth, largest_hf_tensor_bytes=largest,
                   prompts=z["prompts"], new_tokens=z["new"], tokens_identical=True,
                   launches={n: launches["original"][n] + launches["imported"][n]
                             for n in K.LAUNCHES if launches["original"][n]},
                   launches_per_engine={n: v for n, v in launches["imported"].items() if v},
                   gpu=gpu)
        emit(out)
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)


SHIM_LOSS_RTOL = 1e-3
SHIM_LOSS_RTOL = 1e-3


def train_shim_phase(torch, K, gpu, want_losses):
    """Phase 6b (``train_shim``): the flagship at full width and depth
    (``llama3_proxy_410m``, seq 4096, micro 8, GAS 2, bf16, AdamW) through
    the reference's API, ``forward`` / ``backward`` / ``step``, from the
    same seed, batch and config as the train phase: its two steps' losses
    (the mean of each step's two micro-batch losses) against the train
    phase's first two ``train_batch`` losses (``want_losses``) within
    SHIM_LOSS_RTOL (the same bf16 kernels on the same inputs; step 2 sees
    the flash backward's and the fp32 sums' ordering once more), and the
    launches of a ``train_batch`` step: the flash kernels layers x GAS
    times a step, K8 once, at the boundary step only."""
    import numpy as np
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.models.presets import get_preset
    from deepspeed_tpu_torch.models.transformer import CausalLM

    micro, seq, gas, steps = 8, 4096, 2, 2
    model = CausalLM(get_preset("llama3_proxy_410m", loss_chunk_size=2048))
    engine, _, _, _ = initialize(model=model, config=bench_config(micro, gas))
    cfg = model.cfg
    batch = {"input_ids": np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (gas, micro, seq + 1), dtype=np.int64)}
    K.reset_launches()
    micro_losses, boundaries = [], []
    for _ in range(steps):
        for i in range(gas):
            loss = engine.forward({"input_ids": batch["input_ids"][i]})
            engine.backward(loss)
            boundaries.append(engine.is_gradient_accumulation_boundary())
            engine.step()
            micro_losses.append(float(loss))
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    check_train_launches("train_shim", launches, cfg.num_layers, gas, steps, False)
    got = [float(np.mean(micro_losses[i * gas:(i + 1) * gas])) for i in range(steps)]
    rel = [abs(g - w) / abs(w) for g, w in zip(got, want_losses[:steps])]
    res = dict(phase="train_shim", model="llama3_proxy_410m", layers=cfg.num_layers, seq=seq,
               micro_batch=micro, gas=gas, steps=steps, micro_losses=micro_losses,
               step_losses=got, train_batch_losses=want_losses[:steps], loss_rel_diff=rel,
               limit=SHIM_LOSS_RTOL, boundaries=boundaries, global_steps=engine.global_steps,
               loss_scale=engine.loss_scale, launches=launches, gpu=gpu)
    emit(res)
    if boundaries != [False, True] * steps or engine.global_steps != steps:
        raise AssertionError(f"train_shim: boundaries {boundaries}, "
                             f"global_steps {engine.global_steps}")
    if not all(np.isfinite(got)) or max(rel) > SHIM_LOSS_RTOL:
        raise AssertionError(f"train_shim: losses {got} against train_batch's "
                             f"{want_losses[:steps]} (rel {rel} > {SHIM_LOSS_RTOL})")
    del engine
    return res


FAULT1_TOP_P = 0.99999994  # the largest fp32 below 1


def fault1_logits(torch):
    """ROADMAP queue 3 fault 1's reproduction (8 rows of llama3's vocab, on
    the CPU generator: row 7's fp32 cumulative probability ends below
    FAULT1_TOP_P there), then 248 more rows of the same kind."""
    v = 128256
    return torch.cat([torch.randn(8, v, generator=torch.Generator().manual_seed(0)),
                      torch.randn(248, v, generator=torch.Generator().manual_seed(1))]) * 0.1


def sampling_phase(torch, gpu):
    """Phase 6c (``sampling``): ``sample`` with top-p on CUDA over rows
    whose fp32 cumulative probability may never reach ``top_p`` (the cutoff
    index then equals the vocab size; the gather there was a device-side
    assert that killed the context).  At FAULT1_TOP_P and at 1 - 1e-9
    (1.0 in fp32: every row whose device cumsum ends below 1): every row
    samples a token in [0, v) that the filter kept, every row whose cutoff
    is past the vocab keeps every logit, and at least one row takes that
    path on the card."""
    from deepspeed_tpu_torch.inference.sampling import SamplingParams, sample, top_p_filter

    logits = fault1_logits(torch).to(DEVICE)
    v = logits.shape[-1]
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    res = dict(phase="sampling", rows=logits.shape[0], vocab=v, gpu=gpu, cases={})
    for top_p in (FAULT1_TOP_P, 1.0 - 1e-9):
        toks = sample(logits, SamplingParams(temperature=1.0, top_p=top_p), gen).long()
        kept = top_p_filter(logits, top_p)
        cum = torch.cumsum(torch.softmax(torch.sort(logits, dim=-1, descending=True).values,
                                         dim=-1), dim=-1)
        past = (cum < top_p).sum(dim=-1) == v
        torch.cuda.synchronize()
        valid = bool(((toks >= 0) & (toks < v)).all())
        on_kept = bool(torch.isfinite(kept[torch.arange(len(toks), device=DEVICE), toks]).all())
        masked_past = int(torch.isinf(kept[past]).sum())
        res["cases"][repr(top_p)] = dict(rows_cutoff_past_vocab=int(past.sum()),
                                         row7_cutoff_past_vocab=bool(past[7]),
                                         tokens_valid=valid, tokens_on_kept_logits=on_kept,
                                         masked_logits_in_those_rows=masked_past)
        if not (valid and on_kept) or masked_past:
            raise AssertionError(f"sampling: {res['cases'][repr(top_p)]} at top_p {top_p}")
    emit(res)
    if not any(c["rows_cutoff_past_vocab"] for c in res["cases"].values()):
        raise AssertionError("sampling: no row's cutoff was past the vocab on the card")
    return res


def adam_timing(torch, engine):
    """K8 on the engine's own flat buffers (every parameter of the tree),
    its plain version, and ``torch._fused_adamw_`` (what
    ``torch.optim.AdamW(fused=True)`` calls; timed only) over the same
    leaves as views of the same buffers.  Bound: 28 bytes an element (p, g,
    m, v read, p, m, v written) over 3.35 TB/s; 16 fp32 operations an
    element over 67 TFLOP/s is 30x less."""
    from deepspeed_tpu_torch.ops.kernels import fused_adam as K8

    flat, grad = engine._masters.flat, engine._masters.grad
    m, v = engine.opt_state["mu"][0], engine.opt_state["nu"][0]
    n = flat.numel()
    grad.normal_(0.0, 1e-3)
    lr = torch.tensor(1e-4, device=flat.device)
    t = torch.tensor(1000, dtype=torch.int32, device=flat.device)
    ms = time_ms(torch, lambda: K8.fused_adamw_kernel(flat, grad, m, v, lr, t, wd=0.1),
                 iters=10, warm=2)
    plain_ms = time_ms(torch, lambda: K8.fused_adamw_flat_plain(flat, grad, m, v, lr, t,
                                                                 wd=0.1), iters=3, warm=1)

    def leaf_views(buf):
        out = []
        for p in engine._params_list:
            off = (p.data_ptr() - flat.data_ptr()) // 4
            out.append(buf[off:off + p.numel()].view(p.shape))
        return out

    with torch.no_grad():
        leaves = [p.detach() for p in engine._params_list]
        args = (leaves, leaf_views(grad), leaf_views(m), leaf_views(v), [],
                [torch.tensor(1000.0, device=flat.device) for _ in leaves])
        lib_ms = time_ms(torch, lambda: torch._fused_adamw_(
            *args, lr=1e-4, beta1=0.9, beta2=0.999, weight_decay=0.1, eps=1e-8,
            amsgrad=False, maximize=False), iters=10, warm=2)
    bound, by = _bound(16 * n, 28 * n, PEAK_FP32_FLOPS)
    grad.zero_()
    return dict(shape=f"N{n} fp32 (the llama3_proxy_410m tree, {len(leaves)} leaves)", ms=ms,
                plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound, bound_by=by,
                library_note="torch._fused_adamw_ over the same leaves (multi-tensor "
                             "apply), the same update up to rounding")


# ---------------------------------------------------------------------------
# the rest of the one-card training surface: optimizers, remat, presets
# ---------------------------------------------------------------------------
# the optimizers that are plain PyTorch updates (JAX builds them with optax
# and no Pallas kernel), each with the config params the phases give it
NEW_OPTIMIZERS = {"lamb": {"lr": 1e-4, "weight_decay": 0.1},
                  "lion": {"lr": 1e-4, "weight_decay": 0.1},
                  "adagrad": {"lr": 1e-4}, "muon": {"lr": 1e-4}}
# the card's parameters after 3 updates against the CPU's from the same fp32
# gradients, max |p_card - p_cpu| / max |p|.  The elementwise rules are the
# same IEEE fp32 operations in the same order on both (bit-equal but for
# pow / rsqrt / the norms' summation order, which move an update by an ulp
# or two); Muon's update is 15 fp32 matrix products a 2-D leaf a step, whose
# summation order cuBLAS and the CPU's BLAS choose apart, and Newton-Schulz
# iterations amplify the differences of small singular directions.
OPT_TOL = 1e-6
OPT_NS_TOL = 1e-5
OPT_CHECK_LR = 1e-3
# the second update reads the first's state; the CPU's updates run in the
# build window
OPT_STEPS = 2
# the train flagship's shape (bench.py:42-109), which the optimizers' and
# remat phases run at
FLAGSHIP = dict(seq=4096, micro=8, gas=2)


def optimizer_inputs(torch):
    """The optimizer checks' inputs: the 2-layer full-width flagship tree
    (on the CPU), its flat copy and OPT_STEPS seeded fp32 gradients."""
    from deepspeed_tpu_torch.models.presets import get_preset
    from deepspeed_tpu_torch.models.transformer import init_params
    from deepspeed_tpu_torch.runtime.engine import _leaves

    cfg = get_preset("llama3_proxy_410m", num_layers=2)
    tree = _tree_cpu(init_params(cfg, seed=SEED, device=DEVICE, dtype=torch.float32))
    p0 = torch.cat([x.reshape(-1) for x in _leaves(tree, [])])
    gen = torch.Generator().manual_seed(SEED + 7)
    return tree, p0, [torch.randn(p0.numel(), generator=gen) * 1e-3 for _ in range(OPT_STEPS)]


def optimizer_check(torch, name, inputs):
    """``name`` on the 2-layer full-width flagship tree, OPT_STEPS updates on
    the card and on the CPU from the same seeded fp32 gradients
    (``inputs``, ``optimizer_inputs``' result)."""
    from deepspeed_tpu_torch.ops.optimizers import build_optimizer
    from deepspeed_tpu_torch.runtime.engine import _flat_masters

    tree, p0, grads = inputs
    out = {}
    for dev in (DEVICE, "cpu"):
        masters = _flat_masters(tree, torch.device(dev))  # the engine's layout
        opt = build_optimizer(name, NEW_OPTIMIZERS[name])
        state = opt.init(masters.leaves)
        lr = torch.tensor(OPT_CHECK_LR, device=dev)
        t0 = time.perf_counter()
        for g in grads:
            masters.grad.copy_(g)
            opt.step(masters.leaves, masters.grads, state, lr)
        if dev == DEVICE:
            torch.cuda.synchronize()
        out[dev] = (masters.flat.detach().cpu(), time.perf_counter() - t0)
    card, cpu = out[DEVICE][0], out["cpu"][0]
    err = float((card - cpu).abs().max()) / float(cpu.abs().max())
    upd_err = float((card - cpu).abs().max()) / float((cpu - p0).abs().max())
    tol = OPT_NS_TOL if name == "muon" else OPT_TOL
    res = dict(optimizer=name, elements=p0.numel(), steps=OPT_STEPS, lr=OPT_CHECK_LR,
               max_abs_err_over_max_p=err, limit=tol,
               max_abs_err_over_max_update=upd_err, card_s=out[DEVICE][1],
               cpu_s=out["cpu"][1])
    if not (err <= tol and torch.isfinite(card).all()):
        raise AssertionError(f"optimizers: {name} card against CPU {res}")
    return res


def optimizer_cost(torch, K, name, adamw_step_s):
    """The train flagship (seq 4096, micro 8, GAS 2) with optimizer ``name``:
    one warm-up, 3 timed ``train_batch`` steps, the optimizer's update alone
    on the engine's buffers under the profiler, its state bytes."""
    import numpy as np
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.models.presets import get_preset
    from deepspeed_tpu_torch.models.transformer import CausalLM

    micro, seq, gas, steps = FLAGSHIP["micro"], FLAGSHIP["seq"], FLAGSHIP["gas"], 3
    model = CausalLM(get_preset("llama3_proxy_410m", loss_chunk_size=2048))
    conf = bench_config(micro, gas)
    conf["optimizer"] = {"type": name, "params": NEW_OPTIMIZERS[name]}
    engine, _, _, _ = initialize(model=model, config=conf)
    batch = {"input_ids": np.random.default_rng(SEED).integers(
        0, model.cfg.vocab_size, (gas, micro, seq + 1), dtype=np.int64)}
    losses = [float(engine.train_batch(batch))]
    K.reset_launches()
    step_s = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(engine.train_batch(batch)))
        step_s.append(time.perf_counter() - t0)
    launches = dict(K.LAUNCHES)
    want = {"flash_fwd": model.cfg.num_layers * gas * steps, "fused_adamw": 0}
    if any(launches[n] != w for n, w in want.items()):
        raise AssertionError(f"optimizers: {name} launches {launches} against {want}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"optimizers: {name} losses {losses}")
    lr = torch.tensor(1e-4, device=DEVICE)

    def update():
        engine.optimizer.step(engine._params_list, engine._masters.grads, engine.opt_state, lr)

    update_ms = time_ms(torch, update, iters=3, warm=1)
    opt_wall, opt_dev, rows = _device_profile(torch, update, top=5)
    bound, by = _update_bound(name, engine._params_list)
    med = sorted(step_s)[len(step_s) // 2]
    tokens = gas * micro * seq
    res = dict(optimizer=name, step_s=step_s, step_s_median=med, tokens_per_s=tokens / med,
               adamw_step_s_median=adamw_step_s, step_over_adamw=med / adamw_step_s,
               update_ms=update_ms, update_bound_ms=bound, update_bound_by=by,
               update_wall_ms=opt_wall, update_device_ms=opt_dev, update_top=rows,
               opt_state_bytes=engine.memory_breakdown()["opt_state_bytes"],
               peak_memory_bytes=torch.cuda.max_memory_allocated(), losses=losses,
               launches=launches)
    del engine
    _free(torch)
    return res


def _update_bound(name, leaves):
    """(ms, what bounds it) of one update over ``leaves``: fp32 bytes of
    the parameters, gradients and moments each read once and the
    parameters and moments written once (Lion, Adagrad and Muon's 2-D
    leaves 5 an element, Lamb and NAdamW 7), against Muon's Newton-Schulz
    products at the fp32 rate (5 steps of 4 m^2 n + 2 m^3 flops on an m x
    n leaf, m <= n)."""
    per_elem = {"lamb": 7, "lion": 5, "adagrad": 5}
    flops, nbytes = 0, 0
    for p in leaves:
        if name == "muon" and p.dim() == 2:
            m, n = sorted(p.shape)
            flops += 5 * (4 * m * m * n + 2 * m ** 3)
            nbytes += 5 * 4 * p.numel()
        else:
            nbytes += per_elem.get(name, 7) * 4 * p.numel()
    return _bound(flops, nbytes, PEAK_FP32_FLOPS)


def optimizers_phase(torch, K, gpu, adamw_step_s, checks):
    """Lamb, Lion, Adagrad and Muon: ``checks``, their ``optimizer_check``
    (card against CPU, which launches no kernel: ``main`` runs it while the
    kernels build), and ``optimizer_cost`` (the train flagship's step
    beside AdamW's)."""
    t0 = time.perf_counter()
    costs = {}
    for n in NEW_OPTIMIZERS:
        torch.cuda.reset_peak_memory_stats()
        costs[n] = optimizer_cost(torch, K, n, adamw_step_s)
    launches = {k: sum(c["launches"][k] for c in costs.values()) for k in K.LAUNCHES}
    for c in costs.values():
        del c["launches"]
    res = dict(phase="optimizers", checks=checks, cost=costs, launches=launches,
               seconds=time.perf_counter() - t0, gpu=gpu)
    emit(res)
    return res


# the remat policies of the train flagship, in the order they run
REMAT_POLICIES = ("none", "full", "selective", "dots", "offload")
# attention forwards a layer runs per micro-batch under each policy: the
# policies that recompute the attention (full: the layer; dots: all but its
# products) run K1f again in the backward
REMAT_FWD_PER_LAYER = {"none": 1, "full": 2, "selective": 1, "dots": 2, "offload": 1}
# the flagship's first 12 of 24 layers under each policy: the peak order
# and the launch counts hold at any depth, the train phase runs all 24, and
# the compile phases took the seconds (the whole smoke's time limit)
REMAT_LAYERS = 12


def remat_run(torch, K, remat, micro, steps=2):
    """The train flagship under ``remat``: a warm-up step, then ``steps``
    timed steps with the peak memory reset before them."""
    import numpy as np
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.models import transformer as T
    from deepspeed_tpu_torch.models.presets import get_preset

    seq, gas = FLAGSHIP["seq"], FLAGSHIP["gas"]
    model = T.CausalLM(get_preset("llama3_proxy_410m", loss_chunk_size=2048, remat=remat,
                                  num_layers=REMAT_LAYERS))
    engine, _, _, _ = initialize(model=model, config=bench_config(micro, gas))
    batch = {"input_ids": np.random.default_rng(SEED).integers(
        0, model.cfg.vocab_size, (gas, micro, seq + 1), dtype=np.int64)}
    try:
        first = float(engine.train_batch(batch))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launches()
        moved0 = dict(T.OFFLOAD_BYTES)
        step_s = []
        for _ in range(steps):
            t0 = time.perf_counter()
            loss = float(engine.train_batch(batch))
            step_s.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated()
        launches = dict(K.LAUNCHES)
        moved = {k: (T.OFFLOAD_BYTES[k] - moved0[k]) / steps for k in moved0}
    finally:
        del engine
        _free(torch)
    L = model.cfg.num_layers
    want = {"flash_fwd": REMAT_FWD_PER_LAYER[remat] * L * gas * steps,
            "flash_bwd_dq": L * gas * steps, "flash_bwd_dkv": L * gas * steps}
    if any(launches[n] != w for n, w in want.items()) or not np.isfinite([first, loss]).all():
        raise AssertionError(f"remat {remat}: launches {launches} against {want}, "
                             f"losses {first} {loss}")
    return dict(step_s=step_s, step_s_median=sorted(step_s)[len(step_s) // 2],
                peak_memory_bytes=peak, losses=[first, loss],
                launches_per_step={n: launches[n] / steps for n in want},
                offload_bytes_per_step=moved if remat == "offload" else None,
                launches=launches)


def remat_phase(torch, K, gpu):
    """The train flagship under each remat policy at micro 8 (all at micro 4
    if ``none`` does not fit): step time, peak memory, K1f / K1b launches
    per step against ``REMAT_FWD_PER_LAYER``, the bytes ``offload`` moves;
    peak(full) <= peak(dots) <= peak(none) and peak(offload) <
    peak(selective)."""
    t0 = time.perf_counter()
    runs, micro = {}, FLAGSHIP["micro"]
    try:
        runs["none"] = remat_run(torch, K, "none", micro)
    except torch.cuda.OutOfMemoryError:
        micro //= 2  # retried outside the handler, once its traceback has let go
    if micro != FLAGSHIP["micro"]:
        _free(torch)
        runs["none"] = remat_run(torch, K, "none", micro)
    for remat in REMAT_POLICIES[1:]:
        runs[remat] = remat_run(torch, K, remat, micro)
    peak = {r: runs[r]["peak_memory_bytes"] for r in runs}
    order = dict(full_le_dots=peak["full"] <= peak["dots"],
                 dots_le_none=peak["dots"] <= peak["none"],
                 offload_lt_selective=peak["offload"] < peak["selective"])
    launches = {k: sum(r["launches"][k] for r in runs.values()) for k in K.LAUNCHES}
    for r in runs.values():
        del r["launches"]
    res = dict(phase="remat", model="llama3_proxy_410m", seq=FLAGSHIP["seq"],
               micro_batch=micro, gas=FLAGSHIP["gas"],
               none_fits_at_flagship_micro=micro == FLAGSHIP["micro"], runs=runs,
               peak_order=order,
               launches=launches, seconds=time.perf_counter() - t0, gpu=gpu)
    emit(res)
    if not all(order.values()):
        raise AssertionError(f"remat: peak memory order {order}: {peak}")
    return res


# presets_train: every preset the card trains at full width, except the two
# the earlier phases cover (llama3_proxy_410m, gpt2_small) and llama3_70b
# (its fp32 masters and moments do not fit one card: item 7).  A MoE
# preset's CPU run takes the card's expert choices (RoutePin): bf16
# activations move a near-tied router choice, and the token then runs
# through another expert and, past capacity, drops another token: a
# discrete change, not rounding.  Its unpinned cosine and the number of
# choices that moved are reported beside the gated pinned one.
PRESETS_TRAIN_SKIP = ("llama3_70b", "llama3_proxy_410m", "gpt2_small")
PRESET_SEQ, PRESET_MICRO = 64, 2


def _cpu_attn_grads(torch, cfg, params_cpu, micro):
    """(loss, layer 0's wq / wk / wv / wo gradients) of one micro-batch
    through the port on the CPU in fp32."""
    from deepspeed_tpu_torch.models.transformer import CausalLM

    attn = params_cpu["layers"]["attn"]
    names = ("wq", "wk", "wv", "wo")
    for n in names:
        attn[n].requires_grad_(True)
    loss = CausalLM(cfg.replace(dtype=torch.float32)).loss_fn(
        params_cpu, {k: torch.as_tensor(v) for k, v in micro.items()})
    grads = torch.autograd.grad(loss, [attn[n] for n in names])
    return float(loss.detach()), {n: g[0].flatten() for n, g in zip(names, grads)}


class RoutePin:
    """Expert choices of routed MoE calls, in call order.  Under
    ``record()`` every ``top_k`` of the router keeps its choices; under
    ``replay()`` each call takes the recorded choices instead (its own
    probabilities at them, so the weights and gradients stay its own) and
    counts where its own choices differ: ``moved`` tokens chose another
    set of experts, ``reordered`` ones the same set in another order (which
    changes the capacity queue, not a dropless output).  The capacity gate
    and the dropless block both choose through ``sharded_moe.top_k``, so a
    replay pins the experts and, by them, the slots."""

    def __init__(self):
        self.calls, self.replayed, self.moved, self.reordered, self.tokens = [], 0, 0, 0, 0

    @contextlib.contextmanager
    def _patched(self, fn):
        from deepspeed_tpu_torch.moe import layer, sharded_moe

        orig = sharded_moe.top_k

        def wrapped(probs, k):
            return fn(orig, probs, k)

        sharded_moe.top_k = layer.top_k = wrapped
        try:
            yield self
        finally:
            sharded_moe.top_k = layer.top_k = orig

    def record(self):
        def keep(orig, probs, k):
            vals, idx = orig(probs, k)
            self.calls.append(idx.detach().cpu())
            return vals, idx

        return self._patched(keep)

    def replay(self):
        def pinned(orig, probs, k):
            _, own = orig(probs, k)
            rec = self.calls[self.replayed].to(probs.device)
            self.replayed += 1
            if rec.shape != own.shape:
                raise AssertionError(f"RoutePin: call {self.replayed} has {tuple(own.shape)} "
                                     f"choices, the record {tuple(rec.shape)}")
            same_set = (own.sort(-1).values == rec.sort(-1).values).all(-1)
            self.moved += int((~same_set).sum())
            self.reordered += int((same_set & (own != rec).any(-1)).sum())
            self.tokens += own.shape[0]
            return probs.gather(-1, rec), rec

        return self._patched(pinned)

    def summary(self):
        if self.replayed != len(self.calls):
            raise AssertionError(f"RoutePin: {self.replayed} of {len(self.calls)} recorded "
                                 "calls replayed")
        return dict(routed_calls=len(self.calls), token_choices=self.tokens,
                    tokens_moved=self.moved, tokens_reordered=self.reordered)


# one layer at full width (2 until the compile phases took the seconds: the
# whole smoke's time limit); train_check runs the flagship's 2 layers
PRESET_TRAIN_LAYERS = 1


def preset_train_one(torch, K, name):
    """``name`` at full width and ``PRESET_TRAIN_LAYERS`` layers, bf16, its
    own remat and attention: one ``train_batch`` on the card against the port on the CPU
    in fp32 from the same weights and batch (a MoE preset's CPU run on the
    card's expert choices: ``RoutePin``)."""
    import numpy as np
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.models.presets import get_preset
    from deepspeed_tpu_torch.models.transformer import CausalLM, init_params

    cfg = get_preset(name, num_layers=PRESET_TRAIN_LAYERS)
    params = init_params(cfg, seed=SEED, device=DEVICE, dtype=torch.float32)
    params_cpu = _tree_cpu(params)
    batch = {"input_ids": np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (1, PRESET_MICRO, PRESET_SEQ + 1), dtype=np.int64)}
    micro0 = {"input_ids": batch["input_ids"][0]}
    torch.cuda.reset_peak_memory_stats()
    engine, _, _, _ = initialize(model=CausalLM(cfg), params=params,
                                 config=bench_config(PRESET_MICRO, 1))
    del params
    pin = RoutePin() if cfg.moe_num_experts else None
    with pin.record() if pin else contextlib.nullcontext():
        g_card = _attn_grads(torch, engine, micro0)
    K.reset_launches()
    card_loss = float(engine.train_batch(batch))
    launches = dict(K.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    del engine
    _free(torch)
    routing = None
    if pin:
        free_loss, g_free = _cpu_attn_grads(torch, cfg, params_cpu, micro0)
        with pin.replay():
            cpu_loss, g_cpu = _cpu_attn_grads(torch, cfg, params_cpu, micro0)
        routing = dict(pin.summary(), cpu_loss_unpinned=free_loss,
                       grad_cosine_layer0_unpinned=grad_cosines(torch, g_card, g_free))
    else:
        cpu_loss, g_cpu = _cpu_attn_grads(torch, cfg, params_cpu, micro0)
    cos = grad_cosines(torch, g_card, g_cpu)
    rel = abs(card_loss - cpu_loss) / abs(cpu_loss)
    L = cfg.num_layers
    flash = cfg.attn_impl != "reference"
    want = {"flash_fwd": REMAT_FWD_PER_LAYER[cfg.remat] * L if flash else 0,
            "flash_bwd_dq": L if flash else 0, "flash_bwd_dkv": L if flash else 0,
            "fused_adamw": 1}
    res = dict(model=name, hidden=cfg.hidden_size, heads=cfg.num_heads,
               kv_heads=cfg.num_kv_heads, head_dim=cfg.hd, remat=cfg.remat,
               attn_impl=cfg.attn_impl, params=cfg.param_count, card_loss=card_loss,
               cpu_loss=cpu_loss, step1_loss_rel_err=rel, grad_cosine_layer0=cos,
               launches={n: launches[n] for n in want}, peak_memory_bytes=peak)
    if routing:
        res["cpu_on_card_routing"] = routing
    bad = [n for n, w in want.items() if launches[n] != w]
    if bad or not rel <= TRAIN_LOSS_RTOL or not all(c > GRAD_COS_MIN for c in cos.values()):
        raise AssertionError(f"presets_train: {res} (launches expected {want})")
    return res, launches


def presets_train_phase(torch, K, gpu):
    from deepspeed_tpu_torch.models.presets import list_presets

    t0 = time.perf_counter()
    runs, launches = {}, {k: 0 for k in K.LAUNCHES}
    for name in list_presets():
        if name in PRESETS_TRAIN_SKIP:
            continue
        t1 = time.perf_counter()
        runs[name], ran = preset_train_one(torch, K, name)
        runs[name]["seconds"] = time.perf_counter() - t1
        for k in launches:
            launches[k] += ran[k]
    res = dict(phase="presets_train", layers=PRESET_TRAIN_LAYERS, seq=PRESET_SEQ,
               micro_batch=PRESET_MICRO,
               loss_rtol=TRAIN_LOSS_RTOL, grad_cos_min=GRAD_COS_MIN, runs=runs,
               launches=launches, seconds=time.perf_counter() - t0, gpu=gpu)
    emit(res)
    return res


# presets_serve: the presets JAX's v2 engine serves (no parallel block, no
# ALiBi) at full depth, each a 13-15 GB bf16 tree on the card
PRESETS_SERVE = ("llama2_7b", "mistral_7b", "qwen2_7b", "opt_6_7b")
PRESET_SERVE_SIZES = dict(batch=16, prompt_len=128, steps=32)


def preset_serve_one(torch, K, name):
    """``name`` at full depth: 16 prompts of 128 through ``put``, 32 greedy
    ``step``s (K1f and K2 layers x dispatches), a profiled tick; then its
    first 2 layers at full width serve 2 streams that replay on the CPU in
    fp32 (near-argmax), and no block stays in use after ``close()``."""
    import numpy as np
    from deepspeed_tpu_torch.inference.engine_v2 import InferenceEngineV2
    from deepspeed_tpu_torch.inference.sampling import SamplingParams
    from deepspeed_tpu_torch.models.presets import get_preset
    from deepspeed_tpu_torch.models.transformer import init_params

    B, n, steps = (PRESET_SERVE_SIZES[k] for k in ("batch", "prompt_len", "steps"))
    cfg = get_preset(name)
    params = init_params(cfg, seed=SEED, device=DEVICE)
    eng = InferenceEngineV2(params, cfg, max_seqs=B, num_blocks=256, block_size=32,
                            prefill_budget=2048)
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist() for _ in range(B)]
    samp = SamplingParams(temperature=0.0, max_new_tokens=steps + 8)
    eng.put([10_001], [prompts[0]], samp)  # warm-up
    eng.step(samp)
    eng.flush([10_001])
    stats0 = dict(eng.stats)
    K.reset_launches()
    first = eng.put(list(range(1, B + 1)), prompts, samp)
    tick_ms = []
    for _ in range(steps):
        t0 = time.perf_counter()
        eng.step(samp)
        tick_ms.append(1e3 * (time.perf_counter() - t0))
    launches = dict(K.LAUNCHES)
    d_prefill = eng.stats["prefill_dispatches"] - stats0["prefill_dispatches"]
    d_ticks = eng.stats["decode_ticks"] - stats0["decode_ticks"]
    L = cfg.num_layers
    if (launches["flash_fwd"] != L * d_prefill or launches["paged_decode"] != L * d_ticks
            or d_ticks != steps or not first):
        raise AssertionError(f"presets_serve {name}: launches {launches}, prefill "
                             f"dispatches {d_prefill}, ticks {d_ticks}")
    wall_ms, dev_ms, _ = _device_profile(torch, lambda: eng.step(samp), n=2, top=0)
    leaked = eng.close()["blocks_in_use"]
    del eng, params
    _free(torch)
    # the 2-layer full-width copy: served on the card, replayed on the CPU
    cfg2 = cfg.replace(num_layers=2)
    params2 = init_params(cfg2, seed=SEED, device=DEVICE)
    eng = InferenceEngineV2(params2, cfg2, max_seqs=4, num_blocks=64, block_size=32)
    short = {u: prompts[u - 1][:64] for u in (1, 2)}
    samp2 = SamplingParams(temperature=0.0, max_new_tokens=16)
    gen = {u: [t] for u, t in eng.put(list(short), list(short.values()), samp2).items()}
    for _ in range(8):
        for u, t in eng.step(samp2).items():
            gen[u].append(t)
    leaked += eng.close()["blocks_in_use"]
    worst, exact, total = replay_on_cpu(torch, _tree_cpu(params2), cfg2, short, gen)
    del eng, params2
    _free(torch)
    med = sorted(tick_ms)[len(tick_ms) // 2]
    res = dict(model=name, layers=L, heads=cfg.num_heads, kv_heads=cfg.num_kv_heads,
               head_dim=cfg.hd, batch=B, prompt_len=n, decode_steps=steps,
               prefill_dispatches=d_prefill, decode_tick_ms_median=med,
               decode_tokens_per_s=B * 1e3 / med, profile_tick_wall_ms=wall_ms,
               profile_tick_device_ms=dev_ms,
               launches_per_forward={"flash_fwd": launches["flash_fwd"] / d_prefill,
                                     "paged_decode": launches["paged_decode"] / d_ticks},
               two_layer_argmax_exact=f"{exact}/{total}", two_layer_argmax_worst_gap=worst,
               blocks_in_use_after_close=leaked)
    if leaked or worst > ARGMAX_TOL_FRAC:
        raise AssertionError(f"presets_serve: {res}")
    return res, launches


def presets_serve_phase(torch, K, gpu):
    t0 = time.perf_counter()
    runs, launches = {}, {k: 0 for k in K.LAUNCHES}
    for name in PRESETS_SERVE:
        t1 = time.perf_counter()
        runs[name], ran = preset_serve_one(torch, K, name)
        runs[name]["seconds"] = time.perf_counter() - t1
        for k in launches:
            launches[k] += ran[k]
    res = dict(phase="presets_serve", runs=runs, launches=launches,
               seconds=time.perf_counter() - t0, gpu=gpu)
    emit(res)
    return res


# ---------------------------------------------------------------------------
# Mixtral-style MoE (moe_train, moe_serve) and the dense v1 engine (v1_serve)
# ---------------------------------------------------------------------------
# moe_train: mixtral_8x7b at full width cut to 2 layers (about 3.16 G
# parameters: 57 GB of fp32 masters, gradients and AdamW moments), seq 4096,
# micro-batch 1, the preset's remat="full", AdamW through K8
MOE_TRAIN = dict(layers=2, seq=4096, micro=1, steps=3)
MOE_PEAK_LIMIT = 75e9  # bytes; past it the phase is to run 1 layer instead
# the narrow fp32 MoE check (moe_train) and the v1 / v2 token check
# (v1_serve): mixtral_8x7b's switches at hidden 256 with 4 experts
MOE_NARROW = dict(hidden_size=256, intermediate_size=512, num_heads=2, num_kv_heads=1,
                  moe_num_experts=4, num_layers=2, vocab_size=1024)
# card against CPU, both fp32 (TF32 off), on the narrow config: relative
# Frobenius error of the loss and of every gradient leaf.  The two differ
# in summation order only (~1e-6); a wrong dispatch, combine or routing
# decision moves a leaf by orders of magnitude more.
MOE_CHECK_TOL = 1e-4
# K8 on the MoE engine's own flat buffers, which pass 2^31 elements: the
# spans at the start, around element 2^31 and at the end against the plain
# version (K8_TOL)
K8_PAST = 1 << 31
K8_SPAN = 1 << 16
# moe_serve: mixtral_8x7b at full width, 8 layers (about 24 GB in bf16),
# through the v2 scheduler: 4 requests of a shared 256-token prefix and a
# 64-token suffix, 64 new greedy tokens each; per tick and in bursts
MOE_SERVE = dict(layers=8, n_req=4, sys_len=256, sfx_len=64, max_new=64, burst=16)
MOE_SERVE_ENGINE = dict(max_seqs=4, num_blocks=64, block_size=32, max_seq_len=512,
                        prefill_buckets=(64, 128, 256, 512), prefill_budget=512,
                        enable_prefix_caching=True)
# v1's prefill logits against v2's on the same bf16 weights and prompts,
# 8 layers: max |v1 - v2| over the row's logit range (max - min).  The two
# attend differently (v1 the plain body over the dense cache, v2 the flash
# kernel) and round to bf16 at other points, so a near-tied router choice
# can move between them: each moved choice sends a token through another
# expert.  On v2's expert choices (RoutePin) only the rounding is left:
# read 0.76 % of the range, of which the bf16 logits' own rounding (up to
# 2^-8 of a logit on each side, |logit| about half the range) can make
# 0.4 %; held to MOE_V1_PINNED_TOL = 1 %.  On its own choices v1 read
# 1.39 % (40 of 2,048 token choices moved), held to MOE_V1_LOGIT_TOL =
# 2 %, the near-argmax limit for a bf16 pick (ARGMAX_TOL_FRAC).  A wrong
# layer moves either by tens of percent.
MOE_V1_LOGIT_TOL = 0.02
MOE_V1_PINNED_TOL = 0.01
# the 2-layer full-width copy of moe_serve's model, per tick and in bursts
# of 8, replayed on the CPU in fp32 (near-argmax, ARGMAX_TOL_FRAC)
MOE_REPLAY = dict(layers=2, n_req=2, prompt_len=64, max_new=16, burst=8)
# v1_serve: the families JAX serves only through init_inference, at full depth
V1_SERVE = ("bloom_7b1", "falcon_7b", "gptj_6b")
V1_SIZES = dict(batch=4, prompt_len=128, new=32)
V1_REPLAY = dict(batch=2, prompt_len=64, new=16)  # 2-layer copies replayed on the CPU


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, prefix + k + "/"))
        else:
            out[prefix + k] = v
    return out


def _to(tree, device, dtype=None):
    """A parameter tree's copy on ``device`` (in ``dtype`` when given)."""
    return {k: _to(v, device, dtype) if isinstance(v, dict)
            else v.detach().to(device, dtype or v.dtype) for k, v in tree.items()}


def moe_narrow_check(torch):
    """The narrow fp32 MoE config: ``loss_fn`` and every gradient on the
    card against the port on the CPU (the plain attention body on both: the
    attention kernels take bf16; what is checked is the routed path)."""
    import numpy as np
    from deepspeed_tpu_torch.models.presets import get_preset
    from deepspeed_tpu_torch.models.transformer import CausalLM, init_params

    cfg = get_preset("mixtral_8x7b", dtype=torch.float32, attn_impl="reference",
                     remat="none", **MOE_NARROW)
    params = init_params(cfg, seed=SEED, device="cpu", dtype=torch.float32)
    tokens = torch.as_tensor(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (2, 257), dtype=np.int64))
    out = {}
    for dev in ("cpu", DEVICE):
        p = _to(params, dev)
        for leaf in _leaves(p).values():
            leaf.requires_grad_(True)
        loss = CausalLM(cfg).loss_fn(p, {"input_ids": tokens.to(dev)})
        loss.backward()
        out[dev] = float(loss.detach()), {k: v.grad.cpu() for k, v in _leaves(p).items()}
    (l_cpu, g_cpu), (l_card, g_card) = out["cpu"], out[DEVICE]
    errs = {k: float((g_card[k] - g_cpu[k]).norm() / g_cpu[k].norm().clamp(min=1e-30))
            for k in g_cpu}
    res = dict(config={k: v for k, v in MOE_NARROW.items()}, card_loss=l_card, cpu_loss=l_cpu,
               loss_rel_err=abs(l_card - l_cpu) / abs(l_cpu), worst_grad_rel_err=max(
                   errs.values()), worst_grad_leaf=max(errs, key=errs.get),
               tolerance=MOE_CHECK_TOL)
    if res["loss_rel_err"] > MOE_CHECK_TOL or res["worst_grad_rel_err"] > MOE_CHECK_TOL:
        raise AssertionError(f"moe_train: narrow fp32 card vs CPU {res}")
    return res


def k8_past_2_31(torch, engine):
    """K8 over the engine's flat fp32 buffers (more than 2^31 elements:
    the kernel indexes with 64-bit offsets) against the plain version on
    copies of three spans: the start, around element 2^31 and the end."""
    from deepspeed_tpu_torch.ops.kernels import fused_adam as K8

    flat, grad = engine._masters.flat, engine._masters.grad
    m, v = engine.opt_state["mu"][0], engine.opt_state["nu"][0]
    n = flat.numel()
    if n <= K8_PAST + K8_SPAN:
        raise AssertionError(f"moe_train: {n} elements do not pass 2^31")
    grad.normal_(0.0, 1e-3)
    spans = [(0, K8_SPAN), (K8_PAST - K8_SPAN, K8_PAST + K8_SPAN), (n - K8_SPAN, n)]
    snaps = [[t[a:b].clone() for t in (flat, grad, m, v)] for a, b in spans]
    lr = torch.tensor(1e-4, device=flat.device)
    step = torch.tensor(4, dtype=torch.int32, device=flat.device)
    K8.fused_adamw_kernel(flat, grad, m, v, lr, step, wd=0.1)
    worst = 0.0
    for (a, b), (p0, g0, m0, v0) in zip(spans, snaps):
        K8.fused_adamw_flat_plain(p0, g0, m0, v0, lr, step, wd=0.1)
        for got, ref in ((flat[a:b], p0), (m[a:b], m0), (v[a:b], v0)):
            worst = max(worst, float((got - ref).abs().max() / ref.abs().max()))
    grad.zero_()
    res = dict(elements=n, spans=[[a, b] for a, b in spans], worst_rel_err=worst,
               limit=K8_TOL)
    if not worst <= K8_TOL:
        raise AssertionError(f"moe_train: K8 past 2^31 {res}")
    return res


# device-kernel name fragments of a routed MoE block's pieces (first match
# wins): the GEMMs are the expert products (the fp32 router product among
# them: 0.27 GFLOP against the experts' 3.6 TFLOP at the training shape)
MOE_CATEGORIES = (("expert_products", ("gemm", "xmma", "nvjet", "cutlass", "Kernel2")),
                  ("gating", ("softmax", "sort", "Sort", "radix", "scan", "cumsum",
                              "one_hot", "topk")),
                  ("dispatch_combine", ("index", "gather", "scatter", "Cat", "take", "put")))


def moe_block_profile(torch, cfg, seq):
    """One routed block (``moe_block``) forward and backward at the
    training shape (1 x ``seq`` tokens, the preset's width, bf16) under
    ``torch.profiler``: device ms by piece (``MOE_CATEGORIES``; the rest is
    the activation, the weighting and sums, casts and copies)."""
    from deepspeed_tpu_torch.moe.layer import moe_block

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 7)
    d, f, E = cfg.hidden_size, cfg.intermediate_size, cfg.moe_num_experts
    shapes = {"router": ((d, E), d), "w_gate": ((E, d, f), d), "w_up": ((E, d, f), d),
              "w_down": ((E, f, d), f)}
    lw = {k: (_randn(torch, s, gen, torch.float32) * fan ** -0.5).bfloat16().requires_grad_()
          for k, (s, fan) in shapes.items()}
    x = _randn(torch, (1, seq, d), gen, torch.bfloat16).requires_grad_()

    def step():
        out, aux = moe_block(lw, x, cfg)
        (out.float().square().mean() + aux).backward()

    step()
    wall_ms, dev_ms, rows = _device_profile(torch, step, top=None)
    cats = {name: 0.0 for name, _ in MOE_CATEGORIES}
    cats["other"] = 0.0
    for r in rows:
        name = next((c for c, keys in MOE_CATEGORIES if any(k in r["name"] for k in keys)),
                    "other")
        cats[name] += r["ms_per_call"]
    total = sum(cats.values())
    del lw, x
    return dict(tokens=seq, wall_ms=wall_ms, device_ms=dev_ms, ms=cats,
                share={k: v / total for k, v in cats.items()} if total else None,
                top=rows[:12])


def moe_train_phase(torch, K, gpu):
    """``mixtral_8x7b`` at full width and ``MOE_TRAIN['layers']`` layers:
    the narrow fp32 check, then warm-up and 3 timed ``train_batch`` steps
    (K1f twice per layer under remat full, K1b once, K8 once), the gate's
    dropped fraction and aux loss, a profiled step, K8 past 2^31 on the
    engine's buffers, and one routed block profiled by piece."""
    import numpy as np
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.models.presets import get_preset
    from deepspeed_tpu_torch.models.transformer import CausalLM, init_params
    from deepspeed_tpu_torch.moe import layer as moe_layer

    t_phase = time.perf_counter()
    check = moe_narrow_check(torch)
    z = MOE_TRAIN
    cfg = get_preset("mixtral_8x7b", num_layers=z["layers"])
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, seed=SEED, device=DEVICE, dtype=torch.bfloat16)
    engine, _, _, _ = initialize(model=CausalLM(cfg), params=params,
                                 config=bench_config(z["micro"], 1), device=DEVICE)
    del params
    _free(torch)
    batch = {"input_ids": np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (1, z["micro"], z["seq"] + 1), dtype=np.int64)}
    t0 = time.perf_counter()
    first = float(engine.train_batch(batch))  # warm-up
    warm_s = time.perf_counter() - t0
    K.reset_launches()
    moe_layer.GATE_STATS = []
    step_s, losses = [], []
    for _ in range(z["steps"]):
        t0 = time.perf_counter()
        losses.append(float(engine.train_batch(batch)))  # reads the loss: synced
        step_s.append(time.perf_counter() - t0)
    launches = dict(K.LAUNCHES)
    gates, moe_layer.GATE_STATS = moe_layer.GATE_STATS, None
    peak = torch.cuda.max_memory_allocated()
    L, steps = cfg.num_layers, z["steps"]
    want = {"flash_fwd": REMAT_FWD_PER_LAYER[cfg.remat] * L * steps,
            "flash_bwd_dq": L * steps, "flash_bwd_dkv": L * steps, "fused_adamw": steps}
    bad = {n: (launches[n], w) for n, w in want.items() if launches[n] != w}
    if bad or not all(np.isfinite([first] + losses)):
        raise AssertionError(f"moe_train: launches (got, want) {bad}, losses {first} {losses}")
    dropped = [float(g["dropped_fraction"]) for g in gates]
    aux = [float(g["aux_loss"]) for g in gates]
    counts = gates[-1]["expert_counts"].tolist()
    wall_ms, dev_ms, rows = _device_profile(torch, lambda: engine.train_batch(batch), top=12)
    k8 = k8_past_2_31(torch, engine)
    n_params = engine._masters.flat.numel()
    del engine
    _free(torch)
    block = moe_block_profile(torch, cfg, z["seq"])
    _free(torch)
    med = _median(step_s)
    tokens = z["micro"] * z["seq"]
    res = dict(phase="moe_train", model="mixtral_8x7b", layers=L, seq=z["seq"],
               micro_batch=z["micro"], remat=cfg.remat, experts=cfg.moe_num_experts,
               top_k=cfg.moe_top_k, capacity_factor=cfg.moe_capacity_factor,
               params=n_params, optimizer="adamw (K8)", warmup_step_s=warm_s, step_s=step_s,
               step_s_median=med, tokens_per_s=tokens / med, loss_first=first, losses=losses,
               peak_memory_bytes=peak, peak_within_limit=peak <= MOE_PEAK_LIMIT,
               gate_calls=len(gates), dropped_fraction_mean=sum(dropped) / len(dropped),
               dropped_fraction_max=max(dropped), aux_loss_mean=sum(aux) / len(aux),
               last_layer_expert_counts=counts, launches=launches,
               launches_per_step={n: launches[n] / steps for n in want},
               profile_step_wall_ms=wall_ms, profile_step_device_ms=dev_ms,
               device_idle_share=None if dev_ms is None else 1.0 - dev_ms / wall_ms,
               profile_top=rows, moe_block_profile=block, k8_past_2_31=k8,
               narrow_fp32_check=check, seconds=time.perf_counter() - t_phase, gpu=gpu)
    emit(res)
    return res


def card_prefill_logits(torch, params, cfg, token_lists):
    """The last-row logits of each sequence through the v2 runner's packed
    prefill on the card (no KV written: every page id is -1)."""
    import numpy as np
    from deepspeed_tpu_torch.inference import model_runner
    from deepspeed_tpu_torch.inference.paged import init_paged_cache

    bs = 32
    t = sum(-(-len(toks) // bs) * bs for toks in token_lists)
    tok, seg, pos = (np.zeros(t, np.int32) for _ in range(3))
    last, cur = [], 0
    for i, toks in enumerate(token_lists):
        n = len(toks)
        tok[cur:cur + n], seg[cur:cur + n], pos[cur:cur + n] = toks, i + 1, np.arange(n)
        last.append(cur + n - 1)
        cur += -(-n // bs) * bs
    kv = init_paged_cache(cfg.num_layers, 1, bs, cfg.num_kv_heads, cfg.hd, dtype=cfg.dtype,
                          device=DEVICE)
    with torch.no_grad():
        logits, _ = model_runner.prefill_packed(params, cfg, tok, seg, pos,
                                                np.full(t // bs, -1, np.int32),
                                                np.asarray(last, np.int32), kv)
    return logits.float()


def moe_serve_run(torch, K, params, cfg, fuse, quant, prompts, max_new=None):
    """A fresh engine (``decode_megastep`` ``fuse``, weights ``quant``)
    through the MoE workload after a one-request rehearsal (which captures
    the burst graph): request 1 alone, then the rest, which hit its cached
    prefix.  Returns results, wall s, counter deltas, launches and the
    close audit."""
    import numpy as np
    from deepspeed_tpu_torch.inference.engine_v2 import InferenceEngineV2
    from deepspeed_tpu_torch.inference.sampling import SamplingParams

    eng = InferenceEngineV2(params, cfg, quantize_weights=quant, device=DEVICE,
                            serve={"decode_megastep": fuse}, **MOE_SERVE_ENGINE)
    sched = eng.scheduler
    warm = np.random.default_rng(SEED + 3).integers(1, cfg.vocab_size, 64).tolist()
    sched.submit(100_000, warm, SamplingParams(temperature=0.0, max_new_tokens=fuse + 4))
    sched.run()
    sched.pop_result(100_000)
    _sync(torch)
    samp = SamplingParams(temperature=0.0, max_new_tokens=max_new or MOE_SERVE["max_new"])
    stats0 = dict(eng.stats)
    K.reset_launches()
    t0 = time.perf_counter()
    sched.submit(1, prompts[1], samp)
    sched.tick()
    for u in sorted(prompts)[1:]:
        sched.submit(u, prompts[u], samp)
    sched.run()
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    results = {u: sched.pop_result(u) for u in prompts}
    d = {k: eng.stats[k] - stats0[k] for k in eng.stats}
    audit = eng.close()
    return dict(results=results, wall=wall, d=d, launches=launches, close=audit)


def moe_serve_replay(torch, K, cfg):
    """``cfg``'s first 2 layers at full width through the v2 scheduler in
    bf16, per tick and in bursts (``MOE_REPLAY``): the bursts
    token-identical to the per-tick run, every pick near the CPU's fp32
    argmax over the same stream (the CPU routes its own experts, dropless
    as the engine does)."""
    import numpy as np
    from deepspeed_tpu_torch.models.transformer import init_params

    z = MOE_REPLAY
    cfg2 = cfg.replace(num_layers=z["layers"])
    params2 = init_params(cfg2, seed=SEED, device=DEVICE)
    rng = np.random.default_rng(SEED + 5)
    prompts = {u: rng.integers(1, cfg.vocab_size, z["prompt_len"]).tolist()
               for u in range(1, z["n_req"] + 1)}
    streams, launches, bursts = {}, {k: 0 for k in K.LAUNCHES}, {}
    for fuse in (1, z["burst"]):
        r = moe_serve_run(torch, K, params2, cfg2, fuse, None, prompts, z["max_new"])
        streams[fuse], bursts[fuse] = r["results"], r["d"]["decode_bursts"]
        for k in launches:
            launches[k] += r["launches"][k]
    worst, exact, total = replay_on_cpu(torch, _tree_cpu(params2), cfg2, prompts, streams[1])
    del params2
    _free(torch)
    res = dict(layers=z["layers"], requests=z["n_req"], prompt_len=z["prompt_len"],
               new_tokens=z["max_new"], burst=z["burst"], bursts=bursts[z["burst"]],
               bursts_token_identical_to_per_tick=streams[1] == streams[z["burst"]],
               argmax_exact=f"{exact}/{total}", argmax_worst_gap=worst,
               tolerance=ARGMAX_TOL_FRAC)
    if (not res["bursts_token_identical_to_per_tick"] or not bursts[z["burst"]]
            or bursts[1] or worst > ARGMAX_TOL_FRAC
            or any(len(t) != z["max_new"] for t in streams[1].values())):
        raise AssertionError(f"moe_serve: 2-layer replay {res}")
    return res, launches


def moe_serve_phase(torch, K, gpu):
    """``mixtral_8x7b`` at full width, ``MOE_SERVE['layers']`` layers, bf16
    and then int8 weights (the experts stay bf16, as JAX's quantizer leaves
    them), each per tick and with ``decode_megastep`` bursts on fresh
    engines.  Gates: every request finishes with 64 tokens, the bursts are
    token-identical to the per-tick run, the kernels launched layers x
    dispatches (K1f / K3 on the prefills, K2 on every decode tick, K4 on the
    int8 runs), no block leaks.  Then v1's prefill logits against v2's on
    the same weights, on v1's own expert choices (``MOE_V1_LOGIT_TOL``)
    and on v2's (``MOE_V1_PINNED_TOL``), and the 2-layer copy replayed on
    the CPU (``moe_serve_replay``).  Returns the result and the 8-layer
    (cfg, params) for ``v1_serve``."""
    import numpy as np
    from deepspeed_tpu_torch.inference import init_inference
    from deepspeed_tpu_torch.models.presets import get_preset
    from deepspeed_tpu_torch.models.transformer import CausalLM, init_params

    t_phase = time.perf_counter()
    z = MOE_SERVE
    cfg = get_preset("mixtral_8x7b", num_layers=z["layers"], max_seq_len=512)
    params = init_params(cfg, seed=SEED, device=DEVICE)
    rng = np.random.default_rng(SEED)
    sys_prompt = rng.integers(1, cfg.vocab_size, z["sys_len"]).tolist()
    prompts = {u: sys_prompt + rng.integers(1, cfg.vocab_size, z["sfx_len"]).tolist()
               for u in range(1, z["n_req"] + 1)}
    L = cfg.num_layers
    runs, launches = {}, {k: 0 for k in K.LAUNCHES}
    for quant in (None, "int8"):
        pair = {}
        for fuse in (1, z["burst"]):
            r = moe_serve_run(torch, K, params, cfg, fuse, quant, prompts)
            d, lc = r["d"], r["launches"]
            label = f"{quant or 'bf16'}_x{fuse}"
            bad = [u for u, t in r["results"].items() if len(t) != z["max_new"]]
            if bad or r["close"]["blocks_in_use"]:
                raise AssertionError(f"moe_serve {label}: unfinished {bad}, {r['close']}")
            if (d["decode_bursts"] > 0) != (fuse > 1):
                raise AssertionError(f"moe_serve {label}: {d['decode_bursts']} bursts")
            if (lc["paged_decode"] != L * (d["decode_ticks"] + d["burst_ticks"])
                    or lc["flash_fwd"] + lc["ctx_attention"] != L * d["prefill_dispatches"]
                    or not lc["flash_fwd"] or not lc["ctx_attention"]
                    or (quant == "int8") != (lc["quant_matmul_int8"] > 0)):
                raise AssertionError(f"moe_serve {label}: launches {lc}, stats {d}")
            gen = sum(len(t) for t in r["results"].values())
            runs[label] = dict(decode_megastep=fuse, weights=quant or "bf16", wall_s=r["wall"],
                               generated_tokens_per_s=gen / r["wall"],
                               effective_tokens_per_s=(gen + sum(map(len, prompts.values())))
                               / r["wall"], prefill_dispatches=d["prefill_dispatches"],
                               prefix_hit_blocks=d.get("prefix_hit_blocks"),
                               decode_ticks=d["decode_ticks"], bursts=d["decode_bursts"],
                               burst_ticks=d["burst_ticks"],
                               launches={n: lc[n] for n in ("flash_fwd", "ctx_attention",
                                                            "paged_decode",
                                                            "quant_matmul_int8")})
            pair[fuse] = r["results"]
            for k in launches:
                launches[k] += lc[k]
        if pair[1] != pair[z["burst"]]:
            diff = [u for u in pair[1] if pair[1][u] != pair[z["burst"]][u]]
            raise AssertionError(f"moe_serve {quant or 'bf16'}: bursts differ from the "
                                 f"per-tick run in streams {diff}")
    # v1 on the same weights: its prefill logits against v2's runner, on
    # its own expert choices and on v2's (the packed prefill's rows are the
    # [2, 128] batch's in order: no padding at 128)
    from deepspeed_tpu_torch.models.transformer import init_kv_cache

    v1 = init_inference(CausalLM(cfg), params, device=DEVICE)
    heads = [prompts[u][:128] for u in (1, 2)]
    pin = RoutePin()
    with pin.record():
        v2_logits = card_prefill_logits(torch, params, cfg, heads)
    rng_row = (v2_logits.max(-1).values - v2_logits.min(-1).values)
    gaps, argmax_same = {}, {}
    for mode in ("own", "pinned"):
        with pin.replay() if mode == "pinned" else contextlib.nullcontext():
            v1_logits, _ = v1.prefill(torch.tensor(heads, device=DEVICE),
                                      init_kv_cache(cfg, 2, 129, device=DEVICE))
        gaps[mode] = float(((v1_logits - v2_logits).abs().max(-1).values / rng_row).max())
        argmax_same[mode] = f"{int((v1_logits.argmax(-1) == v2_logits.argmax(-1)).sum())}/2"
    routing = pin.summary()
    del v1
    if gaps["own"] > MOE_V1_LOGIT_TOL or gaps["pinned"] > MOE_V1_PINNED_TOL:
        raise AssertionError(f"moe_serve: v1 prefill logits off v2's {gaps} of the range "
                             f"(limits {MOE_V1_LOGIT_TOL}, {MOE_V1_PINNED_TOL}), {routing}")
    replay, ran = moe_serve_replay(torch, K, cfg)
    for k in launches:
        launches[k] += ran[k]
    res = dict(phase="moe_serve", model="mixtral_8x7b", **z,
               engine={k: (list(v) if isinstance(v, tuple) else v)
                       for k, v in MOE_SERVE_ENGINE.items()}, runs=runs,
               bursts_token_identical_to_per_tick=True, launches=launches,
               v1_vs_v2_prefill=dict(prompts=2, prompt_len=128, max_gap_frac=gaps["own"],
                                     tolerance=MOE_V1_LOGIT_TOL, argmax_same=argmax_same,
                                     max_gap_frac_on_v2_routing=gaps["pinned"],
                                     tolerance_on_v2_routing=MOE_V1_PINNED_TOL,
                                     v1_routing_against_v2=routing),
               two_layer_replay=replay,
               seconds=time.perf_counter() - t_phase, gpu=gpu)
    emit(res)
    return res, (cfg, params)


def _cpu_rows_logits(torch, params_cpu, cfg, tokens, rows):
    """fp32 logits of ``tokens`` [b, s] at the positions ``rows`` through
    the port's serving forward on the CPU (a dense cache filled from index
    0, so MoE layers route dropless as both engines do)."""
    from deepspeed_tpu_torch.models.transformer import forward, init_kv_cache, lm_logits

    cfg = cfg.replace(dtype=torch.float32)
    cache = init_kv_cache(cfg, tokens.shape[0], tokens.shape[1], device="cpu")
    with torch.no_grad():
        h, _, _ = forward(params_cpu, tokens, cfg, cache=cache, cache_index=0,
                          return_hidden=True)
        return lm_logits(params_cpu, cfg, h[:, rows])


def v1_serve_one(torch, K, name, cfg=None, params=None, replay=True):
    """``init_inference`` on ``name`` at full depth (or the given cfg and
    params): batch 4, 128-token prompts, 32 greedy tokens, timed; each
    attention call's body counted (``transformer.CACHE_ATTENTION``); a
    prefill that fills its whole cache (JAX's flash case); then, with
    ``replay``, a 2-layer full-width copy near-argmax against the CPU."""
    import numpy as np
    from deepspeed_tpu_torch.inference import InferenceEngine, init_inference
    from deepspeed_tpu_torch.inference.sampling import SamplingParams
    from deepspeed_tpu_torch.models import transformer as T
    from deepspeed_tpu_torch.models.presets import get_preset

    t_one = time.perf_counter()
    B, n, new = (V1_SIZES[k] for k in ("batch", "prompt_len", "new"))
    cfg = cfg or get_preset(name)
    params = params if params is not None else T.init_params(cfg, seed=SEED, device=DEVICE)
    eng = init_inference(T.CausalLM(cfg), params, device=DEVICE)
    prompts = np.random.default_rng(SEED).integers(1, cfg.vocab_size, (B, n))
    eng.generate(prompts[:1, :16], SamplingParams(max_new_tokens=2))  # warm-up
    _sync(torch)
    T.CACHE_ATTENTION.update(flash=0, plain=0)
    K.reset_launches()
    t0 = time.perf_counter()
    out = eng.generate(prompts, SamplingParams(max_new_tokens=new))  # returns host ids
    gen_s = time.perf_counter() - t0
    bodies = dict(T.CACHE_ATTENTION)
    cache = T.init_kv_cache(cfg, B, n + 1, device=DEVICE)
    t0 = time.perf_counter()
    eng.prefill(torch.as_tensor(prompts, device=DEVICE), cache)
    _sync(torch)
    prefill_s = time.perf_counter() - t0
    del cache
    L = cfg.num_layers
    if out.shape != (B, new) or out.min() < 0 or out.max() >= cfg.vocab_size:
        raise AssertionError(f"v1_serve {name}: ids {out.shape} out of range")
    if bodies != {"flash": 0, "plain": L * (1 + new)}:
        raise AssertionError(f"v1_serve {name}: attention bodies {bodies}, want "
                             f"{L * (1 + new)} plain")
    # a prefill that fills the whole cache: JAX's flash case where its
    # predicate holds (here: not ALiBi's reference body)
    full = InferenceEngine(eng.model, eng.params, max_seq_len=n, device=DEVICE)
    T.CACHE_ATTENTION.update(flash=0, plain=0)
    full.generate(prompts, SamplingParams(max_new_tokens=4))
    full_bodies = dict(T.CACHE_ATTENTION)
    launches = dict(K.LAUNCHES)
    q = torch.empty(1, n, cfg.num_heads, cfg.hd)
    kk = torch.empty(1, n, cfg.num_kv_heads, cfg.hd)
    flash_ok = cfg.attn_impl in ("flash", "auto") and T.flash_supports(q, kk, 0)
    if full_bodies != ({"flash": L, "plain": 0} if flash_ok else {"flash": 0, "plain": L}) \
            or launches["flash_fwd"] != (L if flash_ok else 0):
        raise AssertionError(f"v1_serve {name}: full-cache prefill bodies {full_bodies}, "
                             f"flash_fwd {launches['flash_fwd']}")
    del eng, full
    res = dict(model=name, layers=L, heads=cfg.num_heads, kv_heads=cfg.num_kv_heads,
               head_dim=cfg.hd, position=cfg.position, parallel_block=cfg.parallel_block,
               experts=cfg.moe_num_experts, batch=B, prompt_len=n, new_tokens=new,
               generate_s=gen_s, prefill_s=prefill_s,
               decode_tokens_per_s=B * new / max(gen_s - prefill_s, 1e-9),
               attention_bodies=bodies, full_cache_prefill_bodies=full_bodies)
    if replay:
        cfg2 = cfg.replace(num_layers=2)
        params2 = T.init_params(cfg2, seed=SEED, device=DEVICE)
        b2, n2, new2 = (V1_REPLAY[k] for k in ("batch", "prompt_len", "new"))
        gen2 = init_inference(T.CausalLM(cfg2), params2, device=DEVICE).generate(
            prompts[:b2, :n2], SamplingParams(max_new_tokens=new2))
        seqs = torch.as_tensor(np.concatenate([prompts[:b2, :n2], gen2[:, :-1]], 1))
        logits = _cpu_rows_logits(torch, _tree_cpu(params2), cfg2, seqs,
                                  list(range(n2 - 1, n2 - 1 + new2)))
        worst, exact = 0.0, 0
        for row, picks in zip(logits, gen2):
            w, e = near_argmax(torch, row, torch.as_tensor(picks, dtype=torch.long))
            worst, exact = max(worst, w), exact + e
        del params2
        res.update(two_layer_argmax_exact=f"{exact}/{b2 * new2}",
                   two_layer_argmax_worst_gap=worst)
        if worst > ARGMAX_TOL_FRAC:
            raise AssertionError(f"v1_serve {name}: 2-layer pick off the CPU argmax {worst}")
    res["seconds"] = time.perf_counter() - t_one
    return res, launches


def v1_narrow_check(torch):
    """The narrow MoE config: v1 on the card in fp32 (the plain attention
    body, fp32 throughout) token-identical to v1 and v2 on the CPU in fp32.
    v2 cannot run fp32 on the card (its kernels take bf16): its bf16 run is
    held token-identical to v1 on the card and, pick by pick, near the
    CPU's fp32 argmax over its own stream (``ARGMAX_TOL_FRAC``)."""
    import numpy as np
    from deepspeed_tpu_torch.inference import init_inference
    from deepspeed_tpu_torch.inference.engine_v2 import InferenceEngineV2
    from deepspeed_tpu_torch.inference.sampling import SamplingParams
    from deepspeed_tpu_torch.models import transformer as T
    from deepspeed_tpu_torch.models.presets import get_preset

    cfg = get_preset("mixtral_8x7b", dtype=torch.float32, max_seq_len=256, **MOE_NARROW)
    params = T.init_params(cfg, seed=SEED, device="cpu", dtype=torch.float32)
    prompts = np.random.default_rng(SEED + 1).integers(1, cfg.vocab_size, (2, 40))
    samp = SamplingParams(max_new_tokens=16)
    card = init_inference(T.CausalLM(cfg), _to(params, DEVICE), device=DEVICE).generate(
        prompts, samp)
    cpu = init_inference(T.CausalLM(cfg), params, device="cpu").generate(prompts, samp)
    v2_kw = dict(max_seqs=2, num_blocks=32, block_size=16, prefill_buckets=(64,))
    v2_cpu = InferenceEngineV2(params, cfg, device="cpu", **v2_kw)
    v2_cpu_out = [v2_cpu.generate(p.tolist(), samp) for p in prompts]
    cfg16 = cfg.replace(dtype=torch.bfloat16)
    v2_card = InferenceEngineV2(_to(params, DEVICE, torch.bfloat16), cfg16, device=DEVICE,
                                **v2_kw)
    v2_card_out = np.asarray([v2_card.generate(p.tolist(), samp) for p in prompts])
    v2_card.close()
    seqs = torch.as_tensor(np.concatenate([prompts, v2_card_out[:, :-1]], 1))
    logits = _cpu_rows_logits(torch, params, cfg, seqs, list(range(39, 39 + 16)))
    worst = max(near_argmax(torch, row, torch.as_tensor(p, dtype=torch.long))[0]
                for row, p in zip(logits, v2_card_out))
    res = dict(config=dict(MOE_NARROW), new_tokens=16,
               v1_card_fp32_equals_cpu_v1_and_v2=bool(
                   np.array_equal(card, cpu) and np.array_equal(cpu, np.asarray(v2_cpu_out))),
               v2_card_bf16_token_match_v1=f"{int((v2_card_out == card).sum())}/{card.size}",
               v2_card_bf16_argmax_worst_gap=worst, tolerance=ARGMAX_TOL_FRAC)
    if (not res["v1_card_fp32_equals_cpu_v1_and_v2"] or not np.array_equal(v2_card_out, card)
            or worst > ARGMAX_TOL_FRAC):
        raise AssertionError(f"v1_serve: narrow MoE {res}: v1 card {card.tolist()} / CPU "
                             f"{cpu.tolist()} / v2 CPU {v2_cpu_out} / v2 card "
                             f"{v2_card_out.tolist()}")
    return res


def v1_serve_phase(torch, K, gpu, moe):
    """``init_inference`` on the ALiBi and parallel-block families at full
    depth, one at a time, each freed before the next; then on the
    ``moe_serve`` Mixtral weights (``moe``: its cfg and params) and the
    narrow MoE check."""
    t_phase = time.perf_counter()
    runs, launches = {}, {k: 0 for k in K.LAUNCHES}
    for name in V1_SERVE:
        runs[name], ran = v1_serve_one(torch, K, name)
        for k in launches:
            launches[k] += ran[k]
        _free(torch)
    cfg, params = moe
    runs["mixtral_8x7b"], ran = v1_serve_one(torch, K, "mixtral_8x7b", cfg, params,
                                             replay=False)
    for k in launches:
        launches[k] += ran[k]
    narrow = v1_narrow_check(torch)
    res = dict(phase="v1_serve", runs=runs, narrow_moe=narrow, launches=launches,
               seconds=time.perf_counter() - t_phase, gpu=gpu)
    emit(res)
    return res


# ---------------------------------------------------------------------------
# quantized serving: kernel checks, quant_check, quant_serve, quantizer
# ---------------------------------------------------------------------------
QMM_NAMES = {"int8": "quant_matmul_int8", "fp8": "quant_matmul_fp8", "fp6": "quant_matmul_fp6"}
K6_NAMES = ("quantize_int8", "quantize_fp8", "dequantize")


def _payloads(torch, w):
    """{kernel name: the int8 / e4m3 / fp6 serving payload of w}."""
    from deepspeed_tpu_torch.ops.quantizer import (
        quantize_serving_weight,
        quantize_serving_weight_fp6,
    )

    return {QMM_NAMES["int8"]: quantize_serving_weight(w, "int8"),
            QMM_NAMES["fp8"]: quantize_serving_weight(w, "fp8"),
            QMM_NAMES["fp6"]: quantize_serving_weight_fp6(w)}


def _qmm(name, p, x, bias=None, plain=False):
    """K4 / K5 (or its plain version) on payload ``p``."""
    from deepspeed_tpu_torch.ops.kernels import quant_matmul as QM

    if name == QMM_NAMES["fp6"]:
        fn = QM.quant_matmul_fp6_plain if plain else QM.quant_matmul_fp6_kernel
        return fn(x, p.packed, p.s, p.in_dim, bias)
    return (QM.quant_matmul_plain if plain else QM.quant_matmul_kernel)(x, p.q, p.s, bias)


def _as_bytes(torch, t):
    return t.view(torch.uint8) if t.element_size() == 1 else t


def quant_codes_check(torch, gen):
    """Every weight code decodes exactly: K4 / K5 on x = the identity [256,
    256] with unit scales return the decoded weight itself, bit for bit
    equal to the plain version's (int8: all 256 bytes; e4m3: all but the
    two NaN codes; fp6: random plane bytes, every code many times).  A
    decode that flushed subnormals (e4m3 exponent 0, e2m3 exponent 0) or
    rounded would differ here; the random-weight cases could hide it."""
    from deepspeed_tpu_torch.ops.kernels import quant_matmul as QM

    k, n = 256, 128
    x = torch.eye(k, device=DEVICE, dtype=torch.bfloat16)
    s = torch.ones(n, device=DEVICE)
    codes = torch.randint(0, 256, (k, n), generator=gen, device=DEVICE,
                          dtype=torch.int32).to(torch.uint8)
    codes[:, 0] = torch.arange(256, device=DEVICE).to(torch.uint8)
    e4m3 = codes.clone()
    e4m3[(e4m3 & 0x7F) == 0x7F] = 0  # NaN
    planes = torch.randint(0, 256, (3, k // 4, n), generator=gen, device=DEVICE,
                           dtype=torch.int32).to(torch.uint8)
    runs = {QMM_NAMES["int8"]: lambda f: f(x, codes.view(torch.int8), s),
            QMM_NAMES["fp8"]: lambda f: f(x, e4m3.view(torch.float8_e4m3fn), s)}
    cases = []
    for name, run in runs.items():
        got, ref = run(QM.quant_matmul_kernel), run(QM.quant_matmul_plain)
        cases.append((name, got, ref))
    cases.append((QMM_NAMES["fp6"], QM.quant_matmul_fp6_kernel(x, planes, s, k),
                  QM.quant_matmul_fp6_plain(x, planes, s, k)))
    torch.cuda.synchronize()
    out = []
    for name, got, ref in cases:
        bad = int((got.view(torch.int16) != ref.view(torch.int16)).sum())
        out.append(dict(kernel=name, case="all_codes_identity_K256_N128",
                        elements_differing=bad, limit=0))
        if bad:
            raise AssertionError(f"{name}: {out[-1]} (every code must decode exactly)")
    return out


K6_DTYPES = ("int8", "float8_e4m3fn", "float8_e5m2")


def row_quant_inputs(torch, gen):
    """(label, x) pairs for the row quantizers on the card: the quantizer
    API's [4096, 14336] bf16 shape with edge rows (a zero row, an inf, a
    NaN, -inf beside NaN, a subnormal amax, an amax just above the 1e-12
    floor, an outlier that sends the rest to fp8's subnormals), an N that
    is not a multiple of 16 (every row's chunks start at another column),
    fp32 and fp16 rows, rows wider than the kernel's registers hold, tiny
    rows, and a tensor whose base is not 16-byte aligned."""
    x = _randn(torch, (4096, 14336), gen, torch.bfloat16)
    x[7] = 0.0  # scale max(0, 1e-12) / qmax
    x[11, 5] = float("inf")
    x[12, 9000] = float("nan")
    x[13, 3], x[13, 4] = float("-inf"), float("nan")
    x[14] = (_randn(torch, (14336,), gen, torch.float32) * 1e-39).to(torch.bfloat16)
    x[15] = (_randn(torch, (14336,), gen, torch.float32) * 1e-12).to(torch.bfloat16)
    x[16] *= 1e-3
    x[16, 100] = 1e3
    yield "G4096_N14336_bf16_edges", x
    del x
    x = _randn(torch, (37, 14343), gen, torch.bfloat16)
    x[3, 14342], x[4, 0] = float("inf"), float("nan")
    yield "G37_N14343_bf16", x
    for dt in (torch.float32, torch.float16):
        x = _randn(torch, (64, 4100), gen, dt) * 3.0
        x[1, 17] = float("nan")
        yield f"G64_N4100_{str(dt).split('.')[-1]}", x
    yield "G8_N70001_bf16", _randn(torch, (8, 70001), gen, torch.bfloat16)
    yield "G5_N40_bf16", _randn(torch, (5, 40), gen, torch.bfloat16)
    base = _randn(torch, (33 * 1000 + 1,), gen, torch.bfloat16)
    yield "G33_N1000_bf16_base_off_by_2_bytes", base[1:].view(33, 1000)


def row_quant_agreement(torch, QK, x, dtype):
    """Quantize ``x`` to ``dtype`` (a torch dtype name) by the kernel and by
    the plain version on the card, dequantize the kernel's codes by K6b and
    by the plain version: how many q bytes, scales (bit for bit; two NaNs
    agree) and dequantized bf16 bit patterns differ, and the largest
    difference between finite codes / dequantized values."""
    dtype = getattr(torch, dtype)
    q, s = QK.quantize_kernel(x, dtype)
    d = QK.dequantize_kernel(q, s, torch.bfloat16)
    torch.cuda.synchronize()
    qp, sp = QK.quantize_rows_plain(x, dtype)
    dp = QK.dequantize_rows_plain(q, s, torch.bfloat16)

    def finite_err(a, b):
        a, b = a.float(), b.float()
        ok = torch.isfinite(a) & torch.isfinite(b)
        return float(torch.where(ok, a - b, 0.0).abs().max())

    both_nan = torch.isnan(s) & torch.isnan(sp)
    return dict(q_bytes_differing=int((_as_bytes(torch, q) != _as_bytes(torch, qp)).sum()),
                scales_differing=int(((s.view(torch.int32) != sp.view(torch.int32))
                                      & ~both_nan).sum()),
                nan_scales=int(torch.isnan(s).sum()),
                dequantized_bits_differing=int((d.view(torch.int16)
                                                != dp.view(torch.int16)).sum()),
                q_max_abs_err=finite_err(q, qp), dequantized_max_abs_err=finite_err(d, dp))


def quant_kernel_checks(torch):
    """K4 (int8, e4m3) and K5 at every 8B serving-matmul shape, M = 1, 16,
    300, 512 and 2048 (the decode tile of 16 tokens, a 256-token tile's
    ragged edge, the prefill tiles), plus ragged cases with a bias, each
    held by relative Frobenius error against the plain version in fp32 on
    the same bf16 input; every code decoded exactly (``quant_codes_check``);
    then K6a/b/c on ``row_quant_inputs``: q bytes, scales and the
    dequantized tensor identical to the plain version."""
    from deepspeed_tpu_torch.ops.kernels import quant_kernel as QK

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 20)
    errs = {n: 0.0 for n in (*QMM_NAMES.values(), *K6_NAMES)}
    cases = quant_codes_check(torch, gen)
    shapes = [(k, n, m, False) for k, n in QUANT_SHAPES_8B for m in QUANT_CHECK_M]
    shapes += [(4100, 1000, 5, True), (1024, 1040, 100, True)]  # ragged M, N, K
    # x rows through cp.async and weight rows through registers, and the reverse
    shapes += [(4096, 1000, 300, True), (1028, 1024, 17, True)]
    for k, n in dict.fromkeys((k, n) for k, n, _, _ in shapes):
        w = _randn(torch, (k, n), gen, torch.bfloat16) * k ** -0.5
        payloads = _payloads(torch, w)
        del w
        for m, with_bias in ((m, b) for kk, nn, m, b in shapes if (kk, nn) == (k, n)):
            x = _randn(torch, (m, k), gen, torch.bfloat16)
            bias = _randn(torch, (n,), gen, torch.float32) if with_bias else None
            for name, p in payloads.items():
                got = _qmm(name, p, x, bias)
                torch.cuda.synchronize()
                ref = _qmm(name, p, x.float(), bias, plain=True)
                if not bool(torch.isfinite(got).all()):
                    raise AssertionError(f"{name} M{m} K{k} N{n}: non-finite output")
                e = got.float() - ref
                rel = float(e.norm() / ref.norm())
                errs[name] = max(errs[name], float(e.abs().max()))
                cases.append(dict(kernel=name, case=f"M{m}_K{k}_N{n}" + ("_bias" if with_bias
                                                                          else ""),
                                  rel_fro_err=rel, limit=QMM_TOL,
                                  max_abs_err=float(e.abs().max())))
                if rel > QMM_TOL:
                    raise AssertionError(f"{name}: {cases[-1]} over the limit {QMM_TOL}")
                del got, ref, e
        del payloads
        _free(torch)

    for label, x in row_quant_inputs(torch, gen):
        for dtype in K6_DTYPES:
            row = row_quant_agreement(torch, QK, x, dtype)
            name = "quantize_int8" if dtype == "int8" else "quantize_fp8"
            errs[name] = max(errs[name], row.pop("q_max_abs_err"))
            errs["dequantize"] = max(errs["dequantize"], row.pop("dequantized_max_abs_err"))
            cases.append(dict(kernel=f"{name}+dequantize", case=f"{label}_to_{dtype}", **row,
                              limit=0))
            if row["q_bytes_differing"] or row["scales_differing"] or \
                    row["dequantized_bits_differing"]:
                raise AssertionError(f"{name}: {cases[-1]} (must be identical)")
        del x
    _free(torch)
    return errs, cases


def _stream_bytes(params):
    """Bytes of the serving matmuls' weights (what one forward streams)."""
    from deepspeed_tpu_torch.ops.quantizer import _SERVING_QUANT_PATHS, tree_nbytes

    def walk(node, path):
        for key, v in node.items():
            p = f"{path}/{key}" if path else key
            if isinstance(v, dict):
                yield from walk(v, p)
            elif any(p.endswith(t) for t in _SERVING_QUANT_PATHS):
                yield tree_nbytes(v)

    return sum(walk(params, ""))


def quant_check_phase(torch, K, gpu):
    """``llama3_8b`` at full width, 2 layers: for int8, fp8 and fp6 an
    engine on the card (bf16) serves 4 prompts of 64 tokens and 8 greedy
    steps; the same quantized payloads on the CPU replay every stream in
    fp32 through the plain versions (near-argmax, ARGMAX_TOL_FRAC); K4 / K5
    launched 7 x 2 + 1 times per forward."""
    import numpy as np
    from deepspeed_tpu_torch.inference.engine_v2 import InferenceEngineV2
    from deepspeed_tpu_torch.inference.sampling import SamplingParams
    from deepspeed_tpu_torch.models.presets import get_preset
    from deepspeed_tpu_torch.models.transformer import init_params

    cfg = get_preset("llama3_8b", num_layers=2, max_seq_len=2048)
    params = init_params(cfg, seed=SEED, device=DEVICE)
    B, prompt_len, steps = 4, 64, 8
    rng = np.random.default_rng(SEED)
    prompts = {u: rng.integers(1, cfg.vocab_size, prompt_len).tolist() for u in range(1, B + 1)}
    samp = SamplingParams(temperature=0.0, max_new_tokens=steps + 4)
    per_mm = 7 * cfg.num_layers + 1
    out, launches = {}, {n: 0 for n in K.LAUNCHES}
    for fmt, name in QMM_NAMES.items():
        eng = InferenceEngineV2(params, cfg, max_seqs=B, num_blocks=64, block_size=32,
                                prefill_buckets=(256,), prefill_budget=256,
                                quantize_weights=fmt)
        K.reset_launches()
        first = eng.put(list(prompts), list(prompts.values()), samp)
        gen = {u: [first[u]] for u in prompts}
        for _ in range(steps):
            for u, tok in eng.step(samp).items():
                gen[u].append(tok)
        got = dict(K.LAUNCHES)
        fwd = eng.stats["prefill_dispatches"] + eng.stats["decode_ticks"]
        if got[name] != per_mm * fwd:
            raise AssertionError(f"quant_check {fmt}: {name} launched {got[name]} times, "
                                 f"expected {per_mm} x {fwd} forwards")
        if any(t < 0 for g in gen.values() for t in g):
            raise AssertionError(f"quant_check {fmt}: non-finite logits")
        params_cpu = _tree_cpu(eng.params)
        if eng.close()["blocks_in_use"]:
            raise AssertionError(f"quant_check {fmt}: leaked blocks")
        del eng
        _free(torch)
        worst, exact, total = replay_on_cpu(torch, params_cpu, cfg, prompts, gen)
        del params_cpu
        if worst > ARGMAX_TOL_FRAC:
            raise AssertionError(f"quant_check {fmt}: card pick off the CPU argmax by {worst:.4f} "
                                 f"of the logit range > {ARGMAX_TOL_FRAC}")
        out[fmt] = dict(argmax_exact=f"{exact}/{total}", argmax_worst_gap_frac=worst,
                        launches_per_forward=got[name] / fwd, forwards=fwd)
        for n in launches:
            launches[n] += got[n]
    del params
    _free(torch)
    res = dict(phase="quant_check", model="llama3_8b", layers=cfg.num_layers, batch=B,
               prompt_len=prompt_len, decode_steps=steps, tolerance=ARGMAX_TOL_FRAC,
               formats=out, launches=launches, gpu=gpu)
    emit(res)
    return res


PROFILE_CATEGORIES = {  # substrings of device-kernel names, first match wins
    "quant_matmul (K4/K5)": ("qmm_",),
    "cublas_matmul": ("gemm", "nvjet", "xmma", "cutlass", "splitK"),
    "paged_decode (K2)": (K2_PROFILE_NAME,),
    "flash_fwd (K1f)": ("flash_fwd",),
}


def _categorize(rows):
    out = {c: 0.0 for c in PROFILE_CATEGORIES}
    out["other"] = 0.0
    for r in rows:
        cat = next((c for c, keys in PROFILE_CATEGORIES.items()
                    if any(k in r["name"] for k in keys)), "other")
        out[cat] += r["ms_per_call"]
    return out


def quant_serve_phase(torch, K, gpu):
    """``llama3_8b`` at full depth (``bench.py --serve8b`` at batch 16): for
    bf16 (plain weights, the anchor) then int8, fp8 and fp6 from one bf16
    tree on the card, 16 prompts of 128 tokens through ``put``, 4 warm-up
    and 32 timed greedy ``step``s, one profiled tick; then the burst: a
    ``step_n(2)`` that captures the tick, a timed ``step_n(32)`` (K4 / K5
    225 and K2 32 times a replayed tick) and a profiled ``step_n(8)``.
    Returns the phase result and layer 0's w_up (the quantizer phase's
    input)."""
    import numpy as np
    from deepspeed_tpu_torch.inference.engine_v2 import InferenceEngineV2
    from deepspeed_tpu_torch.inference.sampling import SamplingParams
    from deepspeed_tpu_torch.models.presets import get_preset
    from deepspeed_tpu_torch.models.transformer import init_params
    from deepspeed_tpu_torch.ops.quantizer import tree_nbytes

    cfg = get_preset("llama3_8b", max_seq_len=2048)
    L = cfg.num_layers
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, seed=SEED, device=DEVICE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    B, prompt_len, warm, steps = 16, 128, 4, 32
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(1, cfg.vocab_size, prompt_len).tolist() for _ in range(B)]
    uids = list(range(1, B + 1))
    samp = SamplingParams(temperature=0.0, max_new_tokens=warm + steps + 8)
    formats, launches = {}, {n: 0 for n in K.LAUNCHES}
    for fmt in (None, "int8", "fp8", "fp6"):
        t0 = time.perf_counter()
        eng = InferenceEngineV2(params, cfg, max_seqs=B, num_blocks=192, block_size=32,
                                prefill_buckets=(128, 256, 512), prefill_budget=512,
                                quantize_weights=fmt)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        K.reset_launches()
        t0 = time.perf_counter()
        first = eng.put(uids, prompts, samp)  # returns host tokens: synced
        prefill_s = time.perf_counter() - t0
        gen = {u: [first[u]] for u in uids}
        for _ in range(warm):
            eng.step(samp)
        tick_ms = []
        for _ in range(steps):
            t0 = time.perf_counter()
            out = eng.step(samp)  # fetches the sampled tokens: synced
            tick_ms.append(1e3 * (time.perf_counter() - t0))
            for u, tok in out.items():
                gen[u].append(tok)
        got = dict(K.LAUNCHES)
        d_prefill, d_ticks = eng.stats["prefill_dispatches"], eng.stats["decode_ticks"]
        qname = QMM_NAMES.get(fmt)
        want = {"flash_fwd": L * d_prefill, "paged_decode": L * d_ticks}
        for name in QMM_NAMES.values():
            want[name] = (7 * L + 1) * (d_prefill + d_ticks) if name == qname else 0
        bad = {n: (got[n], w) for n, w in want.items() if got[n] != w}
        if bad:
            raise AssertionError(f"quant_serve {fmt or 'bf16'}: launches (got, expected) {bad}")
        if any(t < 0 for g in gen.values() for t in g):
            raise AssertionError(f"quant_serve {fmt or 'bf16'}: non-finite logits")
        wall_ms, dev_ms, rows = _device_profile(torch, lambda: eng.step(samp), top=None)
        # the burst: a step_n(2) captures the tick, then step_n(steps) replays it
        eng.step_n(2, samp)
        K.reset_launches()
        t0 = time.perf_counter()
        eng.step_n(steps, samp)  # ends in its one fetch: synced
        burst_ms = 1e3 * (time.perf_counter() - t0)
        b_got = dict(K.LAUNCHES)
        b_want = {"paged_decode": L * steps,
                  **({qname: (7 * L + 1) * steps} if qname else {})}
        if any(b_got[k] != w for k, w in b_want.items()):
            raise AssertionError(f"quant_serve {fmt or 'bf16'}: burst launches {b_got}, want "
                                 f"{b_want}")
        per_replay = burst_graph_launches(eng)
        b_prof = burst_profile(torch, eng, samp, 8)
        eng.flush(uids)
        a = eng.mgr.allocator
        in_use = a.total_blocks - a.free_blocks - a.cached_blocks
        if in_use:
            raise AssertionError(f"quant_serve {fmt or 'bf16'}: {in_use} blocks in use "
                                 "after the flush")
        resident, stream = tree_nbytes(eng.params), _stream_bytes(eng.params)
        eng.close()
        del eng
        _free(torch)
        med = sorted(tick_ms)[len(tick_ms) // 2]
        formats[fmt or "bf16"] = dict(
            resident_weight_bytes=resident, stream_weight_bytes=stream,
            stream_bound_ms=1e3 * stream / PEAK_BYTES, setup_s=setup_s,
            decode_tick_ms_median=med, decode_tick_ms_min=min(tick_ms),
            decode_tick_ms_max=max(tick_ms), decode_tokens_per_s=B * 1e3 / med,
            effective_weight_gb_s=stream / med / 1e6,
            prefill_s=prefill_s, prefill_tokens_per_s=B * prompt_len / prefill_s,
            prefill_dispatches=d_prefill, decode_ticks=d_ticks,
            launches_per_forward={"flash_fwd": got["flash_fwd"] / d_prefill,
                                  "paged_decode": got["paged_decode"] / d_ticks,
                                  **({qname: got[qname] / (d_prefill + d_ticks)}
                                     if qname else {})},
            profile_tick_wall_ms=wall_ms, profile_tick_device_ms=dev_ms,
            device_idle_share=None if dev_ms is None else 1.0 - dev_ms / med,
            device_ms_by_category=_categorize(rows), profile_top=rows[:8],
            tick_ms_per_token=med / B, burst_ticks=steps, burst_ms_per_tick=burst_ms / steps,
            burst_ms_per_token=burst_ms / steps / B,
            burst_device_ms_per_tick=b_prof["device_ms_per_tick"],
            burst_device_ms_per_token=None if b_prof["device_ms_per_tick"] is None
            else b_prof["device_ms_per_tick"] / B,
            tick_device_ms_per_token=None if dev_ms is None else dev_ms / B,
            burst_idle_share=None if b_prof["device_ms_per_tick"] is None
            else 1.0 - b_prof["device_ms_per_tick"] / (burst_ms / steps),
            burst_profile_idle_share=b_prof["idle_share"], burst_profile_top=b_prof["top"],
            host_syncs_per_token={"burst": 1 / (steps * B), "per_tick": 1 / B},
            burst_copies={"htod": b_prof["htod_copies_per_burst"],
                          "dtoh": b_prof["dtoh_copies_per_burst"]},
            launches_per_replay=per_replay)
        for n in launches:
            launches[n] += got[n] + b_got[n]
    w_up0 = params["layers"]["mlp"]["w_up"][0].clone()
    peak = torch.cuda.max_memory_allocated()
    del params
    _free(torch)
    res = dict(phase="quant_serve", model="llama3_8b", layers=L, max_seq_len=2048, batch=B,
               prompt_len=prompt_len, warmup_steps=warm, timed_steps=steps,
               num_blocks=192, block_size=32, prefill_buckets=[128, 256, 512],
               prefill_budget=512, init_s=init_s, peak_memory_bytes=peak,
               formats=formats, launches=launches, gpu=gpu)
    emit(res)
    return res, w_up0


def quantizer_phase(torch, K, gpu, w):
    """The quantizer API (K6) on layer 0's w_up of the 8B tree, groups of
    its trailing dimension: ``quantize_int8`` -> ``dequantize``,
    ``quantize_fp8`` (e4m3, e5m2) -> ``dequantize``, ``fake_quantize_int8``.
    Each element is held to its format's rounding bound: int8 within half a
    step (s / 2) of x, fp8 within half an ulp (2^-(m+1) |x|, or half the
    subnormal step in the subnormal range), and the codes and scales equal
    the plain version's on the same rows, byte for byte."""
    from deepspeed_tpu_torch.ops import quantizer as Q
    from deepspeed_tpu_torch.ops.kernels import quant_kernel as QK

    gs = w.shape[-1]
    K.reset_launches()
    qi = Q.quantize_int8(w, gs)
    di = Q.dequantize(qi)
    fake = Q.fake_quantize_int8(w, gs)
    fp8 = {}
    for dtype in (torch.float8_e4m3fn, torch.float8_e5m2):
        qt = Q.quantize_fp8(w, dtype, gs)
        fp8[dtype] = (qt, Q.dequantize(qt))
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    want = {"quantize_int8": 2, "quantize_fp8": 2, "dequantize": 4}
    if any(launches[n] != v for n, v in want.items()):
        raise AssertionError(f"quantizer: launches {launches}, expected {want}")
    if not torch.equal(fake, di) or di.dtype != w.dtype or di.shape != w.shape:
        raise AssertionError("quantizer: fake_quantize_int8 != dequantize(quantize_int8)")
    differing = {}
    for dtype, qt in ((torch.int8, qi), *((d, v[0]) for d, v in fp8.items())):
        qp, sp = QK.quantize_rows_plain(w.reshape(-1, gs), dtype)
        differing[str(dtype).split(".")[-1]] = (
            int((_as_bytes(torch, qt.data).reshape(qp.shape) != _as_bytes(torch, qp)).sum()),
            int((qt.scales.view(torch.int32) != sp.view(torch.int32)).sum()))
    if any(sum(v) for v in differing.values()):
        raise AssertionError(f"quantizer: (bytes, scales) differing from the plain version "
                             f"{differing}")
    xf = w.float()
    s = qi.scales[:, None]
    step_err = float(((xf - qi.data.float() * s).abs() / s).max())
    res = dict(phase="quantizer", shape=list(w.shape), group_size=gs,
               bytes_and_scales_differing_from_plain=differing,
               int8_max_err_in_steps=step_err, limit_in_steps=0.5 + 1e-4,
               int8_rel_fro_err=float((di.float() - xf).norm() / xf.norm()))
    if step_err > 0.5 + 1e-4:  # + fp32 rounding of x / s and q * s
        raise AssertionError(f"quantizer: int8 error {step_err} steps > 0.5")
    for dtype, mbits, sub_step in ((torch.float8_e4m3fn, 3, 2.0 ** -9),
                                   (torch.float8_e5m2, 2, 2.0 ** -16)):
        qt, deq = fp8[dtype]
        s = qt.scales[:, None]
        err = (xf - qt.data.float() * s).abs()
        lim = torch.maximum(xf.abs() * 2.0 ** -(mbits + 1), 0.5 * sub_step * s) * (1 + 1e-5)
        over = int((err > lim).sum())
        key = str(dtype).split(".")[-1]
        res[f"{key}_elements_over_half_ulp"] = over
        res[f"{key}_rel_fro_err"] = float((deq.float() - xf).norm() / xf.norm())
        if over:
            raise AssertionError(f"quantizer: {over} {key} elements over half an ulp")
    res.update(launches=launches, gpu=gpu)
    emit(res)
    return res


def qmm_shape_times(torch, gen, plain=True):
    """{kernel name: {"M.. K.. N..": row}}: K4 / K5 at every 8B serving-matmul
    shape for M = 16 (a decode tick at batch 16) and M = 512 (a prefill
    dispatch), device time by CUDA-graph replay (``ms``) and back-to-back
    eager calls (``eager_ms``: the wrapper's host time shows there when it
    exceeds the kernel's), beside ``torch.matmul`` of x with the dequantized
    bf16 weight (what serving without quantization pays).  That yardstick's
    cost does not depend on the format, so it is timed once a shape and M,
    on the int8 payload's dequantized weight, and shared by the three rows.
    ``plain``: the plain version too, at [4096, 14336] only.  Bounds: every
    input read once and every output written once, the weight at its
    compressed size, over 3.35 TB/s, or 2 M K N over the bf16 tensor rate."""
    out = {name: {} for name in QMM_NAMES.values()}
    for k, n in QUANT_SHAPES_8B:
        w = _randn(torch, (k, n), gen, torch.bfloat16) * k ** -0.5
        payloads = _payloads(torch, w)
        del w
        p8 = payloads[QMM_NAMES["int8"]]
        deq = (p8.q.float() * p8.s).to(torch.bfloat16)
        for m in (16, 512):
            x = _randn(torch, (m, k), gen, torch.bfloat16)
            lib = lambda: torch.matmul(x, deq)  # noqa: E731
            library = dict(library_ms=graph_ms(torch, lib), library_eager_ms=time_ms(torch, lib))
            for name, p in payloads.items():
                wbytes = _nbytes(p.packed if name == QMM_NAMES["fp6"] else p.q, p.s)
                bound, by = _bound(2 * m * k * n, _nbytes(x) + wbytes + 2 * m * n)
                kern = lambda: _qmm(name, p, x)  # noqa: E731
                row = dict(shape=f"M{m} K{k} N{n}", ms=graph_ms(torch, kern),
                           eager_ms=time_ms(torch, kern), **library, bound_ms=bound,
                           bound_by=by)
                if plain and (k, n) == (4096, 14336):
                    row["plain_ms"] = time_ms(torch, lambda: _qmm(name, p, x, plain=True),
                                              iters=10)
                out[name][row["shape"]] = row
        del deq, payloads
        _free(torch)
    return out


def quant_timings(torch):
    """K4 / K5 by ``qmm_shape_times``; the kernel's top-level entry is [4096,
    14336] (w_up / w_gate: the most bytes a layer streams) at M 16, with M
    512 as ``at_prefill_shape``, the only shape where the plain version is
    timed.  K6 by ``quant_row_times``."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 30)
    out = {}
    for name, by_shape in qmm_shape_times(torch, gen).items():
        out[name] = dict(by_shape["M16 K4096 N14336"], by_shape=by_shape,
                         at_prefill_shape=by_shape["M512 K4096 N14336"],
                         library_note="torch.matmul of x with the dequantized bf16 weight "
                                      "(what serving without quantization pays), timed once "
                                      "a shape and M",
                         timing_note="ms and library_ms: CUDA-graph replay (device time); "
                                     "eager_ms: back-to-back calls (host time shows)")
    out.update(quant_row_times(torch, gen))
    return out


def quant_row_times(torch, gen, plain=True):
    """K6a (int8), K6c (e4m3; e5m2 beside it as ``quantize_fp8_e5m2``) and
    K6b (int8 -> bf16) on [4096, 14336] bf16 (the 8B tree's w_up, the
    quantizer API's shape): device time by CUDA-graph replay (``ms``) and
    back-to-back eager calls (``eager_ms``), the plain version eager
    (``plain``).  Bounds over 3.35 TB/s (every byte once: 2 in, 1 out an
    element, the scales) or 4 (quantize) and 2 (dequantize) operations an
    element over the fp32 rate."""
    from deepspeed_tpu_torch.ops.kernels import quant_kernel as QK

    x = _randn(torch, (4096, 14336), gen, torch.bfloat16)
    elems = x.numel()
    note = "null: no single PyTorch call computes a per-row amax-scaled quantization"
    out = {}
    for name, dtype in (("quantize_int8", torch.int8), ("quantize_fp8", torch.float8_e4m3fn),
                        ("quantize_fp8_e5m2", torch.float8_e5m2)):
        bound, by = _bound(4 * elems, 3 * elems + 4 * x.shape[0], PEAK_FP32_FLOPS)
        kern = lambda: QK.quantize_kernel(x, dtype)  # noqa: E731
        out[name] = dict(shape="G4096 N14336 bf16 -> " + str(dtype).split(".")[-1],
                         ms=graph_ms(torch, kern), eager_ms=time_ms(torch, kern),
                         library_ms=None, library_note=note, bound_ms=bound, bound_by=by)
        if plain:
            out[name]["plain_ms"] = time_ms(torch, lambda: QK.quantize_rows_plain(x, dtype))
    q, s = QK.quantize_kernel(x, torch.int8)
    bound, by = _bound(2 * elems, 3 * elems + 4 * x.shape[0], PEAK_FP32_FLOPS)
    kern = lambda: QK.dequantize_kernel(q, s)  # noqa: E731
    out["dequantize"] = dict(shape="G4096 N14336 int8 -> bf16", ms=graph_ms(torch, kern),
                             eager_ms=time_ms(torch, kern), library_ms=None,
                             library_note=note, bound_ms=bound, bound_by=by)
    if plain:
        out["dequantize"]["plain_ms"] = time_ms(torch, lambda: QK.dequantize_rows_plain(q, s))
    for row in out.values():
        row["timing_note"] = "ms: CUDA-graph replay (device time); eager_ms: back-to-back calls"
    del x, q, s
    _free(torch)
    return out


# ---------------------------------------------------------------------------
# phase 7: timings and bounds
# ---------------------------------------------------------------------------
def time_ms(torch, fn, iters=30, warm=3):
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def graph_ms(torch, fn, iters=20, reps=5):
    """Device ms per call of ``fn``: ``iters`` calls captured in one CUDA
    graph, the fastest of ``reps`` timed replays (no host time between the
    launches)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture, as graphs want
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    best = float("inf")
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        torch.cuda.synchronize()
        best = min(best, a.elapsed_time(b) / iters)
    del graph
    return best


def paired_ms(torch, kernel, library):
    """A kernel and its library yardstick timed alike: device ms by CUDA-graph
    replay (``ms``, ``library_ms``; no host time between launches) and by
    back-to-back eager calls (``eager_ms``, ``library_eager_ms``; the
    wrapper's host time shows where it exceeds the kernel's)."""
    return dict(ms=graph_ms(torch, kernel), eager_ms=time_ms(torch, kernel),
                library_ms=graph_ms(torch, library), library_eager_ms=time_ms(torch, library))


def _bound(flops, nbytes, peak_flops=PEAK_BF16_FLOPS):
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes), "operations" if t_ops > t_bytes else "bytes")


def _nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def timings(torch):
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.attention import dot_product_attention
    from deepspeed_tpu_torch.ops.kernels import flash_attention as K1

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 10)
    out = {}

    # K1f: the engine's cold pack, 16 prompts of 128 in T = 2048
    c = flash_case(torch, gen, [128] * 16, 0)
    q, k, v, seg = c["q"], c["k"], c["v"], c["segment_ids"]
    _, t, hq, hd = q.shape
    pairs = 16 * 128 * 129 // 2
    flops = 4 * hd * hq * pairs
    bound, by = _bound(flops, _nbytes(q, k, v, q, seg))
    mask = (seg[0][:, None] == seg[0][None, :]) & torch.ones(t, t, dtype=torch.bool,
                                                            device=DEVICE).tril()
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    out["flash_fwd"] = dict(
        shape=f"T{t} 16x128 hq{hq} hkv{k.shape[2]} hd{hd}",
        ms=time_ms(torch, lambda: K1.flash_attention_kernel(q, k, v, seg)),
        plain_ms=time_ms(torch, lambda: dot_product_attention(q, k, v, segment_ids=seg)),
        library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True)),
        bound_ms=bound, bound_by=by)

    out.update(paged_timings(torch, gen))
    out.update(train_timings(torch, gen))
    _free(torch)
    out["padded_head_dims"] = padded_timings(torch, gen)
    out.update(sparse_timings(torch, gen))
    return out


def paged_timings(torch, gen, plain=True):
    """K2 (the 410M decode shape and gpt2_small's, K2p's counterpart), K3 (the
    scheduler's prefix-hit pack and a verify tick's pack) and both partial
    modes, each by ``paired_ms`` beside its SDPA yardstick, with the bound;
    ``plain``: the plain versions' eager ms too."""
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.kernels import ctx_attention as K3
    from deepspeed_tpu_torch.ops.kernels import paged_attention as K2

    out = {}
    # K2: B = 64 decode over the paged pool (mixed lengths, 8 idle slots)
    out["paged_decode"] = decode_timing(torch, K2, decode_case(torch, gen), plain)
    out["paged_decode_hd64"] = decode_timing(torch, K2, decode_case(torch, gen, **GPT2_DECODE),
                                              plain)

    # K3: a prefix-hit pack, 4 suffixes of 64 over 512 cached tokens each
    c = ctx_case(torch, gen, sfx=(64, 64, 64, 64), ctx=(512, 512, 512, 512), bad_ids=False)
    t, hq, hd = c["q"].shape
    hkv = c["k"].shape[1]
    n_seg, sfx, ctx = 4, 64, 512
    flops = 4 * hd * hq * n_seg * (sfx * ctx + sfx * (sfx + 1) // 2)
    ctx_bytes = 2 * n_seg * ctx * hkv * hd * c["cache_k"].element_size()
    bound, by = _bound(flops, ctx_bytes + _nbytes(c["q"], c["k"], c["v"], c["q"],
                                                  c["segment_ids"], c["ctx_tables"]))
    # library yardstick: one SDPA call over each segment's [context | suffix]
    # keys gathered contiguously beforehand (the gather is not timed)
    ks = torch.randn(n_seg, hkv, ctx + sfx, hd, generator=gen, device=DEVICE).to(torch.bfloat16)
    vs = torch.randn(n_seg, hkv, ctx + sfx, hd, generator=gen, device=DEVICE).to(torch.bfloat16)
    qs = torch.randn(n_seg, hq, sfx, hd, generator=gen, device=DEVICE).to(torch.bfloat16)
    smask = torch.ones(sfx, ctx + sfx, dtype=torch.bool, device=DEVICE).tril(ctx)
    out["ctx_attention"] = dict(
        shape=f"T{t} N8 4x(512 ctx + 64 sfx)",
        **paired_ms(torch, lambda: K3.paged_attention_packed_ctx_kernel(**c),
                    lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=smask,
                                                           enable_gqa=True)),
        **_plain_ms(torch, plain, lambda: K3.paged_attention_packed_ctx_plain(**c)),
        bound_ms=bound, bound_by=by)
    del c, ks, vs, qs
    # K3 on a verify tick's pack (8 slots x 5 rows, mid-page contexts) at
    # the 410M model's heads
    hq, hkv, hd = 8, 2, 128
    c = verify_case(torch, gen, hq, hkv, hd)
    seg, lens = c["segment_ids"].long(), c["ctx_lens"].long()
    rows = torch.bincount(seg[seg > 0] - 1, minlength=lens.numel())  # pack rows per slot
    flops = 4 * hd * hq * int((rows * lens + rows * (rows + 1) // 2).sum())
    ctx_bytes = 2 * int(lens.sum()) * hkv * hd * c["cache_k"].element_size()
    bound, by = _bound(flops, ctx_bytes + _nbytes(c["q"], c["k"], c["v"], c["q"],
                                                  c["segment_ids"], c["ctx_tables"]))
    qs, ks, vs, smask = verify_sdpa_inputs(torch, c)
    got = K3.paged_attention_packed_ctx_kernel(**c)
    lib = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=smask, enable_gqa=True)
    out["ctx_attention"]["at_verify_shape"] = dict(
        shape=f"T40 N8 x (k+1 = 5) hq8 hkv2 hd128 ctx_lens {list(VERIFY_CTX)}",
        **paired_ms(torch, lambda: K3.paged_attention_packed_ctx_kernel(**c),
                    lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=smask,
                                                           enable_gqa=True)),
        **_plain_ms(torch, plain, lambda: K3.paged_attention_packed_ctx_plain(**c)),
        library_max_abs_err=_verify_rows_err(torch, got, lib, c),
        bound_ms=bound, bound_by=by)
    del c, qs, ks, vs, smask
    out["ctx_attention_partial"] = ctx_partial_timing(torch, K3, gen, plain)
    out["paged_decode_partial"] = decode_partial_timing(torch, K2, gen, plain)
    return out


def _plain_ms(torch, plain, fn):
    return dict(plain_ms=time_ms(torch, fn)) if plain else {}


def decode_timing(torch, K2, c, plain=True):
    """K2 on a ``decode_case``: kernel, plain version, the SDPA yardstick
    (``decode_sdpa_inputs``) and the bound (every live key and value row
    read once, q read and out written once; 4 hd flops per live (query
    head, key) pair)."""
    import torch.nn.functional as F

    b, hq, hd = c["q"].shape
    hkv = c["cache_k"].shape[2]
    live = int(c["seq_lens"].long().sum())
    kv_bytes = 2 * live * hkv * hd * c["cache_k"].element_size()
    bound, by = _bound(4 * hd * hq * live,
                       kv_bytes + _nbytes(c["q"], c["q"], c["block_table"], c["seq_lens"]))
    qs, ks, vs, mask = decode_sdpa_inputs(torch, c)
    got = K2.paged_attention_decode_kernel(**c)
    lib = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask, enable_gqa=True)
    live_rows = c["block_table"][:, 0] >= 0  # idle slots (all -1 tables) are not compared
    return dict(shape=f"B{b} hq{hq} hkv{hkv} hd{hd} bs{c['cache_k'].shape[1]} "
                      f"P{c['block_table'].shape[1]} live_tokens{live}",
                **paired_ms(torch, lambda: K2.paged_attention_decode_kernel(**c),
                            lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask,
                                                                   enable_gqa=True)),
                **_plain_ms(torch, plain, lambda: K2.paged_attention_decode_plain(**c)),
                library_max_abs_err=float((got[live_rows].float()
                                           - lib[live_rows, :, 0].float()).abs().max()),
                bound_ms=bound, bound_by=by)


def owned_keys(torch, tables, lens, nb, bs):
    """[rows, P * bs] bool: the key positions below ``lens`` whose page lies
    in ``[0, nb)`` (this shard's, under a translated table)."""
    page = tables.long().repeat_interleave(bs, dim=1)
    pos = torch.arange(page.shape[1], device=tables.device)
    return (pos[None, :] < lens.long()[:, None]) & (page >= 0) & (page < nb)


def _gather_owned(torch, c, ok, table_key):
    """Each row's owned keys (``owned_keys``) gathered contiguously, padded
    to the longest: (k, v [rows, L, hkv, hd], count [rows])."""
    nb, bs = c["cache_k"].shape[:2]
    count = ok.sum(1)
    L = max(int(count.max()), 1)
    order = torch.argsort((~ok).to(torch.int8), dim=1, stable=True)[:, :L]
    pages = c[table_key].long().gather(1, order // bs).clamp(0, nb - 1)
    return c["cache_k"][pages, order % bs], c["cache_v"][pages, order % bs], count


def decode_partial_timing(torch, K2, gen, plain=True):
    """The decode partial at the engine's decode shape (B 64, P 128, bs 32)
    striped over 2 shards, shard 0's view: kernel, plain version, the SDPA
    yardstick over the shard's owned keys (gathered beforehand, untimed,
    padded to the longest, length mask), and the bound (the owned key and
    value rows read once, q, the table and lengths read once, the fp32
    triple written once; 4 hd flops per owned (query head, key) pair)."""
    import torch.nn.functional as F

    S = 2
    c = shard_view(torch, decode_case(torch, gen, stripes=S), 0, S, "block_table")
    b, hq, hd = c["q"].shape
    nb, bs, hkv, _ = c["cache_k"].shape
    ok = owned_keys(torch, c["block_table"], c["seq_lens"], nb, bs)
    owned = int(ok.sum())
    triple = b * hq * (hd + 2) * 4
    bound, by = _bound(4 * hd * hq * owned,
                       2 * owned * hkv * hd * c["cache_k"].element_size() + triple
                       + _nbytes(c["q"], c["block_table"], c["seq_lens"]))
    k, v, count = _gather_owned(torch, c, ok, "block_table")
    mask = torch.arange(k.shape[1], device=DEVICE)[None, :] < count[:, None]
    qs, ks, vs = c["q"][:, :, None], k.transpose(1, 2), v.transpose(1, 2)
    return dict(shape=f"B{b} hq{hq} hkv{hkv} hd{hd} bs{bs} P{c['block_table'].shape[1]} "
                      f"shard 0 of {S} ({nb} of {nb * S} blocks) owned_keys{owned}",
                **paired_ms(torch, lambda: K2.paged_attention_decode_partial_kernel(**c),
                            lambda: F.scaled_dot_product_attention(
                                qs, ks, vs, attn_mask=mask[:, None, None], enable_gqa=True)),
                **_plain_ms(torch, plain,
                            lambda: K2.paged_attention_decode_partial_plain(**c)),
                bound_ms=bound, bound_by=by)


def ctx_partial_timing(torch, K3, gen, plain=True):
    """K3's partial mode at the scheduler's prefix-hit shape (T 256, N 8,
    4 x (512 ctx + 64 sfx)) striped over 2 shards, shard 0's view with the
    pack's own keys: kernel, plain version, the SDPA yardstick (each
    segment's owned context keys and its pack keys gathered beforehand,
    untimed; causal over the pack), and the bound (owned context rows, q and
    the pack's k / v read once, the fp32 triple written once; 4 hd flops
    per (query head, key) pair)."""
    import torch.nn.functional as F

    S, sfx = 2, 64
    c = shard_view(torch, ctx_case(torch, gen, sfx=(sfx,) * 4, ctx=(512,) * 4, bad_ids=False,
                                   stripes=S), 0, S, "ctx_tables")
    t, hq, hd = c["q"].shape
    nb, bs, hkv, _ = c["cache_k"].shape
    seg = c["segment_ids"].long()
    slots = torch.unique(seg[seg > 0]) - 1
    ok = owned_keys(torch, c["ctx_tables"][slots], c["ctx_lens"][slots], nb, bs)
    owned = ok.sum(1)  # per live slot
    pairs = int((sfx * owned).sum()) + len(slots) * sfx * (sfx + 1) // 2
    bound, by = _bound(4 * hd * hq * pairs,
                       2 * int(owned.sum()) * hkv * hd * c["cache_k"].element_size()
                       + t * hq * (hd + 2) * 4
                       + _nbytes(c["q"], c["k"], c["v"], c["segment_ids"], c["ctx_tables"],
                                 c["ctx_lens"]))
    k, v, count = _gather_owned(torch, dict(c, ctx_tables=c["ctx_tables"][slots]), ok,
                                "ctx_tables")
    L = int(count.max()) + sfx  # every slot owns the same count here
    rows = torch.stack([(seg == int(i) + 1).nonzero()[:, 0] for i in slots])  # [n, sfx]
    ks = torch.cat([k, c["k"][rows]], dim=1).transpose(1, 2)
    vs = torch.cat([v, c["v"][rows]], dim=1).transpose(1, 2)
    qs = c["q"][rows].transpose(1, 2)
    smask = torch.ones(sfx, L, dtype=torch.bool, device=DEVICE).tril(L - sfx)
    return dict(shape=f"T{t} N8 4x(512 ctx + 64 sfx) shard 0 of {S} ({nb} of {nb * S} blocks), "
                      f"include_pack, owned_ctx_keys{int(owned.sum())}",
                **paired_ms(torch, lambda: K3.paged_attention_packed_ctx_partial_kernel(**c),
                            lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=smask,
                                                                   enable_gqa=True)),
                **_plain_ms(torch, plain,
                            lambda: K3.paged_attention_packed_ctx_partial_plain(**c)),
                bound_ms=bound, bound_by=by)


def _contiguous_ctx(cache, table_row, n):
    """The first ``n`` tokens of one slot's paged context, contiguous:
    [n, hkv, hd]."""
    pages = -(-n // cache.shape[1])
    return cache[table_row[:pages].long()].reshape(-1, *cache.shape[2:])[:n]


def decode_sdpa_inputs(torch, c):
    """The library yardstick of K2 (as the K3 row's): each slot's live keys
    gathered contiguously beforehand (the gather is not timed), padded to
    the longest, and a length mask; q as one query row a slot.  Returns
    (q [B, hq, 1, hd], k / v [B, hkv, L, hd], mask [B, 1, 1, L])."""
    lens = c["seq_lens"].long()
    n = int(lens.max())
    pages = -(-n // c["cache_k"].shape[1])
    idx = c["block_table"][:, :pages].long().clamp(min=0)
    b = idx.shape[0]
    k, v = (x[idx].reshape(b, -1, *x.shape[2:])[:, :n].transpose(1, 2).contiguous()
            for x in (c["cache_k"], c["cache_v"]))
    mask = torch.arange(n, device=lens.device)[None, :] < lens[:, None]
    return c["q"][:, :, None], k, v, mask[:, None, None]


def verify_sdpa_inputs(torch, c):
    """The library yardstick of K3 on a verify pack (``verify_case``
    layout: slot i's rows start at i (k + 1)): each slot's [context | pack]
    keys gathered contiguously beforehand, padded to the longest, and a
    mask that lets pack row r see the context and pack rows <= r.  Returns
    (q [N, hq, k+1, hd], k / v [N, hkv, L, hd], mask [N, 1, k+1, L])."""
    seg, lens = c["segment_ids"].long(), c["ctx_lens"].long()
    n_slots = lens.numel()
    k1 = seg.numel() // n_slots
    rows = torch.bincount(seg[seg > 0] - 1, minlength=n_slots).tolist()
    n = max(int(c_) + r for c_, r in zip(lens.tolist(), rows))
    hkv, hd = c["k"].shape[1:]
    ks, vs = (torch.zeros(n_slots, n, hkv, hd, dtype=c["k"].dtype, device=c["k"].device)
              for _ in range(2))
    for i, (c_, r) in enumerate(zip(lens.tolist(), rows)):
        for dst, pool, pack in ((ks, c["cache_k"], c["k"]), (vs, c["cache_v"], c["v"])):
            dst[i, :c_] = _contiguous_ctx(pool, c["ctx_tables"][i], c_)
            dst[i, c_:c_ + r] = pack[i * k1:i * k1 + r]
    q = c["q"].reshape(n_slots, k1, *c["q"].shape[1:]).transpose(1, 2)
    pos = torch.arange(n, device=lens.device)
    mask = pos[None, None, :] <= lens[:, None, None] + torch.arange(k1, device=lens.device)[
        None, :, None]
    return q, ks.transpose(1, 2), vs.transpose(1, 2), mask[:, None]


def _verify_rows_err(torch, got, lib, c):
    """Max abs difference of the live pack rows: K3's [T, hq, hd] against
    the yardstick's [N, hq, k+1, hd]."""
    live = c["segment_ids"] > 0
    flat = lib.transpose(1, 2).reshape(got.shape)
    return float((got[live].float() - flat[live].float()).abs().max())


def train_timings(torch, gen):
    """K1b (and K1f again) at the training flagship's per-call shape: b 8,
    s 4096, hq 8 / hkv 2, hd 128, no segments.  Bounds: 10 hd flops per
    causal (query, key, q-head) pair for the backward pair (6 hd for dq
    alone, 8 hd for dk/dv alone: each recomputes q.k and dO.v), 4 hd for the
    forward; bytes of each input read once and each output written once."""
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops import kernels as K
    from deepspeed_tpu_torch.ops.attention import dot_product_attention
    from deepspeed_tpu_torch.ops.kernels import flash_attention as K1

    b, s, hq, hkv, hd = 8, 4096, 8, 2, 128
    c = bwd_case(torch, gen, b, s, hq, hkv, hd)
    q, k, v, do = c["q"], c["k"], c["v"], c["do"]
    del c
    o, lse = K1.flash_attention_kernel(q, k, v, return_lse=True)
    pairs = b * hq * s * (s + 1) // 2
    shape = f"b{b} s{s} hq{hq} hkv{hkv} hd{hd} causal"
    delta = (o.float() * do.float()).sum(-1)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    sc, cap = K.scalars(hd ** -0.5, None)
    common = (K.ptr(q), K.ptr(k), K.ptr(v), None, K.ptr(do), K.ptr(lse), K.ptr(delta))
    ms_dq = time_ms(torch, lambda: K.launch("flash_bwd_dq", *common, K.ptr(dq),
                                            b, s, hq, hkv, hd, sc, cap), iters=5, warm=1)
    ms_dkv = time_ms(torch, lambda: K.launch("flash_bwd_dkv", *common, K.ptr(dk), K.ptr(dv),
                                             b, s, hq, hkv, hd, sc, cap), iters=5, warm=1)
    ms_pair = time_ms(torch, lambda: K1.flash_attention_bwd_kernel(q, k, v, None, o, lse, do),
                      iters=5, warm=1)
    ms_fwd = time_ms(torch, lambda: K1.flash_attention_kernel(q, k, v, return_lse=True),
                     iters=5, warm=1)
    del delta
    plain_bwd = time_ms(torch, lambda: K1.flash_attention_bwd_plain(
        q, k, v, None, o, lse, do, hd ** -0.5, None), iters=2, warm=1)
    plain_fwd = time_ms(torch, lambda: dot_product_attention(q, k, v), iters=2, warm=1)
    torch.cuda.empty_cache()
    # library yardsticks (timed only; the port never calls them): one
    # scaled_dot_product_attention call forward, and its backward alone
    qt, kt, vt, dot = (x.transpose(1, 2).contiguous().requires_grad_(x is not do)
                       for x in (q, k, v, do))
    lib_fwd = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True), iters=5, warm=1)
    lib_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
    lib_bwd = time_ms(torch, lambda: torch.autograd.grad(lib_out, (qt, kt, vt), dot,
                                                         retain_graph=True), iters=5, warm=1)
    qkvo = _nbytes(q, k, v, o, do, lse)
    b_pair = _bound(10 * hd * pairs, qkvo + _nbytes(q, k, v))
    b_dq = _bound(6 * hd * pairs, qkvo + _nbytes(q))
    b_dkv = _bound(8 * hd * pairs, qkvo + _nbytes(k, v))
    b_fwd = _bound(4 * hd * pairs, _nbytes(q, k, v, q, lse))
    bwd_note = ("plain_ms and library_ms time the whole backward (dq, dk and dv together): "
                "neither splits into the two kernels.  bound_ms counts this kernel's own "
                "work (6 hd flops per causal pair for dq, 8 hd for dk/dv), which includes "
                "the split's recompute of q.k and dO.v: the two add to more than the "
                "backward's own bound (10 hd), pair_bound_ms, beside pair_ms")
    pair = dict(pair_ms=ms_pair, pair_bound_ms=b_pair[0])
    return {
        "flash_bwd_dq": dict(shape=shape, ms=ms_dq, plain_ms=plain_bwd, library_ms=lib_bwd,
                             bound_ms=b_dq[0], bound_by=b_dq[1], note=bwd_note, **pair),
        "flash_bwd_dkv": dict(shape=shape, ms=ms_dkv, plain_ms=plain_bwd, library_ms=lib_bwd,
                              bound_ms=b_dkv[0], bound_by=b_dkv[1], note=bwd_note, **pair),
        "flash_bwd_pair": dict(shape=shape, ms=ms_pair, plain_ms=plain_bwd, library_ms=lib_bwd,
                               bound_ms=b_pair[0], bound_by=b_pair[1],
                               note="dq + dk/dv kernels and the delta reduction"),
        "flash_fwd_train": dict(shape=shape + " (with lse)", ms=ms_fwd, plain_ms=plain_fwd,
                                library_ms=lib_fwd, bound_ms=b_fwd[0], bound_by=b_fwd[1]),
    }


# the padded head dims timed per call: (preset, b, s, hq, hkv, hd) at the
# preset's heads, 2 rows of 2,048 tokens
PADDED_TIMED = (("phi_2", 2, 2048, 32, 32, 80), ("gpt_neox_20b", 2, 2048, 64, 64, 96))


def padded_timings(torch, gen):
    """K1f / K1b at head dims 80 and 96 through the ``flash_attention``
    entry (q / k / v zero-padded to 128, the kernels, o sliced back; the
    backward through the slice and the pad): the forward with its lse
    (``ms``) and the backward pair (``bwd_ms``), beside the plain versions
    and SDPA at the real head dim (the library yardstick: one call forward,
    its backward alone).  Bounds count the real head dim's work (4 hd flops
    a causal pair forward, 10 hd backward; each input read once, each
    output written once), so the padding shows as distance from them."""
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.attention import dot_product_attention
    from deepspeed_tpu_torch.ops.kernels import flash_attention as K1

    out = {}
    for preset, b, s, hq, hkv, hd in PADDED_TIMED:
        c = bwd_case(torch, gen, b, s, hq, hkv, hd)
        q, k, v, do = (c[n].requires_grad_(n != "do") for n in ("q", "k", "v", "do"))
        o = K1.flash_attention(q, k, v)
        fwd_ms = time_ms(torch, lambda: K1.flash_attention(q, k, v), iters=5, warm=1)
        bwd_ms = time_ms(torch, lambda: torch.autograd.grad(o, (q, k, v), do,
                                                            retain_graph=True), iters=5, warm=1)
        with torch.no_grad():
            plain_fwd = time_ms(torch, lambda: dot_product_attention(q, k, v), iters=2, warm=1)
            ol = K1.flash_attention_fwd_plain(q, k, v, None, hd ** -0.5, None)
            plain_bwd = time_ms(torch, lambda: K1.flash_attention_bwd_plain(
                q, k, v, None, ol[0], ol[1], do, hd ** -0.5, None), iters=2, warm=1)
        del ol
        qt, kt, vt = (x.detach().transpose(1, 2).contiguous().requires_grad_(True)
                      for x in (q, k, v))
        dot = do.transpose(1, 2).contiguous()
        lib_fwd = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), iters=5, warm=1)
        lib_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
        lib_bwd = time_ms(torch, lambda: torch.autograd.grad(lib_out, (qt, kt, vt), dot,
                                                             retain_graph=True), iters=5, warm=1)
        pairs = b * hq * s * (s + 1) // 2
        lse_bytes = b * hq * s * 4
        b_fwd = _bound(4 * hd * pairs, _nbytes(q, k, v, q) + lse_bytes)
        b_bwd = _bound(10 * hd * pairs, _nbytes(q, k, v, q, do, q, k, v) + lse_bytes)
        out[f"hd{hd}"] = dict(
            shape=f"{preset}: b{b} s{s} hq{hq} hkv{hkv} hd{hd} causal, padded to "
                  f"{K1.padded_head_dim(hd)}",
            ms=fwd_ms, plain_ms=plain_fwd, library_ms=lib_fwd, bound_ms=b_fwd[0],
            bound_by=b_fwd[1], bwd_ms=bwd_ms, bwd_plain_ms=plain_bwd, bwd_library_ms=lib_bwd,
            bwd_bound_ms=b_bwd[0], bwd_bound_by=b_bwd[1])
        del c, q, k, v, do, o, qt, kt, vt, dot, lib_out
        _free(torch)
    return out


def active_pairs(layout, block):
    """Causal (query, key) pairs inside the layout's active blocks, per head
    of one batch row: B^2 per block below the diagonal, B (B + 1) / 2 on it."""
    import numpy as np

    below = int(np.tril(layout, -1).sum())
    diag = int(np.diag(layout).sum())
    return below * block * block + diag * block * (block + 1) // 2


def sparse_timings(torch, gen):
    """K7f / K7b at the sparse flagship's per-call shape: b 8, s 4096, hq 8 /
    hkv 2, hd 128, fixed(128, 4, 1), no segments.  Bounds from this layout's
    active pairs: 4 hd flops a pair forward, 6 hd dq, 8 hd dk/dv, 10 hd the
    backward pair.  Library yardstick (timed only; the port never calls
    it): ``scaled_dot_product_attention`` with the layout and the causal
    mask expanded to an [s, s] bool mask, forward, and its backward alone;
    it computes the same function at dense cost."""
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops import kernels as K
    from deepspeed_tpu_torch.ops.kernels import sparse_attention as K7

    b, s, hq, hkv, hd = 8, 4096, 8, 2, 128
    layout, block = sparse_layout(SPARSE_FLAGSHIP, s)
    plan = K7.sparse_plan(layout, block, True, DEVICE)
    c = bwd_case(torch, gen, b, s, hq, hkv, hd)
    q, k, v, do = c["q"], c["k"], c["v"], c["do"]
    del c
    sc = hd ** -0.5
    o, lse = K7.sparse_attention_kernel(q, k, v, None, None, plan, sc, None)
    pairs = b * hq * active_pairs(layout, block)
    shape = f"b{b} s{s} hq{hq} hkv{hkv} hd{hd} fixed(128, 4, 1), {pairs} active pairs"
    delta = (o.float() * do.float()).sum(-1)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    scf, cap = K.scalars(sc, None)
    common = (K.ptr(q), K.ptr(k), K.ptr(v), None, None, K.ptr(do), K.ptr(lse), K.ptr(delta))
    n, max_a, max_t = plan.n, plan.tbl.shape[1], plan.tblT.shape[1]
    ms_dq = time_ms(torch, lambda: K.launch(
        "sparse_bwd_dq", *common, K.ptr(dq), K.ptr(plan.tbl), K.ptr(plan.cnt), K.ptr(plan.perm),
        b, s, hq, hkv, hd, block, max_a, scf, cap), iters=5, warm=1)
    ms_dkv = time_ms(torch, lambda: K.launch(
        "sparse_bwd_dkv", *common, K.ptr(dk), K.ptr(dv), K.ptr(plan.tblT), K.ptr(plan.cntT),
        K.ptr(plan.permT), b, s, hq, hkv, hd, block, max_t, scf, cap), iters=5, warm=1)
    ms_pair = time_ms(torch, lambda: K7.sparse_attention_bwd_kernel(
        q, k, v, None, None, o, lse, do, plan, sc, None), iters=5, warm=1)
    ms_fwd = time_ms(torch, lambda: K7.sparse_attention_kernel(q, k, v, None, None, plan, sc,
                                                               None), iters=5, warm=1)
    del delta
    plain_fwd = time_ms(torch, lambda: K7.sparse_attention_fwd_plain(
        q, k, v, None, None, plan.tbl, plan.cnt, block, sc, None), iters=2, warm=1)
    _free(torch)
    plain_bwd = time_ms(torch, lambda: K7.sparse_attention_bwd_plain(
        q, k, v, None, None, o, lse, do, plan.tbl, plan.cnt, block, sc, None), iters=2, warm=1)
    _free(torch)
    mask = (K7.element_mask(layout, block) & torch.ones(s, s, dtype=torch.bool).tril()).to(DEVICE)
    qt, kt, vt, dot = (x.transpose(1, 2).contiguous().requires_grad_(x is not do)
                       for x in (q, k, v, do))
    lib_fwd = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=True), iters=5, warm=1)
    lib_out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=True)
    lib_bwd = time_ms(torch, lambda: torch.autograd.grad(lib_out, (qt, kt, vt), dot,
                                                         retain_graph=True), iters=5, warm=1)
    del lib_out, qt, kt, vt, dot
    qkvo = _nbytes(q, k, v, o, do, lse)
    b_pair = _bound(10 * hd * pairs, qkvo + _nbytes(q, k, v))
    b_dq = _bound(6 * hd * pairs, qkvo + _nbytes(q))
    b_dkv = _bound(8 * hd * pairs, qkvo + _nbytes(k, v))
    b_fwd = _bound(4 * hd * pairs, _nbytes(q, k, v, q, lse))
    note = ("plain_ms and library_ms time the whole backward (dq, dk and dv together; the "
            "library's backward alone, library_fwd_bwd_ms with its forward)")
    lib = dict(library_ms=lib_bwd, library_fwd_bwd_ms=lib_fwd + lib_bwd)
    out = {
        "sparse_fwd": dict(shape=shape, ms=ms_fwd, plain_ms=plain_fwd, library_ms=lib_fwd,
                           bound_ms=b_fwd[0], bound_by=b_fwd[1]),
        "sparse_bwd_dq": dict(shape=shape, ms=ms_dq, plain_ms=plain_bwd, bound_ms=b_dq[0],
                              bound_by=b_dq[1], note=note, **lib),
        "sparse_bwd_dkv": dict(shape=shape, ms=ms_dkv, plain_ms=plain_bwd, bound_ms=b_dkv[0],
                               bound_by=b_dkv[1], note=note, **lib),
        "sparse_bwd_pair": dict(shape=shape, ms=ms_pair, plain_ms=plain_bwd,
                                bound_ms=b_pair[0], bound_by=b_pair[1],
                                note="dq + dk/dv kernels and the delta reduction", **lib),
    }
    return out


# ---------------------------------------------------------------------------
# ZeRO-Offload on one card (runtime/offload.py): the CPU tier streams the
# fp32 masters and Adam moments from pinned host memory through the card
# each step (K8 chunk by chunk); the NVMe tier keeps them in swap files and
# updates them with the host AdamW (csrc/host/host_adam.cpp)
# ---------------------------------------------------------------------------
OFFLOAD_PRESET = "llama3_proxy_410m"  # offload_check's widths and nvme_train's model
OFFLOAD_CHECK = dict(layers=2, seq=4096, micro=8, gas=2, steps=3)
# Lion and Lamb through the CPU tier against the plain engine, of max |p|:
# Lion is elementwise (exact expected), Lamb's per-leaf norms reduce the
# same leaf at another address, where a reduction may take another order
OFFLOAD_OPT_TOL = 1e-6
# the NVMe tier's masters against the plain engine's after one step, of
# max |p|: the same gradients (step 1 runs the same bf16 weights), the host
# AdamW against K8, both fp32: the host kernel rounds 1 - b2 in fp32
# arithmetic (1.3e-5 off K8's, from double) and contracts into FMAs, a few
# ulps.  From step 2 the bf16 compute copies see those ulps, and an entry
# whose gradient is bf16 noise can take Adam's full step of lr either way:
# the later steps are held to NVME_TOL + 2 lr (steps - 1) / max |p|
# (nvme_drift_bound)
NVME_TOL = 1e-6
# nvme_train's sequential losses against the train phase's first three
# (same weights, batch and config): step 1 runs the same bf16 weights; a
# few ulps in the masters move some bf16 roundings after it
NVME_LOSS_RTOL = 1e-3
# torch.cuda.memory_allocated() after a CPU-tier init against the compute
# copy + the fp32 gradient buffer + the staging chunks
OFFLOAD_MEM_TOL = 0.05
# depth capped at 20 of 32 layers (5.41 G parameters: 86.6 GB of state at 16
# bytes a parameter, past the card's 80 GB) to keep the whole smoke inside
# its time limit; the host's MemAvailable may cut it further
OFFLOAD_TRAIN = dict(model="llama3_8b", seq=4096, micro=1, gas=2, steps=3, max_layers=20)
OFFLOAD_PEAK_LIMIT = 75e9  # bytes: past it the phase runs remat full in place of dots
CARD_BYTES = 80e9  # the card's memory, against which the state must not fit
# host bytes left free beside the pinned state: the process, the page cache
# the disk phases use, the next phase's buffers
OFFLOAD_HOST_RESERVE = 10 << 30
# 2 sequential and 3 pipelined steps for the smoke's time limit: a step
# walks 5.17 GB of state at 1.1-1.2 GB/s
NVME_TRAIN = dict(seq_steps=2, pipe_steps=3, bench_mb=2048)


def _proc_memory():
    """MemTotal / MemAvailable from /proc/meminfo and this process's VmLck /
    VmPin / VmRSS from /proc/self/status, in bytes."""
    out = {"MemTotal": 0, "MemAvailable": 0, "VmLck": 0, "VmPin": 0, "VmRSS": 0}
    for path in ("/proc/meminfo", "/proc/self/status"):
        with open(path) as fh:
            for line in fh:
                key, _, rest = line.partition(":")
                if key in out:
                    out[key] = int(rest.split()[0]) * 1024
    return out


def host_sizes(torch, path=None):
    """What the host gives the offload tiers: ``free -b`` (total, used,
    free, available bytes), ``ulimit -l`` (RLIMIT_MEMLOCK, kB or
    "unlimited"), this process's locked / pinned / resident bytes, and the
    free bytes under ``path``."""
    import resource
    import shutil

    free = subprocess.run(["free", "-b"], capture_output=True, text=True, check=True).stdout
    mem = next(ln.split()[1:] for ln in free.splitlines() if ln.startswith("Mem:"))
    soft, _ = resource.getrlimit(resource.RLIMIT_MEMLOCK)
    out = dict(free_b=dict(zip(("total", "used", "free", "shared", "buff_cache",
                                "available"), map(int, mem))),
               ulimit_l="unlimited" if soft == resource.RLIM_INFINITY else soft // 1024,
               proc=_proc_memory())
    if path is not None:
        out["disk_free_bytes"] = shutil.disk_usage(path).free
        out["disk_path"] = path
    return out


def _offload_conf(micro, gas, opt=None, **zero):
    conf = bench_config(micro, gas)
    if opt is not None:
        conf["optimizer"] = {"type": opt, "params": NEW_OPTIMIZERS[opt]}
    conf["zero_optimization"].update(zero)
    return conf


def _masters_cpu(torch, engine):
    """The engine's fp32 masters by path, on the host (the swap files under
    the NVMe tier, pinned memory under the CPU tier)."""
    from deepspeed_tpu_torch.checkpoint.saving import export_fp32_state_dict

    return {k: v.detach().float().cpu()
            for k, v in _leaves(export_fp32_state_dict(engine)).items()}


def _rel_to_max(torch, got, ref):
    return max(float((got[k] - v).abs().max()) for k, v in ref.items()) / _max_abs(ref)


def _max_abs(tree):
    return max(float(v.abs().max()) for v in tree.values())


def nvme_drift_bound(lr, steps, ref):
    """NVME_TOL after one step, plus Adam's full step of ``lr`` either way
    on each later step, relative to max |p| of ``ref``."""
    return NVME_TOL + 2 * lr * (steps - 1) / _max_abs(ref)


def _close_engine(engine):
    if engine._offload is not None:
        engine._offload.close()
    if engine._nvme_opt is not None:
        engine.flush_nvme_pipeline()
        engine._nvme_opt.close()


def offload_check_phase(torch, K, gpu):
    """``offload_check``: the flagship's widths at 2 layers (seq 4096,
    micro 8, GAS 2, bf16): the CPU tier bit-identical to the plain engine
    (losses and masters), Lion and Lamb through it within
    OFFLOAD_OPT_TOL, the NVMe tier within NVME_TOL, a save after step 1
    resumed bit for bit under each tier, the state in pinned host memory and
    the card's bytes after init."""
    import shutil
    import tempfile

    import numpy as np
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.models.presets import get_preset
    from deepspeed_tpu_torch.models.transformer import CausalLM

    t_phase = time.perf_counter()
    z = OFFLOAD_CHECK
    cfg = get_preset(OFFLOAD_PRESET, num_layers=z["layers"], loss_chunk_size=2048)
    batches = [{"input_ids": b} for b in np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (z["steps"], z["gas"], z["micro"], z["seq"] + 1), dtype=np.int64)]
    tmp = tempfile.mkdtemp(prefix="dst_offload_check_")

    def make(opt=None, **zero):
        return initialize(model=CausalLM(cfg), config=_offload_conf(
            z["micro"], z["gas"], opt, **zero), device=DEVICE)[0]

    def run(engine, bs):
        return [float(engine.train_batch(b)) for b in bs]

    try:
        plain = make()
        p_losses = run(plain, batches[:1])
        p_masters1 = _masters_cpu(torch, plain)
        p_losses += run(plain, batches[1:])
        p_masters = _masters_cpu(torch, plain)
        del plain
        _free(torch)
        # the CPU tier: placement, the card's bytes, the run with a save after step 1
        before = torch.cuda.memory_allocated()
        tier = make(offload_optimizer="cpu")
        dev_bytes = torch.cuda.memory_allocated() - before
        mem = tier.memory_breakdown()["offload"]
        want_bytes = (mem["device_compute_bytes"] + mem["device_grad_bytes"]
                      + mem["device_staging_bytes"])
        mem_rel = abs(dev_bytes - want_bytes) / want_bytes
        host_state = [tier._offload.masters, *tier._offload.slot_flat]
        pinned = all(t.is_pinned() for t in host_state)
        K.reset_launches()
        c_losses = run(tier, batches[:1])
        tier.save_checkpoint(os.path.join(tmp, "cpu"), tag="s1")
        c_losses += run(tier, batches[1:])
        launches = dict(K.LAUNCHES)
        chunks = len(tier._offload.chunks)
        c_masters = _masters_cpu(torch, tier)
        _close_engine(tier)
        del tier
        _free(torch)
        resumed = make(offload_optimizer="cpu")
        resumed.load_checkpoint(os.path.join(tmp, "cpu"), tag="s1")
        r_losses = run(resumed, batches[1:])
        r_masters = _masters_cpu(torch, resumed)
        _close_engine(resumed)
        del resumed
        _free(torch)
        cpu_exact = c_losses == p_losses and all(torch.equal(c_masters[k], p_masters[k])
                                                 for k in p_masters)
        cpu_resume_exact = r_losses == c_losses[1:] and all(
            torch.equal(r_masters[k], c_masters[k]) for k in c_masters)
        # Lion and Lamb through the tier against the plain engine
        opt_errs = {}
        for opt in ("lion", "lamb"):
            ref = make(opt)
            run(ref, batches)
            ref_m = _masters_cpu(torch, ref)
            del ref
            _free(torch)
            got = make(opt, offload_optimizer="cpu")
            run(got, batches)
            opt_errs[opt] = _rel_to_max(torch, _masters_cpu(torch, got), ref_m)
            _close_engine(got)
            del got
            _free(torch)
        # the NVMe tier, with a save after step 1
        nvme_zero = dict(offload_optimizer={"device": "nvme",
                                            "nvme_path": os.path.join(tmp, "swap_a")})
        nv = make(**nvme_zero)
        n_losses = run(nv, batches[:1])
        nvme_err1 = _rel_to_max(torch, _masters_cpu(torch, nv), p_masters1)
        nv.save_checkpoint(os.path.join(tmp, "nvme"), tag="s1")
        n_losses += run(nv, batches[1:])
        n_masters = _masters_cpu(torch, nv)
        _close_engine(nv)
        del nv
        _free(torch)
        nvme_err = _rel_to_max(torch, n_masters, p_masters)
        lr = NEW_OPTIMIZERS["lion"]["lr"]  # bench_config's AdamW lr, 1e-4
        drift = nvme_drift_bound(lr, z["steps"], p_masters)
        nv2 = make(offload_optimizer={"device": "nvme", "nvme_path": os.path.join(tmp, "swap_b")})
        nv2.load_checkpoint(os.path.join(tmp, "nvme"), tag="s1")
        n2_losses = run(nv2, batches[1:])
        n2_masters = _masters_cpu(torch, nv2)
        _close_engine(nv2)
        del nv2
        _free(torch)
        nvme_resume_exact = n2_losses == n_losses[1:] and all(
            torch.equal(n2_masters[k], n_masters[k]) for k in n_masters)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    steps = z["steps"]
    res = dict(phase="offload_check", model="llama3_proxy_410m", layers=z["layers"],
               seq=z["seq"], micro_batch=z["micro"], gas=z["gas"], steps=steps,
               params=sum(v.numel() for v in p_masters.values()),
               plain_losses=p_losses, cpu_tier_losses=c_losses,
               cpu_tier_bit_identical=cpu_exact, cpu_tier_resume_bit_identical=cpu_resume_exact,
               state_pinned=pinned, host_state_bytes=mem["host_state_bytes"],
               pinned_bytes=mem["pinned_bytes"], device_bytes_after_init=dev_bytes,
               device_bytes_expected=want_bytes, device_bytes_rel_err=mem_rel,
               device_bytes_tolerance=OFFLOAD_MEM_TOL, chunks_per_step=chunks,
               optimizer_errs=opt_errs, optimizer_tolerance=OFFLOAD_OPT_TOL,
               nvme_losses=n_losses, nvme_masters_err_step1=nvme_err1,
               nvme_tolerance_step1=NVME_TOL, nvme_masters_err=nvme_err,
               nvme_drift_bound=drift,
               nvme_resume_bit_identical=nvme_resume_exact, launches=launches,
               launches_per_step={n: c / steps for n, c in launches.items() if c},
               seconds=time.perf_counter() - t_phase, gpu=gpu)
    emit(res)
    bad = []
    if not cpu_exact:
        bad.append("the CPU tier differs from the plain engine")
    if not cpu_resume_exact:
        bad.append("the CPU tier's resume differs from its uninterrupted run")
    if not pinned:
        bad.append("the CPU tier's state is not in pinned host memory")
    if mem_rel > OFFLOAD_MEM_TOL:
        bad.append(f"device bytes after init {dev_bytes} vs {want_bytes}")
    if launches["fused_adamw"] != steps * chunks:
        bad.append(f"K8 launched {launches['fused_adamw']} times, want {steps * chunks}")
    bad += [f"{o} through the tier: {e} > {OFFLOAD_OPT_TOL}"
            for o, e in opt_errs.items() if not e <= OFFLOAD_OPT_TOL]
    if not nvme_err1 <= NVME_TOL:
        bad.append(f"NVMe tier masters after step 1: {nvme_err1} > {NVME_TOL}")
    if not nvme_err <= drift:
        bad.append(f"NVMe tier masters after {steps} steps: {nvme_err} > {drift}")
    if not nvme_resume_exact:
        bad.append("the NVMe tier's resume differs from its uninterrupted run")
    if bad:
        raise AssertionError(f"offload_check: {bad}")
    return res


def _layer_params(torch, cfg):
    """(parameters outside the layers, parameters a layer) of ``cfg``."""
    one = cfg.replace(num_layers=1).param_count
    two = cfg.replace(num_layers=2).param_count
    return one - (two - one), two - one


def offload_depth(torch, cfg, avail):
    """The deepest depth <= ``cfg.num_layers`` and OFFLOAD_TRAIN's
    ``max_layers`` whose masters and two Adam moments (12 bytes a
    parameter) fit in ``avail`` host bytes less OFFLOAD_HOST_RESERVE;
    (depth, parameters)."""
    fixed, per = _layer_params(torch, cfg)
    depth = min(cfg.num_layers, OFFLOAD_TRAIN.get("max_layers", cfg.num_layers))
    while depth > 0 and 12 * (fixed + depth * per) > avail - OFFLOAD_HOST_RESERVE:
        depth -= 1
    return depth, fixed + depth * per


def _profile_split(rows, wall_ms):
    """A profiled step's device time by kind: host-to-device and
    device-to-host copies, K8, and every other kernel (forward, backward,
    casts); the compute stream's idle share (copies run on side streams)."""
    h2d = sum(r["ms_per_call"] for r in rows if "HtoD" in r["name"])
    d2h = sum(r["ms_per_call"] for r in rows if "DtoH" in r["name"])
    k8 = sum(r["ms_per_call"] for r in rows if "fused_adamw" in r["name"])
    other = sum(r["ms_per_call"] for r in rows) - h2d - d2h - k8
    return dict(h2d_ms=h2d, d2h_ms=d2h, k8_ms=k8, forward_backward_ms=other,
                compute_stream_idle_share=1.0 - (other + k8) / wall_ms)


def offload_train_phase(torch, K, gpu):
    """``offload_train``: ``llama3_8b`` at full width through the CPU tier
    (seq 4096, micro 1, GAS 2, bf16, AdamW), at full depth or the deepest
    the host's memory holds while the state still exceeds the card: a
    warm-up step (its peak picks remat dots or full), timed steps, a
    profiled step."""
    import numpy as np
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.models.presets import get_preset
    from deepspeed_tpu_torch.models.transformer import CausalLM, init_params

    t_phase = time.perf_counter()
    z = OFFLOAD_TRAIN
    sizes0 = host_sizes(torch)
    emit(dict(phase="offload_train_host", when="before init", **sizes0, gpu=gpu))
    full = get_preset(z["model"], loss_chunk_size=2048)
    depth, n_params = offload_depth(torch, full, sizes0["free_b"]["available"])
    state_bytes = 16 * n_params  # fp32 masters, gradients, m, v: a non-offloaded engine
    if state_bytes <= CARD_BYTES:
        raise AssertionError(f"offload_train: the host holds the state of {depth} layers "
                             f"({state_bytes} bytes), which the card holds too")
    cfg = full.replace(num_layers=depth)
    cut = None if depth == full.num_layers else (
        f"{depth} of {full.num_layers} layers: at most {z.get('max_layers')} (the smoke's "
        f"time limit), and 12 bytes a parameter of pinned host state must fit in "
        f"MemAvailable {sizes0['free_b']['available']} less {OFFLOAD_HOST_RESERVE} reserved")
    model = CausalLM(cfg)
    t0 = time.perf_counter()
    params = init_params(cfg, seed=SEED, device=DEVICE, dtype=torch.bfloat16)
    engine, _, _, _ = initialize(model=model, params=params, config=_offload_conf(
        z["micro"], z["gas"], offload_optimizer="cpu"), device=DEVICE)
    del params
    _free(torch)
    init_s = time.perf_counter() - t0
    sizes1 = host_sizes(torch)
    mem = engine.memory_breakdown()["offload"]
    emit(dict(phase="offload_train_host", when="after init", **sizes1,
              pinned_bytes_registered=mem["pinned_bytes"], gpu=gpu))
    batch = {"input_ids": np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (z["gas"], z["micro"], z["seq"] + 1), dtype=np.int64)}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    first = float(engine.train_batch(batch))  # warm-up
    warm_s = time.perf_counter() - t0
    warm_peak = torch.cuda.max_memory_allocated()
    remat = cfg.remat
    if warm_peak > OFFLOAD_PEAK_LIMIT:
        remat = "full"
        model.cfg = cfg.replace(remat="full")
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    steps = z["steps"] - 1
    step_s, losses = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(float(engine.train_batch(batch)))  # reads the loss: synced
        step_s.append(time.perf_counter() - t0)
    launches = dict(K.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    wall_ms, dev_ms, rows = _device_profile(torch, lambda: engine.train_batch(batch), top=None)
    split = _profile_split(rows, wall_ms)
    chunks = len(engine._offload.chunks)
    _close_engine(engine)
    del engine
    _free(torch)
    med = _median(step_s)
    tokens = z["gas"] * z["micro"] * z["seq"]
    flops_tok = model.flops_per_token(z["seq"])
    L = depth
    fwd = REMAT_FWD_PER_LAYER[remat]
    want = {"flash_fwd": fwd * L * z["gas"] * steps, "flash_bwd_dq": L * z["gas"] * steps,
            "flash_bwd_dkv": L * z["gas"] * steps, "fused_adamw": chunks * steps}
    res = dict(phase="offload_train", model=z["model"], layers=L,
               full_layers=full.num_layers, depth_cut=cut, hidden=cfg.hidden_size,
               vocab=cfg.vocab_size, seq=z["seq"], micro_batch=z["micro"], gas=z["gas"],
               remat=remat, warmup_peak_bytes=warm_peak, params=n_params,
               non_offloaded_state_bytes=state_bytes, card_bytes=CARD_BYTES,
               host_state_bytes=mem["host_state_bytes"], pinned_bytes=mem["pinned_bytes"],
               device_compute_bytes=mem["device_compute_bytes"],
               device_grad_bytes=mem["device_grad_bytes"],
               device_staging_bytes=mem["device_staging_bytes"], chunks_per_step=chunks,
               init_s=init_s, warmup_step_s=warm_s, loss_first=first, losses=losses,
               step_s=step_s, step_s_median=med, tokens_per_step=tokens,
               tokens_per_s=tokens / med, flops_per_token=flops_tok,
               mfu=tokens / med * flops_tok / PEAK_BF16_FLOPS, peak_memory_bytes=peak,
               profile_step_wall_ms=wall_ms, profile_step_device_ms=dev_ms,
               profile_split=split, profile_top=sorted(rows, key=lambda r: -r["ms_per_call"])[:12],
               launches=launches, launches_per_step={n: launches[n] / steps for n in want},
               host_before=sizes0, host_after_init=sizes1,
               seconds=time.perf_counter() - t_phase, gpu=gpu)
    emit(res)
    bad = {n: (launches[n], w) for n, w in want.items() if launches[n] != w}
    if bad:
        raise AssertionError(f"offload_train: launches (got, want) {bad}")
    if not (np.isfinite([first] + losses).all() and losses[-1] < first):
        raise AssertionError(f"offload_train: losses not finite and falling: {first} {losses}")
    if not peak < CARD_BYTES:
        raise AssertionError(f"offload_train: peak device bytes {peak} >= {CARD_BYTES}")
    return res


def nvme_train_phase(torch, K, gpu, train_losses):
    """``nvme_train``: the training flagship (24 layers, seq 4096, micro 8,
    GAS 2) on the NVMe tier under a temporary directory: 3 sequential steps
    against the train phase's first 3 losses, then a pipelined engine's 4
    steps, its walks against the next dispatches, and the async I/O
    engine's rates at the same directory (``nvme/bench.py``)."""
    import shutil
    import tempfile

    import numpy as np
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.models.presets import get_preset
    from deepspeed_tpu_torch.models.transformer import CausalLM
    from deepspeed_tpu_torch.nvme.bench import run_bench

    t_phase = time.perf_counter()
    z = NVME_TRAIN
    micro, seq, gas = 8, 4096, 2
    tmp = tempfile.mkdtemp(prefix="dst_nvme_train_")
    try:
        sizes = host_sizes(torch, tmp)
        emit(dict(phase="nvme_train_host", when="before init", **sizes, gpu=gpu))
        cfg = get_preset(OFFLOAD_PRESET, loss_chunk_size=2048)
        batch = {"input_ids": np.random.default_rng(SEED).integers(
            0, cfg.vocab_size, (gas, micro, seq + 1), dtype=np.int64)}

        def make(path, **extra):
            conf = _offload_conf(micro, gas, offload_optimizer={
                "device": "nvme", "nvme_path": os.path.join(tmp, path), **extra})
            return initialize(model=CausalLM(cfg), config=conf, device=DEVICE)[0]

        t0 = time.perf_counter()
        engine = make("seq")
        init_s = time.perf_counter() - t0
        K.reset_launches()
        seq_losses, seq_s = [], []
        nv = engine._nvme_opt
        r0, w0 = nv.bytes_read, nv.bytes_written
        for _ in range(z["seq_steps"]):
            t0 = time.perf_counter()
            seq_losses.append(float(engine.train_batch(batch)))
            seq_s.append(time.perf_counter() - t0)
        launches = dict(K.LAUNCHES)
        seq_read = (nv.bytes_read - r0) / z["seq_steps"]
        seq_written = (nv.bytes_written - w0) / z["seq_steps"]
        swap_bytes = engine.memory_breakdown()["offload"]["swap_bytes"]
        _close_engine(engine)
        del engine
        _free(torch)
        pipe = make("pipe", pipeline=True)
        nv = pipe._nvme_opt
        r0, w0 = nv.bytes_read, nv.bytes_written
        pipe_losses, pipe_s = [], []
        for _ in range(z["pipe_steps"]):
            t0 = time.perf_counter()
            pipe_losses.append(float(pipe.train_batch(batch)))
            pipe_s.append(time.perf_counter() - t0)
        pipe.flush_nvme_pipeline()
        walks = z["pipe_steps"]
        pipe_read = (nv.bytes_read - r0) / walks
        pipe_written = (nv.bytes_written - w0) / walks
        timeline = list(pipe._nvme_timeline)
        _close_engine(pipe)
        del pipe
        _free(torch)
        bench = run_bench(os.path.join(tmp, "bench"), size_mb=z["bench_mb"], threads=8, ops=16)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    spans, start = [], None
    for kind, t in timeline:
        if kind == "walk_start":
            start = t
        elif kind == "walk_end" and start is not None:
            spans.append((start, t))
            start = None
    dispatches = [t for kind, t in timeline if kind == "dispatch"]
    overlaps = [[s < d < e for d in dispatches].count(True) for s, e in spans]
    walk_s = [e - s for s, e in spans]
    med_walk = _median(walk_s)
    ref = train_losses[:z["seq_steps"]]
    rel = [abs(a - b) / abs(b) for a, b in zip(seq_losses, ref)]
    tokens = gas * micro * seq
    res = dict(phase="nvme_train", model="llama3_proxy_410m", layers=cfg.num_layers, seq=seq,
               micro_batch=micro, gas=gas, optimizer="adamw (host)", swap_bytes=swap_bytes,
               init_s=init_s, sequential_losses=seq_losses, train_phase_losses=ref,
               loss_rel_errs=rel, loss_tolerance=NVME_LOSS_RTOL,
               first_loss_equal=seq_losses[0] == ref[0], sequential_step_s=seq_s,
               sequential_tokens_per_s=tokens / _median(seq_s),
               sequential_read_bytes_per_step=seq_read,
               sequential_written_bytes_per_step=seq_written,
               pipelined_losses=pipe_losses, pipelined_step_s=pipe_s,
               pipelined_tokens_per_s=tokens / _median(pipe_s[1:]),
               walk_s=walk_s, walk_s_median=med_walk,
               walk_read_GBps=pipe_read / 2 ** 30 / med_walk,
               walk_write_GBps=pipe_written / 2 ** 30 / med_walk,
               dispatches_inside_walks=overlaps, bench=bench, host=sizes,
               launches=launches, launches_per_step={n: c / z["seq_steps"]
                                                     for n, c in launches.items() if c},
               seconds=time.perf_counter() - t_phase, gpu=gpu)
    emit(res)
    bad = []
    if not all(r <= NVME_LOSS_RTOL for r in rel):
        bad.append(f"sequential losses {seq_losses} vs the train phase's {ref}")
    if pipe_losses[0] != seq_losses[0]:
        bad.append(f"first pipelined loss {pipe_losses[0]} != sequential {seq_losses[0]}")
    if not any(overlaps):
        bad.append(f"no dispatch inside a walk: {timeline}")
    if not (seq_losses[-1] < seq_losses[0] and pipe_losses[-1] < pipe_losses[0]):
        bad.append(f"losses not falling: {seq_losses} {pipe_losses}")
    if launches["fused_adamw"]:
        bad.append("K8 launched under the NVMe tier (its update is the host AdamW)")
    if bad:
        raise AssertionError(f"nvme_train: {bad}")
    return res


# ---------------------------------------------------------------------------
# the instrumented, scheduled step: timers, memory report, flops profiler,
# CSV monitor, curriculum learning (seqlen, and analyzed-difficulty
# sampling) and progressive layer drop
# ---------------------------------------------------------------------------
SCHEDULE_PRESET = "llama3_proxy_410m"  # CPU rehearsals: "tiny"
SCHEDULE_CHECK = dict(layers=2, seq=1024, cut=520, micro=2, gas=2)
# 12 of the flagship's 24 layers: the gates (lengths, kept layers x GAS,
# K8 once, the CSV rows, the profiled K1 count) hold at any depth, and the
# compile phases took the seconds (the whole smoke's time limit)
SCHEDULE_TRAIN = dict(seq=4096, micro=8, gas=2, steps=8, loader_steps=3, timed=4, docs=96,
                      min_doc=256, layers=12)
SCHEDULE_CURRICULUM = dict(min_difficulty=512, max_difficulty=4096, total_curriculum_step=10,
                           difficulty_step=8)
SCHEDULE_PLD = dict(theta=0.5, gamma=0.5)
SCHEDULE_PROFILE_STEP = 3


def _schedule_model(seq, layers=None):
    from deepspeed_tpu_torch.models.presets import get_preset
    from deepspeed_tpu_torch.models.transformer import CausalLM

    over = dict(loss_chunk_size=2048) if SCHEDULE_PRESET == "llama3_proxy_410m" else \
        dict(max_seq_len=seq + 1)
    if layers is not None:
        over["num_layers"] = layers
    return CausalLM(get_preset(SCHEDULE_PRESET, **over))


def _curriculum(lo, hi, total, step, analysis=None):
    """A ``data_efficiency`` section: the seqlen curriculum ``fixed_linear``
    from ``lo`` to ``hi`` over ``total`` steps in steps of ``step``."""
    cl = {"enabled": True, "curriculum_type": "seqlen", "min_difficulty": lo,
          "max_difficulty": hi, "schedule_type": "fixed_linear",
          "schedule_config": {"total_curriculum_step": total, "difficulty_step": step}}
    if analysis is not None:
        cl["data_analysis_path"] = analysis
    return {"enabled": True, "curriculum_learning": cl}


def k1_closed_form(cfg, micro, seq, kept_layers):
    """K1's operations in a step whose micro-batches run ``kept_layers``
    (one count a micro-batch) at ``seq`` tokens: 4 hd a causal pair and
    query head forward, 10 hd backward (PERF.md's bound counts)."""
    pairs = micro * seq * (seq + 1) // 2 * cfg.hd * cfg.num_heads * sum(kept_layers)
    return {"flash_fwd": 4 * pairs, "flash_bwd": 10 * pairs}


def _step_launch_gate(phase, launches, kept):
    """K1f / K1b: the micro-batches' kept layers summed; K8 once."""
    if DEVICE != "cuda":
        return
    want = {n: sum(kept) for n in ATTN_KERNELS[False]}
    want["fused_adamw"] = 1
    bad = {n: (launches.get(n, 0), w) for n, w in want.items() if launches.get(n, 0) != w}
    if bad:
        raise AssertionError(f"{phase}: launches (got, expected) {bad} in a step")


def _launch_diff(K, before):
    return {n: K.LAUNCHES[n] - before[n] for n in K.LAUNCHES if K.LAUNCHES[n] != before[n]}


def _schedule_micros(batch, keep):
    """schedule_check's two micro-batches before any step: micro-batch 0
    cut to the curriculum length, unmasked and under layer mask ``keep``."""
    cut = {"input_ids": batch["input_ids"][0][:, :SCHEDULE_CHECK["cut"] + 1]}
    return (("cut", cut), ("masked", dict(cut, layer_keep=keep[0])))


def schedule_check_reference(torch):
    """schedule_check's CPU half, which launches no kernel (``main`` runs
    it while the kernels build): the port on the CPU in fp32 from the
    seeded tree, the loss and layer 0's attention gradients of each of
    ``_schedule_micros`` and step 1's loss, with the inputs both engines
    take."""
    import numpy as np
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.models.transformer import CausalLM, init_params

    z = SCHEDULE_CHECK
    cfg = _schedule_model(z["seq"], z["layers"]).cfg
    params = init_params(cfg, seed=SEED, device="cpu", dtype=torch.float32)
    batch = {"input_ids": np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (z["gas"], z["micro"], z["seq"] + 1), dtype=np.int64)}
    keep = np.ones((z["gas"], cfg.num_layers), bool)
    keep[:, 1] = False
    conf = bench_config(z["micro"], z["gas"])
    conf["data_efficiency"] = _curriculum(z["cut"], z["cut"], 1, 8)
    cpu, _, _, _ = initialize(model=CausalLM(cfg.replace(dtype=torch.float32)), params=params,
                              config={**conf, "bf16": {"enabled": False}}, device="cpu")
    micros = {name: _loss_and_attn_grads(torch, cpu, micro)
              for name, micro in _schedule_micros(batch, keep)}
    return dict(params=params, batch=batch, keep=keep, conf=conf, micros=micros,
                step1_loss=float(cpu.train_batch(batch)))


def schedule_check_phase(torch, K, gpu, ref):
    """``schedule_check``: the flagship's width at 2 layers, the card (bf16)
    against the port on the CPU (fp32, ``ref`` from
    ``schedule_check_reference``) with train_check's limits, on a
    curriculum step cut from 1,024 to 520 tokens (K1 on a partial tile) and
    under a given layer mask that drops layer 1.  Before any step: the
    loss and layer 0's attention gradients of a cut micro-batch, unmasked
    and masked (step-1 loss within TRAIN_LOSS_RTOL, cosines above
    GRAD_COS_MIN).  Step 1 (curriculum, the flops profiler's step): K1f /
    K1b layers x GAS, K8 once, the profiler's K1 count equal to
    ``k1_closed_form`` and the card's loss against the CPU engine's.  Step
    2 (the mask in the batch): K1f / K1b kept layers x GAS."""
    import tempfile

    import numpy as np
    from deepspeed_tpu_torch import initialize

    z = SCHEDULE_CHECK
    model = _schedule_model(z["seq"], z["layers"])
    cfg, batch, keep, conf = model.cfg, ref["batch"], ref["keep"], ref["conf"]
    with tempfile.TemporaryDirectory() as tmp:
        report_path = os.path.join(tmp, "profile.txt")
        card, _, _, _ = initialize(model=model, params=ref["params"], device=DEVICE, config=dict(
            conf, flops_profiler={"enabled": True, "profile_step": 1,
                                  "output_file": report_path}))
        checks = {}
        for name, micro in _schedule_micros(batch, keep):
            lc, gc = _loss_and_attn_grads(torch, card, micro)
            lp, gp = ref["micros"][name]
            checks[name] = dict(card_loss=lc, cpu_loss=lp, loss_rel_err=abs(lc - lp) / abs(lp),
                                grad_cosine_layer0=grad_cosines(torch, gc, gp))
        K.reset_launches()
        before = dict(K.LAUNCHES)
        card_losses = [float(card.train_batch(batch))]
        launches_cut = _launch_diff(K, before)
        executed = card.flops_profiler.get_executed()
        with open(report_path) as fh:
            report = fh.read()
        before = dict(K.LAUNCHES)
        card_losses.append(float(card.train_batch(dict(batch, layer_keep=keep))))
        launches_masked = _launch_diff(K, before)
        launches = dict(K.LAUNCHES)
    cpu_loss = ref["step1_loss"]
    step1_rel = abs(card_losses[0] - cpu_loss) / abs(cpu_loss)
    closed = k1_closed_form(cfg, z["micro"], z["cut"], [cfg.num_layers] * z["gas"])
    res = dict(phase="schedule_check", model=SCHEDULE_PRESET, layers=cfg.num_layers,
               seq=z["seq"], curriculum_seq=z["cut"], micro_batch=z["micro"], gas=z["gas"],
               layer_keep=keep[0].tolist(), before_steps=checks, card_losses=card_losses,
               cpu_step1_loss=cpu_loss, step1_loss_rel_err=step1_rel,
               launches_curriculum_step=launches_cut, launches_masked_step=launches_masked,
               profiler_kernel_flops=executed["kernel_flops"], k1_closed_form=closed,
               profiler_executed_flops=executed["flops"],
               profiler_peak_bytes=executed.get("peak_bytes"), launches=launches, gpu=gpu)
    emit(res)
    bad = [f"{n}: loss rel {c['loss_rel_err']}" for n, c in checks.items()
           if not c["loss_rel_err"] <= TRAIN_LOSS_RTOL]
    bad += [f"{n}: cosine {c['grad_cosine_layer0']}" for n, c in checks.items()
            if not all(v > GRAD_COS_MIN for v in c["grad_cosine_layer0"].values())]
    if not (np.isfinite(card_losses).all() and step1_rel <= TRAIN_LOSS_RTOL):
        bad.append(f"step-1 loss card {card_losses[0]} vs CPU {cpu_loss} (rel {step1_rel})")
    if "executed FLOPs" not in report or "train FLOPs" not in report:
        bad.append("the profiler's report lacks the analytic or the executed FLOPs")
    if DEVICE == "cuda" and executed["kernel_flops"] != closed:
        bad.append(f"the profiler's K1 count {executed['kernel_flops']} != {closed}")
    if bad:
        raise AssertionError(f"schedule_check: {bad}")
    _step_launch_gate("schedule_check (curriculum)", launches_cut,
                      [cfg.num_layers] * z["gas"])
    _step_launch_gate("schedule_check (masked)", launches_masked,
                      [int(k.sum()) for k in keep])
    del card
    return res


def schedule_train_phase(torch, K, gpu, train_mfu):
    """``schedule_train``: the flagship at full depth with every switch on
    (the seqlen curriculum ``fixed_linear`` 512 -> 4096 in steps of 8 over
    10 steps; progressive layer drop at SCHEDULE_PLD; ``csv_monitor``,
    ``wall_clock_breakdown``, ``memory_breakdown``; the flops profiler at
    step SCHEDULE_PROFILE_STEP), trained 8 steps by ``train_batch``, then 3
    by ``train_on_loader`` over a token dataset made from the seed, written
    as an indexed dataset in a temporary directory, analyzed by
    ``DataAnalyzer`` and sampled through ``data_analysis_path``.  Then, at
    the full length with PLD paused, the step time with
    ``wall_clock_breakdown`` off / on / on / off (4 steps each, no host read
    between them; each block holds one ``steps_per_print`` boundary), and
    steps alone, uncounted / counted by ``analyze_train_step`` / counted /
    uncounted, none at a boundary (the count's own cost).  Gates, every
    step: the model saw the scheduler's length; K1f / K1b the kept layers
    x GAS, K8 once; the loss finite and the CSV's row of it the float
    ``get_last_loss`` read; some step drops a layer;
    every drawn sample's length within the difficulty when it was drawn;
    the profiler's report with the analytic and the executed FLOPs, its K1
    count equal to ``k1_closed_form`` for the profiled step's masks."""
    import tempfile

    import numpy as np
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.data import (DataAnalyzer, MMapIndexedDataset,
                                          MMapIndexedDatasetBuilder)
    from deepspeed_tpu_torch.profiling import analyze_train_step

    z = SCHEDULE_TRAIN
    model = _schedule_model(z["seq"], z.get("layers"))
    cfg = model.cfg
    rng = np.random.default_rng(SEED)
    drawn = []  # (a drawn sample's length, the scheduler's difficulty then)
    engine = None

    def pad(samples):
        out = np.zeros((len(samples), z["seq"] + 1), np.int64)
        for i, smp in enumerate(samples):
            out[i, :len(smp)] = smp
            drawn.append((len(smp), engine.curriculum_scheduler.get_current_difficulty()))
        return {"input_ids": torch.from_numpy(out)}

    with tempfile.TemporaryDirectory() as tmp:
        prefix, analysis = os.path.join(tmp, "docs"), os.path.join(tmp, "analysis")
        builder = MMapIndexedDatasetBuilder(prefix)
        for n in rng.integers(z["min_doc"], z["seq"] + 2, z["docs"]):
            builder.add_item(rng.integers(0, cfg.vocab_size, int(n)))
        builder.finalize()
        dataset = MMapIndexedDataset(prefix)
        t0 = time.perf_counter()
        DataAnalyzer(dataset, num_workers=2, save_path=analysis).run_map_reduce(processes=1)
        analyze_s = time.perf_counter() - t0
        c = SCHEDULE_CURRICULUM
        conf = bench_config(z["micro"], z["gas"])
        conf.update(
            steps_per_print=4, wall_clock_breakdown=True, memory_breakdown=True,
            data_efficiency=_curriculum(c["min_difficulty"], c["max_difficulty"],
                                        c["total_curriculum_step"], c["difficulty_step"],
                                        analysis),
            progressive_layer_drop={"enabled": True, **SCHEDULE_PLD},
            csv_monitor={"enabled": True, "output_path": tmp, "job_name": "schedule"},
            flops_profiler={"enabled": True, "profile_step": SCHEDULE_PROFILE_STEP,
                            "output_file": os.path.join(tmp, "profile.txt")})
        engine, _, loader, _ = initialize(model=model, config=conf, device=DEVICE,
                                          training_data=dataset, collate_fn=pad)
        seen = []  # the token count each micro-batch's loss ran at
        loss_fn = engine.loss_fn

        def spy(params, micro, gen):
            seen.append(int(micro["input_ids"].shape[-1]) - 1)
            return loss_fn(params, micro, gen)

        engine.loss_fn = spy
        batch = {"input_ids": rng.integers(0, cfg.vocab_size,
                                           (z["gas"], z["micro"], z["seq"] + 1))}
        steps = []

        def take(kind, run):
            before, n_seen = dict(K.LAUNCHES), len(seen)
            t0 = time.perf_counter()
            run()
            loss = engine.get_last_loss()
            steps.append(dict(kind=kind, step=engine.global_steps,
                              difficulty=engine.curriculum_scheduler.get_current_difficulty(),
                              seq=seen[n_seen:], kept=[int(m.sum()) for m in engine.pld_masks],
                              launches=_launch_diff(K, before), loss=loss,
                              s=time.perf_counter() - t0))

        K.reset_launches()
        for _ in range(z["steps"]):
            take("train_batch", lambda: engine.train_batch(batch))
        gen = engine.train_on_loader(loader, num_steps=z["loader_steps"])
        for _ in range(z["loader_steps"]):
            take("train_on_loader", lambda: next(gen))
        gen.close()
        prof = engine.flops_profiler
        executed = prof.get_executed()
        profiled = steps[SCHEDULE_PROFILE_STEP - 1]
        closed = k1_closed_form(cfg, z["micro"], profiled["difficulty"], profiled["kept"])
        with open(os.path.join(tmp, "profile.txt")) as fh:
            report = fh.read()
        # wall_clock_breakdown's tax at the full length, PLD paused so that
        # every step runs all layers: no host read between a block's steps
        pld, engine.progressive_layer_drop = engine.progressive_layer_drop, None
        timed = {"off": [], "on": []}
        before = dict(K.LAUNCHES)
        for mode in ("off", "on", "on", "off"):
            engine.config.wall_clock_breakdown = mode == "on"
            _sync(torch)
            t0 = time.perf_counter()
            for _ in range(z["timed"]):
                engine.train_batch(batch)
            _sync(torch)
            timed[mode].append((time.perf_counter() - t0) / z["timed"])
        timed_launches = _launch_diff(K, before)
        engine.config.wall_clock_breakdown = False
        # a step alone, uncounted / counted / counted / uncounted, none of
        # them a steps_per_print boundary (its flush and memory report)
        every = engine.config.steps_per_print
        engine.config.steps_per_print = 10 ** 9
        single = {"plain": [], "counted": []}
        for kind in ("plain", "counted", "counted", "plain"):
            _sync(torch)
            t0 = time.perf_counter()
            if kind == "plain":
                engine.train_batch(batch)
            else:
                analyze_train_step(engine, batch)
            _sync(torch)
            single[kind].append(time.perf_counter() - t0)
        engine.config.steps_per_print = every
        engine.progressive_layer_drop = pld
        engine.get_last_loss()
        launches = dict(K.LAUNCHES)
        with open(os.path.join(tmp, "schedule", "Train_Samples_train_loss.csv")) as fh:
            csv_rows = {int(a): float(b) for a, b in
                        (ln.split(",") for ln in fh.read().splitlines()[1:])}
    duration = prof.get_total_duration()
    analytic = 3 * prof.get_total_flops()  # fwd + bwd: 6 x MACs
    off, on = sorted(timed["off"]), sorted(timed["on"])
    res = dict(phase="schedule_train", model=SCHEDULE_PRESET, layers=cfg.num_layers,
               seq=z["seq"], micro_batch=z["micro"], gas=z["gas"], curriculum=c,
               pld=SCHEDULE_PLD, docs=z["docs"], analyze_s=analyze_s, steps=steps,
               drawn_samples=len(drawn), drawn_max_len=max((n for n, _ in drawn), default=0),
               eligible_at_draw=int(sum(1 for n in dataset.sizes if drawn and n <= drawn[0][1])),
               profile_step=SCHEDULE_PROFILE_STEP, profile_seq=profiled["difficulty"],
               profile_kept=profiled["kept"], profiler_duration_s=duration,
               profiler_train_flops_analytic=analytic,
               profiler_executed_flops=executed["flops"],
               profiler_aten_flops=executed["aten_flops"],
               profiler_kernel_flops=executed["kernel_flops"], k1_closed_form=closed,
               profiler_peak_bytes=executed.get("peak_bytes"),
               profiler_mfu_analytic=analytic / duration / PEAK_BF16_FLOPS,
               profiler_mfu_executed=executed["flops"] / duration / PEAK_BF16_FLOPS,
               train_phase_mfu=train_mfu, wall_clock_off_s=timed["off"],
               wall_clock_on_s=timed["on"],
               wall_clock_tax=(sum(on) / len(on)) / (sum(off) / len(off)) - 1.0,
               single_step_s=single["plain"], counted_step_s=single["counted"],
               count_tax=sum(single["counted"]) / sum(single["plain"]) - 1.0,
               timed_launches=timed_launches, launches=launches, gpu=gpu)
    emit(res)
    bad = []
    for st in steps:
        if st["seq"] != [st["difficulty"]] * z["gas"]:
            bad.append(f"step {st['step']}: lengths {st['seq']} != difficulty "
                       f"{st['difficulty']}")
        if not np.isfinite(st["loss"]) or csv_rows.get(st["step"]) != st["loss"]:
            bad.append(f"step {st['step']}: loss {st['loss']}, CSV row "
                       f"{csv_rows.get(st['step'])}")
        _step_launch_gate(f"schedule_train step {st['step']}", st["launches"], st["kept"])
    if not any(k < cfg.num_layers for st in steps for k in st["kept"]):
        bad.append("no step dropped a layer")
    if not drawn or any(n > d for n, d in drawn):
        bad.append(f"drawn samples past the difficulty: {[x for x in drawn if x[0] > x[1]]}")
    if "executed FLOPs" not in report or "train FLOPs" not in report:
        bad.append("the profiler's report lacks the analytic or the executed FLOPs")
    if DEVICE == "cuda" and executed["kernel_flops"] != closed:
        bad.append(f"the profiler's K1 count {executed['kernel_flops']} != {closed}")
    want_timed = 4 * z["timed"] * cfg.num_layers * z["gas"]
    if DEVICE == "cuda" and timed_launches.get("flash_fwd") != want_timed:
        bad.append(f"timed steps: K1f {timed_launches.get('flash_fwd')} != {want_timed}")
    if bad:
        raise AssertionError(f"schedule_train: {bad}")
    del engine
    return res


REPLACES = {
    "flash_fwd": "deepspeed_tpu/ops/pallas/flash_kernel.py:253",
    "flash_bwd_dq": "deepspeed_tpu/ops/pallas/flash_kernel.py:384",
    "flash_bwd_dkv": "deepspeed_tpu/ops/pallas/flash_kernel.py:407",
    "paged_decode": "deepspeed_tpu/ops/pallas/paged_attention.py:270",
    "paged_decode_hd64": "deepspeed_tpu/ops/pallas/paged_attention.py:225",
    "ctx_attention": "deepspeed_tpu/ops/pallas/ctx_attention.py:244",
    "ctx_attention_partial": "deepspeed_tpu/ops/pallas/ctx_attention.py:297",
    "paged_decode_partial": "deepspeed_tpu/inference/paged.py:558",
    "quant_matmul_int8": "deepspeed_tpu/ops/pallas/quant_matmul.py:115",
    "quant_matmul_fp8": "deepspeed_tpu/ops/pallas/quant_matmul.py:115",
    "quant_matmul_fp6": "deepspeed_tpu/ops/pallas/quant_matmul.py:237",
    "quantize_int8": "deepspeed_tpu/ops/pallas/quant_kernel.py:52",
    "quantize_fp8": "deepspeed_tpu/ops/pallas/quant_kernel.py:103",
    "dequantize": "deepspeed_tpu/ops/pallas/quant_kernel.py:75",
    "sparse_fwd": "deepspeed_tpu/ops/pallas/flash_kernel.py:587",
    "sparse_bwd_dq": "deepspeed_tpu/ops/pallas/flash_kernel.py:662",
    "sparse_bwd_dkv": "deepspeed_tpu/ops/pallas/flash_kernel.py:687",
    "fused_adamw": "deepspeed_tpu/ops/pallas/fused_adam.py:46",
}


PARTIAL_NOTES = {
    "ctx_attention_partial": "the pallas_call at ctx_attention.py:297 with partial=True: the "
                             "(acc, m, l) triple per seq shard, include_pack on shard 0",
    "paged_decode_partial": "_paged_attention_decode_partial, a jnp body (no pallas_call): "
                            "K2 in its partial mode per seq shard, other shards' pages skipped",
}


# ---------------------------------------------------------------------------
# compression-aware and parameter-efficient training: compression/ (QAT,
# activation quantization, pruning, layer reduction + distillation), the
# eigenvalue estimator, LoRA and the hybrid engine's generate
# ---------------------------------------------------------------------------
SHAPING_PRESET = "llama3_proxy_410m"  # CPU rehearsals: "tiny"
# the transform card against CPU at 2 layers: steps before, at and after the
# offsets (QAT and l1 pruning at 2, the structured masks at 3) in fp32, and
# the bf16 leaves at and after them (the CPU's full-width transforms are
# most of the phase's time); the engines at seq 256
COMPRESS_CHECK = dict(layers=2, seq=256, micro=2, gas=2, steps=(1, 2, 3, 6),
                      bf16_steps=(3, 6), offset=2)
COMPRESS_TRAIN = dict(seq=4096, micro=8, gas=2, steps=4, offset=1)
# redundancy_clean's shrunk tree against the masked tree: one sequence of
# CLEAN_CHECK_SEQ tokens in fp32, max |logits difference| over max |logits|.
# Read on an NVIDIA H100 80GB HBM3 at 700 W (llama3_proxy_410m, 24 layers):
# 2.6e-6 for the right units, 1.33 for a tree keeping the pruned ones
CLEAN_CHECK_SEQ = 512
CLEAN_RTOL = 1e-4
# the student's micro-batch holds the two [micro, seq, vocab] fp32 logits
# the KD term reads (1 GB each at micro 2)
KD_TRAIN = dict(seq=4096, micro=2, gas=2, steps=3, student_layers=12, alpha=0.5,
                temperature=2.0)
LORA_TRAIN = dict(seq=4096, micro=8, gas=2, steps=3, r=16, alpha=32.0, lr=1e-3)
LORA_GEN = dict(prompts=8, prompt_len=128, new=32, burst=8, burst_prompts=2,
                check_layers=2, check_seq=512, max_seq_len=1024)
EIGEN_CHECK = dict(layers=2, seq=512, micro=1, gas=2, steps=2, max_iter=4, resolution=2)
# the card's fp32 Hessian-vector product against the CPU's on the same v:
# the same second-order sums in another order (TF32 off), relative Frobenius
HVP_RTOL = 1e-4


def compression_config(cfg, offset, structured_offset):
    """Every technique at ``cfg``'s widths: QAT on the MLP with the 8 -> 4
    bit ramp (one bit a step after ``offset``), l1 pruning of the
    attention at 0.5, and from ``structured_offset`` half the kv groups
    (head pruning on wq / wk / wv with ``num_heads`` the kv heads, wo's
    input rows related: the shrunk tree keeps whole query groups) and half
    the MLP rows (w_up / w_gate, w_down related); 8-bit activations."""
    return {
        "weight_quantization": {
            "shared_parameters": {"enabled": True, "schedule_offset": offset,
                                  "quantize_groups": 1, "quantization_type": "symmetric"},
            "different_groups": {"wq1": {"params": {"start_bits": 8, "target_bits": 4,
                                                    "quantization_period": 1},
                                         "modules": ["layers/mlp"]}}},
        "sparse_pruning": {
            "shared_parameters": {"enabled": True, "method": "l1", "schedule_offset": offset},
            "different_groups": {"sp1": {"params": {"dense_ratio": 0.5},
                                         "modules": ["layers/attn"]}}},
        "head_pruning": {
            "shared_parameters": {"enabled": True, "num_heads": cfg.num_kv_heads,
                                  "schedule_offset": structured_offset},
            "different_groups": {"hp1": {"params": {"dense_ratio": 0.5},
                                         "modules": [r"layers/attn/w[qkv]$"],
                                         "related_modules": [[r"layers/attn/wo$"]]}}},
        "row_pruning": {
            "shared_parameters": {"enabled": True, "method": "l1",
                                  "schedule_offset": structured_offset},
            "different_groups": {"rp1": {"params": {"dense_ratio": 0.5},
                                         "modules": [r"layers/mlp/w_(up|gate)$"],
                                         "related_modules": [[r"layers/mlp/w_down$"]]}}},
        "activation_quantization": {
            "shared_parameters": {"enabled": True, "quantization_type": "symmetric"},
            "different_groups": {"aq1": {"params": {"bits": 8}, "modules": [".*"]}}},
    }


def _shaping_model(layers=None, **over):
    from deepspeed_tpu_torch.models.presets import get_preset
    from deepspeed_tpu_torch.models.transformer import CausalLM

    if SHAPING_PRESET == "llama3_proxy_410m":
        over.setdefault("loss_chunk_size", 2048)
    if layers is not None:
        over["num_layers"] = layers
    return CausalLM(get_preset(SHAPING_PRESET, **over))


def _token_batch(cfg, gas, micro, seq, seed=SEED):
    import numpy as np

    return {"input_ids": np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (gas, micro, seq + 1), dtype=np.int64)}


def _transformed_loss_and_attn_grads(torch, engine, micro, step, grads=True):
    """(loss, layer 0's attention gradients) of one micro-batch through the
    engine's compute-type cast and its compression transform at ``step``;
    the loss alone, by a forward, without ``grads``."""
    from deepspeed_tpu_torch.runtime.precision import cast_floating

    names = ("wq", "wk", "wv", "wo")
    attn = engine.params["layers"]["attn"]
    with contextlib.nullcontext() if grads else torch.no_grad():
        cp = cast_floating(engine.params, engine.compute_dtype)
        cp = engine._compression.transform(cp, torch.tensor(step, dtype=torch.int32,
                                                            device=engine.device))
        loss = engine.model.loss_fn(cp, {k: torch.as_tensor(v).to(engine.device)
                                         for k, v in micro.items()})
    if not grads:
        return float(loss), None
    grads = torch.autograd.grad(loss, [attn[n] for n in names])
    return float(loss.detach()), {n: g[0].float().cpu().flatten() for n, g in zip(names, grads)}


def _tree_mismatches(torch, a, b):
    """{path: differing elements} of two trees on any devices, bit for bit."""
    fa, fb = _leaves(a), _leaves(b)
    out = {}
    for k in fa:
        x, y = fa[k].detach().cpu(), fb[k].detach().cpu()
        if x.shape != y.shape or x.dtype != y.dtype:
            out[k] = f"shape / type {tuple(x.shape)} {x.dtype} vs {tuple(y.shape)} {y.dtype}"
        elif not torch.equal(x.contiguous().view(torch.uint8), y.contiguous().view(torch.uint8)):
            out[k] = int((x != y).sum())
    return out


def compress_check_reference(torch):
    """compress_check's half that launches no kernel (``main`` runs it
    while the kernels build), at the flagship's width and COMPRESS_CHECK's
    2 layers.  The weight transform of every technique
    (``compression_config`` with offsets 2 / 3) on the card against the CPU
    at COMPRESS_CHECK's fp32 and bf16 steps, and ``redundancy_clean`` on
    both: the mismatching elements of each pair, which must be none (the
    same IEEE fp32 operations).  Then the CPU engine with every technique
    active from step 0 (8-bit activations included) in the card's compute
    type: the loss and layer 0's attention gradients of micro-batch 0
    through the transform, and step 1's loss."""
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.compression.compress import CompressionManager
    from deepspeed_tpu_torch.models.transformer import CausalLM, init_params

    z = COMPRESS_CHECK
    cfg = _shaping_model(z["layers"]).cfg
    params = init_params(cfg, seed=SEED, device="cpu", dtype=torch.float32)
    mgr = CompressionManager(compression_config(cfg, z["offset"], z["offset"] + 1))
    transform = {}
    for dtype, steps in ((torch.float32, z["steps"]), (torch.bfloat16, z["bf16_steps"])):
        cpu_p = _to(params, "cpu", dtype)
        card_p = _to(params, DEVICE, dtype)
        for step in steps:
            t0 = time.perf_counter()
            got = mgr.transform(card_p, torch.tensor(step, dtype=torch.int32, device=DEVICE))
            _sync(torch)
            card_ms = 1e3 * (time.perf_counter() - t0)
            want = mgr.transform(cpu_p, torch.tensor(step, dtype=torch.int32))
            bits = mgr.wq_bits(mgr.weight_quant.groups[0], torch.tensor(step))
            transform[f"{str(dtype)[6:]}_step{step}"] = dict(
                mismatches=_tree_mismatches(torch, got, want), bits=float(bits),
                card_ms=card_ms)
    clean_card, info_card = mgr.redundancy_clean(_to(params, DEVICE))
    clean_cpu, info_cpu = mgr.redundancy_clean(_to(params, "cpu"))
    clean_mismatch = _tree_mismatches(torch, clean_card, clean_cpu)
    del clean_card, clean_cpu
    conf = bench_config(z["micro"], z["gas"])
    conf["compression_training"] = compression_config(cfg, 0, 0)
    batch = _token_batch(cfg, z["gas"], z["micro"], z["seq"])
    # the CPU engine in the card's compute type: the transform then sees the
    # same bf16 weights on both (identical masks and grids, as checked
    # above), and what differs is the kernels' and products' rounding
    cpu, _, _, _ = initialize(model=CausalLM(cfg), params=params, config=conf, device="cpu")
    loss0, grads = _transformed_loss_and_attn_grads(
        torch, cpu, {"input_ids": batch["input_ids"][0]}, 0)
    # step 1's loss as train_batch reports it: the mean of the micro-batches'
    # losses at step 0, each a forward before the step's update
    losses = [loss0] + [_transformed_loss_and_attn_grads(torch, cpu, {"input_ids": m}, 0,
                                                         grads=False)[0]
                        for m in batch["input_ids"][1:]]
    return dict(params=params, conf=conf, batch=batch, transform=transform,
                clean_info=(info_card, info_cpu), clean_mismatch=clean_mismatch,
                loss0=loss0, grads=grads, step1_loss=sum(losses) / len(losses))


def compress_check_phase(torch, K, gpu, ref):
    """``compress_check``: the flagship's width at 2 layers, the card
    against ``ref`` (``compress_check_reference``: the transform's and
    ``redundancy_clean``'s mismatches, card against CPU, must be none).
    The card's engine with every technique active from step 0 (8-bit
    activations included) in bf16 against the CPU engine's: the loss and
    layer 0's attention gradients through the transform, step 1's loss
    (train_check's limits), K1f / K1b layers x GAS and K8 once a step."""
    import numpy as np
    from deepspeed_tpu_torch import initialize

    z = COMPRESS_CHECK
    model = _shaping_model(z["layers"])
    cfg, batch = model.cfg, ref["batch"]
    card, _, _, _ = initialize(model=model, params=ref["params"], config=ref["conf"],
                               device=DEVICE)
    lc, gc = _transformed_loss_and_attn_grads(torch, card, {"input_ids": batch["input_ids"][0]},
                                              0)
    lp, cpu_loss = ref["loss0"], ref["step1_loss"]
    cos = grad_cosines(torch, gc, ref["grads"])
    K.reset_launches()
    card_losses = [float(card.train_batch(batch)) for _ in range(2)]
    launches = dict(K.LAUNCHES)
    rel = abs(card_losses[0] - cpu_loss) / abs(cpu_loss)
    transform, (info_card, info_cpu) = ref["transform"], ref["clean_info"]
    res = dict(phase="compress_check", model=SHAPING_PRESET, layers=cfg.num_layers,
               seq=z["seq"], micro_batch=z["micro"], gas=z["gas"], offsets=[z["offset"],
                                                                            z["offset"] + 1],
               transform=transform, redundancy_clean_info=info_card,
               redundancy_clean_mismatches=ref["clean_mismatch"],
               act_quant_bits=card.model.cfg.act_quant_bits,
               before_step_loss=dict(card=lc, cpu=lp, rel_err=abs(lc - lp) / abs(lp)),
               grad_cosine_layer0=cos, card_losses=card_losses, cpu_step1_loss=cpu_loss,
               step1_loss_rel_err=rel, launches=launches, gpu=gpu)
    emit(res)
    bad = [f"transform {k}: {v['mismatches']}" for k, v in transform.items()
           if v["mismatches"]]
    if ref["clean_mismatch"] or info_card != info_cpu:
        bad.append(f"redundancy_clean card vs CPU: {ref['clean_mismatch']} {info_card} "
                   f"{info_cpu}")
    if card.model.cfg.act_quant_bits != 8:
        bad.append("activation bits not wired into the model")
    if not abs(lc - lp) / abs(lp) <= TRAIN_LOSS_RTOL or not rel <= TRAIN_LOSS_RTOL \
            or not np.isfinite(card_losses).all():
        bad.append(f"losses card {lc} / {card_losses} vs CPU {lp} / {cpu_loss}")
    if not all(c > GRAD_COS_MIN for c in cos.values()):
        bad.append(f"gradient cosines {cos} <= {GRAD_COS_MIN}")
    if bad:
        raise AssertionError(f"compress_check: {bad}")
    if DEVICE == "cuda":
        check_train_launches("compress_check", launches, cfg.num_layers, z["gas"], 2, False)
    del card
    return res


def _prune_kept(torch, leaf, dense_ratio):
    """(kept, n, n - k, elements tied at the threshold) of l1 pruning's
    mask over ``leaf``: n - k <= kept < n - k + ties."""
    from deepspeed_tpu_torch.compression.compress import magnitude_prune_mask, prune_keep_index

    a = leaf.float().abs().reshape(-1)
    n = a.numel()
    k = prune_keep_index(n, dense_ratio)
    thr = torch.sort(a).values[k]
    kept = int(magnitude_prune_mask(leaf, dense_ratio).sum())
    return kept, n, n - k, int((a == thr).sum())


def _kth_vs_sort(torch, leaf, dense_ratio):
    """l1 pruning's threshold of ``leaf`` by a full sort (what the transform
    runs, as JAX's ``jnp.sort``) and by ``torch.kthvalue``, the same value,
    each timed (CUDA events, 5 calls)."""
    from deepspeed_tpu_torch.compression.compress import prune_keep_index

    a = leaf.float().abs().reshape(-1)
    k = prune_keep_index(a.numel(), dense_ratio)
    kth = torch.kthvalue(a, k + 1).values
    srt = torch.sort(a).values[k]
    out = dict(elements=a.numel(), k=k, same=bool(kth == srt), kthvalue_ms=None, sort_ms=None)
    if DEVICE == "cuda":
        out.update(kthvalue_ms=time_ms(torch, lambda: torch.kthvalue(a, k + 1), iters=5, warm=1),
                   sort_ms=time_ms(torch, lambda: torch.sort(a), iters=5, warm=1))
    return out


def _logits_gap(torch, cfg, masked, clean, tokens):
    """max |logits(clean) - logits(masked)| / max |logits(masked)| of
    ``tokens`` [1, s]: ``masked`` (``export_params``) under ``cfg``,
    ``clean`` (``redundancy_clean``, half the kv groups and MLP rows) under
    ``cfg`` shrunk to it; both in fp32, with the plain attention body and
    no activation fake-quant (whose rounding would move the gap by a grid
    step)."""
    from deepspeed_tpu_torch.models.transformer import forward

    full = cfg.replace(dtype=torch.float32, attn_impl="reference", act_quant_bits=None)
    small = full.replace(num_heads=cfg.num_heads // 2, num_kv_heads=cfg.num_kv_heads // 2,
                         head_dim=cfg.hd, intermediate_size=cfg.intermediate_size // 2)
    ref = forward(_to(masked, DEVICE, torch.float32), tokens, full)
    got = forward(_to(clean, DEVICE, torch.float32), tokens, small)
    return float((got - ref).abs().max() / ref.abs().max())


def _clean_keeping_pruned(mgr, params):
    """``redundancy_clean``'s shrunk tree with every structured keep-mask
    inverted: the units that pruning removes (zeros after
    ``export_params``) kept in place of the right ones, in the same shapes
    at dense_ratio 0.5 — what compress_train's gate must tell apart."""
    masks = mgr._structured_masks
    mgr._structured_masks = lambda *a: {p: (~m, axis, units)
                                        for p, (m, axis, units) in masks(*a).items()}
    try:
        return mgr.redundancy_clean(params)[0]
    finally:
        del mgr._structured_masks


def compress_train_phase(torch, K, gpu, train_step_s):
    """``compress_train``: the flagship (seq 4096, micro 8, GAS 2) with every
    technique on (``compression_config``, offsets 1 / 2), 4 timed steps
    beside the train phase's step (``train_step_s``, same call), then 2
    with the activation fake-quant off; the transform's device ms by
    profile (once a micro-batch).  Gates: K1f /
    K1b 24 x GAS a step and K8 once; losses finite; l1's kept count per
    attention leaf n - k (up to the ties at the threshold, the elements
    equal to it); head / row kept units half of each; the logits of
    ``redundancy_clean``'s shrunk tree are the masked tree's within
    CLEAN_RTOL, where the shrunk tree that keeps the pruned units instead
    is beyond it (``_logits_gap``)."""
    import numpy as np
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.runtime.precision import cast_floating

    z = COMPRESS_TRAIN
    model = _shaping_model()
    cfg = model.cfg
    conf = bench_config(z["micro"], z["gas"])
    conf["compression_training"] = compression_config(cfg, z["offset"], z["offset"] + 1)
    torch.cuda.reset_peak_memory_stats()
    engine, _, _, _ = initialize(model=model, config=conf, device=DEVICE)
    mgr = engine._compression
    batch = _token_batch(cfg, z["gas"], z["micro"], z["seq"])
    first = float(engine.train_batch(batch))  # warm-up, step 0: the act quant alone
    K.reset_launches()
    step_s, losses = [], []
    for _ in range(z["steps"]):
        t0 = time.perf_counter()
        losses.append(float(engine.train_batch(batch)))  # a host read: synced
        step_s.append(time.perf_counter() - t0)
    launches = dict(K.LAUNCHES)
    # the same engine with the activation fake-quant off: its cost a step
    bits = model.cfg.act_quant_bits
    model.cfg = model.cfg.replace(act_quant_bits=None)
    no_aq_s = []
    for _ in range(2):
        t0 = time.perf_counter()
        float(engine.train_batch(batch))
        no_aq_s.append(time.perf_counter() - t0)
    model.cfg = model.cfg.replace(act_quant_bits=bits)
    step = engine.device_step
    with torch.no_grad():
        cp = cast_floating(engine.params, engine.compute_dtype)
        wall_ms, dev_ms, rows = _device_profile(torch, lambda: mgr.transform(cp, step), n=2)
        shaped = mgr.transform(cp, step)
        attn = _leaves(cp["layers"]["attn"])
        pruned = {k: _prune_kept(torch, v, 0.5) for k, v in attn.items()}
        kth = _kth_vs_sort(torch, attn["wq"], 0.5)
        masked = mgr.export_params(cp)
        clean, info = mgr.redundancy_clean(cp)
        tokens = torch.as_tensor(batch["input_ids"][0][:1, :CLEAN_CHECK_SEQ]).to(DEVICE)
        gaps = dict(kept=_logits_gap(torch, model.cfg, masked, clean, tokens),
                    pruned_kept_instead=_logits_gap(torch, model.cfg, masked,
                                                    _clean_keeping_pruned(mgr, cp), tokens))
        zero_frac = {k: float((v == 0).float().mean()) for k, v in _leaves(shaped).items()
                     if k.startswith("layers/attn") or k.startswith("layers/mlp")}
    del cp, shaped, masked, clean
    med = sorted(step_s)[len(step_s) // 2]
    res = dict(phase="compress_train", model=SHAPING_PRESET, layers=cfg.num_layers,
               seq=z["seq"], micro_batch=z["micro"], gas=z["gas"], timed_steps=z["steps"],
               offsets=[z["offset"], z["offset"] + 1], warmup_loss=first, losses=losses,
               step_s=step_s, step_s_median=med, train_step_s_median=train_step_s,
               step_s_without_act_quant=no_aq_s,
               step_vs_train=med / train_step_s if train_step_s else None,
               transform_wall_ms=wall_ms, transform_device_ms=dev_ms,
               transform_device_ms_per_step=None if dev_ms is None else dev_ms * z["gas"],
               transform_step_share=None if dev_ms is None else
               dev_ms * z["gas"] / (1e3 * med),
               transform_profile_top=rows[:8], l1_threshold_kthvalue_vs_sort=kth,
               l1_kept=pruned,
               l1_kept_fraction={k: v[0] / v[1] for k, v in pruned.items()},
               structured_info=info, zero_fraction=zero_frac,
               redundancy_clean_logits_rel_err=gaps, redundancy_clean_tolerance=CLEAN_RTOL,
               peak_memory_bytes=torch.cuda.max_memory_allocated() if DEVICE == "cuda"
               else None, launches=launches,
               launches_per_step={n: launches[n] / z["steps"] for n in launches}, gpu=gpu)
    emit(res)
    bad = []
    if not (np.isfinite(first) and np.isfinite(losses).all()):
        bad.append(f"losses {first} {losses}")
    bad += [f"l1 {k}: kept {v[0]} of {v[1]}, want {v[2]} (+{v[3]} tied)"
            for k, v in pruned.items() if not v[2] <= v[0] < v[2] + max(v[3], 1)]
    for kind, per in info.items():
        bad += [f"{kind} {p}: {u}" for p, u in per.items()
                if u["kept_units"] != max(1, round(u["of"] * 0.5))]
    if not gaps["kept"] <= CLEAN_RTOL < gaps["pruned_kept_instead"]:
        bad.append(f"redundancy_clean's logits against the masked tree's: {gaps}, the "
                   f"right units within {CLEAN_RTOL}, the pruned ones beyond it")
    if not kth["same"]:
        bad.append(f"kthvalue's threshold differs from the sorted one: {kth}")
    if bad:
        raise AssertionError(f"compress_train: {bad}")
    if DEVICE == "cuda":
        check_train_launches("compress_train", launches, cfg.num_layers, z["gas"], z["steps"],
                             False)
    del engine
    return res


def kd_train_phase(torch, K, gpu):
    """``kd_train``: the flagship's 24 layers as the teacher and a 12-layer
    student from ``layer_reduction_init`` (``teacher_layer`` the odd
    layers) trained through ``make_kd_loss_fn`` (one student forward a
    step, the teacher under no_grad), KD_TRAIN's steps.  Gates: the
    student's leaves the teacher's odd layers (bit for bit); K1f (24 + 12)
    x GAS a step, K1b 12 x GAS, K8 once; losses finite."""
    import numpy as np
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.compression.compress import layer_reduction_init, make_kd_loss_fn
    from deepspeed_tpu_torch.models.transformer import init_params

    z = KD_TRAIN
    teacher = _shaping_model()
    tcfg = teacher.cfg
    ids = list(range(1, tcfg.num_layers, 2))[:z["student_layers"]]
    student = _shaping_model(len(ids))
    t_params = init_params(tcfg, seed=SEED, device=DEVICE, dtype=torch.float32)
    lr = {"enabled": True, "keep_number_layer": len(ids), "teacher_layer": ids,
          "module_name_prefix": "layers"}
    s_params = layer_reduction_init(t_params, lr)
    same = all(torch.equal(s_params["layers"][g][n], t_params["layers"][g][n][ids])
               for g in s_params["layers"] for n in s_params["layers"][g])
    loss_fn = make_kd_loss_fn(student, teacher, t_params, alpha=z["alpha"],
                              temperature=z["temperature"])
    del t_params  # the loss keeps the teacher in the compute type
    torch.cuda.reset_peak_memory_stats()
    engine, _, _, _ = initialize(model=student, params=s_params, loss_fn=loss_fn,
                                 config=bench_config(z["micro"], z["gas"]), device=DEVICE)
    del s_params
    batch = _token_batch(tcfg, z["gas"], z["micro"], z["seq"])
    first = float(engine.train_batch(batch))
    K.reset_launches()
    step_s, losses = [], []
    for _ in range(z["steps"]):
        t0 = time.perf_counter()
        losses.append(float(engine.train_batch(batch)))
        step_s.append(time.perf_counter() - t0)
    launches = dict(K.LAUNCHES)
    res = dict(phase="kd_train", model=SHAPING_PRESET, teacher_layers=tcfg.num_layers,
               student_layers=len(ids), teacher_layer=ids, seq=z["seq"],
               micro_batch=z["micro"], gas=z["gas"], alpha=z["alpha"],
               temperature=z["temperature"], student_is_teacher_layers=same,
               warmup_loss=first, losses=losses, step_s=step_s,
               step_s_median=sorted(step_s)[len(step_s) // 2],
               peak_memory_bytes=torch.cuda.max_memory_allocated() if DEVICE == "cuda"
               else None, launches=launches,
               launches_per_step={n: launches[n] / z["steps"] for n in launches}, gpu=gpu)
    emit(res)
    if not same or not (np.isfinite(first) and np.isfinite(losses).all()):
        raise AssertionError(f"kd_train: student from the teacher {same}, losses {losses}")
    if DEVICE == "cuda":
        n = z["steps"] * z["gas"]
        want = {"flash_fwd": (tcfg.num_layers + len(ids)) * n, "flash_bwd_dq": len(ids) * n,
                "flash_bwd_dkv": len(ids) * n, "fused_adamw": z["steps"]}
        bad = {k: (launches[k], w) for k, w in want.items() if launches[k] != w}
        if bad:
            raise AssertionError(f"kd_train: launches (got, expected) {bad}")
    del engine, loss_fn
    return res


def _hybrid_gen(torch, K, hyb, prompts, samp, batched=True):
    """Greedy streams of ``prompts`` through the hybrid engine
    (``generate_batch``, or ``generate`` one prompt at a time), with the
    launches and the serving engine's dispatches they took."""
    inf = hyb._inference
    s0 = dict(inf.stats)
    before = dict(K.LAUNCHES)
    out = hyb.generate_batch(prompts, samp) if batched else [hyb.generate(p, samp)
                                                             for p in prompts]
    _sync(torch)
    return out, _launch_diff(K, before), {k: inf.stats[k] - s0[k] for k in (
        "prefill_dispatches", "decode_ticks", "decode_bursts", "burst_ticks")}


def _k8_sizes(torch):
    """A context recording the element count of each K8 launch by the
    optimizers (``ops.optimizers.fused_adamw_flat``)."""
    import deepspeed_tpu_torch.ops.optimizers as O

    sizes = []
    real = O.fused_adamw_flat

    @contextlib.contextmanager
    def ctx():
        def rec(p, *a, **kw):
            sizes.append(int(p.numel()))
            return real(p, *a, **kw)

        O.fused_adamw_flat = rec
        try:
            yield sizes
        finally:
            O.fused_adamw_flat = real

    return ctx()


def lora_check(torch, K):
    """A 2-layer LoRA engine at full width, one step at LORA_GEN's check
    length, then its hybrid's greedy streams replayed on the CPU in fp32
    through the merged weights (near-argmax)."""
    import numpy as np
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.inference.sampling import SamplingParams
    from deepspeed_tpu_torch.linear import LoRACausalLM, LoRAConfig
    from deepspeed_tpu_torch.runtime.hybrid_engine import DeepSpeedHybridEngine

    z, g = LORA_TRAIN, LORA_GEN
    model = LoRACausalLM(_shaping_model(g["check_layers"]),
                         LoRAConfig(lora_r=z["r"], lora_alpha=z["alpha"]))
    conf = bench_config(2, 1)
    conf["optimizer"]["params"]["lr"] = z["lr"]
    engine, _, _, _ = initialize(model=model, params=model.init_params(seed=SEED, device=DEVICE),
                                 config=conf, device=DEVICE)
    engine.train_batch(_token_batch(model.cfg, 1, 2, g["check_seq"]))
    hyb = DeepSpeedHybridEngine(engine, max_seqs=g["prompts"], num_blocks=256, block_size=32,
                                max_seq_len=g["max_seq_len"])
    rng = np.random.default_rng(SEED + 20)
    prompts = [rng.integers(1, model.cfg.vocab_size, g["prompt_len"]).tolist()
               for _ in range(g["prompts"])]
    out = hyb.generate_batch(prompts, SamplingParams(temperature=0.0, max_new_tokens=g["new"]))
    merged = _tree_cpu(model.export_merged(engine.params))
    worst, exact, total = replay_on_cpu(torch, merged, model.cfg,
                                        dict(enumerate(prompts)), dict(enumerate(out)))
    audit = hyb._inference.close()
    del hyb, engine
    return dict(layers=g["check_layers"], argmax_exact=f"{exact}/{total}",
                argmax_worst_gap=worst, tolerance=ARGMAX_TOL_FRAC, close=audit)


def lora_hybrid_phase(torch, K, gpu, train_res):
    """``lora_hybrid``: ``LoRACausalLM`` over the flagship's 24 layers (r 16,
    alpha 32, the default targets, the base frozen in bf16) trained 3
    steps of the train cell, then ``DeepSpeedHybridEngine.generate_batch``
    (8 prompts x 128 tokens, 32 greedy tokens) before and after.  Gates:
    K8 once a step over exactly the adapters' elements (the launches'
    sizes recorded); the base bit-identical after training; K1f / K2 layers
    x dispatches; the generations change after training; a hybrid with
    ``decode_megastep`` 8, whose burst graph was captured before training,
    token-identical after the refresh to a per-tick hybrid (the graph
    reads the refreshed weights in place); the 2-layer merged copy
    near-argmax on the CPU; no leak.  Reports the masters' and the
    optimizer's bytes beside the plain engine's (4 and 8 bytes a
    parameter, +4) and the peak beside the train phase's
    (``train_res``)."""
    import numpy as np
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.inference.sampling import SamplingParams
    from deepspeed_tpu_torch.linear import LoRACausalLM, LoRAConfig
    from deepspeed_tpu_torch.runtime.hybrid_engine import DeepSpeedHybridEngine

    z, g = LORA_TRAIN, LORA_GEN
    K.reset_launches()
    check = lora_check(torch, K)
    _free(torch)
    inner = _shaping_model()
    cfg = inner.cfg
    model = LoRACausalLM(inner, LoRAConfig(lora_r=z["r"], lora_alpha=z["alpha"]))
    params = model.init_params(seed=SEED, device=DEVICE)
    n_lora = sum(t.numel() for t in _leaves(params["lora"]).values())
    base0 = {k: v.clone() for k, v in _leaves(params["base"]).items()}
    conf = bench_config(z["micro"], z["gas"])
    conf["optimizer"]["params"]["lr"] = z["lr"]
    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()
    engine, _, _, _ = initialize(model=model, params=params, config=conf, device=DEVICE)
    del params
    mem = engine.memory_breakdown()
    serve = dict(max_seqs=g["prompts"], num_blocks=256, block_size=32,
                 max_seq_len=g["max_seq_len"])
    hyb = DeepSpeedHybridEngine(engine, **serve)
    burst = DeepSpeedHybridEngine(engine, serve={"decode_megastep": g["burst"]}, **serve)
    tick = DeepSpeedHybridEngine(engine, **serve)
    rng = np.random.default_rng(SEED + 21)
    prompts = [rng.integers(1, cfg.vocab_size, g["prompt_len"]).tolist()
               for _ in range(g["prompts"])]
    samp = SamplingParams(temperature=0.0, max_new_tokens=g["new"])
    t0 = time.perf_counter()
    gen0, l_gen0, d_gen0 = _hybrid_gen(torch, K, hyb, prompts, samp)
    gen0_s = time.perf_counter() - t0
    bp = prompts[:g["burst_prompts"]]
    b0, _, db0 = _hybrid_gen(torch, K, burst, bp, samp, batched=False)  # captures the graph
    graphs0 = dict(burst._inference._burst.graphs) if burst._inference._burst else {}
    batch = _token_batch(cfg, z["gas"], z["micro"], z["seq"])
    before = dict(K.LAUNCHES)
    step_s, losses = [], []
    with _k8_sizes(torch) as sizes:
        for _ in range(z["steps"]):
            t0 = time.perf_counter()
            losses.append(float(engine.train_batch(batch)))
            step_s.append(time.perf_counter() - t0)
    l_train = _launch_diff(K, before)
    peak = torch.cuda.max_memory_allocated() if DEVICE == "cuda" else None
    base_same = all(torch.equal(v, base0[k]) for k, v in _leaves(engine.params["base"]).items())
    del base0
    t0 = time.perf_counter()
    gen1, l_gen1, d_gen1 = _hybrid_gen(torch, K, hyb, prompts, samp)  # refresh, then generate
    gen1_s = time.perf_counter() - t0
    b1, _, db1 = _hybrid_gen(torch, K, burst, bp, samp, batched=False)
    t1, _, dt1 = _hybrid_gen(torch, K, tick, bp, samp, batched=False)
    graphs1 = dict(burst._inference._burst.graphs) if burst._inference._burst else {}
    same_graphs = bool(graphs0) and all(graphs1.get(k) is v for k, v in graphs0.items()) \
        and len(graphs1) == len(graphs0)
    audits = [h._inference.close() for h in (hyb, burst, tick)]
    changed = sum(a != b for x, y in zip(gen0, gen1) for a, b in zip(x, y))
    L = cfg.num_layers
    dec = decode_kernel(cfg)
    gen_gate = {name: (l.get("flash_fwd", 0), L * d["prefill_dispatches"],
                       l.get(dec, 0), L * d["decode_ticks"])
                for name, l, d in (("before", l_gen0, d_gen0), ("after", l_gen1, d_gen1))}
    plain_params = cfg.param_count
    res = dict(phase="lora_hybrid", model=SHAPING_PRESET, layers=L, r=z["r"],
               alpha=z["alpha"], seq=z["seq"], micro_batch=z["micro"], gas=z["gas"],
               lr=z["lr"], adapter_elements=n_lora, k8_launch_elements=sizes,
               losses=losses, step_s=step_s, step_s_median=sorted(step_s)[len(step_s) // 2],
               train_step_s_median=train_res["step_s_median"],
               master_params_bytes=mem["master_params_bytes"],
               opt_state_bytes=mem["opt_state_bytes"],
               plain_master_params_bytes=4 * plain_params,
               plain_opt_state_bytes=8 * plain_params + 4,
               peak_memory_bytes=peak, train_peak_memory_bytes=train_res["peak_memory_bytes"],
               base_bit_identical=base_same, generate_batch_s=dict(before=gen0_s, after=gen1_s),
               generations_changed_tokens=f"{changed}/{g['prompts'] * g['new']}",
               dispatches=dict(before=d_gen0, after=d_gen1),
               launches_gate=gen_gate, burst_dispatches=dict(before=db0, after=db1,
                                                             per_tick=dt1),
               burst_graphs_kept=same_graphs,
               bursts_token_identical_to_per_tick=b1 == t1,
               burst_changed_after_training=b1 != b0, narrow_check=check, close=audits,
               launches_train=l_train, launches=dict(K.LAUNCHES), gpu=gpu)
    emit(res)
    bad = []
    if not np.isfinite(losses).all():
        bad.append(f"losses {losses}")
    if not base_same:
        bad.append("the frozen base moved")
    if engine._masters.flat.numel() != n_lora or mem["opt_state_bytes"] != 8 * n_lora + 4:
        bad.append(f"masters {engine._masters.flat.numel()} / state {mem['opt_state_bytes']} "
                   f"for {n_lora} adapter elements")
    if changed == 0:
        bad.append("the generations did not change after training")
    if b1 != t1:
        bad.append("bursts after the refresh differ from per-tick decoding")
    if check["argmax_worst_gap"] > ARGMAX_TOL_FRAC:
        bad.append(f"2-layer merged replay {check}")
    if any(a["blocks_in_use"] for a in audits + [check["close"]]):
        bad.append(f"leaked blocks {audits} {check['close']}")
    if DEVICE == "cuda":
        if sizes != [n_lora] * z["steps"]:
            bad.append(f"K8 launches over {sizes}, want {z['steps']} x {n_lora}")
        if l_train.get("fused_adamw") != z["steps"] or any(
                l_train.get(n) != L * z["gas"] * z["steps"] for n in ATTN_KERNELS[False]):
            bad.append(f"training launches {l_train}")
        bad += [f"{k}: K1f {a} != {b} or {dec} {c} != {d}" for k, (a, b, c, d) in gen_gate.items()
                if a != b or c != d or b == 0]
        if not (db0["decode_bursts"] and db1["decode_bursts"] and same_graphs):
            bad.append(f"bursts {db0} {db1}, graphs kept {same_graphs}")
    if bad:
        raise AssertionError(f"lora_hybrid: {bad}")
    del engine, hyb, burst, tick
    return res


def _double_backward_raises(torch, attn, device, dtype):
    """Whether a second derivative through ``attn`` raises the
    once-differentiable error (s 256, 8 heads on 2 kv heads, hd 128)."""
    gen = torch.Generator(device=device).manual_seed(SEED)
    q, k, v = (torch.randn((1, 256, h, 128), generator=gen, device=device).to(dtype)
               .requires_grad_(True) for h in (8, 2, 2))
    w = torch.randn((1, 256, 8, 128), generator=gen, device=device).to(dtype)
    o = attn(q, k, v)
    loss = (o.float() * w.float()).sum() ** 2 + (q.float() ** 3).sum()
    g, = torch.autograd.grad(loss, q, create_graph=True)
    try:
        torch.autograd.grad((g.float() * w.float()).sum(), q)
    except RuntimeError as exc:
        return "differentiate twice" in str(exc)
    return False


def hvp_check(torch):
    """eigen_check's Hessian-vector product, which launches no kernel
    (``main`` runs it while the kernels build): the flagship's width at
    EIGEN_CHECK's layers and seq, in fp32 through the plain attention body
    the estimator runs, on the card and on the CPU on the same ``v``.
    Returns (relative Frobenius error, card seconds, CPU seconds)."""
    from deepspeed_tpu_torch.models.transformer import CausalLM, init_params
    from deepspeed_tpu_torch.runtime.eigenvalue import hvp_fn

    z = EIGEN_CHECK
    cfg = _shaping_model(z["layers"]).cfg
    params = init_params(cfg, seed=SEED, device="cpu", dtype=torch.float32)
    batch = _token_batch(cfg, z["gas"], z["micro"], z["seq"])
    micro0 = {"input_ids": torch.as_tensor(batch["input_ids"][0])}
    ref = CausalLM(cfg.replace(dtype=torch.float32, attn_impl="reference"))
    gen = torch.Generator().manual_seed(SEED + 30)
    v = [torch.randn(x.shape, generator=gen) for x in _leaves(params).values()]
    hv = {}
    for dev in (DEVICE, "cpu"):
        t0 = time.perf_counter()
        hvp, _ = hvp_fn(ref.loss_fn, _to(params, dev),
                        {k: t.to(dev) for k, t in micro0.items()})
        hv[dev] = [h.cpu() for h in hvp([x.to(dev) for x in v])]
        hv[f"{dev}_s"] = time.perf_counter() - t0
        del hvp
    num = sum(float(((a.double() - b.double()) ** 2).sum()) for a, b in zip(hv[DEVICE], hv["cpu"]))
    den = sum(float((b.double() ** 2).sum()) for b in hv["cpu"])
    return (num / den) ** 0.5, hv[f"{DEVICE}_s"], hv["cpu_s"]


def eigen_check_phase(torch, K, gpu, hvp):
    """``eigen_check``: the flagship's width at 2 layers, seq 512.  One
    Hessian-vector product in fp32 (the plain attention body the
    estimator runs) on the card against the CPU on the same ``v``
    (``hvp``, ``hvp_check``'s result: relative Frobenius under HVP_RTOL,
    TF32 off); the engine's ``block_eigenvalues`` at every
    ``resolution``-th step (bf16, the flash Function in training, K1f /
    K1b layers x GAS a step: the estimator's double backward never
    reaches K1), finite; and a double backward through K1 and K7 on the
    card raises."""
    import numpy as np
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.models.transformer import init_params
    from deepspeed_tpu_torch.ops.kernels.flash_attention import flash_attention
    from deepspeed_tpu_torch.ops.kernels.sparse_attention import block_sparse_flash_attention

    z = EIGEN_CHECK
    model = _shaping_model(z["layers"])
    cfg = model.cfg
    params = init_params(cfg, seed=SEED, device="cpu", dtype=torch.float32)
    batch = _token_batch(cfg, z["gas"], z["micro"], z["seq"])
    rel, hvp_card_s, hvp_cpu_s = hvp
    conf = bench_config(z["micro"], z["gas"])
    conf["eigenvalue"] = {"enabled": True, "max_iter": z["max_iter"],
                          "gas_boundary_resolution": z["resolution"]}
    engine, _, _, _ = initialize(model=model, params=params, config=conf, device=DEVICE)
    K.reset_launches()
    t0 = time.perf_counter()
    losses = [float(engine.train_batch(batch)) for _ in range(z["steps"])]
    steps_s = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    eig = list(engine.block_eigenvalues)
    raises = {}
    if DEVICE == "cuda":
        raises["K1"] = _double_backward_raises(
            torch, lambda q, k, v_: flash_attention(q, k, v_, causal=True), DEVICE,
            torch.bfloat16)
        layout = np.tril(np.ones((2, 2), bool))
        raises["K7"] = _double_backward_raises(
            torch, lambda q, k, v_: block_sparse_flash_attention(q, k, v_, layout, 128),
            DEVICE, torch.bfloat16)
    res = dict(phase="eigen_check", model=SHAPING_PRESET, layers=cfg.num_layers, seq=z["seq"],
               micro_batch=z["micro"], gas=z["gas"], hvp_rel_err=rel, hvp_tolerance=HVP_RTOL,
               hvp_card_s=hvp_card_s, hvp_cpu_s=hvp_cpu_s,
               max_iter=z["max_iter"], resolution=z["resolution"], losses=losses,
               steps_with_estimates_s=steps_s, block_eigenvalues=eig,
               double_backward_raises=raises, launches=launches, gpu=gpu)
    emit(res)
    bad = []
    if not rel < HVP_RTOL:
        bad.append(f"HVP card vs CPU rel {rel}")
    want_steps = [s for s in range(1, z["steps"] + 1) if s % z["resolution"] == 0]
    if [s for s, _ in eig] != want_steps or not all(np.isfinite(e) and e >= 0 for _, e in eig):
        bad.append(f"block_eigenvalues {eig}, want steps {want_steps}")
    if DEVICE == "cuda" and not all(raises.values()):
        bad.append(f"double backward on the card: {raises}")
    if bad:
        raise AssertionError(f"eigen_check: {bad}")
    if DEVICE == "cuda":
        check_train_launches("eigen_check", launches, cfg.num_layers, z["gas"], z["steps"],
                             False)
    del engine
    return res


def build_window_references(torch, K):
    """The checks' halves that launch no kernel of the port, which ``main``
    runs while the kernels build: the optimizers' updates on the card and
    the CPU, eigen_check's HVP pair, compress_check's transform and
    ``redundancy_clean`` pairs, and the CPU engines' references of
    train_check, sparse_train_check, schedule_check and compress_check.
    Returns the references by phase, and ``seconds``, each one's; raises
    if any kernel launched (a launch would build beside the builder)."""
    def optimizers():
        inputs = optimizer_inputs(torch)
        return {n: optimizer_check(torch, n, inputs) for n in NEW_OPTIMIZERS}

    jobs = (("optimizers", optimizers),
            ("eigen_check", lambda: hvp_check(torch)),
            ("compress_check", lambda: compress_check_reference(torch)),
            ("train_check", lambda: train_check_reference(torch)),
            ("sparse_train_check", lambda: train_check_reference(torch, SPARSE_CHECK)),
            ("schedule_check", lambda: schedule_check_reference(torch)))
    refs, seconds = {}, {}
    for name, job in jobs:
        t0 = time.perf_counter()
        refs[name] = job()
        seconds[name] = time.perf_counter() - t0
    _free(torch)
    if any(K.LAUNCHES.values()):
        raise AssertionError(f"a kernel launched during the build: {dict(K.LAUNCHES)}")
    refs["seconds"] = seconds
    return refs


# ---------------------------------------------------------------------------
# the compile section (the attention kernels as torch.library ops under
# torch.compile) and the hybrid engine's quantized refresh
# ---------------------------------------------------------------------------
COMPILE_PRESET = "llama3_proxy_410m"  # CPU rehearsals: "tiny"
# the flagship's width and cell (seq 4096, micro 8, GAS 2, bf16 over fp32
# masters, AdamW, selective remat, the chunked CE) at 2 of its 24 layers
# under inductor (4 layers compiled in 45.3 s, 2 in 48.9 on a slower host:
# the compile's cost is mostly fixed); the block-sparse twin
# (fixed(128, 4, 1), FusedAdam) at 2 layers under aot_eager: its point is
# K7's ops called from a compiled graph, and inductor's second compile
# (23-29 s) would take the whole smoke past its time limit
COMPILE_TRAIN = dict(layers=2, seq=4096, micro=8, gas=2, steps=4, sparse_layers=2,
                     sparse_steps=2, backend="inductor", sparse_backend="aot_eager")
# compiled against eager losses, relative: the same bf16 step, inductor's
# fused elementwise kernels rounding in other places.  Read on the card:
# 1.0e-5 at 2 layers, 3.3e-5 at 4; the losses move 3.4 % a step, so a
# limit near that movement would pass a graph that drops part of a
# gradient
COMPILE_LOSS_RTOL = 1e-3
# each leaf's update over the run (a stacked leaf layer by layer), compiled
# against eager, as a cosine: a dropped gradient leaves a slice moved by
# weight decay alone (1e-5 of it a step against Adam's 1e-4 an element),
# whose cosine with the eager update is near 0.  The phase plants that
# fault (layer 0's attention gradients zeroed in an eager twin,
# ``_zero_layer0_attention_grads``) and requires a gate to catch it
COMPILE_UPDATE_COS_MIN = 0.9
HYBRID_QUANT = dict(layers=2, seq=512, micro=2, gas=1, steps=2, lr=1e-3, prompts=2,
                    prompt_len=64, new=16, burst=8, max_seq_len=256)


def _compile_model(layers):
    from deepspeed_tpu_torch.models.presets import get_preset
    from deepspeed_tpu_torch.models.transformer import CausalLM

    over = dict(num_layers=layers)
    if COMPILE_PRESET == "llama3_proxy_410m":
        over["loss_chunk_size"] = 2048
    else:
        over["max_seq_len"] = COMPILE_TRAIN["seq"] + 1
    return CausalLM(get_preset(COMPILE_PRESET, **over))


def _step_categories(rows):
    """Device ms of one step by kind of kernel (the profiler's rows):
    attention (K1 / K7), K8, matrix products, the rest (elementwise,
    reductions, copies; inductor's fused kernels are ``triton_*``)."""
    cats = {"attention": 0.0, "fused_adamw": 0.0, "gemm": 0.0, "triton": 0.0, "other": 0.0}
    for r in rows:
        n = r["name"]
        if re.search(r"flash_(fwd|bwd_dq|bwd_dkv)_kernel|sparse", n):
            cats["attention"] += r["ms_per_call"]
        elif "adamw" in n:
            cats["fused_adamw"] += r["ms_per_call"]
        elif re.search(r"gemm|xmma|cutlass|nvjet|sm90_|wgmma", n):
            cats["gemm"] += r["ms_per_call"]
        elif n.startswith("triton_"):
            cats["triton"] += r["ms_per_call"]
        else:
            cats["other"] += r["ms_per_call"]
    return cats


def _zero_layer0_attention_grads(torch, loss_fn):
    """``loss_fn`` whose gradients of layer 0's attention weights are zero:
    the fault a compiled graph that dropped part of a gradient would make."""
    def fn(params, micro, gen):
        attn = {n: torch.cat([w[:1].detach(), w[1:]])
                for n, w in params["layers"]["attn"].items()}
        return loss_fn({**params, "layers": {**params["layers"], "attn": attn}}, micro, gen)
    return fn


def _leaf_paths(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaf_paths(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _update_cosines(torch, got, ref):
    """{leaf (``path[i]`` for layer i of a stacked leaf): the cosine of the
    updates ``got`` and ``ref`` in fp64}; 1 where both are zero."""
    out = {}
    for path, a in got.items():
        b = ref[path]
        pairs = ([(f"{path}[{i}]", a[i], b[i]) for i in range(a.shape[0])]
                 if path.startswith("layers/") else [(path, a, b)])
        for name, x, y in pairs:
            x, y = x.double().flatten(), y.double().flatten()
            nx, ny = float(x.norm()), float(y.norm())
            out[name] = 1.0 if nx == ny == 0 else (
                float(x @ y) / (nx * ny) if nx and ny else 0.0)
    return out


def _compile_twins(torch, K, layers, steps, backend, sparse=None, profile=False,
                   planted=False):
    """An eager engine and its ``compile: {"backend": backend}`` twin, from
    the same weights, on the same batch: the first step (the compile, for
    the twin), then ``steps`` timed steps with their launches, and each
    leaf's update over the run as a cosine with the eager twin's.  With
    ``planted``, a third engine, eager, whose loss drops layer 0's
    attention gradients."""
    import torch._dynamo
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.models.transformer import init_params

    z = COMPILE_TRAIN
    out, ref = {}, None
    runs = [("eager", None), ("compiled", {"backend": backend})]
    for name, section in runs + [("planted", None)] * planted:
        torch._dynamo.reset()
        model = _compile_model(layers)
        conf = bench_config(z["micro"], z["gas"], sparse)
        if DEVICE != "cuda":
            conf["bf16"] = {"enabled": False}
        if section is not None:
            conf["compile"] = section
        params = init_params(model.cfg, seed=SEED, device=DEVICE, dtype=torch.float32)
        engine, _, _, _ = initialize(model=model, params=params, config=conf, device=DEVICE)
        del params
        if name == "planted":
            engine.loss_fn = _zero_layer0_attention_grads(torch, engine.loss_fn)
        p0 = {k: v.detach().clone() for k, v in _leaf_paths(engine.params)}
        batch = _token_batch(model.cfg, z["gas"], z["micro"], z["seq"])
        t0 = time.perf_counter()
        first = float(engine.train_batch(batch))
        first_s = time.perf_counter() - t0
        K.reset_launches()
        losses, step_s = [first], []
        for _ in range(steps):
            _sync(torch)
            t0 = time.perf_counter()
            losses.append(float(engine.train_batch(batch)))
            step_s.append(time.perf_counter() - t0)
        launches = dict(K.LAUNCHES)
        run = dict(first_step_s=first_s, losses=losses, step_s=step_s,
                   step_s_median=sorted(step_s)[len(step_s) // 2], launches=launches,
                   launches_per_step={n: launches[n] / steps for n in launches
                                      if launches[n]})
        update = {k: v.detach() - p0.pop(k) for k, v in _leaf_paths(engine.params)}
        if ref is None:
            ref = update
        else:
            cos = _update_cosines(torch, update, ref)
            worst = min(cos, key=cos.get)
            run.update(update_cos_min=cos[worst], update_cos_worst_leaf=worst,
                       loss_rel_diff=[abs(a - b) / abs(b) for a, b in
                                      zip(losses, out["eager"]["losses"])])
        del update, p0
        if profile and name != "planted" and DEVICE == "cuda":
            wall_ms, dev_ms, rows = _device_profile(torch, lambda: engine.train_batch(batch),
                                                    top=None)
            run.update(profile_step_wall_ms=wall_ms, profile_step_device_ms=dev_ms,
                       device_idle_share=None if dev_ms is None else 1.0 - dev_ms / wall_ms,
                       device_ms_by_kind=_step_categories(rows), profile_top=rows[:8])
        out[name] = run
        del engine
        _free(torch)
    del ref
    _free(torch)
    torch._dynamo.reset()
    return out


def compile_train_phase(torch, K, gpu):
    """``compile_train``: the train cell at ``COMPILE_TRAIN``'s depth under
    ``compile: {"backend": "inductor"}`` against its eager twin (same
    weights, same batch), then a 2-layer block-sparse twin pair under
    ``aot_eager``.  Gates:
    each run's K1 (K7) kernels layers x GAS a step and K8 once, the
    compiled run's launches equal to the eager twin's (the compiled graph
    calls the hand-written kernels, never a generated replacement), the
    losses within ``COMPILE_LOSS_RTOL`` and every leaf's update at a cosine
    of at least ``COMPILE_UPDATE_COS_MIN`` with the eager twin's; an eager
    twin that drops layer 0's attention gradients (``planted``) must fail
    one of those two gates.  Reports the compile seconds (the
    compiled run's first step less its median step), each run's median
    step and its device time by kind of kernel."""
    z = COMPILE_TRAIN
    dense = _compile_twins(torch, K, z["layers"], z["steps"], z["backend"], profile=True,
                           planted=True)
    sparse = _compile_twins(torch, K, z["sparse_layers"], z["sparse_steps"],
                            z["sparse_backend"], sparse=SPARSE_FLAGSHIP)
    bad = []
    for label, twins, layers, steps, is_sparse in (
            ("dense", dense, z["layers"], z["steps"], False),
            ("sparse", sparse, z["sparse_layers"], z["sparse_steps"], True)):
        for name, run in twins.items():
            if DEVICE == "cuda":
                try:
                    check_train_launches(f"compile_train {label} {name}", run["launches"],
                                         layers, z["gas"], steps, is_sparse)
                except AssertionError as exc:
                    bad.append(str(exc))
        watched = (*ATTN_KERNELS[is_sparse], "fused_adamw")
        lc, le = twins["compiled"]["launches"], twins["eager"]["launches"]
        if any(lc[n] != le[n] for n in watched):
            bad.append(f"{label}: compiled launches {[lc[n] for n in watched]} != eager "
                       f"{[le[n] for n in watched]}")
        c = twins["compiled"]
        if not max(c["loss_rel_diff"]) <= COMPILE_LOSS_RTOL:
            bad.append(f"{label}: losses {c['losses']} vs {twins['eager']['losses']}")
        if not c["update_cos_min"] >= COMPILE_UPDATE_COS_MIN:
            bad.append(f"{label}: update cosine {c['update_cos_min']} at "
                       f"{c['update_cos_worst_leaf']}")
        if "planted" in twins:  # the gates must catch a dropped gradient
            p = twins["planted"]
            p["caught_by"] = [g for g, hit in (
                ("losses", max(p["loss_rel_diff"]) > COMPILE_LOSS_RTOL),
                ("update_cos", p["update_cos_min"] < COMPILE_UPDATE_COS_MIN)) if hit]
            if not p["caught_by"]:
                bad.append(f"{label}: the planted fault passed the gates {p}")
        twins["compile_s"] = c["first_step_s"] - c["step_s_median"]
    res = dict(phase="compile_train", model=COMPILE_PRESET, layers=z["layers"], seq=z["seq"],
               micro_batch=z["micro"], gas=z["gas"], backend=z["backend"],
               sparse_backend=z["sparse_backend"],
               loss_rtol=COMPILE_LOSS_RTOL, update_cos_min=COMPILE_UPDATE_COS_MIN,
               dense=dense, sparse_layers=z["sparse_layers"],
               sparse_attention=SPARSE_FLAGSHIP, sparse=sparse,
               compile_s=dict(dense=dense["compile_s"], sparse=sparse["compile_s"]),
               step_s_median=dict(eager=dense["eager"]["step_s_median"],
                                  compiled=dense["compiled"]["step_s_median"]),
               launches={n: dense["compiled"]["launches"][n] + sparse["compiled"]["launches"][n]
                         for n in K.LAUNCHES},
               launches_per_step=dict(dense=dense["compiled"]["launches_per_step"],
                                      sparse=sparse["compiled"]["launches_per_step"]),
               torch=torch.__version__, gpu=gpu)
    emit(res)
    if bad:
        raise AssertionError(f"compile_train: {bad}")
    return res


def _quant_payloads(torch, tree, prefix=""):
    """Every quantized leaf's payload tensors by path (the serving tree)."""
    from deepspeed_tpu_torch.ops.quantizer import ServingQuant, ServingQuantFP6

    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}"
        if isinstance(v, dict):
            out.update(_quant_payloads(torch, v, path))
        elif isinstance(v, ServingQuant):
            out[path + ".q"], out[path + ".s"] = v.q.view(torch.uint8), v.s
        elif isinstance(v, ServingQuantFP6):
            out[path + ".packed"], out[path + ".s"] = v.packed, v.s
    return out


def hybrid_quant_phase(torch, K, gpu):
    """``hybrid_quant``: for int8, fp8 and fp6, a hybrid engine over
    ``HYBRID_QUANT``'s layers of the flagship (bf16) serving quantized
    weights with ``decode_megastep`` bursts: a first ``generate`` captures
    the burst graph, ``train_batch`` moves the weights, the next
    ``generate`` re-quantizes them into the payloads in place and replays
    the same graph.  Gates: the tokens after training equal a fresh
    quantized engine's built from the trained weights; every payload byte
    equals a fresh ``quantize_serving_params`` of them and differs from
    before somewhere; the burst graphs are the ones captured before; K4 /
    K5 launched in the generate after the refresh."""
    import numpy as np
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.inference.engine_v2 import InferenceEngineV2
    from deepspeed_tpu_torch.inference.sampling import SamplingParams
    from deepspeed_tpu_torch.models.transformer import init_params
    from deepspeed_tpu_torch.ops.quantizer import quantize_serving_params
    from deepspeed_tpu_torch.runtime.hybrid_engine import DeepSpeedHybridEngine

    z = HYBRID_QUANT
    serve = dict(max_seqs=z["prompts"], num_blocks=64, block_size=32,
                 max_seq_len=z["max_seq_len"], serve={"decode_megastep": z["burst"]})
    formats, bad, launches = {}, [], {}
    for fmt in QMM_NAMES:
        model = _compile_model(z["layers"])
        cfg = model.cfg
        conf = bench_config(z["micro"], z["gas"])
        conf["optimizer"]["params"]["lr"] = z["lr"]
        if DEVICE != "cuda":
            conf["bf16"] = {"enabled": False}
        params = init_params(cfg, seed=SEED, device=DEVICE, dtype=torch.float32)
        engine, _, _, _ = initialize(model=model, params=params, config=conf, device=DEVICE)
        del params
        hyb = DeepSpeedHybridEngine(engine, quantize_weights=fmt, **serve)
        rng = np.random.default_rng(SEED + 40)
        prompts = [rng.integers(1, cfg.vocab_size, z["prompt_len"]).tolist()
                   for _ in range(z["prompts"])]
        samp = SamplingParams(temperature=0.0, max_new_tokens=z["new"])
        gen0, l_gen0, d_gen0 = _hybrid_gen(torch, K, hyb, prompts, samp, batched=False)
        burst = hyb._inference._burst
        graphs0 = dict(burst.graphs) if burst is not None else {}
        old = {k: v.clone() for k, v in _quant_payloads(torch, hyb._inference.params).items()}
        batch = _token_batch(cfg, z["gas"], z["micro"], z["seq"])
        losses = [float(hyb.train_batch(batch)) for _ in range(z["steps"])]
        t0 = time.perf_counter()
        gen1, l_gen1, d_gen1 = _hybrid_gen(torch, K, hyb, prompts, samp, batched=False)
        gen1_s = time.perf_counter() - t0
        graphs1 = dict(burst.graphs) if burst is not None else {}
        trained = hyb._serving_params()
        fresh = InferenceEngineV2(params=trained, cfg=hyb._infer_cfg, device=DEVICE,
                                  quantize_weights=fmt, **serve)
        want = [fresh.generate(p, samp) for p in prompts]
        got_bytes = _quant_payloads(torch, hyb._inference.params)
        want_bytes = _quant_payloads(torch, quantize_serving_params(trained, fmt))
        same_bytes = got_bytes.keys() == want_bytes.keys() and all(
            torch.equal(got_bytes[k], want_bytes[k]) for k in want_bytes)
        moved = any(not torch.equal(old[k], got_bytes[k]) for k in old)
        kept = bool(graphs0) and graphs1.keys() == graphs0.keys() and all(
            graphs1[k] is v for k, v in graphs0.items())
        audits = [hyb._inference.close(), fresh.close()]
        name = QMM_NAMES[fmt]
        formats[fmt] = dict(losses=losses, tokens_equal_fresh=gen1 == want,
                            generations_changed=gen1 != gen0, payload_bytes_equal=same_bytes,
                            payloads_moved=moved, burst_graphs_kept=kept,
                            dispatches=dict(before=d_gen0, after=d_gen1),
                            launches_generate=dict(before=l_gen0, after=l_gen1),
                            generate_after_refresh_s=gen1_s)
        for n, c in l_gen0.items():
            launches[n] = launches.get(n, 0) + c
        for n, c in l_gen1.items():
            launches[n] = launches.get(n, 0) + c
        if gen1 != want:
            bad.append(f"{fmt}: tokens {gen1} != a fresh quantized engine's {want}")
        if not same_bytes or not moved:
            bad.append(f"{fmt}: payload bytes equal to a fresh encoding {same_bytes}, "
                       f"moved {moved}")
        if DEVICE == "cuda":
            if not (kept and d_gen1["decode_bursts"]):
                bad.append(f"{fmt}: graphs kept {kept}, bursts {d_gen1}")
            if not l_gen1.get(name):
                bad.append(f"{fmt}: no {name} launch after the refresh ({l_gen1})")
        if any(a["blocks_in_use"] for a in audits):
            bad.append(f"{fmt}: leaked blocks {audits}")
        del engine, hyb, fresh, trained
        _free(torch)
    res = dict(phase="hybrid_quant", model=COMPILE_PRESET, layers=z["layers"],
               decode_megastep=z["burst"], formats=formats, launches=launches, gpu=gpu)
    emit(res)
    if bad:
        raise AssertionError(f"hybrid_quant: {bad}")
    return res


def _free(torch):
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def main() -> None:
    t_start = time.perf_counter()
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke runs on the card only")
    if not os.path.isdir(os.path.join(HERE, "deepspeed_tpu_torch")):
        fail(f"deepspeed_tpu_torch not found beside {__file__}")
    sys.path.insert(0, HERE)
    from deepspeed_tpu_torch.models.presets import get_preset
    from deepspeed_tpu_torch.models.transformer import init_params
    from deepspeed_tpu_torch.ops import kernels as K

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = gpu_line()

    # the checks' halves that launch no kernel of the port (plain PyTorch on
    # the card, the port on the CPU) run while nvcc compiles the kernels
    built = {}
    builder = threading.Thread(target=build_and_dump, args=(K, built))
    t0 = time.perf_counter()
    builder.start()
    try:
        refs = build_window_references(torch, K)
    finally:
        builder.join()
    if "error" in built:
        raise built["error"]
    build = built["build"]
    ptxas = {src: [ln.strip() for ln in K.build_log(src).splitlines() if "registers" in ln]
             for src in dict.fromkeys(K.SOURCES.values())}
    emit(dict(phase="build", seconds=build["seconds"], built=build["built"],
              window_s=time.perf_counter() - t0, references_s=refs.pop("seconds"),
              ptxas=ptxas, gpu=gpu))
    emit(dict(phase="sass", ops=list(SASS_OPS), kernels=sass_phase(K),
              row_quantizers=rowq_sass(K), gpu=gpu))

    errs, cases = kernel_checks(torch)
    _free(torch)
    q_errs, q_cases = quant_kernel_checks(torch)
    errs.update(q_errs)
    emit(dict(phase="kernels", tolerance=KERNEL_TOL, bwd_tolerance=BWD_TOL,
              lse_tolerance=LSE_TOL, quant_matmul_tolerance=QMM_TOL,
              fused_adamw_tolerance=K8_TOL, cases=cases + q_cases,
              gpu=gpu))
    _free(torch)

    cfg = get_preset("llama3_proxy_410m")
    params = init_params(cfg, seed=SEED, device="cuda")
    eng = engine_phase(torch, K, gpu, params, cfg)
    ms_eng = burst_engine_phase(torch, K, gpu, params, cfg, eng["streams"],
                                "llama3_proxy_410m", "megastep", n=64)
    burst_stops_phase(torch, K, gpu, params, cfg)
    ms_sch = megastep_serve_phase(torch, K, gpu, *cut_depth(params, cfg, SERVE_CUT_LAYERS))
    sch = scheduler_phase(torch, K, gpu, params, cfg)
    # the serve front end (router, handoff, fleet plane, chaos) on the same model
    params_cpu = _tree_cpu(params)
    rt = router_phase(torch, K, gpu, params, cfg, params_cpu)
    rh = router_handoff_phase(torch, K, gpu, params, cfg, params_cpu, rt.pop("want_long"))
    _free(torch)
    rk = router_check_phase(torch, K, gpu, cfg)
    rf = router_fleet_phase(torch, K, gpu, params, cfg)
    rc = router_chaos_phase(torch, K, gpu, params, cfg)
    kernel_errors_phase(torch, K, gpu, cfg)
    _free(torch)
    # the out-of-process serve plane (subprocess workers on this card, the
    # kernels built above) and the autotuning package, on the same model
    rr = remote_router_phase(torch, K, gpu, params, cfg, params_cpu, rt)
    rho, remote = remote_handoff_phase(torch, K, gpu, cfg, params_cpu, rh)
    rfl = remote_fleet_phase(torch, K, gpu, cfg, remote)
    del remote
    rch = remote_chaos_phase(torch, K, gpu, cfg, params_cpu, rt, rc)
    ad = adapt_serve_phase(torch, K, gpu, *cut_depth(params, cfg, SERVE_CUT_LAYERS),
                           cut_depth(params_cpu, cfg, SERVE_CUT_LAYERS)[0])
    del params_cpu
    _free(torch)
    at = autotune_serve_phase(torch, K, gpu, params, cfg)
    _free(torch)
    spec = spec_phase(torch, K, gpu, *cut_depth(params, cfg, SERVE_CUT_LAYERS),
                      "llama3_proxy_410m", "spec_serve")
    lcc = longctx_check_phase(torch, K, gpu, cfg)
    lc = longctx_phase(torch, K, gpu, *cut_depth(params, cfg, SERVE_CUT_LAYERS))
    del params
    _free(torch)
    g_eng, g_burst, g_spec = gpt2_serve_phase(torch, K, gpu)
    train_check_phase(torch, K, gpu, refs.pop("train_check"))
    _free(torch)
    train_check_phase(torch, K, gpu, refs.pop("sparse_train_check"))
    _free(torch)
    tr = train_phase(torch, K, gpu)
    adam_times = tr.pop("fused_adamw_timing")
    _free(torch)
    shim = train_shim_phase(torch, K, gpu, tr["train_batch_losses"])
    _free(torch)
    sampling_phase(torch, gpu)
    _free(torch)
    ck = checkpoint_phase(torch, K, gpu)
    hf = hf_roundtrip_phase(torch, K, gpu)
    _free(torch)
    # the instrumented, scheduled step: timers, the profiler, the CSV
    # monitor, curriculum learning and progressive layer drop
    sc = schedule_check_phase(torch, K, gpu, refs.pop("schedule_check"))
    _free(torch)
    st = schedule_train_phase(torch, K, gpu, tr["mfu"])
    _free(torch)
    # compression-aware and parameter-efficient training: the transform and
    # the engines card against CPU, the flagship under every technique, KD
    # into a 12-layer student, LoRA with the hybrid engine's generate, the
    # eigenvalue estimator
    cc = compress_check_phase(torch, K, gpu, refs.pop("compress_check"))
    _free(torch)
    ct = compress_train_phase(torch, K, gpu, tr["step_s_median"])
    _free(torch)
    kd = kd_train_phase(torch, K, gpu)
    _free(torch)
    lh = lora_hybrid_phase(torch, K, gpu, tr)
    _free(torch)
    ec = eigen_check_phase(torch, K, gpu, refs.pop("eigen_check"))
    _free(torch)
    # the attention kernels as torch.library ops under torch.compile, and
    # the hybrid engine's quantized refresh with a burst graph captured
    ctr = compile_train_phase(torch, K, gpu)
    _free(torch)
    hq = hybrid_quant_phase(torch, K, gpu)
    _free(torch)
    # ZeRO-Offload: the CPU tier and the NVMe tier checked against the plain
    # engine, the NVMe tier on the flagship, llama3_8b through the CPU tier
    oc = offload_check_phase(torch, K, gpu)
    _free(torch)
    nt = nvme_train_phase(torch, K, gpu, tr["train_batch_losses"])
    _free(torch)
    ot = offload_train_phase(torch, K, gpu)
    _free(torch)
    sp = train_phase(torch, K, gpu, sparse=SPARSE_FLAGSHIP, steps=SPARSE_TRAIN_STEPS)
    _free(torch)
    opt = optimizers_phase(torch, K, gpu, tr["step_s_median"], refs.pop("optimizers"))
    rm = remat_phase(torch, K, gpu)
    pt = presets_train_phase(torch, K, gpu)
    ps = presets_serve_phase(torch, K, gpu)
    _free(torch)
    # Mixtral-style MoE (training, v2 serving) and the dense v1 engine
    mt = moe_train_phase(torch, K, gpu)
    _free(torch)
    mv, moe = moe_serve_phase(torch, K, gpu)
    v1 = v1_serve_phase(torch, K, gpu, moe)
    del moe
    _free(torch)
    qc = quant_check_phase(torch, K, gpu)
    qs, w_up0 = quant_serve_phase(torch, K, gpu)
    qz = quantizer_phase(torch, K, gpu, w_up0)
    del w_up0
    _free(torch)

    times = timings(torch)
    times.update(quant_timings(torch))
    times["fused_adamw"] = adam_times
    padded = times.pop("padded_head_dims")
    emit(dict(phase="timings", flash_bwd_pair=times.pop("flash_bwd_pair"),
              flash_fwd_train=times["flash_fwd_train"], padded_head_dims=padded,
              earlier_ms={**K1_EARLIER_MS, **K7_EARLIER_MS},
              quant={n: times[n] for n in (*QMM_NAMES.values(), *K6_NAMES,
                                           "quantize_fp8_e5m2")},
              sparse_bwd_pair=times.pop("sparse_bwd_pair"),
              sparse={n: times[n] for n in ATTN_KERNELS[True]},
              fused_adamw=adam_times, gpu=gpu))
    # launches of the main paths (serving engine, its burst, the megastep
    # scheduler, scheduler, speculative serving, seq-sharded long-context
    # serving, gpt2 serving, dense and block-sparse training, the other
    # optimizers, the remat policies, the presets' training and serving,
    # quantized serving, the quantizer API, MoE training and serving, the v1
    # engine), each read right after its own run
    main_paths = (eng, ms_eng, ms_sch, sch, spec, lcc, lc, g_eng, g_burst, g_spec, tr, shim, sp,
                  opt, rm, pt, ps, qc, qs, qz, rt, rh, rk, rf, rc, rr, rho, rfl, rch, ad, at,
                  ck, hf, mt, mv, v1, oc, nt, ot, sc, st, cc, ct, kd, lh, ec, ctr, hq)
    schedule_paths = {"schedule_check": sc, "schedule_train": st}
    shaping_paths = {"compress_check": cc, "compress_train": ct, "kd_train": kd,
                     "lora_hybrid": lh, "eigen_check": ec}
    moe_paths = {"moe_train": mt, "moe_serve": mv, "v1_serve": v1}
    compile_paths = {"compile_train": ctr, "hybrid_quant": hq}
    offload_paths = {"offload_check": oc, "nvme_train": nt, "offload_train": ot}
    resume_paths = {"checkpoint": ck, "hf_roundtrip": hf}
    router_paths = {"router": rt, "router_handoff": rh, "router_check": rk,
                    "router_fleet": rf, "router_chaos": rc}
    # the subprocess workers' launches, read from each child's stats reply
    remote_paths = {"remote_router": rr, "remote_handoff": rho, "remote_fleet": rfl,
                    "remote_chaos": rch}
    per_forward = {**eng["launches_per_forward"], **sch["launches_per_forward"],
                   "paged_decode_hd64": g_eng["launches_per_forward"]["paged_decode_hd64"]}
    for name in ("paged_decode_partial", "ctx_attention_partial"):  # longctx, S = 2
        per_forward[name] = lc["launches_per_forward"][name]
    for fmt, name in QMM_NAMES.items():  # quant_serve at full depth
        per_forward[name] = qs["formats"][fmt]["launches_per_forward"][name]
    # the burst graphs' launches per replayed tick: 410M, gpt2_small, S = 2, 8B
    per_replay = {**ms_eng["launches_per_replay"], **g_burst["launches_per_replay"],
                  **lcc["runs"]["S2"]["burst"]["launches_per_replay"]}
    for fmt, name in QMM_NAMES.items():
        per_replay[name] = qs["formats"][fmt]["launches_per_replay"][name]
    kernels = []
    for name in K.SOURCES:
        launches = sum(p["launches"].get(name, 0) for p in main_paths)
        if launches == 0:
            raise AssertionError(f"kernel {name} never launched on the main paths")
        entry = dict(name=name, route="cuda",
                     source=f"deepspeed_tpu_torch/csrc/{K.SOURCES[name]}",
                     replaces=REPLACES[name], launches=launches,
                     max_abs_err=errs[name], **times[name])
        router_launches = {k: p["launches"].get(name, 0) for k, p in router_paths.items()
                           if p["launches"].get(name)}
        if router_launches:  # the serve front end's phases (ROADMAP item 6)
            entry["launches_router_phases"] = router_launches
        remote_launches = {k: p["launches"].get(name, 0) for k, p in remote_paths.items()
                           if p["launches"].get(name)}
        if remote_launches:  # launched inside the subprocess workers
            entry["launches_remote_phases"] = remote_launches
        resume_launches = {k: p["launches"].get(name, 0) for k, p in resume_paths.items()
                           if p["launches"].get(name)}
        if resume_launches:  # resumed training and the HF round trip
            entry["launches_resume_phases"] = resume_launches
        moe_launches = {k: p["launches"].get(name, 0) for k, p in moe_paths.items()
                        if p["launches"].get(name)}
        if moe_launches:  # Mixtral training and serving, the v1 engine
            entry["launches_moe_v1_phases"] = moe_launches
        offload_launches = {k: p["launches"].get(name, 0) for k, p in offload_paths.items()
                            if p["launches"].get(name)}
        if offload_launches:  # ZeRO-Offload: K8 once a chunk under the CPU tier
            entry["launches_offload_phases"] = offload_launches
        schedule_launches = {k: p["launches"].get(name, 0) for k, p in schedule_paths.items()
                             if p["launches"].get(name)}
        if schedule_launches:  # the scheduled step: curriculum lengths, dropped layers
            entry["launches_schedule_phases"] = schedule_launches
        shaping_launches = {k: p["launches"].get(name, 0) for k, p in shaping_paths.items()
                            if p["launches"].get(name)}
        if shaping_launches:  # compression, distillation, LoRA + hybrid generate, eigenvalues
            entry["launches_shaping_phases"] = shaping_launches
        compile_launches = {k: p["launches"].get(name, 0) for k, p in compile_paths.items()
                            if p["launches"].get(name)}
        if compile_launches:  # the compiled train step, the quantized hybrid's refresh
            entry["launches_compile_phases"] = compile_launches
        for kind in ("dense", "sparse"):
            if ctr["launches_per_step"][kind].get(name):
                entry.setdefault("launches_per_compiled_train_step", {})[kind] = \
                    ctr["launches_per_step"][kind][name]
        if name == "fused_adamw":
            entry["launches_per_offloaded_step"] = {
                "offload_check": oc["launches_per_step"]["fused_adamw"],
                f"offload_train ({ot['model']}, {ot['layers']} layers)":
                    ot["launches_per_step"]["fused_adamw"]}
            entry["offload_train_k8_ms_per_step"] = ot["profile_split"]["k8_ms"]
        if name in per_forward:  # serving: launches per model forward
            entry["launches_per_forward"] = per_forward[name]
        if name in per_replay:  # decode bursts: launches per replayed tick
            entry["launches_per_replayed_tick"] = per_replay[name]
        for run in (tr, sp):  # training: launches per optimizer step
            if run["launches"][name]:
                entry["launches_per_train_step"] = run["launches_per_step"][name]
        if name == "flash_fwd":
            entry["at_train_shape"] = times["flash_fwd_train"]
        if name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):  # K1 at hd 80 / 96
            entry["padded_head_dims"] = padded
        if name == "paged_decode_hd64":
            entry["instantiates"] = ("paged_decode (K2, " + REPLACES["paged_decode"]
                                     + ") at HD = 64: K2p's counterpart, no lane packing")
        if name == "ctx_attention":
            entry["launches_per_verify_tick"] = spec["launches_per_verify_tick"]["ctx_attention"]
        if name in PARTIAL_NOTES:
            entry["note"] = PARTIAL_NOTES[name]
        if name in K6_NAMES:  # the quantizer API: one launch per call
            entry["launches_per_call"] = 1
        kernels.append(entry)
    ends, prev = {}, t_start
    for phase, t in PHASE_ENDS:  # each phase's seconds: since the previous emit
        ends[phase] = ends.get(phase, 0.0) + (t - prev)
        prev = t
    emit(dict(timeline_s=ends, total_s=time.perf_counter() - t_start))
    emit({"kernels": kernels})
    print(gpu, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()

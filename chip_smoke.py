#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (src/repro_torch) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with an NVIDIA H100 and the
CUDA toolkit. Phases, each fatal on failure:

1. build   — compile csrc/matrixflow_gemm.cu, paged_attention.cu,
             flash_attention.cu and ssd_scan.cu with nvcc for sm_90a, all
             at once.
2. kernels — each kernel against its plain PyTorch version on the card at
             the main paths' shapes, bf16 and fp32 (TF32 off): the
             MatrixFlow GEMM at every full-width smollm-135m projection
             (M = batch_slots and M = slots x prompt bucket) and every
             bert-base / vit-base projection (M = 8 x 128, 8 x 197); paged
             attention at H=9, Hkv=3, D=64, page 16, decode and a bucketed
             prefill over shuffled block tables; flash attention at the
             encoders' shapes (bert-base S 128, vit-base S 197, vit-huge S
             257 at D 80) and smollm's contiguous decode, prefill bucket,
             chunked-prefill offset and bottom-right default. Times the
             kernel, the plain version and one PyTorch call for the same
             function (torch.matmul; SDPA) after an L2 flush. Each GEMM
             cell records the route K1 took (its per-route launch
             counters): a bf16 cell must run on wgmma (bf16 takes bm 64 at
             every M on the card, core/plan.py::bm_for), an fp32 cell on
             the CUDA cores; each bf16 decode-step GEMM is timed again on
             mma.sync at bm 16, the route it took before. So too each attention cell: K3 and K4 in bf16 on the
             tensor-core route their chooser names (rows, or split at
             decode), in fp32 on the CUDA cores; every cell is launched
             twice and the two results must be bitwise equal. The paged
             cells' block tables hold an out-of-range page id in every
             entry past a slot's valid keys (the kernels must never read
             one; the plain version reads a valid copy), and a decode cell
             has slots of 0, 1, 128 (a page boundary) and 255 keys.
3. serving — full-width smollm-135m in bf16 from seeded random weights,
             served through the paged engine's submit/step: more requests
             than slots, a pool small enough to preempt. Both kernels'
             launch counters must grow and every request must complete.
             Then one batched generate() on the same engine.
4. parity  — full width in fp32: the kernel path on the card against the
             plain path (the same code on the CPU, where every wrapper runs
             its plain version): prefill and first-decode logits within
             LOGIT_TOL, greedy streams equal or first diverging where the
             plain path's top-2 margin is below LOGIT_TOL.
5. encoders — full-width bert-base (B 8 x S 128 tokens) and vit-base (B 8 x
             197 stub patch embeddings, head 1000) in bf16 through
             encoder_forward under the default policies: the MatrixFlow GEMM
             and flash attention must both launch; logits finite. Then
             bert-base in fp32, kernel path on the card against the plain
             path on the CPU, logits within LOGIT_TOL.
6. contiguous serving — full-width smollm-135m (10 of its 30 layers,
             SERVE_CUT_LAYERS) served from contiguous KV
             caches (AttentionPolicy("fused")): 12 requests through
             submit/step in bf16, all complete, the GEMM and flash kernels
             launched; then generate(). In fp32 (2 of 30 layers) the same
             prompts' greedy streams equal the paged engine's on the card
             and the CPU plain path's, or first diverge where the plain
             top-2 margin is below LOGIT_TOL.
7. int8 serving — full-width smollm-135m (10 of its 30 layers) in bf16
             with weight_dtype="int8"
             (every projection and the head through the W8A8 GEMM, K2) and
             kv_dtype="int8" (int8 pages through K5): the same 12 requests x
             32 tokens under the 24-page pool, all complete with preemption,
             K2 launched on both tensor-core routes (wgmma at prefill, mma
             at decode) and K5 on both (rows, split), neither on the CUDA
             cores, K1 and K4 not; a preempted request's stream
             equals its solo stream. Then fp32 at full width, 2 of the 30
             layers, the card
             against the CPU plain path: greedy streams equal, or parting
             where the plain top-2 margin is below LOGIT_TOL or after an
             int8 value the two runs rounded differently from an ulp apart
             on a .5 tie (every quantization before it must agree to fp32
             noise: W8A8 and the frozen KV page scales amplify one such
             rounding into a whole quantization step).

8. SSM serving — full-width mamba2-1.3b (8 of 48 layers, d_model 2048, 64 SSD
             heads x 64, N 128) in bf16 from contiguous caches under the
             default ServeConfig, whose policy resolves to fused: generate() of 8 prompts x 384 tokens (Q 128, the
             state carried over 3 chunks) x 16 tokens; then a single-slot
             engine: a 200-token prompt (Q 100) through submit/step equals
             generate() of it, and a 131-token request (Q 1) on the
             recycled slot equals its solo run on a fresh engine (conv and
             SSD state zeroed). K1 and the SSD scan (K6) launched, K6 on
             its tensor-core walk route and never on the CUDA cores, the
             paged kernels (K4, K5) not.
9. hybrid serving — full-width zamba2-2.7b (12 of 54 SSD layers, d_model 2560,
             one shared attention block every 6 at head_dim 80) in bf16:
             generate() of 8 prompts x 64 tokens x 16 tokens under the fused
             policy; K1, K3 and K6 (walk) launched, K4 and K5 not.
10. SSM parity — fp32, full width cut in depth (mamba2 to 2 layers, zamba2
             to 6, one attention group): the card against the CPU plain
             path, prefill of 2 prompts (200 and 64 tokens) and 4 decode
             steps fed the same tokens, logits within LOGIT_TOL at every
             step, greedy tokens equal or differing only where the plain
             top-2 margin is below LOGIT_TOL.
11. serving features — smollm-135m at full width, 2 of its 30 layers
             (FEATURES_LAYERS), bf16, paged (page 16), 8 slots: (a) the prefix cache (12 requests on one 48-token
             system prompt, two parting inside its third page; a 24-page
             pool with watermark 2), in bf16 and with int8 KV: hits, COW
             forks and evictions all > 0, the pool and cache consistent,
             every request complete, each fork bitwise equal to its donor
             right after _copy_page and every shared page (int8 scale rows
             included) bitwise unchanged after a borrower's tail prefill;
             (b) speculative decoding with NGramDrafter on prompts that
             repeat a 6-token pattern: k = 4 (verify at Sq 5, K4 split)
             and k = 8 (Sq 9, K4 rows) on paged caches, k = 4 on fused
             contiguous caches (K3) and with int8 KV (K5); accepted
             tokens and rolled-back pages > 0, the pool ends full,
             tokens/s with and without printed; then a full-width
             DraftModelDrafter drafting for itself (its acceptance rate
             printed); (c) 12 concurrent AsyncServingEngine streams over
             the 8 slots, all complete, slo_report printed; (d) (a)'s bf16
             run with Observability(): the trace and the metrics snapshot
             validate, each request trace holds exactly its stream across
             preemption, the decode step's host wall time with obs and
             with NULL_OBS printed. Then fp32 at full width: prefix-on
             streams equal prefix-off, spec streams equal non-spec, or
             first part where the plain top-2 margin is below LOGIT_TOL.
12. stream identity — smollm-135m and qwen2-1.5b at full width, 2
             layers each (IDENTITY_LAYERS), in bf16, paged (page 16), 8
             slots, fp pools and int8 KV: 12 requests under the 24-page
             pool, every preempted request's stream equal to its solo
             stream; phase 11's 12 requests on one 48-token system prompt,
             prefix cache on equal to off. Zero streams may part.
             (``python3 chip_smoke.py --identity [arch ...]`` runs this
             phase alone.)
13-15. the rest of the dense family — qwen2-1.5b (QKV biases; 2 of 28
             layers), qwen3-8b (q/k RMSNorm; 2 of 36 layers) and
             granite-20b (MQA, group 48, GELU MLP; 2 of 52 layers), full
             width, bf16 weights drawn on the card from a seed: paged
             serving with preemption (K4 at head_dim 128), contiguous
             serving (K3 at head_dim 128, groups 6, 4 and 48), int8 KV
             (K5; qwen2 and granite, qwen2 with W8A8 weights through K2),
             each 12 requests x 32 tokens then generate(); qwen2 through
             phase 12's identity (2 of its layers);
             then fp32 at 2, 1 and 1 layers, the card against the CPU plain
             path within LOGIT_TOL (phase 4).
16-19. the model zoo's last four at full width, bf16 weights drawn on the
             card: internvl2-76b (2 of 80 layers; 64 / 8 heads x 128):
             paged serving with preemption (K4, group 8) and contiguous
             serving (K3), the VLM forward over B 2 x (256 stub image
             embeddings ⊕ 64 tokens) with no cache (K3 rows), then that
             prompt prefilled into contiguous caches and 8 greedy steps;
             musicgen-medium (4 of 48 layers, 24 x 64 MHA, 4 codebooks):
             forward over contiguous (K3) and paged (K4) caches, prefill 8 x
             64 frames then 32 greedy steps, argmax per codebook; dbrx-132b
             (2 of 40 layers; 16 experts top-4, 48 / 8 heads x 128): paged
             with preemption, contiguous, W8A8 weights + int8 KV (K2, K5),
             each then generate(); deepseek-v2-236b (its dense layer and 2
             of 59 MoE layers; MLA at q/k head dim 192, v 128; 160 experts
             top-6 + 2 shared): contiguous serving under the engine's default
             policy (K3's (192, 128) instance, split at decode and rows at
             prefill). The MoE expert banks run as torch products (the
             reference's jnp.einsum); the routers through K1. Then fp32 at
             1, 2, 1 and 2 layers (deepseek: the dense layer + 1 MoE layer)
             and 2 greedy steps (ZOO_PARITY_STEPS), the weights drawn on the card and held on the host, the card
             against the CPU plain path within LOGIT_TOL (phase 4; the VLM
             behind its image prefix, musicgen per codebook, deepseek over
             contiguous caches). (``python3 chip_smoke.py --zoo [arch ...]``
             runs these phases alone.)
20. training — full-width smollm-135m (30 layers) in bf16, trained by the
             port's Trainer: B 8 x 128 tokens from TokenPipeline, 4 steps
             with remat on, unfused attention, every GEMM through K1: its
             forward, its backward (dA = dC.Wt, dW = At.dC, K1 launches
             counted apart) and its batch grid (the attention's score and
             value products, 72 problems a launch); K2-K6 never launched.
             Every loss finite, the last below the first; per-step host
             wall time, tokens/s, and one profiled step's device busy
             time printed. A checkpoint at step 2; a fresh Trainer
             resumes there and reaches step 4 with losses bitwise the
             uninterrupted run's (and whether one step repeats bitwise is
             printed); K1's launches of one step with remat on and off.
21. fp32 train step — 2 of the 30 layers at full width, TF32 off: one
             step's loss, gradients and AdamW update on the card (K1 on
             the CUDA cores) against the CPU plain path: loss and
             gradients within LOGIT_TOL, params after the update within
             TRAIN_FP32_PARAM_TOL (half the step's lr).
22. mixed dtypes — smollm-135m at full width, 4 of its 30 layers
             (MIXED_LAYERS), as an fp32 model over a bf16 cache (the
             reference's default ServeConfig pairing): paged,
             contiguous and int8 KV, 12 requests each under the 24-page
             pool, all complete; the new instances (K4, K3: fp32 q over
             bf16 K/V; K5's fp32 q) launched. Then at 2 layers the card's
             streams against the CPU plain path's, a first parting allowed
             only where the plain top-2 margin is below LOGIT_TOL.
             (``python3 chip_smoke.py --train`` runs 20-21 with their
             kernel cells alone, ``--mixed`` 22 with its kernel cells.)
23. multi-device — qwen3-8b at full width, 2 of 36 layers, its sharding
             overrides cleared, two ranks on the card over gloo: TP=2
             serving against the one-device engine, a DP=2 smollm-135m
             step (FSDP: each rank its cut of the params and moments), a
             2-stage pipeline (``--tp`` runs it alone).
24. tensor-parallel training — the same qwen3-8b, one fp32 AdamW step of
             B 4 x 128 tokens on one device, its state freed but the new
             params and first moment (kept for phase 26), then on two
             ranks at TP=2 (each holding its slices of the same seeded
             weights, the loss vocab-parallel): each rank's loss within
             1e-6 relative of the one-device loss, its param slices within
             the reference's fp32 TOLS of the one-device params' slices;
             K1 on the CUDA cores, forward and backward, printed per rank
             by route, and the collectives of a step by kind and bytes;
             then one bf16 step a rank timed after a warm-up (K1 on
             wgmma). (``--tp-train`` runs it alone.)
26. FSDP — the same qwen3-8b step on two ranks at DP=2 with FSDP over
             data (each rank its cut of every leaf's d_model dim, gathered
             where it is used, the gradients reduce-scattered), then on
             the 2 x 2 (data, model) mesh, four ranks: each rank held to
             the one-device fp32 step as in phase 24; its param and moment
             bytes beside the one-device state's; its all-gathers and
             reduce-scatters equal to their closed form (each cut leaf
             gathered in the forward, a layer's again in remat's
             recompute, reduce-scattered once), and every collective equal
             to the dry run's of the same cell on ``Mesh.abstract``; on
             DP=2 one bf16 step a rank timed. (``--fsdp`` runs it alone.)
27. expert parallelism — dbrx-132b at full width, 1 of its 40 layers, B
             2 x 64: the fp32 forward and backward on one device (no
             full-width AdamW step of even one layer fits the card), its
             bank gradients kept on the host and the rest freed, then on
             two ranks at EP=2 (the (1, 2) mesh: 8 of the 16 experts a
             rank): each rank's loss, aux and grad norm within 1e-6
             relative of one device's, its bank-gradient slices within the
             fp32 TOLS, its bank bytes exactly half, its collectives equal
             to the dry run's on ``Mesh.abstract``, K1 by route and its
             peak allocation printed; then a bf16 forward and backward
             timed on one device and a rank. (``--ep`` runs it alone.)
28. pod axis — smollm-135m at full width, 4 of its 30 layers, B 8
             x 128, one fp32
             AdamW step on one device, plain and with ``compress_grads``;
             then four ranks on (pod 2, data 2, model 1) with FSDP over
             data, held to the plain step, and on (pod 2, data 1, model
             2) with compression (the amax reduced over the model cut),
             held to the compressed step but at recorded int8 rounding
             ties, as phase 26 holds its ranks; rank 0's collectives by
             kind and by axes (the pod all-reduce) equal to the dry run's.
             (``--pod`` runs it alone.)
25. roofline — the dry run (``repro_torch.launch.dryrun``) on meta tensors
             at the shapes of three runs measured above: smollm-135m's
             paged decode step at 8 live slots (phase 3), bert-base's
             forward at B 8 x 128 (phase 5), smollm-135m's train step at B
             8 x 128 with remat (phase 20). Its launches by kernel and
             route must equal those runs' counters; its predicted compute,
             memory and roofline times are printed beside the runs'
             device busy and host wall times and their ratios.
             (``--roofline`` runs phases 3, 5, 20 and 25.)
29. analysis — the static-analysis gate (``repro_torch.analysis``) on the
             card's launches: (a) the contract sweep with the card's
             routes, grids and clusters (every backend x the parity grid,
             every config at its published widths), its instances printed
             by kernel and route, zero violations; (b) a coverage probe:
             each kernel and route at the sweep's cells and K1/K2 at
             smollm-135m's decode and prefill GEMMs (K1's mma split and
             batch grid among them), launched through the raw binding into
             outputs filled with a sentinel (NaN; INT32_MIN for int32):
             every element the contract marks written must be overwritten
             and agree with the plain version (GEMM_TOLS / ATTN_TOLS /
             SSD_TOLS, int8 exact); (c) the lint of the full-width
             smollm-135m paged engine's prefill and decode steps, on meta
             and live, zero findings; (d) the ops facade (gemm,
             gemm_preformatted, mha, ssd) against its plain versions, each
             call moving its wrapper's counter by one. Its seconds are
             printed. (``--analysis`` runs it alone.)
30. long context — KV caches cut over the sequence (long_500k's
             rules): (a) K3 with its log-sum-exp at zamba2's shared block
             (H = Hkv = 32, D 80) over planted keys, against its plain
             version, three planted faults failing; (b) zamba2-2.7b at
             full width (12 of 54 layers in bf16: two shared-attention
             groups; 6 in fp32) over
             524,288-column caches, decode on one device and on two gloo
             ranks whose K/V columns are cut over data. (``--long`` runs
             it alone.)
31. MLA latent cut — (a) K3 at MLA's (192, 128) with its log-sum-exp
             (split over a rank's 16,384 and one device's 32,768 columns,
             rows at a 64-row chunk; H = 128) over planted keys, the same
             gates; (b) deepseek-v2-236b at full width (its dense layer
             and 1 MoE layer in bf16, the dense layer in fp32) over a
             latent cache of 2 rows x 32,768 columns (8,192 in fp32): a
             64-token prefill chunk across the ranks' boundary and 4
             decode steps on one device, then on two gloo ranks on (data
             1, model 2) under the kvseq arm's act_kv_seq -> model, each
             rank holding half the latent's columns and wkv_b whole,
             gathering the queries and merging every head's partials over
             model; held to one device (fp32 within GEMM_TOLS, tokens
             equal; bf16 as phase 30 holds it, an equal-weight merge
             failing at the chunk), every step's all-gathers the closed
             form, a decode step's collectives the dry run's. Its seconds
             are printed. (``--mla-cut`` runs it alone.)

The kernel phases (2) also hold the W8A8 GEMM (K2) bitwise against its
plain version at smollm-135m's decode and prefill GEMMs and bert-base's
1024-row GEMMs, each on the tensor-core route its chooser names, with
torch._int_mm plus the rescale as its yardstick, and paged attention
over int8 pages (K5) at decode, the prefill bucket and a chunked prefill
(bf16 q on the tensor-core route its chooser names, fp32 q on the CUDA
cores; tables poisoned past the valid keys, two launches bitwise equal),
with SDPA over the dequantized pages as its yardstick;
the SSD scan (K6) against its plain version at the SSM paths' prefills
(mamba2 B 8 x S 384 and 64, B 1 x S 200, 131 and 4096, B 2 x S 1000;
zamba2 B 8 x S 64), fp32 y and state within (1e-4, 1e-4), bf16 y within
TOLS["bfloat16"] and its fp32 state within (1e-4, 1e-4), each on the
route its chooser names (bf16: walk, or chunks from 513 steps; fp32: the
CUDA cores), two launches bitwise equal, timed per call and, from
torch.profiler, per kernel of the route (no single PyTorch call computes
the scan: no yardstick);
K1 at the training step's shapes (every smollm-135m projection and the
head at 1024 rows: forward, dA and dW) and its batch grid at the unfused
attention's products (72 problems of 128 x 64 . 64 x 128 and the like),
with torch.matmul / torch.bmm as yardsticks; K3's and K4's fp32-q over
bf16-K/V instances at smollm-135m's decode step and prefill bucket, with
SDPA over fp32 copies as the yardstick;
K1 at the SSM models' decode GEMMs and mamba2's prefill GEMMs and at
every projection of the three dense decoders (decode and prefill); K3 at
zamba2's head_dim-80 prefill and decode and at the dense decoders'
contiguous decode and prefill (head_dim 128, groups 4, 6 and 48); K4 and
K5 at their decode and prefill; K4 and K5 at phase 11's shapes
(a speculative verify at Sq 5 and 9 whose slots trim their drafts to
their own counts, the rest of their rows at position -1, one slot masked
whole; a tail prefill from position 53, mid-page) and K3 at the Sq-5
verify over contiguous caches; K1 at internvl2's and dbrx's projections,
both routers, deepseek's MLA projections (wkv_b over the whole 8 x 256
latent cache), shared experts and dense layer, and musicgen's head; K3 at
internvl2's, dbrx's and musicgen's decode and prefill and at MLA's (192,
128) decode (split) and prefill bucket (rows), v a strided view of the
up-projection, with SDPA (Ev != E) as its yardstick; K4 at the same three
models' shapes, K5 at dbrx's.

Every kernel counter is set to 0 just before each path (3, 5-9, each
run of 11, 12, each serving run of 13-15 and 16-19, 20, each serving
run of 22, and each decode of 30 and 31, on one device and on a rank) is
driven and read just after; a kernel of the path that never launched fails
it. K1-K6 are counted per route too: every bf16 path must have launched
K1 on wgmma and never on mma.sync (or, with int8 weights, K2 on both
tensor-core routes), K3, K4 or K5 on both of theirs (the encoders: rows),
K6 on a tensor-core route, and none of them on the CUDA cores (phase
22's fp32 model aside, whose K1, K3, K4 and K5 run there).
Prints the card's name and power limit, a {"kernels": [...]} line, and as
its last line {"ok": true, "device": {...}}. Details go to
chiprun_out/chip_smoke.json. Exits non-zero, printing no result, without a
GPU or outside a checkout.
"""
from __future__ import annotations

import asyncio
import dataclasses
import gc
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"

# Tolerances (atol, rtol) of kernel vs plain version on the card: the
# reference's own (tests/parity.py TOLS and ATTN_TOLS).
GEMM_TOLS = {"float32": (1e-4, 1e-5), "bfloat16": (5e-2, 5e-2)}
ATTN_TOLS = {"float32": (3e-5, 3e-5), "bfloat16": (3e-2, 3e-2)}
# Full-width fp32 logits, kernel path on the card vs plain path on the CPU:
# 30 layers of fp32 GEMMs summed in another order, random weights.
LOGIT_TOL = 1e-3
# The SSD scan (K6) against its plain version: fp32 within the reference's
# ssd_chunked tolerance (tests/test_ssm.py), bf16 y within parity's TOLS.
# The SSM models' fp32 logits, card vs CPU, are held to LOGIT_TOL as the
# other full-width paths are: K1 sums each fp32 dot product in one running
# sum, and at zamba2's K = 10240 (its shared MLP) that parts the logits
# (up to ~4.6) from the CPU's by ~2e-4 on an H100, where torch.matmul
# parts them by ~4e-5 (scripts/torch_fp32_backend_diff.py); parity's
# TOLS["float32"] (1e-4, 1e-5) is below both.
SSD_TOLS = {"float32": (1e-4, 1e-4), "bfloat16": (5e-2, 5e-2)}

# The serving paths: full-width smollm-135m.
ARCH = "smollm-135m"
SLOTS = 8
MAX_LEN = 256
PAGE = 16
PROMPT_BUCKET = 64           # prompts of 16..64 tokens → a 64-column bucket
N_REQUESTS = 12
GEN_LEN = 32
CACHE_PAGES = 24             # < 8 slots x 6 pages: decode growth preempts
CONTIG_FP32_LAYERS = 2       # phase 6's fp32 streams: the CPU plain path's time
INT8_PARITY_LAYERS = 2       # phase 7's fp32 card-vs-CPU run (of 30): its time
SERVE_CUT_LAYERS = 10        # phases 6 and 7's bf16 serving (of 30): the time
FEATURES_LAYERS = 2          # phase 11 (of 30): the run's time
MIXED_LAYERS = 4
SPEC_K, SPEC_K8 = 4, 8       # draft budgets: verify at Sq 5 (split), 9 (rows)
# The encoder path: the paper's models at full published width.
ENC_BATCH = 8
BERT_SEQ = 128
VIT_SEQ = 197                # 196 patches + the class token
PARITY_BATCH = 2             # bert-base fp32, card vs CPU
PARITY_PROMPT, PARITY_STEPS = 24, 8   # decoders' fp32 greedy, card vs CPU
ZOO_PARITY_STEPS = 2         # phases 16-19: the CPU's steps through 5-17 GiB
N_IMAGE_TOKENS = 256         # internvl2's stub frontend: patch embeddings
# The SSM paths: full-width mamba2-1.3b and zamba2-2.7b, contiguous caches.
MAMBA, ZAMBA = "mamba2-1.3b", "zamba2-2.7b"
SSM_SLOTS = 8
SSM_MAX_LEN = 512
SSM_GEN = 16
MAMBA_PROMPT = 384           # Q 128: the state carried over three chunks
SOLO_PROMPTS = (200, 131)    # Q 100 over two chunks; Q 1 over 131
ZAMBA_PROMPT = 64
SSM_PARITY = {MAMBA: (2, 200), ZAMBA: (6, 64)}   # layers, prompt tokens
# layers served (of 48 and 54; zamba2: two shared-attention groups):
# the run's time
SSM_SERVE_LAYERS = {MAMBA: 8, ZAMBA: 12}
SSM_PARITY_STEPS = 4


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


T_START = time.perf_counter()


def log(msg: str) -> None:
    print(f"[chip_smoke {time.perf_counter() - T_START:6.1f} s] {msg}",
          flush=True)


def begin(phase: str) -> None:
    """A phase's start, on standard error: a run stopped from outside
    shows there where it was."""
    print(f"[chip_smoke {time.perf_counter() - T_START:6.1f} s] begin "
          f"{phase}", file=sys.stderr, flush=True)


class Timer:
    """Device time of one call, the median of `iters` calls, each after an
    L2 flush (the serving path meets its weights cold: 270 MB of bf16
    weights per decode step against a 50 MB L2). Before each timed call
    the card spins for twice the host time the call takes to enqueue its
    work plus ~1 ms, with Python's garbage collector paused, so the start
    event fires only once all of it is queued even when the shared host
    stalls: the interval is device time, not host overhead. A stall longer
    than the spin still lets the card idle inside one call's interval (a
    10.8 us kernel once read 0.47 ms as a mean of 20); the median drops
    that call."""

    def __init__(self, iters: int = 10):
        self.iters = iters
        self.flush_buf = torch.empty(128 << 20, dtype=torch.uint8,
                                     device="cuda")

    def ms(self, fn) -> float:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        enqueue_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        spin_cycles = int(2 * enqueue_s * 2e9) + 2_000_000  # ~2 GHz SM clock
        gc.disable()
        try:
            times = [self._timed(fn, spin_cycles) for _ in range(self.iters)]
        finally:
            gc.enable()
        return statistics.median(times)

    def _timed(self, fn, spin_cycles: int) -> float:
        self.flush_buf.zero_()
        torch.cuda._sleep(spin_cycles)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)


def bound_ms(kernel: str, route: str, **shapes):
    """(ms, "bytes" or "operations"): the least time the card takes for one
    launch (repro_torch.roofline: launch_cost's bytes and operations over
    the H100's rates)."""
    from repro_torch.roofline import analysis as RA
    t, by = RA.bound(RA.launch_cost(kernel, route, **shapes))
    return t * 1e3, by


def paged_bound(route, q, bt, qpos, kvl, Hkv, dt, kv_dtype=None):
    """K4's or K5's bound for what this call's data needs: each row's
    visible pages of K and V once, q, the tables and the output; its
    visible (query, key) pairs."""
    B, Sq, H, D = q.shape
    horizon = torch.minimum(kvl, qpos.max(dim=1).values + 1).clamp(min=0)
    vis = torch.minimum(kvl[:, None], qpos + 1).clamp(min=0)
    return bound_ms("paged_attention", route, B=B, Sq=Sq, H=H, Hkv=Hkv, D=D,
                    page_size=PAGE, n_blocks=bt.shape[1], dtype=dt,
                    kv_dtype=kv_dtype, pages=int((-(-horizon // PAGE)).sum()),
                    pairs=int(vis.sum()))


ATTN_ROUTES = ("rows", "split", "cuda_cores")
# fp32 q over bf16 K/V (an fp32 model, a bf16 cache): K3's and K4's
# CUDA-core instances with bf16 K/V, counted apart
MIXED_ROUTE = "cuda_cores_bf16kv"
MIXED_ROUTES = ATTN_ROUTES + (MIXED_ROUTE,)
K2_ROUTES = ("wgmma", "mma")
SSD_ROUTES = ("walk", "chunks", "cuda_cores")
SSD_TC_ROUTES = ("walk", "chunks")


def kernel_wrappers():
    """Each kernel's launch counter: (the wrapper, its attribute) or (a
    dict of counts by route, its key). The paged wrapper launches K4 for fp
    pools and K5 for int8 pools, and counts them apart."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import matrixflow_gemm as MF
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.kernels import ssd_scan as K6
    k1 = MF.matrixflow_gemm_block_major
    fa, pa = FA.flash_attention, PA.paged_attention
    return {"matrixflow_gemm": (k1, "launches"),
            # K1 by route: bf16 on the tensor cores (wgmma at bm 64, mma.sync
            # at bm 16/32), fp32 and int8 on the CUDA cores
            "matrixflow_gemm_wgmma": (k1, "wgmma_launches"),
            "matrixflow_gemm_mma": (k1, "mma_launches"),
            "matrixflow_gemm_cuda_core": (k1, "cuda_core_launches"),
            # K1's batch grid (the unfused attention's products) and its
            # launches made for a gradient (dA, dW), on top of the routes
            "matrixflow_gemm_batched": (k1, "batched_launches"),
            "matrixflow_gemm_backward": (k1, "backward_launches"),
            "paged_attention": (pa, "launches"),
            "flash_attention": (fa, "launches"),
            # K3's launches that write the log-sum-exp too (a KV cache cut
            # over the sequence)
            "flash_attention_lse": (fa, "lse_launches"),
            # K3 and K4 by route: bf16 on the tensor cores (rows: more than
            # 16 rows a CTA; split: decode), fp32 on the CUDA cores
            **{f"flash_attention_{r}": (fa.launches_by_route, r)
               for r in MIXED_ROUTES},
            **{f"paged_attention_{r}": (pa.launches_by_route, r)
               for r in MIXED_ROUTES},
            "matrixflow_gemm_dequant": (MF.matrixflow_gemm_dequant,
                                        "launches"),
            # K2 by route: wgmma at bm 64, mma.sync at bm 16/32
            **{f"matrixflow_gemm_dequant_{r}": (MF.matrixflow_gemm_dequant,
                                                f"{r}_launches")
               for r in K2_ROUTES},
            "paged_attention_int8": (pa, "launches_int8"),
            # K5 by route: bf16 q on the tensor cores, fp32 q on the CUDA cores
            **{f"paged_attention_int8_{r}": (pa.launches_int8_by_route, r)
               for r in ATTN_ROUTES},
            "ssd_scan": (K6.ssd_scan, "launches"),
            # K6 by route: bf16 on the tensor cores (walk: a row's tiles in
            # one CTA; chunks: segments over CTAs), fp32 on the CUDA cores
            **{f"ssd_scan_{r}": (K6.ssd_scan.launches_by_route, r)
               for r in SSD_ROUTES}}


def counts() -> dict:
    return {k: c[key] if isinstance(c, dict) else getattr(c, key)
            for k, (c, key) in kernel_wrappers().items()}


def reset_counts() -> None:
    for c, key in kernel_wrappers().values():
        if isinstance(c, dict):
            c[key] = 0
        else:
            setattr(c, key, 0)


# What a bf16 path that prefills (or encodes) and decodes must launch: K1
# on its wgmma route at every M (core/plan.py::bm_for: a row's bits then do
# not depend on the rows sharing a call), never mma.sync or the CUDA cores;
# K3 or K4 on both tensor-core routes.
K1_BF16 = ("matrixflow_gemm", "matrixflow_gemm_wgmma")
K3_BF16 = ("flash_attention", "flash_attention_rows", "flash_attention_split")
K4_BF16 = ("paged_attention", "paged_attention_rows", "paged_attention_split")
# K6 at the SSM paths' prefills (S <= 512): the walk route
K6_BF16 = ("ssd_scan", "ssd_scan_walk")
K2_BF16 = ("matrixflow_gemm_dequant", "matrixflow_gemm_dequant_wgmma",
           "matrixflow_gemm_dequant_mma")
K5_BF16 = ("paged_attention_int8", "paged_attention_int8_rows",
           "paged_attention_int8_split")
K2_K5_BF16 = K2_BF16 + K5_BF16
CUDA_CORE_COUNTERS = ("matrixflow_gemm_cuda_core", "flash_attention_cuda_cores",
                      "paged_attention_cuda_cores",
                      "paged_attention_int8_cuda_cores", "ssd_scan_cuda_cores",
                      f"flash_attention_{MIXED_ROUTE}",
                      f"paged_attention_{MIXED_ROUTE}",
                      # K1's mma.sync route: off every bf16 path (K1_BF16)
                      "matrixflow_gemm_mma")
# What an fp32 model over a bf16 (or int8) cache runs on the CUDA cores
MIXED_ALLOWED = ("matrixflow_gemm_cuda_core", f"flash_attention_{MIXED_ROUTE}",
                 f"paged_attention_{MIXED_ROUTE}",
                 "paged_attention_int8_cuda_cores")


def read_counts(path: str, required, allowed=()) -> dict:
    """The launch counts since reset_counts(); fails if a kernel of the
    path never launched, or if K1, K3, K4, K5 or K6 ran on the CUDA cores
    or K1 on mma.sync (every path read here but the fp32 model's, whose
    CUDA-core counters are ``allowed``, is bf16 or int8 with bf16
    activations, and none may take those routes; K2 has no CUDA-core
    route)."""
    return check_counts(path, counts(), required, allowed)


def check_counts(path: str, counts_now: dict, required, allowed=()) -> dict:
    """read_counts' checks on counts read elsewhere (another process's)."""
    for name in required:
        if counts_now[name] <= 0:
            fail(f"{path}: kernel {name} was never launched")
    for name in CUDA_CORE_COUNTERS:
        if counts_now[name] and name not in allowed:
            fail(f"{path}: {name} counted {counts_now[name]} launches off "
                 f"the bf16 tensor-core routes")
    return counts_now


def route_taken(before: dict, after: dict, kernel: str,
                routes=ATTN_ROUTES) -> str:
    """The one route of ``kernel`` whose counter grew between two counts()
    snapshots; fails unless exactly one did."""
    grew = [r for r in routes
            if after[f"{kernel}_{r}"] > before[f"{kernel}_{r}"]]
    if len(grew) != 1:
        fail(f"{kernel}: routes {grew} counted launches, expected one")
    return grew[0]


def check_close(name, got, want, atol, rtol):
    got, want = got.float(), want.float()
    err = float((got - want).abs().max()) if got.numel() else 0.0
    if not bool(torch.isfinite(got).all()):
        fail(f"{name}: kernel output is not finite")
    if not bool(((got - want).abs() <= atol + rtol * want.abs()).all()):
        fail(f"{name}: max |kernel - plain| = {err:.3e} exceeds atol={atol} "
             f"rtol={rtol}")
    return err


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def gemm_cells(cfg, bert, vit, ssm_cfgs=()):
    """(name, M, K, N, path, uses per run of the path) of every projection
    of the serving paths (smollm-135m; the SSM models' decode steps and
    mamba2's prefill) and the encoder paths."""
    d, f, V = cfg.d_model, cfg.d_ff, cfg.vocab
    qd, kvd, L = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim, cfg.n_layers
    layer = [("q/o", d, qd, 2 * L), ("k/v", d, kvd, 2 * L),
             ("mlp-in", d, 2 * f, L), ("mlp-out", f, d, L)]
    cells = [(f"decode {n}", SLOTS, K, N, "decode step", c)
             for n, K, N, c in layer]
    # prefill reads last columns only: the head runs at M = SLOTS too
    cells.append(("head", SLOTS, d, V, "decode step", 1))
    cells += [(f"prefill {n}", SLOTS * PROMPT_BUCKET, K, N, "prefill", c)
              for n, K, N, c in layer]
    for scfg in ssm_cfgs:
        d, di, L = scfg.d_model, scfg.d_inner, scfg.n_layers
        ssd = [("z/x", d, di, 2 * L), ("B/C", d, scfg.ssm_state, 2 * L),
               ("dt", d, scfg.ssm_heads, L), ("out", di, d, L)]
        if scfg.attn_every:        # the shared block, once per group
            g, hd = L // scfg.attn_every, scfg.n_heads * scfg.head_dim
            ssd += [("shared q/k/v/o", d, hd, 4 * g),
                    ("shared mlp-in", d, 2 * scfg.d_ff, g),
                    ("shared mlp-out", scfg.d_ff, d, g)]
        step = f"{scfg.name} decode step"
        cells += [(f"{scfg.name} decode {n}", SSM_SLOTS, K, N, step, c)
                  for n, K, N, c in ssd + [("head", d, scfg.vocab, 1)]]
        if not scfg.attn_every:    # mamba2's generate prefill, 8 x 384 rows
            cells += [(f"{scfg.name} prefill {n}", SSM_SLOTS * MAMBA_PROMPT,
                       K, N, f"{scfg.name} prefill", c) for n, K, N, c in ssd]
    for ecfg, M in ((bert, ENC_BATCH * BERT_SEQ),
                    (vit, ENC_BATCH * VIT_SEQ)):
        d, f, L = ecfg.d_model, ecfg.d_ff, ecfg.n_layers
        path = f"{ecfg.name} forward"
        cells += [(f"{ecfg.name} {n}", M, K, N, path, c) for n, K, N, c in
                  (("q/k/v/o", d, d, 4 * L), ("mlp-in", d, f, L),
                   ("mlp-out", f, d, L), ("head", d, ecfg.vocab, 1))]
    return cells


def dense_gemm_cells(m):
    """(name, M, K, N, path, uses per run of the path) of a dense decoder's
    projections at its published depth: a decode step (M = SLOTS) and a
    prefill (M = SLOTS x PROMPT_BUCKET; the head reads last columns only,
    so it runs at M = SLOTS in both)."""
    d, f, L = m.d_model, m.d_ff, m.n_layers
    qd, kvd = m.n_heads * m.head_dim, m.n_kv_heads * m.head_dim
    wi = 2 * f if m.mlp_act == "swiglu" else f
    layer = [("q", d, qd, L), ("k/v", d, kvd, 2 * L), ("o", qd, d, L),
             ("mlp-in", d, wi, L), ("mlp-out", f, d, L)]
    cells = [(f"{m.name} decode {n}", SLOTS, K, N, f"{m.name} decode step", c)
             for n, K, N, c in layer + [("head", d, m.vocab, 1)]]
    return cells + [(f"{m.name} prefill {n}", SLOTS * PROMPT_BUCKET, K, N,
                     f"{m.name} prefill", c) for n, K, N, c in layer]


# The route bf16 decode GEMMs took before every bf16 GEMM on the card ran
# at bm 64 (core/plan.py::bm_for): mma.sync at the smallest row tile
# covering M, timed beside the wgmma cell of the same GEMM.
MMA_BEFORE = " (mma, bm 16)"


def zoo_gemm_cells(vlm, audio, dbrx, deepseek):
    """(name, M, K, N, path, uses per run of the path) of the model zoo's
    last four at their depth on the card: internvl2's projections as a
    dense decoder's; dbrx's attention projections and router (its expert
    bank is a torch product, not K1); deepseek's MLA projections (wkv_b
    up-projects the whole (SLOTS, MAX_LEN) latent cache on every call),
    router, shared experts, leading dense layer and head; musicgen's head
    (vocab x 4 codebooks)."""
    cells = dense_gemm_cells(vlm)
    pf = SLOTS * PROMPT_BUCKET
    for m, layer, head in (
            (dbrx, [("q", dbrx.d_model, dbrx.n_heads * dbrx.head_dim),
                    ("k/v", dbrx.d_model, dbrx.n_kv_heads * dbrx.head_dim),
                    ("o", dbrx.n_heads * dbrx.head_dim, dbrx.d_model),
                    ("router", dbrx.d_model, dbrx.n_experts)], True),
            (audio, [], True)):
        L = m.n_layers
        uses = {"k/v": 2 * L}
        for M, step in ((SLOTS, "decode step"), (pf, "prefill")):
            cells += [(f"{m.name} {step.split()[0]} {n}", M, K, N,
                       f"{m.name} {step}", uses.get(n, L))
                      for n, K, N in layer]
        if head:
            cells.append((f"{m.name} decode head", SLOTS, m.d_model,
                          m.vocab * max(m.n_codebooks, 1),
                          f"{m.name} decode step", 1))
    d, H, ds = deepseek.d_model, deepseek.n_heads, deepseek
    dn, dr, dv = ds.qk_nope_head_dim, ds.qk_rope_head_dim, ds.v_head_dim
    r, f, nd = ds.kv_lora_rank, ds.moe_d_ff, ds.first_dense_layers
    L, Lm = ds.n_layers, ds.n_layers - nd
    layer = [("wq_a", d, ds.q_lora_rank, L),
             ("wq_b", ds.q_lora_rank, H * (dn + dr), L),
             ("wkv_a", d, r + dr, L), ("o", H * dv, d, L),
             ("router", d, ds.n_experts, Lm),
             ("shared mlp-in", d, 2 * ds.n_shared_experts * f, Lm),
             ("shared mlp-out", ds.n_shared_experts * f, d, Lm),
             ("dense mlp-in", d, 2 * ds.d_ff, nd),
             ("dense mlp-out", ds.d_ff, d, nd)]
    for M, step in ((SLOTS, "decode step"), (pf, "prefill")):
        path = f"{ds.name} {step}"
        cells += [(f"{ds.name} {step.split()[0]} {n}", M, K, N, path, c)
                  for n, K, N, c in layer]
        cells.append((f"{ds.name} {step.split()[0]} wkv_b", SLOTS * MAX_LEN,
                      r, H * (dn + dv), path, L))
    cells.append((f"{ds.name} decode head", SLOTS, d, ds.vocab,
                  f"{ds.name} decode step", 1))
    return cells


def run_gemm_phase(timer, cfg, bert, vit, ssm_cfgs, models=(), zoo=()):
    """K1 at every projection of the paths (bf16 and fp32), of the dense
    decoders ``models`` and of the model zoo's last four ``zoo`` (bf16);
    each bf16 decode-step GEMM of the first two also on the mma.sync route
    at bm 16 (off the path: the repair's cost)."""
    from repro_torch.core import layout as L
    from repro_torch.core.plan import GemmPolicy, layout_for_packed, pack_weight
    from repro_torch.kernels import matrixflow_gemm as MF

    rows = []
    gen = torch.Generator(device="cuda").manual_seed(0)
    cells = [("bfloat16", c) for c in gemm_cells(cfg, bert, vit, ssm_cfgs)]
    cells += [("float32", c) for c in gemm_cells(cfg, bert, vit, ssm_cfgs)]
    cells += [("bfloat16", c) for m in models for c in dense_gemm_cells(m)]
    zoo_cells = [("bfloat16", c) for c in zoo_gemm_cells(*zoo)] if zoo else []
    for dtype_name, (name, M, K, N, path, uses) in cells + zoo_cells:
        dt = getattr(torch, dtype_name)
        atol, rtol = GEMM_TOLS[dtype_name]
        a = torch.randn((M, K), generator=gen, device="cuda").to(dt)
        w = (torch.randn((K, N), generator=gen, device="cuda")
             / K ** 0.5).to(dt)
        pw = pack_weight(w, GemmPolicy())          # as the engine packs
        variants = [(path, layout_for_packed(M, pw))]
        if dtype_name == "bfloat16" and path.endswith("decode step") \
                and (dtype_name, (name, M, K, N, path, uses)) not in zoo_cells:
            variants.append((path + MMA_BEFORE, L.BlockLayout(
                L.bm_for(M), pw.bn, pw.bk, pw.mode)))
        for vpath, blk in variants:
            a_bm = L.to_block_major_a(a, blk.bm, blk.bk)
            before = counts()
            got = MF.matrixflow_gemm_block_major(a_bm, pw.data, out_dtype=dt)
            after = counts()
            want = MF.plain(a_bm, pw.data, out_dtype=dt)
            torch.cuda.synchronize()
            cell = (f"matrixflow_gemm {name} M={M} K={K} N={N} {dtype_name}"
                    + (MMA_BEFORE if vpath != path else ""))
            route = [r for r in ("wgmma", "mma", "cuda_core")
                     if after[f"matrixflow_gemm_{r}"]
                     > before[f"matrixflow_gemm_{r}"]]
            allowed = (("cuda_core",) if dtype_name == "float32" else
                       ("mma",) if vpath != path else ("wgmma",))
            if len(route) != 1 or route[0] not in allowed:
                fail(f"{cell}: ran route {route}, expected one of {allowed}")
            tile = (MF.tc_tile(blk.bm, blk.bn, a_bm.shape[0],
                               pw.data.shape[0], a_bm.shape[1], blk.bk)
                    if route[0] != "cuda_core" else None)
            err = check_close(cell, got, want, atol, rtol)
            t_k = timer.ms(lambda: MF.matrixflow_gemm_block_major(
                a_bm, pw.data, out_dtype=dt))
            t_p = timer.ms(lambda: MF.plain(a_bm, pw.data, out_dtype=dt))
            t_lib = timer.ms(lambda: torch.matmul(a, w))
            b_ms, b_by = bound_ms("matrixflow_gemm", route[0], M=M, N=N, K=K,
                                  dtype=dt)
            rows.append(dict(cell=cell, dtype=dtype_name, M=M, K=K, N=N,
                             block=[blk.bm, blk.bn, blk.bk], route=route[0],
                             tile=tile, path=vpath, uses=uses,
                             max_abs_err=err, ms=t_k, plain_ms=t_p,
                             library_ms=t_lib, bound_ms=b_ms, bound_by=b_by))
            log(f"{cell}: blocks {blk.bm}x{blk.bn}x{blk.bk} route {route[0]} "
                f"tile {tile} max|d|={err:.2e} kernel {t_k:.4f} ms plain "
                f"{t_p:.4f} ms matmul {t_lib:.4f} ms bound {b_ms:.4f} ms "
                f"({b_by})")
        del a, w, pw
    return rows


def paged_case(gen, dt, *, B, Sq, lens, q_start, H, Hkv, D, ps, nb):
    """Shuffled block tables over a pool with garbage distractor pages;
    row b holds lens[b] keys; its queries sit at q_start[b] + s (-1 past
    the row's real queries, as bucketed prefill pads). Returns the tables
    twice: valid page ids everywhere (for the plain version, which gathers
    every entry), and with every entry past a row's valid keys out of the
    pool's range (for the kernels, which must never read one)."""
    P = B * nb + 5
    kp = torch.randn((P, ps, Hkv, D), generator=gen, device="cuda").to(dt) * 3
    vp = torch.randn((P, ps, Hkv, D), generator=gen, device="cuda").to(dt) * 3
    perm = torch.randperm(P, generator=gen, device="cuda")[:B * nb]
    tables = perm.reshape(B, nb).to(torch.int32)
    q = torch.randn((B, Sq, H, D), generator=gen, device="cuda").to(dt)
    qpos = np.full((B, Sq), -1, np.int32)
    for b in range(B):
        n_real = lens[b] - q_start[b]
        qpos[b, :n_real] = q_start[b] + np.arange(n_real)
    qpos = torch.from_numpy(qpos).cuda()
    kvl = torch.tensor(lens, dtype=torch.int32, device="cuda")
    dead = torch.arange(nb, device="cuda")[None] >= -(-kvl[:, None] // ps)
    poisoned = torch.where(dead, torch.full_like(tables, P + (1 << 20)),
                           tables)
    return q, kp, vp, tables, poisoned, qpos, kvl


def verify_rows(rng, k):
    """A speculative verify batch at Sq = 1 + k: slot b holds p_b keys
    before the step and m_b <= k drafts (trimmed per slot, some to 0), so
    it writes p_b + 1 + m_b keys and queries positions p_b..p_b + m_b; the
    rest of its k + 1 rows sit at position -1; the last slot is masked
    whole (not decodable this step). Returns (lens, q_start)."""
    p = rng.integers(17, MAX_LEN - k - 1, SLOTS)
    m = rng.integers(0, k + 1, SLOTS)
    m[:3] = (k, 0, k // 2)
    lens = (p + 1 + m).tolist()
    q_start = p.tolist()
    lens[-1], q_start[-1] = 0, 0
    return lens, q_start


def tail_prefill_rows(rng):
    """A prefix-hit tail prefill: slot 0 borrowed 3 cached pages and 5 rows
    of a forked fourth (positions 0..52 resident), and prefills its
    19-token tail from position 53, mid-page, in a 32-column bucket; every
    other slot holds keys and is masked (no queries)."""
    lens = rng.integers(17, MAX_LEN, SLOTS)
    lens[0] = 53 + 19
    q_start = lens.copy()
    q_start[0] = 53
    return lens.tolist(), q_start.tolist()


def serving_feature_cases(rng):
    """The serving features' attention shapes (phase 11's paths): verify
    at k = 4 (Sq 5, 15 rows a CTA: the split route) and k = 8 (Sq 9, 27
    rows: the rows route), and a tail prefill starting mid-page."""
    return [("verify k4", SPEC_K + 1, *verify_rows(rng, SPEC_K),
             "verify step k4"),
            ("verify k8", SPEC_K8 + 1, *verify_rows(rng, SPEC_K8),
             "verify step k8"),
            ("tail prefill mid-page", 32, *tail_prefill_rows(rng),
             "tail prefill")]


def model_attention_cases(rng, m):
    """A dense decoder's decode step and prefill bucket (paths named after
    it), for the attention phases' models beyond smollm-135m."""
    dec_lens = rng.integers(17, MAX_LEN, SLOTS).tolist()
    pf_lens = rng.integers(16, PROMPT_BUCKET + 1, SLOTS).tolist()
    return [(f"{m.name} decode", 1, dec_lens, [n - 1 for n in dec_lens],
             f"{m.name} decode step"),
            (f"{m.name} prefill", PROMPT_BUCKET, pf_lens, [0] * SLOTS,
             f"{m.name} prefill")]


def run_attention_phase(timer, cfg, models=(), main=True):
    """K4 at smollm-135m's serving shapes (unless ``main`` is False) and at
    the decode step and prefill of each of ``models`` (head_dim 128;
    granite's group 48)."""
    from repro_torch.kernels import paged_attention as PA

    nb = MAX_LEN // PAGE
    rng = np.random.default_rng(1)
    rows = []
    gen = torch.Generator(device="cuda").manual_seed(1)
    for dtype_name, m in [(d, m) for m in ((cfg,) if main else ()) + (*models,)
                          for d in ("bfloat16", "float32")]:
        H, Hkv, D = m.n_heads, m.n_kv_heads, m.head_dim
        dt = getattr(torch, dtype_name)
        atol, rtol = ATTN_TOLS[dtype_name]
        dec_lens = rng.integers(17, MAX_LEN, SLOTS).tolist()
        pf_lens = rng.integers(16, PROMPT_BUCKET + 1, SLOTS).tolist()
        # a slot with no key (its row masked), one key, keys ending exactly
        # on a page boundary, and the longest a 256-token slot decodes
        edge_lens = [0, 1, 8 * PAGE, MAX_LEN - 1] + \
            rng.integers(17, MAX_LEN, SLOTS - 4).tolist()
        cases = [
            ("decode", 1, dec_lens, [n - 1 for n in dec_lens], "decode step"),
            ("decode edge lengths", 1, edge_lens,
             [n - 1 for n in edge_lens], "decode step, edge lengths"),
            ("prefill", PROMPT_BUCKET, pf_lens, [0] * SLOTS, "prefill"),
        ] + serving_feature_cases(rng) if m is cfg else \
            model_attention_cases(rng, m)
        for name, Sq, lens, q_start, path in cases:
            q, kp, vp, bt, dead_bt, qpos, kvl = paged_case(
                gen, dt, B=SLOTS, Sq=Sq, lens=lens, q_start=q_start,
                H=H, Hkv=Hkv, D=D, ps=PAGE, nb=nb)
            scale = D ** -0.5
            before = counts()
            got = PA.paged_attention(q, kp, vp, dead_bt, qpos, kvl)
            again = PA.paged_attention(q, kp, vp, dead_bt, qpos, kvl)
            route = route_taken(before, counts(), "paged_attention")
            want = PA.paged_attention_plain(q, kp, vp, bt, qpos, kvl,
                                            causal=True, scale=scale,
                                            soft_cap=None)
            torch.cuda.synchronize()
            cell = (f"paged_attention {name} B={SLOTS} Sq={Sq} H={H} Hkv={Hkv} "
                    f"D={D} {dtype_name}")
            expect = PA.route_for(dt, Sq, H // Hkv)
            if route != expect or (dtype_name == "float32") != (
                    route == "cuda_cores"):
                fail(f"{cell}: ran route {route}, the chooser names {expect}")
            if not torch.equal(got, again):
                fail(f"{cell}: two launches differ")
            err = check_close(cell, got, want, atol, rtol)
            masked = qpos < 0
            if bool(masked.any()) and float(got[masked].abs().max()) != 0.0:
                fail(f"{cell}: masked query rows are not exactly zero")
            # SDPA over the gathered pages, as a yardstick (gather excluded)
            kd = PA.gather_pages(kp, bt).repeat_interleave(H // Hkv, 2)
            vd = PA.gather_pages(vp, bt).repeat_interleave(H // Hkv, 2)
            qs, ks, vs = (x.transpose(1, 2).contiguous() for x in (q, kd, vd))
            cols = torch.arange(nb * PAGE, device="cuda")
            mask = ((cols[None, None, :] < kvl[:, None, None])
                    & (cols[None, None, :] <= qpos[:, :, None]))[:, None]
            sdpa = torch.nn.functional.scaled_dot_product_attention
            t_k = timer.ms(lambda: PA.paged_attention(q, kp, vp, dead_bt,
                                                      qpos, kvl))
            t_p = timer.ms(lambda: PA.paged_attention_plain(
                q, kp, vp, bt, qpos, kvl, causal=True, scale=scale,
                soft_cap=None))
            t_lib = timer.ms(lambda: sdpa(qs, ks, vs, attn_mask=mask))
            # what this run's data needs: each visible page of K and V once,
            # q, the tables and the output; 2·(D + Dv) FLOPs per visible key
            b_ms, b_by = paged_bound(route, q, bt, qpos, kvl, Hkv, dt)
            rows.append(dict(cell=cell, dtype=dtype_name, Sq=Sq, lens=lens,
                             path=path, uses=m.n_layers, route=route,
                             max_abs_err=err, ms=t_k, plain_ms=t_p,
                             library_ms=t_lib, bound_ms=b_ms, bound_by=b_by))
            log(f"{cell}: route {route} max|d|={err:.2e} kernel {t_k:.4f} ms plain "
                f"{t_p:.4f} ms sdpa {t_lib:.4f} ms bound {b_ms:.4f} ms "
                f"({b_by})")
    return rows


# ---------------------------------------------------------------------------
# Phase 2c: flash attention against its plain version
# ---------------------------------------------------------------------------

def model_flash_cells(rng, models):
    """The dense decoders ``models`` served from contiguous caches
    (head_dim 128; qwen3 group 4, qwen2 6, granite 48): a decode step over
    ragged lengths and a 64-column prefill bucket of 16..64 real columns a
    slot."""
    cells = []
    for m in models:
        lens = rng.integers(17, MAX_LEN + 1, SLOTS)
        cells.append((f"{m.name} decode", SLOTS, 1, MAX_LEN, m.n_heads,
                      m.n_kv_heads, m.head_dim, True,
                      (lens - 1)[:, None].astype(np.int32),
                      lens.astype(np.int32), f"{m.name} decode step",
                      m.n_layers))
        lens = rng.integers(16, PROMPT_BUCKET + 1, SLOTS)
        qpos = np.full((SLOTS, PROMPT_BUCKET), -1, np.int32)
        for b, n in enumerate(lens):
            qpos[b, :n] = np.arange(n)
        cells.append((f"{m.name} prefill bucket", SLOTS, PROMPT_BUCKET,
                      MAX_LEN, m.n_heads, m.n_kv_heads, m.head_dim, True,
                      qpos, lens.astype(np.int32), f"{m.name} prefill",
                      m.n_layers))
    return cells


def flash_cells(cfg, bert, vit, vit_huge, zamba, rng, models=(), mla=None):
    """(name, B, Sq, Sk, H, Hkv, D, causal, q_positions, kv_valid_len,
    path, uses per run[, Dv]) at the encoder paths' and the contiguous
    serving path's shapes, the decoders ``models``' and, for ``mla``
    (deepseek-v2), MLA's q/k head dim 192 with v head dim 128.
    q_positions / kv_valid_len are numpy arrays or None (the wrapper's
    bottom-right default / Sk)."""
    H, Hkv, D, L = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.n_layers
    cells = [(e.name, ENC_BATCH, S, S, e.n_heads, e.n_kv_heads, e.head_dim,
              False, None, None, f"{e.name} forward", e.n_layers)
             for e, S in ((bert, BERT_SEQ), (vit, VIT_SEQ),
                          (vit_huge, 257))]
    # contiguous decode: ragged lengths, one masked row (position -1)
    lens = rng.integers(17, MAX_LEN + 1, SLOTS)
    lens[3] = 0
    qpos = (lens - 1)[:, None].astype(np.int32)
    cells.append(("smollm decode", SLOTS, 1, MAX_LEN, H, Hkv, D, True, qpos,
                  lens.astype(np.int32), "decode step", L))
    # the engine's single-slot prefill: one real row of a 64-column bucket,
    # 40 real columns, every other row masked
    qpos = np.full((SLOTS, PROMPT_BUCKET), -1, np.int32)
    qpos[0, :40] = np.arange(40)
    lens = np.zeros(SLOTS, np.int32)
    lens[0] = 40
    cells.append(("smollm prefill bucket", SLOTS, PROMPT_BUCKET, MAX_LEN, H,
                  Hkv, D, True, qpos, lens, "prefill", L))
    # chunked prefill: 32-column chunks continuing ragged caches
    starts = rng.integers(0, MAX_LEN - 32, SLOTS)
    qpos = (starts[:, None] + np.arange(32)).astype(np.int32)
    cells.append(("chunked prefill offset", SLOTS, 32, MAX_LEN, H, Hkv, D,
                  True, qpos, (starts + 32).astype(np.int32), "chunk", L))
    cells.append(("bottom-right default", SLOTS, PROMPT_BUCKET, MAX_LEN, H,
                  Hkv, D, True, None, None, "default", L))
    # speculative verify on contiguous caches at k = 4: Sq 5, each slot's
    # drafts trimmed to its own count (rows past them at position -1)
    lens, q_start = verify_rows(rng, SPEC_K)
    qpos = np.full((SLOTS, SPEC_K + 1), -1, np.int32)
    for b in range(SLOTS):
        n = lens[b] - q_start[b]
        qpos[b, :n] = q_start[b] + np.arange(n)
    cells.append(("smollm verify k4", SLOTS, SPEC_K + 1, MAX_LEN, H, Hkv, D,
                  True, qpos, np.asarray(lens, np.int32), "verify step k4",
                  L))
    # zamba2's shared block (head_dim 80) over its contiguous caches: the
    # generate prefill and a decode step, once per attention group
    z, G = zamba, zamba.n_layers // zamba.attn_every
    qpos = np.broadcast_to(np.arange(ZAMBA_PROMPT, dtype=np.int32),
                           (SSM_SLOTS, ZAMBA_PROMPT)).copy()
    cells.append(("zamba2 prefill", SSM_SLOTS, ZAMBA_PROMPT, SSM_MAX_LEN,
                  z.n_heads, z.n_kv_heads, z.head_dim, True, qpos,
                  np.full(SSM_SLOTS, ZAMBA_PROMPT, np.int32), "zamba2 prefill",
                  G))
    pos = ZAMBA_PROMPT + rng.integers(0, SSM_GEN, SSM_SLOTS).astype(np.int32)
    cells.append(("zamba2 decode", SSM_SLOTS, 1, SSM_MAX_LEN, z.n_heads,
                  z.n_kv_heads, z.head_dim, True, pos[:, None], pos + 1,
                  "zamba2 decode step", G))
    cells += model_flash_cells(rng, models)
    if mla is not None:
        # MLA over its contiguous latent cache: K and V up-projected per
        # head (one kv head a query head), D 192 = 128 nope + 64 rope, Dv
        # 128; a decode step (split) and a 64-column prefill bucket (rows)
        H, D = mla.n_heads, mla.qk_nope_head_dim + mla.qk_rope_head_dim
        lens = rng.integers(17, MAX_LEN + 1, SLOTS)
        cells.append((f"{mla.name} decode", SLOTS, 1, MAX_LEN, H, H, D, True,
                      (lens - 1)[:, None].astype(np.int32),
                      lens.astype(np.int32), f"{mla.name} decode step",
                      mla.n_layers, mla.v_head_dim))
        lens = rng.integers(16, PROMPT_BUCKET + 1, SLOTS)
        qpos = np.full((SLOTS, PROMPT_BUCKET), -1, np.int32)
        for b, n in enumerate(lens):
            qpos[b, :n] = np.arange(n)
        cells.append((f"{mla.name} prefill bucket", SLOTS, PROMPT_BUCKET,
                      MAX_LEN, H, H, D, True, qpos, lens.astype(np.int32),
                      f"{mla.name} prefill", mla.n_layers, mla.v_head_dim))
    return cells


def run_flash_phase(timer, cells):
    from repro_torch.kernels import flash_attention as FA

    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = []
    gen = torch.Generator(device="cuda").manual_seed(4)
    for dtype_name in ("bfloat16", "float32"):
        dt = getattr(torch, dtype_name)
        atol, rtol = ATTN_TOLS[dtype_name]
        for (name, B, Sq, Sk, H, Hkv, D, causal, qpos_np, kvl_np, path,
             uses, *dv) in cells:
            Dv = dv[0] if dv else D
            q, k = (torch.randn(shape, generator=gen, device="cuda").to(dt)
                    for shape in ((B, Sq, H, D), (B, Sk, Hkv, D)))
            # v of MLA (Dv != D) is the strided view mla_attention passes:
            # the last Dv dims of the (..., (D - 64) + Dv) up-projection
            v = torch.randn((B, Sk, Hkv, D - 64 + Dv if Dv != D else D),
                            generator=gen, device="cuda").to(dt)[..., -Dv:]
            qpos = None if qpos_np is None else torch.from_numpy(qpos_np).cuda()
            kvl = None if kvl_np is None else torch.from_numpy(kvl_np).cuda()
            before = counts()
            got = FA.flash_attention(q, k, v, qpos, kvl, causal=causal)
            again = FA.flash_attention(q, k, v, qpos, kvl, causal=causal)
            route = route_taken(before, counts(), "flash_attention")
            qpos_r = qpos if qpos is not None else (
                torch.arange(Sq, device="cuda") + (Sk - Sq)).expand(
                    B, Sq).to(torch.int32)
            kvl_r = kvl if kvl is not None else torch.full(
                (B,), Sk, dtype=torch.int32, device="cuda")
            scale = D ** -0.5
            want = FA.flash_attention_plain(q, k, v, qpos_r, kvl_r,
                                            causal=causal, scale=scale,
                                            soft_cap=None)
            torch.cuda.synchronize()
            cell = (f"flash_attention {name} B={B} Sq={Sq} Sk={Sk} H={H} "
                    f"Hkv={Hkv} D={D} " + (f"Dv={Dv} " if Dv != D else "")
                    + dtype_name)
            expect = FA.route_for(dt, Sq, H // Hkv)
            if route != expect or (dtype_name == "float32") != (
                    route == "cuda_cores"):
                fail(f"{cell}: ran route {route}, the chooser names {expect}")
            if not torch.equal(got, again):
                fail(f"{cell}: two launches differ")
            err = check_close(cell, got, want, atol, rtol)
            masked = qpos_r < 0
            if causal and bool(masked.any()) \
                    and float(got[masked].abs().max()) != 0.0:
                fail(f"{cell}: masked query rows are not exactly zero")
            # SDPA on (B, H, S, D) copies with K/V repeated per query head
            # and the same visibility as a boolean mask (copies not timed)
            rep = H // Hkv
            qs = q.transpose(1, 2).contiguous()
            ks, vs = (x.repeat_interleave(rep, 2).transpose(1, 2).contiguous()
                      for x in (k, v))
            cols = torch.arange(Sk, device="cuda")
            vis = cols[None, None, :] < kvl_r[:, None, None]
            if causal:
                vis = vis & (cols[None, None, :] <= qpos_r[:, :, None])
            mask = None if bool(vis.all()) else vis[:, None]
            t_k = timer.ms(lambda: FA.flash_attention(q, k, v, qpos, kvl,
                                                      causal=causal))
            t_p = timer.ms(lambda: FA.flash_attention_plain(
                q, k, v, qpos_r, kvl_r, causal=causal, scale=scale,
                soft_cap=None))
            t_lib = timer.ms(lambda: sdpa(qs, ks, vs, attn_mask=mask))
            # what this run's data needs: each row's visible keys of K and V
            # once per kv head, q and the output once; 2·(D + Dv) FLOPs per
            # visible (query, head, key)
            horizon = kvl_r.clamp(min=0)
            if causal:
                horizon = torch.minimum(horizon, qpos_r.max(dim=1).values + 1)
            b_ms, b_by = bound_ms(
                "flash_attention", route, B=B, Sq=Sq, Sk=Sk, H=H, Hkv=Hkv,
                D=D, Dv=Dv, dtype=dt, keys=int(horizon.clamp(min=0).sum()),
                pairs=int(vis.sum()))
            rows.append(dict(cell=cell, dtype=dtype_name, path=path,
                             uses=uses, route=route, max_abs_err=err,
                             ms=t_k, plain_ms=t_p, library_ms=t_lib,
                             bound_ms=b_ms, bound_by=b_by))
            log(f"{cell}: route {route} max|d|={err:.2e} kernel {t_k:.4f} ms plain "
                f"{t_p:.4f} ms sdpa {t_lib:.4f} ms bound {b_ms:.4f} ms "
                f"({b_by})")
    return rows


# ---------------------------------------------------------------------------
# Phase 2d: the W8A8 GEMM (K2) against its plain version
# ---------------------------------------------------------------------------

def run_quant_gemm_phase(timer, cfg, bert, vit):
    """K2 at smollm-135m's decode (M = 8) and 64-column prefill GEMMs and
    bert-base's 1024-row GEMMs, fp32 and bf16 out: bitwise equal to the
    plain version, on the tensor-core route its chooser names (wgmma at bm
    64, mma.sync at bm 16/32). The activations are quantized per row as
    the W8A8 route does; the weights are packed as the engine packs
    them."""
    from repro_torch.core import layout as L
    from repro_torch.core import quant as Q
    from repro_torch.core.plan import GemmPolicy, layout_for_packed, pack_weight
    from repro_torch.kernels import matrixflow_gemm as MF

    cells = [c for c in gemm_cells(cfg, bert, vit)
             if c[4] != f"{vit.name} forward"]
    rows = []
    gen = torch.Generator(device="cuda").manual_seed(10)
    for dtype_name in ("bfloat16", "float32"):
        dt = getattr(torch, dtype_name)
        for name, M, K, N, path, uses in cells:
            a = torch.randn((M, K), generator=gen, device="cuda").to(dt)
            w = (torch.randn((K, N), generator=gen, device="cuda")
                 / K ** 0.5).to(dt)
            pw = pack_weight(w, GemmPolicy(), quantize="int8")
            blk = layout_for_packed(M, pw)
            aq, sa = Q.quantize_activations(a)
            a_bm = L.to_block_major_a(aq, blk.bm, blk.bk)

            def kernel():
                return MF.matrixflow_gemm_dequant(a_bm, pw.data, sa,
                                                  pw.scales, out_dtype=dt)

            before = counts()
            got = kernel()
            route = route_taken(before, counts(), "matrixflow_gemm_dequant",
                                K2_ROUTES)
            want = MF.plain(a_bm, pw.data, out_dtype=dt, scale_a=sa,
                            scale_b=pw.scales)
            torch.cuda.synchronize()
            cell = (f"matrixflow_gemm_dequant {name} M={M} K={K} N={N} "
                    f"{dtype_name}")
            expect = MF.route_for(torch.int8, blk.bm, dequant=True)
            if route != expect:
                fail(f"{cell}: ran route {route}, the chooser names {expect}")
            tile = MF.tc_tile(blk.bm, blk.bn, a_bm.shape[0], pw.data.shape[0],
                              a_bm.shape[1], blk.bk)
            if not torch.equal(got, want):
                err = float((got.float() - want.float()).abs().max())
                fail(f"{cell}: kernel and plain version differ (max |d| "
                     f"{err:.3e}); the W8A8 GEMM must match bitwise")
            # yardstick: torch._int_mm (cuBLASLt, needs M > 16 and K, N
            # multiples of 8: decode rows padded to 32, N to a multiple of
            # 8) followed by the rank-1 rescale
            Mp, Np = max(M, 32), -(-N // 8) * 8
            a_pad = torch.zeros((Mp, K), dtype=torch.int8, device="cuda")
            a_pad[:M] = aq
            w_pad = torch.zeros((K, Np), dtype=torch.int8, device="cuda")
            w_pad[:, :N] = pw.unpack_quantized()
            sa_pad = torch.ones(Mp, device="cuda")
            sa_pad[:M] = sa
            sb_pad = torch.ones(Np, device="cuda")
            sb_pad[:N] = pw.scales

            def library():
                c = torch._int_mm(a_pad, w_pad).float()
                return (c * sa_pad[:, None] * sb_pad[None, :]).to(dt)

            t_k = timer.ms(kernel)
            t_p = timer.ms(lambda: MF.plain(a_bm, pw.data, out_dtype=dt,
                                            scale_a=sa, scale_b=pw.scales))
            t_lib = timer.ms(library)
            b_ms, b_by = bound_ms("matrixflow_gemm_dequant", route, M=M, N=N,
                                  K=K, out_dtype=dt)
            rows.append(dict(cell=cell, dtype=dtype_name, M=M, K=K, N=N,
                             block=[blk.bm, blk.bn, blk.bk], route=route,
                             tile=tile, path=path,
                             uses=uses, max_abs_err=0.0, ms=t_k,
                             plain_ms=t_p, library_ms=t_lib,
                             library_padding=[Mp - M, Np - N],
                             bound_ms=b_ms, bound_by=b_by))
            log(f"{cell}: blocks {blk.bm}x{blk.bn}x{blk.bk} route {route} "
                f"tile {tile} bitwise kernel "
                f"{t_k:.4f} ms plain {t_p:.4f} ms _int_mm+rescale "
                f"{t_lib:.4f} ms bound {b_ms:.4f} ms ({b_by})")
    return rows


# ---------------------------------------------------------------------------
# Phase 2e: paged attention over int8 pages (K5) against its plain version
# ---------------------------------------------------------------------------

def run_int8_attention_phase(timer, cfg, models=(), main=True):
    """K5 at smollm-135m's decode, prefill bucket and chunked prefill, q in
    bf16 and fp32, over int8 pools with per-(page, kv head) scales through
    shuffled block tables whose entries past a slot's valid keys are out
    of range (the kernels read neither those pages nor their scales);
    within ATTN_TOLS, masked rows exactly 0, two launches bitwise equal,
    on the route the chooser names (bf16 q: split at decode, rows above 16
    rows a CTA; fp32 q: the CUDA cores)."""
    from repro_torch.core import quant as Q
    from repro_torch.kernels import paged_attention as PA

    nb = MAX_LEN // PAGE
    rng = np.random.default_rng(11)
    rows = []
    gen = torch.Generator(device="cuda").manual_seed(11)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for dtype_name, m in [(d, m) for m in ((cfg,) if main else ()) + (*models,)
                          for d in ("bfloat16", "float32")]:
        H, Hkv, D = m.n_heads, m.n_kv_heads, m.head_dim
        dt = getattr(torch, dtype_name)
        atol, rtol = ATTN_TOLS[dtype_name]
        dec_lens = rng.integers(17, MAX_LEN, SLOTS).tolist()
        pf_lens = rng.integers(16, PROMPT_BUCKET + 1, SLOTS).tolist()
        starts = rng.integers(0, MAX_LEN - 32, SLOTS).tolist()
        cases = [
            ("decode", 1, dec_lens, [n - 1 for n in dec_lens], "decode step"),
            ("prefill", PROMPT_BUCKET, pf_lens, [0] * SLOTS, "prefill"),
            ("chunked prefill", 32, [t + 32 for t in starts], starts,
             "chunk"),
        ] + serving_feature_cases(rng) if m is cfg else \
            model_attention_cases(rng, m)
        for name, Sq, lens, q_start, path in cases:
            q, kp, vp, bt, dead_bt, qpos, kvl = paged_case(
                gen, torch.float32, B=SLOTS, Sq=Sq, lens=lens,
                q_start=q_start, H=H, Hkv=Hkv, D=D, ps=PAGE, nb=nb)
            q = q.to(dt)
            (qk, ks), (qv, vs) = Q.quantize_kv_pages(kp), \
                Q.quantize_kv_pages(vp)
            scale = D ** -0.5

            def kernel():
                return PA.paged_attention(q, qk, qv, dead_bt, qpos, kvl,
                                          kv_scales=(ks, vs))

            def plain():
                return PA.paged_attention_plain(
                    q, qk, qv, bt, qpos, kvl, causal=True, scale=scale,
                    soft_cap=None, kv_scales=(ks, vs))

            before = counts()
            got, again = kernel(), kernel()
            route = route_taken(before, counts(), "paged_attention_int8")
            want = plain()
            torch.cuda.synchronize()
            cell = (f"paged_attention_int8 {name} B={SLOTS} Sq={Sq} H={H} "
                    f"Hkv={Hkv} D={D} q {dtype_name}")
            expect = PA.route_for(dt, Sq, H // Hkv)
            if route != expect or (dtype_name == "float32") != (
                    route == "cuda_cores"):
                fail(f"{cell}: ran route {route}, the chooser names {expect}")
            if not torch.equal(got, again):
                fail(f"{cell}: two launches differ")
            err = check_close(cell, got, want, atol, rtol)
            masked = qpos < 0
            if bool(masked.any()) and float(got[masked].abs().max()) != 0.0:
                fail(f"{cell}: masked query rows are not exactly zero")
            # SDPA over the gathered, dequantized pages (not timed)
            rep = H // Hkv
            kd = PA.gather_pages(Q.dequantize_kv_pages(qk, ks, dt), bt)
            vd = PA.gather_pages(Q.dequantize_kv_pages(qv, vs, dt), bt)
            qs, kss, vss = (x.transpose(1, 2).contiguous() for x in (
                q, kd.repeat_interleave(rep, 2), vd.repeat_interleave(rep, 2)))
            cols = torch.arange(nb * PAGE, device="cuda")
            mask = ((cols[None, None, :] < kvl[:, None, None])
                    & (cols[None, None, :] <= qpos[:, :, None]))[:, None]
            t_k = timer.ms(kernel)
            t_p = timer.ms(plain)
            t_lib = timer.ms(lambda: sdpa(qs, kss, vss, attn_mask=mask))
            # what this run's data needs: each visible page of K and V once
            # as int8 plus its two fp32 scales, q and the output, the
            # tables; 4·D operations per visible (query, head, key)
            b_ms, b_by = paged_bound(route, q, bt, qpos, kvl, Hkv, dt,
                                     kv_dtype=torch.int8)
            rows.append(dict(cell=cell, dtype=dtype_name, Sq=Sq, lens=lens,
                             path=path, uses=m.n_layers, route=route,
                             max_abs_err=err,
                             ms=t_k, plain_ms=t_p, library_ms=t_lib,
                             bound_ms=b_ms, bound_by=b_by))
            log(f"{cell}: route {route} max|d|={err:.2e} kernel {t_k:.4f} ms plain "
                f"{t_p:.4f} ms sdpa {t_lib:.4f} ms bound {b_ms:.4f} ms "
                f"({b_by})")
    return rows


# ---------------------------------------------------------------------------
# Phase 2f: the SSD scan (K6) against its plain version
# ---------------------------------------------------------------------------

def ssd_cells(mamba, zamba):
    """(name, B, S, cfg, path) of the SSD scans the SSM paths run (one per
    SSD layer of a prefill), plus mamba2 at B 8 x S 64 (one chunk), a
    4096-token prompt (32 chunks) and B 2 x S 1000 (Q 125)."""
    return [(f"{mamba.name} generate prefill", SSM_SLOTS, MAMBA_PROMPT, mamba),
            (f"{mamba.name} submit prefill", 1, SOLO_PROMPTS[0], mamba),
            (f"{mamba.name} recycled-slot prefill", 1, SOLO_PROMPTS[1], mamba),
            (f"{mamba.name} prefill", SSM_SLOTS, 64, mamba),
            (f"{mamba.name} long prefill", 1, 4096, mamba),
            (f"{mamba.name} prefill", 2, 1000, mamba),
            (f"{zamba.name} generate prefill", SSM_SLOTS, ZAMBA_PROMPT, zamba)]


# K6's kernels by phase (csrc/ssd_scan.cu): the chunks route launches all
# three, the walk route the last one; fp32 runs ssd_scan_kernel.
SSD_PHASES = (("ssd_segment_state_kernel", "segment states"),
              ("ssd_segment_pass_kernel", "segment pass"),
              ("ssd_walk_kernel", "walk"), ("ssd_scan_kernel", "cuda cores"))


def ssd_phase_ms(fn, n=5):
    """Device time per call of each of K6's kernels over ``n`` calls, from
    torch.profiler (L2 warm: the calls run back to back)."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        for sub, phase in SSD_PHASES:
            if sub in e.name:
                out[phase] = out.get(phase, 0.0) \
                    + e.time_range.elapsed_us() / 1e3 / n
    return out


def run_ssd_phase(timer, mamba, zamba):
    """K6 at every SSM path's prefill shape, bf16 and fp32: the route its
    chooser names (bf16 on a tensor-core route, fp32 on the CUDA cores),
    two launches bitwise equal, y and the fp32 state against the plain
    version, the time per call and, per route, per kernel (phase)."""
    from repro_torch.kernels import ssd_scan as K6

    rows = []
    gen = torch.Generator(device="cuda").manual_seed(15)
    for dtype_name in ("bfloat16", "float32"):
        dt_ = getattr(torch, dtype_name)
        atol, rtol = SSD_TOLS[dtype_name]
        for name, B, S, scfg in ssd_cells(mamba, zamba):
            H, P, N = scfg.ssm_heads, scfg.ssm_head_dim, scfg.ssm_state
            # the distributions of tests/test_flash_ssd_kernels.py, which
            # the fp32 tolerance was set for: the error of a sum in another
            # order grows with the terms' scale, and with unscaled B and C
            # (C·B ~ 11 at N 128) kernel and plain part by ~1e-3 on outputs
            # near 0, 1e-5 of the terms summed
            x = torch.randn((B, S, H, P), generator=gen, device="cuda").to(dt_)
            dt = torch.nn.functional.softplus(torch.randn(
                (B, S, H), generator=gen, device="cuda"))
            A = -torch.exp(0.5 * torch.randn((H,), generator=gen,
                                             device="cuda"))
            Bc, Cc = ((0.5 * torch.randn((B, S, N), generator=gen,
                                         device="cuda")).to(dt_)
                      for _ in range(2))
            before = counts()
            y, h = K6.ssd_scan(x, dt, A, Bc, Cc)
            y2, h2 = K6.ssd_scan(x, dt, A, Bc, Cc)
            torch.cuda.synchronize()
            route = route_taken(before, counts(), "ssd_scan", SSD_ROUTES)
            want_route = K6.route_for(dt_, S, P, N)
            if route != want_route or (route in SSD_TC_ROUTES) != (
                    dtype_name == "bfloat16"):
                fail(f"ssd_scan {name} B={B} S={S} {dtype_name}: ran on "
                     f"{route}, the chooser names {want_route}")
            want_y, want_h = K6.ssd_scan_plain(x, dt, A, Bc, Cc)
            torch.cuda.synchronize()
            Q = K6.ssd_chunk_size(S, 128)
            cell = (f"ssd_scan {name} B={B} S={S} H={H} P={P} N={N} Q={Q} "
                    f"{dtype_name} ({route})")
            if not (torch.equal(y, y2) and torch.equal(h, h2)):
                fail(f"{cell}: two launches differ")
            err = check_close(cell, y, want_y, atol, rtol)
            err_h = check_close(f"{cell} final state", h, want_h, 1e-4, 1e-4)
            t_k = timer.ms(lambda: K6.ssd_scan(x, dt, A, Bc, Cc))
            t_p = timer.ms(lambda: K6.ssd_scan_plain(x, dt, A, Bc, Cc))
            phases = ssd_phase_ms(lambda: K6.ssd_scan(x, dt, A, Bc, Cc))
            b_ms, b_by = bound_ms("ssd_scan", route, B=B, S=S, H=H, P=P,
                                  N=N, dtype=dtype_name, Q=Q)
            rows.append(dict(cell=cell, dtype=dtype_name, B=B, S=S, Q=Q,
                             route=route, path=f"{name} B{B}xS{S}",
                             uses=scfg.n_layers, max_abs_err=err,
                             state_max_abs_err=err_h, ms=t_k, plain_ms=t_p,
                             phase_ms_warm_l2=phases, library_ms=None,
                             bound_ms=b_ms, bound_by=b_by))
            log(f"{cell}: max|d| y {err:.2e} state {err_h:.2e} kernel "
                f"{t_k:.4f} ms (by kernel, L2 warm: "
                f"{', '.join(f'{k} {v:.4f}' for k, v in phases.items())}) "
                f"plain {t_p:.4f} ms bound {b_ms:.4f} ms ({b_by}); no "
                f"library call")
    return rows


# ---------------------------------------------------------------------------
# Phase 3: serving
# ---------------------------------------------------------------------------

def serve_requests(eng, prompts, limit_s):
    """Drive submit/step until every prompt has GEN_LEN tokens, cancelling
    each as it gets there. Handles are slot ids (contiguous) or request ids
    (paged); the streams are returned in prompt order."""
    pending, owner, streams = list(enumerate(prompts)), {}, {}
    decode_deltas, n_tokens = [], 0
    t0 = time.perf_counter()
    while pending or eng.slot_live.any() or eng.wait:
        while pending:
            h = eng.submit(pending[0][1])
            if h is None:
                break
            owner[h] = pending.pop(0)[0]
            streams[owner[h]] = []
        before = (counts(), eng.prefill_tokens)
        out = eng.step()
        if eng.prefill_tokens == before[1] and not eng.wait and out:
            decode_deltas.append(tuple(
                n - before[0][k] for k, n in counts().items()))
        n_tokens += len(out)
        for h, t in out.items():
            streams[owner[h]].append(t)
            if len(streams[owner[h]]) >= GEN_LEN:
                eng.cancel(h)
        if time.perf_counter() - t0 > limit_s:
            fail(f"serving did not finish within {limit_s} s")
    got = [streams.get(i, []) for i in range(len(prompts))]
    per_step = dict(zip(kernel_wrappers(), max(
        set(decode_deltas), key=decode_deltas.count))) if decode_deltas \
        else None
    return got, n_tokens, per_step


def check_streams(path, streams, vocab, gen_len=GEN_LEN):
    for i, toks in enumerate(streams):
        if len(toks) < gen_len or min(toks) < 0 or max(toks) >= vocab:
            fail(f"{path}: request {i} incomplete or malformed: {toks}")


def run_serving_phase(cfg):
    from repro_torch.core.plan import AttentionPolicy
    from repro_torch.kernels import matrixflow_gemm as MF
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import ServeConfig, ServingEngine

    params = T.init_model(cfg, seed=0, device="cuda")
    sc = ServeConfig(batch_slots=SLOTS, max_len=MAX_LEN, cache_dtype=cfg.dtype,
                     pack_weights=True,
                     attention=AttentionPolicy(backend="paged", page_size=PAGE),
                     cache_pages=CACHE_PAGES, device="cuda")
    eng = ServingEngine(cfg, params, sc)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab, int(n)).tolist()
               for n in rng.integers(16, PROMPT_BUCKET + 1, N_REQUESTS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    streams, n_tokens, per_step = serve_requests(eng, prompts, 300)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_counts("serving", K1_BF16 + K4_BF16)
    check_streams("serving", streams, cfg.vocab)
    if eng.n_preemptions < 1:
        fail("serving: the pool never ran dry (no preemption)")
    # the batched entry point on the same engine: one 16-token prompt per
    # slot, whose 48-token horizons fill the 24-page pool exactly
    prompts = rng.integers(0, cfg.vocab, (SLOTS, 16))
    before = MF.matrixflow_gemm_block_major.launches
    t1 = time.perf_counter()
    gen_out = eng.generate(prompts, GEN_LEN)
    gen_s = time.perf_counter() - t1
    if gen_out.shape != (SLOTS, GEN_LEN) or gen_out.min() < 0 \
            or gen_out.max() >= cfg.vocab:
        fail(f"generate: malformed output {gen_out.shape}")
    if MF.matrixflow_gemm_block_major.launches == before:
        fail("generate: the MatrixFlow kernel was never launched")
    decode = profile_decode_step(eng, rng.integers(0, cfg.vocab, (SLOTS, 16)))
    res = dict(requests=N_REQUESTS, tokens=n_tokens, seconds=dt,
               tokens_per_s=n_tokens / dt,
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
               preemptions=eng.n_preemptions, launches=launches,
               launches_per_decode_step=per_step,
               generate_tokens_per_s=SLOTS * GEN_LEN / gen_s,
               decode_step=decode, stats=eng.stats())
    log(f"serving: {N_REQUESTS} requests x {GEN_LEN} tokens, {n_tokens} "
        f"tokens in {dt:.3f} s ({res['tokens_per_s']:.1f} tok/s), peak "
        f"{res['peak_mem_gib']:.3f} GiB, {eng.n_preemptions} preemptions, "
        f"launches {launches}, per decode step {per_step}; generate() "
        f"{SLOTS}x{GEN_LEN} tokens in {gen_s:.3f} s; a decode step at "
        f"{SLOTS} live requests: device busy {decode['device_busy_ms']:.3f} "
        f"ms of {decode['host_wall_ms']:.3f} ms host wall (profiled)")
    return res


def profile_decode_step(eng, prompts):
    """One decode step with every slot live (phase 25 holds the dry run
    to it): the launches and host wall time of one step, and the device
    busy time of two more (torch.profiler, which slows the host)."""
    for p in prompts:
        if eng.submit(p.tolist()) is None:
            fail("decode profile: a prompt was not admitted")
    for _ in range(8):                 # until the prompts are prefilled
        before = eng.prefill_tokens
        eng.step()
        if eng.prefill_tokens == before and int(eng.slot_live.sum()) == SLOTS:
            break
    prefilled = eng.prefill_tokens
    c0 = counts()
    t0 = time.perf_counter()
    eng.step()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    c1 = counts()
    busy, wall_profiled = device_busy_ms(eng.step, 2)
    if eng.prefill_tokens != prefilled or eng.wait \
            or int(eng.slot_live.sum()) != SLOTS:
        fail("decode profile: a profiled step prefilled or preempted")
    return dict(launches={k: c1[k] - c0[k] for k in c1},
                device_busy_ms=busy, host_wall_ms=wall,
                host_wall_ms_profiled=wall_profiled)


# ---------------------------------------------------------------------------
# Phase 4: kernel path (card) vs plain path (CPU), full width, fp32
# ---------------------------------------------------------------------------

def greedy_batch(cfg, rng, B, S):
    """numpy inputs: tokens (B, S) or, audio, (B, S, n_codebooks); for the
    VLM also N_IMAGE_TOKENS stub image embeddings a row (at the token
    table's scale) ahead of the text."""
    shape = (B, S, cfg.n_codebooks) if cfg.n_codebooks else (B, S)
    batch = {"tokens": rng.integers(0, cfg.vocab, shape)}
    if cfg.family == "vlm":
        batch["embeds"] = (0.02 * rng.standard_normal(
            (B, N_IMAGE_TOKENS, cfg.d_model))).astype(np.float32)
    return batch


def greedy_run(cfg, params, device, batch, n_steps, paged=True,
               kv_dtype=None):
    """``batch`` (greedy_batch's) prefilled into fresh caches through
    transformer.forward (the last column's logits only), then ``n_steps``
    greedy steps (audio: the argmax of each codebook). Paged: pools of
    ``kv_dtype`` pages of PAGE tokens through a shuffled block table; else
    contiguous caches, the only kind MLA takes. Returns (tokens (B,
    n_steps + 1[, n_codebooks]), fp32 logits per step on the host, seconds
    of the decode steps)."""
    from repro_torch.core import api
    from repro_torch.core.plan import FUSED, AttentionPolicy
    from repro_torch.models import transformer as T

    B = batch["tokens"].shape[0]
    S = batch["tokens"].shape[1] + (batch["embeds"].shape[1]
                                    if "embeds" in batch else 0)
    if paged:
        nb = -(-(S + n_steps) // PAGE)
        caches = T.init_paged_caches(cfg, B, B * nb, PAGE, cfg.dtype, device,
                                     kv_dtype=kv_dtype)
        bt = torch.randperm(B * nb, generator=torch.Generator().manual_seed(
            7)).reshape(B, nb).to(torch.int32).to(device)
        policy = AttentionPolicy(backend="paged", page_size=PAGE)
    else:
        caches = T.init_caches(cfg, B, max(MAX_LEN, S + n_steps), cfg.dtype,
                               device)
        bt, policy = None, FUSED

    def step(inputs, positions, last=None):
        b = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
             for k, v in inputs.items()}
        b["positions"] = positions.to(device)
        if bt is not None:
            b["block_tables"] = bt
        logits, _, _ = T.forward(params, cfg, b, caches=caches, last_cols=last)
        return logits[:, -1].float().cpu()

    toks, lgs = [], []
    with torch.no_grad(), api.use_attention_policy(policy):
        lg = step(batch, torch.arange(S).expand(B, S),
                  torch.full((B,), S - 1, device=device))
        t0 = time.perf_counter()
        for i in range(n_steps + 1):
            lgs.append(lg)
            toks.append(lg.argmax(-1))
            if i < n_steps:
                lg = step({"tokens": toks[-1][:, None].numpy()},
                          torch.full((B, 1), S + i))
        dec_s = time.perf_counter() - t0
    return torch.stack(toks, 1), lgs, dec_s


def to_device(node, device):
    """A param tree's tensors on ``device``."""
    if isinstance(node, dict):
        return {k: to_device(v, device) for k, v in node.items()}
    if isinstance(node, list):
        return [to_device(v, device) for v in node]
    return node.to(device)


def tree_tensors(node):
    """The tensors of a param tree, packed weights' blocks and scales
    included."""
    if isinstance(node, dict):
        return [t for v in node.values() for t in tree_tensors(v)]
    if isinstance(node, list):
        return [t for v in node for t in tree_tensors(v)]
    if isinstance(node, torch.Tensor):
        return [node]
    return [t for t in (getattr(node, "data", None),
                        getattr(node, "scales", None)) if t is not None]


def compare_greedy(tag, toks_g, lg_g, toks_c, lg_c):
    """The card's greedy run against the CPU plain path's: prefill and
    first-decode logits within LOGIT_TOL, and streams equal or first
    parting where the plain top-2 margin (of every codebook that parts,
    for audio) is below LOGIT_TOL. Returns (logit errors per step, the
    first divergence or None)."""
    errs = [float((a - b).abs().max()) for a, b in zip(lg_g, lg_c)]
    for i, name in ((0, "prefill"), (1, "first decode")):
        if not np.isfinite(errs[i]) or errs[i] > LOGIT_TOL:
            fail(f"{tag}: {name} logits max |kernel - plain| = {errs[i]:.3e}"
                 f" > {LOGIT_TOL}")
    diverged = None
    for b in range(toks_g.shape[0]):
        for i in range(toks_g.shape[1]):
            differ = (toks_g[b, i] != toks_c[b, i]).reshape(-1)
            if bool(differ.any()):
                lg = lg_c[i][b].reshape(differ.numel(), -1)[differ]
                top2 = lg.topk(2, dim=-1).values
                margin = float((top2[:, 0] - top2[:, 1]).min())
                if margin >= LOGIT_TOL:
                    fail(f"{tag}: greedy streams diverge at row {b} step {i} "
                         f"with plain top-2 margin {margin:.3e} >= {LOGIT_TOL}")
                diverged = dict(row=b, step=i, margin=margin)
                break
    return errs, diverged


def run_parity_phase(cfg, tag="parity", paged=True, steps=PARITY_STEPS):
    """fp32 at full width, ``cfg``'s depth (phase 4): the card's kernel
    path against the CPU plain path through greedy_run (2 rows of
    PARITY_PROMPT tokens, the VLM's behind its image embeddings, then
    ``steps`` greedy steps), over
    paged caches or, ``paged`` False, contiguous ones. The weights are
    drawn on the card (seconds, where the host's draw takes minutes at
    billions of parameters) and held on the host."""
    from repro_torch.core.api import pack_model_weights
    from repro_torch.models import transformer as T

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    t0 = time.perf_counter()
    raw = T.init_model(cfg32, seed=3, device="cpu", draw_device="cuda")
    gpu_params = pack_model_weights(to_device(raw, "cuda"))
    cpu_params = pack_model_weights(raw)
    del raw
    host_gib = sum(t.numel() * t.element_size() for t in tree_tensors(
        cpu_params)) / 2**30
    batch = greedy_batch(cfg, np.random.default_rng(3), 2, PARITY_PROMPT)
    toks_g, lg_g, _ = greedy_run(cfg32, gpu_params, "cuda", batch, steps,
                                 paged)
    del gpu_params
    gc.collect()
    torch.cuda.empty_cache()
    toks_c, lg_c, _ = greedy_run(cfg32, cpu_params, "cpu", batch, steps,
                                 paged)
    del cpu_params
    errs, diverged = compare_greedy(tag, toks_g, lg_g, toks_c, lg_c)
    res = dict(layers=cfg.n_layers, paged=paged, host_weights_gib=host_gib,
               logit_max_abs_err=errs, streams_equal=diverged is None,
               first_divergence=diverged, seconds=time.perf_counter() - t0)
    log(f"{tag} fp32 full width, {cfg.n_layers} layers "
        f"({'paged' if paged else 'contiguous'}, {host_gib:.1f} GiB of fp32 "
        f"weights on the host): logits max|d| per step "
        f"{[f'{e:.2e}' for e in errs]}; streams "
        f"{'equal' if diverged is None else f'diverge at a near-tie {diverged}'}"
        f" ({res['seconds']:.1f} s)")
    return res


# ---------------------------------------------------------------------------
# Phase 5: the BERT/ViT encoders
# ---------------------------------------------------------------------------

def encoder_batch(ecfg, B, S, dtype, device, seed):
    gen = torch.Generator().manual_seed(seed)
    if ecfg.family == "vit":      # stub patch embeddings, as the reference
        return {"embeds": torch.randn((B, S, ecfg.d_model), generator=gen)
                .to(device=device, dtype=dtype)}
    return {"tokens": torch.randint(0, ecfg.vocab, (B, S), generator=gen)
            .to(device)}


def run_encoder_phase(bert, vit):
    from repro_torch.core.api import pack_model_weights
    from repro_torch.models import transformer as T

    res = {}
    for ecfg, S in ((bert, BERT_SEQ), (vit, VIT_SEQ)):
        params = pack_model_weights(T.init_model(ecfg, seed=5, device="cuda"))
        batch = encoder_batch(ecfg, ENC_BATCH, S, ecfg.param_dtype, "cuda", 5)
        with torch.no_grad():
            T.encoder_forward(params, ecfg, batch)       # warm-up
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            logits = T.encoder_forward(params, ecfg, batch)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        counts = read_counts(f"encoder {ecfg.name}",
                             ("matrixflow_gemm", "matrixflow_gemm_wgmma",
                              "flash_attention", "flash_attention_rows"))
        if tuple(logits.shape) != (ENC_BATCH, S, ecfg.vocab) \
                or not bool(torch.isfinite(logits).all()):
            fail(f"encoder {ecfg.name}: logits {tuple(logits.shape)} "
                 f"malformed or not finite")
        with torch.no_grad():
            busy, host = device_busy_ms(
                lambda: T.encoder_forward(params, ecfg, batch), 2)
        res[ecfg.name] = dict(batch=ENC_BATCH, seq=S, dtype=ecfg.dtype,
                              forward_wall_ms=wall_ms, launches=counts,
                              device_busy_ms=busy, host_wall_ms=host)
        log(f"encoder {ecfg.name} {ecfg.dtype} B={ENC_BATCH} S={S}: forward "
            f"{wall_ms:.3f} ms (host clock), launches {counts}; device busy "
            f"{busy:.3f} ms of {host:.3f} ms host wall (profiled)")
    # fp32 parity: the kernel path on the card against the plain path on
    # the CPU, the same seeded weights
    cfg32 = dataclasses.replace(bert, dtype="float32")
    batch = encoder_batch(cfg32, PARITY_BATCH, BERT_SEQ, torch.float32,
                          "cpu", 6)
    t0 = time.perf_counter()
    with torch.no_grad():
        out = {}
        for device in ("cuda", "cpu"):
            params = pack_model_weights(T.init_model(cfg32, seed=6,
                                                     device=device))
            out[device] = T.encoder_forward(
                params, cfg32, {k: v.to(device) for k, v in batch.items()}
            ).cpu()
    err = float((out["cuda"] - out["cpu"]).abs().max())
    if not np.isfinite(err) or err > LOGIT_TOL:
        fail(f"encoder parity: bert-base fp32 logits max |kernel - plain| = "
             f"{err:.3e} > {LOGIT_TOL}")
    res["parity"] = dict(arch=bert.name, batch=PARITY_BATCH, seq=BERT_SEQ,
                         logit_max_abs_err=err,
                         seconds=time.perf_counter() - t0)
    log(f"encoder parity bert-base fp32 B={PARITY_BATCH} S={BERT_SEQ}: "
        f"logits max|d| {err:.2e} (tolerance {LOGIT_TOL})")
    return res


# ---------------------------------------------------------------------------
# Phase 6: serving from contiguous KV caches
# ---------------------------------------------------------------------------

def first_divergence(cfg32, params_cpu, prompt, a, b,
                     label="contiguous serving fp32"):
    """None if streams a and b agree; else the step where they first
    differ, failing unless the plain path's top-2 logit margin after
    ``prompt + a[:step]`` is below LOGIT_TOL (a near-tie that fp32
    summation order may flip)."""
    from repro_torch.models import transformer as T

    for i, (x, y) in enumerate(zip(a, b)):
        if x == y:
            continue
        toks = torch.tensor([prompt + a[:i]])
        with torch.no_grad():
            logits, _, _ = T.forward(params_cpu, cfg32, {"tokens": toks})
        top2 = logits[0, -1].float().topk(2).values
        margin = float(top2[0] - top2[1])
        if margin >= LOGIT_TOL:
            fail(f"{label}: streams diverge at step {i} with plain top-2 "
                 f"margin {margin:.3e} >= {LOGIT_TOL}")
        return dict(step=i, margin=margin)
    if len(a) != len(b):
        fail(f"{label}: stream lengths {len(a)} != {len(b)}")
    return None


def run_contiguous_phase(cfg):
    from repro_torch.core.api import pack_model_weights
    from repro_torch.core.plan import FUSED, AttentionPolicy
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import ServeConfig, ServingEngine

    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab, int(n)).tolist()
               for n in rng.integers(16, PROMPT_BUCKET + 1, N_REQUESTS)]
    eng = ServingEngine(cfg, T.init_model(cfg, seed=0, device="cuda"),
                        ServeConfig(batch_slots=SLOTS, max_len=MAX_LEN,
                                    cache_dtype=cfg.dtype, pack_weights=True,
                                    attention=FUSED, device="cuda"))
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    streams, n_tokens, per_step = serve_requests(eng, prompts, 300)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_counts("contiguous serving", K1_BF16 + K3_BF16)
    check_streams("contiguous serving", streams, cfg.vocab)
    gen_prompts = rng.integers(0, cfg.vocab, (SLOTS, 16))
    reset_counts()
    t1 = time.perf_counter()
    gen_out = eng.generate(gen_prompts, GEN_LEN)
    gen_s = time.perf_counter() - t1
    gen_launches = read_counts("contiguous generate", K1_BF16 + K3_BF16)
    if gen_out.shape != (SLOTS, GEN_LEN) or gen_out.min() < 0 \
            or gen_out.max() >= cfg.vocab:
        fail(f"contiguous generate: malformed output {gen_out.shape}")
    res = dict(requests=N_REQUESTS, tokens=n_tokens, seconds=dt,
               tokens_per_s=n_tokens / dt, launches=launches,
               launches_per_decode_step=per_step,
               generate_tokens_per_s=SLOTS * GEN_LEN / gen_s,
               generate_launches=gen_launches, stats=eng.stats())
    log(f"contiguous serving: {N_REQUESTS} requests x {GEN_LEN} tokens, "
        f"{n_tokens} tokens in {dt:.3f} s ({res['tokens_per_s']:.1f} tok/s), "
        f"launches {launches}, per decode step {per_step}; generate() "
        f"{SLOTS}x{GEN_LEN} tokens in {gen_s:.3f} s")
    del eng

    # fp32: the same prompts through the contiguous engine on the card, the
    # paged engine on the card and the contiguous engine on the CPU (plain
    # versions), full width at CONTIG_FP32_LAYERS layers; greedy streams
    # must agree
    cfg32 = dataclasses.replace(cfg, dtype="float32",
                                n_layers=CONTIG_FP32_LAYERS)
    params32 = T.init_model(cfg32, seed=8, device="cpu")
    runs = {}
    t0 = time.perf_counter()
    for name, device, attn in (
            ("fused card", "cuda", FUSED),
            ("paged card", "cuda", AttentionPolicy("paged", PAGE)),
            ("fused cpu plain", "cpu", FUSED)):
        e = ServingEngine(cfg32, params32, ServeConfig(
            batch_slots=SLOTS, max_len=MAX_LEN, cache_dtype="float32",
            pack_weights=True, attention=attn, device=device))
        runs[name] = serve_requests(e, prompts, 600)[0]
        del e
    params_cpu = pack_model_weights(params32)
    ties = {}
    for other in ("paged card", "fused cpu plain"):
        for i, p in enumerate(prompts):
            d = first_divergence(cfg32, params_cpu, p, runs["fused card"][i],
                                 runs[other][i])
            if d is not None:
                ties[f"{other} request {i}"] = d
    res["fp32_streams"] = dict(equal=not ties, near_ties=ties,
                               seconds=time.perf_counter() - t0)
    log(f"contiguous serving fp32, {CONTIG_FP32_LAYERS} layers: streams of "
        f"{N_REQUESTS} requests "
        f"{'equal' if not ties else f'equal up to near-ties {ties}'} across "
        f"fused card / paged card / CPU plain")
    return res


# ---------------------------------------------------------------------------
# Phase 7: int8 serving (W8A8 weights through K2, int8 KV pages through K5)
# ---------------------------------------------------------------------------

class QuantRecorder:
    """Every int8 quantization of a run — each W8A8 GEMM input and each KV
    write — as (fp32 values, scale, int8 payload) on the host, in call
    order."""

    def __enter__(self):
        from repro_torch.core import quant as Q
        self.Q, self.calls = Q, []
        self.saved = (Q.quantize_activations, Q.quantize_kv_rows)
        qa, qkv = self.saved

        def act(x):
            out = qa(x)
            self.calls.append((x.float().cpu(), out[1][..., None].cpu(),
                               out[0].cpu()))
            return out

        def kv(rows, scales):
            out = qkv(rows, scales)
            self.calls.append((rows.float().cpu(),
                               scales.float()[..., None].cpu(), out.cpu()))
            return out

        Q.quantize_activations, Q.quantize_kv_rows = act, kv
        return self

    def __exit__(self, *exc):
        self.Q.quantize_activations, self.Q.quantize_kv_rows = self.saved


def tie_flip(calls_a, calls_b):
    """Where two int8 runs part: the first call whose int8 payloads
    differ. Fails unless every quantization before it saw the same fp32
    values and scales up to fp32 noise (1e-5 relative) and every differing
    value there differs by one step on a .5 tie of the grid (x / s within
    1e-3 of k + 0.5): an ulp of fp32 difference rounded to another int8
    value, not a fault of the kernels."""
    if len(calls_a) != len(calls_b):
        fail(f"int8 parity: {len(calls_a)} vs {len(calls_b)} quantizations")
    for g, ((ax, as_, aq), (bx, bs, bq)) in enumerate(zip(calls_a, calls_b)):
        if ax.shape != bx.shape:
            fail(f"int8 parity: call {g} shapes {ax.shape} vs {bx.shape}")
        noise = 1e-5 * max(float(bx.abs().max()), 1.0)
        if float((ax - bx).abs().max()) > noise or not torch.allclose(
                as_, bs, rtol=1e-5, atol=0):
            fail(f"int8 parity: quantization call {g} saw fp32 values "
                 f"{float((ax - bx).abs().max()):.3e} apart before any int8 "
                 f"value differed")
        flips = aq != bq
        if bool(flips.any()):
            step = (aq[flips].int() - bq[flips].int()).abs()
            scaled = (bx / bs).expand_as(bx)[flips]
            off_tie = (scaled - scaled.trunc()).abs().sub(0.5).abs()
            if bool((step != 1).any()) or float(off_tie.max()) >= 1e-3:
                fail(f"int8 parity: call {g} rounds {int(flips.sum())} "
                     f"values differently, not one step on a .5 tie "
                     f"(largest distance from a tie {float(off_tie.max()):.3e})")
            return dict(call=g, of=len(calls_a), values=int(flips.sum()),
                        all_later=sum(int((a[2] != b[2]).sum()) for a, b in
                                      zip(calls_a[g:], calls_b[g:])))
    return None


def run_int8_serving_phase(cfg):
    """Full-width smollm-135m, bf16, paged, weight_dtype and kv_dtype int8:
    12 requests through submit/step under a 24-page pool (preemption), K2
    and K5 launched on both tensor-core routes each (K2: wgmma at
    prefill, mma at decode; K5: rows, split), none on the CUDA cores, and
    K1 and K4 not; one preempted request's stream equals its solo stream
    on the card; then fp32, the card against the CPU plain path over
    greedy_run."""
    from repro_torch.core.api import pack_model_weights
    from repro_torch.core.plan import AttentionPolicy
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import ServeConfig, ServingEngine

    sc = ServeConfig(batch_slots=SLOTS, max_len=MAX_LEN, cache_dtype=cfg.dtype,
                     attention=AttentionPolicy(backend="paged", page_size=PAGE),
                     cache_pages=CACHE_PAGES, weight_dtype="int8",
                     kv_dtype="int8", device="cuda")
    params = T.init_model(cfg, seed=0, device="cuda")
    eng = ServingEngine(cfg, params, sc)
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, cfg.vocab, int(n)).tolist()
               for n in rng.integers(16, PROMPT_BUCKET + 1, N_REQUESTS)]
    preempted = []
    preempt = eng._preempt
    eng._preempt = lambda slot: (preempted.append(int(eng.slot_rid[slot])),
                                 preempt(slot))[1]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    streams, n_tokens, per_step = serve_requests(eng, prompts, 300)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_counts("int8 serving", K2_K5_BF16)
    if launches["matrixflow_gemm"] or launches["paged_attention"]:
        fail(f"int8 serving: an fp kernel ran on the int8 path: {launches}")
    check_streams("int8 serving", streams, cfg.vocab)
    if not preempted:
        fail("int8 serving: the pool never ran dry (no preemption)")
    stats = eng.stats()
    del eng
    # request ids are given in submission order, which is prompt order
    rid = preempted[0]
    solo = ServingEngine(cfg, params, sc)
    h = solo.submit(prompts[rid])
    alone = []
    while len(alone) < GEN_LEN:
        alone.append(solo.step()[h])
    del solo
    if alone != streams[rid]:
        fail(f"int8 serving: preempted request {rid}'s stream "
             f"{streams[rid]} differs from its solo stream {alone}")
    log(f"int8 serving: {N_REQUESTS} requests x {GEN_LEN} tokens, {n_tokens} "
        f"tokens in {dt:.3f} s ({n_tokens / dt:.1f} tok/s), "
        f"{len(preempted)} preemptions, launches {launches}, per decode "
        f"step {per_step}; preempted request {rid} equals its solo stream; "
        f"pool {stats['kv_page_bytes']} B/page ({stats['kv_dtype']})")
    res = dict(requests=N_REQUESTS, tokens=n_tokens, seconds=dt,
               tokens_per_s=n_tokens / dt,
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
               preemptions=len(preempted), launches=launches,
               launches_per_decode_step=per_step, solo_checked_request=rid,
               stats=stats)

    # fp32: the card's int8 path against the CPU plain path
    cfg32 = dataclasses.replace(cfg, dtype="float32",
                                n_layers=INT8_PARITY_LAYERS)
    batch = greedy_batch(cfg, np.random.default_rng(13), 2, PARITY_PROMPT)
    runs = {}
    t0 = time.perf_counter()
    for device in ("cuda", "cpu"):
        p32 = pack_model_weights(T.init_model(cfg32, seed=14, device=device),
                                 quantize="int8")
        with QuantRecorder() as rec:
            toks, lg, _ = greedy_run(cfg32, p32, device, batch, PARITY_STEPS,
                                     kv_dtype="int8")
        runs[device] = (toks, lg, rec.calls)
        del p32
    (toks_g, lg_g, calls_g), (toks_c, lg_c, calls_c) = runs["cuda"], runs["cpu"]
    errs = [float((a - b).abs().max()) for a, b in zip(lg_g, lg_c)]
    if not all(np.isfinite(errs)):
        fail(f"int8 parity: non-finite logits {errs}")
    flip = tie_flip(calls_g, calls_c)
    parted = None
    for b in range(toks_g.shape[0]):
        i = next((i for i in range(toks_g.shape[1])
                  if int(toks_g[b, i]) != int(toks_c[b, i])), None)
        if i is None:
            continue
        top2 = lg_c[i][b].topk(2).values
        margin = float(top2[0] - top2[1])
        if margin >= LOGIT_TOL and flip is None:
            fail(f"int8 parity: greedy streams part at row {b} step {i} "
                 f"with plain top-2 margin {margin:.3e} >= {LOGIT_TOL} and "
                 f"no int8 value rounded differently")
        parted = parted or dict(row=b, step=i, margin=margin)
    res["fp32_parity"] = dict(logit_max_abs_err=errs,
                              streams_equal=parted is None,
                              first_divergence=parted, first_tie_flip=flip,
                              seconds=time.perf_counter() - t0)
    log(f"int8 parity fp32 full width, {INT8_PARITY_LAYERS} layers (W8A8 + "
        f"int8 KV): logits max|d| per "
        f"step {[f'{e:.2e}' for e in errs]}; streams "
        f"{'equal' if parted is None else f'part at {parted}'}; first int8 "
        f"value rounded differently: {flip}")
    return res


# ---------------------------------------------------------------------------
# Phases 8-10: the SSM families (Mamba-2, the Zamba-2 hybrid)
# ---------------------------------------------------------------------------

def ssm_engine(cfg, params, slots):
    """The SSM engine under the default policy, which resolves to the
    contiguous ``fused`` backend on the card for the SSD families."""
    from repro_torch.serving.engine import ServeConfig, ServingEngine

    eng = ServingEngine(cfg, params, ServeConfig(
        batch_slots=slots, max_len=SSM_MAX_LEN, cache_dtype=cfg.dtype,
        pack_weights=True, device="cuda"))
    if eng.attn.backend != "fused":
        fail(f"{cfg.name}: the default policy resolved to "
             f"{eng.attn.backend!r}, not 'fused'")
    return eng


def solo_stream(eng, prompt):
    h = eng.submit(prompt)
    out = [eng.step()[h] for _ in range(SSM_GEN)]
    eng.cancel(h)
    return out


def run_ssm_serving_phase(cfg, prompt_len, required, single_slot):
    """generate() of SSM_SLOTS prompts x SSM_GEN tokens at full width; with
    ``single_slot``, then the single-slot submit/step checks. Counters are
    reset before and read after the whole path."""
    from repro_torch.models import transformer as T

    params = T.init_model(cfg, seed=20, device="cuda")
    rng = np.random.default_rng(21)
    prompts = rng.integers(0, cfg.vocab, (SSM_SLOTS, prompt_len))
    eng = ssm_engine(cfg, params, SSM_SLOTS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    out = eng.generate(prompts, SSM_GEN)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    del eng
    if out.shape != (SSM_SLOTS, SSM_GEN) or out.min() < 0 \
            or out.max() >= cfg.vocab:
        fail(f"{cfg.name} generate: malformed output {out.shape}")
    res = dict(slots=SSM_SLOTS, prompt=prompt_len, tokens=SSM_GEN,
               generate_s=gen_s, generate_tokens_per_s=out.size / gen_s)
    if single_slot:
        first, second = (rng.integers(0, cfg.vocab, n).tolist()
                         for n in SOLO_PROMPTS)
        one = ssm_engine(cfg, params, 1)
        want = one.generate(np.asarray([first]), SSM_GEN)[0].tolist()
        got = solo_stream(one, first)
        if got != want:
            fail(f"{cfg.name}: the {len(first)}-token prompt's submit/step "
                 f"stream {got} differs from generate()'s {want}")
        recycled = solo_stream(one, second)
        del one
        fresh = solo_stream(ssm_engine(cfg, params, 1), second)
        if recycled != fresh:
            fail(f"{cfg.name}: the request on the recycled slot gave "
                 f"{recycled}, its solo run on a fresh engine {fresh}")
        res.update(solo_prompts=list(SOLO_PROMPTS), submit_equals_generate=True,
                   recycled_equals_fresh=True)
    torch.cuda.synchronize()
    launches = read_counts(f"{cfg.name} serving", required)
    if launches["paged_attention"] or launches["paged_attention_int8"]:
        fail(f"{cfg.name} serving: a paged kernel ran: {launches}")
    on_tc = sum(launches[f"ssd_scan_{r}"] for r in SSD_TC_ROUTES)
    if on_tc != launches["ssd_scan"]:
        fail(f"{cfg.name} serving: {launches['ssd_scan'] - on_tc} of "
             f"{launches['ssd_scan']} K6 launches were off the tensor-core "
             f"routes {SSD_TC_ROUTES}")
    res.update(launches=launches,
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
    log(f"{cfg.name} serving bf16: generate() {SSM_SLOTS}x{prompt_len} "
        f"prompts x {SSM_GEN} tokens in {gen_s:.3f} s "
        f"({res['generate_tokens_per_s']:.1f} tok/s)"
        + (f"; single-slot submit of {SOLO_PROMPTS[0]} tokens equals "
           f"generate(), the {SOLO_PROMPTS[1]}-token request on the recycled "
           f"slot equals its fresh solo run" if single_slot else "")
        + f"; launches {launches}; peak {res['peak_mem_gib']:.2f} GiB")
    return res


def ssm_greedy_run(cfg, params, device, prompts, n_steps, feed=None):
    """Prefill then ``n_steps`` decode steps over contiguous caches (fused
    policy). Each step is fed ``feed[:, i]`` when given (the same tokens on
    both devices), else its own argmax. Returns (argmax (B, n_steps + 1),
    the last-position logits of every step on the CPU)."""
    from repro_torch.core import api
    from repro_torch.core.plan import FUSED
    from repro_torch.models import transformer as T

    B, S = prompts.shape
    caches = T.init_caches(cfg, B, S + n_steps + 1, "float32", device)
    toks, logits_all = [], []
    with torch.no_grad(), api.use_attention_policy(FUSED):
        batch = {"tokens": torch.from_numpy(prompts).to(device),
                 "positions": torch.arange(S).expand(B, S).to(device)}
        logits, _, _ = T.forward(params, cfg, batch, caches=caches,
                              last_cols=torch.full((B,), S - 1, device=device))
        for i in range(n_steps + 1):
            lg = logits[:, -1].float().cpu()
            logits_all.append(lg)
            toks.append(lg.argmax(-1))
            if i == n_steps:
                break
            nxt = toks[-1] if feed is None else feed[:, i]
            batch = {"tokens": nxt[:, None].to(device),
                     "positions": torch.full((B, 1), S + i).to(device)}
            logits, _, _ = T.forward(params, cfg, batch, caches=caches)
    return torch.stack(toks, 1), logits_all


def run_ssm_parity_phase(cfg):
    """fp32, full width cut in depth: the card's kernels against the CPU's
    plain versions on the same seeded weights and tokens."""
    from repro_torch.core.api import pack_model_weights
    from repro_torch.models import transformer as T

    n_layers, S = SSM_PARITY[cfg.name]
    cfg32 = dataclasses.replace(cfg, dtype="float32", n_layers=n_layers)
    prompts = np.random.default_rng(22).integers(0, cfg.vocab, (2, S))
    t0 = time.perf_counter()
    params = pack_model_weights(T.init_model(cfg32, seed=23, device="cpu"))
    toks_c, lg_c = ssm_greedy_run(cfg32, params, "cpu", prompts,
                                  SSM_PARITY_STEPS)
    params = pack_model_weights(T.init_model(cfg32, seed=23, device="cuda"))
    toks_g, lg_g = ssm_greedy_run(cfg32, params, "cuda", prompts,
                                  SSM_PARITY_STEPS, feed=toks_c)
    del params
    errs, ties = [], []
    for i, (g, c) in enumerate(zip(lg_g, lg_c)):
        errs.append(float((g - c).abs().max()))
        if not np.isfinite(errs[-1]) or errs[-1] > LOGIT_TOL:
            fail(f"{cfg.name} parity fp32: step {i} logits max |card - plain| "
                 f"= {errs[-1]:.3e} > {LOGIT_TOL}")
        for b in range(g.shape[0]):
            if int(toks_g[b, i]) != int(toks_c[b, i]):
                top2 = c[b].topk(2).values
                margin = float(top2[0] - top2[1])
                if margin >= LOGIT_TOL:
                    fail(f"{cfg.name} parity fp32: greedy tokens differ at row "
                         f"{b} step {i} with plain top-2 margin {margin:.3e} "
                         f">= {LOGIT_TOL}")
                ties.append(dict(row=b, step=i, margin=margin))
    res = dict(layers=n_layers, prompt=S, steps=SSM_PARITY_STEPS,
               logit_max_abs_err=errs, streams_equal=not ties, near_ties=ties,
               seconds=time.perf_counter() - t0)
    log(f"{cfg.name} parity fp32, {n_layers} layers at full width, 2 x {S} "
        f"tokens + {SSM_PARITY_STEPS} steps: logits max|d| per step "
        f"{[f'{e:.2e}' for e in errs]}; greedy streams "
        f"{'equal' if not ties else f'equal but at near-ties {ties}'}")
    return res


# ---------------------------------------------------------------------------
# Phase 11: serving features (prefix cache, speculative decoding, the
# streaming frontend, observability)
# ---------------------------------------------------------------------------

def feature_engine(cfg, params, *, attn="paged", cache_pages=None, **kw):
    """8 slots, max_len 256, page 16, packed weights (``cfg`` at full
    width); ``kw`` adds the serving features. ``attn``: "paged", "fused",
    or "default" (the engine's own choice)."""
    from repro_torch.core.plan import FUSED, AttentionPolicy
    from repro_torch.serving.engine import ServeConfig, ServingEngine

    policy = {"fused": FUSED, "default": None}.get(
        attn, AttentionPolicy("paged", PAGE))
    return ServingEngine(cfg, params, ServeConfig(
        batch_slots=SLOTS, max_len=MAX_LEN, cache_dtype=cfg.dtype,
        pack_weights=True, attention=policy, cache_pages=cache_pages,
        device="cuda", **kw))


def serve_features(eng, prompts, limit_s, gen_len=GEN_LEN):
    """Drive submit/step until every prompt has ``gen_len`` tokens (a
    speculative burst past it is cut), cancelling each as it gets there.
    Returns (streams in prompt order, every token each request reported,
    tokens, seconds, host wall time of each decode-only step()), the last
    a step that prefilled nothing."""
    pending, owner, streams, reported = list(enumerate(prompts)), {}, {}, {}
    step_s, n_tokens = [], 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while pending or eng.slot_live.any() or eng.wait:
        while pending:
            h = eng.submit(pending[0][1])
            if h is None:
                break
            owner[h] = pending.pop(0)[0]
            streams[owner[h]], reported[owner[h]] = [], []
        pf = eng.prefill_tokens
        ts = time.perf_counter()
        out = eng.step()
        te = time.perf_counter() - ts
        if out and eng.prefill_tokens == pf:
            step_s.append(te)
        for h, t in out.items():
            burst = t if isinstance(t, list) else [t]
            s = streams[owner[h]]
            reported[owner[h]] += burst
            n_tokens += len(burst)
            s += burst[:gen_len - len(s)]
            if len(s) >= gen_len:
                eng.cancel(h)
        if time.perf_counter() - t0 > limit_s:
            fail(f"serving features: not done within {limit_s} s")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return ([streams.get(i, []) for i in range(len(prompts))],
            [reported.get(i, []) for i in range(len(prompts))],
            n_tokens, dt, step_s)


def page_rows(eng, page: int) -> dict:
    """One page's rows of every layer's pools (and int8 scales), stacked
    over layers: {name: (layers, ...)}, a copy."""
    return {n: torch.stack([c[n][page] for c in eng.caches])
            for n in ("kp", "vp", "k_scale", "v_scale") if n in eng.caches[0]}


def same_rows(a: dict, b: dict) -> bool:
    return all(torch.equal(a[n], b[n]) for n in a)


def watch_cow(eng, tag: str) -> dict:
    """Wrap the engine's COW copy and admission: a fork must equal its
    donor bitwise right after _copy_page (int8 scale rows included), and
    every page a borrower shares (its borrowed full pages and its fork's
    donor) must be bitwise unchanged after the borrower's tail prefill."""
    seen = {"forks_checked": 0, "shared_pages_checked": 0, "donor": None}
    copy, admit = eng._copy_page, eng._begin_admit

    def copy_page(src, dst):
        copy(src, dst)
        if not same_rows(page_rows(eng, src), page_rows(eng, dst)):
            fail(f"{tag}: fork {dst} differs from its donor {src} right "
                 f"after _copy_page")
        seen["forks_checked"] += 1
        seen["donor"] = src

    def begin_admit(slot, rid, prompt, tokens, *, start=0, **kw):
        shared = []
        if start:
            shared = list(eng.slot_tables[slot].pages[:start // PAGE])
            if seen["donor"] is not None:
                shared.append(seen["donor"])
        seen["donor"] = None
        before = {p: page_rows(eng, p) for p in shared}
        admit(slot, rid, prompt, tokens, start=start, **kw)
        for p, rows in before.items():
            if not same_rows(rows, page_rows(eng, p)):
                fail(f"{tag}: shared page {p} changed under a borrower's "
                     f"tail prefill from position {start}")
        seen["shared_pages_checked"] += len(shared)

    eng._copy_page, eng._begin_admit = copy_page, begin_admit
    return seen


def prefix_prompts(cfg, rng):
    """12 requests on one 48-token system prompt (3 full pages), each with
    a distinct 8-24-token suffix; two of them keep only 40 tokens of it,
    so they part inside the cached third page (COW forks)."""
    system = rng.integers(0, cfg.vocab, 48).tolist()
    out = []
    for i in range(N_REQUESTS):
        head = system[:40] if i in (5, 9) else system
        out.append(head + rng.integers(0, cfg.vocab,
                                       int(rng.integers(8, 25))).tolist())
    return out


def spec_prompts(cfg, rng, n=N_REQUESTS):
    """Prompts with repeated n-grams: a 6-token pattern four times, then a
    1-8-token tail (the traffic prompt-lookup drafting serves)."""
    out = []
    for _ in range(n):
        pat = rng.integers(0, cfg.vocab, 6).tolist()
        out.append(pat * 4 + rng.integers(0, cfg.vocab,
                                          int(rng.integers(1, 9))).tolist())
    return out


def decode_step_ms(step_s):
    return 1e3 * statistics.median(step_s) if step_s else None


def run_prefix_part(cfg, params, prompts, kv_dtype, obs=None):
    """Part (a) (and, with ``obs``, part (d)): the prefix-cache run under
    the 24-page pool with watermark eviction."""
    tag = f"prefix cache {kv_dtype or 'bf16'}" + (" obs" if obs else "")
    kw = dict(obs=obs) if obs is not None else {}
    eng = feature_engine(cfg, params, cache_pages=CACHE_PAGES,
                         prefix_cache=True, prefix_watermark=2,
                         kv_dtype=kv_dtype, **kw)
    seen = watch_cow(eng, tag) if obs is None else None
    reset_counts()
    streams, reported, n_tokens, dt, step_s = serve_features(eng, prompts,
                                                             300)
    required = K1_BF16 + (K4_BF16 if kv_dtype is None else K5_BF16)
    launches = read_counts(tag, required)
    check_streams(tag, streams, cfg.vocab)
    st = eng.stats()
    for key in ("prefix_hits", "prefix_cow_forks", "prefix_evictions"):
        if st[key] <= 0:
            fail(f"{tag}: {key} = {st[key]}, expected > 0")
    eng.pool.check()
    eng.prefix.check()
    if seen is not None and (seen["forks_checked"] < 1
                             or seen["shared_pages_checked"] < 1):
        fail(f"{tag}: no fork or shared page was checked: {seen}")
    res = dict(requests=N_REQUESTS, tokens=n_tokens, seconds=dt,
               tokens_per_s=n_tokens / dt, launches=launches, stats=st,
               decode_step_host_ms=decode_step_ms(step_s),
               decode_steps=len(step_s))
    if seen is not None:
        res.update(forks_checked=seen["forks_checked"],
                   shared_pages_checked=seen["shared_pages_checked"])
    log(f"{tag}: {N_REQUESTS} requests x {GEN_LEN} tokens, {n_tokens} tokens "
        f"in {dt:.3f} s ({n_tokens / dt:.1f} tok/s), decode step "
        f"{res['decode_step_host_ms']:.2f} ms host wall (median of "
        f"{len(step_s)}), hits {st['prefix_hits']} forks "
        f"{st['prefix_cow_forks']} evictions {st['prefix_evictions']} "
        f"preemptions {st['n_preemptions']}"
        + (f", forks equal their donors ({seen['forks_checked']}), shared "
           f"pages unchanged ({seen['shared_pages_checked']})" if seen else "")
        + f"; launches {launches}")
    return res, eng, streams, reported


def run_spec_part(cfg, params, prompts, name, *, attn="paged", k=SPEC_K,
                  kv_dtype=None, required=()):
    """Part (b): NGramDrafter(k) against the same engine without it."""
    from repro_torch.serving.spec_decode import NGramDrafter

    runs = {}
    for on in (False, True):
        eng = feature_engine(cfg, params, attn=attn, kv_dtype=kv_dtype,
                             spec=NGramDrafter(k=k) if on else None)
        reset_counts()
        streams, _, n_tokens, dt, step_s = serve_features(eng, prompts, 300)
        launches = read_counts(f"spec {name}", required if on else ())
        check_streams(f"spec {name}", streams, cfg.vocab)
        st = eng.stats()
        if on:
            if st["spec_accepted_tokens"] <= 0:
                fail(f"spec {name}: no draft was accepted: {st}")
            if eng.paged:
                if st["spec_rollback_pages"] <= 0:
                    fail(f"spec {name}: no page was rolled back: {st}")
                eng.pool.check()
                if eng.pool.free_pages != eng.pool.n_pages:
                    fail(f"spec {name}: {eng.pool.pages_in_use} pages still "
                         f"in use at the end")
        runs[on] = (n_tokens / dt, launches, decode_step_ms(step_s), st,
                    streams)
        del eng
    st = runs[True][3]
    # bf16 streams with and without speculation are counted, not gated: K1
    # takes one route at every M and K4's routes walk a row's keys alike,
    # but a verify's row still differs from a decode's where K3 or K4 split
    # a cache of 512 keys or more; the fp32 identity run below is the gate
    parted = [i for i, (a, b) in enumerate(zip(runs[False][4], runs[True][4]))
              if a != b]
    return dict(k=k, attention=attn, kv_dtype=kv_dtype,
                tokens_per_s=runs[True][0], tokens_per_s_no_spec=runs[False][0],
                step_host_ms=runs[True][2],
                step_host_ms_no_spec=runs[False][2], launches=runs[True][1],
                acceptance_rate=st["spec_acceptance_rate"],
                accepted=st["spec_accepted_tokens"],
                rejected=st["spec_rejected_tokens"],
                rollback_pages=st.get("spec_rollback_pages"),
                bf16_streams_parted=parted)


def run_features_phase(cfg):
    """Phase 11 on full-width smollm-135m, bf16 (paged, page 16, 8 slots),
    then the fp32 identity runs. Kernel counters are reset before each
    part's run and read after it."""
    from repro_torch.core.api import pack_model_weights
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import transformer as T
    from repro_torch.obs import (Observability, validate_metrics_snapshot,
                                 validate_trace)
    from repro_torch.serving.frontend import AsyncServingEngine
    from repro_torch.serving.spec_decode import (DraftModelDrafter,
                                                 NGramDrafter)

    res = {}
    params = T.init_model(cfg, seed=0, device="cuda")
    rng = np.random.default_rng(30)
    pprompts = prefix_prompts(cfg, rng)

    # (a) the prefix cache, bf16 then int8 KV
    res["prefix_bf16"], eng, _, _ = run_prefix_part(cfg, params, pprompts,
                                                    None)
    del eng
    res["prefix_int8_kv"], eng, _, _ = run_prefix_part(cfg, params, pprompts,
                                                       "int8")
    del eng

    # (b) speculative decoding, NGramDrafter on prompts with repeated n-grams
    sprompts = spec_prompts(cfg, rng)
    routes = {f"verify Sq {k + 1}": FA.route_for(torch.bfloat16, k + 1,
                                                 cfg.n_heads // cfg.n_kv_heads)
              for k in (SPEC_K, SPEC_K8)}
    if routes != {f"verify Sq {SPEC_K + 1}": "split",
                  f"verify Sq {SPEC_K8 + 1}": "rows"}:
        fail(f"spec: the verify shapes route {routes}")
    res["spec_routes"] = routes
    spec = {}
    spec["paged k4"] = run_spec_part(
        cfg, params, sprompts, "paged k4",
        required=K1_BF16 + ("paged_attention", "paged_attention_split",
                            "paged_attention_rows"))
    spec["paged k8"] = run_spec_part(
        cfg, params, sprompts, "paged k8", k=SPEC_K8,
        required=K1_BF16 + ("paged_attention", "paged_attention_rows"))
    spec["fused k4"] = run_spec_part(cfg, params, sprompts, "fused k4",
                                     attn="fused", required=K1_BF16 + K3_BF16)
    spec["int8 kv k4"] = run_spec_part(
        cfg, params, sprompts, "int8 kv k4", kv_dtype="int8",
        required=K1_BF16 + ("paged_attention_int8",
                            "paged_attention_int8_split",
                            "paged_attention_int8_rows"))
    for name, r in spec.items():
        log(f"spec {name}: {r['tokens_per_s']:.1f} tok/s with NGramDrafter("
            f"k={r['k']}), {r['tokens_per_s_no_spec']:.1f} without; "
            f"acceptance {r['acceptance_rate']:.3f} ({r['accepted']} "
            f"accepted, {r['rejected']} rejected, {r['rollback_pages']} "
            f"pages rolled back; bf16 streams parted from the non-spec "
            f"ones: {len(r['bf16_streams_parted'])} of {N_REQUESTS}); step "
            f"{r['step_host_ms']:.2f} ms host wall "
            f"({r['step_host_ms_no_spec']:.2f} without); launches "
            f"{r['launches']}")
    # a draft model: smollm-135m at full width drafting for itself
    drafter = DraftModelDrafter(
        cfg, params, k=3, max_len=MAX_LEN, device="cuda", pack_weights=True)
    eng = feature_engine(cfg, params, spec=drafter)
    reset_counts()
    streams, _, n_tokens, dt, _ = serve_features(eng, sprompts[:3], 300,
                                                 gen_len=16)
    dm_launches = read_counts("spec draft model", K1_BF16 + K4_BF16)
    check_streams("spec draft model", streams, cfg.vocab, gen_len=16)
    st = eng.stats()
    if st["spec_accepted_tokens"] <= 0:
        fail(f"spec draft model: no draft was accepted: {st}")
    spec["draft model k3"] = dict(
        requests=3, tokens=n_tokens, seconds=dt, tokens_per_s=n_tokens / dt,
        acceptance_rate=st["spec_acceptance_rate"],
        accepted=st["spec_accepted_tokens"],
        rejected=st["spec_rejected_tokens"], launches=dm_launches)
    log(f"spec draft model (smollm-135m drafting for itself, k=3): "
        f"acceptance rate {st['spec_acceptance_rate']:.3f} "
        f"({st['spec_accepted_tokens']} accepted, "
        f"{st['spec_rejected_tokens']} rejected), {n_tokens / dt:.1f} tok/s")
    del eng, drafter
    res["spec"] = spec

    # (c) the streaming frontend: more concurrent streams than slots
    eng = feature_engine(cfg, params, cache_pages=CACHE_PAGES)
    aeng = AsyncServingEngine(eng)
    fprompts = [rng.integers(0, cfg.vocab, int(n)).tolist()
                for n in rng.integers(16, PROMPT_BUCKET + 1, N_REQUESTS)]

    async def streams_all():
        return await asyncio.gather(*(aeng.complete(p, GEN_LEN,
                                                    priority=i % 2)
                                      for i, p in enumerate(fprompts)))

    reset_counts()
    t0 = time.perf_counter()
    outs = asyncio.run(streams_all())
    dt = time.perf_counter() - t0
    launches = read_counts("frontend", K1_BF16 + K4_BF16)
    check_streams("frontend", outs, cfg.vocab)
    if aeng.in_flight or eng.pool.free_pages != eng.pool.n_pages:
        fail(f"frontend: {aeng.in_flight} in flight, "
             f"{eng.pool.pages_in_use} pages in use at the end")
    slo = aeng.slo_report()
    res["frontend"] = dict(streams=N_REQUESTS, tokens=sum(map(len, outs)),
                           seconds=dt, slo=slo, launches=launches,
                           preemptions=eng.n_preemptions)
    log(f"frontend: {N_REQUESTS} concurrent streams over {SLOTS} slots, "
        f"{sum(map(len, outs))} tokens in {dt:.3f} s, "
        f"{eng.n_preemptions} preemptions; TTFT {slo['ttft_s']} s, ITL "
        f"{slo['itl_s']} s; launches {launches}")
    del eng, aeng

    # (d) observability: (a)'s bf16 run again with Observability()
    obs = Observability()
    r, eng, streams, reported = run_prefix_part(cfg, params, pprompts, None,
                                                obs=obs)
    doc = obs.trace.export()
    problems = validate_trace(doc)
    snap = obs.metrics.snapshot()
    problems += validate_metrics_snapshot(snap)
    if problems:
        fail(f"observability: {problems[:5]}")
    (OUT_DIR / "phase11_trace.json").write_text(json.dumps(doc))
    preempted = 0
    for rid in range(N_REQUESTS):    # request ids follow submission order
        rt = eng.request_trace(rid)
        if rt is None or rt.tokens != reported[rid]:
            fail(f"observability: request {rid}'s trace holds "
                 f"{None if rt is None else len(rt.tokens)} tokens, its "
                 f"stream {len(reported[rid])}")
        preempted += rt.n_preemptions
    if preempted < 1:
        fail("observability: no traced request was preempted")
    base_ms = res["prefix_bf16"]["decode_step_host_ms"]
    r.update(trace_events=len(doc["traceEvents"]),
             preempted_requests_traced=preempted,
             decode_step_host_ms_null_obs=base_ms)
    res["obs"] = r
    log(f"observability: trace of {len(doc['traceEvents'])} events and "
        f"metrics snapshot valid; every request trace holds exactly its "
        f"stream ({preempted} preemptions traced); decode step host wall "
        f"{r['decode_step_host_ms']:.2f} ms with obs, {base_ms:.2f} ms with "
        f"NULL_OBS")
    del eng

    # fp32 identity: prefix on = off, spec = no spec, at full width
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = T.init_model(cfg32, seed=31, device="cuda")
    params_cpu = pack_model_weights(T.init_model(cfg32, seed=31,
                                                 device="cpu"))
    t0 = time.perf_counter()
    ident = {}
    for name, prompts, on in (
            ("prefix", pprompts[:8], dict(prefix_cache=True)),
            ("spec k4", sprompts[:8], dict(spec=NGramDrafter(k=SPEC_K)))):
        off_eng = feature_engine(cfg32, params32)
        off = serve_features(off_eng, prompts, 600, gen_len=16)[0]
        del off_eng
        on_eng = feature_engine(cfg32, params32, **on)
        got = serve_features(on_eng, prompts, 600, gen_len=16)[0]
        stats = on_eng.stats()
        del on_eng
        ties = {}
        for i, p in enumerate(prompts):
            d = first_divergence(cfg32, params_cpu, p, off[i], got[i],
                                 label=f"{name} fp32 identity")
            if d is not None:
                ties[i] = d
        ident[name] = dict(requests=len(prompts), equal=not ties,
                           near_ties=ties,
                           **{k: v for k, v in stats.items()
                              if k.startswith(("prefix_hit", "spec_acc"))})
        log(f"{name} fp32 full width: streams of {len(prompts)} requests "
            f"{'equal' if not ties else f'equal up to near-ties {ties}'} "
            f"with the feature off")
    ident["seconds"] = time.perf_counter() - t0
    res["fp32_identity"] = ident
    return res


# ---------------------------------------------------------------------------
# Phase 12: bf16 greedy streams that depend neither on preemption nor on a
# prefix-cache hit
# ---------------------------------------------------------------------------

# The models phase 12 runs on: the paged path's smollm-135m, and qwen2-1.5b
# (phase 13), each cut to its first IDENTITY_LAYERS layers at full width
# for the run's time (a row's bits do not depend on the depth).
IDENTITY_ARCHS = ("smollm-135m", "qwen2-1.5b")
IDENTITY_LAYERS = 2


def solo_streams(cfg, params, prompts, rids, kv_dtype):
    """The streams of ``prompts[rid]`` for each of ``rids``, each served
    alone on one engine whose pool never runs dry."""
    eng = feature_engine(cfg, params, kv_dtype=kv_dtype)
    out = {}
    for rid in rids:
        h = eng.submit(prompts[rid])
        out[rid] = [eng.step()[h] for _ in range(GEN_LEN)]
        eng.cancel(h)
    return out


def run_identity_phase(cfg, params):
    """The first IDENTITY_LAYERS layers of ``cfg`` and ``params``, bf16,
    paged (page 16), 8 slots, fp pools and int8 KV: (a) 12
    requests under the 24-page pool, each preempted request's stream
    against its solo stream; (b) phase 11's 12 requests on one 48-token
    system prompt with the prefix cache on (the same 24-page pool,
    watermark 2) against the prefix cache off. Counts the streams that
    part; any part fails the phase (after every count is logged)."""
    if cfg.n_layers > IDENTITY_LAYERS:
        cfg = dataclasses.replace(cfg, n_layers=IDENTITY_LAYERS)
        params = dict(params, layers=params["layers"][:IDENTITY_LAYERS])
    res, parted = {}, 0
    for kv_dtype in (None, "int8"):
        tag = f"identity {cfg.name} {kv_dtype or 'bf16'} KV"
        rng = np.random.default_rng(21)
        prompts = [rng.integers(0, cfg.vocab, int(n)).tolist()
                   for n in rng.integers(16, PROMPT_BUCKET + 1, N_REQUESTS)]
        eng = feature_engine(cfg, params, cache_pages=CACHE_PAGES,
                             kv_dtype=kv_dtype)
        preempted = set()
        preempt = eng._preempt
        eng._preempt = lambda slot, e=eng, f=preempt: (
            preempted.add(int(e.slot_rid[slot])), f(slot))[1]
        t0 = time.perf_counter()
        reset_counts()
        streams = serve_requests(eng, prompts, 600)[0]
        launches = read_counts(tag, K1_BF16 + (
            K4_BF16 if kv_dtype is None else K5_BF16))
        check_streams(tag, streams, cfg.vocab)
        del eng
        if not preempted:
            fail(f"{tag}: the pool never ran dry (no preemption)")
        # request ids follow submission order, which is prompt order
        solo = solo_streams(cfg, params, prompts, sorted(preempted), kv_dtype)
        pre_parted = [r for r in sorted(preempted) if solo[r] != streams[r]]
        pprompts = prefix_prompts(cfg, np.random.default_rng(22))
        on_eng = feature_engine(cfg, params, cache_pages=CACHE_PAGES,
                                prefix_cache=True, prefix_watermark=2,
                                kv_dtype=kv_dtype)
        on = serve_features(on_eng, pprompts, 600)[0]
        hits = on_eng.stats()["prefix_hits"]
        del on_eng
        off_eng = feature_engine(cfg, params, kv_dtype=kv_dtype)
        off = serve_features(off_eng, pprompts, 600)[0]
        del off_eng
        if hits < 1:
            fail(f"{tag}: the prefix cache was never hit")
        fix_parted = [i for i in range(N_REQUESTS) if on[i] != off[i]]
        parted += len(pre_parted) + len(fix_parted)
        res[kv_dtype or "bf16"] = dict(
            preempted=sorted(preempted), preempted_parted=pre_parted,
            prefix_hits=hits, prefix_parted=fix_parted, launches=launches,
            seconds=time.perf_counter() - t0)
        log(f"{tag} ({cfg.n_layers} layers): {len(pre_parted)} of "
            f"{len(preempted)} preempted "
            f"requests part from their solo streams {pre_parted}; "
            f"{len(fix_parted)} of {N_REQUESTS} prefix-on streams part from "
            f"prefix-off {fix_parted} ({hits} hits); launches {launches}")
    if parted:
        fail(f"identity {cfg.name}: {parted} bf16 streams part: {res}")
    return res


# ---------------------------------------------------------------------------
# Phases 13-15: the rest of the dense family at full width
# ---------------------------------------------------------------------------

# arch: (layers served, None for the published depth — cut for the run's
# time: 2 of 28, 2 of 36, 2 of 52; layers of the fp32 card-vs-CPU
# parity; the int8 run: None, "kv" (int8 KV pages) or "w8a8" (W8A8
# weights and int8 KV pages))
DENSE_MODELS = {"qwen2-1.5b": (2, 2, "w8a8"),
                "qwen3-8b": (2, 1, None),
                "granite-20b": (2, 1, "kv")}


def serve_dense(tag, cfg, params, required, **kw):
    """12 requests x GEN_LEN tokens through submit/step on one engine
    (feature_engine: 8 slots, max_len 256, page 16, and ``kw``), every
    request complete and ``required`` launched, preemption engaged under a
    paged pool of CACHE_PAGES; then generate() of one 16-token prompt a
    slot, whose 48-token horizons fill that pool exactly."""
    eng = feature_engine(cfg, params, **kw)
    rng = np.random.default_rng(41)
    prompts = [rng.integers(0, cfg.vocab, int(n)).tolist()
               for n in rng.integers(16, PROMPT_BUCKET + 1, N_REQUESTS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    streams, n_tokens, per_step = serve_requests(eng, prompts, 600)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_counts(tag, required)
    check_streams(tag, streams, cfg.vocab)
    if kw.get("cache_pages") and eng.n_preemptions < 1:
        fail(f"{tag}: the pool never ran dry (no preemption)")
    t1 = time.perf_counter()
    out = eng.generate(rng.integers(0, cfg.vocab, (SLOTS, 16)), GEN_LEN)
    gen_s = time.perf_counter() - t1
    if out.shape != (SLOTS, GEN_LEN) or out.min() < 0 \
            or out.max() >= cfg.vocab:
        fail(f"{tag}: generate() gave malformed output {out.shape}")
    res = dict(requests=N_REQUESTS, tokens=n_tokens, seconds=dt,
               tokens_per_s=n_tokens / dt,
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
               preemptions=eng.n_preemptions, launches=launches,
               launches_per_decode_step=per_step,
               generate_tokens_per_s=SLOTS * GEN_LEN / gen_s)
    log(f"{tag}: {N_REQUESTS} requests x {GEN_LEN} tokens, {n_tokens} tokens "
        f"in {dt:.3f} s ({res['tokens_per_s']:.1f} tok/s), peak "
        f"{res['peak_mem_gib']:.2f} GiB, {eng.n_preemptions} preemptions, "
        f"per decode step {per_step}; generate() {SLOTS}x{GEN_LEN} tokens in "
        f"{gen_s:.3f} s")
    return res


def run_dense_phase(arch, layers, parity_layers, int8):
    """One dense decoder (or dbrx's MoE) at full width in bf16 (weights
    drawn on the card from a seed), at ``layers`` (None: the published
    depth): paged serving with preemption (K1 wgmma, K4 on both routes),
    contiguous serving (K3 on both), with ``int8`` int8 KV (K5 on both;
    "w8a8" also W8A8 weights, K2 on both), and for qwen2-1.5b phase 12's
    stream identity; then fp32 at ``parity_layers``, the card against the
    CPU plain path (phase 4)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer as T

    full = get_config(arch)
    cfg = full if layers is None else dataclasses.replace(full,
                                                          n_layers=layers)
    t0 = time.perf_counter()
    params = T.init_model(cfg, seed=0, device="cuda", draw_device="cuda")
    res = dict(layers=cfg.n_layers, published_layers=full.n_layers,
               init_s=time.perf_counter() - t0)
    log(f"{arch}: {cfg.n_layers} of {full.n_layers} layers at full width, "
        f"bf16 weights drawn on the card in {res['init_s']:.1f} s")
    res["paged"] = serve_dense(f"{arch} paged serving", cfg, params,
                               K1_BF16 + K4_BF16, cache_pages=CACHE_PAGES)
    res["contiguous"] = serve_dense(f"{arch} contiguous serving", cfg, params,
                                    K1_BF16 + K3_BF16, attn="fused")
    w8a8 = int8 == "w8a8"
    if int8:
        res["int8"] = serve_dense(
            f"{arch} int8 serving", cfg, params,
            K5_BF16 + (K2_BF16 if w8a8 else K1_BF16), cache_pages=CACHE_PAGES,
            kv_dtype="int8", weight_dtype="int8" if w8a8 else None)
    if w8a8 and res["int8"]["launches"]["matrixflow_gemm"]:
        fail(f"{arch} int8 serving: K1 ran beside the W8A8 GEMM")
    if arch in IDENTITY_ARCHS:
        res["identity"] = run_identity_phase(cfg, params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    res["parity"] = run_parity_phase(
        dataclasses.replace(full, n_layers=parity_layers), f"{arch} parity",
        steps=ZOO_PARITY_STEPS if arch in ZOO_MODELS else PARITY_STEPS)
    return res


# ---------------------------------------------------------------------------
# Phases 16-19: the model zoo's last four at full width
# ---------------------------------------------------------------------------

VLM, AUDIO, DBRX, DEEPSEEK = ("internvl2-76b", "musicgen-medium", "dbrx-132b",
                              "deepseek-v2-236b")
# arch: (layers on the card, None for the published depth; layers of the
# fp32 card-vs-CPU parity). deepseek's count includes its leading dense
# layer: 1 + 2 MoE layers on the card, 1 + 1 in parity.
ZOO_MODELS = {VLM: (2, 1), AUDIO: (4, 2), DBRX: (2, 1), DEEPSEEK: (3, 2)}
VLM_TEXT, VLM_STEPS = 64, 8
AUDIO_PROMPT, AUDIO_STEPS = 64, 32


def zoo_config(arch):
    from repro_torch.configs.registry import get_config
    full = get_config(arch)
    layers = ZOO_MODELS[arch][0]
    return full if layers is None else dataclasses.replace(full,
                                                           n_layers=layers)


def pack_in_place(params):
    """Every GEMM weight packed as the engine packs it, one top-level entry
    or layer at a time, so the raw and packed copies of a model are never
    both resident (an engine given packed weights keeps them)."""
    from repro_torch.core.api import pack_model_weights
    for k in list(params):
        if k == "layers":
            for i, lp in enumerate(params[k]):
                params[k][i] = pack_model_weights(lp)
        else:
            params[k] = pack_model_weights({k: params[k]})[k]
    gc.collect()
    torch.cuda.empty_cache()
    return params


def zoo_params(cfg):
    from repro_torch.models import transformer as T
    t0 = time.perf_counter()
    params = T.init_model(cfg, seed=0, device="cuda", draw_device="cuda")
    torch.cuda.synchronize()
    gib = sum(t.numel() * t.element_size() for t in tree_tensors(params)) \
        / 2**30
    full = ZOO_MODELS[cfg.name][0]
    log(f"{cfg.name}: {cfg.n_layers} layers at full width"
        + (" (the published depth)" if full is None else "")
        + f", {gib:.1f} GiB of bf16 weights drawn on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    return params, gib


def zoo_forward_run(tag, cfg, params, batch, n_steps, paged, required):
    """One greedy_run in bf16 on the card, counted: every kernel of
    ``required`` launched, none off the tensor-core routes, tokens in
    range and logits finite."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    toks, lgs, dec_s = greedy_run(cfg, params, "cuda", batch, n_steps, paged)
    torch.cuda.synchronize()
    launches = read_counts(tag, required)
    if not all(bool(torch.isfinite(lg).all()) for lg in lgs):
        fail(f"{tag}: logits are not finite")
    if toks.min() < 0 or toks.max() >= cfg.vocab:
        fail(f"{tag}: tokens out of range")
    B = toks.shape[0]
    res = dict(batch=B, steps=n_steps, decode_seconds=dec_s,
               tokens_per_s=B * n_steps / dec_s,
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
               launches=launches, first_tokens=toks[:, :4].tolist())
    log(f"{tag}: prefill + {n_steps} greedy steps of {B} rows, "
        f"{res['tokens_per_s']:.1f} steps x rows / s, peak "
        f"{res['peak_mem_gib']:.2f} GiB, launches {launches}")
    return res


def run_vlm_phase():
    """internvl2-76b (phase 16): paged serving with preemption (K4, group
    8), contiguous serving (K3); the VLM forward over B 2 x (256 image
    embeddings ⊕ 64 text tokens) without a cache (K3 rows), then the same
    prompt prefilled into contiguous caches and VLM_STEPS greedy steps; fp32
    parity at 1 layer with the image prefix."""
    from repro_torch.models import transformer as T
    cfg = zoo_config(VLM)
    params, gib = zoo_params(cfg)
    pack_in_place(params)            # 32 GB: the packed copy replaces it
    res = dict(layers=cfg.n_layers, weights_gib=gib)
    res["paged"] = serve_dense(f"{VLM} paged serving", cfg, params,
                               K1_BF16 + K4_BF16, cache_pages=CACHE_PAGES)
    res["contiguous"] = serve_dense(f"{VLM} contiguous serving", cfg, params,
                                    K1_BF16 + K3_BF16, attn="fused")
    batch = greedy_batch(cfg, np.random.default_rng(51), 2, VLM_TEXT)
    tag = f"{VLM} vlm forward"
    reset_counts()
    with torch.no_grad():
        logits, _, _ = T.forward(params, cfg, {
            k: torch.from_numpy(v).cuda() for k, v in batch.items()})
    torch.cuda.synchronize()
    launches = read_counts(tag, K1_BF16 + ("flash_attention",
                                           "flash_attention_rows"))
    S = N_IMAGE_TOKENS + VLM_TEXT
    if tuple(logits.shape) != (2, S, cfg.vocab) \
            or not bool(torch.isfinite(logits.float()).all()):
        fail(f"{tag}: logits {tuple(logits.shape)} not finite or not "
             f"(2, {S}, {cfg.vocab})")
    del logits
    res["vlm_forward"] = dict(columns=S, launches=launches)
    log(f"{tag}: B 2 x ({N_IMAGE_TOKENS} image embeddings + {VLM_TEXT} "
        f"tokens), logits finite, launches {launches}")
    res["vlm_decode"] = zoo_forward_run(
        f"{VLM} vlm prefill + decode", cfg, params, batch, VLM_STEPS, False,
        K1_BF16 + K3_BF16)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    res["parity"] = run_parity_phase(
        dataclasses.replace(cfg, n_layers=ZOO_MODELS[VLM][1]),
        f"{VLM} parity", paged=True, steps=ZOO_PARITY_STEPS)
    return res


def run_audio_phase():
    """musicgen-medium (phase 17), 4 of its 48 layers: prefill 8 x 64
    frames of 4 codebooks, then AUDIO_STEPS greedy steps (argmax per
    codebook) through forward over contiguous caches (K3) and over paged
    caches through a shuffled block table (K4); fp32 parity at 2 layers."""
    cfg = zoo_config(AUDIO)
    params, gib = zoo_params(cfg)
    pack_in_place(params)
    res = dict(layers=cfg.n_layers, weights_gib=gib)
    batch = greedy_batch(cfg, np.random.default_rng(52), SLOTS, AUDIO_PROMPT)
    for paged, kernels in ((False, K3_BF16), (True, K4_BF16)):
        kind = "paged" if paged else "contiguous"
        res[kind] = zoo_forward_run(f"{AUDIO} {kind} forward", cfg, params,
                                    batch, AUDIO_STEPS, paged,
                                    K1_BF16 + kernels)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    res["parity"] = run_parity_phase(
        dataclasses.replace(cfg, n_layers=ZOO_MODELS[AUDIO][1]),
        f"{AUDIO} parity", paged=True, steps=ZOO_PARITY_STEPS)
    return res


def run_mla_phase():
    """deepseek-v2-236b (phase 19): its leading dense layer and 2 MoE
    layers, contiguous serving (the only cache MLA takes) under the
    engine's default policy (fused on the card): K3 at (192, 128) on split
    at decode and rows at prefill, K1 on wgmma; then generate(); fp32
    parity at the dense layer + 1 MoE layer."""
    cfg = zoo_config(DEEPSEEK)
    params, gib = zoo_params(cfg)
    res = dict(layers=cfg.n_layers, weights_gib=gib)
    res["contiguous"] = serve_dense(f"{DEEPSEEK} contiguous serving", cfg,
                                    params, K1_BF16 + K3_BF16,
                                    attn="default")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    res["parity"] = run_parity_phase(
        dataclasses.replace(cfg, n_layers=ZOO_MODELS[DEEPSEEK][1]),
        f"{DEEPSEEK} parity", paged=False, steps=ZOO_PARITY_STEPS)
    return res


def run_zoo_phases(archs=ZOO_MODELS):
    """Phases 16-19 (or those of ``archs``), each model's weights freed
    before the next."""
    phases = {VLM: run_vlm_phase, AUDIO: run_audio_phase,
              DBRX: lambda: run_dense_phase(DBRX, *ZOO_MODELS[DBRX], "w8a8"),
              DEEPSEEK: run_mla_phase}
    return {a: phases[a]() for a in archs}


# ---------------------------------------------------------------------------
# Phases 20-22: training on K1 (its batch grid and its backward), the fp32
# train step against the CPU, mixed cache and model dtypes
# ---------------------------------------------------------------------------

TRAIN_BATCH, TRAIN_SEQ = 8, 128       # B 8 x 128 tokens from TokenPipeline
# The pipeline's copy stream over the first 512 token ids: over all
# 49,152 a token shows up ~0.4 times in 20 steps and the loss stays at
# ln V (10.81 -> 10.95 on an H100; the same on the CPU at smoke width,
# where 512 ids fall 10.86 -> 8.57). The model keeps its full vocabulary.
TRAIN_DATA_VOCAB = 512
TRAIN_STEPS, TRAIN_CKPT = 4, 2        # a checkpoint at step 2, resumed
TRAIN_LR, TRAIN_WARMUP = 3e-3, 5
TRAIN_FP32_LAYERS, TRAIN_FP32_BATCH = 2, 4
# AdamW's first step moves a weight by lr x g / (|g| + eps), about lr
# wherever |g| >> eps: the params after the card's step must stay within
# TRAIN_FP32_PARAM_TOL (half of lr) of the CPU's, so a step that applied
# no update, or the wrong one, fails. An H100 measured 1.18e-5.
TRAIN_FP32_LR = 1e-4
TRAIN_FP32_PARAM_TOL = 5e-5
MIXED_PARITY_LAYERS = 2
# Resumed at step 5, the losses of steps 5-9 must equal the
# uninterrupted run's bitwise: a step on an H100 repeats bitwise (the
# phase checks that too), so any gap means a lost data cursor, Adam moment
# or schedule step.
# The unfused attention's products at S tokens and head_dim dh, one
# batched K1 launch each over the B x heads problems (forward: scores,
# values; backward: the four products of their gradients); smollm-135m's
# are S 128, dh 64 at B 8 x 9 heads. (name, M, K, N, out in bf16)
def train_batch_cells(S, dh):
    return (("scores q.kT", S, dh, S, "float32"),
            ("values p.v", S, S, dh, "bfloat16"),
            ("dq = ds.k / dv = pT.do", S, S, dh, "bfloat16"),
            ("dk = qT.ds", dh, S, S, "bfloat16"),
            ("dp = do.vT", S, dh, S, "bfloat16"))


K1_TRAIN = ("matrixflow_gemm", "matrixflow_gemm_wgmma",
            "matrixflow_gemm_batched", "matrixflow_gemm_backward")
FORWARD_ONLY = ("matrixflow_gemm_dequant", "flash_attention",
                "paged_attention", "paged_attention_int8", "ssd_scan")


def train_projection_cells(cfg):
    """(name, K, N, forward out) of every K1 product of a dense layer and
    the head (out None: the operands' dtype)."""
    d, H, Hkv, dh, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                        cfg.head_dim, cfg.d_ff)
    return (("q", d, H * dh, None), ("k/v", d, Hkv * dh, None),
            ("o", H * dh, d, None), ("mlp in", d, 2 * f, None),
            ("mlp out", f, d, None), ("head", d, cfg.vocab, None))


def run_train_kernel_phase(timer, cfg, *, M=TRAIN_BATCH * TRAIN_SEQ,
                           problems=None, seq=TRAIN_SEQ,
                           projections=None, dtypes=("bfloat16",),
                           path=lambda direction: f"train {direction}",
                           tag="", seed=20):
    """K1 at a training step's shapes (default smollm-135m's, bf16): every
    projection's forward (C = A.W), its two backward products (dA = dC.Wt,
    dW = At.dC, each laid out block-major as its own problem), and the
    batch grid at the unfused attention's products (``problems`` a
    launch, default TRAIN_BATCH x the heads; ``seq`` tokens). Each against its plain version
    within GEMM_TOLS on the route its dtype takes (bf16: wgmma; fp32: the
    CUDA cores), timed with the plain version, one PyTorch call
    (torch.matmul; torch.bmm for a batch) and the bound. ``projections``
    (default :func:`train_projection_cells`) give (name, K, N, forward
    out); ``path`` names a cell's path from its direction ("forward",
    "backward", "batch grid forward", "batch grid backward"). ``uses``
    per step: each block's forward runs twice under remat, its backward
    once."""
    from repro_torch.core import layout as L
    from repro_torch.core.plan import GemmPolicy, plan
    from repro_torch.kernels import matrixflow_gemm as MF

    rows = []
    gen = torch.Generator(device="cuda").manual_seed(seed)
    L_ = cfg.n_layers
    pol = GemmPolicy()
    projections = projections or train_projection_cells(cfg)
    problems = problems or TRAIN_BATCH * cfg.n_heads

    def cell(name, a, b, out_dt, direction, uses, batched=False):
        dt = a.dtype
        Mx, Kx = a.shape[-2:]
        Nx = b.shape[-1]
        blk = plan(Mx, Nx, Kx, dt, pol, "cuda").layout
        a_bm = L.to_block_major_a(a, blk.bm, blk.bk)
        b_bm = L.to_block_major_b(b, blk.bk, blk.bn)
        before = counts()
        got = MF.matrixflow_gemm_block_major(a_bm, b_bm, out_dtype=out_dt)
        after = counts()
        want = MF.plain(a_bm, b_bm, out_dtype=out_dt)
        torch.cuda.synchronize()
        G = a.shape[0] if batched else 1
        dtype = str(dt)[6:]
        short = "bf16" if dt == torch.bfloat16 else "fp32"
        label = (f"matrixflow_gemm {tag}{name} "
                 + (f"G={G} " if batched else "")
                 + f"M={Mx} K={Kx} N={Nx} {short}->{str(out_dt)[6:]}")
        route = route_taken(before, after, "matrixflow_gemm",
                            ("wgmma", "mma", "cuda_core"))
        expect = "wgmma" if dt == torch.bfloat16 else "cuda_core"
        if route != expect or (after["matrixflow_gemm_batched"]
                               - before["matrixflow_gemm_batched"]) != batched:
            fail(f"{label}: route {route} (expected {expect}), batched "
                 f"launches {after['matrixflow_gemm_batched']}")
        atol, rtol = GEMM_TOLS[dtype]
        err = check_close(label, got, want, atol, rtol)
        del got, want
        t_k = timer.ms(lambda: MF.matrixflow_gemm_block_major(
            a_bm, b_bm, out_dtype=out_dt))
        t_p = timer.ms(lambda: MF.plain(a_bm, b_bm, out_dtype=out_dt))
        lib = torch.bmm if batched else torch.matmul
        t_lib = timer.ms(lambda: lib(a, b))
        b_ms, b_by = bound_ms("matrixflow_gemm", route, M=Mx, N=Nx, K=Kx,
                              dtype=dt, out_dtype=out_dt, G=G)
        rows.append(dict(cell=label, dtype=dtype, M=Mx, K=Kx, N=Nx,
                         G=G, block=[blk.bm, blk.bn, blk.bk], route=route,
                         path=path(direction), uses=uses, max_abs_err=err,
                         ms=t_k, plain_ms=t_p, library_ms=t_lib,
                         bound_ms=b_ms, bound_by=b_by))
        log(f"{label}: blocks {blk.bm}x{blk.bn}x{blk.bk} max|d|={err:.2e} "
            f"kernel {t_k:.4f} ms plain {t_p:.4f} ms "
            f"{'bmm' if batched else 'matmul'} {t_lib:.4f} ms bound "
            f"{b_ms:.4f} ms ({b_by})")

    for dtype in dtypes:
        dt = getattr(torch, dtype)
        for name, K, N, fwd_out in projections:
            head = name == "head"
            a = (torch.randn((M, K), generator=gen, device="cuda")).to(dt)
            w = (torch.randn((K, N), generator=gen, device="cuda")
                 / K ** 0.5).to(dt)
            dc = (torch.randn((M, N), generator=gen, device="cuda")
                  / N ** 0.5).to(dt)
            fwd_uses = (1 if head else 2 * L_) * (2 if name == "k/v" else 1)
            bwd_uses = (1 if head else L_) * (2 if name == "k/v" else 1)
            cell(f"{name} forward", a, w, getattr(torch, fwd_out or dtype),
                 "forward", fwd_uses)
            cell(f"{name} dA", dc, w.t(), dt, "backward", bwd_uses)
            cell(f"{name} dW", a.t(), dc, dt, "backward", bwd_uses)
            del a, w, dc
            torch.cuda.empty_cache()
        for i, (name, Mx, Kx, Nx, out) in enumerate(
                train_batch_cells(seq, cfg.head_dim)):
            a = torch.randn((problems, Mx, Kx), generator=gen,
                            device="cuda").to(dt)
            b = torch.randn((problems, Kx, Nx), generator=gen,
                            device="cuda").to(dt)
            # forward: 2 L launches a step (remat); backward: each forward
            # product's two gradients, L launches each
            direction = "batch grid forward" if i < 2 else \
                "batch grid backward"
            uses = 2 * L_ if i < 2 else (2 * L_ if i == 2 else L_)
            cell(name, a, b, dt if dt == torch.float32 else getattr(torch, out),
                 direction, uses, batched=True)
    return rows


def run_mixed_kernel_phase(timer, cfg):
    """The new instances of K3 and K4: fp32 q over bf16 K/V (an fp32 model
    serving from a bf16 cache) at smollm-135m's decode step and prefill
    bucket, contiguous (K3) and paged (K4); against the plain version,
    timed with it, SDPA over fp32 copies of the visible K/V, and the bound
    (fp32 q and output, bf16 K/V, fp32 operations on the CUDA cores)."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import paged_attention as PA

    sdpa = torch.nn.functional.scaled_dot_product_attention
    rng = np.random.default_rng(21)
    gen = torch.Generator(device="cuda").manual_seed(21)
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    nb = MAX_LEN // PAGE
    rows = []
    # one operand of P.V is bf16 (p rounded as p.astype(v.dtype)), and a p
    # on a rounding boundary may take the other bf16 neighbour on either
    # side: bf16's tolerance for every element, and all but 1% of them
    # within fp32's, as scores and sums are fp32 (tests/test_torch_cuda.py
    # ::_mixed_close)
    atol, rtol = ATTN_TOLS["bfloat16"]
    atol32, rtol32 = ATTN_TOLS["float32"]
    for name, Sq, path in (("decode", 1, "decode step"),
                           ("prefill", PROMPT_BUCKET, "prefill")):
        lens = (rng.integers(17, MAX_LEN, SLOTS) if Sq == 1 else
                rng.integers(16, PROMPT_BUCKET + 1, SLOTS)).tolist()
        starts = [n - 1 for n in lens] if Sq == 1 else [0] * SLOTS
        q, kp, vp, bt, dead_bt, qpos, kvl = paged_case(
            gen, torch.bfloat16, B=SLOTS, Sq=Sq, lens=lens, q_start=starts,
            H=H, Hkv=Hkv, D=D, ps=PAGE, nb=nb)
        q = q.float()
        kd, vd = PA.gather_pages(kp, bt), PA.gather_pages(vp, bt)
        scale = D ** -0.5
        for kern, fn, plain in (
                ("flash_attention",
                 lambda: FA.flash_attention(q, kd, vd, qpos, kvl),
                 lambda: FA.flash_attention_plain(
                     q, kd, vd, qpos, kvl, causal=True, scale=scale,
                     soft_cap=None)),
                ("paged_attention",
                 lambda: PA.paged_attention(q, kp, vp, dead_bt, qpos, kvl),
                 lambda: PA.paged_attention_plain(
                     q, kp, vp, bt, qpos, kvl, causal=True, scale=scale,
                     soft_cap=None))):
            before = counts()
            got, again = fn(), fn()
            route = route_taken(before, counts(), kern, MIXED_ROUTES)
            want = plain()
            torch.cuda.synchronize()
            label = (f"{kern} fp32 q / bf16 KV {name} B={SLOTS} Sq={Sq} H={H} "
                     f"Hkv={Hkv} D={D}")
            if route != "cuda_cores_bf16kv" or got.dtype != torch.float32:
                fail(f"{label}: route {route}, output {got.dtype}")
            if not torch.equal(got, again):
                fail(f"{label}: two launches differ")
            err = check_close(label, got, want, atol, rtol)
            off = float(((got - want).abs() > atol32 + rtol32 * want.abs())
                        .float().mean())
            if off > 0.01:
                fail(f"{label}: {off:.2%} of the outputs past the fp32 "
                     f"tolerance atol={atol32} rtol={rtol32} (at most 1%)")
            qs = q.transpose(1, 2).contiguous()
            ks, vs = (x.float().repeat_interleave(H // Hkv, 2).transpose(
                1, 2).contiguous() for x in (kd, vd))
            cols = torch.arange(nb * PAGE, device="cuda")
            mask = ((cols[None, None, :] < kvl[:, None, None])
                    & (cols[None, None, :] <= qpos[:, :, None]))[:, None]
            t_k, t_p = timer.ms(fn), timer.ms(plain)
            t_lib = timer.ms(lambda: sdpa(qs, ks, vs, attn_mask=mask))
            vis = torch.minimum(kvl[:, None], qpos + 1).clamp(min=0)
            horizon = torch.minimum(kvl, qpos.max(dim=1).values + 1).clamp(
                min=0)
            # both kernels read each row's visible keys of K and V once
            b_ms, b_by = bound_ms(
                "flash_attention", MIXED_ROUTE, B=SLOTS, Sq=Sq, Sk=MAX_LEN,
                H=H, Hkv=Hkv, D=D, dtype=torch.float32,
                kv_dtype=torch.bfloat16, keys=int(horizon.sum()),
                pairs=int(vis.sum()))
            rows.append(dict(cell=label, kernel=kern,
                             dtype="float32 q, bfloat16 KV", path=path,
                             uses=cfg.n_layers, route=route, max_abs_err=err,
                             past_fp32_tol=off, ms=t_k, plain_ms=t_p,
                             library_ms=t_lib, bound_ms=b_ms, bound_by=b_by))
            log(f"{label}: route {route} max|d|={err:.2e} kernel {t_k:.4f} ms "
                f"plain {t_p:.4f} ms sdpa {t_lib:.4f} ms bound {b_ms:.4f} ms "
                f"({b_by}), {off:.4%} past fp32's tolerance")
    return rows


def device_busy_ms(fn, n=1):
    """Summed device time of every kernel ``fn`` runs, per call, over ``n``
    calls (torch.profiler; kernels of one stream run one at a time), and
    the host wall time per call of those calls."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / n
    busy = sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3 / n
    return busy, wall * 1e3


def run_train_phase(cfg):
    """smollm-135m at full width and depth, bf16, trained by the port's
    Trainer on the card: B 8 x 128 tokens from TokenPipeline (ids below
    TRAIN_DATA_VOCAB), TRAIN_STEPS steps with remat on, a checkpoint at
    step TRAIN_CKPT; every GEMM through K1 (forward,
    backward, the batch grid of the unfused attention), the forward-only
    kernels never. Then a fresh Trainer resumes from the checkpoint and
    reaches step TRAIN_STEPS. Also: K1 launches of one step with remat on
    and off, whether one step repeats bitwise, and a step's device busy
    time."""
    import shutil
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train.loop import TrainConfig, Trainer, make_train_step

    gc.collect()
    torch.cuda.empty_cache()
    ckpt = ROOT / "build" / "train_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    dc = DataConfig(seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                    vocab=TRAIN_DATA_VOCAB, seed=0)
    tc = TrainConfig(steps=TRAIN_STEPS, log_every=1, ckpt_every=TRAIN_CKPT,
                     ckpt_dir=str(ckpt), base_lr=TRAIN_LR,
                     warmup=TRAIN_WARMUP, device="cuda")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    trainer = Trainer(cfg, dc, tc)
    out = trainer.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts("training", K1_TRAIN)
    for name in FORWARD_ONLY:
        if launches[name]:
            fail(f"training: forward-only kernel {name} launched "
                 f"{launches[name]} times")
    losses = [l for _, l in out["history"]]
    if len(losses) != TRAIN_STEPS or not all(np.isfinite(losses)):
        fail(f"training: losses {losses}")
    if not losses[-1] < losses[0]:
        fail(f"training: the loss did not fall ({losses[0]} -> {losses[-1]})")
    peak = torch.cuda.max_memory_allocated() / 2**30
    steps_s = trainer.step_times
    res = dict(steps=TRAIN_STEPS, batch=[TRAIN_BATCH, TRAIN_SEQ],
               losses=losses, seconds=wall, step_ms=[s * 1e3 for s in steps_s],
               median_step_ms=statistics.median(steps_s[1:]) * 1e3,
               tokens_per_s=tokens / statistics.median(steps_s[1:]),
               peak_mem_gib=peak, launches=launches,
               launches_per_step={k: launches[k] / TRAIN_STEPS
                                  for k in K1_TRAIN})
    log(f"training: {TRAIN_STEPS} steps in {wall:.1f} s, loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}, median step "
        f"{res['median_step_ms']:.1f} ms ({res['tokens_per_s']:.0f} tok/s), "
        f"peak {peak:.2f} GiB, K1 launches a step "
        f"{res['launches_per_step']}")

    # resume from the checkpoint in a fresh Trainer
    shutil.rmtree(ckpt / f"step_{TRAIN_STEPS:08d}")
    reset_counts()
    resumed = Trainer(cfg, dc, tc)
    if resumed.start_step != TRAIN_CKPT:
        fail(f"resume: started at step {resumed.start_step}")
    rout = resumed.run()
    read_counts("resumed training", K1_TRAIN)
    r_losses = [l for _, l in rout["history"]]
    tail = losses[TRAIN_CKPT:]
    diff = max(abs(a - b) for a, b in zip(tail, r_losses))
    res["resume"] = dict(losses=r_losses, max_abs_diff=diff,
                         bitwise=r_losses == tail)
    if r_losses != tail:
        fail(f"resume: losses {r_losses} are not bitwise {tail} (max |d| "
             f"{diff:.3e})")
    log(f"training resumed at step {TRAIN_CKPT}: losses bitwise equal to "
        f"the uninterrupted run's")
    shutil.rmtree(ckpt, ignore_errors=True)

    # one step, twice from the same state: bitwise repeatable? And the K1
    # launches of a step with remat on and off, and its device busy time
    params, opt = rout["params"], resumed.opt_state
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in resumed.data.next_batch().items()}
    step_fn = make_train_step(cfg, resumed.opt_cfg, tc)
    outs = [step_fn(params, opt, batch) for _ in range(2)]
    same = all(torch.equal(a, b) for a, b in zip(
        tree_leaves(outs[0][0]), tree_leaves(outs[1][0])))
    res["step_bitwise_repeatable"] = dict(
        params=same, loss=float(outs[0][2]["loss"]) == float(
            outs[1][2]["loss"]),
        grad_norm=[float(o[2]["grad_norm"]) for o in outs])
    per_step = {}
    for remat in (True, False):
        c = dataclasses.replace(cfg, remat=remat)
        reset_counts()
        make_train_step(c, resumed.opt_cfg, tc)(params, opt, batch)
        torch.cuda.synchronize()
        per_step[f"remat {'on' if remat else 'off'}"] = counts()
    res["launches_one_step"] = per_step
    busy, host = device_busy_ms(lambda: step_fn(params, opt, batch), 2)
    res["profiled_step"] = dict(device_busy_ms=busy, host_wall_ms=host,
                                idle_share=1 - busy / host)
    res["dots"] = run_dots_step(cfg, params, opt, batch, resumed.opt_cfg,
                                tc, per_step)
    del outs, params, opt
    log(f"training step: bitwise repeatable {res['step_bitwise_repeatable']}; "
        f"K1 launches {({r: {k: c[k] for k in K1_TRAIN} for r, c in per_step.items()})}; "
        f"device busy {busy:.1f} ms of {host:.1f} ms host wall (profiled)")
    return res


def run_dots_step(cfg, params, opt, batch, opt_cfg, tc, per_step):
    """Phase 20's remat "dots" step: from one state and batch, the loss
    and every gradient under "full" and "dots" (within GEMM_TOLS, and
    whether bitwise equal); K1's launches of a train step under "dots"
    (``per_step`` gains them) equal to those with remat off and to the
    dry run's of the same step on ``meta``; each policy's train step:
    device busy time and peak memory above the state; the dry run's
    temporaries of the "dots" step."""
    from repro_torch.core import api
    from repro_torch.core.plan import UNFUSED, GemmPolicy
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch import steps as ST
    from repro_torch.models import transformer as T
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train.loop import make_train_step

    atol, rtol = GEMM_TOLS["bfloat16"]
    grads, res = {}, {}
    for policy in ("full", "dots"):
        c = dataclasses.replace(cfg, remat=True, remat_policy=policy)
        with api.use_policy(GemmPolicy()), api.use_attention_policy(UNFUSED):
            (loss, _), g = ST.value_and_grad(
                lambda p: T.lm_loss(p, c, batch), params)
        grads[policy] = (loss, tree_leaves(g))
        step = make_train_step(c, opt_cfg, tc)
        reset_counts()
        step(params, opt, batch)
        torch.cuda.synchronize()
        launches = counts()
        if policy == "dots":
            per_step["remat dots"] = launches
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        step(params, opt, batch)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        busy, host = device_busy_ms(lambda: step(params, opt, batch), 1)
        res[policy] = dict(
            loss=float(loss), k1_launches={k: launches[k] for k in K1_TRAIN},
            device_busy_ms=busy, host_wall_ms=host,
            peak_mem_above_state_bytes=peak)
        if policy == "dots":       # the dry run of the step it checks
            dry = DR.run_step(c, "train", TRAIN_BATCH, TRAIN_SEQ)
            res[policy].update(
                dry_run_temp_bytes=dry["memory"]["temp_size_in_bytes"],
                dry_run_k1_launches=DR.launch_counters(dry)[
                    "matrixflow_gemm"])
    (lf, gf), (ld, gd) = grads["full"], grads["dots"]
    check_close("dots loss", ld, lf, atol, rtol)
    err = max(check_close(f"dots grad {i}", b, a, atol, rtol)
              for i, (a, b) in enumerate(zip(gf, gd)))
    res["bitwise"] = bool(torch.equal(lf, ld)) and all(
        torch.equal(a, b) for a, b in zip(gf, gd))
    res["grad_max_abs_diff"] = err
    k1 = {p: per_step[p]["matrixflow_gemm"]
          for p in ("remat on", "remat off", "remat dots")}
    if k1["remat dots"] != k1["remat off"]:
        fail(f"training dots: K1 launches a step {k1}: dots must launch as "
             f"often as remat off (no GEMM in the recompute)")
    if res["dots"]["dry_run_k1_launches"] != k1["remat dots"]:
        fail(f"training dots: the dry run counts "
             f"{res['dots']['dry_run_k1_launches']} K1 launches, the card "
             f"{k1['remat dots']}")
    res["k1_launches_a_step"] = k1
    log(f"training remat dots vs full (one step): bitwise {res['bitwise']}, "
        f"grads max |d| {err:.3e}; K1 launches a step {k1}; "
        + "; ".join(f"{p}: device busy {r['device_busy_ms']:.1f} ms of "
                    f"{r['host_wall_ms']:.1f} ms host, peak "
                    f"{r['peak_mem_above_state_bytes'] / 2**30:.3f} GiB above"
                    f" the state"
                    for p, r in res.items() if p in ("full", "dots"))
        + f"; dots dry-run temporaries "
        f"{res['dots']['dry_run_temp_bytes'] / 2**30:.3f} GiB")
    return res


def run_train_fp32_phase(cfg):
    """One train step in fp32 (TF32 off) at full width, 2 layers: the card
    (K1 forward, backward and batch grid, on the CUDA cores) against the
    CPU plain path on the same params and batch: the loss, every gradient
    leaf and the params after the AdamW update (lr = TRAIN_FP32_LR). Loss
    within LOGIT_TOL; each gradient leaf within LOGIT_TOL of its largest
    entry; params within LOGIT_TOL."""
    from repro_torch.core import api
    from repro_torch.core.plan import UNFUSED, GemmPolicy
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.models import transformer as T
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
    from repro_torch.optim.adamw import tree_leaves

    cfg32 = dataclasses.replace(cfg, dtype="float32",
                                n_layers=TRAIN_FP32_LAYERS)
    params = T.init_model(cfg32, seed=5, device="cuda", draw_device="cuda")
    batch = TokenPipeline(DataConfig(seq_len=TRAIN_SEQ,
                                     global_batch=TRAIN_FP32_BATCH,
                                     vocab=cfg.vocab, seed=3)).next_batch()
    res, runs = {}, {}
    for device in ("cuda", "cpu"):
        p = to_device(params, device)
        b = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        reset_counts()
        t0 = time.perf_counter()
        with api.use_policy(GemmPolicy()), api.use_attention_policy(UNFUSED):
            (loss, _), grads = value_and_grad(
                lambda q: T.lm_loss(q, cfg32, b), p)
        new_p = adamw_update(p, grads, adamw_init(p),
                             AdamWConfig(lr=TRAIN_FP32_LR),
                             torch.tensor(TRAIN_FP32_LR))[0]
        if device == "cuda":
            torch.cuda.synchronize()
            res["launches"] = counts()
            for name in ("matrixflow_gemm_cuda_core",
                         "matrixflow_gemm_batched",
                         "matrixflow_gemm_backward"):
                if not res["launches"][name]:
                    fail(f"fp32 train step: {name} never launched")
        runs[device] = (float(loss), [g.cpu() for g in tree_leaves(grads)],
                        [q.cpu() for q in tree_leaves(new_p)],
                        time.perf_counter() - t0)
    (lc, gc_, pc, tcard), (lp, gp, pp, tcpu) = runs["cuda"], runs["cpu"]
    d_loss = abs(lc - lp)
    d_grad = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                 for a, b in zip(gc_, gp))
    d_param = max(float((a - b).abs().max()) for a, b in zip(pc, pp))
    step = max(float((a - b.cpu()).abs().max())
               for a, b in zip(pp, tree_leaves(params)))
    res.update(loss_card=lc, loss_cpu=lp, loss_abs_diff=d_loss,
               grad_max_rel_diff=d_grad, param_max_abs_diff=d_param,
               cpu_step_max_abs=step, seconds_card=tcard, seconds_cpu=tcpu)
    if not step > 2 * TRAIN_FP32_PARAM_TOL:
        fail(f"fp32 train step: the CPU's update moves no weight by more "
             f"than {step:.3e}, too little to tell a missing update apart")
    for what, v, tol in (
            ("loss", d_loss, LOGIT_TOL),
            ("gradient (relative to each leaf's largest entry)", d_grad,
             LOGIT_TOL),
            ("params after the update", d_param, TRAIN_FP32_PARAM_TOL)):
        if not v <= tol:
            fail(f"fp32 train step, card vs CPU: {what} differ by {v:.3e} > "
                 f"{tol}")
    log(f"fp32 train step ({TRAIN_FP32_LAYERS} layers, B {TRAIN_FP32_BATCH} "
        f"x {TRAIN_SEQ}), card vs CPU: loss {lc:.6f} / {lp:.6f} "
        f"(|d| {d_loss:.2e}), grads max rel |d| {d_grad:.2e}, params max |d| "
        f"{d_param:.2e}")
    return res


def run_mixed_phase(cfg):
    """An fp32 model serving from a bf16 cache at full width (the
    reference's default ServeConfig pairing): paged, contiguous and int8
    KV, 12 requests each, all complete; K1 on the CUDA cores (fp32), the
    new K4 / K3 instances (fp32 q over bf16 pages / caches) or K5's fp32-q
    instance launched. Then at MIXED_PARITY_LAYERS layers, the card's
    streams against the CPU plain path's on the same dtypes, a first
    parting allowed only where the plain top-2 margin is below LOGIT_TOL."""
    from repro_torch.core.api import pack_model_weights
    from repro_torch.core.plan import FUSED, AttentionPolicy
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import ServeConfig, ServingEngine

    gc.collect()
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    rng = np.random.default_rng(22)
    prompts = [rng.integers(0, cfg.vocab, int(n)).tolist()
               for n in rng.integers(16, PROMPT_BUCKET + 1, N_REQUESTS)]
    runs = {"paged": (dict(attention=AttentionPolicy("paged", PAGE),
                           cache_pages=CACHE_PAGES),
                      ("paged_attention_cuda_cores_bf16kv",)),
            "contiguous": (dict(attention=FUSED),
                           ("flash_attention_cuda_cores_bf16kv",)),
            "int8 KV": (dict(attention=AttentionPolicy("paged", PAGE),
                             cache_pages=CACHE_PAGES, kv_dtype="int8"),
                        ("paged_attention_int8_cuda_cores",))}
    params = T.init_model(cfg32, seed=9, device="cuda", draw_device="cuda")
    res = {}
    for name, (kw, required) in runs.items():
        eng = ServingEngine(cfg32, params, ServeConfig(
            batch_slots=SLOTS, max_len=MAX_LEN, cache_dtype="bfloat16",
            pack_weights=True, device="cuda", **kw))
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        streams, n_tokens, per_step = serve_requests(eng, prompts, 300)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = read_counts(f"mixed {name}", ("matrixflow_gemm",
                                                 "matrixflow_gemm_cuda_core")
                               + required, allowed=MIXED_ALLOWED)
        check_streams(f"mixed {name}", streams, cfg.vocab)
        res[name] = dict(tokens=n_tokens, seconds=dt,
                         tokens_per_s=n_tokens / dt, launches=launches,
                         launches_per_decode_step=per_step,
                         preemptions=eng.n_preemptions)
        log(f"mixed dtypes ({name}: fp32 model, "
            f"{'int8' if 'int8' in name else 'bf16'} cache): {N_REQUESTS} "
            f"requests, {n_tokens} tokens in {dt:.2f} s "
            f"({n_tokens / dt:.1f} tok/s), {eng.n_preemptions} preemptions, "
            f"launches {launches}")
        del eng
    del params

    cfgp = dataclasses.replace(cfg32, n_layers=MIXED_PARITY_LAYERS)
    params = T.init_model(cfgp, seed=10, device="cpu")
    streams = {}
    for kind, attn in (("paged", AttentionPolicy("paged", PAGE)),
                       ("contiguous", FUSED)):
        for device in ("cuda", "cpu"):
            e = ServingEngine(cfgp, params, ServeConfig(
                batch_slots=SLOTS, max_len=MAX_LEN, cache_dtype="bfloat16",
                pack_weights=True, attention=attn, device=device))
            streams[kind, device] = serve_requests(e, prompts, 600)[0]
            del e
    params_cpu = pack_model_weights(params)
    ties = {}
    for kind in ("paged", "contiguous"):
        for i, p in enumerate(prompts):
            d = first_divergence(cfgp, params_cpu, p, streams[kind, "cuda"][i],
                                 streams[kind, "cpu"][i],
                                 label=f"mixed dtypes {kind}")
            if d is not None:
                ties[f"{kind} request {i}"] = d
    res["parity"] = dict(layers=MIXED_PARITY_LAYERS, equal=not ties,
                         near_ties=ties)
    log(f"mixed dtypes, {MIXED_PARITY_LAYERS} layers, card vs CPU plain: "
        f"streams {'equal' if not ties else f'equal up to near-ties {ties}'}")
    return res


# ---------------------------------------------------------------------------
# Phase 23: multi-device on torch.distributed — tensor-parallel serving of
# qwen3-8b at full width, data-parallel training and the GPipe pipeline,
# two ranks on the one card over gloo
# ---------------------------------------------------------------------------

TP_ARCH = "qwen3-8b"
TP_WORLD = 2
TP_LAYERS = 1                  # of qwen3-8b's 36, at full width: the time
# phases 24 and 26 (TP and FSDP training): two layers, so a fault across
# the stacked layers' leaves, gathers or slices can show
TP_TRAIN_LAYERS = 2
TP_PROMPT, TP_GEN = 32, 16     # phase 23's bf16 streams: SLOTS prompts
TP_DECODE_STEPS = 8            # timed decode steps, SLOTS requests live
TP_PIPE = dict(layers_per_stage=2, mu=4, mb=8, d=1024)   # phase 23's GPipe
# The DP step runs make_train_step_fn, whose schedule warms up over 100
# steps (lr/100 at step 0, as in the reference): at 2e-2 its first step
# moves a weight by ~2e-4, four times TRAIN_FP32_PARAM_TOL, so a step
# that applied no update, or another one, fails.
TP_DP_LR = 2e-2
TP_PAGED = dict(backend="paged", page_size=PAGE)
# The ranks of phases 23 and 24 take ~30 s on an H100: a hung rank or
# collective fails its phase well inside the run's time limit.
TP_RANKS_TIMEOUT_S, TP_COLLECTIVE_TIMEOUT_S = 240, 120


def tp_config(dtype, layers=TP_LAYERS):
    """qwen3-8b at full width and ``layers`` layers with the sharding
    overrides cleared, as the reference's TP runner builds its model
    (tests/tp_serving_runner.py::build), so the heads and the KV pools
    split: 16 query and 4 KV heads a rank at TP=2."""
    from repro_torch.configs.registry import get_config
    return dataclasses.replace(get_config(TP_ARCH), n_layers=layers,
                               sharding_overrides=(), dtype=dtype)


def tp_rank_config():
    """What one rank of TP_WORLD holds of the model: its heads (for the
    kernel cells at the rank's shapes)."""
    m = tp_config("bfloat16")
    return dataclasses.replace(
        m, name=f"{TP_ARCH} tp{TP_WORLD} rank", d_head=m.head_dim,
        n_heads=m.n_heads // TP_WORLD, n_kv_heads=m.n_kv_heads // TP_WORLD)


def tp_params(cfg, mesh):
    """Seeded weights drawn on the card (the same on every process), cut
    to this rank's share on a mesh (``steps.rank_params``: its slices over
    model, its cut over data)."""
    from repro_torch.launch import steps as ST
    from repro_torch.models import transformer as T
    params = T.init_model(cfg, seed=0, device="cuda", draw_device="cuda")
    held = ST.rank_params(cfg, params, mesh)
    if held is not params:
        del params
        torch.cuda.empty_cache()     # the whole draw: ranks share the card
    return held


def tp_engine(cfg, params, mesh, **kw):
    from repro_torch.core.plan import AttentionPolicy
    from repro_torch.serving.engine import ServeConfig, ServingEngine
    sc = dict(batch_slots=2, max_len=64, attention=AttentionPolicy(**TP_PAGED),
              cache_dtype=cfg.dtype, device="cuda")
    sc.update(kw)
    return ServingEngine(cfg, params, ServeConfig(**sc, mesh=mesh))


def tp_steps(eng, n, generator=None):
    outs, pages = [], []
    for _ in range(n):
        outs.append({int(h): int(t) for h, t in
                     eng.step(generator=generator).items()})
        pages.append((eng.pool.free_pages, eng.pool.pages_in_use)
                     if eng.paged else None)
    return outs, pages


def tp_drain(eng, max_steps=200):
    pages = []
    for _ in range(max_steps):
        eng.step()
        pages.append((eng.pool.free_pages, eng.pool.pages_in_use))
        if not eng.slot_live.any() and not eng.wait:
            break
    return pages


def tp_scenarios(cfg, params, mesh):
    """The reference TP runner's scenarios at full width (greedy,
    seeded temperature, preempt/resume, prefix-cache COW, int8 KV) and the
    contiguous (K3) engine: streams and per-step page accounting."""
    from repro_torch.core.plan import FUSED
    V = cfg.vocab
    rng = np.random.default_rng(7)
    gen = lambda seed: torch.Generator().manual_seed(seed)   # noqa: E731
    out = {}
    eng = tp_engine(cfg, params, mesh)
    prompts = rng.integers(0, V, (2, 12))
    r = {"generate": eng.generate(prompts, 8).tolist()}
    eng = tp_engine(cfg, params, mesh)
    r["handles"] = [eng.submit(rng.integers(0, V, 5).tolist()),
                    eng.submit(rng.integers(0, V, 9).tolist())]
    r["steps"], r["pages"] = tp_steps(eng, 6)
    r["kv_shards"] = eng.kv_shards()
    out["greedy"] = r
    eng = tp_engine(cfg, params, mesh, temperature=0.8)
    r = {"generate": eng.generate(rng.integers(0, V, (2, 7)), 8,
                                  generator=gen(42)).tolist()}
    eng = tp_engine(cfg, params, mesh, temperature=0.8)
    r["handles"] = [eng.submit(rng.integers(0, V, 3).tolist(),
                               generator=gen(1))]
    r["steps"], r["pages"] = tp_steps(eng, 6, generator=gen(100))
    out["temperature"] = r
    for name, kw in (("preempt", {}), ("kv-int8 preempt",
                                        {"kv_dtype": "int8"})):
        # 2 pages of 16 tokens for 2 slots of max_len 32: decode growth
        # exhausts the pool and preempts
        eng = tp_engine(cfg, params, mesh, max_len=32, cache_pages=2, **kw)
        hs = [eng.submit(rng.integers(0, V, 3).tolist()) for _ in range(2)]
        pages = tp_drain(eng)
        eng.pool.check()
        out[name] = {"handles": hs, "pages": pages,
                     "n_preemptions": eng.n_preemptions,
                     "streams": {int(h): [int(t) for t in eng.request_out[h]]
                                 for h in hs}}
    eng = tp_engine(cfg, params, mesh, kv_dtype="int8")
    out["kv-int8"] = {"generate": eng.generate(
        rng.integers(0, V, (2, 12)), 8).tolist()}
    eng = tp_engine(cfg, params, mesh, batch_slots=3, prefix_cache=True,
                    cache_pages=12)
    shared = rng.integers(0, V, 21).tolist()      # 1 full page + a tail
    prompts = [shared + [40, 41], shared + [50, 51],
               shared[:9] + [60, 61, 62, 63]]
    r = {"handles": [eng.submit(p) for p in prompts],
         "hits": eng.prefix.hits, "cow_forks": eng.prefix.cow_forks}
    r["steps"], r["pages"] = tp_steps(eng, 6)
    r["prefix"] = eng.prefix.stats()
    eng.pool.check()
    eng.prefix.check()
    out["prefix"] = r
    eng = tp_engine(cfg, params, mesh, attention=FUSED)
    r = {"generate": eng.generate(rng.integers(0, V, (2, 12)), 8).tolist()}
    eng = tp_engine(cfg, params, mesh, attention=FUSED)
    r["handles"] = [eng.submit(rng.integers(0, V, 5).tolist()),
                    eng.submit(rng.integers(0, V, 9).tolist())]
    r["steps"], _ = tp_steps(eng, 6)
    out["contiguous"] = r
    return out


def tp_bf16_run(cfg, params, mesh):
    """bf16 at full width: SLOTS prompts of TP_PROMPT tokens, TP_GEN greedy
    tokens through the paged (K4), int8-KV (K5) and contiguous (K3)
    engines, and the prompts' last-column logits of one cache-less
    forward."""
    from repro_torch.core.plan import FUSED
    from repro_torch.distributed import tp as TP
    from repro_torch.models import transformer as T
    prompts = np.random.default_rng(9).integers(
        0, cfg.vocab, (SLOTS, TP_PROMPT))
    out = {}
    for name, kw in (("paged", {}), ("int8 KV", dict(kv_dtype="int8")),
                     ("contiguous", dict(attention=FUSED))):
        eng = tp_engine(cfg, params, mesh, batch_slots=SLOTS,
                        max_len=MAX_LEN, **kw)
        out[name] = eng.generate(prompts, TP_GEN)
    ctx = TP.make_context(mesh, overrides=cfg.overrides_dict()) \
        if mesh is not None else None
    with torch.no_grad(), TP.use_tp(ctx):
        logits = T.forward(params, cfg, {"tokens": torch.from_numpy(
            prompts).cuda()}, last_cols=torch.full(
                (SLOTS,), TP_PROMPT - 1, device="cuda"))[0]
    out["logits"] = logits[:, 0].float().cpu().numpy()
    return out


def tp_decode_timing(cfg, params, mesh):
    """The decode step with SLOTS requests live (prompts of 16 tokens,
    bf16, paged): host wall ms of each of TP_DECODE_STEPS steps (step()
    reads the sampled tokens back, so the card has finished), and the
    collectives and kernel launches per step."""
    from repro_torch.distributed import tp as TP
    eng = tp_engine(cfg, params, mesh, batch_slots=SLOTS, max_len=MAX_LEN)
    rng = np.random.default_rng(5)
    for _ in range(SLOTS):
        eng.submit(rng.integers(0, cfg.vocab, 16).tolist())
    eng.step()
    eng.step()
    TP.collectives.reset()
    before = counts()
    ms = []
    for _ in range(TP_DECODE_STEPS):
        t0 = time.perf_counter()
        eng.step()
        ms.append((time.perf_counter() - t0) * 1e3)
    after = counts()
    col = TP.collectives.snapshot()
    return {"step_ms": ms, "median_ms": statistics.median(ms),
            "collectives_per_step": {
                what: {k: v / TP_DECODE_STEPS for k, v in d.items()}
                for what, d in col.items()},
            "launches_per_step": {k: (after[k] - before[k]) / TP_DECODE_STEPS
                                  for k in after if after[k] - before[k]}}


def tp_serving_run(mesh):
    """Phase 23's serving on ``mesh`` (one rank of it) or one device: the
    fp32 scenarios, then bf16 streams, logits and the timed decode step;
    the kernel launches of each dtype's path."""
    res = {}
    for dtype in ("float32", "bfloat16"):
        cfg = tp_config(dtype)
        params = tp_params(cfg, mesh)
        reset_counts()
        if dtype == "float32":
            res["fp32"] = tp_scenarios(cfg, params, mesh)
        else:
            res["bf16"] = tp_bf16_run(cfg, params, mesh)
        res[f"{dtype} launches"] = counts()
        if dtype == "bfloat16":
            res["decode"] = tp_decode_timing(cfg, params, mesh)
        res[f"{dtype} param bytes"] = sum(
            t.numel() * t.element_size() for t in tree_tensors(params))
        del params
        gc.collect()
        torch.cuda.empty_cache()
    return res


def dp_train_run(mesh):
    """One data-parallel train step of smollm-135m at full width in fp32
    (TRAIN_FP32_LAYERS layers, TF32 off): B TRAIN_BATCH x TRAIN_SEQ split
    over the mesh's data axis, each rank holding its FSDP cut of the
    params and moments (``steps.rank_params``), against the one-rank step
    on the whole batch in the same process; the ranks' params gathered
    whole after the step."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core import api
    from repro_torch.core.plan import UNFUSED, GemmPolicy
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.distributed import tp as TP
    from repro_torch.launch import steps as ST
    from repro_torch.models import transformer as T
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.optim.adamw import tree_leaves

    cfg = dataclasses.replace(get_config(ARCH), dtype="float32",
                              n_layers=TRAIN_FP32_LAYERS)
    params = T.init_model(cfg, seed=5, device="cuda", draw_device="cuda")
    batch = {k: torch.from_numpy(v).cuda() for k, v in TokenPipeline(
        DataConfig(seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                   vocab=cfg.vocab, seed=3)).next_batch().items()}
    runs = {}
    for name, m in (("dp", mesh), ("one", None)):
        step = ST.make_train_step_fn(cfg, AdamWConfig(lr=TP_DP_LR),
                                     total_steps=10, mesh=m)
        held = ST.rank_params(cfg, params, m)
        reset_counts()
        TP.collectives.reset()
        with api.use_policy(GemmPolicy()), api.use_attention_policy(UNFUSED):
            p, _, met = step(held, adamw_init(held), batch)
        torch.cuda.synchronize()
        launches, coll = counts(), TP.collectives.snapshot()
        runs[name] = (float(met["loss"]), float(met["grad_norm"]),
                      tree_leaves(ST.full_params(cfg, p, m)), launches, coll)
    (ld, nd, pd, cd, coll), (lo, no, po, _, _) = runs["dp"], runs["one"]
    moved = max(float((a - b).abs().max())
                for a, b in zip(po, tree_leaves(params)))
    return {"loss_dp": ld, "loss_one": lo, "grad_norm_dp": nd,
            "grad_norm_one": no,
            "param_max_abs_diff": max(float((a - b).abs().max())
                                      for a, b in zip(pd, po)),
            "one_step_max_abs": moved, "launches": cd, "collectives": coll,
            "fsdp_closed_form": fsdp_closed_form(cfg, mesh)}


def pipeline_run(mesh):
    """A GPipe pipeline over the mesh's stage axis on the card: 2 layers
    of tanh(h @ W) a stage (K1, d 1024, fp32), μ 4 microbatches of 8,
    forward and the gradient of sum(out²), against the sequential version
    in the same process."""
    from repro_torch.core import api
    from repro_torch.distributed import tp as TP
    from repro_torch.distributed.pipeline import pipeline_apply, \
        stack_for_stages

    S = mesh.axis_size("stage")
    per, mu, mb, d = (TP_PIPE[k] for k in ("layers_per_stage", "mu", "mb",
                                            "d"))
    gen = torch.Generator(device="cuda").manual_seed(11)
    ws = torch.randn((S * per, d, d), generator=gen, device="cuda") / d ** 0.5
    x = torch.randn((mu, mb, d), generator=gen, device="cuda")

    def stage_fn(wslice, h):
        for w in wslice:
            h = torch.tanh(api.matmul(h, w))
        return h

    s = mesh.coords["stage"]
    mine = stack_for_stages(ws, S)[s].clone().requires_grad_(True)
    reset_counts()
    TP.collectives.reset()
    out = pipeline_apply(stage_fn, mine, x, mesh=mesh)
    (out ** 2).sum().backward()
    torch.cuda.synchronize()
    launches, coll = counts(), TP.collectives.snapshot()
    whole = ws.clone().requires_grad_(True)
    ref = stage_fn(whole, x)
    (ref ** 2).sum().backward()
    out, ref = out.detach(), ref.detach()
    return {"fwd_max_abs_diff": float((out - ref).abs().max()),
            "bwd_max_abs_diff": float(
                (mine.grad - whole.grad[s * per:(s + 1) * per]).abs().max()),
            "grad_max_abs": float(whole.grad.abs().max()),
            "launches": launches, "collectives": coll}


def tp_rank(rank, world, root):
    """One rank of phase 23, on cuda:0 beside the others: TP serving on a
    (1, world) mesh, the data-parallel step on (world, 1), the pipeline on
    a stage axis of world."""
    sys.path.insert(0, str(Path(root) / "src"))
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.launch.mesh import Mesh, make_host_mesh
    return {"serving": tp_serving_run(make_host_mesh(model=world)),
            "train": dp_train_run(make_host_mesh()),
            "pipeline": pipeline_run(Mesh((world,), ("stage",)))}


def run_tp_gemm_phase(timer, cfg):
    """K1 at a rank's shapes of qwen3-8b at TP=2 (decode M = SLOTS and
    prefill M = SLOTS x PROMPT_BUCKET; the head at M = SLOTS), bf16 and
    fp32: the column slices (q, k/v, SwiGLU's gate ‖ up taken half by
    half, the head's 75,968 vocab columns) against the same columns of
    the unsharded call (bitwise, or their distance), and the row slices
    (o, mlp-out: K halved, fp32 out) whose two partial sums must match one
    call within GEMM_TOLS["float32"]. Each cell timed as run_gemm_phase
    times its cells."""
    from repro_torch.core import api
    from repro_torch.core import layout as L
    from repro_torch.core.plan import GemmPolicy, layout_for_packed, \
        pack_weight
    from repro_torch.distributed.tp import shard_dim
    from repro_torch.kernels import matrixflow_gemm as MF

    d, f, V = cfg.d_model, cfg.d_ff, cfg.vocab
    qd, kvd = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    # (name, K, N, kind, blocks, uses per run: TP_LAYERS layers)
    layer = [("q", d, qd, "col", 1, TP_LAYERS),
             ("k/v", d, kvd, "col", 1, 2 * TP_LAYERS),
             ("o", qd, d, "row", 1, TP_LAYERS),
             ("mlp-in", d, 2 * f, "col", 2, TP_LAYERS),
             ("mlp-out", f, d, "row", 1, TP_LAYERS)]
    path = f"{TP_ARCH} tp{TP_WORLD}"
    cells = [(f"decode {n}", SLOTS, K, N, kind, b, f"{path} decode step", u)
             for n, K, N, kind, b, u in layer]
    cells.append(("decode head", SLOTS, d, V, "col", 1,
                  f"{path} decode step", 1))
    cells += [(f"prefill {n}", SLOTS * PROMPT_BUCKET, K, N, kind, b,
               f"{path} prefill", u) for n, K, N, kind, b, u in layer]
    rows = []
    gen = torch.Generator(device="cuda").manual_seed(23)
    for dtype_name in ("bfloat16", "float32"):
        dt = getattr(torch, dtype_name)
        atol, rtol = GEMM_TOLS[dtype_name]
        for name, M, K, N, kind, blocks, cpath, uses in cells:
            x = torch.randn((M, K), generator=gen, device="cuda").to(dt)
            w = (torch.randn((K, N), generator=gen, device="cuda")
                 / K ** 0.5).to(dt)
            label = (f"matrixflow_gemm tp{TP_WORLD} {kind} {name} M={M} "
                     f"K={K} N={N} {dtype_name}")
            if kind == "col":
                w_r = shard_dim(w, 1, 0, TP_WORLD, blocks)
                a_r, odt = x, dt
                whole = shard_dim(api.matmul(x, w), -1, 0, TP_WORLD, blocks)
                part = api.matmul(x, w_r)
                extra = dict(bitwise=bool(torch.equal(part, whole)),
                             col_max_abs_diff=float(
                                 (part.float() - whole.float()).abs().max()))
            else:
                w_r = shard_dim(w, 0, 0, TP_WORLD)
                a_r, odt = shard_dim(x, -1, 0, TP_WORLD), torch.float32
                parts = [api.matmul(shard_dim(x, -1, r, TP_WORLD),
                                    shard_dim(w, 0, r, TP_WORLD),
                                    out_dtype=torch.float32)
                         for r in range(TP_WORLD)]
                one = api.matmul(x, w, out_dtype=torch.float32)
                summed = parts[0] + parts[1]
                err = check_close(f"{label} partial sums vs one call",
                                  summed, one, *GEMM_TOLS["float32"])
                extra = dict(row_max_abs_diff=err)
            pw = pack_weight(w_r, GemmPolicy())
            blk = layout_for_packed(M, pw)
            a_bm = L.to_block_major_a(a_r, blk.bm, blk.bk)
            before = counts()
            got = MF.matrixflow_gemm_block_major(a_bm, pw.data, out_dtype=odt)
            after = counts()
            want = MF.plain(a_bm, pw.data, out_dtype=odt)
            torch.cuda.synchronize()
            route = [r for r in ("wgmma", "mma", "cuda_core")
                     if after[f"matrixflow_gemm_{r}"]
                     > before[f"matrixflow_gemm_{r}"]]
            expect = "cuda_core" if dtype_name == "float32" else "wgmma"
            if route != [expect]:
                fail(f"{label}: ran route {route}, expected {expect}")
            err = check_close(label, got, want, atol, rtol)
            t_k = timer.ms(lambda: MF.matrixflow_gemm_block_major(
                a_bm, pw.data, out_dtype=odt))
            t_p = timer.ms(lambda: MF.plain(a_bm, pw.data, out_dtype=odt))
            t_lib = timer.ms(lambda: torch.matmul(a_r, w_r))
            Kr, Nr = w_r.shape
            b_ms, b_by = bound_ms("matrixflow_gemm", route[0], M=M, N=Nr,
                                  K=Kr, dtype=dt, out_dtype=odt)
            rows.append(dict(cell=label, dtype=dtype_name, M=M, K=Kr, N=Nr,
                             route=route[0], path=cpath, uses=uses,
                             max_abs_err=err, ms=t_k, plain_ms=t_p,
                             library_ms=t_lib, bound_ms=b_ms, bound_by=b_by,
                             **extra))
            log(f"{label}: local {Kr}x{Nr} route {route[0]} max|d|={err:.2e} "
                f"kernel {t_k:.4f} ms plain {t_p:.4f} ms matmul {t_lib:.4f} "
                f"ms bound {b_ms:.4f} ms ({b_by}) {extra}")
            del x, w, w_r, pw, a_bm
    return rows


def run_tp_kernel_phase(timer):
    """Phase 23's kernel cells at a rank's shapes: K1
    (run_tp_gemm_phase), K4 and K5 at the rank's 16 query / 4 KV heads
    (head_dim 128) at decode and the prefill bucket, K3 over contiguous
    caches at the same heads."""
    from repro_torch.configs.registry import get_config
    m = tp_rank_config()
    return {"gemm": run_tp_gemm_phase(timer, tp_config("bfloat16")),
            "attention": run_attention_phase(timer, get_config(ARCH), [m],
                                             main=False),
            "int8_attention": run_int8_attention_phase(
                timer, get_config(ARCH), [m], main=False),
            "flash": run_flash_phase(timer, model_flash_cells(
                np.random.default_rng(23), [m]))}


# The kernels each dtype's TP path must launch: fp32 on the CUDA cores,
# bf16 on the tensor-core routes (phase 23 reads them per rank).
TP_FP32 = ("matrixflow_gemm", "matrixflow_gemm_cuda_core",
           "paged_attention", "paged_attention_cuda_cores",
           "paged_attention_int8", "paged_attention_int8_cuda_cores",
           "flash_attention", "flash_attention_cuda_cores")
TP_BF16 = K1_BF16 + K4_BF16 + K5_BF16 + K3_BF16


def run_tp_phase():
    """Phase 23. The one-device run first (this process), then TP_WORLD
    ranks on the same card (distributed/launch.py: spawn, gloo); the fp32
    streams and page accounting of every rank must equal the one-device
    engine's, every rank's the same; the bf16 partings and logit
    distance, the decode step's wall time and collectives are recorded;
    the DP step and the pipeline must match their one-rank versions."""
    import tempfile

    from repro_torch.distributed.launch import spawn

    t0 = time.perf_counter()
    one = tp_serving_run(None)
    t_one = time.perf_counter() - t0
    log(f"tp: the one-device runs took {t_one:.1f} s; starting {TP_WORLD} "
        f"ranks")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tp_") as work:
        ranks = spawn(tp_rank, TP_WORLD, (str(ROOT),), workdir=work,
                      timeout_s=TP_RANKS_TIMEOUT_S,
                      collective_timeout_s=TP_COLLECTIVE_TIMEOUT_S)
    t_ranks = time.perf_counter() - t0 - t_one
    res = {"seconds_one_device": t_one, "seconds_ranks": t_ranks,
           "one_device": one, "ranks": ranks}
    want = json.dumps(one["fp32"], sort_keys=True)
    for r, rk in enumerate(ranks):
        srv = rk["serving"]
        got = dict(srv["fp32"])
        if got["greedy"]["kv_shards"] != TP_WORLD:
            fail(f"tp rank {r}: the KV pool did not split "
                 f"(kv_shards {got['greedy']['kv_shards']})")
        got["greedy"] = dict(got["greedy"], kv_shards=1)
        if json.dumps(got, sort_keys=True) != want:
            bad = [k for k in got if json.dumps(got[k], sort_keys=True)
                   != json.dumps(one["fp32"][k], sort_keys=True)]
            fail(f"tp rank {r}: fp32 scenarios {bad} differ from the "
                 f"one-device engine's")
        check_counts(f"tp rank {r} fp32 serving", srv["float32 launches"],
                     TP_FP32, allowed=CUDA_CORE_COUNTERS)
        check_counts(f"tp rank {r} bf16 serving", srv["bfloat16 launches"],
                     TP_BF16)
    if json.dumps(ranks[0]["serving"]["fp32"], sort_keys=True) != \
            json.dumps(ranks[1]["serving"]["fp32"], sort_keys=True):
        fail("tp: the ranks' fp32 streams differ")
    b1, bt = one["bf16"], ranks[0]["serving"]["bf16"]
    parted = {k: int((np.asarray(bt[k]) != np.asarray(b1[k])).any(1).sum())
              for k in ("paged", "int8 KV", "contiguous")}
    for r in ranks[1:]:
        for k in parted:
            if not np.array_equal(r["serving"]["bf16"][k], bt[k]):
                fail(f"tp: the ranks' bf16 {k} streams differ")
    lg = float(np.abs(bt["logits"] - b1["logits"]).max())
    if not np.isfinite(bt["logits"]).all():
        fail("tp: bf16 logits not finite")
    for srv in [one] + [rk["serving"] for rk in ranks]:   # JSON from here
        srv["bf16"] = {k: np.asarray(v).tolist()
                       for k, v in srv["bf16"].items() if k != "logits"}
    dec1, dect = one["decode"], ranks[0]["serving"]["decode"]
    res.update(bf16_streams_parted=parted, bf16_streams=SLOTS,
               bf16_logit_max_abs_diff=lg,
               decode_ms_one_device=dec1["median_ms"],
               decode_ms_tp=dect["median_ms"],
               collectives_per_decode_step=dect["collectives_per_step"],
               launches_per_decode_step_tp=dect["launches_per_step"],
               launches_per_decode_step_one=dec1["launches_per_step"],
               param_bytes_one=one["bfloat16 param bytes"],
               param_bytes_rank=ranks[0]["serving"]["bfloat16 param bytes"])
    log(f"tp{TP_WORLD} {TP_ARCH} ({TP_LAYERS} layers, full width): fp32 "
        f"streams of 6 scenarios equal the one-device engine's on every "
        f"rank; bf16 parted {parted} of {SLOTS} streams each, logits max "
        f"|d| {lg:.3e}; decode step {dect['median_ms']:.2f} ms at tp"
        f"{TP_WORLD} vs {dec1['median_ms']:.2f} ms on one device; "
        f"collectives per decode step {dect['collectives_per_step']}; "
        f"bf16 params {res['param_bytes_rank'] / 2**30:.2f} GiB a rank vs "
        f"{res['param_bytes_one'] / 2**30:.2f} GiB; rank 0's launches: "
        f"fp32 path {dict((k, ranks[0]['serving']['float32 launches'][k]) for k in TP_FP32)}, "
        f"bf16 path {dict((k, ranks[0]['serving']['bfloat16 launches'][k]) for k in TP_BF16)}")
    for r, rk in enumerate(ranks):
        tr, pp = rk["train"], rk["pipeline"]
        if tr["one_step_max_abs"] <= 2 * TRAIN_FP32_PARAM_TOL:
            fail(f"dp rank {r}: the update moves no weight by more than "
                 f"{tr['one_step_max_abs']:.3e}")
        for what, v, tol in (
                ("loss", abs(tr["loss_dp"] - tr["loss_one"]), LOGIT_TOL),
                ("grad norm", abs(tr["grad_norm_dp"] - tr["grad_norm_one"]),
                 LOGIT_TOL),
                ("params after the update", tr["param_max_abs_diff"],
                 TRAIN_FP32_PARAM_TOL)):
            if not v <= tol:
                fail(f"dp{TP_WORLD} step vs one rank: {what} differ by "
                     f"{v:.3e} > {tol}")
        check_counts(f"dp rank {r} train step", tr["launches"],
                     ("matrixflow_gemm", "matrixflow_gemm_backward",
                      "matrixflow_gemm_batched"), allowed=CUDA_CORE_COUNTERS)
        want = dict(all_reduce=2, broadcast=0,
                    **tr["fsdp_closed_form"]["calls"])
        if tr["collectives"]["calls"] != want:
            fail(f"dp rank {r}: collectives {tr['collectives']['calls']}, "
                 f"not {want} (the FSDP gathers and reduce-scatters, one "
                 f"all-reduce of the whole leaves and metrics, one of the "
                 f"norm)")
        if not (pp["fwd_max_abs_diff"] <= 1e-5
                and pp["bwd_max_abs_diff"] <= 1e-4 * max(
                    1.0, pp["grad_max_abs"])):
            fail(f"pipeline rank {r} vs sequential: forward |d| "
                 f"{pp['fwd_max_abs_diff']:.3e}, gradient |d| "
                 f"{pp['bwd_max_abs_diff']:.3e}")
        check_counts(f"pipeline rank {r}", pp["launches"],
                     ("matrixflow_gemm", "matrixflow_gemm_backward"),
                     allowed=CUDA_CORE_COUNTERS)
    tr, pp = ranks[0]["train"], ranks[0]["pipeline"]
    log(f"dp{TP_WORLD} train step ({ARCH}, {TRAIN_FP32_LAYERS} layers fp32, "
        f"B {TRAIN_BATCH} x {TRAIN_SEQ}) vs one rank: loss |d| "
        f"{abs(tr['loss_dp'] - tr['loss_one']):.2e}, params max |d| "
        f"{tr['param_max_abs_diff']:.2e}; pipeline ({TP_WORLD} stages) vs "
        f"sequential: forward |d| {pp['fwd_max_abs_diff']:.2e}, gradient "
        f"|d| {pp['bwd_max_abs_diff']:.2e}; phase {t_one:.1f} s one device "
        f"+ {t_ranks:.1f} s ranks")
    return res


# ---------------------------------------------------------------------------
# Phase 24: tensor-parallel training on the card
# ---------------------------------------------------------------------------

# The fp32 step's batch (B x S tokens of the full vocabulary) and lr: the
# schedule's warmup gives lr/100 at step 0, so AdamW moves a weight by
# ~5e-4, five times the fp32 tolerance (GEMM_TOLS, the reference's TOLS).
TP_TRAIN_BATCH, TP_TRAIN_SEQ = 4, 128
TP_TRAIN_LR = 5e-2
# AdamW's first step moves a weight by lr x (g / (|g| + eps) + wd x w): by
# the sign of g alone wherever |g| >> eps, so the two steps' params agree to
# rounding there. Where |g| is near eps (1e-8) the update follows g's
# magnitude, and the order of the fp32 sums that differs between one device
# and the ranks (the row-parallel partial sums, the input gradients summed
# over the model group) moves it: an H100 gave 1 of 815,288,832 elements
# outside TOLS["float32"] (1.6e-4). Held to TOLS: every element whose
# one-device update is settled by the sign, |g| / (|g| + eps) >= this;
# the others are counted, and may be at most TP_TRAIN_UNSETTLED of them.
TP_TRAIN_SETTLED = 0.99
TP_TRAIN_UNSETTLED = 1e-6
TP_TRAIN_LOSS_RTOL = 1e-6
# The params' gate sees g's sign, not its size; AdamW's first moment does:
# after one step from zero it is (1 - b1) x clip x g, the clipped gradient
# itself. Each rank's worst leaf, ||mu - mu_one|| / ||mu_one|| over the
# one-device moment's same slice, must stay under this: a gradient doubled,
# halved or scaled by a wrong clip is off by 0.5 or more, the fp32 sums'
# other order by ~1e-6.
TP_TRAIN_GRAD_RTOL = 1e-4


def tp_train_batch(cfg, batch=TP_TRAIN_BATCH, seq=TP_TRAIN_SEQ):
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    return {k: torch.from_numpy(v).cuda() for k, v in TokenPipeline(
        DataConfig(seq_len=seq, global_batch=batch,
                   vocab=cfg.vocab, seed=4)).next_batch().items()}


def tp_train_step(cfg, params, mesh, lr=TP_TRAIN_LR, batch=None,
                  compress=False, overrides=None):
    """One make_train_step_fn step (AdamW, unfused attention, every GEMM
    through K1; int8 gradients with ``compress``; the rules
    ``overrides`` on the config's) of ``params`` (a rank's slices on
    ``mesh``) on ``batch`` (default :func:`tp_train_batch`): the new
    params, loss, gradient norm, the step's launches and collectives (also
    by the axes each went over), its first moment (the clipped gradient,
    scaled by 1 - b1), its host wall time, and the bytes of the blocks'
    inputs that remat saves (the tensors handed to
    ``torch.utils.checkpoint``)."""
    from repro_torch.core import api
    from repro_torch.core.plan import UNFUSED, GemmPolicy
    from repro_torch.distributed import tp as TP
    from repro_torch.launch import steps as ST
    from repro_torch.models import transformer as T
    from repro_torch.optim import AdamWConfig, adamw_init

    step = ST.make_train_step_fn(
        cfg, AdamWConfig(lr=lr, compress_grads=compress), total_steps=10,
        mesh=mesh, rules_overrides=overrides)
    batch = tp_train_batch(cfg) if batch is None else batch
    opt = adamw_init(params)
    saved = [0]
    checkpoint = T.checkpoint

    def counted(fn, *args, **kw):
        saved[0] += sum(a.numel() * a.element_size() for a in args
                        if torch.is_tensor(a))
        return checkpoint(fn, *args, **kw)
    torch.cuda.synchronize()
    reset_counts()
    TP.collectives.reset()
    t0 = time.perf_counter()
    T.checkpoint = counted
    try:
        with api.use_policy(GemmPolicy()), api.use_attention_policy(UNFUSED):
            new, opt, met = step(params, opt, batch)
    finally:
        T.checkpoint = checkpoint
    loss = float(met["loss"])
    torch.cuda.synchronize()
    return dict(params=new, mu=opt["mu"], loss=loss,
                grad_norm=float(met["grad_norm"]),
                launches=counts(), collectives=TP.collectives.snapshot(),
                by_axes=TP.collectives.by_axes(mesh),
                wall_ms=(time.perf_counter() - t0) * 1e3,
                saved_block_input_bytes=saved[0])


def k1_by_direction(c):
    """K1's launches of one step: by route, forward and backward."""
    return {"routes": {r: c[f"matrixflow_gemm_{r}"]
                       for r in ("wgmma", "mma", "cuda_core")},
            "forward": c["matrixflow_gemm"] - c["matrixflow_gemm_backward"],
            "backward": c["matrixflow_gemm_backward"],
            "batched": c["matrixflow_gemm_batched"]}


def adamw_gate(cfg, mesh, out, init, ref_params, ref_mu=None, ties=None,
               tie_dr=None, measure=None):
    """A rank's fp32 step (``out``: tp_train_step's, from its cut
    ``init``) held leaf by leaf against the one-device step's params
    (``ref_params``, cut to the rank's share by ``steps.rank_params``:
    within GEMM_TOLS["float32"] wherever the one-device update is
    settled, TP_TRAIN_SETTLED) and, given ``ref_mu``, first moment (the
    worst leaf's relative distance). Given ``measure`` (the one-device
    |g| / scale of a compressed step, :func:`quantization_ties`) on a step
    without compression, each leaf's largest parting of an element's
    |g| / scale is returned (``r_parting_by_leaf``, read off the first
    moment). Given ``ties`` (a compressed step: the one-device |g| / scale
    like the params) and ``tie_dr`` (that ``r_parting_by_leaf`` of the
    same mesh without compression; required), an element outside the
    tolerance at an int8 rounding tie (within :func:`tie_window` of a
    half-integer) is counted apart (``tie_partings``: params outside the
    tolerance; ``mu_tie_partings``: first-moment elements parted by half
    an int8 step or more, the eight farthest from their half-integer
    listed in ``mu_tie_elements`` with the steps they part by) and left
    out of the moment's distance, not held;
    the largest parting outside the ties of the first moment's worst leaf
    is reported (``mu_worst_parting``: the leaf, the element's |g| /
    scale, its distance from the half-integer and the int8 quanta it parts
    by; ``leaf_partings`` and ``count``, the elements of the leaf and of
    every leaf outside the ties that part by half a quantum or more). Every element of the model is some rank's, so the ranks
    together hold every param to the one-device step's."""
    from repro_torch.launch import steps as ST
    from repro_torch.optim import AdamWConfig, cosine_schedule
    from repro_torch.optim.adamw import tree_leaves

    atol, rtol = GEMM_TOLS["float32"]
    mu = out.pop("mu")
    if ref_mu is None:
        del mu
    ref = ST.rank_params(cfg, ref_params, mesh)
    lr = float(cosine_schedule(torch.zeros((), dtype=torch.int32),
                               base_lr=TP_TRAIN_LR, warmup=100, total=10))
    wd = AdamWConfig().weight_decay
    if ties is not None and tie_dr is None:
        raise ValueError("a compressed step's ties need tie_dr, the "
                         "partings of |g| / scale on its mesh without "
                         "compression")
    ratio_cut = [None] * len(tree_leaves(ref)) if ties is None else \
        tree_leaves(ST.rank_params(cfg, ties, mesh))
    tie_cut = [None if r is None else tie_distance(r) < tie_window(dr)
               for r, dr in zip(ratio_cut, tie_dr or [None] * len(ratio_cut))]
    worst = worst_settled = moved = 0.0
    bad = unsettled = n = tied = 0
    for got, want, was, tie in zip(tree_leaves(out.pop("params")),
                                   tree_leaves(ref), tree_leaves(init),
                                   tie_cut):
        d = (got - want).abs()
        outside = d > atol + rtol * want.abs()
        if tie is not None:
            tied += int((outside & tie).sum())
            outside &= ~tie
        # the one-device step's g / (|g| + eps), from its update
        u = (was - want) / lr - (wd * was if was.dim() >= 2 else 0.0)
        settled = u.abs() >= TP_TRAIN_SETTLED
        bad += int((outside & settled).sum())
        unsettled += int((outside & ~settled).sum())
        worst = max(worst, float(d.max()))
        worst_settled = max(worst_settled, float(
            torch.where(settled, d, torch.zeros_like(d)).max()))
        moved = max(moved, float((want - was).abs().max()))
        n += got.numel()
    del ref
    grad_rel, mu_tied, mu_worst, mu_parted = None, 0, None, 0
    r_parting, tie_elements = None, []
    if ref_mu is not None:
        grad_rel = 0.0
        measured = [None] * len(tie_cut) if measure is None else \
            tree_leaves(ST.rank_params(cfg, measure, mesh))
        r_parting = [] if measure is not None else None
        for leaf, (got, want, tie, r, m) in enumerate(zip(
                tree_leaves(mu), tree_leaves(ST.rank_params(cfg, ref_mu, mesh)),
                tie_cut, ratio_cut, measured)):
            d = got - want
            if m is not None:        # |g| / scale's parting, no compression
                # |mu| / r: the leaf's scale, times the clip and 1 - beta1
                unit = float(want.abs().max()) / float(m.max())
                r_parting.append(float(d.abs().max()) / unit if unit
                                 else 0.0)
            if tie is not None:      # a tie rounded the other way: one step
                # one int8 step of this leaf's first moment
                q = torch.round(r.flatten()).clamp(min=1)
                step = float((want.abs().flatten() / q).max())
                parted = (d.abs() > 0.5 * step) & tie
                mu_tied += int(parted.sum())
                for i in torch.nonzero(parted.flatten())[:, 0]:
                    ri = r.flatten()[i]
                    tie_elements.append(dict(
                        leaf=leaf, index=int(i), g_over_scale=float(ri),
                        tie_distance=float(tie_distance(ri)),
                        window=tie_window(tie_dr[leaf]),
                        quanta=float(d.flatten()[i].abs()) / step))
                d = torch.where(tie, torch.zeros_like(d), d)
                away = d.abs().flatten()
                mu_parted += int((away > 0.5 * step).sum())
                rel = float(torch.linalg.vector_norm(d)
                            / torch.linalg.vector_norm(want))
                i = int(away.argmax())
                if float(away[i]) > 0 and (mu_worst is None
                                           or rel > mu_worst["leaf_rel_diff"]):
                    mu_worst = dict(
                        leaf=leaf, shape=list(got.shape), index=i,
                        g_over_scale=float(r.flatten()[i]),
                        tie_distance=float(tie_distance(r.flatten()[i])),
                        window=tie_window(tie_dr[leaf]),
                        abs_diff=float(away[i]),
                        quanta=float(away[i]) / step if step else None,
                        leaf_partings=int((away > 0.5 * step).sum()),
                        leaf_rel_diff=rel)
            grad_rel = max(grad_rel, float(torch.linalg.vector_norm(d)
                                           / torch.linalg.vector_norm(want)))
    tie_elements.sort(key=lambda e: -e["tie_distance"])
    return dict(grad_leaf_max_rel_diff=grad_rel, param_max_abs_diff=worst,
                settled_param_max_abs_diff=worst_settled,
                params_outside_tol=bad, unsettled_outside_tol=unsettled,
                tie_partings=tied, mu_tie_partings=mu_tied,
                mu_tie_elements=tie_elements[:8],
                r_parting_by_leaf=r_parting,
                mu_worst_parting=mu_worst and dict(mu_worst, count=mu_parted),
                param_count=n,
                one_device_step_max_abs=moved)


def check_adamw_gate(tag, f, one):
    """Phase 24's and 26's gates on a rank's fp32 step ``f`` against the
    one-device step ``one``."""
    rel = abs(f["loss"] - one["loss"]) / abs(one["loss"])
    if not rel <= TP_TRAIN_LOSS_RTOL:
        fail(f"{tag}: fp32 loss {f['loss']} vs one device {one['loss']} "
             f"(relative {rel:.2e} > {TP_TRAIN_LOSS_RTOL})")
    atol, rtol = GEMM_TOLS["float32"]
    if not abs(f["grad_norm"] - one["grad_norm"]) <= \
            atol + rtol * abs(one["grad_norm"]):
        fail(f"{tag}: fp32 grad norm {f['grad_norm']} vs one device "
             f"{one['grad_norm']} (outside GEMM_TOLS['float32'])")
    over = [e for e in f.get("mu_tie_elements", ())
            if e["quanta"] > POD_TIE_QUANTA]
    if over:
        fail(f"{tag}: a first-moment element at an int8 tie parts by more "
             f"than one rounding ({over})")
    if f["grad_leaf_max_rel_diff"] is not None and \
            not f["grad_leaf_max_rel_diff"] <= TP_TRAIN_GRAD_RTOL:
        fail(f"{tag}: a gradient leaf (AdamW's first moment) "
             f"{f['grad_leaf_max_rel_diff']:.3e} of its norm from the "
             f"one-device step's (> {TP_TRAIN_GRAD_RTOL}); largest parting "
             f"outside the int8 ties {f.get('mu_worst_parting')}")
    if f["params_outside_tol"] or f["unsettled_outside_tol"] > \
            TP_TRAIN_UNSETTLED * f["param_count"]:
        fail(f"{tag}: {f['params_outside_tol']} params whose update is "
             f"settled by the gradient's sign, and "
             f"{f['unsettled_outside_tol']} others, of {f['param_count']} "
             f"outside GEMM_TOLS['float32'] of the one-device step's (max "
             f"|d| {f['param_max_abs_diff']:.3e})")
    if f["one_device_step_max_abs"] <= 3 * GEMM_TOLS["float32"][0]:
        fail(f"{tag}: the update moves no weight by more than "
             f"{f['one_device_step_max_abs']:.3e}")
    check_counts(f"{tag} fp32 step", f["launches"],
                 ("matrixflow_gemm", "matrixflow_gemm_cuda_core",
                  "matrixflow_gemm_backward", "matrixflow_gemm_batched"),
                 allowed=CUDA_CORE_COUNTERS)
    if any(f["launches"][k] for k in FORWARD_ONLY):
        fail(f"{tag}: a forward-only kernel launched "
             f"({ {k: f['launches'][k] for k in FORWARD_ONLY} })")
    if f["collectives"]["calls"]["broadcast"]:
        fail(f"{tag}: a broadcast in the step")


def release_shared(*trees) -> None:
    """Empty a rank's containers of the parent's CUDA tensors (spawn
    arguments, shared through CUDA IPC), which the rank's entry frames
    keep until the process ends: each tensor freed here tells the parent
    its block is released, so ``torch.cuda.ipc_collect`` there frees it
    (a block the rank still held at its exit stays allocated in the
    parent for the rest of the run)."""
    for t in trees:
        t.clear()


def tp_train_rank(rank, world, root, ref_params, ref_mu):
    """One rank of phase 24 on cuda:0: the fp32 step on its slices of the
    seeded weights, held to the one-device step (:func:`adamw_gate`), its
    loss vocab-parallel; then a bf16 step timed after one warm-up step.
    ``ref_params`` and ``ref_mu`` are the parent's tensors on the card,
    shared with this process through CUDA IPC: read, never written."""
    sys.path.insert(0, str(Path(root) / "src"))
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.distributed import tp as TP
    from repro_torch.launch import steps as ST
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as T

    mesh = make_host_mesh(model=world)
    cfg = tp_config("float32", TP_TRAIN_LAYERS)
    with TP.use_tp(ST.tp_context(cfg, mesh)):
        vocab_parallel = T.vocab_parallel(cfg)
    init = tp_params(cfg, mesh)
    out = tp_train_step(cfg, init, mesh)
    out.update(adamw_gate(cfg, mesh, out, init, ref_params, ref_mu),
               k1=k1_by_direction(out["launches"]),
               vocab_parallel=vocab_parallel)
    release_shared(ref_params, ref_mu)
    del init, ref_params, ref_mu
    gc.collect()
    torch.cuda.empty_cache()
    cfg16 = tp_config("bfloat16", TP_TRAIN_LAYERS)
    p16 = tp_params(cfg16, mesh)
    tp_train_step(cfg16, p16, mesh)                    # warm-up
    bf16 = tp_train_step(cfg16, p16, mesh)
    bf16.pop("params")
    bf16.pop("mu")
    bf16["k1"] = k1_by_direction(bf16["launches"])
    return {"fp32": out, "bf16": bf16}


_ONE_DEVICE = {}


def one_device_train_steps():
    """Phases 24's and 26's one-device steps (this process), run once for
    both: the fp32 step (of its params, gradients and moments, ~26 GB,
    only the new params and the first moment stay on the card, shared
    with the ranks through CUDA IPC) and a bf16 step timed after a
    warm-up."""
    if not _ONE_DEVICE:
        from repro_torch.optim.adamw import tree_leaves
        t0 = time.perf_counter()
        cfg = tp_config("float32", TP_TRAIN_LAYERS)
        params = tp_params(cfg, None)
        one = tp_train_step(cfg, params, None)
        del params
        ref_params, ref_mu = one.pop("params"), one.pop("mu")
        gc.collect()
        torch.cuda.empty_cache()
        cfg16 = tp_config("bfloat16", TP_TRAIN_LAYERS)
        p16 = tp_params(cfg16, None)
        tp_train_step(cfg16, p16, None)                    # warm-up
        one16 = tp_train_step(cfg16, p16, None)
        one16.pop("params")
        one16.pop("mu")
        del p16
        gc.collect()
        torch.cuda.empty_cache()
        # fp32 params and AdamW's two fp32 moments
        state = 3 * sum(t.numel() * t.element_size()
                        for t in tree_leaves(ref_params))
        _ONE_DEVICE.update(fp32=one, bf16=one16, ref_params=ref_params,
                           ref_mu=ref_mu, state_bytes=state,
                           seconds=time.perf_counter() - t0)
    return _ONE_DEVICE


def release_one_device_train_steps() -> None:
    _ONE_DEVICE.clear()
    gc.collect()
    torch.cuda.ipc_collect()
    torch.cuda.empty_cache()


def run_tp_train_phase():
    """Phase 24. The one-device steps first (:func:`one_device_train_steps`,
    kept for phase 26), then TP_WORLD ranks on the card, each held to the
    one-device fp32 step (:func:`check_adamw_gate`: loss within
    TP_TRAIN_LOSS_RTOL, grad norm within GEMM_TOLS["float32"], first
    moment's leaves within TP_TRAIN_GRAD_RTOL, param slices within
    GEMM_TOLS["float32"]), the loss vocab-parallel; K1 on the CUDA cores
    forward and backward, nothing else launched; then a bf16 step on each
    rank timed, K1 on wgmma."""
    import tempfile

    from repro_torch.distributed.launch import spawn

    t0 = time.perf_counter()
    od = one_device_train_steps()
    one, one16 = od["fp32"], od["bf16"]
    t_one = time.perf_counter() - t0
    log(f"tp-train: the one-device steps took {od['seconds']:.1f} s (fp32 "
        f"loss {one['loss']:.6f}); starting {TP_WORLD} ranks")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tpt_") as work:
        ranks = spawn(tp_train_rank, TP_WORLD,
                      (str(ROOT), od["ref_params"], od["ref_mu"]),
                      workdir=work, timeout_s=TP_RANKS_TIMEOUT_S,
                      collective_timeout_s=TP_COLLECTIVE_TIMEOUT_S)
    gc.collect()
    torch.cuda.ipc_collect()
    t_ranks = time.perf_counter() - t0 - t_one
    for r, rk in enumerate(ranks):
        if not rk["fp32"]["vocab_parallel"]:
            fail(f"tp-train rank {r}: the loss is not vocab-parallel")
        check_adamw_gate(f"tp-train rank {r}", rk["fp32"], one)
        check_counts(f"tp-train rank {r} bf16 step", rk["bf16"]["launches"],
                     K1_TRAIN)
        c = rk["bf16"]["launches"]
        if any(c[k] for k in FORWARD_ONLY):
            fail(f"tp-train rank {r}: a forward-only kernel launched "
                 f"({ {k: c[k] for k in FORWARD_ONLY} })")
        if rk["bf16"]["collectives"]["calls"]["broadcast"]:
            fail(f"tp-train rank {r}: a broadcast in the step")
    r0 = ranks[0]
    res = {"seconds_one_device": od["seconds"], "seconds_ranks": t_ranks,
           "batch": [TP_TRAIN_BATCH, TP_TRAIN_SEQ],
           "one_device": {"fp32": one, "bf16": one16}, "ranks": ranks,
           "fp32_loss_rel_diff": [abs(rk["fp32"]["loss"] - one["loss"])
                                  / abs(one["loss"]) for rk in ranks],
           "fp32_grad_norm": [one["grad_norm"]]
           + [rk["fp32"]["grad_norm"] for rk in ranks],
           "fp32_grad_leaf_max_rel_diff": [
               rk["fp32"]["grad_leaf_max_rel_diff"] for rk in ranks],
           "fp32_param_max_abs_diff": [rk["fp32"]["param_max_abs_diff"]
                                       for rk in ranks],
           "fp32_settled_param_max_abs_diff": [
               rk["fp32"]["settled_param_max_abs_diff"] for rk in ranks],
           "fp32_unsettled_outside_tol": [
               rk["fp32"]["unsettled_outside_tol"] for rk in ranks],
           "bf16_step_ms_one_device": one16["wall_ms"],
           "bf16_step_ms_ranks": [rk["bf16"]["wall_ms"] for rk in ranks],
           "collectives_per_step": {"fp32": r0["fp32"]["collectives"],
                                    "bf16": r0["bf16"]["collectives"]}}
    log(f"tp-train {TP_ARCH} ({TP_TRAIN_LAYERS} layers, full width, B "
        f"{TP_TRAIN_BATCH} x {TP_TRAIN_SEQ}) at tp{TP_WORLD}, vocab-parallel "
        f"loss: fp32 loss rel |d| {res['fp32_loss_rel_diff']}, grad norm "
        f"(one device, ranks) {res['fp32_grad_norm']}, worst gradient leaf "
        f"rel |d| {res['fp32_grad_leaf_max_rel_diff']}, params max |d| "
        f"{res['fp32_param_max_abs_diff']} of the one-device step's "
        f"({res['fp32_settled_param_max_abs_diff']} where the update is "
        f"settled; {res['fp32_unsettled_outside_tol']} unsettled elements "
        f"outside TOLS); K1 a "
        f"rank, fp32 {r0['fp32']['k1']}, bf16 {r0['bf16']['k1']}; "
        f"collectives a step, fp32 {r0['fp32']['collectives']}, bf16 "
        f"{r0['bf16']['collectives']}; bf16 step "
        f"{res['bf16_step_ms_ranks']} ms a rank vs {one16['wall_ms']:.1f} ms "
        f"on one device; phase {t_one:.1f} s one device + {t_ranks:.1f} s "
        f"ranks")
    return res


# ---------------------------------------------------------------------------
# Phase 26: FSDP over data on the card
# ---------------------------------------------------------------------------

FSDP_DATA = 2                  # data ranks; the 2 x 2 mesh adds 2 model ranks


def fsdp_closed_form(cfg, mesh):
    """The all-gathers and reduce-scatters of one FSDP train step of
    ``cfg`` (dense, no hybrid) at ``mesh``'s rank: every leaf the data
    axis cuts gathered where the model uses it — a layer's again in
    remat's recompute — and its gradient reduce-scattered once; calls and
    bytes as ``tp.collectives`` counts them (the gathered leaf, the rank's
    cut)."""
    from repro_torch.distributed import fsdp as FSDP
    from repro_torch.launch import steps as ST
    from repro_torch.models import transformer as T
    from repro_torch.optim.adamw import tree_leaves

    held = ST.rank_params(cfg, T.init_model(cfg, device="meta"), mesh)
    ctx = FSDP.make_context(cfg, mesh)
    out = {"calls": {"all_gather": 0, "reduce_scatter": 0},
           "bytes": {"all_gather": 0, "reduce_scatter": 0}}
    if ctx is None:
        return out
    keys = [k for k in sorted(held) for _ in tree_leaves(held[k])]
    for key, (t, cut) in zip(keys, FSDP.leaves_with_cuts(held, ctx)):
        if cut is None:
            continue
        gathers = 2 if (key == "layers" or key.startswith("dense_layer")) \
            and cfg.remat else 1
        nbytes = t.numel() * t.element_size()
        out["calls"]["all_gather"] += gathers
        out["bytes"]["all_gather"] += gathers * nbytes * ctx.size
        out["calls"]["reduce_scatter"] += 1
        out["bytes"]["reduce_scatter"] += nbytes
    return out


def fsdp_rank(rank, world, root, ref_params, model):
    """One rank of phase 26 on cuda:0, on the (FSDP_DATA, ``model``) mesh:
    the fp32 step from its share of the seeded weights (its cut over data,
    its slices over model), held to the one-device step
    (:func:`adamw_gate`: loss, grad norm and params; the first moment, phase
    24's, is not kept for this phase: two ranks' states and the card's
    copy of the one-device moment do not fit beside each other); the bytes
    of the params and moments it held, the collectives' closed form at
    its coordinates; on the DP mesh, then one bf16 step timed.
    ``ref_params`` comes through CUDA IPC: read, never written."""
    sys.path.insert(0, str(Path(root) / "src"))
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim.adamw import tree_leaves

    mesh = make_host_mesh(model=model)
    cfg = tp_config("float32", TP_TRAIN_LAYERS)
    init = tp_params(cfg, mesh)
    held = 3 * sum(t.numel() * t.element_size() for t in tree_leaves(init))
    torch.cuda.reset_peak_memory_stats()
    out = tp_train_step(cfg, init, mesh)
    out["peak_allocated_bytes"] = torch.cuda.max_memory_allocated()
    out.update(adamw_gate(cfg, mesh, out, init, ref_params),
               k1=k1_by_direction(out["launches"]), state_bytes=held,
               closed_form=fsdp_closed_form(cfg, mesh),
               coords=dict(mesh.coords))
    release_shared(ref_params)
    del init, ref_params
    gc.collect()
    torch.cuda.empty_cache()
    res = {"fp32": out}
    if model == 1:               # one step: the fp32 step warmed the ranks
        cfg16 = tp_config("bfloat16", TP_TRAIN_LAYERS)
        p16 = tp_params(cfg16, mesh)
        bf16 = tp_train_step(cfg16, p16, mesh)
        bf16.pop("params")
        bf16.pop("mu")
        bf16["k1"] = k1_by_direction(bf16["launches"])
        res["bf16"] = bf16
    return res


def run_fsdp_phase():
    """Phase 26. Phase 24's one-device steps (run here if phase 24 did not
    run; its first moment is freed here), then the same qwen3-8b step on
    FSDP_DATA ranks (DP with FSDP) and on the FSDP_DATA x 2 mesh (FSDP and
    TP=2), every rank on the card: each held to the one-device fp32 step
    as phase 24 holds its ranks but for the moment
    (:func:`check_adamw_gate`); a rank's param and moment bytes stated
    beside the one-device state's; its all-gathers and reduce-scatters
    equal to their closed form, and every collective (kinds, calls,
    bytes) equal to the dry run's of the same cell on ``Mesh.abstract``
    at the rank's coordinates; on the DP mesh a bf16 step a rank timed,
    K1 on wgmma."""
    import tempfile

    from repro_torch.distributed.launch import spawn
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch.mesh import Mesh

    t0 = time.perf_counter()
    od = one_device_train_steps()
    one = od["fp32"]
    od.pop("ref_mu", None)             # phase 24's alone: the card's room
    gc.collect()
    torch.cuda.empty_cache()
    res = {"one_device_state_bytes": od["state_bytes"],
           "batch": [TP_TRAIN_BATCH, TP_TRAIN_SEQ]}
    cfg = tp_config("float32", TP_TRAIN_LAYERS)
    for model in (1, 2):
        name = f"dp{FSDP_DATA}" + ("" if model == 1 else f"_tp{model}")
        world = FSDP_DATA * model
        t1 = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix="chip_smoke_fsdp_") as work:
            ranks = spawn(fsdp_rank, world,
                          (str(ROOT), od["ref_params"], model),
                          workdir=work, timeout_s=TP_RANKS_TIMEOUT_S,
                          collective_timeout_s=TP_COLLECTIVE_TIMEOUT_S)
        gc.collect()
        torch.cuda.ipc_collect()
        t_ranks = time.perf_counter() - t1
        dry = []
        for r, rk in enumerate(ranks):
            f = rk["fp32"]
            tag = f"fsdp {name} rank {r}"
            check_adamw_gate(tag, f, one)
            got = f["collectives"]
            want = f["closed_form"]
            if {k: got["calls"][k] for k in want["calls"]} != \
                    want["calls"] or {k: got["bytes"][k] for k in
                                      want["bytes"]} != want["bytes"]:
                fail(f"{tag}: all-gathers and reduce-scatters {got} differ "
                     f"from their closed form {want}")
            d = DR.run_step(cfg, "train", TP_TRAIN_BATCH, TP_TRAIN_SEQ,
                            mesh=Mesh.abstract((FSDP_DATA, model),
                                               ("data", "model"), rank=r))
            if d["collective_counts"] != got["calls"] or {
                    k: d["collectives"][k] for k in got["bytes"]} != {
                    k: float(v) for k, v in got["bytes"].items()}:
                fail(f"{tag}: collectives {got} differ from the dry run's "
                     f"on Mesh.abstract ({d['collective_counts']}, "
                     f"{d['collectives']})")
            dry.append({"calls": d["collective_counts"],
                        "bytes": d["collectives"]})
            if "bf16" in rk:
                check_counts(f"{tag} bf16 step", rk["bf16"]["launches"],
                             K1_TRAIN)
                if any(rk["bf16"]["launches"][k] for k in FORWARD_ONLY):
                    fail(f"{tag}: a forward-only kernel launched in bf16")
        f0 = ranks[0]["fp32"]
        res[name] = {
            "ranks": ranks, "seconds": t_ranks, "dry_run_collectives": dry,
            "fp32_loss_rel_diff": [abs(rk["fp32"]["loss"] - one["loss"])
                                   / abs(one["loss"]) for rk in ranks],
            "fp32_grad_norm": [one["grad_norm"]]
            + [rk["fp32"]["grad_norm"] for rk in ranks],
            "fp32_param_max_abs_diff": [rk["fp32"]["param_max_abs_diff"]
                                        for rk in ranks],
            "fp32_unsettled_outside_tol": [
                rk["fp32"]["unsettled_outside_tol"] for rk in ranks],
            "state_bytes": [rk["fp32"]["state_bytes"] for rk in ranks],
            "peak_allocated_bytes": [rk["fp32"]["peak_allocated_bytes"]
                                     for rk in ranks],
            "bf16_step_ms_ranks": [rk["bf16"]["wall_ms"] for rk in ranks
                                   if "bf16" in rk]}
        log(f"fsdp {TP_ARCH} ({TP_TRAIN_LAYERS} layers, full width, B "
            f"{TP_TRAIN_BATCH} x {TP_TRAIN_SEQ}) on {name}: fp32 loss rel "
            f"|d| {res[name]['fp32_loss_rel_diff']}, grad norm (one "
            f"device, ranks) {res[name]['fp32_grad_norm']}, params max |d| "
            f"{res[name]['fp32_param_max_abs_diff']}; params + moments "
            f"{res[name]['state_bytes']} bytes a rank vs "
            f"{od['state_bytes']} on one device, fp32 step peak "
            f"{res[name]['peak_allocated_bytes']} bytes allocated a rank; "
            f"collectives a step "
            f"(rank 0, fp32) {f0['collectives']} = closed form and dry "
            f"run; K1 rank 0 fp32 {f0['k1']}; bf16 step "
            f"{res[name]['bf16_step_ms_ranks']} ms a rank vs "
            f"{od['bf16']['wall_ms']:.1f} ms on one device; "
            f"{t_ranks:.1f} s")
    res["seconds"] = time.perf_counter() - t0
    log(f"fsdp: phase {res['seconds']:.1f} s")
    return res


# ---------------------------------------------------------------------------
# Phase 27: expert parallelism over model on the card
# ---------------------------------------------------------------------------

EP_ARCH = "dbrx-132b"
EP_LAYERS = 1                  # of dbrx-132b's 40, at full width: the card
EP_WORLD = 2                   # the (1, 2) mesh: 8 of the 16 experts a rank
EP_BATCH, EP_SEQ = 2, 64
EP_LOSS_RTOL = 1e-6            # loss, aux and grad norm against one device
# Each expert's bank-gradient slice on a rank, ||g - g_one|| / ||g_one||
# over the one-device gradient's same slice: a slice of the wrong expert,
# zero or scaled is off by 0.5 or more, the fp32 sums' other order by
# ~1e-7 (phase 24's gate on its gradient leaves).
EP_GRAD_RTOL = TP_TRAIN_GRAD_RTOL


def ep_config(dtype):
    """dbrx-132b at full width (d 6144, 16 experts x d_ff 10752, top-4,
    vocab 100352) and EP_LAYERS layers."""
    from repro_torch.configs.registry import get_config
    return dataclasses.replace(get_config(EP_ARCH), n_layers=EP_LAYERS,
                               dtype=dtype)


def ep_projection_cells(cfg, world):
    """(name, K, N, forward out) of K1's products in a dbrx layer and the
    head on a rank of the (1, ``world``) mesh (1: one device): q's
    columns, o's rows and the head's vocab cut over model (o's partial
    sums in fp32 when cut), the KV projections whole (dbrx's rules
    replicate its 8 KV heads), the router whole on every rank."""
    d, dh = cfg.d_model, cfg.head_dim
    qd, kvd = cfg.n_heads * dh, cfg.n_kv_heads * dh
    return (("q", d, qd // world, None), ("k/v", d, kvd, None),
            ("o", qd // world, d, "float32" if world > 1 else None),
            ("router", d, cfg.n_experts, None),
            ("head", d, cfg.vocab // world, None))


def ep_path(world):
    return (f"{EP_ARCH} one-device forward+backward" if world == 1 else
            f"{EP_ARCH} ep{world} rank forward+backward")


def run_ep_kernel_phase(timer):
    """Phase 27's kernel cells: K1 at the shapes of the dbrx step on one
    device and on an EP_WORLD rank (:func:`ep_projection_cells`, the
    batch grid at the rank's heads), forward, dA and dW, bf16 on wgmma
    and fp32 on the CUDA cores, each held to its plain version
    (:func:`run_train_kernel_phase`)."""
    cfg = ep_config("bfloat16")
    rows = []
    for world in (1, EP_WORLD):
        rows += run_train_kernel_phase(
            timer, cfg, M=EP_BATCH * EP_SEQ,
            problems=EP_BATCH * cfg.n_heads // world, seq=EP_SEQ,
            projections=ep_projection_cells(cfg, world),
            dtypes=("bfloat16", "float32"),
            path=lambda direction, world=world: ep_path(world),
            tag=f"{EP_ARCH} {'one device' if world == 1 else 'ep rank'} ",
            seed=27 + world)
    return rows


def bank_bytes(params):
    return sum(t.numel() * t.element_size() for lp in params["layers"]
               for k, t in lp["moe"].items() if k in ("wi", "wo"))


def ep_forward_backward(cfg, params, mesh):
    """One forward and backward of ``lm_loss`` (unfused attention, every
    GEMM through K1; the banks' products ``torch.einsum``) of ``params``
    (a rank's share on ``mesh``, or whole): loss, aux, the global grad
    norm (``steps._grad_norm``, as the train step takes it), the
    gradients, launches, collectives, host wall time and peak
    allocation."""
    from repro_torch.core import api
    from repro_torch.core.plan import UNFUSED, GemmPolicy
    from repro_torch.distributed import tp as TP
    from repro_torch.launch import steps as ST
    from repro_torch.models import transformer as T

    batch = tp_train_batch(cfg, EP_BATCH, EP_SEQ)
    tpctx = ST.tp_context(cfg, mesh)
    shapes = T.init_model(cfg, device="meta")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    TP.collectives.reset()
    t0 = time.perf_counter()
    with api.use_policy(GemmPolicy()), api.use_attention_policy(UNFUSED), \
            TP.use_tp(tpctx):
        (loss, met), grads = ST.value_and_grad(
            lambda p: T.lm_loss(p, cfg, batch), params)
        gnorm = ST._grad_norm(grads, shapes, tpctx, None)
    out = dict(loss=float(loss), aux=float(met["aux"]),
               grad_norm=float(gnorm))
    torch.cuda.synchronize()
    out.update(grads=grads, launches=counts(),
               collectives=TP.collectives.snapshot(),
               wall_ms=(time.perf_counter() - t0) * 1e3,
               peak_allocated_bytes=torch.cuda.max_memory_allocated())
    return out


def ep_rank(rank, world, root, ref_banks):
    """One rank of phase 27 on cuda:0, on the (1, EP_WORLD) mesh: the fp32
    forward and backward on its share of the seeded weights (its experts'
    slice of both banks, its heads and vocab slices), each expert's
    bank-gradient slice held to the one-device step's (``ref_banks``: the
    parent's gradients of ``wi`` and ``wo`` on the card, shared through
    CUDA IPC, read and never written): elements within GEMM_TOLS, and
    ||g - g_one|| / ||g_one|| an expert; then a bf16 forward and backward
    timed after a warm-up."""
    sys.path.insert(0, str(Path(root) / "src"))
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.launch.mesh import make_host_mesh

    mesh = make_host_mesh(model=world)
    cfg = ep_config("float32")
    held = tp_params(cfg, mesh)
    out = ep_forward_backward(cfg, held, mesh)
    moe = out.pop("grads")["layers"][0]["moe"]
    banks = {k: moe[k] for k in ("wi", "wo")}
    e = cfg.n_experts // world
    e0 = mesh.coords["model"] * e
    out.update(bank_bytes=bank_bytes(held), experts=[e0, e0 + e],
               k1=k1_by_direction(out["launches"]), coords=dict(mesh.coords))
    del held, moe                # the card's room: two ranks share it
    gc.collect()
    torch.cuda.empty_cache()
    atol, rtol = GEMM_TOLS["float32"]
    outside, worst, worst_rel = 0, 0.0, 0.0
    norms = {}
    for k, got in banks.items():
        for j in range(e):              # an expert at a time
            want = ref_banks[k][e0 + j]
            d = (got[j] - want).abs()
            outside += int((d > atol + rtol * want.abs()).sum())
            worst = max(worst, float(d.max()))
            g_norm = float(torch.linalg.vector_norm(want))
            d_norm = float(torch.linalg.vector_norm(d))
            worst_rel = max(worst_rel, d_norm / g_norm if g_norm else
                            (0.0 if d_norm == 0 else float("inf")))
            norms.setdefault(k, []).append(g_norm)
            del want, d
    out.update(bank_grad_outside_tol=outside, bank_grad_max_abs_diff=worst,
               bank_grad_max_rel_diff=worst_rel,
               bank_grad_expert_norms=norms)
    release_shared(ref_banks)
    del banks, ref_banks
    gc.collect()
    torch.cuda.empty_cache()
    cfg16 = ep_config("bfloat16")
    p16 = tp_params(cfg16, mesh)
    ep_forward_backward(cfg16, p16, mesh)                # warm-up
    bf16 = ep_forward_backward(cfg16, p16, mesh)
    bf16.pop("grads")
    bf16["k1"] = k1_by_direction(bf16["launches"])
    return {"fp32": out, "bf16": bf16}


def run_ep_phase():
    """Phase 27. K1's cells at the step's shapes (:func:`run_ep_kernel_phase`);
    then dbrx-132b at full width, EP_LAYERS layer (one device cannot hold
    a full-width AdamW step even of one layer: ~4.49 G params x 16 B), B
    EP_BATCH x EP_SEQ: a bf16 forward and backward timed on one device,
    then the fp32 one, of which the bank gradients stay on the card and
    the rest is freed; then EP_WORLD ranks of the card, each holding half
    the experts, held to it: loss, aux and grad norm within EP_LOSS_RTOL,
    the bank-gradient slices within GEMM_TOLS["float32"] and each
    expert's within EP_GRAD_RTOL of its norm; a rank's bank bytes exactly
    1 / EP_WORLD of the one-device banks'; its collectives (kinds, calls,
    bytes) equal to the dry run's of the same cell on ``Mesh.abstract``;
    K1 on the CUDA cores in fp32 and on wgmma in bf16, as many launches
    as the kernel cells' uses, nothing else launched; a bf16 forward and
    backward timed on each rank."""
    import tempfile

    from repro_torch.distributed.launch import spawn
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch.mesh import Mesh

    t0 = time.perf_counter()
    held_at_start = torch.cuda.memory_allocated()
    timer = Timer()
    kernels = run_ep_kernel_phase(timer)
    del timer
    gc.collect()
    torch.cuda.empty_cache()
    t_kernels = time.perf_counter() - t0
    cfg16 = ep_config("bfloat16")
    p16 = tp_params(cfg16, None)
    ep_forward_backward(cfg16, p16, None)                # warm-up
    one16 = ep_forward_backward(cfg16, p16, None)
    one16.pop("grads")
    del p16
    gc.collect()
    torch.cuda.empty_cache()
    cfg = ep_config("float32")
    params = tp_params(cfg, None)
    one = ep_forward_backward(cfg, params, None)
    grads = one.pop("grads")
    one_banks = bank_bytes(params)
    ref_banks = {k: grads["layers"][0]["moe"][k] for k in ("wi", "wo")}
    one["bank_grad_max_abs"] = {k: float(g.abs().max())
                                for k, g in ref_banks.items()}
    one["bank_grad_norm"] = {k: float(torch.linalg.vector_norm(g))
                             for k, g in ref_banks.items()}
    del params, grads
    gc.collect()
    torch.cuda.empty_cache()
    t_one = time.perf_counter() - t0 - t_kernels
    log(f"ep: {held_at_start} bytes allocated here at the start; the "
        f"kernel cells took {t_kernels:.1f} s, the one-device bf16 "
        f"and fp32 forward+backward {t_one:.1f} s (fp32 loss "
        f"{one['loss']:.6f}; bank gradients max |g| "
        f"{one['bank_grad_max_abs']}, norm {one['bank_grad_norm']}); "
        f"starting {EP_WORLD} ranks")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ep_") as work:
        ranks = spawn(ep_rank, EP_WORLD, (str(ROOT), ref_banks), workdir=work,
                      timeout_s=TP_RANKS_TIMEOUT_S,
                      collective_timeout_s=TP_COLLECTIVE_TIMEOUT_S)
    del ref_banks
    gc.collect()
    torch.cuda.ipc_collect()
    torch.cuda.empty_cache()
    t_ranks = time.perf_counter() - t0 - t_kernels - t_one
    uses = sum(r["uses"] for r in kernels
               if r["path"] == ep_path(EP_WORLD) and r["dtype"] == "bfloat16")
    dry = []
    for r, rk in enumerate(ranks):
        f, tag = rk["fp32"], f"ep rank {r}"
        for k in ("loss", "aux", "grad_norm"):
            rel = abs(f[k] - one[k]) / abs(one[k])
            if not rel <= EP_LOSS_RTOL:
                fail(f"{tag}: fp32 {k} {f[k]} vs one device {one[k]} "
                     f"(relative {rel:.2e} > {EP_LOSS_RTOL})")
        if f["bank_grad_outside_tol"]:
            fail(f"{tag}: {f['bank_grad_outside_tol']} bank-gradient "
                 f"elements outside GEMM_TOLS['float32'] of the one-device "
                 f"slices (max |d| {f['bank_grad_max_abs_diff']:.3e})")
        if not f["bank_grad_max_rel_diff"] <= EP_GRAD_RTOL:
            fail(f"{tag}: an expert's bank gradient "
                 f"{f['bank_grad_max_rel_diff']:.3e} of its norm from the "
                 f"one-device slice's (> {EP_GRAD_RTOL})")
        if f["bank_bytes"] * EP_WORLD != one_banks:
            fail(f"{tag}: holds {f['bank_bytes']} bytes of the banks, not "
                 f"1/{EP_WORLD} of {one_banks}")
        check_counts(f"{tag} fp32", f["launches"],
                     ("matrixflow_gemm", "matrixflow_gemm_cuda_core",
                      "matrixflow_gemm_backward", "matrixflow_gemm_batched"),
                     allowed=CUDA_CORE_COUNTERS)
        check_counts(f"{tag} bf16", rk["bf16"]["launches"], K1_TRAIN)
        for dt in ("fp32", "bf16"):
            if any(rk[dt]["launches"][k] for k in FORWARD_ONLY):
                fail(f"{tag}: a forward-only kernel launched in {dt}")
            if rk[dt]["launches"]["matrixflow_gemm"] != uses:
                fail(f"{tag}: {rk[dt]['launches']['matrixflow_gemm']} K1 "
                     f"launches in {dt}, the kernel cells' uses {uses}")
        got = f["collectives"]
        d = DR.run_step(cfg, "train", EP_BATCH, EP_SEQ,
                        mesh=Mesh.abstract((1, EP_WORLD), ("data", "model"),
                                           rank=r))
        if d["collective_counts"] != got["calls"] or {
                k: d["collectives"][k] for k in got["bytes"]} != {
                k: float(v) for k, v in got["bytes"].items()}:
            fail(f"{tag}: collectives {got} differ from the dry run's on "
                 f"Mesh.abstract ({d['collective_counts']}, "
                 f"{d['collectives']})")
        if [p["part"] for p in d["parts_from_reference"]
                if p["part"] == "MoE expert banks"]:
            fail(f"{tag}: the dry run names the MoE banks as a departure")
        dry.append({"calls": d["collective_counts"],
                    "bytes": d["collectives"],
                    "args_bytes": d["memory"]["argument_size_in_bytes"]})
    res = {"layers": EP_LAYERS, "batch": [EP_BATCH, EP_SEQ],
           "seconds_kernels": t_kernels, "seconds_one_device": t_one,
           "seconds_ranks": t_ranks, "kernels": kernels,
           "allocated_bytes_at_start": held_at_start,
           "one_device": {"fp32": one, "bf16": one16,
                          "bank_bytes": one_banks},
           "ranks": ranks, "dry_run": dry}
    f0 = ranks[0]["fp32"]
    smallest = [min(min(v) for v in rk["fp32"]["bank_grad_expert_norms"]
                    .values()) for rk in ranks]
    log(f"ep {EP_ARCH} ({EP_LAYERS} layer, full width, B {EP_BATCH} x "
        f"{EP_SEQ}) on (1, {EP_WORLD}): fp32 loss (one device, ranks) "
        f"{[one['loss']] + [rk['fp32']['loss'] for rk in ranks]}, aux "
        f"{[one['aux']] + [rk['fp32']['aux'] for rk in ranks]}, grad norm "
        f"{[one['grad_norm']] + [rk['fp32']['grad_norm'] for rk in ranks]}; "
        f"bank gradients max |d| "
        f"{[rk['fp32']['bank_grad_max_abs_diff'] for rk in ranks]} (max |g| "
        f"{one['bank_grad_max_abs']}), worst expert ||d|| / ||g|| "
        f"{[rk['fp32']['bank_grad_max_rel_diff'] for rk in ranks]}, "
        f"smallest expert ||g|| {smallest}; bank "
        f"bytes a rank {[rk['fp32']['bank_bytes'] for rk in ranks]} of "
        f"{one_banks}; collectives (rank 0, fp32) {f0['collectives']} = dry "
        f"run; K1 rank 0 fp32 {f0['k1']}, bf16 {ranks[0]['bf16']['k1']}; "
        f"peak allocated a rank "
        f"{[rk['fp32']['peak_allocated_bytes'] for rk in ranks]} vs "
        f"{one['peak_allocated_bytes']} on one device; bf16 forward+"
        f"backward {[rk['bf16']['wall_ms'] for rk in ranks]} ms a rank vs "
        f"{one16['wall_ms']:.1f} ms on one device; phase "
        f"{time.perf_counter() - t0:.1f} s")
    res["seconds"] = time.perf_counter() - t0
    return res


# ---------------------------------------------------------------------------
# Phase 28: the pod axis and int8 compression on meshes that cut the params
# ---------------------------------------------------------------------------

POD_BATCH, POD_SEQ = 8, 128
POD_LAYERS = 4                 # of smollm-135m's 30, at full width: the time
# (pod, data, model) of the meshes, four ranks each: FSDP over data with
# the pod axis; the model cut without compression, then with it and the
# amax over the model cut (pod_rank runs them in this order)
POD_MESHES = {"pod2_dp2": ((2, 1), False), "pod2_tp2_plain": ((2, 2), False),
              "pod2_tp2": ((2, 2), True)}
# An element whose one-device r = |g| / scale lies within tie_window(dr)
# of a half-integer may round to the other int8 value on a rank, whose
# fp32 sums run in another order. Its r parts from one device's through g
# and through the scale. g's part is measured in the same run, a leaf at a
# time: dr, the leaf's largest parting of an element's r in the step
# without compression on the same mesh, whose sums the compressed step
# repeats before it quantizes (adamw_gate's r_parting_by_leaf). An fp32
# sum's error follows the magnitude of its terms, not of the element, so
# dr is taken over every element, in r's own units. The scale's part is r
# / 127 times the amax element's parting of r: no more than about dr
# again. The fixed predecessor, 1e-4 in r, missed a tie at r 14.50015
# (1.507e-4 from the half-integer) at 4 layers.
POD_TIE_FACTOR = 2.0
# a tie rounded the other way parts by one int8 step (1.0000004 measured)
POD_TIE_QUANTA = 1.5


def tie_window(dr):
    """The distance from a half-integer within which a leaf's |g| / scale
    may round the other way, given its measured largest parting ``dr``."""
    return POD_TIE_FACTOR * dr


def pod_config():
    """smollm-135m at full width, POD_LAYERS layers, fp32."""
    from repro_torch.configs.registry import get_config
    return dataclasses.replace(get_config(ARCH), dtype="float32",
                               n_layers=POD_LAYERS)


def quantization_ties(grads):
    """|g| / scale of every element of ``grads`` (one device's), the
    scale the step's (``steps._grad_amax``: a layer's leaf scaled as the
    reference's stacked tensor): an element within :func:`tie_window` of
    a half-integer is at an int8 rounding tie (:func:`tie_distance`)."""
    from repro_torch.launch import steps as ST
    from repro_torch.optim.adamw import tree_map

    return tree_map(lambda g, amax: g.abs() / (torch.clamp(amax, min=1e-12)
                                               / 127.0),
                    grads, ST._grad_amax(grads, None, None))


def tie_distance(r):
    """How far each |g| / scale of ``r`` lies from a half-integer."""
    return (r - torch.floor(r) - 0.5).abs()


def pod_rank(rank, world, root, refs, ties):
    """One rank of phase 28 on cuda:0: on each mesh of POD_MESHES the fp32
    step (compressed on the last) from its share of the seeded weights,
    held to the one-device step (``refs``: the plain and the compressed
    step's (params, first moment); ``ties``: the compressed step's
    |g| / scale, :func:`quantization_ties`; through CUDA IPC); the
    compressed step's tie window from the plain step's on its mesh."""
    sys.path.insert(0, str(Path(root) / "src"))
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.launch.mesh import make_host_mesh

    cfg = pod_config()
    batch = tp_train_batch(cfg, POD_BATCH, POD_SEQ)
    out, r_parting = {}, {}
    for name, ((pod, model), compress) in POD_MESHES.items():
        mesh = make_host_mesh(pod=pod, model=model)
        init = tp_params(cfg, mesh)
        f = tp_train_step(cfg, init, mesh, batch=batch, compress=compress)
        ref_params, ref_mu = refs[compress]
        f.update(adamw_gate(cfg, mesh, f, init, ref_params, ref_mu,
                            ties=ties if compress else None,
                            tie_dr=r_parting.get((pod, model)),
                            measure=None if compress else ties),
                 k1=k1_by_direction(f["launches"]),
                 coords=dict(mesh.coords))
        if not compress:
            r_parting[pod, model] = f["r_parting_by_leaf"]
        out[name] = f
        del init, ref_params, ref_mu
        gc.collect()
        torch.cuda.empty_cache()
    release_shared(refs, ties)
    return out


def run_pod_phase():
    """Phase 28. smollm-135m at full width, POD_LAYERS layers, B POD_BATCH x
    POD_SEQ, one fp32 AdamW step: on one device, plain and with
    ``compress_grads``; then four ranks of the card on (pod 2, data 2,
    model 1), FSDP over data, held to the plain step, on (pod 2, data 1,
    model 2) held to it too, and there with compression, the amax reduced
    over the model cut, held to the compressed step (an element outside
    the tolerance only at a quantization tie, within :func:`tie_window`
    of a half-integer); each as phase 24 holds its ranks (loss,
    grad norm, params, and the first moment, which carries the
    dequantized gradient itself: each leaf's ||mu - mu_one|| / ||mu_one||
    within TP_TRAIN_GRAD_RTOL, the recorded ties left out); rank 0's collectives, by kind and by the axes each
    went over (the pod all-reduce), equal to the dry run's of the same
    cell on ``Mesh.abstract``."""
    import tempfile

    from repro_torch.core import api
    from repro_torch.core.plan import UNFUSED, GemmPolicy
    from repro_torch.distributed.launch import spawn
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch import steps as ST
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import transformer as T

    t0 = time.perf_counter()
    cfg = pod_config()
    batch = tp_train_batch(cfg, POD_BATCH, POD_SEQ)
    one, refs = {}, {}
    for compress in (False, True):
        params = tp_params(cfg, None)
        one[compress] = tp_train_step(cfg, params, None, batch=batch,
                                      compress=compress)
        refs[compress] = (one[compress].pop("params"),
                          one[compress].pop("mu"))
    with api.use_policy(GemmPolicy()), api.use_attention_policy(UNFUSED):
        _, grads = ST.value_and_grad(lambda p: T.lm_loss(p, cfg, batch),
                                     params)
    ties = quantization_ties(grads)
    del params, grads
    gc.collect()
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_pod_") as work:
        ranks = spawn(pod_rank, 4, (str(ROOT), refs, ties), workdir=work,
                      timeout_s=TP_RANKS_TIMEOUT_S,
                      collective_timeout_s=TP_COLLECTIVE_TIMEOUT_S)
    del refs, ties
    gc.collect()
    torch.cuda.ipc_collect()
    torch.cuda.empty_cache()
    t_ranks = time.perf_counter() - t1
    res = {"batch": [POD_BATCH, POD_SEQ], "seconds_ranks": t_ranks,
           "one_device": {"plain": one[False], "compressed": one[True]}}
    for name, ((pod, model), compress) in POD_MESHES.items():
        for r, rk in enumerate(ranks):
            check_adamw_gate(f"pod {name} rank {r}", rk[name], one[compress])
        got = ranks[0][name]
        d = DR.run_step(cfg, "train", POD_BATCH, POD_SEQ,
                        mesh=Mesh.abstract((pod, 4 // (pod * model), model),
                                           ("pod", "data", "model")),
                        compress_grads=compress)
        if d["collective_counts"] != got["collectives"]["calls"] or {
                k: d["collectives"][k] for k in got["collectives"]["bytes"]
        } != {k: float(v) for k, v in got["collectives"]["bytes"].items()} \
                or d["collectives_by_axes"] != got["by_axes"]:
            fail(f"pod {name} rank 0: collectives {got['collectives']} "
                 f"{got['by_axes']} differ from the dry run's on "
                 f"Mesh.abstract ({d['collective_counts']}, "
                 f"{d['collectives_by_axes']})")
        res[name] = {
            "ranks": [rk[name] for rk in ranks],
            "dry_run_by_axes": d["collectives_by_axes"],
            "fp32_loss_rel_diff": [abs(rk[name]["loss"] - one[compress]
                                       ["loss"]) / abs(one[compress]["loss"])
                                   for rk in ranks],
            "fp32_grad_norm": [one[compress]["grad_norm"]]
            + [rk[name]["grad_norm"] for rk in ranks],
            "fp32_param_max_abs_diff": [rk[name]["param_max_abs_diff"]
                                        for rk in ranks],
            "fp32_grad_leaf_max_rel_diff": [
                rk[name]["grad_leaf_max_rel_diff"] for rk in ranks],
            "tie_partings": [rk[name]["tie_partings"] for rk in ranks],
            "mu_tie_partings": [rk[name]["mu_tie_partings"]
                                for rk in ranks],
            "mu_worst_parting": [rk[name]["mu_worst_parting"]
                                 for rk in ranks],
            "mu_tie_elements": [rk[name]["mu_tie_elements"]
                                for rk in ranks],
            "r_parting_max": [max(rk[name]["r_parting_by_leaf"] or [None])
                              for rk in ranks]}
        pod_ar = got["by_axes"].get("all_reduce:pod")
        log(f"pod {ARCH} ({POD_LAYERS} layers, full width, B {POD_BATCH} x "
            f"{POD_SEQ}) on {name}"
            f"{' with compress_grads' if compress else ''}: fp32 loss rel "
            f"|d| {res[name]['fp32_loss_rel_diff']}, grad norm (one device, "
            f"ranks) {res[name]['fp32_grad_norm']}, params max |d| "
            f"{res[name]['fp32_param_max_abs_diff']}, worst first-moment "
            f"leaf rel |d| {res[name]['fp32_grad_leaf_max_rel_diff']}, "
            f"partings at ties (params) {res[name]['tie_partings']} (first "
            f"moment) {res[name]['mu_tie_partings']}, largest first-moment "
            f"parting outside them {res[name]['mu_worst_parting']}, "
            f"first-moment partings at ties {res[name]['mu_tie_elements']}, "
            f"largest parting of |g| / scale (no compression) "
            f"{res[name]['r_parting_max']}; pod "
            f"all-reduce (rank 0) {pod_ar} "
            f"vs dry run {d['collectives_by_axes'].get('all_reduce:pod')}; "
            f"collectives by axes {got['by_axes']}; K1 rank 0 "
            f"{got['k1']}")
    res["seconds"] = time.perf_counter() - t0
    log(f"pod: phase {res['seconds']:.1f} s ({t_ranks:.1f} s ranks)")
    return res


# ---------------------------------------------------------------------------
# Phase 32: sequence parallelism (act_seq -> model) in the train step
# ---------------------------------------------------------------------------

SEQPAR_RULES = {"act_seq": "model"}     # the reference's seqpar arm
# (b): smollm-135m at full width (9 heads: attention whole on every rank),
# SEQPAR_SMOLLM_LAYERS of its 30, remat "dots" (the seqpar_dots arm), on
# (data 2, model 2), B SEQPAR_SMOLLM_BATCH x TP_TRAIN_SEQ
SEQPAR_SMOLLM_LAYERS = 4
SEQPAR_SMOLLM_BATCH = 4


def seqpar_config(dtype):
    """(b)'s smollm-135m: full width, SEQPAR_SMOLLM_LAYERS layers, remat
    "dots"."""
    from repro_torch.configs.registry import get_config
    return dataclasses.replace(get_config(ARCH), dtype=dtype,
                               n_layers=SEQPAR_SMOLLM_LAYERS,
                               remat_policy="dots")


def seqpar_check(tag, cfg, f, mesh, rows, seq):
    """A rank's sequence-parallel step ``f``: its collectives over model
    equal the closed form and the dry run's on ``meta`` at the same
    shapes (every axis, kinds and bytes), its saved block inputs are the
    rank's 1/mp of the sequence, and K1 ran wgmma or the CUDA cores,
    nothing else."""
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch.mesh import Mesh
    sys.path.insert(0, str(ROOT / "tests"))
    from seqpar_form import closed_form
    mp = mesh.axis_size("model")
    e = torch.empty((), dtype=cfg.param_dtype).element_size()
    want = closed_form(cfg, rows, seq, mesh.axis_size("data"), mp, e)
    got = {k: (v["calls"], v["bytes"]) for k, v in f["by_axes"].items()
           if k.endswith(":model")}
    if got != {f"{k}:model": v for k, v in want.items()}:
        fail(f"{tag}: collectives over model {got} differ from the closed "
             f"form {want}")
    d = DR.run_step(cfg, "train", rows * mesh.axis_size("data"), seq,
                    mesh=Mesh.abstract((mesh.axis_size("data"), mp),
                                       ("data", "model")),
                    rules_overrides=SEQPAR_RULES)
    if d["collectives_by_axes"] != f["by_axes"]:
        fail(f"{tag}: collectives {f['by_axes']} differ from the dry run's "
             f"on Mesh.abstract ({d['collectives_by_axes']})")
    saved = cfg.n_layers * rows * (seq // mp) * cfg.d_model * e
    if f["saved_block_input_bytes"] != saved:
        fail(f"{tag}: remat saved {f['saved_block_input_bytes']} B of block "
             f"inputs, not the rank's rows' {saved}")
    if f["launches"]["matrixflow_gemm_mma"]:
        fail(f"{tag}: K1 took mma")
    return dict(closed_form=want, dry_run_by_axes=d["collectives_by_axes"],
                saved_block_input_bytes_whole_sequence=saved * mp)


def seqpar_rank(rank, world, root, refs, rows):
    """One rank of phase 32 on cuda:0. ``world`` 2, (a): qwen3-8b's fp32
    step on (model 2) under SEQPAR_RULES, from its slices of phase 24's
    seeded weights, held to phase 24's one-device step (``refs``: its
    params and first moment through CUDA IPC); then a bf16 step timed
    after a warm-up. ``world`` 4, (b): smollm-135m's fp32 step on (data 2,
    model 2) held to its one-device step (``refs``), then a bf16 step.
    ``rows`` is a data rank's rows of the batch."""
    sys.path.insert(0, str(Path(root) / "src"))
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.launch.mesh import make_host_mesh

    mesh = make_host_mesh(model=2)
    small = world == 4
    out = {}
    for dtype in ("float32", "bfloat16"):
        cfg = seqpar_config(dtype) if small else \
            tp_config(dtype, TP_TRAIN_LAYERS)
        batch = tp_train_batch(cfg, rows * mesh.axis_size("data"))
        init = tp_params(cfg, mesh)
        if dtype == "bfloat16":          # warm-up: the step is timed
            tp_train_step(cfg, init, mesh, batch=batch,
                          overrides=SEQPAR_RULES)
        f = tp_train_step(cfg, init, mesh, batch=batch,
                          overrides=SEQPAR_RULES)
        if dtype == "float32":
            f.update(adamw_gate(cfg, mesh, f, init, *refs))
            release_shared(*refs)
        f.pop("params", None)
        f.pop("mu", None)
        f.update(seqpar_check(f"seqpar rank {rank} {dtype}", cfg, f, mesh,
                              rows, TP_TRAIN_SEQ),
                 k1=k1_by_direction(f["launches"]),
                 coords=dict(mesh.coords))
        out[dtype] = f
        del init
        gc.collect()
        torch.cuda.empty_cache()
    return out


def run_seqpar_phase():
    """Phase 32. The reference's seqpar arm (``act_seq -> model``) in
    ``make_train_step_fn``: the residual stream a rank's 1/2 of the
    sequence, a block's input gathered over it and its row-parallel
    output reduce-scattered, K1 forward and backward on every projection.
    (a) qwen3-8b at full width, TP_TRAIN_LAYERS layers, phase 24's batch
    and weights, on (model 2): the fp32 step held to phase 24's
    one-device step (:func:`check_adamw_gate`: loss, grad norm, every
    gradient leaf within TP_TRAIN_GRAD_RTOL, every param), the bf16 step's
    loss and grad norm within GEMM_TOLS["bfloat16"] of one device's. (b)
    smollm-135m at SEQPAR_SMOLLM_LAYERS layers with remat "dots" on
    (data 2, model 2), held alike to its own one-device step. Every rank:
    collectives over model equal to the closed form and to the dry run's
    on meta, the saved block inputs its rows' (:func:`seqpar_check`)."""
    import tempfile

    from repro_torch.distributed.launch import spawn

    t0 = time.perf_counter()
    od = one_device_train_steps()
    res = {"rules": SEQPAR_RULES}
    cfg = seqpar_config("float32")
    batch = tp_train_batch(cfg, SEQPAR_SMOLLM_BATCH)
    params = tp_params(cfg, None)
    small = tp_train_step(cfg, params, None, batch=batch)
    del params
    small16 = tp_train_step(seqpar_config("bfloat16"), tp_params(
        seqpar_config("bfloat16"), None), None, batch=tp_train_batch(
            seqpar_config("bfloat16"), SEQPAR_SMOLLM_BATCH))
    small16.pop("params")
    small16.pop("mu")
    runs = {"a": (TP_WORLD, (od["ref_params"], od["ref_mu"]),
                  TP_TRAIN_BATCH, od["fp32"], od["bf16"]),
            "b": (4, (small.pop("params"), small.pop("mu")),
                  SEQPAR_SMOLLM_BATCH // 2, small, small16)}
    for name, (world, refs, rows, one, one16) in runs.items():
        t1 = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix="chip_smoke_sp_") as work:
            ranks = spawn(seqpar_rank, world, (str(ROOT), refs, rows),
                          workdir=work, timeout_s=TP_RANKS_TIMEOUT_S,
                          collective_timeout_s=TP_COLLECTIVE_TIMEOUT_S)
        del refs
        gc.collect()
        torch.cuda.ipc_collect()
        torch.cuda.empty_cache()
        atol, rtol = GEMM_TOLS["bfloat16"]
        for r, rk in enumerate(ranks):
            check_adamw_gate(f"seqpar {name} rank {r}", rk["float32"], one)
            b = rk["bfloat16"]
            for k in ("loss", "grad_norm"):
                if not abs(b[k] - one16[k]) <= atol + rtol * abs(one16[k]):
                    fail(f"seqpar {name} rank {r}: bf16 {k} {b[k]} vs one "
                         f"device {one16[k]} (outside GEMM_TOLS)")
            check_counts(f"seqpar {name} rank {r} bf16 step", b["launches"],
                         K1_TRAIN)
        r0 = ranks[0]
        res[name] = {
            "seconds": time.perf_counter() - t1, "world": world,
            "batch": [rows * (world // 2), TP_TRAIN_SEQ], "ranks": ranks,
            "one_device": {"fp32": {k: one[k] for k in (
                "loss", "grad_norm", "saved_block_input_bytes")},
                "bf16": {k: one16[k] for k in (
                    "loss", "grad_norm", "wall_ms",
                    "saved_block_input_bytes")}}}
        log(f"seqpar ({name}) {'smollm-135m' if world == 4 else TP_ARCH} on "
            f"{dict(r0['float32']['coords'])} x {world} ranks: fp32 loss "
            f"{[rk['float32']['loss'] for rk in ranks]} vs {one['loss']}, "
            f"grad norm {[rk['float32']['grad_norm'] for rk in ranks]} vs "
            f"{one['grad_norm']}, worst gradient leaf rel |d| "
            f"{[rk['float32']['grad_leaf_max_rel_diff'] for rk in ranks]}, "
            f"params max |d| "
            f"{[rk['float32']['param_max_abs_diff'] for rk in ranks]}; bf16 "
            f"loss {[rk['bfloat16']['loss'] for rk in ranks]} vs "
            f"{one16['loss']}, step "
            f"{[round(rk['bfloat16']['wall_ms'], 1) for rk in ranks]} ms vs "
            f"{one16['wall_ms']:.1f}; per rank: K1 "
            f"{[rk[d]['k1'] for rk in ranks for d in ('float32', 'bfloat16')]}"
            f"; collectives {[rk[d]['by_axes'] for rk in ranks for d in ('float32', 'bfloat16')]}"
            f" (closed form {r0['float32']['closed_form']}, "
            f"{r0['bfloat16']['closed_form']}); saved block inputs "
            f"{[rk[d]['saved_block_input_bytes'] for rk in ranks for d in ('float32', 'bfloat16')]}"
            f" B vs one device's {one['saved_block_input_bytes']}, "
            f"{one16['saved_block_input_bytes']}; "
            f"{res[name]['seconds']:.1f} s")
    res["seconds"] = time.perf_counter() - t0
    log(f"seqpar: phase {res['seconds']:.1f} s")
    return res


# ---------------------------------------------------------------------------
# Phase 25: the dry run on meta against the real runs
# ---------------------------------------------------------------------------

def run_roofline_phase(report):
    """The dry run (repro_torch.launch.dryrun) on ``meta`` at the shapes
    of three runs this script measured: smollm-135m's paged decode step at
    SLOTS live requests (phase 3), bert-base's forward (phase 5) and the
    smollm-135m train step with remat (phase 20). Its launches, kernel by
    kernel and route by route as its cost ledger records them (nothing
    launches on ``meta``, so no counter moves), must equal the counters
    of the real run;
    the predicted roofline terms are printed beside the measured device
    busy times (torch.profiler) and host wall times (unprofiled) of those
    runs, and their ratios."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core.plan import AttentionPolicy
    from repro_torch.launch import dryrun as DR

    cfg, bert = get_config(ARCH), get_config("bert-base")
    dec = report["serving"]["decode_step"]
    enc = report["encoders"][bert.name]
    tr = report["train"]
    cells = (
        (f"{ARCH} decode step, paged, {SLOTS} slots",
         lambda: DR.run_step(cfg, "decode", SLOTS, MAX_LEN,
                             attention=AttentionPolicy("paged",
                                                       page_size=PAGE),
                             pack_weights=True, n_pages=CACHE_PAGES),
         dec["launches"], dec["device_busy_ms"], dec["host_wall_ms"]),
        (f"{bert.name} forward, B {ENC_BATCH} x {BERT_SEQ}",
         lambda: DR.run_step(bert, "forward", ENC_BATCH, BERT_SEQ,
                             pack_weights=True),
         enc["launches"], enc["device_busy_ms"], enc["forward_wall_ms"]),
        (f"{ARCH} train step, B {TRAIN_BATCH} x {TRAIN_SEQ}, remat",
         lambda: DR.run_step(dataclasses.replace(cfg, remat=True), "train",
                             TRAIN_BATCH, TRAIN_SEQ),
         tr["launches_one_step"]["remat on"],
         tr["profiled_step"]["device_busy_ms"], tr["median_step_ms"]))
    res = {}
    for name, run, measured, busy, wall in cells:
        r = run()
        meta = DR.launch_counters(r)
        diff = {k: (meta.get(k, 0), measured.get(k)) for k in {*meta,
                                                               *measured}
                if meta.get(k, 0) != measured.get(k)}
        if diff:
            fail(f"roofline {name}: the dry run's launches differ from the "
                 f"card's (dry run, card): {diff}")
        t = r["roofline"]
        bound = max(t["t_compute_s"], t["t_memory_s"],
                    t["t_collective_s"]) * 1e3
        res[name] = dict(
            launches=r["launches"], cost=r["cost"], memory=r["memory"],
            t_compute_ms=t["t_compute_s"] * 1e3,
            t_memory_ms=t["t_memory_s"] * 1e3, roofline_ms=bound,
            bottleneck=t["bottleneck"], device_busy_ms=busy,
            host_wall_ms=wall, roofline_over_busy=bound / busy,
            roofline_over_wall=bound / wall, busy_over_wall=busy / wall,
            dry_run_s=r["run_s"])
        log(f"roofline {name}: launches {r['launches']} equal the card's; "
            f"predicted t_compute {t['t_compute_s'] * 1e3:.4f} ms, "
            f"t_memory {t['t_memory_s'] * 1e3:.4f} ms, roofline "
            f"{bound:.4f} ms ({t['bottleneck']}); measured device busy "
            f"{busy:.3f} ms, host wall {wall:.3f} ms; roofline / busy "
            f"{bound / busy:.3f}, roofline / wall {bound / wall:.4f}")
    return res


# ---------------------------------------------------------------------------
# Phase 29: the static-analysis gate on the card's launches
# ---------------------------------------------------------------------------

# Each kernel's total launch counter (kernel_wrappers(): the rest count by
# route or mark)
KERNEL_COUNTERS = ("matrixflow_gemm", "matrixflow_gemm_dequant",
                   "flash_attention", "paged_attention",
                   "paged_attention_int8", "ssd_scan")
# smollm-135m's projections (K, N) and the two row counts of its serving
# steps (decode: SLOTS rows; a prefill bucket: SLOTS x PROMPT_BUCKET)
PROBE_PROJECTIONS = ((576, 576), (576, 192), (576, 1536), (1536, 576),
                     (576, 49152))
PROBE_ROWS = (SLOTS, SLOTS * PROMPT_BUCKET)


def probe_cells(entries):
    """The sweep's cells on the card (``analysis.probe.sweep_cells``), then
    K1 and K2 at smollm-135m's decode and prefill GEMMs: K1 in bf16 as
    planned (wgmma) and, at decode, at bm 16 (mma, K split over a
    cluster), in fp32 and int8 → int32 (the CUDA cores); K2 as planned;
    and K1's batch grid (the unfused attention's 8 x 9 products) on wgmma
    and the CUDA cores."""
    from repro_torch.analysis import probe as PR
    cells = PR.sweep_cells(entries)
    for M in PROBE_ROWS:
        for K, N in PROBE_PROJECTIONS:
            variants = [(torch.bfloat16, False, None),
                        (torch.int8, True, None)]
            if M == SLOTS:
                variants += [(torch.bfloat16, False, 16),
                             (torch.float32, False, None),
                             (torch.int8, False, None)]
            for dt, fused, bm in variants:
                cell = PR.gemm_cell(M, N, K, dt, fused=fused, bm=bm)
                cells.append((f"smollm {'K2' if fused else 'K1'} "
                              f"{str(dt)[6:]} {M}x{K}x{N} "
                              f"bm={cell['blk'].bm}", "matrixflow_gemm",
                              cell))
    for dt in (torch.bfloat16, torch.float32):
        cells.append((f"smollm K1 batched {str(dt)[6:]} 72 x 1x64x256",
                      "matrixflow_gemm",
                      PR.gemm_cell(1, 256, 64, dt, batch=SLOTS * 9)))
    return cells


def run_analysis_phase():
    """Phase 29: (a) the contract sweep on the card's launches, (b) the
    coverage probe of every kernel and route, (c) the lint of the
    full-width smollm-135m paged engine's steps on meta and live, (d) the
    ops facade against its plain versions, each call moving its wrapper's
    counter by its launches. Fatal on any violation, unwritten element,
    disagreement, finding or miscount."""
    import io

    from repro_torch.analysis import probe as PR
    from repro_torch.analysis import sweep as SW
    from repro_torch.analysis.trace_lint import lint_engine
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.obs import Observability
    from repro_torch.serving.engine import ServeConfig, ServingEngine
    t_phase = time.perf_counter()
    out = {}
    # (a) the sweep
    buf = io.StringIO()
    t0 = time.perf_counter()
    entries, n_bad = SW.run_sweep(device="cuda", out=buf)
    (OUT_DIR / "analysis_sweep.txt").write_text(buf.getvalue())
    by_route = SW.count_by_route(entries)
    out["sweep"] = dict(instances=len(entries), violations=n_bad,
                        by_kernel_route=by_route,
                        s=time.perf_counter() - t0)
    log(f"analysis sweep: {len(entries)} contract instances, {n_bad} "
        f"violations, {by_route}")
    if n_bad:
        fail(f"analysis sweep: {n_bad} contract violations (chiprun_out/"
             f"analysis_sweep.txt)")
    # (b) the coverage probe
    t0 = time.perf_counter()
    try:
        probe = PR.run_probe(probe_cells(entries), seed=29)
    except PR.ProbeError as e:
        fail(f"analysis probe: {e}")
    out["probe"] = dict(probe, s=time.perf_counter() - t0)
    log(f"analysis probe: {sum(probe['cells'].values())} launches, every "
        f"marked element written and within tolerance: {probe['cells']}")
    # (c) the lint: meta and live
    t0 = time.perf_counter()
    cfg = get_config(ARCH)
    params = T.init_model(cfg, seed=0, device="cuda", draw_device="cuda")
    sc = ServeConfig(batch_slots=SLOTS, max_len=MAX_LEN, obs=Observability())
    eng = ServingEngine(cfg, params, sc)
    findings = lint_engine(eng)
    reset_counts()
    live = lint_engine(eng, live=True)
    torch.cuda.synchronize()
    out["lint_launches"] = read_counts("analysis lint live",
                                       K1_BF16 + K4_BF16)
    for tag, fs in (("meta", findings), ("live", live)):
        for f in fs:
            log(f"lint FAIL {tag} {f}")
    out["lint"] = dict(meta=len(findings), live=len(live),
                       s=time.perf_counter() - t0)
    if findings or live:
        fail(f"analysis lint: {len(findings)} findings on meta, {len(live)} "
             f"live, in smollm-135m's prefill and decode steps")
    log(f"analysis lint: smollm-135m paged prefill+decode, 0 findings on "
        f"meta and live")
    del eng, params
    # (d) the facade
    t0 = time.perf_counter()
    reset_counts()
    gen = torch.Generator(device="cuda").manual_seed(29)
    bf = torch.bfloat16
    a = torch.randn((SLOTS, 576), generator=gen, device="cuda").to(bf)
    b = torch.randn((576, 1536), generator=gen, device="cuda").to(bf)
    q = torch.randn((SLOTS, 1, 9, 64), generator=gen, device="cuda").to(bf)
    kv = torch.randn((SLOTS, 256, 3, 64), generator=gen, device="cuda").to(bf)
    x = torch.randn((1, 384, 64, 64), generator=gen, device="cuda").to(bf)
    dtv = 0.01 + 0.1 * torch.rand((1, 384, 64), generator=gen, device="cuda")
    A = -(0.5 + torch.rand(64, generator=gen, device="cuda"))
    Bc = (torch.randn((1, 384, 128), generator=gen, device="cuda") / 8).to(bf)
    from repro_torch.core import layout as L
    from repro_torch.core import plan as P
    blk = P.plan(SLOTS, 1536, 576, bf, P.GemmPolicy(backend="matrixflow"),
                 "cuda").layout
    a_bm = L.to_block_major_a(a, blk.bm, blk.bk)
    b_bm = L.to_block_major_b(b, blk.bk, blk.bn)
    facade = {}
    for fn, args, kw, counter, tol in (
            (ops.gemm, (a, b), {}, "matrixflow_gemm", PR.TOLS["bfloat16"]),
            (ops.gemm_preformatted, (a_bm, b_bm), dict(blk=blk),
             "matrixflow_gemm", PR.TOLS["bfloat16"]),
            (ops.mha, (q, kv, kv), {}, "flash_attention",
             PR.ATTN_TOLS["bfloat16"]),
            (ops.ssd, (x, dtv, A, Bc, Bc), {}, "ssd_scan",
             PR.SSD_TOLS["bfloat16"])):
        before = counts()
        got = fn(*args, **kw)
        after = counts()
        moved = {k: after[k] - before[k] for k in KERNEL_COUNTERS
                 if after[k] != before[k]}
        if moved != {counter: 1}:
            fail(f"analysis facade {fn.__name__}: counters moved {moved}, "
                 f"expected {{{counter!r}: 1}}")
        want = fn(*args, **kw, impl="ref")
        facade[fn.__name__] = check_close(f"analysis facade {fn.__name__}",
                                          got, want, *tol)
    torch.cuda.synchronize()
    out["facade_launches"] = read_counts(
        "analysis ops facade", ("matrixflow_gemm", "flash_attention",
                                "ssd_scan"))
    out["facade"] = dict(max_abs_err=facade, s=time.perf_counter() - t0)
    out["s"] = time.perf_counter() - t_phase
    log(f"analysis: phase 29 in {out['s']:.1f} s (sweep "
        f"{out['sweep']['s']:.1f}, probe {out['probe']['s']:.1f}, lint "
        f"{out['lint']['s']:.1f}, facade {out['facade']['s']:.1f})")
    return out


# ---------------------------------------------------------------------------
# Phase 30: KV caches cut over the sequence (long_500k) and K3's
# log-sum-exp
# ---------------------------------------------------------------------------

LONG_SEQ = 524288                    # long_500k's cache, one row
# zamba2-2.7b at full width, 2 and 1 shared-attention groups of its 9
LONG_LAYERS = {"bfloat16": 12, "float32": 6}
# written lengths: the decode writes at 524,280.. in rank 1's half, both
# ranks holding visible keys; at 100,000.. in rank 0's, rank 1's half past
# every row's valid length
LONG_LENS = {"both see keys": 524280, "rank 1 sees none": 100000}
LONG_STEPS = 4
LONG_WORLD = 2                       # mesh (data 2, model 1)
LONG_SEED = 30
# bf16, after step 0: the cut's logits at a step at most this many times
# as far from one device's as the one-device control's (K3's keys over
# half the cluster CTAs). Readings (H100, 700 W), the cut's max |d| over
# the control's at a step: at most 1.25 on random caches; 1.0-3.08 on
# these caches (0.145 against 0.047 at step 3 of "both see keys", the
# states parted by then; 0.082 against 0.039 at step 1 of the other)
LONG_CONTROL_FACTOR = 4
# K3 with its log-sum-exp, (arch, name, Sq, keys, dtype): at zamba2's
# shared block (H = Hkv = 32, D 80; phase 30(a)) a decode over the
# one-device cache and over a rank's half, a 64-row prefill chunk (rows),
# fp32 (the CUDA cores); at deepseek-v2's MLA (H = Hkv = 128, q/k 192, v
# 128; phase 31(a)) a decode over a rank's 16,384 latent columns and over
# one device's 32,768, a 64-row prefill chunk over a rank's columns
LSE_CELLS = ((ZAMBA, "split, one device", 1, LONG_SEQ, "bfloat16"),
             (ZAMBA, "split, a rank", 1, LONG_SEQ // LONG_WORLD, "bfloat16"),
             (ZAMBA, "rows, prefill 64", 64, 4096, "bfloat16"),
             (ZAMBA, "cuda cores", 1, 65536, "float32"),
             (DEEPSEEK, "mla split, a rank", 1, 16384, "bfloat16"),
             (DEEPSEEK, "mla split, one device", 1, 32768, "bfloat16"),
             (DEEPSEEK, "mla rows, prefill 64", 64, 16384, "bfloat16"))
# out of a phase 30(a) cell: max |kernel - plain| at most this share of
# the plain output's RMS, beside ATTN_TOLS (bf16 rounds the largest
# values, about 4 RMS, by up to 0.008 RMS on each side)
LSE_OUT_RMS = 0.05


def once_ms(fn) -> float:
    """Device time of one call of ``fn`` (CUDA events; for a plain version
    whose Python loop over key blocks takes seconds a call)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


# the planted keys' scores: from LSE_SCORES[0] at head 0 to LSE_SCORES[1]
# at the last, the other half's key LSE_SCORE_GAP below; the random keys'
# log-sum-exp over a half is about log(keys / 2) + 0.5 (10.9 to 13.0)
LSE_SCORES = (14.0, 24.0)
LSE_SCORE_GAP = 3.0
LSE_PLANT_STEP = 31                  # columns between two rows' planted keys


def lse_inputs(gen, Sq, Sk, H, Hkv, D, Dv, dt):
    """q, k, v of a phase 30(a) cell (q/k head dim D, v Dv), random with
    planted keys: for every
    query row r and KV head h, a key in each half of the columns (r *
    LSE_PLANT_STEP + 7 and Sk/2 + r * LSE_PLANT_STEP + 11, visible to
    every row) scaled from q so that its score is s_h (spread over
    LSE_SCORES) in one half and s_h - LSE_SCORE_GAP in the other, the
    halves alternating with h, each with a value of its own (2 x randn).
    So the answer depends on the kernel: one half holds most of a row's
    mass, the halves' log-sum-exps differ by units, the rows' lse spread
    over ten, and the output is of the planted values' size."""
    g = H // Hkv
    q = torch.randn((1, Sq, H, D), generator=gen, device="cuda").to(dt)
    k = torch.randn((1, Sk, Hkv, D), generator=gen, device="cuda")
    v = torch.randn((1, Sk, Hkv, Dv), generator=gen, device="cuda")
    qf = q.float()[0, :, ::g]                               # (Sq, Hkv, D)
    lo, hi = LSE_SCORES
    s = lo + (hi - lo) * torch.arange(Hkv, device="cuda") / max(Hkv - 1, 1)
    first_high = (torch.arange(Hkv, device="cuda") % 2 == 0)
    rows = torch.arange(Sq, device="cuda") * LSE_PLANT_STEP
    for cols, high in ((rows + 7, first_high),
                       (rows + Sk // 2 + 11, ~first_high)):
        score = torch.where(high, s, s - LSE_SCORE_GAP)     # (Hkv,)
        alpha = score / (D ** -0.5 * (qf * qf).sum(-1))     # (Sq, Hkv)
        k[0, cols] = alpha[..., None] * qf
        v[0, cols] = 2 * torch.randn((Sq, Hkv, Dv), generator=gen,
                                     device="cuda")
    return q, k.to(dt), v.to(dt)


def within(got, want, atol, rtol) -> bool:
    got, want = got.float(), want.float()
    return bool(((got - want).abs() <= atol + rtol * want.abs()).all())


def run_lse_kernel_phase(timer, arch=ZAMBA):
    """Phase 30(a) (phase 31(a) with ``arch`` deepseek-v2-236b). K3 with
    ``return_lse=True`` at ``arch``'s LSE_CELLS on the route
    its chooser names, over planted keys (:func:`lse_inputs`): out and lse
    held to the plain version within ATTN_TOLS, out also within
    LSE_OUT_RMS of its own RMS, and the lse less its row's mean over the
    heads within ATTN_TOLS; at a decode, the two halves' launches merged
    (``tp.merge_stack``) held to the one launch. Planted faults must fail
    those gates: a zero output, one constant lse, the halves merged with
    equal weights. Its time beside the plain version's, SDPA's (the
    normalized output alone) and the bound of this data (every key
    visible to the decode rows, the prefill's causal pairs; the lse's
    fp32 write counted)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.distributed import tp as TP
    from repro_torch.kernels import flash_attention as FA

    cfg = get_config(arch)
    H, Hkv = cfg.n_heads, cfg.n_kv_heads
    D, Dv = (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim, cfg.v_head_dim) \
        if cfg.is_mla else (cfg.head_dim, cfg.head_dim)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator(device="cuda").manual_seed(LONG_SEED)
    rows = []
    for cell_arch, name, Sq, Sk, dtype_name in LSE_CELLS:
        if cell_arch != arch:
            continue
        dt = getattr(torch, dtype_name)
        atol, rtol = ATTN_TOLS[dtype_name]
        q, k, v = lse_inputs(gen, Sq, Sk, H, Hkv, D, Dv, dt)
        cell = (f"flash_attention lse {name} Sq={Sq} Sk={Sk} H={H} "
                f"Hkv={Hkv} D={D} Dv={Dv} {dtype_name}")
        before = counts()
        got, lse = FA.flash_attention(q, k, v, return_lse=True)
        route = route_taken(before, counts(), "flash_attention")
        if route != FA.route_for(dt, Sq, H // Hkv):
            fail(f"{cell}: ran route {route}")
        qpos = (torch.arange(Sq, device="cuda") + (Sk - Sq)).expand(
            1, Sq).to(torch.int32)
        kvl = torch.full((1,), Sk, dtype=torch.int32, device="cuda")

        plain = []                   # one call, timed: seconds at 512k keys
        t_p = once_ms(lambda: plain.append(FA.flash_attention_plain(
            q, k, v, qpos, kvl, causal=True, scale=D ** -0.5, soft_cap=None,
            return_lse=True)))
        want, want_lse = plain.pop()
        err = check_close(f"{cell} out", got, want, atol, rtol)
        err_lse = check_close(f"{cell} lse", lse, want_lse, atol, rtol)
        rms = float(want.float().pow(2).mean().sqrt())
        if err > LSE_OUT_RMS * rms:
            fail(f"{cell} out: max |kernel - plain| = {err:.3e} exceeds "
                 f"{LSE_OUT_RMS} x the plain output's RMS {rms:.3e}")

        def centred(x):
            return x - x.mean(dim=-1, keepdim=True)
        err_c = check_close(f"{cell} lse less its row mean", centred(lse),
                            centred(want_lse), atol, rtol)
        spread = float(want_lse.amax(-1).sub(want_lse.amin(-1)).min())
        faults = {"zero output": within(torch.zeros_like(want), want, atol,
                                        rtol),
                  "constant lse": within(centred(torch.full_like(
                      want_lse, float(want_lse.mean()))), centred(want_lse),
                      atol, rtol)}
        t_k = timer.ms(lambda: FA.flash_attention(q, k, v, return_lse=True))
        qs, ks, vs = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        cols = torch.arange(Sk, device="cuda")
        vis = cols[None, :] <= qpos[0, :, None]              # (Sq, Sk)
        mask = None if bool(vis.all()) else vis[None, None]
        t_lib = timer.ms(lambda: sdpa(qs, ks, vs, attn_mask=mask))
        b_ms, b_by = bound_ms("flash_attention", route, B=1, Sq=Sq, Sk=Sk,
                              H=H, Hkv=Hkv, D=D, Dv=Dv, dtype=dt, keys=Sk,
                              pairs=int(vis.sum()), lse=True)
        merge_err = lse_gap = None
        if Sq == 1:                  # two cuts of the keys, merged
            half = Sk // 2
            parts = [FA.flash_attention(q, k[:, sl], v[:, sl], return_lse=True)
                     for sl in (slice(0, half), slice(half, Sk))]
            o_r = torch.stack([o for o, _ in parts])
            lse_r = torch.stack([x for _, x in parts])
            merged = TP.merge_stack(o_r, lse_r)
            merge_err = check_close(f"{cell} two cuts merged",
                                    merged.to(dt), got, atol, rtol)
            lse_gap = float((lse_r[0] - lse_r[1]).abs().min())
            faults["equal-weight merge"] = within(
                o_r.float().mean(dim=0).to(dt), got, atol, rtol)
        passed = [f for f, ok in faults.items() if ok]
        if passed:
            fail(f"{cell}: planted faults pass the gates: {passed}")
        rows.append(dict(cell=cell, dtype=dtype_name, path=name, uses=1,
                         route=route, max_abs_err=max(err, err_lse),
                         lse_max_abs_err=err_lse,
                         lse_less_row_mean_max_abs_err=err_c, out_rms=rms,
                         lse_row_spread_min=spread, halves_lse_gap_min=lse_gap,
                         planted_faults_caught=sorted(faults), ms=t_k,
                         plain_ms=t_p, library_ms=t_lib, bound_ms=b_ms,
                         bound_by=b_by,
                         two_cuts_merged_max_abs_err=merge_err))
        log(f"{cell}: route {route} max|d| out {err:.2e} (RMS {rms:.3f}) "
            f"lse {err_lse:.2e} (less row mean {err_c:.2e}; rows spread "
            f"over >= {spread:.2f}) two cuts merged {merge_err} (halves' "
            f"lse apart by >= {lse_gap}); planted faults caught "
            f"{sorted(faults)}; kernel {t_k:.4f} ms plain {t_p:.1f} ms sdpa "
            f"{t_lib:.4f} ms bound {b_ms:.4f} ms ({b_by})")
        del q, k, v, qs, ks, vs, got, lse, want, want_lse
        torch.cuda.empty_cache()
    return rows


def long_config(dtype_name):
    from repro_torch.configs.registry import get_config
    return dataclasses.replace(get_config(ZAMBA),
                               n_layers=LONG_LAYERS[dtype_name],
                               dtype=dtype_name)


def long_caches(cfg, length, ctx=None):
    """zamba2's decode caches of one row at ``length`` written tokens of
    LONG_SEQ, drawn on the card from LONG_SEED (every SSD layer's conv and
    SSD state, every shared-attention group's K/V; the sink column zero):
    the same on every process; with a rank's context, its cut of them
    (``tp.shard_caches``: no 10 GB crosses processes)."""
    from repro_torch.distributed import tp as TP
    from repro_torch.models import transformer as T
    gen = torch.Generator(device="cuda").manual_seed(LONG_SEED)
    caches = T.init_caches(cfg, 1, LONG_SEQ, cfg.dtype, "cuda")
    half = LONG_SEQ // LONG_WORLD
    for c in caches:
        if "k" in c:
            for name in ("k", "v"):
                c[name][:, :LONG_SEQ].normal_(generator=gen)
            # the halves differ, so the merge's weights decide the output:
            # the second's keys at half the scale (less of a row's mass),
            # each half's values about a mean of its own
            c["k"][:, half:LONG_SEQ].mul_(0.5)
            for sl in (slice(0, half), slice(half, LONG_SEQ)):
                c["v"][:, sl].add_(torch.randn(
                    c["v"].shape[2:], generator=gen,
                    device="cuda").to(c["v"].dtype))
            c["len"].fill_(length)
        else:
            for t in c["conv"].values():
                t.normal_(generator=gen)
            c["state"].normal_(generator=gen).mul_(0.1)
    if ctx is None:
        return caches
    cut = TP.shard_caches(caches, ctx, shard_kv=False)
    del caches
    torch.cuda.empty_cache()
    return cut


def long_decode(cfg, params, caches, ctx, length, feed=None):
    """LONG_STEPS decode steps of one row from ``length``, through the
    serving decode step over contiguous caches (K3): logits and greedy
    tokens a step, each step's wall time, and the collectives of step 2;
    ``feed`` gives each step's input token (another run's greedy stream),
    else the previous step's argmax."""
    from repro_torch.core.plan import AttentionPolicy
    from repro_torch.distributed import tp as TP
    from repro_torch.serving.engine import make_decode_step
    step = make_decode_step(cfg, attn=AttentionPolicy(backend="fused"),
                            tpctx=ctx)
    tok = torch.ones((1, 1), dtype=torch.int32, device="cuda")
    pos = torch.full((1, 1), length, dtype=torch.int32, device="cuda")
    logits, toks, step_ms, coll = [], [], [], None
    with torch.no_grad():
        for i in range(LONG_STEPS):
            if feed is not None and i:
                tok.fill_(int(feed[i - 1]))
            TP.collectives.reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg, caches = step(params, tok, pos, caches)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            if i == 1:
                coll = TP.collectives.snapshot()
                coll["by_axes"] = TP.collectives.by_axes(
                    ctx.mesh if ctx is not None else None)
            tok = torch.argmax(lg, dim=-1)[:, None].to(torch.int32)
            logits.append(lg.float())
            toks.append(int(tok))
            pos = pos + 1
    return torch.cat(logits).cpu(), toks, step_ms, coll, caches


def kv_bytes(caches, real=False):
    """Bytes of the caches' K/V (``real``: without the sink column)."""
    n = 0
    for c in caches:
        for name in ("k", "v"):
            if name in c:
                t = c[name][:, :-1] if real else c[name]
                n += t.numel() * t.element_size()
    return n


def long_rank(rank, world, root, feeds):
    """One rank of phase 30(b) on cuda:0, mesh (data 2, model 1) under
    the long_500k rules: each dtype's decode from its cut of every case's
    caches, fed the one-device greedy tokens (``feeds``); its K/V bytes,
    the launches and collectives of a step; a live lint of the step."""
    sys.path.insert(0, str(Path(root) / "src"))
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.analysis import trace_lint
    from repro_torch.configs.registry import SHAPES
    from repro_torch.core.plan import AttentionPolicy
    from repro_torch.distributed import tp as TP
    from repro_torch.launch import steps as ST
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import make_decode_step

    mesh = make_host_mesh()
    out = {"coords": dict(mesh.coords)}
    for dtype_name in LONG_LAYERS:
        cfg = long_config(dtype_name)
        ctx = ST.serve_context(cfg, mesh, SHAPES["long_500k"])
        params = T.init_model(cfg, seed=0, device="cuda", draw_device="cuda")
        for case, length in LONG_LENS.items():
            caches = long_caches(cfg, length, ctx)
            offsets = [int(c["seq_offset"]) for c in caches if "k" in c]
            reset_counts()
            lg, toks, step_ms, coll, caches = long_decode(
                cfg, params, caches, ctx, length, feeds[dtype_name][case])
            torch.cuda.synchronize()
            out[(dtype_name, case)] = dict(
                logits=lg, tokens=toks, step_ms=step_ms, collectives=coll,
                kv_bytes=kv_bytes(caches), kv_bytes_real=kv_bytes(caches,
                                                                  True),
                offsets=offsets, launches=counts(),
                lens=[int(c["len"][0]) for c in caches if "k" in c])
            if dtype_name == "bfloat16" and case == next(iter(LONG_LENS)):
                step = make_decode_step(
                    cfg, attn=AttentionPolicy(backend="fused"), tpctx=ctx)
                tok = torch.ones((1, 1), dtype=torch.int32, device="cuda")
                pos = torch.full((1, 1), length + LONG_STEPS,
                                 dtype=torch.int32, device="cuda")
                out["lint"] = [str(f) for f in trace_lint.lint_step(
                    step, params, tok, pos, caches, path="long decode")]
            del caches
            if dtype_name == "bfloat16":
                # planted fault: the ranks' partials merged with equal
                # weights, whatever their log-sum-exps; its logits must
                # fail the bf16 gate (:func:`long_bf16_over`)
                real_merge = TP.merge_stack
                TP.merge_stack = lambda o_r, lse_r: o_r.float().mean(dim=0)
                try:
                    out[(dtype_name, case, "fault")] = long_decode(
                        cfg, params, long_caches(cfg, length, ctx), ctx,
                        length, feeds[dtype_name][case])[0]
                finally:
                    TP.merge_stack = real_merge
            gc.collect()
            torch.cuda.empty_cache()
        del params
        gc.collect()
        torch.cuda.empty_cache()
    return out


def long_bf16_over(diff, cdiff, ok) -> list:
    """The steps at which bf16 logits fail phase 30(b)'s gate (``diff``,
    ``cdiff``: (steps, vocab) |logits - one device's| of the cut and of
    the one-device control; ``ok``: the cut's elements within GEMM_TOLS).
    Step 0 starts from the state one device starts from: every logit
    within GEMM_TOLS. Later steps start from states that bf16 rounding
    has parted (one device against itself leaves GEMM_TOLS there): max
    |d| at most LONG_CONTROL_FACTOR times that step's control."""
    d, c = diff.amax(dim=1).tolist(), cdiff.amax(dim=1).tolist()
    return [i for i in range(len(d))
            if (not bool(ok[i].all()) if i == 0
                else d[i] > LONG_CONTROL_FACTOR * c[i])]


def run_long_phase():
    """Phase 30. (a) K3's log-sum-exp against its plain version
    (:func:`run_lse_kernel_phase`); (b) zamba2-2.7b at full width, its
    caches at LONG_SEQ drawn on the card: LONG_STEPS decode steps on one
    device, then on LONG_WORLD gloo ranks of the card whose caches are cut
    over data (the long_500k rules), each rank fed the one-device tokens:
    fp32 (LONG_LAYERS) logits within GEMM_TOLS and tokens equal; bf16
    logits within GEMM_TOLS at step 0 and, once bf16 rounding has parted
    the states, no farther from one device's than LONG_CONTROL_FACTOR
    times a one-device control's at each step (K3's keys split over half
    the CTAs: another merge order; fed the same tokens, whose own must not
    part), the elements outside GEMM_TOLS counted and parted tokens
    printed; a planted fault (the ranks' partials merged with equal
    weights) must fail that gate; each
    rank's K/V columns half of one device's; a step's collectives equal
    to the dry run's; (c) the cut decode step linted live on rank 0."""
    import tempfile

    from repro_torch.configs.registry import SHAPES
    from repro_torch.distributed.launch import spawn
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import transformer as T

    t0 = time.perf_counter()
    res = {"kernels": run_lse_kernel_phase(Timer(), ZAMBA)}
    t_a = time.perf_counter() - t0
    one, feeds, control = {}, {}, {}
    for dtype_name in LONG_LAYERS:
        cfg = long_config(dtype_name)
        params = T.init_model(cfg, seed=0, device="cuda", draw_device="cuda")
        feeds[dtype_name] = {}
        for case, length in LONG_LENS.items():
            caches = long_caches(cfg, length)
            reset_counts()
            lg, toks, step_ms, _, caches = long_decode(cfg, params, caches,
                                                       None, length)
            one[(dtype_name, case)] = dict(
                logits=lg, tokens=toks, step_ms=step_ms,
                kv_bytes=kv_bytes(caches), kv_bytes_real=kv_bytes(caches,
                                                                  True),
                launches=read_counts(f"long one device {dtype_name} {case}",
                                     ("flash_attention",),
                                     allowed=CUDA_CORE_COUNTERS))
            feeds[dtype_name][case] = toks
            del caches
            # control: the same decode, fed the same tokens, with K3's keys
            # split over half the cluster CTAs (another merge order)
            real_split = FA.split_count
            FA.split_count = lambda *a: max(1, real_split(*a) // 2)
            try:
                ctrl, ctrl_toks, _, _, caches = long_decode(
                    cfg, params, long_caches(cfg, length), None, length,
                    toks)
            finally:
                FA.split_count = real_split
            if ctrl_toks != toks:
                fail(f"long {ZAMBA} {dtype_name} {case}: the one-device "
                     f"control's tokens {ctrl_toks} part from one device's "
                     f"{toks}")
            control[(dtype_name, case)] = ctrl
            del caches
            gc.collect()
            torch.cuda.empty_cache()
        del params
        gc.collect()
        torch.cuda.empty_cache()
    t1 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_long_") as work:
        ranks = spawn(long_rank, LONG_WORLD, (str(ROOT), feeds),
                      workdir=work, timeout_s=TP_RANKS_TIMEOUT_S,
                      collective_timeout_s=TP_COLLECTIVE_TIMEOUT_S)
    t_ranks = time.perf_counter() - t1
    res["cases"] = {}
    problems = []                  # every case is printed before a failure
    for (dtype_name, case), ref in one.items():
        atol, rtol = GEMM_TOLS[dtype_name]
        cfg = long_config(dtype_name)
        d = DR.run_step(cfg, "decode", 1, LONG_SEQ,
                        mesh=Mesh.abstract((LONG_WORLD, 1), ("data", "model")),
                        shape_name="long_500k")
        row = {"one_device": {k: v for k, v in ref.items()
                              if k != "logits"}, "ranks": []}
        for r, rk in enumerate(ranks):
            got = rk[(dtype_name, case)]
            tag = f"long {ZAMBA} {dtype_name} {case} rank {r}"
            diff = (got["logits"] - ref["logits"]).abs()
            ok = diff <= atol + rtol * ref["logits"].abs()
            cdiff = (control[(dtype_name, case)] - ref["logits"]).abs()
            c_ok = cdiff <= atol + rtol * ref["logits"].abs()
            parted = [i for i, (a, b) in enumerate(zip(got["tokens"],
                                                       ref["tokens"]))
                      if a != b]
            if dtype_name == "float32" and not bool(ok.all()):
                problems.append(
                    f"{tag}: logits max |d| {float(diff.max()):.3e} from "
                    f"one device's exceed atol={atol} rtol={rtol}")
            fault = {}
            if dtype_name == "bfloat16":
                over = long_bf16_over(diff, cdiff, ok)
                if over:
                    problems.append(
                        f"{tag}: logits max |d| by step "
                        f"{diff.amax(dim=1).tolist()} from one device's "
                        f"fail the bf16 gate at steps {over} (step 0 within"
                        f" GEMM_TOLS, later {LONG_CONTROL_FACTOR} x the "
                        f"one-device control's {cdiff.amax(dim=1).tolist()})")
                fdiff = (rk[(dtype_name, case, "fault")]
                         - ref["logits"]).abs()
                f_ok = fdiff <= atol + rtol * ref["logits"].abs()
                fault = dict(max_abs_diff_by_step=fdiff.amax(dim=1).tolist(),
                             outside_tols=(~f_ok).sum(dim=1).tolist(),
                             failing_steps=long_bf16_over(fdiff, cdiff, f_ok))
                if not fault["failing_steps"]:
                    problems.append(
                        f"{tag}: the planted fault (an equal-weight merge) "
                        f"passes the bf16 gate: {fault}")
            if dtype_name == "float32" and parted:
                problems.append(
                    f"{tag}: greedy tokens {got['tokens']} part from one "
                    f"device's {ref['tokens']}")
            if 2 * got["kv_bytes_real"] != ref["kv_bytes_real"]:
                problems.append(
                    f"{tag}: K/V columns {got['kv_bytes_real']} B are not "
                    f"half of one device's {ref['kv_bytes_real']} B")
            c = got["collectives"]
            if d["collectives_by_axes"] != c["by_axes"] \
                    or d["collective_counts"] != c["calls"]:
                problems.append(
                    f"{tag}: a step's collectives {c} differ from the dry "
                    f"run's ({d['collective_counts']}, "
                    f"{d['collectives_by_axes']})")
            check_counts(tag, got["launches"], ("matrixflow_gemm",
                                                 "flash_attention",
                                                 "flash_attention_lse"),
                         allowed=CUDA_CORE_COUNTERS)
            row["ranks"].append(dict(
                {k: v for k, v in got.items() if k != "logits"},
                logits_max_abs_diff=float(diff.max()), parted_steps=parted,
                logits_max_abs_diff_by_step=diff.amax(dim=1).tolist(),
                outside_tols=int((~ok).sum()),
                control_max_abs_diff_by_step=cdiff.amax(dim=1).tolist(),
                control_outside_tols=int((~c_ok).sum()),
                equal_weight_merge_fault=fault))
            log(f"{tag}: logits max |d| by step {diff.amax(dim=1).tolist()} "
                f"({(~ok).sum(dim=1).tolist()} of {ok.shape[1]} outside "
                f"GEMM_TOLS; one-device control "
                f"{cdiff.amax(dim=1).tolist()}, {(~c_ok).sum(dim=1).tolist()}"
                f" outside; max |logit| "
                f"{ref['logits'].abs().amax(dim=1).tolist()}), tokens "
                f"{got['tokens']} (one device {ref['tokens']}; parted at "
                f"{parted}), K/V {got['kv_bytes']} B (one device "
                f"{ref['kv_bytes']} B), offsets {got['offsets']}, lens "
                f"{got['lens']}, planted equal-weight merge {fault}, "
                f"step {statistics.median(got['step_ms']):.1f}"
                f" ms (one device {statistics.median(ref['step_ms']):.1f}), "
                f"collectives a step {c['by_axes']} (dry run "
                f"{d['collectives_by_axes']})")
        res["cases"][f"{dtype_name} {case}"] = row
    if problems:
        fail("; ".join(problems))
    lint = ranks[0]["lint"]
    if lint:
        fail(f"long decode (rank 0, live): lint findings {lint}")
    res["lint_findings"] = lint
    res["launches"] = {f"{n} {case} rank {r}": rk[(n, case)]["launches"]
                       for r, rk in enumerate(ranks)
                       for n, case in one}
    res["seconds"] = time.perf_counter() - t0
    log(f"long: phase {res['seconds']:.1f} s ((a) {t_a:.1f} s, ranks "
        f"{t_ranks:.1f} s); lint on rank 0 live: {lint or 'no findings'}")
    return res


# ---------------------------------------------------------------------------
# Phase 31: MLA's latent cache cut over the sequence (deepseek-v2-236b under
# the kvseq arm's act_kv_seq -> model) and K3 at (192, 128) with its
# log-sum-exp
# ---------------------------------------------------------------------------

MLA_CUT_WORLD = 2                    # mesh (data 1, model 2)
MLA_CUT_RULES = {"act_kv_seq": "model"}
# by dtype: (layers, latent columns, each row's written length). bf16: the
# dense layer and 1 MoE layer over decode_32k's 32,768 columns, row 0's
# prefill chunk crossing the ranks' boundary (16,352..16,415), row 1's in
# rank 0's half (rank 1 sees none of row 1); fp32: the dense layer alone
# over 8,192 columns, the rows placed alike
MLA_CUT = {"bfloat16": (2, 32768, (16352, 10000)),
           "float32": (1, 8192, (4064, 2500))}
MLA_CUT_CHUNK = 64                   # the prefill chunk, then the steps
MLA_CUT_STEPS = 4
MLA_CUT_SEED = 31


def mla_cut_config(dtype_name):
    from repro_torch.configs.registry import get_config
    return dataclasses.replace(get_config(DEEPSEEK),
                               n_layers=MLA_CUT[dtype_name][0],
                               dtype=dtype_name)


def mla_cut_caches(cfg, ctx=None):
    """deepseek's latent caches of MLA_CUT's rows and columns at their
    written lengths, drawn on the card from MLA_CUT_SEED (the sink column
    zero): the same on every process; with a rank's context, its cut of
    them (``tp.shard_caches``). The halves differ, so the merge's weights
    decide the output: the second's latent at half the scale (smaller
    scores), each half's about a mean of its own (values about a mean of
    their own once up-projected)."""
    from repro_torch.distributed import tp as TP
    from repro_torch.models import transformer as T
    _, seq, lens = MLA_CUT[cfg.dtype]
    gen = torch.Generator(device="cuda").manual_seed(MLA_CUT_SEED)
    caches = T.init_caches(cfg, len(lens), seq, cfg.dtype, "cuda")
    half = seq // MLA_CUT_WORLD
    for c in caches:
        for name in ("ckv", "krope"):
            t = c[name]
            t[:, :seq].normal_(generator=gen)
            t[:, half:seq].mul_(0.5)
            for sl in (slice(0, half), slice(half, seq)):
                t[:, sl].add_(torch.randn(t.shape[2:], generator=gen,
                                          device="cuda").to(t.dtype))
        c["len"].copy_(torch.tensor(lens, dtype=c["len"].dtype))
    if ctx is None:
        return caches
    cut = TP.shard_caches(caches, ctx, shard_kv=False)
    del caches
    torch.cuda.empty_cache()
    return cut


def mla_cut_serve(cfg, params, caches, ctx, feed=None):
    """The serving steps over contiguous latent caches (K3 at (192, 128)):
    a MLA_CUT_CHUNK-token prefill chunk from each row's length, then
    MLA_CUT_STEPS greedy decode steps; logits (1 + steps, B, vocab) and
    greedy tokens a step, each step's wall time and collectives. ``feed``
    gives each decode step's input tokens (another run's greedy stream),
    else the previous step's argmax."""
    from repro_torch.core.plan import AttentionPolicy
    from repro_torch.distributed import tp as TP
    from repro_torch.serving.engine import make_decode_step, \
        make_prefill_step
    _, _, lens = MLA_CUT[cfg.dtype]
    B = len(lens)
    attn = AttentionPolicy(backend="fused")
    prefill = make_prefill_step(cfg, attn=attn, tpctx=ctx)
    decode = make_decode_step(cfg, attn=attn, tpctx=ctx)
    rng = np.random.default_rng(MLA_CUT_SEED)
    chunk = torch.from_numpy(rng.integers(0, cfg.vocab, (B, MLA_CUT_CHUNK))
                             .astype(np.int32)).cuda()
    pos = (torch.tensor(lens, dtype=torch.int32, device="cuda")[:, None]
           + torch.arange(MLA_CUT_CHUNK, dtype=torch.int32, device="cuda"))
    logits, toks, step_ms, coll = [], [], [], []
    with torch.no_grad():
        for i in range(1 + MLA_CUT_STEPS):
            TP.collectives.reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if i == 0:
                lg, caches = prefill(params, {"tokens": chunk,
                                              "positions": pos}, caches)
                pos = pos[:, -1:] + 1
            else:
                if feed is not None:
                    tok = torch.tensor(feed[i - 1], dtype=torch.int32,
                                       device="cuda")[:, None]
                lg, caches = decode(params, tok, pos, caches)
                pos = pos + 1
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            c = TP.collectives.snapshot()
            c["by_axes"] = TP.collectives.by_axes(
                ctx.mesh if ctx is not None else None)
            coll.append(c)
            tok = torch.argmax(lg, dim=-1)[:, None].to(torch.int32)
            logits.append(lg.float())
            toks.append(tok[:, 0].tolist())
    return torch.stack(logits).cpu(), toks, step_ms, coll, caches


def latent_bytes(caches, real=False):
    """Bytes of the latent caches (``real``: without the sink column)."""
    return sum((c[n][:, :-1] if real else c[n]).numel()
               * c[n].element_size() for c in caches
               for n in ("ckv", "krope"))


def mla_cut_gathers(cfg, Sq):
    """The closed form of a step's all-gathers over model, a layer: the
    rank's queries of its heads to every head (B x Sq x H x 192 in the
    model's dtype), then the merge's partials (2 ranks x B x Sq x H x (128
    + 1) fp32): (calls, bytes)."""
    B, H = len(MLA_CUT[cfg.dtype][2]), cfg.n_heads
    D = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    es = torch.empty((), dtype=getattr(torch, cfg.dtype)).element_size()
    per_layer = (B * Sq * H * D * es
                 + MLA_CUT_WORLD * B * Sq * H * (cfg.v_head_dim + 1) * 4)
    return 2 * cfg.n_layers, per_layer * cfg.n_layers


def mla_cut_kernels(dtype_name):
    """(required, allowed) launch counters of a phase 31 run: bf16 on the
    tensor cores, K3 on both routes (rows at the chunk, split at decode);
    fp32 on the CUDA cores."""
    if dtype_name == "bfloat16":
        return K1_BF16 + K3_BF16, ()
    return ("matrixflow_gemm", "flash_attention"), CUDA_CORE_COUNTERS


def mla_cut_rank(rank, world, root, feeds):
    """One rank of phase 31 on cuda:0, mesh (data 1, model 2) under the
    kvseq arm's rules: each dtype's prefill and decode over its cut of the
    latent caches, fed the one-device greedy tokens (``feeds``): logits,
    tokens, the collectives of every step, its latent bytes, the launches
    and its peak allocation; bf16 again with the ranks' partials merged
    with equal weights (a planted fault)."""
    sys.path.insert(0, str(Path(root) / "src"))
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.distributed import tp as TP
    from repro_torch.launch import steps as ST
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as T
    from repro_torch.models.module import param_axes

    mesh = make_host_mesh(model=MLA_CUT_WORLD)
    out = {"coords": dict(mesh.coords)}
    for dtype_name in MLA_CUT:
        cfg = mla_cut_config(dtype_name)
        ctx = ST.serve_context(cfg, mesh, extra_overrides=MLA_CUT_RULES)
        whole = T.init_model(cfg, seed=0, device="cuda", draw_device="cuda")
        params = TP.shard_params(whole, param_axes(cfg), ctx,
                                 units=TP.head_units(cfg))
        del whole
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        caches = mla_cut_caches(cfg, ctx)
        offsets = [int(c["seq_offset"]) for c in caches]
        reset_counts()
        lg, toks, step_ms, coll, caches = mla_cut_serve(
            cfg, params, caches, ctx, feeds[dtype_name])
        torch.cuda.synchronize()
        attn = params["dense_layer0"]["attn"]
        out[dtype_name] = dict(
            logits=lg, tokens=toks, step_ms=step_ms, collectives=coll,
            latent_bytes=latent_bytes(caches), latent_bytes_real=latent_bytes(
                caches, True), offsets=offsets, launches=counts(),
            lens=[c["len"].tolist() for c in caches],
            wkv_b=list(attn["wkv_b"].shape), wq_b=list(attn["wq_b"].shape),
            peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        del caches
        if dtype_name == "bfloat16":
            # planted fault: the ranks' partials merged with equal weights,
            # whatever their log-sum-exps; it must fail the bf16 gate
            real_merge = TP.merge_stack
            TP.merge_stack = lambda o_r, lse_r: o_r.float().mean(dim=0)
            try:
                out[(dtype_name, "fault")] = mla_cut_serve(
                    cfg, params, mla_cut_caches(cfg, ctx), ctx,
                    feeds[dtype_name])[0]
            finally:
                TP.merge_stack = real_merge
        del params
        gc.collect()
        torch.cuda.empty_cache()
    return out


def run_mla_cut_phase():
    """Phase 31. (a) K3 at (192, 128) with its log-sum-exp against its
    plain version (:func:`run_lse_kernel_phase` at deepseek's LSE_CELLS);
    (b) deepseek-v2-236b at full width (MLA_CUT's layers), its latent
    caches drawn on the card: a prefill chunk and MLA_CUT_STEPS decode
    steps on one device, then on MLA_CUT_WORLD gloo ranks of the card
    whose latent is cut over model with the query heads (the kvseq arm's
    rules: each rank up-projects its own columns for every head through a
    whole wkv_b, gathers the queries, merges over model), each rank fed the
    one-device tokens: fp32 logits within GEMM_TOLS and tokens equal;
    bf16 logits within GEMM_TOLS at step 0 (the prefill) and after it no
    farther from one device's than LONG_CONTROL_FACTOR times a one-device
    control's (each decode's keys over two cluster CTAs; its own tokens
    must not part); a planted fault (an equal-weight merge) must fail that
    gate; each rank's latent columns half of one device's; every step's
    all-gathers the closed form (:func:`mla_cut_gathers`), a decode step's
    collectives the dry run's."""
    import tempfile

    from repro_torch.distributed.launch import spawn
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import transformer as T

    t0 = time.perf_counter()
    res = {"kernels": run_lse_kernel_phase(Timer(), DEEPSEEK)}
    t_a = time.perf_counter() - t0
    one, feeds, control = {}, {}, {}
    for dtype_name in MLA_CUT:
        cfg = mla_cut_config(dtype_name)
        params = T.init_model(cfg, seed=0, device="cuda", draw_device="cuda")
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        lg, toks, step_ms, _, caches = mla_cut_serve(
            cfg, params, mla_cut_caches(cfg), None)
        one[dtype_name] = dict(
            logits=lg, tokens=toks, step_ms=step_ms,
            latent_bytes=latent_bytes(caches),
            latent_bytes_real=latent_bytes(caches, True),
            peak_gib=torch.cuda.max_memory_allocated() / 2**30,
            launches=read_counts(f"mla cut one device {dtype_name}",
                                 *mla_cut_kernels(dtype_name)))
        feeds[dtype_name] = toks[:-1]
        del caches
        if not bool(torch.isfinite(lg).all()):
            fail(f"mla cut one device {dtype_name}: logits not finite")
        # control: the same steps fed the same tokens, each decode's keys
        # over two cluster CTAs (B x Hkv pairs fill the SMs: one CTA a
        # pair otherwise), another merge order
        real_split = FA.split_count
        FA.split_count = lambda *a: 2
        try:
            ctrl, ctrl_toks, _, _, _ = mla_cut_serve(
                cfg, params, mla_cut_caches(cfg), None, toks[:-1])
        finally:
            FA.split_count = real_split
        if ctrl_toks != toks:
            fail(f"mla cut {DEEPSEEK} {dtype_name}: the one-device "
                 f"control's tokens {ctrl_toks} part from one device's "
                 f"{toks}")
        control[dtype_name] = ctrl
        del params
        gc.collect()
        torch.cuda.empty_cache()
    t1 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mla_cut_") as work:
        ranks = spawn(mla_cut_rank, MLA_CUT_WORLD, (str(ROOT), feeds),
                      workdir=work, timeout_s=TP_RANKS_TIMEOUT_S,
                      collective_timeout_s=TP_COLLECTIVE_TIMEOUT_S)
    t_ranks = time.perf_counter() - t1
    res["cases"] = {}
    problems = []                  # every case is printed before a failure
    for dtype_name, ref in one.items():
        atol, rtol = GEMM_TOLS[dtype_name]
        cfg = mla_cut_config(dtype_name)
        _, seq, lens = MLA_CUT[dtype_name]
        d = DR.run_step(cfg, "decode", len(lens), seq,
                        mesh=Mesh.abstract((1, MLA_CUT_WORLD),
                                           ("data", "model")),
                        rules_overrides=MLA_CUT_RULES)
        want_ag = [mla_cut_gathers(cfg, MLA_CUT_CHUNK if i == 0 else 1)
                   for i in range(1 + MLA_CUT_STEPS)]
        ref_lg = ref["logits"].flatten(1)          # (steps, B x vocab)
        row = {"one_device": {k: v for k, v in ref.items()
                              if k != "logits"}, "ranks": []}
        cdiff = (control[dtype_name].flatten(1) - ref_lg).abs()
        for r, rk in enumerate(ranks):
            got = rk[dtype_name]
            tag = f"mla cut {DEEPSEEK} {dtype_name} rank {r}"
            diff = (got["logits"].flatten(1) - ref_lg).abs()
            ok = diff <= atol + rtol * ref_lg.abs()
            parted = [i for i, (a, b) in enumerate(zip(got["tokens"],
                                                       ref["tokens"]))
                      if a != b]
            if dtype_name == "float32" and (not bool(ok.all()) or parted):
                problems.append(
                    f"{tag}: logits max |d| by step "
                    f"{diff.amax(dim=1).tolist()} from one device's "
                    f"(atol={atol} rtol={rtol}), tokens {got['tokens']} "
                    f"(one device {ref['tokens']})")
            fault = {}
            if dtype_name == "bfloat16":
                over = long_bf16_over(diff, cdiff, ok)
                if over:
                    problems.append(
                        f"{tag}: logits max |d| by step "
                        f"{diff.amax(dim=1).tolist()} from one device's "
                        f"fail the bf16 gate at steps {over} (step 0 within"
                        f" GEMM_TOLS, later {LONG_CONTROL_FACTOR} x the "
                        f"one-device control's {cdiff.amax(dim=1).tolist()})")
                fdiff = (rk[(dtype_name, "fault")].flatten(1) - ref_lg).abs()
                f_ok = fdiff <= atol + rtol * ref_lg.abs()
                fault = dict(max_abs_diff_by_step=fdiff.amax(dim=1).tolist(),
                             outside_tols=(~f_ok).sum(dim=1).tolist(),
                             failing_steps=long_bf16_over(fdiff, cdiff, f_ok))
                if 0 not in fault["failing_steps"]:
                    problems.append(
                        f"{tag}: the planted fault (an equal-weight merge) "
                        f"passes the bf16 gate at step 0: {fault}")
            if 2 * got["latent_bytes_real"] != ref["latent_bytes_real"]:
                problems.append(
                    f"{tag}: latent columns {got['latent_bytes_real']} B are "
                    f"not half of one device's {ref['latent_bytes_real']} B")
            ag = [(c["by_axes"].get("all_gather:model", {}).get("calls", 0),
                   c["by_axes"].get("all_gather:model", {}).get("bytes", 0))
                  for c in got["collectives"]]
            if ag != want_ag:
                problems.append(f"{tag}: all-gathers a step {ag}, closed "
                                f"form {want_ag}")
            c = got["collectives"][2]
            if d["collectives_by_axes"] != c["by_axes"] \
                    or d["collective_counts"] != c["calls"]:
                problems.append(
                    f"{tag}: a decode step's collectives {c} differ from the "
                    f"dry run's ({d['collective_counts']}, "
                    f"{d['collectives_by_axes']})")
            required, allowed = mla_cut_kernels(dtype_name)
            check_counts(tag, got["launches"],
                         required + ("flash_attention_lse",), allowed)
            row["ranks"].append(dict(
                {k: v for k, v in got.items() if k != "logits"},
                logits_max_abs_diff_by_step=diff.amax(dim=1).tolist(),
                outside_tols=(~ok).sum(dim=1).tolist(), parted_steps=parted,
                control_max_abs_diff_by_step=cdiff.amax(dim=1).tolist(),
                equal_weight_merge_fault=fault, all_gathers_closed_form=want_ag))
            log(f"{tag}: logits max |d| by step {diff.amax(dim=1).tolist()} "
                f"({(~ok).sum(dim=1).tolist()} of {ok.shape[1]} outside "
                f"GEMM_TOLS; one-device control {cdiff.amax(dim=1).tolist()}"
                f"), tokens {got['tokens']} (one device {ref['tokens']}; "
                f"parted at {parted}), latent {got['latent_bytes']} B (one "
                f"device {ref['latent_bytes']} B), offsets {got['offsets']}, "
                f"wkv_b {got['wkv_b']} wq_b {got['wq_b']}, planted "
                f"equal-weight merge {fault}, decode step "
                f"{statistics.median(got['step_ms'][1:]):.1f} ms (one device "
                f"{statistics.median(ref['step_ms'][1:]):.1f}), prefill "
                f"{got['step_ms'][0]:.1f} ms ({ref['step_ms'][0]:.1f}), "
                f"all-gathers a step {ag} (closed form {want_ag}), a decode "
                f"step's collectives {c['by_axes']} (dry run "
                f"{d['collectives_by_axes']}), peak {got['peak_gib']:.2f} GiB "
                f"(one device {ref['peak_gib']:.2f}), launches "
                f"{ {k: v for k, v in got['launches'].items() if v} }")
        res["cases"][dtype_name] = row
    if problems:
        fail("; ".join(problems))
    res["launches"] = {f"{n} rank {r}": rk[n]["launches"]
                       for r, rk in enumerate(ranks) for n in one}
    res["seconds"] = time.perf_counter() - t0
    log(f"mla cut: phase {res['seconds']:.1f} s ((a) {t_a:.1f} s, ranks "
        f"{t_ranks:.1f} s)")
    return res


def slice_paths(report) -> dict:
    """The launch counts of phases 20, 22, 23, 24, 26, 27, 28 and 29's
    paths, by path. Of the slice entries of the kernels line
    (:func:`slice_entries`), the training ones count phase 20's
    ``training`` path alone, the mixed ones phase 22's, and the ``_tp2``
    ones phase 23's TP=2 serving ranks; every path, the DP=2 train step,
    the pipeline ranks, phase 24's TP=2 train steps, phase 26's FSDP
    steps, phase 27's EP ranks and phase 28's pod ranks too, joins the
    kernels' all-path totals in ``main``."""
    out = {}
    if "train" in report:
        out["training"] = report["train"]["launches"]
    for name, r in report.get("mixed", {}).items():
        if "launches" in r:
            out[f"mixed dtypes {name} serving"] = r["launches"]
    for r, rk in enumerate(report.get("tp", {}).get("ranks", [])):
        for dtype in ("float32", "bfloat16"):
            out[f"tp{TP_WORLD} rank {r} {dtype} serving"] = \
                rk["serving"][f"{dtype} launches"]
        out[f"dp{TP_WORLD} rank {r} train step"] = rk["train"]["launches"]
        out[f"pipeline rank {r}"] = rk["pipeline"]["launches"]
    for r, rk in enumerate(report.get("tp_train", {}).get("ranks", [])):
        for dtype in ("fp32", "bf16"):
            out[f"tp{TP_WORLD}-train rank {r} {dtype} step"] = \
                rk[dtype]["launches"]
    for name, run in report.get("fsdp", {}).items():
        for r, rk in enumerate(run["ranks"] if isinstance(run, dict)
                               and "ranks" in run else []):
            for dtype in ("fp32", "bf16"):
                if dtype in rk:
                    out[f"fsdp {name} rank {r} {dtype} step"] = \
                        rk[dtype]["launches"]
    for r, rk in enumerate(report.get("ep", {}).get("ranks", [])):
        for dtype in ("fp32", "bf16"):
            out[f"ep{EP_WORLD} rank {r} {dtype} forward+backward"] = \
                rk[dtype]["launches"]
    for name in POD_MESHES:
        for r, rk in enumerate(report.get("pod", {}).get(name, {})
                               .get("ranks", [])):
            out[f"pod {name} rank {r} fp32 step"] = rk["launches"]
    for name in ("a", "b"):
        for r, rk in enumerate(report.get("seqpar", {}).get(name, {})
                               .get("ranks", [])):
            for dtype in ("float32", "bfloat16"):
                out[f"seqpar ({name}) rank {r} {dtype} step"] = \
                    rk[dtype]["launches"]
    if "analysis" in report:
        out["analysis lint live"] = report["analysis"]["lint_launches"]
        out["analysis ops facade"] = report["analysis"]["facade_launches"]
    for name, c in report.get("long", {}).get("launches", {}).items():
        out[f"long {ZAMBA} {name} decode"] = c
    for name, c in report.get("mla_cut", {}).get("launches", {}).items():
        out[f"mla cut {DEEPSEEK} {name} prefill + decode"] = c
    return out


def slice_entries(report) -> list:
    """The kernels line's entries of the later slices' instances: K1's
    batch grid and its backward launches (training), K3's and K4's
    fp32-q over bf16-K/V instances (mixed dtypes), K1, K3, K4 and K5 at
    a TP=2 rank's shapes, K1 at an EP_WORLD rank's training shapes
    (phase 27; its fp32 times beside), each with its launches on its path
    and its times per training step, forward+backward or decode step."""
    paths = slice_paths(report)
    out = []

    def entry(name, counter, source, replaces, rows, dtype, path, others,
              *, prefix):
        launches = {p: c[counter] for p, c in paths.items()
                    if c[counter] and p.startswith(prefix)}
        out.append({"name": name, "route": "cuda",
                    "source": f"src/repro_torch/csrc/{source}.cu",
                    "replaces": replaces, "launches": sum(launches.values()),
                    "launches_by_path": launches, "times_per": path,
                    **aggregate(rows, dtype, path),
                    "other_runs": {p: aggregate(rows, dtype, p)
                                   for p in others}})

    if "train_kernels" in report:
        rows = report["train_kernels"]
        k1 = "src/repro/kernels/matrixflow_gemm.py:137"
        entry("matrixflow_gemm_batched", "matrixflow_gemm_batched",
              "matrixflow_gemm", k1,
              [r for r in rows if r["G"] > 1], "bfloat16",
              "train batch grid forward", ("train batch grid backward",),
              prefix="training")
        entry("matrixflow_gemm_backward", "matrixflow_gemm_backward",
              "matrixflow_gemm", k1, rows, "bfloat16", "train backward",
              ("train forward", "train batch grid backward"),
              prefix="training")
    if "kernels" in report.get("ep", {}):
        rows, rank_path = report["ep"]["kernels"], ep_path(EP_WORLD)
        entry(f"matrixflow_gemm_ep{EP_WORLD}", "matrixflow_gemm",
              "matrixflow_gemm", "src/repro/kernels/matrixflow_gemm.py:137",
              rows, "bfloat16", rank_path, (ep_path(1),),
              prefix=f"ep{EP_WORLD} ")
        out[-1]["float32"] = {p: aggregate(rows, "float32", p)
                              for p in (rank_path, ep_path(1))}
        out[-1]["launches_by_route"] = {
            r: sum(c[f"matrixflow_gemm_{r}"] for p, c in paths.items()
                   if p.startswith(f"ep{EP_WORLD} "))
            for r in ("wgmma", "mma", "cuda_core")}
    if "mixed_kernels" in report:
        for kern, line in (("flash_attention", 199), ("paged_attention", 188)):
            entry(f"{kern}_bf16kv", f"{kern}_{MIXED_ROUTE}", kern,
                  f"src/repro/kernels/{kern}.py:{line}",
                  [r for r in report["mixed_kernels"] if r["kernel"] == kern],
                  "float32 q, bfloat16 KV", "decode step", ("prefill",),
                  prefix="mixed dtypes")
    if "long" in report:          # K3 with its log-sum-exp (phase 30)
        entry("flash_attention_lse", "flash_attention_lse",
              "flash_attention", "src/repro/kernels/flash_attention.py:199",
              report["long"]["kernels"], "bfloat16", "split, a rank",
              ("split, one device", "rows, prefill 64"),
              prefix=("long ", "mla cut "))
        out[-1]["float32"] = aggregate(report["long"]["kernels"], "float32",
                                       "cuda cores")
    if "mla_cut" in report:       # its (192, 128) instance (phase 31)
        entry("flash_attention_lse_d192", "flash_attention_lse",
              "flash_attention", "src/repro/kernels/flash_attention.py:199",
              report["mla_cut"]["kernels"], "bfloat16", "mla split, a rank",
              ("mla split, one device", "mla rows, prefill 64"),
              prefix="mla cut ")
        out[-1]["launches_by_route"] = {
            r: sum(c[f"flash_attention_{r}"] for p, c in paths.items()
                   if p.startswith("mla cut ")) for r in ATTN_ROUTES}
    if "tp_kernels" in report:
        tk, tp = report["tp_kernels"], f"tp{TP_WORLD} "
        rank = tp_rank_config().name
        for name, counter, source, line, rows, path in (
                ("matrixflow_gemm", "matrixflow_gemm", "matrixflow_gemm",
                 "matrixflow_gemm.py:137", tk["gemm"],
                 f"{TP_ARCH} tp{TP_WORLD}"),
                ("paged_attention", "paged_attention", "paged_attention",
                 "paged_attention.py:188", tk["attention"], rank),
                ("paged_attention_int8", "paged_attention_int8",
                 "paged_attention", "paged_attention.py:222",
                 tk["int8_attention"], rank),
                ("flash_attention", "flash_attention", "flash_attention",
                 "flash_attention.py:199", tk["flash"], rank)):
            entry(f"{name}_tp{TP_WORLD}", counter, source,
                  f"src/repro/kernels/{line}", rows, "bfloat16",
                  f"{path} decode step", (f"{path} prefill",), prefix=tp)
    return out


def aggregate(rows, dtype, path="decode step"):
    """Per run of ``path`` (a decode step, an encoder forward): each of its
    cells weighted by its uses per run."""
    sel = [r for r in rows if r["dtype"] == dtype and r["path"] == path]
    tot = {k: sum(r[k] * r["uses"] for r in sel)
           for k in ("ms", "plain_ms", "bound_ms")}
    lib = [r["library_ms"] for r in sel]
    tot["library_ms"] = None if None in lib else sum(
        t * r["uses"] for t, r in zip(lib, sel))
    by = sum(r["uses"] * r["bound_ms"] for r in sel
             if r["bound_by"] == "bytes")
    tot["bound_by"] = "bytes" if by >= tot["bound_ms"] / 2 else "operations"
    tot["max_abs_err"] = max(r["max_abs_err"] for r in rows
                             if r["dtype"] == dtype)
    return tot


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this test needs a GPU")
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from "
             f"the root of a checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    OUT_DIR.mkdir(exist_ok=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else \
        "nvidia-smi gave no answer"
    print(card, flush=True)
    report = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda}

    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    build_logs = _build.build()
    report["build_s"] = time.perf_counter() - t0
    (OUT_DIR / "chip_smoke_build.log").write_text(
        "\n".join(f"== {k}\n{v}" for k, v in build_logs.items()))
    log(f"build: {sorted(build_logs) or 'cached'} in {report['build_s']:.1f} s")

    if sys.argv[1:2] == ["--identity"]:      # phase 12 alone, on the named archs
        from repro_torch.models import transformer as T
        for arch in sys.argv[2:] or IDENTITY_ARCHS:
            c = get_config(arch)
            run_identity_phase(c, T.init_model(c, seed=0, device="cuda"))
        return
    if sys.argv[1:2] == ["--zoo"]:           # phases 16-19 alone, or the named
        report["zoo"] = run_zoo_phases(sys.argv[2:] or ZOO_MODELS)
        (OUT_DIR / "chip_smoke_zoo.json").write_text(
            json.dumps(report, indent=1))
        return
    if sys.argv[1:2] == ["--tp"]:             # phase 23 with its kernel cells
        timer = Timer()
        report["tp_kernels"] = run_tp_kernel_phase(timer)
        del timer
        report["tp"] = run_tp_phase()
        (OUT_DIR / "chip_smoke_tp.json").write_text(json.dumps(report,
                                                               indent=1))
        print(json.dumps({"kernels": slice_entries(report)}), flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return
    if sys.argv[1:2] in (["--tp-train"], ["--fsdp"], ["--ep"], ["--pod"],
                         ["--seqpar"]):
        # phase 24, 26, 27, 28 or 32 alone
        if sys.argv[1] == "--tp-train":
            report["tp_train"] = run_tp_train_phase()
        elif sys.argv[1] == "--seqpar":
            report["seqpar"] = run_seqpar_phase()
        elif sys.argv[1] == "--fsdp":
            report["fsdp"] = run_fsdp_phase()
        elif sys.argv[1] == "--ep":
            report["ep"] = run_ep_phase()
        else:
            report["pod"] = run_pod_phase()
        release_one_device_train_steps()
        (OUT_DIR / f"chip_smoke_{sys.argv[1][2:].replace('-', '_')}.json"
         ).write_text(json.dumps(report, indent=1))
        print(json.dumps({"kernels": slice_entries(report)}), flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return
    if sys.argv[1:2] == ["--roofline"]:       # phases 3, 5 and 20, then 25
        cfg = get_config(ARCH)
        report["serving"] = run_serving_phase(cfg)
        report["encoders"] = run_encoder_phase(get_config("bert-base"),
                                               get_config("vit-base"))
        report["train"] = run_train_phase(cfg)
        report["roofline"] = run_roofline_phase(report)
        (OUT_DIR / "chip_smoke_roofline.json").write_text(
            json.dumps(report, indent=1))
        print(json.dumps({"kernels": slice_entries(report)}), flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return
    if sys.argv[1:2] == ["--long"]:           # phase 30 alone
        report["long"] = run_long_phase()
        (OUT_DIR / "chip_smoke_long.json").write_text(
            json.dumps(report, indent=1, default=str))
        print(json.dumps({"kernels": slice_entries(report)}), flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return
    if sys.argv[1:2] == ["--mla-cut"]:        # phase 31 alone
        report["mla_cut"] = run_mla_cut_phase()
        (OUT_DIR / "chip_smoke_mla_cut.json").write_text(
            json.dumps(report, indent=1, default=str))
        print(json.dumps({"kernels": slice_entries(report)}), flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return
    if sys.argv[1:2] == ["--analysis"]:       # phase 29 alone
        report["analysis"] = run_analysis_phase()
        (OUT_DIR / "chip_smoke_analysis.json").write_text(
            json.dumps(report, indent=1))
        print(json.dumps({"kernels": slice_entries(report)}), flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return
    if sys.argv[1:2] in (["--train"], ["--mixed"]):   # phases 20-21 or 22
        cfg = get_config(ARCH)
        timer = Timer()
        if sys.argv[1] == "--train":
            report["train_kernels"] = run_train_kernel_phase(timer, cfg)
            del timer
            report["train"] = run_train_phase(cfg)
            report["train_fp32"] = run_train_fp32_phase(cfg)
        else:
            report["mixed_kernels"] = run_mixed_kernel_phase(timer, cfg)
            del timer
            report["mixed"] = run_mixed_phase(
                dataclasses.replace(cfg, n_layers=MIXED_LAYERS))
        (OUT_DIR / f"chip_smoke_{sys.argv[1][2:]}.json").write_text(
            json.dumps(report, indent=1))
        print(json.dumps({"kernels": slice_entries(report)}), flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return

    cfg = get_config(ARCH)
    bert, vit = get_config("bert-base"), get_config("vit-base")
    mamba, zamba = get_config(MAMBA), get_config(ZAMBA)
    dense = [get_config(a) for a in DENSE_MODELS]
    # the zoo's last four at their depth on the card (phases 16-19)
    vlm, audio, dbrx, deepseek = (zoo_config(a) for a in ZOO_MODELS)
    timer = Timer()
    begin("gemm")
    report["gemm"] = run_gemm_phase(timer, cfg, bert, vit, (mamba, zamba),
                                    dense, (vlm, audio, dbrx, deepseek))
    begin("attention")
    report["attention"] = run_attention_phase(timer, cfg,
                                              dense + [vlm, dbrx, audio])
    begin("flash")
    report["flash"] = run_flash_phase(timer, flash_cells(
        cfg, bert, vit, get_config("vit-huge"), zamba,
        np.random.default_rng(3), dense + [vlm, dbrx, audio], deepseek))
    begin("quant_gemm")
    report["quant_gemm"] = run_quant_gemm_phase(timer, cfg, bert, vit)
    begin("int8_attention")
    report["int8_attention"] = run_int8_attention_phase(timer, cfg,
                                                        dense + [dbrx])
    begin("ssd")
    report["ssd"] = run_ssd_phase(timer, mamba, zamba)
    begin("train_kernels")
    report["train_kernels"] = run_train_kernel_phase(timer, cfg)
    begin("mixed_kernels")
    report["mixed_kernels"] = run_mixed_kernel_phase(timer, cfg)
    begin("tp_kernels")
    report["tp_kernels"] = run_tp_kernel_phase(timer)
    del timer
    begin("serving")
    report["serving"] = run_serving_phase(cfg)
    begin("parity")
    report["parity"] = run_parity_phase(cfg)
    begin("encoders")
    report["encoders"] = run_encoder_phase(bert, vit)
    begin("contiguous")
    report["contiguous"] = run_contiguous_phase(
        dataclasses.replace(cfg, n_layers=SERVE_CUT_LAYERS))
    begin("int8_serving")
    report["int8_serving"] = run_int8_serving_phase(
        dataclasses.replace(cfg, n_layers=SERVE_CUT_LAYERS))
    begin("mamba2_serving")
    report["mamba2_serving"] = run_ssm_serving_phase(
        dataclasses.replace(mamba, n_layers=SSM_SERVE_LAYERS[MAMBA]),
        MAMBA_PROMPT, K1_BF16 + K6_BF16, True)
    begin("zamba2_serving")
    report["zamba2_serving"] = run_ssm_serving_phase(
        dataclasses.replace(zamba, n_layers=SSM_SERVE_LAYERS[ZAMBA]),
        ZAMBA_PROMPT, K1_BF16 + K3_BF16 + K6_BF16, False)
    begin("ssm_parity")
    report["ssm_parity"] = {c.name: run_ssm_parity_phase(c)
                            for c in (mamba, zamba)}
    begin("features")
    report["features"] = feat = run_features_phase(
        dataclasses.replace(cfg, n_layers=FEATURES_LAYERS))
    from repro_torch.models import transformer as T
    begin("identity")
    report["identity"] = run_identity_phase(
        cfg, T.init_model(cfg, seed=0, device="cuda"))
    begin("dense")
    report["dense"] = {a: run_dense_phase(a, *v)
                       for a, v in DENSE_MODELS.items()}
    begin("zoo")
    report["zoo"] = zoo = run_zoo_phases()
    begin("train")
    report["train"] = run_train_phase(cfg)
    begin("train_fp32")
    report["train_fp32"] = run_train_fp32_phase(cfg)
    begin("mixed")
    report["mixed"] = run_mixed_phase(
        dataclasses.replace(cfg, n_layers=MIXED_LAYERS))
    begin("tp")
    report["tp"] = run_tp_phase()
    begin("tp_train")
    report["tp_train"] = run_tp_train_phase()
    begin("seqpar")           # phase 32, while phase 24's first moment lives
    report["seqpar"] = run_seqpar_phase()
    begin("fsdp")
    report["fsdp"] = run_fsdp_phase()
    release_one_device_train_steps()
    begin("ep")
    report["ep"] = run_ep_phase()
    begin("pod")
    report["pod"] = run_pod_phase()
    begin("roofline")
    report["roofline"] = run_roofline_phase(report)
    begin("analysis")
    report["analysis"] = run_analysis_phase()
    begin("long")
    report["long"] = run_long_phase()
    begin("mla_cut")
    report["mla_cut"] = run_mla_cut_phase()
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(report, indent=1,
                                                        default=str))

    by_path = {"paged serving": report["serving"]["launches"],
               **{f"{n} forward": report["encoders"][n]["launches"]
                  for n in (bert.name, vit.name)},
               "contiguous serving": report["contiguous"]["launches"],
               "int8 paged serving": report["int8_serving"]["launches"],
               f"{MAMBA} serving": report["mamba2_serving"]["launches"],
               f"{ZAMBA} serving": report["zamba2_serving"]["launches"],
               "prefix cache": feat["prefix_bf16"]["launches"],
               "prefix cache, int8 KV": feat["prefix_int8_kv"]["launches"],
               **{f"spec {n}": r["launches"]
                  for n, r in feat["spec"].items()},
               "frontend": feat["frontend"]["launches"],
               "prefix cache, obs": feat["obs"]["launches"]}
    identity = {ARCH: report["identity"], **{
        a: r["identity"] for a, r in report["dense"].items()
        if "identity" in r}}
    by_path.update({f"identity {a} {kv} KV": r["launches"]
                    for a, ident in identity.items()
                    for kv, r in ident.items()})
    for a, r in list(report["dense"].items()) + [(DBRX, zoo[DBRX]),
                                                  (VLM, zoo[VLM]),
                                                  (DEEPSEEK, zoo[DEEPSEEK])]:
        by_path.update({f"{a} {run} serving": r[run]["launches"]
                        for run in ("paged", "contiguous", "int8") if run in r})
    by_path.update(slice_paths(report))
    by_path.update({f"{VLM} vlm forward": zoo[VLM]["vlm_forward"]["launches"],
                    f"{VLM} vlm decode": zoo[VLM]["vlm_decode"]["launches"],
                    **{f"{AUDIO} {k} forward": zoo[AUDIO][k]["launches"]
                       for k in ("contiguous", "paged")}})
    qwen2, qwen3, granite = (m.name for m in dense)
    zoo_steps = tuple(f"{m} {p}" for m in (VLM, DBRX, DEEPSEEK)
                      for p in ("decode step", "prefill"))

    def entry(name, source, replaces, rows, path, other_paths, counter=None,
              paths=None):
        """``counter``'s launches (default ``name``'s) over ``paths`` (default
        every path), and ``rows``' times per run of ``path``."""
        counter = counter or name
        launches = {p: c[counter] for p, c in by_path.items()
                    if c[counter] and (paths is None or p in paths)}
        return {"name": name, "route": "cuda",
                "source": f"src/repro_torch/csrc/{source}.cu",
                "replaces": replaces, "launches": sum(launches.values()),
                "launches_by_path": launches, "times_per": path,
                **aggregate(rows, "bfloat16", path),
                "other_runs": {p: aggregate(rows, "bfloat16", p)
                               for p in other_paths}}

    ssd_paths = sorted({r["path"] for r in report["ssd"]})
    main_ssd = f"{MAMBA} generate prefill B{SSM_SLOTS}xS{MAMBA_PROMPT}"
    def on_route(route, phase="gemm"):
        return [r for r in report[phase] if r["route"] == route]

    k1 = entry("matrixflow_gemm", "matrixflow_gemm",
               "src/repro/kernels/matrixflow_gemm.py:137", report["gemm"],
               "decode step", (f"{bert.name} forward", f"{vit.name} forward",
                               f"{MAMBA} decode step", f"{MAMBA} prefill",
                               f"{ZAMBA} decode step",
                               *(f"{m} {p}" for m in (qwen2, qwen3, granite)
                                 for p in ("decode step", "prefill")),
                               *zoo_steps, f"{AUDIO} decode step"))
    k1["launches_by_route"] = {
        r: sum(c[f"matrixflow_gemm_{r}"] for c in by_path.values())
        for r in ("wgmma", "mma", "cuda_core")}
    by_route = {
        k: {r: sum(c[f"{k}_{r}"] for c in by_path.values()) for r in routes}
        for k, routes in (("flash_attention", ATTN_ROUTES),
                          ("paged_attention", ATTN_ROUTES),
                          ("paged_attention_int8", ATTN_ROUTES),
                          ("matrixflow_gemm_dequant", K2_ROUTES),
                          ("ssd_scan", SSD_ROUTES))}
    kernels = [
        k1,
        entry("matrixflow_gemm_wgmma", "matrixflow_gemm",
              "src/repro/kernels/matrixflow_gemm.py:137", on_route("wgmma"),
              "decode step", (f"{bert.name} forward", f"{vit.name} forward",
                              "prefill", f"{MAMBA} prefill",
                              f"{MAMBA} decode step", f"{ZAMBA} decode step",
                              *(f"{m} {p}" for m in (qwen2, qwen3, granite)
                                for p in ("decode step", "prefill")),
                              *zoo_steps, f"{AUDIO} decode step")),
        # off every bf16 path since bf16 takes bm 64 at every M: its cells
        # time the decode GEMMs as they ran before, at bm 16
        dict(entry("matrixflow_gemm_mma", "matrixflow_gemm",
                   "src/repro/kernels/matrixflow_gemm.py:137",
                   on_route("mma"), "decode step" + MMA_BEFORE,
                   tuple(f"{m} decode step{MMA_BEFORE}"
                         for m in (MAMBA, ZAMBA, qwen2, qwen3, granite))),
             on_main_path=False),
        entry("matrixflow_gemm_dequant", "matrixflow_gemm",
              "src/repro/kernels/matrixflow_gemm.py:154",
              report["quant_gemm"], "decode step",
              ("prefill", f"{bert.name} forward")),
        entry("matrixflow_gemm_dequant_wgmma", "matrixflow_gemm",
              "src/repro/kernels/matrixflow_gemm.py:154",
              on_route("wgmma", "quant_gemm"), f"{bert.name} forward",
              ("prefill",)),
        entry("matrixflow_gemm_dequant_mma", "matrixflow_gemm",
              "src/repro/kernels/matrixflow_gemm.py:154",
              on_route("mma", "quant_gemm"), "decode step", ()),
        entry("flash_attention", "flash_attention",
              "src/repro/kernels/flash_attention.py:199", report["flash"],
              f"{bert.name} forward", (f"{vit.name} forward", "decode step",
                                       "zamba2 prefill", "zamba2 decode step",
                                       "verify step k4")),
        entry("flash_attention_rows", "flash_attention",
              "src/repro/kernels/flash_attention.py:199",
              on_route("rows", "flash"), f"{bert.name} forward",
              (f"{vit.name} forward", "vit-huge forward", "prefill", "chunk",
               "zamba2 prefill")),
        entry("flash_attention_split", "flash_attention",
              "src/repro/kernels/flash_attention.py:199",
              on_route("split", "flash"), "decode step",
              ("zamba2 decode step", "verify step k4")),
        # the head_dim-128 instances (the three dense decoders' contiguous
        # serving) and granite's group of 48
        entry("flash_attention_d128", "flash_attention",
              "src/repro/kernels/flash_attention.py:199",
              [r for r in report["flash"] if " D=128 " in r["cell"]],
              f"{qwen2} decode step",
              (f"{qwen2} prefill", f"{qwen3} decode step", f"{qwen3} prefill",
               f"{granite} decode step", f"{granite} prefill",
               *(f"{m} {p}" for m in (VLM, DBRX)
                 for p in ("decode step", "prefill"))),
              counter="flash_attention",
              paths={f"{m} contiguous serving" for m in (qwen2, qwen3,
                                                         granite, VLM, DBRX)}
              | {f"{VLM} vlm forward", f"{VLM} vlm decode"}),
        # MLA's q/k head dim 192 with v head dim 128 (deepseek-v2's
        # contiguous serving: split at decode, rows at prefill)
        dict(entry("flash_attention_d192", "flash_attention",
                   "src/repro/kernels/flash_attention.py:199",
                   [r for r in report["flash"] if " D=192 " in r["cell"]],
                   f"{DEEPSEEK} decode step", (f"{DEEPSEEK} prefill",),
                   counter="flash_attention",
                   paths={f"{DEEPSEEK} contiguous serving"}),
             launches_by_route={
                 r: by_path[f"{DEEPSEEK} contiguous serving"][
                     f"flash_attention_{r}"] for r in ATTN_ROUTES}),
        entry("flash_attention_group48", "flash_attention",
              "src/repro/kernels/flash_attention.py:199",
              [r for r in report["flash"] if " H=48 Hkv=1 " in r["cell"]],
              f"{granite} decode step", (f"{granite} prefill",),
              counter="flash_attention",
              paths={f"{granite} contiguous serving"}),
        entry("paged_attention", "paged_attention",
              "src/repro/kernels/paged_attention.py:188",
              report["attention"], "decode step",
              ("prefill", "verify step k4", "verify step k8",
               "tail prefill",
               *(f"{m} {p}" for m in (VLM, DBRX, AUDIO)
                 for p in ("decode step", "prefill")))),
        entry("paged_attention_rows", "paged_attention",
              "src/repro/kernels/paged_attention.py:188",
              on_route("rows", "attention"), "prefill",
              ("verify step k8", "tail prefill")),
        entry("paged_attention_split", "paged_attention",
              "src/repro/kernels/paged_attention.py:188",
              on_route("split", "attention"), "decode step",
              ("decode step, edge lengths", "verify step k4")),
        entry("paged_attention_group48", "paged_attention",
              "src/repro/kernels/paged_attention.py:188",
              [r for r in report["attention"] if " H=48 Hkv=1 " in r["cell"]],
              f"{granite} decode step", (f"{granite} prefill",),
              counter="paged_attention", paths={f"{granite} paged serving"}),
        entry("paged_attention_int8", "paged_attention",
              "src/repro/kernels/paged_attention.py:222",
              report["int8_attention"], "decode step",
              ("prefill", "chunk", "verify step k4", "verify step k8",
               "tail prefill", f"{DBRX} decode step", f"{DBRX} prefill")),
        entry("paged_attention_int8_split", "paged_attention",
              "src/repro/kernels/paged_attention.py:222",
              on_route("split", "int8_attention"), "decode step",
              ("verify step k4",)),
        entry("paged_attention_int8_rows", "paged_attention",
              "src/repro/kernels/paged_attention.py:222",
              on_route("rows", "int8_attention"), "prefill",
              ("chunk", "verify step k8", "tail prefill")),
        entry("paged_attention_int8_group48", "paged_attention",
              "src/repro/kernels/paged_attention.py:222",
              [r for r in report["int8_attention"]
               if " H=48 Hkv=1 " in r["cell"]],
              f"{granite} decode step", (f"{granite} prefill",),
              counter="paged_attention_int8",
              paths={f"{granite} int8 serving"}),
        entry("ssd_scan", "ssd_scan", "src/repro/kernels/ssd_scan.py:117",
              report["ssd"], main_ssd,
              [p for p in ssd_paths if p != main_ssd]),
    ]
    for k in kernels:
        if k["name"] in by_route:
            k["launches_by_route"] = by_route[k["name"]]
    kernels += slice_entries(report)
    # K6 per route: ms per run of each path the route takes, and per kernel
    # (phase) of a call, bf16
    k6 = next(k for k in kernels if k["name"] == "ssd_scan")
    k6["ms_by_route"] = {
        r: {p: aggregate(sel, "bfloat16", p)["ms"]
            for p in sorted({row["path"] for row in sel})}
        for r in SSD_TC_ROUTES
        for sel in [[row for row in report["ssd"] if row["route"] == r
                     and row["dtype"] == "bfloat16"]]}
    k6["phase_ms_per_call_warm_l2"] = {
        row["path"]: row["phase_ms_warm_l2"] for row in report["ssd"]
        if row["dtype"] == "bfloat16"}
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

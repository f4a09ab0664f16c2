#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (tpu_kquant_torch) on one NVIDIA card.

    python3 chip_smoke.py            # from the repository root; one GPU

Phases, each fatal on failure:
 1. the card's name and power limit (nvidia-smi), torch / CUDA / nvcc versions;
 2. build the CUDA kernels from tpu_kquant_torch/csrc (nvcc, in parallel);
 3. hold each kernel against its plain PyTorch version on the card at the
    main path's TinyLlama-1.1B shapes, at Qwen2.5-1.5B's (qmm's tied lm
    head and o_proj at R = 1 and its R = 512 tiles on f32 activations; ffn
    also at Qwen2.5-7B's and on f32 scales; attn_in with biases at head_dim
    128; the prefill kernel with f32 q at 12 / 2 heads of 128) and at
    Mixtral-8x7B's (qmm at every projection its layer gives it, on bf16
    pairs and on f32 scales, at R = 1, 16 and 512 as the path runs them;
    attn_in on either layout at D 4096, R = 1 and 16; qmm_int8 at the
    expert gate/up, R = 1, 8 and 16, and the router, R = 1, after its
    activation quantization is checked byte for byte); oproj_ffn also on
    f32 scales; the flash decode kernel at the serving cell (1024 slots of
    2048, bf16 and int8 KV, the cell's positions and positions over the
    whole context) and at head_dim 128; and at phase 9's kinds: qmm on
    q8, q5, unwidened q6, q3 and q2 (bf16 pairs and f32 scales, R = 1 and
    512) at TinyLlama's gate/up, wqk, down and lm head, qmm_int8's q6
    branch at the down and lm head (R = 1, 8, 16) after its 16-group
    activation quantization is checked byte for byte, attn_in with q8, q6w
    and q4 in both slots (R = 1, 16), oproj_ffn and ffn with q8 in every
    slot (R = 1, 8); and qmm's wgmma tile at the 1024-slot serving tick (R
    = 1024) and pp2048 (R = 2048) on TinyLlama's wqk, wv, wo, gate/up and
    down and Mixtral's expert gate/up and down (TILE_CASES); qmm at
    Mamba-2.8B's ssm_in, ssm_x, ssm_dt (q8 on f32 scales at K = 160), ssm_out
    and tied lm head (N = 50280), R = 1, 16 and 512 (MAMBA_QMM); the gate/up
    phase of the fused FFN kernels alone at every kind their gates take
    (TinyLlama's w_gateup, R = 1 and 8, listed with ffn's cases and timed
    beside each oproj_ffn and ffn case); the attention phase of attn_out
    and layer alone at each of their phase-3 shapes (listed with their
    cases, SDPA with GQA as the library call); the gemma family's branches
    (check_gemma): attn_in at head_dim 256 (Gemma-2B's R = 1 and 16,
    Gemma-2-9B's R = 1), oproj_ffn, ffn and the gate/up phase with GELU at
    Gemma-2B's widths, layer with GELU at TinyLlama's shapes, rot with GELU
    and the next layer's head_dim-256 QKV at Gemma-2B's, and the flash
    decode (8 / 1 heads of 256, B = 16 over 8192 slots, bf16 and int8) and
    prefill (T = S = 4096, bf16 and int8; a ragged q offset with a window)
    at head_dim 256; the sliding-window family's (check_phi3): attn_in on
    Phi-3-mini's one wqkv [9216, 3072] as two slots of its bytes at
    head_dim 96 (R = 1, 16, 32), oproj_ffn at D 3072, F 8192 (R = 1, 8),
    rot with the next layer's wqkv slots (R = 1), qmm's lm head at N =
    32064 (R = 1, 32, 512); then the batch-invariance check
    (fatal): rows of the GEMV paths at R = 16 and 32 against each row
    alone, the tile's 64-row blocks of a 16 x 64 burst against the 64-row
    calls, the flash decode's rows at B = 16 and 1024, attn_in's at
    TinyLlama, Qwen2.5, Mixtral on f32 scales and Q8_0 (its kernel's K split
    held to the host's attn_in_plan) and the plain decode attention's at 16
    and 32 rows of 128 slots (bf16 and int8 KV, the deferred append on and
    off), attn_in at Gemma-2B's head_dim 256 and on Phi-3-mini's wqkv
    slots at head_dim 96, the flash decode's rows at
    head_dim 256 (B = 16 and 64), attn_out's at B = 16 (bf16 and int8 KV)
    and layer's at B = 4,
    ragged positions, against each row alone, bit for bit (tolerance 2e-2
    of max|ref|; qmm_int8 1e-3; the attention kernels 2e-2 of each output
    row's own max|ref|), and time the kernel and the plain version; as yardsticks the
    port never calls, qmm's ``library_ms`` is torch.matmul on the
    pre-dequantized weight in the activations' dtype, the attention
    kernels' scaled_dot_product_attention on bf16 (int8 on the dequantized
    cache), and the fused kernels, which no single PyTorch call computes
    (``library_ms`` null), get ``matmul_ms``: their matmuls on
    pre-dequantized bf16 weights;
 4. end to end at TinyLlama-1.1B width (random Q4_K_M fixture from a seed):
    load onto the card, check a 2-layer cut against the plain versions on
    the CPU, answer three greedy requests of different prompt lengths with
    the launch counters set to 0 just before and read just after, then time
    pp512 and tg128; tg128 on one cache whose decode step (runtime.graphs)
    is captured in the warm run, timed two runs a side replaying it and in
    the plain loop (plain, graph, graph, plain), every run's tokens and
    last logits equal bit for bit, and decode_sampled (temperature, top-k,
    top-p, repeat penalty) as a graph against the plain loop, tokens, last
    logits, keys and penalty state equal bit for bit; then tg128 under
    TKQ_INT8_FOLDS=1 (the fixture's q6w wo sends every decode step to #5,
    which folds the q4 gate/up), plain against graph, counted and equal bit
    for bit (tg128_ab);
 5. long prompts, on a bf16 and then an int8 KV cache of 2240 slots (2048 +
    128 + 64, bench.py's sizing): a 2-layer cut prefilling a 1100-token
    prompt (bucket 2048: the flash prefill kernel) on the card against the
    CPU, three greedy requests of 1000, 1500 and 2048 tokens with the counts
    set to 0 just before and read just after, then pp2048 and tg128 at depth
    2048;
 6. serving (tpu_kquant_torch.serving.ContinuousBatcher) at TinyLlama's full
    width and depth, with tools_serve_bench.py's requests (prompts of 32-63
    tokens, 48 new, temperature 0.8, top_k 40, top_p 0.95, repeat penalty
    1.1 over 64, seed 1000 + i): a 2-layer cut of the serving path on the
    card against the CPU with the attention budget lowered so that 8 slots
    pass it (bf16 and int8 KV); 16 slots of 128 serving 64 requests, 12
    greedy (4 with an eos), each greedy stream equal, token for token, to
    the same prompt served alone by engine.generate (the number that differ
    is printed, and any is fatal); 1024 slots of 2048
    serving 1024 requests admitted as one
    burst, on bf16 and then int8 KV: the flash prefill in every layer of the
    burst and the flash decode kernel in every layer of every tick. Each run
    is counted from 0 and checked against the gates (the ticks the device
    ran); tokens/s (wall), ticks and wall per tick are printed. At 16 slots
    the same 64 requests are served again per tick (max_chunk 1) and by the
    graph and the plain batcher two runs a side (plain, graph, graph,
    plain; tok/s and ms a tick), every stream equal to the chunked run's.
    Then phase 4's fixture loaded with f32
    scales under impl "int8": attn_in and oproj_ffn on f32 scales, three
    greedy requests, counted;
 7. Qwen2.5-1.5B at full width and depth (28 layers; q/k/v biases, tied lm
    head; attention width 1536 fails oproj_ffn's gate, so decode runs
    attn_in with biases, an o_proj qmm and the ffn kernel): write the
    fixture, load it, check a 2-layer cut against the CPU at prompts of 8,
    40 and 1100 tokens, answer greedy requests of 5, 40, 200 and 3000 tokens
    on a 4288-slot bf16 cache (the last is bucket 4096: the flash prefill
    with f32 q) with the counts set to 0 just before and read just after,
    then time pp512 and tg128;
 8. Mixtral-8x7B at full width (dim 4096, 32 / 8 heads of 128, ffn 14336,
    8 experts, top 2, vocab 32000, rope theta 1e6) cut to MIXTRAL_DEPTH of
    its 32 layers (the host writes and repacks 0.93 GB of GGUF per layer;
    the cut is logged as `reduced`): one fixture file, loaded twice, one
    load at a time: with bf16 pairs under impl "auto" (attn_in, qmm for
    o_proj, the router and every expert), then with f32 scales under impl
    "int8" (attn_in on f32 scales, qmm_int8 for the router and the experts'
    gate/up at decode rows, qmm for o_proj, the downs and the lm head). Per
    configuration: a 1-layer cut on the card against the CPU at prompts of
    8 and 40 tokens with 2 greedy steps, the selected experts of every
    token and layer compared (reference_check); greedy requests of 5, 40
    and 200 tokens, counted; pp512 and tg128 beside their bounds, every
    expert's bytes counted (the loop reads all 8 per token).
 9. GGML types: TinyLlama-1.1B at full width under every recipe of the
    reference's quantize tool (models/fixtures.py:target_type), one load
    at a time: Q8_0, Q5_K_M, Q6_K, Q4_K_S, Q3_K_M, Q2_K and Q4_K_M with
    widen_q6=False (bf16 pairs under impl "auto", then f32 scales under
    impl "int8": qmm_int8's q6 branch) cut to GGML_DEPTH layers (the cut is
    logged as `reduced`), each with a 2-layer cut against the CPU and
    greedy requests of 5, 40 and 200 tokens counted from 0, untimed. Each
    recipe's decode dispatch is pinned from the recipe table
    (GGML_CONFIGS).
10. the reference's opt-in decode fusions (FUSED_PATHS; its switches, read
    at call time by models/llama.py) at TinyLlama-1.1B's full width and
    depth: (a) TKQ_ROTATE_LAYER=1 on phase 4's bf16 load right after phase
    6's serving; (b) TKQ_FUSE_LAYER=1 TKQ_KV_APPEND_PALLAS=1 (also at batch
    4) and (c) TKQ_FUSE_ATTN_OUT=1 TKQ_DEFER_APPEND=0 TKQ_KV_APPEND_PALLAS=1
    (bf16, then int8 KV) on phase 6's f32-scale load. Each path's decode
    dispatch pinned, a 2-layer cut against the CPU, three greedy requests
    counted from 0, and (but (b) at batch 4) tg128 with the switches on and
    off in turns;
11. the qmm kernel lab (utils/kernel_lab.py; kernels #14-#16 of
    csrc/kernel_lab.cu) at R = 1 on TinyLlama's wqk [2304, 2048] and
    gate/up [11264, 2048] q4-sm and down [2048, 5632] q6w-sp and Llama-3-8B's
    gate/up [28672, 4096] q4-sm: every rung of the mutation ladder at the
    CLI's default tiles of both geometries (k chunks 256, 512, 1024; n tiles
    256, 512), and the manual ring kernel's dma and full on the q4 tensors;
    then full alone on q6w-f32, q8-sp and q4-f32 at TinyLlama's gate/up.
    Each case is held against its plain version (dma and extract equal, the
    rest within LAB_TOL, f32 summation order) and against the one PyTorch
    call that computes the same function (dma and the flat kinds' extract:
    the signed byte sum, equal; convert, bf16c, full, gdot and manual full:
    torch.matmul on the rung's bf16 weight, within TOL; q4's extract has
    none) and timed (graph replay, eager, plain, library, bound, GB/s);
    then run_ladder, the lab's entry point, over every tensor with the
    counts set to 0 just before and read just after (time_chained's
    marginal times, beside the graph times in the ladder's table); then tools/kernel_lab.py and
    tools/kernel_bench.py once in-process (the latter's lm head beside phase
    3's graph time for the same GEMV).
12. the prefill-attention lab (utils/prefill_lab.py; kernels #17-#19 of
    csrc/prefill_lab.cu, variants A, B and G of the reference's lab
    scripts) at TinyLlama-1.1B's pp512 layer (T 512 after a 704-slot cache,
    32 / 4 heads of 64: the reference lab's own shape), its pp2048 layer (T
    = S = 2048) and Qwen2.5-1.5B's heads at pp512 (12 / 2 of 128): every
    sweep point (A at tq 128, 256, 512; B at tq 128, 256 x ts 128, 256, 384;
    G at tq 128, 256 x ts 128, 256) held to its plain version (2e-2 of each
    output row's max|ref|) and timed (graph replay, eager; plain, SDPA with
    GQA on the same bf16 inputs, the bound of the causal pairs), beside the
    flash prefill kernel #8 on the same inputs; SDPA held to variant A, and
    once its top-left causal mask to the explicit one; then run_sweep, the
    lab's entry point, at every shape with the counts set to 0 just before
    and read just after (time_chained's marginal times), and
    tools/prefill_lab.py once in-process.
13. the gemma family: Gemma-2B (google/gemma-2b: 18 layers, dim 2048, 8 / 1
    heads of 256, ffn 16384, vocab 256000, GELU, tied lm head) at full
    width, GEMMA_DEPTH = 6 of its 18 layers: the decode dispatch pinned (attn_in at head_dim 256
    and oproj_ffn with GELU in every layer, the lm head a qmm), a 2-layer
    cut against the CPU, greedy requests of 5, 40, 200 and 3000 tokens (the
    last is bucket 4096: the flash prefill at head_dim 256 in every layer)
    counted from 0, pp512 and tg128; the 2-layer cut again under
    TKQ_ROTATE_LAYER=1 (the rot kernel with GELU and head_dim 256), which
    must launch rot; then Gemma-2-9B (google/gemma-2-9b: post norms,
    softcaps 50 / 30, a window of 4096 on every other layer, 16 / 8 heads
    of 256) cut to GEMMA2_DEPTH of its 42 layers (logged as `reduced`): a
    2-layer check against the CPU.
14. the front door (front_door): TinyLlama-1.1B at full depth on the
    seed-0 fixture with its vocab (tokenizer/), each main-path run
    (the CLIs, context shift, sessions, speculative decoding, perplexity,
    the bench CLI) counted from 0: the
    generate CLI (tools/main.py) greedy and sampled, -n 64, its ids equal
    generate's; context shift (256 slots, a 200-token prompt, 200 new
    tokens, n_keep 4) on bf16 and int8 KV, and shift_cache and the logits
    after a shift on a 2-layer cut against the CPU; sessions saved after
    prefill and 16 tokens, 32 more from a fresh engine equal to the
    uninterrupted run (bf16, int8; fatal); the rows of 5-token verify
    windows (engine.step) at B = 1 and 2 equal the decode steps at their
    positions bit for bit (fatal; a window's launches pinned); one window
    1900 deep in 2048 slots timed against the decode steps and its
    attention against one [T, S] call (window_cost); greedy
    speculative decoding (n_draft 4, 32 tokens): generate_speculative with
    the target as its own draft (every draft accepted) and with a 2-layer
    draft of another seed on two rows, DeviceSpeculator's prompt lookup
    on a repetitive prompt and DeviceSpeculator with the 2-layer draft,
    each equal to plain greedy on bf16 KV (fatal) and timed beside it;
    self-draft and prompt lookup on int8 KV (the differing tokens
    printed); tools/perplexity.py's perplexity over 1024 ids at ctx 512
    (finite; the 2-layer cut within 1e-3 relative of the CPU's); the bench
    CLI's table (-p 512 -n 128 -r 2).
15. the sliding-window family (sliding_window), run after phase 13:
    Phi-3-mini-4k (microsoft/Phi-3-mini-4k-instruct: 32 layers, dim 3072,
    32 / 32 heads of 96, ffn 8192, vocab 32064, window 2047 on every layer,
    q/k/v in one wqkv) at full width, PHI3_DEPTH = 8 of its 32 layers: the
    decode dispatch pinned
    (attn_in on wqkv's two slots and oproj_ffn in every layer, the lm head a
    qmm, on either layout); 2-layer cuts against the CPU on the unified
    layout (prompts of 8 and 40 tokens) and on the iSWA ring (8; and
    PHI3_RING_LONG = 2600 on int8 KV, past the window, wrapping the ring), and
    under TKQ_ROTATE_LAYER=1 (rot with the next layer's wqkv, which must
    launch); on each layout greedy requests of 5, 40, 200
    and 3000 tokens (past the window and the ring) counted from 0, pp512
    and tg128 on 4096 slots (PHI3_TIMED_REPS runs after a warm one; then
    phase 4's graph-against-plain A/B of tg128, tokens and last logits
    equal bit for bit); the
    3000-token prompt's last logits on the ring against the unified
    layout's (5e-2 of max|ref|); tools/main.py --kv-layout iswa -n 32, its
    ids equal generate's; then phase 13's Gemma-2-9B cut (a window layer
    and a full one) on the iSWA layout against the CPU, bf16 KV
    (GEMMA2_RING_KV; int8 too before phase 16, now Phi-3's), on a
    5000-token prompt (past its window of 4096; ring 4608).
16. the recurrent family (recurrent), run after phase 14: Mamba-2.8B
    (state-spaces/mamba-2.8b-hf: 64 layers, d_model 2560, d_inner 5120,
    d_state 16, d_conv 4, dt_rank 160, vocab 50280, tied lm head) at full
    width and depth, written with weights of std MAMBA_SCALE: the dispatch
    pinned (every matmul on qmm's kernel, 4 x 64 + 1 = 257 launches a
    decode step and a prefill, no plain version; the prefill's five shapes
    on the tile, ssm_x and ssm_dt included); mamba_layer_scan's rows at B =
    16 (T = 1 and 64) equal to each row alone, bit for bit; its peak device
    memory on a 16-row burst of 2048 tokens under one [16, 2048, d_inner,
    d_state] f32 tensor (MAMBA_BURST; the scan goes in chunks); a 2-layer cut
    against the CPU (a right-padded prefill of 5 and 200 tokens and 16
    decode steps: logits, the first greedy token in the CPU's top 5, the
    final conv and ssm states); the last logits' dependence on earlier
    tokens; greedy requests of 5-512 tokens counted from 0, pp512 and
    tg128 (one timed run each; then phase 4's graph-against-plain A/B of
    tg128, tokens and last logits equal bit for bit); a session saved after a prompt and
    continued equal to the uninterrupted run; the generate CLI, its ids
    equal generate's; serving 64 requests on 16 slots, 10 at once and then
    one a tick (MAMBA_WAVES), so bursts and single admissions both refill
    slots that finished requests held, each of the 4 greedy streams
    (MAMBA_GREEDY: a single and a burst admission, each into a fresh and a
    reused slot) equal to its solo run, and every stream of the same waves
    served per tick (max_chunk 1) equal to the chunked run's.
17. the quantizer and the converter (quantizer), run after phase 16: (a)
    csrc/quantize.cu's Q4_K, Q6_K and Q8_0 kernels against their plain
    versions on the card, bit for bit, on whole tensors of TinyLlama's
    shapes at the types q4_k_m gives them (QUANT_CASES; ffn_gate also Q8_0)
    and on tests/test_native.py's six edge cases, their first 64 rows
    against the port's NumPy copy, each timed (graph and eager) beside its
    bound (FP64 / FP32 operations or bytes); (b) TinyLlama-1.1B's F16
    fixture (seed 0, written by a process started after phase 2's build,
    start_f16_fixture) requantized to q4_k_m on the card by
    tools/quantize.py: the wall time and its parts, the output's types
    against the recipe, layer 0's tensors and the lm head (64 rows each)
    against the NumPy copy, the quantize launches one a converted tensor,
    then the result loaded (bf16 scales) and a 32-token prompt run: its
    first greedy token in the F16 model's top 5, the logits' correlation;
    (c) tools/ppl_delta.py at TinyLlama's full width cut to PPL_DEPTH = 4
    layers (copied from (b)'s file), --types q8_0,q6_k,q4_k_m --ctx 256
    --max-windows 2 on a text of the fixture vocab's words: KL ordered
    q4_k_m > q6_k > q8_0 and q8_0's |dppl| under 1/512 of ppl (the
    reference test's |dppl| < 1 at its ppl of 512), the windows on qmm's
    tile;
18. Llama-3-8B at full width and depth (32 layers, dim 4096, 32 / 8 heads
    of 128, ffn 14336, vocab 128256, rope base 5e5; its Q4_K_M fixture
    written by a process started after phase 2's build,
    start_llama3_fixture):
    load, pin_dispatch (attn_in and oproj_ffn a layer and the GEMV lm head
    a decode step, the flash prefill in every layer at 2048 rows), a
    2-layer cut against the CPU, end_to_end (three requests, pp512, tg128)
    and tg128 plain against graph bit for bit (tg128_ab), 32 requests on 16
    slots of 128 (every eighth greedy, each equal to its run alone); then
    tg128 and
    the serving run again under TKQ_Q4_MXU_MINS=0 and under
    TKQ_INT8_FOLDS=1 (L3_FOLD_ENVS): the fold dispatch pinned at a decode
    step and a 16-row tick, the folded launches counted apart
    ("attn_in.folded", "oproj_ffn.folded") and required, each greedy stream
    equal to the request repeated in all 16 rows of one generate (the
    TPU's choice, and with it the function, changes at 8 rows). Phase 3
    holds the folded kernels to their plain folded forms (check_folds: each
    within TOL and its mean error below a quarter of its fold gap) and
    their rows to the rows alone (check_batch_invariance).
Phase 8 runs Mixtral at MIXTRAL_DEPTH = 1 layer and phase 9 every recipe,
Q8_0 and Q5_K_M among them, untimed at GGML_DEPTH = 2 layers (2 and 4
layers, Q5_K_M timed at 22 before phase 13, Q8_0 before phase 15),
phase 10 one turn of tg128 on and off a path (FUSED_TURNS; 2 before phase
15), and phases 5, 7 and 13 time pp2048 / tg128@2048, Qwen2.5's and
Gemma-2B's pp512 / tg128 once each after a warm run (LONG_TIMED_REPS,
QWEN_TIMED_REPS, GEMMA_TIMED_REPS; medians of 3 before phase 15): the
smoke's 1200 s limit. The CPU side of every cut
dequantizes each weight once (cpu_dequant_memo).
The decode loops and the serving tick run as CUDA graphs (runtime.graphs):
a kernel wrapper counts at the warm run, the capture's calls are taken back
and every replay adds them, so the counts are launches; main_run holds a
run to the forwards it ran eagerly and, for each replay, those its step
captured (record_captures), and logs its graph launches and the counted
kernel launches inside and outside them. A capture that fails (a host read
in the step raises under set_sync_debug_mode("error")) ends the smoke.
Launch counts in the kernels' JSON line are the sums over the request runs
of phases 4 to 10, 13 to 16 and 18 (folded launches among attn_in's,
oproj_ffn's and ffn's), each counted from 0 and checked against the dispatch
gates exactly (the quantizers': phase 17's requantize and ppl_delta runs,
each counted from 0, one launch a converted tensor; the labs' kernels: their wrapper calls in phase 11's
run_ladder and phase 12's run_sweep, CUDA-graph captures included, replays
not); the gates in turn
are held to each model's decode and long
prefill dispatch (and Mixtral's and phase 9's 64-row prefill), stated from
its config (pin_dispatch). The second-to-last line is the kernels' JSON; the last line
is {"ok": true, "device": {...}}.
Without a CUDA card it exits non-zero.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak
INT8_OPS = 1979e12  # H100 SXM dense int8 tensor-core peak
TOL = 2e-2
INT8_TOL = 1e-3  # qmm_int8 against its plain version: integer partials are exact
L2_BYTES = 50e6


T0 = time.perf_counter()


def log(*a) -> None:
    print(*a, flush=True)


def phase(title: str) -> None:
    log(f"== {title} (at {time.perf_counter() - T0:.1f} s)")


def gpu_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True, check=True)
    return r.stdout.strip().splitlines()[0]


def bound_ms(n_bytes: float, n_ops: float, peak: float = BF16_FLOPS) -> tuple[float, str]:
    tb, to = n_bytes / HBM_BYTES_PER_S, n_ops / peak
    return (max(tb, to) * 1e3, "bytes" if tb >= to else "operations")


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean ms per call of fn(i) as the host drives it (eager): CUDA events
    around `iters` calls, so host time between launches counts."""
    import torch

    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int, reps: int = 5) -> float:
    """Mean device ms per call of fn(i): `iters` calls captured in one CUDA
    graph and replayed `reps` times, so no host time enters."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(2):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for i in range(iters):
            fn(i)
    g.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        g.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / (reps * iters)
    del g
    return ms


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def _rand_weights(rng, kind: str, N: int, K: int, dev):
    """A random packed weight in the loader's layout of `kind` on the card
    (models.fixtures.random_packed): "q4", "q6w", "q8", "q5", "q6", "q3",
    "q2" with bf16 pairs (scale_dtype="bf16"), and with a trailing "f" their
    f32 scales (and mins)."""
    from tpu_kquant_torch.models.fixtures import random_packed

    f32 = kind.endswith("f")
    return random_packed(rng, kind[:-1] if f32 else kind, N, K, f32=f32).to(dev)


def _rotation(w0, one_bytes: int) -> list:
    """w0 (a packed weight, or a tuple or list of them) and enough device
    copies of it to exceed L2 twice, so every timed launch reads its weights
    from device memory, as the model's layer loop does. Copies, not fresh
    draws: L2 holds addresses, and packing fresh weights on the host is
    slow."""
    def copy(w):
        return type(w)(copy(x) for x in w) if isinstance(w, (tuple, list)) else w.clone()

    n = min(32, max(1, math.ceil(2 * L2_BYTES / one_bytes)))
    return [w0] + [copy(w0) for _ in range(n - 1)]


def _err(got, ref) -> tuple[float, float]:
    d = (got.float() - ref.float()).abs().max().item()
    return d, d / max(ref.float().abs().max().item(), 1e-30)


def row_rel_err(got, ref) -> float:
    """Max over the rows of the last axis of max|got - ref| / max|ref| in
    that row. Causal attention's output shrinks along the prompt (a row
    that attends n slots has |out| ~ n^-1/2, and row 0 is v[0]), so one
    max|ref| over the whole output is set by the first rows and would let a
    fault in the late tiles pass; each row here is held to its own scale."""
    d = (got.float() - ref.float()).abs().amax(-1)
    return (d / ref.float().abs().amax(-1).clamp_min(1e-30)).max().item()


MX_DIM, MX_FFN, MX_VOCAB = 4096, 14336, 32000  # Mixtral-8x7B's dim, expert ffn, vocab
# Mamba-2.8B's packed matmuls at Q4_K_M (label, kind, N, K, out dtype): ssm_dt's
# K = dt_rank 160 takes Q8_0, whose 5 scale groups stay f32 under bf16 pairs
# (odd), the GEMV at 5 chunks and the tile's half step at K % 64 = 32
MB_DIM, MB_INNER, MB_DT_RANK, MB_VOCAB = 2560, 5120, 160, 50280
MAMBA_QMM = (("ssm_in q4-sm", "q4", 2 * MB_INNER, MB_DIM, "bf"),
             ("ssm_x q4-sm", "q4", MB_DT_RANK + 32, MB_INNER, "bf"),
             ("ssm_dt q8-f32", "q8f", MB_INNER, MB_DT_RANK, "bf"),
             ("ssm_out q4-sm", "q4", MB_DIM, MB_INNER, "bf"),
             ("tied lm head q4-sm", "q4", MB_VOCAB, MB_DIM, "f32"))


# phase 9's kinds at TinyLlama's shapes (gate/up [11264, 2048], wqk [2304,
# 2048], down [2048, 5632], lm head [32000, 2048]): every kind the recipes
# give qmm, at R = 1 (decode) and 512 (the tiles), and each on f32 scales
GGML_QMM_CASES = tuple(
    (f"{what} {kind.rstrip('f')}{lay or '-f32'} R={R}", kind, N, K, R,
     "f32" if what == "lm head" else "bf")
    for what, kind, lay, N, K, Rs in (
        ("gate/up", "q8", "-sp", 11264, 2048, (1, 512)),
        ("lm head", "q8", "-sp", 32000, 2048, (1, 512)),
        ("gate/up", "q5", "-sm", 11264, 2048, (1, 512)),
        ("wqk", "q5", "-sm", 2304, 2048, (1, 512)),
        ("gate/up", "q3", "-sm", 11264, 2048, (1, 512)),
        ("gate/up", "q2", "-sm", 11264, 2048, (1, 512)),
        ("down", "q6", "-sm", 2048, 5632, (1, 512)),
        ("down", "q6f", "", 2048, 5632, (1, 512)),
        ("gate/up", "q8f", "", 11264, 2048, (1,)),
        ("gate/up", "q5f", "", 11264, 2048, (1,)),
        ("gate/up", "q3f", "", 11264, 2048, (1,)),
        ("gate/up", "q2f", "", 11264, 2048, (1,)))
    for R in Rs)


# qmm: TinyLlama's decode lm head and wqk at R = 1, prefill gate/up and
# down at R = 512; Qwen2.5-1.5B's tied lm head (q4-sm) and o_proj at R =
# 1, and its prefill gate/up and down at R = 512 on f32 activations (bf16
# + f32 bias past 32 rows), which the tile stages as bf16. The plain
# version keeps f32 activations f32 (ops/qmm.py says why). Mixtral-8x7B:
# every projection its layer gives qmm, on bf16 pairs (impl auto) and on
# f32 scales (impl int8: wo, the downs and the lm head at decode rows),
# at R = 1 (decode), 16 (the bucket-16 prefill) and 512 (the tiles).
QMM_CASES = (
    ("lm head q6w-sp R=1", "q6w", 32000, 2048, 1, "bf", "f32"),
    ("wqk q4-sm R=1", "q4", 2304, 2048, 1, "bf", "bf"),
    ("w_gateup q4-sm R=512", "q4", 11264, 2048, 512, "bf", "bf"),
    ("w_down q6w-sp R=512", "q6w", 2048, 5632, 512, "bf", "bf"),
    ("qwen2.5-1.5b: tied lm head q4-sm R=1", "q4", 151936, 1536, 1, "bf", "f32"),
    ("qwen2.5-1.5b: wo q6w-sp R=1", "q6w", 1536, 1536, 1, "bf", "bf"),
    ("qwen2.5-1.5b: w_gateup q4-sm R=512, f32 x", "q4", 2 * 8960, 1536, 512, "f32", "f32"),
    ("qwen2.5-1.5b: w_down q6w-sp R=512, f32 x", "q6w", 1536, 8960, 512, "f32", "f32"),
    ("mixtral: expert down q6w-f32 R=1", "q6wf", MX_DIM, MX_FFN, 1, "bf", "f32"),
    ("mixtral: expert down q6w-f32 R=512", "q6wf", MX_DIM, MX_FFN, 512, "bf", "f32"),
    ("mixtral: expert gate q4-f32 R=512", "q4f", MX_FFN, MX_DIM, 512, "bf", "bf"),
    ("mixtral: router q4-f32 N=8 R=512", "q4f", 8, MX_DIM, 512, "bf", "f32"),
    ("mixtral: router q4-sm N=8 R=1", "q4", 8, MX_DIM, 1, "bf", "f32"),
    ("mixtral: router q4-sm N=8 R=16", "q4", 8, MX_DIM, 16, "bf", "f32"),
    ("mixtral: expert gate/up q4-sm R=1", "q4", MX_FFN, MX_DIM, 1, "bf", "bf"),
    ("mixtral: expert gate/up q4-sm R=16", "q4", MX_FFN, MX_DIM, 16, "bf", "bf"),
    ("mixtral: expert gate/up q4-sm R=512", "q4", MX_FFN, MX_DIM, 512, "bf", "bf"),
    ("mixtral: expert down q6w-sp R=1", "q6w", MX_DIM, MX_FFN, 1, "bf", "f32"),
    ("mixtral: expert down q6w-sp R=16", "q6w", MX_DIM, MX_FFN, 16, "bf", "f32"),
    ("mixtral: expert down q6w-sp R=512", "q6w", MX_DIM, MX_FFN, 512, "bf", "f32"),
    ("mixtral: expert down q6w-f32 R=16", "q6wf", MX_DIM, MX_FFN, 16, "bf", "f32"),
    # the GEMV at 16 slots (the serving cell's decode ticks) and at 32 rows,
    # the most it takes
    ("lm head q6w-sp R=16 (serving, 16 slots)", "q6w", 32000, 2048, 16, "bf", "f32"),
    ("lm head q6w-sp R=32", "q6w", 32000, 2048, 32, "bf", "f32"),
    ("mixtral: expert gate/up q4-sm R=32", "q4", MX_FFN, MX_DIM, 32, "bf", "bf"),
    ("mixtral: expert down q6w-sp R=32", "q6w", MX_DIM, MX_FFN, 32, "bf", "f32"),
    ("mixtral: wo q6w-sp R=1", "q6w", MX_DIM, MX_DIM, 1, "bf", "bf"),
    ("mixtral: wo q6w-f32 R=1", "q6wf", MX_DIM, MX_DIM, 1, "bf", "bf"),
    ("mixtral: wo q6w-f32 R=16", "q6wf", MX_DIM, MX_DIM, 16, "bf", "bf"),
    ("mixtral: lm head q6w-sp R=1", "q6w", MX_VOCAB, MX_DIM, 1, "bf", "f32"),
    ("mixtral: lm head q6w-f32 R=1", "q6wf", MX_VOCAB, MX_DIM, 1, "bf", "f32"),
    ("mixtral: wqk q4-sm R=512", "q4", 5120, MX_DIM, 512, "bf", "bf"),
    ("mixtral: wv q6w-f32 R=512", "q6wf", 1024, MX_DIM, 512, "bf", "bf"),
    *((label, kind, N, K, R, "bf", o) for label, kind, N, K, R, o in GGML_QMM_CASES),
    *((f"mamba-2.8b: {label} R={R}", kind, N, K, R, "bf", o)
      for label, kind, N, K, o in MAMBA_QMM for R in (1, 16, 512)))

# the tile at the 1024-slot serving tick (R = 1024) and pp2048 (R = 2048):
# TinyLlama's wqk, wv, wo, gate/up and down, Mixtral's expert gate/up and
# down, on bf16 pairs
TILE_CASES = tuple(
    (f"{what} R={R}", kind, N, K, R, "bf", o)
    for R in (1024, 2048)
    for what, kind, N, K, o in (
        ("tile: wqk q4-sm", "q4", 2304, 2048, "bf"), ("tile: wv q6w-sp", "q6w", 256, 2048, "bf"),
        ("tile: wo q6w-sp", "q6w", 2048, 2048, "bf"),
        ("tile: w_gateup q4-sm", "q4", 11264, 2048, "bf"),
        ("tile: w_down q6w-sp", "q6w", 2048, 5632, "bf"),
        ("tile: mixtral expert gate/up q4-sm", "q4", 14336, 4096, "bf"),
        ("tile: mixtral expert down q6w-sp", "q6w", 4096, 14336, "f32")))


def qmm_cases() -> tuple:
    """Phase 3's qmm cases: (label, kind, N, K, R, x dtype, out dtype), the
    dtypes "bf" or "f32"."""
    return QMM_CASES + TILE_CASES


def _act(R, K, scale=1.0, dev="cuda"):
    import torch

    return (torch.randn(R, K, device=dev) * scale).to(torch.bfloat16)


def check_qmm(dev, rng, cases) -> list:
    """qmm against qmm_plain at each (label, kind, N, K, R, x dtype, out
    dtype) case, x f32 or bf16, out f32 or bf16; timed as the module
    docstring says, beside torch.matmul on the dequantized weight."""
    import torch

    from tpu_kquant_torch.ops.qmm import qmm, qmm_plain
    from tpu_kquant_torch.quant.codecs import dequant_kmajor

    bf, f32 = torch.bfloat16, torch.float32
    out = []
    for label, kind, N, K, R, xdt, odt in cases:
        xdt, odt = (f32 if xdt == "f32" else bf), (f32 if odt == "f32" else bf)
        w0 = _rand_weights(rng, kind, N, K, dev)
        ws = _rotation(w0, w0.n_bytes)
        x = _act(R, K, dev=dev) if xdt == bf else torch.randn(R, K, device=dev)  # f32: not bf16
        got = qmm(x, w0, odt)
        torch.cuda.synchronize()
        ref = qmm_plain(x, w0, odt)
        ad, rel = _err(got, ref)
        # the library yardstick multiplies in x's dtype (f32 x: f32, no TF32)
        wd = [dequant_kmajor(w, xdt).contiguous() for w in ws]
        nb = w0.n_bytes + x.numel() * x.element_size() + R * N * got.element_size()
        b, by = bound_ms(nb, 2.0 * R * K * N)
        out.append({
            "case": label, "max_abs_err": ad, "rel_err": rel,
            "ms": graph_ms(lambda i: qmm(x, ws[i % len(ws)], odt), 40),
            "eager_ms": time_ms(lambda i: qmm(x, ws[i % len(ws)], odt), 40),
            "plain_ms": graph_ms(lambda i: qmm_plain(x, w0, odt), 4, reps=3),
            "library_ms": graph_ms(lambda i: torch.matmul(x, wd[i % len(wd)]), 40),
            "bound_ms": b, "bound_by": by})
        del wd, ws
    return out


def check_kernels(dev) -> dict:
    """Kernel vs plain version at the main path's shapes, with the timings
    of the module docstring, and the batch-invariance check. Returns
    {kernel: [case dicts]}; raises on any disagreement."""
    import numpy as np
    import torch

    rng = np.random.default_rng(0)
    torch.manual_seed(0)
    out: dict = {"qmm": check_qmm(dev, rng, qmm_cases())}
    out.update(check_fused_ffn(dev, rng))
    out["prefill"] = check_prefill(dev)
    out["qmm_int8"] = check_qmm_int8(dev, rng)
    out["decode_attn"] = check_decode_attn(dev)
    out.update(check_fused_decode(dev, rng))
    for name, cases in check_gemma(dev, rng).items():
        out[name] += cases
    for name, cases in check_phi3(dev, rng).items():
        out[name] += cases
    t0 = time.perf_counter()
    for name, cases in check_folds(dev, rng).items():
        out[name] += cases
    log(f"  check_folds took {time.perf_counter() - t0:.1f} s")
    report_cases(out)
    t0 = time.perf_counter()
    check_batch_invariance(dev, rng)
    log(f"  check_batch_invariance took {time.perf_counter() - t0:.1f} s")
    return out


def check_fused_ffn(dev, rng) -> dict:
    """attn_in, oproj_ffn and ffn against their plain versions at the main
    path's shapes (see check_kernels)."""
    import torch

    from tpu_kquant_torch.ops import ffn as ffn_mod
    from tpu_kquant_torch.ops.attn_in import attn_in_plain, fused_attn_in
    from tpu_kquant_torch.ops.ffn import ffn_plain, fused_ffn, fused_oproj_ffn, oproj_ffn_plain
    from tpu_kquant_torch.quant.codecs import dequant_kmajor

    # the gate/up phase alone, timed beside the whole kernels (absent from a
    # parent's checkout timed by tools/tile_ab.py)
    gate_up = getattr(ffn_mod, "gate_up", None)
    out: dict = {"attn_in": [], "oproj_ffn": []}
    dim, H, Hkv, hd, F = 2048, 32, 4, 64, 5632

    def act(R, K, scale=1.0):
        return _act(R, K, scale, dev)

    # attn_in: TinyLlama (32 + 4 heads of 64, no biases), then Qwen2.5-1.5B
    # (12 + 2 heads of 128 over D 1536, f32 biases), at R = 1; then
    # Mixtral-8x7B (32 + 8 heads of 128 over D 4096) on f32 scales and on
    # bf16 pairs, at R = 1 (decode) and 16 (the bucket-16 prefill)
    pairs, f32s = ("q4", "q6w"), ("q4f", "q6wf")
    for label, D_, Hq, Hk, hd_, biased, (kq, kv), R in (
            ("wqk q4-sm + wv q6w-sp R=1", dim, H, Hkv, hd, False, pairs, 1),
            ("qwen2.5-1.5b: + biases, hd 128, D 1536 R=1", 1536, 12, 2, 128, True, pairs, 1),
            ("mixtral: wqk q4-f32 + wv q6w-f32, hd 128, D 4096 R=1", MX_DIM, 32, 8, 128, False,
             f32s, 1),
            ("mixtral: wqk q4-f32 + wv q6w-f32, hd 128, D 4096 R=16", MX_DIM, 32, 8, 128, False,
             f32s, 16),
            ("mixtral: wqk q4-sm + wv q6w-sp, hd 128, D 4096 R=1", MX_DIM, 32, 8, 128, False,
             pairs, 1),
            ("mixtral: wqk q4-sm + wv q6w-sp, hd 128, D 4096 R=16", MX_DIM, 32, 8, 128, False,
             pairs, 16),
            # phase 9's recipes: Q8_0, Q6_K and Q4_K_S fuse both slots
            *((f"{lab} R={R}", dim, H, Hkv, hd, False, kinds, R)
              for lab, kinds in (("q8_0: wqk q8-sp + wv q8-sp", ("q8", "q8")),
                                 ("q6_k: wqk q6w-sp + wv q6w-sp", ("q6w", "q6w")),
                                 ("q4_k_s: wqk q4-sm + wv q4-sm", ("q4", "q4")))
              for R in (1, 16))):
        mk_in = lambda: (_rand_weights(rng, kq, (Hq + Hk) * hd_, D_, dev),  # noqa: E731
                         _rand_weights(rng, kv, Hk * hd_, D_, dev))
        w0 = mk_in()
        nbw = sum(w.n_bytes for w in w0)
        ws = _rotation(w0, nbw)
        x = act(R, D_, 0.5)
        nw = torch.rand(D_, device=dev) + 0.5
        cos, sin = torch.rand(R, hd_ // 2, device=dev), torch.rand(R, hd_ // 2, device=dev)
        n_out = w0[0].shape[0] + w0[1].shape[0]
        bias = (torch.randn(w0[0].shape[0], device=dev) * 0.5,
                torch.randn(w0[1].shape[0], device=dev) * 0.5) if biased else None
        g0, g1 = fused_attn_in(x, nw, 1e-5, *w0, cos, sin, hd_, bias)
        torch.cuda.synchronize()
        r0, r1 = attn_in_plain(x, nw, 1e-5, *w0, cos, sin, hd_, bias)
        e0, e1 = _err(g0, r0), _err(g1, r1)
        wcat = [torch.cat([dequant_kmajor(w, torch.bfloat16) for w in pair], dim=1).contiguous()
                for pair in ws]
        b, by = bound_ms(nbw + R * D_ * 2 + D_ * 4 + 2 * R * (hd_ // 2) * 4 + R * n_out * 2
                         + (n_out * 4 if biased else 0), 2.0 * R * D_ * n_out)
        run = lambda i: fused_attn_in(x, nw, 1e-5, *ws[i % len(ws)], cos, sin, hd_,  # noqa: E731
                                      bias)
        out["attn_in"].append({
            "case": label, "max_abs_err": max(e0[0], e1[0]), "rel_err": max(e0[1], e1[1]),
            "ms": graph_ms(run, 64), "eager_ms": time_ms(run, 64),
            "plain_ms": graph_ms(lambda i: attn_in_plain(x, nw, 1e-5, *w0, cos, sin, hd_, bias),
                                 4, 3),
            "library_ms": None,
            "matmul_ms": graph_ms(lambda i: torch.matmul(x, wcat[i % len(wcat)]), 64),
            "bound_ms": b, "bound_by": by})
        del ws, wcat

    # oproj_ffn, wo as the fixture stores it (q6w), on bf16 pairs and on f32
    # scales (TinyLlama loaded with scale_dtype="f32") at R = 1, and Q8_0's
    # q8 in every slot at R = 1 and 8
    for label, (ko, kg, kd), R in (
            ("wo q6w-sp + w_gateup q4-sm + w_down q6w-sp R=1", ("q6w", "q4", "q6w"), 1),
            ("f32 scales: wo q6w-f32 + w_gateup q4-f32 + w_down q6w-f32 R=1",
             ("q6wf", "q4f", "q6wf"), 1),
            ("q8_0: wo, w_gateup, w_down q8-sp R=1", ("q8", "q8", "q8"), 1),
            ("q8_0: wo, w_gateup, w_down q8-sp R=8", ("q8", "q8", "q8"), 8)):
        mk_ffn = lambda: (_rand_weights(rng, ko, dim, H * hd, dev),  # noqa: E731
                          _rand_weights(rng, kg, 2 * F, dim, dev),
                          _rand_weights(rng, kd, dim, F, dev))
        w0 = mk_ffn()
        nbw = sum(w.n_bytes for w in w0)
        ws = _rotation(w0, nbw)
        x, at = act(R, dim, 0.5), act(R, H * hd, 0.5)
        nw = torch.rand(dim, device=dev) + 0.5

        def ffn(i, plain=False):
            wo, gu, dn = w0 if plain else ws[i % len(ws)]
            f = oproj_ffn_plain if plain else fused_oproj_ffn
            return f(x, at, wo, nw, 1e-5, gu, dn)

        got = ffn(0)
        torch.cuda.synchronize()
        ref = ffn(0, plain=True)
        ad, rel = _err(got, ref)
        wd = [[dequant_kmajor(w, torch.bfloat16).contiguous() for w in trio] for trio in ws]
        xs = [at, x, act(R, F)]
        b, by = bound_ms(nbw + R * (3 * dim * 2 + H * hd * 2) + dim * 4,
                         2.0 * R * (H * hd * dim + dim * 2 * F + F * dim))
        out["oproj_ffn"].append({
            "case": label, "max_abs_err": ad, "rel_err": rel, "ms": graph_ms(ffn, 64),
            "eager_ms": time_ms(ffn, 64),
            "plain_ms": graph_ms(lambda i: ffn(i, plain=True), 4, 3),
            "library_ms": None,
            "matmul_ms": graph_ms(lambda i: [torch.matmul(a, w) for a, w in
                                             zip(xs, wd[i % len(wd)])], 64),
            "gate_up_ms": None if gate_up is None else graph_ms(
                lambda i: gate_up(x, nw, 1e-5, ws[i % len(ws)][1]), 64),
            "bound_ms": b, "bound_by": by})
        del ws, wd

    # ffn (qwen2's decode FFN) at Qwen2.5-1.5B and -7B widths, R = 1 and 8,
    # and at 1.5B on f32 scales
    out["ffn"] = []
    for label, D_, F_, kg, kd in (("qwen2.5-1.5b", 1536, 8960, "q4", "q6w"),
                                  ("qwen2.5-7b", 3584, 18944, "q4", "q6w"),
                                  ("qwen2.5-1.5b f32 scales", 1536, 8960, "q4f", "q6wf"),
                                  ("tinyllama q8_0", dim, F, "q8", "q8")):
        mk = lambda: (_rand_weights(rng, kg, 2 * F_, D_, dev),  # noqa: E731
                      _rand_weights(rng, kd, D_, F_, dev))
        w0 = mk()
        nbw = sum(w.n_bytes for w in w0)
        ws = _rotation(w0, nbw)
        wd = [[dequant_kmajor(w, torch.bfloat16).contiguous() for w in pair] for pair in ws]
        nw = torch.rand(D_, device=dev) + 0.5
        for R in (1, 8):
            x = act(R, D_, 0.5)
            got = fused_ffn(x, nw, 1e-6, *w0)
            torch.cuda.synchronize()
            ad, rel = _err(got, ffn_plain(x, nw, 1e-6, *w0))
            a_f = act(R, F_)
            b, by = bound_ms(nbw + 2 * R * D_ * 2 + D_ * 4, 2.0 * R * 3 * D_ * F_)
            run = lambda i: fused_ffn(x, nw, 1e-6, *ws[i % len(ws)])  # noqa: E731
            pair = {"q4f": "q4-f32 + w_down q6w-f32", "q4": "q4-sm + w_down q6w-sp",
                    "q8": "q8-sp + w_down q8-sp"}[kg]
            out["ffn"].append({
                "case": f"{label} w_gateup {pair} R={R}", "max_abs_err": ad,
                "rel_err": rel, "ms": graph_ms(run, 64), "eager_ms": time_ms(run, 64),
                "plain_ms": graph_ms(lambda i: ffn_plain(x, nw, 1e-6, *w0), 4, 3),
                "library_ms": None,
                "matmul_ms": graph_ms(lambda i: [torch.matmul(a, w) for a, w in
                                                 zip((x, a_f), wd[i % len(wd)])], 64),
                "gate_up_ms": None if gate_up is None else graph_ms(
                    lambda i: gate_up(x, nw, 1e-6, ws[i % len(ws)][0]), 64),
                "bound_ms": b, "bound_by": by})
        del ws, wd

    # the gate/up phase alone (csrc/gate_up.cuh, the phase of oproj_ffn,
    # ffn, layer and rot) at every kind the fused gates take, on TinyLlama's
    # w_gateup [11264, 2048], R = 1 and 8, against gate_up_plain; listed
    # with ffn's cases (library_ms null, matmul_ms the bf16 matmul)
    if gate_up is not None:
        for kg in ("q4", "q4f", "q6w", "q6wf", "q8", "q8f"):
            w0 = _rand_weights(rng, kg, 2 * F, dim, dev)
            ws = _rotation([w0], w0.n_bytes)
            wd = [dequant_kmajor(w[0], torch.bfloat16).contiguous() for w in ws]
            nw = torch.rand(dim, device=dev) + 0.5
            for R in (1, 8):
                x = act(R, dim, 0.5)
                got = gate_up(x, nw, 1e-5, w0)
                torch.cuda.synchronize()
                ad, rel = _err(got, ffn_mod.gate_up_plain(x, nw, 1e-5, w0))
                b, by = bound_ms(w0.n_bytes + R * dim * 2 + dim * 4 + R * F * 2,
                                 2.0 * R * dim * 2 * F)
                run = lambda i: gate_up(x, nw, 1e-5, ws[i % len(ws)][0])  # noqa: E731
                side = "f32" if kg.endswith("f") else "pairs"
                out["ffn"].append({
                    "case": f"gate/up phase alone: {kg.rstrip('f')} {side} [11264, 2048] R={R}",
                    "max_abs_err": ad, "rel_err": rel, "ms": graph_ms(run, 64),
                    "eager_ms": time_ms(run, 64),
                    "plain_ms": graph_ms(lambda i: ffn_mod.gate_up_plain(x, nw, 1e-5, w0), 4, 3),
                    "library_ms": None,
                    "matmul_ms": graph_ms(lambda i: torch.matmul(x, wd[i % len(wd)]), 64),
                    "bound_ms": b, "bound_by": by})
            del ws, wd
    return out


# Llama-3-8B (dim 4096, 32 / 8 heads of 128, ffn 14336); the (dim, ffn) of
# check_folds' TinyLlama-1.1B and Qwen2.5-1.5B cases
L3_DIM, L3_H, L3_HKV, L3_HD, L3_FFN = 4096, 32, 8, 128, 14336
FOLD_TINY, FOLD_QWEN = (2048, 5632), (1536, 8960)


def _fold_gap(got, ref, off, x=None) -> tuple[float, float]:
    """(mean |got - ref|, the fold gap mean |ref - off|) of the block's
    delta (output minus residual x where given), in f32: a folded kernel
    against its plain folded form, and that form against the unfolded
    one."""
    got, ref, off = (t.float() - (0 if x is None else x.float()) for t in (got, ref, off))
    return (got - ref).abs().mean().item(), (ref - off).abs().mean().item()


def check_folds(dev, rng) -> dict:
    """The int8 folds of #3, #5 and #6 (ops/dequant.py) against their plain
    folded forms, each under the switches that make the TPU's dispatch fold
    there: attn_in at Llama-3-8B's wqk [5120, 4096] q4-sm + wv [1024, 4096]
    q6w-sp, R = 16 under TKQ_Q4_MXU_MINS=0 (the "auto" rule) and R = 1
    under TKQ_INT8_FOLDS=1 TKQ_MANUAL_ATTN_IN=0; oproj_ffn at TinyLlama's
    fixture layout (wo q6w-sp, gate/up q4-sm [11264, 2048]) R = 1 and 8,
    and at Llama-3-8B's gate/up [28672, 4096] R = 1 and 8 with wo q6w-sp
    and with wo q4-sm (TKQ_MANUAL_OPROJ=0); ffn at Qwen2.5-1.5B's q4
    gate/up on f32 scales R = 1 and 8 and on pairs R = 1. Beside them the
    same kernels unfolded at Llama-3-8B's widths (phase 18's decode). Each
    folded case must be within TOL of its plain folded form and its mean
    |error| below a quarter of its fold gap (the plain folded form against
    the plain unfolded one), and must have launched the folded branch
    (fatal). Timed as the other fused cases: matmul_ms the bf16 matmuls of
    the dequantized weights."""
    import torch

    from tpu_kquant_torch.ops import attn_in as ai
    from tpu_kquant_torch.ops import ffn as ffn_mod
    from tpu_kquant_torch.quant.codecs import dequant_kmajor

    out: dict = {"attn_in": [], "oproj_ffn": [], "ffn": []}
    folds1 = {"TKQ_INT8_FOLDS": "1"}

    def held(name, label, env, run, plain, fold_plain, ctr, x, nbw, io_bytes, macs, mats):
        """Run the case under `env`: the kernel once (checked), timed."""
        with switches(env):
            n0 = ctr.launches + ctr.plain_calls
            got = run(0)
            torch.cuda.synchronize()
            folded = ctr.launches + ctr.plain_calls - n0
            ref = fold_plain(bool(env))
            first = lambda t: t[0] if isinstance(t, tuple) else t  # noqa: E731
            ad, rel = _err(first(got), first(ref))
            c = {"case": label, "max_abs_err": ad, "rel_err": rel}
            if env:
                err, gap = _fold_gap(first(got), first(ref), first(fold_plain(False)), x)
                c.update(mean_err=err, fold_gap=gap, folded_launches=folded)
                log(f"  {name} {label}: mean |err| {err:.3e}, fold gap {gap:.3e} "
                    f"(ratio {err / max(gap, 1e-30):.3f}); folded launches {folded}")
                if folded != 1 or not (gap > 0 and err < gap / 4):
                    raise SystemExit(f"FAIL: {name} {label}: folded launches {folded}, mean "
                                     f"|err| {err:.3e} not below a quarter of the fold gap "
                                     f"{gap:.3e}")
            elif folded:
                raise SystemExit(f"FAIL: {name} {label} folded under the default switches")
            b, by = bound_ms(nbw + io_bytes, 2.0 * macs[0] + macs[1])  # int8 ops at half cost
            c.update(ms=graph_ms(run, 64), eager_ms=time_ms(run, 64),
                     plain_ms=graph_ms(lambda i: plain(), 4, 3), library_ms=None,
                     matmul_ms=graph_ms(mats, 64), bound_ms=b, bound_by=by)
        out[name].append(c)

    # attn_in (#3)
    D, H, Hkv, hd = L3_DIM, L3_H, L3_HKV, L3_HD
    w0 = (_rand_weights(rng, "q4", (H + Hkv) * hd, D, dev),
          _rand_weights(rng, "q6w", Hkv * hd, D, dev))
    nbw = sum(w.n_bytes for w in w0)
    ws = _rotation(w0, nbw)
    wcat = [torch.cat([dequant_kmajor(w, torch.bfloat16) for w in pair], dim=1).contiguous()
            for pair in ws[:4]]
    nw = torch.rand(D, device=dev) + 0.5
    n_out = (H + 2 * Hkv) * hd
    for label, env, R in (("llama-3-8b: wqk q4-sm + wv q6w-sp R=1", {}, 1),
                          ("llama-3-8b: wqk q4-sm + wv q6w-sp R=16", {}, 16),
                          ("llama-3-8b folded (TKQ_Q4_MXU_MINS=0, auto) R=16",
                           {"TKQ_Q4_MXU_MINS": "0"}, 16),
                          ("llama-3-8b folded (TKQ_INT8_FOLDS=1 TKQ_MANUAL_ATTN_IN=0) R=1",
                           {**folds1, "TKQ_MANUAL_ATTN_IN": "0"}, 1)):
        x = _act(R, D, 0.5, dev)
        cos, sin = torch.rand(R, hd // 2, device=dev), torch.rand(R, hd // 2, device=dev)
        args = (x, nw, 1e-5)
        q_macs = R * D * (H + Hkv) * hd
        held("attn_in", label, env,
             lambda i: ai.fused_attn_in(*args, *ws[i % len(ws)], cos, sin, hd),
             lambda: ai.attn_in_plain(*args, *w0, cos, sin, hd, fold=bool(env)),
             lambda f: ai.attn_in_plain(*args, *w0, cos, sin, hd, fold=f),
             ai.fold_counter, None, nbw,
             R * D * 2 + D * 4 + 2 * R * (hd // 2) * 4 + R * n_out * 2,
             (R * D * n_out - (q_macs if env else 0), q_macs if env else 0),
             lambda i: torch.matmul(x, wcat[i % len(wcat)]))
    del ws, wcat

    # oproj_ffn (#5): one weight trio a layout, its cases in turn
    q6_env = folds1
    q4_env = {**folds1, "TKQ_MANUAL_OPROJ": "0"}
    for dim, F_, ko, cases in (
            (*FOLD_TINY, "q6w", (("tinyllama", q6_env, 1), ("tinyllama", q6_env, 8))),
            (D, L3_FFN, "q6w", (("llama-3-8b", {}, 1), ("llama-3-8b", {}, 8),
                                ("llama-3-8b", q6_env, 1), ("llama-3-8b", q6_env, 8))),
            (D, L3_FFN, "q4", (("llama-3-8b", q4_env, 1), ("llama-3-8b", q4_env, 8)))):
        w0 = (_rand_weights(rng, ko, dim, dim, dev), _rand_weights(rng, "q4", 2 * F_, dim, dev),
              _rand_weights(rng, "q6w", dim, F_, dev))
        nbw = sum(w.n_bytes for w in w0)
        ws = _rotation(w0, nbw)
        wd = [[dequant_kmajor(w, torch.bfloat16).contiguous() for w in trio] for trio in ws[:2]]
        nw_ = torch.rand(dim, device=dev) + 0.5
        side = "sm" if ko == "q4" else "sp"
        for model, env, R in cases:
            label = (f"{model}: wo {ko}-{side} + w_gateup q4-sm + w_down q6w-sp"
                     + (", folded" if env else "")
                     + (" (TKQ_MANUAL_OPROJ=0)" if "TKQ_MANUAL_OPROJ" in env else "") + f" R={R}")
            x, at = _act(R, dim, 0.5, dev), _act(R, dim, 0.5, dev)
            fwo = bool(env) and ko == "q4"
            xs = [at, x, _act(R, F_, 1.0, dev)]
            i8 = R * (dim * dim * fwo + dim * 2 * F_) if env else 0
            held("oproj_ffn", label, env,
                 lambda i: ffn_mod.fused_oproj_ffn(x, at, ws[i % len(ws)][0], nw_, 1e-5,
                                                   *ws[i % len(ws)][1:]),
                 lambda: ffn_mod.oproj_ffn_plain(x, at, w0[0], nw_, 1e-5, *w0[1:],
                                                 folds=(fwo, bool(env)), round_first=bool(env)),
                 lambda f: ffn_mod.oproj_ffn_plain(x, at, w0[0], nw_, 1e-5, *w0[1:],
                                                   folds=(fwo and f, f), round_first=f),
                 ffn_mod.fold_counter, x, nbw, R * (3 * dim * 2 + dim * 2) + dim * 4,
                 (R * (dim * dim + 3 * dim * F_) - i8, i8),
                 lambda i: [torch.matmul(a, w) for a, w in zip(xs, wd[i % len(wd)])])
        del ws, wd

    # ffn (#6)
    dim, F_ = FOLD_QWEN
    for kg, R in (("q4f", 1), ("q4f", 8), ("q4", 1)):
        w0 = (_rand_weights(rng, kg, 2 * F_, dim, dev), _rand_weights(rng, "q6w", dim, F_, dev))
        nbw = sum(w.n_bytes for w in w0)
        ws = _rotation(w0, nbw)
        wd = [[dequant_kmajor(w, torch.bfloat16).contiguous() for w in pair] for pair in ws[:2]]
        x, nw_ = _act(R, dim, 0.5, dev), torch.rand(dim, device=dev) + 0.5
        xs = [x, _act(R, F_, 1.0, dev)]
        side = "f32" if kg == "q4f" else "sm"
        held("ffn", f"qwen2.5-1.5b: w_gateup q4-{side} + w_down q6w-sp, folded R={R}", folds1,
             lambda i: ffn_mod.fused_ffn(x, nw_, 1e-6, *ws[i % len(ws)]),
             lambda: ffn_mod.ffn_plain(x, nw_, 1e-6, *w0, fold=True),
             lambda f: ffn_mod.ffn_plain(x, nw_, 1e-6, *w0, fold=f),
             ffn_mod.ffn_fold_counter, x, nbw, 2 * R * dim * 2 + dim * 4,
             (R * dim * F_, R * dim * 2 * F_),
             lambda i: [torch.matmul(a, w) for a, w in zip(xs, wd[i % len(wd)])])
        del ws, wd
    return out


# Gemma-2B (dim 2048, 8 / 1 heads of 256, ffn 16384) and Gemma-2-9B (dim
# 3584, 16 / 8 heads of 256, ffn 14336), Q4_K_M kinds
GEMMA_2B = (2048, 8, 1, 256, 16384)
GEMMA2_9B = (3584, 16, 8, 256, 14336)


def check_gemma(dev, rng) -> dict:
    """The gemma family's branches of the fused kernels against their plain
    versions, timed as check_kernels' cases: attn_in at head_dim 256
    (Gemma-2B's wqk q4-sm [2304, 2048] and wv q6w-sp [256, 2048] at R = 1
    and 16, Gemma-2-9B's [6144, 3584] and [2048, 3584] at R = 1);
    oproj_ffn (R = 1, 8), ffn (R = 1, 8) and the gate/up phase alone (R = 1)
    with GELU at Gemma-2B's widths; layer with GELU at TinyLlama's shapes
    (f32 scales, as path (b) loads them); rot with GELU at Gemma-2B's shapes
    (R = 1: o_proj, the FFN and the next layer's head_dim-256 QKV). Flash
    decode and prefill at head_dim 256 are DECODE_CASES' and PREFILL_CASES'
    gemma rows. Returns {kernel: [case dicts]} to append."""
    import torch

    from tpu_kquant_torch.ops import ffn as ffn_mod
    from tpu_kquant_torch.ops.attn_in import attn_in_plain, fused_attn_in
    from tpu_kquant_torch.ops.layer import fused_layer, layer_plain
    from tpu_kquant_torch.ops.rope import rope_cos_sin
    from tpu_kquant_torch.ops.rot import fused_oproj_ffn_attn_in, rot_plain
    from tpu_kquant_torch.models.config import RopeParams
    from tpu_kquant_torch.quant.codecs import dequant_kmajor

    out: dict = {"attn_in": [], "oproj_ffn": [], "ffn": [], "layer": [], "rot": []}
    deq = lambda ws: [dequant_kmajor(w, torch.bfloat16).contiguous() for w in ws]  # noqa: E731

    def timed(run, plain, mats, lead_ms=None) -> dict:
        return {"ms": graph_ms(run, 32), "eager_ms": time_ms(run, 32),
                "plain_ms": graph_ms(plain, 2, 3), "library_ms": None, "matmul_ms": mats,
                **({} if lead_ms is None else {"gate_up_ms": lead_ms})}

    # attn_in at head_dim 256: a column block takes 64 columns of a head's
    # first half and their rope partners
    for label, (D_, Hq, Hk, hd, _), R in (("gemma-2b", GEMMA_2B, 1), ("gemma-2b", GEMMA_2B, 16),
                                           ("gemma-2-9b", GEMMA2_9B, 1)):
        mk = lambda: (_rand_weights(rng, "q4", (Hq + Hk) * hd, D_, dev),  # noqa: E731
                      _rand_weights(rng, "q6w", Hk * hd, D_, dev))
        w0 = mk()
        nbw = sum(w.n_bytes for w in w0)
        ws = _rotation(w0, nbw)
        x = _act(R, D_, 0.5, dev)
        nw = torch.rand(D_, device=dev) + 0.5
        cos, sin = rope_cos_sin(torch.randint(0, 8192, (R, 1), device=dev),
                                RopeParams(head_dim=hd, n_rot=hd, mode="neox"))
        cos, sin = cos[:, 0], sin[:, 0]
        g0, g1 = fused_attn_in(x, nw, 1e-6, *w0, cos, sin, hd)
        torch.cuda.synchronize()
        r0, r1 = attn_in_plain(x, nw, 1e-6, *w0, cos, sin, hd)
        e0, e1 = _err(g0, r0), _err(g1, r1)
        n_out = w0[0].shape[0] + w0[1].shape[0]
        wcat = [torch.cat(deq(pair), dim=1).contiguous() for pair in ws]
        b, by = bound_ms(nbw + R * D_ * 2 + D_ * 4 + 2 * R * (hd // 2) * 4 + R * n_out * 2,
                         2.0 * R * D_ * n_out)
        out["attn_in"].append({
            "case": f"{label}: wqk q4-sm + wv q6w-sp, hd 256, D {D_} R={R}",
            "max_abs_err": max(e0[0], e1[0]), "rel_err": max(e0[1], e1[1]),
            **timed(lambda i: fused_attn_in(x, nw, 1e-6, *ws[i % len(ws)], cos, sin, hd),
                    lambda i: attn_in_plain(x, nw, 1e-6, *w0, cos, sin, hd, None),
                    graph_ms(lambda i: torch.matmul(x, wcat[i % len(wcat)]), 32)),
            "bound_ms": b, "bound_by": by})
        del ws, wcat

    # oproj_ffn and ffn with GELU at Gemma-2B's widths (wo q6w, gate/up q4,
    # down q6w), and the gate/up phase alone
    dim, H, Hkv, hd, F = GEMMA_2B
    mk = lambda: (_rand_weights(rng, "q6w", dim, H * hd, dev),  # noqa: E731
                  _rand_weights(rng, "q4", 2 * F, dim, dev),
                  _rand_weights(rng, "q6w", dim, F, dev))
    w0 = mk()
    nbw = sum(w.n_bytes for w in w0)
    ws = _rotation(w0, nbw)
    wd = [deq(t) for t in ws]
    nw = torch.rand(dim, device=dev) + 0.5
    for R in (1, 8):
        x, at, a_f = _act(R, dim, 0.5, dev), _act(R, H * hd, 0.5, dev), _act(R, F, 1.0, dev)

        def oproj(i, plain=False):
            wo, gu, dn = w0 if plain else ws[i % len(ws)]
            f = ffn_mod.oproj_ffn_plain if plain else ffn_mod.fused_oproj_ffn
            return f(x, at, wo, nw, 1e-6, gu, dn, act_fn="gelu")

        def ffn(i, plain=False):
            _, gu, dn = w0 if plain else ws[i % len(ws)]
            f = ffn_mod.ffn_plain if plain else ffn_mod.fused_ffn
            return f(x, nw, 1e-6, gu, dn, act_fn="gelu")

        lead = graph_ms(lambda i: ffn_mod.gate_up(x, nw, 1e-6, ws[i % len(ws)][1], "gelu"), 32)
        for name, fn, nb, fl, mats in (
                ("oproj_ffn", oproj, nbw + R * (3 * dim * 2 + H * hd * 2) + dim * 4,
                 2.0 * R * (H * hd * dim + 3 * dim * F), (at, x, a_f)),
                ("ffn", ffn, nbw - w0[0].n_bytes + 2 * R * dim * 2 + dim * 4,
                 2.0 * R * 3 * dim * F, (None, x, a_f))):
            got = fn(0)
            torch.cuda.synchronize()
            ad, rel = _err(got, fn(0, plain=True))
            b, by = bound_ms(nb, fl)
            out[name].append({
                "case": f"gemma-2b GELU: {'wo q6w-sp + ' if name == 'oproj_ffn' else ''}"
                        f"w_gateup q4-sm [32768, 2048] + w_down q6w-sp R={R}",
                "max_abs_err": ad, "rel_err": rel,
                **timed(fn, lambda i, fn=fn: fn(i, plain=True),
                        graph_ms(lambda i, mats=mats: [
                    torch.matmul(a, w) for a, w in zip(mats, wd[i % len(wd)]) if a is not None],
                    32), lead),
                "bound_ms": b, "bound_by": by})
    x = _act(1, dim, 0.5, dev)
    got = ffn_mod.gate_up(x, nw, 1e-6, w0[1], "gelu")
    torch.cuda.synchronize()
    ad, rel = _err(got, ffn_mod.gate_up_plain(x, nw, 1e-6, w0[1], "gelu"))
    b, by = bound_ms(w0[1].n_bytes + dim * 2 + dim * 4 + F * 2, 2.0 * dim * 2 * F)
    out["ffn"].append({
        "case": "gate/up phase alone: gemma-2b GELU q4 pairs [32768, 2048] R=1",
        "max_abs_err": ad, "rel_err": rel,
        **timed(lambda i: ffn_mod.gate_up(x, nw, 1e-6, ws[i % len(ws)][1], "gelu"),
                lambda i: ffn_mod.gate_up_plain(x, nw, 1e-6, w0[1], "gelu"),
                graph_ms(lambda i: torch.matmul(x, wd[i % len(wd)][1]), 32)),
        "bound_ms": b, "bound_by": by})

    # rot with GELU at Gemma-2B's shapes: the next layer's QKV at head_dim 256
    n0, n1 = (H + Hkv) * hd, Hkv * hd
    mk2 = lambda: (_rand_weights(rng, "q4", n0, dim, dev),  # noqa: E731
                   _rand_weights(rng, "q6w", n1, dim, dev))
    nxt = [mk2() for _ in ws]
    nw2 = torch.rand(dim, device=dev) + 0.5
    x, at = _act(1, dim, 0.5, dev), _act(1, H * hd, 0.5, dev)
    cos, sin = (torch.rand(1, hd // 2, device=dev) for _ in range(2))

    def rot(i, plain=False):
        (wo, gu, dn), (wq, wv) = (w0, nxt[0]) if plain else (ws[i % len(ws)], nxt[i % len(ws)])
        f = rot_plain if plain else fused_oproj_ffn_attn_in
        return f(x, at, wo, nw, 1e-6, gu, dn, nw2, wq, wv, cos, sin, hd, act_fn="gelu")

    got = rot(0)
    torch.cuda.synchronize()
    errs = [_err(a, r) for a, r in zip(got, rot(0, plain=True))]
    nb2 = sum(w.n_bytes for w in nxt[0])
    b, by = bound_ms(nbw + nb2 + 2 * (H * hd + 2 * dim + n0 + n1) + 8 * dim + 2 * hd * 4,
                     2.0 * (dim * (H * hd + 3 * F) + dim * (n0 + n1)))
    out["rot"].append({
        "case": "gemma-2b GELU, next layer's QKV at hd 256, R=1 bf16 pairs",
        "max_abs_err": max(e[0] for e in errs), "rel_err": max(e[1] for e in errs),
        **timed(rot, lambda i: rot(i, plain=True), None), "bound_ms": b, "bound_by": by})
    out["rot"][-1]["matmul_ms"] = graph_ms(
        lambda i: [torch.matmul(a, w) for a, w in zip((at, x, _act(1, F, 1.0, dev)),
                                                      wd[i % len(wd)])], 32)
    del ws, wd, nxt

    # layer with GELU at TinyLlama's shapes (the layer gate's head dims are
    # 64 and 128 in both packages), f32 scales
    dim, (H, Hkv, hd), F = 2048, TINY_HEADS, 5632
    n0, n1 = (H + Hkv) * hd, Hkv * hd
    kinds = (("q4f", n0, dim), ("q6wf", n1, dim), ("q6wf", dim, H * hd), ("q4f", 2 * F, dim),
             ("q6wf", dim, F))
    mk_l = lambda: [_rand_weights(rng, k_, N, K, dev) for k_, N, K in kinds]  # noqa: E731
    w0 = mk_l()
    nbw = sum(w.n_bytes for w in w0)
    ws = _rotation(w0, nbw)
    wd = [deq(t) for t in ws]
    anw, fnw = (torch.rand(dim, device=dev) + 0.5 for _ in range(2))
    for positions in ((700,), (0, 255, 256, 700)):
        B = len(positions)
        pos = torch.tensor(positions, device=dev)[:, None]
        cos, sin = rope_cos_sin(pos, RopeParams(head_dim=hd, n_rot=hd))
        x = _act(B, dim, 0.5, dev).reshape(B, 1, dim)
        kc, vc = (torch.randn(B, Hkv, FUSED_S, hd, device=dev).to(torch.bfloat16)
                  for _ in range(2))
        args = (cos, sin, kc, vc, H, Hkv)
        got = fused_layer(x, pos, anw, fnw, 1e-5, *w0, *args, act_fn="gelu")
        torch.cuda.synchronize()
        ref = layer_plain(x, pos, anw, fnw, 1e-5, *w0, *args, act_fn="gelu")
        rel = max(row_rel_err(a.reshape(B, -1), r.reshape(B, -1)) for a, r in zip(got, ref))
        live = float(sum(positions))
        b, by = bound_ms(nbw + live * Hkv * 2 * hd * 2 + 2 * B * (2 * dim + 2 * n1) + B * 16,
                         2.0 * B * (dim * (n0 + n1 + H * hd) + 3 * dim * F)
                         + 4.0 * (live + B) * H * hd)
        xs = [_act(B, K, 1.0, dev) for _, _, K in kinds]
        out["layer"].append({
            "case": f"GELU: B={B} positions {list(positions)}, S {FUSED_S}, f32 scales",
            "max_abs_err": max(_err(a, r)[0] for a, r in zip(got, ref)), "rel_err": rel,
            **timed(lambda i: fused_layer(x, pos, anw, fnw, 1e-5, *ws[i % len(ws)], *args,
                                          act_fn="gelu"),
                    lambda i: layer_plain(x, pos, anw, fnw, 1e-5, *w0, *args, act_fn="gelu"),
                    graph_ms(lambda i: [torch.matmul(a, w) for a, w in
                                        zip(xs, wd[i % len(wd)])], 32)),
            "bound_ms": b, "bound_by": by})
        del kc, vc
    del ws, wd
    torch.cuda.empty_cache()
    return out


# Phi-3-mini-4k (dim 3072, 32 / 32 heads of 96, ffn 8192, vocab 32064), Q4_K_M
# kinds: wqkv q4 [9216, 3072] (one tensor), wo q6w, w_gateup q4, w_down q6w,
# the lm head q6w [32064, 3072]
PHI3 = (3072, 32, 32, 96, 8192, 32064)


def check_phi3(dev, rng) -> dict:
    """The sliding-window family's branches against their plain versions,
    timed as check_kernels' cases: attn_in on Phi-3-mini's one wqkv as
    qkv_slots' two views (head_dim 96: the paired column map; R = 1, 16,
    32); oproj_ffn at D 3072, F 8192 (R = 1, 8); rot with the next layer's
    wqkv at head_dim 96 (R = 1); qmm's lm head at N = 32064 (not a multiple
    of 128: the GEMV's and the tile's ragged column blocks; R = 1, 32, 512).
    Returns {kernel: [case dicts]} to append."""
    import torch

    from tpu_kquant_torch.ops import ffn as ffn_mod
    from tpu_kquant_torch.ops.attn_in import attn_in_plain, fused_attn_in, qkv_slots
    from tpu_kquant_torch.ops.rot import fused_oproj_ffn_attn_in, rot_plain
    from tpu_kquant_torch.quant.codecs import dequant_kmajor

    dim, H, Hkv, hd, F, V = PHI3
    n_qkv, n_rope = (H + 2 * Hkv) * hd, (H + Hkv) * hd
    out: dict = {"qmm": check_qmm(dev, rng, tuple(
        (f"phi-3-mini lm head q6w-sp [{V}, {dim}] R={R}", "q6w", V, dim, R, "bf", "f32")
        for R in (1, 32, 512))), "attn_in": [], "oproj_ffn": [], "rot": []}
    deq = lambda ws: [dequant_kmajor(w, torch.bfloat16).contiguous() for w in ws]  # noqa: E731

    def timed(run, plain, mats) -> dict:
        return {"ms": graph_ms(run, 32), "eager_ms": time_ms(run, 32),
                "plain_ms": graph_ms(plain, 2, 3), "library_ms": None, "matmul_ms": mats}

    # attn_in on the slots of one wqkv: qk (64 heads of 96, roped), v (32)
    mk = lambda: _rand_weights(rng, "q4", n_qkv, dim, dev)  # noqa: E731
    w0 = mk()
    ws = _rotation(w0, w0.n_bytes)
    slots = [qkv_slots(w, n_rope) for w in ws]
    wd = [dequant_kmajor(w, torch.bfloat16).contiguous() for w in ws]
    nw = torch.rand(dim, device=dev) + 0.5
    for R in (1, 16, 32):
        x = _act(R, dim, 0.5, dev)
        cos, sin = (torch.rand(R, hd // 2, device=dev) for _ in range(2))
        g0, g1 = fused_attn_in(x, nw, 1e-5, *slots[0], cos, sin, hd)
        torch.cuda.synchronize()
        r0, r1 = attn_in_plain(x, nw, 1e-5, *slots[0], cos, sin, hd)
        e0, e1 = _err(g0, r0), _err(g1, r1)
        b, by = bound_ms(w0.n_bytes + R * dim * 2 + dim * 4 + 2 * R * (hd // 2) * 4
                         + R * n_qkv * 2, 2.0 * R * dim * n_qkv)
        out["attn_in"].append({
            "case": f"phi-3-mini: wqkv q4-sm [{n_qkv}, {dim}] as 2 slots, hd 96 R={R}",
            "max_abs_err": max(e0[0], e1[0]), "rel_err": max(e0[1], e1[1]),
            **timed(lambda i: fused_attn_in(x, nw, 1e-5, *slots[i % len(slots)], cos, sin, hd),
                    lambda i: attn_in_plain(x, nw, 1e-5, *slots[0], cos, sin, hd),
                    graph_ms(lambda i: torch.matmul(x, wd[i % len(wd)]), 32)),
            "bound_ms": b, "bound_by": by})

    # oproj_ffn (wo q6w, gate/up q4, down q6w) at R = 1 and 8, then rot: the
    # same weights and the next layer's wqkv slots, R = 1
    mk = lambda: (_rand_weights(rng, "q6w", dim, H * hd, dev),  # noqa: E731
                  _rand_weights(rng, "q4", 2 * F, dim, dev),
                  _rand_weights(rng, "q6w", dim, F, dev))
    f0 = mk()
    nbf = sum(w.n_bytes for w in f0)
    fs = _rotation(f0, nbf)
    fd = [deq(t) for t in fs]
    nw2 = torch.rand(dim, device=dev) + 0.5
    for R in (1, 8):
        x, at, a_f = _act(R, dim, 0.5, dev), _act(R, H * hd, 0.5, dev), _act(R, F, 1.0, dev)

        def oproj(i, plain=False):
            wo, gu, dn = f0 if plain else fs[i % len(fs)]
            fn = ffn_mod.oproj_ffn_plain if plain else ffn_mod.fused_oproj_ffn
            return fn(x, at, wo, nw, 1e-5, gu, dn)

        def mats(i, extra=()):
            return [torch.matmul(a, w) for a, w in zip((at, x, a_f, *extra),
                                                      (*fd[i % len(fd)], *(wd[i % len(wd)]
                                                                          for _ in extra)))]

        got = oproj(0)
        torch.cuda.synchronize()
        ad, rel = _err(got, oproj(0, plain=True))
        b, by = bound_ms(nbf + R * (3 * dim * 2 + H * hd * 2) + dim * 4,
                         2.0 * R * (H * hd * dim + 3 * dim * F))
        out["oproj_ffn"].append({
            "case": f"phi-3-mini: wo q6w-sp + w_gateup q4-sm [{2 * F}, {dim}] + w_down q6w-sp "
                    f"R={R}", "max_abs_err": ad, "rel_err": rel,
            **timed(oproj, lambda i: oproj(i, plain=True), graph_ms(mats, 32)),
            "bound_ms": b, "bound_by": by})
        if R != 1:
            continue
        cos, sin = (torch.rand(1, hd // 2, device=dev) for _ in range(2))

        def rot(i, plain=False):
            (wo, gu, dn), nxt = (f0, slots[0]) if plain else (fs[i % len(fs)],
                                                               slots[i % len(slots)])
            fn = rot_plain if plain else fused_oproj_ffn_attn_in
            return fn(x, at, wo, nw, 1e-5, gu, dn, nw2, *nxt, cos, sin, hd)

        got = rot(0)
        torch.cuda.synchronize()
        errs = [_err(a, r) for a, r in zip(got, rot(0, plain=True))]
        b, by = bound_ms(nbf + w0.n_bytes + 2 * (H * hd + 2 * dim + n_qkv) + 8 * dim
                         + 2 * hd * 4, 2.0 * (dim * (H * hd + 3 * F) + dim * n_qkv))
        out["rot"].append({
            "case": f"phi-3-mini: next layer's wqkv [{n_qkv}, {dim}] as 2 slots, hd 96, R=1 "
                    f"bf16 pairs", "max_abs_err": max(e[0] for e in errs),
            "rel_err": max(e[1] for e in errs),
            **timed(rot, lambda i: rot(i, plain=True),
                    graph_ms(lambda i: mats(i, (x,)), 32)),
            "bound_ms": b, "bound_by": by})
    del ws, slots, wd, fs, fd
    torch.cuda.empty_cache()
    return out


# the batch sizes whose rows the invariance check holds to the row alone
INVARIANCE_ROWS = (16, 32)


def check_batch_invariance(dev, rng) -> int:
    """Row r of a call with R in INVARIANCE_ROWS rows must equal, bit for
    bit (torch.equal), that row computed alone (R = 1): qmm at every kind
    code at TinyLlama's wqk [2304, 2048] and Mixtral's wo [4096, 4096] (f32
    out) and at Mamba-2.8B's five shapes (MAMBA_QMM), rms_norm at widths
    1536-4096 on rows whose squares span many binades, qmm_int8 (q4-f32 at Mixtral's expert gate/up, q6-f32 at
    TinyLlama's down), attn_in and oproj_ffn at TinyLlama's widths and ffn
    at Qwen2.5-1.5B's (bf16 out, their main path's). qmm's tile: rows [64 i,
    64 i + 64) of a 16 x 64 burst (the batcher's burst prefill) must equal
    the 64-row call of those rows (a prompt alone), at TinyLlama's
    projections and every kind code at its wqk. Flash decode (#7): row b of
    a B = 16 and a B = 1024 call on 2048 slots must equal row b alone, at
    TinyLlama's and Qwen2.5-1.5B's heads on bf16 and int8 KV. attn_in also
    at Qwen2.5-1.5B (biases, head_dim 128), at Mixtral-8x7B on f32 scales
    and with Q8_0's q8 in both slots, after its kernel's K split is held to
    ops/attn_in.py:attn_in_plan at every pair of slot kinds; the plain
    decode attention (ops/attention.py:attention_plain, the serving cell's
    16 slots of 128 at TinyLlama's heads) on bf16 and int8 KV, with the
    deferred append on and off; the int8 folds of attn_in (Llama-3-8B),
    oproj_ffn (TinyLlama, wo q6w and q4) and ffn (TinyLlama, Qwen2.5-1.5B
    on f32 scales); the rows of a 5-token verify window (engine.
    step) against the decode steps at their positions; then
    check_fused_invariance (attn_out and
    layer). Fatal; returns the number of cases checked."""
    import torch

    from tpu_kquant_torch.ops import attn_in as attn_in_mod
    from tpu_kquant_torch.ops.attention import attention_decode
    from tpu_kquant_torch.ops.attn_in import fused_attn_in
    from tpu_kquant_torch.ops.decode_attention import attention_decode_flash
    from tpu_kquant_torch.ops.ffn import fused_ffn, fused_oproj_ffn
    from tpu_kquant_torch.ops.norms import rms_norm
    from tpu_kquant_torch.ops.qmm import KINDS, qmm
    from tpu_kquant_torch.ops.qmm_int8 import qmm_int8

    top = max(INVARIANCE_ROWS)
    n = 0

    def same_rows(label, fn, *xs):
        nonlocal n
        tup = lambda y: y if isinstance(y, tuple) else (y,)  # noqa: E731
        solo = [tup(fn(*(x[r:r + 1] for x in xs))) for r in range(top)]
        bad = []
        for R in INVARIANCE_ROWS:
            got = tup(fn(*(x[:R] for x in xs)))
            bad += [(R, r) for r in range(R)
                    if not all(torch.equal(g[r:r + 1], o) for g, o in zip(got, solo[r]))]
        if bad:
            raise SystemExit(f"FAIL: batch invariance: {label}: (R, row) {bad[:8]} differ from "
                             f"the row computed alone")
        n += 1

    f32 = torch.float32
    for kind, side in KINDS:
        k = kind + ("f" if side == "f32" else "")
        for N, K in ((2304, 2048), (MX_DIM, MX_DIM)):
            w = _rand_weights(rng, k, N, K, dev)
            same_rows(f"qmm {kind}-{side} [{N}, {K}]", lambda x: qmm(x, w, f32),
                      _act(top, K, dev=dev))
    for label, k, N, K, _o in MAMBA_QMM:
        w = _rand_weights(rng, k, N, K, dev)
        same_rows(f"qmm mamba-2.8b {label} [{N}, {K}]", lambda x: qmm(x, w, f32),
                  _act(top, K, dev=dev))
    # rms_norm on rows whose squares span many binades (their sums are
    # inexact, so a reduction order that follows the row count shows)
    gen = torch.Generator(device=dev).manual_seed(20)
    for D in (1536, 2048, 2560, 3072, 3584, 4096):
        xw = (torch.randn(top, D, generator=gen, device=dev)
              * torch.exp(2 * torch.randn(top, D, generator=gen, device=dev))).to(torch.bfloat16)
        nw_ = torch.rand(D, generator=gen, device=dev) + 0.5
        same_rows(f"rms_norm D={D}, x over many binades", lambda x: rms_norm(x, nw_, 1e-5), xw)
    for k, N, K in (("q4f", MX_FFN, MX_DIM), ("q6f", 2048, 5632)):
        w = _rand_weights(rng, k, N, K, dev)
        same_rows(f"qmm_int8 {k} [{N}, {K}]", lambda x: qmm_int8(x, w, f32), _act(top, K, dev=dev))
    dim, H, Hkv, hd, F = 2048, 32, 4, 64, 5632
    wqk, wv = _rand_weights(rng, "q4", (H + Hkv) * hd, dim, dev), _rand_weights(rng, "q6w",
                                                                               Hkv * hd, dim, dev)
    nw = torch.rand(dim, device=dev) + 0.5
    same_rows("attn_in (TinyLlama)",
              lambda x, c, s_: fused_attn_in(x, nw, 1e-5, wqk, wv, c, s_, hd, None),
              _act(top, dim, 0.5, dev), torch.rand(top, hd // 2, device=dev),
              torch.rand(top, hd // 2, device=dev))
    # attn_in's K split: the kernel's own plan against the host's mirror
    codes = [c for c, (k, _) in enumerate(KINDS) if k in ("q4", "q6w", "q8")]
    plan_bad = [(qc, vc, w) for qc in codes for vc in codes
                for w in ((2304, 256, 2048), (1792, 256, 1536), (5120, 1024, MX_DIM),
                          (6144, 2048, 3584), (6144, 3072, 3072))
                if attn_in_mod.kernel_plan(qc, vc, *w) != attn_in_mod.attn_in_plan(qc, vc, *w)]
    if plan_bad:
        raise SystemExit(f"FAIL: attn_in's kernel split differs from attn_in_plan at (qk code, "
                         f"v code, (n0, n1, D)) {plan_bad[:4]}")
    n += 1
    for label, D_, Hq, Hk, hd_, (kq, kv), biased in (
            ("attn_in (Qwen2.5-1.5B: biases, hd 128)", 1536, 12, 2, 128, ("q4", "q6w"), True),
            ("attn_in (Mixtral-8x7B, f32 scales)", MX_DIM, 32, 8, 128, ("q4f", "q6wf"), False),
            ("attn_in (Q8_0: q8 in both slots)", dim, H, Hkv, hd, ("q8", "q8"), False),
            ("attn_in (Gemma-2B: head_dim 256)", dim, 8, 1, 256, ("q4", "q6w"), False)):
        wq_, wv_ = (_rand_weights(rng, kq, (Hq + Hk) * hd_, D_, dev),
                    _rand_weights(rng, kv, Hk * hd_, D_, dev))
        bias = (torch.randn((Hq + Hk) * hd_, device=dev) * 0.5,
                torch.randn(Hk * hd_, device=dev) * 0.5) if biased else None
        nw_ = torch.rand(D_, device=dev) + 0.5
        same_rows(label, lambda x, c, s_: fused_attn_in(x, nw_, 1e-5, wq_, wv_, c, s_, hd_, bias),
                  _act(top, D_, 0.5, dev), torch.rand(top, hd_ // 2, device=dev),
                  torch.rand(top, hd_ // 2, device=dev))
        del wq_, wv_
    # Phi-3-mini: the two slots of one wqkv at head_dim 96 (the paired map)
    D_, Hq, Hk, hd_, _, _ = PHI3
    wqkv = _rand_weights(rng, "q4", (Hq + 2 * Hk) * hd_, D_, dev)
    sl = attn_in_mod.qkv_slots(wqkv, (Hq + Hk) * hd_)
    nw_ = torch.rand(D_, device=dev) + 0.5
    same_rows("attn_in (Phi-3-mini: wqkv slots, head_dim 96)",
              lambda x, c, s_: fused_attn_in(x, nw_, 1e-5, *sl, c, s_, hd_),
              _act(top, D_, 0.5, dev), torch.rand(top, hd_ // 2, device=dev),
              torch.rand(top, hd_ // 2, device=dev))
    del wqkv, sl
    check_fold_invariance(dev, rng, same_rows)
    # the plain decode attention of the serving cell: rows of 128 slots at
    # TinyLlama's heads, bf16 and int8 KV, the deferred append on and off
    ga = torch.Generator(device=dev).manual_seed(9)
    S_ = 128
    q = torch.randn(top, 1, H, hd, device=dev, generator=ga).to(torch.bfloat16)
    pos = torch.randint(1, S_, (top, 1), device=dev, generator=ga)
    kc, vc = (torch.randn(top, 1, Hkv, hd, device=dev, generator=ga).to(torch.bfloat16)
              for _ in range(2))
    for int8 in (False, True):
        if int8:
            k, v = (torch.randint(-127, 128, (top, Hkv, S_, hd), device=dev, generator=ga,
                                  dtype=torch.int8) for _ in range(2))
            ks, vs = (torch.rand(top, Hkv, S_, device=dev, generator=ga) * 0.02 + 0.001
                      for _ in range(2))
        else:
            k, v = (torch.randn(top, Hkv, S_, hd, device=dev, generator=ga).to(torch.bfloat16)
                    for _ in range(2))
            ks = vs = torch.ones(top, Hkv, S_, device=dev)
        sc = (lambda a, b: (a, b)) if int8 else (lambda a, b: None)  # noqa: E731
        kv = "int8" if int8 else "bf16"
        same_rows(f"plain decode attention, {kv} KV, 128 slots",
                  lambda q_, k_, v_, p_, a, b: attention_decode(q_, k_, v_, p_, sc(a, b)),
                  q, k, v, pos, ks, vs)
        same_rows(f"plain decode attention, {kv} KV, 128 slots, deferred append",
                  lambda q_, k_, v_, p_, a, b, c_, d_: attention_decode(
                      q_, k_, v_, p_, sc(a, b), kv_cur=(c_, d_)),
                  q, k, v, pos, ks, vs, kc, vc)
    # a speculative verify window (engine.step: T = 5 tokens at positions
    # p..p + 4, its rows appended first, each query's own row as kv_cur) on
    # bf16 KV: row t equals the decode step at p + t (the deferred append's
    # cache: rows p..p + t - 1 written, the rest stale), bit for bit
    Tw, Sw = 5, 704
    qw = torch.randn(2, Tw, H, hd, device=dev, generator=ga).to(torch.bfloat16)
    kw_, vw_ = (torch.randn(2, Tw, Hkv, hd, device=dev, generator=ga).to(torch.bfloat16)
                for _ in range(2))
    pw = torch.tensor([[100], [403]], device=dev) + torch.arange(Tw, device=dev)[None, :]
    stale = [torch.randn(2, Hkv, Sw, hd, device=dev, generator=ga).to(torch.bfloat16)
             for _ in range(2)]

    def written(upto):
        out = [t.clone() for t in stale]
        for b in range(2):
            for c, new in zip(out, (kw_, vw_)):
                c[b][:, pw[b, :upto]] = new[b, :upto].transpose(0, 1)
        return out

    kc_, vc_ = written(Tw)
    win = attention_decode(qw, kc_, vc_, pw, None, kv_cur=(kw_, vw_))
    bad = []
    for t in range(Tw):
        kd, vd = written(t)
        dec = attention_decode(qw[:, t:t + 1], kd, vd, pw[:, t:t + 1], None,
                               kv_cur=(kw_[:, t:t + 1], vw_[:, t:t + 1]))
        bad += [t] if not torch.equal(win[:, t:t + 1], dec) else []
    if bad:
        raise SystemExit(f"FAIL: verify window: rows {bad} of a {Tw}-token window differ from "
                         f"the decode step at their positions")
    n += 1
    wo, gu, dn = (_rand_weights(rng, "q6w", dim, H * hd, dev),
                  _rand_weights(rng, "q4", 2 * F, dim, dev), _rand_weights(rng, "q6w", dim, F, dev))
    same_rows("oproj_ffn (TinyLlama)", lambda x, a: fused_oproj_ffn(x, a, wo, nw, 1e-5, gu, dn),
              _act(top, dim, 0.5, dev), _act(top, H * hd, 0.5, dev))
    D_, F_ = 1536, 8960
    gu, dn = _rand_weights(rng, "q4", 2 * F_, D_, dev), _rand_weights(rng, "q6w", D_, F_, dev)
    nw = torch.rand(D_, device=dev) + 0.5
    same_rows("ffn (Qwen2.5-1.5B)", lambda x: fused_ffn(x, nw, 1e-6, gu, dn),
              _act(top, D_, 0.5, dev))

    def same_blocks(label, fn, x, T=64):
        nonlocal n
        got = fn(x)
        bad = [i for i in range(x.shape[0] // T)
               if not torch.equal(got[T * i:T * i + T], fn(x[T * i:T * i + T]))]
        if bad:
            raise SystemExit(f"FAIL: batch invariance: {label}: blocks {bad[:8]} of the "
                             f"{x.shape[0]}-row call differ from the {T}-row calls")
        n += 1

    burst = 16 * 64
    for k, N, K in (("q4", 2304, 2048), ("q6w", 256, 2048), ("q6w", 2048, 2048),
                    ("q4", 11264, 2048), ("q6w", 2048, 5632), ("q6w", 32000, 2048),
                    *((kind + ("f" if side == "f32" else ""), 2304, 2048)
                      for kind, side in KINDS[2:])):
        w = _rand_weights(rng, k, N, K, dev)
        same_blocks(f"qmm tile {k} [{N}, {K}]", lambda x: qmm(x, w), _act(burst, K, dev=dev))
    g = torch.Generator(device=dev).manual_seed(5)
    for (H, Hkv, D), int8 in ((TINY_HEADS, False), (TINY_HEADS, True), (QWEN_HEADS, False),
                              (QWEN_HEADS, True)):
        B, S = 1024, 2048
        q = torch.randn(B, 1, H, D, device=dev, generator=g).to(torch.bfloat16)
        if int8:
            k, v = (torch.randint(-127, 128, (B, Hkv, S, D), device=dev, generator=g,
                                  dtype=torch.int8) for _ in range(2))
            scales = tuple(torch.rand(B, Hkv, S, device=dev, generator=g) * 0.02 + 0.001
                           for _ in range(2))
        else:
            k, v = (torch.randn(B, Hkv, S, D, device=dev, generator=g).to(torch.bfloat16)
                    for _ in range(2))
            scales = None
        qp = torch.randint(0, S, (B, 1), device=dev, generator=g)
        qp[:4, 0] = torch.tensor([63, 64, 2047, 0], device=dev)

        def rows(lo, hi):
            sc = None if scales is None else tuple(t[lo:hi] for t in scales)
            return attention_decode_flash(q[lo:hi], k[lo:hi], v[lo:hi], qp[lo:hi], sc)

        full, sixteen = rows(0, B), rows(0, 16)
        bad = [b for b in sorted(set(range(16)) | set(range(16, B, 61)))
               if not (torch.equal(full[b:b + 1], rows(b, b + 1))
                       and (b >= 16 or torch.equal(sixteen[b:b + 1], full[b:b + 1])))]
        if bad:
            raise SystemExit(f"FAIL: batch invariance: flash decode {H}/{Hkv} heads of {D} "
                             f"{'int8' if int8 else 'bf16'}: rows {bad[:8]} at B = 16 or 1024 "
                             f"differ from the row alone")
        n += 1
        del q, k, v, scales
        torch.cuda.empty_cache()
    # flash decode at head_dim 256 (Gemma-2B's heads): rows of B = 16 and 64
    # on 4096 slots against the row alone, bf16 and int8 KV
    for int8 in (False, True):
        (H, Hkv, D), B, S = GEMMA_HEADS, 64, 4096
        q = torch.randn(B, 1, H, D, device=dev, generator=g).to(torch.bfloat16)
        if int8:
            k, v = (torch.randint(-127, 128, (B, Hkv, S, D), device=dev, generator=g,
                                  dtype=torch.int8) for _ in range(2))
            scales = tuple(torch.rand(B, Hkv, S, device=dev, generator=g) * 0.02 + 0.001
                           for _ in range(2))
        else:
            k, v = (torch.randn(B, Hkv, S, D, device=dev, generator=g).to(torch.bfloat16)
                    for _ in range(2))
            scales = None
        qp = torch.randint(0, S, (B, 1), device=dev, generator=g)
        qp[:4, 0] = torch.tensor([63, 64, S - 1, 0], device=dev)

        def rows(lo, hi):
            sc = None if scales is None else tuple(t[lo:hi] for t in scales)
            return attention_decode_flash(q[lo:hi], k[lo:hi], v[lo:hi], qp[lo:hi], sc)

        full, sixteen = rows(0, B), rows(0, 16)
        bad = [b for b in range(B) if not (torch.equal(full[b:b + 1], rows(b, b + 1))
                                           and (b >= 16 or torch.equal(sixteen[b:b + 1],
                                                                       full[b:b + 1])))]
        if bad:
            raise SystemExit(f"FAIL: batch invariance: flash decode {H}/{Hkv} heads of {D} "
                             f"{'int8' if int8 else 'bf16'}: rows {bad[:8]} at B = 16 or {B} "
                             f"differ from the row alone")
        n += 1
        del q, k, v, scales
        torch.cuda.empty_cache()
    n += check_fused_invariance(dev, rng)
    log(f"  batch invariance: {n} cases (qmm at every kind code, qmm_int8, attn_in at TinyLlama, "
        f"Qwen2.5, Mixtral f32, Q8_0, Gemma-2B's head_dim 256 and Phi-3-mini's wqkv slots at "
        f"head_dim 96 and its split plan, oproj_ffn, "
        f"ffn, the plain decode attention): every row at R in {INVARIANCE_ROWS} equals the row "
        f"computed alone; the rows of a 5-token verify window equal the decode steps at their "
        f"positions; qmm's tile: every 64-row block of a 16 x 64 burst equals its 64-row "
        f"call; flash decode: rows at B = 16 and 1024 (head_dim 256: 16 and 64) equal the row "
        f"alone; attn_out at B = 16 and layer at B = 4, ragged positions: every row equals the "
        f"row alone (torch.equal)")
    return n


def check_fold_invariance(dev, rng, same_rows) -> None:
    """check_batch_invariance's folded cases: the int8 folds of attn_in
    (Llama-3-8B), oproj_ffn (TinyLlama, wo q6w and q4) and ffn (TinyLlama,
    Qwen2.5-1.5B on f32 scales). Each row's 32-groups are quantized alone,
    so a folded row is the row alone bit for bit (the manual variants off,
    so that every row count folds). `same_rows(label, fn, *xs)`: the check."""
    import torch

    from tpu_kquant_torch.ops.attn_in import fused_attn_in
    from tpu_kquant_torch.ops.ffn import fused_ffn, fused_oproj_ffn

    top = max(INVARIANCE_ROWS)
    (dim, F), (qd, qf) = FOLD_TINY, FOLD_QWEN
    with switches({"TKQ_INT8_FOLDS": "1", "TKQ_MANUAL_ATTN_IN": "0", "TKQ_MANUAL_OPROJ": "0"}):
        wq_, wv_ = (_rand_weights(rng, "q4", (L3_H + L3_HKV) * L3_HD, L3_DIM, dev),
                    _rand_weights(rng, "q6w", L3_HKV * L3_HD, L3_DIM, dev))
        nw_ = torch.rand(L3_DIM, device=dev) + 0.5
        same_rows("attn_in folded (Llama-3-8B: wqk q4-sm, wv q6w-sp)",
                  lambda x, c, s_: fused_attn_in(x, nw_, 1e-5, wq_, wv_, c, s_, L3_HD),
                  _act(top, L3_DIM, 0.5, dev), torch.rand(top, L3_HD // 2, device=dev),
                  torch.rand(top, L3_HD // 2, device=dev))
        del wq_, wv_
        gu_, dn_ = _rand_weights(rng, "q4", 2 * F, dim, dev), _rand_weights(rng, "q6w", dim, F,
                                                                            dev)
        nw = torch.rand(dim, device=dev) + 0.5
        for ko in ("q6w", "q4"):
            wo_ = _rand_weights(rng, ko, dim, dim, dev)
            same_rows(f"oproj_ffn folded (TinyLlama: wo {ko}, w_gateup q4-sm)",
                      lambda x, a: fused_oproj_ffn(x, a, wo_, nw, 1e-5, gu_, dn_),
                      _act(top, dim, 0.5, dev), _act(top, dim, 0.5, dev))
        same_rows("ffn folded (TinyLlama: w_gateup q4-sm)",
                  lambda x: fused_ffn(x, nw, 1e-5, gu_, dn_), _act(top, dim, 0.5, dev))
        wf = (_rand_weights(rng, "q4f", 2 * qf, qd, dev), _rand_weights(rng, "q6w", qd, qf, dev))
        nw_ = torch.rand(qd, device=dev) + 0.5
        same_rows("ffn folded (Qwen2.5-1.5B: w_gateup q4-f32)",
                  lambda x: fused_ffn(x, nw_, 1e-6, *wf), _act(top, qd, 0.5, dev))


def check_fused_invariance(dev, rng) -> int:
    """The opt-in fusions' paths (b) and (c) at TinyLlama's shapes and
    ragged positions: attn_out (#10) at B = 16 on bf16 and int8 KV (its
    output and head outputs), layer (#11) at B = 4 on f32 scales (y, k_new,
    v_new and the head outputs) on 704 and 2048 slots; each row of the call
    must equal, bit for bit, that row computed alone. Fatal; returns the
    number of cases checked."""
    import torch

    from tpu_kquant_torch.models.config import RopeParams
    from tpu_kquant_torch.ops.attn_out import fused_attn_out
    from tpu_kquant_torch.ops.layer import fused_layer
    from tpu_kquant_torch.ops.rope import rope_cos_sin

    n = 0

    def same_as_alone(label, fn, B, *xs):
        nonlocal n
        full = fn(*(x[:B] for x in xs))
        bad = [r for r in range(B) if not all(
            torch.equal(a[r:r + 1], o) for a, o in zip(full, fn(*(x[r:r + 1] for x in xs))))]
        if bad:
            raise SystemExit(f"FAIL: batch invariance: {label}: rows {bad[:8]} of B = {B} differ "
                             f"from the row alone")
        n += 1

    dim, (H, Hkv, hd), F = 2048, TINY_HEADS, 5632
    g = torch.Generator(device=dev).manual_seed(6)
    S_ = FUSED_S
    ragged = torch.tensor([1, 255, 256, 700, 0, 63, 64, 703] + [40 + 41 * i for i in range(8)],
                          device=dev)[:, None]
    wo = _rand_weights(rng, "q6wf", dim, H * hd, dev)
    x16 = torch.randn(16, 1, dim, device=dev, generator=g).to(torch.bfloat16)
    q16 = torch.randn(16, 1, H, hd, device=dev, generator=g).to(torch.bfloat16)
    for int8 in (False, True):
        if int8:
            k, v = (torch.randint(-127, 128, (16, Hkv, S_, hd), device=dev, generator=g,
                                  dtype=torch.int8) for _ in range(2))
            ks, vs = (torch.rand(16, Hkv, S_, device=dev, generator=g) * 0.02 + 0.001
                      for _ in range(2))
        else:
            k, v = (torch.randn(16, Hkv, S_, hd, device=dev, generator=g).to(torch.bfloat16)
                    for _ in range(2))
            ks = vs = torch.ones(16, Hkv, S_, device=dev)

        def attn_out(x_, q_, k_, v_, p_, a, b, int8=int8):
            att = torch.empty(x_.shape[0], H * hd, dtype=torch.bfloat16, device=dev)
            return fused_attn_out(x_, q_, k_, v_, p_, (a, b) if int8 else None, wo, att=att), att

        same_as_alone(f"attn_out (TinyLlama, {'int8' if int8 else 'bf16'} KV, {S_} slots)",
                      attn_out, 16, x16, q16, k, v, ragged, ks, vs)
        del k, v, ks, vs
    lw = [_rand_weights(rng, k_, N, K, dev) for k_, N, K in (
        ("q4f", (H + Hkv) * hd, dim), ("q6wf", Hkv * hd, dim), ("q6wf", dim, H * hd),
        ("q4f", 2 * F, dim), ("q6wf", dim, F))]
    anw, fnw = (torch.rand(dim, device=dev, generator=g) + 0.5 for _ in range(2))
    for positions, S_ in (((1, 255, 256, 700), FUSED_S), ((64, 1000, 1500, 2047), 2048)):
        pos = torch.tensor(positions, device=dev)[:, None]
        cos, sin = rope_cos_sin(pos, RopeParams(head_dim=hd, n_rot=hd))
        x4 = (torch.randn(4, 1, dim, device=dev, generator=g) * 0.5).to(torch.bfloat16)
        kc, vc = (torch.randn(4, Hkv, S_, hd, device=dev, generator=g).to(torch.bfloat16)
                  for _ in range(2))

        def layer(x_, p_, c_, s_, k_, v_):
            att = torch.empty(x_.shape[0], H * hd, dtype=torch.bfloat16, device=dev)
            return (*fused_layer(x_, p_, anw, fnw, 1e-5, *lw, c_, s_, k_, v_, H, Hkv, att=att),
                    att)

        same_as_alone(f"layer (TinyLlama, f32 scales, positions {list(positions)}, {S_} slots)",
                      layer, 4, x4, pos, cos, sin, kc, vc)
        del kc, vc
    del lw, wo
    return n


def report_cases(out: dict) -> None:
    """Log each phase 3 case and raise where a kernel disagrees with its
    plain version beyond its tolerance."""
    for name, cases in out.items():
        for c in cases:
            lib = c["library_ms"] if c["library_ms"] is not None else c["matmul_ms"]
            log(f"  {name:9s} {c['case']:52s} rel err {c['rel_err']:.2e}  kernel "
                f"{c['ms'] * 1e3:8.1f} us (eager {c['eager_ms'] * 1e3:7.1f})  plain "
                f"{c['plain_ms'] * 1e3:8.1f} us  "
                f"{'library' if c['library_ms'] is not None else 'matmuls'} "
                f"{lib * 1e3:8.1f} us  bound {c['bound_ms'] * 1e3:8.2f} us ({c['bound_by']})")
            if "global_rel_err" in c:
                log(f"  {'':9s} rel err per row {c['rel_err']:.2e}, of the whole max|ref| "
                    f"{c['global_rel_err']:.2e}; SDPA per row {c['library_rel_err']:.2e}")
            if "att_rel_err" in c:
                log(f"  {'':9s} attention phase per head row {c['att_rel_err']:.2e} "
                    f"({c['att_splits']})")
            tol = c.get("tol", TOL)
            if not math.isfinite(c["rel_err"]) or c["rel_err"] > tol:
                raise SystemExit(f"FAIL: {name} {c['case']} disagrees with its plain "
                                 f"version: {c['rel_err']:.3e} > {tol}")




def check_qmm_int8(dev, rng) -> list:
    """qmm_int8 against its plain version at Mixtral's decode shapes (expert
    gate/up [14336, 4096] at R = 1, 8, 16; the router [8, 4096] at R = 1)
    and, for the q6 branch, at TinyLlama's down [2048, 5632] and lm head
    [32000, 2048] (R = 1, 8, 16), its f32 output held to INT8_TOL of max|ref|
    and its output in the main path's dtype to the f32 output rounded; timed
    in the main path's dtype (gate/up and down bf16, the router and lm head
    f32); first the kernel's activation quantization (32- and 16-groups)
    against ops.act_quant byte for byte, ties at .5 and all-zero groups
    included. Library yardstick: torch.matmul on the dequantized bf16
    weight."""
    import torch

    from tpu_kquant_torch.ops.act_quant import quantize_activations
    from tpu_kquant_torch.ops.qmm_int8 import qmm_int8, qmm_int8_plain, quantize_q8
    from tpu_kquant_torch.quant.codecs import dequant_kmajor

    x = (torch.randn(16, MX_DIM, device=dev) * 2).to(torch.bfloat16)
    x[0, :32] = 0
    x[1, 32:64] = torch.tensor([127.0, 2.5, -2.5, 0.5, 1.5, -0.5, -1.5, 3.5] * 4, device=dev)
    for got, want in zip(quantize_q8(x), quantize_activations(x)):
        if not torch.equal(got.view(torch.uint8), want.view(torch.uint8)):
            raise SystemExit("FAIL: the qmm_int8 kernel's activation quantization differs from "
                             "ops.act_quant.quantize_activations")
    x[2, :16] = 0  # a zero 16-group of q6's quantization
    for got, want in zip(quantize_q8(x, 16), quantize_activations(x, 16)):
        if not torch.equal(got.view(torch.uint8), want.view(torch.uint8)):
            raise SystemExit("FAIL: the qmm_int8 kernel's 16-group activation quantization "
                             "differs from ops.act_quant.quantize_activations")
    log("  qmm_int8  activation quantization: byte-equal to quantize_activations (R=16, K=4096, "
        "groups 32 and 16)")
    cases = []
    for label, kind, N, K, R, odt in (
            ("mixtral: expert gate/up q4-f32 R=1", "q4f", MX_FFN, MX_DIM, 1, torch.bfloat16),
            ("mixtral: expert gate/up q4-f32 R=8", "q4f", MX_FFN, MX_DIM, 8, torch.bfloat16),
            ("mixtral: expert gate/up q4-f32 R=16", "q4f", MX_FFN, MX_DIM, 16, torch.bfloat16),
            ("mixtral: expert gate/up q4-f32 R=32", "q4f", MX_FFN, MX_DIM, 32, torch.bfloat16),
            ("mixtral: router q4-f32 N=8 R=1", "q4f", 8, MX_DIM, 1, torch.float32),
            # phase 9's Q4_K_M with widen_q6=False on f32 scales: the q6 branch
            # at TinyLlama's down and lm head
            *((f"q6-f32 {what} R={R}", "q6f", N, K, R, odt)
              for what, N, K, odt in (("down", 2048, 5632, torch.bfloat16),
                                      ("lm head", 32000, 2048, torch.float32))
              for R in (1, 8, 16, 32))):
        w0 = _rand_weights(rng, kind, N, K, dev)
        ws = _rotation(w0, w0.n_bytes)
        xr = torch.randn(R, K, device=dev).to(torch.bfloat16)
        # held in f32: one bf16 rounding of an output moves it by up to 2^-8
        got = qmm_int8(xr, w0, torch.float32)
        got_main = qmm_int8(xr, w0, odt)
        torch.cuda.synchronize()
        if not torch.equal(got_main, got.to(odt)):
            raise SystemExit(f"FAIL: qmm_int8 {label}: its {odt} output is not its f32 output "
                             f"rounded")
        ad, rel = _err(got, qmm_int8_plain(xr, w0, torch.float32))
        wd = [dequant_kmajor(w, torch.bfloat16).contiguous() for w in ws]
        nb = w0.n_bytes + xr.numel() * 2 + R * N * got_main.element_size()
        b, by = bound_ms(nb, 2.0 * R * K * N, INT8_OPS)
        cases.append({
            "case": label, "max_abs_err": ad, "rel_err": rel, "tol": INT8_TOL,
            "ms": graph_ms(lambda i: qmm_int8(xr, ws[i % len(ws)], odt), 40),
            "eager_ms": time_ms(lambda i: qmm_int8(xr, ws[i % len(ws)], odt), 40),
            "plain_ms": graph_ms(lambda i: qmm_int8_plain(xr, w0, odt), 4, reps=3),
            "library_ms": graph_ms(lambda i: torch.matmul(xr, wd[i % len(wd)]), 40),
            "bound_ms": b, "bound_by": by})
        del ws, wd
    return cases


# flash prefill at TinyLlama's heads (32 / 4 of 64, bf16 q; the serving
# cell's 1024-request burst of 64-token prompts among them) and at
# Qwen2.5-1.5B's (12 / 2 of 128, f32 q: bf16 + f32 bias; a ragged T with a
# window on int8 KV):
# (label, B, T, S, q_starts, int8 KV, window, (H, Hkv, D), q dtype)
TINY_HEADS, QWEN_HEADS = (32, 4, 64), (12, 2, 128)
GEMMA_HEADS = (8, 1, 256)  # Gemma-2B's query and KV heads of 256
PREFILL_CASES = (
    ("T=S=2048 bf16 (pp2048 layer)", 1, 2048, 2048, [0], False, 0, TINY_HEADS, "bfloat16"),
    ("T=S=2048 int8 (pp2048 layer)", 1, 2048, 2048, [0], True, 0, TINY_HEADS, "bfloat16"),
    ("T=256 S=2240 q_start 1024 bf16", 1, 256, 2240, [1024], False, 0, TINY_HEADS, "bfloat16"),
    ("T=512 S=2048 q_start 1024 window 300 int8", 1, 512, 2048, [1024], True, 300, TINY_HEADS,
     "bfloat16"),
    ("B=3 T=40 S=320 q_start 0/100/200 bf16", 3, 40, 320, [0, 100, 200], False, 0, TINY_HEADS,
     "bfloat16"),
    ("qwen2.5-1.5b: f32 q, hd 128, GQA 6, T=S=2048 bf16", 1, 2048, 2048, [0], False, 0,
     QWEN_HEADS, "float32"),
    ("B=1024 T=S=64 bf16 (1024-request burst)", 1024, 64, 64, [0] * 1024, False, 0,
     TINY_HEADS, "bfloat16"),
    ("B=1024 T=S=64 int8 (1024-request burst)", 1024, 64, 64, [0] * 1024, True, 0,
     TINY_HEADS, "bfloat16"),
    ("qwen2.5-1.5b: f32 q, hd 128, GQA 6, B=2 T=72 S=384 q_start 100/248 window 96 int8", 2,
     72, 384, [100, 248], True, 96, QWEN_HEADS, "float32"),
    # head_dim 256: Gemma-2B's 3000-token request is bucket 4096
    ("gemma-2b: hd 256, 8 / 1 heads, T=S=4096 bf16", 1, 4096, 4096, [0], False, 0,
     GEMMA_HEADS, "bfloat16"),
    ("gemma-2b: hd 256, 8 / 1 heads, T=S=4096 int8", 1, 4096, 4096, [0], True, 0,
     GEMMA_HEADS, "bfloat16"),
    ("gemma-2b: hd 256, B=2 T=200 S=4352 q_start 1000/3900 window 512 int8", 2, 200, 4352,
     [1000, 3900], True, 512, GEMMA_HEADS, "bfloat16"),
)


def prefill_work(B, T, S, H, Hkv, D, starts, window, kv_bytes,
                 q_bytes: int = 2) -> tuple[float, float]:
    """(bytes, flops) the flash prefill needs for these inputs: q and the
    output once (`q_bytes` per element each), the cache slots some query
    attends once (`kv_bytes` per slot and head, scales included), and 4 D
    flops per head for every unmasked (query, slot) pair."""
    import numpy as np

    pairs, n_bytes = 0, 2 * q_bytes * B * T * H * D
    for qs in starts:
        pos = qs + np.arange(T)
        lo = np.maximum(pos - window + 1, 0) if window > 0 else np.zeros_like(pos)
        pairs += int(np.maximum(np.minimum(pos, S - 1) - lo + 1, 0).sum())
        first = max(qs - window + 1, 0) if window > 0 else 0
        n_bytes += 2 * Hkv * (min(qs + T - 1, S - 1) - first + 1) * kv_bytes
    return float(n_bytes), 4.0 * pairs * H * D


def check_prefill(dev) -> list:
    """The flash prefill kernel against its plain version (and SDPA as the
    library yardstick) at the PREFILL_CASES. K/V are strided views of a
    2-layer cache with 64 spare slots, as the llama path hands them over."""
    import torch
    import torch.nn.functional as F

    from tpu_kquant_torch.ops.prefill import attention_prefill, attention_prefill_plain

    g = torch.Generator(device=dev).manual_seed(0)
    cases = []
    for label, B, T, S, starts, int8, window, (H, Hkv, D), q_dtype in PREFILL_CASES:
        q = torch.randn(B, T, H, D, device=dev, generator=g).to(getattr(torch, q_dtype))
        shape = (2, B, Hkv, S + 64, D)
        if int8:
            kc, vc = (torch.randint(-127, 128, shape, device=dev, generator=g,
                                    dtype=torch.int8) for _ in range(2))
            ksc, vsc = (torch.rand(shape[:-1], device=dev, generator=g) * 0.02 + 0.001
                        for _ in range(2))
            scales = (ksc[1, :, :, :S], vsc[1, :, :, :S])
        else:
            kc, vc = (torch.randn(shape, device=dev, generator=g).to(torch.bfloat16)
                      for _ in range(2))
            scales = None
        k, v = kc[1, :, :, :S], vc[1, :, :, :S]
        qs = torch.tensor(starts, device=dev)
        args = (q, k, v, qs, scales)
        got = attention_prefill(*args, sliding_window=window)
        torch.cuda.synchronize()
        ref = attention_prefill_plain(*args, sliding_window=window)
        ad, glob = _err(got, ref)
        rel = row_rel_err(got, ref)
        # the library yardstick: SDPA on bf16 [B, H, T, D] (dequantized for
        # int8); causal flag where the mask is plain causal, else the mask
        kb, vb = k, v
        if int8:
            kb = (k.float() * scales[0][..., None]).to(torch.bfloat16)
            vb = (v.float() * scales[1][..., None]).to(torch.bfloat16)
        qt = q.transpose(1, 2).to(torch.bfloat16)
        if T == S and window == 0 and not any(starts):
            sdpa = lambda i: F.scaled_dot_product_attention(  # noqa: E731
                qt, kb, vb, is_causal=True, enable_gqa=True)
        else:
            pos = qs[:, None] + torch.arange(T, device=dev)
            kv = torch.arange(S, device=dev)
            m = kv[None, None, :] <= pos[:, :, None]
            if window > 0:
                m &= kv[None, None, :] > pos[:, :, None] - window
            m = m[:, None]
            sdpa = lambda i: F.scaled_dot_product_attention(  # noqa: E731
                qt, kb, vb, attn_mask=m, enable_gqa=True)
        lib_err = row_rel_err(sdpa(0).transpose(1, 2), ref)
        nb, fl = prefill_work(B, T, S, H, Hkv, D, starts, window,
                              D * k.element_size() + (4 if int8 else 0), q.element_size())
        b, by = bound_ms(nb, fl)
        run = lambda i: attention_prefill(*args, sliding_window=window)  # noqa: E731
        cases.append({
            "case": label, "max_abs_err": ad, "rel_err": rel, "global_rel_err": glob,
            "library_rel_err": lib_err,
            "ms": graph_ms(run, 20), "eager_ms": time_ms(run, 20),
            "plain_ms": graph_ms(lambda i: attention_prefill_plain(
                *args, sliding_window=window), 2, reps=3),
            "library_ms": graph_ms(sdpa, 20), "bound_ms": b, "bound_by": by,
            "bytes": nb, "flops": fl})
        del ref, got
        torch.cuda.empty_cache()
    return cases


# flash decode (#7) at the serving cell (1024 slots of 2048, TinyLlama's
# heads) with the cell's positions (32-111: prompts of 32-63 tokens and 48
# new ones) and with positions uniform over the context, on bf16 and int8
# KV; then head_dim 128 at Qwen2.5-1.5B's and Mixtral-8x7B's heads:
# (label, B, S, (H, Hkv, D), positions, int8 KV)
DECODE_CASES = (
    ("B=1024 S=2048 bf16, positions 32-111 (serving cell)", 1024, 2048, TINY_HEADS, (32, 112),
     False),
    ("B=1024 S=2048 int8, positions 32-111 (serving cell)", 1024, 2048, TINY_HEADS, (32, 112),
     True),
    ("B=1024 S=2048 bf16, positions 0-2047", 1024, 2048, TINY_HEADS, (0, 2048), False),
    ("B=1024 S=2048 int8, positions 0-2047", 1024, 2048, TINY_HEADS, (0, 2048), True),
    ("qwen2.5-1.5b: hd 128, 12 / 2 heads, B=128 S=2048 bf16", 128, 2048, QWEN_HEADS, (0, 2048),
     False),
    ("mixtral: hd 128, 32 / 8 heads, B=64 S=2048 int8", 64, 2048, (32, 8, 128), (0, 2048), True),
    # head_dim 256 at Gemma-2B's heads, ragged positions over its 8192 context
    ("gemma-2b: hd 256, 8 / 1 heads, B=16 S=8192 bf16, positions 0-8191", 16, 8192,
     GEMMA_HEADS, (0, 8192), False),
    ("gemma-2b: hd 256, 8 / 1 heads, B=16 S=8192 int8, positions 0-8191", 16, 8192,
     GEMMA_HEADS, (0, 8192), True),
)


def decode_work(qp, H, Hkv, D, kv_bytes) -> tuple[float, float]:
    """(bytes, flops) the flash decode needs: q and the output once (bf16),
    the positions, the live cache slots (0..q_pos of each row) once
    (`kv_bytes` per slot and KV head, K and V and their scales), and 4 D
    flops per query head and live slot."""
    live = float((qp.long() + 1).sum().item())
    B = qp.shape[0]
    return 2 * 2.0 * B * H * D + 4 * B + live * Hkv * kv_bytes, 4.0 * live * H * D


def check_decode_attn(dev) -> list:
    """The flash decode kernel against its plain version (and SDPA as the
    library yardstick) at the DECODE_CASES. q is sliced from a qk row as the
    unfused projection leaves it; K/V are strided views of a 2-layer cache."""
    import torch
    import torch.nn.functional as F

    from tpu_kquant_torch.ops.decode_attention import (
        attention_decode_flash,
        decode_attention_plain,
    )

    g = torch.Generator(device=dev).manual_seed(1)
    cases = []
    for label, B, S, (H, Hkv, D), (lo, hi), int8 in DECODE_CASES:
        qk = torch.randn(B, 1, (H + Hkv) * D, device=dev, generator=g).to(torch.bfloat16)
        q = qk[..., : H * D].reshape(B, 1, H, D)
        shape = (2, B, Hkv, S, D)
        if int8:
            kc, vc = (torch.randint(-127, 128, shape, device=dev, generator=g, dtype=torch.int8)
                      for _ in range(2))
            ksc, vsc = (torch.rand(shape[:-1], device=dev, generator=g) * 0.02 + 0.001
                        for _ in range(2))
            scales = (ksc[1], vsc[1])
        else:
            kc, vc = (torch.randn(shape, device=dev, generator=g).to(torch.bfloat16)
                      for _ in range(2))
            scales = None
        k, v = kc[1], vc[1]
        qp = torch.randint(lo, hi, (B, 1), device=dev, generator=g)
        args = (q, k, v, qp, scales)
        got = attention_decode_flash(*args)
        torch.cuda.synchronize()
        ref = decode_attention_plain(*args)
        ad, glob = _err(got, ref)
        rel = row_rel_err(got, ref)
        kb, vb = k, v
        if int8:
            kb = (k.float() * scales[0][..., None]).to(torch.bfloat16)
            vb = (v.float() * scales[1][..., None]).to(torch.bfloat16)
        mask = (torch.arange(S, device=dev)[None, :] <= qp)[:, None, None, :]
        qt = q.transpose(1, 2)
        sdpa = lambda i: F.scaled_dot_product_attention(  # noqa: E731
            qt, kb, vb, attn_mask=mask, enable_gqa=True)
        lib_err = row_rel_err(sdpa(0).transpose(1, 2), ref)
        nb, fl = decode_work(qp, H, Hkv, D, 2 * (D * k.element_size() + (4 if int8 else 0)))
        b, by = bound_ms(nb, fl)
        run = lambda i: attention_decode_flash(*args)  # noqa: E731
        cases.append({
            "case": label, "max_abs_err": ad, "rel_err": rel, "global_rel_err": glob,
            "library_rel_err": lib_err,
            "ms": graph_ms(run, 20), "eager_ms": time_ms(run, 20),
            "plain_ms": graph_ms(lambda i: decode_attention_plain(*args), 2, reps=3),
            "library_ms": graph_ms(sdpa, 20), "bound_ms": b, "bound_by": by,
            "bytes": nb, "flops": fl})
        del ref, got, kc, vc, kb, vb
        torch.cuda.empty_cache()
    return cases


# the reference's opt-in decode fusions at TinyLlama's shapes on a 704-slot
# cache (phase 4's requests; phase 10's paths): attn_out (label, B,
# position, int8 KV, wo kind), the first case the headline of the kernels'
# line (path (c): bf16 KV, q6w-f32 wo)
ATTN_OUT_CASES = (
    ("B=1 pos 700 bf16 KV, wo q6w-f32", 1, 700, False, "q6wf"),
    ("B=1 pos 40 bf16 KV, wo q6w-f32", 1, 40, False, "q6wf"),
    ("B=16 pos 700 int8 KV, wo q6w-f32", 16, 700, True, "q6wf"),
    ("B=16 pos 40 int8 KV, wo q6w-f32", 16, 40, True, "q6wf"),
    ("B=1 pos 700 bf16 KV, wo q8-f32", 1, 700, False, "q8f"),
    ("B=16 pos 40 int8 KV, wo q8-f32", 16, 40, True, "q8f"),
    ("B=1 pos 40 int8 KV, wo q4-sm", 1, 40, True, "q4"),
    ("B=16 pos 700 bf16 KV, wo q4-sm", 16, 700, False, "q4"),
)
FUSED_S = 704
# layer (f32 scales, path (b)): the rows' positions and the cache's slots;
# the last case splits the attention into 8 splits of 4 tiles
LAYER_CASES = (((700,), FUSED_S), ((0,), FUSED_S), ((1,), FUSED_S), ((255,), FUSED_S),
               ((256,), FUSED_S), ((0, 255, 256, 700), FUSED_S), ((1, 255, 256, 700), FUSED_S),
               ((64, 1000, 1500, 2047), 2048))


def _splits_note(S: int) -> str:
    """The attention phase's split over S at these shapes, for the log."""
    from tpu_kquant_torch.ops import decode_attention as da

    if not hasattr(da, "fused_attn_plan"):  # an older package (tools/tile_ab.py --root)
        return "the timed package's own split"
    tps, n = da.fused_attn_plan(S)
    return f"{n} split{'s' if n > 1 else ''} of {tps} tile{'s' if tps > 1 else ''}, one cluster"


def attention_phase_case(label: str, q, k, v, qp, scales=None, kv_cur=None) -> dict:
    """The attention phase of attn_out / layer alone (ops/decode_attention.py:
    fused_attention) against its plain version, per (row, head): graph and
    eager ms, the plain version, SDPA with GQA as the library call (int8 K/V
    dequantized to bf16 and, with the current token, the cache with slot
    q_pos holding it, both outside the timed call), and the bound of the
    live cache slots, q, the current token and the head outputs."""
    import torch
    import torch.nn.functional as F

    from tpu_kquant_torch.ops import decode_attention as da

    B, H, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    got = da.fused_attention(q, k, v, qp, scales, kv_cur)
    torch.cuda.synchronize()
    if kv_cur is None:
        plain = lambda i: da.decode_attention_plain(q[:, None], k, v, qp, scales)  # noqa: E731
        live = float((qp.long() + 1).sum().item())
        kb, vb = k, v
        if scales is not None:
            kb = (k.float() * scales[0][..., None]).to(torch.bfloat16)
            vb = (v.float() * scales[1][..., None]).to(torch.bfloat16)
        extra = 0.0
    else:
        plain = lambda i: da.attend_with_current(q, k, v, qp, *kv_cur)  # noqa: E731
        live = float(qp.long().sum().item())
        rows = torch.arange(B, device=q.device)
        kb, vb = k.clone(), v.clone()
        kb[rows, :, qp[:, 0]] = kv_cur[0]
        vb[rows, :, qp[:, 0]] = kv_cur[1]
        extra = 2.0 * 2 * B * Hkv * D
    ref = plain(0).reshape(B, H, D)
    kv_bytes = 2 * (D * k.element_size() + (4 if scales is not None else 0))
    nb = 2 * 2.0 * B * H * D + 4 * B + live * Hkv * kv_bytes + extra
    b, by = bound_ms(nb, 4.0 * (live + (B if kv_cur is not None else 0)) * H * D)
    mask = (torch.arange(S, device=q.device)[None, :] <= qp)[:, None, None, :]
    sdpa = lambda i: F.scaled_dot_product_attention(  # noqa: E731
        q[:, :, None], kb, vb, attn_mask=mask, enable_gqa=True)
    run = lambda i: da.fused_attention(q, k, v, qp, scales, kv_cur)  # noqa: E731
    out = {"case": f"attention phase alone: {label}",
           "max_abs_err": _err(got.reshape(B, H, D), ref)[0],
           "rel_err": row_rel_err(got.reshape(B, H, D), ref),
           "library_rel_err": row_rel_err(sdpa(0).reshape(B, H, D), ref),
           "ms": graph_ms(run, 32), "eager_ms": time_ms(run, 32),
           "plain_ms": graph_ms(plain, 4, 3), "library_ms": graph_ms(sdpa, 32),
           "bound_ms": b, "bound_by": by, "att_splits": _splits_note(S)}
    del kb, vb
    return out


def check_fused_decode(dev, rng) -> dict:
    """kv_append, attn_out, layer and rot against their plain versions at
    TinyLlama's shapes, with the timings of check_kernels: kv_append at B =
    1 and 32 on 704 and 2048 slots (library_ms: the port's two index_put_
    writes of the same rows); attn_out at ATTN_OUT_CASES, layer at
    LAYER_CASES and rot at R = 1 and 8 on bf16 pairs and f32 scales
    (library_ms null; matmul_ms the matmuls inside, on pre-dequantized bf16
    weights). The outputs are held per output row (row_rel_err), layer's
    k_new / v_new too, and so is the attention phase of attn_out and layer
    on its own: its bf16 head outputs (the kernels' scratch, through the
    wrappers' `att`) against the plain attention, per (row, head). After
    each kernel's fused cases, the attention phase alone
    (attention_phase_case) at each of attn_out's (B, positions, KV dtype)
    and at each LAYER_CASES case."""
    import torch

    from tpu_kquant_torch.models.config import RopeParams
    from tpu_kquant_torch.ops import decode_attention as decode_attention_mod
    from tpu_kquant_torch.ops.attn_out import attn_out_plain, attn_out_supported, fused_attn_out
    from tpu_kquant_torch.ops.kv_append import kv_append, kv_append_plain
    from tpu_kquant_torch.ops.layer import fused_layer, layer_plain, layer_supported
    from tpu_kquant_torch.ops.rope import rope_cos_sin
    from tpu_kquant_torch.ops.rot import fused_oproj_ffn_attn_in, rot_plain, rot_supported
    from tpu_kquant_torch.quant.codecs import dequant_kmajor

    dim, (H, Hkv, hd), F = 2048, TINY_HEADS, 5632
    n0, n1 = (H + Hkv) * hd, Hkv * hd
    g = torch.Generator(device=dev).manual_seed(7)
    out: dict = {"kv_append": [], "attn_out": [], "layer": [], "rot": []}

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, device=dev, generator=g) * scale).to(torch.bfloat16)

    def deq(ws):
        return [dequant_kmajor(w, torch.bfloat16).contiguous() for w in ws]

    # kv_append: a decode step's rows into layer 2 of a 3-layer cache
    for B, S in ((1, FUSED_S), (32, FUSED_S), (1, 2048), (32, 2048)):
        kc, vc = (randn(3, B, Hkv, S, hd) for _ in range(2))
        qk = randn(B, 1, n0)
        kn, vn = qk[..., H * hd:].reshape(B, 1, Hkv, hd), randn(B, 1, Hkv, hd)
        start = torch.randint(0, S, (B,), device=dev, generator=g)
        k1, v1 = kc.clone(), vc.clone()
        kv_append(k1, v1, kn, vn, 2, start)
        torch.cuda.synchronize()
        kv_append_plain(kc, vc, kn, vn, 2, start)
        exact = torch.equal(k1, kc) and torch.equal(v1, vc)
        bi = torch.arange(B, device=dev)[:, None]
        hi = torch.arange(Hkv, device=dev)[None, :]
        idx = (bi, hi, start[:, None])

        def index_put(i):
            kc[2].index_put_(idx, kn[:, 0])
            vc[2].index_put_(idx, vn[:, 0])

        b, by = bound_ms(2 * 2 * (2 * B * Hkv * hd) + 8 * B, 0)
        run = lambda i: kv_append(kc, vc, kn, vn, 2, start)  # noqa: E731
        out["kv_append"].append({
            "case": f"B={B} S={S}", "max_abs_err": 0.0 if exact else math.inf,
            "rel_err": 0.0 if exact else math.inf, "ms": graph_ms(run, 64),
            "eager_ms": time_ms(run, 64),
            "plain_ms": graph_ms(lambda i: kv_append_plain(kc, vc, kn, vn, 2, start), 16),
            "library_ms": graph_ms(index_put, 16), "bound_ms": b, "bound_by": by})
        del kc, vc, k1, v1

    # attn_out: q as a slice of attn_in's qk row; the cache a layer view;
    # the attention phase alone at each of its shapes (where the timed
    # package has the entry point), listed after the fused cases
    phase_alone = hasattr(decode_attention_mod, "fused_attention")
    phases: dict = {"attn_out": [], "layer": []}
    seen: set = set()
    for label, B, pos, int8, wk in ATTN_OUT_CASES:
        mk = lambda: _rand_weights(rng, wk, dim, H * hd, dev)  # noqa: E731
        w0 = mk()
        ws = _rotation(w0, w0.n_bytes)
        x = randn(B, 1, dim)
        q = randn(B, 1, n0)[..., : H * hd].reshape(B, 1, H, hd)
        shape = (2, B, Hkv, FUSED_S, hd)
        if int8:
            kc, vc = (torch.randint(-127, 128, shape, device=dev, generator=g, dtype=torch.int8)
                      for _ in range(2))
            sc = tuple((torch.rand(shape[:-1], device=dev, generator=g) * 0.02 + 0.001)[1]
                       for _ in range(2))
        else:
            kc, vc = (randn(*shape) for _ in range(2))
            sc = None
        k, v = kc[1], vc[1]
        qp = torch.randint(max(0, pos - 15), pos + 1, (B, 1), device=dev, generator=g)
        if not attn_out_supported(w0, H, Hkv, hd, B, FUSED_S):
            raise SystemExit(f"FAIL: attn_out's gate refuses its phase 3 case {label}")
        a_got, a_ref = (torch.empty(B, H * hd, dtype=torch.bfloat16, device=dev)
                        for _ in range(2))
        got = fused_attn_out(x, q, k, v, qp, sc, w0, att=a_got)
        torch.cuda.synchronize()
        ref = attn_out_plain(x, q, k, v, qp, sc, w0, att=a_ref)
        ad, _ = _err(got, ref)
        att_rel = row_rel_err(a_got.reshape(B, H, hd), a_ref.reshape(B, H, hd))
        wd = deq(ws)
        att = randn(B, H * hd)
        nb, fl = decode_work(qp, H, Hkv, hd, 2 * (hd * k.element_size() + (4 if int8 else 0)))
        b, by = bound_ms(nb + w0.n_bytes + 2 * 2 * B * dim, fl + 2.0 * B * H * hd * dim)
        run = lambda i: fused_attn_out(x, q, k, v, qp, sc, ws[i % len(ws)])  # noqa: E731
        out["attn_out"].append({
            "case": label, "max_abs_err": ad,
            "rel_err": max(row_rel_err(got[:, 0], ref[:, 0]), att_rel), "att_rel_err": att_rel,
            "att_splits": _splits_note(FUSED_S),
            "ms": graph_ms(run, 32), "eager_ms": time_ms(run, 32),
            "plain_ms": graph_ms(lambda i: attn_out_plain(x, q, k, v, qp, sc, w0), 4, 3),
            "library_ms": None,
            "matmul_ms": graph_ms(lambda i: torch.matmul(att, wd[i % len(wd)]), 32),
            "bound_ms": b, "bound_by": by})
        if phase_alone and (B, pos, int8) not in seen:
            seen.add((B, pos, int8))
            phases["attn_out"].append(attention_phase_case(
                f"B={B} pos {pos - 15}-{pos} {'int8' if int8 else 'bf16'} KV", q[:, 0], k, v, qp,
                sc))
        del ws, wd, kc, vc

    # layer: f32 scales (the load path (b) runs), wo q6w as the fixture's
    kinds = (("q4f", n0, dim), ("q6wf", n1, dim), ("q6wf", dim, H * hd), ("q4f", 2 * F, dim),
             ("q6wf", dim, F))
    mk_l = lambda: [_rand_weights(rng, k_, N, K, dev) for k_, N, K in kinds]  # noqa: E731
    w0 = mk_l()
    nbw = sum(w.n_bytes for w in w0)
    ws = _rotation(w0, nbw)
    wd = [deq(t) for t in ws]
    anw, fnw = (torch.rand(dim, device=dev, generator=g) + 0.5 for _ in range(2))
    for positions, S in LAYER_CASES:
        B = len(positions)
        pos = torch.tensor(positions, device=dev)[:, None]
        cos, sin = rope_cos_sin(pos, RopeParams(head_dim=hd, n_rot=hd))
        x = randn(B, 1, dim, scale=0.5)
        kc, vc = (randn(2, B, Hkv, S, hd) for _ in range(2))
        args = (cos, sin, kc[1], vc[1], H, Hkv)
        if not layer_supported(*w0, B, dim, H, Hkv, hd):
            raise SystemExit(f"FAIL: layer's gate refuses its phase 3 case {positions}")
        a_got, a_ref = (torch.empty(B, H * hd, dtype=torch.bfloat16, device=dev)
                        for _ in range(2))
        got = fused_layer(x, pos, anw, fnw, 1e-5, *w0, *args, att=a_got)
        torch.cuda.synchronize()
        ref = layer_plain(x, pos, anw, fnw, 1e-5, *w0, *args, att=a_ref)
        errs = [_err(a, r) for a, r in zip(got, ref)]
        att_rel = row_rel_err(a_got.reshape(B, H, hd), a_ref.reshape(B, H, hd))
        rel = max([row_rel_err(a.reshape(B, -1), r.reshape(B, -1)) for a, r in zip(got, ref)]
                  + [att_rel])
        xs = [randn(B, K) for _, _, K in kinds]
        live = float(sum(positions))  # cache slots below each row's position
        b, by = bound_ms(nbw + live * Hkv * 2 * hd * 2 + 2 * B * (2 * dim + 2 * n1) + B * 16,
                         2.0 * B * (dim * (n0 + n1 + H * hd) + 3 * dim * F)
                         + 4.0 * (live + B) * H * hd)
        run = lambda i: fused_layer(x, pos, anw, fnw, 1e-5, *ws[i % len(ws)], *args)  # noqa: E731
        out["layer"].append({
            "case": f"B={B} positions {list(positions)}, S {S}, f32 scales",
            "max_abs_err": max(e[0] for e in errs), "rel_err": rel, "att_rel_err": att_rel,
            "att_splits": _splits_note(S),
            "ms": graph_ms(run, 32), "eager_ms": time_ms(run, 32),
            "plain_ms": graph_ms(lambda i: layer_plain(x, pos, anw, fnw, 1e-5, *w0, *args), 4, 3),
            "library_ms": None,
            "matmul_ms": graph_ms(lambda i: [torch.matmul(a, w) for a, w in
                                             zip(xs, wd[i % len(wd)])], 32),
            "bound_ms": b, "bound_by": by})
        if phase_alone:  # q and the current k as slices of a qk row, as attn_in leaves them
            qk = randn(B, n0)
            cur = (qk[:, H * hd:].reshape(B, Hkv, hd), randn(B, Hkv, hd))
            phases["layer"].append(attention_phase_case(
                f"B={B} positions {list(positions)}, S {S}, the current token",
                qk[:, : H * hd].reshape(B, H, hd), kc[1], vc[1], pos, kv_cur=cur))
        del kc, vc
    del ws, wd
    for name, rows in phases.items():
        out[name] += rows

    # rot: oproj_ffn's weights as the fixture's (wo q6w), the next layer's
    # wqk q4 and wv q6w, on bf16 pairs (path (a)) and f32 scales
    for f32 in (False, True):
        sfx = "f" if f32 else ""
        kinds = (("q6w" + sfx, dim, H * hd), ("q4" + sfx, 2 * F, dim), ("q6w" + sfx, dim, F),
                 ("q4" + sfx, n0, dim), ("q6w" + sfx, n1, dim))
        mk_r = lambda: [_rand_weights(rng, k_, N, K, dev) for k_, N, K in kinds]  # noqa: E731
        w0 = mk_r()
        nbw = sum(w.n_bytes for w in w0)
        ws = _rotation(w0, nbw)
        wd = [deq(t) for t in ws]
        nw, nw2 = (torch.rand(dim, device=dev, generator=g) + 0.5 for _ in range(2))
        for R in (1, 8):
            x, at = randn(R, dim, scale=0.5), randn(R, H * hd, scale=0.5)
            cos, sin = (torch.rand(R, hd // 2, device=dev, generator=g) for _ in range(2))
            if not rot_supported(*w0[:3], w0[3:], R, dim, hd):
                raise SystemExit("FAIL: rot's gate refuses its phase 3 case")
            got = fused_oproj_ffn_attn_in(x, at, w0[0], nw, 1e-5, w0[1], w0[2], nw2, w0[3],
                                          w0[4], cos, sin, hd)
            torch.cuda.synchronize()
            ref = rot_plain(x, at, w0[0], nw, 1e-5, w0[1], w0[2], nw2, w0[3], w0[4], cos, sin,
                            hd)
            errs = [_err(a, r) for a, r in zip(got, ref)]
            xs = [at, x, randn(R, F), x, x]
            b, by = bound_ms(nbw + 2 * R * (H * hd + 2 * dim + n0 + n1) + 8 * dim
                             + 2 * R * hd * 4,
                             2.0 * R * (dim * (H * hd + 3 * F) + dim * (n0 + n1)))

            def run(i, plain=False):
                w = w0 if plain else ws[i % len(ws)]
                f = rot_plain if plain else fused_oproj_ffn_attn_in
                return f(x, at, w[0], nw, 1e-5, w[1], w[2], nw2, w[3], w[4], cos, sin, hd)

            out["rot"].append({
                "case": f"R={R} {'f32 scales' if f32 else 'bf16 pairs'}",
                "max_abs_err": max(e[0] for e in errs), "rel_err": max(e[1] for e in errs),
                "ms": graph_ms(run, 32), "eager_ms": time_ms(run, 32),
                "plain_ms": graph_ms(lambda i: run(i, plain=True), 4, 3),
                "library_ms": None,
                "matmul_ms": graph_ms(lambda i: [torch.matmul(a, w) for a, w in
                                                 zip(xs, wd[i % len(wd)])], 32),
                "bound_ms": b, "bound_by": by})
        del ws, wd
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 4: end to end
# ---------------------------------------------------------------------------


def expected_launches(cfg, params, rows: int, impl: str = "auto", batch: int = 1,
                      seq: int | None = None, kv_int8: bool = False,
                      attend: int | None = None, iswa: bool = False) -> dict:
    """Launches of one forward of `batch` rows of `rows` tokens, derived from
    the dispatch gates of models/llama.py for this model (every layer has
    layer 0's shapes) under the reference's switches as the environment
    sets them now: attn_in, oproj_ffn or ffn where their gates pass at
    batch * rows rows, for every projection they leave (a MoE layer's router
    and its E experts' gate, up and down included) and the lm head a qmm, or
    a qmm_int8 where the int8 gate passes under `impl`; the flash prefill
    kernel in every layer where the plain attention's logits over `attend`
    slots (default: a prefill's first T = rows; engine.step's window: every
    slot of its cache) would pass the budget and its shape rule holds; the flash
    decode kernel in every layer of a decode step (rows 1) whose logits over
    `seq` cache slots would (`kv_int8`: the int8 gate's S % 256). The
    switches: TKQ_FUSE_ATTN, TKQ_FUSE_OPROJ and TKQ_FUSE_FFN (default on:
    attn_in, oproj_ffn and ffn where "1"), TKQ_FUSE_LAYER (a decode step's layers in the layer kernel
    where layer_enabled passes on a bf16 cache), TKQ_DEFER_APPEND and
    TKQ_FUSE_ATTN_OUT (attn_out in place of the attention and o_proj where
    the append is not deferred), TKQ_ROTATE_LAYER (rot for every layer but
    the last, whose successor then skips attn_in) and TKQ_KV_APPEND_PALLAS
    (kv_append for each layer's eager append of a decode step on a cache of
    `seq` slots); the int8 folds (ops/dequant.py: TKQ_INT8_FOLDS,
    TKQ_Q4_MXU_MINS, TKQ_MANUAL_ATTN_IN, TKQ_MANUAL_OPROJ): the launches of
    attn_in, oproj_ffn and ffn that fold also count as "attn_in.folded",
    "oproj_ffn.folded" and "ffn.folded". phi3's wqkv: attn_in and rot on its two slots
    (qkv_weights), else one qmm. `iswa` (the forward of an ISWACache): no
    deferred append, no flash kernel in a ring layer, and a prefill chunk's
    lm head on one row a sequence (logits_rows). A recurrent model (mamba)
    runs qmm for its packed matmuls and nothing else, at any rows."""
    from tpu_kquant_torch.models.llama import qkv_weights
    from tpu_kquant_torch.models.moe import _expert_view
    from tpu_kquant_torch.ops import attention
    from tpu_kquant_torch.ops.attn_in import attn_in_enabled
    from tpu_kquant_torch.ops.attn_in import folds as attn_in_folds
    from tpu_kquant_torch.ops.attn_out import attn_out_enabled
    from tpu_kquant_torch.ops.dequant import ffn_folds, oproj_ffn_folds
    from tpu_kquant_torch.ops.ffn import ffn_enabled, oproj_ffn_enabled
    from tpu_kquant_torch.ops.kv_append import kv_append_enabled
    from tpu_kquant_torch.ops.layer import layer_enabled
    from tpu_kquant_torch.ops.prefill import prefill_supported
    from tpu_kquant_torch.ops.qmatmul import int8_eligible
    from tpu_kquant_torch.ops.rot import rot_enabled

    L, lay, D, H = cfg.n_layers, params["layers"][0], cfg.head_dim, cfg.n_heads
    if cfg.is_recurrent:  # mamba: its packed matmuls a layer and the lm head, any rows
        n = dict.fromkeys(("prefill", "decode_attn", "attn_in", "oproj_ffn", "ffn", "qmm_int8",
                           "kv_append", "attn_out", "layer", "rot", *FOLDED), 0)
        mats = [lay[k] for k in ("ssm_in", "ssm_x", "ssm_dt", "ssm_out") if lay[k].kind != "dense"]
        n["qmm"] = L * len(mats) + 1
        return n
    budget = attention.ATTN_PLAIN_MAX_MB
    softcap = cfg.attn_logit_softcap > 0.0  # keeps both flash kernels off
    att = rows if attend is None else attend
    flash = rows > 1 and not softcap and prefill_supported(rows, att, D) and \
        attention.logits_mb(batch, rows, H, att) > budget
    # layers whose attention may leave the plain branch: all but a ring's
    n_flat = L - (sum(cfg.layer_window(i) > 0 for i in range(L)) if iswa else 0)
    decode = rows == 1 and not softcap and not cfg.sliding_window and seq is not None and \
        D % 64 == 0 and seq % 64 == 0 and (not kv_int8 or seq % 256 == 0) and \
        attention.logits_mb(batch, 1, H, seq) > budget
    n_rows = batch * rows
    n = {"prefill": n_flat * flash, "decode_attn": 0, "attn_in": 0, "oproj_ffn": 0, "ffn": 0,
         "qmm": 0, "qmm_int8": 0, "kv_append": 0, "attn_out": 0, "layer": 0, "rot": 0,
         **dict.fromkeys(FOLDED, 0)}

    def mm(qt, times: int, r: int = n_rows) -> None:
        n["qmm_int8" if impl == "int8" and int8_eligible(qt, r) else "qmm"] += times

    head_rows = batch if iswa and rows > 1 else n_rows  # the lm head's rows
    wqk, wv = qkv_weights(lay, cfg)

    neox = cfg.rope.mode == "neox" and cfg.rope.n_rot == D
    gu = "w_gateup" in lay and not cfg.is_moe and not cfg.post_norms
    if rows == 1 and neox and not cfg.attn_bias and not cfg.is_moe and not kv_int8 and \
            not softcap and not cfg.sliding_window and not iswa and \
            "wqk" in lay and gu and layer_enabled(
                impl, lay["wqk"], lay["wv"], lay["wo"], lay["w_gateup"], lay["w_down"], batch,
                cfg.dim, H, cfg.n_kv_heads, D):
        n["layer"] = L
        n["kv_append"] = L * (seq is not None and kv_append_enabled(False, 1, batch, seq))
        mm(params["output"], 1)
        return n
    deferred = rows == 1 and not iswa and os.environ.get("TKQ_DEFER_APPEND", "1") == "1" and \
        os.environ.get("TKQ_FUSE_LAYER", "0") != "1" and \
        (seq is None or attention.logits_mb(batch, 1, H, seq) <= budget)
    eager = rows == 1 and not deferred
    n["kv_append"] = L * (eager and seq is not None and kv_append_enabled(kv_int8, 1, batch, seq))
    a_out = eager and seq is not None and not softcap and not cfg.sliding_window and \
        not cfg.post_norms and attn_out_enabled(impl, lay["wo"], H, cfg.n_kv_heads, D, batch,
                                                seq)
    biases = (lay["bqk"], lay["bv"]) if cfg.attn_bias else None
    a_in = neox and wqk is not None and \
        attn_in_enabled(wqk, wv, n_rows, cfg.dim, D, biases, impl)
    rot = not a_out and neox and not cfg.attn_bias and gu and L > 1 and wqk is not None and \
        rot_enabled(impl, lay["wo"], lay["w_gateup"], lay["w_down"], [wqk, wv], n_rows,
                    cfg.dim, D)
    o_ffn = not a_out and gu and oproj_ffn_enabled(impl, lay["wo"], lay["w_gateup"],
                                                   lay["w_down"], n_rows)
    ffn = gu and not o_ffn and ffn_enabled(impl, lay["w_gateup"], lay["w_down"], n_rows)
    n["decode_attn"] = n_flat * (decode and not a_out)
    n["attn_out"] = L * a_out
    n["rot"] = (L - 1) * rot
    n["attn_in"] = (1 if rot else L) * a_in
    n["oproj_ffn"] = (1 if rot else L) * o_ffn
    n["ffn"] = L * ffn
    if a_in and attn_in_folds(wqk, wv, n_rows, biases):
        n["attn_in.folded"] = n["attn_in"]
    if o_ffn and any(oproj_ffn_folds(lay["wo"], lay["w_gateup"], lay["w_down"], n_rows)):
        n["oproj_ffn.folded"] = n["oproj_ffn"]
    if ffn and ffn_folds(lay["w_gateup"]):
        n["ffn.folded"] = n["ffn"]
    if not a_in:  # under rot only the first layer projects its own q/k/v
        ws = [lay["wqkv"]] if "wqkv" in lay else \
            ([lay["wqk"]] if "wqk" in lay else [lay["wq"], lay["wk"]]) + [lay["wv"]]
        for w in ws:
            mm(w, 1 if rot else L)
    if not (o_ffn or a_out):
        mm(lay["wo"], L)
    if cfg.is_moe:
        mm(lay["gate_inp"], L)
        for k in ("w_gate", "w_up", "w_down"):
            mm(_expert_view(lay["experts"][k], 0), L * cfg.n_experts)
    elif not (o_ffn or ffn):
        for w in ([lay["w_gateup"]] if "w_gateup" in lay else [lay["w_gate"], lay["w_up"]]) + \
                [lay["w_down"]]:
            mm(w, L)
    mm(params["output"], 1, head_rows)
    return n


# the counters of the launches that fold (ops/attn_in.py, ops/ffn.py)
FOLDED = ("attn_in.folded", "oproj_ffn.folded", "ffn.folded")


def pin_dispatch(cfg, params, what: str, decode: dict, long_rows: int, impl: str = "auto",
                 prefill64: dict | None = None, seq: int | None = None,
                 kv_int8: bool = False, flash_layers: int | None = None) -> None:
    """Hold the gates themselves to the dispatch this model is meant to run,
    stated from its config and not by the gates: `decode` is one decode
    step's launches (under `impl`, on a cache of `seq` slots, int8 where
    `kv_int8`), `prefill64` (where given) a 64-row prefill's, and a prefill
    of `long_rows` rows runs the flash prefill kernel in `flash_layers`
    layers (default: every layer). Without this, a gate that began to
    refuse would lower the expected counts with the launches, and the exact
    checks would still pass."""
    got = expected_launches(cfg, params, 1, impl, seq=seq, kv_int8=kv_int8)
    got64 = expected_launches(cfg, params, 64, impl)
    n = expected_launches(cfg, params, long_rows, impl)["prefill"]
    want_n = cfg.n_layers if flash_layers is None else flash_layers
    decode = {k: decode.get(k, 0) for k in got}
    prefill64 = None if prefill64 is None else {k: prefill64.get(k, 0) for k in got64}
    log(f"  dispatch of {what}: decode step {_nonzero(got)}, 64-row prefill {_nonzero(got64)}, "
        f"prefill kernel in {n} layers at {long_rows} rows")
    if got != decode or n != want_n or (prefill64 is not None and got64 != prefill64):
        raise SystemExit(f"FAIL: {what}: the gates dispatch a decode step as {got}, a 64-row "
                         f"prefill as {got64} and a {long_rows}-row prefill to the prefill "
                         f"kernel in {n} layers; expected {decode}, {prefill64} and {want_n}")


def _nonzero(d: dict) -> dict:
    return {k: v for k, v in d.items() if v}


def _add(a: dict, b: dict, n: int = 1) -> dict:
    return {k: a.get(k, 0) + n * b.get(k, 0) for k in set(a) | set(b)}


def counts() -> dict:
    from tpu_kquant_torch.ops import _build

    return {k: c.launches for k, c in _build.COUNTERS.items()}


def reset_counts() -> None:
    from tpu_kquant_torch.ops import _build

    for c in _build.COUNTERS.values():
        c.reset()


def check_counts(what: str, want: dict) -> dict:
    got = counts()
    log(f"  launches in {what}: {got} (expected {want})")
    for k, v in want.items():
        if got.get(k, 0) != v:
            raise SystemExit(f"FAIL: {what}: kernel {k} launched {got.get(k, 0)} times, "
                             f"expected {v}")
    return got


def _to_cpu(v):
    """A parameter tree (QTensors, tensors, nested dicts and lists) on the CPU."""
    if isinstance(v, dict):
        return {k: _to_cpu(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_to_cpu(x) for x in v]
    return v.to("cpu")


# a prompt's smallest k-th/(k+1)-th router-logit gap on the card, in the
# logits' std: about 3x the card-CPU router-logit difference on an H100
ROUTER_MARGIN = 0.05
ROUTER_DRAWS = 2000  # prompts drawn on the card at most, per prompt length


def _routing(routes: list, k: int) -> tuple[list, float, float]:
    """(sorted top-k expert ids per recorded call, the smallest gap between
    the k-th and (k+1)-th router logit, the logits' std)."""
    import torch

    srt = [torch.sort(r, -1, descending=True) for r in routes]
    sel = [s.indices[..., :k].sort(-1).values for s in srt]
    margin = min((s.values[..., k - 1] - s.values[..., k]).min().item() for s in srt)
    return sel, margin, torch.cat([r.reshape(-1) for r in routes]).std().item()


@contextlib.contextmanager
def cpu_dequant_memo():
    """Within the block, dequant_kmajor of a weight held on the CPU is
    computed once and reused: the plain versions dequantize every weight at
    every call, and a cut's CPU side calls them for each prompt and step
    (most of a cut's time, and of the smoke's, before this). Keyed by the
    packed arrays' addresses, strides, shapes and dtypes and the requested
    dtype; the weights stay alive and unchanged while the block runs. CUDA
    weights go to dequant_kmajor itself."""
    import torch

    from tpu_kquant_torch.ops import attn_in, ffn, layer, qmm
    from tpu_kquant_torch.quant import codecs

    real = codecs.dequant_kmajor
    memo: dict = {}

    def cached(qt, dtype=torch.float32):
        arrs = qt.arrays.items()
        if not all(isinstance(a, torch.Tensor) and a.device.type == "cpu" for _, a in arrs):
            return real(qt, dtype)
        key = (qt.kind, qt.layout, tuple(qt.shape), qt.fold, dtype) + tuple(
            (k, a.data_ptr(), tuple(a.shape), a.stride(), a.dtype) for k, a in sorted(arrs))
        if key not in memo:
            memo[key] = real(qt, dtype)
        return memo[key]

    mods = (attn_in, ffn, layer, qmm)
    for m in mods:
        m.dequant_kmajor = cached
    try:
        yield
    finally:
        for m in mods:
            m.dequant_kmajor = real
        memo.clear()


def reference_check(cfg, params, dev, lengths=(8, 40), max_seq: int = 128,
                    kv_quantized: bool | tuple = False, depth: int = 2, impl: str = "auto",
                    steps: int = 4, kv_layout: str = "unified") -> None:
    """A `depth`-layer cut of the loaded model on the card (kernels) against
    the same cut on the CPU (plain versions), both on `kv_layout`: prefill
    of each prompt length (8 rows: fused kernels; 40: qmm; 1100: bucket
    2048, the flash prefill), then `steps` greedy decode steps, on a bf16
    or int8 KV cache (`kv_quantized`; a tuple: each in turn, over one CPU
    copy of the weights, dequantized once). For a MoE model the router logits of
    every call are recorded on both sides, and the experts selected for
    every prompt token, decode step and layer must agree. The agreement must
    not be luck: the smallest router margin of the card's run (k-th against
    (k+1)-th logit) must exceed twice the largest card-CPU router-logit
    difference, since no difference below half the margin can swap a
    selection. Prompts are drawn on the card until every margin is at least
    ROUTER_MARGIN of the logits' std, and that prompt is checked once."""
    import dataclasses

    import numpy as np
    import torch

    from tpu_kquant_torch.models import moe
    from tpu_kquant_torch.runtime.engine import InferenceEngine

    cut = dataclasses.replace(cfg, n_layers=depth)
    p_gpu = {**params, "layers": params["layers"][:depth]}
    p_cpu = _to_cpu(p_gpu)
    rng = np.random.default_rng(1)
    k = cfg.n_experts_used
    seen: list = []
    real = moe._routing_weights

    def spy(logits, top_k):
        seen.append(logits.float().cpu())
        return real(logits, top_k)

    def run(p, d, prompt):
        seen.clear()
        eng = InferenceEngine(cut, p, max_seq=max_seq, kv_quantized=quant, device=d,
                              impl=impl, kv_layout=kv_layout)
        cache = eng.new_cache(1)
        logits, cache, lens = eng.prefill([prompt], cache)
        first = torch.argmax(logits, -1)
        # the routing spy reads every step's router logits on the host, which
        # a captured step may not: a MoE model's steps take the plain loop
        toks, cache = eng.decode_greedy(first, torch.tensor(lens, device=d), cache, steps,
                                        plain=cfg.is_moe)
        # prompt rows of the prefill calls, then the decode steps' single rows
        routes = [r[0, :len(prompt)] for r in seen[:depth]] + [r[0] for r in seen[depth:]]
        return logits[0].float().cpu(), [int(first[0])] + toks[0].cpu().tolist(), routes

    def draw(n):
        """The first prompt of n tokens whose card run has every router margin
        at least ROUTER_MARGIN std (any prompt for a dense model)."""
        for tries in range(1, ROUTER_DRAWS + 1):
            prompt = rng.integers(10, cfg.vocab_size, n).tolist()
            out = run(p_gpu, dev, prompt)
            if not cfg.is_moe:
                return prompt, out, tries
            _, margin, std = _routing(out[2], k)
            if margin >= ROUTER_MARGIN * std:
                return prompt, out, tries
        raise SystemExit(f"FAIL: no prompt of {n} tokens in {ROUTER_DRAWS} draws has router "
                         f"margins of {ROUTER_MARGIN} std")

    moe._routing_weights = spy
    try:
        with cpu_dequant_memo():
            for quant in (kv_quantized if isinstance(kv_quantized, tuple) else (kv_quantized,)):
                kv = "int8" if quant else "bf16"
                for n in lengths:
                    t0 = time.perf_counter()
                    prompt, (lg, tg, rg), tries = draw(n)
                    t_draw = time.perf_counter() - t0
                    lc, tc, rc = run(p_cpu, "cpu", prompt)
                    if cfg.is_moe:
                        # decode steps compare only while both sides were fed the same tokens
                        same = depth + depth * next(
                            (i for i in range(steps) if tg[i] != tc[i]), steps)
                        sel, margin, std = _routing(rg[:same], k)
                        sel_c, _, _ = _routing(rc[:same], k)
                        diff = max((a - b).abs().max().item()
                                   for a, b in zip(rg[:same], rc[:same]))
                        agree = all(torch.equal(a, b) for a, b in zip(sel, sel_c))
                        n_dec = sum(int(s.numel() // k) for s in sel)
                        log(f"  routing, prompt {n} ({tries} draw(s) in {t_draw:.1f} s for "
                            f"margins >= {ROUTER_MARGIN} std): {n_dec} decisions (tokens x "
                            f"layers), experts agree {agree}; smallest card margin {margin:.3e} "
                            f"(router logits std {std:.3e}), largest card-CPU router logit "
                            f"difference {diff:.3e} (tolerance: half the margin)")
                        if not (agree and 2 * diff < margin):
                            raise SystemExit(f"FAIL: the card and the CPU route prompt {n} "
                                             f"differently, or within their difference (impl "
                                             f"{impl})")
                    rel = ((lg - lc).abs().max() / lc.abs().max()).item()
                    top5 = set(torch.topk(lc, 5).indices.tolist())
                    log(f"  {depth}-layer cut, {kv} KV, {kv_layout}, impl {impl}, prompt {n}: "
                        f"logits rel err {rel:.2e}; greedy card {tg} cpu {tc}")
                    if not (torch.isfinite(lg).all() and rel < 5e-2 and tg[0] in top5):
                        raise SystemExit(f"FAIL: card and CPU disagree on the {depth}-layer cut "
                                         f"({kv} KV, impl {impl}, prompt {n})")
    finally:
        moe._routing_weights = real


def weight_work(params) -> tuple[int, int]:
    """(bytes, multiply-adds per row) of every matmul weight and bias of the
    loaded model, the lm head and every stacked expert included (the MoE
    loop reads all E experts per token)."""
    import math

    from tpu_kquant_torch.quant.qtensor import QTensor

    leaves = [params["output"]]
    for lay in params["layers"]:
        for v in lay.values():
            leaves += list(v.values()) if isinstance(v, dict) else [v]
    mats = [v for v in leaves if isinstance(v, QTensor) and v.kind != "dense"]
    biases = [v for v in leaves if not isinstance(v, QTensor)]
    return (sum(qt.n_bytes for qt in mats) + sum(b.numel() * b.element_size() for b in biases),
            sum(math.prod(qt.shape) for qt in mats))


FIXTURE_DIR = ROOT / ".cache" / "tkq_torch_fixture_vocab"  # files with the fixture vocab


def load_fixture(cfg0, name: str, dev, scale_dtype: str = "bf16", recipe: str = "q4_k_m",
                 widen_q6: bool = True, seed: int = 0, scale: float = 0.05):
    """Write the `seed` fixture of `cfg0` (its vocab included; weights of
    std `scale`) under the quantize tool's `recipe` under .cache/ (once) and
    load it onto the card with `scale_dtype` and `widen_q6`; logs both
    times."""
    import torch

    from tpu_kquant_torch.models.fixtures import write_fixture_gguf
    from tpu_kquant_torch.runtime.loader import load_model

    path = FIXTURE_DIR / name
    t0 = time.perf_counter()
    if not path.exists():
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        write_fixture_gguf(tmp, cfg0, seed=seed, recipe=recipe, scale=scale)
        os.replace(tmp, path)
    t1 = time.perf_counter()
    cfg, params, _ = load_model(str(path), scale_dtype=scale_dtype, device=dev, widen_q6=widen_q6)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    log(f"  fixture {path.name}: write {t1 - t0:.1f} s, load + repack ({scale_dtype} scales"
        f"{'' if widen_q6 else ', widen_q6=False'}) {t2 - t1:.1f} s; depth {cfg.n_layers} of {cfg0.n_layers} layers, dim {cfg.dim}, vocab "
        f"{cfg.vocab_size}, biases {cfg.attn_bias}, tied lm head {cfg0.tie_embeddings}, "
        f"experts {cfg.n_experts} (top {cfg.n_experts_used})")
    return cfg, params, {"write_s": t1 - t0, "load_s": t2 - t1}


def refill(eng, prompt: list, cache):
    """Prefill one prompt into `cache` anew, zeroed first (a recurrent state
    starts from the cache it is given). Returns (the first greedy token [1],
    its position [1]) on the card."""
    import torch

    from tpu_kquant_torch.runtime.graphs import cache_tensors

    for t in cache_tensors(cache):
        t.zero_()
    logits, _, lens = eng.prefill([prompt], cache)
    return torch.argmax(logits, -1), torch.tensor(lens, device=eng.device)


AB_SAMPLER = dict(temperature=0.8, top_k=40, top_p=0.95, repeat_penalty=1.1)  # phase 6's chain


def sampled_graph_check(eng, prompt: list, tag: str) -> None:
    """decode_sampled (AB_SAMPLER, penalties over 64) for 32 steps on the
    captured step and on the plain loop from the same prefilled cache:
    tokens, the last step's logits, keys and penalty state equal bit for
    bit (fatal)."""
    import torch

    from tpu_kquant_torch.ops.sampling import SamplerConfig, init_penalty_state, row_keys

    sc = SamplerConfig(**AB_SAMPLER)
    cache, out = eng.new_cache(1), {}
    for plain in (True, False):
        first, pos = refill(eng, prompt, cache)
        keys = row_keys(torch.tensor([7]), 0).to(eng.device)
        state = init_penalty_state([prompt], eng.cfg.vocab_size, 64, eng.device)
        toks, _, keys, state = eng.decode_sampled(first, pos, cache, 32, sc, keys, state,
                                                  plain=plain)
        out[plain] = (toks, eng.last_logits.clone(), keys, *state)
    same = [torch.equal(a, b) for a, b in zip(out[True], out[False])]
    log(f"  sampled decode{tag} (32 steps, {AB_SAMPLER}): graph against the plain loop, "
        f"tokens / last logits / keys / penalty state equal: {same}")
    if not all(same):
        raise SystemExit(f"FAIL: the sampled decode loop's graph differs from the plain loop"
                         f"{tag}: {same}")


def end_to_end(dev, cfg, params, request_lengths=(5, 40, 200), request_max_seq: int = 704,
               profile: Path | None = None, tag: str = "", impl: str = "auto",
               kv_layout: str = "unified", timed_max_seq: int = 704, reps: int = 3,
               ab: bool = False, sampled: bool = False) -> dict:
    """The main path of one loaded model under `impl` on `kv_layout`: greedy
    requests of `request_lengths` tokens (16 new tokens each) on a
    `request_max_seq` bf16 cache, counted from 0 and checked against the
    dispatch gates (main_run), then pp512 and tg128 on a `timed_max_seq`
    cache (704: 512 + 128 + 64), medians of `reps` after a warm run. tg128
    runs on one cache, prefilled anew before each run, so the decode loop's
    graph is captured in the warm run and no timed run captures; with `ab`,
    its runs are two a side of the graph and the plain loop (plain, graph,
    graph, plain), every run's tokens and last logits equal bit for bit
    (fatal); with `sampled`, also sampled_graph_check."""
    import numpy as np
    import torch

    from tpu_kquant_torch.runtime import graphs
    from tpu_kquant_torch.runtime.engine import InferenceEngine

    # bounds of the two timed workloads, from the loaded weights: decode
    # reads every matmul weight once per token (KV and activations left
    # out); pp512 does 2 * 512 * N * K matmul flops per weight
    w_bytes, macs = weight_work(params)
    tg_bound = bound_ms(w_bytes, 2.0 * macs)
    pp_bound = bound_ms(w_bytes, 2.0 * 512 * macs)
    log(f"  bounds: decode {tg_bound[0]:.4f} ms/token ({tg_bound[1]}: {w_bytes / 1e6:.1f} MB of "
        f"weights), pp512 {pp_bound[0]:.4f} ms ({pp_bound[1]}: {2 * 512 * macs / 1e12:.3f} "
        f"TFLOP of matmuls)")

    def engine(max_seq):
        return InferenceEngine(cfg, params, max_batch=1, max_seq=max_seq, device=dev, impl=impl,
                               kv_layout=kv_layout)

    # the main path: requests of different prompt lengths, greedy
    rng = np.random.default_rng(2)
    eng = engine(request_max_seq)
    prompts = [rng.integers(10, cfg.vocab_size, n).tolist() for n in request_lengths]
    torch.cuda.synchronize()
    main_counts: dict = {}
    with main_run(f"the {len(prompts)} requests{tag}", main_counts):
        answers = [eng.generate([pr], max_new_tokens=16)[0] for pr in prompts]
        torch.cuda.synchronize()
    for pr, ans in zip(prompts, answers):
        log(f"  request of {len(pr)} tokens -> {ans}")
        if len(ans) != 16 or not all(0 <= t < cfg.vocab_size for t in ans):
            raise SystemExit("FAIL: a request did not get 16 valid tokens")
    del eng

    # pp512: bucketed prefill of a 512-token prompt (warmed once; median of reps)
    eng = engine(timed_max_seq)
    prompt = rng.integers(10, cfg.vocab_size, 512).tolist()
    eng.prefill([prompt], eng.new_cache(1))
    pp = []
    for _ in range(reps):
        cache = eng.new_cache(1)
        torch.cuda.synchronize()
        with main_run(f"pp512{tag}", {}):
            t0 = time.perf_counter()
            logits, cache, lens = eng.prefill([prompt], cache)
            torch.cuda.synchronize()
            pp.append(time.perf_counter() - t0)
    pp_s = sorted(pp)[len(pp) // 2]
    if not (logits.shape == (1, cfg.vocab_size) and torch.isfinite(logits).all()):
        raise SystemExit("FAIL: pp512 logits are not finite [1, vocab]")

    # tg128: 128 greedy decode steps after the 512-token prefill (warmed
    # once, which captures; median of reps, or the A/B's turns)
    cache = eng.new_cache(1)
    captures = graphs.STATS.captures
    eng.decode_greedy(*refill(eng, prompt, cache), cache, 4)
    capture = ((graphs.STATS.capture_ms[-1], graphs.STATS.pool_bytes[-1])
               if graphs.STATS.captures > captures else (None, None))
    tg: dict = {True: [], False: []}
    runs = []
    for plain in ((True, False, False, True) if ab else (False,) * reps):
        first, pos = refill(eng, prompt, cache)
        torch.cuda.synchronize()
        with main_run(f"tg128{tag}{' (plain loop)' if plain else ''}", {}):
            t0 = time.perf_counter()
            toks, cache = eng.decode_greedy(first, pos, cache, 128, plain=plain)
            torch.cuda.synchronize()
            tg[plain].append(time.perf_counter() - t0)
        runs.append((toks, eng.last_logits.clone()))
    tg_s = sorted(tg[False])[len(tg[False]) // 2]
    if ab:
        same = all(torch.equal(a, runs[0][0]) and torch.equal(b, runs[0][1]) for a, b in runs)
        cap = ("no capture" if capture[0] is None else
               f"capture {capture[0]:.1f} ms, graph pool {capture[1] / 1e6:.1f} MB")
        log(f"  [{gpu_line()}]{tag} tg128, graph against the plain loop (plain, graph, graph, "
            f"plain): graph {', '.join(f'{128 / t:.1f}' for t in tg[False])} tok/s, plain "
            f"{', '.join(f'{128 / t:.1f}' for t in tg[True])} tok/s; {cap}; tokens and last "
            f"logits equal bit for bit: {same}")
        if not same:
            raise SystemExit(f"FAIL:{tag} the decode loop's graph differs from the plain loop "
                             f"(tokens or last logits)")
    if sampled:
        sampled_graph_check(eng, prompt, tag)
    step_logits, _ = eng.decode_step(toks[:, -1], pos + 128, cache)
    if not torch.isfinite(step_logits).all():
        raise SystemExit("FAIL: decode logits are not finite")
    if profile is not None:
        profile_steps(eng, cfg, dev, profile, tag=f"_{tag.strip()}" if tag else "")
    res = {"depth": cfg.n_layers, "pp512_tok_s": 512 / pp_s, "pp512_ms": pp_s * 1e3,
           "pp512_ms_all": [t * 1e3 for t in pp],
           "tg128_tok_s": 128 / tg_s, "tg128_ms_per_tok": tg_s / 128 * 1e3,
           "tg128_tok_s_all": [128 / t for t in tg[False]],
           "tg128_plain_tok_s_all": [128 / t for t in tg[True]],
           "capture_ms": capture[0], "pool_bytes": capture[1],
           "main_path_launches": main_counts, "tg_bound_ms_per_tok": tg_bound[0],
           "pp512_bound_ms": pp_bound[0], "weight_bytes": w_bytes}
    log(f"  [{gpu_line()}]{tag} depth {cfg.n_layers}: pp512 {res['pp512_tok_s']:.1f} tok/s "
        f"({res['pp512_ms']:.2f} ms; bound {pp_bound[0]:.4f} ms), tg128 "
        f"{res['tg128_tok_s']:.1f} tok/s ({res['tg128_ms_per_tok']:.3f} ms/token; bound "
        f"{tg_bound[0]:.4f}); medians of {len(pp)} / {len(tg[False])}: pp512 runs "
        f"{', '.join(f'{512 / t:.1f}' for t in pp)} tok/s, tg128 runs "
        f"{', '.join(f'{v:.1f}' for v in res['tg128_tok_s_all'])} tok/s")
    return res


# qmm's kernels as the profiler names them: the GEMV, the tile and the
# split-K reduce of tpu_kquant_torch/csrc (namespace tkq), not PyTorch's own
# at::native::reduce_kernel
QMM_KERNEL = re.compile(r"\btkq::(gemv|tile|reduce)_kernel\b")


def profile_steps(eng, cfg, dev, out: Path, n_prompt: int = 512, tag: str = "") -> None:
    """--profile DIR: torch.profiler over one prefill of `n_prompt` tokens
    and 8 decode steps, replayed from the captured step and in the plain
    loop; kernel tables go to DIR/profile_*.txt, busy shares to the log."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    out.mkdir(parents=True, exist_ok=True)
    prompt = np.random.default_rng(3).integers(10, cfg.vocab_size, n_prompt).tolist()
    logits, cache, lens = eng.prefill([prompt], eng.new_cache(1))
    first = torch.argmax(logits, -1)
    pos = torch.tensor(lens, device=dev)
    eng.decode_greedy(first, pos, cache, 2)  # captures the decode step
    for what, run in ((f"prefill{tag}", lambda: eng.prefill([prompt], eng.new_cache(1))),
                      (f"decode{tag}", lambda: eng.decode_greedy(first, pos + 2, cache, 8)),
                      (f"decode_plain{tag}",
                       lambda: eng.decode_greedy(first, pos + 2, cache, 8, plain=True))):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        avg = prof.key_averages()
        kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        dev_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
        (out / f"profile_{what}.txt").write_text(avg.table(
            sort_by="self_device_time_total", row_limit=40))
        by_name: dict = {}
        for e in kernels:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        log(f"  profile {what}: wall {wall * 1e3:.2f} ms (profiler on), device kernels "
            f"{dev_ms:.2f} ms ({100 * dev_ms / (wall * 1e3):.1f}% busy); top: "
            + "; ".join(f"{k[:36]} {v:.2f} ms" for k, v in top))
        if cfg.is_recurrent:  # qmm's kernels (GEMV, tile, split reduce) against the rest
            q_ms = sum(v for k, v in by_name.items() if QMM_KERNEL.search(k))
            log(f"  profile {what}: qmm {q_ms:.2f} ms ({100 * q_ms / dev_ms:.1f}% of device "
                f"time), the plain ops (scan, conv, norms, copies) {dev_ms - q_ms:.2f} ms")


# ---------------------------------------------------------------------------
# phase 5: long prompts on bf16 and int8 KV
# ---------------------------------------------------------------------------

LONG_MAX_SEQ = 2048 + 128 + 64  # bench.py's sizing: prompt + tg128 + 64
LONG_TIMED_REPS = 1  # pp2048 and tg128@2048: one run after a warm one (3 before phase 15)


def long_prompts(cfg, params, dev, profile: Path | None = None) -> dict:
    """Phase 5 (module docstring), for each KV kind. Returns the timings and
    the launch counts of the request runs."""
    import numpy as np
    import torch

    from tpu_kquant_torch.runtime.engine import InferenceEngine, _bucket

    # pp2048 bound: the matmuls' flops (2 * 2048 * N * K per weight) plus the
    # flash prefill's causal flops in every layer, against the weights' bytes
    w_bytes, macs = weight_work(params)
    H, Hkv, D, L = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.n_layers
    _, attn_fl = prefill_work(1, 2048, 2048, H, Hkv, D, [0], 0, 2 * D)
    pp_bound = bound_ms(w_bytes, 2.0 * 2048 * macs + L * attn_fl)
    rng = np.random.default_rng(4)
    res: dict = {"launches": {}, "pp2048_bound_ms": pp_bound[0]}
    for quant in (False, True):
        kv = "int8" if quant else "bf16"
        reference_check(cfg, params, dev, lengths=(1100,), max_seq=LONG_MAX_SEQ,
                        kv_quantized=quant)
        eng = InferenceEngine(cfg, params, max_batch=1, max_seq=LONG_MAX_SEQ,
                              kv_quantized=quant, device=dev)
        # the main path: three long requests, counted
        prompts = [rng.integers(10, cfg.vocab_size, n).tolist() for n in (1000, 1500, 2048)]
        torch.cuda.synchronize()
        reset_counts()
        want: dict = {}
        answers = []
        for pr in prompts:
            answers.append(eng.generate([pr], max_new_tokens=16)[0])
            want = _add(want, expected_launches(cfg, params, min(_bucket(len(pr)),
                                                                 eng.max_seq)))
            want = _add(want, expected_launches(cfg, params, 1), 15)
        torch.cuda.synchronize()
        res["launches"][kv] = check_counts(f"the three long requests ({kv} KV)", want)
        for pr, ans in zip(prompts, answers):
            log(f"  {kv} KV: request of {len(pr)} tokens -> {ans}")
            if len(ans) != 16 or not all(0 <= t < cfg.vocab_size for t in ans):
                raise SystemExit("FAIL: a long request did not get 16 valid tokens")

        # pp2048 (warmed once; median of LONG_TIMED_REPS)
        prompt = rng.integers(10, cfg.vocab_size, 2048).tolist()
        eng.prefill([prompt], eng.new_cache(1))
        pp = []
        for _ in range(LONG_TIMED_REPS):
            cache = eng.new_cache(1)
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            logits, cache, lens = eng.prefill([prompt], cache)
            torch.cuda.synchronize()
            pp.append(time.perf_counter() - t0)
            check_counts(f"pp2048 ({kv} KV)", expected_launches(cfg, params, 2048))
        if not (logits.shape == (1, cfg.vocab_size) and torch.isfinite(logits).all()):
            raise SystemExit("FAIL: pp2048 logits are not finite [1, vocab]")

        # tg128 at depth 2048: 128 greedy steps after the 2048-token prefill
        # (warmed once, which captures the step; median of LONG_TIMED_REPS,
        # each after a prefill anew into the same cache)
        eng.decode_greedy(*refill(eng, prompt, cache), cache, 4)
        tg = []
        for _ in range(LONG_TIMED_REPS):
            first, pos = refill(eng, prompt, cache)
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            toks, cache = eng.decode_greedy(first, pos, cache, 128)
            torch.cuda.synchronize()
            tg.append(time.perf_counter() - t0)
            check_counts(f"tg128@2048 ({kv} KV)",
                         {k: 128 * v for k, v in expected_launches(cfg, params, 1).items()})
        step, _ = eng.decode_step(toks[:, -1], pos + 128, cache)
        if not torch.isfinite(step).all():
            raise SystemExit(f"FAIL: decode logits at depth 2176 are not finite ({kv} KV)")
        # decode bound per token: every weight byte plus the cache rows up to
        # depth ~2112 (the mean over the 128 steps), read once
        kv_row = 2 * L * Hkv * (D * (1 if quant else 2) + (4 if quant else 0))
        tg_bound = bound_ms(w_bytes + kv_row * (2048 + 64), 2.0 * macs)
        pp_s, tg_s = sorted(pp)[len(pp) // 2], sorted(tg)[len(tg) // 2]
        res[kv] = {"pp2048_tok_s": 2048 / pp_s, "pp2048_ms": pp_s * 1e3,
                   "pp2048_tok_s_all": [2048 / t for t in pp],
                   "tg128_at_2048_tok_s": 128 / tg_s, "tg128_at_2048_ms_per_tok": tg_s / 128 * 1e3,
                   "tg128_at_2048_tok_s_all": [128 / t for t in tg],
                   "tg_bound_ms_per_tok": tg_bound[0]}
        r = res[kv]
        log(f"  [{gpu_line()}] {kv} KV: pp2048 {r['pp2048_tok_s']:.1f} tok/s "
            f"({r['pp2048_ms']:.2f} ms; bound {pp_bound[0]:.3f} ms, {pp_bound[1]}), tg128@2048 "
            f"{r['tg128_at_2048_tok_s']:.1f} tok/s ({r['tg128_at_2048_ms_per_tok']:.3f} ms/token; "
            f"bound {tg_bound[0]:.4f}); medians of {LONG_TIMED_REPS}: pp2048 runs "
            f"{', '.join(f'{v:.1f}' for v in r['pp2048_tok_s_all'])}, tg128@2048 runs "
            f"{', '.join(f'{v:.1f}' for v in r['tg128_at_2048_tok_s_all'])} tok/s")
        for x in (r["pp2048_tok_s"], r["tg128_at_2048_tok_s"]):
            if not (math.isfinite(x) and x > 0):
                raise SystemExit(f"FAIL: a long-prompt rate is not finite ({kv} KV)")
        if profile is not None:
            profile_steps(eng, cfg, dev, profile, n_prompt=2048, tag=f"2048_{kv}")
        del eng, cache
        torch.cuda.empty_cache()
    return res


def counted_requests(cfg, params, dev, impl: str, seed: int, what: str,
                     kv_quantized: bool = False, batch: int = 1) -> dict:
    """Three greedy requests (prompts of 5, 40 and 200 tokens, 16 new each)
    on a 704-slot cache (int8 where `kv_quantized`) under `impl`, counted
    from 0 and checked against the gates; with `batch` 4, the three and a
    fourth of 120 tokens as one batch of ragged rows. Returns the counts."""
    import numpy as np
    import torch

    from tpu_kquant_torch.runtime.engine import InferenceEngine, _bucket

    eng = InferenceEngine(cfg, params, max_batch=batch, max_seq=704, device=dev, impl=impl,
                          kv_quantized=kv_quantized)
    rng = np.random.default_rng(seed)
    lengths = (5, 40, 200, 120)[:max(3, batch)]
    prompts = [rng.integers(10, cfg.vocab_size, n).tolist() for n in lengths]
    groups = [prompts] if batch > 1 else [[pr] for pr in prompts]
    torch.cuda.synchronize()
    reset_counts()
    want: dict = {}
    answers = []
    for grp in groups:
        answers += eng.generate(grp, max_new_tokens=16)
        rows = min(_bucket(max(len(pr) for pr in grp)), eng.max_seq)
        want = _add(want, expected_launches(cfg, params, rows, impl, batch=len(grp)))
        want = _add(want, expected_launches(cfg, params, 1, impl, batch=len(grp),
                                            seq=eng.max_seq, kv_int8=kv_quantized), 15)
    torch.cuda.synchronize()
    got = check_counts(f"the {len(prompts)} requests ({what})", want)
    for pr, ans in zip(prompts, answers):
        log(f"  {what}: request of {len(pr)} tokens -> {ans}")
        if len(ans) != 16 or not all(0 <= t < cfg.vocab_size for t in ans):
            raise SystemExit(f"FAIL: a request ({what}) did not get 16 valid tokens")
    return got


def dense_f32(dev) -> tuple[dict, dict]:
    """Phase 4's TinyLlama fixture loaded with f32 scales under impl "int8":
    decode runs attn_in and oproj_ffn on f32 scales (the int8 gate takes q4
    weights past the fused kernels only, so qmm_int8 is not reached), three
    greedy requests counted from 0 and checked against the gates. Then, on
    the same load, phase 10's paths (b) and (c). Returns the requests'
    counts and phase 10's results."""
    import torch

    from tpu_kquant_torch.models.fixtures import tinyllama_1b_config

    cfg, params, _ = load_fixture(tinyllama_1b_config(), "tinyllama-1.1b-q4_k_m-seed0.gguf", dev,
                                  scale_dtype="f32")
    L = cfg.n_layers
    pin_dispatch(cfg, params, "TinyLlama-1.1B (f32 scales, impl int8)",
                 {"attn_in": L, "oproj_ffn": L, "qmm": 1}, 2048, "int8")
    got = counted_requests(cfg, params, dev, "int8", 6, "f32 scales, impl int8")
    fused = fused_paths(dev, cfg, params, FUSED_PATHS[1:])
    del params
    torch.cuda.empty_cache()
    return got, fused


# ---------------------------------------------------------------------------
# phase 6: serving (continuous batching, the sampler chain, flash decode)
# ---------------------------------------------------------------------------

SERVE_NEW = 48  # tools_serve_bench.py's gen-len


def serve_request(i: int, cfg, rng, greedy: bool = False, eos: int | None = None):
    """tools_serve_bench.py's request: a prompt of 32-63 tokens, 48 new ones,
    temperature 0.8 (0 when greedy), top_k 40, top_p 0.95, repeat penalty
    1.1 over the last 64 tokens, seed 1000 + i."""
    from tpu_kquant_torch.serving import Request

    plen = 32 + int(rng.integers(0, 32))
    return Request(prompt=rng.integers(10, cfg.vocab_size, plen).tolist(),
                   max_new_tokens=SERVE_NEW, temperature=0.0 if greedy else 0.8, top_k=40,
                   top_p=0.95, repeat_penalty=1.1, penalty_last_n=64, seed=1000 + i, eos_id=eos)


def instrument(cb) -> dict:
    """Record a batcher's admissions ((k, T) of each burst, T of each single
    admission). Whether every tick's logits were finite is the batcher's own
    device flag, cb.logits_finite (a replayed chunk keeps only its last
    tick's logits)."""
    from tpu_kquant_torch.runtime.engine import _bucket

    rec: dict = {"bursts": [], "singles": []}
    real_burst, real_admit = cb._admit_burst, cb._admit
    T = lambda reqs: min(_bucket(max(len(r.prompt) for r in reqs)),  # noqa: E731
                         cb.engine.max_seq)

    def burst(pairs):
        rec["bursts"].append((len(pairs), T([r for _b, r in pairs])))
        return real_burst(pairs)

    def admit(b, req):
        rec["singles"].append(T([req]))
        return real_admit(b, req)

    cb._admit_burst, cb._admit = burst, admit
    return rec


def serving_launches(cfg, params, rec: dict, ticks: int, B: int, max_seq: int,
                     kv_int8: bool) -> dict:
    """What the gates launch for a serving run: each burst's [k, T] prefill,
    each single admission's [1, T], and `ticks` decode steps of B rows over
    max_seq slots (the ticks the device ran: the batcher's ticks_run)."""
    want: dict = {}
    for k, T in rec["bursts"]:
        want = _add(want, expected_launches(cfg, params, T, batch=k))
    for T in rec["singles"]:
        want = _add(want, expected_launches(cfg, params, T))
    return _add(want, expected_launches(cfg, params, 1, batch=B, seq=max_seq, kv_int8=kv_int8),
                ticks)


def _top2_gap(eng, req, toks: list, d: int) -> float:
    """The top-2 gap of the (penalised) logits a greedy request chooses its
    token d from, when it has emitted toks[:d]: its prompt and those tokens
    fed through a batch-1 engine."""
    import torch

    from tpu_kquant_torch.ops.sampling import apply_penalties, init_penalty_state

    logits, cache, lens = eng.prefill([req.prompt], eng.new_cache(1))
    pos = int(lens[0])
    for t in toks[:d]:
        logits, cache = eng.decode_step(torch.tensor([t], device=eng.device),
                                        torch.tensor([pos], device=eng.device), cache)
        pos += 1
    counts = init_penalty_state([req.prompt + toks[:d]], eng.cfg.vocab_size,
                                req.penalty_last_n, eng.device)[0]
    top = torch.topk(apply_penalties(logits.float(), counts, req.repeat_penalty), 2).values[0]
    return float(top[0] - top[1])


def serving_reference_check(cfg, params, dev, kv_quantized: bool) -> None:
    """A 2-layer cut of the serving path on the card against the CPU, with
    the attention budget lowered so that 8 slots of 256 pass it (the burst's
    [8, 64] prefill takes the flash prefill kernel, every tick the flash
    decode kernel): 8 greedy requests, two ticks. The first tick's logits
    (the burst's) within 5e-2 of max|ref|, each row's first token in the
    CPU's top 5; the second tick's logits (the first real decode, through
    #7) within 5e-2 on the rows whose first tokens agree."""
    import dataclasses

    import numpy as np
    import torch

    from tpu_kquant_torch.ops import attention
    from tpu_kquant_torch.runtime.engine import InferenceEngine
    from tpu_kquant_torch.serving import ContinuousBatcher, Request

    cut = dataclasses.replace(cfg, n_layers=2)
    p_gpu = {**params, "layers": params["layers"][:2]}
    rng = np.random.default_rng(5)
    prompts = [rng.integers(10, cfg.vocab_size, int(n)).tolist() for n in rng.integers(32, 64, 8)]
    kv = "int8" if kv_quantized else "bf16"
    saved = attention.ATTN_PLAIN_MAX_MB
    attention.ATTN_PLAIN_MAX_MB = 0.1
    outs = []
    try:
        for d, p in ((dev, p_gpu), ("cpu", _to_cpu(p_gpu))):
            eng = InferenceEngine(cut, p, max_batch=8, max_seq=256, kv_quantized=kv_quantized,
                                  device=d)
            cb = ContinuousBatcher(eng)
            for pr in prompts:
                cb.submit(Request(prompt=pr, max_new_tokens=4))
            if d != "cpu":
                torch.cuda.synchronize()
                reset_counts()
            ticks = []
            for _ in range(2):
                cb.step()
                ticks.append(cb.tick_logits.float().cpu())
            if d != "cpu":
                check_counts(f"the 2-layer serving cut ({kv} KV)",
                             {"prefill": 2, "decode_attn": 4})
            outs.append((ticks, [s.req.output[0] for s in cb.slots]))
    finally:
        attention.ATTN_PLAIN_MAX_MB = saved
    (tg, first_g), (tc, first_c) = outs
    same = torch.tensor([a == b for a, b in zip(first_g, first_c)])
    rel1 = ((tg[0] - tc[0]).abs().max() / tc[0].abs().max()).item()
    rel2 = ((tg[1][same] - tc[1][same]).abs().max() / tc[1][same].abs().max()).item() \
        if same.any() else float("nan")
    top5 = torch.topk(tc[0], 5, dim=-1).indices
    in5 = (top5 == torch.tensor(first_g)[:, None]).any(-1)
    log(f"  2-layer serving cut, {kv} KV, budget 0.1 MB: first tick rel err {rel1:.2e}, first "
        f"tokens in the CPU's top 5 {int(in5.sum())}/8, equal {int(same.sum())}/8; second "
        f"tick (flash decode) rel err {rel2:.2e} on those rows")
    if not (all(torch.isfinite(t).all() for t in tg) and rel1 < 5e-2 and in5.all()
            and same.any() and rel2 < 5e-2):
        raise SystemExit(f"FAIL: the card and the CPU disagree on the 2-layer serving cut ({kv} "
                         f"KV)")


def _collect() -> None:
    """Free what the caller has just deleted: instrument() ties a batcher to
    its own wrapped methods in a reference cycle, which only the collector
    breaks (a 1024-slot cache is 47 GB)."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def profile_ticks(cb, out: Path, tag: str, n: int = 4) -> None:
    """--profile DIR: torch.profiler over `n` serving ticks of a batcher with
    every slot active; the kernel table goes to DIR/profile_serve_TAG.txt,
    the busy share and the top kernels to the log."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    out.mkdir(parents=True, exist_ok=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            cb.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    dev_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    (out / f"profile_serve_{tag}.txt").write_text(prof.key_averages().table(
        sort_by="self_device_time_total", row_limit=40))
    by_name: dict = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    log(f"  profile serve_{tag}: {n} ticks, wall {wall * 1e3:.2f} ms (profiler on), device "
        f"kernels {dev_ms:.2f} ms ({100 * dev_ms / (wall * 1e3):.1f}% busy); top: "
        + "; ".join(f"{k[:40]} {v:.2f} ms" for k, v in top))


def serve_copies(eng, specs: list, plain: bool | None = None,
                 max_chunk: int | None = None) -> tuple[list, float, dict]:
    """Serve copies of `specs` (unserved Requests) on a new batcher, all
    submitted at once. Returns (their streams, wall s, the batcher's stats)."""
    import dataclasses

    import torch

    from tpu_kquant_torch.serving import ContinuousBatcher

    cb = ContinuousBatcher(eng, plain=plain)
    reqs = [dataclasses.replace(r, output=[]) for r in specs]
    for r in reqs:
        cb.submit(r)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cb.run(max_chunk=max_chunk)
    torch.cuda.synchronize()
    return [r.output for r in reqs], time.perf_counter() - t0, dict(cb.stats)


def serving(cfg, params, dev, big: tuple[int, int] = (1024, 2048),
            profile: Path | None = None) -> dict:
    """Phase 6 (module docstring): `big` is the large configuration's slots
    and cache length. Returns each configuration's numbers and its launch
    counts."""
    import dataclasses

    import numpy as np
    import torch

    from tpu_kquant_torch.runtime import graphs
    from tpu_kquant_torch.runtime.engine import InferenceEngine
    from tpu_kquant_torch.serving import ContinuousBatcher

    res: dict = {"launches": {}}
    for quant in (False, True):
        serving_reference_check(cfg, params, dev, quant)

    # (a) 16 slots of 128, 64 requests (the bench's 4 B): 12 greedy, 4 of
    # them with an eos taken from their solo stream
    B, max_seq = 16, 128
    rng = np.random.default_rng(7)
    greedy = {i for i in range(64) if i % 16 < 3}
    reqs = [serve_request(i, cfg, rng, greedy=i in greedy) for i in range(64)]
    solo_eng = InferenceEngine(cfg, params, max_batch=1, max_seq=max_seq, device=dev)
    solo = {}
    for i in sorted(greedy):
        r = reqs[i]
        solo[i] = solo_eng.generate([r.prompt], max_new_tokens=SERVE_NEW, top_k=40, top_p=0.95,
                                    repeat_penalty=1.1, penalty_last_n=64)[0]
    for j, i in enumerate(sorted(greedy)[:4]):
        reqs[i].eos_id = solo[i][8 + 4 * j]
    eng = InferenceEngine(cfg, params, max_batch=B, max_seq=max_seq, device=dev)
    specs = [dataclasses.replace(r, output=[]) for r in reqs]  # unserved, for the runs below
    cb = ContinuousBatcher(eng)
    rec = instrument(cb)
    for r in reqs:
        cb.submit(r)
    torch.cuda.synchronize()
    replays, inside = graphs.STATS.replays, sum(graphs.STATS.replayed_launches.values())
    reset_counts()
    t0 = time.perf_counter()
    done = cb.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ticks = cb.stats["steps"]
    res["launches"]["b16"] = got = check_counts(
        "serving, 16 slots",
        serving_launches(cfg, params, rec, cb.stats["ticks_run"], B, max_seq, False))
    inside = sum(graphs.STATS.replayed_launches.values()) - inside
    st = cb.stats
    log(f"  serving, 16 slots: {st['ticks_run']} ticks run ({ticks} counted), "
        f"{graphs.STATS.replays - replays} graph launches: {st['chunks']} chunks of "
        f"{st['chunk_ticks'] / max(st['chunks'], 1):.1f} on average and "
        f"{st['ticks_run'] - st['chunk_ticks']} admission ticks, one host read each; counted "
        f"kernel launches {inside} inside graphs, {sum(got.values()) - inside} outside (the "
        f"admissions' prefills)")
    if not (len(done) == 64 and bool(cb.logits_finite)):
        raise SystemExit("FAIL: serving at 16 slots lost a request or saw non-finite logits")
    differ = []
    for r in reqs:
        stop = len(r.output) == SERVE_NEW or (r.eos_id is not None and r.output[-1] == r.eos_id)
        if not (stop and all(0 <= t < cfg.vocab_size for t in r.output)):
            raise SystemExit(f"FAIL: request {r.rid} ended at {len(r.output)} tokens, not at "
                             f"{SERVE_NEW} or its eos")
        i = r.rid
        if i in greedy:
            want = solo[i]
            if r.eos_id is not None:
                want = want[: want.index(r.eos_id) + 1]
            if r.output != want:
                d = next(j for j, (a, b) in enumerate(zip(r.output + [-1], want + [-2]))
                         if a != b)
                differ.append((i, d, _top2_gap(solo_eng, r, r.output, d)))
    eos_hit = sum(1 for r in reqs if r.eos_id is not None and len(r.output) < SERVE_NEW)
    res["b16"] = {"tok_s": cb.stats["tokens_out"] / wall, "ticks": ticks,
                  "ms_per_tick": wall / ticks * 1e3, "wall_s": wall,
                  "tokens": cb.stats["tokens_out"], "bursts": rec["bursts"],
                  "singles": len(rec["singles"]), "greedy_differ": differ}
    log(f"  [{gpu_line()}] serving 16 slots x 128: 64 requests, {cb.stats['tokens_out']} tokens "
        f"in {wall:.3f} s wall = {res['b16']['tok_s']:.1f} tok/s; {ticks} ticks, "
        f"{res['b16']['ms_per_tick']:.2f} ms/tick; bursts {rec['bursts']}, "
        f"{len(rec['singles'])} single admissions; {eos_hit} requests stopped at their eos; "
        f"greedy requests differing from their solo run: {len(differ)} of {len(greedy)} "
        f"(request, step, top-2 gap) {differ}")
    if differ:
        raise SystemExit(f"FAIL: {len(differ)} of {len(greedy)} greedy requests served at 16 "
                         f"slots differ from their solo runs (request, first step, top-2 gap of "
                         f"the solo logits there): {differ}")
    # per tick against the chunks, then the graph against the plain batcher
    # (plain, graph, graph, plain): every stream equal to the run above
    streams = [r.output for r in reqs]
    outs, per_tick, _ = serve_copies(eng, specs, max_chunk=1)
    differ = ["per tick"] if outs != streams else []
    ab: dict = {True: [], False: []}
    for i, plain in enumerate((True, False, False, True)):
        outs, w, st = serve_copies(eng, specs, plain=plain)
        ab[plain].append((st["tokens_out"] / w, w / st["steps"] * 1e3))
        differ += [f"A/B run {i} (plain {plain})"] if outs != streams else []
    res["b16"]["per_tick_tok_s"] = sum(len(o) for o in streams) / per_tick
    res["b16"]["ab"] = {"graph": ab[False], "plain": ab[True]}
    log(f"  [{gpu_line()}] serving 16 slots x 128, graph against the plain batcher (plain, "
        f"graph, graph, plain), tok/s and ms/tick: graph "
        f"{', '.join(f'{t:.1f} / {m:.2f}' for t, m in ab[False])}, plain "
        f"{', '.join(f'{t:.1f} / {m:.2f}' for t, m in ab[True])}; per tick (max_chunk 1) "
        f"{res['b16']['per_tick_tok_s']:.1f} tok/s; runs whose 64 streams differ from the "
        f"chunked run's: {differ}")
    if differ:
        raise SystemExit(f"FAIL: serving at 16 slots: streams of {differ} differ from the "
                         f"chunked graph run's")
    if profile is not None:
        cb2 = ContinuousBatcher(eng)
        for i in range(B):
            cb2.submit(serve_request(100 + i, cfg, rng))
        cb2.step()
        profile_ticks(cb2, profile, "16")
        del cb2
    del cb, eng, solo_eng
    _collect()

    # (b) 1024 slots of 2048, one burst of 1024 requests, bf16 then int8 KV
    B, max_seq = big
    for quant in (False, True):
        kv = "int8" if quant else "bf16"
        rng = np.random.default_rng(8)
        reqs = [serve_request(i, cfg, rng, greedy=i % 16 < 3) for i in range(B)]
        eng = InferenceEngine(cfg, params, max_batch=B, max_seq=max_seq, kv_quantized=quant,
                              device=dev)
        cb = ContinuousBatcher(eng)
        rec = instrument(cb)
        for r in reqs:
            cb.submit(r)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        cb.step()  # the burst and the first tick
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        done = cb.run()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        ticks = cb.stats["steps"]
        L = cfg.n_layers
        got = check_counts(f"serving, {B} slots ({kv} KV)",
                           serving_launches(cfg, params, rec, cb.stats["ticks_run"], B, max_seq,
                                            quant))
        if got["decode_attn"] != L * cb.stats["ticks_run"] \
                or got["prefill"] != L * len(rec["bursts"]) \
                or rec["bursts"] != [(B, 64)] or rec["singles"]:
            raise SystemExit(f"FAIL: {B} slots ({kv} KV): flash decode {got['decode_attn']} "
                             f"launches for {ticks} ticks, prefill {got['prefill']} for bursts "
                             f"{rec['bursts']}")
        n_tok = cb.stats["tokens_out"]
        if not (len(done) == B and all(len(r.output) == SERVE_NEW for r in reqs)
                and bool(cb.logits_finite)):
            raise SystemExit(f"FAIL: {B} slots ({kv} KV): a request lacks tokens or a tick's "
                             f"logits are not finite")
        wall = t2 - t0
        res[f"b{B}_{kv}"] = {"tok_s": n_tok / wall, "ticks": ticks,
                              "ms_per_tick": (t2 - t1) / (ticks - 1) * 1e3,
                              "burst_and_first_tick_s": t1 - t0, "wall_s": wall,
                              "tokens": n_tok}
        res["launches"][f"b{B}_{kv}"] = got
        r = res[f"b{B}_{kv}"]
        log(f"  [{gpu_line()}] serving {B} slots x {max_seq}, {kv} KV: {n_tok} tokens in "
            f"{wall:.3f} s wall = {r['tok_s']:.1f} tok/s; the burst ({B} x 64 prefill) and first tick "
            f"{r['burst_and_first_tick_s']:.3f} s (the tick's capture included), then "
            f"{ticks - 1} ticks at {r['ms_per_tick']:.2f} ms/tick; flash decode launched "
            f"{got['decode_attn']} = {L} x {cb.stats['ticks_run']} ticks run, flash prefill "
            f"{got['prefill']} = {L} x 1 burst")
        del cb
        _collect()
        if profile is not None:
            cb = ContinuousBatcher(eng)
            for i in range(B):
                cb.submit(serve_request(i, cfg, rng))
            cb.step()
            profile_ticks(cb, profile, f"{B}_{kv}")
            del cb
        del eng
        _collect()
    return res


# ---------------------------------------------------------------------------
# phase 10: the reference's opt-in decode fusions (TinyLlama-1.1B, full depth)
# ---------------------------------------------------------------------------

# (label, switches, impl, a decode step's launches as (per layer, fixed), int8
# KV, batch, timed): (a) runs on phase 4's load (bf16 pairs), the others on
# phase 6's f32-scale load, under impl "auto"
FUSED_PATHS = (
    ("(a) TKQ_ROTATE_LAYER=1, bf16 pairs", {"TKQ_ROTATE_LAYER": "1"}, "auto",
     ({"rot": 1}, {"rot": -1, "attn_in": 1, "oproj_ffn": 1, "qmm": 1}), False, 1, True),
    ("(b) TKQ_FUSE_LAYER=1 TKQ_KV_APPEND_PALLAS=1, f32 scales",
     {"TKQ_FUSE_LAYER": "1", "TKQ_KV_APPEND_PALLAS": "1"}, "auto",
     ({"layer": 1, "kv_append": 1}, {"qmm": 1}), False, 1, True),
    ("(b) at batch 4", {"TKQ_FUSE_LAYER": "1", "TKQ_KV_APPEND_PALLAS": "1"}, "auto",
     ({"layer": 1, "kv_append": 1}, {"qmm": 1}), False, 4, False),
    ("(c) TKQ_FUSE_ATTN_OUT=1 TKQ_DEFER_APPEND=0 TKQ_KV_APPEND_PALLAS=1, f32 scales, bf16 KV",
     {"TKQ_FUSE_ATTN_OUT": "1", "TKQ_DEFER_APPEND": "0", "TKQ_KV_APPEND_PALLAS": "1"}, "auto",
     ({"attn_in": 1, "kv_append": 1, "attn_out": 1, "ffn": 1}, {"qmm": 1}), False, 1, True),
    ("(c) on int8 KV",
     {"TKQ_FUSE_ATTN_OUT": "1", "TKQ_DEFER_APPEND": "0", "TKQ_KV_APPEND_PALLAS": "1"}, "auto",
     ({"attn_in": 1, "attn_out": 1, "ffn": 1}, {"qmm": 1}), True, 1, True),
)
FUSED_TURNS = 1  # tg128's turns of on, off a path (2 before phase 15: the smoke's 1200 s)
SWITCHES = ("TKQ_KV_APPEND_PALLAS", "TKQ_FUSE_ATTN_OUT", "TKQ_DEFER_APPEND", "TKQ_FUSE_LAYER",
            "TKQ_ROTATE_LAYER", "TKQ_FUSE_OPROJ", "TKQ_INT8_FOLDS", "TKQ_Q4_MXU_MINS",
            "TKQ_GROUP_SCALE", "TKQ_MANUAL_ATTN_IN", "TKQ_MANUAL_OPROJ")


@contextlib.contextmanager
def switches(env: dict):
    """The reference's switches set to `env` (every other one unset) for the
    block, and restored after it, also when it raises."""
    saved = {k: os.environ.get(k) for k in SWITCHES}
    try:
        for k in SWITCHES:
            os.environ.pop(k, None)
        os.environ.update(env)
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def tg128_on_off(cfg, params, dev, env: dict, impl: str, kv_quantized: bool,
                 reps: int = FUSED_TURNS) -> dict:
    """tg128 (128 greedy steps after a 512-token prefill on a 704-slot
    cache, one for each setting) with the switches `env` on and off, `reps`
    turns of on, off (after one warm run of each, which captures the decode
    step); the on-runs' launches checked against the gates. Returns tok/s
    per run and the medians."""
    import numpy as np
    import torch

    from tpu_kquant_torch.runtime.engine import InferenceEngine

    eng = InferenceEngine(cfg, params, max_batch=1, max_seq=704, device=dev, impl=impl,
                          kv_quantized=kv_quantized)
    prompt = np.random.default_rng(3).integers(10, cfg.vocab_size, 512).tolist()
    caches = {on: eng.new_cache(1) for on in (True, False)}  # the warm runs capture on them

    def run(on: bool, check: bool) -> float:
        with switches(env if on else {}):
            first, pos = refill(eng, prompt, caches[on])
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            eng.decode_greedy(first, pos, caches[on], 128)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            if check:
                step = expected_launches(cfg, params, 1, impl, seq=704, kv_int8=kv_quantized)
                check_counts(f"tg128 with the switches {'on' if on else 'off'}",
                             {k: 128 * v for k, v in step.items()})
        return 128 / dt

    run(True, False)
    run(False, False)
    res: dict = {"on": [], "off": []}
    for _ in range(reps):
        for on in (True, False):
            res["on" if on else "off"].append(run(on, True))
    for k in ("on", "off"):
        res[f"{k}_median"] = float(np.median(res[k]))
    return res


def fused_paths(dev, cfg, params, paths) -> dict:
    """Phase 10's `paths` (entries of FUSED_PATHS) on one loaded model;
    returns {label: fused_path's result}."""
    return {path[0]: fused_path(dev, cfg, params, *path) for path in paths}


def fused_path(dev, cfg, params, label: str, env: dict, impl: str, decode: tuple,
               kv_quantized: bool, batch: int, timed: bool) -> dict:
    """Phase 10, one path: with `env` set (and restored after), the decode
    dispatch pinned to `decode` ((per layer, fixed) launches), a 2-layer cut
    on the card against the CPU, three greedy requests (at `batch` 4: four
    as one batch) counted from 0; then, where `timed`, tg128 with the
    switches on and off in turns."""
    phase(f"phase 10: {label}")
    L = cfg.n_layers
    per_layer, fixed = decode
    want = _add({k: L * v for k, v in per_layer.items()}, fixed)
    with switches(env):
        if batch == 1:
            pin_dispatch(cfg, params, f"TinyLlama-1.1B, {label}", want, 2048, impl, seq=704,
                         kv_int8=kv_quantized)
            reference_check(cfg, params, dev, kv_quantized=kv_quantized, impl=impl)
        got = counted_requests(cfg, params, dev, impl, 10 + batch, label, kv_quantized, batch)
    res = {"launches": got}
    if timed:
        res["tg128"] = tg128_on_off(cfg, params, dev, env, impl, kv_quantized)
        t = res["tg128"]
        log(f"  [{gpu_line()}] {label}: tg128 switches on {t['on_median']:.1f} tok/s (runs "
            f"{', '.join(f'{v:.1f}' for v in t['on'])}), off {t['off_median']:.1f} tok/s "
            f"(runs {', '.join(f'{v:.1f}' for v in t['off'])}), {FUSED_TURNS} turn(s) of on, "
            f"off")
    return res


# ---------------------------------------------------------------------------
# phase 7: Qwen2.5-1.5B (biases, tied lm head, the ffn kernel)
# ---------------------------------------------------------------------------

QWEN_MAX_SEQ = 4096 + 128 + 64  # the 3000-token request's bucket + tg128 + 64
QWEN_TIMED_REPS = 1  # pp512 and tg128: one run after a warm one (3 before phase 15)


def qwen2(dev, profile: Path | None = None) -> dict:
    """Phase 7 (module docstring)."""
    from tpu_kquant_torch.models.fixtures import qwen2_5_1_5b_config

    cfg, params, times = load_fixture(qwen2_5_1_5b_config(), "qwen2.5-1.5b-q4_k_m-seed0.gguf",
                                      dev)
    L = cfg.n_layers
    pin_dispatch(cfg, params, "Qwen2.5-1.5B",
                 {"prefill": 0, "attn_in": L, "oproj_ffn": 0, "ffn": L, "qmm": L + 1,
                  "qmm_int8": 0}, 4096)
    reference_check(cfg, params, dev, lengths=(8, 40, 1100), max_seq=LONG_MAX_SEQ)
    res = end_to_end(dev, cfg, params, request_lengths=(5, 40, 200, 3000),
                     request_max_seq=QWEN_MAX_SEQ, profile=profile, tag=" qwen2.5-1.5b",
                     reps=QWEN_TIMED_REPS)
    return {**res, **times}


# ---------------------------------------------------------------------------
# phase 8: Mixtral-8x7B (MoE; bf16 pairs under impl auto, f32 scales under int8)
# ---------------------------------------------------------------------------

MIXTRAL_DEPTH = 1  # a layer's write + load takes over 25 s on the card's host (phase 13 took
#                   the time a second layer cost)
MIXTRAL_CONFIGS = (("bf16 pairs, impl auto", "bf16", "auto"),
                   ("f32 scales, impl int8", "f32", "int8"))


def mixtral(dev, profile: Path | None = None) -> dict:
    """Phase 8 (module docstring). Returns the results of both
    configurations and their main-path launch counts."""
    import dataclasses

    import torch

    from tpu_kquant_torch.models.fixtures import mixtral_8x7b_config

    full = mixtral_8x7b_config()
    cfg0 = dataclasses.replace(full, n_layers=MIXTRAL_DEPTH)
    name = f"mixtral-8x7b-{MIXTRAL_DEPTH}l-q4_k_m-seed0.gguf"
    out: dict = {"launches": {}}
    for label, scale_dtype, impl in MIXTRAL_CONFIGS:
        phase(f"phase 8: Mixtral-8x7B, {label}")
        cfg, params, times = load_fixture(cfg0, name, dev, scale_dtype)
        out.setdefault("reduced", (
            f"depth {MIXTRAL_DEPTH} of {full.n_layers} layers: one layer is 0.93 GB of GGUF "
            f"(24 expert matrices of 58.7 M weights) that the host writes and repacks, over "
            f"25 s a layer, so one layer keeps the phase near 2 minutes; this run: "
            f"{(times['write_s'] + times['load_s']) / MIXTRAL_DEPTH:.1f} s a layer for the "
            f"write and the first load"))
        log(f"  reduced: {out['reduced']}")
        L, E = cfg.n_layers, cfg.n_experts
        decode = {"prefill": 0, "attn_in": L, "oproj_ffn": 0, "ffn": 0,
                  "qmm": (1 + E) * L + 1 if impl == "int8" else (2 + 3 * E) * L + 1,
                  "qmm_int8": (1 + 2 * E) * L if impl == "int8" else 0}
        prefill64 = {"prefill": 0, "attn_in": 0, "oproj_ffn": 0, "ffn": 0,
                     "qmm": (4 + 3 * E) * L + 1, "qmm_int8": 0}
        pin_dispatch(cfg, params, f"Mixtral-8x7B ({label})", decode, 2048, impl, prefill64)
        reference_check(cfg, params, dev, lengths=(8, 40), max_seq=128, depth=1, impl=impl,
                        steps=2)
        res = end_to_end(dev, cfg, params, profile=profile, tag=f" mixtral-{scale_dtype}-{impl}",
                         impl=impl)
        out[label] = {**res, **times}
        out["launches"][label] = res["main_path_launches"]
        del params
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 9: GGML types (the recipes of the reference's quantize tool)
# ---------------------------------------------------------------------------

GGML_DEPTH = 2  # every recipe's depth, untimed (the smoke's time limit: 4 before phase
#                 13; Q8_0 at full depth and timed before phase 15)
# (label, recipe, full depth and timed, load options, impl, a decode step's
# launches per layer, the lm head's kernel), as the recipe table gives them:
# Q8_0 and Q6_K fuse every slot; Q5_K_M's, Q3_K_M's and Q2_K's wqk and
# gate/up are bit-plane kinds, which no fused gate takes; Q4_K_S's down is
# q4, which both FFN gates refuse; unwidened q6 is fused nowhere and, on f32
# scales under impl "int8", goes to qmm_int8 with every q4 weight.
GGML_CONFIGS = (
    ("Q8_0", "q8_0", False, {}, "auto", {"attn_in": 1, "oproj_ffn": 1}, "qmm"),
    ("Q5_K_M", "q5_k_m", False, {}, "auto", {"qmm": 5}, "qmm"),
    ("Q6_K", "q6_k", False, {}, "auto", {"attn_in": 1, "oproj_ffn": 1}, "qmm"),
    ("Q4_K_S", "q4_k_s", False, {}, "auto", {"attn_in": 1, "qmm": 3}, "qmm"),
    ("Q3_K_M", "q3_k_m", False, {}, "auto", {"qmm": 5}, "qmm"),
    ("Q2_K", "q2_k", False, {}, "auto", {"qmm": 5}, "qmm"),
    ("Q4_K_M widen_q6=False, bf16 pairs", "q4_k_m", False, {"widen_q6": False}, "auto",
     {"qmm": 5}, "qmm"),
    ("Q4_K_M widen_q6=False, f32 scales, impl int8", "q4_k_m", False,
     {"widen_q6": False, "scale_dtype": "f32"}, "int8", {"qmm_int8": 5}, "qmm_int8"),
)


def _kinds(params) -> str:
    """The packed kind and side layout of each weight of layer 0, the lm
    head and the embedding, for the log."""
    def one(qt):
        side = "sm" if "sm" in qt.arrays else "sp" if "sp" in qt.arrays else "f32"
        return f"{qt.kind}-{side}"

    lay = params["layers"][0]
    names = [k for k in ("wqk", "wv", "wo", "w_gateup", "w_down") if k in lay]
    return ", ".join([f"{k} {one(lay[k])}" for k in names]
                     + [f"output {one(params['output'])}", f"tok_embd {one(params['tok_embd'])}"])


def ggml_types(dev, profile: Path | None = None) -> dict:
    """Phase 9: TinyLlama-1.1B at full width under every recipe of the
    reference's quantize tool, one load at a time: the dispatch pinned per
    recipe, a 2-layer cut against the CPU, three greedy requests counted
    from 0; each cut to GGML_DEPTH layers (Q5_K_M since phase 13, Q8_0
    since phase 15; a recipe marked timed in GGML_CONFIGS runs at full depth
    with pp512 and tg128 beside their bounds). Returns the results and the
    requests' launch counts."""
    import dataclasses

    import torch

    from tpu_kquant_torch.models.fixtures import tinyllama_1b_config

    full = tinyllama_1b_config()
    out: dict = {"launches": {}, "reduced": (
        f"Q8_0, Q5_K_M, Q6_K, Q4_K_S, Q3_K_M, Q2_K and Q4_K_M (widen_q6=False, two loads) at "
        f"depth {GGML_DEPTH} of {full.n_layers} layers, untimed: the smoke's time limit")}
    log(f"  reduced: {out['reduced']}")
    for label, recipe, timed, load_kw, impl, per_layer, head in GGML_CONFIGS:
        phase(f"phase 9: TinyLlama-1.1B {label}")
        cfg0 = full if timed else dataclasses.replace(full, n_layers=GGML_DEPTH)
        name = f"tinyllama-1.1b-{recipe}-{cfg0.n_layers}l-seed0.gguf"
        cfg, params, times = load_fixture(cfg0, name, dev, load_kw.get("scale_dtype", "bf16"),
                                          recipe, load_kw.get("widen_q6", True))
        log(f"  kinds: {_kinds(params)}")
        L = cfg.n_layers
        decode = {k: v * L for k, v in per_layer.items()}
        decode[head] = decode.get(head, 0) + 1
        pin_dispatch(cfg, params, f"TinyLlama-1.1B {label}", decode, 2048, impl,
                     {"qmm": 5 * L + 1})
        reference_check(cfg, params, dev, impl=impl)
        if timed:
            res = end_to_end(dev, cfg, params, profile=profile, tag=f" {recipe}", impl=impl)
            out[label] = {**res, **times}
            out["launches"][label] = res["main_path_launches"]
        else:
            out["launches"][label] = counted_requests(cfg, params, dev, impl, 9, label)
            out[label] = times
        del params
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 13: the gemma family (GELU, head_dim 256; gemma2's quirks)
# ---------------------------------------------------------------------------

GEMMA_MAX_SEQ = 4096 + 128 + 64  # the 3000-token request's bucket + tg128 + 64
GEMMA2_DEPTH = 2  # Gemma-2-9B's layers on the card (of 42)
GEMMA_DEPTH = 6  # Gemma-2B's layers on the card (of 18; all before phase 16, 9 before phase
#                  18: the 1200 s)
GEMMA_TIMED_REPS = 1  # Gemma-2B's pp512 / tg128: one run after a warm one (3 before phase 15)


def gemma(dev, profile: Path | None = None) -> dict:
    """Phase 13 (module docstring): Gemma-2B at full width and GEMMA_DEPTH, then
    Gemma-2-9B cut to GEMMA2_DEPTH layers. Returns Gemma-2B's results (its
    requests' launches under main_path_launches) and the cut, loaded
    (``gemma2_9b``: cfg, params)."""
    import dataclasses

    import torch

    from tpu_kquant_torch.models.fixtures import gemma2_9b_config, gemma_2b_config

    full = gemma_2b_config()
    cfg, params, times = load_fixture(dataclasses.replace(full, n_layers=GEMMA_DEPTH),
                                      f"gemma-2b-{GEMMA_DEPTH}l-q4_k_m-seed0.gguf", dev)
    L = cfg.n_layers
    log(f"  reduced: Gemma-2B at depth {L} of {full.n_layers} layers (the smoke's 1200 s)")
    # decode: attn_in at head_dim 256 and oproj_ffn with GELU in every
    # layer, the tied lm head a qmm; the 3000-token request's bucket 4096
    # runs the flash prefill at head_dim 256 in every layer
    pin_dispatch(cfg, params, "Gemma-2B",
                 {"prefill": 0, "attn_in": L, "oproj_ffn": L, "ffn": 0, "qmm": 1, "qmm_int8": 0},
                 4096)
    reference_check(cfg, params, dev)
    res = end_to_end(dev, cfg, params, request_lengths=(5, 40, 200, 3000),
                     request_max_seq=GEMMA_MAX_SEQ, profile=profile, tag=" gemma-2b",
                     reps=GEMMA_TIMED_REPS)
    # the rotated layer boundary: layer 0's rot kernel (GELU, then layer 1's
    # QKV at head_dim 256), a 2-layer cut against the CPU
    with switches({"TKQ_ROTATE_LAYER": "1"}):
        reset_counts()
        reference_check(cfg, params, dev, lengths=(8,), steps=2)
        n_rot = counts()["rot"]
    log(f"  TKQ_ROTATE_LAYER=1: the rot kernel launched {n_rot} times in the 2-layer cut")
    if n_rot == 0:
        raise SystemExit("FAIL: Gemma-2B under TKQ_ROTATE_LAYER=1 never launched rot")
    del params
    torch.cuda.empty_cache()

    full = gemma2_9b_config()
    cut = dataclasses.replace(full, n_layers=GEMMA2_DEPTH)
    out = {**res, **times, "reduced": (
        f"Gemma-2-9B at depth {GEMMA2_DEPTH} of {full.n_layers} layers, a reference_check "
        f"only: a layer of its width costs write and load time that the smoke's budget does "
        f"not have")}
    log(f"  reduced: {out['reduced']}")
    cfg, params, t9 = load_fixture(cut, f"gemma-2-9b-{GEMMA2_DEPTH}l-q4_k_m-seed0.gguf", dev)
    # post norms keep oproj_ffn and ffn off, the softcap keeps the flash
    # kernels off; attn_in runs at head_dim 256
    reference_check(cfg, params, dev, lengths=(8,), steps=2, depth=GEMMA2_DEPTH)
    out["gemma2_9b_cut"] = t9
    out["gemma2_9b"] = (cfg, params)  # phase 15 runs it on the iSWA layout
    return out


# ---------------------------------------------------------------------------
# phase 15: the sliding-window family (Phi-3-mini-4k on both KV layouts;
# Gemma-2-9B's cut on the iSWA layout)
# ---------------------------------------------------------------------------

PHI3_MAX_SEQ = 4096  # Phi-3-mini-4k's context: the 3000-token request's bucket
PHI3_TIMED_REPS = 1  # pp512 and tg128 on each layout: one timed run after a warm one
PHI3_DEPTH = 8  # Phi-3-mini-4k's layers on the card (of 32; all before phase 16, 16 before
#                 phase 18: the 1200 s)
GEMMA2_LONG = 5000  # past Gemma-2-9B's window of 4096: its ring of 4608 wraps
GEMMA2_RING_KV = (False,)  # the ring cut's KV kinds: bf16 (int8 wraps Phi-3's ring below;
#                            Gemma-2-9B's int8 CPU side took 40-44 s of the 1200 s)
PHI3_RING_LONG = 2600  # past Phi-3-mini's window of 2047: its ring of 2560 wraps


def sliding_window(dev, g9, profile: Path | None = None) -> dict:
    """Phase 15 (module docstring): Phi-3-mini-4k at full width and PHI3_DEPTH on
    the unified and the iSWA layout, then phase 13's Gemma-2-9B cut `g9`
    (cfg, params) on the iSWA layout against the CPU. Returns the main
    path's launches (end_to_end's requests on both layouts and the CLI run)
    and the numbers it printed."""
    import dataclasses

    import numpy as np
    import torch

    from tpu_kquant_torch.gguf import GGUFReader
    from tpu_kquant_torch.models.fixtures import phi3_mini_4k_config
    from tpu_kquant_torch.runtime.engine import InferenceEngine
    from tpu_kquant_torch.tokenizer import from_gguf_metadata
    from tpu_kquant_torch.tools import main as main_cli

    t_phase = time.perf_counter()
    gpu = gpu_line()
    steps: dict = {}  # wall seconds of each step, logged at the end

    def lap(what: str) -> None:
        steps[what] = time.perf_counter() - t_phase - sum(steps.values())

    full = phi3_mini_4k_config()
    name = f"phi3-mini-4k-{PHI3_DEPTH}l-q4_k_m-seed0.gguf"
    cfg, params, times = load_fixture(dataclasses.replace(full, n_layers=PHI3_DEPTH), name, dev)
    L = cfg.n_layers
    log(f"  reduced: Phi-3-mini-4k at depth {L} of {full.n_layers} layers (the smoke's 1200 s)")
    res: dict = {"gpu": gpu, **times}
    # decode: attn_in on wqkv's two slots and oproj_ffn in every layer, the
    # lm head a qmm, on either layout; no flash prefill at head_dim 96 (the
    # kernel's D % 64) and none on a ring
    step = {"attn_in": L, "oproj_ffn": L, "qmm": 1}
    pin_dispatch(cfg, params, "Phi-3-mini-4k", step, PHI3_MAX_SEQ, flash_layers=0)
    ring_step = _nonzero(expected_launches(cfg, params, 1, iswa=True))
    if ring_step != step:
        raise SystemExit(f"FAIL: Phi-3-mini-4k on the iSWA layout: a decode step dispatches as "
                         f"{ring_step}, expected {step}")
    lap("write, load, pins")

    # (b) 2-layer cuts against the CPU on both layouts (8 tokens; on the
    # ring also PHI3_RING_LONG tokens on int8 KV, which wrap it; the bf16
    # ring's wrap against the CPU is (d)'s, against the unified layout
    # (c)'s); (e) the
    # unified cut under TKQ_ROTATE_LAYER=1 must launch rot with the next
    # layer's wqkv slots
    reference_check(cfg, params, dev)
    reference_check(cfg, params, dev, lengths=(8,), max_seq=PHI3_MAX_SEQ, steps=2,
                    kv_layout="iswa")
    reference_check(cfg, params, dev, lengths=(PHI3_RING_LONG,), max_seq=PHI3_MAX_SEQ, steps=2,
                    kv_quantized=True, kv_layout="iswa")
    with switches({"TKQ_ROTATE_LAYER": "1"}):
        reset_counts()
        reference_check(cfg, params, dev, lengths=(8,), steps=2)
        n_rot = counts()["rot"]
    log(f"  TKQ_ROTATE_LAYER=1: the rot kernel launched {n_rot} times in the 2-layer cut")
    if n_rot == 0:
        raise SystemExit("FAIL: Phi-3-mini-4k under TKQ_ROTATE_LAYER=1 never launched rot")
    lap("cuts against the CPU")

    # (a) the main path at full depth on each layout: requests of 5-3000
    # tokens (3000 passes the window and the ring), pp512, tg128
    launches: dict = {}
    for layout in ("unified", "iswa"):
        t0 = time.perf_counter()
        r = end_to_end(dev, cfg, params, request_lengths=(5, 40, 200, 3000),
                       request_max_seq=PHI3_MAX_SEQ, timed_max_seq=PHI3_MAX_SEQ,
                       kv_layout=layout, reps=PHI3_TIMED_REPS, tag=f" phi-3-mini {layout}",
                       profile=profile, ab=True)
        r["seconds"] = time.perf_counter() - t0
        launches = _add(launches, r["main_path_launches"])
        res[layout] = r
        lap(f"{layout}: requests, pp512, tg128")

    # (c) the ring against the unified layout on the 3000-token prompt
    rng = np.random.default_rng(15)
    prompt = rng.integers(10, cfg.vocab_size, 3000).tolist()
    last = {}
    for layout in ("unified", "iswa"):
        eng = InferenceEngine(cfg, params, max_seq=PHI3_MAX_SEQ, device=dev, kv_layout=layout)
        cache = eng.new_cache(1)
        last[layout] = eng.prefill([prompt], cache)[0][0].float()
        if layout == "iswa":
            log(f"  ring of {cache.ring} slots (window {cfg.sliding_window} + chunk "
                f"{eng.iswa_chunk}), {len(prompt)} prompt tokens")
        del eng, cache
    rel = float((last["iswa"] - last["unified"]).abs().max() / last["unified"].abs().max())
    same_top = int(last["iswa"].argmax()) == int(last["unified"].argmax())
    res["iswa_vs_unified_rel"] = rel
    log(f"  [{gpu}] 3000-token prompt at full depth: last logits on the ring against the "
        f"unified layout rel err {rel:.2e}, same top token {same_top}")
    if not (torch.isfinite(last["iswa"]).all() and rel < 5e-2):
        raise SystemExit(f"FAIL: the iSWA layout's logits differ from the unified layout's "
                         f"({rel:.3e})")
    lap("ring against unified")

    # the generate CLI on the ring (its own load), its ids equal generate's
    path = str(FIXTURE_DIR / name)
    tok = from_gguf_metadata(GGUFReader(path).metadata)
    ids = tok.encode(FD_PROMPT, add_bos=True)
    t0 = time.perf_counter()
    with main_run("tools/main.py --kv-layout iswa", launches):
        out = main_cli.run(["-m", path, "-p", FD_PROMPT, "-n", "32", "--kv-layout", "iswa",
                            "--max-seq", str(PHI3_MAX_SEQ)])
    wall = time.perf_counter() - t0
    want = InferenceEngine(cfg, params, max_seq=PHI3_MAX_SEQ, device=dev,
                           kv_layout="iswa").generate([ids], max_new_tokens=32,
                                                      eos_id=tok.eos_id)[0]
    res["cli_tok_s"] = len(out["ids"]) / out["seconds"]
    log(f"  [{gpu}] tools/main.py --kv-layout iswa -n 32: {len(out['ids'])} tokens, "
        f"{res['cli_tok_s']:.1f} tok/s (generation {out['seconds']:.2f} s; {wall:.1f} s with "
        f"the CLI's load); ids equal generate's: {out['ids'] == want}")
    if out["ids"] != want or not out["ids"]:
        raise SystemExit(f"FAIL: tools/main.py --kv-layout iswa differs from generate: "
                         f"{out['ids']} against {want}")
    del params
    torch.cuda.empty_cache()
    lap("the CLI")

    # (d) Gemma-2-9B's cut (a window layer and a full one) on the iSWA
    # layout against the CPU, bf16 KV (GEMMA2_RING_KV), a prompt past the window
    cfg9, params9 = g9
    reference_check(cfg9, params9, dev, lengths=(GEMMA2_LONG,), max_seq=GEMMA2_LONG + 64,
                    kv_quantized=GEMMA2_RING_KV, steps=2, depth=cfg9.n_layers, kv_layout="iswa")
    lap("gemma-2-9b cut on the ring")
    res["launches"] = launches
    res["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 15 took {res['seconds']:.1f} s: " + ", ".join(
        f"{k} {v:.1f} s" for k, v in steps.items()))
    return res


# ---------------------------------------------------------------------------
# phase 16: the recurrent family (Mamba-2.8B, full width and depth)
# ---------------------------------------------------------------------------

# the writer's weight std for Mamba-2.8B: at the default 0.05 the SSM's
# output is so small beside the residual stream that the last logits hardly
# depend on the earlier tokens (a 4-layer cut: 0.6% of max|logits| on the
# CPU), and the state checks below would see little; at 0.1 they move by
# more than max|logits| (PERF.md §4)
MAMBA_SCALE = 0.1
MAMBA_MAX_SEQ = 2048  # Mamba-2.8B's context
MAMBA_SERVE = (16, 128, 64)  # slots, cache length, requests
# (requests submitted, ticks stepped after): 10 at once (a burst into fresh
# slots), then one a tick (six single admissions into fresh slots, then a
# queue); every request makes 48 tokens, so the first ten retire together
# (a burst into their slots) and the next six one a tick (single admissions
# into slots that finished requests held), and so on
MAMBA_WAVES = ((10, 1),) + ((1, 1),) * 54
# the greedy requests, one of each admission: 4 a burst into fresh slots,
# 12 a single admission into a fresh slot, 20 a burst and 28 a single
# admission into reused slots (the admissions are logged, and a phase
# without a greedy single admission into a reused slot fails); 8 before the
# smoke's 1200 s ran short, their solo runs 23 s on a slow host
MAMBA_GREEDY = (4, 12, 20, 28)
MAMBA_BURST = (16, 2048)  # rows and tokens of the scan's memory check
MAMBA_TOL = 5e-2  # the 2-layer cut: logits and final states against the CPU, of max|ref|


def mamba_pins(cfg, params, dev) -> None:
    """Pinned dispatch: every matmul weight is packed for qmm's kernel; a
    decode step and a 64-token prefill each launch qmm 4 L + 1 times and
    run no plain version, and the prefill's matmuls (ssm_x and ssm_dt among
    them) take the tile."""
    import torch

    from tpu_kquant_torch.ops import _build
    from tpu_kquant_torch.ops import qmm as qmm_mod
    from tpu_kquant_torch.runtime.engine import InferenceEngine

    L = cfg.n_layers
    mats = {k: params["layers"][0][k] for k in ("ssm_in", "ssm_x", "ssm_dt", "ssm_out")}
    mats["lm head"] = params["output"]
    kinds = {k: qmm_mod.KINDS[qmm_mod.kernel_kind(w)] for k, w in mats.items()
             if w.kind != "dense" and qmm_mod.kernel_kind(w) is not None}
    log(f"  Mamba-2.8B's matmuls: " + ", ".join(
        f"{k} {'-'.join(kinds[k]) if k in kinds else mats[k].kind} {list(mats[k].shape)}"
        for k in mats))
    if len(kinds) != len(mats) or any(
            qmm_mod.kernel_kind(lay[k]) is None for lay in params["layers"]
            for k in ("ssm_in", "ssm_x", "ssm_dt", "ssm_out")):
        raise SystemExit("FAIL: Mamba-2.8B: a matmul weight is not one qmm's kernel reads")
    want = expected_launches(cfg, params, 1)
    if want["qmm"] != 4 * L + 1 or sum(want.values()) != want["qmm"]:
        raise SystemExit(f"FAIL: Mamba-2.8B: the gates dispatch a forward as {_nonzero(want)}, "
                         f"expected qmm {4 * L + 1}")
    eng = InferenceEngine(cfg, params, max_seq=128, device=dev)
    tiles: set = set()
    real = qmm_mod.tile_plan

    def spy(R, N, K, code):
        tiles.add((int(N), int(K)))
        return real(R, N, K, code)

    cache = eng.new_cache(1)
    for what, run in (("64-token prefill", lambda: eng.prefill([list(range(10, 74))], cache)),
                      ("decode step", lambda: eng.decode_step(
                          torch.tensor([5], device=dev), torch.tensor([64], device=dev),
                          cache))):
        reset_counts()
        plain0 = {k: c.plain_calls for k, c in _build.COUNTERS.items()}
        qmm_mod.tile_plan = spy
        try:
            run()
        finally:
            qmm_mod.tile_plan = real
        torch.cuda.synchronize()
        plain = {k: c.plain_calls - plain0[k] for k, c in _build.COUNTERS.items()
                 if c.plain_calls != plain0[k]}
        check_counts(f"Mamba-2.8B's {what}", want)
        if plain:
            raise SystemExit(f"FAIL: Mamba-2.8B's {what} ran plain versions: {plain}")
        if what.startswith("64"):
            shapes = {tuple(int(d) for d in w.shape) for w in mats.values()}
            log(f"  the 64-token prefill's tile calls at (N, K) {sorted(tiles)}")
            if not shapes <= tiles:
                raise SystemExit(f"FAIL: Mamba-2.8B's prefill left {sorted(shapes - tiles)} "
                                 f"off the tile")
            tiles.clear()
        elif tiles:
            raise SystemExit(f"FAIL: Mamba-2.8B's decode step took the tile at {tiles}")


def mamba_scan_invariance(cfg, params, dev) -> None:
    """mamba_layer_scan on layer 0: each row of a 16-row call (T = 1, the
    GEMV; T = 64, the tile), with random inputs and states, equals the row
    computed alone, bit for bit (output, conv and SSM states): the plain
    ops' reductions are sums over fixed small axes. Fatal."""
    import torch

    from tpu_kquant_torch.models.mamba import mamba_layer_scan

    gen = torch.Generator(device=dev).manual_seed(16)
    lay = params["layers"][0]
    for T in (1, 64):
        B = 16
        x = (torch.randn(B, T, cfg.dim, generator=gen, device=dev) * 0.3).to(torch.bfloat16)
        conv = torch.randn(B, cfg.ssm_d_conv - 1, cfg.ssm_d_inner, generator=gen, device=dev)
        ssm = torch.randn(B, cfg.ssm_d_inner, cfg.ssm_d_state, generator=gen, device=dev)
        valid = torch.ones(B, T, dtype=torch.bool, device=dev)
        valid[1::2, T // 2 + 1:] = False  # right-padded rows
        got = mamba_layer_scan(lay, cfg, x, conv, ssm, valid)
        bad = [b for b in range(B)
               if not all(torch.equal(g[b:b + 1], o) for g, o in zip(got, mamba_layer_scan(
                   lay, cfg, x[b:b + 1], conv[b:b + 1], ssm[b:b + 1], valid[b:b + 1])))]
        log(f"  mamba_layer_scan at B = 16, T = {T}: rows differing from the row alone: {bad}")
        if bad:
            raise SystemExit(f"FAIL: mamba_layer_scan's rows {bad} at B = 16, T = {T} differ "
                             f"from the rows computed alone")


def mamba_cut(cfg, params, dev, depth: int = 2, lengths=(5, 200), steps: int = 16) -> dict:
    """A `depth`-layer cut on the card against the CPU's plain versions: a
    right-padded prefill of two rows (`lengths` tokens), then `steps` decode
    steps fed the CPU's greedy tokens: every step's logits within MAMBA_TOL
    of max|ref|, the card's first greedy token in the CPU's top 5, and the
    final conv and ssm states within MAMBA_TOL of max|ref|."""
    import dataclasses

    import numpy as np
    import torch

    from tpu_kquant_torch.runtime.engine import InferenceEngine

    cut = dataclasses.replace(cfg, n_layers=depth)
    p_gpu = {**params, "layers": params["layers"][:depth]}
    rng = np.random.default_rng(16)
    prompts = [rng.integers(10, cfg.vocab_size, n).tolist() for n in lengths]
    runs = {}
    with cpu_dequant_memo():
        for d, p in (("cpu", _to_cpu(p_gpu)), (dev, p_gpu)):
            eng = InferenceEngine(cut, p, max_batch=len(prompts), max_seq=512, device=d)
            logits, cache, lens = eng.prefill(prompts, eng.new_cache(len(prompts)))
            seq = [logits.float().cpu()]
            toks = runs["cpu"]["toks"] if "cpu" in runs else []
            pos = torch.tensor(lens, device=d)
            for i in range(steps):
                if d == "cpu":
                    toks.append(torch.argmax(seq[-1], -1))
                logits, cache = eng.decode_step(toks[i].to(d), pos + i, cache)
                seq.append(logits.float().cpu())
            runs["cpu" if d == "cpu" else "card"] = {
                "logits": seq, "toks": toks, "conv": cache.conv.cpu(), "ssm": cache.ssm.cpu()}
    c, g = runs["cpu"], runs["card"]
    rel = max(float((a - b).abs().max() / b.abs().max()) for a, b in zip(g["logits"],
                                                                            c["logits"]))
    top5 = all(int(g["logits"][0][b].argmax()) in torch.topk(c["logits"][0][b], 5).indices
               for b in range(len(prompts)))
    steps_top5 = sum(int(a[b].argmax()) in torch.topk(r[b], 5).indices
                     for a, r in zip(g["logits"], c["logits"]) for b in range(len(prompts)))
    st = {k: float((g[k] - c[k]).abs().max() / c[k].abs().max()) for k in ("conv", "ssm")}
    log(f"  {depth}-layer cut, prompts of {list(lengths)} tokens (one right-padded prefill) and "
        f"{steps} decode steps: logits rel err {rel:.2e} (worst step), first greedy token in "
        f"the CPU's top 5: {top5}, every step's in its top 5: {steps_top5} of "
        f"{len(g['logits']) * len(prompts)}; final states rel err conv {st['conv']:.2e}, ssm "
        f"{st['ssm']:.2e}")
    if not (all(torch.isfinite(x).all() for x in g["logits"]) and rel < MAMBA_TOL and top5
            and max(st.values()) < MAMBA_TOL):
        raise SystemExit("FAIL: Mamba-2.8B's cut on the card disagrees with the CPU")
    return {"logits_rel": rel, **{f"{k}_rel": v for k, v in st.items()}}


def mamba_serving(cfg, params, dev) -> dict:
    """16 slots, 64 of tools_serve_bench.py's requests (prompts of 32-63
    tokens, 48 new; MAMBA_GREEDY greedy, the rest sampled), submitted as
    MAMBA_WAVES (10, then one a tick), counted from 0 (main_run). Fatal: a
    lost request or non-finite logits; no single admission into a slot that
    a finished request held, or none of a greedy request (the slot prefill
    that zeroes the reused row); a greedy stream that differs from its solo
    engine.generate, token for token; a stream of the same waves served per
    tick (max_chunk 1) that differs from the chunked run's."""
    import dataclasses

    import numpy as np
    import torch

    from tpu_kquant_torch.runtime.engine import InferenceEngine
    from tpu_kquant_torch.serving import ContinuousBatcher

    B, max_seq, n = MAMBA_SERVE
    rng = np.random.default_rng(17)
    greedy = set(MAMBA_GREEDY)
    reqs = [serve_request(i, cfg, rng, greedy=i in greedy) for i in range(n)]
    specs = [dataclasses.replace(r, output=[]) for r in reqs]  # unserved, for the per-tick run
    solo_eng = InferenceEngine(cfg, params, max_batch=1, max_seq=max_seq, device=dev)
    t0 = time.perf_counter()
    solo = {i: solo_eng.generate([reqs[i].prompt], max_new_tokens=SERVE_NEW, top_k=40,
                                 top_p=0.95, repeat_penalty=1.1, penalty_last_n=64)[0]
            for i in sorted(greedy)}
    t_solo = time.perf_counter() - t0
    eng = InferenceEngine(cfg, params, max_batch=B, max_seq=max_seq, device=dev)
    cb = ContinuousBatcher(eng)
    rec = instrument(cb)
    # which admissions refill a slot that an earlier request held
    index = {id(r): i for i, r in enumerate(reqs)}
    held: set = set()
    adm: dict = {"burst fresh": [], "burst reused": [], "single fresh": [], "single reused": []}
    real_burst, real_admit = cb._admit_burst, cb._admit

    def burst(pairs):
        for b, r in pairs:
            adm["burst reused" if b in held else "burst fresh"].append(index[id(r)])
            held.add(b)
        return real_burst(pairs)

    def admit(b, req):
        adm["single reused" if b in held else "single fresh"].append(index[id(req)])
        held.add(b)
        return real_admit(b, req)

    cb._admit_burst, cb._admit = burst, admit
    launches: dict = {}
    torch.cuda.synchronize()
    with main_run(f"serving Mamba-2.8B, {B} slots", launches):
        t0 = time.perf_counter()
        first = 0
        for count, ticks_after in MAMBA_WAVES:
            for r in reqs[first:first + count]:
                cb.submit(r)
            first += count
            for _ in range(ticks_after):
                cb.step()
        done = cb.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ticks = cb.stats["steps"]
    if not (first == n and sum(1 for r in reqs if r.done) == n
            and bool(cb.logits_finite)
            and all(len(r.output) == SERVE_NEW for r in reqs)):
        raise SystemExit(f"FAIL: serving Mamba-2.8B lost a request or saw non-finite logits "
                         f"({len(done)} done at the end)")
    differ = [(i, next(j for j, (a, b) in enumerate(zip(reqs[i].output, solo[i])) if a != b))
              for i in sorted(greedy) if reqs[i].output != solo[i]]
    greedy_adm = {k: sorted(greedy & set(v)) for k, v in adm.items()}
    res = {"tok_s": cb.stats["tokens_out"] / wall, "ticks": ticks,
           "ms_per_tick": wall / ticks * 1e3, "bursts": rec["bursts"],
           "singles": len(rec["singles"]), "admissions": {k: len(v) for k, v in adm.items()},
           "greedy_admissions": greedy_adm, "solo_s": t_solo, "greedy_differ": differ,
           "launches": launches}
    log(f"  [{gpu_line()}] serving Mamba-2.8B, {B} slots: {n} requests (10, then one a tick), "
        f"{cb.stats['tokens_out']} tokens in {wall:.3f} s wall = {res['tok_s']:.1f} tok/s; "
        f"{ticks} ticks, {res['ms_per_tick']:.2f} ms/tick; bursts {rec['bursts']}, "
        f"{len(rec['singles'])} single admissions; admissions "
        + ", ".join(f"{k} {len(v)} (greedy {greedy_adm[k]})" for k, v in adm.items())
        + f"; greedy streams differing from their solo runs ({t_solo:.1f} s): "
        f"{len(differ)} of {len(greedy)} {differ}")
    if not adm["single reused"] or not greedy_adm["single reused"]:
        raise SystemExit(f"FAIL: serving Mamba-2.8B made no single admission of a greedy "
                         f"request into a slot a finished request held: {adm}")
    if differ:
        raise SystemExit(f"FAIL: {len(differ)} of {len(greedy)} greedy Mamba-2.8B streams "
                         f"served at {B} slots differ from their solo runs: {differ}")
    per_tick = ContinuousBatcher(eng)
    first = 0
    t0 = time.perf_counter()
    for count, ticks_after in MAMBA_WAVES:
        for r in specs[first:first + count]:
            per_tick.submit(r)
        first += count
        for _ in range(ticks_after):
            per_tick.step()
    per_tick.run(max_chunk=1)
    torch.cuda.synchronize()
    res["per_tick_s"] = time.perf_counter() - t0
    n_diff = sum(a.output != b.output for a, b in zip(specs, reqs))
    log(f"  the same waves served per tick (max_chunk 1) in {res['per_tick_s']:.2f} s: streams "
        f"differing from the chunked run's: {n_diff} of {n}")
    if n_diff:
        raise SystemExit(f"FAIL: {n_diff} Mamba-2.8B streams served per tick differ from the "
                         f"chunked run's")
    del cb, per_tick, eng, solo_eng
    _collect()
    return res


def mamba_burst_memory(cfg, params, dev) -> dict:
    """mamba_layer_scan on layer 0 over a MAMBA_BURST burst (16 rows of 2048
    tokens, right-padded rows among them): its peak device memory above
    what was allocated before, against one [16, 2048, d_inner, d_state] f32
    tensor, the size that dA, dBx and the kept states each had before the
    scan went in chunks. Fatal if the peak reaches it."""
    import torch

    from tpu_kquant_torch.models.mamba import SCAN_CHUNK_ELEMS, mamba_layer_scan

    B, T = MAMBA_BURST
    di, ds = cfg.ssm_d_inner, cfg.ssm_d_state
    gen = torch.Generator(device=dev).manual_seed(18)
    x = (torch.randn(B, T, cfg.dim, generator=gen, device=dev) * 0.3).to(torch.bfloat16)
    conv = torch.zeros(B, cfg.ssm_d_conv - 1, di, device=dev)
    ssm = torch.zeros(B, di, ds, device=dev)
    valid = torch.ones(B, T, dtype=torch.bool, device=dev)
    valid[1::2, T // 2:] = False
    _collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    out = mamba_layer_scan(params["layers"][0], cfg, x, conv, ssm, valid)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    whole = 4 * B * T * di * ds
    finite = all(bool(torch.isfinite(o).all()) for o in out)
    log(f"  mamba_layer_scan over a burst of {B} x {T} tokens: peak device memory "
        f"{peak / 1e9:.3f} GB above its inputs ({wall:.2f} s; chunks of "
        f"{max(1, SCAN_CHUNK_ELEMS // (B * di * ds))} steps), against one whole "
        f"[{B}, {T}, {di}, {ds}] f32 tensor of {whole / 1e9:.3f} GB; finite: {finite}")
    if not (finite and peak < whole):
        raise SystemExit(f"FAIL: mamba_layer_scan's {B} x {T} burst peaked at {peak / 1e9:.3f} "
                         f"GB (or gave non-finite values)")
    del x, conv, ssm, valid, out
    _collect()
    return {"peak_gb": peak / 1e9, "whole_gb": whole / 1e9, "seconds": wall}


def recurrent(dev, profile: Path | None = None) -> dict:
    """Phase 16 (module docstring): Mamba-2.8B at full width and depth.
    Returns the main path's launches and the numbers it printed."""
    import numpy as np
    import torch

    from tpu_kquant_torch.gguf import GGUFReader
    from tpu_kquant_torch.models.fixtures import mamba_2_8b_config
    from tpu_kquant_torch.runtime.engine import InferenceEngine
    from tpu_kquant_torch.tokenizer import from_gguf_metadata
    from tpu_kquant_torch.tools import main as main_cli

    t_phase = time.perf_counter()
    gpu = gpu_line()
    steps: dict = {}

    def lap(what: str) -> None:
        steps[what] = time.perf_counter() - t_phase - sum(steps.values())

    name = f"mamba-2.8b-q4_k_m-scale{MAMBA_SCALE}-seed0.gguf"
    cfg, params, times = load_fixture(mamba_2_8b_config(), name, dev, scale=MAMBA_SCALE)
    res: dict = {"gpu": gpu, **times}
    w_bytes, _ = weight_work(params)
    state_bytes = 2 * 4 * cfg.n_layers * (cfg.ssm_d_conv - 1 + cfg.ssm_d_state) * cfg.ssm_d_inner
    res["decode_bytes"] = w_bytes + state_bytes
    log(f"  a decode step reads {w_bytes / 1e9:.4f} GB of weights and side arrays and reads "
        f"and writes {state_bytes / 1e6:.2f} MB of state: bound "
        f"{bound_ms(res['decode_bytes'], 0)[0]:.4f} ms")
    mamba_pins(cfg, params, dev)
    mamba_scan_invariance(cfg, params, dev)
    res["burst_memory"] = mamba_burst_memory(cfg, params, dev)
    lap("write, load, pins, invariance, memory")

    res["cut"] = mamba_cut(cfg, params, dev)
    lap("2-layer cut against the CPU")

    # the state must matter, or the session and serving checks see nothing
    eng = InferenceEngine(cfg, params, max_seq=MAMBA_MAX_SEQ, device=dev)
    a, b = [5, 6, 7, 8, 9, 10, 11, 12], [50, 60, 70, 80, 90, 100, 11, 12]
    la, lb = (eng.prefill([p], eng.new_cache(1))[0][0].float() for p in (a, b))
    res["history_rel"] = float((la - lb).abs().max() / la.abs().max())
    log(f"  two 8-token prompts that share their last two tokens: last logits differ by "
        f"{res['history_rel']:.3e} of max|logits|")
    if not res["history_rel"] > 1e-2:
        raise SystemExit("FAIL: Mamba-2.8B's logits do not depend on the earlier tokens")
    del eng

    # the main path at full depth: requests of 5-512 tokens, pp512, tg128
    r = end_to_end(dev, cfg, params, request_lengths=(5, 40, 200, 512),
                   request_max_seq=MAMBA_MAX_SEQ, reps=1, tag=" mamba-2.8b", profile=profile,
                   ab=True)
    launches = dict(r["main_path_launches"])
    res["e2e"] = r
    lap("requests, pp512, tg128")

    # a session saved after the prompt, continued from a fresh engine
    rng = np.random.default_rng(16)
    prompt = rng.integers(10, cfg.vocab_size, 100).tolist()
    eng = InferenceEngine(cfg, params, max_seq=MAMBA_MAX_SEQ, device=dev)
    path = str(ROOT / ".cache" / "tkq_mamba_session.npz")
    with main_run("Mamba-2.8B session", launches):
        logits, cache, lens = eng.prefill([prompt], eng.new_cache(1))
        first = torch.argmax(logits, -1)
        eng.save_session(path, cache, lens)
        cache2, lens2 = InferenceEngine(cfg, params, max_seq=MAMBA_MAX_SEQ,
                                        device=dev).load_session(path)
        resumed, _ = eng.decode_greedy(first, torch.tensor(lens2, device=dev), cache2, 32)
        straight = eng.generate([prompt], max_new_tokens=33)[0]
    os.remove(path)
    same = [int(first[0])] + resumed[0].tolist() == straight
    log(f"  session saved after a 100-token prompt, 32 tokens from a fresh engine equal to the "
        f"uninterrupted run: {same}")
    if not same:
        raise SystemExit("FAIL: a resumed Mamba-2.8B session differs from the run it continues")
    del eng, cache, cache2
    lap("session")

    # the generate CLI (its own load), its ids equal generate's
    fpath = str(FIXTURE_DIR / name)
    tok = from_gguf_metadata(GGUFReader(fpath).metadata)
    ids = tok.encode(FD_PROMPT, add_bos=True)
    t0 = time.perf_counter()
    with main_run("tools/main.py on Mamba-2.8B", launches):
        out = main_cli.run(["-m", fpath, "-p", FD_PROMPT, "-n", "32"])
    wall = time.perf_counter() - t0
    want = InferenceEngine(cfg, params, max_seq=len(ids) + 48, device=dev).generate(
        [ids], max_new_tokens=32, eos_id=tok.eos_id)[0]
    res["cli_tok_s"] = len(out["ids"]) / out["seconds"]
    log(f"  [{gpu}] tools/main.py -n 32 on Mamba-2.8B: {len(out['ids'])} tokens, "
        f"{res['cli_tok_s']:.1f} tok/s ({wall:.1f} s with the CLI's load); ids equal "
        f"generate's: {out['ids'] == want}")
    if out["ids"] != want or not out["ids"]:
        raise SystemExit(f"FAIL: tools/main.py on Mamba-2.8B differs from generate: "
                         f"{out['ids']} against {want}")
    _collect()
    lap("the CLI")

    res["serving"] = mamba_serving(cfg, params, dev)
    launches = _add(launches, res["serving"]["launches"])
    lap("serving")
    res["launches"] = launches
    res["seconds"] = time.perf_counter() - t_phase
    log(f"  launches of phase 16's main-path runs: {_nonzero(launches)}")
    log(f"  phase 16 took {res['seconds']:.1f} s [{gpu}]: " + ", ".join(
        f"{k} {v:.1f} s" for k, v in steps.items()))
    del params
    _collect()
    return res


# ---------------------------------------------------------------------------
# phase 11: the qmm kernel lab (mutation ladder #14 / #15, manual ring #16)
# ---------------------------------------------------------------------------

# (label, kind, s_fmt, N, K, modes, k chunks, n tiles, manual): the ladder at
# R = 1 on TinyLlama's wqk, gate/up and down and Llama-3-8B's gate/up at the
# CLI's default tiles, then the f32-scale and q8 layouts at TinyLlama's
# gate/up, full only
LAB_TKS, LAB_TNS = (256, 512, 1024), (256, 512)
LAB_CASES = (
    ("tiny wqk", "q4", "sm", 2304, 2048, None, LAB_TKS, LAB_TNS, True),
    ("tiny gu", "q4", "sm", 11264, 2048, None, LAB_TKS, LAB_TNS, True),
    ("tiny dn", "q6w", "sp", 2048, 5632, None, LAB_TKS, LAB_TNS, False),
    ("8b gu", "q4", "sm", 28672, 4096, None, LAB_TKS, LAB_TNS, True),
    ("tiny gu q6w-f32", "q6w", "f32", 11264, 2048, ("full",), (256,), (256,), False),
    ("tiny gu q8-sp", "q8", "sp", 11264, 2048, ("full",), (256,), (256,), False),
    ("tiny gu q4-f32", "q4", "f32", 11264, 2048, ("full",), (256,), (256,), False),
)
LAB_TARGET_S = 0.0002  # time_chained's chain length (phase 11 stays under 90 s)
# a rung against its plain version: f32 summation order only (adjacent rungs
# differ by about 1e-3 of max|ref|, so TOL could not tell their chains apart)
LAB_TOL = 1e-4


def _lab_weight(rng, kind: str, s_fmt: str, N: int, K: int, dev):
    from tpu_kquant_torch.models.fixtures import random_packed
    from tpu_kquant_torch.tools.kernel_bench import mk_q4, mk_q6w

    if kind == "q4":
        return mk_q4(N, K, rng, sm=s_fmt == "sm", device=dev)
    if kind == "q6w":
        return mk_q6w(N, K, rng, sp=s_fmt == "sp", device=dev)
    return random_packed(rng, kind, N, K, f32=s_fmt == "f32").to(dev)


def _lab_library(libs: dict, qt, copies: list, x, s_fmt: str, mode: str):
    """(what, graph ms, output) of the one PyTorch call that computes the
    rung's function on this weight (memoized in ``libs``), or None for q4's
    extract. dma (and the flat kinds' extract, whose codes are their bytes):
    the signed byte sum per column; convert / bf16c: torch.matmul on the
    rung's weight in bf16 (its values are bf16); full, gdot and the manual
    kernel's full: torch.matmul on the dequantized bf16 weight. Timed over
    the same rotation of copies as the kernels."""
    import torch

    from tpu_kquant_torch.quant.codecs import dequant_kmajor
    from tpu_kquant_torch.utils import kernel_lab as lab
    from tpu_kquant_torch.utils.attribution import rotation

    if mode == "dma" or (mode == "extract" and qt.kind != "q4"):
        key = "sum"
    elif mode in ("convert", "bf16c"):
        key = mode
    elif mode in ("full", "gdot"):
        key = "full"
    else:
        return None
    if key not in libs:
        if key == "sum":
            qs = [c.arrays["qs"].view(torch.int8) for c in copies]
            libs[key] = ("torch.sum(qs.view(int8), 0, dtype=f32)",
                         graph_ms(lambda i: torch.sum(qs[i % len(qs)], 0, dtype=torch.float32),
                                  40),
                         torch.sum(qs[0], 0, dtype=torch.float32))
        else:
            w0 = (dequant_kmajor(qt, torch.bfloat16) if key == "full" else
                  lab.rung_weight(qt, key, s_fmt).to(torch.bfloat16)).contiguous()
            ws = rotation(w0, w0.clone, w0.numel() * 2)
            what = {"full": "W_bf16", "convert": "codes_bf16", "bf16c": "W_bf16c"}[key]
            libs[key] = (f"torch.matmul(x, {what})",
                         graph_ms(lambda i: torch.matmul(x, ws[i % len(ws)]), 40),
                         torch.matmul(x, w0).float())
    return libs[key]


def kernel_lab(dev, qmm_cases: list) -> dict:
    """Phase 11: the kernel lab. For each LAB_CASES tensor: every rung at
    every tile of both geometries (and the manual kernel's dma and full on
    q4) held against its plain version on the card (dma and extract equal,
    the rest within LAB_TOL of max|ref|) and against the one PyTorch call
    that computes the same function (``_lab_library``: dma and the flat
    kinds' extract equal, the matmuls within TOL), timed by CUDA-graph replay
    (`ms`) and eagerly, beside the plain version, the library call and the
    bound; then, with the counts set to 0 just before and read just after,
    run_ladder on every tensor (the lab's entry point: time_chained's
    marginal times); then the two CLIs once in-process. Returns the
    kernels' case lists and the ladder's launches."""
    import numpy as np
    import torch

    from tpu_kquant_torch.tools import kernel_bench, kernel_lab as lab_cli
    from tpu_kquant_torch.utils import kernel_lab as lab
    from tpu_kquant_torch.utils.attribution import rotation

    t0 = time.perf_counter()
    rng = np.random.default_rng(11)
    torch.manual_seed(11)
    out: dict = {"lab_qmm_n": [], "lab_qmm_k": [], "lab_qmm_manual": []}
    weights = {}
    for label, kind, s_fmt, N, K, modes, tks, tns, manual in LAB_CASES:
        qt = _lab_weight(rng, kind, s_fmt, N, K, dev)
        weights[label] = qt
        copies = rotation(qt, qt.clone, qt.n_bytes)
        R = 1
        x = torch.randn(R, K, device=dev).to(torch.bfloat16)
        xi8 = torch.ones(R, K, dtype=torch.int8, device=dev)
        libs: dict = {}
        modes = modes or lab.MODES
        runs = [("k", t, m) for t in tks for m in modes] + [("n", t, m) for t in tns
                                                               for m in modes]
        if manual:
            runs += [("manual", t, m) for t in tks for m in ("dma", "full")]
        plains = {}
        for geometry, tile, mode in runs:
            if geometry == "manual":
                def call(i, mode=mode, tile=tile):
                    return lab.lab_qmm_manual(x, copies[i % len(copies)], mode, s_fmt, tile)

                def plain(i, mode=mode):
                    return lab.lab_qmm_manual_plain(x, qt, mode, s_fmt)
            else:
                def call(i, mode=mode, tile=tile, geometry=geometry):
                    return lab.lab_qmm(x, xi8, copies[i % len(copies)], mode, s_fmt, tile,
                                       geometry=geometry, tn=tile)

                def plain(i, mode=mode):
                    return lab.lab_qmm_plain(x, xi8, qt, mode, s_fmt)
            got = call(0)
            torch.cuda.synchronize()
            key = (geometry == "manual", mode)
            if key not in plains:
                plains[key] = (plain(0), graph_ms(plain, 4, reps=3))
            ref, plain_ms = plains[key]
            ad, rel = _err(got, ref)
            exact = mode in ("dma", "extract")
            if (exact and not torch.equal(got, ref)) or not math.isfinite(rel) or rel > LAB_TOL:
                raise SystemExit(f"FAIL: lab {label} {geometry} t={tile} {mode} disagrees with "
                                 f"its plain version: max abs {ad:.3e}, rel {rel:.3e}")
            lib = _lab_library(libs, qt, copies, x, s_fmt, mode)
            lib_rel = None
            if lib is not None:
                lib_out = lib[2].expand_as(got)
                lib_rel = _err(got, lib_out)[1]
                if not (torch.equal(got, lib_out) if exact else lib_rel <= TOL):
                    raise SystemExit(f"FAIL: lab {label} {geometry} t={tile} {mode} disagrees "
                                     f"with {lib[0]}: {lib_rel:.3e}")
            nb = lab.lab_bytes(qt, "dma" if mode == "dma" else
                               "full" if geometry == "manual" else mode)
            uses_x = mode not in ("dma", "extract")
            n_bytes = nb + (x.numel() * 2 if uses_x else 0) + got.numel() * 4
            b, by = (bound_ms(n_bytes, 2.0 * R * K * N) if uses_x
                     else bound_ms(n_bytes, 2.0 * qt.arrays["qs"].numel(), INT8_OPS))
            ms = graph_ms(call, 40)
            name = {"k": "lab_qmm_k", "n": "lab_qmm_n", "manual": "lab_qmm_manual"}[geometry]
            out[name].append({
                "case": f"{label} {qt.kind}-{s_fmt} [{N},{K}] t={tile} {mode}",
                "tensor": label, "tile": tile, "mode": mode,
                "max_abs_err": ad, "rel_err": rel, "library_rel_err": lib_rel,
                "ms": ms, "eager_ms": time_ms(call, 40), "plain_ms": plain_ms,
                "library_ms": lib[1] if lib else None,
                "library": lib[0] if lib else "none: no one call sums both nibbles of each byte",
                "bytes": nb, "gbs": nb / (ms * 1e-3) / 1e9,
                "bound_ms": b, "bound_by": by})
        if "sum" in libs:
            sum_ms = libs["sum"][1]
            log(f"  {label}: {libs['sum'][0]} streams the codes at "
                f"{lab.lab_bytes(qt, 'dma') / (sum_ms * 1e-3) / 1e9:.1f} GB/s "
                f"({sum_ms * 1e3:.2f} us)")
        del plains, copies, libs
        torch.cuda.empty_cache()
    log(f"  checks and graph times: {time.perf_counter() - t0:.1f} s")

    # the lab's entry point, counted from 0: run_ladder over every tensor
    reset_counts()
    ladder = []
    for label, kind, s_fmt, N, K, modes, tks, tns, manual in LAB_CASES:
        rows = lab.run_ladder(weights[label], s_fmt, R=1, tks=tks, tns=tns,
                              modes=modes or lab.MODES, log=lambda *a: None, reps=3,
                              manual=manual, target_s=LAB_TARGET_S)
        for r in rows:
            r["tensor"] = label
        ladder += rows
    got = counts()
    launches = {k: got.get(k, 0) for k in out}
    log(f"  launches in run_ladder: {launches}")
    marg = {(r["tensor"], r["geometry"], r["tile"], r["mode"]): r for r in ladder}
    for name, cases in out.items():
        geometry = {"lab_qmm_k": "k", "lab_qmm_n": "n", "lab_qmm_manual": "manual"}[name]
        for c in cases:
            r = marg[(c["tensor"], geometry, c["tile"], c["mode"])]
            c["marginal_ms"] = r["us"] * 1e-3
            c["marginal_gbs"] = r["gbs"]
    # the ladder's table: rung ms (graph) and GB/s per tensor and geometry
    for name, cases in out.items():
        for c in cases:
            lib_us = "-" if c["library_ms"] is None else f"{c['library_ms'] * 1e3:.2f}"
            log(f"  {name:14s} {c['case']:52s} rel {c['rel_err']:.1e}  "
                f"{c['ms'] * 1e3:8.2f} us (eager {c['eager_ms'] * 1e3:7.1f}, marginal "
                f"{c['marginal_ms'] * 1e3:8.2f})  {c['gbs']:7.1f} GB/s  plain "
                f"{c['plain_ms'] * 1e3:8.1f} us  library {lib_us} us  "
                f"bound {c['bound_ms'] * 1e3:.2f} us ({c['bound_by']})")
    del weights
    torch.cuda.empty_cache()

    # the CLIs, once in-process
    rows = lab_cli.main(["--tensor", "wqk", "--modes", "dma,full", "--manual",
                         "--target-s", str(LAB_TARGET_S)])
    log(f"  tools/kernel_lab.py: {len(rows)} rows on {rows[0]['device']}")
    bench = kernel_bench.main(["--model", "tiny", "--phase", "decode", "--only", "head"])
    head_us = bench[0]["us"]
    p3 = [c for c in qmm_cases if c["case"] == "lm head q6w-sp R=1"][0]
    log(f"  tools/kernel_bench.py lm head qmm [32000, 2048] q6w-sp R=1: {head_us:.2f} us "
        f"(marginal, chained); phase 3's graph time {p3['ms'] * 1e3:.2f} us, eager "
        f"{p3['eager_ms'] * 1e3:.2f} us: ratio {head_us / (p3['ms'] * 1e3):.3f}")
    log(f"  phase 11 took {time.perf_counter() - t0:.1f} s")
    return {"cases": out, "launches": launches, "cli_head_us": head_us}


# phase 12: the prefill-attention lab (#17-#19) at TinyLlama-1.1B's pp512
# layer (the reference lab's own shape), its pp2048 layer and Qwen2.5-1.5B's
# heads at pp512 (utils/prefill_lab.py:SHAPES)
PLAB_SHAPES = ("tiny-pp512", "tiny-pp2048", "qwen-pp512")
PLAB_ITERS = 32  # run_sweep's chain length (time_chained)


def prefill_lab(dev) -> dict:
    """Phase 12: the prefill-attention lab. At each PLAB_SHAPES shape (inputs
    from a seeded torch.Generator): SDPA, the library yardstick, held to
    variant A's plain version (and, once, its top-left causal mask to the
    explicit one), the flash prefill kernel #8 on the same inputs, and every
    sweep point of variants A, B and G (utils/prefill_lab.py:SWEEPS) held to
    its plain version per output row (row_rel_err within TOL, fatal) and
    timed by CUDA-graph replay (`ms`) and eagerly, beside its plain version,
    SDPA and the bound of the causal pairs (prefill_work). Then, with the
    counts set to 0 just before and read just after, run_sweep at every
    shape (the lab's entry point: time_chained's marginal times), and
    tools/prefill_lab.py once in-process. Returns the kernels' case lists
    and run_sweep's launches."""
    import torch
    import torch.nn.functional as F

    from tpu_kquant_torch.ops.prefill import attention_prefill, attention_prefill_plain
    from tpu_kquant_torch.tools import prefill_lab as lab_cli
    from tpu_kquant_torch.utils import prefill_lab as pl

    t0 = time.perf_counter()
    out: dict = {f"prefill_lab_{v}": [] for v in "abg"}
    inputs, prod = {}, {}
    for i, shape in enumerate(PLAB_SHAPES):
        c = pl.SHAPES[shape]
        B, T, S, H, Hkv, D = (c[n] for n in ("B", "T", "S", "H", "Hkv", "D"))
        starts = list(c["q_start"])
        q, k, v, qs = inputs[shape] = pl.lab_inputs(c, dev, seed=120 + i)
        qg, scale = pl.group_heads(q, Hkv), D ** -0.5
        nb, fl = prefill_work(B, T, S, H, Hkv, D, starts, 0, 2 * D)
        if (nb, fl) != pl.lab_work(B, T, S, H, Hkv, D, starts):
            raise SystemExit(f"FAIL: lab_work disagrees with prefill_work at {shape}")
        b, by = bound_ms(nb, fl)
        a_ref = pl.call_a_plain(qg, k, v, qs, scale, 128)
        sdpa = pl.sdpa_call(k, v, starts, T, scale)
        lib_rel = row_rel_err(sdpa(q), pl.ungroup_heads(a_ref))
        if i == 0:  # SDPA's top-left causal mask is kv <= t at q_start 0
            m = (torch.arange(S, device=dev)[None, :] <= torch.arange(T, device=dev)[:, None])
            explicit = F.scaled_dot_product_attention(q.transpose(1, 2), k, v, attn_mask=m,
                                                      enable_gqa=True, scale=scale)
            mask_rel = row_rel_err(sdpa(q), explicit.transpose(1, 2))
            log(f"  SDPA is_causal against the explicit mask kv <= t: {mask_rel:.2e}")
            if not mask_rel <= TOL:
                raise SystemExit(f"FAIL: SDPA's causal mask is not kv <= t ({mask_rel:.3e})")
        if not lib_rel <= TOL:
            raise SystemExit(f"FAIL: SDPA disagrees with variant A at {shape}: {lib_rel:.3e}")
        lib_ms = graph_ms(lambda i: sdpa(q), 20)
        run8 = lambda i: attention_prefill(q, k, v, qs, scale=scale)  # noqa: E731
        rel8 = row_rel_err(run8(0), attention_prefill_plain(q, k, v, qs, scale=scale))
        if not rel8 <= TOL:
            raise SystemExit(f"FAIL: flash prefill disagrees with its plain version at {shape}")
        prod[shape] = {"ms": graph_ms(run8, 20), "eager_ms": time_ms(run8, 20), "rel_err": rel8}
        log(f"  {shape}: bound {b * 1e3:.2f} us ({by}; {nb / 1e6:.2f} MB, {fl / 1e9:.3f} GFLOP of "
            f"causal pairs; A executes {4.0 * B * T * S * H * D / 1e9:.3f} GFLOP of pairs), SDPA "
            f"{lib_ms * 1e3:.2f} us (rel {lib_rel:.1e}), #8 {prod[shape]['ms'] * 1e3:.2f} us "
            f"(eager {prod[shape]['eager_ms'] * 1e3:.2f}, rel {rel8:.1e})")
        plains = {}
        for variant in "abg":
            call, plain = pl.CALLS[variant]
            for tq, ts in pl.SWEEPS[variant]:
                extra = () if ts is None else (ts,)
                key = (variant, min(ts, S) if variant == "b" else None)
                if key not in plains:  # only B's function depends on a tile (ts)
                    def run_plain(i, plain=plain, tq=tq, extra=extra):
                        return plain(qg, k, v, qs, scale, tq, *extra)
                    plains[key] = (a_ref if variant == "a" else run_plain(0),
                                   graph_ms(run_plain, 2, reps=3))
                ref, plain_ms = plains[key]

                def run(i, call=call, tq=tq, extra=extra):
                    return call(qg, k, v, qs, scale, tq, *extra)
                got = run(0)
                torch.cuda.synchronize()
                ad, _ = _err(got, ref)
                rel = row_rel_err(got, ref)
                label = f"{shape} {variant} tq={tq}" + ("" if ts is None else f" ts={ts}")
                if not (torch.isfinite(got).all() and rel <= TOL):
                    raise SystemExit(f"FAIL: prefill lab {label} disagrees with its plain "
                                     f"version: max abs {ad:.3e}, row rel {rel:.3e}")
                out[f"prefill_lab_{variant}"].append({
                    "case": label, "shape": shape, "tq": tq, "ts": ts, "max_abs_err": ad,
                    "rel_err": rel, "ms": graph_ms(run, 20), "eager_ms": time_ms(run, 20),
                    "plain_ms": plain_ms, "library_ms": lib_ms,
                    "library": "F.scaled_dot_product_attention(is_causal=True, enable_gqa=True)",
                    "bound_ms": b, "bound_by": by, "bytes": nb, "flops": fl})
        del plains, a_ref
        torch.cuda.empty_cache()
    log(f"  checks and graph times: {time.perf_counter() - t0:.1f} s")

    # the lab's entry point, counted from 0: run_sweep at every shape
    reset_counts()
    rows = []
    for shape in PLAB_SHAPES:
        rows += [dict(r, shape=shape) for r in pl.run_sweep(*inputs[shape], n_iter=PLAB_ITERS)]
    got = counts()
    launches = {k: got.get(k, 0) for k in out}
    log(f"  launches in run_sweep: {launches}")
    marg = {(r["shape"], r["variant"], r["tq"], r["ts"]): r for r in rows}
    for name, cases in out.items():
        for c in cases:
            r = marg[(c["shape"], name[-1], c["tq"], c["ts"])]
            c["marginal_ms"], c["dep_ms"] = r["us"] * 1e-3, r["dep_us"] * 1e-3
    # the sweep's table: graph, eager and marginal us beside #8 and SDPA
    for shape in PLAB_SHAPES:
        r8 = marg[(shape, "prod", 64, 64)]
        log(f"  {shape}: #8 {prod[shape]['ms'] * 1e3:.2f} us (eager "
            f"{prod[shape]['eager_ms'] * 1e3:.2f}, marginal {r8['us']:.2f}); SDPA marginal "
            f"{r8['sdpa_us']:.2f} us; dep {r8['dep_us']:.2f} us; bound {r8['bound_us']:.2f} us")
        for name, cases in out.items():
            for c in (c for c in cases if c["shape"] == shape):
                log(f"    {name:14s} {c['case']:32s} rel {c['rel_err']:.1e}  {c['ms'] * 1e3:9.2f} us "
                    f"(eager {c['eager_ms'] * 1e3:8.2f}, marginal {c['marginal_ms'] * 1e3:9.2f})  "
                    f"plain {c['plain_ms'] * 1e3:9.1f} us  SDPA {c['library_ms'] * 1e3:7.2f} us  "
                    f"bound {c['bound_ms'] * 1e3:.2f} us ({c['bound_by']})")
    del inputs
    torch.cuda.empty_cache()

    # the CLI, once in-process
    cli_rows = lab_cli.main(["--shape", "tiny-pp512", "--variant", "g", "--iters", "16"])
    log(f"  tools/prefill_lab.py: {len(cli_rows)} rows on {cli_rows[0]['device']}")
    log(f"  phase 12 took {time.perf_counter() - t0:.1f} s")
    return {"cases": out, "launches": launches, "prod": prod}


# ---------------------------------------------------------------------------
# phase 14: the front door (TinyLlama-1.1B, full depth)
# ---------------------------------------------------------------------------

FD_PROMPT = ("Hello the world, the hello world: a tale of the world and of hello, told "
             "the other way.")
FD_SAMPLED = ["--temp", "0.8", "--top-k", "40", "--top-p", "0.95", "--repeat-penalty", "1.1",
              "--seed", "5"]
FD_NEW = 32  # speculative streams' length
FD_DRAFT = 4  # n_draft


# a captured step's number (runtime.graphs) -> the launches expected of the
# forwards it captured; main_run adds them once a replay (record_captures)
CAPTURED: dict = {}


def forward_launches(params, cfg, tokens, cache, k: dict) -> dict:
    """expected_launches of one engine forward as it is called: its model,
    rows, tokens, cache slots, attended slots, KV kind and layout."""
    B, T = tokens.shape
    if cfg.is_recurrent:
        return expected_launches(cfg, params, T, k.get("impl", "auto"), batch=B)
    att = k.get("kv_attend_len") or cache.max_seq
    return expected_launches(cfg, params, T, k.get("impl", "auto"), batch=B, seq=cache.max_seq,
                             kv_int8=cache.quantized, attend=min(att, cache.max_seq),
                             iswa=hasattr(cache, "is_ring"))


def record_captures() -> None:
    """Wrap the engine's forwards for the whole run: a forward called while
    a step is being captured records the launches expected of it under the
    step's number (CAPTURED)."""
    from tpu_kquant_torch.runtime import engine as engine_mod
    from tpu_kquant_torch.runtime import graphs

    for name in ("llama_forward", "mamba_forward"):
        def spy(params, cfg, tokens, positions, cache, *a, _real=getattr(engine_mod, name), **k):
            seq = graphs.capturing()
            if seq is not None:
                CAPTURED.setdefault(seq, []).append(forward_launches(params, cfg, tokens, cache,
                                                                     k))
            return _real(params, cfg, tokens, positions, cache, *a, **k)

        setattr(engine_mod, name, spy)


@contextlib.contextmanager
def main_run(what: str, total: dict):
    """One run of the main path: the counts set to 0 just before it and read
    just after, held to expected_launches summed over the forwards it ran:
    each eager engine forward as called, and each replay of a captured step
    (runtime.graphs) as the forwards of its capture (CAPTURED; a capture
    itself launches nothing); the sum added to `total`. Logs the graph
    launches and the counted kernel launches outside graphs. Comparison
    runs, checks against the CPU and launch pins stay outside."""
    from tpu_kquant_torch.runtime import engine as engine_mod
    from tpu_kquant_torch.runtime import graphs

    real, real_m = engine_mod.llama_forward, engine_mod.mamba_forward
    want: dict = {}
    n_fwd = 0

    def spy(params, cfg, tokens, positions, cache, *a, _real=real, **k):
        nonlocal want, n_fwd
        if graphs.capturing() is None:
            want = _add(want, forward_launches(params, cfg, tokens, cache, k))
            n_fwd += 1
        return _real(params, cfg, tokens, positions, cache, *a, **k)

    engine_mod.llama_forward = spy
    engine_mod.mamba_forward = lambda *a, **k: spy(*a, _real=real_m, **k)
    by_step, replayed = dict(graphs.STATS.by_step), dict(graphs.STATS.replayed_launches)
    reset_counts()
    try:
        yield
    finally:
        engine_mod.llama_forward, engine_mod.mamba_forward = real, real_m
    replays = 0
    for seq, n in graphs.STATS.by_step.items():
        n -= by_step.get(seq, 0)
        replays += n
        for fwd in CAPTURED.get(seq, []) if n else []:
            want = _add(want, fwd, n)
            n_fwd += n
    inside = sum(graphs.STATS.replayed_launches.values()) - sum(replayed.values())
    got = check_counts(f"{what} ({n_fwd} forwards; {replays} graph launches)", want)
    log(f"  {what}: {replays} graph launches, {inside} counted kernel launches inside them, "
        f"{sum(got.values()) - inside} outside")
    total.update(_add(total, got))


def window_cost(eng, rng, gpu: str) -> dict:
    """One verify window of FD_DRAFT + 1 tokens 1900 deep in 2048 slots at
    TinyLlama's full width and depth (B = 1, bf16 KV): engine.step against
    as many decode steps (eager ms, CUDA events, host time included); and
    layer 0's attention alone on that cache (device ms in a CUDA graph, and
    peak device memory): the window's (its products query by query on one
    f32 copy of the cache, held bit-equal to the decode steps' calls here), the
    decode steps' T calls, and one [T, S] call (attention_plain without
    kv_cur: the fixed-shape form a window would take if its rows need not
    be the decode steps' bits)."""
    import numpy as np
    import torch

    from tpu_kquant_torch.ops.attention import attention_plain

    T, p, cfg, dev = FD_DRAFT + 1, 1900, eng.cfg, eng.device
    prompt = rng.integers(10, cfg.vocab_size, p).tolist()
    _, cache, lens = eng.prefill([prompt], eng.new_cache(1))
    window = rng.integers(10, cfg.vocab_size, (1, T))
    pos = lens[:, None] + np.arange(T)
    out = {"step_ms": time_ms(lambda i: eng.step(window, pos, cache), 10),
           "decode_steps_ms": time_ms(lambda i: [eng.decode_step(
               eng._tensor(window[:, t]), eng._tensor(lens + t), cache) for t in range(T)], 10)}
    k, v = cache.layer_view(0)[:2]
    gen = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn(1, T, cfg.n_heads, cfg.head_dim, generator=gen, device=dev).to(torch.bfloat16)
    qpos = torch.tensor(pos, device=dev)
    cur = tuple(c[:, :, p:p + T].transpose(1, 2) for c in (k, v))
    forms = {
        "window": lambda i: attention_plain(q, k, v, qpos, kv_cur=cur, fixed=True),
        "decode_calls": lambda i: torch.cat([attention_plain(
            q[:, t:t + 1], k, v, qpos[:, t:t + 1], kv_cur=tuple(c[:, t:t + 1] for c in cur),
            fixed=True) for t in range(T)], 1),
        "one_call": lambda i: attention_plain(q, k, v, qpos, fixed=True),
    }
    if not torch.equal(forms["window"](0), forms["decode_calls"](0)):
        raise SystemExit("FAIL: the window's attention differs from the decode steps' calls")
    for name, fn in forms.items():
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn(0)
        torch.cuda.synchronize()
        out[f"attn_{name}_peak_mb"] = (torch.cuda.max_memory_allocated() - base) / 1e6
        out[f"attn_{name}_ms"] = graph_ms(fn, 10)
    log(f"  [{gpu}] a verify window of {T}, 1900 deep in 2048 slots, B = 1: engine.step "
        f"{out['step_ms']:.3f} ms against {T} decode steps {out['decode_steps_ms']:.3f} ms "
        f"(eager); layer 0's attention (graph ms, peak MB): the window's "
        f"{out['attn_window_ms']:.4f}, {out['attn_window_peak_mb']:.2f}; {T} decode calls "
        f"{out['attn_decode_calls_ms']:.4f}, {out['attn_decode_calls_peak_mb']:.2f}; one "
        f"[{T}, 2048] call {out['attn_one_call_ms']:.4f}, {out['attn_one_call_peak_mb']:.2f}")
    return out


def _cpu_engine(cfg, params, **kw):
    from tpu_kquant_torch.runtime.engine import InferenceEngine

    return InferenceEngine(cfg, _to_cpu(params), device="cpu", **kw)


def front_door(dev) -> dict:
    """Phase 14: the front door at TinyLlama-1.1B's full width and depth on
    the seed-0 Q4_K_M fixture with its vocab, each main-path run counted
    from 0 and checked against the gates (main_run; the comparisons, the
    2-layer cut and the pins are not counted): the generate CLI (tools/main.py) greedy -n 64 (its ids equal
    generate's) and sampled (equal generate(seed=...)); context shift
    (max_seq 256, a 200-token prompt, 200 new tokens, n_keep 4) on bf16 and
    int8 KV (a shift must happen, every token must come), and on a 2-layer
    cut against the CPU (shift_cache of one cache: bf16 within one ulp,
    int8 codes within 1 and scales 1e-6 relative; the logits after a shift
    within 5e-2 of max|ref| and the greedy token in the CPU's top 5);
    sessions saved after prefill and 16 tokens, loaded into a fresh engine,
    32 more equal to the uninterrupted run (bf16 and int8 KV, fatal);
    verify-window rows equal to decode steps bit for bit (B = 1 and 2,
    fatal; one window's launches pinned with expected_launches); a window's
    cost at 2048 slots (window_cost); greedy
    speculative decoding (bf16 KV, fatal: equal to plain greedy):
    generate_speculative with the target as its own draft (every draft
    accepted), with a 2-layer draft of another seed on two rows of other
    lengths, DeviceSpeculator's prompt lookup on a repetitive prompt and
    DeviceSpeculator with the 2-layer draft, each timed beside plain greedy
    (no gain is claimed); speculative streams on int8 KV (the differing
    tokens are printed, not held); perplexity over 1024 ids at ctx 512
    (finite; on the 2-layer cut within 1e-3 relative of the CPU's); the
    bench CLI's table at -p 512 -n 128 -r 2. Returns the launches and the
    numbers it printed."""
    import dataclasses

    import numpy as np
    import torch

    from tpu_kquant_torch.gguf import GGUFReader
    from tpu_kquant_torch.models.fixtures import tinyllama_1b_config
    from tpu_kquant_torch.runtime.engine import InferenceEngine
    from tpu_kquant_torch.runtime.kv_cache import KVCache, shift_cache
    from tpu_kquant_torch.runtime.speculative import DeviceSpeculator, generate_speculative
    from tpu_kquant_torch.tokenizer import from_gguf_metadata
    from tpu_kquant_torch.tools import bench_cli, perplexity
    from tpu_kquant_torch.tools import main as main_cli
    from tpu_kquant_torch.tools.batch_invariance import window_checks

    t_phase = time.perf_counter()
    gpu = gpu_line()
    name = "tinyllama-1.1b-q4_k_m-seed0.gguf"
    cfg, params, _ = load_fixture(tinyllama_1b_config(), name, dev)
    path = str(FIXTURE_DIR / name)
    tok = from_gguf_metadata(GGUFReader(path).metadata)
    res: dict = {"gpu": gpu}
    rng = np.random.default_rng(14)
    total: dict = {}  # the main path's runs' launches (main_run)

    def engine(max_seq, kv_quantized=False, batch=1, c=cfg, p=params):
        return InferenceEngine(c, p, max_batch=batch, max_seq=max_seq, device=dev,
                               kv_quantized=kv_quantized)

    # -- the generate CLI: greedy, then sampled ---------------------------------
    ids = tok.encode(FD_PROMPT, add_bos=True)
    for label, extra in (("greedy", []), ("sampled", FD_SAMPLED)):
        t0 = time.perf_counter()
        with main_run(f"tools/main.py {label}", total):
            out = main_cli.run(["-m", path, "-p", FD_PROMPT, "-n", "64", *extra])
        wall = time.perf_counter() - t0
        kw = dict(temperature=0.8, top_k=40, top_p=0.95, repeat_penalty=1.1, seed=5) \
            if extra else {}
        want = engine(len(ids) + 64 + 16).generate([ids], max_new_tokens=64, eos_id=tok.eos_id,
                                                   **kw)[0]
        tps = len(out["ids"]) / out["seconds"]
        log(f"  [{gpu}] tools/main.py {label} -n 64: {len(out['ids'])} tokens, {tps:.1f} tok/s "
            f"(generation {out['seconds']:.2f} s; {wall:.1f} s with the CLI's load); ids equal "
            f"generate's: {out['ids'] == want}; text {out['text'][:48]!r}")
        if out["ids"] != want or out["text"] != tok.decode(want) or not out["ids"]:
            raise SystemExit(f"FAIL: tools/main.py {label} differs from generate: {out['ids']} "
                             f"against {want}")
        res[f"cli_{label}_tok_s"] = tps

    # -- context shift --------------------------------------------------------
    prompt = rng.integers(10, cfg.vocab_size, 200).tolist()
    real_shift = InferenceEngine.shift_context
    shifts: list = []

    def counted(self, *a, **k):
        shifts.append(a[2:])
        return real_shift(self, *a, **k)

    InferenceEngine.shift_context = counted
    try:
        for q in (False, True):
            shifts.clear()
            t0 = time.perf_counter()
            kv = "int8" if q else "bf16"
            with main_run(f"context shift ({kv} KV)", total):
                got = engine(256, q).generate([prompt], max_new_tokens=200,
                                              context_shift=True, n_keep=4)[0]
            log(f"  [{gpu}] context shift, {kv} KV: max_seq 256, prompt 200, 200 new tokens, "
                f"n_keep 4: {len(got)} tokens, {len(shifts)} shifts (n_keep, n_discard) "
                f"{shifts}, {time.perf_counter() - t0:.1f} s")
            if len(got) != 200 or not shifts:
                raise SystemExit(f"FAIL: context shift on {kv} KV gave {len(got)} tokens "
                                 f"with {len(shifts)} shifts")
    finally:
        InferenceEngine.shift_context = real_shift
    cut = dataclasses.replace(cfg, n_layers=2)
    p_cut = {**params, "layers": params["layers"][:2]}
    with cpu_dequant_memo():
        for q in (False, True):
            kv = "int8" if q else "bf16"
            g_eng = engine(256, q, c=cut, p=p_cut)
            c_eng = _cpu_engine(cut, p_cut, max_seq=256, kv_quantized=q)
            gl, g_cache, lens = g_eng.prefill([prompt], g_eng.new_cache(1))
            cl, c_cache, _ = c_eng.prefill([prompt], c_eng.new_cache(1))
            # one cache, shifted on both sides
            mirror = KVCache(*(None if t is None else t.to("cpu", copy=True) for t in
                               (g_cache.k, g_cache.v, g_cache.k_scale, g_cache.v_scale)))
            a = shift_cache(KVCache(*(None if t is None else t.clone() for t in
                                      (g_cache.k, g_cache.v, g_cache.k_scale, g_cache.v_scale))),
                            4, 126, cut.rope)
            b = shift_cache(mirror, 4, 126, cut.rope)
            ak, bk = a.k.cpu().float(), b.k.float()
            if q:
                dk = float((ak - bk).abs().max())
                ds = float(((a.k_scale.cpu() - b.k_scale).abs()
                            / b.k_scale.abs().clamp_min(1e-30)).max())
                ok = dk <= 1 and ds <= 1e-6 and torch.equal(a.v.cpu(), b.v)
                detail = f"codes within {dk:.0f}, scales within {ds:.1e} relative"
            else:
                ulps = float(((ak - bk).abs() / (bk.abs() * 2.0 ** -7).clamp_min(1e-30)).max())
                ok = ulps <= 1 and torch.equal(a.v.cpu(), b.v)
                detail = f"K within {ulps:.2f} bf16 ulp"
            # the logits after a shift: both engines shift their own cache
            tok0 = torch.argmax(gl, -1)
            g_cache, g_pos = g_eng.shift_context(g_cache, lens, 4, 126)
            c_cache, c_pos = c_eng.shift_context(c_cache, lens, 4, 126)
            lg, _ = g_eng.decode_step(tok0, g_pos, g_cache)
            lc, _ = c_eng.decode_step(tok0.cpu(), c_pos, c_cache)
            lg, lc = lg[0].float().cpu(), lc[0].float()
            rel = float((lg - lc).abs().max() / lc.abs().max())
            top5 = set(torch.topk(lc, 5).indices.tolist())
            log(f"  [{gpu}] 2-layer cut, {kv} KV: shift_cache on the card against the CPU: "
                f"{detail}; logits after a shift rel err {rel:.2e}, greedy "
                f"{int(lg.argmax())} in the CPU's top 5 {sorted(top5)}")
            if not (ok and rel < 5e-2 and int(lg.argmax()) in top5 and torch.isfinite(lg).all()):
                raise SystemExit(f"FAIL: context shift on the 2-layer cut ({kv} KV) disagrees "
                                 f"with the CPU")

    # -- sessions ---------------------------------------------------------------
    s_prompt = rng.integers(10, cfg.vocab_size, 40).tolist()
    sess = FIXTURE_DIR.parent / "phase14_session.npz"
    sess.parent.mkdir(parents=True, exist_ok=True)
    for q in (False, True):
        kv = "int8" if q else "bf16"
        eng = engine(128, q)
        with main_run(f"session save ({kv} KV)", total):
            logits, cache, lens = eng.prefill([s_prompt], eng.new_cache(1))
            first = torch.argmax(logits, -1)
            head, cache = eng.decode_greedy(first, eng._tensor(lens), cache, 16)
            eng.save_session(str(sess), cache, lens + 16)
        want, _ = eng.decode_greedy(head[:, -1], eng._tensor(lens + 16), cache, 32)
        fresh = engine(128, q)
        with main_run(f"session load ({kv} KV)", total):
            back, lens2 = fresh.load_session(str(sess))
            got, _ = fresh.decode_greedy(head[:, -1], fresh._tensor(lens2), back, 32)
        same = torch.equal(got, want)
        log(f"  [{gpu}] session, {kv} KV: saved after prefill + 16, {sess.stat().st_size / 1e6:.1f}"
            f" MB; 32 tokens from a fresh engine equal the uninterrupted run: {same}")
        if not same:
            raise SystemExit(f"FAIL: a session continuation on {kv} KV differs from the "
                             f"uninterrupted run")
    sess.unlink()

    # -- verify windows against decode steps, and their launches --------------------
    w_prompts = [rng.integers(10, cfg.vocab_size, n).tolist() for n in (37, 61)]
    rows = window_checks(engine(128), w_prompts[:1], T=FD_DRAFT + 1, seed=1)
    rows += window_checks(engine(128, batch=2), w_prompts, T=FD_DRAFT + 1, seed=2)
    if not all(r["equal"] for r in rows):
        raise SystemExit(f"FAIL: verify-window rows differ from the decode steps at their "
                         f"positions: {[r['check'] for r in rows if not r['equal']]}")
    for B in (1, 2):
        eng = engine(128, batch=B)
        _, cache, lens = eng.prefill(w_prompts[:B], eng.new_cache(B))
        before = counts()
        eng.step(np.full((B, FD_DRAFT + 1), 7), lens[:, None] + np.arange(FD_DRAFT + 1), cache)
        got = {k: v - before.get(k, 0) for k, v in counts().items()}
        want = expected_launches(cfg, params, FD_DRAFT + 1, batch=B)
        pinned = {"attn_in": cfg.n_layers, "oproj_ffn": cfg.n_layers, "qmm": 1}
        log(f"  verify window of {FD_DRAFT + 1} at B = {B}: launches {_nonzero(got)}, gates "
            f"{_nonzero(want)}, pinned {pinned}")
        if _nonzero(got) != _nonzero(want) or _nonzero(want) != pinned:
            raise SystemExit(f"FAIL: a verify window at B = {B} launched {_nonzero(got)}; "
                             f"the gates say {_nonzero(want)}, pinned {pinned}")
    log(f"  [{gpu}] verify windows: {len(rows)} rows (B = 1 and 2, {FD_DRAFT + 1} tokens) "
        f"equal the decode steps at their positions bit for bit")
    res["window_cost"] = window_cost(engine(2048), np.random.default_rng(15), gpu)

    # -- speculative decoding ------------------------------------------------------
    d_cfg, d_params, _ = load_fixture(dataclasses.replace(tinyllama_1b_config(), n_layers=2),
                                      "tinyllama-1.1b-2l-q4_k_m-seed1.gguf", dev, seed=1)
    rep_seed = rng.integers(10, cfg.vocab_size, 12).tolist()
    rep_prompt = rep_seed + engine(64).generate([rep_seed], max_new_tokens=24)[0]
    cases = (
        ("generate_speculative, self-draft", [s_prompt], "self"),
        ("generate_speculative, 2-layer draft (seed 1), two rows", w_prompts, "draft"),
        ("DeviceSpeculator, n-gram lookup, repetitive prompt", [rep_prompt], "ngram"),
        ("DeviceSpeculator, 2-layer draft", [s_prompt], "device-draft"),
    )
    spec = []
    for q in (False, True):
        for label, prompts, how in cases:
            if q and how != "self" and how != "ngram":
                continue
            B = len(prompts)
            tgt = engine(256, q, batch=B)
            drf = InferenceEngine(d_cfg, d_params, max_batch=B, max_seq=256, device=dev,
                                  kv_quantized=q)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want = tgt.generate(prompts, max_new_tokens=FD_NEW)
            t_plain = time.perf_counter() - t0
            kv = "int8" if q else "bf16"
            self_draft = engine(256, q, batch=B) if how == "self" else None
            with main_run(f"{label} ({kv} KV)", total):
                t0 = time.perf_counter()
                if how == "self":
                    got, st = generate_speculative(tgt, self_draft, prompts, FD_NEW,
                                                   n_draft=FD_DRAFT)
                elif how == "draft":
                    got, st = generate_speculative(tgt, drf, prompts, FD_NEW, n_draft=FD_DRAFT)
                else:
                    got, st = DeviceSpeculator(tgt, drf if how == "device-draft" else None,
                                               n_draft=FD_DRAFT, ngram=3).generate(prompts,
                                                                                   FD_NEW)
                t_spec = time.perf_counter() - t0
            n_tok = sum(len(r) for r in want)
            differ = sum(a != b for r, w in zip(got, want) for a, b in zip(r, w))
            acc = st["accepted"] / max(1, st["drafted"])
            row = {"case": label, "kv": kv, "rounds": st["rounds"], "acceptance": acc,
                   "tok_s": n_tok / t_spec, "plain_tok_s": n_tok / t_plain,
                   "tokens_differing": differ}
            spec.append(row)
            log(f"  [{gpu}] {label}, {kv} KV, n_draft {FD_DRAFT}: {st['rounds']} rounds, "
                f"acceptance {acc:.1%} ({st['accepted']} of {st['drafted']}), {n_tok / t_spec:.1f} "
                f"tok/s against plain greedy's {n_tok / t_plain:.1f}; tokens differing from "
                f"plain greedy: {differ} of {n_tok}")
            if not q and (got != want or (how == "self" and st["accepted"] != st["drafted"])):
                raise SystemExit(f"FAIL: {label} on bf16 KV differs from plain greedy or "
                                 f"rejected a self-draft: {got} against {want}, {st}")
    res["speculative"] = spec
    del d_params

    # -- perplexity -----------------------------------------------------------------
    ppl_ids = rng.integers(3, cfg.vocab_size, 1024).tolist()
    ppl_eng = engine(512)
    with main_run("perplexity", total):
        t0 = time.perf_counter()
        full = perplexity.perplexity(ppl_eng, ppl_ids, ctx=512)
        t_ppl = time.perf_counter() - t0
    cut_g = perplexity.perplexity(engine(512, c=cut, p=p_cut), ppl_ids, ctx=512)
    with cpu_dequant_memo():
        cut_c = perplexity.perplexity(_cpu_engine(cut, p_cut, max_seq=512), ppl_ids, ctx=512)
    rel = abs(cut_g["ppl"] / cut_c["ppl"] - 1)
    log(f"  [{gpu}] perplexity, 1024 ids at ctx 512: {full['ppl']:.4f} over {full['tokens']} "
        f"tokens ({full['windows']} windows, {t_ppl:.2f} s); 2-layer cut {cut_g['ppl']:.6f}, "
        f"CPU {cut_c['ppl']:.6f} (rel {rel:.2e})")
    if not (math.isfinite(full["ppl"]) and rel < 1e-3):
        raise SystemExit("FAIL: perplexity is not finite, or the 2-layer cut differs from the "
                         "CPU's by 1e-3 or more")
    res["ppl"] = full["ppl"]

    # -- the bench CLI ------------------------------------------------------------
    t0 = time.perf_counter()
    with main_run("tools/bench_cli.py", total):
        res["bench"] = bench_cli.main(["-m", path, "-p", "512", "-n", "128", "-r", "2"])
    log(f"  [{gpu}] tools/bench_cli.py -p 512 -n 128 -r 2 ({time.perf_counter() - t0:.1f} s "
        f"with its load):")
    for line in res["bench"]:
        log(f"    {line}")
    res["launches"] = total
    res["seconds"] = time.perf_counter() - t_phase
    log(f"  launches of phase 14's main-path runs: {_nonzero(total)}")
    log(f"  phase 14 took {res['seconds']:.1f} s [{gpu}]")
    del params
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phase 18: Llama-3-8B at full width and depth, and the int8 folds
# ---------------------------------------------------------------------------

L3_NAME = "llama-3-8b-q4_k_m-seed0.gguf"
# the fold switches of phase 18's second and third runs (ops/dequant.py):
# "auto" with the MXU mins off folds attn_in at 8B widths wherever the TPU
# takes the grid (the 16-row ticks); TKQ_INT8_FOLDS=1 also folds oproj_ffn's
# q4 gate/up at every row count (the fixture's q6w wo sends decode to #5)
L3_FOLD_ENVS = (("TKQ_Q4_MXU_MINS=0", {"TKQ_Q4_MXU_MINS": "0"}),
                ("TKQ_INT8_FOLDS=1", {"TKQ_INT8_FOLDS": "1"}))
L3_SERVE = (16, 128, 32)  # slots, cache length, requests (every eighth greedy)


def start_llama3_fixture() -> subprocess.Popen | None:
    """Write phase 18's Llama-3-8B Q4_K_M fixture (seed 0, its vocab, 32
    layers, ~4.9 GB) in a process of its own from the end of phase 2 (beside
    the build it took 26 s from nvcc), as load_fixture would write it. None
    when the file is there already."""
    if (FIXTURE_DIR / L3_NAME).exists():
        return None
    code = ("import os, sys, time; t0 = time.perf_counter(); sys.path.insert(0, sys.argv[1])\n"
            "from tpu_kquant_torch.models.fixtures import llama3_8b_config, write_fixture_gguf\n"
            "tmp = sys.argv[2] + '.tmp'\n"
            "write_fixture_gguf(tmp, llama3_8b_config(), seed=0, recipe='q4_k_m', scale=0.05)\n"
            "os.replace(tmp, sys.argv[2]); print(time.perf_counter() - t0)\n")
    FIXTURE_DIR.mkdir(parents=True, exist_ok=True)
    return subprocess.Popen([sys.executable, "-c", code, str(ROOT), str(FIXTURE_DIR / L3_NAME)],
                            stdout=subprocess.PIPE, text=True)


def tg128_ab(cfg, params, dev, tag: str) -> dict:
    """tg128 after a 512-token prompt on one 704-slot cache, refilled
    before each run: a warm run (it captures the step), then the plain
    loop and the graph, each counted from 0 (main_run); their tokens and
    last logits equal bit for bit (fatal). One run a side: a plain run of
    Llama-3-8B takes ~7 s. Returns the rates and the launches."""
    import numpy as np
    import torch

    from tpu_kquant_torch.runtime.engine import InferenceEngine

    eng = InferenceEngine(cfg, params, max_batch=1, max_seq=704, device=dev)
    prompt = np.random.default_rng(2).integers(10, cfg.vocab_size, 512).tolist()
    cache = eng.new_cache(1)
    eng.decode_greedy(*refill(eng, prompt, cache), cache, 4)
    launches: dict = {}
    tg: dict = {True: [], False: []}
    runs = []
    for plain in (True, False):
        first, pos = refill(eng, prompt, cache)
        torch.cuda.synchronize()
        with main_run(f"tg128{tag}{' (plain loop)' if plain else ''}", launches):
            t0 = time.perf_counter()
            toks, cache = eng.decode_greedy(first, pos, cache, 128, plain=plain)
            torch.cuda.synchronize()
            tg[plain].append(time.perf_counter() - t0)
        runs.append((toks, eng.last_logits.clone()))
    same = all(torch.equal(a, runs[0][0]) and torch.equal(b, runs[0][1]) for a, b in runs)
    log(f"  [{gpu_line()}]{tag} tg128 (plain, graph): graph "
        f"{', '.join(f'{128 / t:.1f}' for t in tg[False])} tok/s, plain "
        f"{', '.join(f'{128 / t:.1f}' for t in tg[True])} tok/s; tokens and last logits "
        f"equal bit for bit: {same}")
    if not same:
        raise SystemExit(f"FAIL:{tag} the decode loop's graph differs from the plain loop")
    return {"tg128_tok_s_all": [128 / t for t in tg[False]],
            "tg128_plain_tok_s_all": [128 / t for t in tg[True]], "launches": launches}


def l3_serving(cfg, params, dev, tag: str, alone_at_b: bool) -> dict:
    """L3_SERVE's requests (serve_request: 32-63 prompt tokens, 48 new, every
    eighth greedy) on a ContinuousBatcher of 16 slots, counted from 0 and
    held to the gates (serving_launches); every greedy stream must equal
    its run alone (fatal): a batch-1 generate, or where `alone_at_b` (the
    fold runs, whose function changes at 8 rows with the TPU's choice of
    variant) the request repeated in all 16 rows of one generate, so that
    its decode steps run at the ticks' row count."""
    import dataclasses

    import numpy as np
    import torch

    from tpu_kquant_torch.runtime.engine import InferenceEngine
    from tpu_kquant_torch.serving import ContinuousBatcher

    B, max_seq, n = L3_SERVE
    rng = np.random.default_rng(11)
    greedy = {i for i in range(n) if i % 8 == 0}
    reqs = [serve_request(i, cfg, rng, greedy=i in greedy) for i in range(n)]
    eng = InferenceEngine(cfg, params, max_batch=B, max_seq=max_seq, device=dev)
    solo_eng = eng if alone_at_b else InferenceEngine(cfg, params, max_batch=1,
                                                      max_seq=max_seq, device=dev)
    kw = dict(max_new_tokens=SERVE_NEW, top_k=40, top_p=0.95, repeat_penalty=1.1,
              penalty_last_n=64)
    solo = {}
    for i in sorted(greedy):
        rows = solo_eng.generate([reqs[i].prompt] * (B if alone_at_b else 1), **kw)
        if any(r != rows[0] for r in rows):
            raise SystemExit(f"FAIL: Llama-3-8B{tag}: copies of request {i} in one batch "
                             f"differ")
        solo[i] = rows[0]
    cb = ContinuousBatcher(eng)
    rec = instrument(cb)
    for r in (dataclasses.replace(r, output=[]) for r in reqs):
        cb.submit(r)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    done = sorted(cb.run(), key=lambda r: r.rid)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = check_counts(f"Llama-3-8B serving{tag}",
                       serving_launches(cfg, params, rec, cb.stats["ticks_run"], B, max_seq,
                                        False))
    if not (len(done) == n and bool(cb.logits_finite)):
        raise SystemExit(f"FAIL: Llama-3-8B serving{tag} lost a request or saw non-finite "
                         f"logits")
    differ = [(r.rid, next(j for j, (a, b) in enumerate(zip(r.output + [-1], solo[r.rid] + [-2]))
                          if a != b))
              for r in done if r.rid in greedy and r.output != solo[r.rid]]
    res = {"tok_s": cb.stats["tokens_out"] / wall, "wall_s": wall, "ticks": cb.stats["steps"],
           "launches": got, "folded": {k: got.get(k, 0) for k in FOLDED}, "differ": differ}
    log(f"  [{gpu_line()}] Llama-3-8B serving{tag}, {B} slots x {max_seq}: {n} requests, "
        f"{cb.stats['tokens_out']} tokens in {wall:.3f} s = {res['tok_s']:.1f} tok/s, "
        f"{res['ticks']} ticks; folded launches {res['folded']}; greedy streams differing from "
        f"their runs alone{' (16 copies)' if alone_at_b else ''}: {len(differ)} of "
        f"{len(greedy)} {differ}")
    if differ:
        raise SystemExit(f"FAIL: Llama-3-8B serving{tag}: greedy streams differ from their runs "
                         f"alone (request, first step): {differ}")
    return res


def llama3(dev, writer: subprocess.Popen | None, profile: Path | None = None) -> dict:
    """Phase 18 (module docstring). Returns its numbers and the launches of
    its main-path runs."""
    import torch

    from tpu_kquant_torch.models.fixtures import llama3_8b_config

    t_phase = time.perf_counter()
    steps: dict = {}  # wall seconds of each step, logged at the end

    def lap(what: str) -> None:
        steps[what] = time.perf_counter() - t_phase - sum(steps.values())

    if writer is not None:
        out, _ = writer.communicate()
        if writer.returncode != 0:
            raise SystemExit(f"FAIL: the Llama-3-8B fixture writer exited {writer.returncode}")
        log(f"  fixture writer (started after phase 2's build): {float(out.strip()):.1f} s; "
            f"waited {time.perf_counter() - t_phase:.1f} s for it here")
    cfg0 = llama3_8b_config()
    cfg, params, times = load_fixture(cfg0, L3_NAME, dev)
    L = cfg.n_layers
    shape = lambda c: (c.n_layers, c.dim, c.n_heads, c.n_kv_heads, c.ffn_dim,  # noqa: E731
                       c.vocab_size, c.rope.freq_base)
    if shape(cfg) != shape(cfg0):
        raise SystemExit(f"FAIL: Llama-3-8B loaded as {shape(cfg)}, not {shape(cfg0)}")
    pin_dispatch(cfg, params, "Llama-3-8B", {"attn_in": L, "oproj_ffn": L, "qmm": 1}, 2048)
    lap("wait, load, pins")
    reference_check(cfg, params, dev)
    lap("2-layer cut against the CPU")
    res = {"load": times, "runs": []}
    # requests, pp512 and tg128 (graph; tg128_ab holds it to the plain loop)
    res["default"] = end_to_end(dev, cfg, params, tag=" Llama-3-8B", profile=profile, reps=2)
    res["default_ab"] = tg128_ab(cfg, params, dev, " Llama-3-8B")
    res["runs"] += [res["default"]["main_path_launches"], res["default_ab"]["launches"]]
    lap("requests, pp512, tg128")
    res["serve"] = {"default": l3_serving(cfg, params, dev, "", False)}
    res["runs"].append(res["serve"]["default"]["launches"])
    lap("serving")
    for label, env in L3_FOLD_ENVS:
        with switches(env):
            # the pins: a decode step and a 16-row tick, as the gates say now
            step = expected_launches(cfg, params, 1, seq=704)
            tick = expected_launches(cfg, params, 1, batch=L3_SERVE[0], seq=L3_SERVE[1])
            log(f"  {label}: decode step {_nonzero(step)}; 16-row tick {_nonzero(tick)}")
            want_step = L if env.get("TKQ_INT8_FOLDS") == "1" else 0
            if (step["oproj_ffn.folded"], step["attn_in.folded"], tick["attn_in.folded"]) != \
                    (want_step, 0, L):
                raise SystemExit(f"FAIL: Llama-3-8B {label}: the fold dispatch is {step} at a "
                                 f"decode step and {tick} at a 16-row tick")
            tg = tg128_ab(cfg, params, dev, f" Llama-3-8B {label}")
            srv = l3_serving(cfg, params, dev, f" {label}", True)
        folded = _add(tg["launches"], srv["launches"])
        if folded.get("attn_in.folded", 0) == 0 or (
                env.get("TKQ_INT8_FOLDS") == "1" and folded.get("oproj_ffn.folded", 0) == 0):
            raise SystemExit(f"FAIL: Llama-3-8B {label}: no folded launch ({_nonzero(folded)})")
        res["serve"][label], res[label] = srv, tg
        res["runs"] += [tg["launches"], srv["launches"]]
        lap(f"{label}: tg128, serving")
    log(f"  phase 18 took {sum(steps.values()):.1f} s [{gpu_line()}]: "
        + ", ".join(f"{k} {v:.1f} s" for k, v in steps.items()))
    del params
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phase 17: the quantizer and the converter
# ---------------------------------------------------------------------------

FP64_FLOPS = 34e12  # H100 SXM FP64 without tensor cores (NVIDIA's data sheet)
FP32_FLOPS = 67e12  # H100 SXM FP32 without tensor cores
# TinyLlama-1.1B's raw tensors at the types q4_k_m gives them (ffn_gate also
# under q8_0): (label, type name, N, K)
QUANT_CASES = (("attn_q", "Q4_K", 2048, 2048), ("ffn_gate", "Q4_K", 5632, 2048),
               ("attn_v", "Q6_K", 256, 2048), ("ffn_down", "Q6_K", 2048, 5632),
               ("output", "Q6_K", 32000, 2048), ("ffn_gate q8_0", "Q8_0", 5632, 2048))
QUANT_HEAD = {"quantize_q4k": "ffn_gate", "quantize_q6k": "output",
              "quantize_q80": "ffn_gate q8_0"}
QUANT_NUMPY_ROWS = 64  # rows held to the NumPy copy (it takes ~1 s a million values)
PPL_DEPTH = 4  # (c): TinyLlama's layers under ppl_delta (of 22)
PPL_TYPES = "q8_0,q6_k,q4_k_m"
QUANT_PROMPT = 32  # (b): the prompt held to the F16 model's top 5


def quant_bound(t, n: int) -> tuple[float, str]:
    """The least time of quantizing n values to t: the larger of its bytes
    over 3.35 TB/s and its f64 / f32 operations over their peaks."""
    from tpu_kquant_torch.ops import quantize as qops

    b, f64, f32 = qops.work(t, n)
    tb, to = b / HBM_BYTES_PER_S, max(f64 / FP64_FLOPS, f32 / FP32_FLOPS)
    return max(tb, to) * 1e3, "bytes" if tb >= to else "operations"


def _edge_values(n: int):
    """tests/test_native.py's six edge cases, each n values (n % 512 == 0)."""
    import numpy as np

    rng = np.random.default_rng(5)
    half = np.concatenate([np.zeros(n // 2), rng.standard_normal(n // 2)])
    return {"zeros": np.zeros(n), "constant": np.full(n, 3.25),
            "plus-minus-one": np.tile([1.0, -1.0], n // 2), "half-zeros": half,
            "x100": rng.standard_normal(n) * 100.0, "x0.01": rng.standard_normal(n) * 0.01}


def check_quantizers(dev) -> dict:
    """Part (a): each quantize kernel against its plain version on the card,
    bit for bit, on whole tensors of TinyLlama's shapes (seeded Gaussian
    values of std 0.05) and on the edge cases, and the first rows against
    the port's NumPy copy; timed graph and eager. Returns {kernel: cases}."""
    import numpy as np
    import torch

    from tpu_kquant_torch.gguf import GGMLType
    from tpu_kquant_torch.ops import quantize as qops
    from tpu_kquant_torch.quant import numpy_codecs

    names = {GGMLType.Q4_K: "quantize_q4k", GGMLType.Q6_K: "quantize_q6k",
             GGMLType.Q8_0: "quantize_q80"}
    out: dict = {n: [] for n in names.values()}
    for t in names:
        for label, x in _edge_values(8192).items():
            xt = torch.from_numpy(x.astype(np.float32)).to(dev)
            k, p = qops.QUANTIZERS[t](xt), qops.PLAIN[t](xt)
            want = numpy_codecs.quantize(x.astype(np.float32), t)
            if not (torch.equal(k, p) and np.array_equal(k.cpu().numpy(), want)):
                raise SystemExit(f"FAIL: {names[t]} differs on the edge case {label}")
    log(f"  edge cases ({', '.join(_edge_values(512))}): every kernel equals its plain "
        "version and the NumPy copy, bit for bit")
    gen = torch.Generator(device=dev)
    for i, (label, tname, N, K) in enumerate(QUANT_CASES):
        t = GGMLType[tname]
        gen.manual_seed(i)
        x = torch.randn(N, K, generator=gen, device=dev) * 0.05
        fn, plain = qops.QUANTIZERS[t], qops.PLAIN[t]
        k = fn(x)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p = plain(x)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        same = torch.equal(k, p)
        rows = k.numel() // N * QUANT_NUMPY_ROWS
        np_same = np.array_equal(k[:rows].cpu().numpy(), numpy_codecs.quantize(
            x[:QUANT_NUMPY_ROWS].cpu().numpy(), t))
        del p
        iters = max(2, min(50, int(2e8 // (N * K))))
        ms = graph_ms(lambda _: fn(x), iters)
        eager = time_ms(lambda _: fn(x), iters)
        bms, by = quant_bound(t, N * K)
        case = {"case": f"{label} [{N}, {K}] {tname}", "max_abs_err": 0.0 if same else
                float("nan"), "rel_err": 0.0 if same else float("nan"), "ms": ms,
                "eager_ms": eager, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                "library_ms": None, "numpy_rows_equal": np_same, "bit_exact": same,
                "tensor": label}
        out[names[t]].append(case)
        log(f"  {names[t]:13s} {case['case']:32s} bit-exact {same} (NumPy, {QUANT_NUMPY_ROWS} "
            f"rows: {np_same})  kernel {ms:8.3f} ms (eager {eager:8.3f})  plain "
            f"{plain_ms:9.2f} ms  bound {bms:7.3f} ms ({by})")
        if not (same and np_same):
            raise SystemExit(f"FAIL: {names[t]} {case['case']} is not the plain version's / "
                             "the NumPy copy's bytes")
        del x, k
    torch.cuda.empty_cache()
    return out


def _expected_quant_launches(types: dict, src_types: dict) -> dict:
    """The quantize kernels' launches of one requantize: one a tensor whose
    type changes to Q4_K, Q6_K or Q8_0."""
    from tpu_kquant_torch.gguf import GGMLType

    names = {GGMLType.Q4_K: "quantize_q4k", GGMLType.Q6_K: "quantize_q6k",
             GGMLType.Q8_0: "quantize_q80"}
    want = dict.fromkeys(names.values(), 0)
    for name, t in types.items():
        if t in names and t != src_types[name]:
            want[names[t]] += 1
    return want


def _logits(eng, prompt: list) -> "torch.Tensor":
    import torch

    cache = eng.new_cache(1)
    logits, _, _ = eng.prefill([prompt], cache)
    return logits[0].float()


def _corr(a, b) -> float:
    a, b = a.double() - a.double().mean(), b.double() - b.double().mean()
    return float((a * b).sum() / (a.norm() * b.norm()))


F16_NAME = "tinyllama-1.1b-f16-seed0.gguf"


def start_f16_fixture() -> subprocess.Popen | None:
    """Write (b)'s F16 TinyLlama-1.1B fixture in a process of its own from
    the end of phase 2: its 1.1 G normal draws take ~40-70 s of one core. Phase 17 waits for it (requantize_tinyllama). None
    when the fixture directory already holds it, as load_fixture reuses the
    others."""
    if (FIXTURE_DIR / F16_NAME).exists():
        return None
    code = ("import os, sys, time; t0 = time.perf_counter(); sys.path.insert(0, sys.argv[1])\n"
            "from tpu_kquant_torch.models.fixtures import tinyllama_1b_config, "
            "write_fixture_gguf\n"
            "tmp = sys.argv[2] + '.tmp'\n"
            "write_fixture_gguf(tmp, tinyllama_1b_config(), seed=0, recipe='f16')\n"
            "os.replace(tmp, sys.argv[2]); print(time.perf_counter() - t0)\n")
    FIXTURE_DIR.mkdir(parents=True, exist_ok=True)
    return subprocess.Popen([sys.executable, "-c", code, str(ROOT), str(FIXTURE_DIR / F16_NAME)],
                            stdout=subprocess.PIPE, text=True)


def requantize_tinyllama(dev, gpu: str, writer: subprocess.Popen | None = None) -> dict:
    """Part (b): TinyLlama-1.1B's F16 fixture (seed 0, full width and depth)
    requantized to q4_k_m on the card; its types against the recipe, layer
    0's tensors and the lm head (QUANT_NUMPY_ROWS rows each) against the
    NumPy copy, then the result loaded and run beside the F16 model."""
    import numpy as np
    import torch

    from tpu_kquant_torch.gguf import GGUFReader
    from tpu_kquant_torch.models.fixtures import tinyllama_1b_config, write_fixture_gguf
    from tpu_kquant_torch.quant import numpy_codecs
    from tpu_kquant_torch.quant.repack import dequantize
    from tpu_kquant_torch.runtime.engine import InferenceEngine
    from tpu_kquant_torch.runtime.loader import load_model
    from tpu_kquant_torch.tools.quantize import requantize, target_type

    FIXTURE_DIR.mkdir(parents=True, exist_ok=True)
    f16 = FIXTURE_DIR / F16_NAME
    q4 = FIXTURE_DIR / "tinyllama-1.1b-f16-seed0-requantized-q4_k_m.gguf"
    t0 = time.perf_counter()
    how = "reused from the fixture directory" if f16.exists() else "written here"
    if writer is not None:
        out, _ = writer.communicate()
        if writer.returncode != 0:
            raise SystemExit(f"FAIL: the F16 fixture's writer exited with {writer.returncode}")
        how = f"written in the background since phase 2's build in {float(out):.1f} s"
    if not f16.exists():
        write_fixture_gguf(f16, tinyllama_1b_config(), seed=0, recipe="f16")
    t1 = time.perf_counter()
    log(f"  F16 fixture {f16.name} ({f16.stat().st_size / 1e9:.2f} GB): {how}; waited "
        f"{t1 - t0:.1f} s for it")
    reset_counts()
    stats = requantize(str(f16), str(q4), "q4_k_m", verbose=False, device=str(dev))
    got = counts()
    sec = stats["seconds"]
    log(f"  requantize F16 -> q4_k_m on the card: {sec['total']:.2f} s wall = host dequantize "
        f"{sec['dequantize']:.2f} + copies {sec['copies']:.2f} + kernels (synchronised) "
        f"{sec['quantize_card']:.3f} + host quantize {sec['quantize_host']:.3f} + reading and "
        f"writing {sec['rest']:.2f}; {stats['bytes_in'] / 1e9:.3f} GB -> "
        f"{stats['bytes_out'] / 1e9:.3f} GB [{gpu}]")
    with GGUFReader(str(f16)) as rf, GGUFReader(str(q4)) as rq:
        src = {k: v.ggml_type for k, v in rf.tensors.items()}
        want = _expected_quant_launches(stats["types"], src)
        check_counts("requantize (b)", want)
        kinds: dict = {}
        for name, ti in rq.tensors.items():
            t = target_type(name, ti.shape, "q4_k_m")
            if ti.ggml_type != t or stats["types"][name] != t:
                raise SystemExit(f"FAIL: {name} is {ti.ggml_type.name}, the recipe says {t.name}")
            kinds[t.name] = kinds.get(t.name, 0) + 1
        log(f"  output types as q4_k_m gives them: {kinds}")
        for name in [n for n in rq.tensors if n.startswith("blk.0.")] + ["output.weight"]:
            ti = rq.tensors[name]
            if len(ti.shape) == 1:
                continue
            rows = min(QUANT_NUMPY_ROWS, ti.shape[0])
            n_src = rows * ti.shape[1]
            x = dequantize(rf.tensor_bytes(name)[: n_src * 2], src[name], (rows, ti.shape[1]))
            want_b = numpy_codecs.quantize(x, ti.ggml_type)
            if not np.array_equal(np.asarray(rq.tensor_bytes(name)[: want_b.size]), want_b):
                raise SystemExit(f"FAIL: {name}'s first {rows} rows differ from the NumPy copy")
        log(f"  layer 0's tensors and the lm head: the first {QUANT_NUMPY_ROWS} rows equal "
            "the NumPy copy's bytes")
    t2 = time.perf_counter()
    cq, pq, _ = load_model(str(q4), scale_dtype="bf16", device=dev)
    c16, p16, _ = load_model(str(f16), device=dev)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    draws = np.random.default_rng(17).integers(3, cq.vocab_size, QUANT_PROMPT - 1)
    prompt = [1] + [int(v) for v in draws]
    lq = _logits(InferenceEngine(cq, pq, max_batch=1, max_seq=64, device=dev), prompt)
    l16 = _logits(InferenceEngine(c16, p16, max_batch=1, max_seq=64, device=dev), prompt)
    top5 = torch.topk(l16, 5).indices.tolist()
    first = int(lq.argmax())
    corr = _corr(lq, l16)
    log(f"  loads: q4_k_m (bf16 scales) and F16 in {t3 - t2:.1f} s; a {QUANT_PROMPT}-token "
        f"prompt: q4_k_m's first greedy token {first}, F16's top 5 {top5}; logits' correlation "
        f"{corr:.5f}; finite {bool(torch.isfinite(lq).all())}")
    if first not in top5 or not torch.isfinite(lq).all() or lq.shape != l16.shape:
        raise SystemExit("FAIL: the requantized TinyLlama's first token is not in the F16 "
                         "model's top 5")
    del pq, p16
    torch.cuda.empty_cache()
    return {"launches": got, "seconds": sec, "corr": corr, "load_s": t3 - t2,
            "write_s": t1 - t0, "f16": f16}


def _cut_gguf(src, dst, depth: int) -> None:
    """A copy of the llama GGUF `src` cut to its first `depth` layers."""
    from tpu_kquant_torch.gguf import GGUFReader, GGUFWriter

    with GGUFReader(str(src)) as r:
        w = GGUFWriter(dst)
        for k, v in r.metadata.items():
            w.add(k, depth if k.endswith(".block_count") else v)
        for name, ti in r.tensors.items():
            if not name.startswith("blk.") or int(name.split(".")[1]) < depth:
                w.add_tensor(name, ti.shape, ti.ggml_type, lambda n=name: r.tensor_bytes(n))
        w.write()


def ppl_ladder(dev, gpu: str, full_f16) -> dict:
    """Part (c): tools/ppl_delta.py at TinyLlama's full width cut to
    PPL_DEPTH layers (full_f16's, (b)'s F16 fixture), --types PPL_TYPES --ctx 256 --max-windows 2, on a text
    of the fixture vocab's words; KL must fall q4_k_m > q6_k > q8_0 and
    q8_0's dppl be near-lossless: |dppl| < 1 at the reference test's ppl of
    512 (tests/test_quantize_tool.py: vocab 512), so |dppl| / ppl < 1 / 512
    here, where a random model's ppl sits near the vocab, 32000."""
    import numpy as np

    from tpu_kquant_torch.gguf import GGUFReader
    from tpu_kquant_torch.tools import ppl_delta
    from tpu_kquant_torch.tools.quantize import target_type

    f16 = FIXTURE_DIR / f"tinyllama-1.1b-{PPL_DEPTH}l-f16-seed0.gguf"
    t0 = time.perf_counter()
    if not f16.exists():
        _cut_gguf(full_f16, f16, PPL_DEPTH)
    log(f"  {f16.name}: the first {PPL_DEPTH} layers of {full_f16.name} (with its embeddings, "
        f"norm and lm head), copied in {time.perf_counter() - t0:.1f} s")
    words = ["hello", "world", "the", "a", "tell", "her", "other", "hell", "to", "the"]
    text = FIXTURE_DIR / "ppl_text.txt"
    text.write_text(" ".join(np.random.default_rng(3).choice(words, 1200)))
    with GGUFReader(str(f16)) as r:
        src = {k: (v.ggml_type, v.shape) for k, v in r.tensors.items()}
    want: dict = {}
    for recipe in PPL_TYPES.split(","):
        types = {k: target_type(k, s, recipe) for k, (_, s) in src.items()}
        want = _add(want, _expected_quant_launches(types, {k: t for k, (t, _) in src.items()}))
    out = FIXTURE_DIR / "ppl_delta.json"
    t0 = time.perf_counter()
    reset_counts()
    rows = ppl_delta.main(["--model", str(f16), "--text", str(text), "--types", PPL_TYPES,
                           "--ctx", "256", "--max-windows", "2", "--device", str(dev),
                           "--json-out", str(out)])
    got = check_counts("ppl_delta (c)", want)
    secs = time.perf_counter() - t0
    if got.get("qmm", 0) == 0:
        raise SystemExit("FAIL: ppl_delta's quantized windows never launched qmm")
    kl = {r["type"]: r["kl"] for r in rows}
    log(f"  ppl_delta at {PPL_DEPTH} of 22 layers, full width: {secs:.1f} s; KL {kl}; "
        f"dppl {[r['dppl'] for r in rows]}; top-1 {[r['top1'] for r in rows]} [{gpu}]")
    if not kl["q4_k_m"] > kl["q6_k"] > kl["q8_0"]:
        raise SystemExit(f"FAIL: KL is not ordered q4_k_m > q6_k > q8_0: {kl}")
    base = json.loads(out.read_text())["base_ppl"]
    dq8 = [r["dppl"] for r in rows if r["type"] == "q8_0"][0]
    log(f"  base ppl {base}; |dppl(q8_0)| / ppl = {abs(dq8) / base:.2e} (limit 1/512)")
    if not abs(dq8) / base < 1 / 512:
        raise SystemExit(f"FAIL: |dppl(q8_0)| = {abs(dq8)} at ppl {base}: not near-lossless")
    return {"launches": got, "rows": rows, "seconds": secs, "base_ppl": base}


def quantizer(dev, writer: subprocess.Popen | None = None) -> dict:
    """Phase 17: (a) the kernels against their plain versions, (b)
    TinyLlama-1.1B requantized on the card (its F16 fixture from `writer`,
    start_f16_fixture's process) and run, (c) ppl_delta's ladder. The
    launches of (b)'s requantize and (c)'s run are the main path's."""
    gpu = gpu_line()
    t0 = time.perf_counter()
    cases = check_quantizers(dev)
    t1 = time.perf_counter()
    req = requantize_tinyllama(dev, gpu, writer)
    t2 = time.perf_counter()
    ppl = ppl_ladder(dev, gpu, req["f16"])
    t3 = time.perf_counter()
    log(f"  phase 17 took {t3 - t0:.1f} s: (a) {t1 - t0:.1f}, (b) {t2 - t1:.1f}, "
        f"(c) {t3 - t2:.1f} [{gpu}]")
    return {"cases": cases, "launches": _add(req["launches"], ppl["launches"]),
            "seconds": t3 - t0}


REPLACES = {
    "qmm": ("tpu_kquant_torch/csrc/qmm.cuh", "tpu_kquant/ops/pallas_qmm.py:287"),
    "attn_in": ("tpu_kquant_torch/csrc/attn_in.cu", "tpu_kquant/ops/pallas_attn_in.py:567"),
    "oproj_ffn": ("tpu_kquant_torch/csrc/ffn.cu", "tpu_kquant/ops/pallas_ffn.py:983"),
    "ffn": ("tpu_kquant_torch/csrc/ffn.cu", "tpu_kquant/ops/pallas_ffn.py:331"),
    "prefill": ("tpu_kquant_torch/csrc/prefill.cu", "tpu_kquant/ops/pallas_prefill.py:168"),
    "qmm_int8": ("tpu_kquant_torch/csrc/qmm_int8.cu", "tpu_kquant/ops/pallas_qmm_int8.py:139"),
    "decode_attn": ("tpu_kquant_torch/csrc/decode_attn.cu",
                    "tpu_kquant/ops/pallas_attention.py:144"),
    "kv_append": ("tpu_kquant_torch/csrc/kv_append.cu", "tpu_kquant/ops/pallas_kv_append.py:97"),
    "attn_out": ("tpu_kquant_torch/csrc/attn_out.cu", "tpu_kquant/ops/pallas_attn_out.py:314"),
    "layer": ("tpu_kquant_torch/csrc/layer.cu", "tpu_kquant/ops/pallas_layer.py:611"),
    "rot": ("tpu_kquant_torch/csrc/rot.cu", "tpu_kquant/ops/attic/pallas_rot.py:462"),
    "lab_qmm_n": ("tpu_kquant_torch/csrc/kernel_lab.cu", "tpu_kquant/utils/kernel_lab.py:296"),
    "lab_qmm_k": ("tpu_kquant_torch/csrc/kernel_lab.cu", "tpu_kquant/utils/kernel_lab.py:343"),
    "lab_qmm_manual": ("tpu_kquant_torch/csrc/kernel_lab.cu",
                       "tpu_kquant/utils/kernel_lab.py:516"),
    "prefill_lab_a": ("tpu_kquant_torch/csrc/prefill_lab.cu", "tools_prefill_lab2.py:69"),
    "prefill_lab_b": ("tpu_kquant_torch/csrc/prefill_lab.cu", "tools_prefill_lab2.py:156"),
    "prefill_lab_g": ("tpu_kquant_torch/csrc/prefill_lab.cu", "tools_prefill_lab3.py:122"),
    # no pallas_call: the reference's host quantizers (its native library's)
    "quantize_q4k": ("tpu_kquant_torch/csrc/quantize.cu", "csrc/tkq.cpp:364"),
    "quantize_q6k": ("tpu_kquant_torch/csrc/quantize.cu", "csrc/tkq.cpp:419"),
    "quantize_q80": ("tpu_kquant_torch/csrc/quantize.cu", "csrc/tkq.cpp:477"),
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", type=Path, metavar="DIR",
                    help="also profile one pp512 prefill and 8 decode steps (in phase "
                         "5 a pp2048 prefill and 8 steps at depth 2048 per KV kind; in "
                         "phase 6 four serving ticks of each configuration; in phase 7 "
                         "the same as phase 4 at Qwen2.5-1.5B); write the kernel tables "
                         "into DIR")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        log("FAIL: torch.cuda.is_available() is false; this smoke test needs a CUDA card")
        return 2
    sys.path.insert(0, str(ROOT))
    from tpu_kquant_torch.ops import _build

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    phase("phase 1: device")
    log(f"  {gpu_line()}")
    nvcc = subprocess.run([_build.nvcc_path(), "--version"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[-1]
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, {nvcc}, "
        f"python {sys.version.split()[0]}")

    phase("phase 2: build")
    # phase 17's F16 and phase 18's Llama-3-8B fixtures are written after the
    # build (run_phases), on cores the card's phases leave idle: beside the
    # 15 nvcc processes they slowed the build (65.9 -> 91.7 s with both)
    writers = {"f16": None, "llama3": None}
    try:
        return run_phases(args, dev, writers, t_start)
    finally:
        for w in writers.values():
            if w is not None and w.poll() is None:
                w.kill()
                w.wait()


def run_phases(args, dev, writers: dict, t_start: float) -> int:
    """Phases 2-18, then the kernels' JSON line and the last line."""
    import torch

    from tpu_kquant_torch.ops import _build

    record_captures()
    log(f"  built {', '.join(_build.SOURCES)} in {_build.build_all():.1f} s "
        f"into {_build.BUILD_DIR.relative_to(ROOT)}")
    log("  per library, wall s when reaped (in this order; all ran in parallel) / nvcc CPU s: "
        + ", ".join(f"{k} {w:.1f} / {c:.1f}" for k, (w, c) in _build.BUILD_TIMES.items()))
    writers["f16"], writers["llama3"] = start_f16_fixture(), start_llama3_fixture()

    phase(f"phase 3: kernels vs plain versions on the card [{gpu_line()}]")
    cases = check_kernels(dev)

    phase("phase 4: end to end (TinyLlama-1.1B)")
    from tpu_kquant_torch.models.fixtures import tinyllama_1b_config

    cfg, params, _ = load_fixture(tinyllama_1b_config(), "tinyllama-1.1b-q4_k_m-seed0.gguf", dev)
    L = cfg.n_layers
    pin_dispatch(cfg, params, "TinyLlama-1.1B",
                 {"prefill": 0, "attn_in": L, "oproj_ffn": L, "ffn": 0, "qmm": 1, "qmm_int8": 0},
                 2048)
    reference_check(cfg, params, dev)
    e2e = end_to_end(dev, cfg, params, profile=args.profile, ab=True, sampled=True)
    # the int8 folds at TinyLlama: its q6w wo sends every decode step to #5,
    # which folds the q4 gate/up
    with switches({"TKQ_INT8_FOLDS": "1"}):
        fold_tg = tg128_ab(cfg, params, dev, " TinyLlama-1.1B TKQ_INT8_FOLDS=1")
    if fold_tg["launches"].get("oproj_ffn.folded", 0) == 0:
        raise SystemExit("FAIL: TinyLlama-1.1B under TKQ_INT8_FOLDS=1 launched no folded "
                         "oproj_ffn")

    phase("phase 5: long prompts (bf16 and int8 KV)")
    long = long_prompts(cfg, params, dev, args.profile)

    phase("phase 6: serving (continuous batching, sampler chain, flash decode)")
    serve = serving(cfg, params, dev, profile=args.profile)
    # phase 10, path (a), on this load; (b) and (c) on phase 6's f32 load
    fused = fused_paths(dev, cfg, params, FUSED_PATHS[:1])
    del cfg, params
    torch.cuda.empty_cache()
    phase("phase 6: TinyLlama-1.1B on f32 scales (impl int8)")
    f32_counts, fused_bc = dense_f32(dev)
    fused.update(fused_bc)

    phase("phase 7: Qwen2.5-1.5B (biases, tied lm head, ffn kernel)")
    qwen = qwen2(dev, args.profile)
    torch.cuda.empty_cache()

    phase("phase 8: Mixtral-8x7B (MoE; bf16 pairs + impl auto, f32 scales + impl int8)")
    mix = mixtral(dev, args.profile)
    torch.cuda.empty_cache()

    phase("phase 9: GGML types (TinyLlama-1.1B under every recipe of the quantize tool)")
    ggml = ggml_types(dev, args.profile)
    torch.cuda.empty_cache()

    phase("phase 13: the gemma family (Gemma-2B; Gemma-2-9B cut to 2 layers)")
    gem = gemma(dev, args.profile)
    torch.cuda.empty_cache()

    phase(f"phase 15: the sliding-window family (Phi-3-mini-4k; iSWA rings) [{gpu_line()}]")
    swa = sliding_window(dev, gem.pop("gemma2_9b"), args.profile)
    torch.cuda.empty_cache()

    phase(f"phase 14: the front door (TinyLlama-1.1B, full depth) [{gpu_line()}]")
    front = front_door(dev)
    torch.cuda.empty_cache()

    phase(f"phase 16: the recurrent family (Mamba-2.8B, full depth) [{gpu_line()}]")
    mamba = recurrent(dev, args.profile)
    torch.cuda.empty_cache()

    phase(f"phase 17: the quantizer and the converter (TinyLlama-1.1B) [{gpu_line()}]")
    quant = quantizer(dev, writers["f16"])
    torch.cuda.empty_cache()

    phase(f"phase 18: Llama-3-8B (full width and depth; the int8 folds) [{gpu_line()}]")
    l3 = llama3(dev, writers["llama3"], args.profile)

    phase(f"phase 11: the qmm kernel lab (mutation ladder, manual ring) [{gpu_line()}]")
    lab = kernel_lab(dev, cases["qmm"])

    phase(f"phase 12: the prefill-attention lab (#17-#19 beside #8 and SDPA) [{gpu_line()}]")
    plab = prefill_lab(dev)

    # launches: the sums over the request runs of phases 4, 5 (both KV
    # kinds), 6 (the three serving runs and the f32-scale requests), 7, 8
    # (both configurations), 9 (every recipe), 10 (every path), 13
    # (Gemma-2B), 14 (its main-path runs), 15 (both layouts and the CLI) and
    # 16 (Mamba-2.8B's requests, session, CLI and serving), 17 and 18
    # (Llama-3-8B's requests, timed runs and serving under each switch
    # setting), each counted from 0 and checked exactly
    runs = [e2e["main_path_launches"], fold_tg["launches"], *long["launches"].values(),
            *serve["launches"].values(),
            f32_counts, qwen["main_path_launches"], *mix["launches"].values(),
            *ggml["launches"].values(), *(r["launches"] for r in fused.values()),
            gem["main_path_launches"], front["launches"], swa["launches"], mamba["launches"],
            quant["launches"], *l3["runs"]]
    launches = {name: sum(r.get(name, 0) for r in runs) for name in cases}
    log(f"  launches on the main path (phases 4-10, 13-18): {launches}; of them folded "
        f"(int8 folds): {({k: sum(r.get(k, 0) for r in runs) for k in FOLDED})}")
    kernels = []
    for name, cs in cases.items():
        src, rep = REPLACES[name]
        head = cs[0]
        if launches[name] == 0:
            raise SystemExit(f"FAIL: kernel {name} was never launched on the main path")
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": launches[name],
            "max_abs_err": head["max_abs_err"], "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"], "case": head["case"], "cases": cs})
    # the quantizers: launches of phase 17's requantize and ppl_delta runs;
    # the headline cases are QUANT_HEAD's
    for name, cs in quant["cases"].items():
        src, rep = REPLACES[name]
        n = quant["launches"].get(name, 0)
        if n == 0:
            raise SystemExit(f"FAIL: kernel {name} was never launched on the main path")
        head = [c for c in cs if c["tensor"] == QUANT_HEAD[name]][0]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep, "launches": n,
            "max_abs_err": head["max_abs_err"], "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"], "case": head["case"], "cases": cs})
    # the lab's kernels: launches on phase 11's entry point (run_ladder);
    # the headline case is TinyLlama's gate/up at the first tile, rung full
    for name, cs in lab["cases"].items():
        src, rep = REPLACES[name]
        if lab["launches"][name] == 0:
            raise SystemExit(f"FAIL: kernel {name} was never launched by run_ladder")
        head = [c for c in cs if c["tensor"] == "tiny gu" and c["mode"] == "full"][0]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": lab["launches"][name],
            "max_abs_err": head["max_abs_err"], "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"], "case": head["case"], "cases": cs})
    # the prefill lab's kernels: launches on phase 12's entry point
    # (run_sweep); the headline case is the pp512 layer at tq 128 (ts 128)
    for name, cs in plab["cases"].items():
        src, rep = REPLACES[name]
        if plab["launches"][name] == 0:
            raise SystemExit(f"FAIL: kernel {name} was never launched by run_sweep")
        head = [c for c in cs if c["shape"] == "tiny-pp512" and c["tq"] == 128
                and c["ts"] in (None, 128)][0]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": plab["launches"][name],
            "max_abs_err": head["max_abs_err"], "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"], "case": head["case"], "cases": cs})
    log(f"  total {time.perf_counter() - t_start:.1f} s")
    log(gpu_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""Smoke run of the PyTorch/CUDA port (``conch_tpu_torch``) on one H100.

    python3 chip_smoke.py

1. prints the card's ``nvidia-smi`` name and power limit;
2. builds the kernels from ``conch_tpu_torch/csrc`` (one ``nvcc`` per
   source, all at once, then one link);
3. kernel phases: holds each hand-written kernel against its plain
   PyTorch version on the card, at the main paths' shapes, and times it
   (device time with the stream pre-filled, and paced by the host) beside
   its plain version, its bound and, where one exists, one PyTorch call
   computing the same function:
   - K1 int4 magic GEMM at the engine's four (K, N) at M 8, 32 (the
     engine's decode step, padded to max_batch_size 32) and 512, read from
     layer 17 of a 32-layer stack, at group 128 and group 64 (tolerance
     1e-2 x max |ref|, bit for bit across two calls);
   - K1b int8 planar GEMM and K8 int8 scaled GEMM at the int8 / w8a8
     engine's four fused (K, N) and lm_head (4096 x 128256), K1c NF4
     codebook GEMM at the nf4 engine's unfused shapes and lm_head, each at
     M 8, 32 and 512 from layer 17 of a 32-layer stack, with random codes
     over the full range (K8: row scales 10x apart end to end), tolerance
     1e-2 x max |ref|, K1b and K1c also bit for bit across two calls; plus
     small cases of the options the served path does not use (K1b 4-bit
     with per-group and scalar zero-points, K1c 8-bit rows with
     zero-points and the FP4 codebook, K8 float8_e4m3fn); each GEMM row
     keeps one layer's sums at each M (``by_m``: 4 GEMMs for K1, K1b and
     K8, 7 for K1c);
   - K1b and K1c over every option they take (``check_quant_gemm_options``,
     3240 small cases, 1080 of K1b and 2160 of K1c: 2-, 4- and 8-bit codes
     and the NF4 codebook, K1c at groups 12, 64, 100, 128 and 256, K1b at
     every planar slice (int8 at groups 32, 64, 96, 128 and 256, 4-bit at
     64, 128 and 256, 2-bit at 128 and 256), bf16 and f32 scales,
     zero-point modes 0, 1 and 2, M 8, 40
     and 130 with K split, x contiguous, with padded rows or realigned, f32
     and bf16 outputs), tolerance 1e-2 x max |ref|; K1 over every option it
     takes (``check_magic_gemm_options``, 864 cases: groups 32, 64 and 128,
     K 416 at group 32 (a last slice half past K), biases 8, 0 and 15, stacked
     and single weights, M 1 to 600, x three ways, f32 and bf16 outputs;
     1e-2 x max |ref|, every case bit for bit across two calls);
   - K3 over every option it takes (``check_paged_attention_options``, 1344
     cases: bf16 and f32 queries over bf16, f32, int8 and e4m3 caches, GQA
     groups 1, 4, 7 and 8, heads 34 to 256, softcap, windows 0, 37 and 500, one
     split and several, idle rows exactly zero, shared prefix pages, pages no
     row may see set to NaN; 3e-2, or 3e-2 + 3e-2 x |ref| on 1-byte caches;
     every case bit for bit across two calls), then one K3 call captured in
     a CUDA graph and replayed (equal to the eager call, also after
     seq_lens changed in place), then 288 rolling-KV cases
     (``check_paged_ring_options``: bf16 queries over bf16, int8 and e4m3
     caches and f32 over f32, groups 1, 4, 7 and 8, heads 64 to 256,
     windows 37, 500 and 2000 over rings of 5, 34 and 127 pages that the
     sequences wrap up to 62 times, softcap on and off, one split and
     several, the table's entries past the ring poisoned);
   - K7 over every option it takes (``check_varlen_attention_options``,
     1344 cases: K3's (query, cache) dtypes, groups and heads, causal and
     not, softcap, windows 0, 37 and 500, a ragged step with a decode row,
     a zero-length sequence and padding rows, shared prefix pages, pages no
     row may see set to NaN, several splits and one; 2e-2 + 2e-2 x |ref|,
     padding rows exactly zero, every case bit for bit across two calls),
     then one K7 call replayed from a CUDA graph (also after cu_seqlens_q
     and seq_lens changed in place), then 576 rolling-KV cases
     (``check_varlen_ring_options``: K3's ring types, groups, heads and
     windows on the ragged step, causal and not, rings of the window plus
     the step's largest chunk);
   - K3 and K7 over a ring at Mistral-7B's shapes (``kernel_phase_ring``:
     the decode step of 8 at 4100 to 7064 tokens and a 512-row chunk,
     window 4096, the rolling engine's ring of 289 pages), bit for bit
     against the same band through a linear table and timed beside it in
     turns; K3 and K7 at Qwen2-7B's GQA group of 7 (``kernel_phase_group7``:
     the served decode step and the 512-row prefill step); K1 at Qwen2-7B's
     int4 shapes (``kernel_phase_k1_qwen2``: K 3584 and 18944, M 8, 32 and
     512, beside bf16 ``torch.matmul``); K8 over e4m3 (the mainloop's fp8
     ``wgmma`` layout) at the w8a8 shapes, M 16, 32 and 512, read from a
     32-layer stack, beside ``torch._scaled_mm`` (``kernel_phase_k8_e4m3``),
     and K7 under f32 queries (``kernel_phase_k7_f32``);
   - K8 over every option it takes (``check_scaled_gemm_options``, 522
     int8 and 525 e4m3 cases: M 1 to 600, K 96 / N 160 and the served
     shapes, f32 and bf16 outputs, scalar and vector scales, stacked and
     single weights, strided a; int8 values near 127 whose split sums pass
     2^24, each equal to the plain version bit for bit; e4m3 within 1e-2 x
     max |ref|, all-positive values at K 14336 within 1e-3 x |ref| per
     output, and one case of each shape that keeps the loop kernel);
   - K11 over every option it takes (``check_mla_attention_options``, 1440
     cases: bf16 queries over bf16, int8 and e4m3 latent caches, f32
     queries over f32, int8 and e4m3 ones, 1, 3, 16 and 128 heads, latent
     128 to 512 and packed 128 to 896, causal or not, ragged decode and
     prefill steps at stage and split edges with idle and zero-length
     sequences, shared pages, padding rows after a real last sequence,
     ``max_seqlen_q`` above the real maximum, one split to eight), within
     K11's tolerances, every case twice, bit for bit; K12q over every
     option it takes (``check_quantize4_options``, 504 cases: blocksizes 2
     to 4096, f32 / bf16 / f16, nf4 and fp4, ragged tails, all-zero
     blocks, every threshold exactly, starts 16-, 8- and 4-byte aligned),
     byte for byte;
   - K12q NF4/FP4 encode on every weight the nf4 init quantizes (with an
     all-zero block), and on the gate projection at blocksize 4096 and
     from f16, byte for byte; K12d NF4/FP4 decode of the gate projection
     at blocksize 64 and 4096 into bf16, f32 and f16, bit for bit;
   - K2 cache write, K3 paged decode attention, K5 RoPE (timed at 8, 32 and
     512 Llama tokens, 8, 16 and 512 Gemma ones), K7 varlen prefill
     attention at Llama-3-8B's shapes (QH 32 / KH 8 / D 128, page 16, a
     32-layer pool read at a non-zero layer, decode batch 8 with an idle
     seq_len-0 row, a 128-row prefill of mixed lengths with a zero-length
     padding sequence and padding rows, pages shared between sequences),
     and again at Gemma-2-2B's (QH 8 / KH 4 / D 256, a 26-layer pool; K3
     and K7 with softcap 50 and scale 1/16, with and without the 4096
     window, at lengths past it, queries scaled so the logits reach the cap);
     K3 also at the decode steps the engines serve (``K3_SERVED_LLAMA``: 32
     rows, 8 live at 40 to 932; ``K3_SERVED_GEMMA``: 16 rows, 8 live at 4200
     to 6000, without and with the window; 1e-2 x (|ref| + the head's
     rms)), in its row's ``served``; every K3 case is built by
     ``k3_inputs`` from ``K3_CASES``;
   - K4 rms_norm at 8 and 512 rows x 4096 (and f32, f16 at 512), K4b
     fused_add_rms_norm in bf16 at 8 and 2048 rows x 4096 and in f32 and
     f16 at 2048 (the sum bit for bit, the output at
     tests/rms_norm_test.py's tolerances), K6 silu_and_mul at 8, 32 (the
     quantized engines' padded step) and 512 rows x 2 * 14336, fused halves
     and row-strided parts, f32, f16 and bf16 at tests/activation_test.py's
     tolerances (bf16 timed at each step, f32 and f16 at 8 rows);
   - K10a gemma_rms_norm at 8, 16 (Gemma-2-2B's decode step) and 512 rows x
     2304 in f32, f16 and bf16, timed beside ``F.rms_norm`` with the weight
     1 + w; K10b gelu_tanh_and_mul as K6, at 8, 16 (Gemma-2-2B's decode
     step) and 512 rows x 2 * 9216;
   - K5, K10a, K2, K4, K6 and K10b after their served predecessors
     (``row_kernel_pairs``: K5 after Llama-3-8B's fused wqkv through K1 at
     32 rows and through ``torch.matmul`` at 8, K10a after Gemma-2-2B's
     ``o_proj`` matmul at 16 and 512 rows, K2 after K5, K4 after the
     residual add, K6 after K1's fused gate|up at 32 rows, K10b after
     Gemma-2-2B's gate|up matmul at 16): the pair's device time minus the
     predecessor's, with and without the programmatic-dependent launch;
   - K6 and K10b over every option they take (``check_gated_act_options``,
     1680 cases, each with and without the programmatic-dependent launch:
     f32, bf16 and f16, d 14336, 9216, 10944, 2816, 128, 4096, 531 and
     18944, 0
     to 512 rows, fused halves, row-strided and contiguous parts, a base or
     rows that break 16-byte alignment) at tests/activation_test.py's
     tolerances and bit for bit against the kernel's own rounding of its
     f32 activation;
   - K5 over every option it takes (``check_rope_options``, 2880 cases: f32,
     bf16 and f16, heads (32, 8, 128), (8, 4, 256), (4, 1, 128), (8, 8,
     64) and (28, 4, 128), whole, half and D - 28 rot_dims, 0 to 512 tokens, contiguous q/k,
     slices of a fused qkv block, rows or a base that break 16-byte
     alignment, positions past the cache, each with and without the
     programmatic-dependent launch) and K10a over every option it takes
     (``check_gemma_rms_norm_options``, 672 cases: f32, bf16 and f16, rows 0
     to 4096, hidden 128 to 4608 and 36872 (the looped path), strided and
     misaligned rows), at the JAX tests' tolerances;
   - K11 absorbed MLA at DeepSeek-V2-Lite's shapes (16 heads, packed
     640, latent 512, page 16, a 27-layer latent pool read at layer 13):
     a decode step of batch 8 at lengths 0 (an idle row) to 4000 and a
     512-row prefill step (chunked continuations, shared pages, padding
     sequences and rows), f32 at 2e-4 and bf16 at 3e-2 (+ the same x
     |ref|);
   - K9 static-scale int8 / e4m3 quantization through its public ops
     (``scaled_int8_quant``, ``scaled_fp8_quant``) at 8 and 512 rows x
     4096 and at 7 x 4097, from f32, bf16 and f16, byte for byte;
   - K3 and K7 with dequantization scales over an f32 cache (2e-3);
   - the int8 and e4m3 KV-cache branches: K2's quantizing store (byte for
     byte) and K3 / K7 at Llama's and Gemma's shapes (softcap, window),
     with k_scale != v_scale, and K11 over quantized latent caches, decode
     and prefill, bf16 queries, at 3e-2 (+ 3e-2 x |ref|; K7 2e-2);
   - K13a BEV pool forward and K13b backward at BEVFusion's nuScenes
     camera-to-BEV size (6 cameras, 118 depth bins x 32 x 88, a 360 x 360
     grid, 80 channels; 1.63 M of 1.99 M frustum points kept, sorted into
     intervals by cell) in f32 and bf16, and on small cases (shared cells,
     cells outside the grid, f16, C 5 and 6): K13a f32 at 1e-5 (+ 1e-5 x
     |ref|), bf16 / f16 at one rounding step x |ref|, K13b bit for bit;
     K13c NMS keep mask at 4096 boxes, IoU 0.5, tied scores, and at N 1,
     513, identical boxes and a lattice of touching boxes, bit for bit;
     then ``check_nms_options`` (K13c at N 1 to 20000 and IoU 0.3,
     0.5, 0.7, the lattice, identical boxes across words, and 40000 boxes,
     whose bands stream through shared memory in chunks; the keep buffer
     filled with 7 first) and ``check_bev_backward_options`` (K13b in f32,
     bf16 and f16 at vector widths 1 to 8 by channels and by misaligned
     grad bases, on intervals with every trap of its search: zero-length
     intervals sharing a start, negative starts, starts at and past the
     last point, a dropped interval inside a cell's run, gaps; the output
     NaN-filled first) and ``check_bev_forward_options`` (K13a in f32,
     bf16 and f16 at vector widths 1 to 8 by channels and by feature bases
     one element off, through TMA stages and from global memory, on
     intervals with every trap of its ownership (``bev_forward_trap_case``:
     runs across tile edges, a dropped interval inside a run, zero-length
     intervals, an interval over several tiles, the grid's first and last
     cells, starts at and past the last point), no kept interval, one
     interval of 100,000 points and BEVFusion's inputs; the output
     NaN-filled first), each bit for bit against the plain versions;
   - K14 ring all-gather on rings of 1, 2, 4 and 8 virtual ranks on the
     card (every rank's buffers its own), both launch modes (one
     cooperative launch; one launch per rank on its own stream), f32, bf16
     and int8, the TP-8 shard (64 x 4096) and a 1 x 4097 one, automatic
     and single blocks per rank; 100 back-to-back calls on one flag
     buffer; per-rank launches with ``torch.cuda._sleep`` ahead of some
     ranks; a deliberate 1 ms timeout that must set the error word; every
     result bit for bit against the plain version, the error word read
     after each phase; timed at 8 ranks x 64 x 4096 and 2048 x 4096 bf16;
   - K1, K1b and K1c storing f32 from bf16 activations
     (``mixed_precision_gemm(..., output_dtype=torch.float32)``) at K = N
     = 4096, M 8 and 512, at 1e-2 x max |ref|, timed beside the bf16
     store; a float16 output must raise, and a bfloat16 ``acc_dtype``
     (recorded only, as in JAX) must equal the f32 call bit for bit;
4. vision: ``generate_voxels`` and ``voxelization_stable`` with
   ``collect_point_features`` at PointPillars' KITTI size (120,000 points,
   3% on voxel boundaries) on the card, every output equal to the CPU's;
   then the vision path (``vision_bevfusion``): voxelize, BEV pool forward
   and ``loss.backward()`` at BEVFusion's size, NMS over 4096 boxes,
   through ``conch_tpu_torch.ops.vision``, with K13a, K13b and K13c's
   launches read around it (the pooled grid and the gradient bit for bit
   against the plain versions);
   the top-p filter (``check_top_p_filter``) at the int4 engine's 32 x
   128256 and Gemma-2-2B's 16 x 256000 logits, held to the exact kept set
   at top_p 1.0, 0.999, 0.9 and 0.5, and ``sample_tokens`` timed beside
   the parent's f32 top-p pass;
   the QLoRA storage path (``llama3_8b_qlora``): every projection of
   Llama-3-8B's 32 layers and its lm_head (bf16 random weights, one layer
   at a time) through ``quantize_4bit(nf4, 64, compress_statistics=True)``
   and ``dequantize_4bit``, 225 launches each of K12q and K12d, every
   error within NF4's half-gap plus the double quantization's, and a
   profiled repeat of one layer; Llama-3-8B's residual stream through
   ``fused_add_rms_norm`` (``llama3_8b_residual_stream``: 64 calls at 2048
   x 4096 bf16, against the plain op's chain); and the collectives layer
   at Llama-3-8B's TP-8 shapes on 8 virtual ranks
   (``llama3_8b_tp8_collectives``: ``ring_all_gather`` of a 512-row and a
   16384-row chunk, K14 launched twice; ``overlapped_allgather_matmul``
   and ``overlapped_matmul_reduce_scatter`` in f32 and bf16 against the
   unsharded product, then timed);
5. slice phases: the first-token logits of 2-layer full-width prefills on
   the card against the plain path on the CPU (Llama-3-8B: bf16 weights in
   f32 and bf16, int4 at group 128 and 64, int8, nf4 and w8a8 weights in
   bf16; Qwen2-7B and Mistral-7B (window cut to 16): bf16 weights in f32,
   int4 in bf16; Gemma-2-2B: f32 and bf16, random norm weights, int4,
   int8, nf4 and w8a8 in bf16; DeepSeek-V2-Lite, one dense and one MoE
   layer: f32 and bf16, int4 and int8 at group 32, nf4 and w8a8 in bf16,
   random norm weights, and the MoE routing compared
   token by token, a divergence accepted only at a near tie; Mixtral-8x7B
   (``check_mixtral_logits``): f32 and bf16, int4 attention projections in
   bf16, bf16 over an int8 KV cache, random norm weights, 11 padding rows
   and capacity factor 0.5 (selections drop), the experts of every row
   equal to the CPU's in f32 and but at a near tie in bf16; each family
   also in bf16 over an int8 and an e4m3 KV cache); ``llama_params_from_hf``
   and ``mixtral_params_from_hf`` with ``device="cuda"`` against the CPU's
   params, bit for bit (``check_hf_converters``); then
   ``LLMEngine`` at full width (random
   weights from a seed) serving greedy requests of 32 tokens, with every
   kernel's launch count and the model steps read around the run, and the
   same requests repeated under torch.profiler (device time by kernel
   group, idle share):
   - Llama-3-8B bf16: 4 requests, ``EngineConfig(num_pages=2048,
     max_batch_size=8, max_prefill_tokens=128)``;
   - Llama-3-8B int4, the README's example: 16 requests of 40 to 900
     tokens, ``EngineConfig(num_pages=4096, max_batch_size=32)`` (512-row
     prefill steps);
   - the same int4 engine with the projections at group 64 (K1's group-64
     template): 8 requests of 40 to 900 tokens;
   - Llama-3-8B int8 (K1b), nf4 (K1c; K12q during the init) and w8a8 (K8),
     32 layers, every projection and lm_head in the mode: 8 requests of 40
     to 900 tokens each, ``EngineConfig(num_pages=4096, max_batch_size=32)``;
   - Gemma-2-2B bf16 (26 layers): 8 requests of 40
     to 4600 tokens, ``EngineConfig(num_pages=4096, max_batch_size=16,
     max_pages_per_seq=320)``, through ``gemma_prefill`` and
     ``gemma_decode_step``;
   - DeepSeek-V2-Lite bf16 (27 layers): 8 requests of 40 to 1800 tokens,
     ``EngineConfig(num_pages=4096, max_batch_size=16,
     max_pages_per_seq=128)``, through ``deepseek_prefill`` and
     ``deepseek_decode_step``;
   - over quantized KV caches (``LLMEngine(..., cache_dtype=...)``), each
     its twin above with only the cache changed: the int4 example over an
     int8 cache, bf16 Llama over an e4m3 cache, DeepSeek-V2-Lite over an
     e4m3 latent cache;
   - Mistral-7B-v0.1 in int4 (its published config, window 4096 on every
     layer) with rolling KV (``mistral_7b_int4_rolling``: page 16, 512-row
     prefill steps, a ring of 289 pages, 8 requests of 40 to 7000 tokens,
     64 new tokens each), then its unbounded twin (the same window, every
     page kept): equal greedy tokens, at most 289 pages a sequence, every
     K3 and K7 launch of the rolling run over the ring
     (``check_rolling_twins``);
   - Qwen2-7B in int4 (``qwen2_7b_int4``: q/k/v biases, GQA group 7, 28
     layers): 8 requests of 40 to 2000 tokens,
     ``EngineConfig(num_pages=4096, max_batch_size=32,
     max_pages_per_seq=160)``;
   - Mixtral-8x7B in bf16 (``mixtral_8x7b_bf16``) at every published
     width, its depth cut to 24 of 32 layers (``MIXTRAL_LAYERS``: 70.2 GB
     of weights), through ``mixtral_prefill`` and ``mixtral_decode_step``:
     8 requests of 40 to 2000 tokens, 16 new tokens each,
     ``EngineConfig(num_pages=1024, max_batch_size=8,
     max_pages_per_seq=128)``, TF32 off; no K1 and no K6 a step (the
     experts' SwiGLU is plain PyTorch); timed three times, then profiled
     with ``moe_ffn``, ``moe_experts`` and the engine's steps in
     ``record_function`` ranges (``report_mixtral_profile``: their device
     time, a decode step's beside the time to read its weights once);
   then the speculative, parallel-sampling and multi-LoRA paths
   (``slice_paths``): every row's logits of a 2-layer, full-width verify
   step (8 x 5 rows after 200 to 1000 cached tokens, 24 padding rows) on
   the card against the CPU for Llama-3-8B (bf16 in f32 and bf16, int4),
   Gemma-2-2B, DeepSeek-V2-Lite and Mixtral-8x7B (f32 and bf16; the CPU
   takes the card's expert choices), every row finite
   (``check_verify_logits``); the greedy-exact contract at full width
   (``check_spec_echo``: one verify step over the plain int4 engine's 16
   tokens a request gives its next tokens, but at a near tie);
   ``llama3_8b_int4_spec`` (8 motif prompts of about 1024 tokens, 128 new,
   4 drafted a step, three runs beside the plain engine: tok/s, drafted,
   accepted, profiled busy ms, idle share and K7 inside the verify
   steps; the tokens equal up to a divergence at a near tie);
   ``check_parallel_sampling`` (int4, n 4 with temperature, top-p,
   logprobs, repetition penalty and logit bias: refcounts and tail pages
   right after each spawn over bf16 and int8 pools, replay, greedy copies,
   abort); ``check_lora`` (4 adapters of rank 16: a 2-layer multi-LoRA
   prefill against each merged model and the CPU, then the int4 engine
   with and without ``lora``, three runs, the id -1 requests giving the
   base engine's tokens); ``check_guided`` (``llama3_8b_int4_guided``: a
   seeded 128256-string vocabulary, a 4-field JSON-schema FSM and a regex
   FSM built on the host, 8 requests in one batch: JSON at temperature
   0.8, the regex and unguided rows at greedy; every guided output fully
   matches, the JSON parses to the schema, the unguided rows equal the
   same prompts served alone up to a near tie; the masks' host ms a
   step); ``check_beam`` (``llama3_8b_int4_beam``: prompts of 1000, 1023,
   1024 and 1025 tokens, 4 beams, 32 tokens, penalties 1.0 and 0.0, under
   the Python and the native allocator, identical; every page back after
   each search; each hypothesis's cumulative logprob against a
   teacher-forced verify forward; K3 inside the beam steps; beam tok/s);
   ``check_server`` (``llama3_8b_int4_server``: ``make_server`` on
   127.0.0.1 port 0, 16 greedy requests of 40 to 900 tokens, 2 streamed,
   one n 4 at temperature 0.8, one by a LoRA adapter's name, all at once;
   against direct ``generate`` up to a near tie; the worker alive and
   every page free; requests/s, p50 and p99 latency, tok/s over HTTP
   beside direct ``generate``); DeepSeek-V2-Lite served with speculation
   (``deepseek_v2_lite_spec``: K11 at the verify step on a served path);
6. prints the ``kernels`` JSON line (each row's launches from its main
   run: Gemma for the kernels it runs, int4 for K1, K4 and K6, int8, nf4
   and w8a8 for K1b, K1c and K8, the nf4 init for K12q, DeepSeek for K11,
   K9's own phase for K9 (no served path runs it; nor K8's e4m3 and K7's
   f32 rows, whose launches are their phases': K8's e4m3 launches on the
   mainloop's fp8 layout), Mistral-7B's rolling run
   for K3's and K7's ring rows (their launches over the ring), Qwen2-7B
   for their group-7 rows and K1's Qwen2 row, the vision path for
   K13a, K13b and K13c, the QLoRA path for K12d, the residual stream for
   K4b, the TP-8 collectives path for K14; every path's counts
   beside them; K7 V and K11 V, their rows at the verify step
   (``kernel_phases_verify``), the launches inside the verify steps of
   ``llama3_8b_int4_spec`` and ``deepseek_v2_lite_spec``; K3 beam, its row
   at a beam step (``kernel_phase_k3_beam``), K3's launches inside the
   beam steps of ``llama3_8b_int4_beam``), the card
   line, then ``{"ok": true, "device": ...}`` as the
   last line.

Any failed check raises, so the script exits non-zero and prints no
result line. Without a CUDA device it exits non-zero at once.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import itertools
import json
import math
import re
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
BF16_OPS_PER_S = 989e12  # dense bf16 tensor-core peak
INT8_OPS_PER_S = 1979e12  # dense int8 tensor-core peak
F32_OPS_PER_S = 67e12  # f32 outside the tensor cores
SEED = 0
NUM_LAYERS_POOL = 32
LAYER = 17  # a non-zero layer inside the 32-layer pool
QH, KH, D, PS = 32, 8, 128, 16
MAX_PAGES_PER_SEQ = 64


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


SM_CYCLES_PER_S = 2.0e9  # above the H100's top SM clock, so a sleep of n cycles lasts at least n / 2e9 s


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device milliseconds per call, from CUDA events around ``iters``
    calls. A sleep kernel first holds the stream for twice the host time
    of the calls, so all of them are queued before the first one runs:
    the events time the device's work back to back, not the host's
    launch cost (``paced_ms`` times that)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2 * iters * host_s * SM_CYCLES_PER_S))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def paced_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call as a caller sees it when the device waits
    on the host: CUDA events around ``iters`` calls issued one after the
    other from Python (wrapper, checks and launch included)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(bytes_moved: float, ops: float, ops_per_s: float = BF16_OPS_PER_S) -> tuple[float, str]:
    """Least time on the card: the larger of bytes / HBM rate and ops / the
    peak rate of their type (bf16 tensor cores unless given)."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check(name: str, err: float, tol: float) -> None:
    print(f"{name}: max_abs_err {err:.3e} (tolerance {tol:.1e})", flush=True)
    if not err <= tol:
        msg = f"{name}: max_abs_err {err} exceeds tolerance {tol}"
        raise AssertionError(msg)


def check_close(name: str, out: torch.Tensor, ref: torch.Tensor, tol: float) -> float:
    """Hold ``out`` to ``ref`` elementwise at ``|out - ref| <= tol + tol * |ref|``
    (the JAX tests' assert_allclose with atol = rtol = tol); returns the
    max abs error."""
    diff = (out.float() - ref.float()).abs()
    err = diff.max().item()
    print(f"{name}: max_abs_err {err:.3e} (tolerance {tol:.0e} + {tol:.0e} * |ref|)", flush=True)
    if not bool((diff <= tol + tol * ref.float().abs()).all()):
        msg = f"{name}: outside {tol} + {tol} * |ref| (max_abs_err {err})"
        raise AssertionError(msg)
    return err


def make_pool(
    gen: torch.Generator, num_pages: int, layers: int = NUM_LAYERS_POOL, kh: int = KH, d: int = D
) -> tuple[torch.Tensor, torch.Tensor]:
    shape = (layers, num_pages, kh, PS, d)
    kc = torch.randn(shape, generator=gen, device="cuda", dtype=torch.float32).to(torch.bfloat16)
    vc = torch.randn(shape, generator=gen, device="cuda", dtype=torch.float32).to(torch.bfloat16)
    return kc, vc


def paged_layout(
    rng: np.random.Generator, seq_lens: list[int], num_pages: int, share: tuple[int, int], shared_pages: int,
    max_pages: int = MAX_PAGES_PER_SEQ,
):
    """Block table (B, max_pages) with random distinct pages,
    entries past each sequence's pages left 0 (page 0 is a real page), and
    sequence ``share[1]`` reading the first ``shared_pages`` pages of
    ``share[0]`` (a prefix-cache hit)."""
    perm = iter(rng.permutation(np.arange(1, num_pages)).tolist())
    bt = np.zeros((len(seq_lens), max_pages), np.int32)
    for b, n in enumerate(seq_lens):
        for p in range(-(-n // PS)):
            bt[b, p] = next(perm)
    src, dst = share
    bt[dst, :shared_pages] = bt[src, :shared_pages]
    return bt


def unique_kv_rows(bt: np.ndarray, kv_lens: list[int], starts: list[int] | None = None) -> int:
    """Distinct cached (page, entry) rows that these sequences read: positions
    ``starts[b]`` (default 0) to ``kv_lens[b] - 1`` of each."""
    rows = set()
    for b, n in enumerate(kv_lens):
        start = starts[b] if starts else 0
        rows.update((int(bt[b, pos // PS]), pos % PS) for pos in range(start, n))
    return len(rows)


# Quantized KV caches in the kernel checks, and their (k_scale, v_scale):
# k != v, so a kernel that swapped them would fail. The int8 scales put
# N(0, 1) values over most of the int8 range.
KV_CACHES = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}
KV_SCALES = {"int8": (1 / 32, 1 / 16), "fp8": (1.5, 0.75)}


def quant_pool(gen, num_pages: int, layers: int, kh: int, d: int, cache: str) -> tuple[torch.Tensor, torch.Tensor]:
    """K and V pools of N(0, 1) values through the quantizing store at
    KV_SCALES[cache]; it clips, so no e4m3 NaN code is ever written."""
    from conch_tpu_torch.kernels.cache.reshape_and_cache import quantize_store

    shape = (layers, num_pages, kh, PS, d)
    return tuple(
        quantize_store(torch.randn(shape, generator=gen, device="cuda"), scale, KV_CACHES[cache])
        for scale in KV_SCALES[cache]
    )


def cache_bytes(t: torch.Tensor) -> torch.Tensor:
    """A quantized cache's raw bytes (comparable across e4m3 NaN codes)."""
    return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t


def kv_pools(gen, num_pages: int, layers: int, kh: int, d: int, cache: str | None):
    """bf16 K and V pools (``make_pool``), or int8 / e4m3 ones (``quant_pool``)."""
    return make_pool(gen, num_pages, layers, kh, d) if cache is None else quant_pool(gen, num_pages, layers, kh, d, cache)


def with_kv_scales(fn, cache: str | None):
    """``fn`` as it is for a bf16 pool; for an int8 / e4m3 one, called with
    KV_SCALES[cache] as its k_scale and v_scale."""
    if cache is None:
        return fn
    ks, vs = KV_SCALES[cache]
    return functools.partial(fn, k_scale=ks, v_scale=vs)


def k2_step(gen, rng, qh: int, kh: int, d: int, tokens: int, idle: tuple[int, ...], num_pages: int):
    """A decode step of ``tokens`` rows, k and v slices of a fused bf16 qkv
    block; the ``idle`` rows have slot -1 (an idle row, or the rows the
    engines pad a step with); rows 5 and 6 write one page. Returns k, v,
    the slots (numpy) and their tensor."""
    qkv = torch.randn((tokens, (qh + 2 * kh) * d), generator=gen, device="cuda").to(torch.bfloat16)
    k = qkv[:, qh * d : (qh + kh) * d].view(tokens, kh, d)
    v = qkv[:, (qh + kh) * d :].view(tokens, kh, d)
    pages = rng.permutation(np.arange(num_pages))[:tokens]
    pages[6] = pages[5]
    entries = rng.integers(0, PS, size=tokens)
    entries[:8] = (0, 15, 7, 0, 3, 9, 10, 1)
    slots = (pages * PS + entries).astype(np.int32)
    slots[list(idle)] = -1
    return k, v, slots, torch.from_numpy(slots).cuda()


# K2's timed steps, (tokens, idle rows): the kernel table's decode step of
# 8 with row 3 idle (the row's numbers), and the quantized engines' step
# padded to 32 rows, 8 live.
K2_STEPS = ((8, (3,)), (32, tuple(range(8, 32))))


def kernel_phase_k2(
    gen, rng, qh: int = QH, kh: int = KH, d: int = D, layers: int = NUM_LAYERS_POOL, cache: str | None = None
) -> dict:
    """K2 into a bf16 pool, or with ``cache`` ("int8", "fp8") its quantizing
    store into such a pool at KV_SCALES[cache], held byte for byte, at each
    of K2_STEPS (``detail``), each timed beside its bound, plain version and
    (bf16 pool) the indexed assignment; the row has the 8-token numbers."""
    from conch_tpu_torch.kernels.cache.reshape_and_cache import (
        reshape_and_cache_stacked_launcher as launch_kv,
        reshape_and_cache_stacked_plain as plain_kv,
    )

    num_pages = 256
    kc, vc = kv_pools(gen, num_pages, layers, kh, d, cache)
    launch, plain = with_kv_scales(launch_kv, cache), with_kv_scales(plain_kv, cache)
    err, detail = 0.0, []
    for tokens, idle in K2_STEPS:
        k, v, slots, slot_t = k2_step(gen, rng, qh, kh, d, tokens, idle, num_pages)
        kc_ref, vc_ref = kc.clone(), vc.clone()
        plain(k, v, kc_ref, vc_ref, slot_t, LAYER)
        launch(k, v, kc, vc, slot_t, LAYER)
        torch.cuda.synchronize()
        step = f"KH={kh} D={d} tokens={tokens} live={tokens - len(idle)}"
        if cache is None:
            e = max((kc.float() - kc_ref.float()).abs().max().item(), (vc.float() - vc_ref.float()).abs().max().item())
            check(f"K2 reshape_and_cache_stacked {step}", e, 0.0)
        else:
            e = float(sum(int((cache_bytes(a) != cache_bytes(b)).sum()) for a, b in ((kc, kc_ref), (vc, vc_ref))))
            check(f"K2 reshape_and_cache_stacked {cache} store {step}: bytes differing", e, 0.0)
        err = max(err, e)
        del kc_ref, vc_ref
        valid = torch.from_numpy(np.nonzero(slots >= 0)[0]).cuda()
        vp = torch.from_numpy(slots[slots >= 0] // PS).long().cuda()
        ve = torch.from_numpy(slots[slots >= 0] % PS).long().cuda()
        kv_valid, vv_valid = k[valid], v[valid]

        def library():
            kc[LAYER, vp, :, ve] = kv_valid
            vc[LAYER, vp, :, ve] = vv_valid

        n_valid = int((slots >= 0).sum())
        # K and V rows: read in bf16, written in the cache's element size; the slots.
        b_ms, b_by = bound(2 * n_valid * kh * d * (2 + kc.element_size()) + tokens * 4, 0)
        detail.append({
            "tokens": tokens, "live": n_valid, "max_abs_err": e, "bound_ms": b_ms, "bound_by": b_by,
            "ms": time_ms(lambda: launch(k, v, kc, vc, slot_t, LAYER)),
            "paced_ms": paced_ms(lambda: launch(k, v, kc, vc, slot_t, LAYER)),
            "plain_ms": time_ms(lambda: plain(k, v, kc, vc, slot_t, LAYER)),
            # One indexed assignment writes the bf16 rows; no single PyTorch call quantizes on store.
            "library_ms": time_ms(library) if cache is None else None,
        })
    for x in detail[1:]:
        print(f"K2 {cache or 'bf16'} KH={kh} D={d} tokens={x['tokens']} live={x['live']}: {x['ms']:.4f} ms (paced "
              f"{x['paced_ms']:.4f}, plain {x['plain_ms']:.4f}, library {x['library_ms']}, bound "
              f"{x['bound_ms']:.7f} by {x['bound_by']})", flush=True)
    row = _kernel_row(
        "reshape_and_cache_stacked", "conch_tpu_torch/csrc/reshape_and_cache.cu",
        "conch_tpu/kernels/cache/reshape_and_cache.py:37", err, detail[0], detail[0]["bound_ms"],
        detail[0]["bound_by"],
    )
    row["detail"] = detail
    return row


# K5's timed steps: the kernel table's decode step of 8 tokens (the row's
# numbers), then Llama-3-8B's padded decode step of the quantized engines
# and a 512-row prefill chunk, Gemma-2-2B's decode step and a 512-row chunk.
K5_TOKENS = {"llama": (8, 32, 512), "gemma": (8, 16, 512)}


def k5_bound(tokens: int, qh: int, kh: int, d: int, itemsize: int = 2) -> tuple[float, str]:
    """K5's bound: q and k read and written once, one f32 cache row and a
    position a token; 3 operations an element."""
    return bound(2 * tokens * (qh + kh) * d * itemsize + tokens * d * 4 + tokens * 4, tokens * (qh + kh) * d * 3)


def kernel_phase_k5(gen, rng, qh: int = QH, kh: int = KH, d: int = D, theta: float = 500000.0,
                    timed_tokens: tuple[int, ...] = K5_TOKENS["llama"]) -> dict:
    """K5 on slices of a fused bf16 qkv row block at ``timed_tokens`` and a
    128-row chunk (2e-2), each step timed beside its bound and plain
    version (``detail``); the row has the first step's numbers."""
    from conch_tpu_torch.kernels.embedding.rotary_embedding import (
        rotary_embedding_launcher as launch,
        rotary_embedding_plain as plain,
    )
    from conch_tpu_torch.reference.embedding.rotary_embedding import compute_cos_sin_cache

    cache = compute_cos_sin_cache(theta, d, 8192, device="cuda")
    err, detail = 0.0, []
    for tokens in (*timed_tokens, 128):
        qkv = torch.randn((tokens, (qh + 2 * kh) * d), generator=gen, device="cuda").to(torch.bfloat16)
        q, k = qkv[:, : qh * d], qkv[:, qh * d : (qh + kh) * d]
        pos = torch.from_numpy(rng.integers(0, 8192, size=tokens).astype(np.int32)).cuda()
        q_k, k_k = launch(pos, q, k, d, cache)
        q_p, k_p = plain(pos, q, k, d, cache)
        torch.cuda.synchronize()
        e = max((q_k.float() - q_p.float()).abs().max().item(), (k_k.float() - k_p.float()).abs().max().item())
        err = max(err, e)
        if tokens in timed_tokens:
            b_ms, b_by = k5_bound(tokens, qh, kh, d)
            detail.append({
                "tokens": tokens, "max_abs_err": e, "bound_ms": b_ms, "bound_by": b_by,
                "ms": time_ms(lambda: launch(pos, q, k, d, cache)),
                "paced_ms": paced_ms(lambda: launch(pos, q, k, d, cache)),
                "plain_ms": time_ms(lambda: plain(pos, q, k, d, cache)), "library_ms": None,
            })
    check(f"K5 rotary_embedding QH={qh} KH={kh} D={d}", err, 2e-2)
    for x in detail:
        print(f"K5 QH={qh} KH={kh} D={d} tokens={x['tokens']}: {x['ms']:.4f} ms (paced {x['paced_ms']:.4f}, plain "
              f"{x['plain_ms']:.4f}, bound {x['bound_ms']:.6f} by {x['bound_by']})", flush=True)
    row = _kernel_row(
        "rotary_embedding", "conch_tpu_torch/csrc/rotary_embedding.cu",
        "conch_tpu/kernels/embedding/rotary_embedding.py:34", err, detail[0], detail[0]["bound_ms"],
        detail[0]["bound_by"],
    )
    row["detail"] = detail
    return row


PAIR_ITERS = 200


def pair_timings(name: str, pred, kernel, launcher) -> dict:
    """``kernel`` after its served predecessor ``pred``: the device time of
    the pair (``kernel(pred())``) minus ``pred()``'s alone, each from one
    ``time_ms`` call of PAIR_ITERS launches, with and without the kernel's
    programmatic-dependent launch (``launcher.pdl``), and the kernel alone
    back to back both ways (there it overlaps its own previous launch)."""
    saved = launcher.pdl
    out = pred()
    res = {"case": name}
    try:
        for pdl in (False, True, False, True):
            launcher.pdl = pdl
            tag = "pdl" if pdl else "no_pdl"
            pred_ms = time_ms(pred, iters=PAIR_ITERS)
            pair_ms = time_ms(lambda: kernel(pred()), iters=PAIR_ITERS)
            alone_ms = time_ms(lambda: kernel(out), iters=PAIR_ITERS)
            for key, value in (("pred_ms", pred_ms), ("pair_ms", pair_ms), ("after_pred_ms", pair_ms - pred_ms),
                               ("alone_ms", alone_ms)):
                res.setdefault(f"{tag}_{key}", []).append(value)
    finally:
        launcher.pdl = saved
    print(f"{name}: after the predecessor (pair - predecessor) without PDL "
          f"{', '.join(f'{v:.4f}' for v in res['no_pdl_after_pred_ms'])} ms, with PDL "
          f"{', '.join(f'{v:.4f}' for v in res['pdl_after_pred_ms'])}; predecessor "
          f"{res['no_pdl_pred_ms'][0]:.4f}; alone without / with PDL "
          f"{res['no_pdl_alone_ms'][0]:.4f} / {res['pdl_alone_ms'][0]:.4f} ms", flush=True)
    return res


def row_kernel_pairs(gen, rng, by_name: dict) -> None:
    """K5, K10a, K2, K4, K6 and K10b after their served predecessors
    (``pair_timings``): K5 after Llama-3-8B's fused wqkv through K1 (int4,
    group 128, the engine's 32-row decode step) and through ``torch.matmul``
    (bf16, 8 rows); K10a after Gemma-2-2B's bf16 ``o_proj`` ``torch.matmul``
    at 16 and 512 rows; K2 after K5 at Llama-3-8B's decode step of 8 tokens
    and the padded 32 (8 live); K4 after the residual add at 8 and 32 rows
    of 4096; K6 after K1's fused gate|up at the 32-row step; K10b after
    Gemma-2-2B's bf16 gate|up ``torch.matmul`` at 16 rows. The results go
    into the rows' ``after_predecessor``."""
    from conch_tpu_torch.kernels.activation.gelu_tanh_and_mul import gelu_tanh_and_mul_launcher as k10b
    from conch_tpu_torch.kernels.activation.silu_and_mul import silu_and_mul_launcher as k6
    from conch_tpu_torch.kernels.cache.reshape_and_cache import reshape_and_cache_stacked_launcher as k2
    from conch_tpu_torch.kernels.embedding.rotary_embedding import rotary_embedding_launcher as rope
    from conch_tpu_torch.kernels.normalization.gemma_rms_norm import gemma_rms_norm_launcher as norm
    from conch_tpu_torch.kernels.normalization.rms_norm import rms_norm_launcher as k4
    from conch_tpu_torch.kernels.quantization.gemm import mixed_gemm_magic_launcher as k1
    from conch_tpu_torch.reference.embedding.rotary_embedding import compute_cos_sin_cache

    k, n = K1_SHAPES[0]
    cache = compute_cos_sin_cache(500000.0, D, 8192, device="cuda")
    packed = torch.randint(-(2**31), 2**31 - 1, (1, k // 8, n), generator=gen, device="cuda", dtype=torch.int32)
    scales = (torch.rand((1, k // GROUP, n), generator=gen, device="cuda") * 4e-3 + 1e-4).to(torch.bfloat16)
    w_qkv = (0.02 * torch.randn((k, n), generator=gen, device="cuda")).to(torch.bfloat16)

    def rope_after(out, pos):
        return rope(pos, out[:, : QH * D], out[:, QH * D : (QH + KH) * D], D, cache)

    rope_pairs = []
    for m, label in ((32, "K1 int4 wqkv, 32 rows"), (8, "torch.matmul bf16 wqkv, 8 rows")):
        x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
        pos = torch.from_numpy(rng.integers(0, 8192, size=m).astype(np.int32)).cuda()
        pred = (lambda x=x: k1(x, packed, scales, GROUP, 8, 0)) if m == 32 else (lambda x=x: torch.matmul(x, w_qkv))
        rope_pairs.append(pair_timings(f"K5 after {label}", pred, lambda out, pos=pos: rope_after(out, pos), rope))
    by_name["rotary_embedding"]["after_predecessor"] = rope_pairs
    w_o = (0.02 * torch.randn((2048, G_HIDDEN), generator=gen, device="cuda")).to(torch.bfloat16)
    w = (0.5 * torch.randn((G_HIDDEN,), generator=gen, device="cuda")).to(torch.bfloat16)
    norm_pairs = []
    for m in (16, 512):
        x = torch.randn((m, 2048), generator=gen, device="cuda").to(torch.bfloat16)
        norm_pairs.append(pair_timings(f"K10a after torch.matmul bf16 o_proj, {m} rows",
                                       lambda x=x: torch.matmul(x, w_o), lambda out: norm(out, w, 1e-6), norm))
    by_name["gemma_rms_norm"]["after_predecessor"] = norm_pairs
    kc, vc = make_pool(gen, 256)
    k2_pairs = []
    for tokens, idle in K2_STEPS:
        k, v, _, slot_t = k2_step(gen, rng, QH, KH, D, tokens, idle, 256)
        q = torch.randn((tokens, QH * D), generator=gen, device="cuda").to(torch.bfloat16)
        pos = torch.from_numpy(rng.integers(0, 8192, size=tokens).astype(np.int32)).cuda()
        k_rows = k.reshape(tokens, KH * D)
        k2_pairs.append(pair_timings(
            f"K2 after K5, {tokens} tokens ({tokens - len(idle)} live)",
            lambda q=q, k_rows=k_rows, pos=pos: rope(pos, q, k_rows, D, cache),
            lambda out, v=v, slot_t=slot_t, tokens=tokens: k2(out[1].view(tokens, KH, D), v, kc, vc, slot_t, LAYER),
            k2))
    by_name["reshape_and_cache_stacked"]["after_predecessor"] = k2_pairs
    w4 = (1.0 + 0.1 * torch.randn((HIDDEN,), generator=gen, device="cuda")).to(torch.bfloat16)
    k4_pairs = []
    for m in (8, 32):
        h, r = (torch.randn((m, HIDDEN), generator=gen, device="cuda").to(torch.bfloat16) for _ in range(2))
        k4_pairs.append(pair_timings(f"K4 after the residual add, {m} rows", lambda h=h, r=r: h + r,
                                     lambda out: k4(out, w4, 1e-5), k4))
    by_name["rms_norm"]["after_predecessor"] = k4_pairs
    k, n = K1_SHAPES[2]  # the fused gate|up projection
    packed_gu = torch.randint(-(2**31), 2**31 - 1, (1, k // 8, n), generator=gen, device="cuda", dtype=torch.int32)
    scales_gu = (torch.rand((1, k // GROUP, n), generator=gen, device="cuda") * 4e-3 + 1e-4).to(torch.bfloat16)
    x = torch.randn((32, k), generator=gen, device="cuda").to(torch.bfloat16)
    by_name["silu_and_mul"]["after_predecessor"] = [pair_timings(
        "K6 after K1 int4 gate|up, 32 rows", lambda: k1(x, packed_gu, scales_gu, GROUP, 8, 0), k6, k6)]
    w_gu = (0.02 * torch.randn((G_HIDDEN, 2 * G_INTER), generator=gen, device="cuda")).to(torch.bfloat16)
    xg = torch.randn((16, G_HIDDEN), generator=gen, device="cuda").to(torch.bfloat16)
    by_name["gelu_tanh_and_mul"]["after_predecessor"] = [pair_timings(
        "K10b after torch.matmul bf16 gate|up, 16 rows", lambda: torch.matmul(xg, w_gu), k10b, k10b)]


# K5's options (check_rope_options): head shapes (Llama-3-8B, Gemma-2-2B,
# JAX's test shapes, Qwen2-7B's 28 over 4), three rot_dims each (whole, half, and rot_dim / 2 not
# a multiple of 8: D - 28), token counts, q/k layouts (contiguous, slices
# of a fused qkv block, fused rows one element longer, contiguous rows from
# a base one element off), positions from -64 to past the cache.
ROPE_OPTION_HEADS = ((32, 8, 128), (8, 4, 256), (4, 1, 128), (8, 8, 64), (28, 4, 128))
ROPE_OPTION_TOKENS = (0, 1, 7, 8, 16, 32, 128, 512)
ROPE_OPTION_LAYOUTS = ("contiguous", "fused", "misaligned rows", "misaligned base")
ROPE_OPTION_POSITIONS = 4096
# tests/rotary_embedding_test.py's tolerances (atol and rtol); bf16's is the K5 phase's 2e-2.
ROPE_TOLERANCES = {torch.float32: 1e-5, torch.bfloat16: 2e-2, torch.float16: 1e-3}


def _flat_rows(gen, rows: int, width: int, dtype: torch.dtype, layout: str, row_stride: int | None = None):
    """A (rows, width) tensor of N(0, 1) values in ``dtype``: contiguous;
    rows at ``row_stride`` (``layout`` "strided"); rows one element longer
    than ``row_stride`` or width ("misaligned rows"); or contiguous rows from
    a base one element past a 16-byte boundary ("misaligned base")."""
    stride = row_stride or width
    if layout == "misaligned base":
        flat = torch.randn((rows * width + 1,), generator=gen, device="cuda").to(dtype)
        return flat[1:].view(rows, width)
    if layout == "misaligned rows":
        stride += 1
    if layout in ("strided", "misaligned rows"):
        return torch.randn((rows, stride), generator=gen, device="cuda").to(dtype)[:, :width]
    return torch.randn((rows, width), generator=gen, device="cuda").to(dtype)


def check_rope_options(gen, rng) -> None:
    """K5 over every option it takes (ROPE_OPTION_*: f32, bf16 and f16,
    each case with and without the programmatic-dependent launch) against
    the plain version at ROPE_TOLERANCES, both outputs contiguous and of
    their input's shape; counts the cases on each path of ``rope_plan``."""
    from conch_tpu_torch.kernels.common import aligned16
    from conch_tpu_torch.kernels.embedding.rotary_embedding import (
        rope_plan,
        rotary_embedding_launcher as launch,
        rotary_embedding_plain as plain,
    )
    from conch_tpu_torch.reference.embedding.rotary_embedding import compute_cos_sin_cache

    saved, failed, paths, cases, exact, err = launch.pdl, [], {}, 0, 0, {}
    try:
        for (qh, kh, d), dtype in itertools.product(ROPE_OPTION_HEADS, ROPE_TOLERANCES):
            tol = ROPE_TOLERANCES[dtype]
            for rot in (d, d // 2, d - 28):
                cache = compute_cos_sin_cache(10000.0, rot, ROPE_OPTION_POSITIONS, device="cuda")
                for tokens, layout in itertools.product(ROPE_OPTION_TOKENS, ROPE_OPTION_LAYOUTS):
                    if layout in ("fused", "misaligned rows"):
                        qkv = _flat_rows(gen, tokens, (qh + 2 * kh) * d, dtype, layout)
                        q, k = qkv[:, : qh * d], qkv[:, qh * d : (qh + kh) * d]
                    else:
                        q = _flat_rows(gen, tokens, qh * d, dtype, layout)
                        k = _flat_rows(gen, tokens, kh * d, dtype, layout)
                    pos = torch.from_numpy(rng.integers(-64, ROPE_OPTION_POSITIONS + 64, size=tokens).astype(
                        np.int32)).cuda()
                    plan = rope_plan(tokens, qh, kh, d, rot, q.element_size(), q.stride(0), k.stride(0),
                                     aligned16(q, k))
                    ref = plain(pos, q, k, d, cache)
                    for pdl in (False, True):
                        launch.pdl = pdl
                        got = launch(pos, q, k, d, cache)
                        name = f"{dtype} QH {qh} KH {kh} D {d} rot {rot} tokens {tokens} {layout} pdl {pdl}"
                        cases += 1
                        paths[plan.path] = paths.get(plan.path, 0) + 1
                        e = 0.0
                        for g, r in zip(got, ref):
                            if g.shape != r.shape or not g.is_contiguous():
                                failed.append(f"{name}: shape {tuple(g.shape)}")
                            elif tokens:
                                diff = (g.float() - r.float()).abs()
                                e = max(e, diff.max().item())
                                if not bool((diff <= tol + tol * r.float().abs()).all()):
                                    failed.append(f"{name}: max_abs_err {diff.max().item():.3e}")
                        err[dtype] = max(err.get(dtype, 0.0), e)
                        exact += e == 0.0
    finally:
        launch.pdl = saved
    torch.cuda.synchronize()
    print(f"K5 options: {cases} cases ({paths.get(0, 0)} on the vector path, {paths.get(1, 0)} scalar), "
          f"{exact} equal to the plain version bit for bit; max_abs_err "
          + ", ".join(f"{dt} {e:.3e} (tolerance {ROPE_TOLERANCES[dt]:.0e} + {ROPE_TOLERANCES[dt]:.0e} * |ref|)"
                      for dt, e in err.items()), flush=True)
    if failed:
        raise AssertionError(f"K5 options: {len(failed)} of {cases} cases failed: " + "; ".join(failed[:10]))


def kernel_phase_k3(gen, rng, cache: str | None = None) -> dict:
    """K3 on Llama-3-8B's table line (K3_CASES) over a bf16 pool, or over
    an int8 / e4m3 one (``cache``) with KV_SCALES[cache] (held at 3e-2 +
    3e-2 x |ref|)."""
    from conch_tpu_torch.kernels.attention.paged_attention import (
        paged_attention_launcher as launch_kv,
        paged_attention_plain as plain_kv,
    )

    case = k3_inputs(gen, rng, "llama3_8b table line", cache)
    launch, plain = with_kv_scales(launch_kv, cache), with_kv_scales(plain_kv, cache)
    args = (*case["args"], 0)
    out_k = launch(*args)
    out_p = plain(*args)
    torch.cuda.synchronize()
    if not torch.isfinite(out_k).all() or out_k[case["idle"]].abs().max().item() != 0.0:
        raise AssertionError("K3: the idle row must come out as finite zeros")
    if cache is None:
        err = (out_k.float() - out_p.float()).abs().max().item()
        check("K3 paged_attention", err, 3e-2)
    else:
        err = check_close(f"K3 paged_attention {cache} cache", out_k, out_p, 3e-2)
    bound_ms, bound_by = k3_bound(case, 0)
    return {
        "name": "paged_attention", "route": "cuda", "source": "conch_tpu_torch/csrc/paged_attention.cu",
        "replaces": "conch_tpu/kernels/attention/paged_attention.py:57", "max_abs_err": err,
        "ms": time_ms(lambda: launch(*args)),
        "paced_ms": paced_ms(lambda: launch(*args)),
        "plain_ms": time_ms(lambda: plain(*args), iters=5),
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
    }


def kernel_phase_k7(gen, rng, cache: str | None = None) -> dict:
    """K7 at Llama-3-8B's table line (K7_CASES) over a bf16 pool, or over an
    int8 / e4m3 one (``cache``) with KV_SCALES[cache] (held at 2e-2 + 2e-2
    x |ref|); padding rows exactly zero."""
    from conch_tpu_torch.kernels.attention.varlen_attention import (
        varlen_attention_launcher as launch_kv,
        varlen_attention_plain as plain_kv,
    )

    case = k7_inputs(gen, rng, "llama3_8b table line", cache)
    launch, plain = with_kv_scales(launch_kv, cache), with_kv_scales(plain_kv, cache)
    args = (*case["args"], 0)
    out_k = launch(*args)
    out_p = plain(*args)
    torch.cuda.synchronize()
    if not torch.isfinite(out_k).all() or out_k[case["total"]:].abs().max().item() != 0.0:
        raise AssertionError("K7: padding rows must come out as finite zeros")
    if cache is None:
        err = (out_k.float() - out_p.float()).abs().max().item()
        check("K7 varlen_attention", err, 2e-2)
    else:
        err = check_close(f"K7 varlen_attention {cache} cache", out_k, out_p, 2e-2)
    bound_ms, bound_by = k7_bound(case, 0)
    return {
        "name": "varlen_attention", "route": "cuda", "source": "conch_tpu_torch/csrc/varlen_attention.cu",
        "replaces": "conch_tpu/kernels/attention/varlen_attention.py:247", "max_abs_err": err,
        "ms": time_ms(lambda: launch(*args)),
        "paced_ms": paced_ms(lambda: launch(*args)),
        "plain_ms": time_ms(lambda: plain(*args), iters=5),
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
    }


def kernel_phases_verify(gen, rng) -> list[dict]:
    """K7 and K11 at the speculative verify step (VERIFY_*): rows K7 V
    (Llama-3-8B's heads over a 32-layer bf16 pool, K7_CASES "llama3_8b
    verify") and K11 V (DeepSeek-V2-Lite's 16 heads over a 27-layer packed
    latent pool, bf16 queries), each held against its plain version (K7 at
    2e-2, K11 at K11_TOLERANCES; K7's padding rows exactly zero, K11's
    finite), and timed; the bounds as ``k7_bound`` and ``kernel_phase_k11``
    count them."""
    from conch_tpu_torch.kernels.attention.mla_attention import mla_attention_launcher, mla_attention_plain
    from conch_tpu_torch.kernels.attention.varlen_attention import varlen_attention_launcher, varlen_attention_plain

    case = k7_inputs(gen, rng, "llama3_8b verify")
    args = (*case["args"], 0)
    got, ref = varlen_attention_launcher(*args), varlen_attention_plain(*args)
    torch.cuda.synchronize()
    if not torch.isfinite(got).all() or got[case["total"]:].abs().max().item() != 0.0:
        raise AssertionError("K7 V: padding rows must come out as finite zeros")
    err = check_close("K7 varlen_attention at the verify step (8 x 5 rows at ~1000)", got, ref, 2e-2)
    b_ms, b_by = k7_bound(case, 0)
    k7 = _kernel_row("varlen_attention_verify", "conch_tpu_torch/csrc/varlen_attention.cu",
                     "conch_tpu/kernels/attention/varlen_attention.py:247", err,
                     {"ms": time_ms(lambda: varlen_attention_launcher(*args)),
                      "paced_ms": paced_ms(lambda: varlen_attention_launcher(*args)),
                      "plain_ms": time_ms(lambda: varlen_attention_plain(*args), iters=5), "library_ms": None},
                     b_ms, b_by)
    del case, args, got, ref
    torch.cuda.empty_cache()

    num_pages = sum(-(-n // PS) for n in VERIFY_SEQ_LENS) + 1
    bt = paged_layout(rng, VERIFY_SEQ_LENS, num_pages, share=(0, 0), shared_pages=0, max_pages=MAX_PAGES_PER_SEQ)
    pool = torch.randn((DS_LAYERS, num_pages, PS, DS_PACKED), generator=gen, device="cuda")
    pool[..., DS_LATENT + DS_ROPE :] = 0.0
    layer = pool[DS_LAYER].to(torch.bfloat16)
    del pool
    q = torch.randn((VERIFY_ROWS, DS_HEADS, DS_PACKED), generator=gen, device="cuda")
    q[..., DS_LATENT + DS_ROPE :] = 0.0
    q = q.to(torch.bfloat16)
    cu = torch.tensor([VERIFY_Q * i for i in range(VERIFY_SEQS + 1)], dtype=torch.int32, device="cuda")
    sl = torch.tensor(VERIFY_SEQ_LENS, dtype=torch.int32, device="cuda")
    margs = (q, layer, cu, VERIFY_MAX_Q, sl, torch.from_numpy(bt).cuda())
    kw = {"scale": DS_SCALE, "latent": DS_LATENT}
    got, ref = mla_attention_launcher(*margs, **kw), mla_attention_plain(*margs, **kw)
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():  # padding rows: copies of a row of the last sequence, as JAX's
        raise AssertionError("K11 V: non-finite rows")
    err = check_close("K11 mla_attention at the verify step (8 x 5 rows at ~1000)", got, ref,
                      K11_TOLERANCES[torch.bfloat16])
    visible = sum(s - VERIFY_Q + j + 1 for s in VERIFY_SEQ_LENS for j in range(VERIFY_Q))
    bytes_moved = (unique_kv_rows(bt, VERIFY_SEQ_LENS) * DS_PACKED * 2 + q.numel() * 2
                   + VERIFY_ROWS * DS_HEADS * DS_LATENT * 2 + bt.size * 4 + (VERIFY_SEQS * 2 + 1) * 4)
    b_ms, b_by = bound(bytes_moved, 2 * DS_HEADS * (DS_PACKED + DS_LATENT) * visible)
    k11 = _kernel_row("mla_attention_verify", "conch_tpu_torch/csrc/mla_attention.cu",
                      "conch_tpu/kernels/attention/mla_attention.py:51", err,
                      {"ms": time_ms(lambda: mla_attention_launcher(*margs, **kw)),
                       "paced_ms": paced_ms(lambda: mla_attention_launcher(*margs, **kw)),
                       "plain_ms": time_ms(lambda: mla_attention_plain(*margs, **kw), iters=5), "library_ms": None},
                      b_ms, b_by)
    for row in (k7, k11):
        print(f"{row['name']}: {row['ms']:.4f} ms (paced {row['paced_ms']:.4f}, plain {row['plain_ms']:.4f}, "
              f"bound {row['bound_ms']:.5f} by {row['bound_by']})", flush=True)
    del margs, layer, q, got, ref
    torch.cuda.empty_cache()
    return [k7, k11]


# Engine shapes of K1 (K, N): fused wqkv, wo, fused gate|up, w_down.
K1_SHAPES = ((4096, 6144), (4096, 4096), (4096, 28672), (14336, 4096))
# Rows of the timed GEMM cases: a decode step of 8, the engine's decode step
# (padded to max_batch_size 32) and a 512-row prefill chunk.
GEMM_MS = (8, 32, 512)
GROUP = 128
HIDDEN, INTER = 4096, 14336


def _kernel_row(name: str, source: str, replaces: str, err: float, timed: dict, bound_ms: float, bound_by: str) -> dict:
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces, "max_abs_err": err,
        "ms": timed["ms"], "paced_ms": timed["paced_ms"], "plain_ms": timed["plain_ms"], "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": timed["library_ms"],
    }


def _k1_cases(gen, group: int, shapes: tuple = K1_SHAPES) -> list[dict]:
    """K1 at the engine's four (K, N) (or ``shapes``), M in GEMM_MS, layer 17 of a 32-layer
    stack, at ``group``: checked against the plain version (tolerance 1e-2
    x max |ref|), bit for bit across two calls, and timed beside it and a
    bf16 matmul on the dequantized weight."""
    from conch_tpu_torch.kernels.common import sm_count
    from conch_tpu_torch.kernels.quantization.gemm import (
        dequantize_magic,
        mixed_gemm_magic_launcher as launch,
        mixed_gemm_magic_plain as plain,
        quant_gemm_plan,
    )

    detail = []
    for k, n in shapes:
        packed = torch.randint(-(2**31), 2**31 - 1, (NUM_LAYERS_POOL, k // 8, n), generator=gen, device="cuda",
                               dtype=torch.int32)
        scales = (torch.rand((NUM_LAYERS_POOL, k // group, n), generator=gen, device="cuda") * 4e-3 + 1e-4).to(
            torch.bfloat16)
        # Timed calls walk the 32 layers (library: 3 dense copies), so the
        # weights come from HBM as in a model step, not from the 50 MB L2.
        dense = [dequantize_magic(packed[i], scales[i], k, group, 8).to(torch.bfloat16) for i in (LAYER, 0, 31)]
        layers, copies = itertools.cycle(range(NUM_LAYERS_POOL)), itertools.cycle(dense)
        for m in GEMM_MS:
            x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
            out_k = launch(x, packed, scales, group, 8, LAYER)
            out_p = plain(x, packed, scales, group, 8, LAYER)
            torch.cuda.synchronize()
            scale = out_p.float().abs().max().item()
            e = (out_k.float() - out_p.float()).abs().max().item()
            check(f"K1 mixed_gemm_magic group {group} M={m} K={k} N={n} (max|ref| {scale:.3f})", e, 1e-2 * scale)
            check_repeatable(f"K1 mixed_gemm_magic group {group} M={m} K={k} N={n}",
                             lambda: launch(x, packed, scales, group, 8, LAYER))
            plan = quant_gemm_plan("magic", m, n, k, 4, group, sm_count(0))
            bytes_moved = m * k * 2 + k * n // 2 + (k // group) * n * 2 + m * n * 2
            b_ms, b_by = bound(bytes_moved, 2 * m * n * k)
            detail.append({
                "group": group, "m": m, "k": k, "n": n, "max_abs_err": e, "bound_ms": b_ms, "bound_by": b_by,
                "plan": dataclasses.asdict(plan),
                "ms": time_ms(lambda: launch(x, packed, scales, group, 8, next(layers))),
                "paced_ms": paced_ms(lambda: launch(x, packed, scales, group, 8, next(layers))),
                "plain_ms": time_ms(lambda: plain(x, packed, scales, group, 8, next(layers)), iters=5),
                "library_ms": time_ms(lambda: torch.matmul(x, next(copies))),
            })
        del packed, scales, dense
        torch.cuda.empty_cache()
    for d in detail:
        print(f"K1 group {group} M={d['m']} K={d['k']} N={d['n']}: {d['ms']:.4f} ms (paced {d['paced_ms']:.4f}, plain {d['plain_ms']:.4f}, bf16 matmul {d['library_ms']:.4f}, bound "
              f"{d['bound_ms']:.5f} by {d['bound_by']}; splits {d['plan']['splits']})", flush=True)
    return detail


def _decode_sums(detail: list[dict], m: int = 8) -> dict:
    """One layer's four GEMMs at ``m`` rows: each time and the bound summed."""
    decode = [d for d in detail if d["m"] == m]
    keys = ("ms", "paced_ms", "plain_ms", "library_ms", "bound_ms")
    return {key: sum(d[key] for d in decode) for key in keys}


def kernel_phase_k1(gen) -> dict:
    """K1 at the engine's four (K, N) at M = 8, 32 (the engine's decode
    step) and 512 (a prefill chunk), read from layer 17 of a 32-layer
    stack, at group 128 (the README's int4) and group 64. The row's numbers
    are the group-128 sums over the four shapes at M = 8 (one layer's
    projections in a decode step of 8); ``by_m`` has them at each M,
    ``group64`` the M = 8 sums at group 64, ``group64_by_m`` those at each
    M, and ``detail`` every case."""
    detail = _k1_cases(gen, 128) + _k1_cases(gen, 64)
    timed = _decode_sums([d for d in detail if d["group"] == 128])
    row = _kernel_row(
        "mixed_gemm_magic", "conch_tpu_torch/csrc/mixed_gemm_magic.cu", "conch_tpu/kernels/quantization/gemm.py:658",
        max(d["max_abs_err"] for d in detail), timed, timed["bound_ms"], "bytes",
    )
    row["group64"] = _decode_sums([d for d in detail if d["group"] == 64])
    row["by_m"] = {m: _decode_sums([d for d in detail if d["group"] == 128], m) for m in GEMM_MS}
    row["group64_by_m"] = {m: _decode_sums([d for d in detail if d["group"] == 64], m) for m in GEMM_MS}
    for group, by_m in ((128, row["by_m"]), (64, row["group64_by_m"])):
        for m, sums in by_m.items():
            print(f"mixed_gemm_magic group {group} one layer at M={m}: {sums['ms']:.4f} ms (library "
                  f"{sums['library_ms']:.4f}, bound {sums['bound_ms']:.5f})", flush=True)
    print(f"K1 one layer at M=8: group 128 {timed['ms']:.4f} ms, group 64 {row['group64']['ms']:.4f} ms", flush=True)
    row["detail"] = detail
    return row


# Engine shapes (K, N) of the quantized modes at Llama-3-8B, with the
# count of each in one layer: int8 (K1b) and w8a8 (K8) fuse wqkv and
# gate|up; nf4 (K1c) stays unfused (its ``shape`` meta refuses concat_n,
# as in the JAX package). lm_head (4096 x 128256) is timed apart.
FUSED_LAYER_SHAPES = {(4096, 6144): 1, (4096, 4096): 1, (4096, 28672): 1, (14336, 4096): 1}
NF4_LAYER_SHAPES = {(4096, 4096): 2, (4096, 1024): 2, (4096, 14336): 2, (14336, 4096): 1}
LM_HEAD = (4096, 128256)
NF4_BLOCK = 64


def _time_case(launch, plain, library, m: int, k: int, n: int, err: float, bytes_moved: float, ops: float,
               ops_per_s: float = BF16_OPS_PER_S, **extra) -> dict:
    b_ms, b_by = bound(bytes_moved, ops, ops_per_s)
    return {
        "m": m, "k": k, "n": n, "max_abs_err": err, "bound_ms": b_ms, "bound_by": b_by,
        "ms": time_ms(launch), "paced_ms": paced_ms(launch), "plain_ms": time_ms(plain, iters=3, warmup=1),
        "library_ms": None if library is None else time_ms(library), **extra,
    }


def _layer_sums(detail: list, counts: dict, m: int) -> dict:
    """One layer's GEMMs at ``m`` rows: each shape's times and bound times its
    count in a layer, summed."""
    cases = [d for d in detail if d["m"] == m and (d["k"], d["n"]) in counts]
    sums = {
        key: sum(d[key] * counts[(d["k"], d["n"])] for d in cases)
        for key in ("ms", "paced_ms", "plain_ms", "library_ms", "bound_ms") if all(d[key] is not None for d in cases)
    }
    sums.setdefault("library_ms", None)
    return sums


def _layer_row(name: str, source: str, replaces: str, err: float, detail: list, counts: dict) -> dict:
    """A kernel row whose numbers are one layer's GEMMs at M = 8 (each shape
    times its count in a layer); ``by_m`` has the same sums at each of
    ``GEMM_MS`` and ``detail`` keeps every case."""
    timed = _layer_sums(detail, counts, 8)
    row = _kernel_row(name, source, replaces, err, timed, timed["bound_ms"], "bytes")
    row["by_m"] = {m: _layer_sums(detail, counts, m) for m in GEMM_MS}
    row["detail"] = detail
    for d in detail:
        print(f"{name} M={d['m']} K={d['k']} N={d['n']}: {d['ms']:.4f} ms (paced {d['paced_ms']:.4f}, plain "
              f"{d['plain_ms']:.4f}, library {d['library_ms']}, bound {d['bound_ms']:.5f} by {d['bound_by']})",
              flush=True)
    for m, sums in row["by_m"].items():
        print(f"{name} one layer at M={m}: {sums['ms']:.4f} ms (library {sums['library_ms']}, bound "
              f"{sums['bound_ms']:.5f})", flush=True)
    return row


def check_repeatable(name: str, launch) -> None:
    """Two calls of ``launch`` on the same inputs must agree bit for bit."""
    first, second = launch(), launch()
    torch.cuda.synchronize()
    if not torch.equal(first, second):
        diff = (first.float() - second.float()).abs().max().item()
        raise AssertionError(f"{name}: two calls on the same inputs differ (max {diff})")
    print(f"{name}: two calls bit for bit equal", flush=True)


def _stack_cycle(n_layers: int = NUM_LAYERS_POOL):
    """Timed calls walk the layers of a stack, so its weights come from HBM
    as in a model step, not from the 50 MB L2."""
    return itertools.cycle(range(n_layers))


def _k1b_cases(gen, group: int, shapes: tuple) -> list[dict]:
    """K1b over int8 planar codes (uint8b128, bf16 scales) at ``group`` and
    the (K, N) ``shapes``, M in GEMM_MS, layer 17 of a 32-layer stack
    (``LM_HEAD`` unstacked), random codes over the full range: checked
    against the plain version (tolerance 1e-2 x max |ref|), bit for bit
    across two calls, and timed beside it and a bf16 matmul on the
    dequantized weight."""
    from conch_tpu_torch.kernels.quantization.gemm import (
        mixed_gemm_planar_launcher as launch,
        mixed_gemm_planar_plain as plain,
    )
    from conch_tpu_torch.utils.quant_utils import unpack_rows_planar

    detail = []
    for (k, n) in shapes:
        layers = NUM_LAYERS_POOL if (k, n) != LM_HEAD else None
        lead = () if layers is None else (layers,)
        packed = torch.randint(-(2**31), 2**31 - 1, (*lead, k // 4, n), generator=gen, device="cuda", dtype=torch.int32)
        scales = (torch.rand((*lead, k // group, n), generator=gen, device="cuda") * 4e-3 + 1e-4).to(torch.bfloat16)
        li = None if layers is None else LAYER
        cyc = _stack_cycle() if layers else itertools.repeat(None)
        one, one_scales = (packed, scales) if layers is None else (packed[LAYER], scales[LAYER])
        codes = unpack_rows_planar(one, 8, k, group).float()
        dense = ((codes - 128.0) * one_scales.float().repeat_interleave(group, 0)).to(torch.bfloat16)
        del codes
        for m in GEMM_MS:
            x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
            out_k = launch(x, packed, scales, None, 8, 128, group, li)
            out_p = plain(x, packed, scales, None, 8, 128, group, li)
            torch.cuda.synchronize()
            scale = out_p.float().abs().max().item()
            e = (out_k.float() - out_p.float()).abs().max().item()
            label = f"K1b mixed_gemm_planar int8 group {group} M={m} K={k} N={n}"
            check(f"{label} (max|ref| {scale:.3f})", e, 1e-2 * scale)
            check_repeatable(label, lambda: launch(x, packed, scales, None, 8, 128, group, li))
            bytes_moved = m * k * 2 + k * n + (k // group) * n * 2 + m * n * 2
            detail.append(_time_case(
                lambda: launch(x, packed, scales, None, 8, 128, group, next(cyc)),
                lambda: plain(x, packed, scales, None, 8, 128, group, li),
                lambda: torch.matmul(x, dense), m, k, n, e, bytes_moved, 2 * m * n * k, group=group,
            ))
        del packed, scales, dense
        torch.cuda.empty_cache()
    return detail


def kernel_phase_k1b(gen) -> dict:
    """K1b (int8 planar, uint8b128, group 128, bf16 scales) at the int8
    engine's shapes, as ``_k1b_cases`` runs them; plus 4-bit with per-group
    and with scalar zero-points. Tolerance 1e-2 x max |ref|."""
    from conch_tpu_torch.kernels.quantization.gemm import (
        mixed_gemm_planar_launcher as launch,
        mixed_gemm_planar_plain as plain,
    )

    detail = _k1b_cases(gen, GROUP, (*FUSED_LAYER_SHAPES, LM_HEAD))
    err = max(d["max_abs_err"] for d in detail)
    # Options the served path does not use: 4-bit planar with per-group and
    # with scalar zero-points (which replace the bias, as in the TPU kernel).
    k, n = 1024, 512
    packed = torch.randint(-(2**31), 2**31 - 1, (3, k // 8, n), generator=gen, device="cuda", dtype=torch.int32)
    scales = (torch.rand((3, k // GROUP, n), generator=gen, device="cuda") * 4e-3 + 1e-4).to(torch.bfloat16)
    zps = {
        "per-group": torch.randint(0, 16, (3, k // GROUP, n), generator=gen, device="cuda").float(),
        "scalar": torch.tensor([7.0], device="cuda"),
    }
    for label, zp in zps.items():
        for m in (8, 40):
            x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
            out_k, out_p = launch(x, packed, scales, zp, 4, 8, GROUP, 1), plain(x, packed, scales, zp, 4, 8, GROUP, 1)
            scale = out_p.float().abs().max().item()
            e = (out_k.float() - out_p.float()).abs().max().item()
            check(f"K1b mixed_gemm_planar 4-bit {label} zero-points M={m} (max|ref| {scale:.3f})", e, 1e-2 * scale)
            err = max(err, e)
    return _layer_row(
        "mixed_gemm_planar", "conch_tpu_torch/csrc/mixed_gemm_planar.cu", "conch_tpu/kernels/quantization/gemm.py:582",
        err, detail, FUSED_LAYER_SHAPES,
    )


def kernel_phase_k1c(gen) -> dict:
    """K1c (NF4 codebook over GPTQ rows, f32 absmax per 64 rows) at the nf4
    engine's unfused shapes, M in GEMM_MS, layer 17 of a 32-layer stack
    (lm_head unstacked), random codes, bit for bit across two calls; plus
    8-bit GPTQ rows with per-group zero-points and the FP4 codebook.
    Tolerance 1e-2 x max |ref|. Library: a bf16 matmul on the dequantized
    weight."""
    from conch_tpu_torch.kernels.quantization.bitsandbytes.blockwise import FP4_MAGNITUDE_CODE, NF4_CODE
    from conch_tpu_torch.kernels.quantization.gemm import (
        dequantize_rows,
        mixed_gemm_rows_launcher as launch,
        mixed_gemm_rows_plain as plain,
    )

    err, detail = 0.0, []
    for (k, n) in (*NF4_LAYER_SHAPES, LM_HEAD):
        layers = NUM_LAYERS_POOL if (k, n) != LM_HEAD else None
        lead = () if layers is None else (layers,)
        packed = torch.randint(-(2**31), 2**31 - 1, (*lead, k // 8, n), generator=gen, device="cuda", dtype=torch.int32)
        absmax = torch.rand((*lead, k // NF4_BLOCK, n), generator=gen, device="cuda") * 0.09 + 0.01
        li = None if layers is None else LAYER
        cyc = _stack_cycle() if layers else itertools.repeat(None)
        one = (packed, absmax) if layers is None else (packed[LAYER], absmax[LAYER])
        dense = dequantize_rows(*one, None, k, 4, 0, NF4_BLOCK, NF4_CODE).to(torch.bfloat16)
        for m in GEMM_MS:
            x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
            out_k = launch(x, packed, absmax, None, 4, 0, NF4_BLOCK, NF4_CODE, li)
            out_p = plain(x, packed, absmax, None, 4, 0, NF4_BLOCK, NF4_CODE, li)
            torch.cuda.synchronize()
            scale = out_p.float().abs().max().item()
            e = (out_k.float() - out_p.float()).abs().max().item()
            check(f"K1c mixed_gemm_rows nf4 M={m} K={k} N={n} (max|ref| {scale:.3f})", e, 1e-2 * scale)
            check_repeatable(f"K1c mixed_gemm_rows nf4 M={m} K={k} N={n}",
                             lambda: launch(x, packed, absmax, None, 4, 0, NF4_BLOCK, NF4_CODE, li))
            err = max(err, e)
            bytes_moved = m * k * 2 + k * n // 2 + (k // NF4_BLOCK) * n * 4 + m * n * 2
            detail.append(_time_case(
                lambda: launch(x, packed, absmax, None, 4, 0, NF4_BLOCK, NF4_CODE, next(cyc)),
                lambda: plain(x, packed, absmax, None, 4, 0, NF4_BLOCK, NF4_CODE, li),
                lambda: torch.matmul(x, dense), m, k, n, e, bytes_moved, 2 * m * n * k,
            ))
        del packed, absmax, dense
        torch.cuda.empty_cache()
    # Options the served path does not use: 8-bit GPTQ rows (uint8b128) with
    # per-group zero-points, and the FP4 codebook (sign bit 3).
    fp4 = tuple(FP4_MAGNITUDE_CODE) + tuple(-v for v in FP4_MAGNITUDE_CODE)
    k, n = 1024, 512
    cases = {
        "8-bit per-group zero-points": (8, 128, None, torch.randint(-8, 8, (3, k // 64, n), generator=gen,
                                                                    device="cuda").float()),
        "fp4 codebook": (4, 0, fp4, None),
    }
    for label, (bits, bias, book, zp) in cases.items():
        packed = torch.randint(-(2**31), 2**31 - 1, (3, k * bits // 32, n), generator=gen, device="cuda",
                               dtype=torch.int32)
        scales = (torch.rand((3, k // 64, n), generator=gen, device="cuda") * 4e-3 + 1e-4).to(torch.bfloat16)
        for m in (8, 40):
            x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
            out_k = launch(x, packed, scales, zp, bits, bias, 64, book, 2)
            out_p = plain(x, packed, scales, zp, bits, bias, 64, book, 2)
            scale = out_p.float().abs().max().item()
            e = (out_k.float() - out_p.float()).abs().max().item()
            check(f"K1c mixed_gemm_rows {label} M={m} (max|ref| {scale:.3f})", e, 1e-2 * scale)
            err = max(err, e)
    return _layer_row(
        "mixed_gemm_rows", "conch_tpu_torch/csrc/mixed_gemm_rows.cu", "conch_tpu/kernels/quantization/gemm.py:129",
        err, detail, NF4_LAYER_SHAPES,
    )


# The option sweep of K1b and K1c: every bit width, scale dtype, zero-point
# mode, M regime (32, 64 and 128 rows a block, with splits), x row layout
# and output dtype, at each group the kernels take among these. Small K and
# N: K spans four split units, so the plan splits K at every M.
OPTION_MS = (8, 40, 130)
ROWS_OPTION_GROUPS = (12, 64, 100, 128, 256)  # 12 and 100: the group-table template (up to 17 scale rows a slice)
# group % (8 * 32 / bits) == 0: 16-word-row slices, whole groups of 128, and 8-word-row slices (int8 at 32,
# 4-bit at 64, 2-bit at 128, int8 at 96: three slices a group).
PLANAR_OPTION_GROUPS = {2: (128, 256), 4: (64, 128, 256), 8: (32, 64, 96, 128, 256)}
OPTION_N = 160  # a partial 128-column tile


def _option_xs(gen, m: int, k: int) -> dict:
    """x three ways: contiguous; rows 16 bytes longer (TMA with ldx != K);
    8 bytes off and a stride of K + 4 (realigned by the wrapper's
    ``_tma_rows``)."""
    wide = torch.randn((m, k + 8), generator=gen, device="cuda").to(torch.bfloat16)
    off = torch.randn((m, k + 4), generator=gen, device="cuda").to(torch.bfloat16)
    return {"contiguous": wide[:, :k].contiguous(), "padded": wide[:, :k], "offset": off[:, 4:]}


def check_quant_gemm_options(gen) -> None:
    """K1b and K1c at every option they take, against their plain versions
    at 1e-2 x max |ref|: 2-, 4- and 8-bit codes (K1c also the NF4 codebook)
    at groups ``ROWS_OPTION_GROUPS`` (K1c, K not a multiple of 64) and
    ``PLANAR_OPTION_GROUPS`` (K1b: the 16- and 8-word-row slices with their
    4-d x box, 2-bit codes, and whole groups of 128), bf16 and f32 scales,
    zero-point modes 0, 1 and 2, M in ``OPTION_MS``, x contiguous, with
    padded rows, or realigned, f32 and bf16 outputs; layer 1 of a 2-layer
    stack. Errors are gathered on the card and read once."""
    from conch_tpu_torch.kernels.quantization.bitsandbytes.blockwise import NF4_CODE
    from conch_tpu_torch.kernels.quantization.gemm import (
        mixed_gemm_planar_launcher,
        mixed_gemm_planar_plain,
        mixed_gemm_rows_launcher,
        mixed_gemm_rows_plain,
    )

    n = OPTION_N
    names, errs, refs = [], [], []

    kernels = {
        "K1c mixed_gemm_rows": (mixed_gemm_rows_launcher, mixed_gemm_rows_plain),
        "K1b mixed_gemm_planar": (mixed_gemm_planar_launcher, mixed_gemm_planar_plain),
    }

    def sweep(label, bits, group, k, groups, books):
        launch, plain = kernels[label]
        epp = 32 // bits
        packed = torch.randint(-(2**31), 2**31 - 1, (2, k // epp, n), generator=gen, device="cuda", dtype=torch.int32)
        for sdt in (torch.bfloat16, torch.float32):
            scales = (torch.rand((2, groups, n), generator=gen, device="cuda") * 4e-3 + 1e-4).to(sdt)
            zps = {
                "zp none": None, "zp scalar": torch.tensor([3.0], device="cuda"),
                "zp per group": torch.randint(0, 2**bits, (2, groups, n), generator=gen, device="cuda").float(),
            }
            for zlabel, zp in zps.items():
                for m in OPTION_MS:
                    for xlabel, x in _option_xs(gen, m, k).items():
                        for book, bias in books:
                            book_arg = () if label.startswith("K1b") else (book,)  # K1b takes no codebook
                            for od in (torch.bfloat16, torch.float32):
                                out = launch(x, packed, scales, zp, bits, bias, group, *book_arg, 1, od)
                                ref = plain(x, packed, scales, zp, bits, bias, group, *book_arg, 1, od)
                                names.append(f"{label} {bits}-bit group {group} K={k} {'nf4 ' if book else ''}"
                                             f"{str(sdt)[6:]} scales, {zlabel}, M={m}, x {xlabel}, {str(od)[6:]} out")
                                errs.append((out.float() - ref.float()).abs().max())
                                refs.append(ref.float().abs().max())

    for bits in (2, 4, 8):
        for group in ROWS_OPTION_GROUPS:
            k = 4 * math.lcm(group, 64) - 16  # four split units, the last slice partial
            books = ((None, 2 ** (bits - 1)),) + (((tuple(NF4_CODE), 0),) if bits == 4 else ())
            sweep("K1c mixed_gemm_rows", bits, group, k, -(-k // group), books)
        for group in PLANAR_OPTION_GROUPS[bits]:
            sweep("K1b mixed_gemm_planar", bits, group, 4 * group, 4, ((None, 2 ** (bits - 1)),))
    err_list = torch.stack(errs).tolist()
    ref_list = torch.stack(refs).tolist()
    bad = [(name, e, r) for name, e, r in zip(names, err_list, ref_list) if not e <= 1e-2 * r]
    for layout in kernels:
        ratios = [e / r for name, e, r in zip(names, err_list, ref_list) if name.startswith(layout)]
        print(f"{layout} options: {len(ratios)} cases, worst max_abs_err / max|ref| {max(ratios):.3e} "
              f"(tolerance 1e-2)", flush=True)
    for name, e, r in bad:
        print(f"{name}: max_abs_err {e:.3e} (tolerance {1e-2 * r:.1e})", flush=True)
    if bad:
        raise AssertionError(f"{len(bad)} of {len(names)} K1b/K1c option cases exceed 1e-2 x max |ref|")


# K1's option sweep: the three groups, any bias, stacked and single weights, x three ways, bf16 and f32 outputs,
# M from 1 past 512 (32, 64 and 128 rows a block, K split at small M). K by group: 4 groups, or at group 32 13
# (six slices of two groups and a last slice half past K).
MAGIC_OPTION_MS = (1, 8, 31, 40, 64, 130, 512, 600)
MAGIC_OPTION_K = {128: 512, 64: 256, 32: 416}
MAGIC_OPTION_BIASES = (8, 0, 15)


def check_magic_gemm_options(gen) -> None:
    """K1 at every option it takes, against its plain version at 1e-2 x max
    |ref|: groups 128, 64 and 32, biases
    ``MAGIC_OPTION_BIASES``, layer 1 of a 2-layer stack and an unstacked
    weight, M in ``MAGIC_OPTION_MS``, x contiguous, with padded rows, or
    realigned, bf16 and f32 outputs; K ``MAGIC_OPTION_K`` (split at small
    M), N = ``OPTION_N``. Every case runs twice and must give the same bits. Errors
    are gathered on the card and read once."""
    from conch_tpu_torch.kernels.common import sm_count
    from conch_tpu_torch.kernels.quantization.gemm import _magic_gemm_cuda, mixed_gemm_magic_plain, quant_gemm_plan

    n = OPTION_N
    names, errs, refs, same = [], [], [], []
    for group, k in MAGIC_OPTION_K.items():
        packed = torch.randint(-(2**31), 2**31 - 1, (2, k // 8, n), generator=gen, device="cuda", dtype=torch.int32)
        scales = (torch.rand((2, k // group, n), generator=gen, device="cuda") * 4e-3 + 1e-4).to(torch.bfloat16)
        for m in MAGIC_OPTION_MS:
            plan = quant_gemm_plan("magic", m, n, k, 4, group, sm_count(0))
            for xlabel, x in _option_xs(gen, m, k).items():
                for bias in MAGIC_OPTION_BIASES:
                    for stacked in (True, False):
                        w, sc, li = (packed, scales, 1) if stacked else (packed[1], scales[1], None)
                        for od in (torch.bfloat16, torch.float32):
                            out = _magic_gemm_cuda(x, w, sc, group, bias, li, od)
                            again = _magic_gemm_cuda(x, w, sc, group, bias, li, od)
                            ref = mixed_gemm_magic_plain(x, w, sc, group, bias, li, od)
                            names.append(f"K1 mixed_gemm_magic group {group} M={m} x {xlabel} bias {bias} "
                                         f"{'stacked' if stacked else 'single'} {str(od)[6:]} out "
                                         f"(splits {plan.splits})")
                            errs.append((out.float() - ref.float()).abs().max())
                            refs.append(ref.float().abs().max())
                            same.append(torch.equal(out, again))
    err_list, ref_list, same_list = torch.stack(errs).tolist(), torch.stack(refs).tolist(), torch.tensor(same).tolist()
    bad = [(name, e, r) for name, e, r in zip(names, err_list, ref_list) if not e <= 1e-2 * r]
    print(f"K1 mixed_gemm_magic options: {len(names)} cases, worst max_abs_err / max|ref| "
          f"{max(e / r for e, r in zip(err_list, ref_list)):.3e} (tolerance 1e-2); "
          f"{sum(same_list)} of {len(names)} bit for bit across two calls", flush=True)
    for name, e, r in bad:
        print(f"{name}: max_abs_err {e:.3e} (tolerance {1e-2 * r:.1e})", flush=True)
    if bad:
        raise AssertionError(f"{len(bad)} of {len(names)} K1 option cases exceed 1e-2 x max |ref|")
    if not all(same_list):
        raise AssertionError(f"{len(same_list) - sum(same_list)} K1 option cases differ between two calls")


def _int_mm_library(m: int, k: int, n: int, gen) -> tuple:
    """``torch._int_mm`` (int8 x int8 -> int32, no epilogue) at the smallest
    M from ``m`` up that it takes: (M timed at, callable)."""
    b = torch.randint(-127, 128, (k, n), generator=gen, device="cuda", dtype=torch.int8)
    for mm in (m, 17, 24, 32):
        a = torch.randint(-127, 128, (mm, k), generator=gen, device="cuda", dtype=torch.int8)
        try:
            torch._int_mm(a, b)
        except RuntimeError:
            continue
        return mm, (lambda a=a: torch._int_mm(a, b))
    return None, None


def k8_weights(gen, k: int, n: int, layers: int | None = NUM_LAYERS_POOL) -> tuple[torch.Tensor, torch.Tensor]:
    """The w8a8 engine's int8 weight of one projection, (layers, K, N) (or
    (K, N) unstacked), and its per-column scales."""
    lead = () if layers is None else (layers,)
    w8 = torch.randint(-127, 128, (*lead, k, n), generator=gen, device="cuda", dtype=torch.int8)
    return w8, torch.rand((*lead, n), generator=gen, device="cuda") * 1e-3 + 1e-4


def k8_rows(gen, m: int, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """m int8 activation rows and their per-row scales, 10x apart end to end
    (a kernel that swapped sa and sb would fail)."""
    a = torch.randint(-127, 128, (m, k), generator=gen, device="cuda", dtype=torch.int8)
    return a, 1e-3 * torch.logspace(0, 1, m, device="cuda")


def kernel_phase_k8(gen) -> dict:
    """K8 (int8 x int8 -> int32, then * sa[m] * sb[n]) at the w8a8 engine's
    shapes, M in GEMM_MS, layer 17 of a 32-layer stack (lm_head unstacked);
    per-row scales spanning 10x, so that a kernel that swapped sa and sb
    would fail; plus float8_e4m3fn inputs with f32 and bf16 outputs and a
    scalar sa. Tolerance 1e-2 x max |ref| (the int path is exact up to its
    epilogue). Library: ``torch._int_mm`` without the epilogue, at the
    smallest M it takes (recorded as ``library_m``)."""
    from conch_tpu_torch.kernels.quantization.gemm import scaled_gemm_launcher as launch, scaled_gemm_plain as plain

    err, detail = 0.0, []
    for (k, n) in (*FUSED_LAYER_SHAPES, LM_HEAD):
        layers = NUM_LAYERS_POOL if (k, n) != LM_HEAD else None
        w8, sb = k8_weights(gen, k, n, layers)
        li = None if layers is None else LAYER
        cyc = _stack_cycle() if layers else itertools.repeat(None)
        # The bf16 matmul of the same shape, for reference (three weights in turn, so not from L2).
        dense = itertools.cycle([torch.randn((k, n), generator=gen, device="cuda").to(torch.bfloat16)
                                 for _ in range(3)])
        for m in GEMM_MS:
            a, sa = k8_rows(gen, m, k)
            xb = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
            out_k = launch(a, w8, sa, sb, torch.bfloat16, li)
            out_p = plain(a, w8, sa, sb, torch.bfloat16, li)
            torch.cuda.synchronize()
            scale = out_p.float().abs().max().item()
            e = (out_k.float() - out_p.float()).abs().max().item()
            same = (out_k == out_p).float().mean().item()
            check(f"K8 scaled_gemm int8 M={m} K={k} N={n} (max|ref| {scale:.3f}, {same:.4f} of outputs equal)",
                  e, 1e-2 * scale)
            err = max(err, e)
            lib_m, lib = _int_mm_library(m, k, n, gen)
            bytes_moved = m * k + k * n + m * 4 + n * 4 + m * n * 2
            detail.append(_time_case(
                lambda: launch(a, w8, sa, sb, torch.bfloat16, next(cyc)),
                lambda: plain(a, w8, sa, sb, torch.bfloat16, li), lib, m, k, n, e, bytes_moved, 2 * m * n * k,
                INT8_OPS_PER_S, library_m=lib_m, matmul_ms=time_ms(lambda: torch.matmul(xb, next(dense))),
            ))
        del w8, sb, dense
        torch.cuda.empty_cache()
    # float8_e4m3fn inputs (the fp8 mainloop, f32 sums), scalar sa.
    m, k, n = 16, 512, 256
    a8 = torch.randn((m, k), generator=gen, device="cuda").to(torch.float8_e4m3fn)
    b8 = torch.randn((k, n), generator=gen, device="cuda").to(torch.float8_e4m3fn)
    sa, sb = torch.tensor([0.5], device="cuda"), torch.rand((n,), generator=gen, device="cuda") + 0.5
    for dtype in (torch.float32, torch.bfloat16):
        out_k, out_p = launch(a8, b8, sa, sb, dtype), plain(a8, b8, sa, sb, dtype)
        scale = out_p.float().abs().max().item()
        e = (out_k.float() - out_p.float()).abs().max().item()
        check(f"K8 scaled_gemm float8_e4m3fn -> {dtype} (max|ref| {scale:.3f})", e, 1e-2 * scale)
        err = max(err, e)
    row = _layer_row(
        "scaled_gemm", "conch_tpu_torch/csrc/scaled_gemm.cu", "conch_tpu/kernels/quantization/gemm.py:739", err,
        detail, FUSED_LAYER_SHAPES,
    )
    row["library_note"] = ("torch._int_mm without the epilogue, at the M in each detail entry's library_m; "
                           "matmul_ms: a bf16 torch.matmul of the same shape, for reference")
    for m in GEMM_MS:
        matmul = sum(d["matmul_ms"] * FUSED_LAYER_SHAPES[(d["k"], d["n"])] for d in detail
                     if d["m"] == m and (d["k"], d["n"]) in FUSED_LAYER_SHAPES)
        row["by_m"][m]["matmul_ms"] = matmul
        print(f"scaled_gemm one layer at M={m}: bf16 torch.matmul {matmul:.4f} ms", flush=True)
    return row


# K8's option sweep: rows from one to past a 512-row chunk (1 and 17:
# partial row tiles of the 32-row template; 40: the 64-row one; 130, 600:
# several 128-row tiles), a small shape (K 96: a K slice zero-filled past
# K; N 160: a partial column block) with every option, and the served
# shapes (FUSED_LAYER_SHAPES) with one option set each, in turn; for int8
# and for float8_e4m3fn.
SCALED_OPTION_MS = (1, 8, 16, 17, 31, 32, 40, 130, 512, 600)
SCALED_OPTION_SMALL = (96, 160)
SCALED_OPTIONS = list(itertools.product(
    (torch.float32, torch.bfloat16), ("scalar", "row"), ("scalar", "column"), ("single", "stacked"),
    (0, 64, 40),  # a's row stride past K: contiguous, one TMA takes, one the wrapper realigns
))
SCALED_DTYPES = (torch.int8, torch.float8_e4m3fn)
# K8's e4m3 tolerances against the plain version: 1e-2 x max |ref| (the two
# sum in other orders, and the tensor cores' slice sums keep about 14
# bits); 1e-3 x |ref| per output where every value is positive (the sums
# do not cancel, so a slice sum left unpromoted shows in every output).
E4M3_TOLERANCE, E4M3_SAME_SIGN_TOLERANCE = 1e-2, 1e-3
# (M, K, N, b's offset in bytes) of e4m3 shapes that keep the loop kernel
# (``e4m3_takes_mainloop``): N not a multiple of 16, b's base off 16 bytes,
# K 0.
E4M3_LOOP_CASES = ((17, 96, 100, 0), (8, 96, 160, 8), (4, 0, 32, 0))


def _e4m3(shape: tuple, gen, low: float | None = None) -> torch.Tensor:
    """float8_e4m3fn values: N(0, 1), or with ``low`` uniform in [low, low +
    1.5) (every value positive)."""
    v = (torch.randn(shape, generator=gen, device="cuda") if low is None
         else torch.rand(shape, generator=gen, device="cuda") * 1.5 + low)
    return v.to(torch.float8_e4m3fn)


def check_scaled_gemm_options(gen, dtypes: tuple = SCALED_DTYPES) -> None:
    """K8 against ``scaled_gemm_plain`` over every option it takes, for
    each of ``dtypes``: M in SCALED_OPTION_MS at K 96 / N 160 with every
    option of SCALED_OPTIONS (output f32 or bf16; scale_a one value or per
    row, 10x apart; scale_b one value or per column; a single weight or
    layer 1 of a stack with its scales; a's rows contiguous or with a row
    stride of K + 64 or K + 40), and at the served shapes with one option
    set each (cycling).

    int8: every output equal bit for bit (``torch.equal``: the sums are
    exact in int32 and both apply ``(float(v) * sa[m]) * sb[n]`` in f32,
    then round once); then w_down's shape (K 14336) at 8 and 32 rows with
    every value of a and b in 125..127: each split's partial sum (K split
    8 ways) exceeds 2^24, so a workspace that held them in f32 would lose
    bits.

    float8_e4m3fn: within E4M3_TOLERANCE x max |ref|, every case on the
    mainloop's fp8 layout (its launches counted); the stack has 3 layers,
    so that a slice read past K without zero-fill reads real values. Then
    w_down's shape at 8 and 32 rows with every value of a and b positive,
    f32 out, each output within E4M3_SAME_SIGN_TOLERANCE x |ref| (its
    largest relative error printed); then E4M3_LOOP_CASES, each on the loop
    kernel.

    Mismatches are counted on the card and read once; the case count is
    printed."""
    from conch_tpu_torch.kernels.quantization.gemm import scaled_gemm_launcher as launch, scaled_gemm_plain as plain

    names, same = [], []
    same_sign_err = []

    def run(dtype, m: int, k: int, n: int, options: list, low: float | None = None) -> None:
        fp8 = dtype == torch.float8_e4m3fn
        layers = 3 if fp8 else 2
        if fp8:
            w, a_wide = _e4m3((layers, k, n), gen, low), _e4m3((m, k + 64), gen, low)
        else:
            w = torch.randint(-127 if low is None else low, 128, (layers, k, n), generator=gen, device="cuda",
                              dtype=torch.int8)
        sb_stack = torch.rand((layers, n), generator=gen, device="cuda") * 1e-3 + 1e-4
        if not fp8:
            a_wide = torch.randint(-127 if low is None else low, 128, (m, k + 64), generator=gen, device="cuda",
                                   dtype=torch.int8)
        sa_row = 1e-3 * torch.logspace(0, 1, m, device="cuda")
        scalar = torch.tensor([2.5e-3], device="cuda")
        for out_dtype, sa_kind, sb_kind, weight, pad in options:
            a = a_wide[:, :k] if pad == 64 else torch.empty((m, k + pad), dtype=dtype, device="cuda")[:, :k]
            if pad != 64:
                a.copy_(a_wide[:, :k])
            sa = scalar if sa_kind == "scalar" else sa_row
            b, sb, layer = (w[1], sb_stack[1], None) if weight == "single" else (w, sb_stack, 1)
            if sb_kind == "scalar":
                sb = scalar
            before = launch.e4m3_launches
            out = launch(a, b, sa, sb, out_dtype, layer)
            ref = plain(a, b, sa, sb, out_dtype, layer)
            names.append(f"K8 {str(dtype)[6:]} M {m} K {k} N {n} out {str(out_dtype)[6:]} sa {sa_kind} sb {sb_kind} "
                         f"{weight} a stride {a.stride(0)}")
            if not fp8:
                same.append(torch.equal(out, ref))
                continue
            if launch.e4m3_launches != before + 1:
                raise AssertionError(f"{names[-1]}: not launched on the e4m3 mainloop")
            diff, mag = (out.float() - ref.float()).abs(), ref.float().abs()
            if low is None:
                same.append(diff.max() <= E4M3_TOLERANCE * mag.max())
            else:
                same.append((diff <= E4M3_SAME_SIGN_TOLERANCE * mag).all())
                same_sign_err.append((diff / mag).max())

    for dtype in dtypes:
        for m in SCALED_OPTION_MS:
            run(dtype, m, *SCALED_OPTION_SMALL, SCALED_OPTIONS)
        turn = itertools.cycle(SCALED_OPTIONS)
        for k, n in FUSED_LAYER_SHAPES:
            for m in SCALED_OPTION_MS:
                run(dtype, m, k, n, [next(turn)])
            torch.cuda.empty_cache()
        for m in (8, 32):
            run(dtype, m, INTER, HIDDEN, [(torch.float32, "row", "column", "stacked", 0)],
                low=125 if dtype == torch.int8 else 0.25)
        if dtype != torch.float8_e4m3fn:
            continue
        for m, k, n, offset in E4M3_LOOP_CASES:
            a = _e4m3((m, k), gen)
            b = torch.empty((k * n + offset,), dtype=dtype, device="cuda")[offset:].view(k, n)
            b.copy_(_e4m3((k, n), gen))
            sa, sb = 1e-3 * torch.logspace(0, 1, m, device="cuda"), torch.rand((n,), generator=gen, device="cuda")
            before = launch.e4m3_loop_launches
            out, ref = launch(a, b, sa, sb, torch.bfloat16), plain(a, b, sa, sb, torch.bfloat16)
            names.append(f"K8 float8_e4m3fn loop kernel M {m} K {k} N {n} b offset {offset}")
            if launch.e4m3_loop_launches != before + 1:
                raise AssertionError(f"{names[-1]}: not launched on the loop kernel")
            same.append((out.float() - ref.float()).abs().max() <= E4M3_TOLERANCE * ref.float().abs().max())
    # int8's flags are host bools; e4m3's stay on the card until here.
    on_card = [v for v in same if isinstance(v, torch.Tensor)]
    read = iter(torch.stack(on_card).tolist() if on_card else [])
    same_list = [v if isinstance(v, bool) else next(read) for v in same]
    if same_sign_err:
        worst = torch.stack(same_sign_err).tolist()
        print(f"K8 scaled_gemm float8_e4m3fn all-positive K {INTER}: max |out - ref| / |ref| "
              + ", ".join(f"{e:.3e}" for e in worst) + f" (tolerance {E4M3_SAME_SIGN_TOLERANCE:.0e})", flush=True)
    print(f"K8 scaled_gemm options: {len(names)} cases ({', '.join(str(d)[6:] for d in dtypes)}), "
          f"{sum(same_list)} equal to the plain version (int8 bit for bit, float8_e4m3fn within its tolerance)",
          flush=True)
    bad = [name for name, ok in zip(names, same_list) if not ok]
    for name in bad[:20]:
        print(f"{name}: differs from the plain version", flush=True)
    if bad:
        raise AssertionError(f"{len(bad)} of {len(names)} K8 option cases differ from the plain version")


def check_scaled_e4m3_options(gen) -> None:
    """K8's option sweep over float8_e4m3fn alone."""
    check_scaled_gemm_options(gen, (torch.float8_e4m3fn,))


GATE = (4096, 14336)  # Llama-3-8B's gate projection (K, N); its (N, K) weight is quantized


def _k12q_case(launch, plain, wt: torch.Tensor, blocksize: int, quant_type: str) -> None:
    """K12q against its plain version on one input, byte for byte."""
    got, ref = launch(wt, blocksize, quant_type), plain(wt, blocksize, quant_type)
    torch.cuda.synchronize()
    bad = int((got[0] != ref[0]).sum().item()) + int((got[1] != ref[1]).sum().item())
    name = f"K12q quantize4 {quant_type} blocksize {blocksize} {tuple(wt.shape)} {wt.dtype}"
    print(f"{name}: {bad} bytes or absmax differ (tolerance 0)", flush=True)
    if bad:
        raise AssertionError(f"{name}: {bad} outputs differ from the plain version")


def kernel_phase_k12q(gen) -> dict:
    """K12q (NF4 and FP4 encode, blocksize 64) on every (N, K) weight the
    nf4 init quantizes, transposed and rounded to bf16 as ``nf4_from_dense``
    hands it over, with an all-zero block; on the gate projection also at
    blocksize 4096 (the loop over a block read twice) and from f16; packed
    bytes and absmax held byte for byte against the plain version. The row
    times the gate projection at blocksize 64; ``detail`` also at 4096."""
    from conch_tpu_torch.kernels.quantization.bitsandbytes.blockwise import (
        quantize4_launcher as launch,
        quantize4_plain as plain,
    )

    detail = []
    for (k, n) in (*NF4_LAYER_SHAPES, LM_HEAD):
        wt = (0.02 * torch.randn((n, k), generator=gen, device="cuda")).to(torch.bfloat16)
        wt[3, :NF4_BLOCK] = 0.0  # an all-zero block: absmax 0, reciprocal 0
        for quant_type in ("nf4", "fp4") if (k, n) == GATE else ("nf4",):
            _k12q_case(launch, plain, wt, NF4_BLOCK, quant_type)
        if (k, n) == GATE:
            wt[5, :4096] = 0.0  # an all-zero block at 4096
            for quant_type in ("nf4", "fp4"):
                _k12q_case(launch, plain, wt, 4096, quant_type)
            for blocksize in (NF4_BLOCK, 4096):
                _k12q_case(launch, plain, wt.half(), blocksize, "nf4")
            size = n * k
            for blocksize in (NF4_BLOCK, 4096):
                bytes_moved = size * 2 + size // 2 + (size // blocksize) * 4
                b_ms, b_by = bound(bytes_moved, 18 * size, F32_OPS_PER_S)  # abs, max, scale, 15 compares
                detail.append({
                    "k": k, "n": n, "blocksize": blocksize, "max_abs_err": 0.0, "bound_ms": b_ms, "bound_by": b_by,
                    "ms": time_ms(lambda: launch(wt, blocksize, "nf4")),
                    "paced_ms": paced_ms(lambda: launch(wt, blocksize, "nf4")),
                    "plain_ms": time_ms(lambda: plain(wt, blocksize, "nf4"), iters=3, warmup=1), "library_ms": None,
                })
        del wt
    for d in detail:
        print(f"quantize4 nf4 {d['n']} x {d['k']} blocksize {d['blocksize']}: {d['ms']:.4f} ms (paced "
              f"{d['paced_ms']:.4f}, plain {d['plain_ms']:.4f}, bound {d['bound_ms']:.5f} by {d['bound_by']})",
              flush=True)
    d = detail[0]
    row = _kernel_row(
        "quantize4", "conch_tpu_torch/csrc/quantize4.cu",
        "conch_tpu/kernels/quantization/bitsandbytes/blockwise.py:324", 0.0, d, d["bound_ms"], d["bound_by"],
    )
    row["detail"] = detail
    return row


def kernel_phase_k12d(gen) -> dict:
    """K12d (NF4 and FP4 decode) on Llama-3-8B's gate projection (14336 x
    4096, bf16, encoded by K12q with an all-zero block) at blocksize 64 and
    4096, into bf16, f32 and f16, held bit for bit against the plain
    version. The row times nf4 at blocksize 64 into bf16 (QLoRA's storage);
    ``detail`` every output dtype and blocksize 4096. No single PyTorch
    call decodes NF4, so no library time."""
    from conch_tpu_torch.kernels.quantization.bitsandbytes.blockwise import (
        dequantize4_launcher as launch,
        dequantize4_plain as plain,
        quantize4_launcher,
    )

    k, n = GATE
    wt = (0.02 * torch.randn((n, k), generator=gen, device="cuda")).to(torch.bfloat16)
    wt[3, :NF4_BLOCK] = 0.0
    size, detail = n * k, []
    for quant_type in ("nf4", "fp4"):
        for blocksize in (NF4_BLOCK, 4096):
            packed, absmax = quantize4_launcher(wt, blocksize, quant_type)
            for dtype in (torch.bfloat16, torch.float32, torch.float16):
                check_equal(f"K12d dequantize4 {quant_type} blocksize {blocksize} {n} x {k} into {dtype}",
                            launch(packed, absmax, blocksize, quant_type, dtype),
                            plain(packed, absmax, blocksize, quant_type, dtype))
                if quant_type == "nf4":
                    elem = torch.empty((), dtype=dtype).element_size()
                    b_ms, b_by = bound(size // 2 + (size // blocksize) * 4 + size * elem, size, F32_OPS_PER_S)
                    detail.append({
                        "case": f"nf4 blocksize {blocksize} into {dtype}", "max_abs_err": 0.0, "bound_ms": b_ms,
                        "bound_by": b_by,
                        "ms": time_ms(lambda: launch(packed, absmax, blocksize, quant_type, dtype)),
                        "paced_ms": paced_ms(lambda: launch(packed, absmax, blocksize, quant_type, dtype)),
                        "plain_ms": time_ms(lambda: plain(packed, absmax, blocksize, quant_type, dtype), iters=3,
                                            warmup=1),
                        "library_ms": None,
                    })
            del packed, absmax
    del wt
    torch.cuda.empty_cache()
    for d in detail:
        print(f"K12d {d['case']}: {d['ms']:.4f} ms (paced {d['paced_ms']:.4f}, plain {d['plain_ms']:.4f}, bound "
              f"{d['bound_ms']:.5f} by {d['bound_by']})", flush=True)
    d = detail[0]
    row = _kernel_row(
        "dequantize4", "conch_tpu_torch/csrc/dequantize4.cu",
        "conch_tpu/kernels/quantization/bitsandbytes/blockwise.py:367", 0.0, d, d["bound_ms"], d["bound_by"],
    )
    row["detail"] = detail
    return row


# tests/rms_norm_test.py's tolerances (atol and rtol) for K4 and K4b
# against their plain versions: the two sum the squares in another order.
NORM_TOLERANCES = {torch.float32: 1e-5, torch.float16: 1e-3, torch.bfloat16: 2e-2}
K4B_CASES = ((8, torch.bfloat16), (2048, torch.bfloat16), (2048, torch.float32), (2048, torch.float16))


def kernel_phase_k4b(gen) -> dict:
    """K4b (fused residual add + RMS norm) at Llama-3-8B's hidden size: bf16
    at 8 and 2048 rows, f32 and f16 at 2048. ``out`` against the plain
    version at NORM_TOLERANCES, the sum ``x + r`` bit for bit. The row has
    the 2048-row bf16 numbers (a prefill chunk); no single PyTorch call
    computes both outputs, so no library time."""
    from conch_tpu_torch.kernels.normalization.rms_norm import (
        fused_add_rms_norm_launcher as launch,
        fused_add_rms_norm_plain as plain,
    )

    eps = 1e-5
    err, detail = 0.0, []
    for rows, dtype in K4B_CASES:
        x, r = (torch.randn((rows, HIDDEN), generator=gen, device="cuda").to(dtype) for _ in range(2))
        w = (1.0 + 0.1 * torch.randn((HIDDEN,), generator=gen, device="cuda")).to(dtype)
        (out, res), (ref_out, ref_res) = launch(x, r, w, eps), plain(x, r, w, eps)
        torch.cuda.synchronize()
        name = f"K4b fused_add_rms_norm rows={rows} {dtype}"
        check_equal(f"{name} x + r", res, ref_res)
        e = check_close(name, out, ref_out, NORM_TOLERANCES[dtype])
        err = max(err, e)
        if rows == 2048:
            b_ms, b_by = bound(4 * rows * HIDDEN * x.element_size() + HIDDEN * w.element_size(), 6 * rows * HIDDEN,
                               F32_OPS_PER_S)
            detail.append({
                "case": f"{rows}x{HIDDEN} {dtype}", "max_abs_err": e, "bound_ms": b_ms, "bound_by": b_by,
                "ms": time_ms(lambda: launch(x, r, w, eps)), "paced_ms": paced_ms(lambda: launch(x, r, w, eps)),
                "plain_ms": time_ms(lambda: plain(x, r, w, eps)), "library_ms": None,
            })
    for d in detail:
        print(f"K4b {d['case']}: {d['ms']:.4f} ms (paced {d['paced_ms']:.4f}, plain {d['plain_ms']:.4f}, bound "
              f"{d['bound_ms']:.5f} by {d['bound_by']})", flush=True)
    row = _kernel_row(
        "fused_add_rms_norm", "conch_tpu_torch/csrc/rms_norm.cu", "conch_tpu/kernels/normalization/rms_norm.py:42",
        err, detail[0], detail[0]["bound_ms"], detail[0]["bound_by"],
    )
    row["detail"] = detail
    return row


# K4's timed steps: Llama-3-8B's decode step of 8 rows (the row's
# numbers), the quantized engines' step padded to 32, a 512-row prefill chunk.
K4_ROWS = (8, 32, 512)


def kernel_phase_k4(gen) -> dict:
    """K4 at K4_ROWS x 4096 in f32, f16 and bf16, bit for bit against its
    plain version; the bf16 steps timed beside their bound, plain version
    and ``F.rms_norm`` (``detail``). The row has the 8-row numbers."""
    from conch_tpu_torch.kernels.normalization.rms_norm import rms_norm_launcher as launch, rms_norm_plain as plain

    eps = 1e-5
    lib = getattr(torch.nn.functional, "rms_norm", None)
    detail = []
    for rows in K4_ROWS:
        for dtype in (torch.float32, torch.float16, torch.bfloat16):
            w = (1.0 + 0.1 * torch.randn((HIDDEN,), generator=gen, device="cuda")).to(dtype)
            x = torch.randn((rows, HIDDEN), generator=gen, device="cuda").to(dtype)
            check_equal(f"K4 rms_norm rows={rows} {dtype}", launch(x, w, eps), plain(x, w, eps))
        b_ms, b_by = bound(2 * rows * HIDDEN * 2 + HIDDEN * 2, 4 * rows * HIDDEN)
        detail.append({
            "rows": rows, "max_abs_err": 0.0, "bound_ms": b_ms, "bound_by": b_by,
            "ms": time_ms(lambda: launch(x, w, eps)),
            "paced_ms": paced_ms(lambda: launch(x, w, eps)),
            "plain_ms": time_ms(lambda: plain(x, w, eps)),
            "library_ms": time_ms(lambda: lib(x, (HIDDEN,), w, eps)) if lib else None,
        })
    for d in detail:
        print(f"K4 rows={d['rows']}: {d['ms']:.4f} ms (paced {d['paced_ms']:.4f}, plain {d['plain_ms']:.4f}, "
              f"F.rms_norm {d['library_ms']}, bound {d['bound_ms']:.6f} by {d['bound_by']})", flush=True)
    row = _kernel_row(
        "rms_norm", "conch_tpu_torch/csrc/rms_norm.cu", "conch_tpu/kernels/normalization/rms_norm.py:34", 0.0,
        detail[0], detail[0]["bound_ms"], detail[0]["bound_by"],
    )
    row["detail"] = detail
    return row


# tests/activation_test.py's tolerances (atol and rtol) for K6 and K10b.
GATED_TOLERANCES = {torch.float32: 1e-6, torch.bfloat16: 1e-2, torch.float16: 1e-3}
# K6's timed steps: Llama-3-8B's decode step of 8 rows (the row's numbers),
# the quantized engines' step padded to 32, a 512-row prefill chunk.
K6_ROWS = (8, 32, 512)


def gated_act_phase(gen, kernel: str, d: int, timed_rows: tuple[int, ...], gain: float, launchers: tuple) -> list[dict]:
    """K6 or K10b (``kernel``) at ``timed_rows`` x 2d in f32, f16 and bf16:
    the fused halves and the row-strided parts of one input (N(0, gain^2))
    against the plain versions at GATED_TOLERANCES. Every bf16 step is timed
    beside its bound and plain version, f32 and f16 at the first; no single
    PyTorch call computes the function, so no library time. Returns the
    timed steps (``detail``); the first is the row's."""
    launch, launch_parts, plain, plain_parts = launchers
    detail = []
    for rows in timed_rows:
        for dtype in (torch.float32, torch.float16, torch.bfloat16):
            tol = GATED_TOLERANCES[dtype]
            x = (gain * torch.randn((rows, 2 * d), generator=gen, device="cuda")).to(dtype)
            gate, up = x[:, :d], x[:, d:]
            err = max(check_close(f"{kernel} halves rows={rows} {dtype}", launch(x), plain(x), tol),
                      check_close(f"{kernel} parts rows={rows} {dtype}", launch_parts(gate, up),
                                  plain_parts(gate, up), tol))
            if dtype == torch.bfloat16 or rows == timed_rows[0]:
                b_ms, b_by = bound(3 * rows * d * x.element_size(), 10 * rows * d, F32_OPS_PER_S)
                detail.append({
                    "rows": rows, "dtype": str(dtype).removeprefix("torch."), "max_abs_err": err, "bound_ms": b_ms,
                    "bound_by": b_by, "ms": time_ms(lambda: launch(x)), "paced_ms": paced_ms(lambda: launch(x)),
                    "plain_ms": time_ms(lambda: plain(x)), "library_ms": None,
                })
    for t in detail:
        print(f"{kernel} halves rows={t['rows']} {t['dtype']}: {t['ms']:.4f} ms (paced {t['paced_ms']:.4f}, plain "
              f"{t['plain_ms']:.4f}, bound {t['bound_ms']:.6f} by {t['bound_by']})", flush=True)
    return sorted(detail, key=lambda t: (t["dtype"] != "bfloat16", t["rows"]))


def _gated_row(name: str, source: str, replaces: str, detail: list[dict]) -> dict:
    row = _kernel_row(name, source, replaces, max(t["max_abs_err"] for t in detail), detail[0], detail[0]["bound_ms"],
                      detail[0]["bound_by"])
    row["detail"] = detail
    return row


def kernel_phase_k6(gen) -> dict:
    """K6 (``gated_act_phase``) at K6_ROWS x 2*14336; the row has the 8-row
    bf16 halves (decode) numbers."""
    from conch_tpu_torch.kernels.activation import silu_and_mul as k6

    launchers = (k6.silu_and_mul_launcher, k6.silu_and_mul_parts_launcher, k6.silu_and_mul_plain,
                 k6.silu_and_mul_parts_plain)
    return _gated_row("silu_and_mul", "conch_tpu_torch/csrc/silu_and_mul.cu",
                      "conch_tpu/kernels/activation/silu_and_mul.py:27",
                      gated_act_phase(gen, "K6 silu_and_mul", INTER, K6_ROWS, 3.0, launchers))


# Gemma-2-2B (GemmaConfig.gemma2_2b()): hidden 2304, intermediate 9216, 8
# query heads over 4 KV heads of 256, 26 layers, softcap 50 on the
# attention logits, scale 256 ** -0.5, a 4096-token window on even layers.
G_QH, G_KH, G_D, G_LAYERS = 8, 4, 256, 26
G_HIDDEN, G_INTER = 2304, 9216
G_SOFTCAP, G_WINDOW, G_SCALE = 50.0, 4096, 256.0**-0.5
G_Q_GAIN = 12.0  # query scale in the K3/K7 checks, so the logits reach the softcap

# K3's timed decode steps, each on a pool and block table of its own:
# name -> (model, rows, table pages, row -> context (other rows idle),
# (source row, reading row, shared pages), windows). The kernel table's
# lines: Llama-3-8B's decode batch of 8 and Gemma-2-2B's, each with an idle
# row, lengths off page multiples and a shared prefix, Gemma's past the
# window. The served steps: the int4 Llama engine (the README example,
# max_batch_size 32) decodes 32 rows, 8 of them live at contexts 40 to 932
# (prompts of 40 to 900 plus 32 generated tokens), over its 64-page table;
# the Gemma-2-2B engine (max_batch_size 16) 16 rows, 8 live at 4200 to
# 6000, over a 384-page table (the served engine's 320 pages stop at 5120
# tokens).
K3_SERVED_LLAMA = dict(zip((0, 3, 4, 9, 15, 20, 26, 31), (40, 131, 262, 395, 540, 690, 812, 932)))
K3_SERVED_GEMMA = dict(zip((0, 2, 3, 6, 8, 11, 13, 15), (4200, 4457, 4713, 4970, 5228, 5485, 5742, 6000)))
K3_CASES = {
    "llama3_8b table line": ("llama", 8, MAX_PAGES_PER_SEQ, dict(enumerate([0, 1, 17, 64, 200, 333, 511, 540])),
                             (4, 5, 4), (0,)),
    "gemma2 table line": ("gemma", 8, 384, dict(enumerate([4600, 1, 17, 0, 300, 4096, 4097, 6000])), (0, 5, 8),
                          (0, G_WINDOW)),
    "llama3_8b int4 served decode": ("llama", 32, 64, K3_SERVED_LLAMA, (0, 0, 0), (0,)),
    "gemma2 served decode": ("gemma", 16, 384, K3_SERVED_GEMMA, (0, 0, 0), (0, G_WINDOW)),
}


def k3_inputs(gen, rng, name: str, cache: str | None = None) -> dict:
    """K3_CASES[name] on the card: ``args``, the launcher's arguments up to
    the window (query, pools, block table, seq_lens, scale, layer 17,
    softcap); ``windows``, ``seq_lens``, ``bt`` (the table in numpy),
    ``idle`` (rows of length 0) and ``shape`` (QH, KH, D). Llama-3-8B: 32
    query heads over 8 KV heads of 128, a 32-layer pool, scale D^-0.5,
    queries N(0, 1). Gemma-2-2B: 8 over 4 of 256, 26 layers, softcap 50,
    scale 1/16, queries N(0, G_Q_GAIN^2). Pools are bf16, or int8 / e4m3
    (``cache``) through the quantizing store."""
    model, rows, max_pages, lens, (src, dst, shared), windows = K3_CASES[name]
    qh, kh, d, layers, softcap, scale, gain = {
        "llama": (QH, KH, D, NUM_LAYERS_POOL, 0.0, D**-0.5, 1.0),
        "gemma": (G_QH, G_KH, G_D, G_LAYERS, G_SOFTCAP, G_SCALE, G_Q_GAIN),
    }[model]
    seq_lens = [lens.get(i, 0) for i in range(rows)]
    num_pages = sum(-(-n // PS) for n in seq_lens) + 1
    kc, vc = kv_pools(gen, num_pages, layers, kh, d, cache)
    bt = paged_layout(rng, seq_lens, num_pages, share=(src, dst), shared_pages=shared, max_pages=max_pages)
    q = (gain * torch.randn((rows, qh, d), generator=gen, device="cuda")).to(torch.bfloat16)
    sl_t = torch.tensor(seq_lens, dtype=torch.int32, device="cuda")
    return {
        "args": (q, kc, vc, torch.from_numpy(bt).cuda(), sl_t, scale, LAYER, softcap), "windows": windows,
        "seq_lens": seq_lens, "bt": bt, "idle": [i for i, n in enumerate(seq_lens) if n == 0], "shape": (qh, kh, d),
    }


def k3_bound(case: dict, window: int) -> tuple[float, str]:
    """K3's bound on ``case`` (k3_inputs) under ``window``: the query read
    and the output written in its dtype, each visible cached K and V row
    read once (shared pages once), the table entries of the visible pages
    and seq_lens; 4 * QH * D operations a visible token."""
    qh, kh, d = case["shape"]
    seq_lens, kc, q = case["seq_lens"], case["args"][1], case["args"][0]
    starts = [max(n - window, 0) if window else 0 for n in seq_lens]
    pages = sum(-(-n // PS) - a // PS for n, a in zip(seq_lens, starts) if n > a)
    bytes_moved = (2 * q.numel() * q.element_size() + 2 * unique_kv_rows(case["bt"], seq_lens, starts) * kh * d
                   * kc.element_size() + pages * 4 + len(seq_lens) * 4)
    return bound(bytes_moved, 4 * qh * d * sum(n - a for n, a in zip(seq_lens, starts)))


# The verify step of the speculative engine (K7 V, K11 V, check_verify_logits):
# 8 sequences, each its last token and 4 drafted ones, at about 1024 tokens
# of context; the engine pads its rows to _bucket(40) = 64 and max_seqlen_q
# to _bucket(5) = 16.
VERIFY_SEQS, VERIFY_Q, VERIFY_ROWS, VERIFY_MAX_Q = 8, 5, 64, 16
VERIFY_SEQ_LENS = [995 + 3 * i for i in range(VERIFY_SEQS)]
# K7's timed prefill steps: name -> (model, rows, table pages, q_lens,
# seq_lens, (source, reading sequence, shared pages), windows). Llama-3-8B:
# a 128-row step as the engine packs it: a mixed-in decode row (context
# 300), a fresh 50-token prompt, the last 40-token chunk of a 340-token
# prompt, a 30-token chunk whose first 4 pages are shared with that prompt,
# then zero-length padding sequences and 7 padding rows. Gemma-2-2B: a
# 512-row step: a mixed-in decode row at context 4200, a 7-token prompt,
# the last 400-token chunk of a 4600-token prompt, zero-length padding
# sequences (16 in all, the served run's batch) and 104 padding rows, on a
# global layer (no window) and a local one (window 4096).
K7_CASES = {
    "llama3_8b table line": ("llama", 128, MAX_PAGES_PER_SEQ, [1, 50, 40, 30, 0, 0, 0, 0],
                             [300, 50, 340, 94, 0, 0, 0, 0], (2, 3, 4), (0,)),
    "gemma2 table line": ("gemma", 512, 384, [1, 7, 400] + [0] * 13, [4200, 7, 4600] + [0] * 13, (0, 0, 0),
                          (0, G_WINDOW)),
    # The speculative verify step (K7 V): 8 sequences of 1 + 4 drafted rows
    # at contexts of 990 to 1011 (seq_lens 995 to 1016), 40 rows padded to
    # the engine's bucket of 64.
    "llama3_8b verify": ("llama", 64, MAX_PAGES_PER_SEQ, [VERIFY_Q] * VERIFY_SEQS, VERIFY_SEQ_LENS, (0, 0, 0), (0,)),
}


def k7_inputs(gen, rng, name: str, cache: str | None = None) -> dict:
    """K7_CASES[name] on the card: ``args``, the launcher's arguments up to
    the window (query, pools, cu_seqlens_q, seq_lens, block table, scale,
    causal, layer 17, softcap); ``windows``, ``q_lens``, ``seq_lens``,
    ``bt`` (the table in numpy), ``total`` (rows before the padding) and
    ``shape`` (QH, KH, D). Shapes, scales and query gains as ``k3_inputs``;
    pools bf16, or int8 / e4m3 (``cache``) through the quantizing store."""
    model, rows, max_pages, q_lens, seq_lens, (src, dst, shared), windows = K7_CASES[name]
    qh, kh, d, layers, softcap, scale, gain = {
        "llama": (QH, KH, D, NUM_LAYERS_POOL, 0.0, D**-0.5, 1.0),
        "gemma": (G_QH, G_KH, G_D, G_LAYERS, G_SOFTCAP, G_SCALE, G_Q_GAIN),
    }[model]
    num_pages = sum(-(-n // PS) for n in seq_lens) + 1
    kc, vc = kv_pools(gen, num_pages, layers, kh, d, cache)
    bt = paged_layout(rng, seq_lens, num_pages, share=(src, dst), shared_pages=shared, max_pages=max_pages)
    q = (gain * torch.randn((rows, qh, d), generator=gen, device="cuda")).to(torch.bfloat16)
    cu = torch.tensor(np.concatenate([[0], np.cumsum(q_lens)]), dtype=torch.int32, device="cuda")
    sl_t = torch.tensor(seq_lens, dtype=torch.int32, device="cuda")
    return {
        "args": (q, kc, vc, cu, sl_t, torch.from_numpy(bt).cuda(), scale, True, LAYER, softcap), "windows": windows,
        "q_lens": q_lens, "seq_lens": seq_lens, "bt": bt, "total": sum(q_lens), "shape": (qh, kh, d),
    }


def k7_bound(case: dict, window: int, ops_per_s: float = BF16_OPS_PER_S) -> tuple[float, str]:
    """K7's bound on ``case`` (k7_inputs) under ``window``: the live query
    rows read and every row written in the query's dtype, each cached K and
    V row that a row sees read once (shared pages once; a sequence's first
    row has the earliest window start), the block table, cu_seqlens_q and
    seq_lens; 4 * QH * D operations a visible (row, key) pair, at
    ``ops_per_s``."""
    qh, kh, d = case["shape"]
    q_lens, seq_lens, bt, kc = case["q_lens"], case["seq_lens"], case["bt"], case["args"][1]
    rows, q_bytes = case["args"][0].shape[0], case["args"][0].element_size()
    row_pos = [s - ql + j for ql, s in zip(q_lens, seq_lens) for j in range(ql)]
    row_start = [max(p - window + 1, 0) if window else 0 for p in row_pos]
    starts = [max(s - ql - window + 1, 0) if window else 0 for ql, s in zip(q_lens, seq_lens)]
    bytes_moved = ((case["total"] + rows) * qh * d * q_bytes + 2 * unique_kv_rows(bt, seq_lens, starts) * kh * d
                   * kc.element_size() + bt.size * 4 + (len(q_lens) + 1 + len(seq_lens)) * 4)
    return bound(bytes_moved, 4 * qh * d * sum(p + 1 - a for p, a in zip(row_pos, row_start)), ops_per_s)


# tests/gemma_rms_norm_test.py's tolerances (atol and rtol) for K10a.
GEMMA_NORM_TOLERANCES = {torch.float32: 1e-5, torch.bfloat16: 1e-2, torch.float16: 1e-3}
# K10a's timed steps: the kernel table's 8 rows (the row's numbers),
# Gemma-2-2B's served decode step (16) and a 512-row prefill chunk.
K10A_ROWS = (8, 16, 512)


def kernel_phase_k10a(gen) -> dict:
    """K10a at K10A_ROWS x 2304 in f32, f16 and bf16 (timed), weights
    random (so a kernel that dropped the (1 + w) would fail), at
    GEMMA_NORM_TOLERANCES; each step timed beside its bound, plain version
    and ``F.rms_norm`` with the weight 1 + w (``detail``). The row has the
    8-row numbers."""
    from conch_tpu_torch.kernels.normalization.gemma_rms_norm import (
        gemma_rms_norm_launcher as launch,
        gemma_rms_norm_plain as plain,
    )

    eps = 1e-6
    lib = getattr(torch.nn.functional, "rms_norm", None)
    err, detail = 0.0, []
    for rows in K10A_ROWS:
        for dtype in (torch.float32, torch.float16, torch.bfloat16):
            w = (0.5 * torch.randn((G_HIDDEN,), generator=gen, device="cuda")).to(dtype)
            x = torch.randn((rows, G_HIDDEN), generator=gen, device="cuda").to(dtype)
            got, ref = launch(x, w, eps), plain(x, w, eps)
            err = max(err, check_close(f"K10a gemma_rms_norm rows={rows} {dtype}", got, ref,
                                       GEMMA_NORM_TOLERANCES[dtype]))
        # One library call computes the same function given the weight 1 + w.
        w1 = (1.0 + w.float()).to(torch.bfloat16)
        b_ms, b_by = bound(2 * rows * G_HIDDEN * 2 + G_HIDDEN * 2, 5 * rows * G_HIDDEN)
        detail.append({
            "rows": rows, "bound_ms": b_ms, "bound_by": b_by,
            "ms": time_ms(lambda: launch(x, w, eps)),
            "paced_ms": paced_ms(lambda: launch(x, w, eps)),
            "plain_ms": time_ms(lambda: plain(x, w, eps)),
            "library_ms": time_ms(lambda: lib(x, (G_HIDDEN,), w1, eps)) if lib else None,
        })
    for d in detail:
        print(f"K10a rows={d['rows']}: {d['ms']:.4f} ms (paced {d['paced_ms']:.4f}, plain {d['plain_ms']:.4f}, "
              f"F.rms_norm(1+w) {d['library_ms']}, bound {d['bound_ms']:.6f} by {d['bound_by']})", flush=True)
    row = _kernel_row(
        "gemma_rms_norm", "conch_tpu_torch/csrc/gemma_rms_norm.cu",
        "conch_tpu/kernels/normalization/gemma_rms_norm.py:26", err, detail[0], detail[0]["bound_ms"],
        detail[0]["bound_by"],
    )
    row["detail"] = detail
    return row


# K10a's options (check_gemma_rms_norm_options): rows, widths (JAX's 128,
# 531 and 3072, Gemma-2-2B's 2304 and 2048, Gemma-2-9B's 3584, 27B's 4608,
# and 36872, past the register path in every dtype: the looped path) and
# layouts (contiguous; rows at a stride 64 elements longer; rows one
# element longer; contiguous rows from a base one element off).
NORM_OPTION_ROWS = (0, 1, 3, 8, 16, 512, 4096)
NORM_OPTION_HIDDEN = (128, 531, 2048, 2304, 3072, 3584, 4608, 36872)
NORM_OPTION_LAYOUTS = ("contiguous", "strided", "misaligned rows", "misaligned base")


def check_gemma_rms_norm_options(gen) -> None:
    """K10a over every option it takes (NORM_OPTION_*, f32, bf16 and f16,
    random weights, the programmatic-dependent launch on every other case)
    against the plain version at GEMMA_NORM_TOLERANCES; counts the cases on
    each path of ``row_norm_plan``."""
    from conch_tpu_torch.kernels.common import aligned16
    from conch_tpu_torch.kernels.normalization.gemma_rms_norm import (
        gemma_rms_norm_launcher as launch,
        gemma_rms_norm_plain as plain,
    )
    from conch_tpu_torch.kernels.normalization.row_norm import row_norm_plan

    eps = 1e-6
    saved, failed, paths, cases, err = launch.pdl, [], {}, 0, {}
    try:
        for hidden, dtype in itertools.product(NORM_OPTION_HIDDEN, GEMMA_NORM_TOLERANCES):
            tol = GEMMA_NORM_TOLERANCES[dtype]
            w = (0.5 * torch.randn((hidden,), generator=gen, device="cuda")).to(dtype)
            for rows, layout in itertools.product(NORM_OPTION_ROWS, NORM_OPTION_LAYOUTS):
                x = _flat_rows(gen, rows, hidden, dtype, layout, hidden + 64 if layout == "strided" else None)
                plan = row_norm_plan(rows, hidden, x.element_size(), x.stride(0), aligned16(x))
                paths[plan.path] = paths.get(plan.path, 0) + 1
                launch.pdl = cases % 2 == 1
                got, ref = launch(x, w, eps), plain(x, w, eps)
                cases += 1
                name = f"{dtype} rows {rows} hidden {hidden} {layout}"
                if got.shape != ref.shape or not got.is_contiguous():
                    failed.append(f"{name}: shape {tuple(got.shape)}")
                elif rows:
                    diff = (got.float() - ref.float()).abs()
                    err[dtype] = max(err.get(dtype, 0.0), diff.max().item())
                    if not bool((diff <= tol + tol * ref.float().abs()).all()):
                        failed.append(f"{name}: max_abs_err {diff.max().item():.3e}")
                del x, got, ref
    finally:
        launch.pdl = saved
    torch.cuda.synchronize()
    names = {0: "vector", 1: "scalar", 2: "looped vector", 3: "looped scalar"}
    print(f"K10a options: {cases} cases (" + ", ".join(f"{names[k]} {v}" for k, v in sorted(paths.items()))
          + "); max_abs_err " + ", ".join(
              f"{dt} {e:.3e} (tolerance {GEMMA_NORM_TOLERANCES[dt]:.0e} + {GEMMA_NORM_TOLERANCES[dt]:.0e} * |ref|)"
              for dt, e in err.items()), flush=True)
    if failed:
        raise AssertionError(f"K10a options: {len(failed)} of {cases} cases failed: " + "; ".join(failed[:10]))
    torch.cuda.empty_cache()


# K4's options (check_rms_norm_options): rows around one block a row and
# the spread limit (131 to 133), the served steps, past them; widths (JAX's
# 128 and 531, Gemma-2-2B's 2304, Llama-3-8B's 4096, Llama-2-13B's 5120,
# 8192: looped in scalars, 16384: looped in f32 vectors; Qwen2-7B's 3584);
# NORM_OPTION_LAYOUTS.
RMS_OPTION_ROWS = (0, 1, 3, 8, 32, 131, 133, 512, 540)
RMS_OPTION_HIDDEN = (128, 531, 2304, 4096, 5120, 8192, 16384, 3584)


def check_rms_norm_options(gen) -> None:
    """K4 over every option it takes (RMS_OPTION_*, NORM_OPTION_LAYOUTS, f32,
    bf16 and f16, random weights, the programmatic-dependent launch on every
    other case) against the plain version bit for bit; counts the cases on
    each path of ``row_norm_plan``."""
    from conch_tpu_torch.kernels.common import aligned16
    from conch_tpu_torch.kernels.normalization.rms_norm import rms_norm_launcher as launch, rms_norm_plain as plain
    from conch_tpu_torch.kernels.normalization.row_norm import row_norm_plan

    eps = 1e-5
    saved, failed, paths, cases = launch.pdl, [], {}, 0
    try:
        for hidden, dtype in itertools.product(RMS_OPTION_HIDDEN, (torch.float32, torch.bfloat16, torch.float16)):
            w = (1.0 + 0.5 * torch.randn((hidden,), generator=gen, device="cuda")).to(dtype)
            for rows, layout in itertools.product(RMS_OPTION_ROWS, NORM_OPTION_LAYOUTS):
                x = _flat_rows(gen, rows, hidden, dtype, layout, hidden + 64 if layout == "strided" else None)
                plan = row_norm_plan(rows, hidden, x.element_size(), x.stride(0), aligned16(x))
                paths[plan.path] = paths.get(plan.path, 0) + 1
                launch.pdl = cases % 2 == 1
                got, ref = launch(x, w, eps), plain(x, w, eps)
                cases += 1
                if got.shape != ref.shape or not got.is_contiguous() or not torch.equal(
                        got.view(torch.uint8), ref.contiguous().view(torch.uint8)):
                    diff = (got.float() - ref.float()).abs().max().item() if rows and got.shape == ref.shape else None
                    failed.append(f"{dtype} rows {rows} hidden {hidden} {layout}: max_abs_err {diff}")
                del x, got, ref
    finally:
        launch.pdl = saved
    torch.cuda.synchronize()
    names = {0: "vector", 1: "scalar", 2: "looped vector", 3: "looped scalar"}
    print(f"K4 options: {cases} cases (" + ", ".join(f"{names[k]} {v}" for k, v in sorted(paths.items()))
          + f"), {cases - len(failed)} equal to the plain version bit for bit", flush=True)
    if failed:
        raise AssertionError(f"K4 options: {len(failed)} of {cases} cases differ: " + "; ".join(failed[:10]))
    torch.cuda.empty_cache()


# K2's options (check_cache_write_options): token counts (a third of the
# rows idle, tokens sharing pages), (KH, D) of Llama-3-8B, Gemma-2-2B, a
# single head of 64 and D 80, Qwen2-7B, page sizes, k / v layouts (contiguous; slices
# of a fused qkv block; fused rows one element longer; contiguous rows from
# a base one element off), every (key, cache) type pair K2 takes.
CACHE_OPTION_TOKENS = (1, 7, 8, 32, 130, 540)
CACHE_OPTION_HEADS = ((8, 128), (4, 256), (1, 64), (2, 80), (4, 128))
CACHE_OPTION_PAGE_SIZES = (16, 64)
CACHE_OPTION_LAYOUTS = ("contiguous", "fused", "misaligned rows", "misaligned base")
CACHE_OPTION_TYPES = (
    (torch.bfloat16, None), (torch.bfloat16, "int8"), (torch.bfloat16, "fp8"), (torch.float32, None),
    (torch.float32, "bf16"), (torch.float32, "int8"), (torch.float32, "fp8"),
)
CACHE_OPTION_LAYERS, CACHE_OPTION_LAYER = 3, 1


def _cache_option_rows(gen, tokens: int, kh: int, d: int, dtype: torch.dtype, layout: str):
    """k and v (tokens, KH, D) in ``dtype`` at 4 N(0, 1), every 37th element
    +-1000 (past every clip): contiguous rows, or the k and v slices of a
    fused (QH = 4 KH) block (``_flat_rows``' layouts)."""
    if layout in ("fused", "misaligned rows"):
        qkv = _flat_rows(gen, tokens, 6 * kh * d, dtype, "misaligned rows" if layout != "fused" else "contiguous")
        k, v = qkv[:, 4 * kh * d : 5 * kh * d], qkv[:, 5 * kh * d :]
    else:
        k, v = (_flat_rows(gen, tokens, kh * d, dtype, layout) for _ in range(2))
    for t in (k, v):
        t.mul_(4.0)
        t[:, ::37] = 1000.0
        t[:, 18::37] = -1000.0
    return k.view(tokens, kh, d), v.view(tokens, kh, d)


def check_cache_write_options(gen, rng) -> None:
    """K2 over every option it takes (CACHE_OPTION_*; the programmatic-
    dependent launch on every other case) into layer 1 of a 3-layer pool of
    random bytes, against the plain version byte for byte over the whole
    pool; counts the cases on each path of ``cache_write_plan``."""
    from conch_tpu_torch.kernels.cache.reshape_and_cache import (
        cache_write_plan,
        reshape_and_cache_stacked_launcher as launch,
        reshape_and_cache_stacked_plain as plain,
    )
    from conch_tpu_torch.kernels.common import aligned16

    cache_types = {None: None, "bf16": torch.bfloat16, **KV_CACHES}
    saved, failed, paths, cases = launch.pdl, [], {}, 0
    try:
        for (kh, d), ps, (dtype, cache) in itertools.product(CACHE_OPTION_HEADS, CACHE_OPTION_PAGE_SIZES,
                                                             CACHE_OPTION_TYPES):
            cache_dtype = cache_types[cache] or dtype
            scales = KV_SCALES.get(cache, (1.0, 1.0))
            num_pages = math.ceil((2 * max(CACHE_OPTION_TOKENS) + ps) / ps)
            shape = (CACHE_OPTION_LAYERS, num_pages, kh, ps, d)
            nbytes = math.prod(shape) * torch.empty((), dtype=cache_dtype).element_size()
            pools = [torch.randint(0, 256, (nbytes,), generator=gen, device="cuda", dtype=torch.uint8)
                     for _ in range(2)]
            for tokens, layout in itertools.product(CACHE_OPTION_TOKENS, CACHE_OPTION_LAYOUTS):
                k, v = _cache_option_rows(gen, tokens, kh, d, dtype, layout)
                slots = rng.choice(2 * tokens + ps, size=tokens, replace=False).astype(np.int32)
                slots[rng.random(tokens) < 1 / 3] = -1
                slot_t = torch.from_numpy(slots).cuda()
                kc, vc = (pool.clone().view(cache_dtype).view(shape) for pool in pools)
                kc_ref, vc_ref = (pool.clone().view(cache_dtype).view(shape) for pool in pools)
                plan = cache_write_plan(tokens, kh, d, k.element_size(), k.stride(0), v.stride(0),
                                        aligned16(k, v, kc, vc))
                paths[plan.path] = paths.get(plan.path, 0) + 1
                launch.pdl = cases % 2 == 1
                plain(k, v, kc_ref, vc_ref, slot_t, CACHE_OPTION_LAYER, *scales)
                launch(k, v, kc, vc, slot_t, CACHE_OPTION_LAYER, *scales)
                cases += 1
                differing = sum(int((a.view(torch.uint8) != b.view(torch.uint8)).sum())
                                for a, b in ((kc, kc_ref), (vc, vc_ref)))
                if differing:
                    failed.append(f"{dtype} into {cache_dtype} KH {kh} D {d} page {ps} tokens {tokens} {layout}: "
                                  f"{differing} bytes differ")
                del k, v, kc, vc, kc_ref, vc_ref
            del pools
    finally:
        launch.pdl = saved
    torch.cuda.synchronize()
    print(f"K2 options: {cases} cases (vector {paths.get(0, 0)}, scalar {paths.get(1, 0)}), "
          f"{cases - len(failed)} equal to the plain version byte for byte", flush=True)
    if failed:
        raise AssertionError(f"K2 options: {len(failed)} of {cases} cases differ: " + "; ".join(failed[:10]))
    torch.cuda.empty_cache()


# K10b's timed steps: the kernel table's 8 rows (the row's numbers),
# Gemma-2-2B's served decode step (16) and a 512-row prefill chunk.
K10B_ROWS = (8, 16, 512)


def kernel_phase_k10b(gen) -> dict:
    """K10b (``gated_act_phase``) at K10B_ROWS x 2*9216; the row has the
    8-row bf16 halves numbers."""
    from conch_tpu_torch.kernels.activation import gelu_tanh_and_mul as k10b

    launchers = (k10b.gelu_tanh_and_mul_launcher, k10b.gelu_tanh_and_mul_parts_launcher,
                 k10b.gelu_tanh_and_mul_plain, k10b.gelu_tanh_and_mul_parts_plain)
    return _gated_row("gelu_tanh_and_mul", "conch_tpu_torch/csrc/gelu_tanh_and_mul.cu",
                      "conch_tpu/kernels/activation/gelu_tanh_and_mul.py:31",
                      gated_act_phase(gen, "K10b gelu_tanh_and_mul", G_INTER, K10B_ROWS, 2.0, launchers))


# K6's and K10b's options (check_gated_act_options): widths (Llama-3-8B's
# 14336, Gemma-2-2B's 9216, DeepSeek-V2-Lite's 10944 and 2816, the JAX
# tests' 128, 4096 and 531, Qwen2-7B's 18944), rows, layouts (the fused halves of a (rows,
# 2d) input; row-strided parts sliced from one; separate contiguous parts;
# fused halves from a base one element off; fused rows one element longer).
GATED_OPTION_WIDTHS = (14336, 9216, 10944, 2816, 128, 4096, 531, 18944)
GATED_OPTION_ROWS = (0, 1, 7, 8, 16, 32, 512)
GATED_OPTION_LAYOUTS = ("halves", "strided parts", "parts", "misaligned base", "misaligned rows")


def _gated_option_call(gen, rows: int, d: int, dtype: torch.dtype, layout: str):
    """The (gate, up) of a layout and a call of a (halves, parts) launcher pair on them."""
    if layout == "parts":
        gate, up = (_flat_rows(gen, rows, d, dtype, "contiguous") for _ in range(2))
        gate *= 3.0
        return gate, up, lambda halves, parts: parts(gate, up)
    source = {"halves": "contiguous", "strided parts": "contiguous"}.get(layout, layout)
    x = _flat_rows(gen, rows, 2 * d, dtype, source)
    x[:, :d] *= 3.0
    gate, up = x[:, :d], x[:, d:]
    if layout == "strided parts":
        return gate, up, lambda halves, parts: parts(gate, up)
    return gate, up, lambda halves, parts: halves(x)


def check_gated_act_options(gen) -> None:
    """K6 and K10b over every option they take (GATED_OPTION_*, f32, bf16
    and f16, each case with and without the programmatic-dependent launch,
    out's memory filled with NaN before each call) against the plain
    versions at GATED_TOLERANCES, and bit for bit against the kernel's own
    rounding: its f32 activation of the gate (an f32 parts call with up 1),
    rounded to the dtype, times up, rounded. Counts the cases on each path
    of ``gated_act_plan`` and those equal to the plain version bit for bit."""
    from conch_tpu_torch.kernels.activation import gelu_tanh_and_mul as k10b, silu_and_mul as k6
    from conch_tpu_torch.kernels.activation.gated_act import gated_act_plan

    kernels = {
        "K6": (k6.silu_and_mul_launcher, k6.silu_and_mul_parts_launcher, k6.silu_and_mul_parts_plain),
        "K10b": (k10b.gelu_tanh_and_mul_launcher, k10b.gelu_tanh_and_mul_parts_launcher,
                 k10b.gelu_tanh_and_mul_parts_plain),
    }
    t0 = time.perf_counter()
    saved = {fn: fn.pdl for fns in kernels.values() for fn in fns[:2]}
    failed, paths, cases, exact, err = [], {}, 0, 0, {}
    try:
        for (label, (halves, parts, plain)), d, dtype in itertools.product(
                kernels.items(), GATED_OPTION_WIDTHS, GATED_TOLERANCES):
            tol = GATED_TOLERANCES[dtype]
            for rows, layout in itertools.product(GATED_OPTION_ROWS, GATED_OPTION_LAYOUTS):
                gate, up, call = _gated_option_call(gen, rows, d, dtype, layout)
                ref = plain(gate, up)
                act = parts(gate.float().contiguous(), torch.ones((rows, d), device="cuda"))
                own = (act.to(dtype).float() * up.float()).to(dtype)
                aligned = all(t.data_ptr() % 16 == 0 for t in (gate, up))
                plan = gated_act_plan(rows, d, gate.element_size(), gate.stride(0), up.stride(0), aligned)
                path = f"{plan.vec * gate.element_size()}-byte vectors" if plan.path == 0 else "scalars"
                for pdl in (False, True):
                    halves.pdl = parts.pdl = pdl
                    poison = torch.full((rows, d), float("nan"), dtype=dtype, device="cuda")
                    del poison
                    got = call(halves, parts)
                    name = f"{label} {dtype} d {d} rows {rows} {layout} pdl {pdl}"
                    cases += 1
                    paths[path] = paths.get(path, 0) + 1
                    if got.shape != ref.shape or got.dtype != dtype or not got.is_contiguous():
                        failed.append(f"{name}: shape {tuple(got.shape)} {got.dtype}")
                        continue
                    diff = (got.float() - ref.float()).abs()
                    e = diff.max().item() if rows else 0.0
                    err[dtype] = max(err.get(dtype, 0.0), e)
                    if not bool((diff <= tol + tol * ref.float().abs()).all()):
                        failed.append(f"{name}: max_abs_err {e:.3e}")
                    elif not torch.equal(got.view(torch.uint8), own.view(torch.uint8)):
                        failed.append(f"{name}: not the kernel's own rounding of its f32 activation")
                    exact += torch.equal(got.view(torch.uint8), ref.contiguous().view(torch.uint8))
                del gate, up, ref, act, own, got
    finally:
        for fn, pdl in saved.items():
            fn.pdl = pdl
    torch.cuda.synchronize()
    counted = ", ".join(f"{k} {v}" for k, v in sorted(paths.items()))
    print(f"K6 / K10b options: {cases} cases ({counted}), {exact} equal to the plain version bit for bit, in "
          f"{time.perf_counter() - t0:.1f} s; max_abs_err " + ", ".join(
              f"{dt} {e:.3e} (tolerance {GATED_TOLERANCES[dt]:.0e} + {GATED_TOLERANCES[dt]:.0e} * |ref|)"
              for dt, e in err.items()), flush=True)
    if failed:
        raise AssertionError(f"K6 / K10b options: {len(failed)} of {cases} cases failed: " + "; ".join(failed[:10]))
    torch.cuda.empty_cache()


def gemma_attention_phases(gen, rng, cache: str | None = None) -> dict[str, list[dict]]:
    """K3 and K7 at Gemma-2-2B's shapes (QH 8 / KH 4 / D 256, a 26-layer pool
    read at layer 17, softcap 50, scale 1/16), on a global layer (no window)
    and a local one (window 4096), with lengths past the window:
    - K3: a decode batch of 8 with lengths 1 to 6000 and an idle row that is
      not first (tolerance 3e-2, tests/paged_attention_test.py:21);
    - K7: a 512-row prefill step as the engine packs it: a mixed-in decode
      row at context 4200, a 7-token prompt, the last 400-token chunk of a
      4600-token prompt, zero-length padding sequences (16 in all, the
      served run's batch) and 104 padding rows (tolerance 2e-2,
      tests/varlen_attention_test.py:25).
    Queries are N(0, G_Q_GAIN^2), so the scaled logits have a standard
    deviation of about 12 and reach the cap: softcap 50 bends them by tens
    of percent, and the softmax is sharp enough that the rows come out of
    order 1, not averages near 0. Both kernels are held elementwise at
    ``tol + tol * |ref|``, as the JAX tests hold them. A kernel that drops
    the softcap, caps before the scale, or ignores the window fails these
    checks (``python3 -m conch_tpu_torch.tools.attention_mutants``).
    With ``cache`` ("int8", "fp8") the pool is quantized and read at
    KV_SCALES[cache]. Returns detail entries (timed, with bounds) for each
    kernel's row."""
    from conch_tpu_torch.kernels.attention.paged_attention import (
        paged_attention_launcher as k3_kv,
        paged_attention_plain as k3_plain_kv,
    )
    from conch_tpu_torch.kernels.attention.varlen_attention import (
        varlen_attention_launcher as k7_kv,
        varlen_attention_plain as k7_plain_kv,
    )

    dec = k3_inputs(gen, rng, "gemma2 table line", cache)
    pre = k7_inputs(gen, rng, "gemma2 table line", cache)
    k3, k3_plain, k7, k7_plain = (with_kv_scales(fn, cache) for fn in (k3_kv, k3_plain_kv, k7_kv, k7_plain_kv))
    out: dict[str, list[dict]] = {"paged_attention": [], "varlen_attention": []}
    for window in dec["windows"]:
        tag = f"gemma2 softcap {G_SOFTCAP:g} window {window}" + (f" {cache} cache" if cache else "")
        args = (*dec["args"], window)
        got, ref = k3(*args), k3_plain(*args)
        torch.cuda.synchronize()
        if not torch.isfinite(got).all() or got[dec["idle"]].abs().max().item() != 0.0:
            raise AssertionError(f"K3 ({tag}): the idle row must come out as finite zeros")
        err = check_close(f"K3 paged_attention {tag}", got, ref, 3e-2)
        b_ms, b_by = k3_bound(dec, window)
        out["paged_attention"].append({
            "case": tag, "max_abs_err": err, "bound_ms": b_ms, "bound_by": b_by,
            "ms": time_ms(lambda: k3(*args)), "paced_ms": paced_ms(lambda: k3(*args)),
            "plain_ms": time_ms(lambda: k3_plain(*args), iters=5), "library_ms": None,
        })

        args = (*pre["args"], window)
        got, ref = k7(*args), k7_plain(*args)
        torch.cuda.synchronize()
        if not torch.isfinite(got).all() or got[pre["total"]:].abs().max().item() != 0.0:
            raise AssertionError(f"K7 ({tag}): padding rows must come out as finite zeros")
        err = check_close(f"K7 varlen_attention {tag}", got, ref, 2e-2)
        b_ms, b_by = k7_bound(pre, window)
        out["varlen_attention"].append({
            "case": tag, "max_abs_err": err, "bound_ms": b_ms, "bound_by": b_by,
            "ms": time_ms(lambda: k7(*args)), "paced_ms": paced_ms(lambda: k7(*args)),
            "plain_ms": time_ms(lambda: k7_plain(*args), iters=5), "library_ms": None,
        })
    del pre, dec
    torch.cuda.empty_cache()
    for name, cases in out.items():
        for d in cases:
            print(f"{name} ({d['case']}): {d['ms']:.4f} ms (paced {d['paced_ms']:.4f}, plain {d['plain_ms']:.4f}, "
                  f"bound {d['bound_ms']:.5f} by {d['bound_by']})", flush=True)
    return out


def check_to_rms(name: str, out: torch.Tensor, ref: torch.Tensor, tol: float) -> float:
    """Hold ``out`` to ``ref`` elementwise at ``|out - ref| <= tol * (|ref| +
    rms)``, rms that of ref over the last dimension (one head of one row):
    a limit that follows the output's size, so that a flat softmax's small
    outputs are held as tightly as a peaked one's, and an idle row must be
    exactly zero. One ulp of bf16 is at most 2^-7 |ref|. Returns the max
    abs error."""
    ref32 = ref.float()
    limit = tol * (ref32.abs() + ref32.pow(2).mean(-1, keepdim=True).sqrt())
    diff = (out.float() - ref32).abs()
    err = diff.max().item()
    worst = (diff / limit.clamp_min(torch.finfo(torch.float32).tiny)).max().item() * tol
    print(f"{name}: max_abs_err {err:.3e}, worst |out - ref| / (|ref| + rms) {worst:.3e} (tolerance {tol:.0e})",
          flush=True)
    if not bool((diff <= limit).all()):
        msg = f"{name}: outside {tol} x (|ref| + rms) (max_abs_err {err}, worst ratio {worst})"
        raise AssertionError(msg)
    return err


def kernel_phase_k3_served(gen, rng) -> list[dict]:
    """K3 at the served decode steps of K3_CASES (Gemma without and with
    the 4096 window), against the plain version at 1e-2 x (|ref| + the
    head's rms) (``check_to_rms``: Llama's N(0, 1) queries give a nearly
    flat softmax over hundreds of tokens, outputs near 0.05, which the
    table lines' 3e-2 + 3e-2 x |ref| would hold too loosely), idle rows
    exactly zero; timed. Returns detail entries of K3's row."""
    from conch_tpu_torch.kernels.attention.paged_attention import (
        paged_attention_launcher as launch,
        paged_attention_plain as plain,
    )

    cases = []
    for label in ("llama3_8b int4 served decode", "gemma2 served decode"):
        case = k3_inputs(gen, rng, label)
        live = len(case["seq_lens"]) - len(case["idle"])
        for window in case["windows"]:
            tag = f"{label}, {live} of {len(case['seq_lens'])} rows live, window {window}"
            args = (*case["args"], window)
            got, ref = launch(*args), plain(*args)
            torch.cuda.synchronize()
            if not torch.isfinite(got).all() or got[case["idle"]].abs().max().item() != 0.0:
                raise AssertionError(f"K3 ({tag}): idle rows must come out as finite zeros")
            err = check_to_rms(f"K3 paged_attention {tag}", got, ref, 1e-2)
            b_ms, b_by = k3_bound(case, window)
            entry = {
                "case": tag, "max_abs_err": err, "bound_ms": b_ms, "bound_by": b_by,
                "ms": time_ms(lambda: launch(*args)), "paced_ms": paced_ms(lambda: launch(*args)),
                "plain_ms": time_ms(lambda: plain(*args), iters=3, warmup=1), "library_ms": None,
            }
            print(f"paged_attention ({tag}): {entry['ms']:.4f} ms (paced {entry['paced_ms']:.4f}, plain "
                  f"{entry['plain_ms']:.4f}, bound {b_ms:.5f} by {b_by})", flush=True)
            cases.append(entry)
        del case
        torch.cuda.empty_cache()
    return cases


# DeepSeek-V2-Lite (DeepseekV2Config.v2_lite()): 16 heads, packed latent
# rows of 640 (c_kv 512 | k_pe 64 | pad 64), 27 layers, softmax scale
# 1 / sqrt(128 + 64).
DS_HEADS, DS_PACKED, DS_LATENT, DS_ROPE, DS_LAYERS = 16, 640, 512, 64, 27
DS_LAYER = 13  # a non-zero layer inside the 27-layer pool
DS_SCALE = 1.0 / math.sqrt(192)
# K11 against its plain version: f32 at tests/mla_attention_test.py:83's
# 2e-4; bf16 at the port's K3/K7 attention tolerance, 3e-2 + 3e-2 x |ref|.
K11_TOLERANCES = {torch.float32: 2e-4, torch.bfloat16: 3e-2}


def k11_inputs(gen, rng, cache: str | None = None) -> dict:
    """K11's cases at DeepSeek-V2-Lite's shapes over a 27-layer latent pool
    read at layer 13 (``kernel_phase_k11``'s, and the tools'):
    - "decode": a decode step of batch 8 at lengths 0 (an idle row, first)
      to 4000;
    - "prefill": a 512-row prefill step as the engine packs it: a mixed-in
      decode row at context 1500, a fresh 200-token prompt, a 150-token
      chunk at context 1800, a 100-token chunk at context 164 whose first 4
      pages are another sequence's, 12 zero-length padding sequences (16 in
      all, the served run's batch) and 61 padding rows.
    Queries and rows have zero pad columns, as the model writes them. With
    ``cache`` ("int8", "fp8") the latent pool is quantized at kv_scale
    KV_SCALES[cache][0]. ``cases`` maps a case to (queries in f32, cu_seqlens_q,
    max_seqlen_q, seq_lens, block table)."""
    max_pages = 256
    dec_lens = [0, 1, 17, 300, 1000, 2047, 3000, 4000]
    pre_q = [1, 200, 150, 100] + [0] * 12
    pre_k = [1500, 200, 1800, 164] + [0] * 12
    rows = 512
    num_pages = sum(-(-n // PS) for n in dec_lens + pre_k) + 1
    bt_all = paged_layout(rng, dec_lens + pre_k, num_pages, share=(10, 11), shared_pages=4, max_pages=max_pages)
    bt_dec, bt_pre = bt_all[: len(dec_lens)], bt_all[len(dec_lens) :]
    pool = torch.randn((DS_LAYERS, num_pages, PS, DS_PACKED), generator=gen, device="cuda")
    pool[..., DS_LATENT + DS_ROPE :] = 0.0
    kv_scale = 1.0 if cache is None else KV_SCALES[cache][0]
    if cache is not None:
        from conch_tpu_torch.kernels.cache.reshape_and_cache import quantize_store

        pool = quantize_store(pool, kv_scale, KV_CACHES[cache])
    q_all = torch.randn((len(dec_lens) + rows, DS_HEADS, DS_PACKED), generator=gen, device="cuda")
    q_all[..., DS_LATENT + DS_ROPE :] = 0.0
    cu_pre = np.concatenate([[0], np.cumsum(pre_q)]).astype(np.int32)
    return {"pool": pool, "kv_scale": kv_scale, "total_prefill": sum(pre_q), "cases": {
        "decode": (q_all[: len(dec_lens)], np.arange(len(dec_lens) + 1, dtype=np.int32), 1, dec_lens, bt_dec),
        "prefill": (q_all[len(dec_lens) :], cu_pre, 256, pre_k, bt_pre),
    }}


def k11_args(inputs: dict, case: str, dtype: torch.dtype) -> tuple[tuple, dict]:
    """(args, keyword arguments) of one ``k11_inputs`` case for queries of
    ``dtype``, read at layer DS_LAYER (a float pool in ``dtype``)."""
    pool = inputs["pool"]
    layer = pool[DS_LAYER] if pool.dtype in (torch.int8, torch.float8_e4m3fn) else pool[DS_LAYER].to(dtype)
    q, cu, max_q, kv_lens, bt = inputs["cases"][case]
    args = (q.to(dtype), layer, torch.from_numpy(cu).cuda(), max_q,
            torch.tensor(kv_lens, dtype=torch.int32, device="cuda"), torch.from_numpy(bt).cuda())
    return args, {"scale": DS_SCALE, "latent": DS_LATENT, "kv_scale": inputs["kv_scale"]}


def kernel_phase_k11(gen, rng, cache: str | None = None) -> dict:
    """K11 on ``k11_inputs``' decode and prefill steps, in f32 and bf16,
    against its plain version. The row has the bf16 decode numbers;
    ``detail`` every case. With ``cache`` ("int8", "fp8") the pool is
    quantized and read by bf16 queries (f32 queries over such caches are
    held in ``check_mla_attention_options``)."""
    from conch_tpu_torch.kernels.attention.mla_attention import (
        mla_attention_launcher as launch,
        mla_attention_plain as plain,
    )

    inputs = k11_inputs(gen, rng, cache)
    total = inputs["total_prefill"]
    detail, err_all = [], 0.0
    for dtype in (torch.float32, torch.bfloat16) if cache is None else (torch.bfloat16,):
        for case in inputs["cases"]:
            args, kw = k11_args(inputs, case, dtype)
            q, layer, cu, bt = args[0], args[1], inputs["cases"][case][1], inputs["cases"][case][4]
            kv_lens = inputs["cases"][case][3]
            got, ref = launch(*args, **kw), plain(*args, **kw)
            torch.cuda.synchronize()
            zero_rows = got[0] if case == "decode" else got[total:]
            if not torch.isfinite(got).all() or zero_rows.abs().max().item() != 0.0:
                raise AssertionError(f"K11 ({case}): idle and padding rows must come out as finite zeros")
            tag = f"{case} {str(dtype).removeprefix('torch.')}" + (f" {cache} cache" if cache else "")
            err = check_close(f"K11 mla_attention {tag}", got, ref, K11_TOLERANCES[dtype])
            err_all = max(err_all, err)
            entry = {"case": tag, "max_abs_err": err}
            if dtype == torch.bfloat16:
                q_lens = np.diff(cu).tolist()
                visible = sum(s - ql + j + 1 for ql, s in zip(q_lens, kv_lens) for j in range(ql))
                bytes_moved = (unique_kv_rows(bt, kv_lens) * DS_PACKED * layer.element_size() + q.numel() * 2
                               + q.shape[0] * DS_HEADS * DS_LATENT * 2 + bt.size * 4 + (len(cu) + len(kv_lens)) * 4)
                b_ms, b_by = bound(bytes_moved, 2 * DS_HEADS * (DS_PACKED + DS_LATENT) * visible)
                entry.update({
                    "bound_ms": b_ms, "bound_by": b_by, "ms": time_ms(lambda: launch(*args, **kw)),
                    "paced_ms": paced_ms(lambda: launch(*args, **kw)),
                    "plain_ms": time_ms(lambda: plain(*args, **kw), iters=5), "library_ms": None,
                })
                print(f"K11 mla_attention ({entry['case']}): {entry['ms']:.4f} ms (paced {entry['paced_ms']:.4f}, "
                      f"plain {entry['plain_ms']:.4f}, bound {b_ms:.5f} by {b_by})", flush=True)
            detail.append(entry)
    del inputs
    torch.cuda.empty_cache()
    main = next(d for d in detail if d["case"].startswith("decode bfloat16"))
    row = _kernel_row(
        "mla_attention", "conch_tpu_torch/csrc/mla_attention.cu", "conch_tpu/kernels/attention/mla_attention.py:51",
        err_all, main, main["bound_ms"], main["bound_by"],
    )
    row["detail"] = detail
    return row


# K11's option sweep: (query, latent cache) dtypes, head counts (64-row
# tiles hold 4 tokens of 16 heads, 64 tokens of 1, 21 tokens and a third
# of 3, half a token of 128), (latent, packed) widths, and three ragged
# steps over tables of 8 pages (one split) and 64 pages (splits of 128
# keys): a decode step with an idle row and lengths at stage (32) and
# split (128) edges, a prefill step with zero-length sequences, a decode
# row, a chunk at a split edge and padding rows after a zero-length last
# sequence, and a step whose last sequence is real with padding rows
# after it. In each step two sequences share their first two pages.
MLA_OPTION_TYPES = (
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.int8),
    (torch.bfloat16, torch.float8_e4m3fn), (torch.float32, torch.int8), (torch.float32, torch.float8_e4m3fn),
)
MLA_OPTION_HEADS = (16, 1, 3, 128)
MLA_OPTION_WIDTHS = ((512, 640), (128, 128), (256, 384), (384, 512), (512, 896))
MLA_OPTION_STEPS = {  # name: (q_lens, seq_lens, rows, the sequences that share pages)
    "decode": ([1, 1, 1, 1, 1, 1, 1], [0, 31, 32, 33, 128, 129, 257], 9, (2, 3)),
    "prefill": ([1, 40, 0, 9, 33, 1, 0], [100, 40, 0, 121, 128, 300, 0], 90, (3, 4)),
    "last real": ([1, 9, 40], [0, 121, 40], 64, (1, 2)),
}


def check_mla_attention_options(gen, rng) -> None:
    """K11 at every option it takes, against its plain version: the
    (query, cache) dtypes of MLA_OPTION_TYPES (1-byte caches at
    KV_SCALES[..][0], read by bf16 and by f32 queries), heads
    MLA_OPTION_HEADS, (latent, packed) MLA_OPTION_WIDTHS, causal and not,
    the steps of MLA_OPTION_STEPS over 8- and 64-page tables, with
    ``max_seqlen_q`` the real maximum or 3 above it. Tolerance
    K11_TOLERANCES of the matrix-unit type (bf16 for bf16 queries and for
    e4m3 caches, whose rows the TPU kernel multiplies in bf16; f32
    otherwise), padding rows included (copies of the last sequence's
    tokens, or zeros); pages that no row may see are NaN in the pool the
    kernel reads (float caches); every case twice, bit for bit. Errors are
    gathered on the card and read once."""
    from conch_tpu_torch.kernels.attention.mla_attention import (
        mla_attention_launcher as launch,
        mla_attention_plain as plain,
        mla_tile_plan,
    )
    from conch_tpu_torch.kernels.cache.reshape_and_cache import quantize_store
    from conch_tpu_torch.kernels.common import sm_count

    names, errs, over, same, splits_seen = [], [], [], [], set()
    for step, (q_lens, lens, rows, share) in MLA_OPTION_STEPS.items():
        for table in (8, 64):
            lens_t = [min(n, table * PS) for n in lens]
            num_pages = sum(-(-n // PS) for n in lens_t) + 2
            poison = num_pages - 1
            bt = paged_layout(rng, lens_t, num_pages - 1, share=share, shared_pages=2, max_pages=table)
            bt[bt == 0] = poison  # the table's padding (page 0 is never drawn)
            bt_t = torch.from_numpy(bt).cuda()
            cu_t = torch.tensor(np.concatenate([[0], np.cumsum(q_lens)]), dtype=torch.int32, device="cuda")
            sl_t = torch.tensor(lens_t, dtype=torch.int32, device="cuda")
            for latent, packed in MLA_OPTION_WIDTHS:
                base = torch.randn((num_pages, PS, packed), generator=gen, device="cuda")
                for q_dt, c_dt in MLA_OPTION_TYPES:
                    one_byte = c_dt in (torch.int8, torch.float8_e4m3fn)
                    kv_scale = KV_SCALES["int8" if c_dt == torch.int8 else "fp8"][0] if one_byte else 1.0
                    pool = quantize_store(base, kv_scale, c_dt) if one_byte else base.to(c_dt)
                    if not one_byte:
                        pool = pool.clone()
                        pool[poison] = float("nan")
                    mxu = torch.bfloat16 if q_dt == torch.bfloat16 or c_dt == torch.float8_e4m3fn else torch.float32
                    tol = K11_TOLERANCES[mxu]
                    for heads in MLA_OPTION_HEADS:
                        q = torch.randn((rows, heads, packed), generator=gen, device="cuda").to(q_dt)
                        for causal in (True, False):
                            plan = mla_tile_plan(rows, len(lens), table, PS, heads, packed, latent, causal,
                                                 sm_count(0))
                            splits_seen.add(plan.splits)
                            max_q = max(q_lens) + (3 if (heads + causal) % 2 else 0)
                            args = (q, pool, cu_t, max_q, sl_t, bt_t)
                            kw = {"scale": packed**-0.5, "latent": latent, "causal": causal, "kv_scale": kv_scale}
                            out, again = launch(*args, **kw), launch(*args, **kw)
                            ref_pool = pool if one_byte else base.to(c_dt)
                            ref = plain(q, ref_pool, cu_t, max_q, sl_t, bt_t, **kw)
                            names.append(f"K11 {step} table {table} q {str(q_dt)[6:]} cache {str(c_dt)[6:]} heads "
                                         f"{heads} latent {latent} packed {packed} "
                                         f"{'causal' if causal else 'non-causal'} max_seqlen_q {max_q} "
                                         f"({plan.splits} splits)")
                            diff = (out.float() - ref.float()).abs()
                            errs.append(diff.max())
                            over.append((diff - tol - tol * ref.float().abs()).max())  # <= 0: inside
                            same.append(torch.equal(out, again))
                del base
    err_list, over_list, same_list = (torch.stack(errs).tolist(), torch.stack(over).tolist(),
                                      torch.tensor(same).tolist())
    print(f"K11 mla_attention options: {len(names)} cases (splits {sorted(splits_seen)}), worst max_abs_err "
          f"{max(err_list):.3e}; {sum(same_list)} bit for bit across two calls", flush=True)
    bad = [(name, e) for name, e, o in zip(names, err_list, over_list) if not o <= 0.0]
    for name, e in bad[:40]:
        print(f"{name}: max_abs_err {e:.3e} outside the tolerance", flush=True)
    if bad:
        raise AssertionError(f"{len(bad)} of {len(names)} K11 option cases fail")
    if not all(same_list):
        raise AssertionError(f"{len(same_list) - sum(same_list)} K11 option cases differ between two calls")


# K12q's option sweep: every power-of-two blocksize from 8 to 4096 (the
# vector path) and 2, 6, 100 and 1000 (the scalar path), sizes of 5 blocks
# and of 3 blocks and 6 elements (a ragged last block whose last chunk is
# not whole), inputs starting 16-, 8- and 4-byte aligned.
QUANTIZE4_OPTION_BLOCKSIZES = (8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 2, 6, 100, 1000)
QUANTIZE4_OPTION_OFFSETS = (0, 8, 4)  # bytes past a 16-byte boundary


def check_quantize4_options(gen) -> None:
    """K12q at every option it takes, byte for byte against its plain
    version: QUANTIZE4_OPTION_BLOCKSIZES, f32, bf16 and f16 inputs, nf4 and
    fp4, the sizes and start offsets above. Block 0 is all zeros (absmax 0,
    reciprocal 0); in f32 inputs block 1 holds 1 and -1 and, where it has
    room, every NF4 and FP4 threshold exactly (zeros elsewhere, so its
    absmax is 1), so a compare that is not strict changes a code. Mismatches are gathered on the card and read
    once."""
    from conch_tpu_torch.kernels.quantization.bitsandbytes.blockwise import (
        FP4_THRESHOLDS,
        nf4_thresholds,
        quantize4_launcher as launch,
        quantize4_plain as plain,
    )

    edges = torch.cat([torch.tensor([1.0, -1.0], device="cuda"), nf4_thresholds("cuda"),
                       torch.tensor(FP4_THRESHOLDS, dtype=torch.float32, device="cuda"),
                       -torch.tensor(FP4_THRESHOLDS, dtype=torch.float32, device="cuda")])
    names, bad = [], []
    for blocksize in QUANTIZE4_OPTION_BLOCKSIZES:
        for size in (5 * blocksize, 3 * blocksize + 6):
            for dtype in (torch.float32, torch.bfloat16, torch.float16):
                for offset in QUANTIZE4_OPTION_OFFSETS:
                    pad = offset * 8 // torch.finfo(dtype).bits  # elements
                    buf = torch.randn(size + 16, generator=gen, device="cuda").to(dtype)
                    x = buf[pad : pad + size]
                    x[:blocksize] = 0.0
                    if dtype == torch.float32 and size > blocksize:
                        n = min(blocksize, edges.numel(), size - blocksize)
                        x[blocksize : 2 * blocksize] = 0.0  # absmax 1: every edge value is scaled by exactly 1
                        x[blocksize : blocksize + n] = edges[:n]
                    for quant_type in ("nf4", "fp4"):
                        got, ref = launch(x, blocksize, quant_type), plain(x, blocksize, quant_type)
                        names.append(f"K12q {quant_type} blocksize {blocksize} size {size} {str(dtype)[6:]} "
                                     f"start +{offset} bytes")
                        bad.append((got[0] != ref[0]).sum() + (got[1] != ref[1]).sum())
    bad_list = torch.stack(bad).tolist()
    print(f"K12q quantize4 options: {len(names)} cases, {sum(b == 0 for b in bad_list)} byte for byte", flush=True)
    for name, b in zip(names, bad_list):
        if b:
            print(f"{name}: {b} bytes or absmax differ", flush=True)
    if any(bad_list):
        raise AssertionError(f"{sum(b != 0 for b in bad_list)} of {len(names)} K12q option cases differ")


# K9 at a decode batch and a prefill chunk of Llama-3-8B's hidden size, and
# at a hidden size off the TPU kernel's 128 lanes whose element count
# leaves a tail past the kernel's 8-element loads; from f32, bf16 and f16.
K9_SHAPES = ((8, HIDDEN), (512, HIDDEN), (7, 4097))
K9_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
K9_SCALE = 0.37  # here x * f32(1 / scale) and x / scale truncate differently on some inputs


def kernel_phase_k9(gen) -> dict:
    """K9 through its public ops (``scaled_int8_quant``, ``scaled_fp8_quant``),
    its only callers: every K9_SHAPES x K9_DTYPES input of N(0, 100^2)
    values (past both ranges) to int8 and to e4m3, held byte for byte
    against the plain versions. No model calls K9, so its launches are
    those of these public-op calls (counted from 0 just before them). The
    row has the int8 numbers at 512 x 4096 bf16; ``detail`` int8 and fp8
    at 8 and 512 rows."""
    from conch_tpu_torch.kernels.quantization.fp8 import (
        static_scaled_fp8_quant_launcher as fp8_kernel,
        static_scaled_fp8_quant_plain as fp8_plain,
    )
    from conch_tpu_torch.kernels.quantization.int8 import (
        static_scaled_int8_quant_launcher as int8_kernel,
        static_scaled_int8_quant_plain as int8_plain,
    )
    from conch_tpu_torch.ops.quantization import scaled_fp8_quant, scaled_int8_quant

    scale = torch.tensor([K9_SCALE], device="cuda")
    inputs = {
        (r, h, dt): (100.0 * torch.randn((r, h), generator=gen, device="cuda")).to(dt)
        for r, h in K9_SHAPES for dt in K9_DTYPES
    }
    ops = {"int8": (scaled_int8_quant, int8_plain, int8_kernel), "fp8": (scaled_fp8_quant, fp8_plain, fp8_kernel)}
    int8_kernel.launches = fp8_kernel.launches = 0
    outs = {(kind, key): op(x, scale)[0] for kind, (op, _, _) in ops.items() for key, x in inputs.items()}
    torch.cuda.synchronize()
    launches = int8_kernel.launches + fp8_kernel.launches
    if launches != len(outs):
        raise AssertionError(f"K9: {launches} launches for {len(outs)} public-op calls")
    differing = 0
    for (kind, key), out in outs.items():
        ref = ops[kind][1](inputs[key], scale)
        if out.dtype != ref.dtype or out.shape != ref.shape:
            raise AssertionError(f"K9 {kind} {key}: {out.dtype} {tuple(out.shape)}, expected {ref.dtype}")
        differing += int((cache_bytes(out) != cache_bytes(ref)).sum())
    check(f"K9 static_scaled_quant, {len(outs)} cases: bytes differing", float(differing), 0.0)
    detail = []
    for kind, (_, plain, kernel) in ops.items():
        for rows in (8, 512):
            x = inputs[(rows, HIDDEN, torch.bfloat16)]
            b_ms, b_by = bound(x.numel() * 3 + 4, 2 * x.numel(), F32_OPS_PER_S)
            detail.append({
                "case": f"{kind} {rows}x{HIDDEN} bf16", "max_abs_err": 0.0, "bound_ms": b_ms, "bound_by": b_by,
                "ms": time_ms(lambda: kernel(x, scale)), "paced_ms": paced_ms(lambda: kernel(x, scale)),
                "plain_ms": time_ms(lambda: plain(x, scale)), "library_ms": None,
            })
    for d in detail:
        print(f"K9 {d['case']}: {d['ms']:.4f} ms (paced {d['paced_ms']:.4f}, plain {d['plain_ms']:.4f}, "
              f"bound {d['bound_ms']:.5f} by {d['bound_by']})", flush=True)
    main = detail[1]
    row = _kernel_row(
        "static_scaled_quant", "conch_tpu_torch/csrc/static_quant.cu",
        "conch_tpu/kernels/quantization/int8.py:22; conch_tpu/kernels/quantization/fp8.py:25", float(differing),
        main, main["bound_ms"], main["bound_by"],
    )
    row["detail"] = detail
    row["phase_launches"] = launches
    return row


def check_attention_scales(gen) -> None:
    """K3 and K7 apply the dequantization scales over a plain f32 cache
    (``kv_cache_dtype`` "auto"), as the JAX kernels do: f32, batch 2, QH 4 /
    KH 1 / D 128, page 16, 8 pages, seq_lens [37, 50], k_scale 2, v_scale 3,
    and for K7 five causal query rows (cu_seqlens_q [0, 2, 5]) and q_scale
    1.5, held against the plain versions at the JAX tests' f32 2e-3."""
    from conch_tpu_torch.kernels.attention.paged_attention import (
        paged_attention_launcher as k3,
        paged_attention_plain as k3_plain,
    )
    from conch_tpu_torch.kernels.attention.varlen_attention import (
        varlen_attention_launcher as k7,
        varlen_attention_plain as k7_plain,
    )

    kc, vc = (torch.randn((1, 8, 1, PS, D), generator=gen, device="cuda") for _ in range(2))
    bt = torch.tensor([[0, 1, 2, 0], [3, 4, 5, 6]], dtype=torch.int32, device="cuda")
    sl = torch.tensor([37, 50], dtype=torch.int32, device="cuda")
    scale, scales = 1.0 / math.sqrt(D), {"k_scale": 2.0, "v_scale": 3.0}
    q = torch.randn((2, 4, D), generator=gen, device="cuda")
    args = (q, kc, vc, bt, sl, scale, 0)
    check_close("K3 paged_attention f32 cache, k_scale 2, v_scale 3", k3(*args, **scales), k3_plain(*args, **scales),
                2e-3)
    q = torch.randn((5, 4, D), generator=gen, device="cuda")
    cu = torch.tensor([0, 2, 5], dtype=torch.int32, device="cuda")
    args, scales = (q, kc, vc, cu, sl, bt, scale, True, 0), {**scales, "q_scale": 1.5}
    check_close("K7 varlen_attention f32 cache, q_scale 1.5, k_scale 2, v_scale 3", k7(*args, **scales),
                k7_plain(*args, **scales), 2e-3)


# K3's option sweep: (query, cache) dtypes, GQA groups, head sizes (34:
# rows copied 4 bytes at a time, or element by element for 1-byte caches),
# softcap, windows (37: not a page multiple), and a wide block table (up to
# 1024 tokens: several splits, merged) and a narrow one (one split).
PAGED_OPTION_TYPES = (
    (torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32), (torch.float32, torch.bfloat16),
    (torch.bfloat16, torch.int8), (torch.bfloat16, torch.float8_e4m3fn), (torch.float32, torch.int8),
    (torch.float32, torch.float8_e4m3fn),
)
PAGED_OPTION_GROUPS = (1, 4, 7, 8)  # 7: Qwen2-7B's group, not a power of two
PAGED_OPTION_HEADS = (64, 128, 256, 34)
PAGED_OPTION_LENS = [0, 1, 17, 300, 700, 1000]  # row 0 idle; row 4 shares row 3's first 8 pages
PAGED_OPTION_KH, PAGED_OPTION_LAYERS = 2, 3


def _option_pool(gen, num_pages: int, d: int, dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
    shape = (PAGED_OPTION_LAYERS, num_pages, PAGED_OPTION_KH, PS, d)
    if dtype in (torch.int8, torch.float8_e4m3fn):
        cache = "int8" if dtype == torch.int8 else "fp8"
        return quant_pool(gen, num_pages, PAGED_OPTION_LAYERS, PAGED_OPTION_KH, d, cache)
    return tuple(torch.randn(shape, generator=gen, device="cuda").to(dtype) for _ in range(2))


def _poisoned(pool: torch.Tensor, pages: list[int]) -> torch.Tensor:
    """A copy of ``pool`` with ``pages`` (of every layer) set to NaN (e4m3:
    its NaN code), so that a read of them shows in the output."""
    out = pool.clone()
    if out.dtype == torch.float8_e4m3fn:
        out.view(torch.uint8)[:, pages] = 0x7F
    else:
        out[:, pages] = float("nan")
    return out


def _report_cases(label: str, names: list, errs: list, tols: list, same: list, zero: list, splits: set) -> None:
    """Read a sweep's errors once and fail on any case outside its
    tolerance, with a nonzero idle or padding row, or unequal across its
    two calls."""
    err_list, over, same_list, zero_list = (torch.stack(errs).tolist(), torch.stack(tols).tolist(),
                                            torch.tensor(same).tolist(), torch.stack(zero).tolist())
    print(f"{label}: {len(names)} cases (splits {sorted(splits)}), worst max_abs_err {max(err_list):.3e}; "
          f"{sum(same_list)} bit for bit across two calls", flush=True)
    bad = [(name, e) for name, e, o, z in zip(names, err_list, over, zero_list) if not (o <= 0.0 and z == 0.0)]
    for name, e in bad:
        print(f"{name}: max_abs_err {e:.3e} outside the tolerance, or an idle / padding row not exactly zero",
              flush=True)
    if bad:
        raise AssertionError(f"{len(bad)} of {len(names)} {label} cases fail")
    if not all(same_list):
        raise AssertionError(f"{len(same_list) - sum(same_list)} {label} cases differ between two calls")


def check_paged_attention_options(gen, rng) -> None:
    """K3 at every option it takes, against its plain version: the (query,
    cache) dtypes of ``PAGED_OPTION_TYPES`` (1-byte caches at KV_SCALES),
    GQA groups ``PAGED_OPTION_GROUPS``, head sizes ``PAGED_OPTION_HEADS``,
    softcap 0 and 30, windows 0, 37 and 500, a 64-page block table (KV
    splits merged) and a 4-page one (one split), idle row 0, shared prefix
    pages, layer 2 of a 3-layer pool. Tolerance 3e-2 (3e-2 + 3e-2 x |ref|
    on 1-byte caches); idle rows exactly zero; every case twice, bit for
    bit. On float caches every page that no row may see (the block table's
    padding, pages wholly before a window) is NaN in the pool the kernel
    reads, so a read of one fails the case. Then one call is captured in a
    CUDA graph: its replay must equal the eager call, and again after
    seq_lens changed in place (the wrapper reads no value on the host).
    Errors are gathered on the card and read once."""
    from conch_tpu_torch.kernels.attention.paged_attention import (
        paged_attention_launcher as launch,
        paged_attention_plain as plain,
        paged_split_plan,
    )
    from conch_tpu_torch.kernels.common import sm_count

    lens = PAGED_OPTION_LENS
    num_pages = sum(-(-n // PS) for n in lens) + 2
    poison_page = num_pages - 1
    bt = paged_layout(rng, lens, num_pages - 1, share=(3, 4), shared_pages=8, max_pages=64)
    bt[bt == 0] = poison_page  # padding entries (page 0 is never drawn by paged_layout)
    tables = {"wide": (bt, lens), "narrow": (bt[:, :4].copy(), [min(n, 4 * PS) for n in lens])}
    names, errs, tols, same, idle, splits_seen = [], [], [], [], [], set()
    for q_dt, c_dt in PAGED_OPTION_TYPES:
        one_byte = c_dt in (torch.int8, torch.float8_e4m3fn)
        ks, vs = KV_SCALES["int8" if c_dt == torch.int8 else "fp8"] if one_byte else (1.0, 1.0)
        for group in PAGED_OPTION_GROUPS:
            for d in PAGED_OPTION_HEADS:
                kc, vc = _option_pool(gen, num_pages, d, c_dt)
                q = (6.0 * torch.randn((len(lens), group * PAGED_OPTION_KH, d), generator=gen, device="cuda")).to(q_dt)
                scale = d**-0.5
                for tlabel, (table, seq_lens) in tables.items():
                    bt_t = torch.from_numpy(table).cuda()
                    sl_t = torch.tensor(seq_lens, dtype=torch.int32, device="cuda")
                    for window in (0, 37, 500):
                        seen = {int(table[b, pos // PS]) for b, n in enumerate(seq_lens)
                                for pos in range(max(n - window, 0) if window else 0, n)}
                        hidden = sorted({int(p) for p in table.reshape(-1)} - seen)
                        kp, vp = (kc, vc) if c_dt == torch.int8 else (_poisoned(kc, hidden), _poisoned(vc, hidden))
                        plan = paged_split_plan(sl_t, bt_t, PS, PAGED_OPTION_KH, window, sm_count(0))
                        splits_seen.add(plan.splits)
                        for softcap in (0.0, 30.0):
                            args = (q, kp, vp, bt_t, sl_t, scale, 2, softcap, window, ks, vs)
                            out, again = launch(*args), launch(*args)
                            ref = plain(q, kc, vc, bt_t, sl_t, scale, 2, softcap, window, ks, vs)
                            names.append(f"K3 q {str(q_dt)[6:]} cache {str(c_dt)[6:]} G {group} D {d} {tlabel} table "
                                         f"({plan.splits} splits) window {window} softcap {softcap:g}")
                            diff = (out.float() - ref.float()).abs()
                            tol = 3e-2 + (3e-2 * ref.float().abs() if one_byte else 0.0)
                            errs.append(diff.max())
                            tols.append((diff - tol).max())  # <= 0 when every element is inside
                            same.append(torch.equal(out, again))
                            idle.append(out[0].float().abs().max())
    _report_cases("K3 paged_attention options", names, errs, tols, same, idle, splits_seen)

    # One call in a CUDA graph, replayed: the same bits as the eager call,
    # and again after seq_lens changed in place.
    kc, vc = _option_pool(gen, num_pages, D, torch.bfloat16)
    q = torch.randn((len(lens), 4 * PAGED_OPTION_KH, D), generator=gen, device="cuda").to(torch.bfloat16)
    bt_t = torch.from_numpy(bt).cuda()
    sl_t = torch.tensor(lens, dtype=torch.int32, device="cuda")
    args = (q, kc, vc, bt_t, sl_t, D**-0.5, 2)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        launch(*args)  # warm-up outside the capture (builds and binds the kernel)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = launch(*args)
    for step, new_lens in enumerate((lens, [5, 0, 1000, 64, 999, 333])):
        sl_t.copy_(torch.tensor(new_lens, dtype=torch.int32))
        graph.replay()
        eager = launch(*args)
        torch.cuda.synchronize()
        if not torch.equal(captured, eager):
            diff = (captured.float() - eager.float()).abs().max().item()
            raise AssertionError(f"K3 in a CUDA graph: replay {step} differs from the eager call (max {diff})")
    print("K3 paged_attention in a CUDA graph: two replays (seq_lens changed in place between them) bit for bit "
          "equal to the eager calls", flush=True)
    check_paged_ring_options(gen, rng)


# K7's option sweep: the (query, cache) dtypes and GQA groups of K3's
# sweep, head sizes 64, 128, 256 and 34 (rows copied 4 bytes at a time, or
# element by element for 1-byte caches; zero-padded to 64 in shared
# memory), causal or not, softcap, windows (37: not a page multiple), and
# one ragged step: a decode row mixed in (context 700), a zero-length
# sequence between live ones, a fresh 77-token prompt (tiles crossing the
# diagonal), the last 150-token chunk of a 1000-token prompt and a 40-token
# chunk of a 300-token prompt whose first 8 pages are that prompt's, a
# zero-length padding sequence and 12 padding rows, over a 64-page table
# (its splits merged; under window 37 one split).
VARLEN_OPTION_QLENS = [1, 0, 77, 150, 40, 0]
VARLEN_OPTION_LENS = [700, 0, 77, 1000, 300, 0]
VARLEN_OPTION_ROWS = 280
VARLEN_OPTION_GRAPH = ([5, 20, 0, 200, 43, 0], [64, 20, 0, 1000, 999, 0])  # q_lens, seq_lens after the change


def check_varlen_attention_options(gen, rng) -> None:
    """K7 at every option it takes, against its plain version: the (query,
    cache) dtypes of ``PAGED_OPTION_TYPES`` (1-byte caches at KV_SCALES),
    GQA groups ``PAGED_OPTION_GROUPS`` over 2 KV heads, head sizes
    ``PAGED_OPTION_HEADS``, causal and not, softcap 0 and 30, windows 0, 37
    and 500, on the ragged step of ``VARLEN_OPTION_QLENS`` (layer 2 of a
    3-layer pool). Tolerance 2e-2 + 2e-2 x |ref| (bf16 P in the tensor-core
    PV product; the JAX tests' 2e-2); padding rows exactly zero; every case
    twice, bit for bit. On float caches every page that no row may see (the
    block table's padding, pages wholly before a sequence's first window) is
    NaN in the pool the kernel reads, so a read of one fails the case. Then
    one call is captured in a CUDA graph: its replay must equal the eager
    call, and again after cu_seqlens_q and seq_lens changed in place (the
    wrapper reads no value on the host). Errors are gathered on the card
    and read once; the case count is printed."""
    from conch_tpu_torch.kernels.attention.varlen_attention import (
        varlen_attention_launcher as launch,
        varlen_attention_plain as plain,
        varlen_tile_plan,
    )
    from conch_tpu_torch.kernels.common import sm_count

    q_lens, lens, rows = VARLEN_OPTION_QLENS, VARLEN_OPTION_LENS, VARLEN_OPTION_ROWS
    total = sum(q_lens)
    num_pages = sum(-(-n // PS) for n in lens) + 2
    poison_page = num_pages - 1
    bt = paged_layout(rng, lens, num_pages - 1, share=(3, 4), shared_pages=8, max_pages=64)
    bt[bt == 0] = poison_page  # padding entries (page 0 is never drawn by paged_layout)
    bt_t = torch.from_numpy(bt).cuda()
    cu_t = torch.tensor(np.concatenate([[0], np.cumsum(q_lens)]), dtype=torch.int32, device="cuda")
    sl_t = torch.tensor(lens, dtype=torch.int32, device="cuda")
    names, errs, tols, same, pad, splits_seen = [], [], [], [], [], set()
    for q_dt, c_dt in PAGED_OPTION_TYPES:
        one_byte = c_dt in (torch.int8, torch.float8_e4m3fn)
        ks, vs = KV_SCALES["int8" if c_dt == torch.int8 else "fp8"] if one_byte else (1.0, 1.0)
        for group in PAGED_OPTION_GROUPS:
            qh = group * PAGED_OPTION_KH
            for d in PAGED_OPTION_HEADS:
                kc, vc = _option_pool(gen, num_pages, d, c_dt)
                q = (6.0 * torch.randn((rows, qh, d), generator=gen, device="cuda")).to(q_dt)
                scale = d**-0.5
                for window in (0, 37, 500):
                    # A sequence's rows see [its first row's window start, seq_len).
                    seen = {int(bt[b, pos // PS]) for b, (ql, n) in enumerate(zip(q_lens, lens))
                            for pos in range(max(n - ql - window + 1, 0) if window else 0, n)}
                    hidden = sorted({int(p) for p in bt.reshape(-1)} - seen)
                    kp, vp = (kc, vc) if c_dt == torch.int8 else (_poisoned(kc, hidden), _poisoned(vc, hidden))
                    for causal in (True, False):
                        plan = varlen_tile_plan(rows, len(lens), bt.shape[1], PS, qh, PAGED_OPTION_KH, d, causal,
                                                window, sm_count(0))
                        splits_seen.add(plan.splits)
                        for softcap in (0.0, 30.0):
                            args = (q, kp, vp, cu_t, sl_t, bt_t, scale, causal, 2, softcap, window, 1.0, ks, vs)
                            out, again = launch(*args), launch(*args)
                            ref = plain(q, kc, vc, cu_t, sl_t, bt_t, scale, causal, 2, softcap, window, 1.0, ks, vs)
                            names.append(f"K7 q {str(q_dt)[6:]} cache {str(c_dt)[6:]} G {group} D {d} "
                                         f"{'causal' if causal else 'non-causal'} ({plan.splits} splits) window "
                                         f"{window} softcap {softcap:g}")
                            diff = (out[:total].float() - ref[:total].float()).abs()
                            errs.append(diff.max())
                            tols.append((diff - 2e-2 - 2e-2 * ref[:total].float().abs()).max())  # <= 0: inside
                            same.append(torch.equal(out, again))
                            pad.append(out[total:].float().abs().max())
                del kc, vc
    _report_cases("K7 varlen_attention options", names, errs, tols, same, pad, splits_seen)

    # One call in a CUDA graph, replayed: the same bits as the eager call,
    # and again after cu_seqlens_q and seq_lens changed in place.
    kc, vc = _option_pool(gen, num_pages, D, torch.bfloat16)
    q = torch.randn((rows, 4 * PAGED_OPTION_KH, D), generator=gen, device="cuda").to(torch.bfloat16)
    bt_t = torch.from_numpy(np.where(bt == poison_page, 0, bt)).cuda()
    args = (q, kc, vc, cu_t, sl_t, bt_t, D**-0.5, True, 2, 30.0, 500)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        launch(*args)  # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = launch(*args)
    for step, (new_q, new_lens) in enumerate(((q_lens, lens), VARLEN_OPTION_GRAPH)):
        cu_t.copy_(torch.tensor(np.concatenate([[0], np.cumsum(new_q)]), dtype=torch.int32))
        sl_t.copy_(torch.tensor(new_lens, dtype=torch.int32))
        graph.replay()
        eager = launch(*args)
        torch.cuda.synchronize()
        if not torch.equal(captured, eager):
            diff = (captured.float() - eager.float()).abs().max().item()
            raise AssertionError(f"K7 in a CUDA graph: replay {step} differs from the eager call (max {diff})")
    print("K7 varlen_attention in a CUDA graph: two replays (cu_seqlens_q and seq_lens changed in place between "
          "them) bit for bit equal to the eager calls", flush=True)
    check_varlen_ring_options(gen, rng)


# Ring cases of the K3 and K7 sweeps (rolling KV): every sequence with
# tokens owns a ring of ``ring_size(window, burst)`` random pages, and the
# table's entries past the ring (as many as the longest sequence's true
# pages, and RING_OPTION_PAD more) name a page no row may see (poisoned on
# float caches, so a walk that misses the modulo reads NaN, inside the
# table). K3's lengths wrap window 37's ring of 5 pages up to 62
# times and window 2000's ring of 127 pages 2.5 times; K7's ragged step
# (VARLEN_OPTION_QLENS) wraps its rings (13, 42 and 136 pages, the window
# plus the step's largest chunk of 150) up to 24 times.
RING_OPTION_TYPES = (
    (torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.int8), (torch.bfloat16, torch.float8_e4m3fn),
    (torch.float32, torch.float32),
)
RING_OPTION_HEADS = (64, 128, 256)
RING_OPTION_WINDOWS = (37, 500, 2000)
RING_OPTION_LENS = [0, 1, 17, 300, 1000, 5000]  # K3: row 0 idle
RING_VARLEN_LENS = [700, 0, 77, 3000, 5000, 0]  # K7, with VARLEN_OPTION_QLENS
RING_OPTION_PAD = 8
RING_DECODE_BURST = 16  # K3's ring: the window plus a burst of writes (1 suffices for decode)


def ring_size(window: int, burst: int) -> int:
    """The engine's ring: the window plus the largest write burst, plus one page."""
    return -(-(window + burst) // PS) + 1


def ring_option_table(rng, lens: list[int], ring: int, num_pages: int) -> np.ndarray:
    """(B, max(ring, the longest sequence's pages) + RING_OPTION_PAD): each
    sequence with tokens its own ring of ``ring`` distinct random pages of 1
    .. num_pages - 2; the entries past the ring, and an empty sequence's,
    name page num_pages - 1."""
    perm = iter(rng.permutation(np.arange(1, num_pages - 1)).tolist())
    width = max(ring, -(-max(lens) // PS)) + RING_OPTION_PAD
    bt = np.full((len(lens), width), num_pages - 1, np.int32)
    for b, n in enumerate(lens):
        if n:
            bt[b, :ring] = [next(perm) for _ in range(ring)]
    return bt


def _ring_hidden(bt: np.ndarray, ring: int, bands: list[tuple[int, int]]) -> list[int]:
    """Pages of ``bt`` that no position of the (start, end) bands reaches
    through the ring."""
    seen = {int(bt[b, (pos // PS) % ring]) for b, (start, end) in enumerate(bands) for pos in range(start, end)}
    return sorted({int(p) for p in bt.reshape(-1)} - seen)


def check_paged_ring_options(gen, rng) -> None:
    """K3 over rolling-KV rings (RING_OPTION_*): bf16 queries over bf16,
    int8 and e4m3 caches and f32 over f32, GQA groups PAGED_OPTION_GROUPS
    (7 among them), heads 64, 128 and 256, windows 37, 500 and 2000 (one
    split and several), softcap 0 and 30, sequences that wrap their rings
    many times and an idle row; against the plain version over the same
    ring at K3's sweep tolerances, idle rows exactly zero, every case
    twice, bit for bit."""
    from conch_tpu_torch.kernels.attention.paged_attention import (
        paged_attention_launcher as launch,
        paged_attention_plain as plain,
        paged_split_plan,
    )
    from conch_tpu_torch.kernels.common import sm_count

    lens = RING_OPTION_LENS
    sl_t = torch.tensor(lens, dtype=torch.int32, device="cuda")
    names, errs, tols, same, idle, splits_seen = [], [], [], [], [], set()
    for window in RING_OPTION_WINDOWS:
        ring = ring_size(window, RING_DECODE_BURST)
        num_pages = sum(1 for n in lens if n) * ring + 2
        bt = ring_option_table(rng, lens, ring, num_pages)
        bt_t = torch.from_numpy(bt).cuda()
        hidden = _ring_hidden(bt, ring, [(max(n - window, 0), n) for n in lens])
        plan = paged_split_plan(sl_t, bt_t, PS, PAGED_OPTION_KH, window, sm_count(0))
        splits_seen.add(plan.splits)
        for q_dt, c_dt in RING_OPTION_TYPES:
            one_byte = c_dt in (torch.int8, torch.float8_e4m3fn)
            ks, vs = KV_SCALES["int8" if c_dt == torch.int8 else "fp8"] if one_byte else (1.0, 1.0)
            for group in PAGED_OPTION_GROUPS:
                for d in RING_OPTION_HEADS:
                    kc, vc = _option_pool(gen, num_pages, d, c_dt)
                    kp, vp = (kc, vc) if c_dt == torch.int8 else (_poisoned(kc, hidden), _poisoned(vc, hidden))
                    q = (6.0 * torch.randn((len(lens), group * PAGED_OPTION_KH, d), generator=gen,
                                           device="cuda")).to(q_dt)
                    for softcap in (0.0, 30.0):
                        args = (q, kp, vp, bt_t, sl_t, d**-0.5, 2, softcap, window, ks, vs, ring)
                        out, again = launch(*args), launch(*args)
                        ref = plain(q, kc, vc, bt_t, sl_t, d**-0.5, 2, softcap, window, ks, vs, ring)
                        names.append(f"K3 ring of {ring} pages q {str(q_dt)[6:]} cache {str(c_dt)[6:]} G {group} "
                                     f"D {d} ({plan.splits} splits) window {window} softcap {softcap:g}")
                        diff = (out.float() - ref.float()).abs()
                        tol = 3e-2 + (3e-2 * ref.float().abs() if one_byte else 0.0)
                        errs.append(diff.max())
                        tols.append((diff - tol).max())
                        same.append(torch.equal(out, again))
                        idle.append(out[0].float().abs().max())
                    del kc, vc, kp, vp
    _report_cases("K3 paged_attention ring options", names, errs, tols, same, idle, splits_seen)


def check_varlen_ring_options(gen, rng) -> None:
    """K7 over rolling-KV rings (RING_OPTION_*) on the ragged step of
    VARLEN_OPTION_QLENS at RING_VARLEN_LENS: K3's ring types, groups and
    heads, causal and not, windows 37, 500 and 2000, softcap 0 and 30; the
    ring holds the window plus the step's largest chunk. Against the plain
    version over the same ring at K7's sweep tolerance (2e-2 + 2e-2 x
    |ref|), padding rows exactly zero, every case twice, bit for bit."""
    from conch_tpu_torch.kernels.attention.varlen_attention import (
        varlen_attention_launcher as launch,
        varlen_attention_plain as plain,
        varlen_tile_plan,
    )
    from conch_tpu_torch.kernels.common import sm_count

    q_lens, lens, rows = VARLEN_OPTION_QLENS, RING_VARLEN_LENS, VARLEN_OPTION_ROWS
    total = sum(q_lens)
    cu_t = torch.tensor(np.concatenate([[0], np.cumsum(q_lens)]), dtype=torch.int32, device="cuda")
    sl_t = torch.tensor(lens, dtype=torch.int32, device="cuda")
    names, errs, tols, same, pad, splits_seen = [], [], [], [], [], set()
    for window in RING_OPTION_WINDOWS:
        ring = ring_size(window, max(q_lens))
        num_pages = sum(1 for n in lens if n) * ring + 2
        bt = ring_option_table(rng, lens, ring, num_pages)
        bt_t = torch.from_numpy(bt).cuda()
        # A sequence's rows see [its first row's window start, seq_len).
        hidden = _ring_hidden(bt, ring, [(max(n - ql - window + 1, 0), n if ql else 0)
                                         for ql, n in zip(q_lens, lens)])
        for q_dt, c_dt in RING_OPTION_TYPES:
            one_byte = c_dt in (torch.int8, torch.float8_e4m3fn)
            ks, vs = KV_SCALES["int8" if c_dt == torch.int8 else "fp8"] if one_byte else (1.0, 1.0)
            for group in PAGED_OPTION_GROUPS:
                qh = group * PAGED_OPTION_KH
                for d in RING_OPTION_HEADS:
                    kc, vc = _option_pool(gen, num_pages, d, c_dt)
                    kp, vp = (kc, vc) if c_dt == torch.int8 else (_poisoned(kc, hidden), _poisoned(vc, hidden))
                    q = (6.0 * torch.randn((rows, qh, d), generator=gen, device="cuda")).to(q_dt)
                    for causal in (True, False):
                        plan = varlen_tile_plan(rows, len(lens), bt.shape[1], PS, qh, PAGED_OPTION_KH, d, causal,
                                                window, sm_count(0), ring)
                        splits_seen.add(plan.splits)
                        for softcap in (0.0, 30.0):
                            args = (q, kp, vp, cu_t, sl_t, bt_t, d**-0.5, causal, 2, softcap, window, 1.0, ks, vs,
                                    ring)
                            out, again = launch(*args), launch(*args)
                            ref = plain(q, kc, vc, cu_t, sl_t, bt_t, d**-0.5, causal, 2, softcap, window, 1.0, ks,
                                        vs, ring)
                            names.append(f"K7 ring of {ring} pages q {str(q_dt)[6:]} cache {str(c_dt)[6:]} G {group}"
                                         f" D {d} {'causal' if causal else 'non-causal'} ({plan.splits} splits) "
                                         f"window {window} softcap {softcap:g}")
                            diff = (out[:total].float() - ref[:total].float()).abs()
                            errs.append(diff.max())
                            tols.append((diff - 2e-2 - 2e-2 * ref[:total].float().abs()).max())
                            same.append(torch.equal(out, again))
                            pad.append(out[total:].float().abs().max())
                    del kc, vc, kp, vp
    _report_cases("K7 varlen_attention ring options", names, errs, tols, same, pad, splits_seen)


def quantized_cache_phases(gen, rng, by_name: dict) -> None:
    """The int8 and e4m3 branches of K2, K3, K7 and K11, each against its
    plain version on the card, as detail entries of those kernels' rows:
    K2's store at Llama-3-8B's and Gemma-2-2B's shapes, K3 and K7 at
    Llama's and at Gemma's (softcap 50, with and without the 4096 window),
    K11 at DeepSeek-V2-Lite's decode and 512-row prefill steps."""
    for cache in KV_CACHES:
        found = {
            "reshape_and_cache_stacked": [
                {**kernel_phase_k2(gen, rng, cache=cache), "case": f"{cache} store, Llama KH {KH} D {D}"},
                {**kernel_phase_k2(gen, rng, G_QH, G_KH, G_D, G_LAYERS, cache), "case": f"{cache} store, gemma2"},
            ],
            "paged_attention": [{**kernel_phase_k3(gen, rng, cache), "case": f"{cache} cache, Llama"}],
            "varlen_attention": [{**kernel_phase_k7(gen, rng, cache), "case": f"{cache} cache, Llama"}],
            "mla_attention": kernel_phase_k11(gen, rng, cache)["detail"],
        }
        for name, cases in gemma_attention_phases(gen, rng, cache).items():
            found[name] += cases
        for name, cases in found.items():
            for case in cases:
                kept = {k: v for k, v in case.items() if k not in ("name", "route", "source", "replaces", "detail")}
                by_name[name].setdefault("detail", []).append(kept)
                if name == "reshape_and_cache_stacked" or "Llama" in kept["case"]:  # the others print their own
                    print(f"{name} ({kept['case']}): {kept['ms']:.4f} ms (paced {kept['paced_ms']:.4f}, plain "
                          f"{kept['plain_ms']:.4f}, bound {kept['bound_ms']:.5f} by {kept['bound_by']})", flush=True)
        torch.cuda.empty_cache()


# --- Vision: BEV pool (K13a, K13b), NMS (K13c), voxelization -----------------
# BEVFusion's camera-to-BEV pool on nuScenes (mit-han-lab/bevfusion,
# DepthLSSTransform): 6 cameras, image 256 x 704 at stride 8 (feature map
# 32 x 88), dbound [1, 60, 0.5] (118 depth bins), xbound / ybound [-54, 54,
# 0.3] (a 360 x 360 grid), zbound [-10, 10, 20] (Z = 1), 80 channels,
# batch 1: 1,993,728 frustum points.
BEV_CAMERAS, BEV_FH, BEV_FW, BEV_STRIDE, BEV_C = 6, 32, 88, 8, 80
BEV_DEPTHS = (1.0, 60.0, 0.5)
BEV_XY, BEV_Z = (-54.0, 54.0, 0.3), (-10.0, 10.0, 20.0)
BEV_GRID = (1, 1, 360, 360)  # batch, Z, X, Y
# nuScenes camera yaws (front, front-right, front-left, back, back-left,
# back-right) and horizontal fields of view, degrees.
BEV_YAWS = (0.0, -55.0, 55.0, 180.0, 110.0, -110.0)
BEV_FOVS = (70.0, 70.0, 70.0, 110.0, 70.0, 70.0)
# PointPillars on KITTI (mmdetection3d configs/_base_/models/
# pointpillars_hv_secfpn_kitti.py): a 432 x 496 x 1 grid, 32 points a pillar.
PILLARS = {"min_range": (0.0, -39.68, -3.0), "max_range": (69.12, 39.68, 1.0), "voxel_dim": (0.16, 0.16, 4.0),
           "max_num_points_per_voxel": 32}
PILLAR_POINTS = 120_000  # about one HDL-64E sweep
NMS_BOXES, NMS_IOU = 4096, 0.5  # the JAX package's benchmarks/nms_benchmark.py


def bevfusion_inputs(gen, rng, dtype=torch.float32) -> dict:
    """The pool's inputs at BEVFusion's size, made from the seed on the card:
    each frustum point (camera, depth bin, feature row and column) is cast
    through its camera (a pinhole with the camera's field of view, its yaw
    and mount jittered by the seed) into the ego frame; points outside the
    grid are dropped (BEVFusion's ``kept``); the rest are sorted by cell
    rank and cut into intervals at rank changes, as BEVFusion's quick
    cumsum does. Features are a depth softmax times a context feature, as
    ``DepthLSSTransform`` makes them."""
    dev = "cuda"
    depths = torch.arange(*BEV_DEPTHS, device=dev)
    u = (torch.arange(BEV_FW, device=dev) + 0.5) * BEV_STRIDE
    v = (torch.arange(BEV_FH, device=dev) + 0.5) * BEV_STRIDE
    width, height = BEV_FW * BEV_STRIDE, BEV_FH * BEV_STRIDE
    xs, ys, zs = [], [], []
    for yaw, fov in zip(BEV_YAWS, BEV_FOVS):
        focal = width / 2 / math.tan(math.radians(fov) / 2)
        yaw = math.radians(yaw + rng.normal(0.0, 1.0))
        mount = (1.0 * math.cos(yaw) + rng.normal(0.0, 0.05), 1.0 * math.sin(yaw) + rng.normal(0.0, 0.05),
                 1.6 + rng.normal(0.0, 0.05))
        d = depths[:, None, None]
        left = -(u[None, None, :] - width / 2) / focal * d  # (D, 1, W)
        up = -(v[None, :, None] - height / 2) / focal * d  # (D, H, 1)
        fwd = d.expand(-1, BEV_FH, BEV_FW)
        left, up = left.expand(-1, BEV_FH, -1), up.expand(-1, -1, BEV_FW)
        xs.append(math.cos(yaw) * fwd - math.sin(yaw) * left + mount[0])
        ys.append(math.sin(yaw) * fwd + math.cos(yaw) * left + mount[1])
        zs.append(up + mount[2])
    x, y, z = (torch.stack(a).reshape(-1) for a in (xs, ys, zs))
    gx = torch.floor((x - BEV_XY[0]) / BEV_XY[2]).to(torch.int32)
    gy = torch.floor((y - BEV_XY[0]) / BEV_XY[2]).to(torch.int32)
    gz = torch.floor((z - BEV_Z[0]) / BEV_Z[2]).to(torch.int32)
    kept = (gx >= 0) & (gx < BEV_GRID[2]) & (gy >= 0) & (gy < BEV_GRID[3]) & (gz >= 0) & (gz < BEV_GRID[1])
    geom = torch.stack([gx, gy, gz, torch.zeros_like(gx)], dim=1)
    context = torch.randn((BEV_CAMERAS, 1, BEV_FH, BEV_FW, BEV_C), generator=gen, device=dev)
    depth = torch.softmax(2.0 * torch.randn((BEV_CAMERAS, len(depths), BEV_FH, BEV_FW, 1), generator=gen,
                                            device=dev), dim=1)
    feats = (depth * context).reshape(-1, BEV_C)
    frustum_points = feats.shape[0]
    feats, geom = feats[kept], geom[kept]
    ranks = geom[:, 0].long() * BEV_GRID[3] + geom[:, 1]  # BEVFusion's rank: x, then y (Z = batch = 1)
    order = torch.argsort(ranks, stable=True)
    feats, geom, ranks = feats[order].to(dtype).contiguous(), geom[order].contiguous(), ranks[order]
    starts_mask = torch.ones_like(ranks, dtype=torch.bool)
    starts_mask[1:] = ranks[1:] != ranks[:-1]
    starts = torch.nonzero(starts_mask).squeeze(1).to(torch.int32)
    ends = torch.cat([starts[1:], torch.tensor([ranks.numel()], dtype=torch.int32, device=dev)])
    lengths = ends - starts
    return {"feats": feats, "geom": geom, "starts": starts, "lengths": lengths, "point_cells": ranks,
            "frustum_points": frustum_points, "longest": int(lengths.max())}


def small_bev_cases(rng) -> list[tuple[str, tuple, torch.dtype]]:
    """What the BEVFusion inputs miss, as (name, (feats, geom, starts,
    lengths, grid), dtype) on the card: cells shared by neighbouring
    intervals (scatter-add), cells outside the grid (batch past the end, a
    negative x, y = Y which a flat index would wrap) including one between
    two intervals of one cell, f16, and channel counts that are not a
    multiple of 4."""
    def case(num_intervals, max_len, channels, gx, gy):
        lengths = rng.integers(1, max_len + 1, size=num_intervals)
        starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])
        n = int(lengths.sum())
        cells = np.sort(rng.choice(gx * gy, size=num_intervals, replace=False))
        geom = np.zeros((n, 4), dtype=np.int32)
        for s, ln, cell in zip(starts, lengths, cells):
            geom[s : s + ln] = (cell // gy, cell % gy, 0, 0)
        feats = rng.normal(size=(n, channels)).astype(np.float32)
        return feats, geom, starts, lengths, (1, 1, gx, gy)

    feats, geom, starts, lengths, grid = case(700, 9, 24, 32, 32)
    for a, b in ((13, 14), (40, 41), (41, 42)):  # a run of three at 40
        geom[starts[a] : starts[a] + lengths[a]] = geom[starts[b]]
    dup = (feats, geom, starts, lengths, grid)
    feats, geom, starts, lengths, grid = case(60, 6, 16, 8, 8)
    geom[starts[10] : starts[10] + lengths[10]] = geom[starts[9]]  # 9, 10, 12 share a cell; 11 is dropped
    geom[starts[12] : starts[12] + lengths[12]] = geom[starts[9]]
    geom[starts[11] : starts[11] + lengths[11], 3] = 1  # batch past the end
    geom[starts[30] : starts[30] + lengths[30], 0] = -1
    geom[starts[31] : starts[31] + lengths[31], 1] = grid[3]
    geom[starts[-1] : starts[-1] + lengths[-1], 3] = 1
    outside = (feats, geom, starts, lengths, grid)
    cases = [("duplicate cells, C 24", dup, torch.float32), ("cells outside the grid", outside, torch.float32),
             ("f16, C 80", case(40, 9, 80, 16, 16), torch.float16),
             ("C 6", case(40, 9, 6, 16, 16), torch.float32), ("C 5", case(40, 9, 5, 16, 16), torch.float32),
             ("bf16, C 6", case(40, 9, 6, 16, 16), torch.bfloat16)]
    out = []
    for name, (feats, geom, starts, lengths, grid), dtype in cases:
        t = [torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in (feats, geom, starts, lengths)]
        out.append((name, (t[0].to(dtype), t[1], t[2].to(torch.int32), t[3].to(torch.int32), grid), dtype))
    return out


def rounding_step(dtype: torch.dtype) -> float:
    """One rounding step of ``dtype`` relative to |ref|: its machine epsilon;
    f32 is held at the JAX test's 1e-5."""
    return 1e-5 if dtype == torch.float32 else torch.finfo(dtype).eps


def check_bev_forward(name: str, out: torch.Tensor, ref: torch.Tensor) -> float:
    """K13a against its plain version: f32 at 1e-5 + 1e-5 |ref|, bf16 / f16
    at one rounding step times |ref|."""
    tol = rounding_step(ref.dtype)
    if out.dtype != ref.dtype or out.shape != ref.shape:
        raise AssertionError(f"K13a {name}: {out.dtype} {tuple(out.shape)}, expected {ref.dtype} {tuple(ref.shape)}")
    diff = (out.float() - ref.float()).abs()
    err = diff.max().item() if diff.numel() else 0.0
    limit = (1e-5 if ref.dtype == torch.float32 else 0.0) + tol * ref.float().abs()
    print(f"K13a bev_pool_fwd {name}: max_abs_err {err:.3e} (tolerance {tol:.1e} x |ref|"
          f"{' + 1e-5' if ref.dtype == torch.float32 else ''})", flush=True)
    if not bool((diff <= limit).all()):
        raise AssertionError(f"K13a {name}: outside tolerance (max_abs_err {err})")
    return err


def check_equal(name: str, out: torch.Tensor, ref: torch.Tensor) -> None:
    """Bit for bit: same dtype, shape and bytes."""
    same = out.dtype == ref.dtype and out.shape == ref.shape and torch.equal(
        out.reshape(-1).view(torch.uint8), ref.reshape(-1).view(torch.uint8))
    print(f"{name}: {'bit for bit equal' if same else 'DIFFERS'}", flush=True)
    if not same:
        raise AssertionError(f"{name}: differs from its plain version")


def nms_boxes(rng, n: int, ties: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """``n`` boxes of 5 to 50 units across a 1000 x 1000 field, and scores on
    the card; with ``ties``, scores on a 1/64 grid (about 64 boxes a score)."""
    centers = rng.uniform(0, 1000, size=(n, 2))
    sizes = rng.uniform(5, 50, size=(n, 2))
    boxes = np.concatenate([centers - sizes / 2, centers + sizes / 2], 1).astype(np.float32)
    scores = rng.uniform(0, 1, n).astype(np.float32)
    if ties:
        scores = np.round(scores * 64) / 64
    return torch.from_numpy(boxes).cuda(), torch.from_numpy(scores.astype(np.float32)).cuda()


def kernel_phases_vision(gen, rng) -> list[dict]:
    """K13a and K13b at BEVFusion's size (f32 and bf16) and on the small
    cases; K13c at 4096 boxes (IoU 0.5, tied scores) and on N = 1, 513,
    identical boxes and ties. Rows: the f32 pool, its backward, NMS at
    4096; ``detail`` the rest."""
    from conch_tpu_torch.kernels.vision.bev_pool import (
        bev_pool_backward_launcher as bwd,
        bev_pool_backward_plain as bwd_plain,
        bev_pool_forward_launcher as fwd,
        bev_pool_plain as fwd_plain,
    )
    from conch_tpu_torch.kernels.vision.nms import nms_keep_mask_launcher as keep_mask, sorted_boxes
    from conch_tpu_torch.kernels.vision.nms import nms_keep_mask_plain as keep_plain

    for name, (feats, geom, starts, lengths, grid), _ in small_bev_cases(rng):
        check_bev_forward(name, fwd(feats, geom, starts, lengths, *grid), fwd_plain(feats, geom, starts, lengths, *grid))
        g = torch.randn((*grid, feats.shape[1]), generator=gen, device="cuda").to(feats.dtype)
        check_equal(f"K13b bev_pool_bwd {name}", bwd(g, geom, starts, lengths, feats.shape[0]),
                    bwd_plain(g, geom, starts, lengths, feats.shape[0]))
    fwd_detail, bwd_detail = [], []
    for dtype in (torch.float32, torch.bfloat16):
        bev = bevfusion_inputs(gen, np.random.default_rng(SEED), dtype)
        feats, geom, starts, lengths = bev["feats"], bev["geom"], bev["starts"], bev["lengths"]
        n, ni, es = feats.shape[0], starts.numel(), feats.element_size()
        label = f"BEVFusion {str(dtype).split('.')[-1]}, {n} of {bev['frustum_points']} points kept, {ni} intervals"
        print(f"{label}, longest {bev['longest']} points", flush=True)
        args = (feats, geom, starts, lengths, *BEV_GRID)
        out = fwd(*args)
        err = check_bev_forward(label, out, fwd_plain(*args))
        grid_rows = math.prod(BEV_GRID)
        lib_out = torch.zeros((grid_rows, BEV_C), dtype=dtype, device="cuda")
        cells = bev["point_cells"]
        b_ms, b_by = bound(n * BEV_C * es + grid_rows * BEV_C * es + ni * 24, n * BEV_C, F32_OPS_PER_S)
        fwd_detail.append({
            "case": label, "max_abs_err": err, "bound_ms": b_ms, "bound_by": b_by, "ms": time_ms(lambda: fwd(*args)),
            "paced_ms": paced_ms(lambda: fwd(*args)), "plain_ms": time_ms(lambda: fwd_plain(*args), iters=3, warmup=1),
            "library_ms": time_ms(lambda: lib_out.index_add_(0, cells, feats)),
        })
        grad = torch.randn((*BEV_GRID, BEV_C), generator=gen, device="cuda").to(dtype)
        bargs = (grad, geom, starts, lengths, n)
        check_equal(f"K13b bev_pool_bwd {label}", bwd(*bargs), bwd_plain(*bargs))
        grad_rows = grad.view(-1, BEV_C)
        b_ms, b_by = bound(ni * BEV_C * es + n * BEV_C * es + ni * 24, 0, F32_OPS_PER_S)
        bwd_detail.append({
            "case": label, "max_abs_err": 0.0, "bound_ms": b_ms, "bound_by": b_by, "ms": time_ms(lambda: bwd(*bargs)),
            "paced_ms": paced_ms(lambda: bwd(*bargs)), "plain_ms": time_ms(lambda: bwd_plain(*bargs), iters=3, warmup=1),
            "library_ms": time_ms(lambda: grad_rows.index_select(0, cells)),
        })
        del bev, feats, geom, starts, lengths, out, lib_out, cells, grad, grad_rows, args, bargs
        torch.cuda.empty_cache()

    identical = (torch.tensor([[0.0, 0.0, 10.0, 10.0]] * 5, device="cuda"),
                 torch.tensor([0.1, 0.9, 0.5, 0.3, 0.7], device="cuda"))
    lattice_boxes, lattice_scores = nms_boxes(rng, 200, ties=True)
    lattice_boxes = torch.round(lattice_boxes / 25.0) * 25.0  # touching boxes, IoU exactly 1/3, 1/2, 0
    nms_cases = [("N 1", nms_boxes(rng, 1)), ("N 513", nms_boxes(rng, 513)), ("identical boxes", identical),
                 ("lattice, tied scores", (lattice_boxes, lattice_scores))]
    for name, (boxes, scores) in nms_cases:
        for t in (0.3, 0.5, 0.7):
            _, parts = sorted_boxes(boxes, scores)
            check_equal(f"K13c nms {name} IoU {t}", keep_mask(*parts, t), keep_plain(*parts, t))
    boxes, scores = nms_boxes(rng, NMS_BOXES, ties=True)
    _, parts = sorted_boxes(boxes, scores)
    kept = keep_mask(*parts, NMS_IOU)
    check_equal(f"K13c nms {NMS_BOXES} boxes IoU {NMS_IOU} (tied scores; {int(kept.sum())} kept)", kept,
                keep_plain(*parts, NMS_IOU))
    pairs = NMS_BOXES * (NMS_BOXES - 1) / 2
    b_ms, b_by = bound(5 * 4 * NMS_BOXES + NMS_BOXES, 20 * pairs, F32_OPS_PER_S)
    nms_timed = {
        "max_abs_err": 0.0, "bound_ms": b_ms, "bound_by": b_by, "ms": time_ms(lambda: keep_mask(*parts, NMS_IOU)),
        "paced_ms": paced_ms(lambda: keep_mask(*parts, NMS_IOU)),
        "plain_ms": time_ms(lambda: keep_plain(*parts, NMS_IOU), iters=1, warmup=0), "library_ms": None,
    }
    rows = []
    for name, source, replaces, detail in (
        ("bev_pool_fwd", "conch_tpu_torch/csrc/bev_pool.cu",
         "conch_tpu/kernels/vision/bev_pool.py:99; conch_tpu/kernels/vision/bev_pool.py:169", fwd_detail),
        ("bev_pool_bwd", "conch_tpu_torch/csrc/bev_pool.cu",
         "conch_tpu/kernels/vision/bev_pool.py:256; conch_tpu/kernels/vision/bev_pool.py:286", bwd_detail),
        ("nms", "conch_tpu_torch/csrc/nms.cu", "conch_tpu/kernels/vision/nms.py:43", [nms_timed]),
    ):
        for d in detail:
            print(f"{name} ({d.get('case', f'{NMS_BOXES} boxes')}): {d['ms']:.4f} ms (paced {d['paced_ms']:.4f}, plain "
                  f"{d['plain_ms']:.4f}, library {d['library_ms']}, bound {d['bound_ms']:.5f} by {d['bound_by']})",
                  flush=True)
        row = _kernel_row(name, source, replaces, max(d["max_abs_err"] for d in detail), detail[0],
                          detail[0]["bound_ms"], detail[0]["bound_by"])
        row["detail"] = detail
        rows.append(row)
    torch.cuda.empty_cache()
    return rows


# K13c's sweep (check_nms_options): box counts across the word edges, a
# few words, the served 4096, 20000 (bands streamed in chunks) and 40000
# (band 0, 320 KB, larger than shared memory); IoU thresholds.
NMS_OPTION_SIZES = (1, 2, 63, 64, 65, 513, 4096, 20000)
NMS_STREAMED = 40000
NMS_OPTION_IOUS = (0.3, 0.5, 0.7)


def _poisoned_empty(numel: int, dtype: torch.dtype, value) -> None:
    """Fill and free a block of ``numel`` elements: the caching allocator hands
    the same memory to the next allocation of that size, so an output
    element a kernel leaves unwritten shows as ``value``."""
    poison = torch.full((numel,), value, dtype=dtype, device="cuda")
    del poison


def check_nms_options(gen, rng) -> None:
    """K13c over NMS_OPTION_SIZES x NMS_OPTION_IOUS (tied scores), the
    lattice (touching boxes, IoU exactly 1/3 and 1/2) at 200 and 4096,
    identical boxes in one word and across three, and NMS_STREAMED at IoU
    0.5: bit for bit against the plain keep mask, the keep buffer's memory
    filled with 7 first (neither True nor False). Counts cases whose bands
    stream in chunks."""
    from conch_tpu_torch.kernels.vision.nms import nms_keep_mask_launcher as keep_mask
    from conch_tpu_torch.kernels.vision.nms import nms_keep_mask_plain as keep_plain
    from conch_tpu_torch.kernels.vision.nms import band_row_words, nms_plan, sorted_boxes

    t0 = time.perf_counter()
    cases = [(f"N {n}, tied scores", nms_boxes(rng, n, ties=True), NMS_OPTION_IOUS) for n in NMS_OPTION_SIZES]
    for n in (200, 4096):
        boxes, scores = nms_boxes(rng, n, ties=True)
        cases.append((f"lattice N {n}", (torch.round(boxes / 25.0) * 25.0, scores), NMS_OPTION_IOUS))
    for n in (5, 130):
        identical = (torch.tensor([[0.0, 0.0, 10.0, 10.0]] * n, device="cuda"),
                     torch.from_numpy(rng.uniform(0, 1, n).astype(np.float32)).cuda())
        cases.append((f"identical boxes N {n}", identical, NMS_OPTION_IOUS))
    cases.append((f"N {NMS_STREAMED}, tied scores", nms_boxes(rng, NMS_STREAMED, ties=True), (NMS_IOU,)))
    failed, count, streamed = [], 0, 0
    for name, (boxes, scores), ious in cases:
        _, parts = sorted_boxes(boxes, scores)
        n = boxes.shape[0]
        plan = nms_plan(n)
        for t in ious:
            ref = keep_plain(*parts, t)
            _poisoned_empty(n, torch.uint8, 7)
            got = keep_mask(*parts, t)
            count += 1
            streamed += plan.chunk_words < band_row_words(plan.words, 0)
            if not torch.equal(got.view(torch.uint8), ref.view(torch.uint8)):
                failed.append(f"{name} IoU {t}: {int((got.view(torch.uint8) != ref.view(torch.uint8)).sum())} of {n} "
                              f"differ ({int(ref.sum())} kept)")
    torch.cuda.synchronize()
    print(f"K13c nms options: {count} cases ({streamed} with bands streamed in chunks), bit for bit against the "
          f"plain keep mask: {count - len(failed)} equal, in {time.perf_counter() - t0:.1f} s", flush=True)
    if failed:
        raise AssertionError(f"K13c nms options: {len(failed)} of {count} cases differ: " + "; ".join(failed[:10]))
    torch.cuda.empty_cache()


def bev_trap_case(rng, num_points: int, grid: tuple[int, int, int, int]) -> tuple[np.ndarray, ...]:
    """Sorted intervals over ``num_points`` points with every case K13b's
    search must get right (tests/test_torch_vision_plan.py builds the same
    kinds): a negative start, points before an interval, zero-length
    intervals sharing a start with a real one (before and after it) and
    inside gaps, a dropped interval (batch past the end) between two
    intervals of one cell, a dropped x, an end past the last point, and
    intervals starting at and past it. (geom, starts, lengths)."""
    cells_xy = grid[2] * grid[3]
    starts, lengths, cells = [-4], [7], [5]
    p = 6
    while p < num_points - 80:
        kind, length, cell = int(rng.integers(0, 6)), int(rng.integers(1, 40)), int(rng.integers(0, cells_xy))
        if kind == 0:
            starts += [p, p]
            lengths += [0, length]
            cells += [cell, cell]
        elif kind == 1:
            starts += [p, p]
            lengths += [length, 0]
            cells += [cell, cell]
        elif kind == 2:
            length = int(rng.integers(1, 5))
            starts.append(p + length - 1)
            lengths.append(0)
            cells.append(0)
        else:
            starts.append(p)
            lengths.append(length)
            cells.append(cell)
        p += length
    for length, cell in ((5, 60), (4, -1), (6, 60), (3, -2)):
        starts.append(p)
        lengths.append(length)
        cells.append(cell)
        p += length
    starts += [p + 2, num_points, num_points + 3]
    lengths += [num_points, 4, 2]
    cells += [9, 10, 11]
    geom = np.zeros((num_points, 4), dtype=np.int32)
    for st, ln, cell in zip(starts, lengths, cells):
        lo, hi = max(st, 0), min(st + ln, num_points)
        geom[lo:hi] = ((0, 0, 0, grid[0]) if cell == -1 else (-1, 0, 0, 0) if cell == -2
                       else (cell // grid[3], cell % grid[3], 0, 0))
    return geom, np.asarray(starts, dtype=np.int32), np.asarray(lengths, dtype=np.int32)


# K13b's sweep (check_bev_backward_options): channel counts giving vectors of
# 1, 2, 4 and 8 elements by the row width, and grad bases moved by 0 to 4
# elements, which cut the vector by alignment.
BEV_OPTION_CHANNELS = (5, 6, 12, 24, 80)
BEV_OPTION_OFFSETS = (0, 1, 2, 4)
BEV_OPTION_POINTS = (3000, 400_000)


def check_bev_backward_options(gen, rng) -> None:
    """K13b over f32, bf16 and f16, BEV_OPTION_CHANNELS, grad bases at
    BEV_OPTION_OFFSETS elements and two trap cases (``bev_trap_case``, 3000
    points: a tile a warp; 400000: several), the output's memory filled with
    NaN before each call: bit for bit against the plain backward. Counts the
    cases at each vector width."""
    from conch_tpu_torch.kernels.vision.bev_pool import bev_pool_backward_launcher as bwd
    from conch_tpu_torch.kernels.vision.bev_pool import bev_pool_backward_plain as bwd_plain
    from conch_tpu_torch.kernels.vision.bev_pool import vector_width

    t0 = time.perf_counter()
    grid = (2, 1, 16, 16)
    failed, widths, count = [], {}, 0
    for num_points in BEV_OPTION_POINTS:
        geom, starts, lengths = (torch.from_numpy(a).cuda() for a in bev_trap_case(rng, num_points, grid))
        for dtype, channels, offset in itertools.product((torch.float32, torch.bfloat16, torch.float16),
                                                         BEV_OPTION_CHANNELS, BEV_OPTION_OFFSETS):
            rows = math.prod(grid)
            flat = torch.randn((rows * channels + offset,), generator=gen, device="cuda").to(dtype)
            grad = flat[offset:].view(*grid, channels)  # contiguous, its base moved by ``offset`` elements
            ref = bwd_plain(grad, geom, starts, lengths, num_points)
            _poisoned_empty(num_points * channels, dtype, float("nan"))
            got = bwd(grad, geom, starts, lengths, num_points)
            vec = vector_width(channels, grad.element_size(), grad, got)
            widths[vec] = widths.get(vec, 0) + 1
            count += 1
            same = got.dtype == ref.dtype and got.shape == ref.shape and torch.equal(
                got.view(torch.uint8), ref.view(torch.uint8))
            if not same:
                bad = int((got.view(torch.uint8) != ref.view(torch.uint8)).reshape(num_points, -1).any(1).sum())
                failed.append(f"{dtype} C {channels} offset {offset} {num_points} points (V {vec}): {bad} rows differ")
        del geom, starts, lengths
    torch.cuda.synchronize()
    by_vec = ", ".join(f"V {v}: {c}" for v, c in sorted(widths.items()))
    print(f"K13b bev_pool_bwd options: {count} cases ({by_vec}), output NaN-filled first, bit for bit against the "
          f"plain backward: {count - len(failed)} equal, in {time.perf_counter() - t0:.1f} s", flush=True)
    if failed:
        raise AssertionError(f"K13b options: {len(failed)} of {count} cases differ: " + "; ".join(failed[:10]))
    torch.cuda.empty_cache()


# K13a's sweep (check_bev_forward_options): channel counts giving vectors of
# 1, 2, 4 and 8 elements by the row width (rows of a multiple of 16 bytes go
# through TMA stages, the rest are read from global memory), feature bases
# moved by one element, which cut the vector to 1 or 2.
BEV_FWD_OPTION_CHANNELS = (5, 6, 12, 24, 80)
BEV_FWD_OPTION_OFFSETS = (0, 1)
BEV_FWD_LONG = 100_000  # points of the one long interval
# Each coordinate out of its range in turn: (x, y, z, b) offsets from the
# grid's (X, Y, Z, B), applied by bev_forward_trap_case.
BEV_OUT_OF_RANGE = ((-1, 0, 0, 0), (1, 0, 0, 0), (0, -1, 0, 0), (0, 1, 0, 0), (0, 0, -1, 0), (0, 0, 1, 0),
                    (0, 0, 0, -1), (0, 0, 0, 1))


def bev_cell_coords(cell: int, grid: tuple[int, int, int, int]) -> tuple[int, int, int, int]:
    """(x, y, z, b) of a flat cell ((b*Z + z)*X + x)*Y + y."""
    _, gz, gx, gy = grid
    return (cell // gy) % gx, cell % gy, (cell // (gx * gy)) % gz, cell // (gz * gx * gy)


def bev_out_of_range(kind: int, grid: tuple[int, int, int, int]) -> tuple[int, int, int, int]:
    """A geom row with one coordinate outside its range (kind picks which,
    and whether below or above)."""
    b, z, x, y = grid
    dx, dy, dz, db = BEV_OUT_OF_RANGE[kind % len(BEV_OUT_OF_RANGE)]
    return (-1 if dx < 0 else x if dx else 0, -1 if dy < 0 else y if dy else 0, -1 if dz < 0 else z if dz else 0,
            -1 if db < 0 else b if db else 0)


def bev_forward_trap_case(rng, num_points: int, grid: tuple[int, int, int, int],
                          tile_points: int) -> tuple[np.ndarray, ...]:
    """Intervals in K13a's contract (ascending starts, ascending kept cells,
    disjoint) over ``num_points`` points with every case its ownership of
    intervals, runs and grid rows must get right (tests/test_torch_vision_
    plan.py holds its model on them): a negative start; the grid's first
    cell; zero-length intervals, alone and sharing a start; runs of several
    intervals of one cell with a dropped interval between them (one
    coordinate out of range, each in turn); runs across a tile edge of
    ``tile_points``; gaps of points in no interval and of empty cells; an
    interval longer than several tiles; the grid's last cell; an end past the
    last point; intervals starting at and past it. Points in no kept
    interval lie outside the grid. (geom, starts, lengths)."""
    cells_total = math.prod(grid)
    starts, lengths, cells = [-3], [5], [None]  # a negative start: dropped (its points 0 and 1 in no interval)
    p, cell, drops = 2, 0, 0
    starts.append(p)
    lengths.append(4)
    cells.append(0)  # the grid's first cell
    p += 4
    max_step = max(1, (cells_total - 8) // (num_points // 20 + 8))
    long = min(3 * tile_points + 17, num_points // 3)
    while p < num_points - long - 100:
        kind, length = int(rng.integers(0, 8)), int(rng.integers(1, 40))
        cell = min(cell + int(rng.integers(1, max_step + 1)), cells_total - 2)
        if kind == 0:  # a zero-length interval sharing its start with the next
            starts += [p, p]
            lengths += [0, length]
            cells += [cell, cell]
        elif kind == 1:  # a run of three intervals, a dropped one between the first two
            for ln, c in ((length, cell), (int(rng.integers(1, 9)), -1 - drops), (int(rng.integers(1, 30)), cell),
                          (int(rng.integers(1, 30)), cell)):
                starts.append(p)
                lengths.append(ln)
                cells.append(c)
                p += ln
            drops += 1
            continue
        elif kind == 2:  # a run across the next tile edge, when the edge is near
            edge = (p // tile_points + 1) * tile_points
            if edge - p > 60:
                starts.append(p)
                lengths.append(length)
                cells.append(cell)
            else:
                head = edge - p - int(rng.integers(0, min(3, edge - p)))
                starts += [p, p + head]
                lengths += [head, length]
                cells += [cell, cell]
                length += head
        elif kind == 3:  # points in no interval, a zero-length interval among them (dropped: outside the grid)
            length = int(rng.integers(1, 6))
            starts.append(p + length - 1)
            lengths.append(0)
            cells.append(None)
        else:
            starts.append(p)
            lengths.append(length)
            cells.append(cell)
        p += length
    cell = min(cell + 1, cells_total - 2)
    starts.append(p)  # longer than several tiles (where the points allow)
    lengths.append(long)
    cells.append(cell)
    p += long
    starts.append(p)  # the grid's last cell, running past the last point
    lengths.append(num_points)
    cells.append(cells_total - 1)
    starts += [num_points, num_points + 3]  # starting at and past the points
    lengths += [4, 2]
    cells += [None, None]
    assert (np.diff(starts) >= 0).all() and p < num_points
    geom = np.empty((num_points, 4), dtype=np.int32)
    geom[:] = bev_out_of_range(7, grid)  # points in no kept interval: batch past the end
    for st, ln, c in zip(starts, lengths, cells):
        lo, hi = max(st, 0), min(st + ln, num_points)
        if c is not None and lo < hi:
            geom[lo:hi] = bev_out_of_range(-1 - c, grid) if c < 0 else bev_cell_coords(c, grid)
    return geom, np.asarray(starts, dtype=np.int32), np.asarray(lengths, dtype=np.int32)


def bev_forward_option_cases(rng) -> list[tuple[str, tuple, tuple, tuple]]:
    """check_bev_forward_options' cases as (name, (geom, starts, lengths) on
    the card, grid, channel counts, base offsets): the trap cases at 3000
    points (a few tiles) and 400,000 (hundreds), no kept interval, one
    interval of BEV_FWD_LONG points."""
    from conch_tpu_torch.kernels.vision.bev_pool import FWD_TILE_POINTS

    small, large = (2, 2, 16, 16), (2, 1, 128, 128)
    cases = [(f"traps, {n} points", bev_forward_trap_case(rng, n, grid, FWD_TILE_POINTS), grid, BEV_FWD_OPTION_CHANNELS,
              BEV_FWD_OPTION_OFFSETS) for n, grid in ((3000, small), (400_000, large))]
    geom = np.tile(np.asarray(bev_out_of_range(7, small), dtype=np.int32), (500, 1))
    starts = np.arange(0, 500, 10, dtype=np.int32)
    cases.append(("no kept interval", (geom, starts, np.full_like(starts, 10)), small, BEV_FWD_OPTION_CHANNELS,
                  BEV_FWD_OPTION_OFFSETS))
    n = BEV_FWD_LONG + 20
    geom = np.zeros((n, 4), dtype=np.int32)
    geom[:10] = bev_cell_coords(3, small)
    geom[10 : 10 + BEV_FWD_LONG] = bev_cell_coords(7, small)
    geom[10 + BEV_FWD_LONG :] = bev_cell_coords(700, small)
    starts = np.asarray([0, 10, 10 + BEV_FWD_LONG], dtype=np.int32)
    lengths = np.asarray([10, BEV_FWD_LONG, 10], dtype=np.int32)
    # Its plain version adds the points one after the other: C 6 and 80 at aligned bases only.
    cases.append((f"one interval of {BEV_FWD_LONG} points", (geom, starts, lengths), small, (6, 80), (0,)))
    return [(name, tuple(torch.from_numpy(a).cuda() for a in arrays), grid, channels, offsets)
            for name, arrays, grid, channels, offsets in cases]


def check_bev_forward_options(gen, rng) -> None:
    """K13a over f32, bf16 and f16, BEV_FWD_OPTION_CHANNELS, feature bases at
    BEV_FWD_OPTION_OFFSETS elements, the cases of ``bev_forward_option_cases``
    and BEVFusion's inputs (f32 and bf16), the output's memory filled with
    NaN before each call: bit for bit against the plain forward. Counts the
    cases at each vector width and those whose rows went through TMA."""
    from conch_tpu_torch.kernels.vision.bev_pool import bev_forward_plan, vector_width
    from conch_tpu_torch.kernels.vision.bev_pool import bev_pool_forward_launcher as fwd
    from conch_tpu_torch.kernels.vision.bev_pool import bev_pool_plain as fwd_plain

    t0 = time.perf_counter()
    failed, widths, count, tma = [], {}, 0, 0

    def one(name, feats, geom, starts, lengths, grid):
        nonlocal count, tma
        ref = fwd_plain(feats, geom, starts, lengths, *grid)
        _poisoned_empty(ref.numel(), feats.dtype, float("nan"))
        got = fwd(feats, geom, starts, lengths, *grid)
        channels = feats.shape[1]
        vec = vector_width(channels, feats.element_size(), feats, got)
        widths[vec] = widths.get(vec, 0) + 1
        tma += bev_forward_plan(feats.shape[0], channels, feats.element_size(), vec).tma
        count += 1
        if not (got.dtype == ref.dtype and got.shape == ref.shape
                and torch.equal(got.view(torch.uint8), ref.view(torch.uint8))):
            bad = int((got.view(torch.uint8) != ref.view(torch.uint8)).reshape(-1, channels * feats.element_size())
                      .any(1).sum())
            failed.append(f"{name} (V {vec}): {bad} grid rows differ")

    for name, (geom, starts, lengths), grid, channel_counts, offsets in bev_forward_option_cases(rng):
        num_points = geom.shape[0]
        for dtype, channels, offset in itertools.product((torch.float32, torch.bfloat16, torch.float16),
                                                         channel_counts, offsets):
            flat = torch.randn((num_points * channels + offset,), generator=gen, device="cuda").to(dtype)
            feats = flat[offset:].view(num_points, channels)  # contiguous, its base moved by ``offset`` elements
            one(f"{name}, {dtype} C {channels} offset {offset}", feats, geom, starts, lengths, grid)
        del geom, starts, lengths
    for dtype in (torch.float32, torch.bfloat16):
        bev = bevfusion_inputs(gen, np.random.default_rng(SEED), dtype)
        one(f"BEVFusion {dtype}", bev["feats"], bev["geom"], bev["starts"], bev["lengths"], BEV_GRID)
        del bev
    torch.cuda.synchronize()
    by_vec = ", ".join(f"V {v}: {c}" for v, c in sorted(widths.items()))
    print(f"K13a bev_pool_fwd options: {count} cases ({by_vec}; {tma} through TMA stages), output NaN-filled first, "
          f"bit for bit against the plain forward: {count - len(failed)} equal, in {time.perf_counter() - t0:.1f} s",
          flush=True)
    if failed:
        raise AssertionError(f"K13a options: {len(failed)} of {count} cases differ: " + "; ".join(failed[:10]))
    torch.cuda.empty_cache()


def pillars_cloud(rng) -> np.ndarray:
    """A KITTI-like sweep at PointPillars' range: points thin out with
    distance from the sensor (about 10% land outside the range), and 3% sit
    on voxel boundaries (x, y = min + k * 0.16 in f32, or one ulp off),
    where a multiplication by the reciprocal and a true division part."""
    n = PILLAR_POINTS
    r = 2.0 + 78.0 * rng.random(n) ** 1.5
    phi = rng.uniform(-math.pi / 2.2, math.pi / 2.2, n)
    pts = np.stack([r * np.cos(phi), r * np.sin(phi), rng.uniform(-3.3, 1.2, n), rng.random(n)], 1).astype(np.float32)
    edge = rng.choice(n, n * 3 // 100, replace=False)
    lo, vd = np.float32(PILLARS["min_range"][1]), np.float32(0.16)
    k = rng.integers(0, 432, edge.size).astype(np.float32)
    pts[edge, 0] = k * vd
    pts[edge, 1] = lo + rng.integers(0, 496, edge.size).astype(np.float32) * vd
    ulp = rng.integers(-1, 2, (edge.size, 2))
    for axis in (0, 1):
        step = np.where(ulp[:, axis] > 0, np.float32(np.inf), np.float32(-np.inf))
        moved = ulp[:, axis] != 0
        pts[edge[moved], axis] = np.nextafter(pts[edge[moved], axis], step[moved])
    return pts


def check_voxelization(rng) -> dict:
    """``generate_voxels``, and ``voxelization_stable`` with
    ``collect_point_features``, at PointPillars' KITTI size on the card and on
    the CPU from the same points: every output equal, element for element.
    Plain torch (no kernel), so this is where a division done another way
    on the card would show."""
    from conch_tpu_torch.ops.vision import (
        VoxelizationParameter, collect_point_features, generate_voxels, voxelization_stable,
    )

    param = VoxelizationParameter(**PILLARS)
    pts = torch.from_numpy(pillars_cloud(rng))

    def run(points):
        gen_out = generate_voxels(points, param)
        stable = voxelization_stable(points, param)
        return (*gen_out, *stable, *collect_point_features(points, stable[0], stable[1], param))

    card = run(pts.cuda())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(pts.cuda())
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    cpu = run(pts)
    names = ("num_filled", "point_features", "voxel_indices", "num_points_per_voxel", "stable counts",
             "point_indices", "flat_voxel_indices", "stable num_filled", "collected features", "capped counts")
    for name, a, b in zip(names, card, cpu, strict=True):
        check_equal(f"voxelization {name} card vs CPU {tuple(b.shape)}", a.cpu(), b)
    filled, stable_filled = int(cpu[0]), int(cpu[7])
    print(f"voxelization: {PILLAR_POINTS} points, generate_voxels {filled} voxels, voxelization_stable "
          f"{stable_filled} voxels; both on the card in {card_s * 1e3:.1f} ms (host clock, one call each)", flush=True)
    return {"generate_voxels": filled, "voxelization_stable": stable_filled}


def vision_path(card: str) -> dict:
    """The public vision ops in a perception stack's order, at full size:
    voxelize a PointPillars sweep, pool BEVFusion's camera features onto the
    BEV grid and back-propagate a loss through the pool
    (``loss.backward()``), then NMS over 4096 boxes. Counts set to 0 just
    before, read just after; checks: finite outputs of the expected shapes,
    the gradient equal bit for bit to the plain backward of the loss's
    gradient, the kept boxes equal to the plain keep mask's. Then a profiled
    repeat (after the counts are read)."""
    from conch_tpu_torch.kernels.vision.bev_pool import bev_pool_backward_plain, bev_pool_plain
    from conch_tpu_torch.kernels.vision.nms import nms_keep_mask_plain, sorted_boxes
    from conch_tpu_torch.ops.vision import VoxelizationParameter, bev_pool, generate_voxels, nms

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    rng = np.random.default_rng(SEED + 1)
    param = VoxelizationParameter(**PILLARS)
    points = torch.from_numpy(pillars_cloud(rng)).cuda()
    bev = bevfusion_inputs(gen, rng)
    feats = bev["feats"].requires_grad_(True)
    boxes, scores = nms_boxes(rng, NMS_BOXES, ties=True)

    def run():
        feats.grad = None
        num_filled, voxel_feats, _, _ = generate_voxels(points, param)
        pooled = bev_pool(feats, bev["geom"], bev["starts"], bev["lengths"], *BEV_GRID)
        loss = (pooled**2).sum()
        loss.backward()
        return num_filled, voxel_feats, pooled, loss, nms(boxes, scores, NMS_IOU)

    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    num_filled, voxel_feats, pooled, loss, keep = run()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launch_counts()
    if pooled.shape != (*BEV_GRID, BEV_C) or not bool(torch.isfinite(pooled).all()) or not math.isfinite(loss.item()):
        raise AssertionError(f"vision path: pooled {tuple(pooled.shape)}, not finite or not of the grid's shape")
    if voxel_feats.shape != (param.max_num_voxels, 32, 4) or int(num_filled) <= 0:
        raise AssertionError("vision path: voxelization gave no voxels")
    check_equal("vision path: pooled vs the plain forward", pooled.detach(),
                bev_pool_plain(feats.detach(), bev["geom"], bev["starts"], bev["lengths"], *BEV_GRID))
    check_equal("vision path: feats.grad vs the plain backward of 2 * pooled", feats.grad,
                bev_pool_backward_plain(2 * pooled.detach(), bev["geom"], bev["starts"], bev["lengths"],
                                        feats.shape[0]))
    order, parts = sorted_boxes(boxes, scores)
    check_equal("vision path: nms vs the plain keep mask", keep,
                order[nms_keep_mask_plain(*parts, NMS_IOU)].to(torch.int32))
    print(f"vision_bevfusion: voxelized {PILLAR_POINTS} points ({int(num_filled)} pillars), pooled "
          f"{feats.shape[0]} points onto {BEV_GRID} x {BEV_C} and back, kept {keep.numel()} of {NMS_BOXES} boxes in "
          f"{seconds * 1e3:.1f} ms on {card} (host clock, first call); launches "
          f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    for name in VISION_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"{name} was never launched on the vision path")
    profile_run(run, "vision_bevfusion")
    del bev, feats, pooled, loss, points, voxel_feats
    gc.collect()
    torch.cuda.empty_cache()
    return launches


VISION_KERNELS = ("bev_pool_fwd", "bev_pool_bwd", "nms")

# Llama-3-8B's seven projections of a layer as torch.nn.Linear stores them,
# (out_features, in_features): q, k, v, o, gate, up, down; then lm_head.
LLAMA_LINEARS = ((4096, 4096), (1024, 4096), (1024, 4096), (4096, 4096), (14336, 4096), (14336, 4096), (4096, 14336))
LLAMA_LM_HEAD = (128256, 4096)
QLORA_LAUNCHES = 7 * 32 + 1


def qlora_path(card: str) -> dict:
    """QLoRA's storage of Llama-3-8B, through the public ops: every
    projection of the 32 layers and the lm_head (bf16 random weights from a
    seeded generator, made one layer at a time) to ``quantize_4bit(nf4,
    blocksize 64, compress_statistics=True)`` (K12q, then the 8-bit dynamic
    code of the absmax in plain torch) and back with ``dequantize_4bit``
    (the absmax recovered in f32, then K12d). Counts set to 0 just before,
    read just after: K12q and K12d 225 launches each. Check on every
    weight: the decode is finite bf16 of the weight's size, and each
    ``|w - deq|`` is at most NF4's largest half-gap times the block's
    absmax, plus the double quantization's error of that absmax, plus a
    bf16 rounding (2^-8 of the absmax). Then a profiled repeat of one layer."""
    from conch_tpu_torch.kernels.quantization.bitsandbytes.blockwise import NF4_CODE
    from conch_tpu_torch.ops.quantization.bitsandbytes import dequantize_4bit, dequantize_blockwise, quantize_4bit

    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    half_gap = max((b - a) / 2 for a, b in zip(NF4_CODE, NF4_CODE[1:]))
    worst = {"err_over_absmax": 0.0, "absmax_err": 0.0}
    codec_s = 0.0

    def roundtrip(w: torch.Tensor):
        packed, state = quantize_4bit(w, blocksize=NF4_BLOCK, compress_statistics=True, quant_type="nf4")
        return state, dequantize_4bit(packed, state)

    def check_weight(w: torch.Tensor, state, deq: torch.Tensor) -> None:
        if deq.dtype != torch.bfloat16 or deq.shape != (w.numel(),) or not bool(torch.isfinite(deq).all()):
            raise AssertionError(f"QLoRA round trip of {tuple(w.shape)}: {deq.dtype} {tuple(deq.shape)} or not finite")
        blocks = w.float().view(-1, NF4_BLOCK)
        absmax = blocks.abs().amax(dim=1)
        recovered = dequantize_blockwise(state.absmax, quant_state=state.state2) + state.offset
        absmax_err = (recovered - absmax).abs()
        err = (deq.float().view(-1, NF4_BLOCK) - blocks).abs()
        limit = (half_gap + 2**-8) * absmax + absmax_err
        if not bool((err <= limit[:, None] + 1e-12).all()):
            raise AssertionError(f"QLoRA round trip of {tuple(w.shape)}: an error above NF4's half-gap bound")
        worst["err_over_absmax"] = max(worst["err_over_absmax"], (err.amax(dim=1) / absmax).max().item())
        worst["absmax_err"] = max(worst["absmax_err"], (absmax_err / absmax).max().item())

    def make(shape: tuple[int, int]) -> torch.Tensor:
        return (0.02 * torch.randn(shape, generator=gen, device="cuda")).to(torch.bfloat16)

    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    values = 0
    for layer in range(NUM_LAYERS_POOL + 1):
        weights = [make(shape) for shape in LLAMA_LINEARS] if layer < NUM_LAYERS_POOL else [make(LLAMA_LM_HEAD)]
        for w in weights:
            values += w.numel()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            state, deq = roundtrip(w)
            torch.cuda.synchronize()
            codec_s += time.perf_counter() - t1
            check_weight(w, state, deq)
            del state, deq
        last = weights if layer < NUM_LAYERS_POOL else last
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launch_counts()
    print(f"llama3_8b_qlora: {QLORA_LAUNCHES} weights (32 layers x 7 projections + lm_head, {values} values) to "
          f"nf4 with double quantization and back in {seconds:.3f} s on {card} (host clock, weights made and "
          f"checked in it; the codec calls alone {codec_s:.3f} s); largest |w - deq| / absmax "
          f"{worst['err_over_absmax']:.5f} (NF4 half-gap {half_gap:.5f}), largest absmax error of the double "
          f"quantization {worst['absmax_err']:.2e} of the absmax; launches "
          f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    for name in ("quantize4", "dequantize4"):
        if launches[name] != QLORA_LAUNCHES:
            raise AssertionError(f"{name}: {launches[name]} launches on the QLoRA path, expected {QLORA_LAUNCHES}")
    profile_run(lambda: [roundtrip(w) for w in last], "llama3_8b_qlora (one layer)")
    del last, weights
    torch.cuda.empty_cache()
    return launches


STREAM_ROWS = 2048  # a prefill chunk of tokens


def residual_stream_path(card: str) -> dict:
    """K4b through its public op, as a decoder stack calls it: Llama-3-8B's
    residual stream (bf16, hidden 4096) at a 2048-token chunk, each of the
    32 layers' two norms adding the sublayer's new output to the residual
    and normalizing the sum, ``h, residual = fused_add_rms_norm(out,
    residual, w, eps)``. The sublayers' outputs and the norm weights are
    random (seeded). Counts set to 0 just before, read just after: 64
    launches. Check: the final residual bit for bit and the final output at
    NORM_TOLERANCES against the plain op chained on the same inputs."""
    from conch_tpu_torch.kernels.normalization.rms_norm import fused_add_rms_norm_plain
    from conch_tpu_torch.ops.normalization import fused_add_rms_norm

    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    eps = 1e-5
    sublayers = 2 * NUM_LAYERS_POOL
    outs = [torch.randn((STREAM_ROWS, HIDDEN), generator=gen, device="cuda").to(torch.bfloat16) for _ in range(sublayers)]
    norms = [(1.0 + 0.1 * torch.randn((HIDDEN,), generator=gen, device="cuda")).to(torch.bfloat16)
             for _ in range(sublayers)]
    start = torch.randn((STREAM_ROWS, HIDDEN), generator=gen, device="cuda").to(torch.bfloat16)

    def run(op):
        h, residual = None, start
        for out, w in zip(outs, norms):
            h, residual = op(out, residual, w, eps)
        return h, residual

    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    h, residual = run(fused_add_rms_norm)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launch_counts()
    ref_h, ref_residual = run(fused_add_rms_norm_plain)
    check_equal("residual stream: the final residual", residual, ref_residual)
    check_close("residual stream: the final normalized output", h, ref_h, NORM_TOLERANCES[torch.bfloat16])
    print(f"llama3_8b_residual_stream: {sublayers} fused_add_rms_norm calls at {STREAM_ROWS} x {HIDDEN} bf16 in "
          f"{seconds * 1e3:.2f} ms on {card} (host clock, first call); launches "
          f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    if launches["fused_add_rms_norm"] != sublayers:
        raise AssertionError(f"fused_add_rms_norm: {launches['fused_add_rms_norm']} launches, expected {sublayers}")
    del outs, norms, start, h, residual, ref_h, ref_residual
    torch.cuda.empty_cache()
    return launches


def gemm_output_types(gen, by_name: dict) -> None:
    """``mixed_precision_gemm(..., output_dtype=torch.float32)`` from bf16
    activations through K1 (int4 magic, group 128), K1b (int8 planar) and
    K1c (NF4 rows) at Llama-3-8B's wo (K = N = 4096), M = 8 and 512, layer
    17 of a 32-layer stack: the f32 store against the plain version at the
    kernels' tolerance (1e-2 x max |ref|), timed beside the bf16 store
    (``out_f32`` in each row). A float16 output must raise on the card; a
    bfloat16 acc_dtype is recorded only (JAX's kernels never read it), so
    its call must equal the float32 acc_dtype call bit for bit."""
    from conch_tpu_torch.kernels.quantization.bitsandbytes.blockwise import NF4_CODE
    from conch_tpu_torch.kernels.quantization.gemm import (
        mixed_gemm_magic_plain,
        mixed_gemm_planar_plain,
        mixed_gemm_rows_plain,
    )
    from conch_tpu_torch.ops.quantization import mixed_precision_gemm

    k = n = HIDDEN

    def stack(words_per_k: int, groups: int, scale_dtype) -> tuple[torch.Tensor, torch.Tensor]:
        packed = torch.randint(-(2**31), 2**31 - 1, (NUM_LAYERS_POOL, k // words_per_k, n), generator=gen,
                               device="cuda", dtype=torch.int32)
        scales = (torch.rand((NUM_LAYERS_POOL, k // groups, n), generator=gen, device="cuda") * 4e-3 + 1e-4)
        return packed, scales.to(scale_dtype)

    cases = {
        "mixed_gemm_magic": (*stack(8, GROUP, torch.bfloat16), (4, 8, GROUP), {"layout": "magic"},
                             mixed_gemm_magic_plain, lambda p, s: (p, s, GROUP, 8)),
        "mixed_gemm_planar": (*stack(4, GROUP, torch.bfloat16), (8, 128, GROUP), {"layout": "planar"},
                              mixed_gemm_planar_plain, lambda p, s: (p, s, None, 8, 128, GROUP)),
        "mixed_gemm_rows": (*stack(8, NF4_BLOCK, torch.float32), (4, 0, NF4_BLOCK),
                            {"layout": "gptq", "codebook": NF4_CODE},
                            mixed_gemm_rows_plain, lambda p, s: (p, s, None, 4, 0, NF4_BLOCK, NF4_CODE)),
    }
    for name, (packed, scales, (bits, bias, group), kw, plain, plain_args) in cases.items():
        by_name[name]["out_f32"] = []
        for m in (8, 512):
            x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)

            def op(out_dtype, layer=LAYER):
                return mixed_precision_gemm(x, packed, scales, None, bits, bias, group, output_dtype=out_dtype,
                                            layer_index=layer, **kw)

            out = op(torch.float32)
            ref = plain(x, *plain_args(packed, scales), LAYER, torch.float32)
            torch.cuda.synchronize()
            if out.dtype != torch.float32 or ref.dtype != torch.float32:
                raise AssertionError(f"{name}: output_dtype float32 gave {out.dtype} (plain {ref.dtype})")
            scale = ref.abs().max().item()
            e = (out - ref).abs().max().item()
            check(f"{name} f32 store M={m} K={k} N={n} (max|ref| {scale:.3f})", e, 1e-2 * scale)
            layers = _stack_cycle()
            case = {"m": m, "k": k, "n": n, "max_abs_err": e,
                    "ms": time_ms(lambda: op(torch.float32, next(layers))),
                    "bf16_store_ms": time_ms(lambda: op(torch.bfloat16, next(layers)))}
            by_name[name]["out_f32"].append(case)
            print(f"{name} M={m}: f32 store {case['ms']:.4f} ms, bf16 store {case['bf16_store_ms']:.4f} ms", flush=True)
        try:
            mixed_precision_gemm(x, packed, scales, None, bits, bias, group, layer_index=LAYER, output_dtype=torch.float16,
                                 **kw)
        except NotImplementedError as exc:
            if "float16" not in str(exc):
                raise AssertionError(f"{name} output_dtype float16: the error does not name float16: {exc}") from exc
        else:
            raise AssertionError(f"{name} output_dtype float16: no error on the card")
        acc = {dt: mixed_precision_gemm(x, packed, scales, None, bits, bias, group, layer_index=LAYER, acc_dtype=dt,
                                        **kw) for dt in (torch.bfloat16, torch.float32)}
        if not torch.equal(acc[torch.bfloat16], acc[torch.float32]):
            raise AssertionError(f"{name}: acc_dtype bfloat16 differs from acc_dtype float32 on the card")
        print(f"{name} M={x.shape[0]}: acc_dtype bfloat16 equal to acc_dtype float32 bit for bit", flush=True)
        del packed, scales
    torch.cuda.empty_cache()


TP = 8  # Llama-3-8B's tensor-parallel degree on an 8-card host
RING_SIZES = (1, 2, 4, 8)
# (rows, cols) of one rank's shard: a 512-row prefill chunk over 8 ranks at
# Llama-3-8B's width, and rows 1 x cols 4097, whose bytes are no multiple of
# 16 (bf16 8194, f32 16388, int8 4097: 2-, 4- and 1-byte copies).
RING_SHAPES = ((512 // TP, HIDDEN), (1, HIDDEN + 1))
RING_LONG = (2048, HIDDEN)  # long context: 128 MiB out per rank in bf16, 1 GiB over the ring
RING_SKEW_CYCLES = 200_000  # about 0.1 ms of torch.cuda._sleep ahead of a late rank


def ring_shards(gen, n: int, shape: tuple[int, int], dtype: torch.dtype) -> list[torch.Tensor]:
    """n random shards, each in a buffer of its own on the card."""
    if dtype == torch.int8:
        return [torch.randint(-128, 128, shape, generator=gen, device="cuda", dtype=torch.int8) for _ in range(n)]
    return [torch.randn(shape, generator=gen, device="cuda").to(dtype) for _ in range(n)]


def check_ring(name: str, out: list[torch.Tensor], shards: list[torch.Tensor], quiet: bool = False) -> None:
    """Every rank's K14 result bit for bit equal to its plain version."""
    from conch_tpu_torch.kernels.collectives.ring_all_gather import ring_all_gather_plain

    ref = ring_all_gather_plain(shards)
    same = len(out) == len(ref) and all(
        o.dtype == r.dtype and o.shape == r.shape
        and torch.equal(o.reshape(-1).view(torch.uint8), r.reshape(-1).view(torch.uint8))
        for o, r in zip(out, ref)
    )
    if not quiet or not same:
        print(f"{name}: {'every rank bit for bit equal' if same else 'DIFFERS'}", flush=True)
    if not same:
        raise AssertionError(f"{name}: differs from its plain version")


def check_ring_error(phase: str) -> None:
    """Fail loudly if a K14 wait timed out in ``phase``."""
    from conch_tpu_torch.kernels.collectives.ring_all_gather import decode_ring_error, ring_error

    code = ring_error()
    print(f"K14 error word after {phase}: {code:#x} ({decode_ring_error(code)})", flush=True)
    if code:
        raise AssertionError(f"K14 {phase}: {decode_ring_error(code)}")


def kernel_phase_k14(gen) -> dict:
    """K14 on rings of 1, 2, 4 and 8 virtual ranks on the card, every result
    bit for bit against the plain version: both launch modes (one
    cooperative launch; one launch per rank on its own stream), f32, bf16
    and int8, the TP-8 shard (several blocks a rank) and a 1 x 4097 one (one
    block a rank); 100 back-to-back calls on one flag buffer, modes
    alternating, each checked; per-rank launches with ``torch.cuda._sleep``
    queued ahead of some ranks' streams so they enter late; a deliberate
    timeout (a rank more than the 2 s timeout late) that must set the error
    word and make ``check_ring_error`` raise, then a clean call. The error
    word is read after every phase. Timed at the TP-8 shard (64 x 4096
    bf16, 8 ranks: 4 MiB out per rank) and the long-context one (2048 x
    4096), beside the plain version and n ``torch.cat`` calls; bound =
    (n^2 + n) shard bytes / 3.35 TB/s: each input read once, each output
    written once, on the one HBM all ranks share."""
    from conch_tpu_torch.kernels.collectives.ring_all_gather import (
        TIMEOUT_S,
        check_ring_error as raise_on_ring_error,
        ring_all_gather_launcher as launch,
        ring_all_gather_plain as plain,
        ring_error,
    )

    streams = [torch.cuda.Stream() for _ in range(max(RING_SIZES))]
    calls = 0
    for n in RING_SIZES:
        for shape in RING_SHAPES:
            for dtype in (torch.float32, torch.bfloat16, torch.int8):
                shards = ring_shards(gen, n, shape, dtype)
                for per_rank in (False, True):
                    out = launch(shards, rank_streams=streams[:n] if per_rank else None)
                    mode = "per-rank" if per_rank else "cooperative"
                    check_ring(f"K14 n={n} {shape} {dtype} {mode}", out, shards, quiet=True)
                    calls += 1
    torch.cuda.synchronize()
    print(f"K14: {calls} calls on rings of {RING_SIZES} ranks, both modes, every rank bit for bit equal", flush=True)
    check_ring_error("the mode, size and dtype cases")

    # 100 back-to-back calls on one flag buffer (n = 8, the TP-8 shard), the
    # modes alternating, the inputs rotated so every call's result differs.
    base = ring_shards(gen, TP, RING_SHAPES[0], torch.bfloat16)
    runs = []
    for c in range(100):
        shards = base[c % TP:] + base[: c % TP]
        runs.append((shards, launch(shards, rank_streams=streams[:TP] if c % 2 else None)))
    torch.cuda.synchronize()
    for c, (shards, out) in enumerate(runs):
        check_ring(f"K14 back-to-back call {c}", out, shards, quiet=True)
    print("K14: 100 back-to-back calls on one flag buffer, every rank of every call bit for bit equal", flush=True)
    del runs
    check_ring_error("the back-to-back calls")

    # Skewed entry: sleeps queued ahead of some ranks' streams.
    for n in (2, 4, 8):
        shards = ring_shards(gen, n, RING_SHAPES[0], torch.bfloat16)
        for pattern, late in (("odd ranks", range(1, n, 2)), ("rank 0", (0,)), ("all but the last", range(n - 1))):
            for r in late:
                with torch.cuda.stream(streams[r]):
                    torch.cuda._sleep(RING_SKEW_CYCLES * (1 + r % 3))
            out = launch(shards, rank_streams=streams[:n])
            check_ring(f"K14 n={n} per-rank, {pattern} late", out, shards)
    torch.cuda.synchronize()
    check_ring_error("the skewed per-rank launches")

    # A timeout must become an error word and an exception, never a hang;
    # the ring works after it. Rank 1 enters half a second after rank 0's
    # wait has run out, then times out itself waiting for rank 0's step.
    shards = ring_shards(gen, 2, RING_SHAPES[1], torch.float32)
    with torch.cuda.stream(streams[1]):
        torch.cuda._sleep(int((TIMEOUT_S + 0.5) * SM_CYCLES_PER_S))
    launch(shards, rank_streams=streams[:2])
    torch.cuda.synchronize()
    code = ring_error()
    print(f"K14 deliberate timeout: error word {code:#x}", flush=True)
    try:
        raise_on_ring_error()
    except RuntimeError as e:
        print(f"K14 deliberate timeout raised: {e}", flush=True)
    else:
        raise AssertionError(f"K14: a rank {TIMEOUT_S + 0.5} s late under a {TIMEOUT_S} s timeout did not raise")
    check_ring("K14 after the deliberate timeout", launch(shards, rank_streams=streams[:2]), shards)
    torch.cuda.synchronize()
    check_ring_error("the call after the deliberate timeout")

    def timed(shape: tuple[int, int]) -> dict:
        shards = ring_shards(gen, TP, shape, torch.bfloat16)
        shard_bytes = shards[0].numel() * 2
        b_ms, b_by = bound((TP * TP + TP) * shard_bytes, 0)
        case = {
            "case": f"{TP} ranks x {shape} bf16", "max_abs_err": 0.0, "bound_ms": b_ms, "bound_by": b_by,
            "ms": time_ms(lambda: launch(shards)), "paced_ms": paced_ms(lambda: launch(shards)),
            "per_rank_ms": time_ms(lambda: launch(shards, rank_streams=streams[:TP])),
            "plain_ms": time_ms(lambda: plain(shards)),
            "library_ms": time_ms(lambda: [torch.cat(shards) for _ in range(TP)]),
        }
        print(f"K14 {case['case']}: {case['ms']:.4f} ms (paced {case['paced_ms']:.4f}, per-rank launches "
              f"{case['per_rank_ms']:.4f}, plain {case['plain_ms']:.4f}, "
              f"{TP} torch.cat {case['library_ms']:.4f}, bound {b_ms:.5f} by {b_by}; "
              f"virtual ranks on one card)", flush=True)
        return case

    detail = [timed(RING_SHAPES[0]), timed(RING_LONG)]
    check_ring_error("the timed calls")
    row = _kernel_row("ring_all_gather", "conch_tpu_torch/csrc/ring_all_gather.cu",
                      "conch_tpu/kernels/collectives/ring_all_gather.py:44", 0.0, detail[0], detail[0]["bound_ms"],
                      detail[0]["bound_by"])
    row["detail"] = detail
    torch.cuda.empty_cache()
    return row


def tp8_collectives_path(card: str) -> tuple[dict, list[dict]]:
    """The collectives layer as Llama-3-8B's tensor parallelism at TP 8 calls
    it, on a ring of 8 virtual ranks on the card (``create_mesh(model=8,
    devices=[cuda:0] * 8)``), through ``conch_tpu_torch.parallel``:
    ``ring_all_gather`` of a 512-row prefill chunk (shards 64 x 4096 bf16)
    and of a long-context one (2048 x 4096 shards); in f32 and bf16,
    ``overlapped_allgather_matmul`` (x 512 x 4096 K-sharded to 512 x 512,
    w_local 4096 x 768: the fused wqkv's 6144 columns over 8) and
    ``overlapped_matmul_reduce_scatter`` (x_local 512 x 1792: w_down's 14336
    rows over 8; w_shard 1792 x 4096). Counts set to 0 just before, read
    just after: K14 launches twice. Checks: each gather bit for bit against
    the plain version and the unsharded input; each collective matmul
    against the unsharded product (f32 at 1e-4 + 1e-4 |ref|, bf16 within
    1e-2 x max |ref|). Then each is timed in bf16 beside the unsharded
    product (on virtual ranks: correctness and cost, no overlap)."""
    from conch_tpu_torch.parallel import (
        create_mesh,
        overlapped_allgather_matmul,
        overlapped_matmul_reduce_scatter,
        ring_all_gather,
    )

    require_full_f32("llama3_8b_tp8_collectives (as JAX's preferred_element_type=f32)")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    ranks = create_mesh(model=TP, devices=[torch.device("cuda", 0)] * TP).axis_devices("model")

    def split(t: torch.Tensor, dim: int) -> list[torch.Tensor]:
        return [c.to(d, copy=True).contiguous() for c, d in zip(t.chunk(TP, dim=dim), ranks)]

    chunk = torch.randn((512, HIDDEN), generator=gen, device="cuda").to(torch.bfloat16)
    long = torch.randn((RING_LONG[0] * TP, HIDDEN), generator=gen, device="cuda").to(torch.bfloat16)
    qkv_cols, down_k = 6144, INTER
    matmuls = {}
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn((512, HIDDEN), generator=gen, device="cuda")
        w = torch.randn((HIDDEN, qkv_cols), generator=gen, device="cuda") / math.sqrt(HIDDEN)
        x2 = torch.randn((512, down_k), generator=gen, device="cuda")
        w2 = torch.randn((down_k, HIDDEN), generator=gen, device="cuda") / math.sqrt(down_k)
        x, w, x2, w2 = (t.to(dtype) for t in (x, w, x2, w2))
        matmuls[dtype] = {"ag": (x, w, split(x, 1), split(w, 1)), "rs": (x2, w2, split(x2, 1), split(w2, 0))}
    gathers = {"prefill": split(chunk, 0), "long": split(long, 0)}

    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    gathered = {name: ring_all_gather(shards) for name, shards in gathers.items()}
    products = {
        dtype: (overlapped_allgather_matmul(m["ag"][2], m["ag"][3]), overlapped_matmul_reduce_scatter(m["rs"][2], m["rs"][3]))
        for dtype, m in matmuls.items()
    }
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launch_counts()
    check_ring_error("the TP-8 collectives path")
    for name, shards in gathers.items():
        check_ring(f"tp8 ring_all_gather ({name})", gathered[name], shards)
        whole = chunk if name == "prefill" else long
        if not all(torch.equal(g, whole) for g in gathered[name]):
            raise AssertionError(f"tp8 ring_all_gather ({name}): a rank's result is not the unsharded input")
    for dtype, (ag, rs) in products.items():
        for label, outs, (x, w, _, _) in (("allgather_matmul", ag, matmuls[dtype]["ag"]),
                                          ("matmul_reduce_scatter", rs, matmuls[dtype]["rs"])):
            got = torch.cat(outs, dim=1)
            ref = torch.matmul(x.float(), w.float())
            name = f"tp8 overlapped_{label} {dtype}"
            if dtype == torch.float32:
                check_close(name, got, ref, 1e-4)
            else:
                scale = ref.abs().max().item()
                check(f"{name} (max|ref| {scale:.3f})", (got.float() - ref).abs().max().item(), 1e-2 * scale)
    print(f"llama3_8b_tp8_collectives: 2 gathers and 4 collective matmuls on {TP} virtual ranks in "
          f"{seconds * 1e3:.2f} ms on {card} (host clock, first call); launches "
          f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    if launches["ring_all_gather"] != len(gathers):
        raise AssertionError(f"ring_all_gather: {launches['ring_all_gather']} launches, expected {len(gathers)}")

    # A collective matmul is about 310 eager launches at TP 8 (per hop and
    # rank: two upcasts, a product, an add, a copy). Device times come from
    # two calls, whose launches all fit in CUDA's launch queue behind
    # time_ms's sleep; with more the host blocks on the full queue and the
    # events time its pacing.
    x, w, xs, ws = matmuls[torch.bfloat16]["ag"]
    x2, w2, xs2, ws2 = matmuls[torch.bfloat16]["rs"]
    timings = [
        {"case": "overlapped_allgather_matmul bf16, x 512 x 512 x 8, w_local 4096 x 768",
         "ms": time_ms(lambda: overlapped_allgather_matmul(xs, ws), iters=2),
         "paced_ms": paced_ms(lambda: overlapped_allgather_matmul(xs, ws)),
         "unsharded_ms": time_ms(lambda: torch.matmul(x, w))},
        {"case": "overlapped_matmul_reduce_scatter bf16, x_local 512 x 1792, w_shard 1792 x 4096",
         "ms": time_ms(lambda: overlapped_matmul_reduce_scatter(xs2, ws2), iters=2),
         "paced_ms": paced_ms(lambda: overlapped_matmul_reduce_scatter(xs2, ws2)),
         "unsharded_ms": time_ms(lambda: torch.matmul(x2, w2))},
    ]
    for t in timings:
        print(f"tp8 {t['case']}: {t['ms']:.4f} ms (paced {t['paced_ms']:.4f}), unsharded product "
              f"{t['unsharded_ms']:.4f} ms on {card} (virtual ranks: no overlap)", flush=True)
    del gathers, gathered, products, matmuls, chunk, long
    torch.cuda.empty_cache()
    return launches, timings


# -- Rolling KV (Mistral-7B) and Qwen2-7B: K3/K7's ring, GQA group 7, K1 at
# Qwen2's shapes; K8 over e4m3 and K7's f32 loop kernel timed. ----------

# Mistral-7B-v0.1's published config.json (mistralai/Mistral-7B-v0.1): a
# 4096-token sliding window on every layer. The port's LlamaConfig carries
# it; the JAX package has no constructor for it either.
MISTRAL_WINDOW, MISTRAL_PREFILL = 4096, 512
MISTRAL_RING = -(-(MISTRAL_WINDOW + MISTRAL_PREFILL) // PS) + 1  # 289 pages: the rolling engine's ring
MISTRAL_TABLE = 448  # the unbounded twin's table: 7064 tokens in 442 pages
# K3's and K7's ring lines: 8 sequences at 4100 to 7064 tokens, all past
# the ring's 4624 but the first (which is past the window).
MISTRAL_LENS = [4100, 4523, 4946, 5369, 5792, 6215, 6640, 7064]
# Qwen2-7B (LlamaConfig.qwen2_7b()): 28 query heads over 4 KV heads of 128
# (a GQA group of 7), 28 layers. Its served decode step: 32 rows (the
# engine's max_batch_size), 8 live at 72 to 2032 tokens (prompts of 40 to
# 2000 plus 32 generated), over a 160-page table; its 512-row prefill
# step: a mixed-in decode row, a fresh 100-token prompt, the last 411
# tokens of a 2000-token prompt, zero-length padding sequences.
Q2_QH, Q2_KH, Q2_LAYERS, Q2_TABLE = 28, 4, 28, 160
K3_SERVED_QWEN2 = dict(zip((0, 3, 4, 9, 15, 20, 26, 31), (72, 300, 600, 900, 1200, 1500, 1800, 2032)))
# Qwen2-7B's int4 GEMMs in one layer, as the engine runs them: the fused
# wqkv, wo, w_gate and w_up apart (each N 18944 padded at pack time to
# 20480, the JAX packing's rule for a wide N whose largest 128-multiple
# divisor up to 2048 is below 1024, so the two cannot fuse) and w_down.
QWEN2_LAYER_SHAPES = {(3584, 4608): 1, (3584, 3584): 1, (3584, 20480): 2, (18944, 3584): 1}
# The padded shape -> the function's own: bounds count the true N, and K1
# is also timed there, so that the padded columns' time stands apart.
QWEN2_TRUE_SHAPES = {(3584, 20480): (3584, 18944)}
FP8_OPS_PER_S = 1979e12  # dense fp8 tensor-core peak


def mistral_7b_config():
    """Mistral-7B-v0.1 at its published config.json: vocab 32000, hidden
    4096, intermediate 14336, 32 layers, 32 heads over 8 KV heads of 128,
    rope_theta 10000, eps 1e-5, max_position 32768, sliding_window 4096."""
    from conch_tpu_torch.models.llama import LlamaConfig

    return LlamaConfig(
        vocab_size=32000, hidden_size=4096, intermediate_size=14336, num_layers=32, num_heads=32, num_kv_heads=8,
        head_dim=128, rope_theta=10000.0, rms_norm_eps=1e-5, max_position=32768, sliding_window=MISTRAL_WINDOW,
    )


def ring_twin_tables(rng, seq_lens: list[int], num_pages: int, width: int, ring: int) -> tuple[np.ndarray, np.ndarray]:
    """A linear table (B, width) of distinct random pages and the ring table
    (B, ring) a rolling engine holds at these lengths: entry j is the page of
    the sequence's last true page i with i % ring == j, so that every page
    of a window band no longer than the ring is the same physical page
    through either table, and the two calls read the same bytes."""
    linear = paged_layout(rng, seq_lens, num_pages, share=(0, 0), shared_pages=0, max_pages=width)
    ring_bt = np.zeros((len(seq_lens), ring), np.int32)
    for b, n in enumerate(seq_lens):
        for i in range(-(-n // PS)):
            ring_bt[b, i % ring] = linear[b, i]  # ascending: a later page takes its ring slot
    return linear, ring_bt


def _attention_row(name: str, kernel: str, replaces: str, err: float, entry: dict) -> dict:
    """A kernel-table row of K3 or K7 (``kernel``) from one timed case."""
    row = _kernel_row(name, f"conch_tpu_torch/csrc/{kernel}.cu", replaces, err, entry, entry["bound_ms"],
                      entry["bound_by"])
    row["detail"] = [entry]
    return row


def kernel_phase_ring(gen, rng) -> list[dict]:
    """K3 and K7 over a rolling-KV ring at Mistral-7B's shapes (QH 32 / KH 8
    / D 128, a 32-layer bf16 pool read at layer 17, window 4096, the
    rolling engine's ring of 289 pages): K3's decode step of 8 sequences at
    MISTRAL_LENS, K7's 512-row chunk (64 rows of each at the same lengths).
    Each is held against its plain version over the ring (K3 at 1e-2 x
    (|ref| + rms), K7 at 2e-2 + 2e-2 x |ref|) and against the same band
    through a linear table (``ring_twin_tables``), bit for bit, and timed
    beside it in turns (ring, linear, linear, ring). Returns the rows
    ``paged_attention_ring`` and ``varlen_attention_ring``."""
    from conch_tpu_torch.kernels.attention.paged_attention import (
        paged_attention_launcher as k3,
        paged_attention_plain as k3_plain,
    )
    from conch_tpu_torch.kernels.attention.varlen_attention import (
        varlen_attention_launcher as k7,
        varlen_attention_plain as k7_plain,
    )

    lens = MISTRAL_LENS
    num_pages = sum(-(-n // PS) for n in lens) + 1
    kc, vc = make_pool(gen, num_pages)
    linear, ring_bt = ring_twin_tables(rng, lens, num_pages, MISTRAL_TABLE, MISTRAL_RING)
    lin_t, ring_t = torch.from_numpy(linear).cuda(), torch.from_numpy(ring_bt).cuda()
    sl_t = torch.tensor(lens, dtype=torch.int32, device="cuda")
    rows = []

    def timed_pair(tag, ring_call, linear_call, plain_call, err, bound_ms, bound_by):
        turns = [time_ms(ring_call), time_ms(linear_call), time_ms(linear_call), time_ms(ring_call)]
        entry = {
            "case": tag, "max_abs_err": err, "bound_ms": bound_ms, "bound_by": bound_by,
            "ms": (turns[0] + turns[3]) / 2, "linear_ms": (turns[1] + turns[2]) / 2, "turns": turns,
            "paced_ms": paced_ms(ring_call), "linear_paced_ms": paced_ms(linear_call),
            "plain_ms": time_ms(plain_call, iters=3, warmup=1), "library_ms": None,
        }
        print(f"{tag}: ring {entry['ms']:.4f} ms, the same band through a linear table {entry['linear_ms']:.4f} "
              f"(turns {', '.join(f'{t:.4f}' for t in turns)}; paced {entry['paced_ms']:.4f} / "
              f"{entry['linear_paced_ms']:.4f}, plain {entry['plain_ms']:.4f}, bound {bound_ms:.5f} by {bound_by})",
              flush=True)
        return entry

    # K3: Mistral-7B's decode step.
    q = torch.randn((len(lens), QH, D), generator=gen, device="cuda").to(torch.bfloat16)
    args = (q, kc, vc, ring_t, sl_t, D**-0.5, LAYER, 0.0, MISTRAL_WINDOW, 1.0, 1.0, MISTRAL_RING)
    lin_args = (q, kc, vc, lin_t, sl_t, D**-0.5, LAYER, 0.0, MISTRAL_WINDOW)
    got, twin, ref = k3(*args), k3(*lin_args), k3_plain(*args)
    torch.cuda.synchronize()
    tag = f"K3 paged_attention ring of {MISTRAL_RING} pages, Mistral-7B decode of 8 at 4100 to 7064, window 4096"
    err = check_to_rms(tag, got, ref, 1e-2)
    if not torch.equal(got, twin):
        raise AssertionError(f"{tag}: differs from the same band through a linear table")
    case = {"shape": (QH, KH, D), "seq_lens": lens, "args": args, "bt": linear}
    b_ms, b_by = k3_bound(case, MISTRAL_WINDOW)
    entry = timed_pair(tag, lambda: k3(*args), lambda: k3(*lin_args), lambda: k3_plain(*args), err, b_ms, b_by)
    rows.append(_attention_row("paged_attention_ring", "paged_attention",
                               "conch_tpu/kernels/attention/paged_attention.py:57", err, entry))

    # K7: a 512-row chunk, 64 rows of each sequence.
    q_lens = [64] * len(lens)
    q = torch.randn((sum(q_lens), QH, D), generator=gen, device="cuda").to(torch.bfloat16)
    cu = torch.tensor(np.concatenate([[0], np.cumsum(q_lens)]), dtype=torch.int32, device="cuda")
    args = (q, kc, vc, cu, sl_t, ring_t, D**-0.5, True, LAYER, 0.0, MISTRAL_WINDOW, 1.0, 1.0, 1.0, MISTRAL_RING)
    lin_args = (q, kc, vc, cu, sl_t, lin_t, D**-0.5, True, LAYER, 0.0, MISTRAL_WINDOW)
    got, twin, ref = k7(*args), k7(*lin_args), k7_plain(*args)
    torch.cuda.synchronize()
    tag = f"K7 varlen_attention ring of {MISTRAL_RING} pages, Mistral-7B 512-row chunk at 4100 to 7064, window 4096"
    err = check_close(tag, got, ref, 2e-2)
    if not torch.equal(got, twin):
        raise AssertionError(f"{tag}: differs from the same band through a linear table")
    case = {"shape": (QH, KH, D), "q_lens": q_lens, "seq_lens": lens, "bt": linear, "args": args,
            "total": sum(q_lens)}
    b_ms, b_by = k7_bound(case, MISTRAL_WINDOW)
    entry = timed_pair(tag, lambda: k7(*args), lambda: k7(*lin_args), lambda: k7_plain(*args), err, b_ms, b_by)
    rows.append(_attention_row("varlen_attention_ring", "varlen_attention",
                               "conch_tpu/kernels/attention/varlen_attention.py:247", err, entry))
    del kc, vc
    torch.cuda.empty_cache()
    return rows


def kernel_phase_group7(gen, rng) -> list[dict]:
    """K3 and K7 at Qwen2-7B's GQA group of 7 (QH 28 / KH 4 / D 128, a
    28-layer bf16 pool read at layer 17): K3 at the served decode step
    (K3_SERVED_QWEN2, 1e-2 x (|ref| + rms), idle rows exactly zero), K7 at
    the 512-row prefill step (2e-2 + 2e-2 x |ref|). Returns the rows
    ``paged_attention_g7`` and ``varlen_attention_g7``."""
    from conch_tpu_torch.kernels.attention.paged_attention import (
        paged_attention_launcher as k3,
        paged_attention_plain as k3_plain,
    )
    from conch_tpu_torch.kernels.attention.varlen_attention import (
        varlen_attention_launcher as k7,
        varlen_attention_plain as k7_plain,
    )

    rows = []
    seq_lens = [K3_SERVED_QWEN2.get(i, 0) for i in range(32)]
    num_pages = sum(-(-n // PS) for n in seq_lens) + 1
    kc, vc = make_pool(gen, num_pages, Q2_LAYERS, Q2_KH, D)
    bt = paged_layout(rng, seq_lens, num_pages, share=(0, 0), shared_pages=0, max_pages=Q2_TABLE)
    q = torch.randn((len(seq_lens), Q2_QH, D), generator=gen, device="cuda").to(torch.bfloat16)
    args = (q, kc, vc, torch.from_numpy(bt).cuda(), torch.tensor(seq_lens, dtype=torch.int32, device="cuda"),
            D**-0.5, LAYER)
    got, ref = k3(*args), k3_plain(*args)
    torch.cuda.synchronize()
    idle = [i for i, n in enumerate(seq_lens) if n == 0]
    if not torch.isfinite(got).all() or got[idle].abs().max().item() != 0.0:
        raise AssertionError("K3 at group 7: idle rows must come out as finite zeros")
    tag = "K3 paged_attention group 7, Qwen2-7B's served decode step: 32 rows, 8 live at 72 to 2032"
    err = check_to_rms(tag, got, ref, 1e-2)
    b_ms, b_by = k3_bound({"shape": (Q2_QH, Q2_KH, D), "seq_lens": seq_lens, "args": args, "bt": bt}, 0)
    entry = {"case": tag, "max_abs_err": err, "bound_ms": b_ms, "bound_by": b_by, "ms": time_ms(lambda: k3(*args)),
             "paced_ms": paced_ms(lambda: k3(*args)), "plain_ms": time_ms(lambda: k3_plain(*args), iters=3, warmup=1),
             "library_ms": None}
    print(f"{tag}: {entry['ms']:.4f} ms (paced {entry['paced_ms']:.4f}, plain {entry['plain_ms']:.4f}, bound "
          f"{b_ms:.5f} by {b_by})", flush=True)
    rows.append(_attention_row("paged_attention_g7", "paged_attention",
                               "conch_tpu/kernels/attention/paged_attention.py:57", err, entry))
    del kc, vc

    q_lens = [1, 100, 411] + [0] * 29
    seq_lens = [1500, 100, 2000] + [0] * 29
    num_pages = sum(-(-n // PS) for n in seq_lens) + 1
    kc, vc = make_pool(gen, num_pages, Q2_LAYERS, Q2_KH, D)
    bt = paged_layout(rng, seq_lens, num_pages, share=(0, 0), shared_pages=0, max_pages=Q2_TABLE)
    q = torch.randn((512, Q2_QH, D), generator=gen, device="cuda").to(torch.bfloat16)
    cu = torch.tensor(np.concatenate([[0], np.cumsum(q_lens)]), dtype=torch.int32, device="cuda")
    args = (q, kc, vc, cu, torch.tensor(seq_lens, dtype=torch.int32, device="cuda"), torch.from_numpy(bt).cuda(),
            D**-0.5, True, LAYER)
    got, ref = k7(*args), k7_plain(*args)
    torch.cuda.synchronize()
    tag = "K7 varlen_attention group 7, Qwen2-7B's 512-row prefill step (a decode row, 100 and 411 new rows)"
    err = check_close(tag, got, ref, 2e-2)
    case = {"shape": (Q2_QH, Q2_KH, D), "q_lens": q_lens, "seq_lens": seq_lens, "bt": bt, "args": args,
            "total": sum(q_lens)}
    b_ms, b_by = k7_bound(case, 0)
    entry = {"case": tag, "max_abs_err": err, "bound_ms": b_ms, "bound_by": b_by, "ms": time_ms(lambda: k7(*args)),
             "paced_ms": paced_ms(lambda: k7(*args)), "plain_ms": time_ms(lambda: k7_plain(*args), iters=3, warmup=1),
             "library_ms": None}
    print(f"{tag}: {entry['ms']:.4f} ms (paced {entry['paced_ms']:.4f}, plain {entry['plain_ms']:.4f}, bound "
          f"{b_ms:.5f} by {b_by})", flush=True)
    rows.append(_attention_row("varlen_attention_g7", "varlen_attention",
                               "conch_tpu/kernels/attention/varlen_attention.py:247", err, entry))
    del kc, vc
    torch.cuda.empty_cache()
    return rows


def kernel_phase_k1_qwen2(gen) -> dict:
    """K1 at Qwen2-7B's int4 GEMMs (QWEN2_LAYER_SHAPES: fused wqkv N 4608,
    wo 3584 x 3584, w_gate and w_up each N 20480 padded, w_down K 18944),
    group 128, M in GEMM_MS, beside bf16 ``torch.matmul`` on the
    dequantized weight; the row is one layer's five launches summed at M 8,
    ``by_m`` at each M. The bounds of w_gate and w_up count the function's
    own N 18944 (QWEN2_TRUE_SHAPES), where K1 is timed too: ``padded`` has,
    at each M, the time of the two launches' padded columns (the padded
    launches less the unpadded ones) and its share of the layer."""
    detail = _k1_cases(gen, 128, (*QWEN2_LAYER_SHAPES, *QWEN2_TRUE_SHAPES.values()))
    true_case = {(d["k"], d["n"], d["m"]): d for d in detail}
    padded = {}
    for (k, n), (tk, tn) in QWEN2_TRUE_SHAPES.items():
        for d in (d for d in detail if (d["k"], d["n"]) == (k, n)):
            own = true_case[(tk, tn, d["m"])]
            d["padded_bound_ms"] = d["bound_ms"]
            d["bound_ms"], d["bound_by"] = own["bound_ms"], own["bound_by"]
            count = QWEN2_LAYER_SHAPES[(k, n)]
            padded[d["m"]] = {"ms": count * (d["ms"] - own["ms"]), "unpadded_ms": count * own["ms"]}
    timed = _layer_sums(detail, QWEN2_LAYER_SHAPES, 8)
    row = _kernel_row("mixed_gemm_magic_qwen2", "conch_tpu_torch/csrc/mixed_gemm_magic.cu",
                      "conch_tpu/kernels/quantization/gemm.py:658", max(d["max_abs_err"] for d in detail), timed,
                      timed["bound_ms"], "bytes")
    row["by_m"] = {m: _layer_sums(detail, QWEN2_LAYER_SHAPES, m) for m in GEMM_MS}
    for m, sums in row["by_m"].items():
        padded[m]["share"] = padded[m]["ms"] / sums["ms"]
        print(f"mixed_gemm_magic Qwen2-7B one layer at M={m}: {sums['ms']:.4f} ms (paced {sums['paced_ms']:.4f}, "
              f"bf16 matmul {sums['library_ms']:.4f}, bound {sums['bound_ms']:.5f} at N 18944); w_gate and w_up's "
              f"padded columns {padded[m]['ms']:.4f} ms, {100 * padded[m]['share']:.1f}% of the layer (the two at "
              f"N 18944: {padded[m]['unpadded_ms']:.4f} ms)", flush=True)
    row["padded"] = padded
    row["detail"] = detail
    return row


# DeepSeek-V2-Lite's GEMMs at group 32 (K, N), with their count in one MoE
# layer (26 of its 27): int4 (K1) keeps wq and w_kv_a apart (w_kv_a's N 576
# padded at pack time to 640) and fuses the shared experts' gate|up; int8
# (K1b) fuses [wq|w_kv_a] and the shared gate|up. The dense layer's
# gate|up (int4: each N 10944 padded to 12288, unfused) and w_down (K
# 10944) are timed beside them, in ``detail``.
DS_GROUP = 32
DS_INT4_LAYER_SHAPES = {(2048, 3072): 1, (2048, 640): 1, (2048, 2048): 1, (2048, 5632): 1, (2816, 2048): 1}
DS_INT4_DENSE_SHAPES = ((2048, 12288), (10944, 2048))
DS_INT8_LAYER_SHAPES = {(2048, 3648): 1, (2048, 2048): 1, (2048, 5632): 1, (2816, 2048): 1}
DS_INT8_DENSE_SHAPES = ((2048, 21888), (10944, 2048))
# Gemma-2-2B's int4 GEMMs (group 128), one of each a layer: fused wqkv, wo, fused gate|up, w_down.
GEMMA_K1_SHAPES = {(2304, 4096): 1, (2048, 2304): 1, (2304, 18432): 1, (9216, 2304): 1}


def kernel_phase_k1_g32(gen) -> dict:
    """K1 at group 32 (two groups a slice) at DeepSeek-V2-Lite's int4
    shapes (``DS_INT4_LAYER_SHAPES``, the dense layer's beside them), as
    ``_k1_cases`` runs them; the row is one MoE layer's five launches
    summed at M 8, ``by_m`` at each M."""
    detail = _k1_cases(gen, DS_GROUP, (*DS_INT4_LAYER_SHAPES, *DS_INT4_DENSE_SHAPES))
    return _layer_row("mixed_gemm_magic_g32", "conch_tpu_torch/csrc/mixed_gemm_magic.cu",
                      "conch_tpu/kernels/quantization/gemm.py:658", max(d["max_abs_err"] for d in detail), detail,
                      DS_INT4_LAYER_SHAPES)


def kernel_phase_k1_gemma(gen) -> dict:
    """K1 at Gemma-2-2B's int4 shapes (``GEMMA_K1_SHAPES``, group 128), as
    ``_k1_cases`` runs them; the row is one layer's four launches at M 8."""
    detail = _k1_cases(gen, 128, tuple(GEMMA_K1_SHAPES))
    return _layer_row("mixed_gemm_magic_gemma", "conch_tpu_torch/csrc/mixed_gemm_magic.cu",
                      "conch_tpu/kernels/quantization/gemm.py:658", max(d["max_abs_err"] for d in detail), detail,
                      GEMMA_K1_SHAPES)


def kernel_phase_k1b_g32(gen) -> dict:
    """K1b at 8 word rows a slice: int8 planar codes at DeepSeek-V2-Lite's
    group 32 and its int8 engine's shapes (``DS_INT8_LAYER_SHAPES``, the
    dense layer's beside them), as ``_k1b_cases`` runs them. The row is one
    MoE layer's four launches at M 8, ``by_m`` at each M."""
    detail = _k1b_cases(gen, DS_GROUP, (*DS_INT8_LAYER_SHAPES, *DS_INT8_DENSE_SHAPES))
    return _layer_row("mixed_gemm_planar_g32", "conch_tpu_torch/csrc/mixed_gemm_planar.cu",
                      "conch_tpu/kernels/quantization/gemm.py:582", max(d["max_abs_err"] for d in detail), detail,
                      DS_INT8_LAYER_SHAPES)


def _scaled_mm_library(a8: torch.Tensor, b8s: list, sa: torch.Tensor, sb: torch.Tensor):
    """``torch._scaled_mm`` on K8's e4m3 inputs with row and column scales
    (the same function, bf16 out), over the weights ``b8s`` in turn (so not
    from L2); each laid out column-major once, outside the timed call.
    (callable, note), or (None, why) where this PyTorch refuses it."""
    copies = itertools.cycle([b.t().contiguous().t() for b in b8s])
    scale_a, scale_b = sa.reshape(-1, 1).float(), sb.reshape(1, -1).float()

    def call():
        return torch._scaled_mm(a8, next(copies), scale_a=scale_a, scale_b=scale_b, out_dtype=torch.bfloat16)

    try:
        call()
    except (RuntimeError, TypeError) as e:
        return None, f"torch._scaled_mm refused row-wise scales: {str(e).splitlines()[0][:120]}"
    return call, "torch._scaled_mm, row-wise scales, bf16 out, 3 weights in turn"


K8_FP8_MS = (16, 32, 512)  # torch._scaled_mm takes M in multiples of 16


def k8_e4m3_weights(gen, k: int, n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """A (NUM_LAYERS_POOL, K, N) float8_e4m3fn weight stack, N(0, 1) values,
    and its (layers, N) column scales."""
    w8 = torch.empty((NUM_LAYERS_POOL, k, n), dtype=torch.float8_e4m3fn, device="cuda")
    for layer in w8:
        layer.copy_(_e4m3((k, n), gen))
    return w8, torch.rand((NUM_LAYERS_POOL, n), generator=gen, device="cuda") * 1e-2 + 1e-3


def kernel_phase_k8_e4m3(gen) -> dict:
    """K8 over float8_e4m3fn (the mainloop's fp8 ``wgmma`` layout) at the
    w8a8 engine's fused shapes, M 16, 32 and 512, per-row and per-column
    scales, bf16 out, read from layer 17 of a 32-layer stack (timed calls
    walk the layers, so the weights come from HBM), held at E4M3_TOLERANCE
    x max |ref| against the plain version and timed beside
    ``torch._scaled_mm`` on the same inputs (three of the layers in turn).
    No model runs it: its launches are the checked calls of this phase, each
    on the mainloop. The row is one layer's sum at M 16, ``by_m`` at each
    M."""
    from conch_tpu_torch.kernels.quantization.gemm import scaled_gemm_launcher as launch, scaled_gemm_plain as plain

    detail, err, notes = [], 0.0, set()
    checked = 0
    for k, n in FUSED_LAYER_SHAPES:
        w8, sb_stack = k8_e4m3_weights(gen, k, n)
        sb = sb_stack[LAYER]
        for m in K8_FP8_MS:
            a8 = _e4m3((m, k), gen)
            sa = 1e-2 * torch.logspace(0, 1, m, device="cuda")
            before = launch.e4m3_launches
            out_k = launch(a8, w8, sa, sb_stack, torch.bfloat16, LAYER)
            checked += launch.e4m3_launches - before
            out_p = plain(a8, w8, sa, sb_stack, torch.bfloat16, LAYER)
            torch.cuda.synchronize()
            scale = out_p.float().abs().max().item()
            e = (out_k.float() - out_p.float()).abs().max().item()
            check(f"K8 scaled_gemm float8_e4m3fn M={m} K={k} N={n} (max|ref| {scale:.3f})", e,
                  E4M3_TOLERANCE * scale)
            err = max(err, e)
            library, note = _scaled_mm_library(a8, [w8[i] for i in (LAYER, 0, NUM_LAYERS_POOL - 1)], sa, sb)
            notes.add(note)
            if library is not None:
                lib = library().float()
                print(f"torch._scaled_mm M={m} K={k} N={n}: max |lib - plain| "
                      f"{(lib - out_p.float()).abs().max().item():.3e}", flush=True)
            b_ms, b_by = bound(m * k + k * n + m * 4 + n * 4 + m * n * 2, 2 * m * n * k, FP8_OPS_PER_S)
            layers = _stack_cycle()
            detail.append({
                "m": m, "k": k, "n": n, "max_abs_err": e, "bound_ms": b_ms, "bound_by": b_by,
                "ms": time_ms(lambda: launch(a8, w8, sa, sb_stack, torch.bfloat16, next(layers))),
                "paced_ms": paced_ms(lambda: launch(a8, w8, sa, sb_stack, torch.bfloat16, next(layers))),
                "plain_ms": time_ms(lambda: plain(a8, w8, sa, sb_stack, torch.bfloat16, LAYER), iters=3, warmup=1),
                "library_ms": None if library is None else time_ms(library),
            })
            del library
        del w8, sb_stack, sb
        torch.cuda.empty_cache()
    timed = _layer_sums(detail, FUSED_LAYER_SHAPES, K8_FP8_MS[0])
    by = "operations" if any(d["bound_by"] == "operations" for d in detail if d["m"] == K8_FP8_MS[0]) else "bytes"
    row = _kernel_row("scaled_gemm_e4m3", "conch_tpu_torch/csrc/scaled_gemm.cu",
                      "conch_tpu/kernels/quantization/gemm.py:739", err, timed, timed["bound_ms"], by)
    row["by_m"] = {m: _layer_sums(detail, FUSED_LAYER_SHAPES, m) for m in K8_FP8_MS}
    row["detail"] = detail
    for d in detail:
        print(f"scaled_gemm float8_e4m3fn M={d['m']} K={d['k']} N={d['n']}: {d['ms']:.4f} ms (paced "
              f"{d['paced_ms']:.4f}, plain {d['plain_ms']:.4f}, library {d['library_ms']}, bound "
              f"{d['bound_ms']:.5f} by {d['bound_by']})", flush=True)
    row["library_note"] = "; ".join(sorted(notes))
    row["phase_launches"] = checked
    if checked != len(detail):
        raise AssertionError(f"K8 e4m3: {checked} of {len(detail)} checked calls launched the mainloop")
    for m, sums in row["by_m"].items():
        print(f"scaled_gemm float8_e4m3fn one layer at M={m}: {sums['ms']:.4f} ms (library {sums['library_ms']}, "
              f"bound {sums['bound_ms']:.5f}; {checked} checked calls on the mainloop)", flush=True)
    return row


def kernel_phase_k7_f32(gen, rng) -> dict:
    """K7 under f32 queries (the per-row CUDA-core kernel) over an f32 pool
    at Llama-3-8B's table line (K7_CASES), held at 2e-3 against the plain
    version (the JAX package's f32 attention tolerance). No model runs it:
    its launches are this phase's checked call."""
    from conch_tpu_torch.kernels.attention.varlen_attention import (
        varlen_attention_launcher as launch,
        varlen_attention_plain as plain,
    )

    case = k7_inputs(gen, rng, "llama3_8b table line")
    q, kc, vc = (t.float() for t in case["args"][:3])
    args = (q, kc, vc, *case["args"][3:], 0)
    before = launch.launches
    got = launch(*args)
    checked = launch.launches - before
    ref = plain(*args)
    torch.cuda.synchronize()
    err = check_close("K7 varlen_attention f32 queries over an f32 cache, Llama-3-8B's table line", got, ref, 2e-3)
    b_ms, b_by = k7_bound({**case, "args": args}, 0, F32_OPS_PER_S)
    row = _kernel_row("varlen_attention_f32", "conch_tpu_torch/csrc/varlen_attention.cu",
                      "conch_tpu/kernels/attention/varlen_attention.py:247", err,
                      {"ms": time_ms(lambda: launch(*args)), "paced_ms": paced_ms(lambda: launch(*args)),
                       "plain_ms": time_ms(lambda: plain(*args), iters=5), "library_ms": None}, b_ms, b_by)
    row["phase_launches"] = checked
    del kc, vc
    torch.cuda.empty_cache()
    return row


def kernel_phases() -> list[dict]:
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rng = np.random.default_rng(SEED)
    rows = [
        kernel_phase_k1(gen), kernel_phase_k2(gen, rng), kernel_phase_k3(gen, rng), kernel_phase_k4(gen),
        kernel_phase_k5(gen, rng), kernel_phase_k6(gen), kernel_phase_k7(gen, rng), kernel_phase_k10a(gen),
        kernel_phase_k10b(gen), kernel_phase_k1b(gen), kernel_phase_k1c(gen), kernel_phase_k8(gen),
        kernel_phase_k12q(gen), kernel_phase_k11(gen, rng), kernel_phase_k9(gen), *kernel_phases_vision(gen, rng),
        kernel_phase_k4b(gen), kernel_phase_k12d(gen), kernel_phase_k14(gen), *kernel_phase_ring(gen, rng),
        *kernel_phase_group7(gen, rng), kernel_phase_k1_qwen2(gen), kernel_phase_k8_e4m3(gen),
        kernel_phase_k7_f32(gen, rng), kernel_phase_k1_g32(gen), kernel_phase_k1b_g32(gen), kernel_phase_k1_gemma(gen),
        *kernel_phases_verify(gen, rng), kernel_phase_k3_beam(gen, rng),
    ]
    # The Gemma-2-2B shapes of K2, K3, K5 and K7 go into their rows' detail
    # beside the Llama-3-8B numbers the rows keep.
    by_name = {r["name"]: r for r in rows}
    gemma = gemma_attention_phases(gen, rng)
    gemma["reshape_and_cache_stacked"] = [kernel_phase_k2(gen, rng, G_QH, G_KH, G_D, G_LAYERS)]
    gemma["rotary_embedding"] = [kernel_phase_k5(gen, rng, G_QH, G_KH, G_D, 10000.0, K5_TOKENS["gemma"])]
    for name, cases in gemma.items():
        for case in cases:
            kept = {k: v for k, v in case.items() if k not in ("name", "route", "source", "replaces")}
            entry = {"case": f"gemma2 KH {G_KH} D {G_D}", **kept}
            by_name[name].setdefault("detail", []).append(entry)
            if name in ("reshape_and_cache_stacked", "rotary_embedding"):
                print(f"{name} (gemma2 KH {G_KH} D {G_D}): {case['ms']:.4f} ms (paced {case['paced_ms']:.4f}, plain "
                      f"{case['plain_ms']:.4f}, bound {case['bound_ms']:.5f} by {case['bound_by']})", flush=True)
    by_name["paged_attention"]["served"] = kernel_phase_k3_served(gen, rng)
    row_kernel_pairs(gen, rng, by_name)
    check_rope_options(gen, rng)
    check_gemma_rms_norm_options(gen)
    check_rms_norm_options(gen)
    check_cache_write_options(gen, rng)
    check_gated_act_options(gen)
    check_attention_scales(gen)
    quantized_cache_phases(gen, rng, by_name)
    gemm_output_types(gen, by_name)
    check_quant_gemm_options(gen)
    check_magic_gemm_options(gen)
    check_paged_attention_options(gen, rng)
    check_varlen_attention_options(gen, rng)
    check_scaled_gemm_options(gen)
    check_mla_attention_options(gen, rng)
    check_quantize4_options(gen)
    check_nms_options(gen, rng)
    check_bev_backward_options(gen, rng)
    check_bev_forward_options(gen, rng)
    for r in rows:
        print(
            f"{r['name']}: {r['ms']:.4f} ms (paced {r['paced_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.5f} ms by "
            f"{r['bound_by']}, library {r['library_ms']})", flush=True,
        )
    torch.cuda.empty_cache()
    return rows


# Each kernel row's launchers: K6's and K10b's kernels have two entry points.
def _launchers() -> dict:
    from conch_tpu_torch.kernels.activation.gelu_tanh_and_mul import (
        gelu_tanh_and_mul_launcher,
        gelu_tanh_and_mul_parts_launcher,
    )
    from conch_tpu_torch.kernels.activation.silu_and_mul import silu_and_mul_launcher, silu_and_mul_parts_launcher
    from conch_tpu_torch.kernels.attention.mla_attention import mla_attention_launcher
    from conch_tpu_torch.kernels.attention.paged_attention import paged_attention_launcher
    from conch_tpu_torch.kernels.attention.varlen_attention import varlen_attention_launcher
    from conch_tpu_torch.kernels.cache.reshape_and_cache import reshape_and_cache_stacked_launcher
    from conch_tpu_torch.kernels.collectives.ring_all_gather import ring_all_gather_launcher
    from conch_tpu_torch.kernels.embedding.rotary_embedding import rotary_embedding_launcher
    from conch_tpu_torch.kernels.normalization.gemma_rms_norm import gemma_rms_norm_launcher
    from conch_tpu_torch.kernels.normalization.rms_norm import fused_add_rms_norm_launcher, rms_norm_launcher
    from conch_tpu_torch.kernels.quantization.bitsandbytes.blockwise import dequantize4_launcher, quantize4_launcher
    from conch_tpu_torch.kernels.quantization.fp8 import static_scaled_fp8_quant_launcher
    from conch_tpu_torch.kernels.quantization.int8 import static_scaled_int8_quant_launcher
    from conch_tpu_torch.kernels.quantization.gemm import (
        mixed_gemm_magic_launcher,
        mixed_gemm_planar_launcher,
        mixed_gemm_rows_launcher,
        scaled_gemm_launcher,
    )
    from conch_tpu_torch.kernels.vision.bev_pool import bev_pool_backward_launcher, bev_pool_forward_launcher
    from conch_tpu_torch.kernels.vision.nms import nms_keep_mask_launcher

    return {
        "mixed_gemm_magic": (mixed_gemm_magic_launcher,),
        "mixed_gemm_planar": (mixed_gemm_planar_launcher,),
        "mixed_gemm_rows": (mixed_gemm_rows_launcher,),
        "scaled_gemm": (scaled_gemm_launcher,),
        "quantize4": (quantize4_launcher,),
        "dequantize4": (dequantize4_launcher,),
        "fused_add_rms_norm": (fused_add_rms_norm_launcher,),
        "reshape_and_cache_stacked": (reshape_and_cache_stacked_launcher,),
        "paged_attention": (paged_attention_launcher,),
        "rms_norm": (rms_norm_launcher,),
        "rotary_embedding": (rotary_embedding_launcher,),
        "silu_and_mul": (silu_and_mul_launcher, silu_and_mul_parts_launcher),
        "varlen_attention": (varlen_attention_launcher,),
        "gemma_rms_norm": (gemma_rms_norm_launcher,),
        "gelu_tanh_and_mul": (gelu_tanh_and_mul_launcher, gelu_tanh_and_mul_parts_launcher),
        "mla_attention": (mla_attention_launcher,),
        "static_scaled_quant": (static_scaled_int8_quant_launcher, static_scaled_fp8_quant_launcher),
        "bev_pool_fwd": (bev_pool_forward_launcher,),
        "bev_pool_bwd": (bev_pool_backward_launcher,),
        "nms": (nms_keep_mask_launcher,),
        "ring_all_gather": (ring_all_gather_launcher,),
    }


# K3's and K7's launches over a rolling-KV ring (``ring_launches``), counted
# beside their launches in all.
RING_COUNTERS = {"paged_attention_ring": "paged_attention", "varlen_attention_ring": "varlen_attention"}
# K8's float8_e4m3fn launches on the mainloop's fp8 layout and on the loop
# kernel (counted beside its launches in all).
E4M3_COUNTERS = {"scaled_gemm_e4m3": "e4m3_launches", "scaled_gemm_e4m3_loop": "e4m3_loop_launches"}


def reset_launch_counts() -> None:
    """Set every kernel's launch count (and K3's and K7's ring counts, K8's
    e4m3 counts) to 0."""
    launchers = _launchers()
    for fns in launchers.values():
        for fn in fns:
            fn.launches = 0
    for kernel in RING_COUNTERS.values():
        launchers[kernel][0].ring_launches = 0
    for attr in E4M3_COUNTERS.values():
        setattr(launchers["scaled_gemm"][0], attr, 0)


def read_launch_counts() -> dict:
    """Each kernel row's launches since the last reset, K3's and K7's
    launches over a ring, and K8's float8_e4m3fn launches on the mainloop
    and on the loop kernel."""
    launchers = _launchers()
    counts = {name: sum(fn.launches for fn in fns) for name, fns in launchers.items()}
    counts.update({name: launchers[kernel][0].ring_launches for name, kernel in RING_COUNTERS.items()})
    counts.update({name: getattr(launchers["scaled_gemm"][0], attr) for name, attr in E4M3_COUNTERS.items()})
    return counts


def to_device(tree, device: str):
    """A copy of a param tree on ``device``."""
    from conch_tpu_torch.models.linear import QuantizedLinear

    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, QuantizedLinear):
        return QuantizedLinear(tree.kind, to_device(tree.arrays, device), dict(tree.meta))
    return tree.to(device)


# Tolerances of the 2-layer prefill check, card (kernels) vs CPU (plain
# versions). f32: the JAX package's f32 attention tolerance (2e-3, atol and
# rtol); the two sides differ only in summation order. bf16: max |diff| <=
# 3e-2 * max |logit|, the bf16 attention tolerance relative to the logits'
# scale. cuBLAS and the CPU round bf16 intermediates differently, and an
# error in the hidden state reaches every logit in proportion to the
# logits' scale (about 6 here), not to each logit's own size.
PREFILL_TOLERANCES = {torch.float32: 2e-3, torch.bfloat16: 3e-2}
# w8a8 rounds every projection's input to whole int8 steps per row, so the
# bf16 rounding differences between card and CPU flip activation codes, and
# the flips spread through the layers. On the CPU (2 layers, hidden 1024;
# python3 -m conch_tpu_torch.tools.w8a8_sensitivity) bf16 against f32
# activations moves the logits by 3.5% of max |logit| in w8a8 against 0.7%
# in int8, and one ulp of noise on the norms moves them by 1.6% in w8a8 and
# by less than 0.01% in int8. Held at 1e-1 x max |ref|: a fault of wiring (a
# wrong layer, scale or row) moves them by about max |ref|.
W8A8_PREFILL_TOLERANCE = 1e-1


def random_norm_weights(params: dict, gen: torch.Generator) -> dict:
    """Gemma params with every norm weight drawn at random (std 0.3), in
    place: the init's zeros make ``(1 + w)`` 1, where a dropped weight
    would pass."""
    for tensor in [params["final_norm"], *(w for n, w in params["layers"].items() if n.endswith("_norm"))]:
        tensor.copy_(0.3 * torch.randn(tensor.shape, generator=gen, device=tensor.device))
    return params


# The 2-layer prefill checks' step: prompts of 24 and 13 tokens (pages [5,
# 0] and [3]) in 48 rows, the other 11 padding rows, and two zero-length
# padding sequences.
PREFILL_Q_LENS, PREFILL_ROWS, PREFILL_BATCH, PREFILL_PAGES = [24, 13], 48, 4, 8


def prefill_check_step(vocab: int) -> list[torch.Tensor]:
    """The checks' step on the host: token ids (drawn from SEED below
    ``vocab``), positions, cu_seqlens_q, seq_lens, block table, slots."""
    rng = np.random.default_rng(SEED)
    q_lens, rows, total = PREFILL_Q_LENS, PREFILL_ROWS, sum(PREFILL_Q_LENS)
    tokens = np.zeros(rows, np.int32)
    tokens[:total] = rng.integers(0, vocab, total)
    positions = np.zeros(rows, np.int32)
    positions[:total] = np.concatenate([np.arange(n) for n in q_lens])
    bt = np.zeros((PREFILL_BATCH, MAX_PAGES_PER_SEQ), np.int32)
    bt[0, :2], bt[1, :1] = [5, 0], [3]
    slots = np.full(rows, -1, np.int32)
    slots[:total] = [int(bt[b, p // PS]) * PS + p % PS for b, n in enumerate(q_lens) for p in range(n)]
    cu = np.array([0, q_lens[0], total, total, total], np.int32)
    seq_lens = np.array(q_lens + [0, 0], np.int32)
    return [torch.from_numpy(a) for a in (tokens, positions, cu, seq_lens, bt, slots)]


def logits_agree(out: torch.Tensor, ref: torch.Tensor, dtype: torch.dtype, tol: float) -> tuple[bool, float, float, str]:
    """The prefill checks' rule, card against the CPU: in f32 ``tol + tol *
    |ref|`` elementwise, else ``tol * max |ref|``; returns (ok, max abs
    error, max |ref|, the rule in words)."""
    err, scale = (out - ref).abs().max().item(), ref.abs().max().item()
    if dtype == torch.float32:
        return bool(((out - ref).abs() <= tol + tol * ref.abs()).all()), err, scale, \
            f"{tol:.0e} + {tol:.0e} * |ref| elementwise"
    return err <= tol * scale, err, scale, f"{tol:.0e} * max|ref| = {tol * scale:.3e}"


# (weights, activation dtype, KV cache dtype; None: the activation dtype).
# "int4-g64": int4 at group 64.
LLAMA_PREFILL_CASES = (
    ("bf16", torch.float32, None), ("bf16", torch.bfloat16, None), ("int4", torch.bfloat16, None),
    ("int4-g64", torch.bfloat16, None),
    ("int8", torch.bfloat16, None), ("nf4", torch.bfloat16, None), ("w8a8", torch.bfloat16, None),
    ("bf16", torch.bfloat16, torch.int8), ("bf16", torch.bfloat16, torch.float8_e4m3fn),
    # Qwen2-7B (q/k/v biases, GQA group 7) and Mistral-7B (the window cut
    # to 16, so that its mask bites in these prompts).
    ("bf16", torch.float32, None, "qwen2_7b"), ("int4", torch.bfloat16, None, "qwen2_7b"),
    ("bf16", torch.float32, None, "mistral_7b"), ("int4", torch.bfloat16, None, "mistral_7b"),
)
# Gemma's cases: (activation dtype, KV cache dtype[, weights; bf16 by default]).
GEMMA_PREFILL_CASES = (
    (torch.float32, None), (torch.bfloat16, None), (torch.bfloat16, torch.int8),
    (torch.bfloat16, torch.float8_e4m3fn),
    (torch.bfloat16, None, "int4"), (torch.bfloat16, None, "int8"), (torch.bfloat16, None, "nf4"),
    (torch.bfloat16, None, "w8a8"),
)


def check_prefill_logits(llama_cases=LLAMA_PREFILL_CASES, gemma_cases=GEMMA_PREFILL_CASES) -> None:
    """First-token logits of a 2-layer, full-width prefill on the card
    (kernels) against the same prefill on the CPU (plain versions), for
    Llama-3-8B (bf16 weights in f32 and in bf16, then int4 (K1), int8 (K1b),
    nf4 (K1c, init through K12q) and w8a8 (K8) weights in bf16, the only
    activation dtype those kernels take on the card; bf16 weights over an
    int8 and an e4m3 KV cache, quantized on store at ``kv_cache_scale``),
    Qwen2-7B and Mistral-7B (bf16 weights in f32, int4 in bf16; Mistral's
    window cut to 16; token ids taken modulo each vocabulary)
    and Gemma-2-2B (bf16 weights in f32 and bf16, and over int8 and e4m3
    caches in bf16; int4 (K1), int8 (K1b), nf4 (K1c) and w8a8 (K8) weights
    in bf16 at group 128; random norm weights, the window cut to 16 so that
    layer 0's mask bites in these 24- and 13-token prompts);
    PREFILL_TOLERANCES."""
    import dataclasses

    from conch_tpu_torch.models.gemma import GemmaConfig, gemma_prefill, init_gemma_params
    from conch_tpu_torch.models.llama import (
        LlamaConfig, fuse_llama_params, init_kv_caches, init_llama_params, llama_prefill,
    )

    rows, batch, num_pages = PREFILL_ROWS, PREFILL_BATCH, PREFILL_PAGES
    host = prefill_check_step(min(LlamaConfig.llama3_8b().vocab_size, GemmaConfig.gemma2_2b().vocab_size))

    def cache_tag(cache):
        return "" if cache is None else f", {str(cache).removeprefix('torch.')} KV cache"

    models = {
        "llama3_8b": ("Llama-3-8B", LlamaConfig.llama3_8b()), "qwen2_7b": ("Qwen2-7B", LlamaConfig.qwen2_7b()),
        "mistral_7b": ("Mistral-7B, window 16", dataclasses.replace(mistral_7b_config(), sliding_window=16)),
    }

    def llama(quant_mode, dtype, cache, model="llama3_8b"):
        name, base = models[model]
        cfg = dataclasses.replace(base, num_layers=2, dtype=dtype)
        mode, _, group = quant_mode.partition("-g")
        return f"{name}, {quant_mode} weights{cache_tag(cache)}", cfg, cache, llama_prefill, lambda: (
            fuse_llama_params(init_llama_params(SEED, cfg, quant_mode=mode, group_size=int(group or 128),
                                                device="cuda")))

    def gemma(dtype, cache, quant_mode="bf16"):
        cfg = dataclasses.replace(GemmaConfig.gemma2_2b(), num_layers=2, sliding_window=16, dtype=dtype)
        gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
        return f"Gemma-2-2B, {quant_mode} weights{cache_tag(cache)}", cfg, cache, gemma_prefill, lambda: (
            fuse_llama_params(random_norm_weights(init_gemma_params(SEED, cfg, quant_mode, device="cuda"), gen)))

    cases = [llama(*case) for case in llama_cases] + [gemma(*case) for case in gemma_cases]
    for label, cfg, cache, prefill, make_params in cases:
        tol = W8A8_PREFILL_TOLERANCE if "w8a8" in label else PREFILL_TOLERANCES[cfg.dtype]
        params = make_params()
        kc, vc = init_kv_caches(cfg, num_pages, PS, cache_dtype=cache, device="cuda")
        inputs = [host[0] % cfg.vocab_size, *host[1:]]
        t = [a.cuda() for a in inputs]
        logits, _, _ = prefill(params, cfg, t[0], t[1], t[2], rows, t[3], t[4], t[5], kc, vc)
        logits = logits.cpu()
        cpu_params = to_device(params, "cpu")
        del params, kc, vc
        torch.cuda.empty_cache()
        kc, vc = init_kv_caches(cfg, num_pages, PS, cache_dtype=cache, device="cpu")
        ref, _, _ = prefill(cpu_params, cfg, *inputs[:3], rows, *inputs[3:], kc, vc)
        del cpu_params
        if not torch.isfinite(logits).all() or logits.shape != (batch, cfg.vocab_size):
            raise AssertionError(f"prefill logits: shape {tuple(logits.shape)} or non-finite values")
        ok, err, scale, rule = logits_agree(logits, ref, cfg.dtype, tol)
        print(f"2-layer prefill logits, {label}, {cfg.dtype}, card vs plain path on the CPU: "
              f"max_abs_err {err:.3e}, max|ref| {scale:.3f}, tolerance {rule}", flush=True)
        if not ok:
            raise AssertionError(f"2-layer prefill logits ({label}, {cfg.dtype}) disagree with the plain path")


# A routing divergence between card and CPU is accepted only at a near
# tie: where the CPU's k-th and (k+1)-th expert probabilities (of 64) lie
# within this gap. Card and CPU round differently (summation order; in
# bf16 the hidden state itself), which moves a probability by about 1e-7
# in f32 and 1e-4 in bf16, against a typical gap of 1e-3.
ROUTING_NEAR_TIE = {torch.float32: 1e-5, torch.bfloat16: 1e-3}


# (activation dtype, latent cache dtype[, weights; bf16 by default]): int4 and int8 at group 32 (K1, K1b),
# nf4 (K1c; w_down's K 10944 split) and w8a8 (K8; w_down ends half a 128-k slice past 85 whole ones).
DEEPSEEK_PREFILL_CASES = (
    (torch.float32, None), (torch.bfloat16, None), (torch.bfloat16, torch.int8),
    (torch.bfloat16, torch.float8_e4m3fn), (torch.bfloat16, None, "int4"), (torch.bfloat16, None, "int8"),
    (torch.bfloat16, None, "nf4"), (torch.bfloat16, None, "w8a8"),
)


def check_deepseek_logits(cases=DEEPSEEK_PREFILL_CASES) -> None:
    """First-token logits of a 2-layer, full-width DeepSeek-V2-Lite prefill
    (layer 0 dense, layer 1 MoE; bf16 weights, random norm weights) on the
    card (K4, K6, K11) against the same prefill on the CPU (plain
    versions), in f32 and bf16, in bf16 over int8 and e4m3 latent caches,
    and in bf16 with int4 (K1) and int8 (K1b) projections at group 32, nf4
    (K1c) and w8a8 (K8) projections, at PREFILL_TOLERANCES (w8a8 at
    W8A8_PREFILL_TOLERANCE); and the MoE layer's routing of every
    real token compared expert set by expert set, a divergence accepted
    only at a near tie (ROUTING_NEAR_TIE)."""
    import dataclasses

    import conch_tpu_torch.models.deepseek as ds

    rows, batch, num_pages, total = PREFILL_ROWS, PREFILL_BATCH, PREFILL_PAGES, sum(PREFILL_Q_LENS)
    host = prefill_check_step(ds.DeepseekV2Config.v2_lite().vocab_size)

    routes: list = []
    route = ds.deepseek_route

    def recording_route(hidden, router_w, config, bias=None):
        weights, experts = route(hidden, router_w, config, bias=bias)
        probs = torch.softmax(hidden.float() @ router_w.float(), dim=-1)
        routes.append((experts[:total].cpu(), probs[:total].cpu()))
        return weights, experts

    ds.deepseek_route = recording_route
    try:
        for dtype, cache, *weights in cases:
            quant_mode = weights[0] if weights else "bf16"
            tag = f"{dtype}" + ("" if cache is None else f", {str(cache).removeprefix('torch.')} latent cache")
            cfg = dataclasses.replace(ds.DeepseekV2Config.v2_lite(), num_layers=2, dtype=dtype)
            params = ds.fuse_deepseek_params(ds.init_deepseek_params(SEED, cfg, quant_mode, device="cuda"))
            gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
            norms = [params["final_norm"]] + [
                w for stack in ("layers_dense", "layers_moe") for n, w in params[stack].items() if n.endswith("_norm")
            ]
            for w in norms:
                w.copy_(1.0 + 0.3 * torch.randn(w.shape, generator=gen, device="cuda"))
            kc = ds.init_deepseek_kv_cache(cfg, num_pages, PS, dtype=cache, device="cuda")
            vc = torch.zeros(0, dtype=dtype, device="cuda")
            t = [a.cuda() for a in host]
            routes.clear()
            logits, _, _ = ds.deepseek_prefill(params, cfg, t[0], t[1], t[2], rows, t[3], t[4], t[5], kc, vc)
            logits = logits.cpu()
            (card_experts, _), = routes
            cpu_params = to_device(params, "cpu")
            del params, kc, vc
            torch.cuda.empty_cache()
            routes.clear()
            kc = ds.init_deepseek_kv_cache(cfg, num_pages, PS, dtype=cache, device="cpu")
            ref, _, _ = ds.deepseek_prefill(
                cpu_params, cfg, host[0], host[1], host[2], rows, host[3], host[4], host[5], kc, torch.zeros(0)
            )
            (cpu_experts, cpu_probs), = routes
            del cpu_params
            if not torch.isfinite(logits).all() or logits.shape != (batch, cfg.vocab_size):
                raise AssertionError(f"DeepSeek prefill logits: shape {tuple(logits.shape)} or non-finite values")
            k = cfg.num_experts_per_tok
            same = (card_experts.sort(dim=-1).values == cpu_experts.sort(dim=-1).values).all(dim=-1)
            ranked = cpu_probs.sort(dim=-1, descending=True).values
            gaps = (ranked[:, k - 1] - ranked[:, k])[~same].tolist()
            print(f"2-layer DeepSeek-V2-Lite prefill, {quant_mode} weights, {tag}: MoE routing card vs CPU: {int(same.sum())} of "
                  f"{total} tokens route to the same {k} experts; k-th/(k+1)-th probability gaps at the "
                  f"divergences {gaps} (near tie <= {ROUTING_NEAR_TIE[dtype]:.0e})", flush=True)
            if any(g > ROUTING_NEAR_TIE[dtype] for g in gaps):
                raise AssertionError(f"DeepSeek routing ({tag}) diverges from the CPU away from a near tie")
            tol = W8A8_PREFILL_TOLERANCE if quant_mode == "w8a8" else PREFILL_TOLERANCES[dtype]
            ok, err, scale, rule = logits_agree(logits, ref, dtype, tol)
            print(f"2-layer prefill logits, DeepSeek-V2-Lite, {quant_mode} weights, {tag}, card vs plain path on the CPU: "
                  f"max_abs_err {err:.3e}, max|ref| {scale:.3f}, tolerance {rule}", flush=True)
            if not ok:
                raise AssertionError(f"2-layer DeepSeek prefill logits ({quant_mode}, {tag}) disagree with the plain path")
    finally:
        ds.deepseek_route = route


def require_full_f32(phase: str) -> None:
    """f32 matmuls in full f32 (PyTorch's defaults): under TF32 a router's
    near ties flip, and the f32 checks would hold TF32 sums."""
    if torch.get_float32_matmul_precision() != "highest" or torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError(f"{phase}: f32 matmuls must run in full f32 (no TF32)")


def mixtral_config(num_layers: int, dtype: torch.dtype = torch.bfloat16, **over):
    """Mixtral-8x7B at every published width, cut to ``num_layers`` layers."""
    from conch_tpu_torch.models.moe import MoEConfig

    base = MoEConfig.mixtral_8x7b()
    return dataclasses.replace(base, llama=dataclasses.replace(base.llama, num_layers=num_layers, dtype=dtype), **over)


# (weights, activation dtype, KV cache dtype; None: the activation dtype).
MIXTRAL_PREFILL_CASES = (
    ("bf16", torch.float32, None), ("bf16", torch.bfloat16, None), ("int4", torch.bfloat16, None),
    ("bf16", torch.bfloat16, torch.int8),
)
# Capacity factor of the logits check: capacity 6 a expert for the 48-row
# step's 96 selections (8 experts, 48 slots), so selections drop.
MIXTRAL_CHECK_CAPACITY_FACTOR = 0.5


def check_mixtral_logits(cases=MIXTRAL_PREFILL_CASES) -> None:
    """First-token logits of a 2-layer, full-width Mixtral-8x7B prefill on
    the card (K2's store aside, K4, K5, K7, K1 for int4 attention
    projections; the router, dispatch and expert einsums through cuBLAS)
    against the same prefill on the CPU (plain versions): bf16 weights in
    f32 and bf16, int4 attention projections in bf16, bf16 over an int8
    KV cache; random norm weights; 37 tokens and 11 padding rows in a
    48-row step at capacity factor 0.5, so selections drop and the padding
    rows take part. Which selections drop depends on every row's ordered
    choice (slot 0 before slot 1), so one near tie that the two devices
    break apart changes what another row keeps; the CPU run therefore
    takes the card's ordered experts in each layer (its own weights: the
    softmax of its logits at those experts). Each layer's router logits,
    every row's, are held to the CPU's at PREFILL_TOLERANCES, as the
    model's logits; the CPU's own choice must equal the card's on every
    row, in order, in f32, and in bf16 a row that chooses otherwise is
    printed with the CPU's logit gap at the first rank that differs (the
    logits' agreement bounds it: at most twice their largest difference).
    With 8 experts a rounding step of the router logits moves a
    probability by about 1e-2, so DeepSeek's ROUTING_NEAR_TIE, set for 64
    experts' probabilities, does not apply. Logits at
    PREFILL_TOLERANCES."""
    import conch_tpu_torch.models.moe as moe
    from conch_tpu_torch.models.llama import fuse_llama_params

    require_full_f32("check_mixtral_logits")
    rows, batch, num_pages = PREFILL_ROWS, PREFILL_BATCH, PREFILL_PAGES
    host = prefill_check_step(moe.MoEConfig.mixtral_8x7b().vocab_size)

    routes: list = []  # (own ordered experts, router logits) per layer
    replay: list = []  # the card's ordered experts per layer, taken by the CPU run
    route = moe.route_topk

    def recording_route(router_logits, top_k):
        weights, experts = route(router_logits, top_k)
        routes.append((experts.cpu(), router_logits.float().cpu()))
        if replay:
            experts = replay[len(routes) - 1].to(router_logits.device)
            weights = torch.softmax(torch.gather(router_logits.float(), 1, experts.long()), dim=-1)
        return weights, experts

    moe.route_topk = recording_route
    try:
        for quant_mode, dtype, cache in cases:
            tag = f"{quant_mode} weights, {dtype}" + ("" if cache is None else f", {str(cache).removeprefix('torch.')} KV cache")
            cfg = mixtral_config(2, dtype, capacity_factor=MIXTRAL_CHECK_CAPACITY_FACTOR)
            params = fuse_llama_params(moe.init_moe_params(SEED, cfg, quant_mode, device="cuda"))
            gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
            for w in [params["final_norm"], params["layers"]["input_norm"], params["layers"]["post_attn_norm"]]:
                w.copy_(1.0 + 0.3 * torch.randn(w.shape, generator=gen, device="cuda"))
            kc, vc = moe.init_moe_kv_caches(cfg, num_pages, PS, cache, device="cuda")
            t = [a.cuda() for a in host]
            routes.clear()
            replay.clear()
            logits, _, _ = moe.mixtral_prefill(params, cfg, t[0], t[1], t[2], rows, t[3], t[4], t[5], kc, vc)
            logits = logits.cpu()
            card_routes = list(routes)
            cpu_params = to_device(params, "cpu")
            del params, kc, vc
            torch.cuda.empty_cache()
            routes.clear()
            replay.extend(e for e, _ in card_routes)
            kc, vc = moe.init_moe_kv_caches(cfg, num_pages, PS, cache, device="cpu")
            ref, _, _ = moe.mixtral_prefill(cpu_params, cfg, *host[:3], rows, *host[3:], kc, vc)
            replay.clear()
            cpu_routes = list(routes)
            del cpu_params, kc, vc
            if not torch.isfinite(logits).all() or logits.shape != (batch, cfg.vocab_size):
                raise AssertionError(f"Mixtral prefill logits: shape {tuple(logits.shape)} or non-finite values")
            k, cap, tol = cfg.top_k, cfg.capacity(rows), PREFILL_TOLERANCES[dtype]
            for layer, ((card_e, card_l), (cpu_e, cpu_l)) in enumerate(zip(card_routes, cpu_routes, strict=True)):
                differ = card_e != cpu_e  # (rows, k): the ordered choices
                same = ~differ.any(dim=-1)
                first = differ.to(torch.int8).argmax(dim=-1)  # the first rank that differs
                ranked = cpu_l.sort(dim=-1, descending=True).values
                gaps = (ranked.gather(1, first[:, None]) - ranked.gather(1, first[:, None] + 1))[~same, 0].tolist()
                dropped = int((torch.bincount(card_e.reshape(-1).long(), minlength=cfg.num_experts) - cap).clamp(min=0).sum())
                ok, err, scale, rule = logits_agree(card_l, cpu_l, dtype, tol)
                print(f"2-layer Mixtral-8x7B prefill, {tag}, layer {layer}: router logits card vs CPU max_abs_err "
                      f"{err:.3e}, max|ref| {scale:.3f}, tolerance {rule}; {int(same.sum())} of {rows} rows (37 live, "
                      f"11 padding) choose the same {k} experts in the same order, the CPU's logit gaps at the first "
                      f"rank that differs {gaps}; capacity {cap}: {dropped} of {rows * k} selections dropped (the "
                      f"card's choice, which the CPU run takes)", flush=True)
                if not ok:
                    raise AssertionError(f"Mixtral router logits ({tag}, layer {layer}) disagree with the plain path")
                if dtype == torch.float32 and gaps:
                    raise AssertionError(f"Mixtral routing ({tag}, layer {layer}) differs from the CPU's in f32")
                if dropped == 0:
                    raise AssertionError(f"Mixtral check ({tag}, layer {layer}): no selection dropped")
            ok, err, scale, rule = logits_agree(logits, ref, dtype, tol)
            print(f"2-layer prefill logits, Mixtral-8x7B, {tag}, card vs plain path on the CPU: max_abs_err "
                  f"{err:.3e}, max|ref| {scale:.3f}, tolerance {rule}", flush=True)
            if not ok:
                raise AssertionError(f"2-layer Mixtral prefill logits ({tag}) disagree with the plain path")
    finally:
        moe.route_topk = route


def hf_state(gen: torch.Generator, experts: int = 0, layers: int = 2) -> dict[str, torch.Tensor]:
    """A tiny random HF state dict in bf16 (hidden 128, 4 query heads and 2
    KV heads of 32, intermediate 256, vocab 96): Llama's, or with
    ``experts`` Mixtral's ``block_sparse_moe`` in place of the MLP."""
    shapes = {"model.embed_tokens.weight": (96, 128), "model.norm.weight": (128,), "lm_head.weight": (96, 128)}
    for i in range(layers):
        p = f"model.layers.{i}."
        shapes.update({p + "self_attn.q_proj.weight": (128, 128), p + "self_attn.k_proj.weight": (64, 128),
                       p + "self_attn.v_proj.weight": (64, 128), p + "self_attn.o_proj.weight": (128, 128),
                       p + "input_layernorm.weight": (128,), p + "post_attention_layernorm.weight": (128,)})
        if experts:
            shapes[p + "block_sparse_moe.gate.weight"] = (experts, 128)
            for e in range(experts):
                for w, shape in (("w1", (256, 128)), ("w2", (128, 256)), ("w3", (256, 128))):
                    shapes[f"{p}block_sparse_moe.experts.{e}.{w}.weight"] = shape
        else:
            shapes.update({p + "mlp.gate_proj.weight": (256, 128), p + "mlp.up_proj.weight": (256, 128),
                           p + "mlp.down_proj.weight": (128, 256)})
    return {k: (0.05 * torch.randn(s, generator=gen)).to(torch.bfloat16) for k, s in shapes.items()}


def same_tree(card, cpu, path: str = "params") -> int:
    """Fails unless two param trees hold the same tensors bit for bit (the
    first's on the card); returns the number of tensors compared."""
    from conch_tpu_torch.models.linear import QuantizedLinear

    if isinstance(cpu, dict):
        if set(card) != set(cpu):
            raise AssertionError(f"{path}: keys {sorted(card)} against {sorted(cpu)}")
        return sum(same_tree(card[k], cpu[k], f"{path}.{k}") for k in cpu)
    if isinstance(cpu, QuantizedLinear):
        if (card.kind, card.meta) != (cpu.kind, cpu.meta):
            raise AssertionError(f"{path}: {card.kind} {card.meta} against {cpu.kind} {cpu.meta}")
        return same_tree(card.arrays, cpu.arrays, path)
    if card.device.type != "cuda" or card.dtype != cpu.dtype or card.shape != cpu.shape:
        raise AssertionError(f"{path}: {card.device} {card.dtype} {tuple(card.shape)} against {cpu.dtype} "
                             f"{tuple(cpu.shape)}")
    a, b = card.cpu().contiguous(), cpu.contiguous()
    if not torch.equal(a.view(torch.uint8) if a.dtype.is_floating_point else a,
                       b.view(torch.uint8) if b.dtype.is_floating_point else b):
        raise AssertionError(f"{path}: the card's tensor differs from the CPU's")
    return 1


def check_hf_converters() -> None:
    """``llama_params_from_hf`` and ``mixtral_params_from_hf`` on tiny random
    bf16 state dicts with ``device="cuda"`` give the CPU's params bit for
    bit, with bf16 and int4 (group 64) projections."""
    from conch_tpu_torch.models import hf
    from conch_tpu_torch.models.llama import LlamaConfig
    from conch_tpu_torch.models.moe import MoEConfig

    gen = torch.Generator().manual_seed(SEED)
    dims = {"vocab_size": 96, "hidden_size": 128, "intermediate_size": 256, "num_layers": 2, "num_heads": 4,
            "num_kv_heads": 2, "head_dim": 32, "max_position": 64}
    cases = (
        ("llama", hf.llama_params_from_hf, LlamaConfig(**dims), hf_state(gen)),
        ("mixtral", hf.mixtral_params_from_hf, MoEConfig(llama=LlamaConfig(**dims), num_experts=4),
         hf_state(gen, experts=4)),
    )
    for name, convert, cfg, state in cases:
        for mode in ("bf16", "int4"):
            card = convert(state, cfg, quant_mode=mode, group_size=64, device="cuda")
            n = same_tree(card, convert(state, cfg, quant_mode=mode, group_size=64, device="cpu"))
            print(f"hf.{convert.__name__} ({name}, {mode}) on the card: {n} tensors equal to the CPU's bit for bit",
                  flush=True)


def bf16_prompts(rng: np.random.Generator, vocab: int) -> list[list[int]]:
    """4 prompts of 40/128/300/500 tokens; the last two share 64 tokens."""
    prefix = rng.integers(0, vocab, 64).tolist()
    return [
        rng.integers(0, vocab, 40).tolist(),
        rng.integers(0, vocab, 128).tolist(),
        prefix + rng.integers(0, vocab, 236).tolist(),
        prefix + rng.integers(0, vocab, 436).tolist(),
    ]


# The README's serving example: 16 prompts of 40 to 900 tokens, two of
# them sharing a 128-token prefix (a prefix-cache hit).
INT4_PROMPT_LENS = (40, 900, 64, 300, 700, 96, 450, 800, 150, 600, 256, 520, 380, 60)
INT4_SHARED_TAILS = (72, 372)


def int4_prompts(rng: np.random.Generator, vocab: int) -> list[list[int]]:
    prefix = rng.integers(0, vocab, 128).tolist()
    prompts = [rng.integers(0, vocab, n).tolist() for n in INT4_PROMPT_LENS]
    return prompts + [prefix + rng.integers(0, vocab, n).tolist() for n in INT4_SHARED_TAILS]


def quant_prompts(rng: np.random.Generator, vocab: int) -> list[list[int]]:
    """8 prompts of 40 to 900 tokens, for the int8, nf4 and w8a8 runs."""
    return [rng.integers(0, vocab, n).tolist() for n in (40, 900, 64, 300, 700, 96, 450, 800)]


def deepseek_prompts(rng: np.random.Generator, vocab: int) -> list[list[int]]:
    """8 prompts of 40 to 1800 tokens (4450 in all)."""
    return [rng.integers(0, vocab, n).tolist() for n in (40, 900, 64, 300, 1800, 96, 450, 800)]


# Mistral-7B with rolling KV: 8 prompts of 40 to 7000 tokens, five longer
# than the ring's 4624 tokens (289 pages of 16), 64 new tokens each.
MISTRAL_PROMPT_LENS = (40, 900, 2000, 4700, 5200, 6000, 6500, 7000)
MISTRAL_MAX_TOKENS = 64


def mistral_prompts(rng: np.random.Generator, vocab: int) -> list[list[int]]:
    return [rng.integers(0, vocab, n).tolist() for n in MISTRAL_PROMPT_LENS]


def qwen2_prompts(rng: np.random.Generator, vocab: int) -> list[list[int]]:
    """8 prompts of 40 to 2000 tokens, for Qwen2-7B."""
    return [rng.integers(0, vocab, n).tolist() for n in (40, 268, 568, 868, 1168, 1468, 1768, 2000)]


def gemma_prompts(rng: np.random.Generator, vocab: int) -> list[list[int]]:
    """8 prompts of 40 to 4600 tokens; the longest crosses the 4096 window
    of the local layers, in prefill (K7) and in decode (K3)."""
    return [rng.integers(0, vocab, n).tolist() for n in (40, 64, 128, 300, 600, 900, 2000, 4600)]


# Mixtral-8x7B: 8 prompts of 40 to 2000 tokens, 16 new tokens each.
MIXTRAL_PROMPT_LENS = (40, 300, 600, 900, 1200, 1500, 1800, 2000)
MIXTRAL_MAX_TOKENS = 16


def mixtral_prompts(rng: np.random.Generator, vocab: int) -> list[list[int]]:
    return [rng.integers(0, vocab, n).tolist() for n in MIXTRAL_PROMPT_LENS]


ATTENTION = ("varlen_attention", "paged_attention")  # K7 once per layer of a prefill step, K3 of a decode step

# Launches a model step makes, with wqkv and gate|up fused. Llama-3-8B, 32
# layers: K1 4 per layer, K4 2 per layer plus the final norm, K6 1 per
# layer, attention 1 per layer. Gemma-2-2B, 26 layers: K10a 4 per layer
# (input, post-attention, pre- and post-feedforward) plus the final norm,
# K10b 1 per layer, attention 1 per layer.
# int8 and w8a8 also quantize lm_head: K1b and K8 4 per layer plus 1; nf4
# stays unfused and quantizes lm_head: K1c 7 per layer plus 1. K12q runs
# during nf4 init (once per projection and layer, plus lm_head) and never
# while serving.
LLAMA_PER_STEP = {"mixed_gemm_magic": 4 * 32, "rms_norm": 2 * 32 + 1, "silu_and_mul": 32, ATTENTION: 32}
# Qwen2-7B, 28 layers: K1 5 a layer (w_gate and w_up do not fuse:
# QWEN2_LAYER_SHAPES), K6 through its parts launcher; its q/k/v biases are
# plain PyTorch adds, as in the JAX package.
QWEN2_PER_STEP = {"mixed_gemm_magic": 5 * 28, "rms_norm": 2 * 28 + 1, "silu_and_mul": 28, ATTENTION: 28}
GEMMA_PER_STEP = {"gemma_rms_norm": 4 * 26 + 1, "gelu_tanh_and_mul": 26, ATTENTION: 26}
_LLAMA_REST = {"rms_norm": 2 * 32 + 1, "silu_and_mul": 32, ATTENTION: 32, "mixed_gemm_magic": 0, "quantize4": 0}
INT8_PER_STEP = {"mixed_gemm_planar": 4 * 32 + 1, **_LLAMA_REST}
NF4_PER_STEP = {"mixed_gemm_rows": 7 * 32 + 1, **_LLAMA_REST}
W8A8_PER_STEP = {"scaled_gemm": 4 * 32 + 1, **_LLAMA_REST}
NF4_INIT_LAUNCHES = 7 * 32 + 1
# DeepSeek-V2-Lite, 27 layers (1 dense, 26 MoE): K11 1 per layer, K4 3 per
# layer (input, kv_a and post-attention norms) plus the final norm, K6 1
# per layer (the fused dense gate|up, then the shared experts' gate|up;
# the routed experts' SwiGLU is plain PyTorch, as in the JAX package). The
# latent cache write and the interleaved RoPE are plain PyTorch too, so no
# K2, K3, K5 or K7.
DEEPSEEK_PER_STEP = {
    "mla_attention": 27, "rms_norm": 3 * 27 + 1, "silu_and_mul": 27, ATTENTION: 0, "reshape_and_cache_stacked": 0,
    "rotary_embedding": 0,
}
DEEPSEEK_KERNELS = ("mla_attention", "rms_norm", "silu_and_mul")
# DeepSeek-V2-Lite's quantized engines (int4 and int8 at group 32): K11 and
# K4 as in bf16; the GEMMs a step, lm_head included. int4 keeps wq and
# w_kv_a apart (w_kv_a's N padded) and the dense layer's w_gate and w_up
# apart (N 10944 padded to 12288), whose SwiGLU is then plain PyTorch (as
# in the JAX package), and fuses the shared gate|up: K1 3 a layer plus 3
# (dense) or 2 (MoE), plus 1, 137; K6 26. int8 and w8a8 fuse all: 4 a layer
# plus 1, 109; K6 27. nf4 fuses nothing: 6 a layer plus 1, 163; no K6 (every
# SwiGLU unfused); its init runs K12q once a projection and layer and for
# lm_head, 163 times.
_DEEPSEEK_REST = {k: v for k, v in DEEPSEEK_PER_STEP.items() if k != "silu_and_mul"}
DEEPSEEK_QUANT_PER_STEP = {
    "int4": {"mixed_gemm_magic": 137, "silu_and_mul": 26, **_DEEPSEEK_REST},
    "int8": {"mixed_gemm_planar": 109, "silu_and_mul": 27, **_DEEPSEEK_REST},
    "nf4": {"mixed_gemm_rows": 163, "silu_and_mul": 0, **_DEEPSEEK_REST},
    "w8a8": {"scaled_gemm": 109, "silu_and_mul": 27, **_DEEPSEEK_REST},
}
# Gemma-2-2B's quantized engines (group 128), 26 layers; the logits stay the
# tied bf16 embedding (cuBLAS). int4, int8 and w8a8 fuse wqkv and gate|up: 4
# GEMMs a layer, 104; nf4 fuses nothing: 7 a layer, 182 (K10b through its
# parts launcher), and its init runs K12q 182 times.
QUANT_GEMM = {"int4": "mixed_gemm_magic", "int8": "mixed_gemm_planar", "nf4": "mixed_gemm_rows",
              "w8a8": "scaled_gemm"}
GEMMA_QUANT_PER_STEP = {mode: {gemm: 182 if mode == "nf4" else 104, **GEMMA_PER_STEP} for mode, gemm in QUANT_GEMM.items()}
QUANT_MAX_TOKENS = 16  # the new quantized DeepSeek and Gemma runs: 16 tokens a request
# Mixtral-8x7B served at every published width, its depth cut to 24 of 32
# layers: a layer holds 2.90 GB in bf16 (its experts 3 x 8 x 4096 x 14336 x
# 2 B = 2.82 GB), so 32 layers, the embedding and the head come to 93.4 GB,
# more than the card's 80 GB, and 24 to 70.2 GB (65.4 GiB), which leaves the
# KV pool, one expert's f32 draw and the workspace their room. A step
# launches K4 2 a layer plus the final norm, attention (K7 in prefill, K3 in
# decode) and K5 1 a layer, no K6 (the experts' SwiGLU is plain PyTorch, as
# in the JAX package) and no K1 (bf16 attention projections).
MIXTRAL_LAYERS = 24
MIXTRAL_PER_STEP = {"rms_norm": 2 * MIXTRAL_LAYERS + 1, ATTENTION: MIXTRAL_LAYERS, "rotary_embedding": MIXTRAL_LAYERS,
                    "silu_and_mul": 0, "mixed_gemm_magic": 0}
MIXTRAL_KERNELS = ("reshape_and_cache_stacked", "paged_attention", "rms_norm", "rotary_embedding", "varlen_attention")
MIXTRAL_ENGINE = {"num_pages": 1024, "max_batch_size": 8, "max_pages_per_seq": 128}
MIXTRAL_RUNS = 3  # timed runs of the same requests, each on a fresh engine


def count_steps(engine) -> tuple[list[int], dict]:
    """Wrap the engine's model step functions so that each call adds one to
    the returned counters: the model steps of a run (then its prefill and
    its decode steps), counted apart from the kernels' launches; then the
    most pages one sequence held and the most held in all at a model step;
    then its speculative verify steps. The dict returned with them sums the
    kernels' launches inside the verify steps."""
    counter = [0, 0, 0, 0, 0, 0]
    in_verify: dict[str, int] = {}

    def counted(fn, kind):
        def step(*args, **kwargs):
            counter[0] += 1
            counter[kind] += 1
            held = [len(r.pages) for r in engine.running]
            counter[3] = max(counter[3], max(held, default=0))
            counter[4] = max(counter[4], sum(held))
            if kind != 5:
                return fn(*args, **kwargs)
            before = read_launch_counts()
            out = fn(*args, **kwargs)
            for name, n in read_launch_counts().items():
                in_verify[name] = in_verify.get(name, 0) + n - before[name]
            return out

        return step

    engine._prefill_fn, engine._decode_fn, engine._verify_fn = (
        counted(engine._prefill_fn, 1), counted(engine._decode_fn, 2), counted(engine._verify_fn, 5))
    return counter, in_verify


def serve(
    card: str, label: str, cfg, make_params, model_fns: dict, engine_kwargs: dict, make_prompts,
    expect: tuple[str, ...], per_step: dict, init_launches: dict | None = None, max_tokens: int = 32,
    record: dict | None = None, profile: bool = True, runs: int = 1, annotate: dict | None = None,
) -> dict:
    """LLMEngine at full width (random weights from the seed) serving greedy
    requests of ``max_tokens`` tokens through ``model_fns`` (Llama's by default);
    returns each kernel's launch count in that run. Fails unless every
    kernel in ``expect`` launched, and launched ``per_step`` times in each
    model step (attention: K3 and K7 together). ``init_launches``: kernels
    that the params' init must launch, with the count (counted from just
    before the init to the engine's start; returned as those kernels'
    counts). Fails at its start if more than 1 GiB is still allocated: an
    earlier run's model was not freed. ``record`` receives the outputs and
    the pages and KV bytes the engine held; ``profile=False`` skips the
    profiled repeat. ``runs`` > 1 times the same requests again on fresh
    engines over the same params (each run's tok/s printed); ``annotate``
    goes to ``profile_served_run``."""
    from conch_tpu_torch.serving import EngineConfig, LLMEngine, SamplingParams

    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    if held > 2**30:
        raise AssertionError(f"{held / 2**30:.1f} GiB still allocated before the {label} run: a model was not freed")
    t0 = time.perf_counter()
    reset_launch_counts()
    params = make_params(cfg)
    engine = LLMEngine(params, cfg, EngineConfig(**engine_kwargs), **model_fns)
    del params
    cache_dtype = model_fns.get("cache_dtype", cfg.dtype)
    if engine.k_caches.dtype != cache_dtype:
        raise AssertionError(f"{label}: the engine's cache is {engine.k_caches.dtype}, asked for {cache_dtype}")
    torch.cuda.synchronize()
    at_init = read_launch_counts()
    print(f"{label} engine ready in {time.perf_counter() - t0:.1f} s ({engine.ecfg}), "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated; launches during init: "
          f"{ {k: v for k, v in at_init.items() if v} }", flush=True)
    for name, want in (init_launches or {}).items():
        if at_init[name] != want:
            raise AssertionError(f"{name}: {at_init[name]} launches during the {label} init, expected {want}")
    prompts = make_prompts(np.random.default_rng(SEED), cfg.vocab_size)
    steps, in_verify = count_steps(engine)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outputs = engine.generate(prompts, SamplingParams(max_tokens=max_tokens))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launch_counts()
    for out in outputs:
        if len(out) != max_tokens or not all(0 <= t < cfg.vocab_size for t in out):
            raise AssertionError(f"request finished with {len(out)} tokens, some outside the vocabulary")
    print(f"{label}: served {len(prompts)} requests (prompts {[len(p) for p in prompts]}, {max_tokens} tokens "
          f"each) in {seconds:.3f} s: {len(prompts) * max_tokens / seconds:.2f} generated tok/s on {card}; "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB peak allocated; prefix-cache hits "
          f"{engine.prefix_cache_hits} tokens", flush=True)
    page_bytes = (engine.k_caches.nbytes + engine.v_caches.nbytes) // engine.ecfg.num_pages
    print(f"{label}: at most {steps[3]} pages a sequence, {steps[4]} pages in all ({steps[4] * page_bytes / 2**30:.2f} "
          f"GiB of KV) at a model step; the pool {engine.ecfg.num_pages} pages "
          f"({engine.ecfg.num_pages * page_bytes / 2**30:.2f} GiB)", flush=True)
    if record is not None:
        record.update(outputs=outputs, seq_pages=steps[3], pages=steps[4], kv_bytes=steps[4] * page_bytes,
                      config=engine.config)
    n_steps = steps[0]
    print(f"{label}: launches in the served run ({n_steps} model steps: {steps[1]} prefill, {steps[2]} decode, "
          f"{steps[5]} verify): {launches}", flush=True)
    if steps[5]:
        print(f"{label}: speculative tokens drafted {engine.spec_tokens_drafted}, accepted "
              f"{engine.spec_tokens_accepted}; launches inside the verify steps "
              f"{ {n: v for n, v in in_verify.items() if v} }", flush=True)
    for name in expect:
        if launches[name] <= 0:
            raise AssertionError(f"{name} was never launched on the {label} path")
    for names, per in per_step.items():
        got = sum(launches[n] for n in ((names,) if isinstance(names, str) else names))
        if got != per * n_steps:
            raise AssertionError(f"{names}: {got} launches on the {label} path, expected {per} x {n_steps} steps")
    print(f"{label}: launches per model step: "
          f"{ {n: launches[n] / n_steps for n in launches if launches[n]} }", flush=True)
    launches.update({f"{name}_verify": n for name, n in in_verify.items()})
    engine_params, ecfg = engine.params, engine.ecfg
    del engine
    torch.cuda.empty_cache()
    rates = [len(prompts) * max_tokens / seconds]
    for _ in range(runs - 1):
        engine = LLMEngine(engine_params, cfg, ecfg, **model_fns)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again = engine.generate(prompts, SamplingParams(max_tokens=max_tokens))
        torch.cuda.synchronize()
        rates.append(len(prompts) * max_tokens / (time.perf_counter() - t0))
        print(f"{label}: run {len(rates)} of {runs}: {rates[-1]:.2f} generated tok/s, greedy tokens "
              f"{'equal to' if again == outputs else 'NOT equal to'} run 1's", flush=True)
        del engine
        torch.cuda.empty_cache()
    if runs > 1:
        print(f"{label}: generated tok/s in each of {runs} runs: {[round(r, 2) for r in rates]} on {card}", flush=True)
    if profile:
        prof = profile_served_run(engine_params, cfg, ecfg, model_fns, prompts, max_tokens, label, annotate)
        if record is not None:
            record["profile"] = prof
    return {**launches, **{name: at_init[name] for name in init_launches or {}}}


def profile_served_run(
    params: dict, cfg, ecfg, model_fns: dict, prompts: list, max_tokens: int, label: str, annotate: dict | None = None,
) -> dict | None:
    """The same requests on a fresh engine under torch.profiler (not the
    timed run): ``profile_run``'s breakdown. ``annotate`` ({range name:
    (module, function name)}) wraps those functions, and the engine's
    prefill and decode steps ("prefill_step", "decode_step"), in
    ``record_function`` ranges for the run, and returns ``profile_run``'s
    device time by range."""
    import contextlib

    from conch_tpu_torch.serving import LLMEngine, SamplingParams

    engine = LLMEngine(params, cfg, ecfg, **model_fns)
    if annotate is None:
        profile_run(lambda: engine.generate(prompts, SamplingParams(max_tokens=max_tokens)), label)
        return None

    def ranged(name, fn):
        def wrapped(*args, **kwargs):
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)

        return wrapped

    targets = {**annotate, "prefill_step": (engine, "_prefill_fn"), "decode_step": (engine, "_decode_fn")}
    saved = [(obj, attr, getattr(obj, attr)) for obj, attr in targets.values()]
    with contextlib.ExitStack() as stack:
        for name, (obj, attr) in targets.items():
            setattr(obj, attr, ranged(name, getattr(obj, attr)))
        stack.callback(lambda: [setattr(obj, attr, fn) for obj, attr, fn in saved])
        return profile_run(lambda: engine.generate(prompts, SamplingParams(max_tokens=max_tokens)), label,
                           ranges=tuple(targets))


KERNEL_NAME_CHARS = 120


def range_device_ms(events: list, kernels: list, names: tuple[str, ...]) -> dict:
    """Device time of the kernels launched inside each named
    ``record_function`` range: {name: (ms, ranges, kernels)}. A launch (a
    CUDA runtime or driver call) inside a range's host span names its
    kernel by the trace's correlation id."""
    import bisect

    by_corr = {e["args"]["correlation"]: e for e in kernels if "correlation" in e.get("args", {})}
    launches = [e for e in events if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and e.get("args", {}).get("correlation") in by_corr]
    out = {}
    for name in names:
        spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                       if e.get("cat") == "user_annotation" and e.get("name") == name)
        starts = [a for a, _ in spans]
        inside = []
        for e in launches:
            i = bisect.bisect_right(starts, e["ts"]) - 1
            if i >= 0 and e["ts"] <= spans[i][1]:
                inside.append(by_corr[e["args"]["correlation"]])
        out[name] = (sum(k["dur"] for k in inside) / 1e3, len(spans), len(inside))
    return out


def profile_run(fn, label: str, ranges: tuple[str, ...] = ()) -> dict | None:
    """``fn()`` under torch.profiler: device time by kernel group, from the
    trace's kernel events, and the device's idle share of the wall time;
    for the kernels of K1 to K11 their events' sum and the part of it after
    the end of the kernel before (a programmatic dependent's event starts
    under its predecessor). Kernel names are cut to KERNEL_NAME_CHARS, which
    keeps the norm policy of K4's and K10a's shared kernel. With ``ranges``
    (names of ``record_function`` ranges opened inside ``fn``), prints and
    returns each range's device time (``range_device_ms``) with the busy
    time under "busy"."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    with tempfile.TemporaryDirectory() as tmp:
        trace = f"{tmp}/trace.json"
        prof.export_chrome_trace(trace)
        with open(trace) as f:
            events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    if not kernels:
        print(f"{label} profile: the trace holds no kernel events; device time not measured", flush=True)
        return None
    groups: dict[str, float] = {}
    by_name: dict[str, float] = {}
    for e in kernels:
        name = e["name"]
        low = name.lower()
        # cuBLAS names its Hopper matmul kernels nvjet_*, older ones *gemm*.
        matmul = "conch" not in low and any(tag in low for tag in ("nvjet", "gemm", "sm90", "cutlass"))
        group = "conch kernels" if "conch" in low else "matmul" if matmul else "other"
        groups[group] = groups.get(group, 0.0) + e["dur"] / 1e3
        by_name[name[:KERNEL_NAME_CHARS]] = by_name.get(name[:KERNEL_NAME_CHARS], 0.0) + e["dur"] / 1e3
    busy = sum(groups.values())
    window = (max(e["ts"] + e["dur"] for e in kernels) - min(e["ts"] for e in kernels)) / 1e3
    print(f"{label} profile ({len(kernels)} kernels): wall {wall_ms:.1f} ms, device busy {busy:.1f} ms, "
          f"idle share of the kernels' window {1 - busy / window:.3f}; "
          + ", ".join(f"{g} {t:.1f} ms" for g, t in sorted(groups.items(), key=lambda x: -x[1])), flush=True)
    top = sorted(by_name.items(), key=lambda x: -x[1])[:8]
    print(f"{label} profile top kernels: " + "; ".join(f"{n} {t:.1f} ms" for n, t in top), flush=True)
    # A programmatic-dependent kernel's event starts under the kernel
    # before it: its time after the latest end of the kernels that started
    # before it is its own.
    own, last_end = {}, float("-inf")
    for e in sorted(kernels, key=lambda e: e["ts"]):
        end = e["ts"] + e["dur"]
        own[id(e)] = max(0.0, end - max(e["ts"], last_end)) / 1e3
        last_end = max(last_end, end)
    # The kernels one K1, K1b, K1c or K8 call may launch (the GEMM, the
    # split reduction, K1b's x row-sum pre-pass), and K3's, K7's and K11's
    # two each (the split walk, the merge); K6's and K10b's by their own
    # names or their activation in the shared template's.
    for tag, names in (("K1/K1b/K1c/K8", ("qgemm::", "group_row_sums")), ("K3", ("paged_split", "paged_merge")),
                       ("K7", ("varlen_tile", "varlen_merge", "varlen_rows")), ("K11", ("mla_",)),
                       ("K5", ("rope_kernel",)), ("K10a", ("gemma_rms_norm_kernel", "GemmaNorm")),
                       ("K4", ("::rms_norm_kernel", "LlamaNorm")),
                       ("K2", ("stacked_write_kernel", "cache_write_kernel")),
                       ("K6", ("silu_and_mul_kernel", "SiluAct")),
                       ("K10b", ("gelu_tanh_and_mul_kernel", "GeluTanhAct"))):
        found = {n: t for n, t in by_name.items() if any(key in n for key in names)}
        if found:
            counts = {n: sum(1 for e in kernels if e["name"][:KERNEL_NAME_CHARS] == n) for n in found}
            mine = {n: sum(own[id(e)] for e in kernels if e["name"][:KERNEL_NAME_CHARS] == n) for n in found}
            print(f"{label} profile {tag} kernels: " + "; ".join(
                f"{n} {t:.1f} ms in {counts[n]} launches ({mine[n]:.1f} ms after the kernel before ended)"
                for n, t in sorted(found.items(), key=lambda x: -x[1])), flush=True)
    if not ranges:
        return None
    by_range = range_device_ms(events, kernels, ranges)
    for name, (ms, spans, n) in by_range.items():
        measured = f"{ms:.1f} ms of device time ({ms / busy:.3f} of busy) in {n} kernels" if n else "not measured"
        print(f"{label} profile range {name}: {spans} ranges, {measured}", flush=True)
    return {"busy": busy, "wall": wall_ms, **by_range}


# The top-p filter on the card (check_top_p_filter): the int4 engine's
# decode step (32 rows of Llama-3's 128256 tokens) and Gemma-2-2B's (16 of
# 256000), logits N(0, 3^2), temperature 1, no top-k.
TOP_P_STEPS = (("llama3_8b int4", 32, 128256), ("gemma2_2b", 16, 256000))
TOP_PS = (1.0, 0.999, 0.9, 0.5)
TOP_P_MARGIN = 1e-6


def _mass_before(row: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """A row's token order by descending value and each sorted token's exact
    mass before it: the f64 probability of the tokens with larger values."""
    order = np.argsort(-row, kind="stable")
    v = row[order].astype(np.float64)
    p = np.exp(v - v[0])
    p /= p.sum()
    before = np.concatenate([[0.0], np.cumsum(p)[:-1]])
    return order, before[np.searchsorted(-v, -v, side="left")]


def parent_sample_tokens_f32(logits, generator, temperature, top_k, top_p) -> torch.Tensor:
    """``sample_tokens`` as the port ran it before its top-p pass moved to
    f64 (softmax and cumulative sum in f32); timed beside it, used nowhere."""
    batch, vocab = logits.shape
    greedy = logits.argmax(dim=-1)
    scaled = logits / temperature.clamp_min(1e-6)[:, None]
    sorted_desc = scaled.sort(dim=-1, descending=True).values
    k = torch.where(top_k > 0, top_k, vocab)
    kth = sorted_desc.gather(-1, (k - 1).clamp(0, vocab - 1)[:, None])
    scaled = scaled.masked_fill(scaled < kth, float("-inf"))
    sorted_desc = sorted_desc.masked_fill(sorted_desc < kth, float("-inf"))
    cumprobs = torch.softmax(sorted_desc, dim=-1).cumsum(dim=-1)
    cutoff_idx = (cumprobs < top_p[:, None]).sum(dim=-1).clamp(max=vocab - 1)
    cutoff_val = sorted_desc.gather(-1, cutoff_idx[:, None])
    scaled = scaled.masked_fill(scaled < cutoff_val, float("-inf"))
    sampled = torch.multinomial(torch.softmax(scaled, dim=-1), 1, generator=generator)[:, 0]
    return torch.where(temperature <= 0.0, greedy, sampled).to(torch.int32)


def check_top_p_filter(card: str) -> None:
    """``top_k_top_p_filter`` on the card at TOP_P_STEPS and TOP_PS, held to
    the kept-set rule of tests/test_torch_sampling.py: a token whose exact
    mass before it is below top_p - TOP_P_MARGIN is kept, one above top_p +
    TOP_P_MARGIN dropped, every token kept at 1.0. Prints the kept counts
    (and the parent's f32 pass's at 1.0) and the device time of one
    ``sample_tokens`` call as the engine makes it (per-row top_k 0 and top_p
    1.0 tensors) beside the parent's f32 pass."""
    from conch_tpu_torch.serving.sampling import sample_tokens, top_k_top_p_filter

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for label, rows, vocab in TOP_P_STEPS:
        logits = 3.0 * torch.randn((rows, vocab), generator=gen, device="cuda")
        host = logits.cpu().numpy()
        sorted_rows = [_mass_before(host[r]) for r in range(rows)]
        top_k = torch.zeros(rows, dtype=torch.int64, device="cuda")
        temperature = torch.ones(rows, device="cuda")
        counts, failed = {}, []
        for top_p in TOP_PS:
            top_p_t = torch.full((rows,), top_p, device="cuda")
            filtered = top_k_top_p_filter(logits, top_k, top_p_t).cpu().numpy()
            kept_counts = []
            for r, (order, before) in enumerate(sorted_rows):
                kept = np.isfinite(filtered[r][order])
                kept_counts.append(int(kept.sum()))
                if not kept[before < top_p - TOP_P_MARGIN].all() or kept[before > top_p + TOP_P_MARGIN].any():
                    failed.append(f"row {r} at top_p {top_p}")
            if top_p == 1.0 and kept_counts != [vocab] * rows:
                failed.append(f"top_p 1.0 kept {min(kept_counts)} of {vocab}")
            counts[top_p] = kept_counts
        ones = torch.ones(rows, device="cuda")
        # The parent's f32 pass at 1.0 keeps the tokens up to its cutoff index.
        cum = torch.softmax(logits.sort(dim=-1, descending=True).values, dim=-1).cumsum(dim=-1)
        parent_kept = ((cum < 1.0).sum(dim=-1).clamp(max=vocab - 1) + 1).tolist()
        g, gen_f32 = (torch.Generator(device="cuda").manual_seed(SEED) for _ in range(2))
        ms = time_ms(lambda: sample_tokens(logits, g, temperature, top_k=top_k, top_p=ones))
        parent_ms = time_ms(lambda: parent_sample_tokens_f32(logits, gen_f32, temperature, top_k, ones))
        print(f"top-p filter {label} ({rows} x {vocab}): kept " + "; ".join(
            f"{tp}: {min(c)} to {max(c)}" for tp, c in counts.items())
            + f" (the parent's f32 pass at 1.0: {min(parent_kept)} to {max(parent_kept)}); sample_tokens "
            f"{ms:.4f} ms with the f64 top-p pass, {parent_ms:.4f} ms with the parent's f32 pass, on {card}",
            flush=True)
        if failed:
            raise AssertionError(f"top-p filter {label}: " + "; ".join(failed[:10]))


# The mainloop's templates in a mangled kernel name: layout, bits (K1: group) and flag (K1, K1b, K1c; K8's
# layouts have none), rows a block.
QGEMM_TEMPLATE = re.compile(
    r"quant_gemm_kernel.*?(RowsLayout|PlanarLayout|MagicLayout|ScaledLayout|E4m3Layout)(?:ILi(\d+)EL[ib](\d+)EE)?"
    r"(?:ILi(\d+)EE)?ELi(\d+)E")


def build() -> None:
    """Build the kernels and print ptxas's report: every register and spill
    line and every wgmma serialization warning, then one line per template
    of the GEMM mainloop (layout, K1/K1b/K1c's bits and flag, rows a block)
    with its registers and spills."""
    from conch_tpu_torch.kernels.common import BUILD_DIR, kernel_library

    t0 = time.perf_counter()
    kernel_library()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s", flush=True)
    template, spills = None, ""
    for line in (BUILD_DIR / "nvcc.log").read_text().splitlines():
        if "registers" in line or ("spill" in line and " 0 bytes spill stores" not in line) or "Performance Loss" in line:
            print("nvcc:", line.strip())
        if "Compiling entry function" in line:
            match = QGEMM_TEMPLATE.search(line)
            if match is None:
                template = None
            else:
                layout, bits, flag, group, bn = match.groups()
                args = f"<{bits}, {flag}>" if bits is not None else f"<{group}>" if group is not None else ""
                template = f"{layout}{args} BN {bn}"
        elif template and "spill stores" in line:
            spills = line.strip()
        elif template and "Used" in line and "registers" in line:
            print(f"ptxas {template}: {line.split(':', 1)[1].strip()}; {spills}", flush=True)
            template = None


LLAMA_KERNELS = (
    "mixed_gemm_magic", "reshape_and_cache_stacked", "paged_attention", "rms_norm", "rotary_embedding",
    "silu_and_mul", "varlen_attention",
)
LLAMA_COMMON = tuple(k for k in LLAMA_KERNELS if k != "mixed_gemm_magic")
# The run whose launches a kernel row reports; the others' counts stand
# beside them (``launches_by_path``).
PRIMARY_PATH = {
    "mixed_gemm_magic": "llama3_8b_int4", "rms_norm": "llama3_8b_int4", "silu_and_mul": "llama3_8b_int4",
    "mixed_gemm_planar": "llama3_8b_int8", "mixed_gemm_rows": "llama3_8b_nf4", "quantize4": "llama3_8b_nf4",
    "scaled_gemm": "llama3_8b_w8a8", "mla_attention": "deepseek_v2_lite_bf16",
    "bev_pool_fwd": "vision_bevfusion", "bev_pool_bwd": "vision_bevfusion", "nms": "vision_bevfusion",
    "dequantize4": "llama3_8b_qlora", "fused_add_rms_norm": "llama3_8b_residual_stream",
    "ring_all_gather": "llama3_8b_tp8_collectives", "paged_attention_ring": "mistral_7b_int4_rolling",
    "varlen_attention_ring": "mistral_7b_int4_rolling", "paged_attention_g7": "qwen2_7b_int4",
    "varlen_attention_g7": "qwen2_7b_int4", "mixed_gemm_magic_qwen2": "qwen2_7b_int4",
    "mixed_gemm_magic_g32": "deepseek_v2_lite_int4", "mixed_gemm_planar_g32": "deepseek_v2_lite_int8",
    "mixed_gemm_magic_gemma": "gemma2_2b_int4", "varlen_attention_verify": "llama3_8b_int4_spec",
    "mla_attention_verify": "deepseek_v2_lite_spec", "paged_attention_beam": "llama3_8b_int4_beam",
}
# Rows of a kernel's branch or another model's shapes: the count their
# launches come from (K3's and K7's ring rows: their launches over a ring).
ROW_COUNTERS = {
    "paged_attention_ring": "paged_attention_ring", "varlen_attention_ring": "varlen_attention_ring",
    "paged_attention_g7": "paged_attention", "varlen_attention_g7": "varlen_attention",
    "mixed_gemm_magic_qwen2": "mixed_gemm_magic", "mixed_gemm_magic_g32": "mixed_gemm_magic",
    "mixed_gemm_planar_g32": "mixed_gemm_planar", "mixed_gemm_magic_gemma": "mixed_gemm_magic",
    # K7 V and K11 V: their launches inside the speculative verify steps.
    "varlen_attention_verify": "varlen_attention_verify", "mla_attention_verify": "mla_attention_verify",
    # K3 beam: its launches inside the beam search's decode steps.
    "paged_attention_beam": "paged_attention_beam",
}
# K9's callers are its public ops: its row's launches are those of its
# kernel phase, and it launches on no served path. Neither do K8 over e4m3
# (its row counts the phase's launches on the fp8 mainloop) and K7's f32
# loop kernel: no served model runs them.
PHASE_PATH_KERNELS = ("static_scaled_quant", "scaled_gemm_e4m3", "varlen_attention_f32")
GEMMA_KERNELS = (
    "reshape_and_cache_stacked", "paged_attention", "rotary_embedding", "varlen_attention", "gemma_rms_norm",
    "gelu_tanh_and_mul",
)


# Mistral-7B's engines: page 16, 512-row prefill steps (so a ring of
# ceil((4096 + 512) / 16) + 1 = 289 pages), 8 requests at once, no prefix
# caching (ring pages are rewritten in place; the twin turns it off too,
# so that both engines run the same steps).
MISTRAL_ENGINE = {"page_size": PS, "max_prefill_tokens": MISTRAL_PREFILL, "max_batch_size": 8,
                  "enable_prefix_caching": False}
MISTRAL_ROLLING = {**MISTRAL_ENGINE, "rolling_kv": True, "num_pages": 8 * MISTRAL_RING,
                   "max_pages_per_seq": MISTRAL_RING}
MISTRAL_UNBOUNDED = {**MISTRAL_ENGINE, "num_pages": 8 * MISTRAL_TABLE, "max_pages_per_seq": MISTRAL_TABLE}
QWEN2_ENGINE = {"num_pages": 4096, "max_batch_size": 32, "max_pages_per_seq": Q2_TABLE}


def check_rolling_twins(rolling: dict, unbounded: dict, launches: dict) -> None:
    """The rolling engine's greedy tokens equal its unbounded twin's; it
    held at most its ring (MISTRAL_RING pages) a sequence while the twin
    held more; every K3 and K7 launch of the rolling run read the ring, and
    none of the twin's."""
    if rolling["config"].kv_ring_pages != MISTRAL_RING:
        raise AssertionError(f"rolling engine: a ring of {rolling['config'].kv_ring_pages} pages, not {MISTRAL_RING}")
    if rolling["outputs"] != unbounded["outputs"]:
        bad = [i for i, (a, b) in enumerate(zip(rolling["outputs"], unbounded["outputs"])) if a != b]
        raise AssertionError(f"rolling KV: requests {bad} differ from the unbounded twin's greedy tokens")
    if rolling["seq_pages"] > MISTRAL_RING or unbounded["seq_pages"] <= MISTRAL_RING:
        raise AssertionError(f"pages a sequence: rolling {rolling['seq_pages']} (ring {MISTRAL_RING}), unbounded "
                             f"{unbounded['seq_pages']}: the prompts must outgrow the ring")
    ring, twin = launches["mistral_7b_int4_rolling"], launches["mistral_7b_int4_unbounded"]
    for ring_name, kernel in RING_COUNTERS.items():
        if not 0 < ring[ring_name] == ring[kernel] or twin[ring_name] != 0:
            raise AssertionError(f"{kernel}: {ring[ring_name]} of {ring[kernel]} launches over the ring in the "
                                 f"rolling run, {twin[ring_name]} in the twin's")
    print(f"mistral-7b rolling KV: greedy tokens of {len(rolling['outputs'])} requests equal to the unbounded twin's; "
          f"at most {rolling['seq_pages']} pages a sequence ({rolling['pages']} in all, "
          f"{rolling['kv_bytes'] / 2**30:.2f} GiB of KV) against {unbounded['seq_pages']} ({unbounded['pages']}, "
          f"{unbounded['kv_bytes'] / 2**30:.2f} GiB); K3 {ring['paged_attention_ring']} and K7 "
          f"{ring['varlen_attention_ring']} launches over the ring", flush=True)


def report_mixtral_profile(card: str, cfg, record: dict) -> None:
    """The served Mixtral run's profile beside its bounds: the share of
    device time in ``moe_ffn`` and in its experts (``moe_experts``: the three
    expert einsums and their SwiGLU), and a decode step's device time beside
    the time the card needs to read the step's weights once (the experts
    alone, and every layer's weights and the head) at HBM_BYTES_PER_S."""
    prof = record.get("profile")
    c, e = cfg.llama, cfg.num_experts
    q, kv = c.num_heads * c.head_dim, c.num_kv_heads * c.head_dim
    item = torch.empty((), dtype=c.dtype).element_size()
    expert_bytes = c.num_layers * 3 * e * c.hidden_size * c.intermediate_size * item
    attention_bytes = (c.hidden_size * (q + 2 * kv) + q * c.hidden_size) * 2  # wqkv and wo in bf16
    weight_bytes = expert_bytes + c.num_layers * (attention_bytes + c.hidden_size * e * 4) + c.hidden_size * c.vocab_size * 2
    expert_ms, weight_ms = expert_bytes / HBM_BYTES_PER_S * 1e3, weight_bytes / HBM_BYTES_PER_S * 1e3
    if prof is None or prof["decode_step"][2] == 0:
        print(f"mixtral-8x7b-bf16: device time by range not measured; a decode step reads {expert_bytes / 1e9:.1f} GB "
              f"of experts ({expert_ms:.2f} ms at {HBM_BYTES_PER_S / 1e12} TB/s) on {card}", flush=True)
        return
    busy = prof["busy"]
    step_ms, steps, _ = prof["decode_step"]
    pre_ms, pre_steps, _ = prof["prefill_step"]
    print(f"mixtral-8x7b-bf16 profile: busy {busy:.1f} ms of {prof['wall']:.1f} ms wall; moe_ffn "
          f"{prof['moe_ffn'][0]:.1f} ms ({prof['moe_ffn'][0] / busy:.3f} of busy), its experts (moe_experts: three "
          f"einsums and the SwiGLU) {prof['moe_experts'][0]:.1f} ms ({prof['moe_experts'][0] / busy:.3f}); "
          f"{pre_steps} prefill steps {pre_ms:.1f} ms, {steps} decode steps {step_ms:.1f} ms on {card}", flush=True)
    print(f"mixtral-8x7b-bf16 decode step: {step_ms / steps:.3f} ms of device time a step against a bound of "
          f"{expert_ms:.3f} ms for its {expert_bytes / 1e9:.2f} GB of expert weights and {weight_ms:.3f} ms for all "
          f"{weight_bytes / 1e9:.2f} GB of its weights, read once at {HBM_BYTES_PER_S / 1e12} TB/s "
          f"({weight_ms / (step_ms / steps):.3f} of the bound) on {card}", flush=True)


# -- the speculative, parallel-sampling and multi-LoRA paths ---------------

# check_verify_logits: the verify step (VERIFY_*) over a cached context of
# 200 to 1000 tokens a sequence, 2 layers at full width: (model, weights,
# activation dtype). Gemma-2-2B's window is cut to 512, so that layer 0's
# mask bites at these contexts.
VERIFY_CHECK_CASES = (
    ("llama3_8b", "bf16", torch.float32), ("llama3_8b", "bf16", torch.bfloat16), ("llama3_8b", "int4", torch.bfloat16),
    ("gemma2_2b", "bf16", torch.float32), ("gemma2_2b", "bf16", torch.bfloat16),
    ("deepseek_v2_lite", "bf16", torch.float32), ("deepseek_v2_lite", "bf16", torch.bfloat16),
    ("mixtral_8x7b", "bf16", torch.float32), ("mixtral_8x7b", "bf16", torch.bfloat16),
)
VERIFY_CHECK_CONTEXTS = [200, 314, 428, 542, 657, 771, 885, 1000]


def verify_check_step(vocab: int) -> list[torch.Tensor]:
    """The check's verify step on the host: 8 sequences of VERIFY_Q rows
    after VERIFY_CHECK_CONTEXTS cached tokens, in VERIFY_ROWS rows (the rest
    padding rows: token 0, slot -1): token ids, positions, cu_seqlens_q,
    seq_lens, block table (64 pages a row), slots; and the pool's pages."""
    rng = np.random.default_rng(SEED + 3)
    total = VERIFY_SEQS * VERIFY_Q
    seq_lens = [c + VERIFY_Q for c in VERIFY_CHECK_CONTEXTS]
    num_pages = sum(-(-n // PS) for n in seq_lens) + 1
    bt = paged_layout(rng, seq_lens, num_pages, share=(0, 0), shared_pages=0, max_pages=MAX_PAGES_PER_SEQ)
    tokens = np.zeros(VERIFY_ROWS, np.int32)
    tokens[:total] = rng.integers(0, vocab, total)
    positions = np.zeros(VERIFY_ROWS, np.int32)
    positions[:total] = [c + j for c in VERIFY_CHECK_CONTEXTS for j in range(VERIFY_Q)]
    slots = np.full(VERIFY_ROWS, -1, np.int32)
    slots[:total] = [int(bt[b, p // PS]) * PS + p % PS for b, c in enumerate(VERIFY_CHECK_CONTEXTS)
                     for p in range(c, c + VERIFY_Q)]
    cu = np.arange(0, total + 1, VERIFY_Q, dtype=np.int32)
    host = [torch.from_numpy(a) for a in (tokens, positions, cu, np.array(seq_lens, np.int32), bt, slots)]
    return host, num_pages


class RouteReplay:
    """Wraps a model's router (``module.name`` returning (weights, experts))
    for a card run and then a CPU run on the same step: the card run's
    ordered experts are recorded call by call; during the CPU run each call
    records its own choice, then takes the card's (weights recomputed by
    ``weights_of(args, experts)`` from the CPU's own router logits). A near
    tie that the two devices break apart then moves no other row's
    capacity, and the logits compare row by row."""

    def __init__(self, module, name: str, weights_of):
        self.module, self.name, self.route, self.weights_of = module, name, getattr(module, name), weights_of
        self.card, self.own, self.replaying = [], [], False

    def __enter__(self):
        def route(*args, **kwargs):
            weights, experts = self.route(*args, **kwargs)
            if not self.replaying:
                self.card.append(experts.cpu())
                return weights, experts
            self.own.append(experts.cpu())
            experts = self.card[len(self.own) - 1].to(experts.device)
            return self.weights_of(args, kwargs, experts), experts

        setattr(self.module, self.name, route)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.route)

    def differing_rows(self) -> int:
        """Rows whose ordered choice differs between the devices, over every call."""
        return sum(int((a != b).any(dim=-1).sum()) for a, b in zip(self.card, self.own, strict=True))


def _verify_case(family: str, quant_mode: str, dtype: torch.dtype):
    """(label, config, params on the card, verify_fn, cache shape, RouteReplay or None)."""
    import conch_tpu_torch.models.deepseek as ds
    import conch_tpu_torch.models.moe as moe
    from conch_tpu_torch.models.gemma import GemmaConfig, gemma_verify_forward, init_gemma_params
    from conch_tpu_torch.models.llama import LlamaConfig, fuse_llama_params, init_llama_params, llama_verify_forward

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    label = f"{family}, {quant_mode} weights, {str(dtype).removeprefix('torch.')}"
    replay = None
    if family == "llama3_8b":
        cfg = dataclasses.replace(LlamaConfig.llama3_8b(), num_layers=2, dtype=dtype)
        params = fuse_llama_params(init_llama_params(SEED, cfg, quant_mode, device="cuda"))
        fn, kv = llama_verify_forward, (cfg.num_kv_heads, PS, cfg.head_dim)
    elif family == "gemma2_2b":
        cfg = dataclasses.replace(GemmaConfig.gemma2_2b(), num_layers=2, sliding_window=512, dtype=dtype)
        params = fuse_llama_params(random_norm_weights(init_gemma_params(SEED, cfg, device="cuda"), gen))
        fn, kv = gemma_verify_forward, (cfg.num_kv_heads, PS, cfg.head_dim)
    elif family == "deepseek_v2_lite":
        cfg = dataclasses.replace(ds.DeepseekV2Config.v2_lite(), num_layers=2, dtype=dtype)
        params = ds.fuse_deepseek_params(ds.init_deepseek_params(SEED, cfg, device="cuda"))
        for stack in ("layers_dense", "layers_moe"):
            for n, w in params[stack].items():
                if n.endswith("_norm"):
                    w.copy_(1.0 + 0.3 * torch.randn(w.shape, generator=gen, device="cuda"))
        fn, kv = ds.deepseek_verify_forward, (PS, cfg.kv_packed_dim)

        def ds_weights(args, kwargs, experts):  # V2-Lite's greedy gate: softmax over all, no renormalization
            hidden, router_w, config = args[:3]
            probs = torch.softmax(hidden.float() @ router_w.float(), dim=-1)
            return probs.gather(1, experts.long()) * config.routed_scaling_factor

        replay = RouteReplay(ds, "deepseek_route", ds_weights)
    else:
        cfg = mixtral_config(2, dtype)
        params = fuse_llama_params(moe.init_moe_params(SEED, cfg, quant_mode, device="cuda"))
        fn, kv = moe.mixtral_verify_forward, (cfg.llama.num_kv_heads, PS, cfg.llama.head_dim)

        def moe_weights(args, kwargs, experts):  # Mixtral: the softmax of the chosen experts' logits
            return torch.softmax(torch.gather(args[0].float(), 1, experts.long()), dim=-1)

        replay = RouteReplay(moe, "route_topk", moe_weights)
    if family != "deepseek_v2_lite":
        norms = [params["final_norm"]] + [w for n, w in params["layers"].items() if n.endswith("_norm")]
        if family != "gemma2_2b":
            for w in norms:
                w.copy_(1.0 + 0.3 * torch.randn(w.shape, generator=gen, device="cuda"))
    return label, cfg, params, fn, kv, replay


def check_verify_logits(cases=VERIFY_CHECK_CASES) -> None:
    """Every row's logits of a 2-layer, full-width verify step (8 sequences
    of 1 + 4 rows after 200 to 1000 cached tokens, 24 padding rows, 64 in
    all) on the card (K7, or K11 for DeepSeek, at the verify shape; K1 for
    int4) against the same step on the CPU (plain versions), over the same
    random cache (N(0, 1) rows; DeepSeek's pad columns zero): Llama-3-8B
    (bf16 weights in f32 and bf16, int4 in bf16), Gemma-2-2B (window cut to
    512), DeepSeek-V2-Lite and Mixtral-8x7B in f32 and bf16, random norm
    weights; MoE routing through ``RouteReplay`` (the CPU takes the card's
    ordered experts; in f32 its own choice must equal the card's on every
    row). Held by ``logits_agree`` at PREFILL_TOLERANCES; every row finite,
    the padding rows' too (Mixtral's included, where the JAX package's are
    NaN)."""
    require_full_f32("check_verify_logits")
    for family, quant_mode, dtype in cases:
        label, cfg, params, fn, kv, replay = _verify_case(family, quant_mode, dtype)
        vocab = cfg.llama.vocab_size if family == "mixtral_8x7b" else cfg.vocab_size
        host, num_pages = verify_check_step(vocab)
        gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
        kc = torch.randn((2, num_pages, *kv), generator=gen, device="cuda").to(dtype)
        if family == "deepseek_v2_lite":
            kc[..., cfg.kv_lora_rank + cfg.qk_rope_head_dim :] = 0
            vc = torch.zeros(0, dtype=dtype, device="cuda")
        else:
            vc = torch.randn(kc.shape, generator=gen, device="cuda").to(dtype)
        kc_cpu, vc_cpu = kc.cpu(), vc.cpu()
        t = [a.cuda() for a in host]
        with replay if replay is not None else contextlib.nullcontext():
            logits, _, _ = fn(params, cfg, t[0], t[1], t[2], VERIFY_MAX_Q, t[3], t[4], t[5], kc, vc)
            logits = logits.cpu()
            cpu_params = to_device(params, "cpu")
            del params, kc, vc
            torch.cuda.empty_cache()
            if replay is not None:
                replay.replaying = True
            ref, _, _ = fn(cpu_params, cfg, *host[:3], VERIFY_MAX_Q, *host[3:], kc_cpu, vc_cpu)
        del cpu_params
        gc.collect()
        if logits.shape != (VERIFY_ROWS, vocab) or not torch.isfinite(logits).all():
            raise AssertionError(f"verify logits ({label}): shape {tuple(logits.shape)} or non-finite values")
        routing = ""
        if replay is not None:
            differ = replay.differing_rows()
            routing = f"; MoE rows whose own routing differs from the card's (the CPU took the card's): {differ}"
            if dtype == torch.float32 and differ:
                raise AssertionError(f"verify check ({label}): MoE routing differs from the CPU's in f32")
        ok, err, scale, rule = logits_agree(logits, ref, dtype, PREFILL_TOLERANCES[dtype])
        print(f"2-layer verify logits, {label}, 8 x 5 rows after 200 to 1000 cached tokens and 24 padding rows, "
              f"card vs plain path on the CPU: max_abs_err {err:.3e}, max|ref| {scale:.3f}, tolerance {rule}"
              f"{routing}", flush=True)
        if not ok:
            raise AssertionError(f"2-layer verify logits ({label}) disagree with the plain path")


# The served speculative path and its checks (Llama-3-8B int4, 32 layers;
# DeepSeek-V2-Lite): 8 prompts, each a 16-token motif drawn from the seed
# repeated to 1000 to 1049 tokens; 4 drafted tokens a step; 128 new tokens
# a request (DeepSeek: 32).
SPEC_ENGINE = {"num_pages": 2048, "max_batch_size": 8, "max_pages_per_seq": 80}
SPEC_MOTIF, SPEC_TOKENS, SPEC_MAX_TOKENS, SPEC_RUNS = 16, 4, 128, 3
SPEC_NEAR_TIE = PREFILL_TOLERANCES[torch.bfloat16]  # logits_agree's bf16 rule: a gap within 3e-2 x max |logit|


def spec_prompts(rng: np.random.Generator, vocab: int) -> list[list[int]]:
    """8 prompts of 1000 to 1049 tokens, each its own 16-token motif repeated."""
    return [(rng.integers(0, vocab, SPEC_MOTIF).tolist() * 70)[: 1000 + 7 * i] for i in range(8)]


def last_logits(params: dict, cfg, tokens: list[int], lora: tuple | None = None) -> torch.Tensor:
    """The logits after ``tokens``: one prefill of one sequence on the card
    over a cache of its own (Llama family); ``lora``: (stacked adapters,
    the adapter id of every token)."""
    from conch_tpu_torch.models.llama import init_kv_caches, llama_prefill

    t = len(tokens)
    pages = -(-t // PS)
    kc, vc = init_kv_caches(cfg, pages, PS, device="cuda")
    bt = torch.arange(pages, dtype=torch.int32, device="cuda")[None]
    extra = {} if lora is None else {"lora": lora[0], "lora_ids": torch.full((t,), lora[1], dtype=torch.int32,
                                                                              device="cuda")}
    logits, _, _ = llama_prefill(
        params, cfg, torch.tensor(tokens, dtype=torch.int32, device="cuda"),
        torch.arange(t, dtype=torch.int32, device="cuda"), torch.tensor([0, t], dtype=torch.int32, device="cuda"),
        t, torch.tensor([t], dtype=torch.int32, device="cuda"), bt, torch.arange(t, dtype=torch.int32, device="cuda"),
        kc, vc, **extra,
    )
    return logits[0].float().cpu()


def near_tie(logits: torch.Tensor, a: int, b: int, bound: float | None = None) -> tuple[bool, float]:
    """Whether tokens ``a`` and ``b`` tie: their logits' gap within ``bound``
    (logit units), or within SPEC_NEAR_TIE x max |logit| without one; the gap."""
    gap = abs(logits[a].item() - logits[b].item())
    return gap <= (SPEC_NEAR_TIE * logits.abs().max().item() if bound is None else bound), gap


def check_diverged(
    label: str, params: dict, cfg, prompts: list, got: list, want: list, spread: float, lora: tuple | None = None,
) -> int:
    """``got`` equals ``want`` request by request up to a first divergence,
    which must sit at a near tie: under a prefill of the history there (with
    ``lora``'s adapter, as ``last_logits``), the two tokens' logits within
    twice ``spread`` (``check_spec_echo``'s measured difference between two
    32-layer bf16 paths' logits, so that either path's logits lie within it
    of the prefill's). Returns the requests equal throughout."""
    equal = 0
    for i, (a, b) in enumerate(zip(got, want, strict=True)):
        if a == b:
            equal += 1
            continue
        p = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
        tied, gap = near_tie(last_logits(params, cfg, prompts[i] + b[:p], lora), a[p], b[p], 2 * spread)
        print(f"{label}: request {i} diverges at token {p} ({a[p]} against {b[p]}): logit gap {gap:.4f} "
              f"(near tie within {2 * spread:.4f}), {'a near tie' if tied else 'NOT a near tie'}", flush=True)
        if not tied:
            raise AssertionError(f"{label}: request {i} diverges at token {p} away from a near tie")
    return equal


def check_spec_echo(card: str, params: dict, cfg, prompts: list) -> float:
    """The greedy-exact contract at full width: the plain int4 engine's 16
    greedy tokens on the 8 spec prompts, then one verify step over them on a
    fresh engine (each sequence's first token and the next 14, 120 rows in
    128): each row's argmax must equal the next plain token, but at a near
    tie (SPEC_NEAR_TIE x max |logit|, logits_agree's bf16 rule). Returns the
    spread of two 32-layer bf16 paths: the largest difference between a
    sequence's last verify row and a prefill of the same history, over the
    8 sequences (logit units)."""
    from conch_tpu_torch.serving import EngineConfig, LLMEngine, SamplingParams
    from conch_tpu_torch.serving.engine import RequestState

    plain = LLMEngine(params, cfg, EngineConfig(**SPEC_ENGINE)).generate(prompts, SamplingParams(max_tokens=16))
    engine = LLMEngine(params, cfg, EngineConfig(**SPEC_ENGINE, mixed_batching=False))  # no decode before the last prefill
    for p in prompts:
        engine.add_request(p, SamplingParams(max_tokens=16))
    while engine.waiting or any(r.state == RequestState.PREFILLING for r in engine.running):
        engine.step()
    reqs = engine.running
    if [r.output_tokens for r in reqs] != [out[:1] for out in plain]:
        raise AssertionError("spec echo: the prefill's first tokens differ from the plain engine's")
    reqs = engine._ensure_decode_pages(reqs, extra={r.request_id: 14 for r in reqs})
    chunks = [(r, r.total_len - 1, [r.output_tokens[-1], *out[1:15]]) for r, out in zip(reqs, plain)]
    logits, total, _ = engine._ragged_step(engine._verify_fn, chunks)
    logits = logits[:total].float().cpu()
    preds = logits.argmax(dim=-1).tolist()
    agree, ties = 0, []
    for i, out in enumerate(plain):
        for j in range(15):
            row, want = 15 * i + j, out[j + 1]
            if preds[row] == want:
                agree += 1
                continue
            tied, gap = near_tie(logits[row], preds[row], want)
            ties.append((i, j, round(gap, 4)))
            if not tied:
                raise AssertionError(f"spec echo: request {i} row {j}: verify argmax {preds[row]} against plain "
                                     f"{want}, logit gap {gap:.4f} away from a near tie")
    spread = max((logits[15 * i + 14] - last_logits(params, cfg, p + out[:15])).abs().max().item()
                 for i, (p, out) in enumerate(zip(prompts, plain)))
    print(f"spec echo (llama3-8b int4, 32 layers): {agree} of {total} verify rows give the plain engine's next "
          f"greedy token; near ties at (request, row, gap) {ties}; the last verify row against a prefill of the "
          f"same history differs by up to {spread:.4f} (max |logit| {logits.abs().max().item():.3f}) on {card}",
          flush=True)
    return spread


def profile_spec_run(fn, engine) -> dict:
    """``fn()`` under torch.profiler with the engine's verify steps in
    ``record_function`` ranges: busy ms, wall ms, the idle share of the
    kernels' window, and the device ms and launches of K7's kernels inside
    the verify steps (``range_device_ms``)."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    verify = engine._verify_fn

    def ranged(*args, **kwargs):
        with torch.profiler.record_function("verify_step"):
            return verify(*args, **kwargs)

    engine._verify_fn = ranged
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    engine._verify_fn = verify
    with tempfile.TemporaryDirectory() as tmp:
        prof.export_chrome_trace(f"{tmp}/trace.json")
        with open(f"{tmp}/trace.json") as f:
            events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    if not kernels:
        return {"busy": None, "wall": wall, "idle": None, "k7_verify_ms": None, "k7_verify_kernels": None}
    busy = sum(e["dur"] for e in kernels) / 1e3
    window = (max(e["ts"] + e["dur"] for e in kernels) - min(e["ts"] for e in kernels)) / 1e3
    k7 = [e for e in kernels if any(n in e["name"] for n in ("varlen_tile", "varlen_merge", "varlen_rows"))]
    k7_ms, _, k7_n = range_device_ms(events, k7, ("verify_step",))["verify_step"]
    return {"busy": busy, "wall": wall, "idle": 1 - busy / window, "k7_verify_ms": k7_ms, "k7_verify_kernels": k7_n}


def serve_spec(card: str, params: dict, cfg, spread: float) -> dict:
    """``llama3_8b_int4_spec``: the spec prompts served SPEC_RUNS times by a
    fresh speculative engine (SPEC_TOKENS drafted a step) beside a fresh
    plain one; each run's tok/s, the spec counters and the launches inside
    the verify steps; in the first round a profiled repeat of each (busy
    ms, idle share, K7's device ms and kernels inside the verify steps: a
    profile of a run costs about 20 s, so the later rounds are timed only,
    to keep the slice's phases within 150 s). The speculative tokens must
    equal the plain ones up to a first divergence at a near tie, and every
    round's tokens the first round's. Returns the first speculative run's
    launches (K7's inside the verify steps as ``varlen_attention_verify``)."""
    from conch_tpu_torch.serving import EngineConfig, LLMEngine, SamplingParams

    prompts = spec_prompts(np.random.default_rng(SEED), cfg.vocab_size)
    sampling = SamplingParams(max_tokens=SPEC_MAX_TOKENS)
    n_tokens = len(prompts) * SPEC_MAX_TOKENS
    launches, rates, first = None, {"plain": [], "spec": []}, None
    for run in range(SPEC_RUNS):
        outs = {}
        for kind in ("plain", "spec"):
            ecfg = EngineConfig(**SPEC_ENGINE, num_speculative_tokens=SPEC_TOKENS if kind == "spec" else 0)
            engine = LLMEngine(params, cfg, ecfg)
            steps, in_verify = count_steps(engine)
            reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs[kind] = engine.generate(prompts, sampling)
            torch.cuda.synchronize()
            rate = n_tokens / (time.perf_counter() - t0)
            rates[kind].append(rate)
            counts = read_launch_counts()
            if kind == "spec" and launches is None:
                launches = {**counts, **{f"{n}_verify": v for n, v in in_verify.items()}}
            profiled = "not profiled"
            if run == 0:
                again = LLMEngine(params, cfg, ecfg)
                prof = profile_spec_run(lambda e=again: e.generate(prompts, sampling), again)
                del again
                busy = "not measured" if prof["busy"] is None else f"{prof['busy']:.1f} ms"
                idle = "not measured" if prof["idle"] is None else f"{prof['idle']:.3f}"
                k7 = ("not measured" if prof["k7_verify_ms"] is None else
                      f"{prof['k7_verify_ms']:.2f} ms of device time in {prof['k7_verify_kernels']} kernels")
                profiled = (f"profiled repeat: busy {busy} of {prof['wall']:.1f} ms wall, idle share {idle}, K7 "
                            f"inside verify steps {k7}")
            print(f"llama3-8b-int4-spec run {run + 1} of {SPEC_RUNS}, {kind}: {rate:.2f} generated tok/s "
                  f"({n_tokens} tokens, prompts {[len(p) for p in prompts]}); {steps[0]} model steps ({steps[1]} "
                  f"prefill, {steps[2]} decode, {steps[5]} verify); drafted {engine.spec_tokens_drafted}, accepted "
                  f"{engine.spec_tokens_accepted}; K7 launches {counts['varlen_attention']}, inside verify steps "
                  f"{in_verify.get('varlen_attention', 0)}; {profiled} on {card}", flush=True)
            del engine
            gc.collect()  # count_steps' wrappers hold the engine in a cycle
            torch.cuda.empty_cache()
        if any(len(o) != SPEC_MAX_TOKENS for o in outs["spec"] + outs["plain"]):
            raise AssertionError("llama3-8b-int4-spec: a request finished short of its tokens")
        if first is None:
            first = outs
            equal = check_diverged("llama3-8b-int4-spec", params, cfg, prompts, outs["spec"], outs["plain"], spread)
            print(f"llama3-8b-int4-spec: {equal} of {len(prompts)} requests give the plain engine's 128 greedy tokens "
                  f"throughout", flush=True)
        elif outs != first:
            raise AssertionError(f"llama3-8b-int4-spec: run {run + 1}'s tokens differ from run 1's")
    print(f"llama3-8b-int4-spec: generated tok/s in each of {SPEC_RUNS} runs: speculative "
          f"{[round(r, 2) for r in rates['spec']]}, plain {[round(r, 2) for r in rates['plain']]} on {card}", flush=True)
    if launches["varlen_attention_verify"] <= 0:
        raise AssertionError("llama3-8b-int4-spec: K7 never launched inside a verify step")
    return launches


def check_parallel_sampling(card: str, params: dict, cfg, spread: float) -> None:
    """Parallel sampling on Llama-3-8B int4 at full width: 4 prompts of 100
    to 515 tokens (partial tail pages), n 4, temperature 0.8, top_p 0.95,
    logprobs, repetition penalty 1.1 and a logit bias; prefix caching off.
    Right after each parent's spawn, each full prompt page has refcount 4
    and each sibling's tail page equals the parent's byte for byte in every
    layer, over a bf16 and an int8 KV pool. A replay from the same seed gives
    the same tokens and logprobs; every logprob is finite and at most 0. At
    greedy, n 4 gives four copies of the n 1 output. Aborting a parent
    mid-run returns every page of its group to the pool."""
    from conch_tpu_torch.serving import EngineConfig, LLMEngine, SamplingParams

    rng = np.random.default_rng(SEED + 4)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in (100, 237, 410, 515)]
    ecfg = EngineConfig(num_pages=1024, max_batch_size=16, max_pages_per_seq=64, enable_prefix_caching=False,
                        seed=SEED)
    sampling = SamplingParams(max_tokens=16, n=4, temperature=0.8, top_p=0.95, logprobs=True, repetition_penalty=1.1,
                              logit_bias=((13, 2.0), (42, -1.0)))
    runs = []
    for cache in (None, torch.int8, None):
        engine = LLMEngine(params, cfg, ecfg, cache_dtype=cache)
        ids = [engine.add_request(p, sampling) for p in prompts]
        checked, finished = set(), {}
        t0 = time.perf_counter()
        while engine.waiting or engine.running:
            for r in engine.step():
                finished[r.request_id] = r
            live = {r.request_id: r for r in engine.running}
            for rid in ids:
                if rid in checked or rid not in engine._group:
                    continue
                checked.add(rid)
                parent, sibs = live[rid], [live[s] for s in engine._group[rid]]
                full, partial = divmod(len(parent.prompt), ecfg.page_size)
                if partial == 0 or len(sibs) != 3:
                    raise AssertionError(f"parallel sampling: request {rid} spawned {len(sibs)} siblings")
                refs = [engine.allocator._refcount[p] for p in parent.pages[:full]]
                if refs != [4] * full:
                    raise AssertionError(f"parallel sampling: shared prompt pages' refcounts {refs}, not 4")
                tail = parent.pages[full]
                for sib in sibs:
                    for pool in (engine.k_caches, engine.v_caches):
                        if not torch.equal(pool[:, sib.pages[full]].view(torch.uint8), pool[:, tail].view(torch.uint8)):
                            raise AssertionError(f"parallel sampling: a sibling's tail page differs from the parent's "
                                                 f"({engine.k_caches.dtype} pool)")
        seconds = time.perf_counter() - t0
        groups = [[finished[i], *(finished[s] for s in engine._group[i])] for i in ids]
        lps = [lp for g in groups for r in g for lp in r.output_logprobs]
        if len(checked) != len(prompts) or len(lps) != 16 * 16 or not all(math.isfinite(x) and x <= 0 for x in lps):
            raise AssertionError("parallel sampling: a group unchecked, or a logprob missing, non-finite or above 0")
        if engine.allocator.num_free != ecfg.num_pages:
            raise AssertionError("parallel sampling: pages still held after the run")
        runs.append([[(r.output_tokens, r.output_logprobs) for r in g] for g in groups])
        distinct = sum(len({tuple(r.output_tokens) for r in g}) for g in groups)
        print(f"parallel sampling (llama3-8b int4, {str(engine.k_caches.dtype).removeprefix('torch.')} KV): 4 groups "
              f"of 4 spawned, shared prompt pages at refcount 4, every sibling's tail page equal to its parent's in "
              f"all 32 layers; {distinct} distinct completions of 16; logprobs in [{min(lps):.3f}, {max(lps):.3f}]; "
              f"{16 * 16 / seconds:.2f} generated tok/s on {card}", flush=True)
        del engine
        torch.cuda.empty_cache()
    if runs[2] != runs[0]:
        raise AssertionError("parallel sampling: a replay from the same seed gave other tokens or logprobs")
    greedy = LLMEngine(params, cfg, ecfg).generate(prompts, SamplingParams(max_tokens=16, n=4))
    single = LLMEngine(params, cfg, ecfg).generate(prompts, SamplingParams(max_tokens=16))
    if any(g != [g[0]] * 4 for g in greedy):
        raise AssertionError("parallel sampling: the members of a greedy n 4 group differ")
    copies = check_diverged("parallel sampling, greedy n 4 against n 1", params, cfg, prompts,
                            [g[0] for g in greedy], single, spread)
    engine = LLMEngine(params, cfg, ecfg)
    rid = engine.add_request(prompts[3], SamplingParams(max_tokens=64, n=4))
    for _ in range(4):
        engine.step()
    held = ecfg.num_pages - engine.allocator.num_free
    if len(engine.running) != 4 or not engine.abort_request(rid) or engine.running:
        raise AssertionError("parallel sampling: aborting the parent did not end its group")
    if engine.allocator.num_free != ecfg.num_pages:
        raise AssertionError("parallel sampling: the aborted group's pages were not all returned")
    print(f"parallel sampling: a replay from the same seed gave the same tokens and logprobs; greedy n 4 gave four "
          f"equal members a group, {copies} of 4 groups the n 1 output throughout (the others up to a near tie: the "
          f"n 1 run steps other row counts); aborting a parent after 4 steps returned its group's {held} pages",
          flush=True)
    del engine
    torch.cuda.empty_cache()


# check_lora: 4 adapters of rank 16 (alpha 32) over wq, wk, wv, wo, w_gate
# and w_down, drawn from seeds SEED + 10 to SEED + 13.
LORA_TARGETS = ("wq", "wk", "wv", "wo", "w_gate", "w_down")
LORA_ADAPTERS, LORA_RANK = 4, 16
LORA_SERVED_IDS = [0, 1, 2, 3, -1, 0, -1, 2]
LORA_RUNS = 3


def lora_adapters(cfg):
    from conch_tpu_torch.models.lora import init_lora_adapter

    return [init_lora_adapter(SEED + 10 + a, cfg, rank=LORA_RANK, alpha=2.0 * LORA_RANK, targets=LORA_TARGETS,
                              device="cuda") for a in range(LORA_ADAPTERS)]


def check_lora(card: str, int4_params: dict, int4_cfg, spread: float) -> dict:
    """Multi-LoRA. (1) 2 layers of Llama-3-8B at full width in bf16: one
    prefill of 5 prompts (21, 17, 25, 12 and 30 tokens) with per-token ids
    0, 1, 2, 3 and -1 (padding rows -1) against each adapter merged into the
    weights (``merge_lora_into_params``) on the card, and against the same
    multi-LoRA prefill on the CPU, at PREFILL_TOLERANCES; the fused gate|up
    is split for w_gate's adapter (K6's parts form). (2) Served: Llama-3-8B
    int4 (32 layers) with the 4 adapters at every layer, 8 requests of 40 to
    900 tokens with ids LORA_SERVED_IDS, LORA_RUNS timed runs beside the
    same engine without ``lora``; the requests with id -1 must give the base
    engine's greedy tokens, up to a near tie. Returns the first LoRA run's
    launches."""
    from conch_tpu_torch.kernels.activation.silu_and_mul import silu_and_mul_parts_launcher
    from conch_tpu_torch.models.llama import LlamaConfig, fuse_llama_params, init_llama_params, llama_prefill
    from conch_tpu_torch.models.lora import merge_lora_into_params, stack_lora_adapters
    from conch_tpu_torch.serving import EngineConfig, LLMEngine, SamplingParams

    cfg = dataclasses.replace(LlamaConfig.llama3_8b(), num_layers=2, dtype=torch.bfloat16)
    params = init_llama_params(SEED, cfg, device="cuda")
    adapters = lora_adapters(cfg)
    stacked = stack_lora_adapters(adapters)
    rng = np.random.default_rng(SEED + 5)
    lens, ids_by_seq = [21, 17, 25, 12, 30], [0, 1, 2, 3, -1]
    total, rows, batch = sum(lens), 128, 8
    tokens = np.zeros(rows, np.int32)
    tokens[:total] = rng.integers(0, cfg.vocab_size, total)
    positions = np.zeros(rows, np.int32)
    positions[:total] = np.concatenate([np.arange(n) for n in lens])
    bt = np.zeros((batch, 4), np.int32)
    slots = np.full(rows, -1, np.int32)
    page = 0
    for b, n in enumerate(lens):
        bt[b, : -(-n // PS)] = np.arange(page, page + -(-n // PS))
        page += -(-n // PS)
    slots[:total] = [int(bt[b, p // PS]) * PS + p % PS for b, n in enumerate(lens) for p in range(n)]
    cu = np.full(batch + 1, total, np.int32)
    cu[: len(lens) + 1] = np.concatenate([[0], np.cumsum(lens)])
    seq_lens = np.zeros(batch, np.int32)
    seq_lens[: len(lens)] = lens
    ids = np.full(rows, -1, np.int32)
    ids[:total] = np.repeat(ids_by_seq, lens)
    host = [torch.from_numpy(a) for a in (tokens, positions, cu, seq_lens, bt, slots, ids)]

    def prefill(p, device, **lora):
        from conch_tpu_torch.models.llama import init_kv_caches

        kc, vc = init_kv_caches(cfg, page, PS, device=device)
        t = [a.to(device) for a in host]
        logits, _, _ = llama_prefill(p, cfg, t[0], t[1], t[2], 32, t[3], t[4], t[5], kc, vc, **lora)
        return logits.float().cpu()

    reset_launch_counts()
    multi = prefill(fuse_llama_params(params), "cuda", lora=stacked, lora_ids=host[6].cuda())
    parts = silu_and_mul_parts_launcher.launches
    tol = PREFILL_TOLERANCES[torch.bfloat16]
    for b, aid in enumerate(ids_by_seq):
        merged = params if aid < 0 else merge_lora_into_params(params, adapters[aid])
        ref = prefill(fuse_llama_params(merged), "cuda")
        ok, err, scale, rule = logits_agree(multi[b], ref[b], torch.bfloat16, tol)
        print(f"2-layer multi-LoRA prefill (Llama-3-8B, bf16), sequence {b} (adapter {aid}) against "
              f"{'the base weights' if aid < 0 else 'its adapter merged into the weights'} on the card: max_abs_err "
              f"{err:.3e}, max|ref| {scale:.3f}, tolerance {rule}", flush=True)
        if not ok:
            raise AssertionError(f"multi-LoRA prefill: sequence {b} (adapter {aid}) disagrees with its merged model")
    cpu = prefill(to_device(fuse_llama_params(params), "cpu"), "cpu", lora=to_device(stacked, "cpu"),
                  lora_ids=host[6])
    ok, err, scale, rule = logits_agree(multi, cpu, torch.bfloat16, tol)
    print(f"2-layer multi-LoRA prefill (Llama-3-8B, bf16), card vs plain path on the CPU: max_abs_err {err:.3e}, "
          f"max|ref| {scale:.3f}, tolerance {rule}; K6's parts form launched {parts} times (w_gate's adapter splits "
          f"the fused gate|up)", flush=True)
    if not ok or parts != cfg.num_layers:
        raise AssertionError("multi-LoRA prefill disagrees with the plain path, or K6's parts form did not run")
    del params, adapters, stacked
    torch.cuda.empty_cache()

    stacked = stack_lora_adapters(lora_adapters(int4_cfg))
    prompts = quant_prompts(np.random.default_rng(SEED), int4_cfg.vocab_size)
    sampling = SamplingParams(max_tokens=32)
    ecfg = EngineConfig(num_pages=2048, max_batch_size=8, max_pages_per_seq=64)
    n_tokens = len(prompts) * 32
    rates, outs, launches = {"lora": [], "base": []}, {}, None
    for run in range(LORA_RUNS):
        for kind in ("base", "lora"):
            engine = LLMEngine(int4_params, int4_cfg, ecfg, lora=stacked if kind == "lora" else None)
            reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = engine.generate(prompts, sampling, lora_ids=[None if i < 0 else i for i in LORA_SERVED_IDS]
                                  if kind == "lora" else None)
            torch.cuda.synchronize()
            rates[kind].append(n_tokens / (time.perf_counter() - t0))
            if run == 0:
                outs[kind] = out
                if kind == "lora":
                    launches = read_launch_counts()
                    parts = silu_and_mul_parts_launcher.launches
            elif out != outs[kind]:
                raise AssertionError(f"served multi-LoRA: run {run + 1}'s {kind} tokens differ from run 1's")
            del engine
            torch.cuda.empty_cache()
    base_rows = [i for i, a in enumerate(LORA_SERVED_IDS) if a < 0]
    equal = check_diverged("served multi-LoRA, id -1 rows", int4_params, int4_cfg, [prompts[i] for i in base_rows],
                           [outs["lora"][i] for i in base_rows], [outs["base"][i] for i in base_rows], spread)
    changed = sum(outs["lora"][i] != outs["base"][i] for i, a in enumerate(LORA_SERVED_IDS) if a >= 0)
    print(f"llama3-8b-int4-lora: 8 requests (prompts {[len(p) for p in prompts]}, 32 tokens each, adapter ids "
          f"{LORA_SERVED_IDS}): generated tok/s in each of {LORA_RUNS} runs {[round(r, 2) for r in rates['lora']]}, "
          f"without lora {[round(r, 2) for r in rates['base']]} on {card}; {equal} of {len(base_rows)} id -1 requests "
          f"give the base engine's tokens, {changed} of {8 - len(base_rows)} adapter requests differ from them; "
          f"K6 launches {launches['silu_and_mul']}, of them its parts form {parts}", flush=True)
    if changed == 0:
        raise AssertionError("served multi-LoRA: no adapter changed a request's tokens")
    return launches


# The guided path (``check_guided``): a synthetic Llama-3 vocabulary from the
# seed (no tokenizer is downloaded): ids 32 to 126 decode to their ASCII
# character, EOS to "", every other id to a string of 1 to 8 characters over
# letters, digits, JSON punctuation and the space. A 4-field JSON schema and
# a regex; 8 requests in one batch: 3 in JSON mode at temperature 0.8, 2 by
# the regex at greedy, 3 unguided at greedy.
GUIDED_EOS = 128001  # Llama-3's <|end_of_text|>
GUIDED_ALPHABET = "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789{}[]:,\" "
GUIDED_SCHEMA = {"type": "object", "properties": {
    "id": {"type": "integer"}, "ok": {"type": "boolean"}, "color": {"enum": ["red", "green", "blue"]},
    "size": {"enum": ["S", "M", "L"]}}}
GUIDED_REGEX = r"[A-Z][a-z]{2,8} [0-9]{4}-[0-9]{2}-[0-9]{2}"
GUIDED_KINDS = ("json", "regex", "plain", "json", "regex", "plain", "json", "plain")
GUIDED_MAX_TOKENS = {"json": 192, "regex": 32, "plain": 32}


def guided_vocab(seed: int, size: int) -> list[str]:
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, 9, size)
    picks = rng.integers(0, len(GUIDED_ALPHABET), int(lens.sum()))
    ends = np.cumsum(lens)
    vocab = ["".join(GUIDED_ALPHABET[c] for c in picks[e - n : e]) for n, e in zip(lens, ends)]
    vocab[32:127] = [chr(i) for i in range(32, 127)]
    vocab[GUIDED_EOS] = ""
    return vocab


def check_guided(card: str, params: dict, cfg, spread: float) -> dict:
    """``llama3_8b_int4_guided``: the FSMs built on this machine's CPU (their
    seconds printed), then GUIDED_KINDS served in one batch on a fresh
    engine. Every guided output must end with EOS and fully match its
    pattern, the JSON ones parse to the schema's keys and types; the
    unguided rows must equal the same prompts served alone, up to a first
    divergence at a near tie (``check_diverged``). Prints the host ms a
    step that the masks add (``_apply_guided_masks``, timed on the host).
    Returns the run's launches."""
    from conch_tpu_torch.serving import EngineConfig, LLMEngine, SamplingParams
    from conch_tpu_torch.serving.guided import TokenFSM, fsm_for_json_schema, json_schema_to_regex

    t0 = time.perf_counter()
    vocab = guided_vocab(SEED, cfg.vocab_size)
    t1 = time.perf_counter()
    json_fsm = fsm_for_json_schema(GUIDED_SCHEMA, vocab)
    t2 = time.perf_counter()
    regex_fsm = TokenFSM.from_regex(GUIDED_REGEX, vocab)
    t3 = time.perf_counter()
    print(f"guided FSMs over a {cfg.vocab_size}-string vocabulary (built in {t1 - t0:.2f} s): the 4-field JSON schema "
          f"{json_fsm.num_states} states, {json_fsm.transitions.nbytes / 1e6:.1f} MB of transitions, "
          f"{t2 - t1:.2f} s; the regex {regex_fsm.num_states} states, {t3 - t2:.2f} s (host CPU)", flush=True)
    fsms = {"json": json_fsm, "regex": regex_fsm, "plain": None}
    prompts = quant_prompts(np.random.default_rng(SEED + 20), cfg.vocab_size)
    samplings = [SamplingParams(max_tokens=GUIDED_MAX_TOKENS[k], temperature=0.8 if k == "json" else 0.0,
                                guided=fsms[k]) for k in GUIDED_KINDS]
    ecfg = EngineConfig(num_pages=2048, max_batch_size=8, max_pages_per_seq=64, eos_token_id=GUIDED_EOS, seed=SEED)
    engine = LLMEngine(params, cfg, ecfg)
    masks = engine._apply_guided_masks
    mask_s: list[float] = []

    def timed_masks(logits, reqs, rows):
        t = time.perf_counter()
        out = masks(logits, reqs, rows)
        if any(r.sampling.guided is not None for r in reqs):
            mask_s.append(time.perf_counter() - t)
        return out

    engine._apply_guided_masks = timed_masks
    steps, _ = count_steps(engine)
    ids = [engine.add_request(p, s) for p, s in zip(prompts, samplings)]
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = {}
    while engine.waiting or engine.running:
        for r in engine.step():
            done[r.request_id] = r.output_tokens
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launch_counts()
    outs = [done[i] for i in ids]
    texts = []
    for kind, out in zip(GUIDED_KINDS, outs):
        if kind == "plain":
            continue
        if out[-1] != GUIDED_EOS:
            raise AssertionError(f"guided ({kind}): the output did not end with EOS: {out}")
        text = "".join(vocab[t] for t in out[:-1])
        texts.append(text)
        if not re.fullmatch(json_schema_to_regex(GUIDED_SCHEMA) if kind == "json" else GUIDED_REGEX, text):
            raise AssertionError(f"guided ({kind}): {text!r} does not fully match its pattern")
        if kind == "json":
            obj = json.loads(text)
            props = GUIDED_SCHEMA["properties"]
            if (list(obj) != list(props) or type(obj["id"]) is not int or type(obj["ok"]) is not bool
                    or obj["color"] not in props["color"]["enum"] or obj["size"] not in props["size"]["enum"]):
                raise AssertionError(f"guided (json): {text!r} does not conform to the schema")
    plain = [i for i, k in enumerate(GUIDED_KINDS) if k == "plain"]
    alone = LLMEngine(params, cfg, ecfg).generate([prompts[i] for i in plain], SamplingParams(max_tokens=32))
    equal = check_diverged("guided batch, unguided rows against the same prompts served alone", params, cfg,
                           [prompts[i] for i in plain], [outs[i] for i in plain], alone, spread)
    n_tokens = sum(len(o) for o in outs)
    print(f"llama3-8b-int4-guided: 8 requests (prompts {[len(p) for p in prompts]}; kinds {list(GUIDED_KINDS)}) in "
          f"{seconds:.3f} s, {n_tokens} tokens, {n_tokens / seconds:.2f} generated tok/s, {steps[0]} model steps "
          f"({steps[1]} prefill, {steps[2]} decode) on {card}; guided outputs {texts}; {equal} of {len(plain)} "
          f"unguided rows equal to the same prompts served alone throughout; the masks add "
          f"{1e3 * sum(mask_s) / len(mask_s):.3f} host ms a step ({len(mask_s)} steps with guided rows, "
          f"max {1e3 * max(mask_s):.3f} ms)", flush=True)
    del engine
    gc.collect()  # count_steps' wrappers hold the engine in a cycle
    torch.cuda.empty_cache()
    return launches


# The beam path (``check_beam``): prompts on each side of a page boundary,
# 4 beams, 32 new tokens, length penalties 1.0 and 0.0, prefix caching off.
BEAM_PROMPT_LENS = (1000, 1023, 1024, 1025)
BEAM_WIDTH, BEAM_TOKENS, BEAM_PENALTIES = 4, 32, (1.0, 0.0)
BEAM_ENGINE = {"num_pages": 1024, "max_batch_size": 8, "max_pages_per_seq": 80, "enable_prefix_caching": False}
# K3's beam row (``kernel_phase_k3_beam``): the 4 beams of a 1024-token
# prompt (64 full pages shared), 16 tokens generated each.
BEAM_K3_PROMPT, BEAM_K3_GEN = 1024, 16


def teacher_forced_logprob(params: dict, cfg, prompt: list[int], tokens: list[int], caches) -> float:
    """The sum of ``tokens``' log-probabilities (f32 log-softmax, summed in
    f64) after ``prompt``: one verify forward (every row's logits) of
    prompt + tokens[:-1] over ``caches`` on the card."""
    from conch_tpu_torch.models.llama import llama_verify_forward

    seq = prompt + tokens[:-1]
    t = len(seq)
    pages = -(-t // PS)
    kc, vc = caches
    dev = {"dtype": torch.int32, "device": "cuda"}
    logits, _, _ = llama_verify_forward(
        params, cfg, torch.tensor(seq, **dev), torch.arange(t, **dev), torch.tensor([0, t], **dev), t,
        torch.tensor([t], **dev), torch.arange(pages, **dev)[None], torch.arange(t, **dev), kc, vc,
    )
    rows = torch.log_softmax(logits[len(prompt) - 1 : t].float(), dim=-1)
    picked = rows.gather(-1, torch.tensor(tokens, device="cuda", dtype=torch.int64)[:, None])[:, 0]
    return picked.double().sum().item()


def check_beam(card: str, params: dict, cfg, spread: float) -> dict:
    """``llama3_8b_int4_beam``: ``beam_search`` on each BEAM_PROMPT_LENS prompt
    at each penalty, with the Python allocator, then again with the native
    one (``CONCH_ENABLE_CPP_EXT=1``), which must give identical hypotheses.
    After each search every page is back in the pool. Each hypothesis's
    cumulative logprob (score x len ** penalty) must equal one teacher-forced
    verify forward's within 2 x spread a token (``check_spec_echo``'s
    measured difference of two 32-layer bf16 paths bounds a logit's and the
    log-sum-exp's). K3 must launch inside the beam steps; prints beam
    tokens/s (BEAM_WIDTH x BEAM_TOKENS a search over its seconds). Returns
    the Python-allocator run's launches, with K3's inside the beam decode
    steps as ``paged_attention_beam``."""
    import os

    from conch_tpu_torch import native
    from conch_tpu_torch.models.llama import init_kv_caches
    from conch_tpu_torch.serving import EngineConfig, LLMEngine, beam_search

    rng = np.random.default_rng(SEED + 30)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in BEAM_PROMPT_LENS]
    ecfg = EngineConfig(**BEAM_ENGINE)
    runs, launches, in_beam = {}, None, {}
    saved = os.environ.get("CONCH_ENABLE_CPP_EXT")
    try:
        for allocator in ("python", "native"):
            os.environ["CONCH_ENABLE_CPP_EXT"] = "1" if allocator == "native" else "0"
            engine = LLMEngine(params, cfg, ecfg)
            if isinstance(engine.allocator, native.NativeBlockAllocator) != (allocator == "native"):
                raise AssertionError(f"beam ({allocator}): the engine took {type(engine.allocator).__name__}")
            decode = engine._decode_fn

            def counted(*args, _decode=decode, **kwargs):
                before = read_launch_counts()
                out = _decode(*args, **kwargs)
                for name, n in read_launch_counts().items():
                    in_beam[name] = in_beam.get(name, 0) + n - before[name]
                return out

            if allocator == "python":
                engine._decode_fn = counted
            reset_launch_counts()
            rates, hyps = [], {}
            for penalty in BEAM_PENALTIES:
                for p in prompts:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    got = beam_search(engine, p, BEAM_WIDTH, BEAM_TOKENS, length_penalty=penalty)
                    torch.cuda.synchronize()
                    rates.append(BEAM_WIDTH * BEAM_TOKENS / (time.perf_counter() - t0))
                    if engine.allocator.num_free != ecfg.num_pages:
                        raise AssertionError(f"beam ({allocator}): {ecfg.num_pages - engine.allocator.num_free} pages "
                                             f"not returned after the {len(p)}-token prompt")
                    if len(got) != BEAM_WIDTH or any(len(h.tokens) != BEAM_TOKENS for h in got):
                        raise AssertionError(f"beam ({allocator}): hypotheses of other lengths than {BEAM_TOKENS}")
                    hyps[(penalty, len(p))] = [(h.tokens, h.score) for h in got]
            if allocator == "python":
                launches = read_launch_counts()
            runs[allocator] = hyps
            print(f"llama3-8b-int4-beam ({allocator} allocator): {len(rates)} searches (prompts "
                  f"{list(BEAM_PROMPT_LENS)}, penalties {list(BEAM_PENALTIES)}, width {BEAM_WIDTH}, {BEAM_TOKENS} "
                  f"tokens): beam tok/s {[round(r, 2) for r in rates]} on {card}; every page returned after each",
                  flush=True)
            del engine
            torch.cuda.empty_cache()
    finally:
        if saved is None:
            os.environ.pop("CONCH_ENABLE_CPP_EXT", None)
        else:
            os.environ["CONCH_ENABLE_CPP_EXT"] = saved
    if runs["native"] != runs["python"]:
        raise AssertionError("beam: the native allocator's hypotheses differ from the Python allocator's")
    longest = max(BEAM_PROMPT_LENS) + BEAM_TOKENS
    caches = init_kv_caches(cfg, -(-longest // PS), PS, device="cuda")
    worst = 0.0
    for (penalty, n), hyps in runs["python"].items():
        prompt = prompts[BEAM_PROMPT_LENS.index(n)]
        for tokens, score in hyps:
            cum = score * len(tokens) ** penalty
            diff = abs(cum - teacher_forced_logprob(params, cfg, prompt, tokens, caches))
            worst = max(worst, diff / len(tokens))
            if diff > 2 * spread * len(tokens):
                raise AssertionError(f"beam: a hypothesis's cumulative logprob {cum:.4f} is {diff:.4f} off a "
                                     f"teacher-forced prefill's (limit {2 * spread * len(tokens):.4f})")
    del caches
    torch.cuda.empty_cache()
    if in_beam.get("paged_attention", 0) <= 0:
        raise AssertionError("beam: K3 never launched inside a beam step")
    print(f"llama3-8b-int4-beam: the native allocator gave identical hypotheses (tokens and scores); each of "
          f"{sum(len(h) for h in runs['python'].values())} hypotheses' cumulative logprob within {worst:.4f} a token "
          f"of a teacher-forced prefill's (limit 2 x spread = {2 * spread:.4f}); K3 launches inside the beam steps "
          f"{in_beam['paged_attention']}; launches {launches}", flush=True)
    return {**launches, **{f"{name}_beam": n for name, n in in_beam.items() if n}}


# The HTTP path (``check_server``): the README's 16 int4 prompts (40 to 900
# tokens, two sharing a 128-token prefix), 32 new tokens, greedy; 2
# streamed; one n 4 at temperature 0.8; one through a LoRA adapter's name.
SERVER_ENGINE = {"num_pages": 4096, "max_batch_size": 32}
SERVER_TOKENS = 32


def _http(base: str, body: dict) -> tuple[int, dict | list, float]:
    """POST ``body`` to /v1/completions: (status, the JSON body or, streamed,
    the SSE chunks, seconds)."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(base + "/v1/completions", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=300) as resp:
            if body.get("stream"):
                chunks = [json.loads(line[6:]) for line in (raw.decode().strip() for raw in resp)
                          if line.startswith("data: ") and line != "data: [DONE]"]
                return resp.status, chunks, time.perf_counter() - t0
            return resp.status, json.loads(resp.read()), time.perf_counter() - t0
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), time.perf_counter() - t0


def check_server(card: str, params: dict, cfg, spread: float) -> dict:
    """``llama3_8b_int4_server``: ``make_server`` over an ``EngineWorker`` on
    127.0.0.1 port 0 (an engine with the 4 LoRA adapters of ``check_lora``),
    20 requests at once from client threads (SERVER_* above). The greedy
    outputs must equal a direct ``engine.generate`` of the same prompts on a
    fresh engine (the LoRA request: with its adapter's id), the streamed
    ones the same prompts' non-streamed outputs, up to a first divergence at
    a near tie (``check_diverged``); the n 4 request gives 4 choices of 32
    tokens. At the end the worker is alive, no request holds a page and
    every page is free or held by the prefix cache. Prints requests/s, p50
    and p99 latency and tok/s over HTTP beside direct ``generate``. Returns
    the HTTP run's launches."""
    import threading

    from conch_tpu_torch.models.lora import stack_lora_adapters
    from conch_tpu_torch.serving import EngineConfig, EngineWorker, LLMEngine, SamplingParams, ServerConfig
    from conch_tpu_torch.serving import make_server

    adapters = stack_lora_adapters(lora_adapters(cfg))
    ecfg = EngineConfig(**SERVER_ENGINE)
    prompts = int4_prompts(np.random.default_rng(SEED), cfg.vocab_size)
    lora_prompt, lora_id = prompts[3], 1
    engine = LLMEngine(params, cfg, ecfg, lora=adapters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    direct = engine.generate(prompts + [lora_prompt], SamplingParams(max_tokens=SERVER_TOKENS),
                             lora_ids=[None] * len(prompts) + [lora_id])
    torch.cuda.synchronize()
    direct_rate = len(direct) * SERVER_TOKENS / (time.perf_counter() - t0)
    del engine
    torch.cuda.empty_cache()

    worker = EngineWorker(LLMEngine(params, cfg, ecfg, lora=adapters))
    names = {f"adapter{i}": i for i in range(LORA_ADAPTERS)}
    httpd = make_server(worker, ServerConfig(model_name="llama3-8b-int4", adapters=names), "127.0.0.1", 0)
    server_thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    server_thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    bodies = [{"prompt": p, "max_tokens": SERVER_TOKENS} for p in prompts]
    bodies += [{"prompt": p, "max_tokens": SERVER_TOKENS, "stream": True} for p in prompts[:2]]
    bodies.append({"prompt": prompts[2], "max_tokens": SERVER_TOKENS, "n": 4, "temperature": 0.8})
    bodies.append({"prompt": lora_prompt, "max_tokens": SERVER_TOKENS, "model": f"adapter{lora_id}"})
    results: list = [None] * len(bodies)

    def hit(i):
        results[i] = _http(base, bodies[i])

    try:
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        threads = [threading.Thread(target=hit, args=(i,)) for i in range(len(bodies))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launch_counts()
        if not worker.alive or worker.fault is not None:
            raise AssertionError(f"server: the engine worker died: {worker.fault!r}")
        if any(r is None or r[0] != 200 for r in results):
            raise AssertionError(f"server: a request failed: {[r if r is None else r[:2] for r in results]}")
        held = worker.engine.running + worker.engine.waiting
        free = worker.engine.allocator.num_free + len(worker.engine._cached_lru)
        if held or free != ecfg.num_pages:
            raise AssertionError(f"server: {len(held)} requests still held, {ecfg.num_pages - free} pages not free")
    finally:
        httpd.shutdown()
        httpd.server_close()
        worker.shutdown()
    greedy = [r[1]["choices"][0]["token_ids"] for r in results[: len(prompts)]]
    finish = {c["finish_reason"] for r in results[: len(prompts)] for c in r[1]["choices"]}
    equal = check_diverged("server, greedy over HTTP against direct generate", params, cfg, prompts, greedy,
                           direct[: len(prompts)], spread)
    streamed = [[t for c in r[1] for t in c["choices"][0]["token_ids"]] for r in results[len(prompts) : len(prompts) + 2]]
    check_diverged("server, streamed against non-streamed", params, cfg, prompts[:2], streamed, greedy[:2], spread)
    group = results[len(prompts) + 2][1]["choices"]
    if len(group) != 4 or any(len(c["token_ids"]) != SERVER_TOKENS for c in group):
        raise AssertionError("server: the n 4 request did not give 4 choices of 32 tokens")
    lora_out = results[-1][1]["choices"][0]["token_ids"]
    check_diverged("server, the LoRA adapter's name against direct generate with its id", params, cfg, [lora_prompt],
                   [lora_out], [direct[-1]], spread, lora=(adapters, lora_id))
    if lora_out == greedy[3]:
        raise AssertionError("server: the adapter's name gave the base model's tokens")
    latencies = sorted(r[2] for r in results)
    tokens = sum(r[1]["usage"]["completion_tokens"] for r in results if isinstance(r[1], dict))
    tokens += sum(len(s) for s in streamed)
    print(f"llama3-8b-int4-server: {len(bodies)} requests over HTTP at once (16 greedy, 2 streamed, n 4 at "
          f"temperature 0.8, one LoRA by name) in {wall:.3f} s: {len(bodies) / wall:.2f} requests/s, latency p50 "
          f"{np.percentile(latencies, 50):.3f} s, p99 {np.percentile(latencies, 99):.3f} s, {tokens / wall:.2f} "
          f"generated tok/s over HTTP against {direct_rate:.2f} by direct generate (17 requests) on {card}; {equal} of "
          f"16 greedy outputs equal to direct generate throughout; finish reasons {sorted(finish)}; the worker alive, "
          f"every page free or cached", flush=True)
    return launches


def kernel_phase_k3_beam(gen, rng) -> dict:
    """K3 at a beam step: BEAM_WIDTH live rows of one BEAM_K3_PROMPT-token
    prompt, BEAM_K3_GEN tokens generated each, in an 8-row step (the others
    idle) over a 32-layer bf16 pool; the prompt's full pages shared by the 4
    rows, each row's own tail pages. Held at 3e-2 against the plain version.
    ``bound_ms`` counts the unique K and V rows once (``unique_kv_rows``);
    ``bound_ms_per_row`` counts the rows each beam reads."""
    from conch_tpu_torch.kernels.attention.paged_attention import paged_attention_launcher, paged_attention_plain

    full, tails = BEAM_K3_PROMPT // PS, -(-(BEAM_K3_PROMPT % PS + BEAM_K3_GEN) // PS)
    num_pages = full + BEAM_WIDTH * tails + 1
    kc, vc = make_pool(gen, num_pages)
    perm = rng.permutation(np.arange(1, num_pages))
    bt = np.zeros((8, BEAM_ENGINE["max_pages_per_seq"]), np.int32)
    seq_lens = [BEAM_K3_PROMPT + BEAM_K3_GEN] * BEAM_WIDTH + [0] * (8 - BEAM_WIDTH)
    for b in range(BEAM_WIDTH):
        bt[b, :full] = perm[:full]
        bt[b, full : full + tails] = perm[full + b * tails : full + (b + 1) * tails]
    q = torch.randn((8, QH, D), generator=gen, device="cuda").to(torch.bfloat16)
    sl = torch.tensor(seq_lens, dtype=torch.int32, device="cuda")
    args = (q, kc, vc, torch.from_numpy(bt).cuda(), sl, D**-0.5, LAYER, 0.0, 0)
    got, ref = paged_attention_launcher(*args), paged_attention_plain(*args)
    torch.cuda.synchronize()
    if not torch.isfinite(got).all() or got[BEAM_WIDTH:].abs().max().item() != 0.0:
        raise AssertionError("K3 beam: the idle rows must come out as finite zeros")
    err = (got.float() - ref.float()).abs().max().item()
    check("K3 paged_attention at a beam step (4 beams sharing 64 pages)", err, 3e-2)
    case = {"shape": (QH, KH, D), "seq_lens": seq_lens, "args": args, "bt": bt}
    b_ms, b_by = k3_bound(case, 0)
    pages = sum(-(-n // PS) for n in seq_lens)
    per_row_bytes = (2 * q.numel() * q.element_size() + 2 * sum(seq_lens) * KH * D * kc.element_size() + pages * 4
                     + len(seq_lens) * 4)
    per_row_ms, _ = bound(per_row_bytes, 4 * QH * D * sum(seq_lens))
    row = _kernel_row("paged_attention_beam", "conch_tpu_torch/csrc/paged_attention.cu",
                      "conch_tpu/kernels/attention/paged_attention.py:57", err,
                      {"ms": time_ms(lambda: paged_attention_launcher(*args)),
                       "paced_ms": paced_ms(lambda: paged_attention_launcher(*args)),
                       "plain_ms": time_ms(lambda: paged_attention_plain(*args), iters=5), "library_ms": None},
                      b_ms, b_by)
    row["bound_ms_per_row"] = per_row_ms
    print(f"paged_attention_beam: {row['ms']:.4f} ms (paced {row['paced_ms']:.4f}, plain {row['plain_ms']:.4f}, bound "
          f"{b_ms:.5f} by {b_by} over the unique rows, {per_row_ms:.5f} over the rows each beam reads)", flush=True)
    del kc, vc
    torch.cuda.empty_cache()
    return row


def slice_paths(card: str, lap) -> dict:
    """The speculative, parallel-sampling, multi-LoRA, guided, beam and HTTP
    paths: the verify logits check, then Llama-3-8B int4 (32 layers, one set
    of fused params) through the spec echo, the served spec runs, parallel
    sampling, multi-LoRA, guided decoding, beam search and the HTTP server,
    then DeepSeek-V2-Lite served with speculation; ``lap(phase)`` after
    each. Returns the served runs' launches by path."""
    import conch_tpu_torch.models.deepseek as ds
    from conch_tpu_torch.models.llama import LlamaConfig, fuse_llama_params, init_llama_params

    gc.collect()  # the served runs' models before (serve() collects at its start; these phases must too)
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    if held > 2**30:
        raise AssertionError(f"{held / 2**30:.1f} GiB still allocated before the slice's paths: a model was not freed")
    check_verify_logits()
    lap("check_verify_logits")
    cfg = LlamaConfig.llama3_8b()
    params = fuse_llama_params(init_llama_params(SEED, cfg, quant_mode="int4", device="cuda"))
    spread = check_spec_echo(card, params, cfg, spec_prompts(np.random.default_rng(SEED), cfg.vocab_size))
    lap("check_spec_echo")
    launches = {"llama3_8b_int4_spec": serve_spec(card, params, cfg, spread)}
    lap("llama3_8b_int4_spec")
    check_parallel_sampling(card, params, cfg, spread)
    lap("check_parallel_sampling")
    launches["llama3_8b_int4_lora"] = check_lora(card, params, cfg, spread)
    lap("check_lora")
    launches["llama3_8b_int4_guided"] = check_guided(card, params, cfg, spread)
    lap("llama3_8b_int4_guided")
    launches["llama3_8b_int4_beam"] = check_beam(card, params, cfg, spread)
    lap("llama3_8b_int4_beam")
    launches["llama3_8b_int4_server"] = check_server(card, params, cfg, spread)
    lap("llama3_8b_int4_server")
    del params
    torch.cuda.empty_cache()
    launches["deepseek_v2_lite_spec"] = serve(
        card, "deepseek-v2-lite-spec", ds.DeepseekV2Config.v2_lite(),
        lambda c: ds.init_deepseek_params(SEED, c, device="cuda"),
        {"prefill_fn": ds.deepseek_prefill, "decode_fn": ds.deepseek_decode_step,
         "verify_fn": ds.deepseek_verify_forward},
        {"num_pages": 1024, "max_batch_size": 8, "max_pages_per_seq": 80, "num_speculative_tokens": SPEC_TOKENS},
        spec_prompts, DEEPSEEK_KERNELS, DEEPSEEK_PER_STEP, profile=False,
    )
    if launches["deepseek_v2_lite_spec"]["mla_attention_verify"] <= 0:
        raise AssertionError("deepseek-v2-lite-spec: K11 never launched inside a verify step")
    lap("deepseek_v2_lite_spec")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    card = card_line()
    print(card, flush=True)
    t_start = time.perf_counter()

    def lap(phase: str) -> None:
        print(f"chip_smoke: {phase} done at {time.perf_counter() - t_start:.1f} s", flush=True)

    build()
    rows = kernel_phases()
    lap("build and kernel phases")
    check_voxelization(np.random.default_rng(SEED))
    vision_launches = vision_path(card)
    qlora_launches = qlora_path(card)
    stream_launches = residual_stream_path(card)
    tp8_launches, tp8_timings = tp8_collectives_path(card)
    next(r for r in rows if r["name"] == "ring_all_gather")["collective_matmuls"] = tp8_timings
    check_top_p_filter(card)
    lap("paths no engine serves")
    check_prefill_logits()
    lap("Llama and Gemma prefill checks")
    check_deepseek_logits()
    lap("DeepSeek prefill checks")
    check_mixtral_logits()
    check_hf_converters()
    lap("Mixtral prefill checks and HF converters")

    from conch_tpu_torch.models.deepseek import (
        DeepseekV2Config, deepseek_decode_step, deepseek_prefill, init_deepseek_params,
    )
    from conch_tpu_torch.models.gemma import GemmaConfig, gemma_decode_step, gemma_prefill, init_gemma_params
    from conch_tpu_torch.models.llama import LlamaConfig, init_llama_params

    def llama(quant_mode, group_size=128):
        return lambda cfg: init_llama_params(SEED, cfg, quant_mode=quant_mode, group_size=group_size, device="cuda")

    llama_cfg = LlamaConfig.llama3_8b()
    deepseek_fns = {"prefill_fn": deepseek_prefill, "decode_fn": deepseek_decode_step}
    deepseek_engine = {"num_pages": 4096, "max_batch_size": 16, "max_pages_per_seq": 128}
    launches = {
        "llama3_8b_bf16": serve(
            card, "bf16", llama_cfg, llama("bf16"), {},
            {"page_size": 16, "num_pages": 2048, "max_batch_size": 8, "max_prefill_tokens": 128}, bf16_prompts,
            LLAMA_COMMON, {k: v for k, v in LLAMA_PER_STEP.items() if k != "mixed_gemm_magic"},
        ),
        # The README's int4 example.
        "llama3_8b_int4": serve(
            card, "int4", llama_cfg, llama("int4"), {}, {"num_pages": 4096, "max_batch_size": 32}, int4_prompts,
            LLAMA_KERNELS, LLAMA_PER_STEP,
        ),
        # The README's int4 engine with the projections at group 64 (K1's
        # group-64 template), 8 requests.
        "llama3_8b_int4_g64": serve(
            card, "int4-g64", llama_cfg, llama("int4", 64), {}, {"num_pages": 4096, "max_batch_size": 32},
            quant_prompts, LLAMA_KERNELS, LLAMA_PER_STEP,
        ),
        # The other weight formats of the same model (lm_head quantized too).
        "llama3_8b_int8": serve(
            card, "int8", llama_cfg, llama("int8"), {}, {"num_pages": 4096, "max_batch_size": 32}, quant_prompts,
            (*LLAMA_COMMON, "mixed_gemm_planar"), INT8_PER_STEP,
        ),
        "llama3_8b_nf4": serve(
            card, "nf4", llama_cfg, llama("nf4"), {}, {"num_pages": 4096, "max_batch_size": 32}, quant_prompts,
            (*LLAMA_COMMON, "mixed_gemm_rows"), NF4_PER_STEP, {"quantize4": NF4_INIT_LAUNCHES},
        ),
        "llama3_8b_w8a8": serve(
            card, "w8a8", llama_cfg, llama("w8a8"), {}, {"num_pages": 4096, "max_batch_size": 32}, quant_prompts,
            (*LLAMA_COMMON, "scaled_gemm"), W8A8_PER_STEP,
        ),
        # Gemma-2-2B at its published config, 26 layers.
        "gemma2_2b_bf16": serve(
            card, "gemma2-2b", GemmaConfig.gemma2_2b(), lambda cfg: init_gemma_params(SEED, cfg, device="cuda"),
            {"prefill_fn": gemma_prefill, "decode_fn": gemma_decode_step},
            {"num_pages": 4096, "max_batch_size": 16, "max_pages_per_seq": 320}, gemma_prompts, GEMMA_KERNELS,
            GEMMA_PER_STEP,
        ),
        # DeepSeek-V2-Lite at its published config, 27 layers (K11).
        "deepseek_v2_lite_bf16": serve(
            card, "deepseek-v2-lite", DeepseekV2Config.v2_lite(),
            lambda cfg: init_deepseek_params(SEED, cfg, device="cuda"), deepseek_fns,
            deepseek_engine, deepseek_prompts, DEEPSEEK_KERNELS, DEEPSEEK_PER_STEP,
        ),
        # Quantized KV caches (kv_cache_scale 1/16): each run is its bf16-cache
        # twin above with only the cache changed. The README's int4 example
        # over an int8 cache (BASELINE.json, "INT4 weight-only + INT8 KV
        # cache"); bf16 weights over an e4m3 cache (BASELINE.json, "FP8 KV
        # cache"); DeepSeek-V2-Lite over an e4m3 latent cache.
        "llama3_8b_int4_kv_int8": serve(
            card, "int4-kv-int8", llama_cfg, llama("int4"), {"cache_dtype": torch.int8},
            {"num_pages": 4096, "max_batch_size": 32}, int4_prompts, LLAMA_KERNELS, LLAMA_PER_STEP,
        ),
        "llama3_8b_bf16_kv_fp8": serve(
            card, "bf16-kv-fp8", llama_cfg, llama("bf16"), {"cache_dtype": torch.float8_e4m3fn},
            {"page_size": 16, "num_pages": 2048, "max_batch_size": 8, "max_prefill_tokens": 128}, bf16_prompts,
            LLAMA_COMMON, {k: v for k, v in LLAMA_PER_STEP.items() if k != "mixed_gemm_magic"},
        ),
        "deepseek_v2_lite_kv_fp8": serve(
            card, "deepseek-v2-lite-kv-fp8", DeepseekV2Config.v2_lite(),
            lambda cfg: init_deepseek_params(SEED, cfg, device="cuda"),
            {**deepseek_fns, "cache_dtype": torch.float8_e4m3fn}, deepseek_engine, deepseek_prompts,
            DEEPSEEK_KERNELS, DEEPSEEK_PER_STEP,
        ),
    }
    # Mistral-7B-v0.1 (its published config: window 4096 on every layer) in
    # int4 with rolling KV, a ring of 289 pages a sequence and prompts past
    # it; then its unbounded twin (the same window, every page kept), whose
    # greedy tokens the rolling engine must give. Qwen2-7B in int4 (q/k/v
    # biases, GQA group 7, K 3584 and 18944).
    rolling, unbounded = {}, {}
    launches["mistral_7b_int4_rolling"] = serve(
        card, "mistral-7b-int4-rolling", mistral_7b_config(), llama("int4"), {}, MISTRAL_ROLLING, mistral_prompts,
        LLAMA_KERNELS, LLAMA_PER_STEP, max_tokens=MISTRAL_MAX_TOKENS, record=rolling,
    )
    launches["mistral_7b_int4_unbounded"] = serve(
        card, "mistral-7b-int4-unbounded", mistral_7b_config(), llama("int4"), {}, MISTRAL_UNBOUNDED,
        mistral_prompts, LLAMA_KERNELS, LLAMA_PER_STEP, max_tokens=MISTRAL_MAX_TOKENS, record=unbounded,
        profile=False,
    )
    check_rolling_twins(rolling, unbounded, launches)
    lap("served runs of Llama-3-8B, Gemma-2-2B, DeepSeek-V2-Lite and Mistral-7B")
    launches["qwen2_7b_int4"] = serve(
        card, "qwen2-7b-int4", LlamaConfig.qwen2_7b(), llama("int4"), {}, QWEN2_ENGINE, qwen2_prompts, LLAMA_KERNELS,
        QWEN2_PER_STEP,
    )
    # DeepSeek-V2-Lite (int4 and int8 at group 32: K1 two groups a slice, K1b
    # 8 word rows a slice; nf4: K1c; w8a8: K8) and Gemma-2-2B (group 128) in
    # each quantized mode, at full width, one model at a time, 8 requests of
    # QUANT_MAX_TOKENS tokens; each engine is its bf16 twin's.
    for mode, gemm in QUANT_GEMM.items():
        nf4_init = {"quantize4": 163} if mode == "nf4" else None
        launches[f"deepseek_v2_lite_{mode}"] = serve(
            card, f"deepseek-v2-lite-{mode}", DeepseekV2Config.v2_lite(),
            lambda cfg, mode=mode: init_deepseek_params(SEED, cfg, quant_mode=mode, device="cuda"), deepseek_fns,
            deepseek_engine, deepseek_prompts,
            ("mla_attention", "rms_norm", gemm, *(("silu_and_mul",) if mode != "nf4" else ())),
            DEEPSEEK_QUANT_PER_STEP[mode], nf4_init, max_tokens=QUANT_MAX_TOKENS,
        )
    for mode, gemm in QUANT_GEMM.items():
        nf4_init = {"quantize4": 182} if mode == "nf4" else None
        launches[f"gemma2_2b_{mode}"] = serve(
            card, f"gemma2-2b-{mode}", GemmaConfig.gemma2_2b(),
            lambda cfg, mode=mode: init_gemma_params(SEED, cfg, quant_mode=mode, device="cuda"),
            {"prefill_fn": gemma_prefill, "decode_fn": gemma_decode_step},
            {"num_pages": 4096, "max_batch_size": 16, "max_pages_per_seq": 320}, gemma_prompts,
            (*GEMMA_KERNELS, gemm), GEMMA_QUANT_PER_STEP[mode], nf4_init, max_tokens=QUANT_MAX_TOKENS,
        )
    # Mixtral-8x7B at every published width, 24 of 32 layers (MIXTRAL_LAYERS),
    # bf16, 8 requests of 40 to 2000 tokens, 512-row prefill steps; the
    # router in full f32.
    import conch_tpu_torch.models.moe as moe

    require_full_f32("mixtral_8x7b_bf16")
    mixtral_cfg, mixtral = mixtral_config(MIXTRAL_LAYERS), {}
    launches["mixtral_8x7b_bf16"] = serve(
        card, "mixtral-8x7b-bf16", mixtral_cfg, lambda cfg: moe.init_moe_params(SEED, cfg, device="cuda"),
        {"prefill_fn": moe.mixtral_prefill, "decode_fn": moe.mixtral_decode_step}, MIXTRAL_ENGINE, mixtral_prompts,
        MIXTRAL_KERNELS, MIXTRAL_PER_STEP, max_tokens=MIXTRAL_MAX_TOKENS, record=mixtral, runs=MIXTRAL_RUNS,
        annotate={"moe_ffn": (moe, "moe_ffn"), "moe_experts": (moe, "moe_experts")},
    )
    report_mixtral_profile(card, mixtral_cfg, mixtral)
    lap("served runs of Qwen2-7B, the quantized DeepSeek and Gemma, and Mixtral")
    launches.update(slice_paths(card, lap))
    launches["vision_bevfusion"] = vision_launches
    launches["llama3_8b_qlora"] = qlora_launches
    launches["llama3_8b_residual_stream"] = stream_launches
    launches["llama3_8b_tp8_collectives"] = tp8_launches
    # ``launches``: the Gemma run for the kernels it runs, the int4 run for
    # K1, K4 and K6, the int8, nf4 and w8a8 runs for their kernels (K12q:
    # during the nf4 init), the DeepSeek run for K11, K9's phase for K9, the
    # vision path for K13a, K13b and K13c; every path's count beside it (the quantized-cache runs' K2, K3, K7
    # and K11 among them).
    for row in rows:
        counter = ROW_COUNTERS.get(row["name"], row["name"])
        by_path = {path: counts[counter] for path, counts in launches.items() if counter in counts}
        if row["name"] in PHASE_PATH_KERNELS:
            row["launches"] = row.pop("phase_launches")
        else:
            row["launches"] = by_path[PRIMARY_PATH.get(row["name"], "gemma2_2b_bf16")]
        row["launches_by_path"] = by_path
        if row["launches"] <= 0:
            raise AssertionError(f"{row['name']} was never launched on its main path")
    print(json.dumps({"kernels": rows}))
    print(card)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

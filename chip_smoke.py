#!/usr/bin/env python3
"""Drive the PyTorch port's dense, split-KV, quantized and d-tiled forwards,
the continuous-batching scheduler, generation, speculative decoding,
training, encoder and seq2seq training paths, the sequence-parallel ring
and sharded train step, and the windowed model's training and generation,
on one NVIDIA H100.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, one line each; any failure exits non-zero before the last line:

1. device: a CUDA card of compute capability 9.0, with its name and power
   limit from nvidia-smi;
2. build:  nvcc builds the kernels of exploring_flash_attention_tpu_torch/
   csrc/ and its -Xptxas -v report (registers, shared memory) is printed;
   the SASS of the kernel functions of H1, H3, H4-int8, H4-kvq, H5 and
   H6-extend (cuobjdump) must hold wgmma instructions: HGMMA in every H1
   (D 32, 64, 128, 256), H3-dkv and H3-dq (D 32, 64, 128, 256; 64 and
   128 also with d a constant),
   H4-kvq, H5 and H6-extend function and in H4-int8's pv_mode bf16 ones,
   IGMMA in every H4-int8 function, and no HMMA or IMMA (the mma.sync and
   WMMA forms they replaced); every H2 function must load with 128-bit
   global loads (LDG.E.128); no instance of the f32 core or of H5 spills
   or has its wgmma serialized, and every H5 cluster instance has
   clusters that the card can hold (cudaOccupancyMaxActiveClusters);
3. h1:     kernel H1 (the attention forward) vs its plain PyTorch
   version and the f64 oracle, causal, at the slice's shapes and one
   ragged case;
4. v1:     flash_attention_v1, the dense forward, on H1 at bench.py's
   canonical shape (B=32, H=8, L=1024, d=128, bf16, non-causal; inputs
   from np.random.default_rng(1) as bench.py makes them): the main call,
   with every counter zeroed before and read after (H1 1), passes
   bench.py's gate (f32 O of [:2, :2] vs the f64 oracle, max|dO| <= 1e-3)
   and matches the plain version over the whole tensor; then one case per
   JAX route (d=32, GQA ragged cross, a ragged KV of 8200, causal cross,
   window 512 at L=4096 and its LSE partial, each one H1 launch; a KV of
   8192 over 16 Q tiles
   per head, one H1 launch over KV spans and one launch of H2, the
   split-KV combine), against the plain version and the oracle.  H1, the
   plain version and scaled_dot_product_attention are timed at the
   canonical shape, the window call must take under half the causal
   call's time, and the split case is timed at several span counts;
5. v2:     the split-KV V2 API at the JAX suite's bench_splitkv entry
   (bench/suite.py:345-360: B=32, H=8, L=1024, d=128, two KV spans of
   512), non-causal and causal: flash_attention_v2 is one H1 launch over
   the spans and one H2 launch (counters zeroed before, read after),
   flash_attention_splitkv_partial's partials have JAX's shape, causal
   spans above the diagonal are (0, -inf); O against the plain version
   and the f64 oracle, the v1 controls and the last span's LSE set to
   -inf beyond the limit; times beside scaled_dot_product_attention;
6. quant:  flash_attention_kvquant (kernel H4-kvq, int8 or e4m3 K/V) and
   flash_attention_int8 (kernel H4-int8, int8 Q/K/V, pv_mode bf16 and
   int8) at the JAX suite's shapes (bench/suite.py:363, :395, :1173):
   the suite's gates at its gate inputs, then one launch per call at the
   canonical shape, a KV of 8192 and a ragged KV (kvquant), at L=4096
   and the JAX test's ragged case (int8), each against the plain version
   and the f64 oracle over the dequantized tensors, with the neighbouring
   block's scales as a further control; times beside
   scaled_dot_product_attention over the dequantized bf16 tensors, and
   the int8 calls also with the per-call quantize_int8 of Q; then both
   at d 16, 80, 144 and 256 (H4's instances D 64, 128, 256; bf16 and f32
   q for kvquant, both pv_modes for int8) and kvquant at d 384 and 1024
   (one launch of H5's quantized form), each against the plain version
   and the oracle beside its controls, and the times at d 80 and 256
   (B=32 H=8 L=1024) beside SDPA (each backend), the bound and, at 256,
   H5's quantized form on the same inputs;
7. dtiled: flash_attention_v1_dtiled (kernel H5) at d=512, B=4, H=8,
   L=1024 with bf16, e4m3 and int8 K/V (bench/suite.py:279, :309), the
   same at d 1024 and 2048 (clusters of 2 and 4 blocks that split d's
   chunks) and ragged cases at d 64, 96, 144, 256 and 640, the suite's
   gate first; the last d-chunk left out of S and, in a cluster, one
   rank's partial only are further controls; times at d 512, 1024, 2048;
8. decode: kernel H6-decode (paged INT8 decode, split across the SMs,
   the runs merged by the last block of each sequence and KV head),
   through paged_decode_attention, one launch per call, vs the plain
   version and the f64 oracle over each slot's band of the dequantized
   cache, at the slice's contexts 257..280, the JAX suite's decode entry
   (B=32, Hq=Hkv=8, page size 256, 2048 tokens; bench/suite.py:455-472)
   without and with a window of 512, the windowed model's (contexts
   4609..4632, window 4096) and B=1 at 8100 tokens (64 runs of one page);
   the controls: the newest token hidden, the window one key narrower;
   the fused O vs the plain merge of the kernel's own partials within one
   bf16 ulp of max|O|, beside the merge with each row's last non-empty
   run left out, which must read beyond the limits; the tickets zero
   after each case; the fused call no slower than the kernel alone
   followed by H2 (the two-launch form), and the window of 512 faster
   than no window;
9. extend: kernel H6-extend (chunked prefill over the paged INT8 cache) vs
   its plain version and the f64 oracle, a C = 256 chunk appended to
   ragged histories 257..280, the windowed model's second turn (C =
   256 over 4609..4632, window 4096) and the speculative verify (C = 5
   over 257..284, some chunks across a page boundary), controls as
   decode's;
10. scheduler: ContinuousBatchingScheduler at the JAX suite's
   bench_scheduler_e2e (bench/suite.py:504-650: Hq = Hkv = 8, d = 128,
   page size 256, 16 slots): its one-step gate (2e-2 of the f64 oracle
   over the dequantized cache; control: the newest token hidden), then
   its churn run (48 requests, prompts 256..2048, 64..192 new tokens,
   16 up front and 4 more every 8 steps, sync=False) with the step's
   CUDA graph replayed (counters: one H6-decode launch a step) and again
   with the fused step eager: every step's output bitwise equal between
   the two, the completion map right, every page back; tokens/s of each;
11. bwd:    kernels H3-dkv and H3-dq (the attention backward, through
   flash_attention_bwd) vs attention_bwd_plain and f64 autograd of the
   plain forward, at the training shape (B=8, Hq=8, Hkv=4, L=1024,
   d=128), a ragged cross case (Lq=200, Lkv=216), L=3072, B=1 (where
   the JAX package takes B12/B13) and the seq2seq cross attention's Lq=256
   against Lkv=1024, then at d 16, 32, 80, 96, 144 and 256 (every instance
   off the flagship's d, a GQA group of 16 over one KV head, ragged cross
   shapes), each under no mask, causal and a window of 100 keys; the
   controls: the last 64-key tile dropped, the diagonal key hidden, the
   window one key narrower; two runs must be bitwise equal;
12. slice:  the full-width flagship LM (vocab 32768, 4 layers, d_model 1024,
   GQA 8/4, d_head 128, d_ff 4096, bf16, random weights from seed 0) runs
   GenerationEngine.generate on [8, 256] prompts for 24 tokens.  Every
   kernel's launch counter is zeroed just before and read just after: H1
   must launch n_layers = 4 times, H6-decode 4 * 23 = 92 and H2 never.
   The decode steps after the first replay one CUDA graph; the counters
   count the replays' launches.  The tokens equal, bitwise, those of a
   loop over _decode_forward (the eager steps), and each generated
   token is checked against a fresh full forward over the sequence so far
   (agreement, or a near-tie under LOGIT_GAP); the control engine is
   built, and captures its graph, under the patch.  Tokens/s come from
   the host clock around a second, synchronized call, graphed and eager;
13. multiturn: the same model holds its slots (generate(hold=True)), then
   continue_generation feeds a second turn of 256 tokens (turn 1's last
   token and 255 new ones, chunk at positions 279..534) and decodes 24
   more.  Counters: turn 1 H1 4, H6-decode 92; turn 2 H6-extend 4,
   H6-decode 92; H2 0 in both, H1 0 in turn 2.  Each turn-2 token is
   checked against the full forward over the whole stream so far, and
   every layer's cache against forward_collect_kv over the concatenated
   stream; release() must return every page;
14. train:  the same model, trainable (fresh weights from seed 0), takes
   make_train_step's AdamW steps (lr 1e-3) on tokens [8, 1025] from
   np.random.default_rng(0).  Every step must launch H1, H3-dkv and H3-dq
   n_layers = 4 times each.  Before the steps, the step-0 loss and every
   parameter's gradient are held against the same model with the plain
   attention patched in (mock.patch), with the diagonal key hidden in the
   forward (loss) and in the backward (gradients) as controls; the loss
   must fall strictly over 5 steps, and tokens/s and TFLOP/s come from the
   host clock around further synchronized steps;
15. encoder: the JAX suite's encoder entry (bench/suite.py:1057-1102):
   the same geometry, fresh weights from seed 0, trained bidirectionally
   by make_mlm_train_step (AdamW, lr 1e-3) on tokens [8, 1024] under one
   fixed MLM mask.  Every step must launch H1, H3-dkv and H3-dq n_layers
   = 4 times each, all without a mask.  The step-0 loss and every
   gradient are held against the plain attention patched in, with a
   causal forward (loss) and a causal backward (gradients) as controls;
   the loss must fall over 5 steps; encoder training tokens/s come from
   the host clock around further steps;
16. window_train: the windowed model (A8), the JAX suite's long-context
   entry (bench/suite.py:1003-1053: vocab 2048, the flagship's layers,
   window 4096), fresh weights from seed 0, make_train_step's AdamW on
   tokens [1, 32769].  Step 0's loss and every gradient against the plain
   attention patched in (blockwise over the bands), the band shifted back
   one key (forward; backward, on H3) and dropped (forward) as controls;
   a warm-up and 5 timed steps, each launching H1, H3-dkv and H3-dq 4
   times, the last loss below the first (the suite's gate); training
   tokens/s;
17. window_generate: the same model served: [8, 4608] prompts (longer
   than the window) for 24 tokens held, then a 256-token second turn and
   24 more (max_len 5120, page size 128).  Counters: turn 1 H1 4,
   H6-decode 92; turn 2 H6-extend 4, H6-decode 92; H2 0 in both.  Tokens
   against the windowed full forward (agreement or a near-tie), the cache
   after turn 2 against forward_collect_kv over the stream; controls: the
   band dropped in decode and a turn one token short (tokens), a stream
   one token short (cache), each patched engine built under its patch;
   turn 1's tokens bitwise those of the eager loop; tokens/s of both
   turns, and of turn 1 eager;
18. speculative (after multiturn): SpeculativeEngine at the JAX suite's
   bench_spec_decode (bench/suite.py:1380-1495): the flagship target with
   a 1-layer paged draft at its widths (seed 7), then with itself as the
   draft, [8, 256] prompts, 24 new tokens, gamma 4; and at
   bench_spec_decode_distilled (:1498-1620): the flagship trained 300
   AdamW steps on the det_p 0.9 Markov task, a tiny draft (1 layer, d_model
   512) distilled from it for 600 steps by distill_draft (counters: H1,
   H6-decode for its corpus, H1 and H3 for its steps), then 8 x 256
   Markov prompts for 128 tokens with the dense draft (window 128) at
   gamma 12, 16 and 20.  Each leg: counters zeroed before the first call
   (H1 per prefill layer of both models, H6-extend per target layer a
   round, H6-decode gamma + 1 per draft layer a round when paged; the
   rounds after the first replay one CUDA graph), graphed calls bitwise
   the eager rounds' tokens, every token against the full forward
   (agreement or a near-tie under LOGIT_GAP), tokens/s graphed and eager
   beside the vanilla engine's on the same prompts; controls, each engine
   captured under its patch: the rollback one token late (must fail) and
   the verify with each chunk row's own key hidden (shown);
19. seq2seq (after encoder): the encoder-decoder family at the
   flagship's widths, 2 encoder and 2 decoder layers, trained by
   make_seq2seq_train_step (Adam, lr 3e-3) on src [8, 1024], tgt
   [8, 257]: 6 launches each of H1, H3-dkv and H3-dq a step (cross
   attention at Lq=256, Lkv=1024 without a mask), the step-0 loss and
   every gradient against the plain attention beside controls (the
   decoder's self-attention seeing the future, the cross backward
   without its last 64 keys), the loss falling over 10 steps, and the
   step's forward / backward / Adam split on the host clock;
20. tiles (after v1): H1's two new forms through flash_attention_v1.
   TileConfig(softmax="bound") at bench.py's canonical shape (the
   phase's main path, counters zeroed before and read after: H1 1 and
   one call of the statistic's torch ops, ops/attention.bound_kmax)
   against the f64 oracle and the plain bound version within 2e-3, the
   v1 gate's controls beyond it; a causal bound call whose K/V grow by
   one 128-key tile keeps its first rows bitwise; traced offsets bitwise
   the static launch; over KV spans (H1 + H2) and under a window against
   the plain version.  The 64-row Q tile (block_q <= 64) bitwise the
   128-row one on the same inputs, exact and bound, timed with it at the
   canonical shape and at B=1 H=8 L=1024 causal; the flagship's forward
   with ModelConfig.tile's block_q=64 bitwise the default's.  Then
   utils/: autotune_v1 at both shapes, autotune_window, autotune_splitkv
   and autotune_dtiled once each, every winner read back from the disk
   cache; a torch.profiler trace (utils.trace) of each form for the
   kernels' device times and the statistic's kernels; kernel_report's
   table of H1 exact, bound, the 64-row tile and SDPA.
21. parallel (after seq2seq): the sequence-parallel paths on one card.
   A causal ring of 4 ranks at the flagship's widths (Hq 8, Hkv 4, d 128,
   bf16), B=8 x L=1024 (the train step's shape) and B=1 x L=32768 (256
   and 8192 rows a rank), composed by hand through parallel.ring's hop
   functions: every (rank, source) hop's H1, H3-dkv and H3-dq at its
   traced pair (a device int32 tensor) bitwise their static launches and
   against the plain versions, the controls kv_pos0 a 64-key tile off
   (the diagonal hop) and a future hop shown its keys; launches per rank
   (H1 4 forward, H3-dkv and H3-dq 4 backward); the composed O, LSE and
   gradients against one-device H1 and H3, with one hop a tile off as
   control; hop times (diagonal and past hop) beside the static launch,
   SDPA under the hop's mask and the bound.  One hop captured in a CUDA
   graph replays bitwise its eager calls at 16 pairs written into the
   offsets tensor.  make_train_step(mesh=) on a one-rank NCCL group
   (MeshConfig(1, 1, 1)) at the flagship's widths on tokens [8, 1025]
   (SGD) against mesh=None: the loss and every leaf's gradient, the ring's
   diagonal key hidden as control, counters zeroed before the mesh step
   and read after (H1 4, H3-dkv 4, H3-dq 4), step times of both; then
   parallel.dryrun.dryrun_multichip(1) on the card.  Collectives across
   ranks are not run: NCCL takes one card a rank, and this machine has
   one; tests/test_torch_parallel.py and tests/test_torch_sharded.py run
   them on gloo ranks on the CPU.

22. heads (after speculative): the serving kernels at head geometries the
   JAX model takes beyond the flagship's (d a multiple of 16 from 16 to
   256, any GQA group, pages a multiple of 128 below 2^15).  H1 at d 16,
   80, 96 and 256 on a GQA group of 16 (B=2, Lq=1000, Lkv=1100): no mask,
   causal and a window of 100 with the LSE, and over 256-key spans, each
   one counted launch against the plain version and the f64 oracle beside
   the v1 phase's controls (scale off by 10%, the last 64-key tile
   dropped); H2 on those spans at d 80 and 256 (control: each row's last
   span left out); H6-decode and H6-extend at (d, Hq, Hkv, page size)
   (16, 32, 1, 1024), (80, 16, 1, 512), (256, 8, 8, 128) and (256, 32, 2,
   512) over B=8 contexts 257..1100 (extend: a 64-token chunk after them),
   beside the decode and extend phases' controls, the fused merge against
   the plain merge of the kernel's own partials, the tickets zero; every
   kernel timed at d 80 and 256 beside its plain version, SDPA and the
   bound.  Then two models at the flagship's widths with only the
   attention geometry changed, heads256 (4 q heads over one KV head of
   256, page size 512) and heads80g16 (16 q heads over one KV head of 80,
   page size 128), each served as the slice and multiturn phases serve the
   flagship (counters, graphed tokens bitwise the eager loop's, tokens
   against the full forward, the cache against the stream, tokens/s), and
   heads80g16 through the continuous-batching scheduler (its gate, 12
   requests graphed and eager, bitwise equal, one H6-decode launch a
   step).  Past d 256 (bf16): H1 at d 257, 264, 300, 385
   and 512 on H5's block of d-chunks as above, H2 at 257, 300 and 512,
   the paged pair at HEADS_WIDE_PAGED (heads512's geometry, a group of 16
   in chunks of 2, code rows of 16, 4, 1 and 8-byte alignment), the d
   off 16-byte rows beside the misread-row controls; H1 at d=512 timed
   beside H5 and SDPA (HEADS_WIDE_TIMED); heads512 (2 q heads over one
   KV head of 512, page size 256) served end to end.
23. heads_train (after train): the heads phase's models but heads512
   (H3 takes d up to 256) trained as
   the flagship is, so H3 runs at d 256 (its column-split instance), 80
   and 72 (D=128 on zero-filled columns; 72's rows of 144 bytes by TMA)
   inside a model: make_train_step on
   tokens [8, 1025] (the step-0 loss and every gradient against the
   plain attention beside the diagonal-hidden controls, H1, H3-dkv and
   H3-dq 4 launches a step, the loss falling strictly over 5 AdamW steps,
   training tokens/s beside the train phase's flagship), the sharded step
   at MeshConfig(1, 1, 1) against mesh=None, and heads256's and heads72's
   encoders (make_mlm_train_step, bidirectional; heads72's is
   SigLIP-so400m's case) as the encoder phase runs it, their gradients
   held against the plain backward in H3's place (the whole path against
   the plain attention is shown: there H1's bf16 O moves a bidirectional
   leaf by up to 6e-2 of its norm, the backward not at all); then H3
   timed at each model's shape (B=8, L=1024, causal and without a mask),
   at SigLIP-so400m's encoder shape (B=32, H=16, L=729, d=72, no mask)
   and causal at d 100 and 36 (the staged producer) on the flagship's
   train shape, beside its plain version, SDPA's backward and the bound;
   H3 at HEADS_ODD (d 1, 8, 33, 36, 40, 72, 100, 250) in bf16 and f32 on
   the group of 16 (B=2, Lq 1000, Lkv 1100) under each mask, one counted
   launch of each kernel within the bwd phase's limit (the f32_train
   phase's at f32) of the plain backward and f64 autograd, beside the
   plain backward on rows read one element late and on each row's last
   column dropped; and H3 at traced offsets at d 80, 256, 72 and 33
   bitwise its static launch.
24. f32 (after heads): the serving kernels and the flagship at f32, the
   JAX package's default dtype (models/transformer.py:59), whose kernels
   compute f32 at f32 accuracy (HIGHEST).  H1 with f32 q/k/v (its f32
   kernel, bf16x6 on wgmma in csrc/f32_attention.cuh) at
   bench/suite.py:105-133's referee
   row (B=2, H=4, L=256, d=128; none, causal, window 64) within 1e-5 of
   an f64 plain run on the card, the LSE too; at tests/
   test_attention_v1.py:24-27's shape and at d 16, 80, 128 and 256 on a
   GQA group of 16 (each mask, the LSE and KV spans) within 2e-5, and
   over long key counts (F32_LONG_KEYS: 8200 keys at d 128 and 256,
   32768 keys without a mask and under a window of 4096) within 2e-5; the
   bound form and the 64-row tile; flash_attention_v2 (H1 spans + H2)
   within 1e-4; H6-decode and H6-extend (bf16x3 on wgmma) with f32 q at
   HEADS_PAGED and at the flagship's geometry (d=128, Hq 8, Hkv 4, pages
   of 128) within 1e-5 of their plain f32 versions (and the f64 oracle
   over the bands),
   the tickets zero.  Every check's known-wrong control is the same inputs
   rounded to bf16 through the bf16 kernel, which must read beyond its
   limit.  Each kernel is timed at f32 at the flagship's shapes (H1 at
   bench.py's canonical shape too) beside its plain version, SDPA at f32
   with TF32 off and its bound (the piece products at 989 TFLOP/s bf16
   for H1 and H6-extend, printed beside what f32 FMA at 67 TFLOP/s would
   take; f32 bytes at 3.35 TB/s).  Then the flagship at dtype=torch.float32 through the
   slice and multiturn phases (H1 4, H6-decode 92 launches a generate;
   H6-extend 4, H6-decode 92 a second turn; graphed bitwise eager; tokens
   against the full forward), and its full forward's logits within 1e-4
   of max|logits| of an all-plain f32 forward on the card, beside the
   forward with attention's q, k, v rounded to bf16.
25. f32_train (after train and heads_train): training at f32.  H3-dkv
   and H3-dq with f32 q, k, v and dO (their f32 kernels, bf16x6 on wgmma,
   P and dS kept f32; at d 144-256 the D=256 instance, a cluster of two
   blocks that split the columns and add their partials of S and dP
   through distributed shared memory; the most clusters active at once
   printed) through flash_attention_bwd, each call one counted launch of
   each,
   with H1 f32's residuals, against f64 autograd of the plain forward on
   the card: max|g - g64| <= 1e-4 max|g64| per gradient (the rtol of
   tests/test_attention_bwd.py:180) at the f32 flagship's train shape
   (B=8, Hq=8, Hkv=4, L=1024, d=128; causal and no mask), BWD_SHAPES'
   ragged shape and BWD_CROSS, d 16, 64, 80 and 144 (under no mask,
   causal and a window of 100), heads256's train shape (B=8, Hq=4, Hkv=1,
   L=1024, d=256; causal and no mask), the windowed model's shape (B=1,
   L=32768, window 4096; the f64 reference block by block over the bands)
   and traced offsets at d 80, 128 and 256 (bitwise their static
   launch).  Two known-wrong
   controls must read beyond the limit in every case: the bf16 kernels on
   the inputs rounded to bf16, and the plain f32 backward with P and dS
   rounded to bf16.  H3 f32 timed at the train shape (causal, no mask)
   beside the plain f32 backward, SDPA's f32 backward (TF32 off) and the
   bound (six bf16 piece products a product at 989 TFLOP/s), at heads256's
   train shape (the same, with the SDPA backends that take its f32
   backward and the kernels of the default's), and at the windowed
   shape.  Then the flagship at dtype=torch.float32 trained as
   the train phase trains it (H1, H3-dkv and H3-dq 4 launches a step, the
   loss falling over 5 AdamW steps, the step-0 loss within 2e-5 and every
   leaf's gradient within 1e-4 of its norm of the all-plain f32 step;
   controls: the diagonal key hidden in the forward, H3's bf16 kernels on
   bf16-rounded inputs in the backward), its training tokens/s beside the
   bf16 flagship's of this run; the encoder step (make_mlm_train_step,
   H1 and H3 without a mask, against the all-plain f32 step; controls: a
   causal forward, a causal backward) and the sharded step at
   MeshConfig(1, 1, 1) (the ring's hop at traced offsets) at f32, each
   at the same limits.  Then heads256 and heads72 at dtype=torch.float32
   through the same train step, encoder step and sharded step at the same
   limits, their training tokens/s beside their bf16 readings of the
   heads_train phase, and H3 f32 timed at heads72's train shape.
26. quant_odd (after f32_ops): H4-kvq, H4-int8 and H5 at head dims off
   the multiples of 16 (HEADS_ODD: their PACKED and STAGED instances,
   whose producers copy rows that no tensor map takes), bf16 and f32 q,
   int8 and e4m3 K/V (H5 also K/V of q's dtype), and H5's quantized
   form through flash_attention_kvquant at d 264, 520, 1000 and 2040;
   each one counted launch against the plain version and the f64 oracle
   on [:1, :2] beside the quant phase's controls and rows misread (each
   element one late, each row's last column dropped: K's or V's, and Q's
   for H4-int8).  Timed beside SDPA over the dequantized tensors and the
   bound of the true d: the kvquant and int8 ops at SigLIP-so400m's
   attention (B=32, H=16, L=729, d=72), H4-kvq at Stable Diffusion 1.5's
   first UNet self-attention (B=2, H=8, L=4096, d=40), H5 beside H1 at
   SigLIP-so400m's shape.

``python3 chip_smoke.py --only PHASE,...`` runs the build and the named
phases alone (no kernels line), for a quicker call while a phase is
worked on.

Kernel times come from CUDA events (L2 flushed before each call) beside
their plain versions, their bounds on the H100 (the larger of the
operations at 989 TFLOP/s bf16 and 1,979 TOP/s int8, 67 TFLOP/s for H2's
f32 work, and the bytes at 3.35 TB/s) and, where one PyTorch call
computes the same function, that call's time (scaled_dot_product_attention
for H1 and H5, causal or with a band mask where H1's mask is, its
autograd backward under the same mask for H3, which is timed causal and
without a mask, each kernel alone and the delta reduction apart).
Every check also runs a control: the same comparison against a
known-wrong path (one key hidden from each row, the scale off by 10%, the
last 64-key tile dropped, or a stream one token short).  The control must read beyond the check's
limit, so each limit is shown to tell a wrong path from a right one.

Then a JSON line describing the kernels, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``.  The script imports no JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import math
import os
import re
import subprocess
import sys
import time
import traceback
import warnings
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# Tolerances (bf16 inputs, f32 accumulation).  Each lies between what a
# sound kernel reads and what a known-wrong path reads (one key hidden from
# every row, printed as "control" beside each check, which must exceed it):
H1_O_TOL = 2e-2        # P and O rounded to bf16; one ulp at |x|~2 is 7.8e-3
H1_LSE_TOL = 4e-3      # l sums bf16-rounded P: ln(l) within ~2^-9
DECODE_O_TOL = 5e-3    # P*v_scale and O rounded to bf16; sound runs 1.4e-3
EXTEND_O_TOL = 5e-3    # as DECODE_O_TOL: P*v_scale and O rounded to bf16;
                       # sound runs 2.7e-3, its control 0.25
PAGED_REL_TOL = 1e-2   # every decode and extend case also holds max|dO| /
                       # max|O_ref| under this: over thousands of keys |O|
                       # is ~0.1 and a one-key fault moves it by ~3e-3, under
                       # the absolute limits.  A CPU emulation of the
                       # kernels' roundings (P * v_scale and O to bf16) reads
                       # 2.8e-3..4.2e-3 at every case's shape, the controls
                       # (newest token hidden, window one key narrower)
                       # 2.9e-2 and up
LOGIT_GAP = 0.0625     # decode vs full forward: a flip must be a near-tie,
                       # 4 bf16 ulps of a logit in [2, 4); sound runs 0.0312
CACHE_KV_TOL = 0.2     # cache after turn 2 vs forward_collect_kv: the int8
                       # step (|k| <= ~5: 5/254 = 0.02) plus bf16 rounding
                       # of K/V that two paths computed (ulp 0.03 at |k| ~ 4);
                       # sound runs 0.106, the one-token-short control 7.6

H3_REL_TOL = 2e-2      # per gradient, max|d| / max|ref|: P and dS rounded to
                       # bf16 before their products, the gradients to bf16;
                       # sound runs 3.4e-3..5.7e-3 (a CPU emulation of those
                       # roundings 3e-3..7e-3), the diagonal-hidden control
                       # 0.36..1.03
TRAIN_LOSS_TOL = 7e-5  # step-0 loss (10.6) vs the plain attention: a mean
                       # over 8,192 tokens of near-uniform predictions
                       # (random weights), moved only where H1's bf16 O
                       # differs by an ulp; sound runs 2.4e-5, the
                       # diagonal-hidden forward 1.8e-4
HEADS72_LOSS_TOL = 2e-4  # heads72's step-0 loss vs the plain attention:
                       # there the loss moves by up to 1.6e-4 with bf16
                       # rounding choices alone (the plain forward against
                       # itself with P rounded to bf16 as H1 rounds it,
                       # tools/probe_loss_rounding.py; the flagship's
                       # 8.7e-5), past TRAIN_LOSS_TOL; sound runs 8.3e-5,
                       # the diagonal-hidden forward 5.2e-4
ENCODER_LOSS_TOL = 1e-3  # the encoder's step-0 MLM loss vs the plain
                       # attention, a mean over the ~1,270 masked tokens
                       # only: sound runs 1.4e-4, the causal forward 1.1e-2
GRAD_REL_TOL = 6e-2    # largest per-leaf ||dg|| / ||g_plain|| over the 38
                       # leaves: bf16 gradients through 4 layers; sound runs
                       # 2.4e-2, the diagonal-hidden backward 0.15
SEQ2SEQ_LOSS_TOL = 5e-4  # the seq2seq step-0 loss vs the plain attention, a
                       # mean over 2,048 target tokens: between the train
                       # phase's 8,192 tokens (sound 2.4e-5) and the
                       # encoder's ~1,270 (sound 1.4e-4)

V1_GATE_TOL = 1e-3     # bench.py's gate (bench.py:66-82): f32 O of [:2, :2]
                       # at the canonical shape vs the f64 oracle on the
                       # bf16-rounded inputs
V1_O_TOL = 2e-3        # f32 O in the further v1 checks, vs the plain
                       # version and the oracle: P rounded to bf16 before
                       # P V; sound runs 1.6e-4..5.7e-4, the controls (scale
                       # off by 10%, last 64-key tile dropped) 2.7e-2 and up
V1_WINDOW_O_TOL = 1e-2  # the window cases: rows that see a handful of keys
                       # have |O| up to ~3 and move by up to ~2^-9 of
                       # |v0 - v1|; sound runs 4.3e-3, the controls 0.1 and
                       # up.  A CPU emulation of H1's roundings reads within
                       # half of each limit, both controls beyond 5x
                       # (tests/test_torch_attention_v1.py).  The v2
                       # phase's causal call holds its first rows, which
                       # see 1..n keys, to the same limit
H2_O_TOL = 1e-5        # H2 vs its plain version on the same f32 partials:
                       # both merge in f32 and differ in summation order
# The fused decode's bf16 O vs the plain merge of the kernel's own f32
# partials: one bf16 ulp of max|O| (one rounding of an f32 merge that
# differs from the plain one by summation order only).

# The quant and dtiled phases hold f32 O against the plain version (the
# whole tensor) and the f64 oracle over the dequantized tensors (a slice),
# each within its own limit; every known-wrong control must read beyond
# both.  The suite's gates (bench/suite.py) at its gate inputs come first.
# CPU emulations of each kernel's roundings on inputs made the same way
# read within half of each limit (tests/test_torch_quant.py,
# tests/test_torch_dtiled.py).
KVQ_GATE_TOL = 1e-3    # bench/suite.py:383
KVQ_O_TOL = 5e-4       # H4-kvq rounds P * v_scale / vmax to fp16 (vmax
                       # per 128-key tile): the emulation reads <= 8.1e-5,
                       # the controls 1.8e-2 and up
INT8_GATE_TOL = 1.5e-3  # bench/suite.py:420, :1200 (pv_mode bf16)
INT8_PV8_TOL = 3e-2    # pv_mode int8 vs the oracle, the JAX test's tier
                       # (tests/test_attention_int8.py:53); B18's own
                       # requantized P reads 2.7e-2 at the gate inputs
INT8_RAGGED_TOL = 1e-2  # tests/test_attention_int8.py:62, its ragged case
INT8_PLAIN_TOL = 1e-3  # H4-int8 vs the plain version, which computes B18's
                       # function: summation order and a rare P flip differ
DTILED_GATE_TOL = 2e-3  # bench/suite.py:299, :334
DTILED_O_TOL = 4e-3    # H5 vs the plain version over the whole tensor (32
                       # heads) and the oracle slice: p * v_scale rounded to
                       # bf16, as B19 does; the emulation reads <= 9.5e-4 on
                       # one or two heads (<= 5.8e-4 at d 64 to 2048 in its
                       # clusters' rank order), an H100 1.32e-3 over 32
                       # (fp8), the controls 0.075 and up (the scale off
                       # by 10% at d=96)

H100_BF16_FLOPS = 989e12      # dense bf16 tensor-core peak, SXM data sheet
H100_INT8_OPS = 1979e12       # dense int8 tensor-core peak, same source
H100_F32_FLOPS = 67e12        # float32 outside the tensor cores, same
H100_HBM_BYTES_S = 3.35e12    # HBM3 rate, same source

H1_SRC = "exploring_flash_attention_tpu_torch/csrc/prefill_attention.cu"
H2_SRC = "exploring_flash_attention_tpu_torch/csrc/splitkv_combine.cu"
H6_SRC = "exploring_flash_attention_tpu_torch/csrc/paged_decode.cu"
H6E_SRC = "exploring_flash_attention_tpu_torch/csrc/paged_extend.cu"
H3_SRC = "exploring_flash_attention_tpu_torch/csrc/attention_bwd.cu"
H4KVQ_SRC = "exploring_flash_attention_tpu_torch/csrc/kvquant_attention.cu"
H4INT8_SRC = "exploring_flash_attention_tpu_torch/csrc/int8_attention.cu"
H5_SRC = "exploring_flash_attention_tpu_torch/csrc/dtiled_attention.cuh"
KVQ_PY = "exploring_flash_attention_tpu/ops/attention_kvquant.py"
INT8_PY = "exploring_flash_attention_tpu/ops/attention_int8.py"
DTILED_PY = "exploring_flash_attention_tpu/ops/attention_v1_dtiled.py"
BWD_PY = "exploring_flash_attention_tpu/ops/attention_bwd.py"
V1_PY = "exploring_flash_attention_tpu/ops/attention_v1.py"
SPLITKV_PY = "exploring_flash_attention_tpu/ops/attention_v2_splitkv.py"

# (B, Hq, Hkv, Lq, Lkv, d) of the bwd phase: the training shape first (its
# error goes into the kernels line), a ragged cross case, and a length
# where the JAX package takes B12/B13
BWD_CROSS = (8, 8, 4, 256, 1024, 128)   # the seq2seq cross attention
BWD_SHAPES = [(8, 8, 4, 1024, 1024, 128), (8, 8, 4, 200, 216, 128),
              (1, 8, 4, 3072, 3072, 128), BWD_CROSS,
              # every H3 instance off the flagship's d: 16 and 32 on D=32,
              # 80 and 96 on D=128's zero-filled columns, 144 and 256 on
              # the column-split D=256; a group of 16 over one KV head and
              # ragged cross shapes (Lq 1000, Lkv 1100: neither a multiple
              # of 64)
              (2, 16, 1, 1000, 1100, 16), (2, 8, 4, 1024, 1024, 32),
              (2, 16, 1, 1000, 1100, 80), (2, 8, 2, 600, 700, 96),
              (2, 8, 2, 1000, 1100, 144), (2, 16, 1, 1000, 1100, 256)]
# the masks H3 takes, as (causal, window): the bwd phase runs every shape
# under each; the window crosses the 64-key tiles and is narrower than
# every shape's Lkv
BWD_MASKS = {"none": (False, None), "causal": (True, None),
             "window": (True, 100)}

# the v1 phase: bench.py's canonical shape (bench.py:33), then one case per
# JAX route that flash_attention_v1 takes; (route, B, Hq, Hkv, Lq, Lkv, d,
# causal, window, heads refereed by the f64 oracle)
V1_CANON = (32, 8, 1024, 128)
V1_WINDOW = 512
V1_SPLIT_ROUTE = "long-KV split-KV route (B8 spans, B9, B10: H1 spans + H2)"
V1_CASES = [
    ("B6/B7 d=32 at the reference shape", 32, 8, 8, 1024, 1024, 32, False,
     None, 2),
    ("B2 GQA, ragged and cross", 8, 8, 2, 1000, 1100, 128, False, None, 2),
    ("B3 streaming, a KV no one-pass span tiles", 2, 8, 8, 1024, 8200, 128,
     False, None, 1),
    ("B4 causal, cross, GQA", 8, 8, 4, 512, 1024, 128, True, None, 2),
    ("B5 sliding window", 4, 8, 4, 4096, 4096, 128, True, V1_WINDOW, 1),
    (V1_SPLIT_ROUTE, 1, 8, 8, 1024, 8192, 128, False, None, 1),
]
SPLIT_SWEEP = (1, 2, 4, 8, 16)      # KV spans timed at the long-KV case
# the v2 phase: the JAX suite's bench_splitkv (bench/suite.py:345-360),
# whose config cuts the 1024 keys into JAX's nkb = 2 spans of 512
V2_SHAPE = (32, 8, 1024, 128)
V2_CONFIG = {"block_q": 1024, "block_kv": 512, "kv_tiles_per_block": 1}
V2_NKB = 2

# the quant phase (bench/suite.py:363, :395, :1173): (case, B, H, Lq, Lkv,
# d, kind, block, seed, heads refereed by the f64 oracle)
KVQ_CASES = [
    ("canonical int8", 32, 8, 1024, 1024, 128, "int8", 512, 1, 2),
    ("canonical fp8", 32, 8, 1024, 1024, 128, "fp8", 512, 1, 2),
    ("B16's route (JAX streams)", 2, 8, 1024, 8192, 128, "int8", 128, 2, 1),
    ("ragged KV", 2, 8, 1024, 1100, 128, "fp8", 128, 3, 2),
]
# (case, B, H, Lq, Lkv, d, block, pv_modes, seed, heads, oracle limits)
INT8_CASES = [
    ("canonical", 32, 8, 1024, 1024, 128, 512, ("bf16", "int8"), 1, 2,
     {"bf16": INT8_GATE_TOL, "int8": INT8_PV8_TOL}),
    # kv blocks shorter than a 128-key tile: one run per block, each
    # issuing the tile's every P V step
    ("canonical, kv block 64", 32, 8, 1024, 1024, 128, 64, ("bf16", "int8"),
     1, 2, {"bf16": INT8_GATE_TOL, "int8": INT8_PV8_TOL}),
    ("canonical, kv block 16", 32, 8, 1024, 1024, 128, 16, ("bf16", "int8"),
     1, 2, {"bf16": INT8_GATE_TOL, "int8": INT8_PV8_TOL}),
    ("L=4096", 8, 8, 4096, 4096, 128, 512, ("bf16",), 4, 1,
     {"bf16": INT8_GATE_TOL}),
    ("ragged KV (tests/test_attention_int8.py:56)", 1, 1, 128, 200, 64, 128,
     ("bf16", "int8"), 0, 1, {"bf16": INT8_RAGGED_TOL, "int8": INT8_PV8_TOL}),
]
# the quant phase's head dims: H4-kvq (bf16 and f32 q, int8 and e4m3 K/V)
# and H4-int8 (both pv_modes) at d 16, 80, 144, 256 (instances D 64, 128,
# 256, 256: a d below D on zero-filled columns), flash_attention_kvquant
# past 256 (H5's quantized form) at 384 and 1024; a shape (B, H, Lq, Lkv)
# ragged at the 64- and 128-key tiles; H4-kvq's K/V in blocks of 100 (a
# tile's vmax over two blocks), H4-int8's Q in blocks of 64 and K/V of 48
# (runs of 16 keys, shorter than an int8 step).  Each case is one launch
# of the kernel its route names, against the plain version and the f64
# oracle on [:1, :2] beside the controls (tests/test_torch_quant_heads.py
# rehearses the limits).  Timed at the JAX suite's shape (B, H, L, block:
# bench/suite.py:363) at d 80 and 256, with H5's quantized form beside
# H4-kvq at d=256 on the same inputs
QUANT_HEADS_DIMS = (16, 80, 144, 256)
QUANT_H5_DIMS = (384, 1024)
QUANT_HEADS_SHAPE = (2, 4, 1000, 1100)
QUANT_HEADS_BLOCKS = {"kvq": 100, "q": 64, "int8": 48}
QUANT_TIMED = (32, 8, 1024, 512)
QUANT_TIMED_DIMS = (80, 256)
# the dtiled phase (bench/suite.py:279, :309): (case, B, H, Lq, Lkv, d,
# kind, block, seed, heads refereed by the f64 oracle).  Past the suite's:
# d 1024 and 2048 at its shape (clusters of 2 and 4 blocks; f32 4 and 8),
# and head dims off the 128-column chunks at the ragged shape (d 640 a
# cluster of 2, f32 4).  The d=512, 1024 and 2048 cases are timed
DTILED_CASES = [
    ("d=512 bf16", 4, 8, 1024, 1024, 512, "bf16", None, 1, 2),
    ("d=512 fp8", 4, 8, 1024, 1024, 512, "fp8", 512, 1, 2),
    ("d=512 int8", 4, 8, 1024, 1024, 512, "int8", 512, 1, 2),
    ("d=256 ragged bf16", 2, 8, 1000, 1100, 256, "bf16", None, 5, 2),
    ("d=1024 bf16", 4, 8, 1024, 1024, 1024, "bf16", None, 1, 2),
    ("d=1024 fp8", 4, 8, 1024, 1024, 1024, "fp8", 512, 1, 2),
    ("d=1024 int8", 4, 8, 1024, 1024, 1024, "int8", 512, 1, 2),
    ("d=2048 bf16", 4, 8, 1024, 1024, 2048, "bf16", None, 1, 2),
    ("d=2048 fp8", 4, 8, 1024, 1024, 2048, "fp8", 512, 1, 2),
    ("d=2048 int8", 4, 8, 1024, 1024, 2048, "int8", 512, 1, 2),
    ("d=64 ragged bf16", 2, 8, 1000, 1100, 64, "bf16", None, 5, 2),
    ("d=96 ragged bf16", 2, 8, 1000, 1100, 96, "bf16", None, 5, 2),
    ("d=144 ragged bf16", 2, 8, 1000, 1100, 144, "bf16", None, 5, 2),
    ("d=640 ragged bf16", 2, 8, 1000, 1100, 640, "bf16", None, 5, 2),
]
DTILED_TIMED = ("d=512 ", "d=1024 ", "d=2048 ")


def dtiled_controls(torch, qs, kd, vd, scale, f32):
    """The controls of an H5 case that every form shares, the plain
    version run wrongly on the refereed slice (K/V dequantized): the last
    128-column d-chunk left out of S and, where h5_plan makes a cluster,
    one rank's partial only (S over rank 0's columns)."""
    from exploring_flash_attention_tpu_torch.ops import attention_plain
    from exploring_flash_attention_tpu_torch.ops.attention_v1_dtiled import (
        h5_plan,
    )

    d = qs.shape[3]
    cut = 128 * ((d - 1) // 128)
    bad = {"last d-chunk out of S": attention_plain(
        qs[..., :cut], kd[..., :cut], vd, scale, False)[0]}
    c, nc = h5_plan(d, f32)
    if c > 1:
        w = 128 * nc
        bad["one rank's partial only"] = attention_plain(
            qs[..., :w], kd[..., :w], vd, scale, False)[0]
    return bad

# the windowed model (A8): the JAX suite's long-context configuration
# (bench/suite.py:1019-1024), its window; window_train's (B, L) (the
# suite's, :1034) and window_generate's (B, prompt, new tokens, second
# turn, max_len)
WINDOW = 4096
WINDOW_TRAIN = (1, 32768)
WINDOW_GENERATE = (8, 4608, 24, 256, 5120)
# the decode phase's cases: (case, B, Hq, Hkv, page size, contexts (first,
# last; B spread between), max_len, window); the last one's split has more
# runs (64 of one page) than a row's lanes in the kernel's merge (32)
DECODE_LONG = "B=1 long context"
DECODE_CASES = [
    ("slice", 8, 8, 4, 128, (257, 280), 1024, None),
    ("JAX suite decode entry (bench/suite.py:455-472)", 32, 8, 8, 256,
     (2048, 2048), 2048, None),
    ("the same, window 512 (bench/suite.py:490-500)", 32, 8, 8, 256,
     (2048, 2048), 2048, 512),
    ("windowed model's generation", 8, 8, 4, 128, (4609, 4632), 5120,
     WINDOW),
    (DECODE_LONG, 1, 8, 4, 128, (8100, 8100), 8192, None),
]
# the scheduler phase: the JAX suite's bench_scheduler_e2e
# (bench/suite.py:504-650): (Hq, Hkv, d), page size, slots, its gate's
# limit (:538), and the churn's 48 requests
SCHED_HEADS = (8, 8, 128)
SCHED_PAGE = 256
SCHED_SLOTS = 16
SCHED_TOL = 2e-2
SCHED_REQUESTS = 48
SCHED_PROMPTS = (256, 512, 1024, 2048)
SCHED_NEW = (64, 128, 192)
# the extend phase's: (case, B, Hq, Hkv, page size, histories, max_len, C,
# window)
EXTEND_CASES = [
    ("multi-turn", 8, 8, 4, 128, (257, 280), 1024, 256, None),
    ("windowed turn 2", 8, 8, 4, 128, (4609, 4632), 5120, 256, WINDOW),
    # the speculative verify: C = gamma + 1 = 5 chunk rows (C * G = 10 of
    # a 64-row warpgroup tile) after the flagship's 256-token prompts (the
    # card tests add chunks across page boundaries)
    ("speculative verify", 8, 8, 4, 128, (257, 284), 1024, 5, None),
]
# the speculative phase: bench_spec_decode's legs (bench/suite.py:1380-1495)
# as (B, prompt, new tokens, gamma, max_len), and bench_spec_decode_
# distilled's (:1498-1620)
SPEC_SHAPE = (8, 256, 24, 4, 1024)
SPEC_DISTILL = {"sub": 1024, "det_p": 0.9, "train_steps": 300,
                "train_shape": (16, 129), "distill_steps": 600,
                "n_prompts": 64, "prompt_len": 32, "prompt": 256, "new": 128,
                "max_len": 512, "window": 128, "gammas": (12, 16, 20)}
# the seq2seq phase: JAX's default depths at the flagship's widths, (B,
# L_src, L_tgt), Adam at models/seq2seq.py's default lr 3e-3
SEQ2SEQ_SHAPE = (8, 1024, 256)
SEQ2SEQ_STEPS = 10


class PhaseError(RuntimeError):
    pass


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def phase_device(torch):
    _require(torch.cuda.is_available(), "no CUDA device is visible")
    _require(torch.cuda.device_count() >= 1, "no CUDA device")
    cap = torch.cuda.get_device_capability(0)
    _require(cap == (9, 0), f"compute capability {cap}, need (9, 0)")
    smi = card_line()
    print(f"phase device: ok {smi}, capability {cap}, "
          f"torch {torch.__version__}, cuda {torch.version.cuda}")
    return smi


def phase_build(kernels):
    t0 = time.perf_counter()
    lib = kernels.build()
    kernels.library()
    dt = time.perf_counter() - t0
    # registers, spills, and the notes where ptxas serializes wgmma
    # (C7510-C7520, "Potential Performance Loss")
    report = [ln.strip() for ln in kernels.ptxas_report().splitlines()
              if "Compiling entry" in ln or "Used" in ln or "spill" in ln
              or "(C75" in ln]
    for ln in report:
        print(f"  ptxas: {ln}")
    print(f"phase build: ok {lib.relative_to(ROOT)} in {dt:.1f} s; nvcc "
          f"seconds by source (all at once): {kernels.nvcc_seconds()}")
    check_sass(kernels)
    check_registers(kernels)
    return h5_clusters(kernels)


# the wgmma kernels' functions in the SASS: H1 (D 32, 64, 128, 256 x Q
# tiles of 64 and 128 rows x the exact and bound statistics), H4-int8
# (D 64, 128, 256 x pv_mode x rows by TMA, or copied at d % 16 != 0,
# PACKED), H4-kvq (D 64, 128, 256 x int8, e4m3 x the same), H5 (d 128,
# 256, 384, 512 x bf16, int8, e4m3; its cluster instances, 1 to 4 chunks
# a block x the same kinds x rows by TMA, or copied where TMA cannot
# describe them, STAGED), H3-dkv and H3-dq (D 32, 64, 128, 256, and the
# exact forms of 64 and 128, whose d is a constant; their staged forms of
# D 32, 64, 128, 256 for rows TMA cannot describe, bf16 d % 8 != 0),
# H6-extend (D 64, 128, 256 x codes by TMA, or by bulk copy where d % 16
# != 0); past d 256 H1 on H5's block (3 or 4 chunks x the exact and bound
# statistics x rows by TMA or STAGED) and H6-extend (3 or 4 chunks x codes
# by TMA or PACKED), and at f32 on H5's f32 block in clusters of two (H1:
# the exact and bound statistics x rows by TMA or STAGED; H6-extend: codes
# by TMA or PACKED)
WGMMA_FUNCTIONS = {"prefill_attention_kernel": 16,
                   "prefill_attention_wide_kernel": 8,
                   "paged_extend_wide_kernel": 4,
                   "prefill_attention_wide_f32_kernel": 4,
                   "paged_extend_wide_f32_kernel": 2,
                   "int8_attention_kernel": 12,
                   "kvquant_attention_kernel": 12,
                   "dtiled_attention_kernel": 12,
                   "dtiled_attention_cluster_kernel": 24,
                   # at f32: H4-kvq D 64, 128, 256 x int8, e4m3; H5 one
                   # and two chunks a block x f32, int8, e4m3 K/V x rows
                   # by TMA or STAGED
                   "kvquant_attention_f32_kernel": 6,
                   "dtiled_attention_f32_kernel": 12,
                   "attention_bwd_dkv_kernel": 10,
                   "attention_bwd_dq_kernel": 10,
                   "paged_extend_kernel": 6,
                   # the f32 core (bf16x6 / bf16x3): D 64/128/256, H1's
                   # exact and bound statistics
                   "prefill_attention_f32_kernel": 6,
                   "paged_extend_f32_kernel": 3,
                   # H3 at f32 (bf16x6): D 64, 128 and 256 (a cluster
                   # of two blocks)
                   "attention_bwd_dkv_f32_kernel": 3,
                   "attention_bwd_dq_f32_kernel": 3}
# H2: one instance per d, 16 to 512 by 16, and d off the multiples of 16
# read at run time on the instances of 16, 32, 64, 128, 256 and 512 lanes'
# rows, 16-byte loads where d % 4 == 0 and a float at a time else
# (``Lb1ELb1E``)
H2_FUNCTIONS = 32 + 6 + 6


MMA_OPS = re.compile(r"\b(HGMMA|IGMMA|HMMA|IMMA)\b")


def check_sass(kernels):
    """H1, H3, H4-int8, H4-kvq, H5 and H6-extend run on wgmma: HGMMA in
    every H1, H3, H4-kvq, H5 and H6-extend function and in the pv_mode bf16
    H4-int8 ones (second template argument false, ``ILi64ELb0E``), IGMMA
    in every
    H4-int8 function, no HMMA or IMMA in any of them.  H2 (every d of the
    rule) reads its partials with 128-bit global loads (``LDG.E.128``,
    with any cache modifiers) in every function but those of rows that are
    no multiple of 16 bytes."""
    sass = kernels.sass_by_function()
    h2 = {n: len(re.findall(r"\bLDG\.E(?:\.\w+)*?\.128\b", t))
          for n, t in sass.items() if "splitkv_combine_kernel" in n}
    print(f"  sass: splitkv_combine_kernel 128-bit loads: "
          + ", ".join(f"{n.split('splitkv_combine_kernel')[1][:16]} {c}"
                      for n, c in h2.items()))
    _require(len(h2) == H2_FUNCTIONS
             and all(c for n, c in h2.items() if "Lb1ELb1E" not in n),
             f"H2's functions lack 128-bit global loads: {h2}")
    found = dict.fromkeys(WGMMA_FUNCTIONS, 0)
    for name, text in sass.items():
        kind = next((k for k in found if k in name), None)
        if kind is None:
            continue
        found[kind] += 1
        counts = dict.fromkeys(("HGMMA", "IGMMA", "HMMA", "IMMA"), 0)
        for op in MMA_OPS.findall(text):
            counts[op] += 1
        print(f"  sass: {kind} {name.split(kind)[1][:12]}: {counts}")
        bf16_pv = re.search(r"int8_attention_kernelILi\d+ELb0E", name)
        need = (["IGMMA"] + (["HGMMA"] if bf16_pv else [])
                if kind.startswith("int8") else ["HGMMA"])
        _require(all(counts[op] > 0 for op in need),
                 f"{name}: no {need} in its SASS")
        _require(counts["HMMA"] == counts["IMMA"] == 0,
                 f"{name}: mma.sync / WMMA instructions in its SASS")
    _require(found == WGMMA_FUNCTIONS, f"kernel functions in the SASS: {found}")
    print("phase sass: ok")


# H6-decode's fused instances, what paged_decode_attention runs: D 32, 64,
# 128 (groups of 1, 2, 4, 8), 256 (1, 2, 4) and 512 (1, 2) x the tuned bf16
# form of d = D, the general bf16 and f32 forms, and the general bf16 and
# f32 forms of d off the multiples of 16 (ODD).  Its instances without the
# merge
# (paged_decode_partials, for the tests and the two-launch timing) are
# reported and not held: ptxas leaves 8-16 bytes of stack in a few of
# them, whatever their code
PAGED_DECODE_FUNCTIONS = (3 * 4 + 3 + 2) * 5
NOT_HELD = re.compile(r"paged_decode_kernelILi\d+ELi\d+ELb0E")
# the kernels whose every instance must hold its accumulators in
# registers: the serving kernels H1 (bf16: D 32/64/128/256 x Q tiles x
# statistics, whose producer runs the staged loads of rows TMA cannot
# describe on 24 registers a thread), H2, H6-decode and H6-extend (bf16), the
# f32 core's (csrc/f32_attention.cuh: H1 D 64/128/256 x the
# exact and bound statistics, H6-extend D 64/128/256, H4-kvq D 64/128/256
# x int8, e4m3), H5's three families (WGMMA_FUNCTIONS), and H4-kvq's and
# H4-int8's bf16 / int8 instances (D 64/128/256 x int8, e4m3 or x
# pv_mode x rows by TMA or PACKED; O 128 registers a consumer thread at
# D=256), and H3-dkv's and
# H3-dq's (WGMMA_FUNCTIONS: dK + dV 128 registers a consumer thread, the
# staged producers on 24 and, H3-dkv's, 40; at f32 the 255 of a thread)
NO_SPILL_FUNCTIONS = {"prefill_attention_kernel": 16,
                      "prefill_attention_wide_kernel": 8,
                      "paged_extend_wide_kernel": 4,
                      "prefill_attention_wide_f32_kernel": 4,
                      "paged_extend_wide_f32_kernel": 2,
                      "attention_bwd_dkv_kernel": 10,
                      "attention_bwd_dq_kernel": 10,
                      "attention_bwd_dkv_f32_kernel": 3,
                      "attention_bwd_dq_f32_kernel": 3,
                      "paged_extend_kernel": 6,
                      "splitkv_combine_kernel": H2_FUNCTIONS,
                      "paged_decode_kernel": PAGED_DECODE_FUNCTIONS,
                      "prefill_attention_f32_kernel": 6,
                      "paged_extend_f32_kernel": 3,
                      "kvquant_attention_f32_kernel": 6,
                      "kvquant_attention_kernel": 12,
                      "int8_attention_kernel": 12,
                      "dtiled_attention_kernel": 12,
                      "dtiled_attention_cluster_kernel": 24,
                      "dtiled_attention_f32_kernel": 12}


# ptxas serializes some wgmma of H3's f32 instances (its C7517 / C7519
# notes, in the parent tree's build too): they are held for spills only
SERIAL_NOT_HELD = ("attention_bwd_dkv_f32_kernel",
                   "attention_bwd_dq_f32_kernel")


def check_registers(kernels):
    """Every instance of the serving kernels (H1, H2, H6-decode and
    H6-extend) holds its state in registers; every instance of the f32
    core holds O, its fresh P V accumulator
    and P's fragments in registers, every H5 instance its O chunks, S and
    (f32) fresh P V, every H4-kvq and H4-int8 instance O, S or its
    run's part and P, and every H3-dkv and H3-dq instance (bf16 and f32)
    dK and dV (dQ), S and dP: no spill (cuobjdump -res-usage: 0 STACK and
    LOCAL bytes, where spills land) and no wgmma serialized by ptxas (its
    C75xx notes name no such function, SERIAL_NOT_HELD apart)."""
    serial = [ln for ln in kernels.ptxas_report().splitlines()
              if "(C75" in ln and any(f in ln for f in NO_SPILL_FUNCTIONS)
              and not any(f in ln for f in SERIAL_NOT_HELD)]
    found = dict.fromkeys(NO_SPILL_FUNCTIONS, 0)
    for name, u in sorted(kernels.res_usage().items()):
        kind = next((f for f in NO_SPILL_FUNCTIONS if f in name), None)
        if NOT_HELD.search(name):
            print(f"  res-usage (not held): {name.split('kernel')[1][:24]}: "
                  f"REG {u.get('REG')} STACK {u.get('STACK')} LOCAL "
                  f"{u.get('LOCAL')}")
            continue
        if kind is None:
            continue
        found[kind] += 1
        print(f"  res-usage: {kind} {name.split(kind)[1][:16]}: REG "
              f"{u.get('REG')} STACK {u.get('STACK')} LOCAL {u.get('LOCAL')}")
        _require(u.get("STACK") == 0 and u.get("LOCAL") == 0,
                 f"{name} spills")
    _require(found == NO_SPILL_FUNCTIONS,
             f"serving, f32 core, H3, H4 and H5 functions in the build: "
             f"{found}")
    _require(not serial, f"ptxas serializes wgmma: {serial}")
    print("phase registers: ok")


# a head dim of each cluster size of H5's plan (h5_plan): bf16 and
# quantized C = 2 (d 640, 1024) and 4 (1152, 2048); f32 C = 2 (384, 512),
# 4 (640, 1024) and 8 (1152, 2048)
H5_CLUSTER_DIMS = {False: (640, 1024, 1152, 2048),
                   True: (384, 512, 640, 1024, 1152, 2048)}


def h5_clusters(kernels):
    """cudaOccupancyMaxActiveClusters of every cluster instance of H5 a
    head dim of H5_CLUSTER_DIMS launches, by K/V kind: each must be
    positive (a launch the card refuses raises in the wrapper)."""
    from exploring_flash_attention_tpu_torch.ops.attention_v1_dtiled import (
        h5_plan,
    )

    lib, out = kernels.library(), {}
    for f32, dims in H5_CLUSTER_DIMS.items():
        for d in dims:
            c, nc = h5_plan(d, f32)
            n = [lib.eft_dtiled_clusters(d, int(f32), kind, 0)
                 for kind in (0, 1, 2)]
            key = f"{'f32 ' if f32 else ''}d={d} C={c} NC={nc}"
            print(f"  H5 clusters active at once, {key} (bf16 or f32, "
                  f"int8, e4m3 K/V): {n}")
            _require(all(x > 0 for x in n), f"H5 {key}: clusters {n}")
            out[key] = n
    print("phase H5 clusters: ok")
    return out


def _bf16(torch, dev, gen, *shape):
    return torch.randn(*shape, generator=gen).to(dev, torch.bfloat16)


def phase_h1(torch, dev):
    from exploring_flash_attention_tpu_torch.oracle import naive_attention
    from exploring_flash_attention_tpu_torch.ops.attention import (
        attention_plain,
        prefill_attention,
    )

    gen = torch.Generator().manual_seed(0)
    main_err = None             # vs plain, at the main path's shape
    for b, hq, hkv, lq, lkv, d in [(8, 8, 4, 256, 256, 128),
                                   (8, 8, 4, 200, 216, 128)]:
        q = _bf16(torch, dev, gen, b, hq, lq, d)
        k = _bf16(torch, dev, gen, b, hkv, lkv, d)
        v = _bf16(torch, dev, gen, b, hkv, lkv, d)
        scale = 1.0 / math.sqrt(d)
        o, lse = prefill_attention(q, k, v, scale, lkv - lq)
        torch.cuda.synchronize()
        o_ref, lse_ref = attention_plain(q, k, v, scale, True, lkv - lq)
        e_o = (o.float() - o_ref).abs().max().item()
        e_lse = (lse - lse_ref).abs().max().item()
        g = hq // hkv
        oracle = naive_attention(q, k.repeat_interleave(g, 1),
                                 v.repeat_interleave(g, 1), causal=True)
        e_or = float(np.abs(o.float().cpu().numpy() - oracle).max())
        # control: the plain version with each row's diagonal key hidden
        o_bad, _ = attention_plain(q, k, v, scale, True, lkv - lq - 1)
        e_bad = (o.float() - o_bad).abs().max().item()
        print(f"  h1 B={b} Hq={hq} Hkv={hkv} Lq={lq} Lkv={lkv} d={d}: "
              f"max|dO| vs plain {e_o:.3e} (tol {H1_O_TOL:g}), "
              f"max|dLSE| {e_lse:.3e} (tol {H1_LSE_TOL:g}), "
              f"max|dO| vs f64 oracle {e_or:.3e} (tol {H1_O_TOL:g}), "
              f"control (diagonal key hidden) {e_bad:.3e}")
        _require(torch.isfinite(o.float()).all().item(), "H1 O not finite")
        _require(e_o < H1_O_TOL and e_lse < H1_LSE_TOL and e_or < H1_O_TOL,
                 "H1 outside tolerance")
        _require(e_bad > H1_O_TOL, "H1 tolerance cannot tell a wrong mask")
        if main_err is None:
            main_err = e_o
    print("phase h1: ok")
    return main_err


def roofline(flop: float, nbytes: float, peak: float = H100_BF16_FLOPS):
    """(bound_ms, bound_by): the least time the H100 could take, the larger
    of the operations over their peak (bf16 tensor cores unless said) and
    the bytes over HBM's rate."""
    t_op = flop / peak * 1e3
    t_mem = nbytes / H100_HBM_BYTES_S * 1e3
    return (t_op, "operations") if t_op >= t_mem else (t_mem, "bytes")


def visible_pairs(lq: int, lkv: int, causal: bool, window) -> int:
    """The (q row, key) pairs that attention needs under the decode
    convention: every pair, the causal ones, or those inside the band."""
    if not causal:
        return lq * lkv
    last = np.arange(lq) + lkv - lq                # each row's last key
    first = np.zeros(lq) if window is None else last - window + 1
    return int((np.minimum(last, lkv - 1) - np.maximum(first, 0) + 1)
               .clip(min=0).sum())


# make_qkv's f32 arrays by their arguments, newest last, kept while they
# fit QKV_CACHE_BYTES: the phases draw the same inputs again (the
# canonical shape in five phases, the dtiled cases in two), and numpy
# draws about 100 M values a second on the host
QKV_CACHE: dict = {}
QKV_CACHE_BYTES = 8 << 30


def cached_qkv(b, hq, hkv, lq, lkv, d, seed):
    """make_qkv(b, hq, lq, d, seed=seed, seq_len_kv=lkv, heads_kv=hkv),
    drawn once while it stays in QKV_CACHE (the arrays are read only)."""
    from exploring_flash_attention_tpu_torch.oracle import make_qkv

    key = (b, hq, hkv, lq, lkv, d, seed)
    out = QKV_CACHE.pop(key, None)
    if out is None:
        out = make_qkv(b, hq, lq, d, seed=seed, seq_len_kv=lkv, heads_kv=hkv)
    QKV_CACHE[key] = out
    while sum(x.nbytes for t in QKV_CACHE.values() for x in t) > \
            QKV_CACHE_BYTES and len(QKV_CACHE) > 1:
        del QKV_CACHE[next(iter(QKV_CACHE))]
    return out


def v1_inputs(torch, dev, b, hq, hkv, lq, lkv, d, seed):
    """Standard-normal q, k, v from np.random.default_rng(seed), rounded to
    bf16 on the card, as bench.py makes its inputs."""
    return [torch.from_numpy(x).to(dev, torch.bfloat16)
            for x in cached_qkv(b, hq, hkv, lq, lkv, d, seed)]


def v1_readings(torch, q, k, v, o, lse, causal, window, nb, nh):
    """One v1 check: max|dO| (and max|dLSE|, with lse) of the kernel's f32
    output vs the plain version over the whole tensor and vs the f64
    oracle over [:nb, :nh]; and two known-wrong controls vs the oracle on
    that slice: the plain version with the scale off by 10%, and with the
    last 64-key tile dropped."""
    from exploring_flash_attention_tpu_torch.oracle import naive_attention
    from exploring_flash_attention_tpu_torch.ops import attention_plain

    scale, diag = 1.0 / math.sqrt(q.shape[3]), k.shape[2] - q.shape[2]
    plain, lse_plain = attention_plain(q, k, v, scale, causal, diag, window)
    r = {"plain": (o - plain).abs().max().item()}
    del plain
    heads = torch.tensor([h * k.shape[1] // q.shape[1] for h in range(nh)],
                         device=q.device)
    qs, ks, vs = q[:nb, :nh], k[:nb, heads], v[:nb, heads]
    o64, lse64 = naive_attention(qs, ks, vs, causal=causal, window=window,
                                 return_lse=True)
    r["oracle"] = float(np.abs(o[:nb, :nh].cpu().numpy() - o64).max())
    bad, _ = attention_plain(qs, ks, vs, 1.1 * scale, causal, diag, window)
    r["scale"] = float(np.abs(bad.cpu().numpy() - o64).max())
    bad, _ = attention_plain(qs, ks[:, :, :-64], vs[:, :, :-64], scale,
                             causal, diag, window)
    r["drop"] = float(np.abs(bad.cpu().numpy() - o64).max())
    if lse is not None:
        fin = torch.isfinite(lse_plain)
        _require(torch.equal(torch.isfinite(lse), fin), "H1 LSE not finite "
                 "where the plain version's is")
        r["lse_plain"] = (lse - lse_plain)[fin].abs().max().item()
        r["lse_oracle"] = float(np.abs(lse[:nb, :nh].cpu().numpy()
                                       - lse64).max())
    _require(torch.isfinite(o).all().item(), "O not finite")
    return r


def v1_check(r, tol, what):
    """The readings within ``tol``, both controls beyond it."""
    _require(max(r["plain"], r["oracle"]) < tol, f"{what} outside tolerance")
    _require(min(r["scale"], r["drop"]) > tol,
             f"the check cannot tell a wrong path ({what})")


def counted_call(torch, fn, want):
    """Run fn with every counter zeroed; the launches must be ``want``."""
    zero_counters()
    out = fn()
    torch.cuda.synchronize()
    got = read_counters()
    _require(got == want, f"launches {got}, expected {want}")
    return out


def phase_v1(torch, dev):
    """flash_attention_v1, the dense forward, through its user entry
    points on H1 (and H2 where the KV is split): bench.py's gate at the
    canonical shape, one case per JAX route, H1 against the plain version
    and scaled_dot_product_attention's time, the window's loop bounds, and
    the split's spans."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from exploring_flash_attention_tpu_torch.ops import (
        attention_plain,
        flash_attention_v1,
        flash_attention_v1_window_partial,
    )
    from exploring_flash_attention_tpu_torch.ops.attention_v1 import (
        split_kv_span,
    )
    from exploring_flash_attention_tpu_torch.utils import time_cuda

    b, h, l, d = V1_CANON
    q, k, v = v1_inputs(torch, dev, b, h, h, l, l, d, seed=1)
    # the main path: one call at the canonical shape, counters read
    zero_counters()
    o = flash_attention_v1(q, k, v, out_dtype=torch.float32)
    torch.cuda.synchronize()
    launches = read_counters()
    _require(launches == launches_only(h1=1),
             f"v1 launches {launches}, expected one H1")
    r = v1_readings(torch, q, k, v, o, None, False, None, 2, 2)
    print(f"  v1 gate B={b} H={h} L={l} d={d} bf16 in, f32 out (bench.py's "
          f"route B1): max|dO| on [:2, :2] vs f64 oracle {r['oracle']:.3e} "
          f"(bench.py's limit {V1_GATE_TOL:g}); whole tensor vs plain "
          f"{r['plain']:.3e} (tol {V1_O_TOL:g}); controls vs f64 oracle: "
          f"scale off by 10% {r['scale']:.3e}, last 64-key tile dropped "
          f"{r['drop']:.3e}; launches {launches}")
    _require(r["oracle"] <= V1_GATE_TOL, "H1 fails bench.py's gate")
    _require(r["plain"] < V1_O_TOL, "H1 differs from the plain version")
    _require(min(r["scale"], r["drop"]) > V1_GATE_TOL,
             "the gate cannot tell a wrong path")
    gate_err = r["plain"]
    del o

    scale = 1.0 / math.sqrt(d)
    t = {"ms": time_cuda(lambda: flash_attention_v1(q, k, v), n_iter=20),
         "plain_ms": time_cuda(lambda: attention_plain(q, k, v, scale, False),
                               n_iter=5, n_warmup=1),
         "library_ms": time_cuda(lambda: sdpa(q, k, v), n_iter=20)}
    flop = 4 * b * h * l * l * d
    t["bound_ms"], t["bound_by"] = roofline(flop, 4 * b * h * l * d * 2)
    t["tflops"] = flop / t["ms"] / 1e9
    print(f"  v1 times at B={b} H={h} L={l} d={d} bf16 (CUDA events, "
          f"median, L2 flushed): H1 {t['ms']:.4f} ms = "
          f"{flop / t['ms'] / 1e9:.1f} TFLOP/s ({flop / 1e9:.1f} GFLOP); "
          f"plain {t['plain_ms']:.4f} ms; scaled_dot_product_attention "
          f"{t['library_ms']:.4f} ms; bound {t['bound_ms']:.4f} ms "
          f"({t['bound_by']})")
    del q, k, v

    h2 = None
    for i, (route, b, hq, hkv, lq, lkv, d, causal, window, nh) in enumerate(
            V1_CASES):
        q, k, v = v1_inputs(torch, dev, b, hq, hkv, lq, lkv, d, seed=2 + i)
        span = None if causal else split_kv_span(b, hq, lq, lkv)
        _require((span is not None) == (route == V1_SPLIT_ROUTE),
                 f"{route}: KV span {span}")
        want = launches_only(h1=1, h2=int(span is not None))
        o = counted_call(torch, lambda: flash_attention_v1(
            q, k, v, causal=causal, window=window, out_dtype=torch.float32),
            want)
        tol = V1_O_TOL if window is None else V1_WINDOW_O_TOL
        r = v1_readings(torch, q, k, v, o, None, causal, window, 1, nh)
        print(f"  v1 {route}: B={b} Hq={hq} Hkv={hkv} Lq={lq} Lkv={lkv} "
              f"d={d} causal={causal} window={window} KV span {span}: "
              f"max|dO| vs plain {r['plain']:.3e}, vs f64 oracle on "
              f"[:1, :{nh}] {r['oracle']:.3e} (tol {tol:g}); controls: "
              f"scale off by 10% {r['scale']:.3e}, last 64-key tile "
              f"dropped {r['drop']:.3e}; launches {want}")
        v1_check(r, tol, route)
        del o
        ms = time_cuda(lambda: flash_attention_v1(
            q, k, v, causal=causal, window=window), n_iter=10)
        ms_plain = time_cuda(lambda: attention_plain(
            q, k, v, 1.0 / math.sqrt(d), causal, lkv - lq, window),
            n_iter=3, n_warmup=1)
        flop = 4 * b * hq * d * visible_pairs(lq, lkv, causal, window)
        # SDPA masks causal top-left, which is H1's diagonal only where
        # Lq == Lkv; a window is a boolean band mask there
        lib = ""
        mask = None
        if window is not None and lq == lkv:
            i = torch.arange(lq, device=dev)
            mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None]
                                                  - window)
        if not causal or mask is not None:
            ms_lib = time_cuda(lambda: sdpa(q, k, v, attn_mask=mask,
                                            enable_gqa=hq != hkv), n_iter=10)
            lib = f"; scaled_dot_product_attention {ms_lib:.4f} ms"
            if mask is not None:
                lib += " (a boolean band mask)"
                t["library_ms_by_case"] = {"B5 window": ms_lib}
        elif lq != lkv:
            lib = ("; SDPA's is_causal masks top-left, not H1's diagonal at "
                   "Lq != Lkv: its library time (an explicit bottom-right "
                   "mask) is in the times line")
        del mask
        bound = roofline(flop, 2 * d * 2 * (b * hq * lq + b * hkv * lkv))
        print(f"  v1 time of that call (bf16 O): {ms:.4f} ms = "
              f"{flop / ms / 1e9:.1f} TFLOP/s of the visible work "
              f"({flop / 1e9:.2f} GFLOP), bound {bound[0]:.4f} ms "
              f"({bound[1]}); plain {ms_plain:.4f} ms{lib}")
        if span is not None:
            h2 = split_timings(torch, q, k, v, span, want)
        if window is None:
            continue
        o, lse = counted_call(torch, lambda: flash_attention_v1_window_partial(
            q, k, v, window), launches_only(h1=1))
        r = v1_readings(torch, q, k, v, o, lse, True, window, 1, nh)
        print(f"  v1 flash_attention_v1_window_partial, same shape (B5 with "
              f"LSE): max|dO| vs plain {r['plain']:.3e}, vs f64 oracle "
              f"{r['oracle']:.3e} (tol {tol:g}); max|dLSE| vs plain "
              f"{r['lse_plain']:.3e}, vs f64 oracle {r['lse_oracle']:.3e} "
              f"(tol {H1_LSE_TOL:g}); controls {r['scale']:.3e}, "
              f"{r['drop']:.3e}; one H1 launch")
        v1_check(r, tol, "window partial")
        _require(max(r["lse_plain"], r["lse_oracle"]) < H1_LSE_TOL,
                 "the window partial's LSE is outside tolerance")
        del o, lse
        t_win = time_cuda(lambda: flash_attention_v1(
            q, k, v, causal=True, window=window), n_iter=10)
        t_causal = time_cuda(lambda: flash_attention_v1(q, k, v, causal=True),
                             n_iter=10)
        print(f"  v1 window {window} vs causal at B={b} Hq={hq} Hkv={hkv} "
              f"L={lq} d={d}: {t_win:.4f} ms vs {t_causal:.4f} ms, ratio "
              f"{t_win / t_causal:.3f} (must be < 0.5: tiles outside the "
              f"band are skipped)")
        _require(t_win < 0.5 * t_causal,
                 "the window call does not skip the tiles outside its band")
    _require(h2 is not None, "no v1 case ran the split-KV pair")
    print("phase v1: ok")
    return launches, gate_err, t, h2


def phase_v2(torch, dev):
    """The split-KV V2 API, the reference's third tier, at the JAX suite's
    bench_splitkv entry (bench/suite.py:345-360: B=32, H=8, L=1024,
    d=128, SplitKVConfig(block_q=1024, block_kv=512, kv_tiles_per_block=1),
    inputs as bench.py makes them), non-causal and causal:
    flash_attention_v2 (one H1 launch over the KV spans, one H2 launch,
    counters zeroed before and read after) against the plain version and
    the f64 oracle, beside the v1 phase's controls and a further one (the
    kernel's own partials merged with one span's LSE set to -inf);
    flash_attention_splitkv_partial's partials in JAX's shape (nkb = 2);
    times of the call, H1's spans and H2 beside
    scaled_dot_product_attention."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from exploring_flash_attention_tpu_torch import SplitKVConfig
    from exploring_flash_attention_tpu_torch.oracle import naive_attention
    from exploring_flash_attention_tpu_torch.ops import (
        attention_plain,
        flash_attention_splitkv_partial,
        flash_attention_v2,
        splitkv_combine,
        splitkv_combine_plain,
    )
    from exploring_flash_attention_tpu_torch.utils import time_cuda

    b, h, l, d = V2_SHAPE
    cfg = SplitKVConfig(**V2_CONFIG)
    q, k, v = v1_inputs(torch, dev, b, h, h, l, l, d, seed=1)
    scale = 1.0 / math.sqrt(d)
    out, launches = {}, {}
    for causal in (False, True):
        mask = "causal" if causal else "none"
        # causal rows near the top see a handful of keys, |O| up to ~3:
        # the window cases' limit, for the same reason
        tol = V1_WINDOW_O_TOL if causal else V1_O_TOL
        zero_counters()
        o = flash_attention_v2(q, k, v, config=cfg, causal=causal,
                               out_dtype=torch.float32)
        torch.cuda.synchronize()
        launches[mask] = read_counters()
        _require(launches[mask] == launches_only(h1=1, h2=1),
                 f"v2 {mask} launches {launches[mask]}, expected H1 1, H2 1")
        r = v1_readings(torch, q, k, v, o, None, causal, None, 2, 2)
        o_p, lse = flash_attention_splitkv_partial(q, k, v, config=cfg,
                                                   causal=causal)
        _require(o_p.shape == (b, h, V2_NKB, l, d)
                 and lse.shape == (b, h, V2_NKB, l),
                 f"partials {tuple(o_p.shape)}, {tuple(lse.shape)}: JAX's "
                 f"nkb is {V2_NKB}")
        e_merge = (splitkv_combine(o_p, lse, out_dtype=torch.float32) - o).abs().max()
        # control: the last span's keys lost in the merge
        lse_bad = lse.clone()
        lse_bad[:2, :2, -1] = float("-inf")
        bad = splitkv_combine_plain(o_p[:2, :2], lse_bad[:2, :2])
        o64 = naive_attention(q[:2, :2], k[:2, :2], v[:2, :2], causal=causal)
        r["span"] = float(np.abs(bad.cpu().numpy() - o64).max())
        dead = torch.isneginf(lse)
        if causal:          # q rows 0..511 see nothing of the second span
            _require(bool(dead[:, :, 1, :l // 2].all())
                     and not dead[:, :, 1, l // 2:].any()
                     and not dead[:, :, 0].any()
                     and bool((o_p[:, :, 1, :l // 2] == 0).all()),
                     "a causal span above the diagonal is not (0, -inf)")
        else:
            _require(not dead.any(), "a non-causal span LSE is -inf")
        print(f"  v2 bench_splitkv {mask}: B={b} H={h} L={l} d={d}, "
              f"{V2_NKB} spans of {cfg.kv_span(l)} keys, f32 O: max|dO| vs "
              f"plain {r['plain']:.3e}, vs f64 oracle on [:2, :2] "
              f"{r['oracle']:.3e} (tol {tol:g}); the partials merged "
              f"again vs the call {e_merge.item():.3e}; controls vs oracle: "
              f"scale off by 10% {r['scale']:.3e}, last 64-key tile dropped "
              f"{r['drop']:.3e}, last span's LSE -inf {r['span']:.3e}; "
              f"launches {launches[mask]}")
        _require(max(r["plain"], r["oracle"]) < tol,
                 f"v2 {mask} outside tolerance")
        _require(min(r["scale"], r["drop"], r["span"]) > tol,
                 f"the v2 check cannot tell a wrong path ({mask})")
        _require(e_merge.item() < H2_O_TOL, "the partials merge elsewhere")
        del o, o_p, lse, lse_bad, bad

        o_p, lse = flash_attention_splitkv_partial(q, k, v, config=cfg,
                                                   causal=causal)
        flop = 4 * b * h * d * visible_pairs(l, l, causal, None)
        t = {"max_abs_err": r["plain"],
             "ms": time_cuda(lambda: flash_attention_v2(
                 q, k, v, config=cfg, causal=causal), n_iter=20),
             "plain_ms": time_cuda(lambda: splitkv_combine_plain(
                 *attention_plain_spans(torch, q, k, v, scale, causal,
                                        cfg.kv_span(l))), n_iter=3,
                 n_warmup=1),
             "library_ms": time_cuda(lambda: sdpa(q, k, v, is_causal=causal),
                                     n_iter=20),
             "h1_spans_ms": time_cuda(lambda: flash_attention_splitkv_partial(
                 q, k, v, config=cfg, causal=causal), n_iter=20),
             "h2_ms": time_cuda(lambda: splitkv_combine(o_p, lse, out_dtype=q.dtype),
                                n_iter=20)}
        t["bound_ms"], t["bound_by"] = roofline(flop, 4 * b * h * l * d * 2)
        t["h2_bound_ms"] = merge_bound(V2_NKB, b * h * l, d)[0]
        print(f"  v2 times {mask} (CUDA events, median, L2 flushed): the "
              f"call {t['ms']:.4f} ms = {flop / t['ms'] / 1e9:.1f} TFLOP/s "
              f"(H1 over the spans {t['h1_spans_ms']:.4f} ms, H2 "
              f"{t['h2_ms']:.4f} ms, its bound {t['h2_bound_ms']:.4f} ms); "
              f"scaled_dot_product_attention {t['library_ms']:.4f} ms; "
              f"plain {t['plain_ms']:.4f} ms; bound {t['bound_ms']:.4f} ms "
              f"({t['bound_by']})")
        out[mask] = t
        del o_p, lse
    print("phase v2: ok")
    return launches, out


def attention_plain_spans(torch, q, k, v, scale, causal, span):
    """The plain version of flash_attention_splitkv_partial on the card:
    H1's plain version over each span, f32 partials."""
    from exploring_flash_attention_tpu_torch.ops import attention_plain

    lq, lkv = q.shape[2], k.shape[2]
    parts = [attention_plain(q, k[:, :, s:s + span], v[:, :, s:s + span],
                             scale, causal, lkv - lq - s)
             for s in range(0, lkv, span)]
    return (torch.stack([p[0] for p in parts], dim=2),
            torch.stack([p[1] for p in parts], dim=2))


def merge_bound(nkb, rows, d):
    """H2's bound for ``rows`` rows of ``nkb`` f32 partials into bf16 O:
    an FMA per partial element and an exp per partial, f32 outside the
    tensor cores; each partial and LSE read once, O written once."""
    return roofline(nkb * rows * (2 * d + 1),
                    nkb * rows * (d + 1) * 4 + rows * d * 2, H100_F32_FLOPS)


def split_timings(torch, q, k, v, span, want):
    """At the split case: H2 against its plain version on H1's span
    partials (error, times, bound), then the whole call at several span
    counts, one span (H1 alone) first."""
    from exploring_flash_attention_tpu_torch.configs import cdiv
    from exploring_flash_attention_tpu_torch.ops import (
        prefill_attention,
        splitkv_combine,
        splitkv_combine_plain,
    )
    from exploring_flash_attention_tpu_torch.ops.attention import H1_KV_TILE
    from exploring_flash_attention_tpu_torch.utils import time_cuda

    b, hq, lq, d = q.shape
    lkv = k.shape[2]
    scale = 1.0 / math.sqrt(d)
    o_part, lse = prefill_attention(q, k, v, scale, 0, False, kv_span=span,
                                    out_dtype=torch.float32)
    nkb = o_part.shape[2]
    got = splitkv_combine(o_part, lse, out_dtype=torch.float32)
    err = (got - splitkv_combine_plain(o_part, lse)).abs().max().item()
    _require(err < H2_O_TOL, f"H2 differs from its plain version: {err:.3e}")
    rows = b * hq * lq
    h2 = {"launches": want["h2"], "max_abs_err": err,
          "ms": time_cuda(lambda: splitkv_combine(o_part, lse, out_dtype=q.dtype)),
          "plain_ms": time_cuda(lambda: splitkv_combine_plain(o_part, lse)),
          "library_ms": None}
    # its operations (an FMA per partial element, an exp per partial) are
    # f32 outside the tensor cores
    h2["bound_ms"], h2["bound_by"] = merge_bound(nkb, rows, d)
    h2["bound_share"] = h2["bound_ms"] / h2["ms"]
    # the same call on 8 rows: what a launch costs in this harness
    tiny = (torch.randn(1, 1, nkb, 8, d, device=q.device),
            torch.randn(1, 1, nkb, 8, device=q.device))
    h2["floor_ms"] = time_cuda(lambda: splitkv_combine(*tiny, out_dtype=q.dtype))
    spans = time_cuda(lambda: prefill_attention(
        q, k, v, scale, 0, False, kv_span=span, out_dtype=torch.float32),
        n_iter=10)
    sweep = []
    for n in SPLIT_SWEEP:
        sp = cdiv(cdiv(lkv, n), H1_KV_TILE) * H1_KV_TILE
        if n == 1:
            ms = time_cuda(lambda: prefill_attention(
                q, k, v, scale, 0, False, with_lse=False), n_iter=10)
        else:
            ms = time_cuda(lambda: splitkv_combine(*prefill_attention(
                q, k, v, scale, 0, False, kv_span=sp,
                out_dtype=torch.float32), out_dtype=q.dtype), n_iter=10)
        sweep.append(f"{n} span{'s' * (n > 1)} {ms:.4f} ms")
    print(f"  v1 split at B={b} Hq={hq} Lq={lq} Lkv={lkv} d={d}, {nkb} "
          f"spans of {span} keys: H2 vs its plain version {err:.3e} (tol "
          f"{H2_O_TOL:g}); H1 spans {spans:.4f} ms, H2 {h2['ms']:.4f} ms vs "
          f"plain {h2['plain_ms']:.4f} ms (bound {h2['bound_ms']:.4f} ms, "
          f"{h2['bound_by']}, {h2['bound_share']:.1%} of it; the same call "
          f"on 8 rows {h2['floor_ms']:.4f} ms); whole call (bf16 O) by span "
          f"count: "
          + ", ".join(sweep))
    return h2


def held(torch, what, o, plain, o64, bad, tol_plain, tol_oracle, nb, nh,
         note=""):
    """One check of the quant and dtiled phases: the kernel's f32 O vs the
    plain version over the whole tensor (within ``tol_plain``) and vs the
    f64 oracle on [:nb, :nh] (within ``tol_oracle``); every known-wrong
    control in ``bad`` (the plain version run wrongly on that slice) must
    read beyond both limits, vs the oracle and vs the plain version."""
    _require(torch.isfinite(o).all().item(), f"{what}: O not finite")
    e_plain = (o - plain).abs().max().item()
    e_oracle = float(np.abs(o[:nb, :nh].cpu().numpy() - o64).max())
    ps = plain[:nb, :nh].cpu().numpy()
    ctl = {name: (float(np.abs(x - o64).max()), float(np.abs(x - ps).max()))
           for name, x in bad.items()}
    print(f"  {what}: max|dO| vs plain {e_plain:.3e} (tol {tol_plain:g}), "
          f"vs f64 oracle on [:{nb}, :{nh}] {e_oracle:.3e} (tol "
          f"{tol_oracle:g}); controls vs oracle / plain: "
          + ", ".join(f"{n} {a:.3e} / {b:.3e}" for n, (a, b) in ctl.items())
          + note)
    _require(e_plain < tol_plain and e_oracle < tol_oracle,
             f"{what} outside tolerance")
    _require(all(a > tol_oracle and b > tol_plain for a, b in ctl.values()),
             f"the check cannot tell a wrong path ({what})")
    return e_plain


def gate_reading(what, o, o64, tol):
    """A suite gate: max|dO| of the whole f32 O vs the f64 oracle, <= tol
    as bench/suite.py:57 holds it."""
    err = float(np.abs(o.cpu().numpy() - o64).max())
    print(f"  {what}: max|dO| vs f64 oracle {err:.3e} (the suite's limit "
          f"{tol:g})")
    _require(err <= tol, f"{what} fails the suite's gate")
    return err


def rolled(qt):
    """The neighbouring block's scales: what a wrong scale index reads."""
    from exploring_flash_attention_tpu_torch.ops import QuantizedTensor

    return QuantizedTensor(qt.values, qt.scales.roll(1, dims=2), qt.block)


def dropped_tile(qt):
    """The quantized tensor without its last 64 keys (scales unchanged)."""
    from exploring_flash_attention_tpu_torch.ops import QuantizedTensor

    return QuantizedTensor(qt.values[:, :, :-64], qt.scales, qt.block)


def heads(qt, b0, b1, nh=None):
    """Batch rows [b0, b1) and the first ``nh`` heads of a quantized
    tensor, values and scales alike."""
    from exploring_flash_attention_tpu_torch.ops import QuantizedTensor

    return QuantizedTensor(qt.values[b0:b1, :nh], qt.scales[b0:b1, :nh],
                           qt.block)


def kernel_times(call, plain, library, flop_by_peak, nbytes,
                 n_iter=20):
    """CUDA-event medians (L2 flushed) of one entry-point call, its plain
    version and the library call (if any), and the bound: the operations
    at each type's peak, summed, against the bytes at HBM's rate."""
    from exploring_flash_attention_tpu_torch.utils import time_cuda

    t = {"ms": time_cuda(call, n_iter=n_iter),
         "plain_ms": time_cuda(plain, n_iter=3, n_warmup=1),
         "library_ms": library and time_cuda(library, n_iter=n_iter)}
    t_op = sum(f / peak for f, peak in flop_by_peak) * 1e3
    t_mem = nbytes / H100_HBM_BYTES_S * 1e3
    t["bound_ms"], t["bound_by"] = ((t_op, "operations") if t_op >= t_mem
                                    else (t_mem, "bytes"))
    return t


def phase_quant(torch, dev):
    """flash_attention_kvquant (H4-kvq) and flash_attention_int8 (H4-int8)
    through their entry points: the suite's gates at its gate inputs, one
    launch per call at the suite's shapes and the further JAX routes,
    each against the plain version and the f64 oracle beside its
    controls, and the times of the canonical calls; then the head dims of
    both kernels' rule, and past it H5's quantized form
    (:func:`quant_head_dims`)."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from exploring_flash_attention_tpu_torch.oracle import naive_attention
    from exploring_flash_attention_tpu_torch.ops import (
        attention_int8_plain,
        attention_kvquant_plain,
        dequantize,
        flash_attention_int8,
        flash_attention_kvquant,
        quantize_fp8,
        quantize_int8,
    )
    from exploring_flash_attention_tpu_torch.utils import time_cuda

    quant = {"int8": quantize_int8, "fp8": quantize_fp8}
    f32 = torch.float32
    gates = {}
    for kind in ("int8", "fp8"):        # bench/suite.py:375-383
        q, k, v = v1_inputs(torch, dev, 2, 4, 4, 512, 512, 128, seed=0)
        kq, vq = quant[kind](k, 512), quant[kind](v, 512)
        o = counted_call(torch, lambda: flash_attention_kvquant(
            q, kq, vq, out_dtype=f32), launches_only(h4kvq=1))
        gates[f"kvquant {kind}"] = gate_reading(
            f"quant kvquant {kind} gate (2, 4, 512, 128) block 512",
            o, naive_attention(q, dequantize(kq), dequantize(vq)),
            KVQ_GATE_TOL)
    for b, h, l, seed in ((2, 4, 512, 0), (1, 2, 512, 0)):   # :412, :1192
        q, k, v = v1_inputs(torch, dev, b, h, h, l, l, 128, seed=seed)
        qq, kq, vq = (quantize_int8(x, 512) for x in (q, k, v))
        o = counted_call(torch, lambda: flash_attention_int8(
            qq, kq, vq, out_dtype=f32), launches_only(h4int8=1))
        gates[f"int8 ({b}, {h})"] = gate_reading(
            f"quant int8 pv_mode bf16 gate ({b}, {h}, {l}, 128) "
            f"block 512", o,
            naive_attention(*(dequantize(x) for x in (qq, kq, vq))),
            INT8_GATE_TOL)
    del q, k, v, o

    kvq = {}
    for case, b, h, lq, lkv, d, kind, block, seed, nh in KVQ_CASES:
        q, k, v = v1_inputs(torch, dev, b, h, h, lq, lkv, d, seed=seed)
        kq, vq = quant[kind](k, block), quant[kind](v, block)
        del k, v
        o = counted_call(torch, lambda: flash_attention_kvquant(
            q, kq, vq, out_dtype=f32), launches_only(h4kvq=1))
        kvq.setdefault("launches", read_counters()["h4kvq"])
        scale = 1.0 / math.sqrt(d)
        qs, ks, vs = q[:1, :nh], heads(kq, 0, 1, nh), heads(vq, 0, 1, nh)
        bad = {"scale x1.1": attention_kvquant_plain(qs, ks, vs, 1.1 * scale),
               "last tile dropped": attention_kvquant_plain(
                   qs, dropped_tile(ks), dropped_tile(vs), scale)}
        if kq.scales.shape[2] > 1:
            bad["scales rolled"] = attention_kvquant_plain(
                qs, rolled(ks), rolled(vs), scale)
        err = held(torch, f"quant kvquant {case}: B={b} H={h} Lq={lq} "
                   f"Lkv={lkv} d={d} {kind} block {block}", o,
                   attention_kvquant_plain(q, kq, vq, scale),
                   naive_attention(qs, dequantize(ks), dequantize(vs)),
                   {n: x.cpu().numpy() for n, x in bad.items()},
                   KVQ_O_TOL, KVQ_O_TOL, 1, nh, "; one H4-kvq launch")
        if case.startswith("canonical"):
            qd, kd, vd = q, dequantize(kq, q.dtype), dequantize(vq, q.dtype)
            t = kernel_times(
                lambda: flash_attention_kvquant(q, kq, vq),
                lambda: attention_kvquant_plain(q, kq, vq, scale),
                lambda: sdpa(qd, kd, vd),
                [(4 * b * h * lq * lkv * d, H100_BF16_FLOPS)],
                2 * b * h * lq * d * 2 + 2 * b * h * lkv * d
                + 2 * kq.scales.numel() * 4)
            t["tflops"] = 4 * b * h * lq * lkv * d / t["ms"] / 1e9
            print(f"  quant kvquant {kind} times at B={b} H={h} L={lq} "
                  f"d={d}: H4-kvq {t['ms']:.4f} ms "
                  f"({t['tflops']:.1f} TFLOP/s), plain "
                  f"{t['plain_ms']:.4f} ms, scaled_dot_product_attention "
                  f"over the dequantized bf16 K/V {t['library_ms']:.4f} ms "
                  f"(the dequant not counted), bound {t['bound_ms']:.4f} ms "
                  f"({t['bound_by']})")
            kvq.setdefault("t", {})[kind] = t
        kvq.setdefault("err", err)
        del q, kq, vq, o

    int8 = {}
    for case, b, h, lq, lkv, d, block, modes, seed, nh, tols in INT8_CASES:
        q, k, v = v1_inputs(torch, dev, b, h, h, max(lq, lkv), max(lq, lkv),
                            d, seed=seed)
        q, k, v = q[:, :, :lq], k[:, :, :lkv], v[:, :, :lkv]
        qq, kq, vq = (quantize_int8(x, block) for x in (q, k, v))
        del k, v
        scale = 1.0 / math.sqrt(d)
        qs, ks, vs = (heads(x, 0, 1, nh) for x in (qq, kq, vq))
        o64 = naive_attention(*(dequantize(x) for x in (qs, ks, vs)))
        for mode in modes:
            o = counted_call(torch, lambda: flash_attention_int8(
                qq, kq, vq, out_dtype=f32, pv_mode=mode),
                launches_only(h4int8=1))
            int8.setdefault("launches", read_counters()["h4int8"])
            # the plain version one batch row at a time bounds its memory
            plain = torch.cat([attention_int8_plain(
                *(heads(x, i, i + 1) for x in (qq, kq, vq)), scale, mode)
                for i in range(b)])
            bad = {"scale x1.1": attention_int8_plain(qs, ks, vs, 1.1 * scale,
                                                      mode),
                   "last tile dropped": attention_int8_plain(
                       qs, dropped_tile(ks), dropped_tile(vs), scale, mode)}
            if kq.scales.shape[2] > 1:
                bad["scales rolled"] = attention_int8_plain(
                    qs, rolled(ks), rolled(vs), scale, mode)
            err = held(torch, f"quant int8 {case}: B={b} H={h} Lq={lq} "
                       f"Lkv={lkv} d={d} block {block} pv_mode {mode}", o,
                       plain, o64, {n: x.cpu().numpy() for n, x in bad.items()},
                       INT8_PLAIN_TOL, tols[mode], 1, nh,
                       "; one H4-int8 launch")
            int8.setdefault("err", err)
            del o, plain
            if not case.startswith(("canonical", "L=")):
                continue
            qd, kd, vd = (dequantize(x, q.dtype) for x in (qq, kq, vq))
            ops = 2 * b * h * lq * lkv * d
            pv_peak = H100_INT8_OPS if mode == "int8" else H100_BF16_FLOPS
            t = kernel_times(
                lambda: flash_attention_int8(qq, kq, vq, pv_mode=mode),
                lambda: [attention_int8_plain(
                    *(heads(x, i, i + 1) for x in (qq, kq, vq)), scale, mode)
                    for i in range(b)],
                lambda: sdpa(qd, kd, vd),
                [(ops, H100_INT8_OPS), (ops, pv_peak)],
                b * h * (lq + 2 * lkv) * d + b * h * lq * d * 2
                + 4 * (qq.scales.numel() + 2 * kq.scales.numel()))
            t["tops"] = 2 * ops / t["ms"] / 1e9
            t["ms_with_q_quant"] = time_cuda(lambda: flash_attention_int8(
                quantize_int8(q, block), kq, vq, pv_mode=mode), n_iter=20)
            print(f"  quant int8 {case} pv_mode {mode} times at B={b} H={h} "
                  f"L={lq} d={d}: H4-int8 {t['ms']:.4f} ms alone "
                  f"({t['tops']:.1f} TOP/s), "
                  f"{t['ms_with_q_quant']:.4f} ms with quantize_int8 of Q "
                  f"per call; plain {t['plain_ms']:.4f} ms; "
                  f"scaled_dot_product_attention over the dequantized bf16 "
                  f"Q/K/V {t['library_ms']:.4f} ms (the dequant not "
                  f"counted); bound {t['bound_ms']:.4f} ms ({t['bound_by']})")
            int8.setdefault("t", {})[f"{case} {mode}"] = t
            del qd, kd, vd
        del q, qq, kq, vq
    kvq["by_head_dim"], int8["by_head_dim"] = quant_head_dims(torch, dev)
    print(f"  quant on {card_line()}")
    print("phase quant: ok")
    return gates, kvq, int8


def quant_head_dims(torch, dev):
    """The quant phase's head-dim cases and times (QUANT_HEADS_DIMS and
    the constants beside it): ({"checks": ..., "times": ...} of
    flash_attention_kvquant, the same of flash_attention_int8), each check
    its max|dO| vs the plain version, vs the oracle and its controls'."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from exploring_flash_attention_tpu_torch.oracle import naive_attention
    from exploring_flash_attention_tpu_torch.ops import (
        attention_int8_plain,
        attention_kvquant_plain,
        dequantize,
        flash_attention_int8,
        flash_attention_kvquant,
        flash_attention_v1_dtiled,
        quantize_fp8,
        quantize_int8,
    )
    from exploring_flash_attention_tpu_torch.ops.attention import h4_instance
    from exploring_flash_attention_tpu_torch.utils import time_cuda

    t0 = time.perf_counter()
    quant = {"int8": quantize_int8, "fp8": quantize_fp8}
    f32 = torch.float32
    b, h, lq, lkv = QUANT_HEADS_SHAPE
    blk = QUANT_HEADS_BLOCKS
    kvq = {"checks": {}, "times": {}}
    int8 = {"checks": {}, "times": {}}

    def readings(what, o, plain, qs, kd, vd, bad, tol, note):
        o64 = naive_attention(qs, kd, vd)
        err = held(torch, what, o, plain, o64,
                   {n: x.cpu().numpy() for n, x in bad.items()}, tol, tol,
                   1, 2, note)
        return {"max_abs_err": err,
                "oracle_err": float(np.abs(o[:1, :2].cpu().numpy()
                                           - o64).max()),
                "controls_vs_oracle": {
                    n: float(np.abs(x.cpu().numpy() - o64).max())
                    for n, x in bad.items()}}

    for d in QUANT_HEADS_DIMS + QUANT_H5_DIMS:
        scale = 1.0 / math.sqrt(d)
        kern = "h4kvq" if d <= 256 else "h5"
        inst = f"D={h4_instance(d)}" if d <= 256 else "H5"
        for qdt in ("bf16", "f32"):
            make = v1_inputs if qdt == "bf16" else f32_inputs
            q, k, v = make(torch, dev, b, h, h, lq, lkv, d, d)
            for kind in ("int8", "fp8"):
                kq, vq = (quant[kind](x, blk["kvq"]) for x in (k, v))
                o = counted_call(torch, lambda: flash_attention_kvquant(
                    q, kq, vq, out_dtype=f32), launches_only(**{kern: 1}))
                qs, ks, vs = q[:1, :2], heads(kq, 0, 1, 2), heads(vq, 0, 1, 2)
                kd, vd = dequantize(ks), dequantize(vs)
                bad = {"scale x1.1": attention_kvquant_plain(
                           qs, ks, vs, 1.1 * scale),
                       "last tile dropped": attention_kvquant_plain(
                           qs, dropped_tile(ks), dropped_tile(vs), scale),
                       "scales rolled": attention_kvquant_plain(
                           qs, rolled(ks), rolled(vs), scale)}
                if qdt == "f32":
                    bad["P rounded to bf16"] = rounded_p_plain(
                        torch, qs, kd, vd, scale)
                tol = (F32_OPS_TOL if qdt == "f32" else
                       KVQ_O_TOL if d <= 256 else DTILED_O_TOL)
                kvq["checks"][f"d={d} {qdt} q {kind}"] = {
                    "kernel": kern, "instance": inst, **readings(
                        f"quant kvquant d={d} ({inst}) {qdt} q {kind} "
                        f"block {blk['kvq']}: B={b} H={h} Lq={lq} "
                        f"Lkv={lkv}", o,
                        attention_kvquant_plain(q, kq, vq, scale),
                        qs, kd, vd, bad, tol, f"; one {kern} launch")}
                del o, kq, vq
            del q, k, v
        if d > 256:
            continue
        q, k, v = v1_inputs(torch, dev, b, h, h, lq, lkv, d, d + 1)
        qq = quantize_int8(q, blk["q"])
        kq, vq = (quantize_int8(x, blk["int8"]) for x in (k, v))
        qs, ks, vs = (heads(x, 0, 1, 2) for x in (qq, kq, vq))
        for mode in ("bf16", "int8"):
            o = counted_call(torch, lambda: flash_attention_int8(
                qq, kq, vq, out_dtype=f32, pv_mode=mode),
                launches_only(h4int8=1))
            plain = attention_int8_plain(qq, kq, vq, scale, mode)
            bad = {"scale x1.1": attention_int8_plain(qs, ks, vs, 1.1 * scale,
                                                      mode),
                   "last tile dropped": attention_int8_plain(
                       qs, dropped_tile(ks), dropped_tile(vs), scale, mode),
                   "scales rolled": attention_int8_plain(
                       qs, rolled(ks), rolled(vs), scale, mode)}
            what = (f"quant int8 d={d} (D={h4_instance(d)}) pv_mode {mode} "
                    f"q block {blk['q']} kv block {blk['int8']}: B={b} "
                    f"H={h} Lq={lq} Lkv={lkv}")
            o64 = naive_attention(*(dequantize(x) for x in (qs, ks, vs)))
            # pv_mode int8 against the oracle: B18's requantized P is the
            # function's own error, which the plain version reads up to
            # 3.1e-2 here (d=16), past the JAX test's tier; the kernel may
            # read no further than the plain version plus its own limit
            plain_oracle = float(np.abs(plain[:1, :2].cpu().numpy()
                                        - o64).max())
            tol_oracle = (INT8_GATE_TOL if mode == "bf16"
                          else plain_oracle + INT8_PLAIN_TOL)
            err = held(torch, what, o, plain, o64,
                       {n: x.cpu().numpy() for n, x in bad.items()},
                       INT8_PLAIN_TOL, tol_oracle, 1, 2,
                       "; one H4-int8 launch")
            int8["checks"][f"d={d} {mode}"] = {
                "instance": f"D={h4_instance(d)}", "max_abs_err": err,
                "oracle_err": float(np.abs(o[:1, :2].cpu().numpy()
                                           - o64).max()),
                "plain_oracle_err": plain_oracle}
            del o, plain
        del q, k, v, qq, kq, vq

    b, h, l, block = QUANT_TIMED
    for d in QUANT_TIMED_DIMS:
        scale = 1.0 / math.sqrt(d)
        flop = 4 * b * h * l * l * d
        for qdt in ("bf16", "f32"):
            make = v1_inputs if qdt == "bf16" else f32_inputs
            q, k, v = make(torch, dev, b, h, h, l, l, d, 1)
            kq, vq = quantize_int8(k, block), quantize_int8(v, block)
            del k, v
            kd, vd = dequantize(kq, q.dtype), dequantize(vq, q.dtype)
            nbytes = (2 * b * h * l * d * q.element_size()
                      + 2 * b * h * l * d + 2 * kq.scales.numel() * 4)
            peak = ([(flop, H100_BF16_FLOPS)] if qdt == "bf16"
                    else f32_core_bound(flop, H4KVQ_F32_TERMS))
            t = kernel_times(lambda: flash_attention_kvquant(q, kq, vq),
                             lambda: attention_kvquant_plain(q, kq, vq, scale),
                             None, peak, nbytes)
            backends, t["library_ms"] = sdpa_backends(torch, q, kd, vd)
            t["library_backends_ms"] = backends
            t["tflops"] = flop / t["ms"] / 1e9
            t["padded_share"] = 1 - d / h4_instance(d)
            note = ""
            if d == 256 and qdt == "bf16":
                # H5's quantized form on the same inputs: where the route
                # turns from H4-kvq to H5
                t["h5_ms"] = time_cuda(lambda: flash_attention_v1_dtiled(
                    q, kq, vq), n_iter=20)
                note = f"; H5's quantized form {t['h5_ms']:.4f} ms"
            print(f"  quant kvquant {qdt} q int8 K/V times at B={b} H={h} "
                  f"L={l} d={d} (D={h4_instance(d)}, "
                  f"{100 * t['padded_share']:.1f}% of the products on "
                  f"zero-filled columns): H4-kvq {t['ms']:.4f} ms "
                  f"({t['tflops']:.1f} TFLOP/s), plain {t['plain_ms']:.4f} "
                  f"ms, scaled_dot_product_attention over the dequantized "
                  f"K/V {t['library_ms']:.4f} ms (backends: "
                  + ", ".join(f"{n} {x:.4f} ms" for n, x in backends.items())
                  + f"), bound {t['bound_ms']:.4f} ms ({t['bound_by']})"
                  + note)
            kvq["times"][f"d={d} {qdt} q"] = t
            del q, kq, vq, kd, vd
        q, k, v = v1_inputs(torch, dev, b, h, h, l, l, d, 1)
        qq, kq, vq = (quantize_int8(x, block) for x in (q, k, v))
        del q, k, v
        qd, kd, vd = (dequantize(x, torch.bfloat16) for x in (qq, kq, vq))
        ops = 2 * b * h * l * l * d
        for mode in ("bf16", "int8"):
            pv_peak = H100_INT8_OPS if mode == "int8" else H100_BF16_FLOPS
            t = kernel_times(
                lambda: flash_attention_int8(qq, kq, vq, pv_mode=mode),
                lambda: [attention_int8_plain(
                    *(heads(x, i, i + 1) for x in (qq, kq, vq)), scale, mode)
                    for i in range(b)],
                None, [(ops, H100_INT8_OPS), (ops, pv_peak)],
                3 * b * h * l * d + b * h * l * d * 2
                + 4 * (qq.scales.numel() + 2 * kq.scales.numel()))
            backends, t["library_ms"] = sdpa_backends(torch, qd, kd, vd)
            t["library_backends_ms"] = backends
            t["tops"] = 2 * ops / t["ms"] / 1e9
            t["padded_share"] = 1 - d / h4_instance(d)
            print(f"  quant int8 pv_mode {mode} times at B={b} H={h} L={l} "
                  f"d={d} (D={h4_instance(d)}): H4-int8 {t['ms']:.4f} ms "
                  f"({t['tops']:.1f} TOP/s), plain {t['plain_ms']:.4f} ms, "
                  f"scaled_dot_product_attention over the dequantized bf16 "
                  f"Q/K/V {t['library_ms']:.4f} ms (backends: "
                  + ", ".join(f"{n} {x:.4f} ms" for n, x in backends.items())
                  + f"), bound {t['bound_ms']:.4f} ms ({t['bound_by']})")
            int8["times"][f"d={d} {mode}"] = t
        del qq, kq, vq, qd, kd, vd
    print(f"  quant head dims in {time.perf_counter() - t0:.1f} s")
    return kvq, int8


def sdpa_backends(torch, q, k, v):
    """The scaled_dot_product_attention backends that take these inputs,
    with the time of each, and the time of the default call."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from exploring_flash_attention_tpu_torch.utils import time_cuda

    out = {}
    for name in ("FLASH_ATTENTION", "CUDNN_ATTENTION", "EFFICIENT_ATTENTION",
                 "MATH"):
        backend = getattr(SDPBackend, name, None)
        if backend is None:
            continue
        try:
            # a backend that refuses the inputs warns, then raises
            with sdpa_kernel([backend]), warnings.catch_warnings():
                warnings.simplefilter("ignore")
                sdpa(q, k, v)
                torch.cuda.synchronize()
                out[name] = time_cuda(lambda: sdpa(q, k, v), n_iter=10)
        except RuntimeError:
            continue
    return out, time_cuda(lambda: sdpa(q, k, v), n_iter=20)


def phase_dtiled(torch, dev):
    """flash_attention_v1_dtiled (H5) through its entry point: the suite's
    gates at d=512, one launch per call at the suite's shape with bf16,
    fp8 and int8 K/V at d 512, 1024 and 2048 and ragged cases at d 64,
    96, 144, 256 and 640, each against the plain version and the f64
    oracle beside its controls, and the times of the d=512, 1024 and 2048
    calls."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from exploring_flash_attention_tpu_torch.oracle import naive_attention
    from exploring_flash_attention_tpu_torch.ops import (
        attention_dtiled_plain,
        dequantize,
        flash_attention_v1_dtiled,
        quantize_fp8,
        quantize_int8,
    )

    quant = {"int8": quantize_int8, "fp8": quantize_fp8}
    f32 = torch.float32
    gates = {}
    for kind in ("bf16", "fp8", "int8"):        # bench/suite.py:295, :326
        q, k, v = v1_inputs(torch, dev, 1, 2, 2, 512, 512, 512, seed=0)
        if kind != "bf16":
            k, v = quant[kind](k, 512), quant[kind](v, 512)
        o = counted_call(torch, lambda: flash_attention_v1_dtiled(
            q, k, v, out_dtype=f32), launches_only(h5=1))
        kd, vd = (k, v) if kind == "bf16" else (dequantize(k), dequantize(v))
        gates[kind] = gate_reading(
            f"dtiled {kind} gate (1, 2, 512, 512) block 512", o,
            naive_attention(q, kd, vd), DTILED_GATE_TOL)

    out = {}
    for case, b, h, lq, lkv, d, kind, block, seed, nh in DTILED_CASES:
        q, k, v = v1_inputs(torch, dev, b, h, h, lq, lkv, d, seed=seed)
        if kind != "bf16":
            k, v = quant[kind](k, block), quant[kind](v, block)
        o = counted_call(torch, lambda: flash_attention_v1_dtiled(
            q, k, v, out_dtype=f32), launches_only(h5=1))
        out.setdefault("launches", read_counters()["h5"])
        scale = 1.0 / math.sqrt(d)
        if kind == "bf16":
            ks, vs = k[:1, :nh], v[:1, :nh]
            kd, vd = ks, vs
            short = ks[:, :, :-64], vs[:, :, :-64]
            bad_rolled = None
        else:
            ks, vs = heads(k, 0, 1, nh), heads(v, 0, 1, nh)
            kd, vd = dequantize(ks), dequantize(vs)
            short = dropped_tile(ks), dropped_tile(vs)
            bad_rolled = attention_dtiled_plain(q[:1, :nh], rolled(ks),
                                                rolled(vs), scale)
        qs = q[:1, :nh]
        bad = {"scale x1.1": attention_dtiled_plain(qs, ks, vs, 1.1 * scale),
               "last tile dropped": attention_dtiled_plain(qs, *short, scale),
               **dtiled_controls(torch, qs, kd, vd, scale, False)}
        if bad_rolled is not None:
            bad["scales rolled"] = bad_rolled
        err = held(torch, f"dtiled {case}: B={b} H={h} Lq={lq} Lkv={lkv} "
                   f"d={d} block {block}", o,
                   attention_dtiled_plain(q, k, v, scale),
                   naive_attention(qs, kd, vd),
                   {n: x.cpu().numpy() for n, x in bad.items()},
                   DTILED_O_TOL, DTILED_O_TOL, 1, nh, "; one H5 launch")
        out.setdefault("err", err)
        del o
        if not case.startswith(DTILED_TIMED):
            continue
        flop = 4 * b * h * lq * lkv * d
        kv_bytes = (2 * b * h * lkv * d * 2 if kind == "bf16" else
                    2 * b * h * lkv * d + 8 * k.scales.numel())
        lib = None
        if kind != "bf16":
            kd, vd = dequantize(k, q.dtype), dequantize(v, q.dtype)
            lib = lambda: sdpa(q, kd, vd)                   # noqa: E731
        t = kernel_times(lambda: flash_attention_v1_dtiled(q, k, v),
                         lambda: attention_dtiled_plain(q, k, v, scale),
                         lib, [(flop, H100_BF16_FLOPS)],
                         2 * b * h * lq * d * 2 + kv_bytes)
        if kind == "bf16":
            backends, t["library_ms"] = sdpa_backends(torch, q, k, v)
            t["library_backends_ms"] = backends
            default = t["library_ms"]
            lib_note = (f"scaled_dot_product_attention {default:.4f} ms "
                        f"(backends that take d={d}: "
                        + ", ".join(f"{n} {x:.4f} ms"
                                    for n, x in backends.items()) + ")")
        else:
            lib_note = (f"scaled_dot_product_attention over the dequantized "
                        f"bf16 K/V {t['library_ms']:.4f} ms (the dequant not "
                        f"counted)")
        print(f"  dtiled {case} times at B={b} H={h} L={lq}: H5 "
              f"{t['ms']:.4f} ms = {flop / t['ms'] / 1e9:.1f} TFLOP/s, plain "
              f"{t['plain_ms']:.4f} ms, {lib_note}, bound "
              f"{t['bound_ms']:.4f} ms ({t['bound_by']})")
        out.setdefault("t", {})[case] = t
        del q, k, v
    print(f"  dtiled on {card_line()}")
    print("phase dtiled: ok")
    return gates, out


def make_paged_case(torch, dev, b=8, hq=8, hkv=4, d=128, ps=128,
                    lens=(257, 280), max_len=1024, seed=1, chunk=0):
    """A cache like the engine's (cdiv(max_len, ps) pages per slot, a
    permuted page table) filled through append_prompts with contexts
    spread from lens[0] to lens[1], and one bf16 q [B, Hq, d].  With
    ``chunk`` = C, append_chunks then adds C more tokens per sequence and q
    is [B, C, Hq, d]."""
    from exploring_flash_attention_tpu_torch.configs import cdiv
    from exploring_flash_attention_tpu_torch.serving import (
        append_chunks,
        append_prompts,
        make_cache,
    )

    gen = torch.Generator().manual_seed(seed)
    pages_per_seq = cdiv(max_len, ps)
    cache = make_cache(hkv, d, b * pages_per_seq, page_size=ps, max_seqs=b,
                       max_pages_per_seq=pages_per_seq, device=dev)
    perm = torch.randperm(b * pages_per_seq, generator=gen)
    cache.page_table.copy_(perm.view(b, pages_per_seq).to(torch.int32))
    slots = torch.arange(b, dtype=torch.int32, device=dev)
    lens = np.linspace(*lens, b).round().astype(int)
    for s, n in enumerate(lens):
        kp = torch.randn(1, int(n), hkv, d, generator=gen).to(dev)
        vp = torch.randn(1, int(n), hkv, d, generator=gen).to(dev)
        append_prompts(cache, slots[s:s + 1], kp, vp)
    if chunk:
        append_chunks(cache, slots,
                      torch.randn(b, chunk, hkv, d, generator=gen).to(dev),
                      torch.randn(b, chunk, hkv, d, generator=gen).to(dev))
        return cache, _bf16(torch, dev, gen, b, chunk, hq, d), slots, lens
    q = _bf16(torch, dev, gen, b, hq, d)
    return cache, q, slots, lens


@contextlib.contextmanager
def newest_token_hidden(cache, slots, n=1):
    """A known-wrong path: each sequence's newest cached token (or ``n``
    newest) is hidden (an off-by-one length), for the controls of the
    decode and extend checks.  In extend, where row i sits at seq_lens - C
    + i, it hides every chunk row's own (diagonal) key."""
    idx = slots.long()
    cache.seq_lens[idx] -= n
    try:
        yield
    finally:
        cache.seq_lens[idx] += n


def gathered_kv(torch, cache, slots, pos, window):
    """The library call's inputs: each slot's K and V gathered from the
    pages and dequantized, bf16 [B, Hkv, L, d] padded to the longest
    sequence, and the boolean mask [B, 1, R, L] of the columns row r at
    position pos[b, r] sees (the same band the kernels take)."""
    from exploring_flash_attention_tpu_torch.serving import gather_kv

    kvs = [gather_kv(cache, int(s)) for s in slots.tolist()]
    lmax = max(k.shape[1] for k, _ in kvs)
    pad = lambda x: torch.nn.functional.pad(         # noqa: E731
        x, (0, 0, 0, lmax - x.shape[1]))
    k = torch.stack([pad(k) for k, _ in kvs]).to(torch.bfloat16)
    v = torch.stack([pad(v) for _, v in kvs]).to(torch.bfloat16)
    col = torch.arange(lmax, device=k.device)
    p = torch.as_tensor(pos, device=k.device)[:, :, None]
    mask = col <= p
    if window is not None:
        mask &= col > p - window
    return k, v, mask[:, None]


def band_oracle(q, cache, slot, pos, window):
    """f64 attention of q [R, Hq, d] (rows at positions pos [R]) over the
    gathered, dequantized cache of one slot, each row over its band."""
    from exploring_flash_attention_tpu_torch.oracle import naive_attention
    from exploring_flash_attention_tpu_torch.serving import gather_kv

    kf, vf = gather_kv(cache, slot)                   # [Hkv, L, d]
    hkv, hq, d = kf.shape[0], q.shape[1], q.shape[2]
    out = np.zeros(q.shape)
    for r, p in enumerate(pos):
        lo = 0 if window is None else max(0, p - window + 1)
        out[r] = naive_attention(q[r].view(hkv, hq // hkv, d),
                                 kf[:, lo:p + 1], vf[:, lo:p + 1]
                                 ).reshape(hq, d)
    return out


def paged_check(what, o, ref, oracle, controls, tol, shown=None):
    """One decode or extend check: the kernel's O vs the plain version
    (the whole tensor) and vs the f64 oracle (``oracle``: the kernel's
    rows the oracle computed, and the oracle's), each within ``tol`` and
    within PAGED_REL_TOL of max|O_ref|; every known-wrong control (the
    plain version run wrongly) must read beyond PAGED_REL_TOL against the
    kernel's O; those in ``shown`` are printed only."""
    o = o.float()
    top = ref.abs().max().item()
    e_plain = (o - ref).abs().max().item()
    got, o64 = oracle
    e_or = float(np.abs(got - o64).max())
    top64 = float(np.abs(o64).max())
    ctl = {n: (o - x).abs().max().item() / top for n, x in controls.items()}
    seen = {n: (o - x).abs().max().item() / top
            for n, x in (shown or {}).items()}
    print(f"  {what}: max|dO| vs plain {e_plain:.3e} ({e_plain / top:.3e} of "
          f"max|O| {top:.3e}), vs f64 oracle on the dequantized cache "
          f"{e_or:.3e} ({e_or / top64:.3e}); limits {tol:g} and "
          f"{PAGED_REL_TOL:g} of max|O|; controls (of max|O|): "
          + ", ".join(f"{n} {x:.3e}" for n, x in ctl.items())
          + "".join(f"; {n} {x:.3e} (shown, not required)"
                    for n, x in seen.items()))
    _require(o.isfinite().all().item(), f"{what}: O not finite")
    _require(max(e_plain, e_or) < tol and e_plain / top < PAGED_REL_TOL
             and e_or / top64 < PAGED_REL_TOL, f"{what} outside tolerance")
    _require(min(ctl.values()) > PAGED_REL_TOL,
             f"the check cannot tell a wrong path ({what})")
    return e_plain


def paged_work(hq, hkv, d, pairs, tokens, rows):
    """The work of paged attention for ``kernel_times``' bound: 4 d bf16
    flops per visible (q head, key) pair of every row; each visible cached
    token's K and V codes and scales read once, q read and O written once
    in bf16."""
    return ([(4 * d * hq * pairs, H100_BF16_FLOPS)],
            tokens * hkv * (2 * d + 8) + 2 * rows * hq * d * 2)


def phase_decode(torch, dev):
    """H6-decode through paged_decode_attention at each of DECODE_CASES:
    one launch per call, the runs merged inside it by the last block of
    each (sequence, KV head); O against the plain version and the f64
    oracle over each slot's band of the dequantized cache, beside its
    controls (the newest token hidden; under a window, the window one key
    narrower); O against the plain merge of the kernel's own partials
    (paged_decode_partials, the kernel without its merge) within one bf16
    ulp of max|O|, beside the merge with each row's last non-empty run left
    out, which must read beyond PAGED_REL_TOL of max|O| (as paged_check's
    controls) wherever the split has more than one run; the tickets zero
    after each case.
    Times, in one run: the kernel alone, the fused call and the two-launch
    form (the kernel alone, then H2), in turns, the fused call no slower
    than the two-launch form; the plain version, scaled_dot_product_attention
    over the gathered, dequantized K/V under the same band mask (the
    gather and the dequant left out), and the bounds of the call and of
    the merge."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from exploring_flash_attention_tpu_torch.ops import (
        splitkv_combine,
        splitkv_combine_plain,
    )
    from exploring_flash_attention_tpu_torch.serving import (
        decode_split,
        paged_decode_attention,
        paged_decode_partials,
        paged_decode_plain,
        ticket_buffer,
    )
    from exploring_flash_attention_tpu_torch.utils import time_cuda

    out, made = {}, None
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for name, b, hq, hkv, ps, lens, max_len, window in DECODE_CASES:
        key = (b, hq, hkv, ps, lens, max_len)
        if made is None or made[0] != key:
            made = None                              # free the last cache
            made = (key, make_paged_case(torch, dev, b, hq, hkv, 128, ps,
                                         lens, max_len))
        cache, q, slots, ctx = made[1]
        d = q.shape[-1]
        scale = 1.0 / math.sqrt(d)
        call = lambda: paged_decode_attention(        # noqa: E731
            q, cache, slots, window=window)
        o = counted_call(torch, call, launches_only(h6=1))
        ref = paged_decode_plain(q, cache, slots, scale, window)
        oracle = np.stack([band_oracle(q[s:s + 1], cache, s,
                                       [int(n) - 1], window)[0]
                           for s, n in enumerate(ctx)])
        controls, shown = {}, {}
        with newest_token_hidden(cache, slots):
            controls["newest token hidden"] = paged_decode_plain(
                q, cache, slots, scale, window)
        if name == DECODE_LONG:
            # one sequence over 8100 keys: a one-key fault moves O by less
            # than PAGED_REL_TOL (a CPU rehearsal reads 6.7e-3 of max|O|),
            # so it is shown; the tokens of the last run hidden must fail
            shown = controls
            tail = int((ctx.max() - 1) % ps + 1)
            with newest_token_hidden(cache, slots, tail):
                controls = {f"the last run's {tail} tokens hidden":
                            paged_decode_plain(q, cache, slots, scale,
                                               window)}
        if window is not None:
            controls["window one key narrower"] = paged_decode_plain(
                q, cache, slots, scale, window - 1)
        split = decode_split(cache, b, window, n_sms)
        what = (f"decode {name}: B={b} Hq={hq} Hkv={hkv} d={d} ps={ps} "
                f"ctx {ctx.min()}..{ctx.max()} window {window}, "
                f"{split[0]} runs of {split[1]} pages")
        err = paged_check(what, o, ref, (o.float().cpu().numpy(), oracle),
                          controls, DECODE_O_TOL, shown)
        del ref, controls, shown

        # the merge inside the kernel vs the plain merge of its partials
        o_part, lse = paged_decode_partials(q, cache, slots, scale, window)
        merged = splitkv_combine_plain(o_part, lse)[:, :, 0]
        top = merged.abs().max().item()
        ulp = 2.0 ** (math.floor(math.log2(top)) - 7)
        e_merge = (o.float() - merged).abs().max().item()
        note = ""
        if split[0] > 1:
            # control: each row's last run that saw a key left out
            run = torch.arange(split[0], device=dev)[:, None]
            last = torch.where(lse.isfinite(), run, -1).amax(dim=2,
                                                             keepdim=True)
            drop = run == last
            bad = splitkv_combine_plain(
                o_part.masked_fill(drop[..., None], 0.0),
                lse.masked_fill(drop, float("-inf")))[:, :, 0]
            c_abs = (o.float() - bad).abs().max().item()
            note = (f"; control (each row's last non-empty run left out) "
                    f"{c_abs:.3e}, {c_abs / top:.3e} of max|O| (must exceed "
                    f"{PAGED_REL_TOL:g} of it, as paged_check's controls)")
            _require(c_abs / top > PAGED_REL_TOL,
                     f"the merge check cannot tell a run left out ({name})")
        print(f"  decode {name}: fused O vs the plain merge of the kernel's "
              f"own partials {e_merge:.3e} (one bf16 ulp of max|O| "
              f"{top:.3e}: {ulp:.3e}){note}")
        _require(e_merge <= ulp, f"the fused merge differs from the plain "
                 f"merge of the kernel's partials ({name})")
        e_h2 = (splitkv_combine(o_part, lse, out_dtype=torch.float32)
                - splitkv_combine_plain(o_part, lse)).abs().max().item()
        _require(e_h2 < H2_O_TOL, f"H2 on the decode partials: {e_h2:.3e}")
        del o, merged

        vis = np.minimum(ctx, window or ctx.max())
        k, v, mask = gathered_kv(torch, cache, slots, ctx[:, None] - 1,
                                 window)
        qs = q[:, :, None]
        t = kernel_times(call, lambda: paged_decode_plain(
            q, cache, slots, scale, window), lambda: sdpa(
            qs, k, v, attn_mask=mask, enable_gqa=hq != hkv),
            *paged_work(hq, hkv, d, int(vis.sum()), int(vis.sum()), b))
        alone = lambda: paged_decode_partials(        # noqa: E731
            q, cache, slots, scale, window)
        two = lambda: splitkv_combine(*alone(), out_dtype=q.dtype)[:, :, 0]  # noqa: E731
        # in turns: fused, two-launch, alone, alone, two-launch, fused
        fused_ms, two_ms, alone_ms = [t["ms"]], [], []
        for fn, acc in ((two, two_ms), (alone, alone_ms), (alone, alone_ms),
                        (two, two_ms), (call, fused_ms)):
            acc.append(time_cuda(fn))
        t["ms"] = float(np.mean(fused_ms))
        t["partials_ms"] = float(np.mean(alone_ms))
        t["two_launch_ms"] = float(np.mean(two_ms))
        t["merge_ms"] = t["ms"] - t["partials_ms"]
        t["h2_ms"] = time_cuda(lambda: splitkv_combine(o_part, lse, out_dtype=q.dtype))
        t["merge_bound_ms"], _ = merge_bound(split[0], b * hq, d)
        t["bound_share"] = t["bound_ms"] / t["ms"]
        t["split"] = list(split)
        t["max_abs_err"] = err
        t["merge_err"] = e_merge
        tickets = ticket_buffer(dev)
        _require(tickets is not None and not tickets.any().item(),
                 f"tickets not zero after the {name} case")
        out[name] = t
        print(f"  decode {name} times: paged_decode_attention (one launch) "
              f"{t['ms']:.4f} ms (bound {t['bound_ms']:.4f} ms, "
              f"{t['bound_by']}, {t['bound_share']:.1%}), H6-decode without "
              f"its merge {t['partials_ms']:.4f} ms, so the merge "
              f"{t['merge_ms']:.4f} ms (its bound {t['merge_bound_ms']:.4f} "
              f"ms); the two-launch form (without its merge, then H2) "
              f"{t['two_launch_ms']:.4f} ms, H2 alone {t['h2_ms']:.4f} ms "
              f"(vs its plain version {e_h2:.3e}); every form timed "
              f"twice in turns; plain {t['plain_ms']:.4f} ms; "
              f"scaled_dot_product_attention over the gathered, dequantized "
              f"K/V {t['library_ms']:.4f} ms; tickets zero after the case")
        _require(t["ms"] <= t["two_launch_ms"], f"the fused call is slower "
                 f"than the two-launch form ({name})")
        del k, v, mask, o_part, lse
    made = None
    suite = out[DECODE_CASES[1][0]]["ms"]
    windowed = out[DECODE_CASES[2][0]]["ms"]
    print(f"  decode window 512 vs no window at the suite's shape: "
          f"{windowed:.4f} ms vs {suite:.4f} ms, ratio "
          f"{windowed / suite:.3f} (must be < 1: pages before the band are "
          f"not read)")
    _require(windowed < suite, "the windowed decode reads pages before the "
             "band")
    _require(out[DECODE_LONG]["split"][0] > 32,
             f"the {DECODE_LONG} case planned {out[DECODE_LONG]['split']}")
    print("phase decode: ok")
    return out


def churn_requests(torch, dev, seed=0):
    """The churn run's 48 requests (bench/suite.py:576-591): prompts of
    256, 512, 1024 and 2048 tokens and 64, 128 and 192 new ones, bf16
    prompt K/V and one fixed (q, k, v) per request, made on the card from
    a seeded generator."""
    from exploring_flash_attention_tpu_torch.serving import Request

    hq, hkv, d = SCHED_HEADS
    g = torch.Generator(device=dev).manual_seed(seed)
    mk = lambda *s: torch.randn(*s, generator=g, device=dev,  # noqa: E731
                                dtype=torch.bfloat16)
    reqs = []
    for r in range(SCHED_REQUESTS):
        pl = SCHED_PROMPTS[r % len(SCHED_PROMPTS)]
        step = (mk(hq, d), mk(hkv, d), mk(hkv, d))
        reqs.append(Request(r, mk(pl, hkv, d), mk(pl, hkv, d),
                            SCHED_NEW[r % len(SCHED_NEW)],
                            lambda i, step=step: step))
    return reqs


def churn_scheduler(dev):
    from exploring_flash_attention_tpu_torch.serving import (
        ContinuousBatchingScheduler,
    )

    longest = max(SCHED_PROMPTS) + max(SCHED_NEW)
    return ContinuousBatchingScheduler(
        *SCHED_HEADS, n_pages=SCHED_SLOTS * (longest + SCHED_PAGE - 1)
        // SCHED_PAGE + 32, page_size=SCHED_PAGE, max_seqs=SCHED_SLOTS,
        max_pages_per_seq=(longest + SCHED_PAGE) // SCHED_PAGE, device=dev)


def run_churn(torch, sched, reqs):
    """The suite's churn (bench/suite.py:619-641): 16 requests up front,
    4 more every 8 steps, every step sync=False, one sync at the end.
    Returns (tokens after the first step, steps, seconds after the first
    step, every step's output)."""
    arrival, steps = SCHED_SLOTS, 1
    for r in reqs[:arrival]:
        sched.submit(r)
    outs = [sched.step(sync=False)[1]]       # builds, loads, captures
    torch.cuda.synchronize()
    tokens = 0
    t0 = time.perf_counter()
    while sched.pending or sched.active or arrival < len(reqs):
        if steps % 8 == 0 and arrival < len(reqs):
            for r in reqs[arrival:arrival + 4]:
                sched.submit(r)
            arrival = min(arrival + 4, len(reqs))
        rids, out = sched.step(sync=False)
        if out is not None:
            outs.append(out)
            tokens += len(rids)
        steps += 1
        _require(steps < 5000, "the churn run did not converge")
    outs[-1].cpu()                             # the one sync at the end
    return tokens, steps, time.perf_counter() - t0, outs


def phase_scheduler(torch, dev):
    """The continuous-batching scheduler at the JAX suite's
    bench_scheduler_e2e (bench/suite.py:504-650): Hq = Hkv = 8, d = 128,
    page size 256, 16 slots.  Its one-step gate first: one request (a
    256-token prompt, f32 inputs from np.random.default_rng(0) as the suite
    draws them) within 2e-2 of the f64 oracle over the dequantized cache,
    the newest token hidden as the control beyond it.  Then the churn run
    twice on the same requests: the step's CUDA graph replayed (the main
    path, counters zeroed before and read after: one H6-decode launch a
    step) and the fused step run eagerly; every step's output bitwise
    equal between the two, the completion map right and every page back
    in both; tokens/s of each."""
    from exploring_flash_attention_tpu_torch.oracle import naive_attention
    from exploring_flash_attention_tpu_torch.serving import (
        ContinuousBatchingScheduler,
        Request,
        gather_kv,
    )
    from exploring_flash_attention_tpu_torch.serving.scheduler import (
        _fused_step,
    )

    hq, hkv, d = SCHED_HEADS
    rng = np.random.default_rng(0)
    kp, vp = (torch.from_numpy(rng.standard_normal((256, hkv, d)).astype(
        np.float32)).to(dev) for _ in range(2))
    qs, ks, vs = (torch.from_numpy(rng.standard_normal((h, d)).astype(
        np.float32)).to(dev) for h in (hq, hkv, hkv))
    gs = ContinuousBatchingScheduler(hq, hkv, d, n_pages=8,
                                     page_size=SCHED_PAGE, max_seqs=2,
                                     device=dev)
    gs.submit(Request(rid=0, prompt_k=kp, prompt_v=vp, max_new_tokens=2,
                      step_inputs=lambda i: (qs, ks, vs)))
    (rid, out0), = gs.step()
    kd, vd = gather_kv(gs.cache, 0)
    q3 = qs[:, None, :].cpu()
    ref = naive_attention(q3, kd, vd)[:, 0]
    bad = naive_attention(q3, kd[:, :-1], vd[:, :-1])[:, 0]
    err, err_bad = float(np.abs(out0 - ref).max()), float(np.abs(
        out0 - bad).max())
    print(f"  scheduler gate (bench/suite.py:521-538): one step over a "
          f"256-token prompt, max|dO| vs the f64 oracle over the "
          f"dequantized cache {err:.3e} (limit {SCHED_TOL:g}); control "
          f"(newest token hidden) {err_bad:.3e}")
    _require(rid == 0 and err < SCHED_TOL, "the scheduler fails its gate")
    _require(err_bad > SCHED_TOL, "the gate cannot tell a wrong step")
    del gs

    reqs = churn_requests(torch, dev)
    want_done = {r.rid: r.max_new_tokens for r in reqs}
    runs = {}
    for mode in ("graphed", "eager"):
        sched = churn_scheduler(dev)
        if mode == "eager":
            def eager(sched=sched):
                b = sched._bufs
                return _fused_step(sched.cache, b.q, b.k, b.v,
                                   b.append_ids, b.decode_slots)
            sched._run_fused_step = eager
        zero_counters()
        tokens, steps, wall, outs = run_churn(torch, sched, reqs)
        launches = read_counters()
        _require(launches == launches_only(h6=steps),
                 f"scheduler {mode} launches {launches}, expected "
                 f"H6-decode {steps} (one a step)")
        _require(sched.completed == want_done,
                 f"scheduler {mode}: completion map {sched.completed}")
        _require(sched.allocator.free_pages == sched.allocator.n_pages,
                 f"scheduler {mode}: pages not returned")
        _require(mode == "eager" or sched._graph is not None,
                 "the graphed run captured no graph")
        runs[mode] = {"tokens": tokens, "steps": steps, "wall_s": wall,
                      "tokens_s": tokens / wall, "launches": launches,
                      "outs": outs}
        print(f"  scheduler churn, {mode} step: {tokens} tokens in "
              f"{steps - 1} steps after the first, {wall:.4f} s: "
              f"{tokens / wall:.1f} tokens/s ({wall / (steps - 1) * 1e3:.4f} "
              f"ms a step, admissions and prefills included); launches "
              f"{launches}")
        del sched
    g_outs, e_outs = runs["graphed"].pop("outs"), runs["eager"].pop("outs")
    same = [torch.equal(a, b) for a, b in zip(g_outs, e_outs)]
    _require(len(g_outs) == len(e_outs) == runs["graphed"]["steps"],
             "the two churn runs took different steps")
    _require(all(torch.isfinite(o).all().item() for o in g_outs),
             "a scheduler output is not finite")
    print(f"  scheduler churn: graphed vs eager step outputs bitwise equal "
          f"in {sum(same)}/{len(same)} steps; completion map of "
          f"{len(want_done)} requests and every page back in both")
    _require(all(same), "a replayed step differs from the eager step")
    print("phase scheduler: ok")
    return runs


def phase_extend(torch, dev):
    """H6-extend through paged_extend_attention at each of EXTEND_CASES:
    one launch per call, O against the plain version and the f64 oracle
    (every chunk row's band of the dequantized cache, rows 0, C/2 and C-1
    of every sequence), beside its controls (every row's own key hidden;
    under a window, the window one key narrower); times as the decode
    phase's."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from exploring_flash_attention_tpu_torch.serving import (
        paged_extend_attention,
        paged_extend_plain,
    )

    out = {}
    for name, b, hq, hkv, ps, lens, max_len, c, window in EXTEND_CASES:
        cache, q, slots, hist = make_paged_case(torch, dev, b, hq, hkv, 128,
                                                ps, lens, max_len, chunk=c)
        d = q.shape[-1]
        scale = 1.0 / math.sqrt(d)
        call = lambda: paged_extend_attention(        # noqa: E731
            q, cache, slots, window=window)
        o = counted_call(torch, call, launches_only(h6e=1))
        ref = paged_extend_plain(q, cache, slots, scale, window)
        rows = [0, c // 2, c - 1]
        oracle = np.stack([band_oracle(q[s, rows], cache, s,
                                       [int(n) + i for i in rows], window)
                           for s, n in enumerate(hist)])
        controls = {}
        with newest_token_hidden(cache, slots):
            controls["every row's own key hidden"] = paged_extend_plain(
                q, cache, slots, scale, window)
        if window is not None:
            controls["window one key narrower"] = paged_extend_plain(
                q, cache, slots, scale, window - 1)
        what = (f"extend {name}: B={b} C={c} Hq={hq} Hkv={hkv} d={d} "
                f"ps={ps} history {hist.min()}..{hist.max()} window {window}")
        err = paged_check(what, o, ref,
                          (o[:, rows].float().cpu().numpy(), oracle),
                          controls, EXTEND_O_TOL)
        del o, ref, controls
        pos = hist[:, None] + np.arange(c)[None]              # [B, C]
        first = pos - (window or 2 ** 40) + 1
        pairs = int((pos - np.maximum(first, 0) + 1).sum())
        tokens = int((hist + c - np.maximum(first[:, 0], 0)).sum())
        k, v, mask = gathered_kv(torch, cache, slots, pos, window)
        qs = q.transpose(1, 2)
        t = kernel_times(call, lambda: paged_extend_plain(
            q, cache, slots, scale, window), lambda: sdpa(
            qs, k, v, attn_mask=mask, enable_gqa=hq != hkv),
            *paged_work(hq, hkv, d, pairs, tokens, b * c))
        t["bound_share"] = t["bound_ms"] / t["ms"]
        t["max_abs_err"] = err
        t["gflop"] = 4 * d * hq * pairs / 1e9
        out[name] = t
        print(f"  extend {name} times: H6-extend {t['ms']:.4f} ms (bound "
              f"{t['bound_ms']:.4f} ms, {t['bound_by']}, {t['gflop']:.2f} "
              f"GFLOP, {t['bound_share']:.1%}); plain {t['plain_ms']:.4f} "
              f"ms; scaled_dot_product_attention over the gathered, "
              f"dequantized K/V {t['library_ms']:.4f} ms")
        del cache, q, k, v, mask
    print("phase extend: ok")
    return out


def _rel(got, ref) -> float:
    """max|got - ref| / max|ref|."""
    return ((got.float() - ref.float()).abs().max()
            / ref.float().abs().max()).item()


def f64_attention_grads(torch, q, k, v, do, scale, causal, diag_off,
                        window=None):
    """Gradients of sum(o * do) by f64 autograd through the plain forward
    under the mask (every row must see a key: a row that sees none has no
    gradient)."""
    from exploring_flash_attention_tpu_torch.ops.attention import (
        attention_plain,
    )
    qd, kd, vd = (t.double().requires_grad_() for t in (q, k, v))
    o, _ = attention_plain(qd, kd, vd, scale, causal, diag_off, window)
    return torch.autograd.grad((o * do.double()).sum(), (qd, kd, vd))


def bwd_control(torch, mask, q, k, v, out, do, lse, scale, off, window):
    """(what, grads) of the known-wrong backward beside each mask: the
    diagonal key hidden (causal), the last 64-key tile dropped, its dK and
    dV rows left zero (none), the window one key narrower (window)."""
    from exploring_flash_attention_tpu_torch.ops.attention_bwd import (
        attention_bwd_plain,
    )
    if mask == "causal":
        return "diagonal key hidden", attention_bwd_plain(
            q, k, v, out, do, lse, scale, True, off - 1)
    if mask == "window":
        return "window one key narrower", attention_bwd_plain(
            q, k, v, out, do, lse, scale, True, off, window - 1)
    dq, dk, dv = attention_bwd_plain(q, k[:, :, :-64], v[:, :, :-64], out,
                                     do, lse, scale, False)
    pad = lambda x: torch.nn.functional.pad(x, (0, 0, 0, 64))  # noqa: E731
    return "last 64-key tile dropped", (dq, pad(dk), pad(dv))


def phase_bwd(torch, dev):
    """H3 through flash_attention_bwd at every BWD_SHAPES case under each
    mask (BWD_MASKS), against attention_bwd_plain and f64 autograd, beside
    the mask's known-wrong control; two runs must be bitwise equal."""
    from exploring_flash_attention_tpu_torch.ops.attention import (
        prefill_attention,
    )
    from exploring_flash_attention_tpu_torch.ops.attention_bwd import (
        attention_bwd_plain,
        flash_attention_bwd,
    )

    gen = torch.Generator().manual_seed(3)
    errs = {}                   # max |d| vs plain at the first shape, by mask
    by_d = {}                   # max|d|/max|ref| vs plain and f64, by d
    for b, hq, hkv, lq, lkv, d in BWD_SHAPES:
        q = _bf16(torch, dev, gen, b, hq, lq, d)
        k = _bf16(torch, dev, gen, b, hkv, lkv, d)
        v = _bf16(torch, dev, gen, b, hkv, lkv, d)
        do = _bf16(torch, dev, gen, b, hq, lq, d)
        scale, off = 1.0 / math.sqrt(d), lkv - lq
        for mask, (causal, window) in BWD_MASKS.items():
            out, lse = prefill_attention(q, k, v, scale, off, causal,
                                         window)        # H1's residuals
            run = lambda: flash_attention_bwd(                  # noqa: E731
                q, k, v, out, do, lse, scale=scale, causal=causal,
                window=window)
            grads, again = run(), run()
            torch.cuda.synchronize()
            identical = all(torch.equal(x, y) for x, y in zip(grads, again))
            plain = attention_bwd_plain(q, k, v, out, do, lse, scale, causal,
                                        off, window)
            f64 = f64_attention_grads(torch, q, k, v, do, scale, causal, off,
                                      window)
            what, bad = bwd_control(torch, mask, q, k, v, out, do, lse,
                                    scale, off, window)
            e_plain = [_rel(g, r) for g, r in zip(grads, plain)]
            e_f64 = [_rel(g, r) for g, r in zip(grads, f64)]
            e_bad = [_rel(g, r) for g, r in zip(grads, bad)]
            fmt = lambda e: " ".join(                           # noqa: E731
                f"{n} {x:.3e}" for n, x in zip(("dq", "dk", "dv"), e))
            print(f"  bwd {mask}{f' {window}' if window else ''} B={b} "
                  f"Hq={hq} Hkv={hkv} Lq={lq} Lkv={lkv} d={d}: "
                  f"max|d|/max|ref| vs plain {fmt(e_plain)}; vs f64 "
                  f"autograd {fmt(e_f64)} (tol {H3_REL_TOL:g}); control "
                  f"({what}) {fmt(e_bad)}; two runs bitwise equal: "
                  f"{identical}")
            _require(all(torch.isfinite(g.float()).all().item()
                         for g in grads), "H3 gradients not finite")
            _require(max(e_plain + e_f64) < H3_REL_TOL,
                     "H3 outside tolerance")
            _require(min(e_bad) > H3_REL_TOL,
                     f"H3 tolerance cannot tell a wrong mask ({mask})")
            _require(identical, "H3 is not deterministic")
            err = [(g.float() - r.float()).abs().max().item()
                   for g, r in zip(grads, plain)]
            errs.setdefault(mask, err)
            if (b, hq, hkv, lq, lkv, d) == BWD_CROSS and mask == "none":
                errs["cross"] = err         # the seq2seq cross attention's
            if d != 128:
                by_d.setdefault(d, {"shape": f"B={b} Hq={hq} Hkv={hkv} "
                                             f"Lq={lq} Lkv={lkv}"})[mask] = {
                    "rel_err_vs_plain": {"h3dq": e_plain[0],
                                         "h3dkv": max(e_plain[1:])},
                    "rel_err_vs_f64": {"h3dq": e_f64[0],
                                       "h3dkv": max(e_f64[1:])},
                    "control": {"h3dq": e_bad[0], "h3dkv": min(e_bad[1:])}}
            del out, lse, grads, again, plain, f64, bad
    print("phase bwd: ok")
    return ({m: {"h3dq": e[0], "h3dkv": max(e[1:])} for m, e in errs.items()},
            by_d)


def compare_with_full_forward(torch, params, cfg, prompt, out):
    """Greedy replay: at every step, the decode path's token against the
    full forward's argmax over the sequence so far.  Returns (agreements,
    steps, largest logit gap of a disagreement)."""
    from exploring_flash_attention_tpu_torch.models import forward

    dev = params["embed"].device
    seq = prompt
    agree, worst_gap = 0, 0.0
    for t in range(out.shape[1]):
        logits = forward(params, torch.from_numpy(seq).to(dev), cfg)
        last = logits[:, -1].cpu().numpy()
        _require(np.isfinite(last).all(), "full-forward logits not finite")
        nxt = last.argmax(-1)
        for b in range(out.shape[0]):
            if nxt[b] == out[b, t]:
                agree += 1
            else:
                worst_gap = max(worst_gap, float(
                    abs(last[b, nxt[b]] - last[b, out[b, t]])))
        seq = np.concatenate([seq, out[:, t:t + 1]], axis=1)
    return agree, out.size, worst_gap


def _counted():
    from exploring_flash_attention_tpu_torch.ops import (
        attention_bwd_dkv,
        attention_bwd_dq,
        flash_attention_int8,
        flash_attention_kvquant,
        flash_attention_v1_dtiled,
        prefill_attention,
        splitkv_combine,
    )
    from exploring_flash_attention_tpu_torch.serving import (
        paged_decode_partials,
        paged_extend_attention,
    )
    return {"h1": prefill_attention, "h2": splitkv_combine,
            "h6": paged_decode_partials,
            "h6e": paged_extend_attention, "h3dkv": attention_bwd_dkv,
            "h3dq": attention_bwd_dq, "h4kvq": flash_attention_kvquant,
            "h4int8": flash_attention_int8, "h5": flash_attention_v1_dtiled}


def launches_only(**counts):
    """The expected counters: the named ones, every other kernel 0."""
    return {name: counts.get(name, 0) for name in _counted()}


def zero_counters():
    for fn in _counted().values():
        fn.launches = 0


def read_counters():
    return {name: fn.launches for name, fn in _counted().items()}


def make_flagship(torch, dev, name="flagship", page_size=128, **heads):
    """The full-width flagship LM with random weights from seed 0, and the
    [8, 256] prompts of both generation phases.  ``heads`` (n_heads,
    n_kv_heads, d_head) change its attention geometry alone, as the heads
    phase's models do; ``page_size`` is its cache's."""
    from types import SimpleNamespace

    from exploring_flash_attention_tpu_torch.models import (
        flagship_config,
        init_params,
    )

    cfg = dataclasses.replace(flagship_config(), **heads)
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    prompt = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (8, 256)).astype(np.int32)
    return SimpleNamespace(
        cfg=cfg, params=params, prompt=prompt, t_init=t_init, name=name,
        page_size=page_size,
        tag=lambda phase: phase if name == "flagship" else f"{name} {phase}")


def phase_slice(torch, dev, lm):
    from unittest import mock

    from exploring_flash_attention_tpu_torch.models import GenerationEngine
    from exploring_flash_attention_tpu_torch.models import (
        generate as generate_module,
    )
    from exploring_flash_attention_tpu_torch.serving import (
        paged_decode_attention,
    )
    from exploring_flash_attention_tpu_torch.utils.profile_generate import (
        eager_generate,
    )

    cfg, params, prompt = lm.cfg, lm.params, lm.prompt
    (bsz, l_prompt), n_new = prompt.shape, 24
    tag = lm.tag("slice")
    eng = GenerationEngine(params, cfg, max_seqs=bsz, max_len=1024,
                           page_size=lm.page_size)

    zero_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = eng.generate(prompt, max_new_tokens=n_new)
    t_first = time.perf_counter() - t0
    launches = read_counters()
    want = launches_only(h1=cfg.n_layers, h6=cfg.n_layers * (n_new - 1))
    print(f"  {tag} launches {launches} (expected {want}; the first decode "
          f"step eager, then {n_new - 2} replays of its CUDA graph)")
    _require(launches == want, "the main path missed a kernel")
    _require(out.shape == (bsz, n_new) and out.dtype == np.int32
             and (out >= 0).all() and (out < cfg.vocab_size).all(),
             f"bad tokens {out.shape} {out.dtype}")

    zero_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out2 = eng.generate(prompt, max_new_tokens=n_new)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    replayed = read_counters()
    _require(replayed == want, f"a call of replays only launched {replayed}")
    tok_s = bsz * n_new / dt
    eager, dt_eager = timed_eager_generate(torch, eager_generate, eng,
                                           prompt, n_new)

    agree, steps, worst_gap = compare_with_full_forward(
        torch, params, cfg, prompt, out)

    # control: every decode step's newest token hidden; the engine is built,
    # and its graph captured, under the patch
    ran = []

    def hide_newest(q, cache, slots, window=None):
        ran.append(1)
        with newest_token_hidden(cache, slots):
            return paged_decode_attention(q, cache, slots, window=window)

    with mock.patch.object(generate_module, "paged_decode_attention",
                           hide_newest):
        bad = GenerationEngine(params, cfg, max_seqs=bsz, max_len=1024,
                               page_size=lm.page_size).generate(prompt,
                                                                n_new)
    bad_agree, _, bad_gap = compare_with_full_forward(
        torch, params, cfg, prompt, bad)
    print(f"  {tag} init {lm.t_init:.2f} s, first generate {t_first:.3f} s, "
          f"second {dt:.4f} s: {tok_s:.1f} tokens/s with the decode steps "
          f"replayed as a CUDA graph, {bsz * n_new / dt_eager:.1f} tokens/s "
          f"with them eager ({dt_eager:.4f} s; B={bsz}, prompt {l_prompt}, "
          f"{n_new} new, incl. prefill); tokens of the graphed engine "
          f"bitwise those of the eager loop over _decode_forward: "
          f"{bool(np.array_equal(out, eager))}; repeat identical: "
          f"{bool(np.array_equal(out, out2))}; full-forward agreement "
          f"{agree}/{steps}, largest gap of a disagreement {worst_gap:.4f} "
          f"(limit {LOGIT_GAP}); control (newest token hidden, patched "
          f"before the capture; the patch ran {len(ran)} times) "
          f"{bad_agree}/{steps}, largest gap {bad_gap:.4f}")
    _require(np.array_equal(out, eager) and np.array_equal(out, out2),
             "the graphed decode differs from the eager loop")
    _require(worst_gap < LOGIT_GAP,
             "a decode token differs from the full forward's beyond a tie")
    _require(ran and bad_gap >= LOGIT_GAP,
             "the full-forward check cannot tell a wrong decode path")
    print(f"phase {tag}: ok")
    return launches, {"tokens_s": tok_s, "eager_tokens_s":
                      bsz * n_new / dt_eager}


def timed_eager_generate(torch, eager_generate, eng, prompt, n_new):
    """The tokens of a greedy generate with every decode step eager (a
    loop over _decode_forward) and the seconds of a second, synchronized
    such call."""
    tokens = eager_generate(eng, prompt, n_new)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eager_generate(eng, prompt, n_new)
    torch.cuda.synchronize()
    return tokens, time.perf_counter() - t0


def phase_multiturn(torch, dev, lm):
    from unittest import mock

    from exploring_flash_attention_tpu_torch.models import (
        GenerationEngine,
        forward_collect_kv,
    )
    from exploring_flash_attention_tpu_torch.models import (
        generate as generate_module,
    )
    from exploring_flash_attention_tpu_torch.serving import (
        gather_kv,
        paged_extend_attention,
    )

    cfg, params, prompt = lm.cfg, lm.params, lm.prompt
    bsz, n_new, l_turn = prompt.shape[0], 24, 256
    tag = lm.tag("multiturn")
    eng = GenerationEngine(params, cfg, max_seqs=bsz, max_len=1024,
                           page_size=lm.page_size)
    zero_counters()
    out1 = eng.generate(prompt, max_new_tokens=n_new, hold=True)
    turn1 = read_counters()
    # turn 2: turn 1's last token, which was never fed into the cache, then
    # 255 user tokens; the chunk sits at 256 + 23 = 279 .. 534
    turn = np.concatenate([out1[:, -1:], np.random.default_rng(1).integers(
        0, cfg.vocab_size, (bsz, l_turn - 1)).astype(np.int32)], axis=1)
    zero_counters()
    out2 = eng.continue_generation(turn, max_new_tokens=n_new)
    turn2 = read_counters()
    want1 = launches_only(h1=cfg.n_layers, h6=cfg.n_layers * (n_new - 1))
    want2 = launches_only(h6=cfg.n_layers * (n_new - 1), h6e=cfg.n_layers)
    print(f"  {tag} launches turn 1 {turn1} (expected {want1}), "
          f"turn 2 {turn2} (expected {want2})")
    _require(turn1 == want1 and turn2 == want2,
             "the multi-turn path missed a kernel")
    _require(out2.shape == (bsz, n_new) and out2.dtype == np.int32
             and (out2 >= 0).all() and (out2 < cfg.vocab_size).all(),
             f"bad tokens {out2.shape} {out2.dtype}")

    # the cache holds prompt ++ turn 1 ++ the user's tokens ++ turn 2 but
    # its last token; the control stream lacks turn 1's last token
    prefix = np.concatenate([prompt, out1, turn[:, 1:]], axis=1)
    stream = np.concatenate([prefix, out2[:, :-1]], axis=1)
    short = np.concatenate([prompt, out1[:, :-1], turn[:, 1:], out2[:, :-1]],
                           axis=1)
    n = stream.shape[1]
    _, kvs = forward_collect_kv(params, torch.from_numpy(stream).to(dev), cfg)
    _, kvs_bad = forward_collect_kv(params, torch.from_numpy(short).to(dev),
                                    cfg)
    e_kv = e_bad = 0.0
    for cache, (k_ref, v_ref), (k_bad, _) in zip(eng.caches, kvs, kvs_bad):
        _require(bool((cache.seq_lens[:bsz] == n).all()),
                 f"cache lengths {cache.seq_lens.tolist()}, expected {n}")
        for s in range(bsz):
            k, v = gather_kv(cache, s)                  # [Hkv, n, d] f32
            e_kv = max(e_kv,
                       (k - k_ref[s].transpose(0, 1)).abs().max().item(),
                       (v - v_ref[s].transpose(0, 1)).abs().max().item())
            e_bad = max(e_bad, (k[:, :n - 1] - k_bad[s].transpose(0, 1))
                        .abs().max().item())
    del kvs, kvs_bad
    eng.release()
    free = eng.allocator.free_pages

    torch.cuda.synchronize()
    eng.generate(prompt, max_new_tokens=n_new, hold=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again = eng.continue_generation(turn, max_new_tokens=n_new)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    eng.release()
    tok_s = bsz * n_new / dt

    # controls: the turn without its first token (turn 1's last), and the
    # turn with every chunk row's own key hidden in the extend kernel
    def hide_diagonal(q, cache, slots, window=None):
        with newest_token_hidden(cache, slots):
            return paged_extend_attention(q, cache, slots, window=window)

    eng.generate(prompt, max_new_tokens=n_new, hold=True)
    short_out = eng.continue_generation(turn[:, 1:], max_new_tokens=n_new)
    eng.release()
    eng.generate(prompt, max_new_tokens=n_new, hold=True)
    with mock.patch.object(generate_module, "paged_extend_attention",
                           hide_diagonal):
        diag_out = eng.continue_generation(turn, max_new_tokens=n_new)
    eng.release()
    agree, steps, worst_gap = compare_with_full_forward(
        torch, params, cfg, prefix, out2)
    bad_agree, _, bad_gap = compare_with_full_forward(
        torch, params, cfg, prefix, short_out)
    diag_agree, _, diag_gap = compare_with_full_forward(
        torch, params, cfg, prefix, diag_out)
    print(f"  {tag} cache after turn 2 ({n} tokens, {cfg.n_layers} "
          f"layers): max|dK|,|dV| vs forward_collect_kv over the stream "
          f"{e_kv:.3e} (tol {CACHE_KV_TOL:g}), control (turn without its "
          f"first token) {e_bad:.3e}; pages free after release {free}/"
          f"{eng.allocator.n_pages}")
    print(f"  {tag} turn 2 second call {dt:.4f} s: {tok_s:.1f} tokens/s "
          f"(B={bsz}, turn {l_turn}, {n_new} new, incl. the extend); repeat "
          f"identical: {bool(np.array_equal(out2, again))}; full-forward "
          f"agreement {agree}/{steps}, largest gap of a disagreement "
          f"{worst_gap:.4f} (limit {LOGIT_GAP}); control (turn without its "
          f"first token) {bad_agree}/{steps}, largest gap {bad_gap:.4f}; "
          f"diagonal key hidden in extend (not required to fail: a one-key "
          f"mask fault is the extend phase's to catch) {diag_agree}/{steps}, "
          f"largest gap {diag_gap:.4f}")
    _require(e_kv < CACHE_KV_TOL, "the cache after turn 2 differs from "
             "the forward over the stream")
    _require(e_bad > CACHE_KV_TOL,
             "the cache check cannot tell a stream one token short")
    _require(free == eng.allocator.n_pages, "release() kept pages")
    _require(worst_gap < LOGIT_GAP,
             "a turn-2 token differs from the full forward's beyond a tie")
    _require(bad_gap >= LOGIT_GAP,
             "the full-forward check cannot tell a turn one token short")
    print(f"phase {tag}: ok")
    return turn2, tok_s


def train_step_flop(cfg, b, l):
    """FLOPs of one train step (forward + backward): 6 per matmul weight
    per token for the projections, the SwiGLU FFN and the tied logits, and
    for causal attention 4·B·Hq·L²·d/2 forward (S and P V on the visible
    half) plus 2.5 times that backward (S recomputed, dP, dV, dQ, dK)."""
    e, hq, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    per_layer = 2 * e * hq * dh + 2 * e * hkv * dh + 3 * e * cfg.d_ff
    weights = cfg.n_layers * per_layer + cfg.vocab_size * e
    attn_fwd = 4 * b * hq * l * l * dh / 2
    return 6 * weights * b * l + cfg.n_layers * 3.5 * attn_fwd


def plain_flash_attention(q, k, v, causal=True, window=None, hidden=0,
                          as_causal=False, config=None):
    """The model's attention on the plain PyTorch forward, differentiated
    by autograd: the reference path of the train, encoder and window_train
    checks (``config``, the model's tile, leaves the plain result as it
    is).  Known-wrong forwards: ``hidden=1`` hides each row's diagonal
    key (under a window, the band shifts back one key), ``as_causal``
    masks a bidirectional call causally.

    Beyond 4096 rows, q is cut into blocks of 2048 rows, each against the
    keys its rows see (their bands, under a window) and under
    ``torch.utils.checkpoint``: the whole score matrix of L = 32768 would
    take 34 GB."""
    import torch
    from torch.utils.checkpoint import checkpoint

    from exploring_flash_attention_tpu_torch.ops.attention import (
        attention_plain,
    )

    scale = 1.0 / math.sqrt(q.shape[3])
    lq, lkv = q.shape[2], k.shape[2]

    def part(qb, kb, vb, diag):
        o, _ = attention_plain(qb, kb, vb, scale, causal or as_causal, diag,
                               window)
        return o.to(q.dtype)

    diag = lkv - lq - hidden                # row i sees keys j <= i + diag
    if lq <= 4096 or not causal:
        return part(q, k, v, diag)
    outs = []
    for r0 in range(0, lq, 2048):
        r1 = min(r0 + 2048, lq)
        c0 = 0 if window is None else max(0, r0 + diag - window + 1)
        c1 = min(lkv, r1 + diag)
        outs.append(checkpoint(part, q[:, :, r0:r1], k[:, :, c0:c1],
                               v[:, :, c0:c1], r0 + diag - c0,
                               use_reentrant=False))
    return torch.cat(outs, dim=2)


def shifted_bwd(bwd, q, k, v, out, do, lse, scale, causal, diag_off,
                window):
    """A known-wrong backward on the kernels themselves: ``bwd`` (H3's
    ``masked_attention_bwd``) with each row's band shifted back one key,
    its diagonal key hidden (the plain backward would need the 34 GB score
    matrix at L = 32768)."""
    return bwd(q, k, v, out, do, lse, scale, causal, diag_off - 1, window)


def hide_diagonal_bwd(q, k, v, out, do, lse, scale, causal, diag_off,
                      window):
    """A known-wrong backward: the plain one with each row's diagonal key
    hidden."""
    from exploring_flash_attention_tpu_torch.ops.attention_bwd import (
        attention_bwd_plain,
    )
    return attention_bwd_plain(q, k, v, out, do, lse, scale, True,
                               diag_off - 1, window)


def plain_bwd(q, k, v, out, do, lse, scale, causal, diag_off, window):
    """The plain backward in H3's place, under the call's own mask."""
    from exploring_flash_attention_tpu_torch.ops.attention_bwd import (
        attention_bwd_plain,
    )
    return attention_bwd_plain(q, k, v, out, do, lse, scale, causal,
                               diag_off, window)


def causal_bwd(q, k, v, out, do, lse, scale, causal, diag_off, window):
    """A known-wrong backward of a bidirectional forward: the plain one
    under the causal mask."""
    from exploring_flash_attention_tpu_torch.ops.attention_bwd import (
        attention_bwd_plain,
    )
    return attention_bwd_plain(q, k, v, out, do, lse, scale, True, diag_off)


def leaf_err(named_leaves, grads, ref):
    """The largest per-leaf ||g - ref|| / ||ref||, and its leaf's name."""
    errs = [((g.float() - r.float()).norm() / r.float().norm()).item()
            for g, r in zip(grads, ref)]
    worst = int(np.argmax(errs))
    return errs[worst], named_leaves[worst]


def phase_train(torch, dev, name="train", loss_tol=TRAIN_LOSS_TOL,
                grad_tol=GRAD_REL_TOL, bwd_control=None, **heads):
    """make_train_step on the flagship LM, or with its config changed by
    ``heads`` (n_heads, n_kv_heads, d_head: the heads_train phase's
    models; dtype: the f32_train phase's): the step-0 loss and every
    gradient against the plain attention within ``loss_tol`` and
    ``grad_tol``, beside the diagonal-hidden forward and ``bwd_control``
    ((backward, what it is) in H3's place; by default the diagonal key
    hidden), the launches of each step, the loss over 5 AdamW steps and
    training tokens/s.  Returns (launches of a step, tokens/s, the checks'
    readings)."""
    from unittest import mock

    from exploring_flash_attention_tpu_torch.models import (
        flagship_config,
        init_params,
        loss_fn,
        make_train_step,
        make_trainable,
        named_param_leaves,
    )
    from exploring_flash_attention_tpu_torch.models import (
        transformer as transformer_module,
    )
    from exploring_flash_attention_tpu_torch.ops import (
        attention_bwd as attention_bwd_module,
    )

    cfg = dataclasses.replace(flagship_config(), **heads)
    bsz, seq, n_steps, n_timed = 8, 1024, 5, 5
    params = make_trainable(init_params(cfg, seed=0, device=dev))
    names, leaves = zip(*named_param_leaves(params))
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (bsz, seq + 1)).astype(np.int32)).to(dev)
    inputs, targets = tokens[:, :-1], tokens[:, 1:]

    def loss_and_grads():
        loss = loss_fn(params, inputs, targets, cfg)
        return loss.item(), torch.autograd.grad(loss, leaves)

    loss_k, grads_k = loss_and_grads()
    with mock.patch.object(transformer_module, "flash_attention",
                           plain_flash_attention):
        loss_p, grads_p = loss_and_grads()
    with mock.patch.object(transformer_module, "flash_attention",
                           functools.partial(plain_flash_attention,
                                             hidden=1)):
        loss_bad = loss_and_grads()[0]
    bad_bwd, bad_what = bwd_control or (
        hide_diagonal_bwd, "diagonal key hidden in the backward")
    with mock.patch.object(attention_bwd_module, "masked_attention_bwd",
                           bad_bwd):
        grads_bad = loss_and_grads()[1]
    e_grad, leaf = leaf_err(names, grads_k, grads_p)
    e_bad, leaf_bad = leaf_err(names, grads_bad, grads_p)
    del grads_k, grads_p, grads_bad
    print(f"  {name} step-0 loss {loss_k:.6f}, with the plain attention "
          f"{loss_p:.6f}: |d| {abs(loss_k - loss_p):.3e} (tol "
          f"{loss_tol:g}), control (diagonal key hidden in the "
          f"forward) {abs(loss_bad - loss_p):.3e}; largest per-leaf "
          f"||dg||/||g|| over {len(leaves)} leaves vs the plain path "
          f"{e_grad:.3e} at {leaf} (tol {grad_tol:g}), control "
          f"({bad_what}) {e_bad:.3e} at {leaf_bad}")
    _require(math.isfinite(loss_k), "step-0 loss not finite")
    _require(abs(loss_k - loss_p) < loss_tol,
             "the step-0 loss differs from the plain path's")
    _require(abs(loss_bad - loss_p) > loss_tol,
             "the loss check cannot tell a wrong mask")
    _require(e_grad < grad_tol, "gradients differ from the plain path's")
    _require(e_bad > grad_tol,
             "the gradient check cannot tell a wrong backward")

    step, opt_init = make_train_step(cfg)
    opt = opt_init(params)
    want = launches_only(h1=cfg.n_layers, h3dkv=cfg.n_layers,
                         h3dq=cfg.n_layers)
    losses, counts = [], []
    for _ in range(n_steps):
        zero_counters()
        losses.append(step(params, opt, tokens).item())
        counts.append(read_counters())
    print(f"  {name} launches per step {counts[0]} (expected {want}); AdamW "
          f"losses over {n_steps} steps {[round(x, 6) for x in losses]}")
    _require(all(c == want for c in counts), "a train step missed a kernel")
    _require(all(math.isfinite(x) for x in losses), "a loss is not finite")
    _require(all(b < a for a, b in zip(losses, losses[1:])),
             "the loss did not fall strictly over the AdamW steps")

    times = []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(n_timed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(params, opt, tokens)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    med = float(np.median(times))
    flop = train_step_flop(cfg, bsz, seq)
    print(f"  {name} step {flop / 1e12:.3f} TFLOP (matmuls, causal "
          f"attention incl. its recompute): {flop / med / 1e12:.1f} TFLOP/s "
          f"at the median step; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    tok_s = bsz * seq / med
    print(f"  {name} step times s {[round(t, 5) for t in sorted(times)]}: "
          f"median {med:.5f} s, {tok_s:.1f} training tokens/s (B={bsz}, "
          f"L={seq}, forward + backward + AdamW)")
    if not heads:
        print("phase train: ok")
    return counts[0], tok_s, {
        "loss_err": abs(loss_k - loss_p),
        "loss_control": abs(loss_bad - loss_p), "grad_err": e_grad,
        "grad_control": e_bad, "losses": losses, "step_s": med,
        "tflop_s": flop / med / 1e12}


def phase_encoder(torch, dev, name="encoder", bwd_ref=False,
                  loss_tol=ENCODER_LOSS_TOL, grad_tol=GRAD_REL_TOL, **heads):
    """The JAX suite's encoder entry (bench/suite.py:1057-1102) on the
    port: the flagship geometry (or its config changed by ``heads``, as
    the heads_train phase runs heads256 and the f32_train phase the
    flagship at f32; the limits ``loss_tol`` and ``grad_tol``) trained
    with make_mlm_train_step (AdamW, lr 1e-3) on tokens [8, 1024] from
    np.random.default_rng(0), under one fixed mask in every step, as the
    suite holds its rng fixed.

    With ``bwd_ref`` the gradients are held against the same forward with
    the plain backward in H3's place (plain_bwd), and the whole path's
    distance from the plain attention is shown beside them: in the heads
    models' bidirectional layers H1's bf16 O alone moves a leaf by up to
    6e-2 of its norm (the kernels' forward with the plain backward reads
    the same as with H3; the flagship's reads 4.0e-2)."""
    from unittest import mock

    from exploring_flash_attention_tpu_torch.models import (
        flagship_config,
        init_params,
        make_mlm_train_step,
        make_trainable,
        mask_tokens,
        mlm_loss,
        named_param_leaves,
    )
    from exploring_flash_attention_tpu_torch.models import (
        transformer as transformer_module,
    )
    from exploring_flash_attention_tpu_torch.ops import (
        attention_bwd as attention_bwd_module,
    )

    cfg = dataclasses.replace(flagship_config(), **heads)
    bsz, seq, n_steps, n_timed = 8, 1024, 5, 5
    mtok = cfg.vocab_size - 1
    params = make_trainable(init_params(cfg, seed=0, device=dev))
    names, leaves = zip(*named_param_leaves(params))
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size - 1, (bsz, seq)).astype(np.int32)).to(dev)
    _, mask = mask_tokens(tokens, torch.Generator(device=dev).manual_seed(0),
                          mtok)

    def loss_and_grads():
        loss = mlm_loss(params, tokens, None, cfg, mtok, mask=mask)
        return loss.item(), torch.autograd.grad(loss, leaves)

    loss_k, grads_k = loss_and_grads()
    with mock.patch.object(transformer_module, "flash_attention",
                           plain_flash_attention):
        loss_p, grads_p = loss_and_grads()
    with mock.patch.object(transformer_module, "flash_attention",
                           functools.partial(plain_flash_attention,
                                             as_causal=True)):
        loss_bad = loss_and_grads()[0]
    with mock.patch.object(attention_bwd_module, "masked_attention_bwd",
                           causal_bwd):
        grads_bad = loss_and_grads()[1]
    ref, what = grads_p, "the plain path"
    if bwd_ref:
        e_path, leaf_path = leaf_err(names, grads_k, grads_p)
        with mock.patch.object(attention_bwd_module, "masked_attention_bwd",
                               plain_bwd):
            ref = loss_and_grads()[1]
        what = "the plain backward in H3's place"
        print(f"  {name}: largest per-leaf ||dg||/||g|| of the whole path "
              f"vs the plain attention {e_path:.3e} at {leaf_path} "
              f"(shown: H1's O), of the kernels' forward with the "
              f"plain backward {leaf_err(names, ref, grads_p)[0]:.3e}")
    e_grad, leaf = leaf_err(names, grads_k, ref)
    e_bad, leaf_bad = leaf_err(names, grads_bad, ref)
    del grads_k, grads_p, grads_bad, ref
    print(f"  {name} step-0 MLM loss {loss_k:.6f} over "
          f"{int(mask.sum())} masked tokens, with the plain attention "
          f"{loss_p:.6f}: |d| {abs(loss_k - loss_p):.3e} (tol "
          f"{loss_tol:g}), control (causal forward) "
          f"{abs(loss_bad - loss_p):.3e}; largest per-leaf ||dg||/||g|| "
          f"over {len(leaves)} leaves vs {what} {e_grad:.3e} at "
          f"{leaf} (tol {grad_tol:g}), control (causal backward) "
          f"{e_bad:.3e} at {leaf_bad}")
    _require(math.isfinite(loss_k), "encoder step-0 loss not finite")
    _require(abs(loss_k - loss_p) < loss_tol,
             "the encoder's step-0 loss differs from the plain path's")
    _require(abs(loss_bad - loss_p) > loss_tol,
             "the encoder's loss check cannot tell a causal forward")
    _require(e_grad < grad_tol,
             "encoder gradients differ from the plain path's")
    _require(e_bad > grad_tol,
             "the encoder's gradient check cannot tell a causal backward")

    step, opt_init = make_mlm_train_step(cfg)
    opt = opt_init(params)
    want = launches_only(h1=cfg.n_layers, h3dkv=cfg.n_layers,
                         h3dq=cfg.n_layers)
    losses, counts = [], []
    for _ in range(n_steps):
        zero_counters()
        losses.append(step(params, opt, tokens, None, mask).item())
        counts.append(read_counters())
    print(f"  {name} launches per step {counts[0]} (expected {want}); "
          f"AdamW MLM losses over {n_steps} steps "
          f"{[round(x, 6) for x in losses]}")
    _require(all(c == want for c in counts),
             "an encoder step missed a kernel")
    _require(all(math.isfinite(x) for x in losses), "a loss is not finite")
    _require(all(b < a for a, b in zip(losses, losses[1:])),
             "the MLM loss did not fall strictly over the AdamW steps")

    times = []
    for _ in range(n_timed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(params, opt, tokens, None, mask)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    med = float(np.median(times))
    tok_s = bsz * seq / med
    print(f"  {name} step times s {[round(t, 5) for t in sorted(times)]}: "
          f"median {med:.5f} s, {tok_s:.1f} encoder training tokens/s "
          f"(B={bsz}, L={seq}, MLM forward + backward + AdamW, fixed mask)")
    if not heads:
        print("phase encoder: ok")
    return counts[0], tok_s


def phase_window_train(torch, dev):
    """The windowed model (A8) trained at the JAX suite's long-context entry
    (bench/suite.py:1003-1053): models.long_context_config (window 4096),
    fresh weights from seed 0, make_train_step's AdamW (lr 1e-3) on tokens
    [1, 32769] from np.random.default_rng(0).  Step 0's loss and every
    gradient against the same model with the plain attention patched in
    (blockwise over the bands), beside controls: each row's band shifted
    back one key (its diagonal hidden) in the forward and, on H3 itself,
    in the backward, and the band dropped (full causal) in the forward.
    Then a warm-up and 5 timed steps, each launching H1, H3-dkv and H3-dq
    once a layer; the last loss must be below the first, the suite's gate
    (bench/suite.py:1045-1048)."""
    from unittest import mock

    from exploring_flash_attention_tpu_torch.models import (
        init_params,
        long_context_config,
        loss_fn,
        make_train_step,
        make_trainable,
        named_param_leaves,
    )
    from exploring_flash_attention_tpu_torch.models import (
        transformer as transformer_module,
    )
    from exploring_flash_attention_tpu_torch.ops import (
        attention_bwd as attention_bwd_module,
    )

    cfg = long_context_config()
    (bsz, seq), n_timed = WINDOW_TRAIN, 5
    params = make_trainable(init_params(cfg, seed=0, device=dev))
    names, leaves = zip(*named_param_leaves(params))
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (bsz, seq + 1)).astype(np.int32)).to(dev)
    inputs, targets = tokens[:, :-1], tokens[:, 1:]

    def loss_and_grads():
        loss = loss_fn(params, inputs, targets, cfg)
        return loss.item(), torch.autograd.grad(loss, leaves)

    def loss_only(attention):
        with mock.patch.object(transformer_module, "flash_attention",
                               attention), torch.no_grad():
            return loss_fn(params, inputs, targets, cfg).item()

    loss_k, grads_k = loss_and_grads()
    with mock.patch.object(transformer_module, "flash_attention",
                           plain_flash_attention):
        loss_p, grads_p = loss_and_grads()
    loss_bad = loss_only(functools.partial(plain_flash_attention, hidden=1))
    loss_full = loss_only(
        lambda q, k, v, causal=True, window=None, config=None:
        plain_flash_attention(q, k, v, causal))
    with mock.patch.object(attention_bwd_module, "masked_attention_bwd",
                           functools.partial(
                               shifted_bwd,
                               attention_bwd_module.masked_attention_bwd)):
        grads_bad = loss_and_grads()[1]
    e_grad, leaf = leaf_err(names, grads_k, grads_p)
    e_bad, leaf_bad = leaf_err(names, grads_bad, grads_p)
    del grads_k, grads_p, grads_bad
    ctl = {"band shifted back one key": abs(loss_bad - loss_p),
           "band dropped (full causal)": abs(loss_full - loss_p)}
    print(f"  window_train B={bsz} L={seq} window {cfg.window}: step-0 loss "
          f"{loss_k:.6f}, with the plain attention {loss_p:.6f}: |d| "
          f"{abs(loss_k - loss_p):.3e} (tol {TRAIN_LOSS_TOL:g}), controls "
          f"in the forward: "
          + ", ".join(f"{n} {x:.3e}" for n, x in ctl.items())
          + f"; largest per-leaf ||dg||/||g|| over {len(leaves)} leaves vs "
          f"the plain path {e_grad:.3e} at {leaf} (tol {GRAD_REL_TOL:g}), "
          f"control (band shifted back one key in H3) {e_bad:.3e} at "
          f"{leaf_bad}")
    _require(math.isfinite(loss_k), "step-0 loss not finite")
    _require(abs(loss_k - loss_p) < TRAIN_LOSS_TOL,
             "the windowed step-0 loss differs from the plain path's")
    _require(min(ctl.values()) > TRAIN_LOSS_TOL,
             "the windowed loss check cannot tell a wrong band")
    _require(e_grad < GRAD_REL_TOL,
             "windowed gradients differ from the plain path's")
    _require(e_bad > GRAD_REL_TOL,
             "the windowed gradient check cannot tell a wrong backward")

    step, opt_init = make_train_step(cfg)
    opt = opt_init(params)
    want = launches_only(h1=cfg.n_layers, h3dkv=cfg.n_layers,
                         h3dq=cfg.n_layers)
    losses, counts, times = [], [], []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(1 + n_timed):                     # a warm-up, then timed
        zero_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(step(params, opt, tokens).item())
        times.append(time.perf_counter() - t0)
        counts.append(read_counters())
    med = float(np.median(times[1:]))
    tok_s = bsz * seq / med
    print(f"  window_train launches per step {counts[0]} (expected {want}); "
          f"AdamW losses {[round(x, 6) for x in losses]}; timed steps s "
          f"{[round(t, 5) for t in sorted(times[1:])]}: median {med:.5f} s, "
          f"{tok_s:.1f} training tokens/s (B={bsz}, L={seq}, window "
          f"{cfg.window}, forward + backward + AdamW); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    _require(all(c == want for c in counts), "a windowed step missed a kernel")
    _require(all(math.isfinite(x) for x in losses), "a loss is not finite")
    _require(losses[-1] < losses[0], "the windowed loss did not fall over "
             "the steps (bench/suite.py:1045-1048's gate)")
    print("phase window_train: ok")
    return counts[0], tok_s


def phase_window_generate(torch, dev):
    """The windowed model (A8) served: models.long_context_config
    (window 4096), weights from seed 0, GenerationEngine (page size 128,
    max_len 5120) on [8, 4608] prompts, longer than the window (4 pages
    of 128 fall wholly before every band), for 24 tokens held, then a
    256-token second turn (turn 1's last token and 255 new ones) and 24
    more.  Counters: turn 1 H1 4, H6-decode 92; turn 2 H6-extend 4,
    H6-decode 92; H2 0 in both.  Tokens against the windowed full
    forward's argmax (agreement or a near-tie), the cache after turn 2
    against forward_collect_kv over the stream, each beside its controls:
    a decode without its band and a turn one token short for the tokens, a
    stream one token short for the cache.  Turn 1's tokens (its decode
    steps replayed as a CUDA graph) bitwise those of a loop over
    _decode_forward; each patched control builds its engine, and captures
    its graph, under the patch."""
    from unittest import mock

    from exploring_flash_attention_tpu_torch.models import (
        GenerationEngine,
        forward_collect_kv,
        init_params,
        long_context_config,
    )
    from exploring_flash_attention_tpu_torch.models import (
        generate as generate_module,
    )
    from exploring_flash_attention_tpu_torch.serving import (
        gather_kv,
        paged_decode_attention,
    )
    from exploring_flash_attention_tpu_torch.utils.profile_generate import (
        eager_generate,
    )

    cfg = long_context_config()
    params = init_params(cfg, seed=0, device=dev)
    bsz, l_prompt, n_new, l_turn, max_len = WINDOW_GENERATE
    prompt = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (bsz, l_prompt)).astype(np.int32)
    eng = GenerationEngine(params, cfg, max_seqs=bsz, max_len=max_len)
    zero_counters()
    out1 = eng.generate(prompt, max_new_tokens=n_new, hold=True)
    turn1 = read_counters()
    turn = np.concatenate([out1[:, -1:], np.random.default_rng(1).integers(
        0, cfg.vocab_size, (bsz, l_turn - 1)).astype(np.int32)], axis=1)
    zero_counters()
    out2 = eng.continue_generation(turn, max_new_tokens=n_new)
    turn2 = read_counters()
    steps = cfg.n_layers * (n_new - 1)
    want1 = launches_only(h1=cfg.n_layers, h6=steps)
    want2 = launches_only(h6e=cfg.n_layers, h6=steps)
    print(f"  window_generate launches turn 1 {turn1} (expected {want1}), "
          f"turn 2 {turn2} (expected {want2})")
    _require(turn1 == want1 and turn2 == want2,
             "the windowed generation missed a kernel")
    for out in (out1, out2):
        _require(out.shape == (bsz, n_new) and out.dtype == np.int32
                 and (out >= 0).all() and (out < cfg.vocab_size).all(),
                 f"bad tokens {out.shape} {out.dtype}")

    prefix = np.concatenate([prompt, out1, turn[:, 1:]], axis=1)
    stream = np.concatenate([prefix, out2[:, :-1]], axis=1)
    short = np.concatenate([prompt, out1[:, :-1], turn[:, 1:], out2[:, :-1]],
                           axis=1)
    n = stream.shape[1]
    _, kvs = forward_collect_kv(params, torch.from_numpy(stream).to(dev), cfg)
    _, kvs_bad = forward_collect_kv(params, torch.from_numpy(short).to(dev),
                                    cfg)
    e_kv = e_bad = 0.0
    for cache, (k_ref, v_ref), (k_bad, _) in zip(eng.caches, kvs, kvs_bad):
        _require(bool((cache.seq_lens[:bsz] == n).all()),
                 f"cache lengths {cache.seq_lens.tolist()}, expected {n}")
        for s in range(bsz):
            k, v = gather_kv(cache, s)
            e_kv = max(e_kv,
                       (k - k_ref[s].transpose(0, 1)).abs().max().item(),
                       (v - v_ref[s].transpose(0, 1)).abs().max().item())
            e_bad = max(e_bad, (k[:, :n - 1] - k_bad[s].transpose(0, 1))
                        .abs().max().item())
    del kvs, kvs_bad
    eng.release()
    free = eng.allocator.free_pages

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again1 = eng.generate(prompt, max_new_tokens=n_new, hold=True)
    torch.cuda.synchronize()
    dt1 = time.perf_counter() - t0
    again2 = eng.continue_generation(turn, max_new_tokens=n_new)
    torch.cuda.synchronize()
    dt2 = time.perf_counter() - t0 - dt1
    eng.release()
    eager, dt_eager = timed_eager_generate(torch, eager_generate, eng,
                                           prompt, n_new)

    # controls: the band dropped in decode (turn 1) and turn 2 without its
    # first token, both required to fail; and, printed, every decode step
    # with its newest token hidden and the decode band one key narrower
    def hide_newest(q, cache, slots, window=None):
        with newest_token_hidden(cache, slots):
            return paged_decode_attention(q, cache, slots, window=window)

    def narrower(q, cache, slots, window=None):
        return paged_decode_attention(q, cache, slots, window=window - 1)

    def no_band(q, cache, slots, window=None):
        return paged_decode_attention(q, cache, slots)

    # each patched engine is built, and its decode graph captured, under
    # the patch; ran counts the patched calls
    bad, ran = {}, []
    for name, fn in (("newest token hidden", hide_newest),
                     ("decode window one key narrower", narrower),
                     ("band dropped in decode", no_band)):
        def patched(*args, fn=fn, **kw):
            ran.append(name)
            return fn(*args, **kw)

        with mock.patch.object(generate_module, "paged_decode_attention",
                               patched):
            bad[name] = (prompt, GenerationEngine(
                params, cfg, max_seqs=bsz, max_len=max_len).generate(
                    prompt, max_new_tokens=n_new))
        _require(name in ran, f"the patched decode ({name}) never ran")
    eng.generate(prompt, max_new_tokens=n_new, hold=True)
    bad["turn 2 without its first token"] = (prefix, eng.continue_generation(
        turn[:, 1:], max_new_tokens=n_new))
    eng.release()
    agree1, steps1, gap1 = compare_with_full_forward(torch, params, cfg,
                                                     prompt, out1)
    agree2, steps2, gap2 = compare_with_full_forward(torch, params, cfg,
                                                     prefix, out2)
    ctl = {name: compare_with_full_forward(torch, params, cfg, pre, out)
           for name, (pre, out) in bad.items()}
    short_turn = ctl.pop("turn 2 without its first token")
    no_band_turn = ctl.pop("band dropped in decode")
    print(f"  window_generate cache after turn 2 ({n} tokens, window "
          f"{cfg.window}): max|dK|,|dV| vs forward_collect_kv over the "
          f"stream {e_kv:.3e} (tol {CACHE_KV_TOL:g}), control (stream one "
          f"token short) {e_bad:.3e}; pages free after release {free}/"
          f"{eng.allocator.n_pages}")
    print(f"  window_generate B={bsz} prompt {l_prompt}: turn 1 {dt1:.4f} s "
          f"({bsz * n_new / dt1:.1f} tokens/s incl. prefill, decode steps "
          f"replayed as a CUDA graph; {bsz * n_new / dt_eager:.1f} tokens/s "
          f"with them eager, {dt_eager:.4f} s), turn 2 {dt2:.4f} s "
          f"({bsz * n_new / dt2:.1f} tokens/s incl. the extend); turn 1 "
          f"tokens of the graphed engine bitwise those of the eager loop "
          f"over _decode_forward: {bool(np.array_equal(out1, eager))}; "
          f"the patched decodes ran {len(ran)} times; repeats identical: "
          f"{bool(np.array_equal(out1, again1) and np.array_equal(out2, again2))}"
          f"; full-forward agreement turn 1 {agree1}/{steps1}, largest gap "
          f"of a disagreement {gap1:.4f}; turn 2 {agree2}/{steps2}, "
          f"{gap2:.4f} (limit {LOGIT_GAP}); controls: band dropped in "
          f"decode (turn 1) {no_band_turn[0]}/{no_band_turn[1]}, largest gap "
          f"{no_band_turn[2]:.4f}, turn 2 without its first token "
          f"{short_turn[0]}/{short_turn[1]}, largest gap "
          f"{short_turn[2]:.4f}; one-key controls (not required to fail: "
          f"over 4096 keys a one-key fault moves no logit beyond a near-tie "
          f"at random weights, the decode phase's windowed case catches "
          f"it): " + ", ".join(f"{name} {a}/{st}, largest gap {g:.4f}"
                               for name, (a, st, g) in ctl.items()))
    _require(e_kv < CACHE_KV_TOL, "the windowed cache after turn 2 differs "
             "from the forward over the stream")
    _require(e_bad > CACHE_KV_TOL,
             "the cache check cannot tell a stream one token short")
    _require(free == eng.allocator.n_pages, "release() kept pages")
    _require(np.array_equal(out1, eager),
             "the graphed windowed decode differs from the eager loop")
    _require(max(gap1, gap2) < LOGIT_GAP, "a windowed token differs from "
             "the windowed full forward's beyond a tie")
    _require(min(short_turn[2], no_band_turn[2]) >= LOGIT_GAP,
             "the windowed full-forward check cannot tell a decode without "
             "its band or a turn one token short")
    print("phase window_generate: ok")
    return turn1, turn2, {"turn1_tokens_s": bsz * n_new / dt1,
                          "turn1_eager_tokens_s": bsz * n_new / dt_eager,
                          "turn2_tokens_s": bsz * n_new / dt2}


def timed(torch, fn, repeats=1):
    """(the last call's result, the least host seconds of ``repeats``
    synchronized calls)."""
    best = None
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    return out, best


def spec_leg(torch, eng, prompt, n_new, gamma, repeats=3):
    """One SpeculativeEngine leg: a first call with every counter zeroed
    (its first round eager, then replays of the round's CUDA graph), which
    must launch H1 once per layer of each model's prefill, H6-extend once
    per target layer a round and, with a paged draft, H6-decode gamma + 1
    times per draft layer a round; then ``repeats`` graphed calls (the
    least time kept) and one with every round eager, all bitwise the
    first call's tokens."""
    zero_counters()
    out, stats = eng.generate(prompt, n_new, gamma=gamma)
    torch.cuda.synchronize()
    launches = read_counters()
    rounds = int(stats["rounds"])
    t_layers, d_layers = eng.tcfg.n_layers, eng.dcfg.n_layers
    want = launches_only(
        h1=t_layers + d_layers, h6e=rounds * t_layers,
        h6=rounds * (gamma + 1) * d_layers if eng.draft_mode == "paged"
        else 0)
    _require(launches == want, f"a speculative generate launched {launches}, "
             f"expected {want}")
    (again, _), dt = timed(torch, lambda: eng.generate(prompt, n_new,
                                                       gamma=gamma), repeats)
    eng.graphed = False
    try:
        (eager, _), dt_eager = timed(torch, lambda: eng.generate(
            prompt, n_new, gamma=gamma))
    finally:
        eng.graphed = True
    _require(np.array_equal(out, again) and np.array_equal(out, eager),
             "the graphed rounds' tokens differ from the eager rounds'")
    _require(out.shape == (prompt.shape[0], n_new) and out.dtype == np.int32
             and (out >= 0).all() and (out < eng.tcfg.vocab_size).all(),
             f"bad tokens {out.shape} {out.dtype}")
    tokens = prompt.shape[0] * n_new
    return out, {"launches": launches, "rounds": rounds,
                 "acceptance": stats["acceptance_rate"],
                 "tokens_per_round": stats["tokens_per_round"],
                 "tokens_s": tokens / dt, "eager_tokens_s": tokens / dt_eager}


def spec_gate(torch, params, cfg, prompt, out, vanilla):
    """Every speculative token against the full forward's argmax over its
    own prefix (agreement, or a near-tie under LOGIT_GAP), and how many
    equal vanilla greedy decoding's."""
    with torch.no_grad():
        agree, steps, gap = compare_with_full_forward(torch, params, cfg,
                                                      prompt, out)
    return {"agree": agree, "steps": steps, "worst_gap": gap,
            "equal_to_vanilla": int((out == vanilla).sum())}


def markov_source(seed, sub, det_p):
    """bench_spec_decode_distilled's task (bench/suite.py:1531-1545): a
    permutation of a sub-vocabulary, each next token its successor with
    probability det_p, else uniform; every draw from one
    np.random.default_rng(seed), in the suite's order."""
    rng = np.random.default_rng(seed)
    succ = rng.permutation(sub).astype(np.int64)

    def markov(n, length):
        out = np.empty((n, length), np.int64)
        out[:, 0] = rng.integers(0, sub, n)
        for t in range(1, length):
            det = succ[out[:, t - 1]]
            noise = rng.integers(0, sub, n)
            out[:, t] = np.where(rng.random(n) < det_p, det, noise)
        return out.astype(np.int32)

    return markov


def phase_speculative(torch, dev, lm):
    """Speculative decoding on the port at the JAX suite's two entries.
    bench_spec_decode (bench/suite.py:1380-1495): the flagship target
    (seed 0) with a 1-layer draft at its widths (seed 7, paged), then with
    itself as the draft, on the [8, 256] prompts for 24 tokens, gamma 4;
    bench_spec_decode_distilled (:1498-1620): the flagship trained 300
    AdamW steps on the det_p 0.9 Markov task, a tiny draft distilled from
    it for 600 steps (distill_draft: its corpus on H1 and H6-decode, its
    steps on H1 and H3), then 8 x 256 Markov prompts for 128 tokens with
    the dense draft (window 128) at gamma 12, 16 and 20.  Each leg's
    launches, its graphed rounds bitwise its eager ones, every token
    against the full forward (agreement or a near-tie), tokens/s graphed
    and eager beside the vanilla engine's on the same prompts.  Controls:
    the rollback one token late (required to fail the token check), the
    verify with every chunk row's own key hidden (shown)."""
    from unittest import mock

    from exploring_flash_attention_tpu_torch.models import (
        GenerationEngine,
        SpeculativeEngine,
        init_params,
    )
    from exploring_flash_attention_tpu_torch.models import (
        generate as generate_module,
    )
    from exploring_flash_attention_tpu_torch.models import (
        speculative as spec_module,
    )
    from exploring_flash_attention_tpu_torch.serving import (
        paged_extend_attention,
        set_seq_lens,
    )

    cfg, params, prompt = lm.cfg, lm.params, lm.prompt
    bsz, _, n_new, gamma, max_len = SPEC_SHAPE
    dcfg = dataclasses.replace(cfg, n_layers=1)
    dparams = init_params(dcfg, seed=7, device=dev)
    van = GenerationEngine(params, cfg, max_seqs=bsz, max_len=max_len)
    van.generate(prompt, n_new)
    vanilla, dt = timed(torch, lambda: van.generate(prompt, n_new), 3)
    out = {"vanilla_tokens_s": bsz * n_new / dt, "legs": {}}
    for name, (dp, dc) in (("random draft", (dparams, dcfg)),
                           ("self draft", (params, cfg))):
        eng = SpeculativeEngine(params, cfg, dp, dc, max_seqs=bsz,
                                max_len=max_len)
        toks, leg = spec_leg(torch, eng, prompt, n_new, gamma)
        leg["gate"] = spec_gate(torch, params, cfg, prompt, toks, vanilla)
        out["legs"][name] = leg
        del eng

    # controls, each engine built (and its round captured) under its patch
    ran = []

    def late_rollback(cache, slots, new_lens):
        ran.append("rollback")
        return set_seq_lens(cache, slots, new_lens + 1)

    def hide_newest(q, cache, slots, window=None):
        ran.append("verify")
        with newest_token_hidden(cache, slots):
            return paged_extend_attention(q, cache, slots, window=window)

    controls = {}
    for name, module, attr, fn in (
            ("rollback one token late", spec_module, "set_seq_lens",
             late_rollback),
            ("verify with each row's own key hidden", generate_module,
             "paged_extend_attention", hide_newest)):
        with mock.patch.object(module, attr, fn):
            bad = SpeculativeEngine(params, cfg, dparams, dcfg, max_seqs=bsz,
                                    max_len=max_len).generate(
                prompt, n_new, gamma=gamma)[0]
        controls[name] = spec_gate(torch, params, cfg, prompt, bad, vanilla)
    for name, leg in out["legs"].items():
        g = leg["gate"]
        print(f"  speculative {name} (B={bsz}, prompt {prompt.shape[1]}, "
              f"{n_new} new, gamma {gamma}, paged draft): launches "
              f"{leg['launches']}; {leg['rounds']} rounds, acceptance "
              f"{leg['acceptance']:.4f}, {leg['tokens_per_round']:.3f} tokens "
              f"a round; {leg['tokens_s']:.1f} tokens/s graphed, "
              f"{leg['eager_tokens_s']:.1f} eager, vanilla "
              f"{out['vanilla_tokens_s']:.1f}; tokens equal to vanilla "
              f"{g['equal_to_vanilla']}/{g['steps']}; full-forward agreement "
              f"{g['agree']}/{g['steps']}, largest gap of a disagreement "
              f"{g['worst_gap']:.4f} (limit {LOGIT_GAP})")
        _require(g["worst_gap"] < LOGIT_GAP, f"a speculative token ({name}) "
                 "differs from the full forward's beyond a tie")
    print("  speculative controls (patched before each capture; the patches "
          f"ran {len(ran)} times): " + "; ".join(
              f"{n} {c['agree']}/{c['steps']}, largest gap "
              f"{c['worst_gap']:.4f}" for n, c in controls.items()))
    _require(set(ran) == {"rollback", "verify"}, "a patched control never ran")
    _require(controls["rollback one token late"]["worst_gap"] >= LOGIT_GAP,
             "the token check cannot tell a rollback one token late")
    out["controls"] = controls
    del van
    out["distilled"] = distilled_legs(torch, dev, cfg)
    print("phase speculative: ok")
    return out


def distilled_legs(torch, dev, cfg):
    """bench_spec_decode_distilled on the port (see phase_speculative)."""
    from exploring_flash_attention_tpu_torch.models import (
        GenerationEngine,
        ModelConfig,
        SpeculativeEngine,
        distill_draft,
        init_params,
        make_train_step,
        make_trainable,
    )

    s = SPEC_DISTILL
    markov = markov_source(11, s["sub"], s["det_p"])
    tparams = make_trainable(init_params(cfg, seed=0, device=dev))
    step, opt_init = make_train_step(cfg)
    opt = opt_init(tparams)
    t0 = time.perf_counter()
    losses = [step(tparams, opt, markov(*s["train_shape"]))
              for _ in range(s["train_steps"])]
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    del opt
    tiny = ModelConfig(vocab_size=cfg.vocab_size, n_layers=1, n_heads=4,
                       n_kv_heads=4, d_model=512, d_head=128, d_ff=2048,
                       dtype=torch.bfloat16)
    zero_counters()
    t0 = time.perf_counter()
    dparams, dst = distill_draft(
        tparams, cfg, init_params(tiny, seed=7, device=dev), tiny,
        steps=s["distill_steps"], batch=16, n_seqs=s["n_prompts"], seed=3,
        prompts=markov(s["n_prompts"], s["prompt_len"]))
    torch.cuda.synchronize()
    distill_s = time.perf_counter() - t0
    launches = read_counters()
    steps, n_dec = s["distill_steps"], 256 - s["prompt_len"] - 1
    want = launches_only(h1=2 * cfg.n_layers + steps * tiny.n_layers,
                         h6=cfg.n_layers * n_dec, h3dkv=steps * tiny.n_layers,
                         h3dq=steps * tiny.n_layers)
    print(f"  distilled: target trained {s['train_steps']} AdamW steps on "
          f"the Markov task in {train_s:.1f} s (loss {losses[0].item():.4f} "
          f"-> {losses[-1].item():.4f}); draft distilled in {distill_s:.1f} "
          f"s, agreement {dst['agree_first']:.4f} -> {dst['agree_last']:.4f}"
          f", loss {dst['loss_last']:.4f}; launches of distill_draft "
          f"{launches} (expected {want})")
    _require(launches == want, "distill_draft missed a kernel")
    _require(losses[-1].item() < losses[0].item(),
             "the target's Markov loss did not fall")
    mprompt = markov(SPEC_SHAPE[0], s["prompt"])
    bsz, n_new = mprompt.shape[0], s["new"]
    van = GenerationEngine(tparams, cfg, max_seqs=bsz, max_len=s["max_len"])
    van.generate(mprompt, n_new)
    vanilla, dt = timed(torch, lambda: van.generate(mprompt, n_new), 3)
    out = {"train_s": train_s, "distill_s": distill_s, "distill": dst,
           "distill_launches": launches, "vanilla_tokens_s": bsz * n_new / dt,
           "gammas": {}}
    for g in s["gammas"]:
        eng = SpeculativeEngine(tparams, cfg, dparams, tiny, max_seqs=bsz,
                                max_len=s["max_len"], draft_mode="dense",
                                draft_window=s["window"])
        toks, leg = spec_leg(torch, eng, mprompt, n_new, g)
        leg["gate"] = spec_gate(torch, tparams, cfg, mprompt, toks, vanilla)
        out["gammas"][g] = leg
        gate = leg["gate"]
        print(f"  speculative distilled gamma {g} (B={bsz}, Markov prompt "
              f"{s['prompt']}, {n_new} new, dense draft window "
              f"{s['window']}): launches {leg['launches']}; {leg['rounds']} "
              f"rounds, acceptance {leg['acceptance']:.4f}, "
              f"{leg['tokens_per_round']:.3f} tokens a round; "
              f"{leg['tokens_s']:.1f} tokens/s graphed, "
              f"{leg['eager_tokens_s']:.1f} eager, vanilla "
              f"{out['vanilla_tokens_s']:.1f}; tokens equal to vanilla "
              f"{gate['equal_to_vanilla']}/{gate['steps']}; full-forward "
              f"agreement {gate['agree']}/{gate['steps']}, largest gap "
              f"{gate['worst_gap']:.4f} (limit {LOGIT_GAP})")
        _require(gate["worst_gap"] < LOGIT_GAP, "a distilled speculative "
                 "token differs from the full forward's beyond a tie")
        del eng
    return out


def phase_seq2seq(torch, dev):
    """The seq2seq family (A7) at the flagship's widths and JAX's default
    depths (2 encoder, 2 decoder layers), trained by
    make_seq2seq_train_step (Adam, lr 3e-3) on src [8, 1024] and tgt
    [8, 257] from np.random.default_rng(0).  Every step launches H1, H3-dkv
    and H3-dq 6 times each: the encoder's self-attention without a mask,
    the decoder's causal, the cross attention without a mask at Lq = 256,
    Lkv = 1024.  The step-0 loss and every gradient against the plain
    attention patched in, beside controls required to fail: the decoder's
    self-attention without its causal mask (loss), the cross backward
    without its last 64 source keys (gradients); shown, not required: the
    forward's cross attention without its last 64 keys and with one key
    hidden.  The loss must fall over 10 steps.  The bwd phase holds H3
    itself at the cross shape, with the last 64-key tile dropped as its
    control."""
    from unittest import mock

    from exploring_flash_attention_tpu_torch.models import (
        Seq2SeqConfig,
        flagship_config,
        init_seq2seq_params,
        make_seq2seq_train_step,
        make_trainable,
        seq2seq_loss,
        tree_leaves,
    )
    from exploring_flash_attention_tpu_torch.models import (
        seq2seq as s2s_module,
    )
    from exploring_flash_attention_tpu_torch.ops import (
        attention_bwd as attention_bwd_module,
    )
    from exploring_flash_attention_tpu_torch.ops.attention_bwd import (
        attention_bwd_plain,
    )
    from exploring_flash_attention_tpu_torch.utils.profile_train import (
        split_step,
    )

    cfg = Seq2SeqConfig(base=flagship_config(), n_enc_layers=2,
                        n_dec_layers=2)
    bsz, l_src, l_tgt = SEQ2SEQ_SHAPE
    params = make_trainable(init_seq2seq_params(cfg, seed=0, device=dev))
    leaves = tree_leaves(params)
    names = [f"leaf {i}" for i in range(len(leaves))]
    rng = np.random.default_rng(0)
    vocab = cfg.base.vocab_size
    src = torch.from_numpy(rng.integers(0, vocab, (bsz, l_src)).astype(
        np.int32)).to(dev)
    tgt = torch.from_numpy(rng.integers(0, vocab, (bsz, l_tgt + 1)).astype(
        np.int32)).to(dev)

    def loss_and_grads():
        loss = seq2seq_loss(params, src, tgt, cfg)
        return loss.item(), torch.autograd.grad(loss, leaves)

    def cross_dropped(n):
        def attention(q, k, v, causal=False, config=None):
            if q.shape[2] != k.shape[2]:            # the cross attention
                k, v = k[:, :, :-n], v[:, :, :-n]
            return plain_flash_attention(q, k, v, causal=causal)
        return attention

    kernel_bwd = attention_bwd_module.masked_attention_bwd

    def cross_bwd_dropped(q, k, v, out, do, lse, scale, causal, diag_off,
                          window):
        if q.shape[2] == k.shape[2]:
            return kernel_bwd(q, k, v, out, do, lse, scale, causal,
                              diag_off, window)
        dq, dk, dv = attention_bwd_plain(q, k[:, :, :-64], v[:, :, :-64],
                                         out, do, lse, scale, False)
        pad = lambda x: torch.nn.functional.pad(x, (0, 0, 0, 64))  # noqa
        return dq, pad(dk), pad(dv)

    def sees_future(q, k, v, causal=False, config=None):
        return plain_flash_attention(q, k, v, causal=False)

    loss_k, grads_k = loss_and_grads()
    with mock.patch.object(s2s_module, "flash_attention",
                           plain_flash_attention):
        loss_p, grads_p = loss_and_grads()
    with mock.patch.object(s2s_module, "flash_attention", sees_future):
        loss_bad = loss_and_grads()[0]
    shown = {}                  # cross-attention faults: (loss, gradients)
    for n in (64, 1):
        with mock.patch.object(s2s_module, "flash_attention",
                               cross_dropped(n)):
            shown[n] = loss_and_grads()
    with mock.patch.object(attention_bwd_module, "masked_attention_bwd",
                           cross_bwd_dropped):
        grads_bad = loss_and_grads()[1]
    e_grad, leaf = leaf_err(names, grads_k, grads_p)
    e_bad, leaf_bad = leaf_err(names, grads_bad, grads_p)
    shown = {n: (abs(x - loss_p), leaf_err(names, g, grads_p)[0])
             for n, (x, g) in shown.items()}
    del grads_k, grads_p, grads_bad
    print(f"  seq2seq step-0 loss {loss_k:.6f} over {bsz * l_tgt} target "
          f"tokens, with the plain attention {loss_p:.6f}: |d| "
          f"{abs(loss_k - loss_p):.3e} (tol {SEQ2SEQ_LOSS_TOL:g}), control "
          f"(the decoder's self-attention sees the future) "
          f"{abs(loss_bad - loss_p):.3e}; largest per-leaf ||dg||/||g|| "
          f"over {len(leaves)} leaves vs the plain path {e_grad:.3e} at "
          f"{leaf} (tol {GRAD_REL_TOL:g}), control (the cross backward "
          f"without its last 64 source keys) {e_bad:.3e} at {leaf_bad}; "
          f"shown, not required (a cross attention over 1024 keys of a "
          f"random model is near their average): the forward's cross "
          f"attention without its last 64 source keys |d loss| "
          f"{shown[64][0]:.3e}, gradients {shown[64][1]:.3e}; with one "
          f"source key hidden {shown[1][0]:.3e}, {shown[1][1]:.3e}")
    _require(math.isfinite(loss_k), "seq2seq step-0 loss not finite")
    _require(abs(loss_k - loss_p) < SEQ2SEQ_LOSS_TOL,
             "the seq2seq step-0 loss differs from the plain path's")
    _require(abs(loss_bad - loss_p) > SEQ2SEQ_LOSS_TOL,
             "the seq2seq loss check cannot tell a decoder that sees the "
             "future")
    _require(e_grad < GRAD_REL_TOL,
             "seq2seq gradients differ from the plain path's")
    _require(e_bad > GRAD_REL_TOL, "the seq2seq gradient check cannot tell "
             "a cross backward short of 64 keys")

    step, opt_init = make_seq2seq_train_step(cfg)
    opt = opt_init(params)
    n_attn = cfg.n_enc_layers + 2 * cfg.n_dec_layers
    want = launches_only(h1=n_attn, h3dkv=n_attn, h3dq=n_attn)
    losses, counts = [], []
    for _ in range(SEQ2SEQ_STEPS):
        zero_counters()
        losses.append(step(params, opt, src, tgt).item())
        counts.append(read_counters())
    print(f"  seq2seq launches per step {counts[0]} (expected {want}); Adam "
          f"losses over {SEQ2SEQ_STEPS} steps "
          f"{[round(x, 6) for x in losses]}")
    _require(all(c == want for c in counts), "a seq2seq step missed a kernel")
    _require(all(math.isfinite(x) for x in losses), "a loss is not finite")
    _require(losses[-1] < losses[0], "the seq2seq loss did not fall")
    parts = np.array([split_step(step, params, opt, src, tgt,
                                 module=s2s_module,
                                 loss_name="seq2seq_loss")[0]
                      for _ in range(5)])
    med = np.median(parts, axis=0)
    step_s = float(np.median(parts.sum(axis=1)))
    out = {"launches": counts[0], "losses": losses, "step_ms": step_s * 1e3,
           "forward_ms": med[0] * 1e3, "backward_ms": med[1] * 1e3,
           "optimizer_ms": med[2] * 1e3,
           "target_tokens_s": bsz * l_tgt / step_s,
           "tokens_s": bsz * (l_src + l_tgt) / step_s}
    print(f"  seq2seq step (B={bsz}, L_src={l_src}, L_tgt={l_tgt}, median of "
          f"5, synchronized at each part): {out['step_ms']:.3f} ms = forward "
          f"and loss {out['forward_ms']:.3f} + backward "
          f"{out['backward_ms']:.3f} + Adam {out['optimizer_ms']:.3f}; "
          f"{out['target_tokens_s']:.1f} target tokens/s, "
          f"{out['tokens_s']:.1f} source + target tokens/s")
    print("phase seq2seq: ok")
    return out


def h3_instance(d, f32=False):
    """H3's instance for head dim d: the smallest of 32, 64, 128, 256 at or
    above it; at f32 of 64, 128 and 256."""
    return next(x for x in ((64, 128, 256) if f32 else (32, 64, 128, 256))
                if d <= x)


def h3_times(torch, q, k, v, do, causal):
    """H3 at q, k, v and do's shape (the static diagonal 0), causal or
    without a mask: CUDA-event medians (L2 flushed before each call) of
    each kernel alone, the delta reduction alone and the pair through
    flash_attention_bwd, against the whole plain backward and the autograd
    backward of scaled_dot_product_attention under the same mask (K and V
    repeated over the group, its forward recorded once, outside the timed
    calls); each kernel's bound at the true d (8 d flops a visible pair
    for H3-dkv, 6 d for H3-dq, or each input read and output written
    once), and the tensor-core work its instance runs for the same pairs
    (the padded columns, (D - d) / D, and at bf16's D=256 the S and dP
    products that both warpgroups compute) over the true d's.  At f32
    inputs the bound counts the f32 kernels' six bf16 piece products a
    product, the bytes four a value, and SDPA's backward runs at f32 (TF32
    off); the f32 D=256 instance, a cluster of two blocks that split the
    columns, computes no product twice."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from exploring_flash_attention_tpu_torch.ops import (
        attention_bwd_dkv,
        attention_bwd_dq,
        attention_bwd_plain,
        flash_attention_bwd,
        prefill_attention,
    )
    from exploring_flash_attention_tpu_torch.utils import time_cuda

    b, hq, l, d = q.shape
    hkv = k.shape[1]
    s = 1.0 / math.sqrt(d)
    o, lse = prefill_attention(q, k, v, s, 0, causal)
    delta = (do.float() * o.float()).sum(dim=-1)
    leaves = [x.detach().clone().requires_grad_() for x in (
        q, k.repeat_interleave(hq // hkv, 1),
        v.repeat_interleave(hq // hkv, 1))]
    o_lib = sdpa(*leaves, is_causal=causal)
    lib = time_cuda(lambda: torch.autograd.grad(
        o_lib, leaves, do, retain_graph=True), n_iter=20)
    # the plain backward (tens of ms) over 3 calls, as kernel_times times
    # the plain versions
    plain = time_cuda(lambda: attention_bwd_plain(
        q, k, v, o, do, lse, s, causal, 0), n_iter=3, n_warmup=1)
    pairs = visible_pairs(l, l, causal, None) * b * hq
    f32 = q.dtype == torch.float32
    terms = H3_F32_TERMS if f32 else 1
    es = q.element_size()
    q_bytes, kv_bytes = b * hq * l * d * es, b * hkv * l * d * es
    row_bytes = b * hq * l * 4
    big = h3_instance(d, f32)
    twice = big == 256 and not f32     # S and dP in both warpgroups
    t = {"h3dkv": {"ms": time_cuda(lambda: attention_bwd_dkv(
             q, k, v, do, lse, delta, s, causal, 0), n_iter=20),
             "plain_ms": plain, "library_ms": lib,
             "instance_work_ratio": big / d * (1.5 if twice else 1)},
         "h3dq": {"ms": time_cuda(lambda: attention_bwd_dq(
             q, k, v, do, lse, delta, s, causal, 0), n_iter=20),
             "plain_ms": plain, "library_ms": lib,
             "instance_work_ratio": big / d * (5 / 3 if twice else 1)}}
    t["h3dkv"]["bound_ms"], t["h3dkv"]["bound_by"] = roofline(
        terms * 8 * d * pairs, 2 * q_bytes + 4 * kv_bytes + 2 * row_bytes)
    t["h3dq"]["bound_ms"], t["h3dq"]["bound_by"] = roofline(
        terms * 6 * d * pairs, 3 * q_bytes + 2 * kv_bytes + 2 * row_bytes)
    for x in t.values():
        x["bound_share"] = x["bound_ms"] / x["ms"]
    delta_ms = time_cuda(lambda: (do.float() * o.float()).sum(dim=-1),
                         n_iter=20)
    pair = time_cuda(lambda: flash_attention_bwd(
        q, k, v, o, do, lse, scale=s, causal=causal), n_iter=20)
    print(f"  times at B={b} Hq={hq} Hkv={hkv} L={l} d={d} (instance D="
          f"{big}), mask {'causal' if causal else 'none'}: H3-dkv "
          f"{t['h3dkv']['ms']:.4f} ms (bound {t['h3dkv']['bound_ms']:.4f} "
          f"ms, {t['h3dkv']['bound_share']:.1%}), H3-dq "
          f"{t['h3dq']['ms']:.4f} ms (bound {t['h3dq']['bound_ms']:.4f} "
          f"ms, {t['h3dq']['bound_share']:.1%}), the delta reduction "
          f"{delta_ms:.4f} ms, flash_attention_bwd (delta + both) "
          f"{pair:.4f} ms vs attention_bwd_plain {plain:.4f} ms and the "
          f"backward of scaled_dot_product_attention (is_causal={causal}) "
          f"{lib:.4f} ms")
    del leaves, o_lib
    return {**t, "delta_ms": delta_ms, "pair_ms": pair}


def time_kernels(torch, dev):
    """CUDA-event medians (L2 flushed before each call) of H3 at the
    training shape (h3_times); and H1 at the generation and training
    shapes and at the v1 phase's causal cross case beside
    scaled_dot_product_attention (is_causal where Lq == Lkv, a
    bottom-right boolean mask at Lq=512, Lkv=1024); the v1 phase times H1
    at the canonical shape."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from exploring_flash_attention_tpu_torch.ops import (
        attention_plain,
        prefill_attention,
    )
    from exploring_flash_attention_tpu_torch.utils import time_cuda

    gen = torch.Generator().manual_seed(2)
    q = _bf16(torch, dev, gen, 8, 8, 256, 128)
    k = _bf16(torch, dev, gen, 8, 4, 256, 128)
    v = _bf16(torch, dev, gen, 8, 4, 256, 128)
    s = 1.0 / math.sqrt(128)
    h1 = (time_cuda(lambda: prefill_attention(q, k, v, s, 0)),
          time_cuda(lambda: attention_plain(q, k, v, s, True, 0)))
    # Lq == Lkv here, so SDPA's top-left causal diagonal is H1's
    out = {"h1_causal_library": {"L=256": time_cuda(lambda: sdpa(
        q, k, v, is_causal=True, enable_gqa=True))}}

    def h1_bound(l, b=8, hq=8, hkv=4, d=128):
        """H1's causal bound at the slice's widths: q, k, v and o in bf16,
        the f32 LSE."""
        return roofline(4 * b * hq * d * visible_pairs(l, l, True, None),
                        2 * d * 2 * (b * hq * l + b * hkv * l)
                        + 4 * b * hq * l)[0]

    hq, hkv, d = 8, 4, 128
    # H3 at the training shape, causal (the train step) and without a mask
    # (the encoder step)
    b, l = 8, 1024
    q, do = (_bf16(torch, dev, gen, b, hq, l, d) for _ in range(2))
    k, v = (_bf16(torch, dev, gen, b, hkv, l, d) for _ in range(2))
    for causal in (True, False):
        out["h3_causal" if causal else "h3_none"] = h3_times(
            torch, q, k, v, do, causal)
    h1_long = time_cuda(lambda: prefill_attention(q, k, v, s, 0), n_iter=20)
    out["h1_causal_library"]["L=1024"] = time_cuda(lambda: sdpa(
        q, k, v, is_causal=True, enable_gqa=True), n_iter=20)
    # the v1 phase's causal cross case (B4 at Lq != Lkv): SDPA's is_causal
    # masks top-left, so its library call takes H1's bottom-right diagonal
    # as an explicit boolean mask
    lq, lkv = 512, 1024
    q = _bf16(torch, dev, gen, b, hq, lq, d)
    k, v = (_bf16(torch, dev, gen, b, hkv, lkv, d) for _ in range(2))
    i = torch.arange(lq, device=dev)[:, None]
    cross = torch.arange(lkv, device=dev)[None, :] <= i + lkv - lq
    out["h1_causal_library"]["Lq=512 Lkv=1024"] = time_cuda(lambda: sdpa(
        q, k, v, attn_mask=cross, enable_gqa=True), n_iter=20)
    h1_cross = time_cuda(lambda: prefill_attention(q, k, v, s, lkv - lq),
                         n_iter=20)
    cross_bound = roofline(4 * b * hq * d * visible_pairs(lq, lkv, True, None),
                           2 * d * 2 * (b * hq * lq + b * hkv * lkv))[0]
    print(f"  times (CUDA events, median of 50 calls, 20 at L=1024, L2 "
          f"flushed before each): "
          f"H1 {h1[0]:.4f} ms vs plain {h1[1]:.4f} ms (bound "
          f"{h1_bound(256):.4f} ms; scaled_dot_product_attention causal "
          f"{out['h1_causal_library']['L=256']:.4f} ms) at B=8 Hq=8 Hkv=4 "
          f"L=256 d=128 (the decode and extend phases time H6)")
    print(f"  times at B=8 Hq=8 Hkv=4 L=1024 d=128 causal: H1 forward "
          f"{h1_long:.4f} ms (bound {h1_bound(1024):.4f} "
          f"ms; scaled_dot_product_attention causal "
          f"{out['h1_causal_library']['L=1024']:.4f} ms)")
    print(f"  times at B=8 Hq=8 Hkv=4 Lq={lq} Lkv={lkv} d=128 causal (B4 "
          f"cross): H1 {h1_cross:.4f} ms (bound {cross_bound:.4f} ms); "
          f"scaled_dot_product_attention with the bottom-right boolean mask "
          f"{out['h1_causal_library']['Lq=512 Lkv=1024']:.4f} ms")
    del q, k, v
    out["window_train_shape"] = window_attention_times(torch, dev, gen)
    out["seq2seq_cross"] = cross_attention_times(torch, dev, gen)
    return out


def cross_attention_times(torch, dev, gen):
    """H1 and H3 without a mask at the seq2seq cross attention's shape
    (B=8, Hq=8, Hkv=4, Lq=256, Lkv=1024, d=128), each beside its plain
    version, its bound and the library call: scaled_dot_product_attention
    for H1, its autograd backward for H3 (each H3 kernel alone against the
    whole backward)."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from exploring_flash_attention_tpu_torch.ops import (
        attention_bwd_dkv,
        attention_bwd_dq,
        attention_bwd_plain,
        attention_plain,
        prefill_attention,
    )
    from exploring_flash_attention_tpu_torch.utils import time_cuda

    b, hq, hkv, lq, lkv, d = BWD_SHAPES[-1]
    s, off = 1.0 / math.sqrt(d), lkv - lq
    q, do = (_bf16(torch, dev, gen, b, hq, lq, d) for _ in range(2))
    k, v = (_bf16(torch, dev, gen, b, hkv, lkv, d) for _ in range(2))
    o, lse = prefill_attention(q, k, v, s, off, False)
    delta = (do.float() * o.float()).sum(dim=-1)
    leaves = [x.detach().clone().requires_grad_() for x in (
        q, k.repeat_interleave(hq // hkv, 1), v.repeat_interleave(hq // hkv,
                                                                  1))]
    o_lib = sdpa(*leaves)
    lib_bwd = time_cuda(lambda: torch.autograd.grad(
        o_lib, leaves, do, retain_graph=True), n_iter=20)
    plain_bwd = time_cuda(lambda: attention_bwd_plain(
        q, k, v, o, do, lse, s, False, off), n_iter=5, n_warmup=1)
    pairs = b * hq * lq * lkv
    q_bytes, kv_bytes = b * hq * lq * d * 2, b * hkv * lkv * d * 2
    row_bytes = b * hq * lq * 4
    t = {"h1": {"ms": time_cuda(lambda: prefill_attention(
             q, k, v, s, off, False), n_iter=20),
             "plain_ms": time_cuda(lambda: attention_plain(
                 q, k, v, s, False, off), n_iter=5, n_warmup=1),
             "library_ms": time_cuda(lambda: sdpa(q, k, v, enable_gqa=True),
                                     n_iter=20)},
         "h3dkv": {"ms": time_cuda(lambda: attention_bwd_dkv(
             q, k, v, do, lse, delta, s, False, off), n_iter=20),
             "plain_ms": plain_bwd, "library_ms": lib_bwd},
         "h3dq": {"ms": time_cuda(lambda: attention_bwd_dq(
             q, k, v, do, lse, delta, s, False, off), n_iter=20),
             "plain_ms": plain_bwd, "library_ms": lib_bwd}}
    work = {"h1": (4 * d * pairs, 2 * q_bytes + 2 * kv_bytes + row_bytes),
            "h3dkv": (8 * d * pairs, 2 * q_bytes + 4 * kv_bytes
                      + 2 * row_bytes),
            "h3dq": (6 * d * pairs, 3 * q_bytes + 2 * kv_bytes
                     + 2 * row_bytes)}
    for kern, (flop, nbytes) in work.items():
        t[kern]["bound_ms"], t[kern]["bound_by"] = roofline(flop, nbytes)
        t[kern]["bound_share"] = t[kern]["bound_ms"] / t[kern]["ms"]
    print(f"  times at the seq2seq cross shape B={b} Hq={hq} Hkv={hkv} "
          f"Lq={lq} Lkv={lkv} d={d}, no mask: "
          + "; ".join(f"{n} {t[n]['ms']:.4f} ms (bound "
                      f"{t[n]['bound_ms']:.4f}, {t[n]['bound_share']:.1%}; "
                      f"plain {t[n]['plain_ms']:.4f}; library "
                      f"{t[n]['library_ms']:.4f})" for n in t)
          + " (library: SDPA for H1, its whole autograd backward for H3)")
    return t


def window_attention_times(torch, dev, gen):
    """H1 and H3 at the windowed model's training shape (B=1, Hq=8, Hkv=4,
    L=32768, d=128) under its window and under the causal mask alone: the
    band's tiles must take under half the causal time (O(L * window)
    pairs, not O(L^2)).  SDPA takes a band only as a dense L x L boolean
    mask, over all L^2 pairs: its backward under that mask is H3's library
    time (:func:`window_library_bwd`)."""
    from exploring_flash_attention_tpu_torch.ops import (
        attention_bwd_dkv,
        attention_bwd_dq,
        prefill_attention,
    )
    from exploring_flash_attention_tpu_torch.utils import time_cuda

    (b, l), hq, hkv, d = WINDOW_TRAIN, 8, 4, 128
    s = 1.0 / math.sqrt(d)
    q, do = (_bf16(torch, dev, gen, b, hq, l, d) for _ in range(2))
    k, v = (_bf16(torch, dev, gen, b, hkv, l, d) for _ in range(2))
    q_bytes, kv_bytes, row_bytes = b * hq * l * d * 2, b * hkv * l * d * 2, \
        b * hq * l * 4
    out = {}
    for name, window in (("window", WINDOW), ("causal", None)):
        o, lse = prefill_attention(q, k, v, s, 0, True, window)
        delta = (do.float() * o.float()).sum(dim=-1)
        pairs = visible_pairs(l, l, True, window) * b * hq
        t = {"h1": {"ms": time_cuda(lambda: prefill_attention(
                 q, k, v, s, 0, True, window), n_iter=10)},
             "h3dkv": {"ms": time_cuda(lambda: attention_bwd_dkv(
                 q, k, v, do, lse, delta, s, True, 0, window), n_iter=10)},
             "h3dq": {"ms": time_cuda(lambda: attention_bwd_dq(
                 q, k, v, do, lse, delta, s, True, 0, window), n_iter=10)}}
        work = {"h1": (4 * d * pairs, 2 * q_bytes + 2 * kv_bytes + row_bytes),
                "h3dkv": (8 * d * pairs, 2 * q_bytes + 4 * kv_bytes
                          + 2 * row_bytes),
                "h3dq": (6 * d * pairs, 3 * q_bytes + 2 * kv_bytes
                         + 2 * row_bytes)}
        for kern, (flop, nbytes) in work.items():
            t[kern]["bound_ms"], t[kern]["bound_by"] = roofline(flop, nbytes)
            t[kern]["bound_share"] = t[kern]["bound_ms"] / t[kern]["ms"]
        out[name] = t
        del o, lse, delta
    print(f"  times at B={b} Hq={hq} Hkv={hkv} L={l} d={d}, window "
          f"{WINDOW} vs causal: "
          + "; ".join(f"{n} {out['window'][n]['ms']:.4f} ms (bound "
                      f"{out['window'][n]['bound_ms']:.4f}, "
                      f"{out['window'][n]['bound_share']:.1%}) vs "
                      f"{out['causal'][n]['ms']:.4f} ms, ratio "
                      f"{out['window'][n]['ms'] / out['causal'][n]['ms']:.3f}"
                      for n in ("h1", "h3dkv", "h3dq"))
          + " (each must be < 0.5: tiles outside the band are skipped)")
    _require(all(out["window"][n]["ms"] < 0.5 * out["causal"][n]["ms"]
                 for n in ("h1", "h3dkv", "h3dq")),
             "H1 or H3 does not skip the tiles outside the band")
    out["window_library_bwd"] = window_library_bwd(torch, q, k, v, do,
                                                   WINDOW)
    return out


def window_library_bwd(torch, q, k, v, do, window):
    """The backward of scaled_dot_product_attention (autograd, the
    memory-efficient backend, K/V repeated to q's heads) under the window
    as a dense boolean L x L band mask: at the largest L of q's, halving,
    whose mask and the backend's work space fit the card."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from exploring_flash_attention_tpu_torch.utils import time_cuda

    g = q.shape[1] // k.shape[1]
    l = q.shape[2]
    while l >= 2 * window:
        try:
            i = torch.arange(l, device=q.device)
            mask = (i[None, :] <= i[:, None]) & (i[None, :]
                                                 > i[:, None] - window)
            leaves = [x[:, :, :l].detach().clone().requires_grad_()
                      for x in (q, k.repeat_interleave(g, 1),
                                v.repeat_interleave(g, 1))]
            with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
                o = sdpa(*leaves, attn_mask=mask)
            d_o = do[:, :, :l].contiguous()
            ms = time_cuda(lambda: torch.autograd.grad(
                o, leaves, d_o, retain_graph=True), n_iter=5, n_warmup=2)
        except torch.cuda.OutOfMemoryError:
            l //= 2
            continue
        r = {"L": l, "ms": ms, "mask_bytes": l * l,
             "backend": "EFFICIENT_ATTENTION"}
        print(f"  SDPA backward under the window {window} as a dense boolean "
              f"mask ({l * l / 2**30:.2f} GiB), B={q.shape[0]} H="
              f"{q.shape[1]} L={l}: {ms:.4f} ms")
        return r
    raise PhaseError("SDPA's masked backward fits at no L")


# ---- the parallel phase: sequence-parallel paths on one card ----

RING_SP = 4                 # ranks of the ring composed on one card
RING_SHAPES = [(8, 1024), (1, 32768)]   # (B, L): the train step's shape
                                        # and the long context, L / 4 a rank
RING_WIDTHS = (8, 4, 128)   # the flagship's Hq, Hkv, d
RING_HOP_O_TOL = V1_WINDOW_O_TOL  # a hop's f32 partial vs the plain
                            # version: the causal hops' first rows see 1..n
                            # keys, as the window cases' do (|O| up to ~3, P
                            # rounded to bf16); sound hops read 2.8e-3..3.7e-3,
                            # the controls (a tile off, the future shown)
                            # 0.11 and up (PR 13, calls 2-3)
RING_O_TOL = V1_O_TOL       # the merged ring O vs one-device H1, both f32
                            # from the kernel: sound 1.2e-4..5.9e-4, the
                            # control (rank 0's diagonal hop a tile off) 3.6
                            # and up (PR 13, call 3)


def _hop_readings(torch, o, lse, ref_o, ref_lse):
    """max|dO| and max|dLSE| of an f32 partial vs its reference; the rows
    whose LSE is -inf must match (each side's O 0 there)."""
    _require(torch.equal(torch.isneginf(lse), torch.isneginf(ref_lse)),
             "a hop's rows that see no key differ from the reference's")
    fin = torch.isfinite(ref_lse)
    e_lse = (lse - ref_lse)[fin].abs().max().item() if fin.any() else 0.0
    return (o - ref_o).abs().max().item(), e_lse


def _rel_or_zero(torch, got, ref):
    """max|got - ref| / max|ref|, or max|got| where ref is all zero (a hop
    that sees no key must give exactly zero)."""
    peak = ref.float().abs().max().item()
    diff = (got.float() - ref.float()).abs().max().item()
    return diff / peak if peak > 0 else diff


def ring_on_one_card(torch, dev, b, l, gen, times):
    """Every (rank, source) hop of a causal RING_SP-rank ring at [B, L] run
    on one card through parallel.ring's hop functions, the shards passed
    by hand: per hop, H1, H3-dkv and H3-dq at the traced pair against the
    same kernels at static offsets (bitwise) and the plain versions, with
    the known-wrong controls (kv_pos0 a 64-key tile off on the diagonal
    hop, the future hop shown its keys); then the composed ring against
    one-device H1 and H3, with one hop's offset a tile off as control."""
    from exploring_flash_attention_tpu_torch.ops.attention import (
        attention_plain,
        prefill_attention,
    )
    from exploring_flash_attention_tpu_torch.ops.attention_bwd import (
        attention_bwd_plain,
        flash_attention_bwd,
        masked_attention_bwd,
    )
    from exploring_flash_attention_tpu_torch.parallel.ring import (
        ring_hop_backward,
        ring_hop_forward,
        ring_offsets,
    )

    hq, hkv, d = RING_WIDTHS
    n, ll = RING_SP, l // RING_SP
    scale = 1.0 / math.sqrt(d)
    q, do = (_bf16(torch, dev, gen, b, hq, l, d) for _ in range(2))
    k, v = (_bf16(torch, dev, gen, b, hkv, l, d) for _ in range(2))
    qs, ks, vs, dos = (x.chunk(n, dim=2) for x in (q, k, v, do))
    qs, ks, vs, dos = ([c.contiguous() for c in x] for x in (qs, ks, vs, dos))
    worst = {"h1_o": 0.0, "h1_lse": 0.0, "h3dkv": 0.0, "h3dq": 0.0}
    ctrl = {"h1_tile": math.inf, "h1_future": math.inf,
            "h3_tile": math.inf, "h3_future": math.inf}
    outs, outs32, lses, launches = [], [], [], None

    def fwd_rank(my, offs):
        o = lse = None
        for s in range(n):
            src = (my - s) % n
            o, lse = ring_hop_forward(qs[my], ks[src], vs[src], offs[s], o,
                                      lse, scale, True)
        return o, lse

    for my in range(n):
        offs = ring_offsets(my, n, ll, ll, dev)
        zero_counters()
        o, lse = fwd_rank(my, offs)
        torch.cuda.synchronize()
        fwd_counts = read_counters()
        outs.append(o.to(torch.bfloat16))
        outs32.append(o)
        lses.append(lse)
        for s in range(n):
            src = (my - s) % n
            diag = (my - src) * ll
            o_t, l_t = prefill_attention(qs[my], ks[src], vs[src], scale,
                                         offs[s], True,
                                         out_dtype=torch.float32)
            o_s, l_s = prefill_attention(qs[my], ks[src], vs[src], scale,
                                         diag, True, out_dtype=torch.float32)
            _require(torch.equal(o_t, o_s) and torch.equal(l_t, l_s),
                     "H1 at a traced pair differs from its static launch")
            p_o, p_l = attention_plain(qs[my], ks[src], vs[src], scale, True,
                                       diag)
            e_o, e_l = _hop_readings(torch, o_t, l_t, p_o, p_l)
            worst["h1_o"] = max(worst["h1_o"], e_o)
            worst["h1_lse"] = max(worst["h1_lse"], e_l)
            if src == my:                   # the diagonal: a tile off
                bad, _ = attention_plain(qs[my], ks[src], vs[src], scale,
                                         True, diag - 64)
                ctrl["h1_tile"] = min(ctrl["h1_tile"],
                                      (o_t - bad).abs().max().item())
            if src > my:                    # the future, shown its keys
                _require(bool((o_t == 0).all()) and bool(
                    torch.isneginf(l_t).all()), "a future hop saw a key")
                bad, _ = attention_plain(qs[my], ks[src], vs[src], scale,
                                         False, 0)
                ctrl["h1_future"] = min(ctrl["h1_future"],
                                        (o_t - bad).abs().max().item())
            del o_t, o_s, p_o, p_l
        # the backward, each hop under the ring's global O and LSE
        out = outs[my]
        delta = (dos[my].float() * out.float()).sum(dim=-1)
        zero_counters()
        for s in range(n):
            src = (my - s) % n
            ring_hop_backward(qs[my], ks[src], vs[src], out, dos[my], lses[my],
                              delta, offs[s], scale, True)
        torch.cuda.synchronize()
        bwd_counts = read_counters()
        launches = launches or {"forward_per_rank": fwd_counts,
                                "backward_per_rank": bwd_counts}
        for s in range(n):
            src = (my - s) % n
            diag = (my - src) * ll
            g_t = ring_hop_backward(qs[my], ks[src], vs[src], out, dos[my],
                                    lses[my], delta, offs[s], scale, True)
            g_s = masked_attention_bwd(qs[my], ks[src], vs[src], out, dos[my],
                                       lses[my], scale, True, diag, None,
                                       delta=delta)
            _require(all(torch.equal(x, y) for x, y in zip(g_t, g_s)),
                     "H3 at a traced pair differs from its static launch")
            g_p = attention_bwd_plain(qs[my], ks[src], vs[src], out, dos[my],
                                      lses[my], scale, True, diag)
            worst["h3dq"] = max(worst["h3dq"],
                                _rel_or_zero(torch, g_t[0], g_p[0]))
            worst["h3dkv"] = max(worst["h3dkv"],
                                 _rel_or_zero(torch, g_t[1], g_p[1]),
                                 _rel_or_zero(torch, g_t[2], g_p[2]))
            if src == my:
                bad = attention_bwd_plain(qs[my], ks[src], vs[src], out,
                                          dos[my], lses[my], scale, True,
                                          diag - 64)
                ctrl["h3_tile"] = min(ctrl["h3_tile"], min(
                    _rel_or_zero(torch, x, y) for x, y in zip(g_t, bad)))
            if src > my:
                _require(all(bool((x == 0).all()) for x in g_t),
                         "a future hop's gradients are not zero")
                bad = attention_bwd_plain(qs[my], ks[src], vs[src], out,
                                          dos[my], lses[my], scale, False, 0)
                ctrl["h3_future"] = min(ctrl["h3_future"], max(
                    x.float().abs().max().item() for x in bad))
            del g_t, g_s, g_p
    print(f"  ring hops B={b} L={l} ({n} ranks of {ll}) Hq={hq} Hkv={hkv} "
          f"d={d}, every (rank, source) hop at its traced pair, bitwise its "
          f"static launch: H1 f32 O vs plain max|d| {worst['h1_o']:.3e}, "
          f"LSE {worst['h1_lse']:.3e} (tol {RING_HOP_O_TOL:g}, "
          f"{H1_LSE_TOL:g}); "
          f"controls: kv_pos0 a tile off {ctrl['h1_tile']:.3e}, a future "
          f"hop shown its keys {ctrl['h1_future']:.3e}; H3 max|d|/max|ref| "
          f"vs plain dq {worst['h3dq']:.3e} dk/dv {worst['h3dkv']:.3e} (tol "
          f"{H3_REL_TOL:g}); controls: a tile off {ctrl['h3_tile']:.3e}, "
          f"the future shown {ctrl['h3_future']:.3e}; launches {launches}")
    _require(worst["h1_o"] < RING_HOP_O_TOL and worst["h1_lse"] < H1_LSE_TOL,
             "a hop's H1 is outside tolerance")
    _require(max(worst["h3dq"], worst["h3dkv"]) < H3_REL_TOL,
             "a hop's H3 is outside tolerance")
    _require(min(ctrl["h1_tile"], ctrl["h1_future"]) > RING_HOP_O_TOL,
             "the hop check cannot tell a wrong offset (H1)")
    _require(min(ctrl["h3_tile"], ctrl["h3_future"]) > H3_REL_TOL,
             "the hop check cannot tell a wrong offset (H3)")
    want_f = launches_only(h1=n)
    want_b = launches_only(h3dkv=n, h3dq=n)
    _require(launches["forward_per_rank"] == want_f
             and launches["backward_per_rank"] == want_b,
             f"ring launches {launches}, expected {want_f}, {want_b}")

    # the composed ring against one device
    one_o, one_lse = prefill_attention(q, k, v, scale, 0, True,
                                       out_dtype=torch.float32)
    ring_o = torch.cat(outs32, dim=2)
    ring_lse = torch.cat(lses, dim=2)
    e_o = (ring_o - one_o).abs().max().item()
    e_lse = (ring_lse - one_lse).abs().max().item()
    one_g = flash_attention_bwd(q, k, v, one_o.to(torch.bfloat16), do,
                                one_lse, scale=scale, causal=True)
    dq = [torch.zeros_like(x, dtype=torch.float32) for x in qs]
    dk = [torch.zeros_like(x, dtype=torch.float32) for x in ks]
    dv = [torch.zeros_like(x, dtype=torch.float32) for x in vs]

    def bwd_all(offsets):
        for x in dq + dk + dv:
            x.zero_()
        for my in range(n):
            delta = (dos[my].float() * outs[my].float()).sum(dim=-1)
            for s in range(n):
                src = (my - s) % n
                g = ring_hop_backward(qs[my], ks[src], vs[src], outs[my],
                                      dos[my], lses[my], delta,
                                      offsets[my][s], scale, True)
                dq[my] += g[0].float()
                dk[src] += g[1].float()
                dv[src] += g[2].float()
        return [torch.cat(x, dim=2) for x in (dq, dk, dv)]

    offsets = [ring_offsets(my, n, ll, ll, dev) for my in range(n)]
    e_g = [_rel(g, r) for g, r in zip(bwd_all(offsets), one_g)]
    # control: rank 0's diagonal hop with kv_pos0 a 64-key tile off (its
    # first rows see a handful of keys, so the tile shows at any L)
    bad_offs = [x.clone() for x in offsets]
    bad_offs[0][0, 1] += 64
    bad_o, _ = fwd_rank(0, bad_offs[0])
    e_bad_o = (bad_o - one_o[:, :, :ll]).abs().max().item()
    e_bad_g = [_rel(g, r) for g, r in zip(bwd_all(bad_offs), one_g)]
    print(f"  ring composed B={b} L={l}: O vs one-device H1 (f32) max|d| "
          f"{e_o:.3e}, LSE {e_lse:.3e} (tol {RING_O_TOL:g}, "
          f"{H1_LSE_TOL:g}); dq dk dv vs one-device H3 max|d|/max|ref| "
          + " ".join(f"{x:.3e}" for x in e_g) + f" (tol {H3_REL_TOL:g}); "
          f"control (rank 0's diagonal hop a tile off): O {e_bad_o:.3e}, "
          "grads " + " ".join(f"{x:.3e}" for x in e_bad_g))
    _require(e_o < RING_O_TOL and e_lse < H1_LSE_TOL,
             "the ring's O differs from one device's")
    _require(max(e_g) < H3_REL_TOL, "the ring's gradients differ")
    _require(e_bad_o > RING_O_TOL and min(e_bad_g) > H3_REL_TOL,
             "the ring check cannot tell a wrong hop")
    out = {"b": b, "l": l, "l_local": ll, "hop_worst": worst,
           "hop_controls": ctrl, "launches": launches,
           "ring_o_err": e_o, "ring_lse_err": e_lse, "ring_grad_err": e_g,
           "control_o": e_bad_o, "control_grads": e_bad_g}
    if times:
        out["times"] = hop_times(torch, qs, ks, vs, dos, outs, lses, scale)
    return out


def hop_times(torch, qs, ks, vs, dos, outs, lses, scale):
    """CUDA-event medians (L2 flushed) of rank 1's diagonal hop (the
    causal triangle) and its past hop (every key) at the traced pair beside
    the static launch, SDPA under the hop's mask (is_causal on the
    diagonal, none on the past hop; its autograd backward for H3) and the
    bound; H3 each kernel alone."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from exploring_flash_attention_tpu_torch.ops import (
        attention_bwd_dkv,
        attention_bwd_dq,
        prefill_attention,
    )
    from exploring_flash_attention_tpu_torch.parallel.ring import ring_offsets
    from exploring_flash_attention_tpu_torch.utils import time_cuda

    n, ll = len(qs), qs[0].shape[2]
    b, hq, _, d = qs[0].shape
    hkv = ks[0].shape[1]
    offs = ring_offsets(1, n, ll, ll, qs[0].device)
    q, do, out, lse = qs[1], dos[1], outs[1], lses[1]
    delta = (do.float() * out.float()).sum(dim=-1)
    q_bytes, kv_bytes = b * hq * ll * d * 2, b * hkv * ll * d * 2
    row_bytes = b * hq * ll * 4
    res = {}
    for name, s, causal_lib in (("diagonal", 0, True), ("past", 1, False)):
        src = (1 - s) % n
        k, v, diag = ks[src], vs[src], (1 - src) * ll
        pairs = b * hq * (ll * (ll + 1) // 2 if causal_lib else ll * ll)
        iters = 20 if ll > 1024 else 50
        t = {"h1": {"ms": time_cuda(lambda: prefill_attention(
                 q, k, v, scale, offs[s], True, out_dtype=torch.float32),
                 n_iter=iters),
                 "static_ms": time_cuda(lambda: prefill_attention(
                     q, k, v, scale, diag, True, out_dtype=torch.float32),
                     n_iter=iters),
                 "library_ms": time_cuda(lambda: sdpa(
                     q, k, v, is_causal=causal_lib, enable_gqa=True),
                     n_iter=iters)},
             "h3dkv": {"ms": time_cuda(lambda: attention_bwd_dkv(
                 q, k, v, do, lse, delta, scale, True, offs[s]),
                 n_iter=iters),
                 "static_ms": time_cuda(lambda: attention_bwd_dkv(
                     q, k, v, do, lse, delta, scale, True, diag),
                     n_iter=iters)},
             "h3dq": {"ms": time_cuda(lambda: attention_bwd_dq(
                 q, k, v, do, lse, delta, scale, True, offs[s]),
                 n_iter=iters),
                 "static_ms": time_cuda(lambda: attention_bwd_dq(
                     q, k, v, do, lse, delta, scale, True, diag),
                     n_iter=iters)}}
        leaves = [x.detach().clone().requires_grad_() for x in (
            q, k.repeat_interleave(hq // hkv, 1),
            v.repeat_interleave(hq // hkv, 1))]
        o_lib = sdpa(*leaves, is_causal=causal_lib)
        lib = time_cuda(lambda: torch.autograd.grad(
            o_lib, leaves, do, retain_graph=True), n_iter=iters)
        t["h3dkv"]["library_ms"] = t["h3dq"]["library_ms"] = lib
        del leaves, o_lib
        work = {"h1": (4 * d * pairs, q_bytes + 2 * kv_bytes + 2 * q_bytes
                       + row_bytes),
                "h3dkv": (8 * d * pairs, 2 * q_bytes + 4 * kv_bytes
                          + 2 * row_bytes),
                "h3dq": (6 * d * pairs, 3 * q_bytes + 2 * kv_bytes
                         + 2 * row_bytes)}
        for kern, (flop, nbytes) in work.items():
            t[kern]["bound_ms"], t[kern]["bound_by"] = roofline(flop, nbytes)
            t[kern]["bound_share"] = t[kern]["bound_ms"] / t[kern]["ms"]
        res[name] = t
        print(f"  hop times B={b} L_local={ll} {name} hop (rank 1, source "
              f"{src}, traced pair {offs[s].tolist()}): "
              + "; ".join(f"{x} {t[x]['ms']:.4f} ms (static "
                          f"{t[x]['static_ms']:.4f}, bound "
                          f"{t[x]['bound_ms']:.4f} {t[x]['bound_by']}, "
                          f"{t[x]['bound_share']:.1%}; library "
                          f"{t[x]['library_ms']:.4f})" for x in t)
              + " (library: SDPA, is_causal on the diagonal hop; its whole "
                "autograd backward for H3)")
    return res


def hop_graph_check(torch, dev):
    """One hop (H1, H3-dkv, H3-dq at a traced pair) captured in a CUDA
    graph, then replayed after each rank's pairs are written into the
    offsets tensor: every replay bitwise the eager calls at those offsets,
    so nothing reads the pair on the host."""
    from exploring_flash_attention_tpu_torch.graphs import no_collection
    from exploring_flash_attention_tpu_torch.ops.attention import (
        prefill_attention,
    )
    from exploring_flash_attention_tpu_torch.ops.attention_bwd import (
        masked_attention_bwd,
    )
    from exploring_flash_attention_tpu_torch.parallel.ring import ring_offsets

    gen = torch.Generator().manual_seed(11)
    hq, hkv, d = RING_WIDTHS
    b, ll = 8, 256
    scale = 1.0 / math.sqrt(d)
    q, do = (_bf16(torch, dev, gen, b, hq, ll, d) for _ in range(2))
    k, v = (_bf16(torch, dev, gen, b, hkv, ll, d) for _ in range(2))
    out = _bf16(torch, dev, gen, b, hq, ll, d)
    lse = torch.randn(b, hq, ll, generator=gen).to(dev) + 6.0
    offs = torch.zeros(2, dtype=torch.int32, device=dev)

    def hop():
        o, l_ = prefill_attention(q, k, v, scale, offs, True,
                                  out_dtype=torch.float32)
        return (o, l_, *masked_attention_bwd(q, k, v, out, do, lse, scale,
                                             True, offs, None))

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        hop()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with no_collection(), torch.cuda.graph(graph):
        captured = hop()
    pairs = torch.cat([ring_offsets(my, RING_SP, ll, ll, dev)
                       for my in range(RING_SP)])
    same = []
    for pair in pairs:
        offs.copy_(pair)
        graph.replay()
        eager = hop()
        torch.cuda.synchronize()
        same.append(all(torch.equal(x, y) for x, y in zip(captured, eager)))
    print(f"  hop graph: H1 + H3-dkv + H3-dq captured once, replayed at "
          f"{len(pairs)} traced pairs written into the offsets tensor: "
          f"bitwise the eager calls at every one: {all(same)}")
    _require(all(same), "a replayed hop differs from its eager call")
    return len(pairs)


def sharded_train_check(torch, dev, name="flagship", loss_tol=TRAIN_LOSS_TOL,
                        grad_tol=GRAD_REL_TOL, **heads):
    """make_train_step(mesh=) on a one-rank NCCL group (MeshConfig(1, 1,
    1): the ring's single hop at the traced pair (0, 0), the tp and data
    all-reduces over one rank) at the flagship's widths (its config
    changed by ``heads``: the heads_train phase's attention geometries,
    the f32_train phase's dtype; the limits ``loss_tol`` and
    ``grad_tol``) on
    tokens [8, 1025], against make_train_step(mesh=None) on the same
    weights (SGD
    at 0.1): the loss, every leaf's gradient (the mesh step's after its
    all-reduces) and the updated parameters, with the ring's diagonal key
    hidden (its offsets one key off) as the control; the launches of the
    mesh step; step times of both."""
    import tempfile
    from unittest import mock

    import torch.distributed as dist

    from exploring_flash_attention_tpu_torch.configs import MeshConfig
    from exploring_flash_attention_tpu_torch.models import (
        flagship_config,
        init_params,
        make_train_step,
        named_param_leaves,
    )
    from exploring_flash_attention_tpu_torch.parallel import ring as ring_mod
    from exploring_flash_attention_tpu_torch.parallel.mesh import (
        init_distributed,
        make_mesh,
    )

    cfg = dataclasses.replace(flagship_config(), **heads)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (8, 1025)).astype(np.int32)).to(dev)
    sgd = lambda leaves: torch.optim.SGD(leaves, lr=0.1)   # noqa: E731
    with tempfile.TemporaryDirectory() as tmp:
        init_distributed(0, 1, f"file://{tmp}/rendezvous", "cuda")
        try:
            mesh = make_mesh(MeshConfig(1, 1, 1), "cuda")
            runs = {}
            for run, m in (("one_device", None), ("mesh", mesh),
                           ("control", mesh)):
                params = init_params(cfg, seed=0, device=dev)
                step, opt_init = make_train_step(cfg, mesh=m, optimizer=sgd)
                opt = opt_init(params)
                orig = ring_mod.ring_offsets
                hide = (lambda *a: orig(*a) + torch.tensor(     # noqa: E731
                    [0, 1], dtype=torch.int32, device=dev))
                with (mock.patch.object(ring_mod, "ring_offsets", hide)
                      if run == "control" else contextlib.nullcontext()):
                    zero_counters()
                    loss = step(params, opt, tokens).item()
                    torch.cuda.synchronize()
                    counts = read_counters()
                names, leaves = zip(*named_param_leaves(params))
                grads = [x.grad.clone() for x in leaves]
                new = [x.detach().clone() for x in leaves]
                times = []
                if run != "control":
                    for _ in range(4):
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        step(params, opt, tokens)
                        torch.cuda.synchronize()
                        times.append(time.perf_counter() - t0)
                runs[run] = {"loss": loss, "grads": grads, "new": new,
                              "counts": counts,
                              "step_s": float(np.median(times[1:]))
                              if times else None}
                del params, opt, step, leaves
        finally:
            dist.destroy_process_group()
    ref = runs["one_device"]
    want = launches_only(h1=cfg.n_layers, h3dkv=cfg.n_layers,
                         h3dq=cfg.n_layers)
    res = {}
    for run in ("mesh", "control"):
        r = runs[run]
        e_grad, leaf = leaf_err(names, r["grads"], ref["grads"])
        res[run] = {"loss_err": abs(r["loss"] - ref["loss"]),
                     "grad_err": e_grad, "leaf": leaf,
                     "params_bitwise": all(torch.equal(x, y) for x, y in zip(
                         r["new"], ref["new"]))}
    m, c = res["mesh"], res["control"]
    print(f"  sharded step (MeshConfig(1, 1, 1), NCCL, one rank) of the "
          f"{name}, tokens [8, 1025], SGD 0.1: loss "
          f"{runs['mesh']['loss']:.6f} vs mesh=None {ref['loss']:.6f}, |d| "
          f"{m['loss_err']:.3e} (tol {loss_tol:g}); largest per-leaf "
          f"||dg|| / ||g|| {m['grad_err']:.3e} at {m['leaf']} (tol "
          f"{grad_tol:g}); updated params bitwise: "
          f"{m['params_bitwise']}; control (the ring's diagonal key hidden) "
          f"loss {c['loss_err']:.3e}, grads {c['grad_err']:.3e} at "
          f"{c['leaf']}; launches {runs['mesh']['counts']} (expected "
          f"{want}); step times s: mesh {runs['mesh']['step_s']:.5f}, "
          f"mesh=None {ref['step_s']:.5f}")
    _require(m["loss_err"] < loss_tol and m["grad_err"] < grad_tol,
             "the sharded step differs from the one-device step")
    _require(c["loss_err"] > loss_tol and c["grad_err"] > grad_tol,
             "the sharded-step check cannot tell a wrong ring")
    _require(runs["mesh"]["counts"] == want,
             "the sharded step missed a kernel")
    return {"loss_err": m["loss_err"], "grad_err": m["grad_err"],
            "params_bitwise": m["params_bitwise"],
            "control": c, "launches": runs["mesh"]["counts"],
            "step_s": runs["mesh"]["step_s"],
            "one_device_step_s": ref["step_s"]}


def phase_parallel(torch, dev):
    """The sequence-parallel paths on one card: the ring's hops at both
    RING_SHAPES, the hop under graph replay, the sharded train step on a
    one-rank NCCL group and parallel.dryrun.dryrun_multichip(1).  A
    collective across ranks needs a card a rank (NCCL refuses two ranks on
    one GPU); the gloo tests on the CPU check those."""
    from exploring_flash_attention_tpu_torch.parallel.dryrun import (
        dryrun_multichip,
    )

    gen = torch.Generator().manual_seed(13)
    rings = {f"B={b} L={l}": ring_on_one_card(torch, dev, b, l, gen,
                                              times=True)
             for b, l in RING_SHAPES}
    graph_pairs = hop_graph_check(torch, dev)
    sharded = sharded_train_check(torch, dev)
    dry = dryrun_multichip(1, "cuda")
    print("phase parallel: ok")
    return {"rings": rings, "graph_pairs": graph_pairs, "sharded": sharded,
            "dryrun": dry}


def ring_launches(par, which, kern):
    """A kernel's launches per rank in one ring pass (both shapes agree)."""
    counts = {r["launches"][which][kern] for r in par["rings"].values()}
    _require(len(counts) == 1, f"ring launches differ by shape: {counts}")
    return counts.pop()


def device_offset_readings(par, kern):
    """The kernels line's record of a kernel's traced-offset mode: per ring
    shape, the worst hop against its plain version (H1: max|dO| of the f32
    partial; H3: max|d| / max|ref|) and the hop times; the graph replays;
    the sharded step's check."""
    err = {"h1": "h1_o", "h3dkv": "h3dkv", "h3dq": "h3dq"}[kern]
    return {"mode": "offsets read by every block from a device int32 pair "
                    "(q_pos0, kv_pos0)",
            "graph_replay_pairs_bitwise": par["graph_pairs"],
            "by_ring_shape": {
                name: {"max_hop_err_vs_plain": r["hop_worst"][err],
                       "hop_times": {hop: x[kern]
                                     for hop, x in r["times"].items()}}
                for name, r in par["rings"].items()},
            "sharded_train_step": par["sharded"]}


# ---- the tiles phase: H1's bound statistic and 64-row Q tile, and the
# utils/ tools on the card ----

BOUND_O_TOL = 2e-3     # the bound form's f32 O vs the f64 oracle and the
                       # plain bound version: the JAX package's bf16 bound
                       # tier (tests/test_attention_v1.py:441-448), whose
                       # docstring expects ~1.0e-3 against exact's 4e-4 (the
                       # top weight is no longer exactly 1.0 in bf16)
TILES_SMALL = (1, 8, 1024, 128)      # B, H, L, d, causal: 64 blocks of
                                     # 128 rows on 132 SMs, 128 of 64
TILES_GROW = (8, 8, 4, 1024, 128)    # B, Hq, Hkv, L, d: causal, then K/V
                                     # (and q) grown by one 128-key tile
TILES_TRACED = (8, 8, 4, 1024, 128, ((2048, 1024), (1024, 2048)))
# B, Hq, Hkv, L, d, (q_pos0, kv_pos0): a ring hop on the diagonal's far
# side and one whose rows see no key
TILES_SPLIT = (1, 8, 8, 1024, 8192, 128)     # the v1 phase's split route
TILES_WINDOW = (4, 8, 4, 4096, 128, V1_WINDOW)


def bound_plain(q, k, v, causal, diag_off, window=None):
    """The plain version of H1's bound form: attention_plain with the
    bound shift of bound_shift (f32 math)."""
    from exploring_flash_attention_tpu_torch.ops.attention import (
        attention_plain,
        bound_kmax,
        bound_shift,
    )

    scale = 1.0 / math.sqrt(q.shape[3])
    shift = bound_shift(q, bound_kmax(k), scale, causal, diag_off)
    return attention_plain(q, k, v, scale, causal, diag_off, window, shift)


def kernel_rows(torch, prof, n_calls):
    """{kernel name: (launches a call, device ms a call)} of the CUDA rows
    of a torch.profiler run of ``n_calls`` calls."""
    rows = {}
    for e in prof.key_averages():
        if e.device_type.name == "CUDA" and not e.is_user_annotation:
            rows[e.key] = (e.count / n_calls,
                           e.self_device_time_total / 1e3 / n_calls)
    return rows


def in_turns(torch, fns, n_iter=20):
    """Median ms of each of ``fns`` (time_cuda), timed in the order a, b,
    ..., then reversed, the two readings averaged: a drift of the card's
    clock over the run weighs on both alike."""
    from exploring_flash_attention_tpu_torch.utils import time_cuda

    first = {n: time_cuda(f, n_iter=n_iter) for n, f in fns.items()}
    second = {n: time_cuda(f, n_iter=n_iter)
              for n, f in reversed(list(fns.items()))}
    return {n: (first[n] + second[n]) / 2 for n in fns}


def phase_tiles(torch, dev):
    """H1's two new forms through flash_attention_v1: the bound statistic
    (TileConfig(softmax="bound")) at the canonical shape against the f64
    oracle and the plain bound version with the v1 gate's controls, its
    causal invariance to a whole K/V tile, traced offsets against the
    static launch, spans and a window against the plain version; the
    64-row Q tile (block_q <= 64) bitwise against the 128-row one and
    timed at two shapes; ModelConfig.tile through the flagship's forward;
    and utils/'s autotune_v1 (winner cached and read back from disk),
    trace and kernel_report on the card."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from exploring_flash_attention_tpu_torch import TileConfig
    from exploring_flash_attention_tpu_torch.models import (
        flagship_config,
        forward,
        init_params,
    )
    from exploring_flash_attention_tpu_torch.ops import (
        attention_plain,
        flash_attention_v1,
        prefill_attention,
    )
    from exploring_flash_attention_tpu_torch.ops.attention import (
        bound_kmax,
        traced_pair,
    )
    from exploring_flash_attention_tpu_torch.utils import (
        attention_flops,
        autotune_dtiled,
        autotune_splitkv,
        autotune_v1,
        autotune_window,
        kernel_report,
        roofline_attention_tflops,
        time_cuda,
        trace,
    )
    import exploring_flash_attention_tpu_torch.utils.autotune as autotune

    bound, tile64 = TileConfig(softmax="bound"), TileConfig(block_q=64)
    bound64 = TileConfig(block_q=64, softmax="bound")
    out = {}
    b, h, l, d = V1_CANON
    q, k, v = v1_inputs(torch, dev, b, h, h, l, l, d, seed=1)
    # the main path: the bound form at the canonical shape, counters read
    zero_counters()
    bound_kmax.launches = 0
    o = flash_attention_v1(q, k, v, bound, out_dtype=torch.float32)
    torch.cuda.synchronize()
    launches, stat_calls = read_counters(), bound_kmax.launches
    _require(launches == launches_only(h1=1) and stat_calls == 1,
             f"bound launches {launches}, statistic calls {stat_calls}: "
             "expected one H1 and one statistic")
    r = v1_readings(torch, q, k, v, o, None, False, None, 2, 2)
    e_plain = (o - bound_plain(q, k, v, False, 0)[0]).abs().max().item()
    o_exact = flash_attention_v1(q, k, v, out_dtype=torch.float32)
    r_exact = v1_readings(torch, q, k, v, o_exact, None, False, None, 2, 2)
    print(f"  tiles bound B={b} H={h} L={l} d={d} bf16 in, f32 out: "
          f"max|dO| on [:2, :2] vs f64 oracle {r['oracle']:.3e} (tol "
          f"{BOUND_O_TOL:g}; exact {r_exact['oracle']:.3e}); whole tensor "
          f"vs the plain bound version {e_plain:.3e}, vs the plain exact "
          f"version {r['plain']:.3e} (tol {BOUND_O_TOL:g}); controls vs f64 "
          f"oracle: scale off by 10% {r['scale']:.3e}, last 64-key tile "
          f"dropped {r['drop']:.3e}; launches {launches}, statistic calls "
          f"{stat_calls}")
    _require(max(r["oracle"], e_plain, r["plain"]) <= BOUND_O_TOL,
             "H1's bound form outside tolerance")
    _require(min(r["scale"], r["drop"]) > BOUND_O_TOL,
             "the bound gate cannot tell a wrong path")
    out["bound"] = {"launches": launches["h1"], "statistic_calls": stat_calls,
                    "max_abs_err": e_plain, "oracle_err": r["oracle"],
                    "exact_oracle_err": r_exact["oracle"]}
    # the 64-row tile on the same inputs: bitwise, exact and bound
    for name, cfg, ref in (("exact", tile64, o_exact), ("bound", bound64, o)):
        o64 = flash_attention_v1(q, k, v, cfg, out_dtype=torch.float32)
        _require(torch.equal(o64, ref),
                 f"64-row tile differs from 128 ({name}): "
                 f"{(o64 - ref).abs().max().item():.3e}")
    del o, o_exact, o64
    print("  tiles 64-row Q tile at the canonical shape: O bitwise the "
          "128-row tile's, exact and bound")

    # times at the canonical shape: the calls (L2 flushed), then each
    # kernel's device time from one trace of all four forms
    scale = 1.0 / math.sqrt(d)
    calls = {"exact": lambda: flash_attention_v1(q, k, v),
             "bound": lambda: flash_attention_v1(q, k, v, bound),
             "tile64": lambda: flash_attention_v1(q, k, v, tile64),
             "bound64": lambda: flash_attention_v1(q, k, v, bound64)}
    t = in_turns(torch, calls)
    t["statistic"] = time_cuda(lambda: bound_kmax(k), n_iter=20)
    t["sdpa"] = time_cuda(lambda: sdpa(q, k, v), n_iter=20)
    t["plain_bound"] = time_cuda(lambda: bound_plain(q, k, v, False, 0),
                                 n_iter=5, n_warmup=1)
    n_prof = 10
    prof_rows = {}
    for name in ("exact", "bound", "tile64", "bound64"):
        with trace(str(ROOT / "build" / "tiles_trace" / name)) as tr:
            for _ in range(n_prof):
                calls[name]()
        prof_rows[name] = kernel_rows(torch, tr.profiler, n_prof)
        _require(os.path.exists(tr.path), f"no Chrome trace at {tr.path}")
    h1_ms = {n: sum(ms for key, (_, ms) in rows.items()
                    if "prefill_attention_kernel" in key)
             for n, rows in prof_rows.items()}
    stat = {key: x for key, x in prof_rows["bound"].items()
            if "prefill_attention_kernel" not in key}
    flop = attention_flops(b, h, l, l, d)
    nbytes = 4 * b * h * l * d * 2
    t["bound_ms"], t["bound_by"] = roofline(flop, nbytes)
    # the statistic reads K once and writes B*Hkv*L/128 floats
    t["statistic_bound_ms"], _ = roofline(0, b * h * l * d * 2)
    print(f"  tiles times at B={b} H={h} L={l} d={d} (CUDA events, median, "
          f"L2 flushed, in turns): call exact {t['exact']:.4f} ms, bound "
          f"{t['bound']:.4f}, 64-row tile {t['tile64']:.4f}, 64-row bound "
          f"{t['bound64']:.4f}; the statistic alone {t['statistic']:.4f} ms "
          f"(bound {t['statistic_bound_ms']:.4f}, bytes); plain bound "
          f"{t['plain_bound']:.4f}; SDPA {t['sdpa']:.4f}; H1's bound "
          f"{t['bound_ms']:.4f} ms ({t['bound_by']})")
    print(f"  tiles H1 kernel device ms (torch.profiler, {n_prof} calls, L2 "
          f"warm): " + ", ".join(f"{n} {x:.4f}" for n, x in h1_ms.items())
          + f"; the statistic's kernels a call: "
          + ", ".join(f"{key[:48]} x{n:g} {ms:.4f} ms"
                      for key, (n, ms) in stat.items()))
    out["canonical"] = {**t, "h1_kernel_ms": h1_ms,
                        "statistic_kernels": {key: {"per_call": n, "ms": ms}
                                              for key, (n, ms) in stat.items()}}

    # the tools: kernel_report's table, autotune_v1 with its disk cache
    entries = [("H1 exact", lambda x: flash_attention_v1(x, k, v), q, flop,
                nbytes),
               ("H1 bound", lambda x: flash_attention_v1(x, k, v, bound), q,
                flop, nbytes),
               ("H1 64-row tile", lambda x: flash_attention_v1(x, k, v,
                                                               tile64),
                q, flop, nbytes),
               ("SDPA", lambda x: sdpa(x, k, v), q, flop, nbytes)]
    print(f"  tiles kernel_report at B={b} H={h} L={l} d={d} "
          "(time_fn_chained, q := the last output; roofline "
          f"{roofline_attention_tflops(b, h, l, d):.1f} TFLOP/s, "
          "roofline_attention_tflops at the H100's peaks):")
    out["report"] = kernel_report(entries)
    cache = ROOT / "build" / "autotune.json"
    cache.unlink(missing_ok=True)
    autotune._CACHE_PATH = str(cache)
    autotune._CACHE.clear()
    win = {"canonical": autotune_v1(q, k, v)}
    canon = (q, k, v)

    b, h, l, d = TILES_SMALL
    q, k, v = v1_inputs(torch, dev, b, h, h, l, l, d, seed=3)
    zero_counters()
    o64 = flash_attention_v1(q, k, v, tile64, causal=True,
                             out_dtype=torch.float32)
    torch.cuda.synchronize()
    launches64 = read_counters()
    _require(launches64 == launches_only(h1=1),
             f"64-row tile launches {launches64}, expected one H1")
    o128 = flash_attention_v1(q, k, v, causal=True, out_dtype=torch.float32)
    _require(torch.equal(o64, o128), "64-row tile differs from 128, causal")
    # a causal call at Lq == Lkv: its first rows see 1..n keys and have
    # |O| up to ~3, so the window cases' limit, beside the control of each
    # row's diagonal key hidden
    e64 = (o64 - attention_plain(q, k, v, 1.0 / math.sqrt(d), True, 0)[0]
           ).abs().max().item()
    e64_bad = (o64 - attention_plain(q, k, v, 1.0 / math.sqrt(d), True, -1)[0]
               ).abs().max().item()
    _require(e64 < V1_WINDOW_O_TOL < e64_bad,
             f"64-row tile vs plain {e64:.3e}, control {e64_bad:.3e}")
    ts = in_turns(torch, {
        "tile128": lambda: flash_attention_v1(q, k, v, causal=True),
        "tile64": lambda: flash_attention_v1(q, k, v, tile64, causal=True)})
    ts["sdpa"] = time_cuda(lambda: sdpa(q, k, v, is_causal=True), n_iter=20)
    ts["plain"] = time_cuda(lambda: attention_plain(
        q, k, v, 1.0 / math.sqrt(d), True, 0), n_iter=5, n_warmup=1)
    flop_c = attention_flops(b, h, l, l, d, causal=True)
    ts["bound_ms"], ts["bound_by"] = roofline(flop_c, 4 * b * h * l * d * 2)
    win["small causal"] = autotune_v1(q, k, v, causal=True)
    print(f"  tiles 64-row Q tile at B={b} H={h} L={l} d={d} causal: O "
          f"bitwise the 128-row tile's; vs plain {e64:.3e} (tol "
          f"{V1_WINDOW_O_TOL:g}; control, each row's diagonal key hidden, "
          f"{e64_bad:.3e}); launches {launches64}; times 128-row "
          f"{ts['tile128']:.4f} ms, 64-row {ts['tile64']:.4f} ms (ratio "
          f"{ts['tile128'] / ts['tile64']:.3f}); SDPA {ts['sdpa']:.4f}; "
          f"plain {ts['plain']:.4f}; bound {ts['bound_ms']:.4f} "
          f"({ts['bound_by']})")
    out["small_causal"] = {**ts, "launches": launches64["h1"],
                           "max_abs_err": e64}
    del o64, o128
    # the winners cached: the in-process cache cleared, read from disk
    autotune._CACHE.clear()
    again = {"canonical": autotune_v1(*canon, candidates=[]),
             "small causal": autotune_v1(q, k, v, causal=True,
                                         candidates=[])}
    _require(again == win and cache.exists(),
             f"autotune's disk cache gave {again}, swept {win}")
    print(f"  tiles autotune_v1 winners (block_q): "
          + ", ".join(f"{n} {c.block_q}" for n, c in win.items())
          + f"; read back from {cache.relative_to(ROOT)} after the "
          "in-process cache was cleared")
    out["autotune"] = {n: c.block_q for n, c in win.items()}
    del q, k, v, canon

    # causal invariance: K/V (and q) grown by one 128-key tile leave the
    # first L rows bitwise unchanged, both Q tiles
    b, hq, hkv, l, d = TILES_GROW
    q, k, v = v1_inputs(torch, dev, b, hq, hkv, l + 128, l + 128, d, seed=4)
    for cfg in (bound, bound64):
        short = flash_attention_v1(q[:, :, :l].contiguous(),
                                   k[:, :, :l].contiguous(),
                                   v[:, :, :l].contiguous(), cfg,
                                   causal=True, out_dtype=torch.float32)
        grown = flash_attention_v1(q, k, v, cfg, causal=True,
                                   out_dtype=torch.float32)
        _require(torch.equal(grown[:, :, :l], short),
                 f"bound causal rows moved when K/V grew by a tile "
                 f"(block_q {cfg.block_q})")
    # causal at Lq == Lkv: the window cases' limit, as for the 64-row tile
    e_grow = (grown - bound_plain(q, k, v, True, 0)[0]).abs().max().item()
    e_grow_bad = (grown - bound_plain(q, k, v, True, -1)[0]
                  ).abs().max().item()
    _require(e_grow < V1_WINDOW_O_TOL < e_grow_bad,
             f"causal bound vs plain {e_grow:.3e}, control {e_grow_bad:.3e}")
    print(f"  tiles causal bound B={b} Hq={hq} Hkv={hkv} L={l} grown to "
          f"{l + 128}: the first {l} rows bitwise unchanged (Q tiles 128 "
          f"and 64); vs the plain bound version {e_grow:.3e} (tol "
          f"{V1_WINDOW_O_TOL:g}; control, each row's diagonal key hidden, "
          f"{e_grow_bad:.3e})")
    del q, k, v, short, grown

    # traced offsets: bitwise the static launch; a hop whose rows see no
    # key gives (0, -inf)
    b, hq, hkv, l, d, hops = TILES_TRACED
    q, k, v = v1_inputs(torch, dev, b, hq, hkv, l, l, d, seed=5)
    for q_pos0, kv_pos0 in hops:
        pair = traced_pair((torch.tensor(q_pos0), torch.tensor(kv_pos0)),
                           dev)
        got = prefill_attention(q, k, v, scale, pair, True,
                                out_dtype=torch.float32, softmax="bound")
        ref = prefill_attention(q, k, v, scale, q_pos0 - kv_pos0, True,
                                out_dtype=torch.float32, softmax="bound")
        _require(all(torch.equal(x, y) for x, y in zip(got, ref)),
                 f"traced bound at ({q_pos0}, {kv_pos0}) differs from static")
        if q_pos0 < kv_pos0:
            _require(bool((got[0] == 0).all() and torch.isneginf(got[1]).all()),
                     "rows that see no key are not (0, -inf)")
        else:
            e_tr = (got[0] - bound_plain(q, k, v, True, q_pos0 - kv_pos0)[0]
                    ).abs().max().item()
            _require(e_tr < BOUND_O_TOL, f"traced bound vs plain {e_tr:.3e}")
    print(f"  tiles bound at traced offsets {hops}, B={b} Hq={hq} Hkv={hkv} "
          f"L={l}: O and LSE bitwise the static launch's; vs the plain bound "
          f"version {e_tr:.3e}; the hop past the diagonal (0, -inf)")
    del q, k, v, got, ref

    # spans (H1 over KV spans + H2) and a window, against the plain version
    b, hq, hkv, lq, lkv, d = TILES_SPLIT
    q, k, v = v1_inputs(torch, dev, b, hq, hkv, lq, lkv, d, seed=6)
    o = counted_call(torch, lambda: flash_attention_v1(
        q, k, v, bound, out_dtype=torch.float32),
        launches_only(h1=1, h2=1))
    e_span = (o - bound_plain(q, k, v, False, 0)[0]).abs().max().item()
    _require(e_span < BOUND_O_TOL, f"bound over spans vs plain {e_span:.3e}")
    win["splitkv"] = autotune_splitkv(q, k, v)
    del q, k, v, o
    b, hq, hkv, l, d, window = TILES_WINDOW
    q, k, v = v1_inputs(torch, dev, b, hq, hkv, l, l, d, seed=7)
    o = counted_call(torch, lambda: flash_attention_v1(
        q, k, v, bound, causal=True, window=window,
        out_dtype=torch.float32), launches_only(h1=1))
    e_win = (o - bound_plain(q, k, v, True, 0, window)[0]).abs().max().item()
    _require(e_win < V1_WINDOW_O_TOL, f"bound window vs plain {e_win:.3e}")
    win["window"] = autotune_window(q, k, v, window)
    del q, k, v, o
    q, k, v = v1_inputs(torch, dev, 1, 8, 8, 1024, 1024, 256, seed=8)
    zero_counters()
    win["dtiled"] = autotune_dtiled(q, k, v)
    torch.cuda.synchronize()
    _require(read_counters() == launches_only(h5=1),
             "autotune_dtiled runs its first candidate once")
    autotune._CACHE.clear()
    _require(autotune_dtiled(q, k, v, candidates=[]) == win["dtiled"]
             and autotune_splitkv(*v1_inputs(torch, dev, *TILES_SPLIT,
                                             seed=6))
             == win["splitkv"], "autotune's disk cache lost a winner")
    print(f"  tiles autotune on the card: window {window} at L={l} block_q "
          f"{win['window'].block_q}; split-KV at Lkv={TILES_SPLIT[4]} "
          f"kv_tiles_per_block {win['splitkv'].kv_tiles_per_block}; "
          f"d-tiled at d=256 (H5 reads no field: the first candidate, one "
          f"launch) {win['dtiled']}; read back from disk")
    out["autotune"].update(
        window=win["window"].block_q,
        splitkv_kv_tiles_per_block=win["splitkv"].kv_tiles_per_block)
    print(f"  tiles bound over KV spans (B={TILES_SPLIT[0]} Lq="
          f"{TILES_SPLIT[3]} Lkv={TILES_SPLIT[4]}, H1 1 + H2 1) vs plain "
          f"{e_span:.3e} (tol {BOUND_O_TOL:g}); window {window} at L={l} "
          f"(H1 1) vs plain {e_win:.3e} (tol {V1_WINDOW_O_TOL:g})")
    out["paths"] = {"span": e_span, "window": e_win}
    del q, k, v

    # ModelConfig.tile reaches H1: the flagship's forward with 64-row tiles
    cfg = flagship_config()
    params = init_params(cfg, seed=0, device=dev)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 1024))).to(dev)
    zero_counters()
    with torch.no_grad():
        ref = forward(params, tokens, cfg)
        got = forward(params, tokens, dataclasses.replace(cfg, tile=tile64))
    torch.cuda.synchronize()
    fl = read_counters()
    _require(torch.equal(got, ref) and fl == launches_only(
        h1=2 * cfg.n_layers), f"forward with tile block_q=64: launches {fl}")
    print(f"  tiles flagship forward [2, 1024] with ModelConfig.tile "
          f"block_q=64: logits bitwise the default's; launches {fl}")
    del params, ref, got
    print("phase tiles: ok")
    return out


# The heads phase: the serving kernels H1, H2, H6-decode and H6-extend at
# head geometries the JAX model takes beyond the flagship's: any d from 1
# to 256 (ops.attention.kernel_head_dim), any GQA group, pages that are a
# multiple of 128 below 2^15.  H1 at d 16, 80, 96 and 256 (its instances D
# 32, 128, 128, 256) and at d off the multiples of 16 (HEADS_ODD) on a GQA
# group of 16, ragged and cross, under each mask with the LSE and over KV
# spans; H2 on those spans at d 80, 256, 72 and 33
HEADS_H1_DIMS = (16, 80, 96, 256, 1, 8, 33, 36, 40, 72, 100, 250, 257, 264,
                 300, 385, 512)
# d whose rows are no multiple of 16 bytes somewhere: bf16 q/k/v rows by
# TMA at d % 8 == 0 (8, 40, 72), by H1's staged producer otherwise (1, 33
# odd; 36, 100, 250 even); codes at 1, 2, 4 or 8-byte alignment.  Each of
# their checks also holds two known-wrong controls: the rows read one
# element late (the tensor shifted by one element), and each row's last
# column dropped
HEADS_ODD = (1, 8, 33, 36, 40, 72, 100, 250)
# past 256 (bf16): H1 and H6-extend on H5's block of d-chunks (3 at d
# 257-384, 4 at 385-512), H2's instances to 512, H6-decode's D=512
# instance.  bf16 rows of 514 (257), 600 (300) and 770 (385) bytes by the
# staged producer, of 528 (264) and 1024 (512) by TMA; codes of 1 (257,
# 385), 8 (264), 4 (300) and 16-byte (512) alignment.  The d here (not 512)
# hold the misread-row controls too; they stay out of HEADS_ODD, which H3
# and H4 also run (NARROW_HEAD_DIM_RULE)
HEADS_WIDE_ODD = (257, 264, 300, 385)
HEADS_H1_SHAPE = (2, 16, 1, 1000, 1100)        # B, Hq, Hkv, Lq, Lkv
HEADS_WINDOW = 100
HEADS_SPAN = 256
HEADS_H2_DIMS = (80, 256, 72, 33, 257, 300, 512)
HEADS_TIMED = (80, 256, 512)   # each kernel timed at these head dims
# the paged kernels' cases, (d, Hq, Hkv, page size): every d of 16, 80 and
# 256, every group of 1, 16 and 32 and every page size of 128, 512 and 1024
# appears; then heads72's geometry and d off the multiples of 16 (code rows
# 8, 4, 2 and 1-byte aligned); B=8 contexts 257..1100, and for H6-extend a
# 64-token chunk after them
HEADS_PAGED = [(16, 32, 1, 1024), (80, 16, 1, 512), (256, 8, 8, 128),
               (256, 32, 2, 512), (72, 16, 16, 128), (40, 8, 1, 256),
               (36, 32, 2, 512), (250, 8, 4, 128), (33, 16, 1, 1024)]
# past 256 (bf16 only: the f32 phase runs HEADS_PAGED): heads512's
# geometry, a group of 16 (8 chunks of 2 q heads), and code rows of 4, 1
# and 8-byte alignment over pages of 512, 128 and 1024
HEADS_WIDE_PAGED = [(512, 2, 1, 256), (512, 16, 1, 128), (300, 8, 2, 512),
                    (257, 4, 4, 128), (264, 8, 1, 1024)]
# the paged cases timed: d 80 and 256 in a group of 16, heads72's and
# heads512's geometries
HEADS_PAGED_TIMED = ((80, 16, 1, 512), (256, 32, 2, 512), (72, 16, 16, 128),
                     (512, 2, 1, 256))
# H1 timed at d off the multiples of 16: (label, B, H, L, d, causal), MHA.
# SigLIP-so400m's encoder at 384 px (27 x 27 patches of 14, 16 heads of 72,
# no mask), and causal at d 72 and 40 (Stable Diffusion 1.x's first level:
# 8 heads of 40)
HEADS_ODD_TIMED = (("SigLIP-so400m encoder", 32, 16, 729, 72, False),
                   ("causal d=72", 8, 16, 2048, 72, True),
                   ("causal d=40", 8, 8, 2048, 40, True))
HEADS_PAGED_LENS = (257, 1100)
HEADS_CHUNK = 64
# the two models served end to end: the flagship's widths (vocab 32768, 4
# layers, d_model 1024, d_ff 4096, bf16, random weights from seed 0) with
# only the attention geometry changed
HEADS_MODELS = {
    # Gemma's head dim (and GPT-J's), one KV head, 512-token pages
    "heads256": {"n_heads": 4, "n_kv_heads": 1, "d_head": 256,
                 "page_size": 512},
    # Phi-2's head dim in a group of 16 (Llama-3.1-405B's group size)
    "heads80g16": {"n_heads": 16, "n_kv_heads": 1, "d_head": 80,
                   "page_size": 128},
    # SigLIP-so400m's and DiT-XL/2's attention: 16 heads of 72 (hidden
    # 1152), one KV head each; rows of 144 bytes, codes of 72
    "heads72": {"n_heads": 16, "n_kv_heads": 16, "d_head": 72,
                "page_size": 128},
    # the flagship's attention regrouped as 2 heads of 512 over one KV
    # head (no public model uses it; the JAX ModelConfig takes it): H1 and
    # H6-extend on H5's block, H6-decode's D=512 instance; the f32 phase
    # serves it at f32 too (H5's f32 block, the f32 D=512 instances).
    # Served only: H3 takes NARROW_HEAD_DIM_RULE at both dtypes, so
    # heads_train and the f32 training phases leave it out
    "heads512": {"n_heads": 2, "n_kv_heads": 1, "d_head": 512,
                 "page_size": 256},
}
# H1 past 256 timed beside H5 (the same block without masks, LSE or GQA)
# and SDPA: (B, H, L, d), no mask and causal, bf16 O without the LSE
HEADS_WIDE_TIMED = (4, 8, 1024, 512)
# heads80g16's scheduler run: requests of these prompt and new-token
# lengths, 8 slots, 4 up front and 2 more every 8 steps
HEADS_SCHED_PROMPTS = (256, 512, 1024)
HEADS_SCHED_NEW = (16, 32, 48)
HEADS_SCHED_REQUESTS = 12
HEADS_SCHED_SLOTS = 8


def misread_rows(torch, x):
    """A known-wrong load of rows that are no multiple of 16 bytes: each
    element read one element late (x's memory shifted by one), and each
    row's last column dropped."""
    late = x.flatten().roll(-1).view(x.shape)
    drop = x.clone()
    drop[..., -1] = 0
    return {"rows read one element late": late, "last column dropped": drop}


def odd_row_controls(torch, q, k, v, o, scale, diag, causal, window,
                     span=None):
    """max|O - plain| of the kernel's O against the plain version on K
    and V misread as misread_rows does (over spans of ``span`` keys, as
    attention_plain_spans)."""
    from exploring_flash_attention_tpu_torch.ops import attention_plain

    bad_k, bad_v = misread_rows(torch, k), misread_rows(torch, v)
    out = {}
    for name in bad_k:
        if span is None:
            bad, _ = attention_plain(q, bad_k[name], bad_v[name], scale,
                                     causal, diag, window)
        else:
            bad, _ = attention_plain_spans(torch, q, bad_k[name],
                                           bad_v[name], scale, causal, span)
        out[name] = (o - bad).abs().max().item()
    return out


@contextlib.contextmanager
def codes_misread(torch, cache, name):
    """The paged controls of rows no multiple of 16 bytes: the cache's
    codes as misread_rows misreads them (``name`` one of its keys), put
    back after."""
    saved = cache.kv_pages.clone()
    cache.kv_pages.copy_(misread_rows(torch, saved)[name])
    try:
        yield
    finally:
        cache.kv_pages.copy_(saved)


def heads_h1(torch, dev, d, out):
    """H1 at head dim ``d``: the three masks with the LSE and the span
    mode, each one counted launch against the plain version and the f64
    oracle beside the v1 phase's controls; H2 on the span partials at
    HEADS_H2_DIMS; both timed at HEADS_TIMED."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from exploring_flash_attention_tpu_torch.ops import (
        attention_plain,
        prefill_attention,
        splitkv_combine,
        splitkv_combine_plain,
    )
    from exploring_flash_attention_tpu_torch.utils import time_cuda

    b, hq, hkv, lq, lkv = HEADS_H1_SHAPE
    q, k, v = v1_inputs(torch, dev, b, hq, hkv, lq, lkv, d, seed=d)
    scale = 1.0 / math.sqrt(d)
    geo = f"B={b} Hq={hq} Hkv={hkv} Lq={lq} Lkv={lkv} d={d}"
    errs = {}
    for mode in ("none", "causal", "window"):
        causal = mode != "none"
        window = HEADS_WINDOW if mode == "window" else None
        o, lse = counted_call(torch, lambda: prefill_attention(
            q, k, v, scale, lkv - lq, causal, window,
            out_dtype=torch.float32), launches_only(h1=1))
        r = v1_readings(torch, q, k, v, o, lse, causal, window, 1, 2)
        tol = V1_O_TOL if window is None else V1_WINDOW_O_TOL
        print(f"  heads H1 {geo} {mode}: max|dO| vs plain {r['plain']:.3e}, "
              f"vs f64 oracle on [:1, :2] {r['oracle']:.3e} (tol {tol:g}); "
              f"max|dLSE| vs plain {r['lse_plain']:.3e}, vs f64 oracle "
              f"{r['lse_oracle']:.3e} (tol {H1_LSE_TOL:g}); controls: scale "
              f"off by 10% {r['scale']:.3e}, last 64-key tile dropped "
              f"{r['drop']:.3e}; one H1 launch")
        v1_check(r, tol, f"heads H1 d={d} {mode}")
        _require(max(r["lse_plain"], r["lse_oracle"]) < H1_LSE_TOL,
                 f"heads H1 d={d} {mode}: LSE outside tolerance")
        errs[mode] = r["plain"]
        if d in HEADS_ODD + HEADS_WIDE_ODD:
            ctl = odd_row_controls(torch, q, k, v, o, scale, lkv - lq, causal,
                                   window)
            print(f"  heads H1 d={d} {mode} controls (vs plain): "
                  + ", ".join(f"{n} {x:.3e}" for n, x in ctl.items()))
            _require(min(ctl.values()) > tol, f"the check cannot tell a "
                     f"misread row (d={d} {mode})")
            errs[f"{mode}_controls"] = ctl
        del o, lse

    # the span mode (B8's partials), non-causal, and H2 merging them
    o, lse = counted_call(torch, lambda: prefill_attention(
        q, k, v, scale, 0, False, kv_span=HEADS_SPAN,
        out_dtype=torch.float32), launches_only(h1=1))
    ref_o, ref_lse = attention_plain_spans(torch, q, k, v, scale, False,
                                           HEADS_SPAN)
    e_o = (o - ref_o).abs().max().item()
    e_lse = (lse - ref_lse).abs().max().item()
    bad = {"scale off by 10%": attention_plain_spans(
        torch, q, k, v, 1.1 * scale, False, HEADS_SPAN)[0],
        "last 64-key tile dropped": attention_plain_spans(
            torch, q, k[:, :, :-64], v[:, :, :-64], scale, False,
            HEADS_SPAN)[0]}
    ctl = {n: (o - x).abs().max().item() for n, x in bad.items()}
    if d in HEADS_ODD + HEADS_WIDE_ODD:
        ctl.update(odd_row_controls(torch, q, k, v, o, scale, 0, False, None,
                                    span=HEADS_SPAN))
    nkb = o.shape[2]
    print(f"  heads H1 {geo} over {nkb} spans of {HEADS_SPAN} keys: max|dO| "
          f"vs plain {e_o:.3e} (tol {V1_O_TOL:g}), max|dLSE| {e_lse:.3e} "
          f"(tol {H1_LSE_TOL:g}); controls "
          + ", ".join(f"{n} {x:.3e}" for n, x in ctl.items()))
    _require(e_o < V1_O_TOL and e_lse < H1_LSE_TOL,
             f"heads H1 d={d} spans outside tolerance")
    _require(min(ctl.values()) > V1_O_TOL,
             f"the span check cannot tell a wrong path (d={d})")
    errs["spans"] = e_o
    del ref_o, ref_lse, bad
    res = {"max_abs_err": errs}
    if d in HEADS_H2_DIMS:
        got = counted_call(torch, lambda: splitkv_combine(
            o, lse, out_dtype=torch.float32), launches_only(h2=1))
        e_h2 = (got - splitkv_combine_plain(o, lse)).abs().max().item()
        # control: every row's last span left out of the merge
        c_h2 = (got - splitkv_combine_plain(o[:, :, :-1], lse[:, :, :-1])
                ).abs().max().item()
        rows = b * hq * lq
        h2 = {"max_abs_err": e_h2, "library_ms": None}
        if d in HEADS_TIMED:
            h2["ms"] = time_cuda(lambda: splitkv_combine(
                o, lse, out_dtype=torch.bfloat16))
            h2["plain_ms"] = time_cuda(lambda: splitkv_combine_plain(o, lse))
            h2["bound_ms"], h2["bound_by"] = merge_bound(nkb, rows, d)
        print(f"  heads H2 d={d}, {nkb} partials of {rows} rows: vs plain "
              f"{e_h2:.3e} (tol {H2_O_TOL:g}); control (each row's last "
              f"span left out) {c_h2:.3e}; one H2 launch"
              + ("" if "ms" not in h2 else
                 f"; {h2['ms']:.4f} ms (bf16 O) vs plain {h2['plain_ms']:.4f}"
                 f" ms, bound {h2['bound_ms']:.4f} ms ({h2['bound_by']})"))
        _require(e_h2 < H2_O_TOL, f"heads H2 d={d} outside tolerance")
        _require(c_h2 > H2_O_TOL, f"the H2 check cannot tell a wrong "
                 f"merge (d={d})")
        out["h2"][d] = h2
    del o, lse
    if d in HEADS_TIMED:
        flop = 4 * b * hq * lq * lkv * d
        res.update(kernel_times(
            lambda: prefill_attention(q, k, v, scale, 0, False,
                                      with_lse=False),
            lambda: attention_plain(q, k, v, scale, False),
            lambda: sdpa(q, k, v, enable_gqa=True),
            [(flop, H100_BF16_FLOPS)],
            2 * d * 2 * (b * hq * lq + b * hkv * lkv)))
        # the instance: D 32-256, or past 256 H5's block of 3 or 4 chunks
        pad = next(x for x in (32, 64, 128, 256, 384, 512) if x >= d)
        res["padded_work"] = 1 - d / pad
        print(f"  heads H1 {geo} times (no mask, bf16 O): {res['ms']:.4f} ms "
              f"= {flop / res['ms'] / 1e9:.1f} TFLOP/s of the true d's work "
              f"(the instance D={pad} pads {res['padded_work']:.1%} of it); "
              f"bound {res['bound_ms']:.4f} ms ({res['bound_by']}); plain "
              f"{res['plain_ms']:.4f} ms; scaled_dot_product_attention "
              f"{res['library_ms']:.4f} ms")
    out["h1"][d] = res


def heads_odd_times(torch, dev):
    """H1 at HEADS_ODD_TIMED (bf16, no LSE, bf16 O), beside its plain
    version, scaled_dot_product_attention and the bound; each call one
    counted H1 launch first."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from exploring_flash_attention_tpu_torch.ops import (
        attention_plain,
        prefill_attention,
    )

    out = {}
    for name, b, h, l, d, causal in HEADS_ODD_TIMED:
        q, k, v = v1_inputs(torch, dev, b, h, h, l, l, d, seed=d)
        scale = 1.0 / math.sqrt(d)
        call = lambda: prefill_attention(                # noqa: E731
            q, k, v, scale, 0, causal, with_lse=False)
        counted_call(torch, call, launches_only(h1=1))
        pairs = l * (l + 1) // 2 if causal else l * l
        flop = 4 * b * h * pairs * d
        t = kernel_times(call, lambda: attention_plain(q, k, v, scale,
                                                       causal),
                         lambda: sdpa(q, k, v, is_causal=causal),
                         [(flop, H100_BF16_FLOPS)], 4 * b * h * l * d * 2)
        t["shape"] = f"B={b} H={h} L={l} d={d}" + (" causal" if causal
                                                   else "")
        t["tflops"] = flop / t["ms"] / 1e9
        print(f"  heads H1 {name} ({t['shape']}): {t['ms']:.4f} ms = "
              f"{t['tflops']:.1f} TFLOP/s; bound {t['bound_ms']:.4f} ms "
              f"({t['bound_by']}); plain {t['plain_ms']:.4f} ms; "
              f"scaled_dot_product_attention {t['library_ms']:.4f} ms")
        out[name] = t
        del q, k, v
    return out


def heads_wide_times(torch, dev):
    """H1 past 256 at HEADS_WIDE_TIMED (bf16, no LSE, bf16 O; no mask and
    causal), each call one counted H1 launch first, beside H5 (its d-tiled
    forward on the same block, no mask), the plain version,
    scaled_dot_product_attention and the bound."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from exploring_flash_attention_tpu_torch.ops import (
        attention_plain,
        flash_attention_v1_dtiled,
        prefill_attention,
    )
    from exploring_flash_attention_tpu_torch.utils import time_cuda

    b, h, l, d = HEADS_WIDE_TIMED
    q, k, v = v1_inputs(torch, dev, b, h, h, l, l, d, seed=d)
    scale = 1.0 / math.sqrt(d)
    out = {}
    for causal in (False, True):
        call = lambda: prefill_attention(                # noqa: E731
            q, k, v, scale, 0, causal, with_lse=False)
        counted_call(torch, call, launches_only(h1=1))
        pairs = l * (l + 1) // 2 if causal else l * l
        flop = 4 * b * h * pairs * d
        t = kernel_times(call, lambda: attention_plain(q, k, v, scale,
                                                       causal),
                         lambda: sdpa(q, k, v, is_causal=causal),
                         [(flop, H100_BF16_FLOPS)], 4 * b * h * l * d * 2)
        t["shape"] = f"B={b} H={h} L={l} d={d}" + (" causal" if causal
                                                   else "")
        t["tflops"] = flop / t["ms"] / 1e9
        if not causal:
            t["h5_ms"] = time_cuda(lambda: flash_attention_v1_dtiled(q, k, v),
                                   n_iter=20)
        print(f"  heads H1 past 256 ({t['shape']}): {t['ms']:.4f} ms = "
              f"{t['tflops']:.1f} TFLOP/s; bound {t['bound_ms']:.4f} ms "
              f"({t['bound_by']}); plain {t['plain_ms']:.4f} ms; "
              f"scaled_dot_product_attention {t['library_ms']:.4f} ms"
              + ("" if causal else f"; H5 on the same inputs "
                 f"{t['h5_ms']:.4f} ms"))
        out["causal" if causal else "none"] = t
    del q, k, v
    return out


def heads_paged(torch, dev, d, hq, hkv, ps, out):
    """H6-decode and H6-extend at one (d, group, page size): each one
    counted launch against the plain version and the f64 oracle over each
    band, beside the decode and extend phases' controls (the newest token
    hidden; every chunk row's own key hidden), the decode's fused merge
    against the plain merge of its own partials, the tickets zero; both
    timed at HEADS_TIMED, the d=256 case at its group of 16."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from exploring_flash_attention_tpu_torch.ops import splitkv_combine_plain
    from exploring_flash_attention_tpu_torch.serving import (
        decode_chunks,
        decode_split,
        paged_decode_attention,
        paged_decode_partials,
        paged_decode_plain,
        paged_extend_attention,
        paged_extend_plain,
        ticket_buffer,
    )

    b, g = 8, hq // hkv
    max_len = HEADS_PAGED_LENS[1] + HEADS_CHUNK
    timed = (d, hq, hkv, ps) in HEADS_PAGED_TIMED
    scale = 1.0 / math.sqrt(d)
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    cache, q, slots, ctx = make_paged_case(torch, dev, b, hq, hkv, d, ps,
                                           HEADS_PAGED_LENS, max_len, seed=d)
    call = lambda: paged_decode_attention(q, cache, slots)  # noqa: E731
    o = counted_call(torch, call, launches_only(h6=1))
    ref = paged_decode_plain(q, cache, slots, scale)
    oracle = np.stack([band_oracle(q[s:s + 1], cache, s, [int(n) - 1],
                                   None)[0] for s, n in enumerate(ctx)])
    with newest_token_hidden(cache, slots):
        controls = {"newest token hidden": paged_decode_plain(
            q, cache, slots, scale)}
    if d in HEADS_ODD + HEADS_WIDE_ODD:
        for name in ("rows read one element late", "last column dropped"):
            with codes_misread(torch, cache, name):
                controls[name] = paged_decode_plain(q, cache, slots, scale)
    chunks = decode_chunks(g, d)
    split = decode_split(cache, b, None, n_sms, chunks)
    geo = f"B={b} Hq={hq} Hkv={hkv} d={d} ps={ps}"
    err = paged_check(f"heads decode {geo} ctx {ctx.min()}..{ctx.max()}, "
                      f"{chunks} group chunk(s), {split[0]} runs of "
                      f"{split[1]} pages", o, ref,
                      (o.float().cpu().numpy(), oracle), controls,
                      DECODE_O_TOL)
    o_part, lse = paged_decode_partials(q, cache, slots, scale)
    merged = splitkv_combine_plain(o_part, lse)[:, :, 0]
    top = merged.abs().max().item()
    ulp = 2.0 ** (math.floor(math.log2(top)) - 7)
    e_merge = (o.float() - merged).abs().max().item()
    tickets = ticket_buffer(dev)
    print(f"  heads decode {geo}: fused O vs the plain merge of the "
          f"kernel's own partials {e_merge:.3e} (one bf16 ulp of max|O|: "
          f"{ulp:.3e}); tickets zero")
    _require(e_merge <= ulp, f"heads decode {geo}: the fused merge differs")
    _require(tickets is not None and not tickets.any().item(),
             f"heads decode {geo}: tickets not zero")
    res = {"max_abs_err": err, "merge_err": e_merge, "chunks": chunks,
           "split": list(split)}
    if timed:
        k, v, mask = gathered_kv(torch, cache, slots, ctx[:, None] - 1, None)
        qs = q[:, :, None]
        res.update(kernel_times(call, lambda: paged_decode_plain(
            q, cache, slots, scale), lambda: sdpa(
            qs, k, v, attn_mask=mask, enable_gqa=hq != hkv),
            *paged_work(hq, hkv, d, int(ctx.sum()), int(ctx.sum()), b)))
        print(f"  heads decode {geo} times: paged_decode_attention "
              f"{res['ms']:.4f} ms (bound {res['bound_ms']:.4f} ms, "
              f"{res['bound_by']}); plain {res['plain_ms']:.4f} ms; "
              f"scaled_dot_product_attention over the gathered, dequantized "
              f"K/V {res['library_ms']:.4f} ms")
        del k, v, mask
    out["h6"][f"d={d} G={g} ps={ps}"] = res
    del cache, q, o, ref, oracle, controls, o_part, lse, merged

    c = HEADS_CHUNK
    cache, q, slots, hist = make_paged_case(torch, dev, b, hq, hkv, d, ps,
                                            HEADS_PAGED_LENS, max_len,
                                            seed=d + 1, chunk=c)
    call = lambda: paged_extend_attention(q, cache, slots)  # noqa: E731
    o = counted_call(torch, call, launches_only(h6e=1))
    ref = paged_extend_plain(q, cache, slots, scale)
    rows = [0, c // 2, c - 1]
    oracle = np.stack([band_oracle(q[s, rows], cache, s,
                                   [int(n) + i for i in rows], None)
                       for s, n in enumerate(hist)])
    with newest_token_hidden(cache, slots):
        controls = {"every row's own key hidden": paged_extend_plain(
            q, cache, slots, scale)}
    if d in HEADS_ODD + HEADS_WIDE_ODD:
        for name in ("rows read one element late", "last column dropped"):
            with codes_misread(torch, cache, name):
                controls[name] = paged_extend_plain(q, cache, slots, scale)
    err = paged_check(f"heads extend {geo} C={c} history {hist.min()}.."
                      f"{hist.max()}", o, ref,
                      (o[:, rows].float().cpu().numpy(), oracle), controls,
                      EXTEND_O_TOL)
    res = {"max_abs_err": err}
    if timed:
        pos = hist[:, None] + np.arange(c)[None]
        pairs = int((pos + 1).sum())
        k, v, mask = gathered_kv(torch, cache, slots, pos, None)
        qs = q.transpose(1, 2)
        res.update(kernel_times(call, lambda: paged_extend_plain(
            q, cache, slots, scale), lambda: sdpa(
            qs, k, v, attn_mask=mask, enable_gqa=hq != hkv),
            *paged_work(hq, hkv, d, pairs, int((hist + c).sum()), b * c)))
        print(f"  heads extend {geo} times: H6-extend {res['ms']:.4f} ms "
              f"(bound {res['bound_ms']:.4f} ms, {res['bound_by']}); plain "
              f"{res['plain_ms']:.4f} ms; scaled_dot_product_attention over "
              f"the gathered, dequantized K/V {res['library_ms']:.4f} ms")
        del k, v, mask
    out["h6e"][f"d={d} G={g} ps={ps}"] = res


def heads_scheduler(torch, dev, cfg, ps):
    """The continuous-batching scheduler at a model's attention geometry:
    its one-step gate (SCHED_TOL of the f64 oracle over the dequantized
    cache, the newest token hidden beyond it), then HEADS_SCHED_REQUESTS
    requests run twice, the step's CUDA graph replayed (counters: one
    H6-decode launch a step) and the fused step eager, every step's output
    bitwise equal, the completion map right and every page back."""
    from exploring_flash_attention_tpu_torch.oracle import naive_attention
    from exploring_flash_attention_tpu_torch.serving import (
        ContinuousBatchingScheduler,
        Request,
        gather_kv,
    )
    from exploring_flash_attention_tpu_torch.serving.scheduler import (
        _fused_step,
    )

    hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    gen = torch.Generator(device=dev).manual_seed(0)
    mk = lambda *s: torch.randn(*s, generator=gen, device=dev,  # noqa: E731
                                dtype=torch.bfloat16)
    step = (mk(hq, d), mk(hkv, d), mk(hkv, d))
    gs = ContinuousBatchingScheduler(hq, hkv, d, n_pages=8, page_size=ps,
                                     max_seqs=2, device=dev)
    gs.submit(Request(0, mk(256, hkv, d), mk(256, hkv, d), 2,
                      lambda i: step))
    (rid, out0), = gs.step()
    kd, vd = gather_kv(gs.cache, 0)                 # [Hkv, L, d]
    q3 = step[0].float().view(hkv, hq // hkv, d).cpu()
    err = float(np.abs(out0 - naive_attention(q3, kd, vd).reshape(
        hq, d)).max())
    err_bad = float(np.abs(out0 - naive_attention(
        q3, kd[:, :-1], vd[:, :-1]).reshape(hq, d)).max())
    print(f"  heads scheduler Hq={hq} Hkv={hkv} d={d} ps={ps} gate: one step "
          f"over a 256-token prompt, max|dO| vs the f64 oracle {err:.3e} "
          f"(limit {SCHED_TOL:g}); control (newest token hidden) "
          f"{err_bad:.3e}")
    _require(rid == 0 and err < SCHED_TOL, "heads scheduler fails its gate")
    _require(err_bad > SCHED_TOL, "the heads gate cannot tell a wrong step")
    del gs

    reqs = []
    for r in range(HEADS_SCHED_REQUESTS):
        pl = HEADS_SCHED_PROMPTS[r % len(HEADS_SCHED_PROMPTS)]
        st = (mk(hq, d), mk(hkv, d), mk(hkv, d))
        reqs.append(Request(r, mk(pl, hkv, d), mk(pl, hkv, d),
                            HEADS_SCHED_NEW[r % len(HEADS_SCHED_NEW)],
                            lambda i, st=st: st))
    longest = max(HEADS_SCHED_PROMPTS) + max(HEADS_SCHED_NEW)
    per_seq = -(-longest // ps)
    runs = {}
    for mode in ("graphed", "eager"):
        sched = ContinuousBatchingScheduler(
            hq, hkv, d, n_pages=HEADS_SCHED_SLOTS * per_seq, page_size=ps,
            max_seqs=HEADS_SCHED_SLOTS, max_pages_per_seq=per_seq,
            device=dev)
        if mode == "eager":
            def eager(sched=sched):
                b = sched._bufs
                return _fused_step(sched.cache, b.q, b.k, b.v,
                                   b.append_ids, b.decode_slots)
            sched._run_fused_step = eager
        zero_counters()
        for r in reqs[:4]:
            sched.submit(r)
        arrival, steps, tokens, outs = 4, 0, 0, []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        while sched.pending or sched.active or arrival < len(reqs):
            if steps % 8 == 0 and steps and arrival < len(reqs):
                for r in reqs[arrival:arrival + 2]:
                    sched.submit(r)
                arrival = min(arrival + 2, len(reqs))
            rids, o = sched.step(sync=False)
            if o is not None:
                outs.append(o)
                tokens += len(rids)
            steps += 1
            _require(steps < 2000, "the heads scheduler did not converge")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counters()
        _require(launches == launches_only(h6=steps),
                 f"heads scheduler {mode} launches {launches}, expected "
                 f"H6-decode {steps}")
        _require(sched.completed == {r.rid: r.max_new_tokens for r in reqs},
                 f"heads scheduler {mode}: completion map {sched.completed}")
        _require(sched.allocator.free_pages == sched.allocator.n_pages,
                 f"heads scheduler {mode}: pages not returned")
        runs[mode] = {"steps": steps, "tokens": tokens,
                      "tokens_s": tokens / wall, "launches": launches,
                      "outs": outs}
        print(f"  heads scheduler {mode} step: {tokens} tokens in {steps} "
              f"steps, {tokens / wall:.1f} tokens/s (the first step builds "
              f"and captures included); launches {launches}")
        del sched
    same = [torch.equal(a, b) for a, b in zip(runs["graphed"].pop("outs"),
                                              runs["eager"].pop("outs"))]
    print(f"  heads scheduler: graphed vs eager step outputs bitwise equal in "
          f"{sum(same)}/{len(same)} steps")
    _require(same and all(same) and runs["graphed"]["steps"]
             == runs["eager"]["steps"], "a replayed heads step differs from "
             "the eager step")
    return runs


def phase_heads(torch, dev):
    """The serving kernels at the head geometries the JAX model takes
    beyond the flagship's (HEADS_*): H1 (every mask with the LSE, KV
    spans), H2, H6-decode and H6-extend against their plain versions and
    the f64 oracle beside known-wrong controls (at d off the multiples of
    16, HEADS_ODD, rows misread by one element and the last column
    dropped too), timed at d 80 and 256, H1 also at HEADS_ODD_TIMED and
    the paged pair at heads72's geometry; then
    three models at the flagship's widths with another attention geometry
    (HEADS_MODELS) served end to end as the slice and multiturn phases
    serve the flagship (generate on [8, 256] prompts, a 256-token second
    turn; counters, the graphed tokens bitwise the eager loop's, tokens
    against the full forward, the cache against the stream), and
    heads80g16 through the continuous-batching scheduler."""
    out = {"h1": {}, "h2": {}, "h6": {}, "h6e": {}, "models": {}}
    for d in HEADS_H1_DIMS:
        heads_h1(torch, dev, d, out)
    out["h1_odd_times"] = heads_odd_times(torch, dev)
    out["h1_wide_times"] = heads_wide_times(torch, dev)
    for d, hq, hkv, ps in HEADS_PAGED + HEADS_WIDE_PAGED:
        heads_paged(torch, dev, d, hq, hkv, ps, out)
    for name, geo in HEADS_MODELS.items():
        geo = dict(geo)
        ps = geo.pop("page_size")
        lm = make_flagship(torch, dev, name, ps, **geo)
        print(f"  {name}: the flagship's widths with n_heads "
              f"{lm.cfg.n_heads}, n_kv_heads {lm.cfg.n_kv_heads}, d_head "
              f"{lm.cfg.d_head}, page size {ps}")
        launches, gen = phase_slice(torch, dev, lm)
        turn2, tok2 = phase_multiturn(torch, dev, lm)
        out["models"][name] = {"generate_launches": launches,
                               "turn_2_launches": turn2,
                               "tokens_s": gen["tokens_s"],
                               "eager_tokens_s": gen["eager_tokens_s"],
                               "turn_2_tokens_s": tok2}
        if name == "heads80g16":
            out["models"][name]["scheduler"] = heads_scheduler(
                torch, dev, lm.cfg, ps)
        del lm
    print("phase heads: ok")
    return out


# The heads_train phase: the heads phase's three models trained on the
# card, H3 at their head dims (256 on the column-split instance, 80 and 72
# on D=128's zero-filled columns, 72's rows by TMA) timed at their shapes,
# H3 at HEADS_ODD in bf16 and f32 (rows by TMA at bf16 d % 8 == 0, by the
# staged producer else; f32 rows a float at a time at d % 4 != 0) on
# HEADS_H1_SHAPE beside the misread-row controls, and H3 at traced offsets
# at d 80, 256, 72 and 33.  HEADS_TRACED: (q_pos0, kv_pos0, window) of a
# ring's diagonal hop, a past hop and a band off the diagonal, B=2 Hq=16
# Hkv=1 L=300
HEADS_TRACED = ((256, 256, None), (300, 0, None), (100, 37, 100))
HEADS_TRACED_DIMS = (80, 256, 72, 33)
# H3 timed at d off the multiples of 16, bf16: (label, B, Hq, Hkv, L, d,
# causal).  SigLIP-so400m's encoder training step (32 images of 27 x 27
# patches, 16 heads of 72, no mask) and the staged producer (rows of 200
# and 72 bytes) causal at the flagship's training shape otherwise
H3_ODD_TIMED = (("SigLIP-so400m encoder", 32, 16, 16, 729, 72, False),
                ("staged causal d=100", 8, 8, 4, 1024, 100, True),
                ("staged causal d=36", 8, 8, 4, 1024, 36, True))


def h3_traced_check(torch, dev):
    """H3 through flash_attention_bwd at traced positions (0-d int32
    tensors, the offsets every block reads from device memory) bitwise
    its static launch at HEADS_TRACED_DIMS (72 by TMA, 33 by the staged
    producer), one launch each of H3-dkv and H3-dq a call; the static
    launch one key off the diagonal must differ."""
    from exploring_flash_attention_tpu_torch.ops import (
        flash_attention_bwd,
        prefill_attention,
    )

    gen = torch.Generator().manual_seed(16)
    out = {}
    for d in HEADS_TRACED_DIMS:
        q, do = (_bf16(torch, dev, gen, 2, 16, 300, d) for _ in range(2))
        k, v = (_bf16(torch, dev, gen, 2, 1, 300, d) for _ in range(2))
        scale = 1.0 / math.sqrt(d)
        for q_pos, kv_pos, window in HEADS_TRACED:
            diag = q_pos - kv_pos
            o, lse = prefill_attention(q, k, v, scale, diag, True, window)
            offs = torch.tensor((q_pos, kv_pos), dtype=torch.int32,
                                device=dev)
            kw = dict(scale=scale, causal=True, window=window)
            zero_counters()
            traced = flash_attention_bwd(q, k, v, o, do, lse, **kw,
                                         positions=(offs[0], offs[1]))
            torch.cuda.synchronize()
            counts = read_counters()
            static = flash_attention_bwd(q, k, v, o, do, lse, **kw,
                                         static_positions=(q_pos, kv_pos))
            off = flash_attention_bwd(q, k, v, o, do, lse, **kw,
                                      static_positions=(q_pos - 1, kv_pos))
            same = all(torch.equal(a, b) for a, b in zip(traced, static))
            moved = not all(torch.equal(a, b) for a, b in zip(traced, off))
            key = f"d={d} ({q_pos}, {kv_pos})" + (f" window {window}"
                                                  if window else "")
            print(f"  H3 at traced offsets, {key}, B=2 Hq=16 Hkv=1 L=300: "
                  f"bitwise the static launch: {same}; launches {counts}; "
                  f"control (static, one key off the diagonal) differs: "
                  f"{moved}")
            _require(same, f"H3 at traced offsets differs from static ({key})")
            _require(counts == launches_only(h3dkv=1, h3dq=1),
                     f"H3 at traced offsets missed a kernel ({key})")
            # a past hop sees every key either way: no control there
            _require(moved or diag >= 300,
                     f"the traced check cannot tell a wrong diagonal ({key})")
            out[key] = same
    return out


def h3_odd_case(torch, dev, d, f32):
    """H3 at head dim ``d`` (HEADS_ODD) on HEADS_H1_SHAPE (a group of 16
    over one KV head, ragged and cross), bf16 or f32 inputs on H1's
    residuals, under each mask: one counted launch of each kernel, every
    gradient within H3_REL_TOL (F32_H3_TOL at f32) of max|ref| against the
    plain backward and f64 autograd, beside the plain backward on q, k, v
    and dO misread as misread_rows misreads them, which must read beyond
    it."""
    from exploring_flash_attention_tpu_torch.ops import (
        attention_bwd_plain,
        flash_attention_bwd,
        prefill_attention,
    )

    b, hq, hkv, lq, lkv = HEADS_H1_SHAPE
    if f32:
        q, k, v, do = f32_inputs_do(torch, dev, b, hq, hkv, lq, lkv, d,
                                    seed=d + 7)
    else:
        gen = torch.Generator().manual_seed(d)
        q, do = (_bf16(torch, dev, gen, b, hq, lq, d) for _ in range(2))
        k, v = (_bf16(torch, dev, gen, b, hkv, lkv, d) for _ in range(2))
    scale, off = 1.0 / math.sqrt(d), lkv - lq
    tol = F32_H3_TOL if f32 else H3_REL_TOL
    what = (f"{'f32' if f32 else 'bf16'} B={b} Hq={hq} Hkv={hkv} Lq={lq} "
            f"Lkv={lkv} d={d}")
    misread = [misread_rows(torch, x) for x in (q, k, v, do)]
    fmt = lambda e: " ".join(                           # noqa: E731
        f"{n} {x:.3e}" for n, x in zip(("dq", "dk", "dv"), e))
    res = {}
    for mask, (causal, window) in BWD_MASKS.items():
        o, lse = prefill_attention(q, k, v, scale, off, causal, window)
        grads = counted_call(torch, lambda: flash_attention_bwd(
            q, k, v, o, do, lse, scale=scale, causal=causal, window=window),
            launches_only(h3dkv=1, h3dq=1))
        _require(all(g.dtype == q.dtype and torch.isfinite(g).all().item()
                     for g in grads), f"H3 {what} {mask}: gradients")
        plain = attention_bwd_plain(q, k, v, o, do, lse, scale, causal, off,
                                    window)
        f64 = f64_attention_grads(torch, q, k, v, do, scale, causal, off,
                                  window)
        e_plain = [_rel(g, r) for g, r in zip(grads, plain)]
        e_f64 = [_rel(g, r) for g, r in zip(grads, f64)]
        # each control's distance from the kernel over max|plain| (at d=1
        # the last column dropped leaves every gradient zero)
        ctl = {}
        for name in misread[0]:
            bq, bk, bv, bdo = (x[name] for x in misread)
            bad = attention_bwd_plain(bq, bk, bv, o, bdo, lse, scale, causal,
                                      off, window)
            ctl[name] = [((g.float() - x.float()).abs().max()
                          / r.float().abs().max()).item()
                         for g, x, r in zip(grads, bad, plain)]
        print(f"  heads H3 {what} {mask}: max|d|/max|ref| vs plain "
              f"{fmt(e_plain)}; vs f64 autograd {fmt(e_f64)} (tol {tol:g}); "
              + "; ".join(f"control ({n}) {fmt(c)}" for n, c in ctl.items())
              + "; one launch of each kernel")
        _require(max(e_plain + e_f64) <= tol,
                 f"H3 {what} {mask} outside tolerance")
        _require(min(min(c) for c in ctl.values()) > tol,
                 f"the H3 check cannot tell a misread row ({what} {mask})")
        res[mask] = {"rel_err_vs_plain": {"h3dq": e_plain[0],
                                          "h3dkv": max(e_plain[1:])},
                     "rel_err_vs_f64": {"h3dq": e_f64[0],
                                        "h3dkv": max(e_f64[1:])},
                     "controls": {n: {"h3dq": c[0], "h3dkv": min(c[1:])}
                                  for n, c in ctl.items()}}
        del o, lse, grads, plain, f64
    return res


def h3_odd_times(torch, dev):
    """H3 at H3_ODD_TIMED (h3_times: each kernel alone beside the plain
    backward, SDPA's backward and the bound at the true d), bf16."""
    gen = torch.Generator().manual_seed(19)
    out = {}
    for label, b, hq, hkv, l, d, causal in H3_ODD_TIMED:
        q, do = (_bf16(torch, dev, gen, b, hq, l, d) for _ in range(2))
        k, v = (_bf16(torch, dev, gen, b, hkv, l, d) for _ in range(2))
        out[label] = {"shape": f"B={b} Hq={hq} Hkv={hkv} L={l} d={d} "
                               f"{'causal' if causal else 'none'}",
                      **h3_times(torch, q, k, v, do, causal)}
        del q, k, v, do
    return out


def phase_heads_train(torch, dev):
    """The heads phase's models (HEADS_MODELS: the flagship's widths with
    only the attention geometry changed) trained as the flagship is:
    make_train_step as the train phase runs it (the step-0 loss and every
    gradient against the plain attention beside the diagonal-hidden
    controls, H1, H3-dkv and H3-dq 4 launches a step, the loss falling
    over 5 AdamW steps, training tokens/s), the sharded step at
    MeshConfig(1, 1, 1) as the parallel phase runs it, and heads256's and
    heads72's encoders (make_mlm_train_step, bidirectional: H3 without a
    mask at D=256, and at d=72 as SigLIP-so400m's tower trains) as the
    encoder phase runs it, their gradients against the plain backward in
    H3's place (phase_encoder's bwd_ref); then H3 timed at each model's
    shape (B=8, L=1024; causal and without a mask) and at H3_ODD_TIMED,
    H3 at HEADS_ODD in both dtypes (h3_odd_case) and at traced offsets
    (h3_traced_check)."""
    out = {"models": {}, "times": {}, "odd": {"bf16": {}, "f32": {}}}
    from exploring_flash_attention_tpu_torch.ops.attention import (
        narrow_head_dim,
    )

    gen = torch.Generator().manual_seed(17)
    for name, geo in HEADS_MODELS.items():
        geo = {k: x for k, x in geo.items() if k != "page_size"}
        if not narrow_head_dim(geo["d_head"]):
            continue            # heads512: H3 takes d up to 256 at bf16
            #                       and f32 (ROADMAP B4d-train)
        tol = HEADS72_LOSS_TOL if name == "heads72" else TRAIN_LOSS_TOL
        counts, tok_s, checks = phase_train(torch, dev, name, loss_tol=tol,
                                            **geo)
        m = {"train_launches": counts, "tokens_s": tok_s, **checks,
             "sharded": sharded_train_check(torch, dev, name, **geo)}
        if name in ("heads256", "heads72"):
            m["encoder_launches"], m["encoder_tokens_s"] = phase_encoder(
                torch, dev, f"{name} encoder", bwd_ref=True, **geo)
        out["models"][name] = m
        hq, hkv, d = geo["n_heads"], geo["n_kv_heads"], geo["d_head"]
        q, do = (_bf16(torch, dev, gen, 8, hq, 1024, d) for _ in range(2))
        k, v = (_bf16(torch, dev, gen, 8, hkv, 1024, d) for _ in range(2))
        out["times"][d] = {
            "shape": f"B=8 Hq={hq} Hkv={hkv} L=1024 ({name})",
            **{("causal" if c else "none"): h3_times(torch, q, k, v, do, c)
               for c in (True, False)}}
        del q, k, v, do
    out["odd_times"] = h3_odd_times(torch, dev)
    for d in HEADS_ODD:
        for kind in ("bf16", "f32"):
            out["odd"][kind][d] = h3_odd_case(torch, dev, d, kind == "f32")
    out["traced"] = h3_traced_check(torch, dev)
    print("phase heads_train: ok")
    return out


# the phases `--only` takes (a quicker call while a phase is worked on; the
# full run, with no arguments, runs every phase and prints the kernels line)
# The f32 phase.  Limits: the JAX package's own f32 tiers (bench/suite.py's
# referee row holds f32 v1 to 1e-5 and V2 to 1e-4; test_v1_f32_small to
# 2e-5), each against an f64 run of the plain version on the card, the
# paged pair against their plain f32 versions; a bf16 kernel on the same
# inputs rounded to bf16 must read beyond each (1e-3 and more)
F32_REFEREE = (2, 4, 256, 128)                 # B, H, L, d
F32_REFEREE_WINDOW = 64
F32_REFEREE_TOL = 1e-5
F32_SMALL_TOL = 2e-5
F32_V2_TOL = 1e-4
F32_PAGED_TOL = 1e-5
F32_H1_DIMS = (16, 80, 128, 256, 33, 72, 257, 300, 385, 512)
# past 256 (H1 on H5's f32 block in clusters of two): the rows that no
# tensor map takes (f32 d % 4 != 0: 257, 385, by the STAGED producer) hold
# the misread-row controls (misread_rows) beside each check
F32_WIDE_ODD = (257, 385)
# H1 f32 over long key counts, where O sums hundreds of key tiles (one
# fresh P V accumulator a tile, added in f32; ROADMAP B2d), within
# F32_SMALL_TOL of the f64 plain run: TPU kernel B3's route (V1_CASES),
# the same at d=256 (the D=256 instance, 513 tiles of 16 keys) and the
# windowed model's 32768 keys without a mask and under its window:
# (case, B, Hq, Hkv, Lq, Lkv, d, causal, window), inputs from
# make_qkv(seed=Lkv + d)
F32_LONG_KEYS = [
    ("B3's route", 2, 8, 8, 1024, 8200, 128, False, None),
    ("B3's route at d=256", 2, 8, 8, 1024, 8200, 256, False, None),
    ("32768 keys", 1, 8, 1, 256, 32768, 128, False, None),
    ("32768 keys, window 4096", 1, 8, 1, 256, 32768, 128, True, WINDOW),
    ("B3's route at d=512", 1, 4, 2, 512, 8200, 512, False, None),
]
# the paged pair at f32 q: HEADS_PAGED, the f32 flagship's own geometry
# (d, Hq, Hkv, page size), which its slice and second turn run, and past
# 256 HEADS_WIDE_PAGED (heads512's geometry first)
F32_PAGED = HEADS_PAGED + [(128, 8, 4, 128)] + HEADS_WIDE_PAGED
# the paged pair timed at f32 at the served models' geometries: (name, Hq,
# Hkv, d, page size), the slice's contexts 257..280, a 256-token turn
F32_PAGED_TIMED = (("flagship", 8, 4, 128, 128), ("heads512", 2, 1, 512, 256))
# V2 at f32 past 256: H1's f32 spans on H5's f32 block, then H2 on f32
# partials into f32 O (B, H, L, d), V2_CONFIG's spans
F32_V2_WIDE = (2, 4, 1024, 512)
# the f32 core's piece products per f32 product (f32_attention.cuh): H1's
# bf16x6, H6-extend's bf16x3 (q and P against the exact int8 codes)
H1_F32_TERMS = 6
H6E_F32_TERMS = 3
# the f32 flagship's full-forward logits vs an all-plain f32 forward on the
# card, of max|logits|: H1's f32 error (1e-6 of O) through 4 layers; the
# forward with attention on bf16-rounded q, k, v reads ~1e-3 and more
F32_LOGIT_TOL = 1e-4


def f32_core_bound(flops, terms):
    """The f32 core's operations for ``flops`` f32 operations: ``terms``
    bf16 piece products each, at the bf16 tensor-core peak."""
    return [(terms * flops, H100_BF16_FLOPS)]


def f32_fma_ms(flops):
    """What the same f32 operations would take as f32 FMA on the CUDA
    cores at their peak (printed beside the f32 core's bound)."""
    return flops / H100_F32_FLOPS * 1e3


def f32_inputs(torch, dev, b, hq, hkv, lq, lkv, d, seed):
    """Standard-normal f32 q, k, v from np.random.default_rng(seed)."""
    return [torch.from_numpy(x).to(dev)
            for x in cached_qkv(b, hq, hkv, lq, lkv, d, seed)]


def f32_check(what, err, ctl, tol, extra=""):
    """One f32 check: err within tol, the bf16-rounded control beyond."""
    print(f"  f32 {what}: max|dO| {err:.3e} (limit {tol:g}); control "
          f"(inputs rounded to bf16, the bf16 kernel) {ctl:.3e}{extra}")
    _require(err <= tol, f"f32 {what} outside tolerance")
    _require(ctl > tol, f"the f32 check cannot tell bf16 ({what})")


def f32_h1(torch, dev, out):
    """H1 at f32: the referee row's three masks, test_v1_f32_small's
    shape, each d of F32_H1_DIMS under each mask and over KV spans (past
    256 the bound form too, and at F32_WIDE_ODD the misread-row controls),
    the bound form and the 64-row tile, V2 (also past 256, F32_V2_WIDE);
    each one counted launch (V2: H1 1, H2 1) against an f64 plain run on
    the card."""
    from exploring_flash_attention_tpu_torch import SplitKVConfig, TileConfig
    from exploring_flash_attention_tpu_torch.ops import (
        attention_plain,
        flash_attention_v1,
        flash_attention_v2,
        prefill_attention,
    )

    def oracle(q, k, v, scale, causal, diag, window, span=None):
        if span is None:
            return attention_plain(q.double(), k.double(), v.double(), scale,
                                   causal, diag, window)
        parts = [attention_plain(q.double(), k[:, :, s:s + span].double(),
                                 v[:, :, s:s + span].double(), scale, causal,
                                 diag - s, window)
                 for s in range(0, k.shape[2], span)]
        return (torch.stack([p[0] for p in parts], dim=2),
                torch.stack([p[1] for p in parts], dim=2))

    def err(o, ref):
        return (o.double() - ref).abs().max().item()

    def lse_err(lse, ref):
        fin = torch.isfinite(ref)
        _require(torch.equal(torch.isfinite(lse), fin), "LSE -inf rows moved")
        return (lse.double()[fin] - ref[fin]).abs().max().item()

    def h1_case(what, q, k, v, causal, window, tol, span=None, odd=False):
        scale = 1.0 / math.sqrt(q.shape[-1])
        diag = k.shape[2] - q.shape[2]
        call = lambda: prefill_attention(               # noqa: E731
            q, k, v, scale, diag, causal, window, kv_span=span)
        o, lse = counted_call(torch, call, launches_only(h1=1))
        _require(o.dtype == torch.float32, f"f32 {what}: O is {o.dtype}")
        ref, lse_ref = oracle(q, k, v, scale, causal, diag, window, span)
        bad, _ = prefill_attention(q.bfloat16(), k.bfloat16(), v.bfloat16(),
                                   scale, diag, causal, window, kv_span=span,
                                   out_dtype=torch.float32)
        e, e_lse = err(o, ref), lse_err(lse, lse_ref)
        f32_check(what, e, err(bad, ref), tol, f"; max|dLSE| {e_lse:.3e}")
        _require(e_lse <= tol, f"f32 {what}: LSE outside tolerance")
        res = {"max_abs_err": e, "lse_err": e_lse, "control": err(bad, ref)}
        if odd:
            # the rows misread (one element late, the last column dropped)
            ctl = odd_row_controls(torch, q, k, v, o, scale, diag, causal,
                                   window, span=span)
            print(f"  f32 {what} controls (vs plain): "
                  + ", ".join(f"{n} {x:.3e}" for n, x in ctl.items()))
            _require(min(ctl.values()) > tol, f"the f32 check cannot tell "
                     f"a misread row ({what})")
            res["controls"] = ctl
        return res

    masks = {"none": (False, None), "causal": (True, None),
             "window": (True, F32_REFEREE_WINDOW)}
    b, h, l, d = F32_REFEREE
    q, k, v = f32_inputs(torch, dev, b, h, h, l, l, d, seed=0)
    for m, (causal, window) in masks.items():
        out["referee"][m] = h1_case(
            f"H1 referee B={b} H={h} L={l} d={d} {m}", q, k, v, causal,
            window, F32_REFEREE_TOL)
    # the bound form and the 64-row Q tile, through flash_attention_v1
    for what, cfg in (("bound", TileConfig(softmax="bound")),
                      ("64-row tile", TileConfig(block_q=64))):
        call = lambda: flash_attention_v1(q, k, v, cfg,  # noqa: E731
                                          causal=True)
        o = counted_call(torch, call, launches_only(h1=1))
        ref, _ = oracle(q, k, v, 1.0 / math.sqrt(d), True, 0, None)
        bad = flash_attention_v1(q.bfloat16(), k.bfloat16(), v.bfloat16(),
                                 cfg, causal=True, out_dtype=torch.float32)
        f32_check(f"H1 referee causal, {what}", err(o, ref), err(bad, ref),
                  F32_REFEREE_TOL)
        out["referee"][what] = err(o, ref)
    q, k, v = f32_inputs(torch, dev, 1, 2, 2, 256, 256, 128, seed=0)
    o = counted_call(torch, lambda: flash_attention_v1(q, k, v),
                     launches_only(h1=1))
    ref, _ = oracle(q, k, v, 1.0 / math.sqrt(128), False, 0, None)
    bad = flash_attention_v1(q.bfloat16(), k.bfloat16(), v.bfloat16(),
                             out_dtype=torch.float32)
    f32_check("v1 (1, 2, 256, 128), test_v1_f32_small's shape", err(o, ref),
              err(bad, ref), F32_SMALL_TOL)
    out["small"] = err(o, ref)

    b, hq, hkv, lq, lkv = HEADS_H1_SHAPE
    for d in F32_H1_DIMS:
        q, k, v = f32_inputs(torch, dev, b, hq, hkv, lq, lkv, d, seed=d)
        row = {}
        odd = d in F32_WIDE_ODD
        for m, (causal, window) in masks.items():
            window = window and HEADS_WINDOW
            row[m] = h1_case(f"H1 d={d} B={b} Hq={hq} Hkv={hkv} Lq={lq} "
                             f"Lkv={lkv} {m}", q, k, v, causal, window,
                             F32_SMALL_TOL, odd=odd)
        row["spans"] = h1_case(f"H1 d={d} spans of {HEADS_SPAN}", q, k, v,
                               False, None, F32_SMALL_TOL, span=HEADS_SPAN,
                               odd=odd)
        if d > 256:
            # the bound statistic past 256, causal, through
            # flash_attention_v1
            cfg = TileConfig(softmax="bound")
            o = counted_call(torch, lambda: flash_attention_v1(
                q, k, v, cfg, causal=True), launches_only(h1=1))
            ref, _ = oracle(q, k, v, 1.0 / math.sqrt(d), True, lkv - lq,
                            None)
            bad = flash_attention_v1(q.bfloat16(), k.bfloat16(),
                                     v.bfloat16(), cfg, causal=True,
                                     out_dtype=torch.float32)
            f32_check(f"H1 d={d} causal, bound", err(o, ref), err(bad, ref),
                      F32_SMALL_TOL)
            row["bound"] = err(o, ref)
            del o, ref, bad
        out["by_head_dim"][d] = row

    for case, b, hq, hkv, lq, lkv, d, causal, window in F32_LONG_KEYS:
        q, k, v = f32_inputs(torch, dev, b, hq, hkv, lq, lkv, d,
                             seed=lkv + d)
        out["long_keys"][case] = h1_case(
            f"H1 over long keys, {case}: B={b} Hq={hq} Hkv={hkv} Lq={lq} "
            f"Lkv={lkv} d={d}", q, k, v, causal, window, F32_SMALL_TOL)
        del q, k, v

    # V2: H1 over the spans, then H2
    b, h, l, d = V2_SHAPE
    q, k, v = f32_inputs(torch, dev, b, h, h, l, l, d, seed=1)
    cfg = SplitKVConfig(**V2_CONFIG)
    call = lambda: flash_attention_v2(q, k, v, config=cfg)  # noqa: E731
    o = counted_call(torch, call, launches_only(h1=1, h2=1))
    _require(o.dtype == torch.float32, f"f32 V2: O is {o.dtype}")
    ref, _ = oracle(q[:4], k[:4], v[:4], 1.0 / math.sqrt(d), False, 0, None)
    bad = flash_attention_v2(q[:4].bfloat16(), k[:4].bfloat16(),
                             v[:4].bfloat16(), config=cfg,
                             out_dtype=torch.float32)
    f32_check(f"V2 B={b} H={h} L={l} d={d} spans of "
              f"{V2_CONFIG['block_kv']} (batch rows 0-3)", err(o[:4], ref),
              err(bad, ref), F32_V2_TOL)
    out["v2"] = err(o[:4], ref)
    del q, k, v, o, ref, bad
    # past 256: H1's f32 spans on H5's f32 block, H2 on f32 partials
    b, h, l, d = F32_V2_WIDE
    q, k, v = f32_inputs(torch, dev, b, h, h, l, l, d, seed=1)
    o = counted_call(torch, lambda: flash_attention_v2(q, k, v, config=cfg),
                     launches_only(h1=1, h2=1))
    _require(o.dtype == torch.float32, f"f32 V2 d={d}: O is {o.dtype}")
    ref, _ = oracle(q, k, v, 1.0 / math.sqrt(d), False, 0, None)
    bad = flash_attention_v2(q.bfloat16(), k.bfloat16(), v.bfloat16(),
                             config=cfg, out_dtype=torch.float32)
    f32_check(f"V2 B={b} H={h} L={l} d={d} spans of "
              f"{V2_CONFIG['block_kv']}", err(o, ref), err(bad, ref),
              F32_V2_TOL)
    out["v2_wide"] = err(o, ref)


def f32_paged(torch, dev, out):
    """H6-decode and H6-extend with f32 q at each of F32_PAGED: one
    counted launch each, against the plain f32 version (the whole tensor)
    and the f64 oracle over the bands (within F32_PAGED_TOL), O f32, the
    tickets zero; the control is the same q rounded to bf16 through the
    bf16 kernel."""
    from exploring_flash_attention_tpu_torch.serving import (
        paged_decode_attention,
        paged_decode_plain,
        paged_extend_attention,
        paged_extend_plain,
        ticket_buffer,
    )

    b = 8
    for d, hq, hkv, ps in F32_PAGED:
        geo = f"B={b} Hq={hq} Hkv={hkv} d={d} ps={ps}"
        scale = 1.0 / math.sqrt(d)
        max_len = HEADS_PAGED_LENS[1] + HEADS_CHUNK
        gen = torch.Generator().manual_seed(d)
        for kind, chunk in (("decode", 0), ("extend", HEADS_CHUNK)):
            cache, qb, slots, lens = make_paged_case(
                torch, dev, b, hq, hkv, d, ps, HEADS_PAGED_LENS, max_len,
                seed=d + (chunk > 0), chunk=chunk)
            q = torch.randn(qb.shape, generator=gen).to(dev)
            if chunk:
                fn, plain, kern = (paged_extend_attention,
                                   paged_extend_plain, "h6e")
                rows = [0, chunk // 2, chunk - 1]
                pos = [[int(n) + i for i in rows] for n in lens]
                q_or = [q[s, rows] for s in range(b)]
            else:
                fn, plain, kern = (paged_decode_attention,
                                   paged_decode_plain, "h6")
                pos = [[int(n) - 1] for n in lens]
                q_or = [q[s:s + 1] for s in range(b)]
            o = counted_call(torch, lambda: fn(q, cache, slots),
                             launches_only(**{kern: 1}))
            _require(o.dtype == torch.float32, f"f32 {kind}: O {o.dtype}")
            ref = plain(q, cache, slots, scale)
            o64 = np.stack([band_oracle(q_or[s], cache, s, pos[s], None)
                            for s in range(b)])
            got = np.stack([(o[s, rows] if chunk else o[s:s + 1]).cpu()
                            .numpy() for s in range(b)])
            e = (o - ref).abs().max().item()
            e64 = float(np.abs(got - o64).max())
            bad = fn(q.bfloat16(), cache, slots).float()
            ctl = (bad - ref).abs().max().item()
            f32_check(f"{kind} {geo}", e, ctl, F32_PAGED_TOL,
                      f"; vs the f64 oracle over the bands {e64:.3e}")
            _require(e64 <= F32_PAGED_TOL, f"f32 {kind} {geo} vs the oracle")
            if not chunk:
                tickets = ticket_buffer(dev)
                _require(tickets is not None and not tickets.any().item(),
                         f"f32 decode {geo}: tickets not zero")
            out[kern][f"d={d} G={hq // hkv} ps={ps}"] = {
                "max_abs_err": e, "oracle_err": e64, "control": ctl}


def f32_times(torch, dev, out):
    """H1 at bench.py's canonical shape, the generation prefill and past
    256 (HEADS_WIDE_TIMED, beside H5 f32), the paged pair at the served
    models' shapes (F32_PAGED_TIMED: the decode slice, B=8, contexts
    257..280; the second turn, C=256 after them), all at f32:
    the kernel, its plain version, SDPA at f32 (TF32 off; over the
    gathered, dequantized cache for the paged pair) and the bound: the
    piece products at 989 TFLOP/s bf16 for H1 (bf16x6) and H6-extend
    (bf16x3), with what f32 FMA at 67 TFLOP/s would take beside it; the
    bytes for H6-decode."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from exploring_flash_attention_tpu_torch import SplitKVConfig
    from exploring_flash_attention_tpu_torch.ops import (
        attention_plain,
        flash_attention_splitkv_partial,
        flash_attention_v1,
        flash_attention_v1_dtiled,
        flash_attention_v2,
        prefill_attention,
        splitkv_combine,
        splitkv_combine_plain,
    )
    from exploring_flash_attention_tpu_torch.ops.attention_v1 import (
        split_kv_span,
    )
    from exploring_flash_attention_tpu_torch.utils import time_cuda
    from exploring_flash_attention_tpu_torch.serving import (
        paged_decode_attention,
        paged_decode_plain,
        paged_extend_attention,
        paged_extend_plain,
    )

    for name, (b, hq, hkv, l, causal) in (
            ("canonical", (32, 8, 8, 1024, False)),
            ("prefill", (8, 8, 4, 256, True))):
        d = 128
        q, k, v = f32_inputs(torch, dev, b, hq, hkv, l, l, d, seed=1)
        scale = 1.0 / math.sqrt(d)
        pairs = visible_pairs(l, l, causal, None)
        flops = 4 * d * b * hq * pairs
        t = kernel_times(
            lambda: prefill_attention(q, k, v, scale, 0, causal, None,
                                      with_lse=False),
            lambda: attention_plain(q, k, v, scale, causal, 0),
            lambda: sdpa(q, k, v, is_causal=causal, enable_gqa=hq != hkv),
            f32_core_bound(flops, H1_F32_TERMS),
            4 * (2 * b * hq * l * d + 2 * b * hkv * l * d))
        t["fma_bound_ms"] = f32_fma_ms(flops)
        t["shape"] = f"B={b} Hq={hq} Hkv={hkv} L={l} d={d} " + (
            "causal" if causal else "no mask")
        print(f"  f32 H1 {name} ({t['shape']}): {t['ms']:.4f} ms (bound "
              f"{t['bound_ms']:.4f} ms, {t['bound_by']}: bf16x6 at 989 "
              f"TFLOP/s; f32 FMA would take {t['fma_bound_ms']:.4f} ms); "
              f"plain {t['plain_ms']:.4f} ms; scaled_dot_product_attention "
              f"f32 {t['library_ms']:.4f} ms")
        out["h1_times"][name] = t
        del q, k, v

    # every v1 route at f32 (V1_CASES): one call each, its launches as the
    # bf16 call's, O within the small tier of the f64 plain run on the
    # first heads, timed beside the plain version and SDPA at f32
    for name, b, hq, hkv, lq, lkv, d, causal, window, _ in V1_CASES:
        q, k, v = f32_inputs(torch, dev, b, hq, hkv, lq, lkv, d, seed=2)
        split = not causal and split_kv_span(b, hq, lq, lkv) is not None
        want = launches_only(h1=1, h2=int(split))
        call = lambda: flash_attention_v1(              # noqa: E731
            q, k, v, causal=causal, window=window)
        o = counted_call(torch, call, want)
        scale = 1.0 / math.sqrt(d)
        g = hq // hkv                  # the first KV head's q heads
        ref, _ = attention_plain(q[:1, :g].double(), k[:1, :1].double(),
                                 v[:1, :1].double(), scale, causal,
                                 lkv - lq, window)
        err = (o[:1, :g].double() - ref).abs().max().item()
        _require(err <= F32_SMALL_TOL, f"f32 v1 {name}: {err:.3e}")
        mask = None
        if causal:
            i, j = torch.arange(lq, device=dev), torch.arange(lkv, device=dev)
            mask = j[None, :] <= i[:, None] + lkv - lq
            if window is not None:
                mask &= j[None, :] > i[:, None] + lkv - lq - window
        pairs = visible_pairs(lq, lkv, causal, window)
        t = kernel_times(
            call, lambda: attention_plain(q, k, v, scale, causal, lkv - lq,
                                          window),
            lambda: sdpa(q, k, v, attn_mask=mask, enable_gqa=hq != hkv),
            f32_core_bound(4 * d * b * hq * pairs, H1_F32_TERMS),
            4 * d * (2 * b * hq * lq + 2 * b * hkv * lkv), n_iter=10)
        t["fma_bound_ms"] = f32_fma_ms(4 * d * b * hq * pairs)
        t.update(shape=f"B={b} Hq={hq} Hkv={hkv} Lq={lq} Lkv={lkv} d={d}"
                 + (f" window {window}" if window else " causal" if causal
                    else ""), max_abs_err=err, launches=want)
        print(f"  f32 v1 {name} ({t['shape']}): max|dO| vs the f64 plain run "
              f"{err:.3e} (limit {F32_SMALL_TOL:g}); {t['ms']:.4f} ms "
              f"(bound {t['bound_ms']:.4f} ms, {t['bound_by']}); plain "
              f"{t['plain_ms']:.4f} ms; SDPA f32 {t['library_ms']:.4f} ms")
        out["h1_times"][name] = t
        del q, k, v, o, mask

    # V2 at bench_splitkv's shape: the call, and H2 alone on its f32
    # partials into f32 O
    b, h, l, d = V2_SHAPE
    q, k, v = f32_inputs(torch, dev, b, h, h, l, l, d, seed=1)
    cfg = SplitKVConfig(**V2_CONFIG)
    scale = 1.0 / math.sqrt(d)
    t = kernel_times(lambda: flash_attention_v2(q, k, v, config=cfg),
                     lambda: attention_plain(q, k, v, scale, False, 0),
                     lambda: sdpa(q, k, v),
                     f32_core_bound(4 * d * b * h * l * l, H1_F32_TERMS),
                     4 * 4 * b * h * l * d, n_iter=10)
    t["fma_bound_ms"] = f32_fma_ms(4 * d * b * h * l * l)
    o_p, lse = flash_attention_splitkv_partial(q, k, v, config=cfg)
    nkb = o_p.shape[2]
    rows = b * h * l
    h2 = kernel_times(
        lambda: splitkv_combine(o_p, lse, out_dtype=torch.float32),
        lambda: splitkv_combine_plain(o_p, lse), None,
        [(nkb * rows * (2 * d + 1), H100_F32_FLOPS)],
        nkb * rows * (d + 1) * 4 + rows * d * 4)
    t["h2"] = h2
    print(f"  f32 V2 B={b} H={h} L={l} d={d} ({nkb} spans): the call "
          f"{t['ms']:.4f} ms (bound {t['bound_ms']:.4f} ms, bf16x6; f32 FMA "
          f"would take {t['fma_bound_ms']:.4f} ms); plain "
          f"{t['plain_ms']:.4f} ms; SDPA f32 {t['library_ms']:.4f} ms; H2 "
          f"alone into f32 O {h2['ms']:.4f} ms (bound {h2['bound_ms']:.4f} "
          f"ms, {h2['bound_by']}), plain {h2['plain_ms']:.4f} ms")
    out["v2_times"] = t
    del q, k, v, o_p, lse

    # H1 past 256 at HEADS_WIDE_TIMED, no mask and causal, beside H5's f32
    # d-tiled forward on the same inputs (no mask) and SDPA at f32
    b, h, l, d = HEADS_WIDE_TIMED
    q, k, v = f32_inputs(torch, dev, b, h, h, l, l, d, seed=d)
    scale = 1.0 / math.sqrt(d)
    for causal in (False, True):
        call = lambda: prefill_attention(              # noqa: E731
            q, k, v, scale, 0, causal, None, with_lse=False)
        counted_call(torch, call, launches_only(h1=1))
        pairs = visible_pairs(l, l, causal, None)
        flops = 4 * d * b * h * pairs
        t = kernel_times(
            call, lambda: attention_plain(q, k, v, scale, causal, 0),
            lambda: sdpa(q, k, v, is_causal=causal),
            f32_core_bound(flops, H1_F32_TERMS), 4 * 4 * b * h * l * d,
            n_iter=10)
        t["fma_bound_ms"] = f32_fma_ms(flops)
        t["shape"] = f"B={b} H={h} L={l} d={d} " + (
            "causal" if causal else "no mask")
        if not causal:
            t["h5_ms"] = time_cuda(
                lambda: flash_attention_v1_dtiled(q, k, v), n_iter=10)
        print(f"  f32 H1 past 256 ({t['shape']}): {t['ms']:.4f} ms (bound "
              f"{t['bound_ms']:.4f} ms, {t['bound_by']}: bf16x6 at 989 "
              f"TFLOP/s; f32 FMA would take {t['fma_bound_ms']:.4f} ms); "
              f"plain {t['plain_ms']:.4f} ms; SDPA f32 "
              f"{t['library_ms']:.4f} ms"
              + ("" if causal else f"; H5 f32 on the same inputs "
                 f"{t['h5_ms']:.4f} ms"))
        out["h1_times"][f"d={d} " + ("causal" if causal else "no mask")] = t
    del q, k, v

    # the paged pair at the served models' geometries (F32_PAGED_TIMED):
    # the decode slice's contexts and a 256-token second turn
    gen = torch.Generator().manual_seed(11)
    b, c = 8, 256
    for name, hq, hkv, d, ps in F32_PAGED_TIMED:
        scale = 1.0 / math.sqrt(d)
        cache, qb, slots, ctx = make_paged_case(torch, dev, b, hq, hkv, d,
                                                ps)
        q = torch.randn(qb.shape, generator=gen).to(dev)
        k, v, mask = gathered_kv(torch, cache, slots, ctx[:, None] - 1, None)
        qs = q[:, :, None]
        call = lambda: paged_decode_attention(q, cache, slots)  # noqa: E731
        counted_call(torch, call, launches_only(h6=1))
        t = kernel_times(call,
                         lambda: paged_decode_plain(q, cache, slots, scale),
                         lambda: sdpa(qs, k.float(), v.float(),
                                      attn_mask=mask, enable_gqa=hq != hkv),
                         [(4 * d * hq * int(ctx.sum()), H100_F32_FLOPS)],
                         int(ctx.sum()) * hkv * (2 * d + 8)
                         + 2 * b * hq * d * 4)
        t["shape"] = (f"B={b} Hq={hq} Hkv={hkv} d={d} ps={ps} ctx "
                      f"{ctx.min()}..{ctx.max()}")
        print(f"  f32 H6-decode, {name} ({t['shape']}): {t['ms']:.4f} ms "
              f"(bound {t['bound_ms']:.4f} ms, {t['bound_by']}); plain "
              f"{t['plain_ms']:.4f} ms; SDPA f32 over the gathered, "
              f"dequantized K/V {t['library_ms']:.4f} ms")
        out["h6_times" if name == "flagship" else f"h6_times_{name}"] = t
        cache, qb, slots, hist = make_paged_case(torch, dev, b, hq, hkv, d,
                                                 ps, chunk=c, seed=12)
        q = torch.randn(qb.shape, generator=gen).to(dev)
        pos = hist[:, None] + np.arange(c)[None]
        pairs = int((pos + 1).sum())
        k, v, mask = gathered_kv(torch, cache, slots, pos, None)
        qs = q.transpose(1, 2)
        call = lambda: paged_extend_attention(q, cache, slots)  # noqa: E731
        counted_call(torch, call, launches_only(h6e=1))
        t = kernel_times(call,
                         lambda: paged_extend_plain(q, cache, slots, scale),
                         lambda: sdpa(qs, k.float(), v.float(),
                                      attn_mask=mask, enable_gqa=hq != hkv),
                         f32_core_bound(4 * d * hq * pairs, H6E_F32_TERMS),
                         int((hist + c).sum()) * hkv * (2 * d + 8)
                         + 2 * b * c * hq * d * 4)
        t["fma_bound_ms"] = f32_fma_ms(4 * d * hq * pairs)
        t["shape"] = (f"B={b} Hq={hq} Hkv={hkv} d={d} ps={ps} C={c} "
                      f"history {hist.min()}..{hist.max()}")
        print(f"  f32 H6-extend, {name} ({t['shape']}): {t['ms']:.4f} ms "
              f"(bound {t['bound_ms']:.4f} ms, {t['bound_by']}: bf16x3 at "
              f"989 TFLOP/s; f32 FMA would take {t['fma_bound_ms']:.4f} "
              f"ms); plain {t['plain_ms']:.4f} ms; SDPA f32 over the "
              f"gathered, dequantized K/V {t['library_ms']:.4f} ms")
        out["h6e_times" if name == "flagship" else f"h6e_times_{name}"] = t
        del cache, q, k, v, mask


def f32_logits(torch, dev, lm):
    """An f32 model's full forward over its prompts (H1 a launch a layer)
    against an all-plain f32 forward on the card, of max|logits|, beside
    the forward with attention's q, k, v rounded to bf16."""
    from unittest import mock

    from exploring_flash_attention_tpu_torch.models import forward
    from exploring_flash_attention_tpu_torch.models import (
        transformer as transformer_module,
    )

    def rounded(q, k, v, **kw):
        q, k, v = (x.bfloat16().float() for x in (q, k, v))
        return plain_flash_attention(q, k, v, **kw)

    toks = torch.from_numpy(lm.prompt).to(dev)
    got = counted_call(torch, lambda: forward(lm.params, toks, lm.cfg),
                       launches_only(h1=lm.cfg.n_layers))
    with mock.patch.object(transformer_module, "flash_attention",
                           plain_flash_attention):
        ref = forward(lm.params, toks, lm.cfg)
    with mock.patch.object(transformer_module, "flash_attention", rounded):
        bad = forward(lm.params, toks, lm.cfg)
    top = ref.abs().max().item()
    e = (got - ref).abs().max().item() / top
    ctl = (bad - ref).abs().max().item() / top
    print(f"  {lm.tag('full forward')} [8, 256]: logits vs the all-plain "
          f"f32 forward {e:.3e} of max|logits| {top:.3f} (limit "
          f"{F32_LOGIT_TOL:g}); control (attention on bf16-rounded q, k, v) "
          f"{ctl:.3e}")
    _require(e <= F32_LOGIT_TOL < ctl, f"{lm.name} logits")
    return {"logit_err": e, "logit_control": ctl}


def f32_model(torch, dev, name, page_size, bf16=None, **heads):
    """One model served at f32 as the slice and multiturn phases serve the
    flagship, its full-forward logits held against the all-plain f32
    forward; ``bf16``: the same model's bf16 readings of this run
    (launches, tokens/s), which must match its launches and are set beside
    its tokens/s."""
    lm = make_flagship(torch, dev, name, page_size, dtype=torch.float32,
                       **heads)
    print(f"  {name}: dtype {lm.cfg.dtype}, n_heads {lm.cfg.n_heads}, "
          f"n_kv_heads {lm.cfg.n_kv_heads}, d_head {lm.cfg.d_head}, page "
          f"size {page_size}, the flagship's widths otherwise")
    launches, gen = phase_slice(torch, dev, lm)
    turn2, tok2 = phase_multiturn(torch, dev, lm)
    out = {"generate_launches": launches, "turn_2_launches": turn2, **gen,
           "turn_2_tokens_s": tok2, **f32_logits(torch, dev, lm)}
    del lm
    beside = ""
    if bf16 is not None:
        _require(launches == bf16["launches"] and turn2 == bf16["turn2"],
                 f"{name}'s launches {launches}, {turn2} differ from the "
                 f"bf16 model's")
        out["bf16_tokens_s"] = bf16["tokens_s"]
        beside = (f"; bf16 in this run {bf16['tokens_s']:.1f} graphed "
                  f"({gen['tokens_s'] / bf16['tokens_s']:.3f}x)")
    print(f"  {name} generate {gen['tokens_s']:.1f} tokens/s graphed, "
          f"{gen['eager_tokens_s']:.1f} eager, turn 2 {tok2:.1f}{beside}; "
          f"launches a generate H1 {launches['h1']}, H6-decode "
          f"{launches['h6']}, a second turn H6-extend {turn2['h6e']}, "
          f"H6-decode {turn2['h6']}; on {card_line()}")
    return out


def phase_f32(torch, dev, bf16=None, bf16_heads512=None):
    """The serving kernels and two models at f32 (module comment above):
    the flagship, and heads512 past head dim 256 (HEADS_MODELS; H1 and
    H6-extend on H5's f32 block, H6-decode's f32 D=512 instances);
    ``bf16`` and ``bf16_heads512``: the bf16 models' slice readings of
    this run (launches, tokens/s), which the f32 models' are set beside."""
    t0 = time.perf_counter()
    out = {"referee": {}, "by_head_dim": {}, "long_keys": {}, "h6": {},
           "h6e": {}, "h1_times": {}}
    f32_h1(torch, dev, out)
    f32_paged(torch, dev, out)
    f32_times(torch, dev, out)
    out["model"] = f32_model(torch, dev, "f32", 128, bf16)
    geo = dict(HEADS_MODELS["heads512"])
    out["heads512"] = f32_model(torch, dev, "heads512 f32",
                                geo.pop("page_size"), bf16_heads512, **geo)
    print(f"phase f32: ok in {time.perf_counter() - t0:.1f} s")
    return out


def f32_readings(f32, kern):
    """The kernels line's f32 readings of one kernel (h1, h6, h6e)."""
    model, wide = f32["model"], f32["heads512"]
    served = {name: {k: m[k] for k in (
        "tokens_s", "eager_tokens_s", "turn_2_tokens_s", "logit_err",
        "logit_control") + (("bf16_tokens_s",) if "bf16_tokens_s" in m
                            else ())}
        for name, m in (("flagship", model), ("heads512", wide))}
    if kern == "h1":
        return {"times": f32["h1_times"], "v2_times": f32["v2_times"],
                "referee": f32["referee"],
                "small_shape": f32["small"], "v2": f32["v2"],
                "v2_d512": f32["v2_wide"],
                "by_head_dim": f32["by_head_dim"],
                "long_keys": f32["long_keys"],
                "launches": {"generate": model["generate_launches"]["h1"],
                             "heads512_generate":
                                 wide["generate_launches"]["h1"]},
                "models": served}
    times = f32[f"{kern}_times"]
    path = ({"generate": model["generate_launches"]["h6"],
             "turn_2": model["turn_2_launches"]["h6"],
             "heads512_generate": wide["generate_launches"]["h6"],
             "heads512_turn_2": wide["turn_2_launches"]["h6"]}
            if kern == "h6"
            else {"turn_2": model["turn_2_launches"]["h6e"],
                  "heads512_turn_2": wide["turn_2_launches"]["h6e"]})
    return {**times, "heads512_times": f32[f"{kern}_times_heads512"],
            "by_case": f32[kern], "launches": path, "models": served}


# The f32_train phase.  H3 at f32 against f64 autograd of the plain
# forward on the card, max|g - g64| / max|g64| per gradient: 1e-4, the rtol
# of the JAX package's f32 GQA backward test (tests/test_attention_bwd.py:
# 180).  A CPU emulation of the f32 kernels' arithmetic reads <= 5.8e-7,
# the controls (the bf16 kernels on the inputs rounded to bf16; P and dS
# rounded to bf16) 1.0e-3 and more (tests/test_torch_bwd_f32.py)
F32_H3_TOL = 1e-4
# the f32 flagship's step 0 against the all-plain f32 step, far under the
# bf16 limits (TRAIN_LOSS_TOL, GRAD_REL_TOL): the loss (a mean over 8,192
# tokens, or the encoder's ~1,270 masked ones; the diagonal key hidden in
# the forward moves it by 1.8e-4 at bf16) and each leaf's ||dg|| / ||g||
# (H3's bf16 kernels on bf16-rounded inputs as the control)
F32_TRAIN_LOSS_TOL = 2e-5
F32_GRAD_REL_TOL = 1e-4
H3_F32_TERMS = 6               # bf16 piece products an f32 product (bf16x6)
# (B, Hq, Hkv, Lq, Lkv, d, masks) of the H3 f32 checks: the f32 flagship's
# train step (causal) and encoder step (no mask), BWD_SHAPES' ragged case,
# the seq2seq cross attention, d 16, 64 (D = d) and 80 (D=128 on
# zero-filled columns), d 144 (the D=256 cluster's second block on 16
# real columns) and heads256's train and encoder steps (d = D = 256; its
# resident KV rows sum over 4 x 1024 q rows)
F32_BWD_CASES = [(8, 8, 4, 1024, 1024, 128, ("causal", "none")),
                 (*BWD_SHAPES[1], tuple(BWD_MASKS)),
                 (*BWD_CROSS, tuple(BWD_MASKS)),
                 (2, 16, 1, 1000, 1100, 16, tuple(BWD_MASKS)),
                 (2, 8, 4, 1024, 1024, 64, tuple(BWD_MASKS)),
                 (2, 16, 1, 1000, 1100, 80, tuple(BWD_MASKS)),
                 (2, 16, 1, 1000, 1100, 144, tuple(BWD_MASKS)),
                 (8, 4, 1, 1024, 1024, 256, ("causal", "none"))]
F32_TRACED_DIMS = (80, 128, 256)   # H3 f32 at HEADS_TRACED's offsets


def _rel64(got, ref) -> float:
    """max|got - ref| / max|ref| in f64 (ref: the f64 gradient)."""
    return ((got.double() - ref).abs().max() / ref.abs().max()).item()


def banded_grads(torch, fn, q, k, v, do, diag_off, window, *rows):
    """fn(q, k, v, do, diag_off, *rows) -> (dq, dk, dv) over the whole
    shape or, past 4096 rows under a window, block by block of 2048 rows
    against the keys of their bands (the score matrix of L = 32768 would
    take 34 GB in f32), dK and dV summed over the blocks.  ``rows``: per-row
    tensors ([B, H, Lq, ...]) cut with q."""
    lq, lkv = q.shape[2], k.shape[2]
    if lq <= 4096 or window is None:
        return fn(q, k, v, do, diag_off, *rows)
    dqs, dk, dv = [], None, None
    for r0 in range(0, lq, 2048):
        r1 = min(r0 + 2048, lq)
        c0 = max(0, r0 + diag_off - window + 1)
        c1 = min(lkv, r1 + diag_off)
        g = fn(q[:, :, r0:r1], k[:, :, c0:c1], v[:, :, c0:c1],
               do[:, :, r0:r1], r0 + diag_off - c0,
               *(x[:, :, r0:r1] for x in rows))
        if dk is None:
            dk = torch.zeros(k.shape, dtype=g[1].dtype, device=k.device)
            dv = torch.zeros(v.shape, dtype=g[2].dtype, device=v.device)
        dqs.append(g[0])
        dk[:, :, c0:c1] += g[1]
        dv[:, :, c0:c1] += g[2]
    return torch.cat(dqs, dim=2), dk, dv


def rounded_pds_bwd(torch, q, k, v, out, do, lse, scale, causal, diag_off,
                    window):
    """A known-wrong f32 backward: the plain one with P and dS rounded to
    bf16 before their products, as the bf16 kernels round them."""
    from exploring_flash_attention_tpu_torch.ops.attention import (
        LOG2E,
        hidden_keys,
    )
    b, hq, lq, d = q.shape
    hkv, lkv = k.shape[1], k.shape[2]
    g = hq // hkv
    kf, vf = (x.repeat_interleave(g, dim=1) for x in (k, v))
    hidden = torch.isneginf(lse)[..., None]
    band = hidden_keys(lq, lkv, causal, diag_off, window, q.device)
    if band is not None:
        hidden = hidden | band
    s = q @ kf.transpose(-1, -2)
    p = torch.exp2((s * (scale * LOG2E) - lse[..., None] * LOG2E)
                   .masked_fill(hidden, float("-inf")))
    delta = (do * out).sum(dim=-1, keepdim=True)
    ds = (p * (do @ vf.transpose(-1, -2) - delta) * scale).masked_fill(
        hidden, 0.0)
    p, ds = p.bfloat16().float(), ds.bfloat16().float()

    def fold(x):
        return x.view(b, hkv, g, lkv, d).sum(dim=2)

    return (ds @ kf, fold(ds.transpose(-1, -2) @ q),
            fold(p.transpose(-1, -2) @ do))


def bf16_h3_bwd(q, k, v, out, do, lse, scale, causal, diag_off, window):
    """A known-wrong f32 backward in masked_attention_bwd's place: H3's
    bf16 kernels on q, k, v and dO rounded to bf16, the gradients cast
    back to f32."""
    from exploring_flash_attention_tpu_torch.ops.attention_bwd import (
        attention_bwd_dkv,
        attention_bwd_dq,
    )
    q, k, v, do = (x.bfloat16().contiguous() for x in (q, k, v, do))
    delta = (do.float() * out.float()).sum(dim=-1)
    mask = (scale, causal, diag_off, window)
    dk, dv = attention_bwd_dkv(q, k, v, do, lse, delta, *mask)
    dq = attention_bwd_dq(q, k, v, do, lse, delta, *mask)
    return dq.float(), dk.float(), dv.float()


def f32_h3_case(torch, what, q, k, v, do, causal, window, traced=None):
    """H3 at f32 through flash_attention_bwd (one counted launch of each
    kernel) on H1 f32's residuals, against f64 autograd of the plain
    forward, beside both controls; ``traced``: (q_pos0, kv_pos0) passed as
    device tensors, the call also bitwise its static launch."""
    from exploring_flash_attention_tpu_torch.ops import (
        flash_attention_bwd,
        prefill_attention,
    )

    lq, lkv, d = q.shape[2], k.shape[2], q.shape[3]
    scale = 1.0 / math.sqrt(d)
    diag = lkv - lq if traced is None else traced[0] - traced[1]
    out, lse = prefill_attention(q, k, v, scale, diag, causal, window)
    kw = dict(scale=scale, causal=causal, window=window)
    static = functools.partial(flash_attention_bwd, q, k, v, out, do, lse,
                               static_positions=(diag, 0), **kw)
    call = static
    if traced is not None:
        offs = torch.tensor(traced, dtype=torch.int32, device=q.device)
        call = functools.partial(flash_attention_bwd, q, k, v, out, do, lse,
                                 positions=(offs[0], offs[1]), **kw)
    grads = counted_call(torch, call, launches_only(h3dkv=1, h3dq=1))
    _require(all(g.dtype == torch.float32 and torch.isfinite(g).all().item()
                 for g in grads), f"f32 H3 {what}: gradients not finite f32")
    same = None
    if traced is not None:
        same = all(torch.equal(a, b) for a, b in zip(grads, static()))
        _require(same, f"f32 H3 {what}: traced differs from static")
    ref = banded_grads(torch, lambda q_, k_, v_, do_, off: f64_attention_grads(
        torch, q_, k_, v_, do_, scale, causal, off, window),
        q, k, v, do, diag, window)
    bad16 = bf16_h3_bwd(q, k, v, out, do, lse, scale, causal, diag, window)
    bad_pds = banded_grads(
        torch, lambda q_, k_, v_, do_, off, o_, l_: rounded_pds_bwd(
            torch, q_, k_, v_, o_, do_, l_, scale, causal, off, window),
        q, k, v, do, diag, window, out, lse)
    e = [_rel64(g, r) for g, r in zip(grads, ref)]
    c16 = [_rel64(g, r) for g, r in zip(bad16, ref)]
    cpds = [_rel64(g, r) for g, r in zip(bad_pds, ref)]
    fmt = lambda x: " ".join(                           # noqa: E731
        f"{n} {y:.3e}" for n, y in zip(("dq", "dk", "dv"), x))
    print(f"  f32 H3 {what}: max|d|/max|g64| {fmt(e)} (limit "
          f"{F32_H3_TOL:g}); controls: the bf16 kernels on bf16-rounded "
          f"inputs {fmt(c16)}, P and dS rounded to bf16 {fmt(cpds)}"
          + ("" if same is None else f"; bitwise its static launch: {same}"))
    _require(max(e) <= F32_H3_TOL, f"f32 H3 {what} outside tolerance")
    _require(min(c16 + cpds) > F32_H3_TOL,
             f"the f32 H3 check cannot tell a bf16 backward ({what})")
    return {"rel_err": {"h3dq": e[0], "h3dkv": max(e[1:])},
            "control_bf16_kernels": {"h3dq": c16[0], "h3dkv": min(c16[1:])},
            "control_pds_rounded": {"h3dq": cpds[0],
                                    "h3dkv": min(cpds[1:])}}


def f32_inputs_do(torch, dev, b, hq, hkv, lq, lkv, d, seed):
    """f32_inputs' q, k, v and a dO of q's shape, all standard normal."""
    q, k, v = f32_inputs(torch, dev, b, hq, hkv, lq, lkv, d, seed)
    do = f32_inputs(torch, dev, b, hq, hkv, lq, lkv, d, seed + 1)[0]
    return q, k, v, do


def f32_h3_checks(torch, dev):
    """Every H3 f32 check of the phase (module comment above): by case
    name, each mask's readings."""
    out = {}
    for b, hq, hkv, lq, lkv, d, masks in F32_BWD_CASES:
        q, k, v, do = f32_inputs_do(torch, dev, b, hq, hkv, lq, lkv, d,
                                    seed=d + lq)
        geo = f"B={b} Hq={hq} Hkv={hkv} Lq={lq} Lkv={lkv} d={d}"
        for m in masks:
            causal, window = BWD_MASKS[m]
            out[f"{geo} {m}"] = f32_h3_case(torch, f"{geo} {m}", q, k, v, do,
                                            causal, window)
        del q, k, v, do
    b, l = WINDOW_TRAIN
    q, k, v, do = f32_inputs_do(torch, dev, b, 8, 4, l, l, 128, seed=40)
    geo = f"B={b} Hq=8 Hkv=4 L={l} d=128 window {WINDOW}"
    out[geo] = f32_h3_case(torch, f"{geo} (the windowed model's shape)", q,
                           k, v, do, True, WINDOW)
    del q, k, v, do
    for d in F32_TRACED_DIMS:
        q, k, v, do = f32_inputs_do(torch, dev, 2, 16, 1, 300, 300, d,
                                    seed=d)
        for q_pos, kv_pos, window in HEADS_TRACED:
            key = f"d={d} traced ({q_pos}, {kv_pos})" + (
                f" window {window}" if window else "")
            out[key] = f32_h3_case(torch, f"{key}, B=2 Hq=16 Hkv=1 L=300",
                                   q, k, v, do, True, window,
                                   traced=(q_pos, kv_pos))
        del q, k, v, do
    return out


def f32_h3_window_times(torch, dev):
    """H3 f32 alone at the windowed model's shape (B=1, L=32768, window
    4096): CUDA-event medians of each kernel beside its bound."""
    from exploring_flash_attention_tpu_torch.ops import (
        attention_bwd_dkv,
        attention_bwd_dq,
        prefill_attention,
    )
    from exploring_flash_attention_tpu_torch.utils import time_cuda

    b, l = WINDOW_TRAIN
    hq, hkv, d = 8, 4, 128
    q, k, v, do = f32_inputs_do(torch, dev, b, hq, hkv, l, l, d, seed=41)
    s = 1.0 / math.sqrt(d)
    o, lse = prefill_attention(q, k, v, s, 0, True, WINDOW)
    delta = (do * o).sum(dim=-1)
    pairs = visible_pairs(l, l, True, WINDOW) * b * hq
    q_bytes, kv_bytes = b * hq * l * d * 4, b * hkv * l * d * 4
    row_bytes = b * hq * l * 4
    t = {}
    for kern, fn, flop, nbytes in (
            ("h3dkv", lambda: attention_bwd_dkv(q, k, v, do, lse, delta, s,
                                                True, 0, WINDOW),
             8, 2 * q_bytes + 4 * kv_bytes + 2 * row_bytes),
            ("h3dq", lambda: attention_bwd_dq(q, k, v, do, lse, delta, s,
                                              True, 0, WINDOW),
             6, 3 * q_bytes + 2 * kv_bytes + 2 * row_bytes)):
        t[kern] = {"ms": time_cuda(fn, n_iter=5)}
        t[kern]["bound_ms"], t[kern]["bound_by"] = roofline(
            H3_F32_TERMS * flop * d * pairs, nbytes)
    print(f"  f32 H3 at B={b} Hq={hq} Hkv={hkv} L={l} d={d} window "
          f"{WINDOW}: H3-dkv {t['h3dkv']['ms']:.4f} ms (bound "
          f"{t['h3dkv']['bound_ms']:.4f}), H3-dq {t['h3dq']['ms']:.4f} ms "
          f"(bound {t['h3dq']['bound_ms']:.4f})")
    return t


def f32_h3_clusters(torch, dev):
    """The most clusters of H3's f32 D=256 instance (two blocks of 225.5
    KB each, one block an SM) active at once on the card, per kernel."""
    from exploring_flash_attention_tpu_torch import kernels

    lib = kernels.library()
    out = {k: lib.eft_attention_bwd_f32_clusters(i, dev.index)
           for i, k in enumerate(("h3dkv", "h3dq"))}
    print(f"  f32 H3 D=256 (clusters of two blocks): at most "
          f"{out['h3dkv']} H3-dkv and {out['h3dq']} H3-dq clusters active "
          f"at once (cudaOccupancyMaxActiveClusters) on "
          f"{torch.cuda.get_device_properties(dev).multi_processor_count} "
          f"SMs")
    _require(min(out.values()) > 0, "the cluster instance cannot run")
    return out


def f32_h3_same_work(torch, dev):
    """H3 f32's D=128 instance on the work each block of the D=256
    cluster does at heads256's shape, without the exchange: at B=8 Hq=8
    Hkv=2 L=1024 d=128 H3-dkv runs 256 blocks of 64 KV rows over 4 q
    heads and H3-dq 1024 blocks of 64 Q rows, each over 128 columns, as
    the clusters' blocks do.  CUDA-event medians, causal and no mask."""
    from exploring_flash_attention_tpu_torch.ops import (
        attention_bwd_dkv,
        attention_bwd_dq,
        prefill_attention,
    )
    from exploring_flash_attention_tpu_torch.utils import time_cuda

    q, k, v, do = f32_inputs_do(torch, dev, 8, 8, 2, 1024, 1024, 128,
                                seed=20)
    s = 1.0 / math.sqrt(128)
    out = {}
    for causal in (True, False):
        o, lse = prefill_attention(q, k, v, s, 0, causal)
        delta = (do * o).sum(dim=-1)
        out["causal" if causal else "none"] = {
            "h3dkv": time_cuda(lambda: attention_bwd_dkv(
                q, k, v, do, lse, delta, s, causal, 0), n_iter=20),
            "h3dq": time_cuda(lambda: attention_bwd_dq(
                q, k, v, do, lse, delta, s, causal, 0), n_iter=20)}
    print("  f32 H3 D=128 on the per-block work of heads256's D=256 "
          "clusters, without the exchange (B=8 Hq=8 Hkv=2 L=1024 d=128): "
          + "; ".join(f"{m} H3-dkv {t['h3dkv']:.4f} ms, H3-dq "
                      f"{t['h3dq']:.4f} ms" for m, t in out.items()))
    return out


def sdpa_f32_backend(torch, q, k, v, do, causal):
    """SDPA's f32 backward at q's shape (TF32 off): which backends take it,
    each tried alone under sdpa_kernel, and the kernels the dispatcher's
    own pick launches (torch.profiler), the longest first."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from torch.nn.functional import scaled_dot_product_attention as sdpa
    from torch.profiler import ProfilerActivity, profile

    g = q.shape[1] // k.shape[1]
    leaves = [x.detach().clone().requires_grad_() for x in (
        q, k.repeat_interleave(g, 1), v.repeat_interleave(g, 1))]

    def run():
        o = sdpa(*leaves, is_causal=causal)
        torch.autograd.grad(o, leaves, do)
        torch.cuda.synchronize()

    takes = []
    for backend in (SDPBackend.FLASH_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel([backend]):
                run()
            takes.append(backend.name)
        except RuntimeError:
            pass
    run()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
    kern = sorted((e for e in prof.key_averages()
                   if e.device_type.name == "CUDA"
                   and not e.is_user_annotation),
                  key=lambda e: e.self_device_time_total, reverse=True)
    top = [e.key[:90] for e in kern[:3]]
    print(f"  SDPA's f32 backward at B={q.shape[0]} Hq={q.shape[1]} "
          f"L={q.shape[2]} d={q.shape[3]} (is_causal={causal}): backends "
          f"that take it alone {takes}; the default's longest kernels {top}")
    return {"takes": takes, "default_kernels": top}


def f32_heads_train(torch, dev, name, bf16_tok_s=None):
    """A heads model (HEADS_MODELS: heads256, heads72) at
    dtype=torch.float32, trained as the f32 flagship is: make_train_step
    (H1 f32 and H3's f32 instances, 4 launches each a step; the step-0
    loss and gradients against the all-plain f32 step beside the controls;
    the loss falling over 5 AdamW steps; tokens/s beside ``bf16_tok_s``,
    the heads_train phase's reading of the same model in this run), its
    encoder step and its sharded step at MeshConfig(1, 1, 1), each against
    the all-plain f32 path."""
    f32 = dict(dtype=torch.float32)
    tols = dict(loss_tol=F32_TRAIN_LOSS_TOL, grad_tol=F32_GRAD_REL_TOL)
    geo = {k: x for k, x in HEADS_MODELS[name].items() if k != "page_size"}
    counts, tok_s, checks = phase_train(
        torch, dev, f"{name} f32 train", bwd_control=(
            bf16_h3_bwd, "H3's bf16 kernels on bf16-rounded q, k, v, dO"),
        **tols, **f32, **geo)
    m = {"train_launches": counts, "tokens_s": tok_s, **checks}
    m["encoder_launches"], m["encoder_tokens_s"] = phase_encoder(
        torch, dev, f"{name} f32 encoder", **tols, **f32, **geo)
    m["sharded"] = sharded_train_check(torch, dev, f"{name} f32", **tols,
                                       **f32, **geo)
    beside = ""
    if bf16_tok_s is not None:
        m["bf16_tokens_s"] = bf16_tok_s
        beside = (f"; {name} at bf16 in this run {bf16_tok_s:.1f} "
                  f"({tok_s / bf16_tok_s:.3f}x)")
    print(f"  {name} f32 training {tok_s:.1f} tokens/s{beside}; launches "
          f"a step H1 {counts['h1']}, H3-dkv {counts['h3dkv']}, H3-dq "
          f"{counts['h3dq']}; on {card_line()}")
    return m


def phase_f32_train(torch, dev, bf16_train=None, bf16_heads=None):
    """Training at f32 (module comment above); ``bf16_train``: the train
    phase's return of this run (launches, tokens/s, readings), beside
    which the f32 flagship's are set; ``bf16_heads``: the heads models'
    training tokens/s in the heads_train phase of this run, by name."""
    t0 = time.perf_counter()
    out = {"checks": f32_h3_checks(torch, dev),
           "clusters": f32_h3_clusters(torch, dev)}
    gen = torch.Generator().manual_seed(18)
    q, k, v, do = (torch.randn(*s, generator=gen).to(dev) for s in (
        (8, 8, 1024, 128), (8, 4, 1024, 128), (8, 4, 1024, 128),
        (8, 8, 1024, 128)))
    out["times"] = {"shape": "B=8 Hq=8 Hkv=4 L=1024 d=128",
                    **{("causal" if c else "none"): h3_times(torch, q, k, v,
                                                             do, c)
                       for c in (True, False)},
                    "window_train_shape": f32_h3_window_times(torch, dev)}
    q, k, v, do = (torch.randn(*s, generator=gen).to(dev) for s in (
        (8, 4, 1024, 256), (8, 1, 1024, 256), (8, 1, 1024, 256),
        (8, 4, 1024, 256)))
    out["times_heads256"] = {
        "shape": "B=8 Hq=4 Hkv=1 L=1024 d=256 (heads256)",
        **{("causal" if c else "none"): h3_times(torch, q, k, v, do, c)
           for c in (True, False)},
        "sdpa_backend": {("causal" if c else "none"): sdpa_f32_backend(
            torch, q, k, v, do, c) for c in (True, False)}}
    del q, k, v, do
    out["times_heads256"]["same_work_d128"] = f32_h3_same_work(torch, dev)
    q, k, v, do = (torch.randn(*s, generator=gen).to(dev) for s in (
        (8, 16, 1024, 72), (8, 16, 1024, 72), (8, 16, 1024, 72),
        (8, 16, 1024, 72)))
    out["times_heads72"] = {
        "shape": "B=8 Hq=16 Hkv=16 L=1024 d=72 (heads72)",
        **{("causal" if c else "none"): h3_times(torch, q, k, v, do, c)
           for c in (True, False)}}
    del q, k, v, do
    f32 = dict(dtype=torch.float32)
    tols = dict(loss_tol=F32_TRAIN_LOSS_TOL, grad_tol=F32_GRAD_REL_TOL)
    counts, tok_s, checks = phase_train(
        torch, dev, "f32 train", bwd_control=(
            bf16_h3_bwd, "H3's bf16 kernels on bf16-rounded q, k, v, dO"),
        **tols, **f32)
    out["model"] = {"train_launches": counts, "tokens_s": tok_s, **checks}
    out["model"]["encoder_launches"], out["model"]["encoder_tokens_s"] = (
        phase_encoder(torch, dev, "f32 encoder", **tols, **f32))
    out["model"]["sharded"] = sharded_train_check(torch, dev, "f32 flagship",
                                                  **tols, **f32)
    beside = ""
    if bf16_train is not None:
        bf16_counts, bf16_tok_s, _ = bf16_train
        _require(counts == bf16_counts, "the f32 flagship's train launches "
                 f"{counts} differ from the bf16 flagship's {bf16_counts}")
        out["model"]["bf16_tokens_s"] = bf16_tok_s
        beside = (f"; the bf16 flagship in this run {bf16_tok_s:.1f} "
                  f"({tok_s / bf16_tok_s:.3f}x)")
    print(f"  f32 flagship training {tok_s:.1f} tokens/s{beside}; launches "
          f"a step H1 {counts['h1']}, H3-dkv {counts['h3dkv']}, H3-dq "
          f"{counts['h3dq']}; on {card_line()}")
    for name in ("heads256", "heads72"):
        out[name] = f32_heads_train(torch, dev, name,
                                    (bf16_heads or {}).get(name))
    print(f"phase f32_train: ok in {time.perf_counter() - t0:.1f} s")
    return out


def f32_train_readings(f32t, kern):
    """The kernels line's f32 readings of H3-dkv or H3-dq (kern h3dkv,
    h3dq)."""
    t, model = f32t["times"], f32t["model"]
    t256, m256 = f32t["times_heads256"], f32t["heads256"]
    t72, m72 = f32t["times_heads72"], f32t["heads72"]
    return {**t["causal"][kern], "shape": t["shape"] + " causal",
            "heads72_shape": {"shape": t72["shape"],
                              "causal": t72["causal"][kern],
                              "none": t72["none"][kern]},
            "none": t["none"][kern],
            "window_train_shape": t["window_train_shape"][kern],
            "heads256_shape": {
                "shape": t256["shape"], "causal": t256["causal"][kern],
                "none": t256["none"][kern],
                "sdpa_backend": t256["sdpa_backend"],
                "same_work_d128_ms": {
                    m: x[kern] for m, x in t256["same_work_d128"].items()},
                "max_active_clusters": f32t["clusters"][kern]},
            "max_abs_err_rel": {n: c["rel_err"][kern]
                                for n, c in f32t["checks"].items()},
            "controls": {n: {"bf16_kernels": c["control_bf16_kernels"][kern],
                             "pds_rounded": c["control_pds_rounded"][kern]}
                         for n, c in f32t["checks"].items()},
            "launches": {"f32_train_step": model["train_launches"][kern],
                         "f32_encoder_step": model["encoder_launches"][kern],
                         "f32_sharded_train_step":
                             model["sharded"]["launches"][kern],
                         "f32_heads256_train_step":
                             m256["train_launches"][kern],
                         "f32_heads256_encoder_step":
                             m256["encoder_launches"][kern],
                         "f32_heads256_sharded_train_step":
                             m256["sharded"]["launches"][kern],
                         "f32_heads72_train_step":
                             m72["train_launches"][kern],
                         "f32_heads72_encoder_step":
                             m72["encoder_launches"][kern],
                         "f32_heads72_sharded_train_step":
                             m72["sharded"]["launches"][kern]},
            "flagship": {k: model[k] for k in (
                "tokens_s", "loss_err", "loss_control", "grad_err",
                "grad_control", "losses") + (
                ("bf16_tokens_s",) if "bf16_tokens_s" in model else ())},
            **{name: {k: m[k] for k in (
                "tokens_s", "encoder_tokens_s", "loss_err", "loss_control",
                "grad_err", "grad_control", "losses") + (
                ("bf16_tokens_s",) if "bf16_tokens_s" in m else ())}
               for name, m in (("heads256", m256), ("heads72", m72))}}


# The f32_ops phase: H4-kvq with f32 q and H5 with f32 inputs (f32 q over
# int8 or e4m3 K/V) through their entry points, each case one counted
# launch held within the JAX tests' f32 tier (tests/test_quant.py:68,
# tests/test_attention_dtiled.py:32) of the plain f32 version (the whole
# tensor) and of the f64 oracle over the dequantized K/V (a slice), beside
# two known-wrong controls that must read beyond it: the bf16 kernel on
# the inputs rounded to bf16, and the plain version with P rounded to
# bf16 (H5 also: its last d-chunk left out of S and, in a cluster, one
# rank's partial only).  A CPU emulation of each kernel's arithmetic
# reads <= 2.6e-7 of the oracle on inputs made the same way (H5 in its
# clusters' rank order, d 640 to 2048: <= 2.0e-7), the controls >= 1.3e-4
# (tests/test_torch_f32_ops.py).
F32_OPS_TOL = 2e-5
# H5's cases beyond DTILED_CASES (the same fields; "bf16" K/V are f32 in
# this phase): d 128 and 384, and 4096 and 32768 keys at d=512, where O
# sums 128 and 1024 key tiles' P V (each from a fresh accumulator)
F32_DTILED_EXTRA = [
    ("d=128 ragged int8", 2, 8, 1000, 1100, 128, "int8", 128, 6, 2),
    ("d=384 ragged", 2, 8, 1000, 1100, 384, "bf16", None, 7, 2),
    ("d=512 Lkv=4096", 1, 8, 1024, 4096, 512, "bf16", None, 8, 1),
    ("d=512 Lkv=32768", 1, 8, 1024, 32768, 512, "bf16", None, 9, 1),
]
H4KVQ_F32_TERMS = 3            # bf16x3: q's pieces against the codes
H5_F32_TERMS = {"bf16": 6, "int8": 3, "fp8": 3}


def rounded_p_plain(torch, q, k, v, scale):
    """A known-wrong f32 attention: the plain one with P rounded to bf16
    before P V (k, v already dequantized)."""
    s = (q @ k.transpose(-1, -2)) * scale
    p = torch.exp(s - s.amax(-1, keepdim=True))
    return (p.bfloat16().float() @ v) / p.sum(-1, keepdim=True)


def f32_ops_case(torch, what, call, plain_fn, bf16_call, q, k, v, nh):
    """One f32_ops check: the entry point's call (one counted launch of
    the kernel ``call`` names) against the plain f32 version and the f64
    oracle on [:1, :nh], beside both controls on that slice, and H5's
    (dtiled_controls)."""
    from exploring_flash_attention_tpu_torch.ops import (
        QuantizedTensor,
        dequantize,
    )

    kern, fn = call
    o = counted_call(torch, fn, launches_only(**{kern: 1}))
    _require(o.dtype == torch.float32, f"{what}: O is {o.dtype}")
    scale = 1.0 / math.sqrt(q.shape[3])
    quantized = isinstance(k, QuantizedTensor)
    qs = q[:1, :nh]
    ks, vs = ((heads(k, 0, 1, nh), heads(v, 0, 1, nh)) if quantized
              else (k[:1, :nh], v[:1, :nh]))
    kd, vd = (dequantize(ks), dequantize(vs)) if quantized else (ks, vs)
    o64 = plain_fn(qs.double(), ks if quantized else ks.double(),
                   vs if quantized else vs.double(), scale)
    kb, vb = (ks, vs) if quantized else (ks.bfloat16(), vs.bfloat16())
    bad = {"the bf16 kernel on bf16-rounded inputs":
               bf16_call(qs.bfloat16().contiguous(), kb, vb),
           "P rounded to bf16": rounded_p_plain(torch, qs, kd, vd, scale)}
    if kern == "h5":
        bad.update(dtiled_controls(torch, qs, kd, vd, scale, True))
    err = held(torch, what, o, plain_fn(q, k, v, scale), o64.cpu().numpy(),
               {n: x.cpu().numpy() for n, x in bad.items()}, F32_OPS_TOL,
               F32_OPS_TOL, 1, nh, f"; one {kern} launch")
    return {"max_abs_err": err,
            "oracle_err": float((o[:1, :nh].double() - o64).abs().max()),
            "controls_vs_oracle": {
                n: float((x.double() - o64).abs().max())
                for n, x in bad.items()}}


def phase_f32_ops(torch, dev):
    """flash_attention_kvquant (H4-kvq) with f32 q at every KVQ_CASES case
    and flash_attention_v1_dtiled (H5) with f32 inputs at every
    DTILED_CASES case and F32_DTILED_EXTRA's, each against the plain f32
    version and the f64 oracle beside both controls (module comment
    above), and the times at the canonical and d=512 shapes beside the
    plain version, SDPA at f32 (TF32 off; over the dequantized K/V for the
    quantized cases) and the bound: the piece products at 989 TFLOP/s."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from exploring_flash_attention_tpu_torch.ops import (
        attention_dtiled_plain,
        attention_kvquant_plain,
        dequantize,
        flash_attention_kvquant,
        flash_attention_v1_dtiled,
        quantize_fp8,
        quantize_int8,
    )

    t0 = time.perf_counter()
    quant = {"int8": quantize_int8, "fp8": quantize_fp8}
    f32 = torch.float32
    out = {"h4kvq": {"cases": {}, "t": {}}, "h5": {"cases": {}, "t": {}}}
    for case, b, h, lq, lkv, d, kind, block, seed, nh in KVQ_CASES:
        q, k, v = f32_inputs(torch, dev, b, h, h, lq, lkv, d, seed)
        kq, vq = quant[kind](k, block), quant[kind](v, block)
        del k, v
        what = (f"f32_ops kvquant {case}: B={b} H={h} Lq={lq} Lkv={lkv} "
                f"d={d} {kind} block {block}")
        out["h4kvq"]["cases"][case] = f32_ops_case(
            torch, what, ("h4kvq", lambda: flash_attention_kvquant(q, kq, vq)),
            attention_kvquant_plain,
            lambda qb, kb, vb: flash_attention_kvquant(qb, kb, vb,
                                                       out_dtype=f32),
            q, kq, vq, nh)
        if case.startswith("canonical"):
            scale = 1.0 / math.sqrt(d)
            kd, vd = dequantize(kq, f32), dequantize(vq, f32)
            flop = 4 * b * h * lq * lkv * d
            t = kernel_times(
                lambda: flash_attention_kvquant(q, kq, vq),
                lambda: attention_kvquant_plain(q, kq, vq, scale),
                lambda: sdpa(q, kd, vd),
                f32_core_bound(flop, H4KVQ_F32_TERMS),
                2 * b * h * lq * d * 4 + 2 * b * h * lkv * d
                + 2 * kq.scales.numel() * 4)
            t["fma_bound_ms"] = f32_fma_ms(flop)
            print(f"  f32_ops kvquant {kind} times at B={b} H={h} L={lq} "
                  f"d={d}: H4-kvq f32 {t['ms']:.4f} ms (bound "
                  f"{t['bound_ms']:.4f} ms, {t['bound_by']}: bf16x3 at 989 "
                  f"TFLOP/s; f32 FMA would take {t['fma_bound_ms']:.4f} ms), "
                  f"plain {t['plain_ms']:.4f} ms, SDPA f32 over the "
                  f"dequantized K/V {t['library_ms']:.4f} ms")
            out["h4kvq"]["t"][kind] = t
            del kd, vd
        del q, kq, vq

    for case, b, h, lq, lkv, d, kind, block, seed, nh in (DTILED_CASES
                                                          + F32_DTILED_EXTRA):
        q, k, v = f32_inputs(torch, dev, b, h, h, lq, lkv, d, seed)
        if kind != "bf16":
            k, v = quant[kind](k, block), quant[kind](v, block)
        label = case.replace("bf16", "f32")
        what = (f"f32_ops dtiled {label}: B={b} H={h} Lq={lq} Lkv={lkv} "
                f"d={d} {'f32' if kind == 'bf16' else kind} K/V block {block}")
        out["h5"]["cases"][label] = f32_ops_case(
            torch, what, ("h5", lambda: flash_attention_v1_dtiled(q, k, v)),
            attention_dtiled_plain,
            lambda qb, kb, vb: flash_attention_v1_dtiled(qb, kb, vb,
                                                         out_dtype=f32),
            q, k, v, nh)
        if case.startswith(DTILED_TIMED) and "Lkv" not in case:
            scale = 1.0 / math.sqrt(d)
            flop = 4 * b * h * lq * lkv * d
            kv_bytes = (2 * b * h * lkv * d * 4 if kind == "bf16" else
                        2 * b * h * lkv * d + 8 * k.scales.numel())
            kd, vd = ((k, v) if kind == "bf16"
                      else (dequantize(k, f32), dequantize(v, f32)))
            t = kernel_times(
                lambda: flash_attention_v1_dtiled(q, k, v),
                lambda: attention_dtiled_plain(q, k, v, scale),
                lambda: sdpa(q, kd, vd),
                f32_core_bound(flop, H5_F32_TERMS[kind]),
                2 * b * h * lq * d * 4 + kv_bytes)
            t["fma_bound_ms"] = f32_fma_ms(flop)
            backends = ""
            if kind == "bf16":
                t["library_backends_ms"], _ = sdpa_backends(torch, q, k, v)
                backends = f" (backends that take f32 d={d}: " + ", ".join(
                    f"{n} {x:.4f} ms"
                    for n, x in t["library_backends_ms"].items()) + ")"
            terms = "bf16x6" if kind == "bf16" else "bf16x3"
            print(f"  f32_ops dtiled {label} times at B={b} H={h} L={lq}: "
                  f"H5 f32 {t['ms']:.4f} ms (bound {t['bound_ms']:.4f} ms, "
                  f"{t['bound_by']}: {terms} at 989 TFLOP/s; f32 FMA would "
                  f"take {t['fma_bound_ms']:.4f} ms), plain "
                  f"{t['plain_ms']:.4f} ms, SDPA f32"
                  f"{'' if kind == 'bf16' else ' over the dequantized K/V'} "
                  f"{t['library_ms']:.4f} ms{backends}")
            out["h5"]["t"][label] = t
            del kd, vd
        del q, k, v
    print(f"  f32_ops on {card_line()}")
    print(f"phase f32_ops: ok in {time.perf_counter() - t0:.1f} s")
    return out


def f32_ops_entry(f32ops, kern, name, source, replaces, also):
    """The kernels line's entry of an f32 form (kern h4kvq or h5): its
    numbers at the canonical int8 (H4-kvq) or dense d=512 (H5) call, every
    case's readings beside it."""
    r = f32ops[kern]
    main = "int8" if kern == "h4kvq" else "d=512 f32"
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "also_replaces": also, "launches": 1,
            "max_abs_err": max(c["max_abs_err"] for c in r["cases"].values()),
            **r["t"][main], "design": "wgmma",
            "bound_share": r["t"][main]["bound_ms"] / r["t"][main]["ms"],
            "by_kind": {n: x for n, x in r["t"].items() if n != main},
            "by_case": r["cases"]}


# The quant_odd phase: H4-kvq, H4-int8 and H5 at head dims off the
# multiples of 16 (HEADS_ODD), whose rows no tensor map takes (codes d % 16
# != 0, bf16 d % 8, f32 d % 4): the PACKED and STAGED instances, whose
# producers copy the rows themselves.  Each case is one counted launch at
# QUANT_HEADS_SHAPE against the plain version and the f64 oracle on
# [:1, :2], beside the quant phase's controls and rows misread as a wrong
# copy would read them (misread_rows on K's or V's rows, and Q's for
# H4-int8); H5's quantized form past 256 through flash_attention_kvquant
# at QUANT_ODD_H5_DIMS (the last rank's last chunk cut at d, clusters of
# 1 to 4 blocks).  tests/test_torch_quant_heads_odd.py and
# tests/test_torch_dtiled_heads_odd.py rehearse the limits
QUANT_ODD_H5_DIMS = (264, 520, 1000, 2040)
# timed (name, B, H, L, d): SigLIP-so400m's attention (its 27 x 27 patch
# grid, 16 heads of 72: the kvquant and int8 ops, H5 beside H1) and Stable
# Diffusion 1.5's first UNet self-attention (64 x 64 latents, 8 heads of
# 40, a classifier-free-guidance batch of 2: H4-kvq)
QUANT_ODD_TIMED = (("SigLIP-so400m", 32, 16, 729, 72),
                   ("Stable Diffusion 1.5", 2, 8, 4096, 40))
QUANT_ODD_BLOCK = 512


def misread_quantized(torch, qt):
    """misread_rows of a quantized tensor's codes (their bytes: torch rolls
    no e4m3 tensor on the card), its scales kept."""
    from exploring_flash_attention_tpu_torch.ops import QuantizedTensor

    return {n: QuantizedTensor(x.view(qt.values.dtype), qt.scales, qt.block)
            for n, x in misread_rows(
                torch, qt.values.view(torch.uint8)).items()}


def misread_controls(torch, plain, q, k, v, with_q=False):
    """The plain version (``plain(q, k, v)``) on K's rows or V's rows (and
    Q's, with_q) misread as misread_rows misreads them, one at a time (at
    d=1 K and V read late together would keep their pairs)."""
    from exploring_flash_attention_tpu_torch.ops import QuantizedTensor

    wrong = (lambda x: misread_quantized(torch, x)     # noqa: E731
             if isinstance(x, QuantizedTensor) else misread_rows(torch, x))
    out = {}
    for who in ("QKV" if with_q else "KV"):
        for name, bad in wrong({"Q": q, "K": k, "V": v}[who]).items():
            args = {"Q": q, "K": k, "V": v, who: bad}
            out[f"{who}: {name}"] = plain(args["Q"], args["K"], args["V"])
    return out


def phase_quant_odd(torch, dev):
    """flash_attention_kvquant (H4-kvq up to 256, H5's quantized form past
    it), flash_attention_int8 (H4-int8) and flash_attention_v1_dtiled (H5)
    at HEADS_ODD, bf16 and f32 q, int8 and e4m3 K/V (H5 also bf16 or f32
    K/V), and the quantized-KV op at QUANT_ODD_H5_DIMS: each one counted
    launch against the plain version and the f64 oracle beside its
    controls (misread rows among them); then the ops timed at
    QUANT_ODD_TIMED beside SDPA over the dequantized tensors and the
    bound, H5 beside H1 at SigLIP-so400m's shape."""
    from exploring_flash_attention_tpu_torch.ops import (
        attention_dtiled_plain,
        attention_int8_plain,
        attention_kvquant_plain,
        dequantize,
        flash_attention_int8,
        flash_attention_kvquant,
        flash_attention_v1,
        flash_attention_v1_dtiled,
        quantize_fp8,
        quantize_int8,
    )
    from exploring_flash_attention_tpu_torch.ops.attention import (
        attention_plain,
        h4_instance,
    )

    t0 = time.perf_counter()
    quant = {"int8": quantize_int8, "fp8": quantize_fp8}
    f32 = torch.float32
    b, h, lq, lkv = QUANT_HEADS_SHAPE
    blk = QUANT_HEADS_BLOCKS
    out = {"h4kvq": {}, "h4int8": {}, "h5": {}, "times": {}}

    def oracle64(q, k, v):
        """f64 attention on the card over the (dequantized) slice, as a
        numpy array: the oracle's sums (numpy's f64 on the host took most
        of this phase's time)."""
        x64 = [(x if torch.is_tensor(x) else dequantize(x)).double()
               for x in (q, k, v)]
        return attention_plain(*x64, 1.0 / math.sqrt(q.shape[-1]),
                               False)[0].cpu().numpy()

    def case(kern, what, call, plain, sl, whole, tol, f32_q, tol_oracle=None):
        """One check: ``call`` one launch of ``kern``; ``plain(q, k, v,
        scale)`` the plain version, run on ``whole`` (the call's inputs)
        and, wrongly, on the slice ``sl`` ([:1, :2])."""
        o = counted_call(torch, call, launches_only(**{kern: 1}))
        q_, k_, v_ = sl
        scale = 1.0 / math.sqrt(q_.shape[-1])
        deq = lambda x: x if torch.is_tensor(x) else dequantize(x)  # noqa
        o64 = oracle64(q_, k_, v_)
        bad = {"scale x1.1": plain(q_, k_, v_, 1.1 * scale),
               "last tile dropped": plain(
                   q_, *(x[:, :, :-64] if torch.is_tensor(x)
                         else dropped_tile(x) for x in (k_, v_)), scale)}
        if not torch.is_tensor(k_):
            bad["scales rolled"] = plain(q_, rolled(k_), rolled(v_), scale)
        if f32_q:
            bad["P rounded to bf16"] = rounded_p_plain(
                torch, q_, deq(k_), deq(v_), scale)
        bad.update(misread_controls(
            torch, lambda a, b_, c: plain(a, b_, c, scale), q_, k_, v_,
            kern == "h4int8"))
        err = held(torch, what, o, plain(*whole, scale), o64,
                   {n: x.cpu().numpy() for n, x in bad.items()}, tol,
                   tol_oracle or tol, 1, 2, f"; one {kern} launch")
        return {"max_abs_err": err,
                "oracle_err": float(np.abs(o[:1, :2].cpu().numpy()
                                           - o64).max())}

    for d in HEADS_ODD + QUANT_ODD_H5_DIMS:
        kern = "h4kvq" if d <= 256 else "h5"
        inst = f"D={h4_instance(d)}" if d <= 256 else "H5"
        for qdt in ("bf16", "f32"):
            make = v1_inputs if qdt == "bf16" else f32_inputs
            q, k, v = make(torch, dev, b, h, h, lq, lkv, d, d)
            for kind in ("int8", "fp8"):
                kq, vq = (quant[kind](x, blk["kvq"]) for x in (k, v))
                tol = (F32_OPS_TOL if qdt == "f32" else
                       KVQ_O_TOL if d <= 256 else DTILED_O_TOL)
                out["h4kvq" if d <= 256 else "h5"][
                    f"d={d} {qdt} q {kind} (kvquant op)"] = case(
                    kern, f"quant_odd kvquant d={d} ({inst}) {qdt} q {kind}",
                    lambda: flash_attention_kvquant(q, kq, vq, out_dtype=f32),
                    attention_kvquant_plain,
                    (q[:1, :2], heads(kq, 0, 1, 2), heads(vq, 0, 1, 2)),
                    (q, kq, vq), tol, qdt == "f32")
                del kq, vq
            if d <= 256:
                # H5 itself: K/V of q's dtype, or codes
                for kind in ("dense", "int8", "fp8"):
                    if kind == "dense":
                        kx, vx, ks, vs = k, v, k[:1, :2], v[:1, :2]
                    else:
                        kx, vx = (quant[kind](x, blk["kvq"]) for x in (k, v))
                        ks, vs = heads(kx, 0, 1, 2), heads(vx, 0, 1, 2)
                    tol = F32_OPS_TOL if qdt == "f32" else DTILED_O_TOL
                    out["h5"][f"d={d} {qdt} q {kind}"] = case(
                        "h5", f"quant_odd dtiled d={d} {qdt} q {kind} K/V",
                        lambda: flash_attention_v1_dtiled(q, kx, vx,
                                                          out_dtype=f32),
                        attention_dtiled_plain, (q[:1, :2], ks, vs),
                        (q, kx, vx), tol, qdt == "f32")
                    del kx, vx
            del q, k, v
        if d > 256:
            continue
        q, k, v = v1_inputs(torch, dev, b, h, h, lq, lkv, d, d + 1)
        qq = quantize_int8(q, blk["q"])
        kq, vq = (quantize_int8(x, blk["int8"]) for x in (k, v))
        del q, k, v
        for mode in ("bf16", "int8"):
            plain = (lambda a, b_, c, s, m=mode:            # noqa: E731
                     attention_int8_plain(a, b_, c, s, m))
            # pv_mode int8 against the oracle: B18's requantized P is the
            # function's own error (the quant phase's head-dim cases)
            o64 = oracle64(*(heads(x, 0, 1, 2) for x in (qq, kq, vq)))
            p_err = float(np.abs(plain(
                *(heads(x, 0, 1, 2) for x in (qq, kq, vq)),
                1.0 / math.sqrt(d)).cpu().numpy() - o64).max())
            r = case("h4int8", f"quant_odd int8 d={d} (D={h4_instance(d)}) "
                     f"pv_mode {mode}",
                     lambda: flash_attention_int8(qq, kq, vq, out_dtype=f32,
                                                  pv_mode=mode),
                     plain, tuple(heads(x, 0, 1, 2) for x in (qq, kq, vq)),
                     (qq, kq, vq), INT8_PLAIN_TOL, False,
                     INT8_GATE_TOL if mode == "bf16"
                     else p_err + INT8_PLAIN_TOL)
            out["h4int8"][f"d={d} {mode}"] = {**r, "plain_oracle_err": p_err}
        del qq, kq, vq
    print(f"  quant_odd checks in {time.perf_counter() - t0:.1f} s")

    # times at QUANT_ODD_TIMED, each beside SDPA over the dequantized bf16
    # tensors (the dequant not counted) and the bound of the true d
    blk_t = QUANT_ODD_BLOCK
    for name, b, h, l, d in QUANT_ODD_TIMED:
        scale = 1.0 / math.sqrt(d)
        flop = 4 * b * h * l * l * d
        q, k, v = v1_inputs(torch, dev, b, h, h, l, l, d, 1)
        kq, vq = quantize_int8(k, blk_t), quantize_int8(v, blk_t)
        kd, vd = dequantize(kq, q.dtype), dequantize(vq, q.dtype)
        row = {"shape": f"B={b} H={h} L={l} d={d}",
               "instance": f"D={h4_instance(d)}",
               "padded_share": 1 - d / h4_instance(d)}
        t = kernel_times(lambda: flash_attention_kvquant(q, kq, vq),
                         lambda: attention_kvquant_plain(q, kq, vq, scale),
                         None, [(flop, H100_BF16_FLOPS)],
                         2 * b * h * l * d * 2 + 2 * b * h * l * d
                         + 8 * kq.scales.numel())
        _, t["library_ms"] = sdpa_backends(torch, q, kd, vd)
        row["h4kvq"] = t
        if name == "SigLIP-so400m":
            qq = quantize_int8(q, blk_t)
            qd = dequantize(qq, torch.bfloat16)
            ops = 2 * b * h * l * l * d
            for mode in ("bf16", "int8"):
                pv_peak = H100_INT8_OPS if mode == "int8" else H100_BF16_FLOPS
                t = kernel_times(
                    lambda: flash_attention_int8(qq, kq, vq, pv_mode=mode),
                    lambda: [attention_int8_plain(
                        *(heads(x, i, i + 1) for x in (qq, kq, vq)), scale,
                        mode) for i in range(b)],
                    None, [(ops, H100_INT8_OPS), (ops, pv_peak)],
                    3 * b * h * l * d + b * h * l * d * 2
                    + 4 * (qq.scales.numel() + 2 * kq.scales.numel()))
                _, t["library_ms"] = sdpa_backends(torch, qd, kd, vd)
                row[f"h4int8 {mode}"] = t
            del qq, qd
            # H5 at d=72 beside H1 at d=72 on the same bf16 inputs
            nbytes = 4 * b * h * l * d * 2
            sdpa = torch.nn.functional.scaled_dot_product_attention
            lib = lambda: sdpa(q, k, v)                     # noqa: E731
            row["h5"] = kernel_times(
                lambda: flash_attention_v1_dtiled(q, k, v),
                lambda: attention_dtiled_plain(q, k, v, scale), lib,
                [(flop, H100_BF16_FLOPS)], nbytes)
            row["h1"] = kernel_times(
                lambda: flash_attention_v1(q, k, v),
                lambda: attention_plain(q, k, v, scale, False)[0], lib,
                [(flop, H100_BF16_FLOPS)], nbytes)
        print(f"  quant_odd times at {name}'s shape {row['shape']} "
              f"({row['instance']}, {100 * row['padded_share']:.2f}% of the "
              f"products on zero-filled columns): " + "; ".join(
                  f"{n} {x['ms']:.4f} ms (plain {x['plain_ms']:.4f}, SDPA "
                  f"{x['library_ms']:.4f}, bound {x['bound_ms']:.4f} ms "
                  f"{x['bound_by']})" for n, x in row.items()
                  if isinstance(x, dict)))
        out["times"][name] = row
        del q, k, v, kq, vq, kd, vd
    print(f"  quant_odd on {card_line()}")
    print(f"phase quant_odd: ok in {time.perf_counter() - t0:.1f} s")
    return out


PHASES = ("h1", "v1", "tiles", "v2", "quant", "dtiled", "f32_ops",
          "quant_odd", "decode",
          "extend", "scheduler", "bwd", "slice", "multiturn", "speculative",
          "heads", "f32", "train", "heads_train", "f32_train", "encoder",
          "seq2seq", "parallel", "window_train", "window_generate",
          "time_kernels")


def run_only(torch, dev, names):
    """Run the named phases alone, in PHASES order (f32_train beside the
    train and heads_train phases' readings where they run)."""
    lm, done = None, {}
    for name in PHASES:
        if name not in names:
            continue
        fn = globals()["time_kernels" if name == "time_kernels"
                       else f"phase_{name}"]
        if name in ("slice", "multiturn", "speculative"):
            lm = lm or make_flagship(torch, dev)
            fn(torch, dev, lm)
        elif name == "f32_train":
            fn(torch, dev, done.get("train"), heads_tokens_s(
                done.get("heads_train")))
        else:
            done[name] = fn(torch, dev)


def heads_tokens_s(htrain):
    """The heads models' training tokens/s in a heads_train phase's
    return, by name (None where the phase did not run)."""
    return None if htrain is None else {
        name: m["tokens_s"] for name, m in htrain["models"].items()}


def heads_launches(heads, kern):
    """A kernel's launches on the heads phase's paths: each model's
    generate and second turn, and heads80g16's scheduler step."""
    out = {}
    for name, m in heads["models"].items():
        out[f"{name}_generate"] = m["generate_launches"][kern]
        out[f"{name}_turn_2"] = m["turn_2_launches"][kern]
        if "scheduler" in m:
            g = m["scheduler"]["graphed"]
            out[f"{name}_scheduler_step"] = g["launches"][kern] / g["steps"]
    return out


def heads_train_launches(htrain, kern):
    """A kernel's launches on the heads_train phase's paths: each model's
    train step and sharded step, heads256's encoder step."""
    out = {}
    for name, m in htrain["models"].items():
        out[f"{name}_train_step"] = m["train_launches"][kern]
        out[f"{name}_sharded_train_step"] = m["sharded"]["launches"][kern]
        if "encoder_launches" in m:
            out[f"{name}_encoder_step"] = m["encoder_launches"][kern]
    return out


def h3_by_head_dim(by_d, htrain, kern):
    """The kernels line's H3 readings by head dim: the bwd phase's errors
    (each mask, vs the plain version and f64 autograd, beside its control),
    the heads_train phase's at HEADS_ODD (bf16 and f32, beside the
    misread-row controls) and its times at the heads models' shapes and at
    H3_ODD_TIMED, with the instance each d runs on."""
    out = {}
    odd = htrain["odd"]
    for d in sorted(set(by_d) | set(htrain["times"]) | set(odd["bf16"])):
        row = {"instance_d": h3_instance(d)}
        if d in by_d:
            row["checks"] = {
                k: (x if k == "shape" else {
                    r: x[r][kern] for r in ("rel_err_vs_plain",
                                            "rel_err_vs_f64", "control")})
                for k, x in by_d[d].items()}
        if d in odd["bf16"]:
            row["checks_odd"] = {
                "shape": "B={} Hq={} Hkv={} Lq={} Lkv={}".format(
                    *HEADS_H1_SHAPE),
                **{kind: {m: {"rel_err_vs_plain": x["rel_err_vs_plain"][kern],
                              "rel_err_vs_f64": x["rel_err_vs_f64"][kern],
                              "controls": {n: c[kern] for n, c in
                                           x["controls"].items()}}
                          for m, x in odd[kind][d].items()}
                   for kind in ("bf16", "f32")}}
        if d in htrain["times"]:
            t = htrain["times"][d]
            row["times"] = {"shape": t["shape"],
                            **{m: t[m][kern] for m in ("causal", "none")}}
        out[str(d)] = row
    out["odd_times"] = {label: {"shape": t["shape"], **t[kern],
                                "delta_ms": t["delta_ms"],
                                "pair_ms": t["pair_ms"]}
                        for label, t in htrain["odd_times"].items()}
    out["traced_offsets_bitwise_static"] = htrain["traced"]
    out["heads_models"] = {
        name: {k: m[k] for k in ("tokens_s", "loss_err", "loss_control",
                                 "grad_err", "grad_control", "losses")}
        for name, m in htrain["models"].items()}
    return out


def main(argv) -> int:
    import torch

    t_start = time.perf_counter()
    only = None
    if argv:
        _require(len(argv) == 2 and argv[0] == "--only"
                 and set(argv[1].split(",")) <= set(PHASES),
                 f"usage: chip_smoke.py [--only PHASE,...] (of {PHASES})")
        only = set(argv[1].split(","))
    smi = phase_device(torch)
    sys.path.insert(0, str(ROOT))
    try:
        import exploring_flash_attention_tpu_torch as port
    except ImportError as exc:
        raise PhaseError(f"the port is not beside chip_smoke.py: {exc}")
    _require(Path(port.__file__).resolve().parent.parent == ROOT,
             f"the port was imported from {port.__file__}, not from {ROOT}")
    from exploring_flash_attention_tpu_torch import kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    h5_occupancy = phase_build(kernels)
    if only is not None:
        run_only(torch, dev, only)
        _require("jax" not in sys.modules, "JAX was imported")
        print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s, the "
              f"build included")
        print(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    h1_err = phase_h1(torch, dev)
    v1_launches, v1_err, v1_t, h2 = phase_v1(torch, dev)
    tiles = phase_tiles(torch, dev)
    v2_launches, v2_t = phase_v2(torch, dev)
    quant_gates, kvq, int8 = phase_quant(torch, dev)
    dtiled_gates, h5 = phase_dtiled(torch, dev)
    f32ops = phase_f32_ops(torch, dev)
    qodd = phase_quant_odd(torch, dev)
    h6 = phase_decode(torch, dev)
    h6e = phase_extend(torch, dev)
    sched = phase_scheduler(torch, dev)
    h3_err, h3_by_d = phase_bwd(torch, dev)
    lm = make_flagship(torch, dev)
    launches, gen = phase_slice(torch, dev, lm)
    turn2, _ = phase_multiturn(torch, dev, lm)
    spec = phase_speculative(torch, dev, lm)
    del lm
    heads = phase_heads(torch, dev)
    h512 = heads["models"]["heads512"]
    f32 = phase_f32(torch, dev, {"launches": launches, "turn2": turn2,
                                 "tokens_s": gen["tokens_s"]},
                    {"launches": h512["generate_launches"],
                     "turn2": h512["turn_2_launches"],
                     "tokens_s": h512["tokens_s"]})
    train, train_tok_s, train_checks = phase_train(torch, dev)
    htrain = phase_heads_train(torch, dev)
    f32t = phase_f32_train(torch, dev, (train, train_tok_s, train_checks),
                           heads_tokens_s(htrain))
    encoder, _ = phase_encoder(torch, dev)
    s2s = phase_seq2seq(torch, dev)
    par = phase_parallel(torch, dev)
    wtrain, _ = phase_window_train(torch, dev)
    wturn1, wturn2, wgen = phase_window_generate(torch, dev)
    t = time_kernels(torch, dev)
    h6_main, h6e_main = h6[DECODE_CASES[0][0]], h6e[EXTEND_CASES[0][0]]
    spec_rand = spec["legs"]["random draft"]
    spec_self = spec["legs"]["self draft"]["launches"]
    spec_dist = spec["distilled"]["gammas"][SPEC_DISTILL["gammas"][0]]
    distill = spec["distilled"]["distill_launches"]
    main_keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                 "bound_share", "max_abs_err")
    _require("jax" not in sys.modules, "JAX was imported")
    print(json.dumps({"kernels": [
        # H1's numbers are the v1 phase's: its main call at bench.py's
        # canonical shape, and its times there
        {"name": "H1 attention forward (none, causal, window; d from 1 to "
                 "512, bf16 and f32; past 256 on H5's blocks of d-chunks, "
                 "csrc/prefill_attention_wide.cu, at f32 "
                 "csrc/prefill_attention_wide_f32.cu)",
         "route": "cuda", "source": H1_SRC, "replaces": f"{V1_PY}:1139",
         "also_replaces": [f"{V1_PY}:{n}" for n in (387, 213, 489, 901,
                                                     1261, 1357)]
         + [f"{SPLITKV_PY}:51", f"{SPLITKV_PY}:213"],
         "launches": v1_launches["h1"], "max_abs_err": v1_err,
         "design": "wgmma",
         "bound_share": v1_t["bound_ms"] / v1_t["ms"],
         "launches_by_path": {"v1": v1_launches["h1"],
                              "v2": v2_launches["none"]["h1"],
                              "v2_causal": v2_launches["causal"]["h1"],
                              "slice": launches["h1"],
                              "train_step": train["h1"],
                              "f32_train_step":
                                  f32t["model"]["train_launches"]["h1"],
                              "encoder_step": encoder["h1"],
                              "window_train_step": wtrain["h1"],
                              "window_generate_turn_1": wturn1["h1"],
                              "spec_generate": spec_rand["launches"]["h1"],
                              "spec_generate_distilled":
                                  spec_dist["launches"]["h1"],
                              "distill_draft": distill["h1"],
                              "seq2seq_step": s2s["launches"]["h1"],
                              "sharded_train_step":
                                  par["sharded"]["launches"]["h1"],
                              "ring_forward_per_rank": ring_launches(
                                  par, "forward_per_rank", "h1"),
                              **heads_launches(heads, "h1"),
                              **heads_train_launches(htrain, "h1")},
         "by_head_dim": heads["h1"],
         "odd_head_dim_times": heads["h1_odd_times"],
         "wide_head_dim_times": heads["h1_wide_times"],
         "by_dtype": {"f32": f32_readings(f32, "h1")},
         "device_offsets": device_offset_readings(par, "h1"),
         "seq2seq_cross_shape": t["seq2seq_cross"]["h1"],
         "window_train_shape": {m: t["window_train_shape"][m]["h1"]
                                for m in ("window", "causal")},
         **v1_t, "library_ms_by_case": {
             **v1_t["library_ms_by_case"],
             **{f"B4 causal {n}": x
                for n, x in t["h1_causal_library"].items()}}},
        # H1's two new forms, the tiles phase's: the bound statistic at the
        # canonical shape (ms the whole call, the statistic's torch ops
        # included; kernel_ms the kernel's device time from the trace) and
        # the 64-row Q tile at B=1 H=8 L=1024 causal
        {"name": "H1 bound statistic (TileConfig softmax='bound')",
         "route": "cuda", "source": H1_SRC, "replaces": f"{V1_PY}:1139",
         "also_replaces": [f"{V1_PY}:{n}" for n in (387, 213, 1261, 1357)],
         "launches": tiles["bound"]["launches"],
         "max_abs_err": tiles["bound"]["max_abs_err"],
         "ms": tiles["canonical"]["bound"],
         "plain_ms": tiles["canonical"]["plain_bound"],
         "bound_ms": tiles["canonical"]["bound_ms"],
         "bound_by": tiles["canonical"]["bound_by"],
         "library_ms": tiles["canonical"]["sdpa"],
         "kernel_ms": tiles["canonical"]["h1_kernel_ms"]["bound"],
         "exact_kernel_ms": tiles["canonical"]["h1_kernel_ms"]["exact"],
         "exact_ms": tiles["canonical"]["exact"],
         "statistic_ms": tiles["canonical"]["statistic"],
         "statistic_calls": tiles["bound"]["statistic_calls"],
         "statistic_kernels": tiles["canonical"]["statistic_kernels"],
         "oracle_err": tiles["bound"]["oracle_err"],
         "paths_err": tiles["paths"]},
        {"name": "H1 64-row Q tile (TileConfig block_q <= 64)",
         "route": "cuda", "source": H1_SRC, "replaces": f"{V1_PY}:489",
         "launches": tiles["small_causal"]["launches"],
         "max_abs_err": tiles["small_causal"]["max_abs_err"],
         "ms": tiles["small_causal"]["tile64"],
         "plain_ms": tiles["small_causal"]["plain"],
         "bound_ms": tiles["small_causal"]["bound_ms"],
         "bound_by": tiles["small_causal"]["bound_by"],
         "library_ms": tiles["small_causal"]["sdpa"],
         "tile128_ms": tiles["small_causal"]["tile128"],
         "canonical_ms": {"tile64": tiles["canonical"]["tile64"],
                          "tile128": tiles["canonical"]["exact"]},
         "autotune_block_q": tiles["autotune"],
         "kernel_report": tiles["report"]},
        # H2: its numbers are the v1 phase's split case, its launches that
        # call's.  Its arithmetic (csrc/lse_merge.cuh) also runs inside
        # H6-decode, whose last block merges the runs: decode_merge_ms is
        # that merge's cost (the fused call less the kernel without it)
        # beside the two-launch form, with H2 after the kernel
        {"name": "H2 split-KV combine (LSE-weighted merge of span partials)",
         "route": "cuda", "source": H2_SRC, "replaces": f"{SPLITKV_PY}:330",
         **h2, "launches": h2["launches"],
         "design": "a row per d/4 lanes, 16-byte loads, LSEs read once "
                   "into registers (csrc/lse_merge.cuh, shared with "
                   "H6-decode's merge)",
         "v2": v2_t,
         "launches_by_path": {"v1": h2["launches"],
                              "v2": v2_launches["none"]["h2"],
                              "v2_causal": v2_launches["causal"]["h2"],
                              "slice": launches["h2"],
                              "multiturn_turn_2": turn2["h2"],
                              "window_generate_turn_1": wturn1["h2"],
                              "window_generate_turn_2": wturn2["h2"],
                              **heads_launches(heads, "h2")},
         "by_head_dim": heads["h2"],
         "decode_merge_ms": {n: x["merge_ms"] for n, x in h6.items()},
         "decode_merge_bound_ms": {n: x["merge_bound_ms"]
                                   for n, x in h6.items()},
         "decode_two_launch_ms": {n: x["two_launch_ms"]
                                  for n, x in h6.items()},
         "decode_h2_ms": {n: x["h2_ms"] for n, x in h6.items()}},
        # H6's numbers are the slice's and the multi-turn's cases; by_case
        # holds every case of the decode and extend phases
        {"name": "H6-decode paged INT8 decode attention (window; d from 1 "
                 "to 512, bf16 and f32 q, any group, pages a multiple of "
                 "128; split across the SMs, the runs merged in its last "
                 "block)",
         "route": "cuda", "source": H6_SRC,
         "replaces": "exploring_flash_attention_tpu/serving/decode.py:74",
         "launches": launches["h6"],
         **{k: h6_main[k] for k in main_keys},
         "design": "split-KV over a 1-D TMA (cp.async.bulk) ring, merged "
                   "by the last block of each (sequence, KV head) on an "
                   "atomic ticket",
         "partials_ms": h6_main["partials_ms"],
         "two_launch_ms": h6_main["two_launch_ms"], "by_case": h6,
         "generate_tokens_s": {"graphed": gen["tokens_s"],
                               "eager": gen["eager_tokens_s"],
                               "windowed_graphed": wgen["turn1_tokens_s"],
                               "windowed_eager":
                                   wgen["turn1_eager_tokens_s"]},
         "scheduler": sched,
         "launches_by_path": {"slice": launches["h6"],
                              "scheduler_step": (
                                  sched["graphed"]["launches"]["h6"]
                                  / sched["graphed"]["steps"]),
                              "multiturn_turn_2": turn2["h6"],
                              "window_generate_turn_1": wturn1["h6"],
                              "window_generate_turn_2": wturn2["h6"],
                              "spec_generate": spec_rand["launches"]["h6"],
                              "distill_draft": distill["h6"],
                              **heads_launches(heads, "h6")},
         "by_head_dim": heads["h6"],
         "by_dtype": {"f32": f32_readings(f32, "h6")},
         "heads_models": {n: {k: x[k] for k in ("tokens_s", "eager_tokens_s",
                                                "turn_2_tokens_s")}
                          for n, x in heads["models"].items()}},
        {"name": "H6-extend paged INT8 chunked-prefill attention (window; d "
                 "from 1 to 512, bf16 and f32 q, any group, pages a "
                 "multiple of 128; past 256 on H5's blocks, "
                 "csrc/paged_extend_wide.cu, at f32 q "
                 "csrc/paged_extend_wide_f32.cu)",
         "route": "cuda", "source": H6E_SRC,
         "replaces": "exploring_flash_attention_tpu/serving/decode.py:257",
         "also_replaces": "exploring_flash_attention_tpu/serving/decode.py:455",
         "launches": turn2["h6e"], **{k: h6e_main[k] for k in main_keys},
         "design": "wgmma", "by_case": h6e,
         "launches_by_path": {"multiturn_turn_2": turn2["h6e"],
                              "window_generate_turn_2": wturn2["h6e"],
                              "spec_generate": spec_rand["launches"]["h6e"],
                              "spec_generate_self": spec_self["h6e"],
                              "spec_generate_distilled":
                                  spec_dist["launches"]["h6e"],
                              **heads_launches(heads, "h6e")},
         "by_head_dim": heads["h6e"],
         "by_dtype": {"f32": f32_readings(f32, "h6e")},
         "speculative": spec},
        # H3's numbers are the training shape's, causal as the train step
        # runs it; "none" holds them without a mask, as the encoder step
        # runs it.  plain_ms is the whole plain backward, and library_ms
        # the whole backward of scaled_dot_product_attention
        *({"name": f"H3-{n} attention backward, {what} (none, causal, "
                   "window; d from 1 to 256, bf16 and f32; f32 d 129-256 "
                   "on a cluster of two blocks)",
           "route": "cuda", "source": H3_SRC, "replaces": f"{BWD_PY}:458",
           "also_replaces": [f"{BWD_PY}:{x}" for x in (281, 377, 112, 205)],
           "launches": train[f"h3{n}"],
           "max_abs_err": h3_err["causal"][f"h3{n}"], "design": "wgmma",
           **t["h3_causal"][f"h3{n}"],
           "launches_by_path": {"train_step": train[f"h3{n}"],
                                "encoder_step": encoder[f"h3{n}"],
                                "window_train_step": wtrain[f"h3{n}"],
                                "seq2seq_step": s2s["launches"][f"h3{n}"],
                                "distill_draft": distill[f"h3{n}"],
                                "sharded_train_step":
                                    par["sharded"]["launches"][f"h3{n}"],
                                "ring_backward_per_rank": ring_launches(
                                    par, "backward_per_rank", f"h3{n}"),
                                **heads_train_launches(htrain, f"h3{n}")},
           "device_offsets": device_offset_readings(par, f"h3{n}"),
           "by_head_dim": h3_by_head_dim(h3_by_d, htrain, f"h3{n}"),
           "seq2seq_cross_shape": t["seq2seq_cross"][f"h3{n}"],
           "window_library_bwd": t["window_train_shape"][
               "window_library_bwd"],
           "max_abs_err_seq2seq_cross_shape":
               h3_err["cross"][f"h3{n}"],
           "max_abs_err_by_mask": {m: e[f"h3{n}"] for m, e in h3_err.items()},
           "none": t["h3_none"][f"h3{n}"],
           "window_train_shape": {
               m: t["window_train_shape"][m][f"h3{n}"]
               for m in ("window", "causal")},
           "seq2seq": s2s,
           "delta_ms": {m: t[f"h3_{m}"]["delta_ms"]
                        for m in ("causal", "none")},
           "pair_ms": {m: t[f"h3_{m}"]["pair_ms"]
                       for m in ("causal", "none")},
           "by_dtype": {"f32": f32_train_readings(f32t, f"h3{n}")}}
          for n, what in (("dkv", "dK and dV"), ("dq", "dQ"))),
        # the quant and dtiled phases: each call of the phase is one
        # launch; the numbers are those of the canonical int8 (H4-kvq),
        # pv_mode bf16 (H4-int8) and bf16 d=512 (H5) calls, and library_ms
        # of the quantized calls is SDPA over the dequantized bf16 tensors
        # by_head_dim: the quant phase's head-dim cases (quant_head_dims;
        # flash_attention_kvquant's past 256 ran on H5) and its times at
        # d 80 and 256
        # odd_head_dims: the quant_odd phase's cases at d off the
        # multiples of 16 (the PACKED / STAGED instances) and its times
        {"name": "H4-kvq attention over int8 / e4m3 K and V (d from 1 to "
                 "256; H5's quantized form past it)",
         "route": "cuda", "source": H4KVQ_SRC, "replaces": f"{KVQ_PY}:47",
         "also_replaces": f"{KVQ_PY}:114", "launches": kvq["launches"],
         "max_abs_err": kvq["err"], **kvq["t"]["int8"], "design": "wgmma",
         "bound_share": (kvq["t"]["int8"]["bound_ms"]
                         / kvq["t"]["int8"]["ms"]),
         "fp8": kvq["t"]["fp8"], "by_head_dim": kvq["by_head_dim"],
         "odd_head_dims": {"checks": qodd["h4kvq"], "times": {
             n: r["h4kvq"] for n, r in qodd["times"].items()}},
         "gates": {n: x for n, x in quant_gates.items()
                   if n.startswith("kvquant")}},
        {"name": "H4-int8 attention, int8 Q, K and V (pv_mode bf16 / int8; "
                 "d from 1 to 256)",
         "route": "cuda", "source": H4INT8_SRC, "replaces": f"{INT8_PY}:50",
         "launches": int8["launches"], "max_abs_err": int8["err"],
         **int8["t"]["canonical bf16"], "design": "wgmma",
         "bound_share": (int8["t"]["canonical bf16"]["bound_ms"]
                         / int8["t"]["canonical bf16"]["ms"]),
         "by_case": {n: x for n, x in int8["t"].items()
                     if n != "canonical bf16"},
         "by_head_dim": int8["by_head_dim"],
         "odd_head_dims": {"checks": qodd["h4int8"], "times": {
             f"SigLIP-so400m {m}": qodd["times"]["SigLIP-so400m"][
                 f"h4int8 {m}"] for m in ("bf16", "int8")}},
         "gates": {n: x for n, x in quant_gates.items()
                   if n.startswith("int8")}},
        {"name": "H5 d-tiled attention forward (bf16, int8, e4m3 K/V; d "
                 "from 1 to 2048, clusters past 512)",
         "route": "cuda", "source": H5_SRC, "replaces": f"{DTILED_PY}:75",
         "launches": h5["launches"], "max_abs_err": h5["err"],
         **h5["t"]["d=512 bf16"], "design": "wgmma",
         "bound_share": (h5["t"]["d=512 bf16"]["bound_ms"]
                         / h5["t"]["d=512 bf16"]["ms"]),
         "by_case": {n: x for n, x in h5["t"].items() if n != "d=512 bf16"},
         "clusters_active": h5_occupancy, "gates": dtiled_gates,
         "odd_head_dims": {"checks": qodd["h5"], "times": {
             f"SigLIP-so400m {n}": qodd["times"]["SigLIP-so400m"][n]
             for n in ("h5", "h1")}}},
        # the f32_ops phase: the f32 forms, each call one launch; the
        # numbers of the canonical int8 (H4-kvq) and dense d=512 (H5)
        # calls, library_ms SDPA at f32 (over the dequantized K/V for
        # H4-kvq), max_abs_err the largest over the phase's cases
        f32_ops_entry(f32ops, "h4kvq", "H4-kvq f32 q over int8 / e4m3 K "
                      "and V (bf16x3 on wgmma)", H4KVQ_SRC, f"{KVQ_PY}:47",
                      f"{KVQ_PY}:114"),
        f32_ops_entry(f32ops, "h5", "H5 d-tiled forward at f32 (f32 or "
                      "int8 / e4m3 K/V; bf16x6 / bf16x3 on wgmma, Q streamed "
                      "by d-chunk)", H5_SRC, f"{DTILED_PY}:75", None),
    ]}))
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s, the build "
          f"included")
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main(sys.argv[1:]))
    except Exception:                       # report the failure, exit non-zero
        traceback.print_exc()
        print("chip_smoke FAILED", file=sys.stderr)
        sys.exit(1)

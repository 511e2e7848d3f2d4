#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (paddle_tpu_torch) on one
NVIDIA GPU.

    python3 chip_smoke.py [--out DIR] [--seed N] [--phases LIST]

``--phases 17,17b,17c`` runs those phases alone (with the phases they
take results from, ``PHASES``: 4c, 5, 12e and 4b need 4, 6b, 6e and 6g
need 6, 6f needs 6b, 8c needs 8, 10c needs 10, 12b-12d and 14b need 12,
13checkpoint needs 13; 18 reads 6, 6b, 8 and 10's step times where they
ran; 1 and 2 always run); the result line then holds
the rows and launch counts of the phases that ran and names the ones
left out. With no ``--phases`` every phase runs.

Phases, each of which passes or ends the script with a non-zero exit:

1. the card: nvidia-smi's name and power limit, the torch version, TF32
   switched off for f32 products;
2. build: every CUDA source of the port compiled with nvcc for sm_90a,
   in parallel; ptxas' registers and spills per kernel, and no spill in
   any instantiation of K4 (its AMP one included), K5, K6 or K7;
3. kernels: the CTAs per SM the card grants the flash forward kernel
   (per dtype, head dim and bias kind); then the kernel against its
   plain PyTorch version on the card, at the main path's shapes and a
   few edge shapes (at bf16 also against the plain version run at
   bf16), two launches on the same inputs bitwise equal, with its device
   time and call time, the plain version's, one PyTorch library call's
   (``scaled_dot_product_attention``, a yardstick the port never calls;
   call and device time; on a causal case ``is_causal`` alone: sdpa
   takes no pad bias beside it) and the least time the card could take
   (the bound); the cases include GPT-2 small's causal [8, 12, 1024, 64]
   with a trailing key-pad bias, f32 and bf16;
3b. backward kernels: the CTAs per SM the card grants the flash dK/dV
   and dQ kernels (per dtype, head dim and bias kind); then both kernels
   against their plain versions on the phase-3 cases (a trainable-bias
   score grad on the causal and the ragged cases), two launches on the
   same inputs bitwise equal, with each kernel's device time and call
   time, the plain versions', and per case the backward as a whole
   (dK/dV + dQ) beside the backward of one
   ``scaled_dot_product_attention`` call (a yardstick the port never
   calls) and the bound of the 10 units of work a backward needs;
3c. tier kernels: the fused residual + layer norm forward (K4) and
   backward (K5, launched through autograd on the fused function, its
   one path) at [4096, 768], [512, 768], a ragged [1000, 1000] and a
   wide [2048, 4096] (the kernels for rows over 2048 columns), f32 and
   bf16; the grouped Adam (K6) and SGD (K7) updates over BERT-base's
   157 param shapes and an odd-sized edge list; each against its plain
   version, two launches bitwise equal (K5, K6, K7), the entries K6 and
   K7 stream at 16 bytes, with its device time and call time, the plain
   version's, one library call's device time and call time
   (``torch.add`` + ``F.layer_norm``, ``native_layer_norm_backward``,
   ``torch._fused_adam_``, ``torch._foreach_add_``: yardsticks the port
   never calls) and the bound; then AMP's dtypes: K4's AMP instantiation
   at [4096, 768] on bf16 x with bf16 r (BERT's path) and with f32 r
   (rounded in registers), s bitwise and y / mean / var within 1e-5 of
   its plain version, two launches bitwise equal, against ``torch.add``
   at bf16 then ``F.layer_norm`` of the f32 sum; K6 and K7 on an AMP
   step's grads (bf16 but the layer norms'), against the plain version,
   two launches bitwise equal, and bitwise equal to the launch on the
   grads widened to f32, against widening then ``_fused_adam_`` /
   ``_foreach_add_``;
3d. tune: the port's tuner measures its one op, the flash kernel against
   the composed attention, at S = 512 and 128 on the card with CUDA
   events, and prints each time and its pick; the winners are dropped
   afterwards, so the paths below take flash by the static threshold
   (the tier's fused ops launch their kernels on the card whatever the
   tuned table holds);
4. serve: BERT-base (12 layers, d_model 768, S = 512, random weights
   from a seed) built with the port's layers, started on the card,
   saved with ``save_inference_model`` and served by the inference
   Predictor (warmup buckets 1, 4, 8) for requests of batch 1, 3 and 8,
   each answered 10 times (the same answer every time). The Executor
   runs the level-2 optimized program: 25 ``fused_layernorm_residual``
   ops (the pass's stats). Every dispatch launches the flash kernel 12
   times and K4 25 times (counted on the card, as for every main path
   below: see the launch meter); the answers are finite, of shape
   [B, 512, 768], and agree with the composed attention path and with
   level 0 (no pass pipeline) on the card; each request is then timed
   at level 2 and at level 0 in turns;
4c. compiled serving (after phase 4, and after 4b under AMP): the
   Predictor captured each warm-up bucket's plan as a CUDA graph at
   load, and every request above was a replay; now each request of
   batch 1, 3 and 8 is replayed against the plan's eager step in turns
   (10 pairs): the latency of each, the busy share and device time of
   one profiled request of each, answers bitwise equal, the launches the
   card runs in a replay equal to an eager step's (launch meter),
   each graph's capture seconds and the graphs' one memory pool;
4b. serve AMP (after phase 5's profile): the same program with bf16 AMP
   on (``Program.set_amp``), saved and served by the Predictor for the
   same requests: every dispatch launches the bf16 flash kernel 12
   times and K4's AMP instantiation 25 times (counted, no other flash or
   K4 launch); the f32 answers of the encoder (12 bf16 layers) against
   phase 4's f32 Predictor within 5e-2 in l2; latency and one profiled
   request per batch size;
5. profile: one more request per batch size under torch.profiler, for
   the device's busy share and its time by kernel (after the main path's
   counts are read);
6. train: BERT-base masked-LM (S = 512, 80 masked slots, batch 8,
   dropout 0.1, f32) built with the port's layers, ``Adam.minimize``,
   startup on the card, 2 warm-up and 6 timed steps on fixed synthetic
   batches, at level 2: 25 ``fused_layernorm_residual`` ops and one
   ``fused_optimizer_update`` over the 157 params. Every step launches
   the flash forward kernel 24 times, each flash backward kernel 12
   times, K4 25 times and K6 once (counted); losses are finite; one step
   run twice from the same scope gives bitwise the same loss and
   params; from the same scope and RNG state, the flash and the composed
   attention path, and level 2 with the tier's kernels and level 0,
   agree on the first step's param grads and on the losses and params
   of 3 steps within the stated tolerances; from the second step on,
   every entry of the Adam group takes K6's 16-byte path (counted); the
   step time (4 pairs) and the host's time by op class (one pair) at
   level 2 and at level 0, in turns; one more step is
   profiled, with K4's and K6's device time in it;
6b. train AMP: the same model and batches with ``Adam`` wrapped in
   ``contrib.mixed_precision.decorate`` (bf16 AMP), level 2: every step
   launches the bf16 flash kernels (24, 12, 12), K4's AMP instantiation
   25 times, K6 once on the step's grads (103 bf16 and 54 f32, counted)
   and no f32 flash kernel; params and moments stay f32; losses finite;
   level 2 against level 0 from one scope within the AMP tolerances
   (``AMP_PARITY_*``); the first loss against phase 6's; the step time,
   tokens/s, peak memory and one profiled step beside phase 6's;
6c. compiled training (after phase 6, and after 6b under AMP): from
   phase 6's (6b's) snapshot, steps replayed from the plan's CUDA graph
   (the first one captures it anew, on its own scope) against the
   plan's eager step on a second scope, in turns (4 pairs after that
   first pair): every loss and the final params bitwise equal, the step
   medians and tokens/s, the busy share of a profiled replayed and eager
   step, the launches the card runs in each (equal; launch meter), the capture
   seconds, the device time of the state copy a replay still makes (the
   beta powers: params and moments are updated in place by K6), peak
   memory of a replayed and an eager step and the executor's graph pool;
6d. plans sharing a pool (after 6c, f32): three training plans of one
   new executor (two fetch lists, and half the batch) in turns on one
   scope for PLAN_ROUNDS rounds, each run bitwise equal to its eager
   step, no state copied in on switching, the three graphs' one pool
   against 6c's, a round's peak memory and the replayed steps' times;
6e. the step loop (after 6d, f32): BERT-base under BERT pre-training's
   learning-rate schedule (a linear warm-up around a polynomial decay
   to 0, the rate computed inside the graph each step) from phase 6's
   snapshot, trained by ``Executor.train_loop`` over a reader of host
   numpy batches (a fresh copy each step) at K = 1 and K = 4 steps per
   call, max_in_flight 2 and prefetch depth 2: losses, rates and params
   bitwise those of ``run`` in a loop over the same batches (10 steps;
   at K = 4 two windows and a ragged tail of 2), the launches the card
   ran (24 / 12 / 12 / 25 / 1 a step), the rate of every step against
   its closed form; then the steady-state step time, tokens/s and busy
   share of the run loop, K = 1 and K = 4 on the device clock (between
   the K6 launches ending the 2nd and the 8th step of a profiled window
   of each), their times on the host clock over blocks of 4 steps in
   turns, ``paddle_pipeline_overlap_ratio``, peak memory, and
   the split of the host's work between two replays of ``run`` (feed
   conversion and copies, re-seeding the generators, ``state_changes``,
   the fetches' copy, the rest);
6f. the same under bf16 AMP, from phase 6b's snapshot (the schedule's
   scale and min ops run bf16, the JAX package's policy, so the rate is
   held against its closed form at 2e-2);
6g. recompute: BERT-base with ``RecomputeOptimizer`` (Adam, a checkpoint
   per encoder layer) from phase 6's snapshot, 3 steps replayed (the
   first eager, the second captures) against the plan's eager step on a
   second scope, bitwise, with the launches each step ran on the card
   (the flash kernels as in phase 6: each segment's forward runs again
   in its grad; no K4, since level 2 fuses nothing inside a segment);
   losses and params against phase 6's main path within its parity
   tolerances; peak memory of an eager and a replayed step beside
   phase 6c's;
7. train with SGD: the same model with ``SGD.minimize``, 3 steps at
   level 2 (K4 25 times and K7 once per step, counted), losses finite,
   and 3 steps at level 0 from the same scope within phase 6's bounds;
7b. train SGD AMP: 3 steps under AMP at level 2, each launching K7
   once on the bf16 grads, the bf16 flash kernels and K4's AMP
   instantiation (counted); losses finite, params f32;
8. train GPT: GPT-2 small (``gpt.base_config()``: 12 layers, d_model
   768, vocab 50304, 163,072,512 weights) built with ``gpt.build`` at
   S = 1024, batch 8, random ids with 0-10% trailing padding, Adam at
   level 2, f32: every step launches the causal flash forward 24 times
   (the pad row rides as a bias), dK/dV and dQ 12 times each, K4 24
   times and K6 once (counted), and no composed attention runs; then
   6c's replayed steps against eager ones in turns (bitwise; medians,
   tokens/s, busy share, peak memory, capture seconds), level 2 against
   level 0 over 3 steps (phase 6's grad and loss bounds; each param by
   its share of elements past 1e-4 and its update's l2 difference), and
   ``train_loop`` at K = 1 over 6 steps bitwise the run loop;
8c. generate (after 8, on its weights): ``gpt.generate`` with a
   ``build_prefill_step`` program (prompt 128) and a
   ``build_decode_step`` program (a KV cache of 1024 rows), greedy, 32
   new tokens, at batch 1 and 8, three calls each on one executor: every
   step after each plan's first two is a replay, K4 runs 24 times a
   dispatch (counted), both graphs hold the scope's caches and write
   them in place; the tokens equal an executor's that never replays,
   and the logits at every position match the training graph's is_test
   forward within 1e-3; the prefill and per-token latencies;
8b. train GPT AMP: phase 8 under bf16 AMP (the bf16 flash kernels and
   K4's AMP instantiation, the same counts, no f32 flash kernel; level
   0 within the AMP bounds);
9. train the transformer: ``transformer.base_config()`` at S = 256,
   batch 8, label smoothing 0.1, Adam, level 2, f32: each step launches
   the flash forward 36 times (encoder self, causal decoder self and
   cross attention, and their grads' recomputes), dK/dV and dQ 18 times,
   K4 30 times and K6 once (counted); 3 replayed steps bitwise their
   eager steps; level 2 against level 0 over 3 steps within phase 8's
   bounds. Phases 3 and 3c hold its attention and layer-norm shapes
   against the plain versions;
10. train ResNet-50: first a probe of whether a conv step repeats
   bitwise (ResNet-50's stem and a 3x3 conv at batch 32, the forward and
   both grads three times under PyTorch's default cuDNN flags and under
   the port's deterministic ones, with their times); then
   ``resnet.build(class_dim=1000, depth=50)`` at 224 x 224, batch 32,
   Adam, level 2, f32: each step launches K6 once and no other kernel of
   the port (the convolutions are cuDNN's, the batch norms composed),
   counted; 6c's replayed steps against eager ones, bitwise, the batch
   norms' 106 running stats included (images/s, busy share with the
   device time class "conv", capture seconds, peak memory); level 2
   against level 0 over 3 steps within phase 8's gates;
10c. serve ResNet-50: the inference program saved with phase 10's
   weights and running stats and served by the Predictor (batch norm in
   test mode, buckets 1 and 8, every request a replay), the answers the
   training program's is_test forward's; latency medians and max;
10b. phase 10 under bf16 AMP (AMP's bounds for level 0);
11. train ViT-B/16: ``vit.base_config()`` (S = 197, 86.5M weights,
   dropout 0.1) at batch 32, Adam, level 2, f32: as configured (the
   static threshold composes attention at S = 197) each step launches
   K4 24 times and K6 once; the same steps with
   PADDLE_TPU_FLASH_MIN_SEQ=0 for that run alone launch K1 24, K2 and
   K3 12 times besides (counted), and the two runs' replays are timed
   in turns; replays bitwise eager; the flash run against the composed
   one within phase 6's loss and grad bounds, level 2 against level 0
   within phase 8's gates; phases 3, 3b and 3c hold ViT's attention
   [32, 12, 197, 64] and layer-norm rows [6304, 768] against the plain
   versions;
11b. phase 11 under bf16 AMP (AMP's bounds);
12e. the batcher (after phase 5, on phase 4's Predictor): a
   ``MicroBatcher`` (max_rows 8) takes 64 requests of 1-3 rows from 4
   threads; every answer against its rows run alone within 1e-4; each
   dispatch runs K1 12 and K4 25 times on the card; rows a dispatch and
   latency;
12. serve GPT-2 small through ``serving.DecodeEngine`` (b_max 8, a cache
   of 1024 rows, f32, random weights from the seed): 48 requests
   submitted at once (prompts of 64-512 tokens, 16-128 new tokens, half
   greedy, half sampled at temperature 0.8, top_k 40), after two
   warm-up requests of each prompt length; every request's tokens equal
   ``gpt.generate``'s for it alone at batch 1 (the same requests one
   after another, also the sequential baseline); K4 counted on the
   card, 24 a prefill and 25 a decode step; tokens/s, time to first
   token, time between tokens, slot occupancy, captures, the byte
   model's prediction against the peak, one decode step profiled;
12b. prefix reuse: 16 requests sharing a 384-token system prompt with
   their own suffixes, twice, through an engine with a prefix store and
   one without: tokens bitwise equal, the store's 31 hits and 1 miss,
   time to first token of each;
12c. speculative decoding, k = 4, 16 greedy requests, with the target
   as its own draft and with a 2-layer draft of random weights: tokens
   bitwise the plain engine's, accepted drafts and tokens a dispatch;
   a verify dispatch's logits bitwise 5 single decode steps (its
   products per position, ops/math.py's ``slot_rows``), and what that
   costs (the verify step's graph with and without it, replayed in
   turns); slot 0's logits at b_max 8 against batch 1, and the decode
   step's ops whose slot-0 output depends on the batch;
12d. ``ReplicaRouter`` over two GPT-2 small replicas: 32 requests from
   two tenants, one capped at 4 in flight; replica 0's scheduler stopped
   by a fault injected at its third decode dispatch: its requests
   readmitted, the replica rebuilt, every admitted request ended once
   with ``generate``'s tokens;
13. BERT-base MLM (S = 512, batch 8, dropout 0.1) with ``Lamb`` (the
   BERT recipe's beta1 0.9, beta2 0.999, epsilon 1e-6, weight decay
   0.01; lr 1e-4), level 2, f32: K1 24, K2 12, K3 12 and K4 25 a step,
   no K6 (the 157 lamb ops run unfused); replays bitwise eager in turns,
   level 2 against level 0 within phase 8's gates, ``train_loop`` at
   K = 1 bitwise the run loop; step time, busy share, kernels, device
   time by class and the 157 lamb updates' device time alone; then the
   checkpoint: ``train_loop`` 10 steps uninterrupted, and on a second
   scope 5 steps, ``save_persistables_async`` with the RNG chain while
   the loop goes on, a fresh executor and scope restored from the file
   running steps 6-10 bitwise the uninterrupted run (losses and every
   persistable), the async file equal to ``save_persistables`` of the
   same state, ``save_params`` / ``load_params`` round-tripping; the
   caller's blocked ms, the write's seconds and the bytes;
13b. phase 13 under bf16 AMP (AMP's bounds, no checkpoint);
13c. BERT-base f32 at depth 4 (batch 2) with ``LarsMomentum``,
   ``Adamax``, ``Adagrad``, ``DecayedAdagrad``, ``Adadelta``, ``RMSProp``
   (centered), ``Ftrl`` and ``ModelAverage`` over Adam: 3 steps each (eager,
   capture, replay) bitwise the plan's eager steps, the launches of
   each step counted, and after every step the state each optimize op
   wrote against the same lowerings run on the CPU from the state before
   it and the step's grads (2e-6 relative, 1e-5 for LARS' norms, K6 at
   2e-6); ModelAverage's ``apply()`` averages exact and ``restore()``
   bitwise.
14b. the fleet from an artifact (after 12d): GPT-2 small's weights saved
   as a serving-only artifact (v1; v2 a copy of its file at another
   path); ``ReplicaRouter`` over two replicas built by
   ``DecodeEngine.from_artifact`` from v1; phase 12's 48 requests
   submitted at once and the fleet rolled to v2 (``roll``, the default
   factory) under them: every request ends exactly once with
   ``generate``'s tokens, both replicas end on v2, one roll counted;
   tokens/s through the roll and the seconds a replica swap;
14. a deployable artifact (after 13c): BERT-base's serving program at
   depth 4 of its 12 layers (S = 512, f32, level 2) frozen by
   ``export.save_artifact`` with AOT buckets 1, 4 and 8 (``torch.export``,
   K1 and K4 as operators) and saved as an inference model;
   ``load_artifact`` + ``LoadedArtifact.predictor()`` serve 10 requests
   per bucket through
   the AOT section (a bucket's first request runs its program, captures
   it as a CUDA graph and replays it; the rest replay): the load and
   the requests move no plan-cache miss, pipeline run or tuner miss,
   3 plans seeded and 30 AOT calls counted, nothing degraded; K1 4 and
   K4 9 a request on the card; the answers bitwise the seeded plan
   path's and a Predictor's from ``create_predictor_from_dir``; the
   artifact's bytes, save and load seconds, first and steady latency of
   the three paths, the AOT capture seconds;
15. dygraph at BERT-base width (after 14): an encoder written against
   ``imperative`` (embeddings, 12 post-norm layers of FCs,
   ``fused_attention`` with a key-pad bias and dropout 0.1, gelu, the
   MLM loss over 80 masked positions a row; S = 512, batch 8) trained
   by ``imperative.optimizer.Adam``: 3 eager steps, then the same 3
   from the same state through ``imperative.jit`` with
   ``exact_numerics=True`` (bitwise the eager steps: losses, params and
   the generator chain) and ``exact_numerics=False`` (level 2 and the
   CUDA graph: K4 25 and K6 once a step; within the flip-parity gates
   of the exact capture); K1-K3 24 / 12 / 12 a step on the card in
   every run; an inference capture's ``as_predictor()`` bitwise the
   eager forward; step times, the graph's capture seconds and a
   profiled replayed step;
16. seq2seq decoding served (after 15): ``machine_translation``'s
   encoder at its config (vocab 10000, embedding 256, hidden 512, a
   bidirectional ``dynamic_gru``, T = 50, lengths 20-50) and a
   ``StateCell`` over ``layers.gru_unit`` at 512, decoded by
   ``BeamSearchDecoder`` (beam 4, 50 steps), saved with
   ``save_inference_model`` and served by the Predictor at buckets 1 and
   16 (each captured at load), 10 requests a bucket: the answers the
   same every time, bitwise the eager step and level 0's ids; replayed
   and eager requests in turns, the busy share and kernels of a
   request;
16b. ``stacked_lstm`` trained at its config (vocab 5000, embedding 128,
   hidden 128, 3 layers, T = 80), batch 64, lengths 16-80, Adam: 3
   steps (eager, capture) then 10 replayed on the main path, K6 once a
   step on the card; replayed steps bitwise eager in turns; step ms,
   busy share, device ms by class, capture seconds, peak memory;
16c. ``machine_translation`` trained at its config, batch 32, Adam: the
   readings of 16b, and ``train_loop`` at K = 1 bitwise the run loop,
   with steady steps timed through each;
16d. control flow on the card at width 512: a ``While`` over a count
   fed as data runs uncaptured, counted in
   ``paddle_executor_uncaptured_plans_total``, with the right sums; a
   training step holding ``cond`` / ``Switch`` / ``IfElse`` and
   StaticRNN / DynamicRNN steps with dropout, each captured and its
   replays bitwise its eager steps; ``beam_search``'s ties on the card
   the CPU's;
17. the Fluid book (tests/test_book.py's seven trainings at its sizes,
   built by tools/book_programs.py): each started on the card, its
   whole training replayed at level 2 with K6 (Adam) or K7
   (fit_a_line's SGD) once a step on the card, the chapter's end
   assertion met (fit_a_line's missed as in the JAX package, its 60
   losses the CPU's), the first 3 losses the port's on the CPU from the
   same startup, replays bitwise eager; then six chapters' networks at
   their widths (``book_programs.CHAPTER``; label_semantic_roles' is
   17b), each trained on the card as 16b trains (K6 or K7 once a step,
   replays bitwise eager), its first 3 losses the CPU's: the replayed
   and eager ms a step, kernels, busy share and peak memory;
17b. label_semantic_roles' ``db_lstm`` at the chapter's widths (hidden
   512, 8 stacked LSTMs, CRF), batch 32 at T = 24, Adam: trains as 16b
   trains (K6 once a step, replays bitwise eager), its first 3 losses
   and its CRF transition after them the CPU's, and decodes; replayed
   and eager ms, kernels, busy share, peak memory;
17c. the 64 op types of the op tail and the loss ops on the card
   against the CPU (forward, and grads where differentiable; the
   random ops by their properties), ``scatter`` over repeated ids
   repeatable, a ``linspace`` plan uncaptured and counted, and CRF and
   CTC training plans captured, replays bitwise eager;
18. the roofline cost model (analysis/cost.py) on the card: the device
   model (the H100's datasheet peaks by dtype, the per-op and per-call
   overheads probed through the port's executor; never ``default``);
   the JAX package's zoo gate: the eleven zoo train programs
   (tools/torch_cost_report.py) at batch 8 priced, the predicted step
   within 4x of the measured replayed step on at least 9 of 11, every
   ratio printed; predicted against measured at full width for BERT-base
   MLM (f32, AMP), GPT-2 small and ResNet-50 (phases 6, 6b, 8 and 10's
   replayed medians, or measured here when those phases did not run);
18b. the unified autotuner (kernels/autotune.py) on BERT-base training
   (phase 6's program), window candidates 1, 2, 4, 8: measured
   exhaustively (``PADDLE_TPU_COST_MODEL=0``), then pruned by the
   roofline; each search's timings, what was pruned with its
   prediction, the winners and whether the pruned search kept the
   exhaustive one; the kernel axis's K1 launches (flash against
   composed at (512, 512)); then ``train_loop`` at the tuned window
   (``resolve_steps_per_call``), bitwise the same steps run one at a
   time;
18c. ``imperative.jit(autotune=True)`` on phase 15's encoder: captured,
   tuned in a scratch scope, replayed bitwise an untuned capture's
   replays (the flash threshold pinned for both);
18d. int8: BERT-base served by the Predictor with
   ``PADDLE_TPU_OPTIMIZE_QUANT=1`` at batch 1 and 8 within
   ``QUANT_TOLERANCE`` of the f32 Predictor, both latencies in turns
   beside ``quantize_outlook``'s predicted speedup; BERT-base MLM
   through ``QuantizeTranspiler.training_transpile``: 5 replayed steps
   with the fake-quant ops' state updated on the card, bitwise eager
   steps, the first loss within ``QUANT_TOLERANCE`` of the plain
   program's;
18e. the 37 op types of this slice (misc_ops' other 31, the six
   quantization ops) on the card against their CPU lowerings, grads
   included; the random ones twice bitwise from one seed;
19. SSD300 (tools/ssd_programs.py: VGG-16 base, 300 x 300, 21 classes,
   8732 priors), f32, level 2, batch 8: its first loss within 1e-4 of
   the port's forward on the CPU; 6 Adam steps on the main path (K6
   once a step on the card), replayed against eager in turns bitwise,
   with ms, kernels, busy share, device ms by class, capture s and
   peak; no plan left uncaptured; then saved per bucket (1 and 8) with
   ``io.save_inference_model`` and served by the Predictor, 10 replayed
   requests each, the [B, 200, 6] detections bitwise the Predictor's
   eager run and the CPU's (classes exactly, 1e-4; rows of scores
   within 1e-5 may change places, and the phase counts them);
19b. the 19 detection op types on the card against their CPU
   lowerings (the gathers, IoU, NMS and matchings bitwise), the four
   grads twice bitwise on the card; the two samplers by their
   properties and twice bitwise from one seed; ``multiclass_nms`` over
   ties at SSD300's shape bitwise the CPU's, and its kernels and device
   ms a call there;
20. the book's recognize_digits (models/mnist.py ``build("cnn")``, 20
   and 50 filters, batch 64, Adam) fed the Fluid way: ``dataset.mnist``
   -> ``batch`` -> ``layers.PyReader`` (DataFeeder, capacity 8) to the
   card, 128 ``exe.run`` steps (K6 once a step, the plan replayed),
   bitwise the same batches fed as DataFeeder dicts and through
   ``train_loop``; ``contrib.Trainer`` from the same seed bitwise, its
   test accuracy and ``Inferencer.infer``'s on its saved params above
   0.95; step ms of the three feeding paths in turns, the consumer's
   wait, the busy share, the card memory the queue holds;
20b. ``AsyncExecutor`` over 8 MultiSlot files of 4096 lines (a proto-text
   ``DataFeedDesc``) training DeepFM at models/ctr.py's full width
   (vocab 1,000,001, embedding 16, hidden 400-400) at batch 1024: one
   reader thread bitwise a numpy loop over the same batches (K6 once a
   step), four threads the same multiset of batches; rows/s at 1 and 4
   threads, the reader's alone, a busy share;
20c. the int8 ``Calibrator`` on ResNet-50's inference program at 224:
   the card's ``max`` and KL scales against the CPU lowering's on one
   shared batch of 2 (1e-5 relative, one histogram bin); KL and max
   over 4 batches of 8, KL's ``save_int8_model`` served by the
   Predictor at batch 1 and 8 within QUANT_TOLERANCE of f32 and, at
   batch 1, within 8 quantization steps of the same saved program on
   the CPU, every op of that program on the card held to the CPU's at
   the CPU's inputs (1e-4 of a float output's abs max; fake-quant
   outputs one-level flips in at most 1e-4 of their elements), two
   planted faults of 1e-3 refused; calibration seconds, the rounding
   control's and a planted fault's gaps, int8 and f32 latency in turns.
21. the mesh tier, data and tensor parallel: BERT-base MLM at its
   widths (768, 12 heads, S = 512, batch 8) cut to 4 layers, Adam, f32,
   level 2, 4 steps each of ``Executor.run`` (the reference),
   ``CompiledProgram(main).with_data_parallel`` over (data 4) positions
   on the card, and a ``ParallelEngine`` over (data 2, model 2) with
   megatron FFN rules and ZeRO-1, from one startup scope: losses within
   1e-5 relative and params within 1e-4 of the reference's (the log
   says where bitwise), the rules' placement and a shard's view; K1/K2/
   K3 8/4/4, K4 9 and K6 1 a step, counted; replayed step ms. Then
   ``contrib.Trainer(parallel=True)`` on recognize_digits for 8 steps
   against ``parallel=False``;
21b. sequence parallel: GPT-2 small at its widths (S = 1024, batch 8)
   cut to 4 layers on a (seq 4) mesh, every causal ``fused_attention``
   on the zigzag ring (one K1 launch a ring step for every position's
   chunk pairs: K1 40, K2 and K3 20 a step, against 8, 4, 4 without a
   mesh; no composed attention), 3 steps against the no-mesh run
   within 2e-4 relative + 2e-5, the first step's grads within 4 times
   the gap between two sound runs without a mesh (flash kernels,
   composed attention); a packed batch with segment ids the same way;
   the plan's ``ring_ppermute`` collectives;
21c. experts: a Switch-style stack (GPT-2 small's widths, 4 layers,
   ``layers.moe_ffn`` with 8 experts of d_ff 3072, capacity factor 1.25,
   in every other layer), top-1 and top-2, 3 steps on an (expert 8)
   mesh against the run without a mesh: routing bitwise, the MoE
   output, aux and losses within 1e-6, the output within 1e-6 of the
   every-expert formula;
21d. pipeline: ``layers.pipeline`` of 4 GPT-width MLP stages (768 ->
   3072 -> 768, residual), batch 32 of 256 positions, 8 microbatches,
   3 Adam steps on (pipe 4) and (data 2, pipe 4) against the sequential
   fallback (losses within 1e-5, the first step's grads within 4 times
   the gap between plain torch's f32 and f64 grads); with dropout both
   meshes bitwise the fallback.
   ``--phases 21,21b,21c,21d`` runs the four alone.

From its second run on, every plan of a Program that ``Executor.run``
runs on the card is a replay of its CUDA graph (paddle_tpu_torch/core/
cuda_graph.py). A replay calls no kernel wrapper: the card runs the
graph's kernels. So the launch meter (``LaunchMeter``) counts every
main path's launches on the card: each kernel counts its own launches
on the device (paddle_tpu_torch/csrc/launch_count.cuh), read before
and after each step or request. Every step and every dispatch must run
the expected launches on the
card, and the wrappers' own counters, zeroed just before the path,
must show the launch calls of the eager first run and of the capture
and none from a replay. The ``launches`` of the result line are the
meter's. What a replayed K6 / K7 streams at 16 bytes or takes as bf16
grads is read from the table the plan keeps on the card. A snapshot of
a scope is a copy, since a replay updates the scope's state tensors in
place; the host's time by op class (phase 6) is the eager step's,
since a replay runs no lowering.

It prints one JSON line of kernel results, then, as the last line,
``{"ok": true, "device": {...}}``. With ``--out DIR`` it also writes
every measurement to ``DIR/chip_smoke.json``. It exits non-zero without
a result when no CUDA device is visible.
"""

import argparse
import gc
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

SEED = 1234
SEQ = 512
BUCKETS = [1, 4, 8]
REQUESTS = [1, 3, 8]
REPEATS = 10  # each request is answered this many times (latency samples)
SERVE_ATOL = 1e-3  # flash vs composed attention through 12 f32 layers
# backward kernels vs their plain versions: the JAX package's stated
# backward tolerance at f32 (docs/KERNELS.md), 2e-2 at bf16
BWD_TOL = {torch.float32: 5e-5, torch.bfloat16: 2e-2}
# training (phase 6)
TRAIN_BATCH = 8
MAX_MASK = 80          # BERT phase-2 max_predictions_per_seq
TRAIN_LR = 1e-4
WARMUP_STEPS, TIMED_STEPS, PARITY_STEPS = 2, 6, 3
# training steps at level 2 and at level 0, in turns: for the step time,
# and for the host's time by op class (a timer around every op)
TURN_PAIRS, HOST_PAIRS = 4, 1
# replayed against eager, in turns: requests per batch size (phase 4c)
# and steps after the first pair (phase 6c)
COMPILED_PAIRS, TRAIN_COMPILED_PAIRS = 10, 4
# three training plans of one executor in turns (phase 6d): rounds (the
# first runs each eagerly, the second captures each)
PLAN_ROUNDS = 3
# the step loop (phases 6e / 6f): steps held bitwise against the run loop
# (at K = 4 two windows and a ragged tail of 2), steps a block in the
# timed turns, steps in a profiled window (two windows of 4 at K = 4),
# replays the host's work is split over
LOOP_STEPS, LOOP_TIMED, PROFILED_STEPS, HOST_GAP_REPLAYS = 10, 4, 8, 10
# BERT pre-training's schedule, in the step counter's units (a warm-up
# around a decay advances the counter twice a step, ``_scheduled_rate``):
# linear warm-up to TRAIN_LR over SCHED_WARMUP, then a linear decay to 0
# at SCHED_DECAY. The rate against its closed form: f32 ops at a relative
# 1e-6; under AMP the schedule's scale and min ops run bf16 (the JAX
# package's policy tables), each rounding to 8 bits, so 2e-2
SCHED_WARMUP, SCHED_DECAY = 6, 60
SCHED_RTOL = {False: 1e-6, True: 2e-2}
# recompute (phase 6g): steps (the first eager, the second captures), as
# many as phase 6's parity steps it is held against
RECOMPUTE_STEPS = 3
# flash vs composed training from one scope. The first step's param
# grads: the l2 norm of each one's difference within PARITY_GRAD_L2 of
# its own l2 norm. The two forwards differ by rounding, and where that
# flips a relu pre-activation near 0 the grads of that FFN (and, less,
# of every layer below it) differ by more than rounding; a wrong dQ, dK
# or dV is off by far more on every param below the attention.
# Params after PARITY_STEPS Adam steps: Adam moves a param by about lr
# per step whatever its grad's size, so wrong grads can move params by
# no more than about 2 * lr * steps (6e-4); 1e-4 sits between that and
# the 6.6e-6 measured (PERF.md). The losses at a relative 1e-3.
PARITY_GRAD_L2 = 1e-2
PARITY_PARAM_ATOL = 1e-4
PARITY_LOSS_RTOL = 1e-3
# GPT-2 small's and the transformer's level 2 against level 0 (phases 8
# and 9, f32): the same grad and loss bounds, but some param elements
# pass PARITY_PARAM_ATOL. Their steps train through relu FFNs, and a
# rounding that flips a relu pre-activation near 0 moves its unit's grad
# column by one token's term; an element whose grad is smaller than that
# takes Adam's early step of about lr the other way. So each param is
# held by the share of its elements past PARITY_PARAM_ATOL, at most
# PARITY_FLIP_SHARE, and by its update's l2 difference (``_update_l2``),
# at most PARITY_UPDATE_L2. tools/torch_flip_parity.py read them (NVIDIA
# H100 80GB HBM3, 700 W): sound runs on 4 seeds of each model (and level
# 0 against itself from params one ulp up) at most 4.9e-4 (one element
# of a 2048 bias) and 2.2e-2; faults planted in K6 (one param's update
# lost, its rate 1.5x, every rate 1.25x) at least 5.7e-2 and 0.34; a
# gelu GPT 0 and 4e-5
PARITY_FLIP_SHARE = 5e-3
PARITY_UPDATE_L2 = 0.1

# H100 SXM published peaks (dense): the bound's denominators
PEAK_FLOPS = {torch.float32: 67e12,     # f32 outside the tensor cores
              torch.bfloat16: 989e12}   # bf16 tensor cores
PEAK_BYTES = 3.35e12

# the tier kernels vs their plain versions (phase 3c): the JAX
# package's stated forward / backward tolerances at f32, 2e-2 at bf16
LN_TOL = {torch.float32: (1e-5, 5e-5), torch.bfloat16: (2e-2, 2e-2)}
OPT_TOL = 2e-6
LN_CASES = [
    # name, (N, D), dtype: training's and serving's largest rows, serving
    # at batch 1, a ragged case (N not a multiple of the rows per CTA, D
    # not a multiple of 32 x 4) and a wide one
    ("bert_b8_f32", (4096, 768), torch.float32),
    ("bert_b8_bf16", (4096, 768), torch.bfloat16),
    ("bert_b1_f32", (512, 768), torch.float32),
    ("bert_b1_bf16", (512, 768), torch.bfloat16),
    ("ragged_f32", (1000, 1000), torch.float32),
    ("ragged_bf16", (1000, 1000), torch.bfloat16),
    # rows wider than a warp holds (2048): the wide kernels
    ("wide_f32", (2048, 4096), torch.float32),
    ("wide_bf16", (2048, 4096), torch.bfloat16),
    # the transformer's rows (phase 9: batch 8 x 256, d_model 512, the
    # VPT = 16 instantiation) and GPT-2 small's decode token at batch 1
    # (phase 8c: one row of 768)
    ("transformer_f32", (2048, 512), torch.float32),
    ("transformer_bf16", (2048, 512), torch.bfloat16),
    ("gpt_decode_b1_f32", (1, 768), torch.float32),
    # ViT-B/16's rows (phases 11, 11b: batch 32 x 197 tokens, d_model 768)
    ("vit_f32", (6304, 768), torch.float32),
    ("vit_bf16", (6304, 768), torch.bfloat16),
    # the serving engine's rows (phases 12-12d, GPT-2 small at b_max 8): a
    # decode step, a verify step (8 slots x 5 positions), a suffix prefill
    # of 16 (and of 64, as the 64-token prefill) and the prefills of 128
    # and 256 (512 is bert_b1's)
    ("engine_decode_f32", (8, 768), torch.float32),
    ("engine_verify_f32", (40, 768), torch.float32),
    ("engine_suffix_f32", (16, 768), torch.float32),
    ("engine_prefill64_f32", (64, 768), torch.float32),
    ("engine_prefill128_f32", (128, 768), torch.float32),
    ("engine_prefill256_f32", (256, 768), torch.float32),
]
# K4's AMP instantiation (phase 3c): s = bf16(bf16(x) + bf16(r)) stored
# bf16 and compared bitwise; y, mean and var f32 at K4's f32 tolerance.
# x and r bf16 as on BERT's path, and r f32 (rounded in registers)
LN_AMP_TOL = 1e-5
LN_AMP_CASES = [
    ("bert_b8_amp", (4096, 768), torch.bfloat16),
    ("bert_b8_amp_rf32", (4096, 768), torch.float32),
    ("transformer_amp", (2048, 512), torch.bfloat16),
    ("vit_amp", (6304, 768), torch.bfloat16),
]
# bf16 AMP (phases 4b, 6b, 7b), level 2 against level 0 on the card.
# The two differ only by K4's and K6's f32 rounding, but a difference
# that moves one bf16 rounding downstream moves that value by 2^-8 of
# it, and where the value is a relu pre-activation near 0 it flips the
# unit's grad. The loss is a bf16 value (its elementwise_div is of the
# bf16 class): within two of its ulps, 2^-6 relative. The first step's
# grads within 0.15 in l2 (7.3e-2 measured on the last layer's norm
# scale, NVIDIA H100 80GB HBM3, 700 W), where a missing or mis-cast term
# is off by its whole size. Each param's update over 3 steps within 0.5
# in l2: Adam scales each element's step by its grad's running size, so
# an element whose grad is near 0 takes a step of about lr whose sign
# the rounding decides (0.22 measured, a bias); a wrong update is off by
# 1 or more. Serving against the f32 Predictor (phase 4's weights): the
# encoder's output through 12 bf16 layers within 5e-2 in l2 (8.5e-3
# measured).
AMP_PARITY_LOSS_RTOL = 2 ** -6
AMP_PARITY_GRAD_L2 = 0.15
AMP_PARITY_UPDATE_L2 = 0.5
AMP_SERVE_L2 = 5e-2
AMP_SERVE_REPEATS = 5
AMP_SGD_STEPS = 3
# an odd-sized edge list for the grouped updates: one-element params,
# sizes one past a CTA's chunk, a size no chunk divides
EDGE_SHAPES = [(1,), (3,), (4097,), (16385,), (1000, 7), (123457,)]
ADAM_HYPER = {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}


def log(*args):
    print(*args, flush=True)


def time_ms(fn, budget_ms=150.0, max_iters=200):
    """Mean milliseconds per call from CUDA events, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    once = max(start.elapsed_time(end), 1e-3)
    iters = int(min(max_iters, max(5, budget_ms / once)))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# the profiler loses the device events of a window's start (H100, torch
# 2.11: up to 43 kernels of a step, a whole short step, or the first
# kernel of a window opened right after another; none in 300 windows
# that waited 20 to 50 ms and then ran a few kernels first; late in the
# whole script, the first 63 to 66 device records of each window even
# so). So a window waits, then opens with PROFILER_LEAD_SPINS one-cycle
# spin kernels, which absorb such a loss; a window that kept none of
# them may have lost its own work's first records, and is run again.
PROFILER_SETTLE_S = 0.05
PROFILER_LEAD_SPINS = 256
PROFILER_LOSSES = []   # (lead records lost, kept) of each window that lost


def _settle():
    """Before a profiler window's own work: wait PROFILER_SETTLE_S, then
    run PROFILER_LEAD_SPINS one-cycle spin kernels (which
    ``device_events`` counts apart and drops) and synchronize."""
    time.sleep(PROFILER_SETTLE_S)
    for _ in range(PROFILER_LEAD_SPINS):
        torch.cuda._sleep(1)
    torch.cuda.synchronize()


def device_events(fn, match=lambda name: True, attempts=3):
    """torch.profiler (CPU + CUDA, CUPTI) around ``fn()`` and a
    synchronize: the device events whose names ``match``, and the
    window's wall-clock microseconds. A window whose lead spins
    (``_settle``) all went missing, or that holds no device event of its
    own, is run again, at most ``attempts`` times in all, and then the
    measurement fails; lead spins lost are logged and kept in
    PROFILER_LOSSES."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _settle()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        device = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        spins = sum("spin_kernel" in e.name for e in device)
        events = [e for e in device
                  if "spin_kernel" not in e.name and match(e.name)]
        if spins < PROFILER_LEAD_SPINS:
            PROFILER_LOSSES.append((PROFILER_LEAD_SPINS - spins, spins))
            log("profiler: the window lost %d of its %d lead spins" % (
                PROFILER_LEAD_SPINS - spins, PROFILER_LEAD_SPINS))
        if events and spins:
            return events, wall_us
    raise AssertionError("the profiler lost every lead spin or saw no "
                         "matching device event in %d windows" % attempts)


def device_ms(fn, names, calls=20):
    """Milliseconds of device time per call in the kernels whose names
    contain one of ``names``: ``calls`` calls after a warm-up. A kernel's
    own time, apart from the host time its wrapper takes to launch it
    (``time_ms`` of back-to-back calls shows that instead, where the
    host is the slower side)."""
    fn()
    torch.cuda.synchronize()
    events, _ = device_events(lambda: [fn() for _ in range(calls)],
                              lambda name: any(n in name for n in names))
    return sum(e.time_range.end - e.time_range.start
               for e in events) / calls / 1e3


# ---------------------------------------------------------------- phase 1
def phase_card():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("device: %s | torch %s (CUDA %s) | matmul.allow_tf32=%s "
        "cudnn.allow_tf32=%s" % (
            torch.cuda.get_device_name(0), torch.__version__,
            torch.version.cuda, torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32))
    return smi


# ---------------------------------------------------------------- phase 2
def phase_build():
    from paddle_tpu_torch.kernels import build

    t0 = time.perf_counter()
    took = build.build_all()
    secs = time.perf_counter() - t0
    log("build: %d kernel(s) in %.1f s %s" % (len(took), secs, {
        k: round(v, 1) for k, v in took.items()}))
    spilled = []
    for name in build.sources():
        for kernel, regs, spills in _ptxas_summary(build.ptxas_report(name)):
            log("  ptxas %s: %s: %s registers; %s" % (name, kernel, regs,
                                                      spills))
            if kernel.startswith(NO_SPILL_KERNELS) and \
                    not re.search(r"\b0 bytes spill stores, 0 bytes spill "
                                  r"loads", spills):
                spilled.append(kernel)
    if spilled:
        raise AssertionError("ptxas spilled registers in %s" % spilled)
    return secs


# kernels whose every instantiation must compile without register spills
NO_SPILL_KERNELS = ("ln_res_fwd", "ln_res_bwd", "adam_group_kernel",
                    "sgd_group_kernel")


def _kernel_label(mangled):
    """``name<type, ints...>`` from a kernel's mangled name: its template
    arguments (element type and integer parameters) where it has them."""
    m = re.search(r"\d((?:flash_(?:fwd|dkv|dq)|ln_res|adam_group|sgd_group)"
                  r"\w*?_kernel)(I.*?EEv)?", mangled)
    if m is None:
        return mangled
    if not m.group(2):
        return m.group(1)
    targs = m.group(2)[1:-3]
    args = (["bfloat16"] if targs.startswith("13__nv_bfloat16") else
            ["float"] if targs.startswith("f") else [])
    args += re.findall(r"Li(\d+)E", targs)
    return "%s<%s>" % (m.group(1), ", ".join(args))


def _ptxas_summary(report):
    """(kernel, registers, spills) per compiled kernel from
    ``-Xptxas=-v``: the kernel with its template arguments (element type,
    head dim or columns per thread), its registers and its spill line."""
    out, kernel, spills = [], "?", "?"
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            kernel = _kernel_label(m.group(1))
        elif "spill" in line:
            spills = line.strip()
        elif "registers" in line:
            regs = re.search(r"Used (\d+) registers", line)
            out.append((kernel, regs.group(1) if regs else "?", spills))
    return out


# ---------------------------------------------------------------- phase 3
ATTN_CASES = [
    # name, (B, H, S, D), dtype, bias kind, causal
    ("bert_f32", (8, 12, 512, 64), torch.float32, "keypad", False),
    ("bert_bf16", (8, 12, 512, 64), torch.bfloat16, "keypad", False),
    ("causal_f32", (2, 12, 1024, 64), torch.float32, None, True),
    ("ragged200_f32", (2, 12, 200, 64), torch.float32, "full", False),
    ("d128_f32", (4, 8, 512, 128), torch.float32, "keypad", False),
    # the tensor-core backward's own masking and edge code
    ("causal_bf16", (2, 12, 1024, 64), torch.bfloat16, None, True),
    ("ragged200_bf16", (2, 12, 200, 64), torch.bfloat16, "full", False),
    ("d128_bf16", (4, 8, 512, 128), torch.bfloat16, "keypad", False),
    # GPT-2 small's attention (phases 8, 8b): causal with a trailing
    # key-pad bias, the main path's shape
    ("gpt_f32", (8, 12, 1024, 64), torch.float32, "trailpad", True),
    ("gpt_bf16", (8, 12, 1024, 64), torch.bfloat16, "trailpad", True),
    # the transformer's attention (phase 9), trailing pad as its batches
    # carry: the encoder's self-attention and the cross-attention (Sq =
    # Sk), and the decoder's causal self-attention
    ("transformer_f32", (8, 8, 256, 64), torch.float32, "trailpad", False),
    ("transformer_causal_f32", (8, 8, 256, 64), torch.float32, "trailpad",
     True),
    # ViT-B/16's attention (phases 11, 11b with the flash kernels forced):
    # the ragged S = 197 (a CLS token and 14 x 14 patches), no bias, not
    # causal
    ("vit_f32", (32, 12, 197, 64), torch.float32, None, False),
    ("vit_bf16", (32, 12, 197, 64), torch.bfloat16, None, False),
    # the ring's pairs (phase 21b: GPT-2 small on (seq 4), zigzag): a
    # ring step stacks 8 (position, chunk) pairs of batch 8 along the
    # batch dim, chunks of 128 rows; the first step's diagonal pairs are
    # causal, the later steps' are not. Each pair carries its chunk of
    # the key-pad bias (the padded run) or the packed rows' segment mask
    # over that chunk pair (the packed run), rows wholly masked included,
    # and its backward takes an lse cotangent (``RING_CASES``)
    ("ring_causal_f32", (64, 12, 128, 64), torch.float32, "ringpad", True),
    ("ring_f32", (64, 12, 128, 64), torch.float32, "ringpad", False),
    ("ring_packed_causal_f32", (64, 12, 128, 64), torch.float32, "ringseg",
     True),
    ("ring_packed_f32", (64, 12, 128, 64), torch.float32, "ringseg", False),
]
RING_CASES = {c[0] for c in ATTN_CASES if c[3] in ("ringpad", "ringseg")}
RING_PAIRS, RING_SEQ = 8, 1024  # pairs a ring step stacks; the global S
DEAD_LSE = -1e8  # a row whose every key is masked has lse near -1e9


def _attn_inputs(shape, dtype, bias_kind, gen, dev, causal_pairs=False):
    B, H, S, D = shape
    q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype)
               for _ in range(3))
    bias = None
    if bias_kind == "keypad":  # 10-40% padded keys per batch row
        bias = torch.zeros(B, 1, 1, S, device=dev)
        pads = torch.randint(S // 10, 2 * S // 5 + 1, (B,), generator=gen,
                             device=dev)
        for b in range(B):
            bias[b, ..., S - int(pads[b]):] = -1e9
    elif bias_kind == "trailpad":  # 0-10% padded keys per row, as GPT's
        bias = torch.zeros(B, 1, 1, S, device=dev)
        pads = torch.randint(0, S // 10 + 1, (B,), generator=gen, device=dev)
        for b in range(B):
            bias[b, ..., S - int(pads[b]):] = -1e9
    elif bias_kind == "full":
        bias = torch.randn(B, 1, S, S, generator=gen, device=dev)
    elif bias_kind in ("ringpad", "ringseg"):
        bias = _ring_pair_bias(B, S, bias_kind, causal_pairs, gen, dev)
    return q, k, v, bias


def _ring_pair_bias(B, S, kind, diagonal, gen, dev):
    """The bias of RING_PAIRS stacked ring pairs of S-row chunks of a
    RING_SEQ sequence, batch B // RING_PAIRS: stacked row b pairs query
    chunk cq with key chunk ck (the same chunk on the ``diagonal``, an
    earlier one elsewhere). ``ringpad``: the key chunk of a trailing
    key-pad bias of 0-40% of RING_SEQ (a chunk may be wholly padded),
    [B, 1, 1, S]. ``ringseg``: packed rows (documents of 64-511 tokens,
    then padding, ids 0) whose segment mask over the chunk pair is added
    to that pad bias, as the ring adds them, [B, 1, S, S]."""
    from paddle_tpu_torch.ops.attention import seg_mask

    rows, n_chunks = B // RING_PAIRS, RING_SEQ // S
    seg = torch.zeros(rows, RING_SEQ, dtype=torch.int64, device=dev)
    for r in range(rows):
        at, doc = 0, 1
        end = RING_SEQ - int(torch.randint(0, 2 * RING_SEQ // 5 + 1, (),
                                           generator=gen, device=dev))
        while at < end:
            n = int(torch.randint(64, 512, (), generator=gen, device=dev))
            seg[r, at:min(at + n, end)] = doc
            at, doc = at + n, doc + 1
    pad = torch.where(seg > 0, 0.0, -1e9)
    out = []
    for b in range(B):
        r = b % rows
        cq = int(torch.randint(1 - int(diagonal), n_chunks, (),
                               generator=gen, device=dev))
        ck = cq if diagonal else int(torch.randint(0, cq, (), generator=gen,
                                                   device=dev))
        ks = slice(ck * S, (ck + 1) * S)
        bias = pad[r, ks].reshape(1, 1, 1, S)
        if kind == "ringseg":
            bias = bias + seg_mask(seg[r:r + 1, cq * S:(cq + 1) * S],
                                   seg[r:r + 1, ks])
        out.append(bias)
    return torch.cat(out)


def _library_mask(bias, causal, dtype):
    """The mask ``scaled_dot_product_attention`` takes beside the kernel's
    bias: none on a causal case (``is_causal`` takes no mask; the
    yardstick then skips the pad bias the kernel adds)."""
    return None if bias is None or causal else bias.to(dtype)


def _attn_bound(shape, dtype, bias, causal):
    B, H, S, D = shape
    pairs = S * (S + 1) // 2 if causal else S * S
    flops = 4.0 * B * H * D * pairs
    nbytes = 4 * B * H * S * D * torch.tensor([], dtype=dtype).element_size()
    nbytes += B * H * S * 4  # lse
    if bias is not None:
        nbytes += bias.numel() * 4
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", flops, nbytes)


def _fwd_occupancy():
    """CTAs per SM the card grants the flash forward kernel, per dtype,
    head dim and bias kind (none, a key-pad row, a full tile)."""
    from paddle_tpu_torch.ops import attention as attn

    out = []
    for dtype in (torch.float32, torch.bfloat16):
        for d in (64, 128):
            rows, threads, _ = attn._kernel_config(d, dtype)
            occ = {str(b): attn.flash_attention_fwd_occupancy(d, dtype, b)
                   for b in (None, "row", "full")}
            out.append(dict(kernel="flash_attention_fwd", dtype=str(dtype),
                            head_dim=d, rows=rows, threads=threads,
                            occupancy=occ))
            log("occupancy flash_attention_fwd %-14s D = %3d, %d rows, %d "
                "threads: %s" % (dtype, d, rows, threads, ", ".join(
                    "bias %s %d CTA(s) x %d B = %d warps/SM"
                    % (b, n, sm, n * threads // 32)
                    for b, (n, sm) in occ.items())))
    return out


def phase_kernels(seed):
    """The flash forward kernel (K1) against its plain version on each of
    ``ATTN_CASES``: two launches bitwise equal, its device time
    (torch.profiler) and call time (CUDA events around back-to-back
    calls), the plain version's, one ``scaled_dot_product_attention``
    call's (call and device time) and the bound. At bf16 it is also held
    against the plain version run at bf16 (not a gate: that version
    rounds the normalized p to bf16, the kernel the unnormalized one, as
    the TPU kernel does). Takes whichever ``paddle_tpu_torch`` is first
    on the path, so a parent's checkout can be timed by the same
    measurement."""
    from paddle_tpu_torch.ops import attention as attn

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    rows = []
    for name, shape, dtype, bias_kind, causal in ATTN_CASES:
        q, k, v, bias = _attn_inputs(shape, dtype, bias_kind, gen, dev,
                                     causal)
        scale = shape[3] ** -0.5
        before = attn.flash_attention_fwd.launches
        out, lse = attn.flash_attention_fwd(q, k, v, bias, scale, causal)
        torch.cuda.synchronize()
        if attn.flash_attention_fwd.launches != before + 1:
            raise AssertionError("%s: the wrapper did not count its launch"
                                 % name)
        out2, lse2 = attn.flash_attention_fwd(q, k, v, bias, scale, causal)
        torch.cuda.synchronize()
        bitwise = torch.equal(out, out2) and torch.equal(lse, lse2)
        del out2, lse2
        want, want_lse = attn.composed_attention_with_lse(
            q.float(), k.float(), v.float(), bias, scale, causal)
        # a row whose every key is masked (only the ring's pairs have
        # them) has an lse near -1e9, where the ulp is 64, and its output
        # spreads over whichever masked keys a side visits: both sides
        # must find it dead (the ring merges it with weight 0), and the
        # live rows are compared
        dead = want_lse <= DEAD_LSE
        live = ~dead if torch.equal(dead, lse <= DEAD_LSE) else None
        err_o = float("inf") if live is None else float(
            (out.float() - want)[live].abs().max())
        err_lse = float("inf") if live is None else float(
            (lse - want_lse)[live].abs().max())
        same_dtype = None
        if dtype != torch.float32:
            b_out, b_lse = attn.composed_attention_with_lse(q, k, v, bias,
                                                            scale, causal)
            same_dtype = dict(
                out=float((out.float() - b_out.float()).abs().max()),
                lse=float((lse - b_lse).abs().max()))
            del b_out, b_lse
        tol_o, tol_lse = (2e-5, 1e-5) if dtype == torch.float32 else \
            (2e-2, 2e-2)
        ok = err_o <= tol_o and err_lse <= tol_lse and bitwise and \
            bool(torch.isfinite(out).all())
        fn = lambda: attn.flash_attention_fwd(  # noqa: E731
            q, k, v, bias, scale, causal)
        ms = device_ms(fn, ("flash_fwd",))
        call_ms = time_ms(fn)
        plain_ms = time_ms(lambda: attn.composed_attention_with_lse(
            q, k, v, bias, scale, causal))
        lib_mask = _library_mask(bias, causal, dtype)
        lib_fn = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q, k, v, attn_mask=lib_mask, is_causal=causal, scale=scale)
        library_ms = time_ms(lib_fn)
        library_device_ms = device_ms(lib_fn, ("",))
        bound_ms, bound_by, flops, nbytes = _attn_bound(shape, dtype, bias,
                                                        causal)
        row = dict(case=name, shape=list(shape), dtype=str(dtype),
                   bias=None if bias is None else list(bias.shape),
                   causal=causal, max_abs_err=err_o, max_abs_err_lse=err_lse,
                   max_abs_err_vs_plain_in_dtype=same_dtype,
                   bitwise_repeatable=bitwise, tol=[tol_o, tol_lse], ms=ms,
                   call_ms=call_ms, plain_ms=plain_ms, library_ms=library_ms,
                   library_device_ms=library_device_ms, bound_ms=bound_ms,
                   bound_by=bound_by, flops=flops, bytes=nbytes,
                   roofline_share=bound_ms / ms, ok=ok)
        rows.append(row)
        log("kernel %-14s %-22s err O %.2e lse %.2e%s | kernel %.4f ms on "
            "the card, %.4f a call | plain %.4f ms | sdpa %.4f ms a call, "
            "%.4f on the card | bound %.4f ms (%s) = %.1f%% of roofline | "
            "two launches bitwise equal: %s%s" % (
                name, tuple(shape), err_o, err_lse,
                "" if same_dtype is None else
                " (vs the plain version at bf16: O %.2e lse %.2e)" % (
                    same_dtype["out"], same_dtype["lse"]),
                ms, call_ms, plain_ms, library_ms, library_device_ms,
                bound_ms, bound_by, 100 * bound_ms / ms, bitwise,
                "" if ok else "  <-- FAILED"))
        del q, k, v, bias, out, lse, want, want_lse, fn, lib_fn, lib_mask
    bad = [r["case"] for r in rows if not r["ok"]]
    if bad:
        raise AssertionError("flash kernel disagrees with its plain version "
                             "(or is not bitwise repeatable) in %s" % bad)
    return rows


# --------------------------------------------------------------- phase 3b
# the cases that also check the raw score grad (a trainable bias's): on
# the causal ones the dK/dV kernel skips the tiles above the diagonal
BWD_WANT_DB = {"causal_f32", "ragged200_f32", "causal_bf16", "ragged200_bf16"}


def _bwd_bounds(shape, dtype, bias, causal, want_db):
    """Bounds of the dK/dV kernel, the dQ kernel and the backward as a
    whole: (ms, bound_by) each. A unit is B*H*P*D FLOPs (P the visible
    (query, key) pairs): the dK/dV kernel does 8, the dQ kernel 6 and
    the backward needs 10 (s, dp, dV, dK and dQ, two FLOPs each). Each
    reads q, k, v, dO, lse, delta and the bias once and writes its
    outputs once."""
    B, H, S, D = shape
    pairs = S * (S + 1) // 2 if causal else S * S
    esize = torch.tensor([], dtype=dtype).element_size()
    ins = 4 * B * H * S * D * esize + 2 * B * H * S * 4
    if bias is not None:
        ins += bias.numel() * 4
    ds_bytes = B * H * S * S * 4 if want_db else 0
    out = []
    for flops_per, nbytes in (
            (8, ins + 2 * B * H * S * D * esize + ds_bytes),
            (6, ins + B * H * S * D * esize),
            (10, ins + 3 * B * H * S * D * esize + ds_bytes)):
        t_ops = flops_per * B * H * pairs * D / PEAK_FLOPS[dtype]
        t_bytes = nbytes / PEAK_BYTES
        out.append((max(t_ops, t_bytes) * 1e3,
                    "operations" if t_ops >= t_bytes else "bytes"))
    return out


def _bwd_occupancy():
    """CTAs per SM the card grants each backward kernel, per dtype, head
    dim and bias kind (none, a key-pad row, a full tile)."""
    from paddle_tpu_torch.ops import attention as attn

    out = []
    for what in ("flash_attention_dkv", "flash_attention_dq"):
        for dtype in (torch.float32, torch.bfloat16):
            for d in (64, 128):
                _, threads, _ = attn._bwd_config(what, d, dtype)
                occ = {str(b): attn.flash_attention_bwd_occupancy(
                    what, d, dtype, b) for b in (None, "row", "full")}
                out.append(dict(kernel=what, dtype=str(dtype), head_dim=d,
                                threads=threads, occupancy=occ))
                log("occupancy %-19s %-14s D = %3d, %d threads: %s" % (
                    what, dtype, d, threads, ", ".join(
                        "bias %s %d CTA(s) x %d B = %d warps/SM"
                        % (b, n, sm, n * threads // 32)
                        for b, (n, sm) in occ.items())))
    return out


def _lse_cotangent_errs(q, k, v, bias, g, g_lse, scale, causal):
    """The ring's use of the kernels, end to end: the grads of (out, lse)
    under the cotangents (g, g_lse) through ``flash_attention_with_lse``
    (K1, then K2 and K3 with g_lse folded into delta) against autograd
    through the plain version in f32. Returns the errors as dq_lse,
    dk_lse, dv_lse."""
    from paddle_tpu_torch.ops import attention as attn

    def grads(fn, *xs):
        leaves = [x.detach().clone().requires_grad_(True) for x in xs]
        out, lse = fn(*leaves, bias, scale, causal)
        return torch.autograd.grad((out, lse), leaves, (g.to(out.dtype),
                                                        g_lse))

    got = grads(attn.flash_attention_with_lse, q, k, v)
    want = grads(attn.composed_attention_with_lse,
                 *[t.float() for t in (q, k, v)])
    return {n + "_lse": float((a.float() - b).abs().max())
            for n, a, b in zip(("dq", "dk", "dv"), got, want)}


def phase_bwd_kernels(seed):
    from paddle_tpu_torch.ops import attention as attn

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 1)
    occupancy = _bwd_occupancy()
    rows = []
    for name, shape, dtype, bias_kind, causal in ATTN_CASES:
        want_db = name in BWD_WANT_DB
        q, k, v, bias = _attn_inputs(shape, dtype, bias_kind, gen, dev,
                                     causal)
        g = torch.randn(shape, generator=gen, device=dev).to(dtype)
        scale = shape[3] ** -0.5
        o, lse = attn.composed_attention_with_lse(
            *[t.float() for t in (q, k, v)], bias, scale, causal)
        g_lse = None
        if name in RING_CASES:
            # the ring's merge hands a pair an lse cotangent, and gives a
            # dead row (every key masked) weight 0: no cotangent at all
            live = (lse > DEAD_LSE)[..., None]
            g = torch.where(live, g, 0.0).to(dtype)
            g_lse = torch.randn(shape[:3], generator=gen,
                                device=dev) * live[..., 0]
        f32 = [t.float() for t in (q, k, v, g)]
        delta = attn._delta(f32[3], o, g_lse)
        args = (q, k, v, bias, g, lse, delta, scale, causal)
        n_dkv = attn.flash_attention_dkv.launches
        n_dq = attn.flash_attention_dq.launches
        dk, dv, ds = attn.flash_attention_dkv(*args, want_db=want_db)
        dq = attn.flash_attention_dq(*args)
        torch.cuda.synchronize()
        if (attn.flash_attention_dkv.launches, attn.flash_attention_dq
                .launches) != (n_dkv + 1, n_dq + 1):
            raise AssertionError("%s: a backward wrapper did not count its "
                                 "launch" % name)
        # no atomics: a second launch on the same inputs, the same bits
        dk2, dv2, ds2 = attn.flash_attention_dkv(*args, want_db=want_db)
        dq2 = attn.flash_attention_dq(*args)
        torch.cuda.synchronize()
        bitwise = all(torch.equal(a, b) for a, b in (
            (dk, dk2), (dv, dv2), (dq, dq2))) and (
            not want_db or torch.equal(ds, ds2))
        del dk2, dv2, ds2, dq2
        # the plain versions on f32 copies of the same inputs
        ref_args = (*f32[:3], bias, f32[3], lse, delta, scale, causal)
        rdk, rdv, rds = attn.flash_attention_dkv_reference(
            *ref_args, want_db=want_db)
        rdq = attn.flash_attention_dq_reference(*ref_args)
        errs = {n: float((a.float() - b).abs().max())
                for n, a, b in (("dq", dq, rdq), ("dk", dk, rdk),
                                ("dv", dv, rdv))}
        if want_db:
            errs["ds"] = float((ds - rds).abs().max())
        # at bf16, also against the plain versions on the bf16 inputs
        # themselves, which round p and ds to bf16 where the kernels do
        # (not a gate: it shows where the two round alike)
        same_dtype = {}
        if dtype != torch.float32:
            bdk, bdv, _ = attn.flash_attention_dkv_reference(*args)
            bdq = attn.flash_attention_dq_reference(*args)
            same_dtype = {n: float((a.float() - b.float()).abs().max())
                          for n, a, b in (("dq", dq, bdq), ("dk", dk, bdk),
                                          ("dv", dv, bdv))}
            del bdk, bdv, bdq
        if g_lse is not None:
            errs.update(_lse_cotangent_errs(q, k, v, bias, g, g_lse, scale,
                                            causal))
        tol = BWD_TOL[dtype]
        ok = max(errs.values()) <= tol and bitwise and all(
            bool(torch.isfinite(t).all()) for t in (dq, dk, dv))
        dkv_fn = lambda: attn.flash_attention_dkv(  # noqa: E731
            *args, want_db=want_db)
        dq_fn = lambda: attn.flash_attention_dq(*args)  # noqa: E731
        # the kernels' own device time (torch.profiler), and the time of
        # back-to-back calls (CUDA events), which holds the host's launch
        t_dkv = dict(ms=device_ms(dkv_fn, ("flash_dkv",)),
                     call_ms=time_ms(dkv_fn),
                     plain_ms=time_ms(lambda: attn
                                      .flash_attention_dkv_reference(
                                          *args, want_db=want_db)))
        t_dq = dict(ms=device_ms(dq_fn, ("flash_dq",)), call_ms=time_ms(dq_fn),
                    plain_ms=time_ms(lambda: attn
                                     .flash_attention_dq_reference(*args)))
        # yardstick: the backward alone of one scaled_dot_product_attention
        lq, lk, lv = (t.detach().clone().requires_grad_(True)
                      for t in (q, k, v))
        lib_out = F.scaled_dot_product_attention(
            lq, lk, lv, attn_mask=_library_mask(bias, causal, dtype),
            is_causal=causal, scale=scale)
        lib_fn = lambda: torch.autograd.grad(  # noqa: E731
            lib_out, (lq, lk, lv), g, retain_graph=True)
        library_ms = time_ms(lib_fn)
        library_device_ms = device_ms(lib_fn, ("",))
        bounds = _bwd_bounds(shape, dtype, bias, causal, want_db)
        for t, (b, by) in zip((t_dkv, t_dq), bounds):
            t.update(bound_ms=b, bound_by=by, roofline_share=b / t["ms"])
        both_ms = t_dkv["ms"] + t_dq["ms"]
        bwd = dict(ms=both_ms, call_ms=t_dkv["call_ms"] + t_dq["call_ms"],
                   library_ms=library_ms,
                   library_device_ms=library_device_ms,
                   bound_ms=bounds[2][0], bound_by=bounds[2][1],
                   roofline_share=bounds[2][0] / both_ms)
        row = dict(case=name, shape=list(shape), dtype=str(dtype),
                   bias=None if bias is None else list(bias.shape),
                   causal=causal, want_db=want_db, max_abs_err=errs, tol=tol,
                   max_abs_err_vs_plain_in_dtype=same_dtype,
                   bitwise_repeatable=bitwise, dkv=t_dkv, dq=t_dq, bwd=bwd,
                   library_ms=library_ms, library_device_ms=library_device_ms,
                   ok=ok)
        rows.append(row)
        log("bwd %-14s %-22s err %s%s | dkv %.4f ms on the card, %.4f a "
            "call (plain %.4f, bound %.4f %s, %.1f%%) | dq %.4f ms, %.4f a "
            "call (plain %.4f, bound %.4f %s, %.1f%%)%s" % (
                name, tuple(shape),
                " ".join("%s %.2e" % kv for kv in errs.items()),
                "" if bitwise else " NOT BITWISE REPEATABLE", t_dkv["ms"],
                t_dkv["call_ms"], t_dkv["plain_ms"], t_dkv["bound_ms"],
                t_dkv["bound_by"], 100 * t_dkv["roofline_share"], t_dq["ms"],
                t_dq["call_ms"], t_dq["plain_ms"], t_dq["bound_ms"],
                t_dq["bound_by"], 100 * t_dq["roofline_share"],
                "" if ok else "  <-- FAILED"))
        log("bwd %-14s dkv + dq %.4f ms on the card, %.4f a call | sdpa "
            "bwd %.4f ms a call, %.4f on the card | bound (10 units) %.4f "
            "%s, %.1f%% | two launches bitwise equal: %s%s" % (
                name, both_ms, bwd["call_ms"], library_ms, library_device_ms,
                bwd["bound_ms"], bwd["bound_by"], 100 * bwd["roofline_share"],
                bitwise, "" if not same_dtype else
                " | err vs the plain versions at bf16 " + " ".join(
                    "%s %.2e" % kv for kv in same_dtype.items())))
        del q, k, v, g, g_lse, bias, f32, o, lse, delta, args, ref_args
        del dk, dv, ds, dq, rdk, rdv, rds, rdq, lq, lk, lv, lib_out, dkv_fn
        del dq_fn, lib_fn
    bad = [r["case"] for r in rows if not r["ok"]]
    if bad:
        raise AssertionError("flash backward kernels disagree with their "
                             "plain versions (or are not bitwise "
                             "repeatable) in %s" % bad)
    return rows, occupancy


# --------------------------------------------------------------- phase 3c
def _ln_bounds(n, d, dtype):
    """Bounds of K4 and K5: (ms, bound_by) each. K4 reads x and r and
    writes y and s, plus the per-row mean and variance and the scale and
    bias vectors; K5 reads s, gy and gres and writes dx, plus the
    statistics, the scale and dscale / dbias. The arithmetic (about 8
    and 12 f32 operations per element) runs on f32 values."""
    esize = torch.tensor([], dtype=dtype).element_size()
    nd = n * d
    out = []
    for streams, vecs, ops in ((4, 2 * d * esize, 8), (4, d * esize + 8 * d,
                                                        12)):
        nbytes = streams * nd * esize + 8 * n + vecs
        t_ops = ops * nd / PEAK_FLOPS[torch.float32]
        t_bytes = nbytes / PEAK_BYTES
        out.append((max(t_ops, t_bytes) * 1e3,
                    "operations" if t_ops >= t_bytes else "bytes"))
    return out


def _opt_bound(n, k, streams, ops, n_bf16=0):
    """Bound of a grouped update over n f32 elements in k params:
    ``streams`` four-byte streams per element (each read or write once),
    of which the grad stream is two bytes for the ``n_bf16`` elements
    whose grads are bf16, and the per-param scalars (3 read and 2
    written for Adam, 1 read for SGD); ``ops`` f32 operations per
    element."""
    scalars = (5 if streams == 7 else 1) * 4 * k
    t_bytes = (streams * 4 * n - 2 * n_bf16 + scalars) / PEAK_BYTES
    t_ops = ops * n / PEAK_FLOPS[torch.float32]
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def _bert_train_program(opt, amp=False):
    """BERT-base MLM training program (no startup run): (main, startup,
    loss, params_grads). With ``amp``, the optimizer goes through
    ``contrib.mixed_precision.decorate``: bf16 AMP."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import bert

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        loss, _ = bert.build(bert.base_config(), seq_len=SEQ,
                             max_mask=MAX_MASK)
        optimizer = getattr(fluid.optimizer, opt)(learning_rate=TRAIN_LR)
        if amp:
            optimizer = fluid.contrib.mixed_precision.decorate(optimizer)
        _, params_grads = optimizer.minimize(loss)
    return main, startup, loss, params_grads


def _group_on_card(shapes, gen, dev):
    """Random f32 params, grads and moments of ``shapes`` on the card,
    one learning rate, per-param beta powers (as the program has)."""
    mk = lambda s, scale=1.0: torch.rand(  # noqa: E731
        s, generator=gen, device=dev) * scale + 0.01
    k = len(shapes)
    return {"Param": [mk(s) for s in shapes],
            "Grad": [mk(s) - 0.5 for s in shapes],
            "Moment1": [mk(s, 0.1) for s in shapes],
            "Moment2": [mk(s, 0.01) for s in shapes],
            "Beta1Pow": [torch.full((1,), 0.9 ** 3, device=dev)
                         for _ in range(k)],
            "Beta2Pow": [torch.full((1,), 0.999 ** 3, device=dev)
                         for _ in range(k)],
            "LearningRate": [torch.full((1,), TRAIN_LR, device=dev)] * k}


def _library_times(fn):
    """A library yardstick's device time per call (every device kernel in
    the profiled window) and its call time (CUDA events around
    back-to-back calls): ``library_ms`` and ``library_call_ms``."""
    return dict(library_ms=device_ms(fn, ("",)), library_call_ms=time_ms(fn))


def phase_tier_kernels(seed):
    """K4 and K5 on ``LN_CASES``, K6 and K7 on BERT-base's params and an
    edge list: each against its plain version, two launches bitwise
    equal, its device and call time, the plain version's, its library
    yardstick's device and call time, and the bound. Takes whichever
    ``paddle_tpu_torch`` is first on the path, so a parent's checkout is
    timed by the same measurement."""
    from paddle_tpu_torch.kernels import layernorm as ln
    from paddle_tpu_torch.kernels import optimizer_update as ou

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 2)
    rows = []
    # K4 and K5. K5's count comes from the autograd runs alone (zeroed
    # just before each, read just after): that is its path, the fused
    # function differentiated
    k5_launches = 0
    for name, (n, d), dtype in LN_CASES:
        # x + r of standard deviation 0.7 stays below 8 over millions of
        # values, where one bf16 rounding of s (half an ulp, 2^-5 from 8
        # up) would pass the 2e-2 tolerance by itself
        x, r = (0.5 * torch.randn(n, d, generator=gen, device=dev)
                .to(dtype) for _ in range(2))
        gy, gs = (0.5 * torch.randn(n, d, generator=gen, device=dev)
                  .to(dtype) for _ in range(2))
        # scale and bias near their initial 1 and 0, as in a model
        sc = (1 + 0.1 * torch.randn(d, generator=gen, device=dev)).to(dtype)
        b = (0.1 * torch.randn(d, generator=gen, device=dev)).to(dtype)
        # the path: the fused function under autograd (zeroed just
        # before, read just after)
        ins = [t.clone().requires_grad_(True) for t in (x, r, sc, b)]
        ln.layernorm_residual_fwd.launches = 0
        ln.layernorm_residual_bwd.launches = 0
        outs = ln.layernorm_residual(*ins, eps=1e-5)
        torch.autograd.backward(outs[:2], [gy, gs])
        torch.cuda.synchronize()
        got = (ln.layernorm_residual_fwd.launches,
               ln.layernorm_residual_bwd.launches)
        if got != (1, 1):
            raise AssertionError("%s: the autograd run launched (K4, K5) = "
                                 "%s, expected (1, 1)" % (name, got))
        k5_launches += got[1]
        # each kernel against its plain version on f32 copies of the
        # same inputs (at bf16 the kernels' outputs are rounded, the
        # plain versions' are not); K5 on K4's saved rows and statistics
        y, s, mean, var = (t.detach() for t in outs)
        want = ln.composed_layernorm_residual(
            x.float(), r.float(), sc.float(), b.float(), eps=1e-5)
        err_f = max(float((o.float() - w).abs().max())
                    for o, w in zip((y, s, mean, var), want))
        bwd_args = (s, mean, var, sc, gy, gs, 1e-5)
        dx, dsc, db = ln.layernorm_residual_bwd(*bwd_args)
        ref = ln.layernorm_residual_bwd_reference(
            s.float(), mean, var, sc.float(), gy.float(), gs.float(), 1e-5)
        err_b = max(float((o.float() - w).abs().max())
                    for o, w in zip((dx, dsc, db), ref))
        # the autograd run took the same kernels: its grads are theirs
        same = all(torch.equal(t.grad, w) for t, w in zip(
            ins, (dx, dx, dsc.to(dtype), db.to(dtype))))
        tol_f, tol_b = LN_TOL[dtype]
        ok = err_f <= tol_f and err_b <= tol_b and same and all(
            bool(torch.isfinite(t).all()) for t in (y, dx, dsc, db))
        # two launches of K5 on the same inputs: the same bits
        again = ln.layernorm_residual_bwd(*bwd_args)
        bitwise = all(torch.equal(a, a2) for a, a2 in zip((dx, dsc, db),
                                                          again))
        ok = ok and bitwise
        del again
        fwd = lambda: ln.layernorm_residual_fwd(x, r, sc, b, 1e-5)  # noqa
        bwd = lambda: ln.layernorm_residual_bwd(*bwd_args)  # noqa: E731
        rstd = torch.rsqrt(var + 1e-5)
        lib_fwd = lambda: F.layer_norm(  # noqa: E731
            torch.add(x, r), (d,), sc, b, 1e-5)
        lib_bwd = lambda: torch.ops.aten.native_layer_norm_backward(  # noqa
            gy, s, [d], mean, rstd, sc, b, [True, True, True])
        t_fwd = dict(
            ms=device_ms(fwd, ("ln_res_fwd",)), call_ms=time_ms(fwd),
            plain_ms=time_ms(lambda: ln.composed_layernorm_residual(
                x, r, sc, b, eps=1e-5)),
            **_library_times(lib_fwd))
        t_bwd = dict(
            ms=device_ms(bwd, ("ln_res_bwd",)), call_ms=time_ms(bwd),
            plain_ms=time_ms(
                lambda: ln.layernorm_residual_bwd_reference(*bwd_args)),
            **_library_times(lib_bwd))
        for t, (bound, by) in zip((t_fwd, t_bwd), _ln_bounds(n, d, dtype)):
            t.update(bound_ms=bound, bound_by=by,
                     roofline_share=bound / t["ms"])
        row = dict(case=name, shape=[n, d], dtype=str(dtype),
                   max_abs_err=dict(fwd=err_f, bwd=err_b),
                   autograd_equals_kernels=same, bwd_bitwise=bitwise,
                   bwd_launch=(list(ln.bwd_launch(ln._lib(), n, d, dtype,
                                                  dev))
                               if hasattr(ln, "bwd_launch") else None),
                   tol=[tol_f, tol_b], fwd=t_fwd, bwd=t_bwd, ok=ok)
        rows.append(row)
        log("tier %-12s %-12s err fwd %.2e bwd %.2e | K4 %.4f ms on the "
            "card, %.4f a call (plain %.4f; add+layer_norm %.4f on the "
            "card, %.4f a call; bound %.4f %s, %.1f%%) | K5 %.4f ms on the "
            "card, %.4f a call (plain %.4f; native_layer_norm_backward "
            "%.4f on the card, %.4f a call; bound %.4f %s, %.1f%%; grid %s; "
            "bitwise %s)%s" % (
                name, (n, d), err_f, err_b, t_fwd["ms"], t_fwd["call_ms"],
                t_fwd["plain_ms"], t_fwd["library_ms"],
                t_fwd["library_call_ms"], t_fwd["bound_ms"],
                t_fwd["bound_by"], 100 * t_fwd["roofline_share"],
                t_bwd["ms"], t_bwd["call_ms"], t_bwd["plain_ms"],
                t_bwd["library_ms"], t_bwd["library_call_ms"],
                t_bwd["bound_ms"], t_bwd["bound_by"],
                100 * t_bwd["roofline_share"], row["bwd_launch"], bitwise,
                "" if ok else "  <-- FAILED"))
        del x, r, gy, gs, sc, b, ins, outs, want, y, s, mean, var, dx, dsc
        del db, ref, bwd_args, rstd, fwd, bwd, lib_fwd, lib_bwd

    # K6 and K7
    main, _, _, params_grads = _bert_train_program("Adam")
    bert_shapes = [tuple(p.shape)
                   for p in main.global_block().all_parameters()]
    grad_bf16 = _amp_grad_bf16(main, [g.name for _, g in params_grads])
    del main, params_grads
    for name, shapes in (("bert_base", bert_shapes),
                         ("edge", EDGE_SHAPES)):
        ins = _group_on_card(shapes, gen, dev)
        n = sum(int(np.prod(s)) for s in shapes)
        k = len(shapes)
        errs, bitwise, vector = {}, {}, {}
        for kind, wrapper, fn, ref in (
                ("adam", ou.adam_group,
                 lambda: ou.adam_group(ins, ADAM_HYPER),
                 lambda: ou.adam_group_reference(ins, ADAM_HYPER)),
                ("sgd", ou.sgd_group, lambda: ou.sgd_group(ins),
                 lambda: ou.sgd_group_reference(ins))):
            # the entries that take the 16-byte path (a parent's wrapper
            # may not count them)
            before = getattr(wrapper, "vector_entries", None)
            got, again, want = fn(), fn(), ref()
            torch.cuda.synchronize()
            vector[kind] = None if before is None else \
                (wrapper.vector_entries - before) // 2
            errs[kind] = max(float((a - w).abs().max())
                             for slot in want
                             for a, w in zip(got[slot], want[slot]))
            bitwise[kind] = all(torch.equal(a, a2) for slot in got
                                for a, a2 in zip(got[slot], again[slot]))
            del got, again, want
        ok = max(errs.values()) <= OPT_TOL and all(bitwise.values())
        adam = lambda: ou.adam_group(ins, ADAM_HYPER)  # noqa: E731
        sgd = lambda: ou.sgd_group(ins)  # noqa: E731
        t_adam = dict(ms=device_ms(adam, ("adam_group_kernel",)),
                      call_ms=time_ms(adam),
                      plain_ms=time_ms(
                          lambda: ou.adam_group_reference(ins, ADAM_HYPER)))
        t_sgd = dict(ms=device_ms(sgd, ("sgd_group_kernel",)),
                     call_ms=time_ms(sgd),
                     plain_ms=time_ms(lambda: ou.sgd_group_reference(ins)))
        # yardsticks on copies: both library calls update in place
        lib = {s: [t.clone() for t in ins[s]]
               for s in ("Param", "Grad", "Moment1", "Moment2")}
        steps = [torch.full((), 3.0, device=dev) for _ in shapes]
        t_adam.update(_library_times(lambda: torch._fused_adam_(
            lib["Param"], lib["Grad"], lib["Moment1"], lib["Moment2"], [],
            steps, lr=TRAIN_LR, beta1=0.9, beta2=0.999, weight_decay=0.0,
            eps=1e-8, amsgrad=False, maximize=False)))
        t_sgd.update(_library_times(lambda: torch._foreach_add_(
            lib["Param"], lib["Grad"], alpha=-TRAIN_LR)))
        for t, (bound, by) in ((t_adam, _opt_bound(n, k, 7, 13)),
                               (t_sgd, _opt_bound(n, k, 3, 2))):
            t.update(bound_ms=bound, bound_by=by,
                     roofline_share=bound / t["ms"])
        row = dict(case=name, params=k, elements=n, max_abs_err=errs,
                   bitwise_repeatable=bitwise, vector_entries=vector,
                   tol=OPT_TOL, adam=t_adam, sgd=t_sgd, ok=ok)
        rows.append(row)
        log("tier %-10s %d params, %d elements: err adam %.2e sgd %.2e; "
            "two launches bitwise equal %s; entries on the 16-byte path %s "
            "| K6 %.4f ms on the card, %.4f a call (plain %.4f; "
            "_fused_adam_ %.4f on the card, %.4f a call; bound %.4f %s, "
            "%.1f%%) | K7 %.4f ms on the card, %.4f a call (plain %.4f; "
            "_foreach_add_ %.4f on the card, %.4f a call; bound %.4f %s, "
            "%.1f%%)%s" % (
                name, k, n, errs["adam"], errs["sgd"], bitwise, vector,
                t_adam["ms"], t_adam["call_ms"], t_adam["plain_ms"],
                t_adam["library_ms"], t_adam["library_call_ms"],
                t_adam["bound_ms"], t_adam["bound_by"],
                100 * t_adam["roofline_share"], t_sgd["ms"], t_sgd["call_ms"],
                t_sgd["plain_ms"], t_sgd["library_ms"],
                t_sgd["library_call_ms"], t_sgd["bound_ms"],
                t_sgd["bound_by"], 100 * t_sgd["roofline_share"],
                "" if ok else "  <-- FAILED"))
        del ins, lib, steps, adam, sgd
        torch.cuda.empty_cache()
    # K4's AMP instantiation and K6 / K7 on an AMP step's grads
    rows += [_ln_amp_case(name, n, d, r_dtype, gen, dev)
             for name, (n, d), r_dtype in LN_AMP_CASES]
    rows.append(_opt_amp_case(bert_shapes, grad_bf16, gen, dev))
    bad = [r["case"] for r in rows if not r["ok"]]
    if bad:
        raise AssertionError("tier kernels disagree with their plain "
                             "versions in %s" % bad)
    return rows, k5_launches


def _amp_grad_bf16(main, grad_names):
    """Whether each param's grad comes out bf16 in an AMP step: the AMP
    class of the grad op that writes it (for a ``sum`` of a param's
    renamed grads, bf16 unless one of its terms is f32). In BERT the
    layer norms' Scale / Bias grads are f32, every other grad bf16."""
    from paddle_tpu_torch.core.amp import policy_for

    writer = {n: op for op in main.global_block().ops
              for n in op.output_names()}

    def bf16(name):
        op = writer[name]
        if op.type == "sum":
            return all(bf16(n) for n in op.input("X") if n)
        return policy_for(op.type) == "bf16"

    return [bf16(g) for g in grad_names]


def _ln_amp_bound(n, d, x_dtype, r_dtype):
    """Bound of K4's AMP instantiation: x and r read in their dtypes, s
    written bf16 and y f32, the statistics, f32 scale and bias; about 8
    f32 operations an element."""
    esize = lambda t: torch.tensor([], dtype=t).element_size()  # noqa
    nbytes = n * d * (esize(x_dtype) + esize(r_dtype) + 2 + 4) + 8 * n + \
        8 * d
    t_ops = 8 * n * d / PEAK_FLOPS[torch.float32]
    t_bytes = nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def _ln_amp_case(name, n, d, r_dtype, gen, dev):
    """K4's AMP instantiation on bf16 x and ``r_dtype`` r, f32 scale and
    bias, against its plain version (s bitwise, y / mean / var within
    LN_AMP_TOL), two launches bitwise equal, with its device and call
    time, the plain version's, the library's (``torch.add`` at bf16 then
    ``F.layer_norm`` of the f32 sum) and the bound."""
    from paddle_tpu_torch.kernels import layernorm as ln

    x = (0.5 * torch.randn(n, d, generator=gen, device=dev)).bfloat16()
    r = (0.5 * torch.randn(n, d, generator=gen, device=dev)).to(r_dtype)
    sc = 1 + 0.1 * torch.randn(d, generator=gen, device=dev)
    b = 0.1 * torch.randn(d, generator=gen, device=dev)
    fwd = lambda: ln.layernorm_residual_fwd_amp(x, r, sc, b, 1e-5)  # noqa
    plain = lambda: ln.composed_layernorm_residual(  # noqa: E731
        x, r, sc, b, eps=1e-5, amp=True)
    got, again, want = fwd(), fwd(), plain()
    torch.cuda.synchronize()
    s_exact = torch.equal(got[1], want[1]) and got[1].dtype == torch.bfloat16
    err = max(float((g - w).abs().max()) for i, (g, w) in
              enumerate(zip(got, want)) if i != 1)
    bitwise = all(torch.equal(a, a2) for a, a2 in zip(got, again))
    ok = s_exact and err <= LN_AMP_TOL and bitwise and \
        got[0].dtype == torch.float32 and bool(torch.isfinite(got[0]).all())
    del got, again, want
    lib = lambda: F.layer_norm(  # noqa: E731
        torch.add(x.bfloat16(), r.bfloat16()).float(), (d,), sc, b, 1e-5)
    t = dict(ms=device_ms(fwd, ("ln_res_fwd",)), call_ms=time_ms(fwd),
             plain_ms=time_ms(plain), **_library_times(lib))
    t["bound_ms"], t["bound_by"] = _ln_amp_bound(n, d, x.dtype, r.dtype)
    t["roofline_share"] = t["bound_ms"] / t["ms"]
    log("tier %-16s %-12s x %s r %s: s bitwise %s, err y/mean/var %.2e | "
        "K4 AMP %.4f ms on the card, %.4f a call (plain %.4f; add + "
        "layer_norm %.4f on the card, %.4f a call; bound %.4f %s, %.1f%%; "
        "bitwise %s)%s" % (
            name, (n, d), x.dtype, r.dtype, s_exact, err, t["ms"],
            t["call_ms"], t["plain_ms"], t["library_ms"],
            t["library_call_ms"], t["bound_ms"], t["bound_by"],
            100 * t["roofline_share"], bitwise,
            "" if ok else "  <-- FAILED"))
    return dict(case=name, shape=[n, d], dtype="amp", r_dtype=str(r.dtype),
                s_bitwise=s_exact, max_abs_err=dict(fwd=err),
                fwd_bitwise=bitwise, tol=LN_AMP_TOL, fwd=t, ok=ok)


def _opt_amp_case(shapes, grad_bf16, gen, dev):
    """K6 and K7 over BERT-base's params with an AMP step's grads (bf16
    where ``grad_bf16``): against the plain version, two launches
    bitwise equal, and bitwise equal to the launch on the grads widened
    to f32; device and call time, the plain version's, the library's
    (each grad widened, then ``torch._fused_adam_`` / ``_foreach_add_``)
    and the bound of the real split of 2- and 4-byte grads."""
    from paddle_tpu_torch.kernels import optimizer_update as ou

    ins = _group_on_card(shapes, gen, dev)
    ins["Grad"] = [g.bfloat16() if bf else g
                   for g, bf in zip(ins["Grad"], grad_bf16)]
    widened = dict(ins, Grad=[g.float() for g in ins["Grad"]])
    n = sum(int(np.prod(s)) for s in shapes)
    n_bf16 = sum(int(np.prod(s)) for s, bf in zip(shapes, grad_bf16) if bf)
    k = len(shapes)
    errs, bitwise, same_as_f32, vector, bf16_entries = {}, {}, {}, {}, {}
    for kind, wrapper, fn, ref in (
            ("adam", ou.adam_group, lambda i: ou.adam_group(i, ADAM_HYPER),
             lambda: ou.adam_group_reference(ins, ADAM_HYPER)),
            ("sgd", ou.sgd_group, ou.sgd_group,
             lambda: ou.sgd_group_reference(ins))):
        v0, b0 = wrapper.vector_entries, wrapper.bf16_grad_entries
        got, again = fn(ins), fn(ins)
        vector[kind] = (wrapper.vector_entries - v0) // 2
        bf16_entries[kind] = (wrapper.bf16_grad_entries - b0) // 2
        wide, want = fn(widened), ref()
        torch.cuda.synchronize()
        errs[kind] = max(float((a - w).abs().max()) for slot in want
                         for a, w in zip(got[slot], want[slot]))
        bitwise[kind] = all(torch.equal(a, a2) for slot in got
                            for a, a2 in zip(got[slot], again[slot]))
        same_as_f32[kind] = all(torch.equal(a, a2) for slot in got
                                for a, a2 in zip(got[slot], wide[slot]))
        del got, again, wide, want
    ok = max(errs.values()) <= OPT_TOL and all(bitwise.values()) and \
        all(same_as_f32.values()) and \
        set(bf16_entries.values()) == {sum(grad_bf16)}
    adam = lambda: ou.adam_group(ins, ADAM_HYPER)  # noqa: E731
    sgd = lambda: ou.sgd_group(ins)  # noqa: E731
    t_adam = dict(ms=device_ms(adam, ("adam_group_kernel",)),
                  call_ms=time_ms(adam), plain_ms=time_ms(
                      lambda: ou.adam_group_reference(ins, ADAM_HYPER)))
    t_sgd = dict(ms=device_ms(sgd, ("sgd_group_kernel",)),
                 call_ms=time_ms(sgd),
                 plain_ms=time_ms(lambda: ou.sgd_group_reference(ins)))
    lib = {s: [t.clone() for t in ins[s]]
           for s in ("Param", "Moment1", "Moment2")}
    steps = [torch.full((), 3.0, device=dev) for _ in shapes]
    t_adam.update(_library_times(lambda: torch._fused_adam_(
        lib["Param"], [g.float() for g in ins["Grad"]], lib["Moment1"],
        lib["Moment2"], [], steps, lr=TRAIN_LR, beta1=0.9, beta2=0.999,
        weight_decay=0.0, eps=1e-8, amsgrad=False, maximize=False)))
    t_sgd.update(_library_times(lambda: torch._foreach_add_(
        lib["Param"], [g.float() for g in ins["Grad"]], alpha=-TRAIN_LR)))
    for t, (bound, by) in ((t_adam, _opt_bound(n, k, 7, 13, n_bf16)),
                           (t_sgd, _opt_bound(n, k, 3, 2, n_bf16))):
        t.update(bound_ms=bound, bound_by=by, roofline_share=bound / t["ms"])
    log("tier %-10s %d params (%d bf16 grads, %d of %d elements): err adam "
        "%.2e sgd %.2e; two launches bitwise equal %s; bitwise equal to "
        "the launch on f32-widened grads %s; entries on the vector path %s, "
        "with a bf16 grad %s | K6 %.4f ms on the card, %.4f a call (plain "
        "%.4f; widen + _fused_adam_ %.4f on the card, %.4f a call; bound "
        "%.4f %s, %.1f%%) | K7 %.4f ms on the card, %.4f a call (plain "
        "%.4f; widen + _foreach_add_ %.4f on the card, %.4f a call; bound "
        "%.4f %s, %.1f%%)%s" % (
            "bert_base_amp", k, sum(grad_bf16), n_bf16, n, errs["adam"],
            errs["sgd"], bitwise, same_as_f32, vector, bf16_entries,
            t_adam["ms"], t_adam["call_ms"], t_adam["plain_ms"],
            t_adam["library_ms"], t_adam["library_call_ms"],
            t_adam["bound_ms"], t_adam["bound_by"],
            100 * t_adam["roofline_share"], t_sgd["ms"], t_sgd["call_ms"],
            t_sgd["plain_ms"], t_sgd["library_ms"], t_sgd["library_call_ms"],
            t_sgd["bound_ms"], t_sgd["bound_by"],
            100 * t_sgd["roofline_share"], "" if ok else "  <-- FAILED"))
    del ins, widened, lib, steps
    torch.cuda.empty_cache()
    return dict(case="bert_base_amp", params=k, elements=n,
                bf16_grads=sum(grad_bf16), bf16_elements=n_bf16,
                max_abs_err=errs, bitwise_repeatable=bitwise,
                bitwise_equal_to_f32_grads=same_as_f32,
                vector_entries=vector, bf16_grad_entries=bf16_entries,
                tol=OPT_TOL, adam=t_adam, sgd=t_sgd, ok=ok)


# --------------------------------------------------------------- phase 3d
TUNE_SIGS = [(SEQ, SEQ), (128, 128)]  # the paths' length, a short one


def phase_tune():
    """The port's tuner on the card: the flash kernel against the
    composed attention at each of ``TUNE_SIGS``. The winners are then
    dropped: the paths below take flash by the static threshold."""
    from paddle_tpu_torch.kernels import tune

    out = []
    for sig in TUNE_SIGS:
        dec = tune.tune("attention", sig, {"scale": 0.125})
        out.append(dict(op="attention", sig=list(sig), pick=dec["choice"],
                        timings=dec["timings"]))
        log("tune attention %-12s %s -> tuner's pick %s" % (
            sig, ", ".join("%s %.4f ms" % (t["label"], t["seconds"] * 1e3)
                           for t in dec["timings"]), dec["choice"]))
    tune.reset()
    return out


# ---------------------------------------------------------------- phase 4
def _encoder_output(program):
    """The encoder output [B, S, d_model]: the X of the reshape2 that
    feeds the MLM head's gather (models/bert.py)."""
    blk = program.global_block()
    gather = next(op for op in blk.ops if op.type == "gather")
    flat = gather.input("X")[0]
    reshape = next(op for op in blk.ops
                   if op.type == "reshape2" and flat in op.output("Out"))
    return blk.var(reshape.input("X")[0])


def _request(batch, cfg, rs):
    mask = np.ones((batch, SEQ), "float32")
    for i in range(batch):  # 10-40% of each row is padding
        mask[i, SEQ - rs.randint(SEQ // 10, 2 * SEQ // 5 + 1):] = 0.0
    return {"src_ids": rs.randint(0, cfg["vocab"], (batch, SEQ)).astype(
                "int64"),
            "sent_ids": rs.randint(0, 2, (batch, SEQ)).astype("int64"),
            "input_mask": mask}


def _in_turns(fn, pairs):
    """``fn()`` at level 2 and at level 0 (``PADDLE_TPU_OPTIMIZE=0``), in
    turns, ``pairs`` times, alternating which level goes first: the
    results at level 2 and at level 0, each a list."""
    out = ([], [])
    for i in range(pairs):
        for level in ((2, 0) if i % 2 == 0 else (0, 2)):
            if level == 0:
                os.environ["PADDLE_TPU_OPTIMIZE"] = "0"
            try:
                out[level == 0].append(fn())
            finally:
                os.environ.pop("PADDLE_TPU_OPTIMIZE", None)
    return out


def _synced_ms(fn):
    """Host-clock ms of one call that ends in a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def _tier_stats(program, fetch_names, scope):
    """What the level-2 pipeline makes of ``program``: (ops before, ops
    after, fused layer norms, optimizer groups and their sizes)."""
    from paddle_tpu_torch.core.passes import optimize_program

    opt, stats = optimize_program(program, fetch_list=fetch_names,
                                  scope=scope, level=2)
    tier = next(r for r in stats if r["pass"] == "fuse_kernel_tier_pass")
    groups = [len(op.input("Param")) for op in opt.global_block().ops
              if op.type == "fused_optimizer_update"]
    return dict(ops_before=len(program.global_block().ops),
                ops_after=len(opt.global_block().ops),
                ln_residual_fused=tier["ln_residual_fused"],
                optimizer_groups=groups,
                passes=[{k: v for k, v in r.items() if k != "seconds"}
                        for r in stats])


def phase_serve(workdir, seed):
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import bert

    cfg = bert.base_config()
    feeds = ["src_ids", "sent_ids", "input_mask"]
    t0 = time.perf_counter()
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        bert.build(cfg, seq_len=SEQ, is_test=True)
    enc = _encoder_output(main)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(startup)
        fluid.io.save_inference_model(workdir, feeds, [enc], exe,
                                      main_program=main)
    n_params = sum(int(np.prod(p.shape))
                   for p in main.global_block().all_parameters())
    del scope, exe
    torch.cuda.empty_cache()
    log("serve: BERT-base %s built, started on the card and saved in "
        "%.1f s (%d parameters)" % (
            {k: cfg[k] for k in ("n_layer", "d_model", "n_head", "d_ff",
                                 "vocab")},
            time.perf_counter() - t0, n_params))

    config = fluid.inference.AnalysisConfig(workdir)
    config.warmup_batch_sizes = list(BUCKETS)
    rs = np.random.RandomState(seed)
    reqs = [_request(b, cfg, rs) for b in REQUESTS]

    # ---- the main path: counts zeroed here, read after the last request
    os.environ.pop("PADDLE_TPU_FLASH_MIN_SEQ", None)  # static threshold
    os.environ.pop("PADDLE_TPU_OPTIMIZE", None)  # level 2
    # one fused_attention per layer; one fused layer norm per layer's two
    # residual seams but the first, plus the embedding's and the last
    n = cfg["n_layer"]
    per_dispatch = (n, 0, 0, 2 * n + 1, 0, 0, 0, 0, 0, 0)
    answers, lat_ms = [], []

    def check(b, rep, out):
        if rep == 0:
            if out.shape != (b, SEQ, cfg["d_model"]) or \
                    not np.isfinite(out).all():
                raise AssertionError("batch %d: bad output %s finite=%s"
                                     % (b, out.shape, np.isfinite(out).all()))
            answers.append(out)
        elif not np.array_equal(out, answers[-1]):
            raise AssertionError("batch %d: a repeated request gave "
                                 "another answer" % b)

    pred, init_s, path = _metered_serving(
        "serve", lambda: fluid.inference.create_paddle_predictor(config),
        reqs, REPEATS, per_dispatch, lat_ms, check)
    launches, peak_mb = path["launches"], path["peak_mb"]
    # ---- end of the main path

    tier = _tier_stats(pred.program, pred.fetch_names, pred.scope)
    if tier["ln_residual_fused"] != per_dispatch[3]:
        raise AssertionError("the pipeline fused %d layer norms, expected "
                             "%d" % (tier["ln_residual_fused"],
                                     per_dispatch[3]))
    # the same requests through the composed attention (flash threshold
    # above S) and through level 0 (no pass pipeline, so no K4)
    diffs = {}
    for name, env, silent in (
            ("composed attention", ("PADDLE_TPU_FLASH_MIN_SEQ", "100000"), 0),
            ("level 0", ("PADDLE_TPU_OPTIMIZE", "0"), 3)):
        os.environ[env[0]] = env[1]
        try:
            diffs[name] = []
            with LaunchMeter() as meter:
                meter.mark()
                for req, out in zip(reqs, answers):
                    (ref,) = pred.run(req)
                    diffs[name].append(float(np.abs(out - ref).max()))
        finally:
            os.environ.pop(env[0], None)
        if meter.total()[silent]:
            raise AssertionError("the %s path launched the %s kernel" % (
                name, COUNT_NAMES[silent]))
    turns = {b: dict(zip(("level 2", "level 0"), _in_turns(
        lambda r=req: _synced_ms(lambda: pred.run(r)), REPEATS)))
        for b, req in zip(REQUESTS, reqs)}
    for i, (b, lat) in enumerate(zip(REQUESTS, lat_ms)):
        log("serve: batch %d (bucket %d) latency median %.3f ms, max %.3f "
            "ms over %d requests; max |flash - composed| = %.3e, max "
            "|level 2 - level 0| = %.3e; in turns, median level 2 %.3f ms, "
            "level 0 %.3f ms"
            % (b, pred.bucket_for(b) or b, float(np.median(lat)), max(lat),
               len(lat), diffs["composed attention"][i],
               diffs["level 0"][i], float(np.median(turns[b]["level 2"])),
               float(np.median(turns[b]["level 0"]))))
    log("serve: predictor init (per warm-up bucket an eager run, then a "
        "capture and its replay) %.2f s; program %d -> %d ops at level 2 (%d "
        "fused layer norms); launches %s = %s on the card on the main path "
        "(launch calls from the host %s); peak device memory %.1f MiB"
        % (init_s, tier["ops_before"], tier["ops_after"],
           tier["ln_residual_fused"], COUNT_NAMES, launches,
           path["host_launches"], peak_mb))
    worst = max(max(v) for v in diffs.values())
    if worst > SERVE_ATOL:
        raise AssertionError("serving answers differ by %.3e > %.0e: %s"
                             % (worst, SERVE_ATOL, diffs))
    return dict(requests=REQUESTS, buckets=BUCKETS, latency_ms=lat_ms,
                latency_in_turns_ms=turns, max_abs_diff=diffs, init_s=init_s,
                launches=dict(zip(COUNT_NAMES, launches)),
                host_launches=dict(zip(COUNT_NAMES, path["host_launches"])),
                per_dispatch=per_dispatch, peak_mem_mib=peak_mb,
                n_params=n_params,
                tier=tier), pred, reqs


# ---------------------------------------------------------------- phase 5
def _kernel_class(name):
    if "flash_fwd" in name:
        return "flash fwd"
    if "flash_dkv" in name or "flash_dq" in name:
        return "flash bwd"
    if "ln_res_" in name:
        return "layer norm (K4/K5)"
    if "adam_group" in name or "sgd_group" in name:
        return "optimizer (K6/K7)"
    # cuDNN's convolutions (forward, data and weight grads) before the
    # products: their kernels' names hold gemm / xmma too (a convolution
    # cuDNN hands to a cuBLAS product counts as matmul)
    if any(t in name.lower() for t in ("convolve", "conv2d", "fprop",
                                       "dgrad", "wgrad", "cudnn",
                                       "implicit_gemm")):
        return "conv"
    if any(t in name for t in ("gemm", "cutlass", "cublas", "xmma",
                               "nvjet")):
        return "matmul"
    if "multi_tensor_apply" in name and "Copy" in name:
        return "state copy"  # a replay's write-back (core/cuda_graph.py)
    if "copy_kernel" in name:
        return "casts and copies"
    return "other"


def _device_breakdown(events, wall_us):
    """Device busy time (union of kernel intervals) and device time by
    kernel class and by kernel, from one profiler window's events."""
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in events)
    busy, end = 0.0, None
    by_class, by_name = {}, {}
    for s0, s1, name in spans:
        d = s1 - s0
        by_class[_kernel_class(name)] = by_class.get(
            _kernel_class(name), 0.0) + d
        by_name[name] = by_name.get(name, 0.0) + d
        if end is None or s0 >= end:
            busy += d
            end = s1
        elif s1 > end:
            busy += s1 - end
            end = s1
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return dict(wall_ms=wall_us / 1e3, device_busy_ms=busy / 1e3,
                busy_share=busy / wall_us, kernels=len(spans),
                by_class_ms={k: v / 1e3 for k, v in by_class.items()},
                top_kernels_ms=[(n[:80], v / 1e3) for n, v in top])


def _log_breakdown(what, r):
    log("profile: %s wall %.3f ms, device busy %.3f ms (%.1f%%), %d kernels; "
        "%s" % (what, r["wall_ms"], r["device_busy_ms"],
                100 * r["busy_share"], r["kernels"],
                {k: round(v, 3) for k, v in r["by_class_ms"].items()}))
    for n, v in r["top_kernels_ms"]:
        log("  %8.3f ms  %s" % (v, n[:100]))


def _profiled(fn):
    """The device's work in one synchronized call (``device_events``)."""
    return _device_breakdown(*device_events(fn))


def _steady_profile(fn):
    """``_profiled`` over a loop of training steps, with its steady
    state on the device clock: ``step_ms``, the time from the K6 launch
    that ends the loop's second step to the one that ends its last, over
    the steps between, and ``steady_busy_share``, the device's busy
    share in that interval (the loop's start and drain left out)."""
    events, wall_us = device_events(fn)
    out = _device_breakdown(events, wall_us)
    marks = sorted(e.time_range.start for e in events
                   if "adam_group" in e.name)
    t0, t1 = marks[1], marks[-1]
    busy, end = 0.0, t0
    for s0, s1 in sorted((max(e.time_range.start, t0),
                          min(e.time_range.end, t1)) for e in events):
        if s1 <= end:
            continue
        busy += s1 - max(s0, end)
        end = s1
    out["step_ms"] = (t1 - t0) / (len(marks) - 2) / 1e3
    out["steady_busy_share"] = busy / (t1 - t0)
    return out


def phase_profile(pred, reqs):
    """One profiled request per batch size: the device's busy share and
    its time by kernel class and by kernel."""
    out = {}
    for req in reqs:
        b = req["src_ids"].shape[0]
        pred.run(req)
        torch.cuda.synchronize()
        out[b] = _profiled(lambda: pred.run(req))
        _log_breakdown("batch %d" % b, out[b])
    return out


# --------------------------------------------------------------- phase 4c
def _pred_eager(pred, req):
    """``pred.run(req)`` through the plan's eager step (the same bucket
    routing), never its CUDA graph."""
    from paddle_tpu_torch.inference import batch_major

    feed, n_rows = pred._route_bucket(pred._as_feed(req))
    outs = pred._exe._run_eager(pred.program, feed=feed,
                                fetch_list=pred.fetch_names,
                                scope=pred.scope)
    if n_rows is not None:
        outs = [o[:n_rows] if batch_major(v) else o
                for v, o in zip(pred.fetch_vars, outs)]
    return outs


def _captured(exe):
    """The plans of ``exe`` that hold a captured CUDA graph."""
    return [p for p in exe._cache.values() if p.graph is not None]


def _request_plan(pred, req):
    """The Predictor's cached plan that serves ``req`` (its bucket's)."""
    from paddle_tpu_torch.core.executor import _cache_key, feed_to_device

    feed, _ = pred._route_bucket(pred._as_feed(req))
    block = pred.program.global_block()
    feeds = {n: feed_to_device(n, v, block.vars.get(n), pred._exe.device)
             for n, v in feed.items()}
    return pred._exe._cache[_cache_key(pred.program, feeds,
                                       pred.fetch_names)]


def _pool_mib(plan):
    """MiB of device memory in the pool of ``plan``'s CUDA graph, which
    every graph of its executor shares: the caching allocator's segments
    of that pool; None where the allocator's snapshot does not name
    segments' pools."""
    pid = tuple(plan.graph.graph.pool())
    segs = torch.cuda.memory._snapshot()["segments"]
    if not segs or "segment_pool_id" not in segs[0]:
        return None
    return sum(seg["total_size"] for seg in segs
               if tuple(seg["segment_pool_id"]) == pid) / 2 ** 20


def _timed(fn):
    """(host-clock ms of ``fn()`` ended by a synchronize, its value)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    val = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, val


def phase_compiled_serve(what, pred, reqs, per_dispatch):
    """Phase 4c: each request replayed (its bucket's CUDA graph, captured
    at load) against the plan's eager step, in turns: latency, the busy
    share of a profiled request of each, answers bitwise equal, the
    launches the card ran in a replay equal to an eager step's and to
    ``per_dispatch`` (the launch meter: a profiler window of the device
    activity alone); each graph's capture seconds
    and the graphs' one memory pool."""
    rows, capture = [], []
    for req in reqs:
        b = int(req["src_ids"].shape[0])
        plan = _request_plan(pred, req)
        if plan.graph is None or plan.compiled_sigs != {"run"}:
            raise AssertionError("serve %s batch %d: its bucket's plan was "
                                 "not captured at load" % (what, b))
        capture.append(dict(bucket=pred.bucket_for(b) or b,
                            capture_s=plan.graph.seconds,
                            pool_mib=_pool_mib(plan)))
        (replayed,) = pred.run(req)
        (eager,) = _pred_eager(pred, req)
        if not np.array_equal(replayed, eager):
            raise AssertionError("serve %s batch %d: the replayed answer is "
                                 "not the eager step's (max |diff| %.3e)" % (
                                     what, b, float(np.abs(
                                         replayed.astype(np.float64)
                                         - eager).max())))
        turns = ([], [])
        for i in range(COMPILED_PAIRS):
            for eager_turn in ((False, True) if i % 2 == 0
                               else (True, False)):
                fn = (lambda r=req: _pred_eager(pred, r)) if eager_turn \
                    else (lambda r=req: pred.run(r))
                ms, (out,) = _timed(fn)
                if not np.array_equal(out, replayed):
                    raise AssertionError("serve %s batch %d: another answer "
                                         "in turns" % (what, b))
                turns[eager_turn].append(ms)
        prof_r = _profiled(lambda r=req: pred.run(r))
        prof_e = _profiled(lambda r=req: _pred_eager(pred, r))
        got = (_metered_launches(lambda r=req: pred.run(r)),
               _metered_launches(lambda r=req: _pred_eager(pred, r)))
        if not got[0] == got[1] == per_dispatch:
            raise AssertionError("serve %s batch %d: the card ran %s = %s "
                                 "kernels in a replay, %s in the eager step, "
                                 "expected %s" % (
                                     what, b, COUNT_NAMES, got[0], got[1],
                                     per_dispatch))
        row = dict(batch=b, bucket=pred.bucket_for(b) or b,
                   replay_ms=turns[0], eager_ms=turns[1],
                   replay_median_ms=float(np.median(turns[0])),
                   eager_median_ms=float(np.median(turns[1])),
                   replay_profile=prof_r, eager_profile=prof_e,
                   launches=dict(zip(COUNT_NAMES, got[0])))
        rows.append(row)
        log("serve %s (4c): batch %d (bucket %d), in turns over %d pairs: "
            "replayed median %.3f ms, eager %.3f ms; device busy %.3f ms of "
            "%.3f (%.1f%%) replayed, %.3f of %.3f (%.1f%%) eager; answers "
            "bitwise equal" % (
                what, b, row["bucket"], COMPILED_PAIRS,
                row["replay_median_ms"], row["eager_median_ms"],
                prof_r["device_busy_ms"], prof_r["wall_ms"],
                100 * prof_r["busy_share"], prof_e["device_busy_ms"],
                prof_e["wall_ms"], 100 * prof_e["busy_share"]))
    pool, n_graphs = capture[-1]["pool_mib"], len(_captured(pred._exe))
    log("serve %s (4c): graphs captured at load, per bucket: %s; the "
        "executor's %d graphs (phase 4's level 0 buckets too) in one pool "
        "of %s MiB; device memory reserved %.1f MiB; launches on the card "
        "in a replay equal the eager step's" % (
            what, "; ".join("%d: %.3f s" % (c["bucket"], c["capture_s"])
                            for c in capture), n_graphs,
            "%.1f" % pool if pool is not None else "not measured",
            torch.cuda.memory_reserved() / 2 ** 20))
    return dict(pairs=COMPILED_PAIRS, requests=rows, graphs=capture,
                graphs_in_pool=n_graphs,
                reserved_mib=torch.cuda.memory_reserved() / 2 ** 20)


# --------------------------------------------------------------- phase 6c
def _replay_turns(what, exe, snap, batches, params, step, pairs):
    """From ``snap``, replayed steps (the first captures the plan anew on
    its own scope) against the plan's eager step on a second scope, in
    turns over ``pairs`` steps after the first: what ``step`` returns
    and the final params bitwise equal. Returns both scopes, the plan,
    its capture seconds, the first step's ms, the (replayed, eager)
    results and each side's step ms."""
    scope_r, scope_e = _restored(snap), _restored(snap)
    ms_first, first = _timed(lambda: step(scope_r, batches[0]))
    plan = next((p for p in _captured(exe) if p.graph.bound_to(scope_r)),
                None)
    if plan is None:
        raise AssertionError("%s: the plan was not captured" % what)
    _, first_e = _timed(lambda: step(scope_e, batches[0], eager=True))
    losses = [(first, first_e)]
    turns = ([], [])
    for i in range(1, pairs + 1):
        batch = batches[i % len(batches)]
        pair = {}
        for eager in ((False, True) if i % 2 else (True, False)):
            ms, pair[eager] = _timed(lambda e=eager: step(
                scope_e if e else scope_r, batch, eager=e))
            turns[eager].append(ms)
        losses.append((pair[False], pair[True]))
    same_loss = all(a == b for a, b in losses)
    same_params = all(torch.equal(scope_r.find_var(n), scope_e.find_var(n))
                      for n in params)
    if not (same_loss and same_params):
        raise AssertionError("%s: replayed steps differ from the eager "
                             "step: losses %s, params equal %s" % (
                                 what, losses, same_params))
    return dict(scope_r=scope_r, scope_e=scope_e, plan=plan,
                capture_s=plan.graph.seconds, ms_first=ms_first,
                losses=losses, turns=turns)


def phase_compiled_train(what, exe, main, loss, snap, batches, params,
                         step, per_step, tokens=TRAIN_BATCH * SEQ,
                         pairs=TRAIN_COMPILED_PAIRS, unit="tokens",
                         eager_readings=True):
    """Phase 6c: from ``snap``, replayed steps (the first captures the
    plan anew on its own scope) against the plan's eager step on a
    second scope, in turns: losses and final params bitwise equal, step
    medians, tokens/s, profiled busy shares, the launches the card ran
    in a replayed step equal to an eager step's (the launch meter) and to
    ``per_step``, capture seconds, the state copy's device time, peak
    memory and the executor's graph pool. ``tokens`` a step (``unit``:
    tokens, or an image model's images), ``pairs`` after the first
    (BERT's by default). Without ``eager_readings`` the eager step is
    neither profiled, metered nor measured for its peak (the main path
    has metered an eager step already)."""
    t = _replay_turns("train %s (6c)" % what, exe, snap, batches, params,
                      step, pairs)
    scope_r, scope_e, plan = t["scope_r"], t["scope_e"], t["plan"]
    capture_s, ms_first, losses, turns = (t[k] for k in (
        "capture_s", "ms_first", "losses", "turns"))
    prof_r = _profiled(lambda: step(scope_r, batches[1]))
    prof_e = (_profiled(lambda: step(scope_e, batches[1], eager=True))
              if eager_readings else None)
    got = (_metered_launches(lambda: step(scope_r, batches[1])),
           _metered_launches(lambda: step(scope_e, batches[1], eager=True))
           if eager_readings else per_step)
    if not got[0] == got[1] == per_step:
        raise AssertionError("train %s (6c): the card ran %s = %s kernels "
                             "in a replayed step, %s in the eager step, "
                             "expected %s" % (what, COUNT_NAMES, got[0],
                                              got[1], per_step))
    peaks = []
    for eager in (False, True)[:1 + eager_readings]:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step(scope_e if eager else scope_r, batches[2], eager=eager)
        peaks.append(torch.cuda.max_memory_allocated() / 2 ** 20)
    pool, n_graphs = _pool_mib(plan), len(_captured(exe))
    med_r, med_e = (float(np.median(t)) for t in turns)
    out = dict(
        pairs=pairs, capture_s=capture_s,
        capture_step_ms=ms_first, losses=losses,
        replay_ms=turns[0], eager_ms=turns[1], replay_median_ms=med_r,
        eager_median_ms=med_e,
        replay_tokens_per_s=tokens / (med_r / 1e3),
        eager_tokens_per_s=tokens / (med_e / 1e3),
        replay_profile=prof_r, eager_profile=prof_e,
        state_copy_ms=prof_r["by_class_ms"].get("state copy", 0.0),
        peak_mem_mib=dict(zip(("replay", "eager"), peaks)), pool_mib=pool,
        graphs_in_pool=n_graphs, unit=unit)
    _log_breakdown("%s replayed train step (6c)" % what, prof_r)
    log("train %s (6c): capture %.3f s (its step %.1f ms); in turns over %d "
        "pairs: replayed median %.3f ms (%.1f %s/s), eager %.3f ms "
        "(%.1f %s/s); device busy %.1f%% replayed, %s eager; state "
        "copy %.4f ms a replayed step; peak memory %.1f MiB replayed, %s "
        "eager; the executor's %d graphs (phase 6's other paths too) in one "
        "pool of %s MiB; %d losses and %d params bitwise equal; launches on "
        "the card equal the eager step's"
        % (what, capture_s, ms_first, pairs, med_r,
           out["replay_tokens_per_s"], unit, med_e,
           out["eager_tokens_per_s"], unit,
           100 * prof_r["busy_share"],
           "%.1f%%" % (100 * prof_e["busy_share"]) if eager_readings
           else "not read", out["state_copy_ms"], peaks[0],
           "%.1f MiB" % peaks[1] if eager_readings else "not read",
           n_graphs,
           "%.1f" % pool if pool is not None else "not measured",
           len(losses), len(params)))
    return out


# --------------------------------------------------------------- phase 6d
def phase_shared_pool(main, loss, snap, batches, params, compiled):
    """Phase 6d: three training plans of one new executor (two fetch lists
    at batch TRAIN_BATCH, one at half the batch) run in turns on one
    scope for PLAN_ROUNDS rounds, each run against the plan's eager step
    on a second scope: losses, fetches and final params bitwise equal,
    the one memory pool the three graphs share against the one plan of
    phase 6c, the state the switches copy in, a round's peak memory and
    the replayed steps' times."""
    import paddle_tpu_torch as fluid

    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope_r, scope_e = _restored(snap), _restored(snap)
    half = {k: v[:TRAIN_BATCH // 2] for k, v in batches[2].items()}
    runs = [("loss", batches[0], [loss]),
            ("loss + a bias", batches[1], [loss, params[-1]]),
            ("loss, half batch", half, [loss])]
    ms = {name: [] for name, _, _ in runs}
    for r in range(PLAN_ROUNDS):
        for name, feed, fetch in runs:
            t, got = _timed(lambda: exe.run(main, feed=feed,
                                            fetch_list=fetch, scope=scope_r))
            if r >= 2:
                ms[name].append(t)
            want = exe._run_eager(main, feed=feed, fetch_list=fetch,
                                  scope=scope_e)
            if not all(np.array_equal(a, b) for a, b in zip(got, want)):
                raise AssertionError("6d: round %d, %s: a replay differs "
                                     "from the eager step" % (r, name))
    if not all(torch.equal(scope_r.find_var(n), scope_e.find_var(n))
               for n in params):
        raise AssertionError("6d: params differ from the eager steps'")
    plans = _captured(exe)
    pools = {tuple(p.graph.graph.pool()) for p in plans}
    adopted = sum(p.graph.adopted for p in plans)
    if len(plans) != len(runs) or len(pools) != 1 or adopted:
        raise AssertionError("6d: %d graphs in %d pools copied %d vars in, "
                             "expected %d graphs in one pool and none"
                             % (len(plans), len(pools), adopted, len(runs)))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for name, feed, fetch in runs:
        exe.run(main, feed=feed, fetch_list=fetch, scope=scope_r)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    pool = _pool_mib(plans[0])
    out = dict(rounds=PLAN_ROUNDS, plans=[n for n, _, _ in runs],
               capture_s=[p.graph.seconds for p in plans],
               replay_ms=ms, pool_mib=pool,
               one_plan_pool_mib=compiled["pool_mib"],
               round_peak_mib=peak, adopted=adopted)
    log("train f32 (6d): %d plans of one executor in turns over %d rounds, "
        "bitwise the eager steps; captures %s s; replayed medians %s ms; "
        "one pool of %s MiB (phase 6c's executor: %s MiB); peak memory of "
        "a round of replays %.1f MiB; %d vars copied in on switching" % (
            len(plans), PLAN_ROUNDS,
            ["%.3f" % p.graph.seconds for p in plans],
            {k: "%.3f" % float(np.median(v)) for k, v in ms.items()},
            "%.1f" % pool if pool is not None else "not measured",
            "%.1f" % compiled["pool_mib"]
            if compiled["pool_mib"] is not None else "not measured",
            peak, adopted))
    exe.close()
    return out


# ---------------------------------------------------------------- phase 6
def _train_batch(cfg, rs):
    """One synthetic MLM batch: 10-40% padding per row; 15% of the real
    tokens masked (capped at MAX_MASK), their ids replaced by [MASK]
    (103) and kept as labels; unused mask slots point at position 0 with
    weight 0."""
    src = rs.randint(0, cfg["vocab"], (TRAIN_BATCH, SEQ)).astype("int64")
    mask = np.ones((TRAIN_BATCH, SEQ), "float32")
    pos = np.zeros((TRAIN_BATCH, MAX_MASK), "int64")
    label = np.zeros((TRAIN_BATCH, MAX_MASK), "int64")
    weight = np.zeros((TRAIN_BATCH, MAX_MASK), "float32")
    for i in range(TRAIN_BATCH):
        real = SEQ - rs.randint(SEQ // 10, 2 * SEQ // 5 + 1)
        mask[i, real:] = 0.0
        n = min(MAX_MASK, int(round(0.15 * real)))
        picks = rs.choice(real, n, replace=False)
        pos[i, :n] = i * SEQ + picks
        label[i, :n] = src[i, picks]
        weight[i, :n] = 1.0
        src[i, picks] = min(103, cfg["vocab"] - 1)
    return {"src_ids": src,
            "sent_ids": rs.randint(0, 2, (TRAIN_BATCH, SEQ)).astype("int64"),
            "input_mask": mask, "mask_pos": pos, "mask_label": label,
            "mask_weight": weight}


def _copied(v):
    return v.clone() if isinstance(v, torch.Tensor) else v


def _snapshot(scope):
    """Copies of the scope's values by name: a replayed step updates the
    scope's state tensors in place (the RNG chain's generator is
    replaced, never advanced, so it is kept as it is)."""
    return {n: _copied(scope.find_var(n)) for n in scope.local_var_names()}


def _restored(snap):
    """A new scope of copies of a snapshot's values."""
    import paddle_tpu_torch as fluid

    scope = fluid.Scope()
    for n, v in snap.items():
        scope.set_var(n, _copied(v))
    return scope


def _op_class(op_type):
    from paddle_tpu_torch.core.registry import get_op

    if op_type in ("adam", "sgd", "momentum", "fused_optimizer_update"):
        return "optimizer"
    if not op_type.endswith("_grad"):
        return "forward"
    if get_op(op_type[:-len("_grad")]).grad_lowering is not None:
        return "grad (custom)"
    return "grad (generic vjp)"


def _host_by_class(run_step):
    """The host's time in each op lowering during one step, by class: a
    wrapper times ``core.lowering.lower_op`` without synchronizing, so
    each number is the time the host spends issuing that op's work.
    Returns (wall ms, {class: (ops, ms)})."""
    from paddle_tpu_torch.core import lowering

    by = {}
    orig = lowering.lower_op

    def timed(ctx, op, env):
        t = time.perf_counter()
        orig(ctx, op, env)
        n, ms = by.get(_op_class(op.type), (0, 0.0))
        by[_op_class(op.type)] = (n + 1, ms + (time.perf_counter() - t) * 1e3)

    lowering.lower_op = timed
    try:
        t0 = time.perf_counter()
        run_step()
        wall = (time.perf_counter() - t0) * 1e3
    finally:
        lowering.lower_op = orig
    return wall, by


def _host_breakdown(samples, what):
    """The median over steps of ``_host_by_class`` samples, per class."""
    wall = float(np.median([w for w, _ in samples]))
    out = {k: dict(ops=n, host_ms=float(np.median(
        [by[k][1] for _, by in samples])))
        for k, (n, _) in sorted(samples[0][1].items())}
    for v in out.values():
        v["ms_per_op"] = v["host_ms"] / v["ops"]
    log("train: host time by op class at %s, median of %d steps (wall %.3f "
        "ms): %s" % (what, len(samples), wall, "; ".join(
            "%s %d ops %.3f ms (%.4f ms/op)"
            % (k, v["ops"], v["host_ms"], v["ms_per_op"])
            for k, v in out.items())))
    return dict(wall_ms=wall, steps=len(samples), by_class=out)


def _kernel_counts():
    """The launch counters of every kernel a training step or a serving
    dispatch runs, as (wrapper, attribute): flash fwd, dK/dV, dQ (all
    launches, then the bf16 instantiations' alone), K4, K6, K7 and K4's
    AMP instantiation."""
    from paddle_tpu_torch.kernels import layernorm as ln
    from paddle_tpu_torch.kernels import optimizer_update as ou
    from paddle_tpu_torch.ops import attention as attn

    flash = (attn.flash_attention_fwd, attn.flash_attention_dkv,
             attn.flash_attention_dq)
    return ([(w, "launches") for w in flash]
            + [(ln.layernorm_residual_fwd, "launches"),
               (ou.adam_group, "launches"), (ou.sgd_group, "launches")]
            + [(w, "bf16_launches") for w in flash]
            + [(ln.layernorm_residual_fwd_amp, "launches")])


def _counts():
    return tuple(getattr(w, a) for w, a in _kernel_counts())


def _zero_counts():
    for w, a in _kernel_counts():
        setattr(w, a, 0)


COUNT_NAMES = ("flash fwd", "flash dkv", "flash dq", "K4", "K6", "K7",
               "flash fwd bf16", "flash dkv bf16", "flash dq bf16",
               "K4 AMP")
def _device_counts():
    """Every ``COUNT_NAMES`` kernel's launches the card has run so far, as
    the kernels count themselves on the device (``build.device_launches``:
    a CUDA graph's replays included), once the card has finished."""
    from paddle_tpu_torch.kernels import build

    torch.cuda.synchronize()
    fwd = build.device_launches("flash_attention_fwd", 2)
    bwd = build.device_launches("flash_attention_bwd", 4)
    ln = build.device_launches("layernorm_residual", 2)
    opt = build.device_launches("optimizer_update", 2)
    return (fwd[0] + fwd[1], bwd[0] + bwd[2], bwd[1] + bwd[3], ln[0],
            opt[0], opt[1], fwd[1], bwd[2], bwd[3], ln[1])


def _times(counts, k):
    return tuple(k * c for c in counts)


class LaunchMeter:
    """The main path's kernel launches, measured on the card: each kernel
    counts its own launches on the device (``_device_counts``), launched
    eagerly or by a CUDA graph's replay. ``mark()`` starts the next unit
    of the window; after the window ``units`` holds each unit's counts,
    in order. The wrappers' own counters (``_counts``) see only the
    launch calls the host makes: an eager step's and a capture's."""

    def __enter__(self):
        self._reads = []
        return self

    def mark(self):
        self._reads.append(_device_counts())

    def __exit__(self, *exc):
        if exc[0] is None:
            self._reads.append(_device_counts())
            self.units = [tuple(b - a for a, b in zip(r0, r1))
                          for r0, r1 in zip(self._reads, self._reads[1:])]
        return False

    def total(self):
        return tuple(int(v) for v in np.sum(self.units, axis=0))


def _metered_launches(fn):
    """The launches the card runs in ``fn()``, by the launch meter."""
    with LaunchMeter() as meter:
        meter.mark()
        fn()
    return meter.units[0]


def _metered_steps(what, step, scope, batches, n_steps, per_step,
                   host_extra=lambda: 0, after=None):
    """A training phase's main path: ``n_steps`` steps on ``scope``
    under the launch meter, the wrappers' counts zeroed just before, and
    then ``after()`` where given (its launches in the totals). Every
    step runs ``per_step`` launches on the card (the first eagerly, the
    second captures the plan and replays it, the rest replay); the
    wrappers count the launch calls of the eager step and of the capture
    and no other. Returns the losses, step times, each step's device
    launches, the device and host totals, the per-step deltas of
    ``host_extra()``, what ``after()`` returned, and the peak memory
    (the most allocated; ``base_mb``, what was allocated when the path
    began: its weights and whatever earlier phases still hold;
    ``rise_mb``, the peak above it)."""
    _zero_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mb = torch.cuda.memory_allocated() / 2 ** 20
    losses, step_ms, host, extra = [], [], [], []
    with LaunchMeter() as meter:
        for i in range(n_steps):
            meter.mark()
            before, x0 = _counts(), host_extra()
            t1 = time.perf_counter()
            losses.append(step(scope, batches[i % len(batches)]))
            step_ms.append((time.perf_counter() - t1) * 1e3)
            host.append(tuple(a - b for a, b in zip(_counts(), before)))
            extra.append(host_extra() - x0)
        if after is not None:
            meter.mark()
            after_out = after()
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    for i, (dev, h) in enumerate(zip(meter.units, host)):
        if dev != per_step:
            raise AssertionError("%s step %d ran %s = %s kernels on the "
                                 "card, expected %s" % (
                                     what, i, COUNT_NAMES, dev, per_step))
        if h != (per_step if i < 2 else _times(per_step, 0)):
            raise AssertionError("%s step %d: the wrappers counted %s = %s "
                                 "launch calls (the eager step and the "
                                 "capture call %s, a replay none)" % (
                                     what, i, COUNT_NAMES, h, per_step))
    if not np.isfinite(losses).all():
        raise AssertionError("%s: losses %s are not all finite"
                             % (what, losses))
    return dict(losses=losses, step_ms=step_ms, device_by_step=meter.units,
                launches=meter.total(), host_launches=_counts(),
                host_extra=extra, peak_mb=peak_mb, base_mb=base_mb,
                rise_mb=peak_mb - base_mb,
                after=after_out if after is not None else None)


def _metered_serving(what, make_pred, reqs, repeats, per_dispatch, lat_ms,
                     check, buckets=BUCKETS, batch_feed="src_ids"):
    """A serving phase's main path under the launch meter, the wrappers'
    counts zeroed just before: the Predictor made by ``make_pred()``
    warms each of ``buckets`` up (an eager run, then a capture and its
    replay), then answers each request ``repeats`` times (``check(batch,
    repeat, answer)``, latencies into ``lat_ms``; a request's batch is
    its ``batch_feed``'s rows). The warm-up runs 2 dispatches' launches
    per bucket on the card and calls as many from the host; each request
    runs one dispatch's (``per_dispatch``) on the card and calls none
    from the host: it is a replay. Returns the Predictor, its seconds to
    start and the launches."""
    _zero_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with LaunchMeter() as meter:
        meter.mark()
        t0 = time.perf_counter()
        pred = make_pred()
        init_s = time.perf_counter() - t0
        host_warm = _counts()
        for req in reqs:
            b = int(req[batch_feed].shape[0])
            lat_ms.append([])
            for rep in range(repeats):
                meter.mark()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                (out,) = pred.run(req)
                torch.cuda.synchronize()
                lat_ms[-1].append((time.perf_counter() - t0) * 1e3)
                check(b, rep, out)
    warm = _times(per_dispatch, 2 * len(buckets))
    if (meter.units[0], host_warm) != (warm, warm):
        raise AssertionError("%s: the warm-up ran %s = %s kernels on the "
                             "card and called %s from the host, expected %s"
                             % (what, COUNT_NAMES, meter.units[0], host_warm,
                                warm))
    bad = [u for u in meter.units[1:] if u != per_dispatch]
    if bad or _counts() != host_warm:
        raise AssertionError("%s: requests ran %s = %s kernels on the card "
                             "(expected %s each) and called %s from the "
                             "host (expected none)" % (
                                 what, COUNT_NAMES, bad[:1], per_dispatch,
                                 tuple(a - b for a, b in zip(_counts(),
                                                             host_warm))))
    return pred, init_s, dict(launches=meter.total(),
                              host_launches=_counts(),
                              peak_mb=torch.cuda.max_memory_allocated()
                              / 2 ** 20)


def _check_bf16_grads(what, exe, scope, path, want):
    """Each AMP step's group update takes ``want`` bf16 grads: as the
    wrapper counted them in the eager step and the capture, and in the
    table the plan's graph keeps, which every replay reads."""
    n_tables, _, _, bf16 = _kept_table(exe, scope)
    if path["host_extra"][:2] != [want, want] or (n_tables, bf16) != (
            1, want):
        raise AssertionError("%s: the group update took %s bf16 grads in "
                             "the eager step and the capture, %d in the "
                             "%d kept table(s), expected %d" % (
                                 what, path["host_extra"][:2], bf16,
                                 n_tables, want))


def _kept_table(exe, scope):
    """The optimizer table the plan's graph on ``scope`` keeps on the card
    and every replay reads, read back: (the number of tables, its rows,
    its entries on the 16-byte path, its bf16 grads; ``table_rows``'
    last two columns)."""
    plan = next(p for p in _captured(exe) if p.graph.bound_to(scope))
    tables = plan.graph.tables
    t = tables[0].cpu()
    return len(tables), int(t.shape[0]), int(t[:, -2].sum()), \
        int(t[:, -1].sum())


def _grad_parity(flash, composed):
    """Each param's grad on one path against another's: the worst l2
    relative difference (the gate) and the worst relative difference of
    the largest element, each as (param, value)."""
    l2, top = ("", 0.0), ("", 0.0)
    for n, c in composed.items():
        d = flash[n] - c
        r2 = float(np.linalg.norm(d) / max(np.linalg.norm(c), 1e-30))
        rt = float(np.abs(d).max() / max(np.abs(c).max(), 1e-30))
        l2 = max(l2, (n, r2), key=lambda t: t[1])
        top = max(top, (n, rt), key=lambda t: t[1])
    return l2, top


def _train_setup(opt, seed, amp=False):
    """BERT-base MLM with ``opt`` (under bf16 AMP with ``amp``), started
    on the card: (exe, scope, main, loss, params, grads name -> param,
    batches, the level-2 stats)."""
    import paddle_tpu_torch as fluid

    main, startup, loss, params_grads = _bert_train_program(opt, amp)
    main.random_seed = startup.random_seed = seed
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    params = [p.name for p in main.global_block().all_parameters()]
    grads = {g.name: p.name for p, g in params_grads}
    rs = np.random.RandomState(seed)
    batches = [_train_batch(bert_cfg(), rs) for _ in range(4)]
    tier = _tier_stats(main, [loss.name], scope)
    return exe, scope, main, loss, params, grads, batches, tier


def bert_cfg():
    from paddle_tpu_torch.models import bert

    return bert.base_config()


def _run_paths(step, snap, batches, params, grads, paths):
    """From one scope snapshot, PARITY_STEPS steps on each path (name ->
    env settings, and which kernel counts must not move): the losses,
    the first step's grads and the final params of each path."""
    out = {}
    for name, (env, silent) in paths.items():
        for k, v in env.items():
            os.environ[k] = v
        try:
            sc = _restored(snap)
            before = _counts()
            first, gvals = (step(sc, batches[0], list(grads)) if grads
                            else (step(sc, batches[0]), []))
            ls = [first] + [step(sc, batches[i % len(batches)])
                            for i in range(1, PARITY_STEPS)]
        finally:
            for k in env:
                os.environ.pop(k, None)
        moved = [COUNT_NAMES[i] for i in silent
                 if _counts()[i] != before[i]]
        if moved:
            raise AssertionError("the %s path launched %s" % (name, moved))
        ps = {n: sc.find_var(n) for n in params}
        finite = np.isfinite(ls).all() and all(
            np.isfinite(v).all() for v in gvals) and all(
            bool(torch.isfinite(v).all()) for v in ps.values())
        if not finite:
            raise AssertionError("the %s path gave a value that is not "
                                 "finite" % name)
        out[name] = (ls, dict(zip(grads.values(), gvals)), ps)
    return out


def _parity(a, b, params, before=None):
    """Path a against path b (``_run_paths``' values): the grad l2 and
    top readings, the losses' relative difference, the params' max
    |diff|, the share of all param elements whose |diff| passes
    PARITY_PARAM_ATOL and the worst param's share as (param, share),
    and, given the params ``before`` the steps, the worst param's update
    l2 difference (``_update_l2``)."""
    loss_rel = max(abs(x - y) / abs(y) for x, y in zip(a[0], b[0]))
    grad_l2, grad_top = _grad_parity(a[1], b[1])
    over = {n: int(((a[2][n] - b[2][n]).abs() > PARITY_PARAM_ATOL).sum())
            for n in params}
    worst = max(params, key=lambda n: over[n] / a[2][n].numel())
    out = dict(grad_l2_rel=grad_l2, grad_max_rel=grad_top,
               loss_rel=loss_rel,
               param_max_abs=max(float((a[2][n] - b[2][n]).abs().max())
                                 for n in params),
               param_share_over_atol=sum(over.values()) / sum(
                   a[2][n].numel() for n in params),
               param_worst_share=(worst, over[worst] / a[2][worst].numel()))
    if before is not None:
        out["update_l2_rel"] = _update_l2(a[2], b[2], before, params)
    return out


def _check_parity(what, p):
    log("train: %s: param grads worst l2 rel diff %.3e (%s, <= %.0e), "
        "worst max-element rel diff %.3e (%s); over %d steps loss rel diff "
        "%.3e (<= %.0e), param max |diff| %.3e (<= %.0e)" % (
            what, p["grad_l2_rel"][1], p["grad_l2_rel"][0], PARITY_GRAD_L2,
            p["grad_max_rel"][1], p["grad_max_rel"][0], PARITY_STEPS,
            p["loss_rel"], PARITY_LOSS_RTOL, p["param_max_abs"],
            PARITY_PARAM_ATOL))
    if p["grad_l2_rel"][1] > PARITY_GRAD_L2 or \
            p["loss_rel"] > PARITY_LOSS_RTOL or \
            p["param_max_abs"] > PARITY_PARAM_ATOL:
        raise AssertionError("training disagrees: %s" % what)


def _check_flip_parity(what, p):
    """Phases 8 and 9 (f32): phase 6's grad and loss bounds, each param's
    share of elements past PARITY_PARAM_ATOL and its update's l2
    difference."""
    log("%s: main path vs level 0: param grads worst l2 rel diff %.3e (%s, "
        "<= %.0e); over %d steps loss rel diff %.3e (<= %.0e), param max "
        "|diff| %.3e, elements past %.0e: %.3e of all, worst %.3e (%s, <= "
        "%.0e); param update worst l2 rel diff %.3e (%s, <= %.2g)" % (
            what, p["grad_l2_rel"][1], p["grad_l2_rel"][0], PARITY_GRAD_L2,
            PARITY_STEPS, p["loss_rel"], PARITY_LOSS_RTOL,
            p["param_max_abs"], PARITY_PARAM_ATOL,
            p["param_share_over_atol"], p["param_worst_share"][1],
            p["param_worst_share"][0], PARITY_FLIP_SHARE,
            p["update_l2_rel"][1], p["update_l2_rel"][0], PARITY_UPDATE_L2))
    if p["grad_l2_rel"][1] > PARITY_GRAD_L2 or \
            p["loss_rel"] > PARITY_LOSS_RTOL or \
            p["param_worst_share"][1] > PARITY_FLIP_SHARE or \
            p["update_l2_rel"][1] > PARITY_UPDATE_L2:
        raise AssertionError("%s: level 2 and level 0 disagree" % what)


def _check_amp_parity(what, p):
    """Two paths under bf16 AMP: the first step's grads, the losses and
    each param's update within the ``AMP_PARITY_*`` bounds."""
    log("%s: param grads worst l2 rel diff %.3e (%s, <= %.3g); over %d "
        "steps loss rel diff %.3e (<= %.3g), param update worst l2 rel "
        "diff %.3e (%s, <= %.3g)" % (
            what, p["grad_l2_rel"][1], p["grad_l2_rel"][0],
            AMP_PARITY_GRAD_L2, PARITY_STEPS, p["loss_rel"],
            AMP_PARITY_LOSS_RTOL, p["update_l2_rel"][1],
            p["update_l2_rel"][0], AMP_PARITY_UPDATE_L2))
    if p["grad_l2_rel"][1] > AMP_PARITY_GRAD_L2 or \
            p["loss_rel"] > AMP_PARITY_LOSS_RTOL or \
            p["update_l2_rel"][1] > AMP_PARITY_UPDATE_L2:
        raise AssertionError("%s: the paths disagree" % what)


def phase_train(seed):
    """BERT-base MLM training through the port's entry points: layers,
    ``Adam.minimize``, ``Executor.run`` on the card, at level 2 with the
    tier's kernels."""
    from paddle_tpu_torch.kernels import optimizer_update as ou

    t0 = time.perf_counter()
    (exe, scope, main, loss, params, grads, batches,
     tier) = _train_setup("Adam", seed)
    cfg = bert_cfg()
    ops = [op.type for op in main.global_block().ops]
    log("train: BERT %s MLM, S = %d, batch %d, %d masked slots: %d ops (%d "
        "grad ops, %d adam, %d fused_attention_grad), %d parameters; built "
        "and started in %.1f s; level 2: %d ops (%d fused layer norms, "
        "optimizer groups of %s params)" % (
            {k: cfg[k] for k in ("n_layer", "d_model", "n_head", "d_ff",
                                 "vocab")}, SEQ, TRAIN_BATCH, MAX_MASK,
            len(ops), sum(t.endswith("_grad") for t in ops),
            ops.count("adam"), ops.count("fused_attention_grad"),
            sum(int(np.prod(main.global_block().var(n).shape))
                for n in params), time.perf_counter() - t0,
            tier["ops_after"], tier["ln_residual_fused"],
            tier["optimizer_groups"]))
    per_step = (2 * cfg["n_layer"], cfg["n_layer"], cfg["n_layer"],
                2 * cfg["n_layer"] + 1, 1, 0, 0, 0, 0, 0)
    if (tier["ln_residual_fused"], tier["optimizer_groups"]) != (
            per_step[3], [len(params)]):
        raise AssertionError("level 2 fused %d layer norms and optimizer "
                             "groups %s, expected %d and [%d]" % (
                                 tier["ln_residual_fused"],
                                 tier["optimizer_groups"], per_step[3],
                                 len(params)))

    def step(sc, feed, fetch=(), eager=False):
        """One step (with ``eager``, the plan's eager step, never its
        graph); its loss, and the values of ``fetch`` when asked."""
        vals = (exe._run_eager if eager else exe.run)(
            main, feed=feed, fetch_list=[loss, *fetch], scope=sc)
        torch.cuda.synchronize()
        val = float(np.asarray(vals[0]).reshape(()))
        return (val, vals[1:]) if fetch else val

    # ---- the main path: counts zeroed here, read after the last step
    for k in ("PADDLE_TPU_FLASH_MIN_SEQ", "PADDLE_TPU_OPTIMIZE"):
        os.environ.pop(k, None)  # static flash threshold, level 2
    path = _metered_steps("train", step, scope, batches,
                          WARMUP_STEPS + TIMED_STEPS, per_step,
                          lambda: ou.adam_group.vector_entries)
    # ---- end of the main path
    losses, launches = path["losses"], path["launches"]
    step_ms, peak_mb = path["step_ms"][WARMUP_STEPS:], path["peak_mb"]
    # from the second step on, params and moments are K6's padded output
    # views: the capture's table streams every entry at 16 bytes, and
    # every replay reads that table
    n_tables, rows, vec, _ = _kept_table(exe, scope)
    vector = dict(eager=path["host_extra"][0], capture=path["host_extra"][1],
                  replayed=vec)
    if (n_tables, rows, vec, path["host_extra"][1]) != (
            1, len(params), len(params), len(params)):
        raise AssertionError("the plan keeps %d tables of %d rows, %d on "
                             "K6's 16-byte path (the capture counted %d), "
                             "expected 1 of %d, all" % (
                                 n_tables, rows, vec, path["host_extra"][1],
                                 len(params)))

    # one step, twice, from the same scope: bitwise the same
    snap = _snapshot(scope)
    runs = []
    for _ in range(2):
        sc = _restored(snap)
        val = step(sc, batches[0])
        runs.append((val, {n: sc.find_var(n) for n in params}))
    bitwise = runs[0][0] == runs[1][0] and all(
        torch.equal(runs[0][1][n], runs[1][1][n]) for n in params)
    if not bitwise:
        raise AssertionError("one step from one scope gave two results: "
                             "loss %r / %r" % (runs[0][0], runs[1][0]))
    del runs, sc

    # from the same scope and RNG state (so the same dropout masks): the
    # main path against the composed attention and against level 0 (no
    # pass pipeline: no K4, no K6)
    paths = _run_paths(step, snap, batches, params, grads, {
        "main": ({}, ()),
        "composed attention": ({"PADDLE_TPU_FLASH_MIN_SEQ": "100000"},
                               (0, 1, 2)),
        "level 0": ({"PADDLE_TPU_OPTIMIZE": "0"}, (3, 4, 5))})
    parity = {name: _parity(paths["main"], paths[name], params)
              for name in ("composed attention", "level 0")}
    # phase 6g holds recompute's steps against the main path's
    main_path = (paths["main"][0],
                 {n: v.cpu() for n, v in paths["main"][2].items()})
    del paths
    for name, p in parity.items():
        _check_parity("main path vs %s" % name, p)

    # level 2 against level 0 on this scope, in turns, after one step at
    # each (which prepares the level-0 plan of this fetch list)
    _in_turns(lambda: step(scope, batches[0]), 1)
    host, host0 = (_host_breakdown(samples, what) for samples, what in zip(
        _in_turns(lambda: _host_by_class(
            lambda: step(scope, batches[0], eager=True)), HOST_PAIRS),
        ("level 2", "level 0")))
    turn2, turn0 = _in_turns(
        lambda: _synced_ms(lambda: step(scope, batches[2])), TURN_PAIRS)
    log("train: step time in turns over %d pairs: median level 2 %.3f ms, "
        "level 0 %.3f ms" % (TURN_PAIRS, float(np.median(turn2)),
                             float(np.median(turn0))))
    prof = _profiled(lambda: step(scope, batches[1]))
    _log_breakdown("train step", prof)
    k4_ms = prof["by_class_ms"].get("layer norm (K4/K5)", 0.0)
    k6_ms = prof["by_class_ms"].get("optimizer (K6/K7)", 0.0)
    log("train: K4 + K6 %.4f + %.4f ms of the profiled step's device time; "
        "Adam entries on K6's 16-byte path %s (of %d; replayed: read from "
        "the table the plan keeps on the card)" % (
            k4_ms, k6_ms, vector, len(params)))

    compiled = phase_compiled_train("f32", exe, main, loss, snap, batches,
                                    params, step, per_step)
    compiled["plans"] = phase_shared_pool(main, loss, snap, batches, params,
                                          compiled)
    med = float(np.median(step_ms))
    tokens_per_s = TRAIN_BATCH * SEQ / (med / 1e3)
    log("train: losses %s" % ["%.4f" % v for v in losses])
    log("train: step median %.3f ms, max %.3f ms over %d steps (under the "
        "launch meter's profiler); %.1f tokens/s; launches %s = %s on the "
        "card on the main path (launch calls from the host %s); peak device "
        "memory %.1f MiB; one step twice from one scope: bitwise equal" % (
            med, max(step_ms), len(step_ms), tokens_per_s, COUNT_NAMES,
            launches, path["host_launches"], peak_mb))
    return dict(ops=len(ops), adam_ops=ops.count("adam"),
                grad_ops=sum(t.endswith("_grad") for t in ops),
                tier=tier, losses=losses, step_ms=step_ms,
                step_ms_median=med, tokens_per_s=tokens_per_s,
                launches=dict(zip(COUNT_NAMES, launches)),
                host_launches=dict(zip(COUNT_NAMES, path["host_launches"])),
                peak_mem_mib=peak_mb, bitwise_repeatable=bitwise,
                parity=dict(steps=PARITY_STEPS, **parity), host=host,
                host_level0=host0,
                step_ms_in_turns={"level 2": turn2, "level 0": turn0},
                profile=prof, k4_ms=k4_ms, k6_ms=k6_ms,
                adam_vector_entries=vector, compiled=compiled,
                per_step=per_step, snapshot=snap, main_path=main_path,
                batches=batches)


# --------------------------------------------------------------- phase 6b
def _amp_step_fn(exe, main, loss):
    """One step of an AMP program, or of an f32 one (with ``eager``, the
    plan's eager step); its loss, and the values of ``fetch`` (as f32
    numpy: an AMP grad is bf16) when asked."""
    def step(sc, feed, fetch=(), eager=False):
        vals = (exe._run_eager if eager else exe.run)(
            main, feed=feed, fetch_list=[loss, *fetch], scope=sc,
            return_numpy=False)
        torch.cuda.synchronize()
        val = float(vals[0].float().reshape(()))
        return ((val, [v.float().cpu().numpy() for v in vals[1:]])
                if fetch else val)

    return step


def _amp_per_step(cfg, opt):
    """The launches of one AMP step (``COUNT_NAMES`` order): every flash
    launch the bf16 instantiation's, every fused layer norm K4's AMP
    instantiation, one K6 (Adam) or K7 (SGD)."""
    n = cfg["n_layer"]
    return (2 * n, n, n, 0, int(opt == "Adam"), int(opt == "SGD"), 2 * n, n,
            n, 2 * n + 1)


def _f32_masters(scope, params):
    """Every param and optimizer moment in the scope is still f32: the
    names of the floating values that are not."""
    return [n for n in scope.local_var_names()
            if (n in params or "moment" in n)
            and isinstance(scope.find_var(n), torch.Tensor)
            and scope.find_var(n).dtype != torch.float32]


def _update_l2(a, b, before, params):
    """Per param, the l2 norm of the difference of two paths' updates
    (params after minus before) over the l2 norm of the second's: the
    worst as (param, value)."""
    worst = ("", 0.0)
    for n in params:
        da = (a[n] - before[n]).double()
        db = (b[n] - before[n]).double()
        r = float((da - db).norm() / max(float(db.norm()), 1e-30))
        worst = max(worst, (n, r), key=lambda t: t[1])
    return worst


def phase_train_amp(seed, f32):
    """BERT-base MLM under bf16 AMP (``contrib.mixed_precision.decorate``
    around ``Adam``), at level 2: the launches of every step (bf16 flash
    kernels, K4's AMP instantiation, K6 on the bf16 grads), f32 masters,
    finite losses, level 2 against level 0 over 3 steps, the first loss
    against the f32 step's (phase 6, same weights, batch and dropout
    masks), the step time and one profiled step beside phase 6's."""
    from paddle_tpu_torch.kernels import optimizer_update as ou

    t0 = time.perf_counter()
    (exe, scope, main, loss, params, grads, batches,
     tier) = _train_setup("Adam", seed, amp=True)
    cfg = bert_cfg()
    per_step = _amp_per_step(cfg, "Adam")
    grad_bf16 = _amp_grad_bf16(main, list(grads))
    if (tier["ln_residual_fused"], tier["optimizer_groups"]) != (
            per_step[9], [len(params)]):
        raise AssertionError("AMP level 2 fused %d layer norms and "
                             "optimizer groups %s" % (
                                 tier["ln_residual_fused"],
                                 tier["optimizer_groups"]))
    log("train AMP: BERT-base MLM under bf16 AMP (level 2, %d ops, %d "
        "fused layer norms, a group of %s params, %d grads bf16) built and "
        "started in %.1f s" % (tier["ops_after"], tier["ln_residual_fused"],
                               tier["optimizer_groups"], sum(grad_bf16),
                               time.perf_counter() - t0))
    step = _amp_step_fn(exe, main, loss)
    snap = _snapshot(scope)

    # ---- the main path: counts zeroed here, read after the last step
    for k in ("PADDLE_TPU_FLASH_MIN_SEQ", "PADDLE_TPU_OPTIMIZE"):
        os.environ.pop(k, None)
    path = _metered_steps("AMP train", step, scope, batches,
                          WARMUP_STEPS + TIMED_STEPS, per_step,
                          lambda: ou.adam_group.bf16_grad_entries)
    # ---- end of the main path
    losses, launches = path["losses"], path["launches"]
    step_ms, peak_mb = path["step_ms"][WARMUP_STEPS:], path["peak_mb"]
    _check_bf16_grads("AMP", exe, scope, path, sum(grad_bf16))
    not_f32 = _f32_masters(scope, params)
    if not_f32:
        raise AssertionError("AMP left params or moments that are not f32: "
                             "%s" % not_f32[:5])

    # level 2 against level 0 (no K4, no K6) from the same scope and RNG
    # state: the first step's grads, the losses and the param updates of
    # PARITY_STEPS steps
    paths = _run_paths(step, snap, batches, params, grads, {
        "main": ({}, ()),
        "level 0": ({"PADDLE_TPU_OPTIMIZE": "0"}, (3, 4, 5, 9))})
    p = _parity(paths["main"], paths["level 0"], params)
    p["update_l2_rel"] = _update_l2(paths["main"][2], paths["level 0"][2],
                                    snap, params)
    del paths
    log("train AMP: main path vs level 0: param grads worst l2 rel diff "
        "%.3e (%s, <= %.3g); over %d steps loss rel diff %.3e (<= %.3g), "
        "param update worst l2 rel diff %.3e (%s, <= %.3g), param max "
        "|diff| %.3e" % (
            p["grad_l2_rel"][1], p["grad_l2_rel"][0], AMP_PARITY_GRAD_L2,
            PARITY_STEPS, p["loss_rel"], AMP_PARITY_LOSS_RTOL,
            p["update_l2_rel"][1], p["update_l2_rel"][0],
            AMP_PARITY_UPDATE_L2, p["param_max_abs"]))
    if p["grad_l2_rel"][1] > AMP_PARITY_GRAD_L2 or \
            p["loss_rel"] > AMP_PARITY_LOSS_RTOL or \
            p["update_l2_rel"][1] > AMP_PARITY_UPDATE_L2:
        raise AssertionError("AMP training at level 2 and level 0 "
                             "disagree")

    turn2, turn0 = _in_turns(
        lambda: _synced_ms(lambda: step(scope, batches[2])), 3)
    prof = _profiled(lambda: step(scope, batches[1]))
    _log_breakdown("AMP train step", prof)
    compiled = phase_compiled_train("AMP", exe, main, loss, snap, batches,
                                    params, step, per_step)
    _log_breakdown("f32 train step (phase 6)", f32["profile"])
    med = float(np.median(step_ms))
    tokens_per_s = TRAIN_BATCH * SEQ / (med / 1e3)
    first_rel = abs(losses[0] - f32["losses"][0]) / abs(f32["losses"][0])
    log("train AMP: losses %s; first loss %.6f against the f32 step's "
        "%.6f (rel %.3e); step median %.3f ms (f32 %.3f), max %.3f over %d "
        "steps; %.1f tokens/s (f32 %.1f); in turns, level 2 %.3f ms, level "
        "0 %.3f ms; launches %s = %s; peak device memory %.1f MiB (f32 "
        "%.1f)" % (
            ["%.4f" % v for v in losses], losses[0], f32["losses"][0],
            first_rel, med, f32["step_ms_median"], max(step_ms),
            len(step_ms), tokens_per_s, f32["tokens_per_s"],
            float(np.median(turn2)), float(np.median(turn0)), COUNT_NAMES,
            launches, peak_mb, f32["peak_mem_mib"]))
    log("train AMP: launch calls from the host %s = %s (the eager step "
        "and the capture)" % (COUNT_NAMES, path["host_launches"]))
    return dict(tier=tier, losses=losses, first_loss_vs_f32=dict(
                    amp=losses[0], f32=f32["losses"][0], rel=first_rel),
                step_ms=step_ms, step_ms_median=med,
                tokens_per_s=tokens_per_s,
                launches=dict(zip(COUNT_NAMES, launches)),
                host_launches=dict(zip(COUNT_NAMES, path["host_launches"])),
                bf16_grads=sum(grad_bf16), peak_mem_mib=peak_mb,
                parity=dict(steps=PARITY_STEPS, **p),
                step_ms_in_turns={"level 2": turn2, "level 0": turn0},
                profile=prof, compiled=compiled, per_step=per_step,
                snapshot=snap)


# ------------------------------------------------------------ phases 6e-6g
def _scheduled_program(amp=False, recompute=False):
    """BERT-base MLM with Adam under BERT pre-training's schedule (a
    linear warm-up around a polynomial decay to 0; under bf16 AMP with
    ``amp``), or with a constant rate and ``RecomputeOptimizer`` (a
    checkpoint per encoder layer) with ``recompute``: (main, startup,
    loss, the rate's var, params_grads)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import bert

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        ckpts = [] if recompute else None
        loss, _ = bert.build(bert.base_config(), seq_len=SEQ,
                             max_mask=MAX_MASK, checkpoints=ckpts)
        lr = TRAIN_LR
        if not recompute:
            lr = fluid.layers.linear_lr_warmup(
                fluid.layers.polynomial_decay(TRAIN_LR, SCHED_DECAY, 0.0,
                                              1.0),
                SCHED_WARMUP, 0.0, TRAIN_LR)
        opt = fluid.optimizer.Adam(learning_rate=lr)
        if amp:
            opt = fluid.contrib.mixed_precision.decorate(opt)
        if recompute:
            opt = fluid.optimizer.RecomputeOptimizer(opt)
            opt._set_checkpoints(ckpts)
        _, params_grads = opt.minimize(loss)
    return main, startup, loss, lr, params_grads


def _scheduled_rate(step):
    """The closed form of ``_scheduled_program``'s rate at ``step`` (0 the
    first). Each of the JAX package's schedules appends its own
    ``increment`` of the one step counter (the port's copy too), so a
    warm-up around a decay advances it twice a step: the decay reads
    2 * step + 1, the warm-up 2 * step + 2."""
    warm = 2 * step + 2
    if warm < SCHED_WARMUP:
        return TRAIN_LR * warm / SCHED_WARMUP
    return TRAIN_LR * (1.0 - min(2 * step + 1, SCHED_DECAY) / SCHED_DECAY)


def _started_from(exe, startup, snap):
    """A started scope of ``startup`` whose vars that ``snap`` names take
    the snapshot's values (an earlier phase's weights, moments and RNG
    chain): a snapshot of its own."""
    import paddle_tpu_torch as fluid

    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    taken = 0
    for n in scope.local_var_names():
        if n in snap:
            scope.set_var(n, _copied(snap[n]))
            taken += 1
    return _snapshot(scope), taken


def _fresh(batches, n):
    """A reader of ``n`` host batches, each a fresh copy (as a data
    loader hands them over: no array repeats, so no const-feed dedup)."""
    return lambda: ({k: v.copy() for k, v in batches[i % len(batches)]
                     .items()} for i in range(n))


def _host_gap_split(exe, main, fetch_list, scope, batches):
    """Phase 6e / 6f's split of the host's work between two replays of
    ``Executor.run``, on ``scope`` (whose plan holds a graph): each part
    timed on the host clock over HOST_GAP_REPLAYS replays, the card idle
    at the start of each: the feeds' conversion and copy to the card
    (``_args``) and into the graph's static buffers, re-seeding the
    graph's generators, ``state_changes`` over the scope, and the
    fetches' copy to the host once the card is done; "plan" is the plan
    lookup (its cache key), and "launch" the graph's launch with the
    scope's write-back."""
    from paddle_tpu_torch.core.cuda_graph import slot_seeds, state_changes
    from paddle_tpu_torch.core.executor import (RNG_VAR, _chain, _require,
                                                to_numpy)

    parts = {k: [] for k in ("feeds", "plan", "state", "seeds", "launch",
                             "fetch")}
    for i in range(HOST_GAP_REPLAYS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        program, sc, feeds, names = exe._args(
            main, batches[i % len(batches)], fetch_list, scope)
        t1 = time.perf_counter()
        plan = exe._plan(program, feeds, names, sc)
        graph = plan.graph
        t2 = time.perf_counter()
        state = {n: _require(sc, n)
                 for n in plan.const_state + plan.mut_state}
        copy, recapture = state_changes(graph.state, state)
        t3 = time.perf_counter()
        if copy or recapture:
            raise AssertionError("host gap: the scope changed under the "
                                 "graph: %s" % (copy + recapture)[:5])
        for n, t in feeds.items():
            graph.feeds[n].copy_(t)
        t4 = time.perf_counter()
        chain = _chain(sc, program) if plan.needs_rng else None
        for g, seed in zip(graph.generators,
                           slot_seeds(graph.slots, chain)):
            g.manual_seed(seed)
        t5 = time.perf_counter()
        graph.graph.replay()
        for n in plan.pure_written:
            sc.set_var(n, graph.written[n])
        if chain is not None:
            sc.set_var(RNG_VAR, chain)
        t6 = time.perf_counter()
        torch.cuda.synchronize()
        t7 = time.perf_counter()
        [to_numpy(v) for v in graph.fetches]
        t8 = time.perf_counter()
        parts["feeds"].append((t1 - t0) + (t4 - t3))
        parts["plan"].append(t2 - t1)
        parts["state"].append(t3 - t2)
        parts["seeds"].append(t5 - t4)
        parts["launch"].append(t6 - t5)
        parts["fetch"].append(t8 - t7)
    med = {k: float(np.median(v)) * 1e3 for k, v in parts.items()}
    med["total"] = sum(med.values())
    med["generators"] = len(graph.generators)
    med["state_vars"] = len(graph.state)
    return med


def _loop_values(exe, main, fetch_list, scope, reader, k):
    """``train_loop`` at ``k`` steps per call (max_in_flight 2, prefetch
    depth 2) over ``reader`` on ``scope``: {step index: fetched values}."""
    seen = {}
    exe.train_loop(main, reader, fetch_list=fetch_list, scope=scope,
                   max_in_flight=2, prefetch_depth=2, steps_per_call=k,
                   on_step=lambda i, v: seen.__setitem__(i, v))
    return seen


def phase_train_loop(what, seed, amp, snap, per_step):
    """Phase 6e (f32) / 6f (AMP): BERT-base under the warm-up + decay
    schedule, started from ``snap`` (phase 6's / 6b's weights), trained
    through ``train_loop`` over a reader of host numpy batches at K = 1
    and K = 4 (max_in_flight 2, prefetch depth 2): losses, rates and
    params bitwise those of ``run`` in a loop over the same batches (a
    ragged tail at K = 4), the rate per step against its closed form,
    the launches the card ran (``per_step`` a step), then the step time
    and tokens/s of each in turns, ``paddle_pipeline_overlap_ratio``,
    the busy share of a profiled window of steps, the split of the
    host's work between replays and peak memory."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import observe

    main, startup, loss, lr, _ = _scheduled_program(amp)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    init, taken = _started_from(exe, startup, snap)
    params = [p.name for p in main.global_block().all_parameters()]
    tier = _tier_stats(main, [loss.name, lr.name], _restored(init))
    if (tier["ln_residual_fused"], tier["optimizer_groups"]) != (
            per_step[9 if amp else 3], [len(params)]):
        raise AssertionError("%s: level 2 fused %d layer norms and "
                             "optimizer groups %s" % (
                                 what, tier["ln_residual_fused"],
                                 tier["optimizer_groups"]))
    fetch = [loss, lr]
    rs = np.random.RandomState(seed + 6)
    batches = [_train_batch(bert_cfg(), rs) for _ in range(4)]
    n = LOOP_STEPS

    # ---- the main path: counts zeroed here, read after the last step
    _zero_counts()
    scopes = {"run": _restored(init)}
    with LaunchMeter() as meter:
        meter.mark()
        ref = {i: exe.run(main, feed=b, fetch_list=fetch,
                          scope=scopes["run"])
               for i, b in enumerate(_fresh(batches, n)())}
        got = {}
        for k in (1, 4):
            scopes[k] = _restored(init)
            meter.mark()
            got[k] = _loop_values(exe, main, fetch, scopes[k],
                                  _fresh(batches, n), k)
    # ---- end of the main path
    launches = meter.units
    for unit in launches:
        if unit != _times(per_step, n):
            raise AssertionError("%s: the card ran %s = %s kernels in %d "
                                 "steps, expected %s a step" % (
                                     what, COUNT_NAMES, unit, n, per_step))
    ends = {1: list(range(n)), 4: [3, 7] + list(range(8, n))}
    for k in (1, 4):
        if sorted(got[k]) != ends[k]:
            raise AssertionError("%s K = %d resolved steps %s" % (
                what, k, sorted(got[k])))
        for i, vals in got[k].items():
            if any(a.tobytes() != b.tobytes() for a, b in zip(vals, ref[i])):
                raise AssertionError("%s K = %d step %d: %s against the run "
                                     "loop's %s" % (what, k, i, vals,
                                                    ref[i]))
        if not all(torch.equal(scopes[k].find_var(p),
                               scopes["run"].find_var(p)) for p in params):
            raise AssertionError("%s K = %d: params differ from the run "
                                 "loop's" % (what, k))
    losses = [float(np.asarray(ref[i][0], "float32").reshape(()))
              for i in range(n)]
    rates = [float(np.asarray(ref[i][1], "float32").reshape(()))
             for i in range(n)]
    want = [_scheduled_rate(i) for i in range(n)]
    rate_rel = max(abs(a - b) / b for a, b in zip(rates, want))
    rate_tol = SCHED_RTOL[amp]
    if rate_rel > rate_tol or not np.isfinite(losses).all():
        raise AssertionError("%s: rates %s against the closed form %s "
                             "(worst rel %.3e > %.0e) or losses %s" % (
                                 what, rates, want, rate_rel, rate_tol,
                                 losses))

    # ---- step times on one scope (its graph captured above): blocks of
    # LOOP_TIMED steps in turns on the host clock (each with its loop's
    # start and drain), then a profiled window of PROFILED_STEPS steps of
    # each, read on the device clock between the K6 launches that end
    # its second and its last step (the steady state)
    sc = scopes[4]

    def run_loop(steps):
        for b in _fresh(batches, steps)():
            exe.run(main, feed=b, fetch_list=fetch, scope=sc)

    def loop(k, steps):
        exe.train_loop(main, _fresh(batches, steps), fetch_list=fetch,
                       scope=sc, max_in_flight=2, prefetch_depth=2,
                       steps_per_call=k)

    def block(kind, steps):
        return (run_loop(steps) if kind == "run" else loop(kind, steps))

    times = {"run": [], 1: [], 4: []}
    overlap = {1: [], 4: []}
    for kind in ("run", 1, 4, 4, 1, "run"):
        ms, _ = _timed(lambda: block(kind, LOOP_TIMED))
        times[kind].append(ms / LOOP_TIMED)
        if kind != "run":
            overlap[kind].append(observe.get_metric(
                "paddle_pipeline_overlap_ratio").value)
    wall = {k: float(np.median(v)) for k, v in times.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    loop(1, LOOP_TIMED)
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    prof = {kind: _steady_profile(lambda: block(kind, PROFILED_STEPS))
            for kind in ("run", 1, 4)}
    med = {k: r["step_ms"] for k, r in prof.items()}
    split = _host_gap_split(exe, main, fetch, sc, batches)
    tokens = {k: TRAIN_BATCH * SEQ / (v / 1e3) for k, v in med.items()}
    for kind, r in prof.items():
        _log_breakdown("%s %s, %d steps" % (
            what, "run loop" if kind == "run" else "train_loop K = %d" % kind,
            PROFILED_STEPS), r)
    log("train %s: train_loop over a reader of host batches from phase "
        "6's snapshot (%d vars taken), the warm-up + decay schedule: %d "
        "steps at K = 1 and K = 4 (ragged tail %d) bitwise the run loop "
        "(losses, rates, %d params); rates within %.2e of the closed form "
        "(<= %.0e); launches %s = %s a step on the card"
        % (what, taken, n, n % 4, len(params), rate_rel, rate_tol,
           COUNT_NAMES, per_step))
    log("train %s: the steady state on the device clock (steps 2 to %d of "
        "a profiled window): run loop %.3f ms a step (%.1f tokens/s, busy "
        "%.1f%%), train_loop K = 1 %.3f ms (%.1f, %.1f%%), K = 4 %.3f ms "
        "(%.1f, %.1f%%); in turns over blocks of %d steps, each with its "
        "loop's start and drain, on the host clock: %.3f / %.3f / %.3f ms "
        "a step; overlap ratio K = 1 %s, K = 4 %s; the whole profiled "
        "windows busy %.1f%% / %.1f%% / %.1f%%; peak memory %.1f MiB" % (
            what, PROFILED_STEPS, med["run"], tokens["run"],
            100 * prof["run"]["steady_busy_share"], med[1], tokens[1],
            100 * prof[1]["steady_busy_share"], med[4], tokens[4],
            100 * prof[4]["steady_busy_share"], LOOP_TIMED, wall["run"],
            wall[1], wall[4], ["%.3f" % v for v in overlap[1]],
            ["%.3f" % v for v in overlap[4]],
            100 * prof["run"]["busy_share"], 100 * prof[1]["busy_share"],
            100 * prof[4]["busy_share"], peak))
    log("train %s: the host between two replays of run (median of %d, ms): "
        "feeds %.3f, plan lookup %.3f, state_changes over %d vars %.3f, "
        "re-seeding %d generators %.3f, the graph's launch %.3f, fetch copy "
        "%.3f; total %.3f" % (
            what, HOST_GAP_REPLAYS, split["feeds"], split["plan"],
            split["state_vars"], split["state"], split["generators"],
            split["seeds"], split["launch"], split["fetch"],
            split["total"]))
    out = dict(steps=n, losses=losses, rates=rates, rates_closed_form=want,
               rate_max_rel=rate_rel,
               launches=dict(zip(COUNT_NAMES, _times(per_step,
                                                     n * len(launches)))),
               step_ms={str(k): v for k, v in med.items()},
               wall_ms_per_step={str(k): v for k, v in times.items()},
               tokens_per_s={str(k): v for k, v in tokens.items()},
               overlap_ratio={str(k): v for k, v in overlap.items()},
               profile={str(k): v for k, v in prof.items()},
               host_gap_ms=split, peak_mem_mib=peak)
    del scopes, sc
    exe.close()
    return out


def phase_recompute(seed, f32):
    """Phase 6g: BERT-base with ``RecomputeOptimizer`` (Adam, a
    checkpoint per encoder layer), level 2, from phase 6's snapshot:
    RECOMPUTE_STEPS steps replayed (the first eager, the second
    captures) against the plan's eager step on a second scope, losses
    and params bitwise, the launches the card ran each step, the losses
    and params against phase 6's main path within its parity
    tolerances, and peak memory of an eager and a replayed step beside
    phase 6c's."""
    import paddle_tpu_torch as fluid

    main, startup, loss, _, _ = _scheduled_program(recompute=True)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    init, taken = _started_from(exe, startup, f32["snapshot"])
    ops = [op.type for op in main.global_block().ops]
    tier = _tier_stats(main, [loss.name], _restored(init))
    cfg = bert_cfg()
    per_step = (2 * cfg["n_layer"], cfg["n_layer"], cfg["n_layer"],
                tier["ln_residual_fused"], len(tier["optimizer_groups"]),
                0, 0, 0, 0, 0)
    params = [p.name for p in main.global_block().all_parameters()]
    batches = f32["batches"]

    def step(sc, feed, eager=False):
        vals = (exe._run_eager if eager else exe.run)(
            main, feed=feed, fetch_list=[loss], scope=sc)
        torch.cuda.synchronize()
        return float(np.asarray(vals[0]).reshape(()))

    # ---- the main path: counts zeroed here, read after the last step
    _zero_counts()
    scope_r, scope_e = _restored(init), _restored(init)
    losses, launches, ms = [], [], []
    for i in range(RECOMPUTE_STEPS):
        b = batches[i % len(batches)]
        t0 = time.perf_counter()
        with LaunchMeter() as meter:
            meter.mark()
            l_r = step(scope_r, b)
        ms.append((time.perf_counter() - t0) * 1e3)
        launches.append(meter.units[0])
        losses.append((l_r, step(scope_e, b, eager=True)))
    # ---- end of the main path
    for i, unit in enumerate(launches):
        if unit != per_step:
            raise AssertionError("recompute step %d ran %s = %s kernels on "
                                 "the card, expected %s" % (
                                     i, COUNT_NAMES, unit, per_step))
    bitwise = all(a == b for a, b in losses) and all(
        torch.equal(scope_r.find_var(p), scope_e.find_var(p))
        for p in params)
    if not bitwise:
        raise AssertionError("recompute: replayed steps differ from the "
                             "eager step: %s" % losses)
    ref_losses, ref_params = f32["main_path"]
    n = min(len(ref_losses), RECOMPUTE_STEPS)
    loss_rel = max(abs(a - b) / abs(b) for (a, _), b in
                   zip(losses[:n], ref_losses[:n]))
    param_diff = max(float((scope_r.find_var(p).cpu()
                            - ref_params[p]).abs().max()) for p in params)
    if n != PARITY_STEPS or loss_rel > PARITY_LOSS_RTOL or \
            param_diff > PARITY_PARAM_ATOL:
        raise AssertionError("recompute against phase 6 over %d steps: "
                             "loss rel %.3e, param max |diff| %.3e" % (
                                 n, loss_rel, param_diff))
    peaks = []
    for eager in (True, False):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step(scope_e if eager else scope_r, batches[0], eager=eager)
        peaks.append(torch.cuda.max_memory_allocated() / 2 ** 20)
    plain = f32["compiled"]["peak_mem_mib"]
    log("train recompute (6g): %d recompute_block ops (%d vars from phase "
        "6's snapshot); level 2 fused %d layer norms and optimizer groups "
        "of %s params (params read inside a segment stay unfused); %d "
        "steps (%s ms) bitwise the eager step; launches %s = %s a step on "
        "the card; against phase 6 over %d steps loss rel %.3e (<= %.0e), "
        "param max |diff| %.3e (<= %.0e); peak memory eager %.1f MiB "
        "(phase 6c %.1f), replayed %.1f (6c %.1f)" % (
            ops.count("recompute_block"), taken, tier["ln_residual_fused"],
            tier["optimizer_groups"], RECOMPUTE_STEPS,
            ["%.1f" % v for v in ms], COUNT_NAMES, per_step, n, loss_rel,
            PARITY_LOSS_RTOL, param_diff, PARITY_PARAM_ATOL, peaks[0],
            plain["eager"], peaks[1], plain["replay"]))
    out = dict(recompute_blocks=ops.count("recompute_block"), tier=tier,
               losses=losses, step_ms=ms,
               launches=dict(zip(COUNT_NAMES, _times(per_step,
                                                     RECOMPUTE_STEPS))),
               per_step=dict(zip(COUNT_NAMES, per_step)),
               loss_rel=loss_rel, param_max_abs=param_diff,
               peak_mem_mib=dict(eager=peaks[0], replay=peaks[1]),
               plain_peak_mem_mib=plain)
    del scope_r, scope_e
    exe.close()
    return out


# --------------------------------------------------------------- phase 4b
def phase_serve_amp(workdir, seed, pred_f32, reqs):
    """The serving program of phase 4 with bf16 AMP on
    (``Program.set_amp``), saved with ``save_inference_model`` (which
    keeps the flag) and served by the Predictor: every dispatch launches
    the bf16 flash kernel 12 times and K4's AMP instantiation 25 times;
    its answers against the f32 Predictor's (phase 4, same weights)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import bert

    cfg = bert.base_config()
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        bert.build(cfg, seq_len=SEQ, is_test=True)
    main.set_amp(True)
    enc = _encoder_output(main)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(startup)
        fluid.io.save_inference_model(
            workdir, ["src_ids", "sent_ids", "input_mask"], [enc], exe,
            main_program=main)
    del scope, exe
    torch.cuda.empty_cache()
    config = fluid.inference.AnalysisConfig(workdir)
    config.warmup_batch_sizes = list(BUCKETS)
    n = cfg["n_layer"]
    per_dispatch = (n, 0, 0, 0, 0, 0, n, 0, 0, 2 * n + 1)

    # ---- the main path: counts zeroed here, read after the last request
    os.environ.pop("PADDLE_TPU_FLASH_MIN_SEQ", None)
    os.environ.pop("PADDLE_TPU_OPTIMIZE", None)
    lat_ms, diffs = [], []

    def check(b, rep, out):
        if rep == 0:
            if out.shape != (b, SEQ, cfg["d_model"]) or \
                    out.dtype != np.float32 or not np.isfinite(out).all():
                raise AssertionError("AMP batch %d: bad output %s %s"
                                     % (b, out.shape, out.dtype))
            diffs.append(out)
        elif not np.array_equal(out, diffs[-1]):
            raise AssertionError("AMP batch %d: a repeated request gave "
                                 "another answer" % b)

    pred, _, path = _metered_serving(
        "serve AMP", lambda: fluid.inference.create_paddle_predictor(config),
        reqs, AMP_SERVE_REPEATS, per_dispatch, lat_ms, check)
    launches, peak_mb = path["launches"], path["peak_mb"]
    # ---- end of the main path
    if not pred.program.amp:
        raise AssertionError("the saved program lost its AMP flag")
    rows = []
    for req, amp_out, lat in zip(reqs, diffs, lat_ms):
        (ref,) = pred_f32.run(req)
        d = amp_out.astype(np.float64) - ref
        rel = float(np.linalg.norm(d) / np.linalg.norm(ref))
        rows.append(dict(batch=int(req["src_ids"].shape[0]), l2_rel=rel,
                         max_abs=float(np.abs(d).max()),
                         latency_ms=lat))
        log("serve AMP: batch %d (bucket %d) latency median %.3f ms over %d "
            "requests; against the f32 Predictor: l2 rel %.3e (<= %.0e), "
            "max |diff| %.3e" % (
                rows[-1]["batch"], pred.bucket_for(rows[-1]["batch"]) or
                rows[-1]["batch"], float(np.median(lat)), len(lat), rel,
                AMP_SERVE_L2, rows[-1]["max_abs"]))
    prof = {}
    for req in reqs:
        b = int(req["src_ids"].shape[0])
        pred.run(req)
        torch.cuda.synchronize()
        prof[b] = _profiled(lambda: pred.run(req))
        _log_breakdown("AMP batch %d" % b, prof[b])
    log("serve AMP: launches %s = %s on the card on the main path (launch "
        "calls from the host %s); peak device memory %.1f MiB" % (
            COUNT_NAMES, launches, path["host_launches"], peak_mb))
    worst = max(r["l2_rel"] for r in rows)
    if worst > AMP_SERVE_L2:
        raise AssertionError("AMP answers differ from f32 by l2 rel %.3e > "
                             "%.0e" % (worst, AMP_SERVE_L2))
    compiled = phase_compiled_serve("AMP", pred, reqs, per_dispatch)
    return dict(requests=rows, launches=dict(zip(COUNT_NAMES, launches)),
                host_launches=dict(zip(COUNT_NAMES, path["host_launches"])),
                peak_mem_mib=peak_mb, profile=prof, compiled=compiled)


# ---------------------------------------------------------------- phase 7
def phase_train_sgd(seed):
    """BERT-base MLM with ``SGD.minimize``: 3 steps at level 2 (K4 and
    K7), then 3 steps at level 0 from the same scope."""
    from paddle_tpu_torch.kernels import optimizer_update as ou

    (exe, scope, main, loss, params, grads, batches,
     tier) = _train_setup("SGD", seed)
    cfg = bert_cfg()
    per_step = (2 * cfg["n_layer"], cfg["n_layer"], cfg["n_layer"],
                2 * cfg["n_layer"] + 1, 0, 1, 0, 0, 0, 0)
    if (tier["ln_residual_fused"], tier["optimizer_groups"]) != (
            per_step[3], [len(params)]):
        raise AssertionError("level 2 fused %d layer norms and optimizer "
                             "groups %s" % (tier["ln_residual_fused"],
                                            tier["optimizer_groups"]))

    def step(sc, feed, fetch=()):
        vals = exe.run(main, feed=feed, fetch_list=[loss, *fetch], scope=sc)
        torch.cuda.synchronize()
        val = float(np.asarray(vals[0]).reshape(()))
        return (val, vals[1:]) if fetch else val

    snap = _snapshot(scope)
    # ---- the main path: counts zeroed here, read after the last step
    for k in ("PADDLE_TPU_FLASH_MIN_SEQ", "PADDLE_TPU_OPTIMIZE"):
        os.environ.pop(k, None)
    path = _metered_steps("SGD", step, scope, batches, PARITY_STEPS,
                          per_step, lambda: ou.sgd_group.vector_entries)
    # ---- end of the main path
    losses, step_ms, launches = (path["losses"], path["step_ms"],
                                 path["launches"])
    vector = dict(eager=path["host_extra"][0],
                  capture=path["host_extra"][1],
                  replayed=_kept_table(exe, scope)[2])
    main_path = (losses, None, {n: scope.find_var(n) for n in params})
    ref = _run_paths(step, snap, batches, params, {}, {
        "level 0": ({"PADDLE_TPU_OPTIMIZE": "0"}, (3, 4, 5))})["level 0"]
    loss_rel = max(abs(x - y) / abs(y) for x, y in zip(losses, ref[0]))
    param_diff = max(float((main_path[2][n] - ref[2][n]).abs().max())
                     for n in params)
    log("train SGD: level 2 %d ops (%d fused layer norms, a group of %s "
        "params); losses %s; step ms %s; launches %s = %s; entries on K7's "
        "16-byte path by step %s; vs level 0 over "
        "%d steps: loss rel diff %.3e (<= %.0e), param max |diff| %.3e "
        "(<= %.0e)" % (
            tier["ops_after"], tier["ln_residual_fused"],
            tier["optimizer_groups"], ["%.4f" % v for v in losses],
            ["%.1f" % v for v in step_ms], COUNT_NAMES, launches, vector,
            PARITY_STEPS, loss_rel, PARITY_LOSS_RTOL, param_diff,
            PARITY_PARAM_ATOL))
    if loss_rel > PARITY_LOSS_RTOL or param_diff > PARITY_PARAM_ATOL:
        raise AssertionError("SGD training at level 2 and level 0 disagree")
    return dict(tier=tier, losses=losses, step_ms=step_ms,
                launches=dict(zip(COUNT_NAMES, launches)),
                host_launches=dict(zip(COUNT_NAMES, path["host_launches"])),
                sgd_vector_entries=vector,
                parity=dict(steps=PARITY_STEPS, loss_rel=loss_rel,
                            param_max_abs=param_diff))


def phase_train_sgd_amp(seed):
    """BERT-base MLM with ``SGD`` under bf16 AMP: AMP_SGD_STEPS steps at
    level 2, each launching K7 once on the step's grads (bf16 but the
    layer norms'), the bf16 flash kernels and K4's AMP instantiation."""
    from paddle_tpu_torch.kernels import optimizer_update as ou

    (exe, scope, main, loss, params, grads, batches,
     tier) = _train_setup("SGD", seed, amp=True)
    per_step = _amp_per_step(bert_cfg(), "SGD")
    grad_bf16 = _amp_grad_bf16(main, list(grads))
    step = _amp_step_fn(exe, main, loss)
    # ---- the main path: counts zeroed here, read after the last step
    for k in ("PADDLE_TPU_FLASH_MIN_SEQ", "PADDLE_TPU_OPTIMIZE"):
        os.environ.pop(k, None)
    path = _metered_steps("AMP SGD", step, scope, batches, AMP_SGD_STEPS,
                          per_step, lambda: ou.sgd_group.bf16_grad_entries)
    # ---- end of the main path
    losses, launches = path["losses"], path["launches"]
    _check_bf16_grads("AMP SGD", exe, scope, path, sum(grad_bf16))
    bf16_entries = dict(eager=path["host_extra"][0],
                        capture=path["host_extra"][1],
                        replayed=_kept_table(exe, scope)[3])
    not_f32 = _f32_masters(scope, params)
    if not_f32:
        raise AssertionError("AMP SGD left params that are not f32: %s"
                             % not_f32[:5])
    log("train SGD AMP: level 2 %d ops (%d fused layer norms, a group of "
        "%s params); losses %s; launches %s = %s; bf16 grads on K7 per "
        "step %s" % (tier["ops_after"], tier["ln_residual_fused"],
                     tier["optimizer_groups"], ["%.4f" % v for v in losses],
                     COUNT_NAMES, launches, bf16_entries))
    return dict(tier=tier, losses=losses,
                launches=dict(zip(COUNT_NAMES, launches)),
                host_launches=dict(zip(COUNT_NAMES, path["host_launches"])),
                bf16_grad_entries=bf16_entries)


# ------------------------------------------------------------ phases 8-9
# GPT-2 small (gpt.base_config(): 12 layers, d_model 768, 12 heads of 64,
# d_ff 3072, vocab 50304, max_length 1024, dropout 0.1) trained at
# S = 1024, batch 8 (phases 8 f32, 8b AMP): steps on the main path (the
# first eager, the second captures, the rest replay) and the steps of
# train_loop at K = 1 held against the run loop
GPT_SEQ, GPT_BATCH, GPT_STEPS, GPT_LOOP_STEPS = 1024, 8, 5, 6
# generate (phase 8c): a prompt of 128 tokens (one prefill dispatch),
# then 32 new tokens, greedily, from a decode step over a cache of 1024
# rows, at batch 1 and 8; each batch size's generate runs GPT_GEN_CALLS
# times on one executor (the prefill plan runs once a call: eager, then
# captured, then replayed)
GPT_PROMPT, GPT_NEW, GPT_GEN_BATCHES, GPT_GEN_CALLS = 128, 32, (1, 8), 3
# the decode step's logits at every position against the training
# graph's is_test forward over the same ids (f32, TF32 off): the two
# reduce in other orders through 12 layers, as the flash and the
# composed serving paths do (SERVE_ATOL)
GPT_DECODE_ATOL = SERVE_ATOL
# the transformer (phase 9): transformer.base_config() at S = 256, batch
# 8, label smoothing 0.1, dropout 0.1: steps on the main path, and
# replayed steps against eager ones (the first capture and 2 pairs)
TR_SEQ, TR_STEPS, TR_SMOOTH, TR_PAIRS = 256, 3, 0.1, 2


def _gpt_batch(vocab, rs):
    """One GPT batch: ids in [1, vocab), the last 0-10% of each row
    padding (id 0, which the loss masks), as real batches carry."""
    ids = rs.randint(1, vocab, (GPT_BATCH, GPT_SEQ)).astype("int64")
    for i in range(GPT_BATCH):
        ids[i, GPT_SEQ - rs.randint(0, GPT_SEQ // 10 + 1):] = 0
    return {"ids": ids}


class _ComposedAttention:
    """Counts the host's calls of the composed attention (the flash
    kernels' plain version) inside the window: none means that every
    ``fused_attention`` of the eager steps and the captures, and so of
    every replay, took the kernels."""

    def __enter__(self):
        from paddle_tpu_torch.ops import attention as attn

        self.calls, self._orig = 0, attn.composed_attention_with_lse

        def counted(*a, **kw):
            self.calls += 1
            return self._orig(*a, **kw)

        attn.composed_attention_with_lse = counted
        return self

    def __exit__(self, *exc):
        from paddle_tpu_torch.ops import attention as attn

        attn.composed_attention_with_lse = self._orig
        return False


def _loop_against_run(what, exe, main, loss, snap, batches, params, n):
    """``train_loop`` at K = 1 over ``n`` fresh host batches against
    ``run`` in a loop, each from ``snap`` on a scope of its own: every
    loss and the final params bitwise equal."""
    sc_run, sc_loop = _restored(snap), _restored(snap)
    ref = [exe.run(main, feed=b, fetch_list=[loss], scope=sc_run)[0]
           for b in _fresh(batches, n)()]
    got = _loop_values(exe, main, [loss], sc_loop, _fresh(batches, n), 1)
    same = sorted(got) == list(range(n)) and all(
        got[i][0].tobytes() == ref[i].tobytes() for i in range(n))
    if not same or not all(torch.equal(sc_run.find_var(p),
                                       sc_loop.find_var(p)) for p in params):
        raise AssertionError("%s: train_loop at K = 1 differs from the run "
                             "loop (losses %s against %s)" % (
                                 what, [got.get(i) for i in range(n)], ref))
    return [float(np.asarray(r, "float32").reshape(())) for r in ref]


def _gpt_setup(seed, amp=False, **knobs):
    """GPT-2 small (``gpt.base_config()``, ``knobs`` over it) built for
    training at S = GPT_SEQ with Adam at TRAIN_LR (in
    ``contrib.mixed_precision.decorate`` with ``amp``), its weights
    started on the card from ``seed``: (exe, scope, main, loss, params,
    grad name -> param, 4 batches from ``seed``, cfg)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import gpt

    cfg = dict(gpt.base_config(), **knobs)
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        loss, _ = gpt.build(cfg, seq_len=GPT_SEQ)
        optimizer = fluid.optimizer.Adam(learning_rate=TRAIN_LR)
        if amp:
            optimizer = fluid.contrib.mixed_precision.decorate(optimizer)
        _, params_grads = optimizer.minimize(loss)
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    exe.run(startup, scope=scope)
    params = [p.name for p in main.global_block().all_parameters()]
    grads = {g.name: p.name for p, g in params_grads}
    rs = np.random.RandomState(seed + 8)
    batches = [_gpt_batch(cfg["vocab"], rs) for _ in range(4)]
    return exe, scope, main, loss, params, grads, batches, cfg


def phase_gpt_train(seed, amp):
    """Phases 8 (f32) and 8b (bf16 AMP): GPT-2 small trained through the
    port's entry points (``gpt.build``, ``Adam.minimize``, under AMP in
    ``contrib.mixed_precision.decorate``; ``Executor.run`` on the card)
    at level 2, from random weights (``seed``). A step's launches on the
    card, from the level-2 program: the flash forward 24 (12
    ``fused_attention`` ops, causal with the pad-row bias, and the
    forward each of their grads recomputes), dK/dV and dQ 12 each, K4 24
    (the pass fuses each layer's two residual adds into the norm after
    them, the last into the final norm; under AMP K4's AMP
    instantiation), K6 once over the 149 params; under AMP every flash
    launch is the bf16 instantiation's. No composed attention runs (the
    host's calls over the eager step and the capture). Then 6c's
    replayed steps against the plan's eager step in turns (bitwise, step
    medians, tokens/s, busy shares, peak memory, capture seconds), level
    2 against level 0 over PARITY_STEPS steps from one scope
    (``_check_flip_parity``; AMP's bounds under AMP), and
    ``train_loop`` at K = 1 over GPT_LOOP_STEPS
    steps bitwise the run loop."""
    what = "GPT AMP (8b)" if amp else "GPT f32 (8)"
    t0 = time.perf_counter()
    exe, scope, main, loss, params, grads, batches, cfg = _gpt_setup(
        seed, amp)
    n_weights = sum(int(np.prod(main.global_block().var(n).shape))
                    for n in params)
    tier = _tier_stats(main, [loss.name], scope)
    n = cfg["n_layer"]
    per_step = (_amp_per_step(cfg, "Adam")[:9] + (2 * n,) if amp else
                (2 * n, n, n, 2 * n, 1, 0, 0, 0, 0, 0))
    k4 = per_step[9 if amp else 3]
    if (len(params), n_weights) != (149, 163072512) or (
            tier["ln_residual_fused"], tier["optimizer_groups"]) != (
            k4, [len(params)]):
        raise AssertionError("%s: %d params, %d weights; level 2 fused %d "
                             "layer norms and optimizer groups %s" % (
                                 what, len(params), n_weights,
                                 tier["ln_residual_fused"],
                                 tier["optimizer_groups"]))
    log("%s: GPT %s, S = %d, batch %d: %d params, %d weights; built and "
        "started in %.1f s; level 2: %d ops of %d (%d fused layer norms, "
        "an optimizer group of %s params)" % (
            what, {k: cfg[k] for k in ("n_layer", "d_model", "n_head",
                                        "d_ff", "vocab")},
            GPT_SEQ, GPT_BATCH, len(params), n_weights,
            time.perf_counter() - t0, tier["ops_after"],
            tier["ops_before"], tier["ln_residual_fused"],
            tier["optimizer_groups"]))
    step = _amp_step_fn(exe, main, loss)
    snap = _snapshot(scope)

    # ---- the main path: counts zeroed here, read after the last step
    for k in ("PADDLE_TPU_FLASH_MIN_SEQ", "PADDLE_TPU_OPTIMIZE"):
        os.environ.pop(k, None)
    with _ComposedAttention() as composed:
        path = _metered_steps(what, step, scope, batches, GPT_STEPS,
                              per_step)
    # ---- end of the main path
    if composed.calls:
        raise AssertionError("%s: the composed attention ran %d times on "
                             "the main path" % (what, composed.calls))
    losses, step_ms = path["losses"], path["step_ms"][2:]
    med = float(np.median(step_ms))
    tokens = GPT_BATCH * GPT_SEQ

    compiled = phase_compiled_train(what, exe, main, loss, snap, batches,
                                    params, step, per_step, tokens=tokens)
    # the graphs' pool (16 GiB f32) goes before the next paths' eager
    # steps (24 GiB at their peak), which would otherwise hold both
    exe.close()
    paths = _run_paths(step, snap, batches, params, grads, {
        "main": ({}, ()),
        "level 0": ({"PADDLE_TPU_OPTIMIZE": "0"},
                    (3, 4, 5, 9) if amp else (3, 4, 5))})
    parity = _parity(paths["main"], paths["level 0"], params, before=snap)
    parity["capture_attempts"] = [p.graph.attempts for p in _captured(exe)]
    del paths
    log("%s: the parity paths' captures took %s attempts (2 where the "
        "first ran out of memory)" % (what, parity["capture_attempts"]))
    if amp:
        _check_amp_parity("%s: main path vs level 0" % what, parity)
        not_f32 = _f32_masters(scope, params)
        if not_f32:
            raise AssertionError("%s left params or moments that are not "
                                 "f32: %s" % (what, not_f32[:5]))
    else:
        _check_flip_parity(what, parity)
    exe.close()
    loop_losses = _loop_against_run(what, exe, main, loss, snap, batches,
                                    params, GPT_LOOP_STEPS)
    prof = compiled["replay_profile"]
    log("%s: losses %s; step median %.3f ms over %d steps of the main path "
        "(replays), %.1f tokens/s; replayed in turns %.3f ms (%.1f "
        "tokens/s), eager %.3f ms; a profiled replayed step %.1f%% busy "
        "(%d kernels); capture %.3f s; peak memory %.1f MiB on the main "
        "path, %.1f replayed, %.1f eager; launches %s = %s on the card "
        "(host calls %s); train_loop K = 1 over %d steps bitwise the run "
        "loop" % (
            what, ["%.4f" % v for v in losses], med, len(step_ms),
            tokens / (med / 1e3), compiled["replay_median_ms"],
            compiled["replay_tokens_per_s"], compiled["eager_median_ms"],
            100 * prof["busy_share"], prof["kernels"], compiled["capture_s"],
            path["peak_mb"], compiled["peak_mem_mib"]["replay"],
            compiled["peak_mem_mib"]["eager"], COUNT_NAMES, path["launches"],
            path["host_launches"], GPT_LOOP_STEPS))
    params_out = {n_: scope.find_var(n_).clone() for n_ in params} \
        if not amp else None
    return dict(n_params=len(params), n_weights=n_weights, tier=tier,
                losses=losses, step_ms=step_ms, step_ms_median=med,
                tokens_per_s=tokens / (med / 1e3),
                launches=dict(zip(COUNT_NAMES, path["launches"])),
                host_launches=dict(zip(COUNT_NAMES, path["host_launches"])),
                per_step=dict(zip(COUNT_NAMES, per_step)),
                peak_mem_mib=path["peak_mb"], compiled=compiled,
                parity=dict(steps=PARITY_STEPS, **parity),
                loop_losses=loop_losses, params=params_out)


class _Generating:
    """The executor ``gpt.generate`` drives: each ``run`` goes to
    ``run_fn`` (the executor's ``run``, or its ``_run_eager``, the plan's
    eager step, never its graph), marks the launch meter first, and keeps
    its host-clock ms (the fetched logits' copy to the host included)
    and, with ``keep``, the fetched logits."""

    def __init__(self, run_fn, meter=None, keep=False):
        self.run_fn, self.meter, self.keep = run_fn, meter, keep
        self.ms, self.logits = [], []

    def run(self, program, feed=None, fetch_list=None, scope=None):
        if self.meter is not None:
            self.meter.mark()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.run_fn(program, feed=feed, fetch_list=fetch_list,
                          scope=scope)
        self.ms.append((time.perf_counter() - t0) * 1e3)
        if self.keep:
            self.logits.append(out[0])
        return out


def _gpt_logits_name(program):
    for op in program.global_block().ops:
        if op.type == "mul" and "gpt_out_proj.w_0" in op.input("Y"):
            return op.output("Out")[0]
    raise AssertionError("no LM head in the program")


def phase_gpt_generate(seed, params):
    """Phase 8c: ``gpt.generate`` with a ``build_prefill_step`` program
    (prompt 128) and a ``build_decode_step`` program (a cache of 1024
    rows), greedy, 32 new tokens, at batch 1 and 8, on phase 8's weights
    (``params``). Each batch size runs generate GPT_GEN_CALLS times on
    one executor and scope: every step after each plan's first two is a
    replay of its graph, and the decode graph, captured at its second
    token, reads and writes the caches the prefill wrote, in place. The
    launches on the card: K4 24 a prefill and 24 a token (the level-2
    program fuses each residual add into the norm after it), counted per
    dispatch, and the wrappers called for the eager step and the capture
    of each plan only. The tokens of every call equal those of an
    executor that never replays (``_run_eager``) on a second scope, and
    the logits of the last call at every position (the prefill's 128
    and each decode step's) match the training graph's is_test forward
    over the same ids within GPT_DECODE_ATOL. Prints the prefill latency
    and the median per-token latency of the last call."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import gpt

    cfg = gpt.base_config()
    n = cfg["n_layer"]
    per = (0, 0, 0, 2 * n, 0, 0, 0, 0, 0, 0)
    rs = np.random.RandomState(seed + 9)
    out = {}
    for batch in GPT_GEN_BATCHES:
        t0 = time.perf_counter()
        dec, dstart = fluid.Program(), fluid.Program()
        with fluid.program_guard(dec, dstart), fluid.unique_name.guard():
            logits, caches = gpt.build_decode_step(cfg, batch=batch)
        pre, pstart = fluid.Program(), fluid.Program()
        with fluid.program_guard(pre, pstart), fluid.unique_name.guard():
            plogits, _ = gpt.build_prefill_step(cfg, batch=batch,
                                                prompt_len=GPT_PROMPT)
        exe = fluid.Executor(fluid.CUDAPlace(0))
        scopes = []
        for _ in range(2):  # the replaying executor's, the eager one's
            sc = fluid.Scope()
            exe.run(dstart, scope=sc)
            exe.run(pstart, scope=sc)
            for name, v in params.items():
                if sc.find_var(name) is not None:
                    sc.set_var(name, v.clone())
            scopes.append(sc)
        tier_d = _tier_stats(dec, [logits.name], scopes[0])
        tier_p = _tier_stats(pre, [plogits.name], scopes[0])
        if (tier_d["ln_residual_fused"], tier_p["ln_residual_fused"]) != (
                2 * n, 2 * n):
            raise AssertionError("generate: level 2 fused %d / %d layer "
                                 "norms in the decode / prefill step" % (
                                     tier_d["ln_residual_fused"],
                                     tier_p["ln_residual_fused"]))
        prompt = rs.randint(1, cfg["vocab"], (batch, GPT_PROMPT)).astype(
            "int64")
        cache_objs = [scopes[0].find_var(c) for c in caches]
        build_s = time.perf_counter() - t0

        def generate(ex, sc):
            return gpt.generate(ex, dec, logits, prompt, GPT_NEW, sc,
                                prefill_prog=pre, prefill_logits=plogits)

        # ---- the main path: counts zeroed here, read after the last call
        _zero_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        calls = []
        with LaunchMeter() as meter:
            for i in range(GPT_GEN_CALLS):
                g = _Generating(exe.run, meter, keep=i == GPT_GEN_CALLS - 1)
                calls.append((generate(g, scopes[0]), g))
        # ---- end of the main path
        peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
        host = _counts()
        bad = [u for u in meter.units if u != per]
        if bad or host != _times(per, 4):
            raise AssertionError("generate batch %d: dispatches ran %s = %s "
                                 "on the card (expected %s each); the "
                                 "wrappers called %s (the eager step and "
                                 "the capture of 2 plans)" % (
                                     batch, COUNT_NAMES, bad[:1], per, host))
        plans = {p: next(q for q in _captured(exe)
                         if q.graph.bound_to(scopes[0]) and any(
                             c in q.graph.donated for c in caches)
                         and q.fetch_names == [v.name])
                 for p, v in (("prefill", plogits), ("decode", logits))}
        shared = all(scopes[0].find_var(c) is o
                     for c, o in zip(caches, cache_objs)) and all(
            p.graph.state[c] is o for p in plans.values()
            for c, o in zip(caches, cache_objs)) and all(
            p.graph.adopted == 0 for p in plans.values())
        if not shared:
            raise AssertionError("generate batch %d: the plans' graphs do "
                                 "not hold the scope's caches in place"
                                 % batch)
        eager = _Generating(exe._run_eager)
        want = generate(eager, scopes[1])
        for i, (got, _) in enumerate(calls):
            if not np.array_equal(got, want):
                raise AssertionError("generate batch %d call %d: tokens "
                                     "differ from the eager executor's"
                                     % (batch, i))
        # the last call's logits at every position against the training
        # graph's is_test forward (dropout off: the decode steps have
        # none) over the same ids
        last = calls[-1][1]
        steps = np.concatenate(last.logits, axis=1)
        full, fstart = fluid.Program(), fluid.Program()
        with fluid.program_guard(full, fstart), fluid.unique_name.guard():
            gpt.build(dict(cfg, dropout=0.0), seq_len=steps.shape[1],
                      is_test=True)
        fsc = fluid.Scope()
        exe.run(fstart, scope=fsc)
        for name, v in params.items():
            fsc.set_var(name, v)
        (ref,) = exe.run(full, feed={"ids": want[:, :steps.shape[1]]},
                         fetch_list=[_gpt_logits_name(full)], scope=fsc)
        err = float(np.abs(steps - ref).max())
        if not np.isfinite(steps).all() or err > GPT_DECODE_ATOL:
            raise AssertionError("generate batch %d: decode logits against "
                                 "the full forward: max |diff| %.3e > %.0e"
                                 % (batch, err, GPT_DECODE_ATOL))
        prefill_ms, token_ms = last.ms[0], last.ms[1:]
        row = dict(batch=batch, build_s=build_s, prefill_ms=prefill_ms,
                   token_ms=token_ms,
                   token_median_ms=float(np.median(token_ms)),
                   eager_prefill_ms=eager.ms[0],
                   eager_token_median_ms=float(np.median(eager.ms[1:])),
                   first_call_ms=calls[0][1].ms,
                   capture_s={p: q.graph.seconds for p, q in plans.items()},
                   pool_mib=_pool_mib(plans["decode"]), peak_mem_mib=peak_mb,
                   logits_max_abs_err=err,
                   launches=dict(zip(COUNT_NAMES, meter.total())),
                   host_launches=dict(zip(COUNT_NAMES, host)),
                   dispatches=len(meter.units))
        out[batch] = row
        log("generate (8c): batch %d, prompt %d, %d new tokens, cache %d "
            "rows: prefill %.3f ms, per token median %.3f ms (max %.3f), "
            "replayed (the eager executor: prefill %.3f ms, per token "
            "%.3f); tokens of %d replaying calls equal the eager "
            "executor's; logits at %d positions within %.3e of the full "
            "forward; capture prefill %.3f s, decode %.3f s; the caches "
            "written in place by both graphs (one pool of %s MiB); peak "
            "memory %.1f MiB; %d dispatches each ran %s = %s on the card" % (
                batch, GPT_PROMPT, GPT_NEW, cfg["max_length"], prefill_ms,
                row["token_median_ms"], max(token_ms), row["eager_prefill_ms"],
                row["eager_token_median_ms"], GPT_GEN_CALLS, steps.shape[1],
                err, row["capture_s"]["prefill"], row["capture_s"]["decode"],
                "%.1f" % row["pool_mib"] if row["pool_mib"] is not None
                else "not measured", peak_mb, len(meter.units), COUNT_NAMES,
                per))
        del exe, scopes, fsc, calls, last, steps, ref, cache_objs, plans
        torch.cuda.empty_cache()
    return out


def _transformer_setup(seed):
    """The transformer (``transformer.base_config()``) built for training
    at S = TR_SEQ, label smoothing TR_SMOOTH, with Adam at TRAIN_LR, its
    weights started on the card from ``seed``: (exe, scope, main, loss,
    params, grad name -> param, 3 batches from ``seed`` with 0-10%
    trailing padding in each row's source and target, cfg)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import transformer

    cfg = transformer.base_config()
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        loss, _ = transformer.build(cfg, seq_len=TR_SEQ,
                                    label_smooth_eps=TR_SMOOTH)
        _, params_grads = fluid.optimizer.Adam(
            learning_rate=TRAIN_LR).minimize(loss)
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    exe.run(startup, scope=scope)
    params = [p.name for p in main.global_block().all_parameters()]
    grads = {g.name: p.name for p, g in params_grads}
    rs = np.random.RandomState(seed + 10)
    batches = []
    for _ in range(3):
        feed = {k: rs.randint(1, cfg[v], (TRAIN_BATCH, TR_SEQ)).astype(
            "int64") for k, v in (("src_ids", "src_vocab"),
                                  ("trg_ids", "trg_vocab"),
                                  ("lbl_ids", "trg_vocab"))}
        for i in range(TRAIN_BATCH):
            src_pad, trg_pad = rs.randint(0, TR_SEQ // 10 + 1, 2)
            feed["src_ids"][i, TR_SEQ - src_pad:] = 0
            for k in ("trg_ids", "lbl_ids"):
                feed[k][i, TR_SEQ - trg_pad:] = 0
        batches.append(feed)
    return exe, scope, main, loss, params, grads, batches, cfg


def phase_transformer(seed):
    """Phase 9: the transformer (``transformer.base_config()``: 6 + 6
    layers, d_model 512, 8 heads of 64, vocabularies of 30000) trained
    at S = 256, batch 8, label smoothing 0.1, dropout 0.1, Adam, level 2,
    f32, from random weights. A step's launches on the card, from the
    level-2 program: the flash forward 36 (encoder self-attention,
    causal decoder self-attention and cross-attention, 6 each, and each
    grad's recompute), dK/dV and dQ 18 each, K4 30 (five residual adds
    a layer pair fused into the norm after them), K6 once over the 187
    trained params (the two position tables are frozen); losses finite.
    Then replayed steps against the plan's eager step in turns, bitwise
    (6c's way: the first captures, then TR_PAIRS pairs), and level 2
    against level 0 over PARITY_STEPS steps from one scope
    (``_check_flip_parity``): K4 at VPT = 16 and K6 over the 187 params
    against their plain versions on the path."""
    t0 = time.perf_counter()
    exe, scope, main, loss, params, grads, batches, cfg = \
        _transformer_setup(seed)
    n_weights = sum(int(np.prod(main.global_block().var(n).shape))
                    for n in params)
    tier = _tier_stats(main, [loss.name], scope)
    n = cfg["n_layer"]
    per_step = (6 * n, 3 * n, 3 * n, 5 * n, 1, 0, 0, 0, 0, 0)
    if (len(params), n_weights) != (189, 90445824) or (
            tier["ln_residual_fused"], tier["optimizer_groups"]) != (
            5 * n, [len(params) - 2]):
        raise AssertionError("transformer: %d params, %d weights; level 2 "
                             "fused %d layer norms and optimizer groups %s"
                             % (len(params), n_weights,
                                tier["ln_residual_fused"],
                                tier["optimizer_groups"]))
    log("transformer (9): %s, S = %d, batch %d, label smoothing %.1f: %d "
        "params, %d weights; built and started in %.1f s; level 2: %d ops "
        "of %d (%d fused layer norms, an optimizer group of %s)" % (
            {k: cfg[k] for k in ("n_layer", "d_model", "n_head", "d_ff",
                                 "src_vocab", "trg_vocab")},
            TR_SEQ, TRAIN_BATCH, TR_SMOOTH, len(params), n_weights,
            time.perf_counter() - t0, tier["ops_after"], tier["ops_before"],
            tier["ln_residual_fused"], tier["optimizer_groups"]))
    step = _amp_step_fn(exe, main, loss)
    snap = _snapshot(scope)

    # ---- the main path: counts zeroed here, read after the last step
    with _ComposedAttention() as composed:
        path = _metered_steps("transformer", step, scope, batches, TR_STEPS,
                              per_step)
    # ---- end of the main path
    if composed.calls:
        raise AssertionError("transformer: the composed attention ran %d "
                             "times on the main path" % composed.calls)
    compiled = phase_compiled_train("transformer (9)", exe, main, loss, snap,
                                    batches, params, step, per_step,
                                    tokens=TRAIN_BATCH * TR_SEQ,
                                    pairs=TR_PAIRS)
    exe.close()
    paths = _run_paths(step, snap, batches, params, grads, {
        "main": ({}, ()), "level 0": ({"PADDLE_TPU_OPTIMIZE": "0"},
                                      (3, 4, 5))})
    parity = _parity(paths["main"], paths["level 0"], params, before=snap)
    del paths
    _check_flip_parity("transformer (9)", parity)
    log("transformer (9): losses %s; steps %s ms; launches %s = %s on the "
        "card (host calls %s); peak memory %.1f MiB" % (
            ["%.4f" % v for v in path["losses"]],
            ["%.1f" % v for v in path["step_ms"]], COUNT_NAMES,
            path["launches"], path["host_launches"], path["peak_mb"]))
    return dict(n_params=len(params), n_weights=n_weights, tier=tier,
                losses=path["losses"], step_ms=path["step_ms"],
                launches=dict(zip(COUNT_NAMES, path["launches"])),
                host_launches=dict(zip(COUNT_NAMES, path["host_launches"])),
                per_step=dict(zip(COUNT_NAMES, per_step)),
                peak_mem_mib=path["peak_mb"], compiled=compiled,
                parity=dict(steps=PARITY_STEPS, **parity))


# ----------------------------------------------------- phases 10 and 11
# image classification: ResNet-50 (``resnet.build(class_dim=1000,
# depth=50)``, 224 x 224) and ViT-B/16 (``vit.base_config()``, S = 197)
# at batch 32, Adam at TRAIN_LR: steps on the main path, and replayed
# steps against eager ones (the first capture and IMG_PAIRS pairs)
IMG_BATCH, IMG_STEPS, IMG_PAIRS, IMG_CLASSES = 32, 3, 2, 1000
# ViT's replayed steps, composed and with the flash kernels, in turns
VIT_FLASH_PAIRS = 4
RN_PARAMS, RN_WEIGHTS, RN_BN = 161, 25557032, 53
VIT_PARAMS, VIT_WEIGHTS, VIT_SEQ = 152, 86530792, 197
# ResNet-50 served (phase 10c): buckets, requests, answers a request
RN_SERVE_BUCKETS = [1, 8]
RN_SERVE_REPEATS = 10
# the Predictor's answers (softmax probabilities over 1000 classes)
# against the training program's is_test forward on the same weights:
# the same ops at the same batch, but a plan of its own (another pass
# pipeline's program, cuDNN's algorithm picked per plan), so f32
# rounding, not bits
RN_SERVE_ATOL = 1e-5
# the conv determinism probe (phase 10): ResNet-50's stem and a stage-1
# 3x3 conv at batch IMG_BATCH, the backward of each this many times
CONV_PROBE_RUNS = 3
CONV_PROBE_CASES = [
    # name, input [N, C, H, W], filter [O, I, kh, kw], stride, pad
    ("stem_7x7s2", (IMG_BATCH, 3, 224, 224), (64, 3, 7, 7), 2, 3),
    ("stage1_3x3", (IMG_BATCH, 64, 56, 56), (64, 64, 3, 3), 1, 1),
]


def _image_batches(seed, n):
    """``n`` batches of IMG_BATCH N(0, 1) images [3, 224, 224] and labels
    in [0, IMG_CLASSES), from ``seed``."""
    rs = np.random.RandomState(seed)
    return [{"img": rs.randn(IMG_BATCH, 3, 224, 224).astype("float32"),
             "label": rs.randint(0, IMG_CLASSES, (IMG_BATCH, 1)).astype(
                 "int64")} for _ in range(n)]


def _bn_stats(main):
    """The batch norms' running mean and variance (persistables the step
    writes, not params)."""
    return [n for op in main.global_block().ops if op.type == "batch_norm"
            for n in op.input("Mean") + op.input("Variance")]


def _image_setup(model, seed, amp):
    """ResNet-50 or ViT-B/16 built for training with Adam at TRAIN_LR (in
    ``contrib.mixed_precision.decorate`` with ``amp``), its weights
    started on the card from ``seed``: (exe, scope, main, loss, acc,
    params, grad name -> param, 4 batches, the level-2 stats)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import resnet, vit

    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        if model == "resnet":
            loss, acc, _ = resnet.build(class_dim=IMG_CLASSES, depth=50,
                                        image_shape=(3, 224, 224))
        else:
            loss, acc = vit.build(vit.base_config())
        optimizer = fluid.optimizer.Adam(learning_rate=TRAIN_LR)
        if amp:
            optimizer = fluid.contrib.mixed_precision.decorate(optimizer)
        _, params_grads = optimizer.minimize(loss)
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    exe.run(startup, scope=scope)
    params = [p.name for p in main.global_block().all_parameters()]
    grads = {g.name: p.name for p, g in params_grads}
    batches = _image_batches(seed + (12 if model == "resnet" else 13), 4)
    tier = _tier_stats(main, [loss.name], scope)
    return exe, scope, main, loss, acc, params, grads, batches, tier


def _conv_probe(seed):
    """Is a conv step bitwise repeatable? On each of CONV_PROBE_CASES, the
    forward and the backward (input and weight grads) run
    CONV_PROBE_RUNS times on the same inputs under PyTorch's default
    cuDNN flags (benchmark off, nondeterministic algorithms allowed; TF32
    off) and under the port's (``ops.nn._conv_flags``: deterministic):
    whether each set of runs is bitwise equal, and the median
    milliseconds of one forward + backward under each."""
    from paddle_tpu_torch.ops.nn import _conv_flags

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    out = {}
    for name, xs, ws, stride, pad in CONV_PROBE_CASES:
        x = torch.randn(xs, generator=gen, device=dev).requires_grad_()
        w = (torch.randn(ws, generator=gen, device=dev) * 0.05
             ).requires_grad_()
        g = torch.randn(F.conv2d(x, w, None, stride, pad).shape,
                        generator=gen, device=dev)

        def fwd_bwd():
            y = F.conv2d(x, w, None, stride, pad)
            return (y, *torch.autograd.grad(y, (x, w), g))

        row = {}
        for flags, ctx in (
                ("default", lambda: torch.backends.cudnn.flags(
                    enabled=True, benchmark=False, deterministic=False,
                    allow_tf32=False)),
                ("port", _conv_flags)):
            with ctx():
                runs = [fwd_bwd() for _ in range(CONV_PROBE_RUNS)]
                torch.cuda.synchronize()
                same = all(all(torch.equal(a, b) for a, b in zip(runs[0], r))
                           for r in runs[1:])
                del runs
                ms = time_ms(fwd_bwd)
            row[flags] = dict(bitwise=same, ms=ms)
        out[name] = row
        log("conv probe %s x %s stride %d: forward + backward %d times "
            "bitwise equal under the default cuDNN flags %s (%.3f ms), under "
            "the port's deterministic flags %s (%.3f ms)" % (
                name, tuple(xs), stride, CONV_PROBE_RUNS,
                row["default"]["bitwise"], row["default"]["ms"],
                row["port"]["bitwise"], row["port"]["ms"]))
        del x, w, g
    bad = [n for n, r in out.items() if not r["port"]["bitwise"]]
    if bad:
        raise AssertionError("a conv step under the port's cuDNN flags is "
                             "not bitwise repeatable: %s" % bad)
    return out


def _image_compiled(what, exe, main, loss, snap, batches, params, stats,
                    step, per_step):
    """Phase 6c's replayed steps against eager ones for an image model:
    the params and the batch norms' running stats bitwise equal."""
    return phase_compiled_train(what, exe, main, loss, snap, batches,
                                params + stats, step, per_step,
                                tokens=IMG_BATCH, pairs=IMG_PAIRS,
                                unit="images")


def _log_image_path(what, path, compiled, extra=""):
    prof = compiled["replay_profile"]
    log("%s: losses %s; replayed in turns %.3f ms a step (%.1f images/s), "
        "eager %.3f ms; a profiled replayed step %.1f%% busy (%d kernels; "
        "conv %.3f ms, matmul %.3f ms of %.3f ms busy); capture %.3f s; "
        "peak memory %.1f MiB on the main path, %.1f replayed, %.1f eager; "
        "launches %s = %s on the card (host calls %s)%s" % (
            what, ["%.4f" % v for v in path["losses"]],
            compiled["replay_median_ms"], compiled["replay_tokens_per_s"],
            compiled["eager_median_ms"], 100 * prof["busy_share"],
            prof["kernels"], prof["by_class_ms"].get("conv", 0.0),
            prof["by_class_ms"].get("matmul", 0.0), prof["device_busy_ms"],
            compiled["capture_s"], path["peak_mb"],
            compiled["peak_mem_mib"]["replay"],
            compiled["peak_mem_mib"]["eager"], COUNT_NAMES,
            path["launches"], path["host_launches"], extra))


def phase_resnet_train(seed, amp):
    """Phases 10 (f32) and 10b (bf16 AMP): ResNet-50 (``resnet.build(
    class_dim=1000, depth=50)``: 53 conv2d + batch_norm, 25,557,032
    weights) trained at 224 x 224, batch 32, through the port's entry
    points at level 2, Adam at TRAIN_LR, from random weights (``seed``).
    A step runs no flash kernel and no K4 (no layer norm) and K6 once over
    the 161 params (counted on the card). Then 6c's replayed steps
    against the plan's eager step, bitwise, the 106 running stats
    included; level 2 against level 0 over PARITY_STEPS steps (phase
    8's gates; AMP's bounds under AMP), with the running stats' largest
    relative difference reported. Phase 10 first probes whether a conv
    step is bitwise repeatable (``_conv_probe``)."""
    what = "ResNet-50 AMP (10b)" if amp else "ResNet-50 f32 (10)"
    probe = None if amp else _conv_probe(seed)
    t0 = time.perf_counter()
    exe, scope, main, loss, acc, params, grads, batches, tier = \
        _image_setup("resnet", seed, amp)
    stats = _bn_stats(main)
    n_weights = sum(int(np.prod(main.global_block().var(n).shape))
                    for n in params)
    per_step = (0, 0, 0, 0, 1, 0, 0, 0, 0, 0)
    if (len(params), n_weights, len(stats)) != (
            RN_PARAMS, RN_WEIGHTS, 2 * RN_BN) or (
            tier["ln_residual_fused"], tier["optimizer_groups"]) != (
            0, [RN_PARAMS]):
        raise AssertionError("%s: %d params, %d weights, %d running stats; "
                             "level 2 fused %d layer norms and optimizer "
                             "groups %s" % (what, len(params), n_weights,
                                            len(stats),
                                            tier["ln_residual_fused"],
                                            tier["optimizer_groups"]))
    log("%s: batch %d: %d params, %d weights, %d running stats; built and "
        "started in %.1f s; level 2: %d ops of %d (an optimizer group of %s "
        "params)" % (what, IMG_BATCH, len(params), n_weights, len(stats),
                     time.perf_counter() - t0, tier["ops_after"],
                     tier["ops_before"], tier["optimizer_groups"]))
    step = _amp_step_fn(exe, main, loss)
    snap = _snapshot(scope)

    # ---- the main path: counts zeroed here, read after the last step
    for k in ("PADDLE_TPU_FLASH_MIN_SEQ", "PADDLE_TPU_OPTIMIZE"):
        os.environ.pop(k, None)
    path = _metered_steps(what, step, scope, batches, IMG_STEPS, per_step)
    # ---- end of the main path
    moved = [n for n in stats if torch.equal(scope.find_var(n), snap[n])]
    if moved:
        raise AssertionError("%s: the steps left %d running stats as they "
                             "were (%s)" % (what, len(moved), moved[:3]))
    compiled = _image_compiled(what, exe, main, loss, snap, batches, params,
                               stats, step, per_step)
    exe.close()
    paths = _run_paths(step, snap, batches, params, grads, {
        "main": ({}, ()), "level 0": ({"PADDLE_TPU_OPTIMIZE": "0"}, (4,))})
    parity = _parity(paths["main"], paths["level 0"], params, before=snap)
    del paths
    if amp:
        _check_amp_parity("%s: main path vs level 0" % what, parity)
        not_f32 = _f32_masters(scope, params)
        if not_f32:
            raise AssertionError("%s left params or moments that are not "
                                 "f32: %s" % (what, not_f32[:5]))
    else:
        _check_flip_parity(what, parity)
    exe.close()
    _log_image_path(what, path, compiled)
    out = dict(n_params=len(params), n_weights=n_weights,
               n_running_stats=len(stats), tier=tier,
               losses=path["losses"], step_ms=path["step_ms"],
               launches=dict(zip(COUNT_NAMES, path["launches"])),
               host_launches=dict(zip(COUNT_NAMES, path["host_launches"])),
               per_step=dict(zip(COUNT_NAMES, per_step)),
               peak_mem_mib=path["peak_mb"], compiled=compiled,
               parity=dict(steps=PARITY_STEPS, **parity), conv_probe=probe)
    if not amp:
        out["state"] = {n: scope.find_var(n).clone() for n in params + stats}
    return out


def phase_resnet_serve(workdir, seed, state):
    """Phase 10c: ResNet-50 served. The inference program (``resnet.build``
    again, its probabilities fetched) is saved with
    ``io.save_inference_model`` from a scope holding phase 10's trained
    weights and running stats, and the port's Predictor (batch norm
    rewritten to ``is_test``, buckets 1 and 8, each warmed up eagerly
    and then captured) answers requests of batch 1 and 8, each
    RN_SERVE_REPEATS times, every answer a replay (counted: a dispatch
    runs none of the port's kernels) and the same every time. The
    answers are held against the training program's is_test forward on
    the same weights (RN_SERVE_ATOL), and are finite probabilities.
    Latency medians and max."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import resnet

    t0 = time.perf_counter()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        _, _, probs = _resnet_probs(resnet)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope = fluid.Scope()
    for n, v in state.items():
        scope.set_var(n, v)
    with fluid.scope_guard(scope):
        fluid.io.save_inference_model(workdir, ["img"], [probs], exe,
                                      main_program=main)
    # the reference: the training program's forward in test mode
    test_prog = main.clone(for_test=True)
    for op in test_prog.global_block().ops:
        if op.type in ("batch_norm", "dropout"):
            op.attrs["is_test"] = True
    test_prog._bump()
    rs = np.random.RandomState(seed + 14)
    reqs = [{"img": rs.randn(b, 3, 224, 224).astype("float32")}
            for b in RN_SERVE_BUCKETS]
    want = [exe._run_eager(test_prog, feed=r, fetch_list=[probs],
                           scope=scope)[0] for r in reqs]
    exe.close()
    del exe, scope
    _free()
    log("serve ResNet-50 (10c): built, saved with phase 10's weights and "
        "the reference answers taken in %.1f s" % (time.perf_counter() - t0))
    config = fluid.inference.AnalysisConfig(workdir)
    config.warmup_batch_sizes = list(RN_SERVE_BUCKETS)
    per_dispatch = (0,) * len(COUNT_NAMES)  # cuDNN, no kernel of the port
    answers, lat_ms = [], []

    def check(b, rep, out):
        if rep == 0:
            if out.shape != (b, IMG_CLASSES) or not np.isfinite(out).all() \
                    or np.abs(out.sum(-1) - 1).max() > 1e-4:
                raise AssertionError("serve ResNet-50 (10c): batch %d: bad "
                                     "answer %s" % (b, out.shape))
            answers.append(out)
        elif not np.array_equal(out, answers[-1]):
            raise AssertionError("serve ResNet-50 (10c): batch %d: a "
                                 "repeated request gave another answer" % b)

    # ---- the main path: counts zeroed here, read after the last request
    pred, init_s, path = _metered_serving(
        "serve ResNet-50 (10c)",
        lambda: fluid.inference.create_paddle_predictor(config), reqs,
        RN_SERVE_REPEATS, per_dispatch, lat_ms, check,
        buckets=RN_SERVE_BUCKETS, batch_feed="img")
    # ---- end of the main path
    bn_test = {op.attrs.get("is_test") for op in
               pred.program.global_block().ops if op.type == "batch_norm"}
    diffs = [float(np.abs(a - w).max()) for a, w in zip(answers, want)]
    for b, lat, d in zip(RN_SERVE_BUCKETS, lat_ms, diffs):
        log("serve ResNet-50 (10c): batch %d latency median %.3f ms, max "
            "%.3f ms over %d replayed requests; max |answer - the training "
            "program's is_test forward| %.3e (<= %.0e)" % (
                b, float(np.median(lat)), max(lat), len(lat), d,
                RN_SERVE_ATOL))
    log("serve ResNet-50 (10c): predictor init %.2f s; batch norms in test "
        "mode: %s; peak device memory %.1f MiB" % (init_s, bn_test,
                                                   path["peak_mb"]))
    if bn_test != {True} or max(diffs) > RN_SERVE_ATOL:
        raise AssertionError("serve ResNet-50 (10c): batch norms is_test %s, "
                             "answers off by %s" % (bn_test, diffs))
    del pred
    return dict(batches=RN_SERVE_BUCKETS, latency_ms=lat_ms,
                latency_median_ms=[float(np.median(x)) for x in lat_ms],
                latency_max_ms=[max(x) for x in lat_ms], max_abs_diff=diffs,
                init_s=init_s, launches=dict(zip(COUNT_NAMES,
                                                 path["launches"])),
                peak_mem_mib=path["peak_mb"])


def _resnet_probs(resnet):
    """ResNet-50's inference graph at phase 10's names: (img, label,
    probabilities)."""
    import paddle_tpu_torch as fluid

    img = fluid.layers.data("img", [3, 224, 224])
    label = fluid.layers.data("label", [1], dtype="int64")
    return img, label, resnet.resnet_imagenet(img, class_dim=IMG_CLASSES,
                                              depth=50)


def phase_vit_train(seed, amp):
    """Phases 11 (f32) and 11b (bf16 AMP): ViT-B/16 (``vit.base_config()``:
    224 / 16, S = 197, d_model 768, 12 layers, 86,530,792 weights, dropout
    0.1) trained at batch 32 through the port's entry points at level 2,
    Adam at TRAIN_LR, from random weights. At S = 197 the static
    threshold composes attention: as configured a step launches K4 at
    each of the 24 add -> layer-norm seams the pass fuses (its AMP
    instantiation under AMP) and K6 once over the 152 params, and no
    flash kernel. Then the same steps from the same scope with
    PADDLE_TPU_FLASH_MIN_SEQ=0 set for that run alone: the flash forward
    24 times a step, dK/dV and dQ 12 each, at ragged S = 197 (counted).
    6c's replayed steps against eager ones, bitwise; the flash run
    against the composed one over PARITY_STEPS steps within phase 6's
    loss and grad bounds (AMP's under AMP); level 2 against level 0
    within phase 8's gates (AMP's bounds under AMP)."""
    what = "ViT-B/16 AMP (11b)" if amp else "ViT-B/16 f32 (11)"
    t0 = time.perf_counter()
    exe, scope, main, loss, acc, params, grads, batches, tier = \
        _image_setup("vit", seed, amp)
    n_weights = sum(int(np.prod(main.global_block().var(n).shape))
                    for n in params)
    n = 12
    seams = 2 * n
    flash = ((2 * n, n, n, 0, 0, 0, 2 * n, n, n, 0) if amp else
             (2 * n, n, n, 0, 0, 0, 0, 0, 0, 0))
    per_step = ((0, 0, 0, 0, 1, 0, 0, 0, 0, seams) if amp else
                (0, 0, 0, seams, 1, 0, 0, 0, 0, 0))
    per_step_flash = tuple(a + b for a, b in zip(per_step, flash))
    if (len(params), n_weights) != (VIT_PARAMS, VIT_WEIGHTS) or (
            tier["ln_residual_fused"], tier["optimizer_groups"]) != (
            seams, [VIT_PARAMS]):
        raise AssertionError("%s: %d params, %d weights; level 2 fused %d "
                             "layer norms and optimizer groups %s" % (
                                 what, len(params), n_weights,
                                 tier["ln_residual_fused"],
                                 tier["optimizer_groups"]))
    log("%s: S = %d, batch %d: %d params, %d weights; built and started in "
        "%.1f s; level 2: %d ops of %d (%d fused layer norms, an optimizer "
        "group of %s params)" % (
            what, VIT_SEQ, IMG_BATCH, len(params), n_weights,
            time.perf_counter() - t0, tier["ops_after"], tier["ops_before"],
            tier["ln_residual_fused"], tier["optimizer_groups"]))
    step = _amp_step_fn(exe, main, loss)
    snap = _snapshot(scope)

    # ---- the main path, as configured: counts zeroed here, read after
    # the last step
    for k in ("PADDLE_TPU_FLASH_MIN_SEQ", "PADDLE_TPU_OPTIMIZE"):
        os.environ.pop(k, None)
    path = _metered_steps(what, step, scope, batches, IMG_STEPS, per_step)
    # ---- end of the main path
    # ---- the main path with the flash kernels: the same steps from the
    # same scope, PADDLE_TPU_FLASH_MIN_SEQ=0 for this run alone
    fscope = _restored(snap)
    os.environ["PADDLE_TPU_FLASH_MIN_SEQ"] = "0"
    try:
        with _ComposedAttention() as composed:
            fpath = _metered_steps(what + " flash", step, fscope, batches,
                                   IMG_STEPS, per_step_flash)
    finally:
        os.environ.pop("PADDLE_TPU_FLASH_MIN_SEQ", None)
    # ---- end of the flash run
    if composed.calls:
        raise AssertionError("%s: the composed attention ran %d times with "
                             "the flash kernels forced" % (what,
                                                           composed.calls))
    # each run's plan replayed, composed and flash in turns
    turns = ([], [])
    for i in range(VIT_FLASH_PAIRS):
        for flash in ((False, True) if i % 2 == 0 else (True, False)):
            if flash:
                os.environ["PADDLE_TPU_FLASH_MIN_SEQ"] = "0"
            try:
                ms, _ = _timed(lambda: step(fscope if flash else scope,
                                            batches[i % len(batches)]))
            finally:
                os.environ.pop("PADDLE_TPU_FLASH_MIN_SEQ", None)
            turns[flash].append(ms)
    med_c, med_f = (float(np.median(t)) for t in turns)
    del fscope
    compiled = _image_compiled(what, exe, main, loss, snap, batches, params,
                               [], step, per_step)
    exe.close()
    paths = _run_paths(step, snap, batches, params, grads, {
        "main": ({}, ()),
        "flash": ({"PADDLE_TPU_FLASH_MIN_SEQ": "0"}, ()),
        "level 0": ({"PADDLE_TPU_OPTIMIZE": "0"},
                    (3, 4, 5, 9) if amp else (3, 4, 5))})
    flash_parity = _parity(paths["flash"], paths["main"], params,
                           before=snap)
    parity = _parity(paths["main"], paths["level 0"], params, before=snap)
    del paths
    if amp:
        _check_amp_parity("%s: flash vs composed" % what, flash_parity)
        _check_amp_parity("%s: main path vs level 0" % what, parity)
        not_f32 = _f32_masters(scope, params)
        if not_f32:
            raise AssertionError("%s left params or moments that are not "
                                 "f32: %s" % (what, not_f32[:5]))
    else:
        p = flash_parity
        log("%s: flash vs composed: param grads worst l2 rel diff %.3e (%s, "
            "<= %.0e); over %d steps loss rel diff %.3e (<= %.0e), param max "
            "|diff| %.3e, elements past %.0e: %.3e of all" % (
                what, p["grad_l2_rel"][1], p["grad_l2_rel"][0],
                PARITY_GRAD_L2, PARITY_STEPS, p["loss_rel"],
                PARITY_LOSS_RTOL, p["param_max_abs"], PARITY_PARAM_ATOL,
                p["param_share_over_atol"]))
        if p["grad_l2_rel"][1] > PARITY_GRAD_L2 or \
                p["loss_rel"] > PARITY_LOSS_RTOL:
            raise AssertionError("%s: flash and composed disagree" % what)
        _check_flip_parity(what, parity)
    exe.close()
    _log_image_path(what, path, compiled, "; with the flash kernels forced: "
                    "losses %s, launches %s on the card (host calls %s); "
                    "replayed in turns over %d pairs: composed %.3f ms, "
                    "flash %.3f ms a step" % (
                        ["%.4f" % v for v in fpath["losses"]],
                        fpath["launches"], fpath["host_launches"],
                        VIT_FLASH_PAIRS, med_c, med_f))
    return dict(n_params=len(params), n_weights=n_weights, tier=tier,
                losses=path["losses"], step_ms=path["step_ms"],
                launches=dict(zip(COUNT_NAMES, path["launches"])),
                host_launches=dict(zip(COUNT_NAMES, path["host_launches"])),
                per_step=dict(zip(COUNT_NAMES, per_step)),
                flash_losses=fpath["losses"], flash_step_ms=fpath["step_ms"],
                replayed_in_turns_ms=dict(composed=turns[0],
                                          flash=turns[1]),
                replayed_in_turns_median_ms=dict(composed=med_c,
                                                 flash=med_f),
                flash_launches=dict(zip(COUNT_NAMES, fpath["launches"])),
                flash_per_step=dict(zip(COUNT_NAMES, per_step_flash)),
                peak_mem_mib=path["peak_mb"],
                flash_peak_mem_mib=fpath["peak_mb"], compiled=compiled,
                flash_parity=dict(steps=PARITY_STEPS, **flash_parity),
                parity=dict(steps=PARITY_STEPS, **parity))


# ------------------------------------------------------- phases 12-12e
# the serving tier: GPT-2 small behind the continuous-batching engine
ENGINE_B_MAX, ENGINE_MAX_LEN = 8, 1024
ENGINE_REQUESTS, ENGINE_PROMPTS, ENGINE_NEW = 48, (64, 128, 256, 512), \
    (16, 128)
SAMPLED = dict(temperature=0.8, top_k=40)
# prefix reuse (12b): a shared system prompt, suffixes of these lengths
PREFIX_LEN, PREFIX_REQUESTS, PREFIX_SUFFIXES, PREFIX_NEW = \
    384, 16, (16, 64), 32
# speculative decoding (12c): k, greedy requests, the disagreeing draft's
# depth, the replayed verify steps a round that time its products per
# position against one product
SPEC_K, SPEC_REQUESTS, SPEC_NEW, SPEC_PROMPTS, DRAFT_LAYERS = \
    4, 16, 64, (64, 128), 2
ROUTE_STEPS, ROUTE_ROUNDS = 50, 3
# the router (12d): requests from two tenants, tenant "b"'s in-flight
# quota, replica 0's decode dispatch that raises (counted from the
# warmed-up fleet's first request)
ROUTER_REQUESTS, ROUTER_QUOTA, ROUTER_FAULT_AT, ROUTER_NEW = 32, 4, 3, 32
# the batcher (12e): requests of 1-3 rows from 4 threads over phase 4's
# Predictor. A coalesced answer against its rows run alone: the same f32
# products at another row count, summed in another order through 12
# layers (phase 4's flash-vs-composed bound is 1e-3)
BATCHER_REQUESTS, BATCHER_THREADS, BATCHER_MAX_ROWS = 64, 4, 8
BATCHER_ATOL = 1e-4


def _engine_traffic(vocab, rs, n, prompts, new, sampled_every=2,
                    seed0=0):
    """``n`` requests from ``rs``: (prompt, n_new, sampling kwargs);
    every ``sampled_every``-th one sampled (temperature 0.8, top_k 40,
    its own seed), the rest greedy (``sampled_every`` 0: all greedy)."""
    out = []
    for i in range(n):
        p = int(rs.choice(prompts))
        n_new = int(rs.randint(new[0], new[1] + 1))
        prompt = rs.randint(1, vocab, (p,)).astype("int64")
        kw = dict(SAMPLED, seed=seed0 + i) if sampled_every and \
            i % sampled_every == sampled_every - 1 else {}
        out.append((prompt, n_new, kw))
    return out


class _Reference:
    """GPT-2 small's weights from the seed on the card, and ``generate``
    for one request alone (batch 1): a decode step with a cache of
    ENGINE_MAX_LEN rows and a prefill program per prompt length, on one
    executor and scope, each replayed from its second run."""

    def __init__(self, cfg, seed):
        import paddle_tpu_torch as fluid
        from paddle_tpu_torch.models import gpt

        self.fluid, self.gpt, self.cfg = fluid, gpt, cfg
        self.exe = fluid.Executor(fluid.CUDAPlace(0))
        self.scope = fluid.Scope()
        self.prog, start = fluid.Program(), fluid.Program()
        self.prog.random_seed = start.random_seed = seed
        with fluid.program_guard(self.prog, start):
            self.logits, self.caches = gpt.build_decode_step(
                cfg, batch=1, max_len=ENGINE_MAX_LEN)
        self.exe.run(start, scope=self.scope)
        self.params = {n: self.scope.find_var(n)
                       for n in self.prog.global_block().vars
                       if n.startswith("gpt_") and n not in self.caches}
        self.prefill = {}

    def _prefill(self, P):
        fluid = self.fluid
        if P not in self.prefill:
            prog, start = fluid.Program(), fluid.Program()
            with fluid.program_guard(prog, start):
                logits, _ = self.gpt.build_prefill_step(
                    self.cfg, batch=1, prompt_len=P,
                    max_len=ENGINE_MAX_LEN)
            tmp = fluid.Scope()
            self.exe.run(start, scope=tmp)
            for n in prog.global_block().vars:
                if self.scope.find_var(n) is None and \
                        tmp.find_var(n) is not None:
                    self.scope.set_var(n, tmp.find_var(n))
            self.prefill[P] = (prog, logits)
        return self.prefill[P]

    def generate(self, prompt, n_new, **kw):
        prog, logits = self._prefill(len(prompt))
        return self.gpt.generate(self.exe, self.prog, self.logits,
                                 prompt[None], n_new, self.scope,
                                 prefill_prog=prog, prefill_logits=logits,
                                 **kw)[0]


_FUSED = {}


def _fused_norms(prog, fetch, scope):
    """K4 launches one dispatch of ``prog`` runs: the level-2 pipeline's
    fused layer norms (cached by the program's op types)."""
    key = tuple(op.type for op in prog.global_block().ops)
    if key not in _FUSED:
        _FUSED[key] = _tier_stats(prog, fetch, scope)["ln_residual_fused"]
    return _FUSED[key]


class _EngineProbe:
    """Host-clock marks of one engine's scheduler, by wrapping its target
    lane and executor: when each prompt's prefill returned (its first
    token is sampled right after), each decode dispatch's start and end,
    the time in the per-slot sampler, and every dispatch (a run with a
    fetch list: not a startup) of each program through its executor."""

    def __init__(self, eng):
        from paddle_tpu_torch.serving import engine as engine_mod

        self.first, self.steps, self.sample_s = {}, [], [0.0]
        self.runs = {}  # id(program) -> [program, fetch names, scope, n]
        lane, exe = eng._lane, eng._exe
        prefill, decode, run = lane.prefill_insert, lane.decode, exe.run
        sample = engine_mod._Slot.sample

        def prefill_insert(slot, prompt, **kw):
            out = prefill(slot, prompt, **kw)
            self.first[prompt.tobytes()] = time.perf_counter()
            return out

        def timed_decode(token, pos):
            t0 = time.perf_counter()
            out = decode(token, pos)
            self.steps.append((t0, time.perf_counter()))
            return out

        def counted_run(program, feed=None, fetch_list=None, scope=None,
                        **kw):
            if fetch_list:
                self.runs.setdefault(id(program), [
                    program, [v.name for v in fetch_list], scope, 0])[3] += 1
            return run(program, feed=feed, fetch_list=fetch_list,
                       scope=scope, **kw)

        def timed_sample(slot, row):
            t0 = time.perf_counter()
            out = sample(slot, row)
            self.sample_s[0] += time.perf_counter() - t0
            return out

        lane.prefill_insert, lane.decode, exe.run = \
            prefill_insert, timed_decode, counted_run
        self._restore = lambda: setattr(engine_mod._Slot, "sample", sample)
        engine_mod._Slot.sample = timed_sample

    def dispatches(self):
        return {k: v[3] for k, v in self.runs.items()}

    def k4(self, since=None):
        """The K4 launches of the dispatches since ``since`` (an earlier
        ``dispatches()``), by each program's fused layer norms."""
        since = since or {}
        return sum((n - since.get(k, 0)) * _fused_norms(p, f, s)
                   for k, (p, f, s, n) in self.runs.items())

    def close(self):
        self._restore()


def _check_k4(what, units, want_k4):
    """Each window of the launch meter ran K4 ``want_k4[i]`` times on the
    card and no other kernel of the port."""
    want = [tuple(k if i == 3 else 0 for i in range(len(COUNT_NAMES)))
            for k in want_k4]
    if list(units) != want:
        raise AssertionError("%s: the card ran %s = %s kernels, expected %s"
                             % (what, COUNT_NAMES, units, want))


def _serve_all(submit, traffic, **extra):
    """Every request of ``traffic`` submitted at once (a backlog) through
    ``submit``, then every result: (tokens, submit times, the seconds
    from the first submit to the last result)."""
    t0 = time.perf_counter()
    subs, reqs = [], []
    for prompt, n_new, kw in traffic:
        subs.append(time.perf_counter())
        reqs.append(submit(prompt, n_new, **kw, **extra))
    out = [r.result(timeout=600) for r in reqs]
    return out, subs, time.perf_counter() - t0


def _check_tokens(what, got, want):
    bad = [i for i, (g, w) in enumerate(zip(got, want))
           if not np.array_equal(g, w)]
    if bad:
        i = bad[0]
        pos = int(np.argmax(got[i] != want[i])) \
            if got[i].shape == want[i].shape else -1
        raise AssertionError("%s: %d of %d requests' tokens differ (request "
                             "%d first at position %d)" % (
                                 what, len(bad), len(got), i, pos))


def _pct(v, q):
    return float(np.percentile(np.asarray(v, dtype=np.float64), q))


def _hist_now(name):
    from paddle_tpu_torch import observe

    s = observe.snapshot()["metrics"][name]["samples"][0]
    return s["count"], s["sum"]


def _metric(name, **labels):
    from paddle_tpu_torch import observe

    for s in observe.snapshot()["metrics"][name]["samples"]:
        if all(s["labels"].get(k) == v for k, v in labels.items()):
            return s.get("value", s.get("count"))
    return 0.0


def _warm(eng, prompts, n=2):
    """Two requests of each prompt length, one after the other: each
    plan's eager run, then its capture."""
    for P in prompts:
        for _ in range(n):
            eng.submit(np.ones(P, "int64"), 2).result(timeout=600)


def _engine(ref, **kw):
    from paddle_tpu_torch.serving import DecodeEngine

    kw.setdefault("queue_capacity", 128)
    return DecodeEngine(ref.cfg, params=ref.params, b_max=ENGINE_B_MAX,
                        max_len=ENGINE_MAX_LEN, **kw)


def phase_engine(seed):
    """Phase 12: GPT-2 small served by ``DecodeEngine`` (b_max 8, a cache
    of 1024 rows, f32, level 2): ENGINE_REQUESTS requests submitted at
    once, prompts of 64-512 tokens, 16-128 new tokens, half greedy and
    half sampled; every request's tokens equal ``generate()``'s for it
    alone (batch 1), which also gives the sequential baseline's
    tokens/s; K4 counted on the card, 24 a prefill and 25 a decode step
    (the serving step's embedding seam fuses too)."""
    from paddle_tpu_torch.models import gpt

    cfg = gpt.base_config()
    t0 = time.perf_counter()
    ref = _Reference(cfg, seed)
    n_weights = sum(int(v.numel()) for v in ref.params.values())
    traffic = _engine_traffic(cfg["vocab"], np.random.RandomState(seed + 12),
                              ENGINE_REQUESTS, ENGINE_PROMPTS, ENGINE_NEW)
    # the reference warms each plan up (eager run, capture), then serves
    # the requests one after another
    for P in ENGINE_PROMPTS:
        for _ in range(2):
            ref.generate(np.ones(P, "int64"), 2)
    torch.cuda.synchronize()
    ts = time.perf_counter()
    want = [ref.generate(p, k, **kw) for p, k, kw in traffic]
    seq_s = time.perf_counter() - ts
    new_tokens = sum(k for _, k, _ in traffic)
    setup_s = time.perf_counter() - t0 - seq_s
    ref.traffic, ref.want = traffic, want  # phase 14b serves them again

    torch.cuda.synchronize()
    base_mib = torch.cuda.memory_allocated() / 2 ** 20
    torch.cuda.reset_peak_memory_stats()
    # ---- the main path: counts zeroed here, read after the last request
    _zero_counts()
    with LaunchMeter() as meter:
        meter.mark()
        tb = time.perf_counter()
        eng = _engine(ref)
        build_s = time.perf_counter() - tb
        probe = _EngineProbe(eng)
        eng.start()
        try:
            _warm(eng, ENGINE_PROMPTS)
            meter.mark()
            warm, host_warm = probe.dispatches(), _counts()
            occ0 = _hist_now("paddle_serving_slot_occupancy_ratio")
            probe.steps.clear()
            probe.sample_s[0] = 0.0
            got, subs, eng_s = _serve_all(eng.submit, traffic)
        finally:
            probe.close()
    # ---- end of the main path
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    _check_tokens("engine (12)", got, want)
    _check_k4("engine (12) warm-up and requests", meter.units,
              [probe.k4() - probe.k4(warm), probe.k4(warm)])
    if _counts() != host_warm:
        raise AssertionError("engine (12): the requests called kernel "
                             "launches from the host: not every dispatch "
                             "was a replay")
    per_kind = {("decode" if p is eng._lane._decode_prog else "prefill"):
                _fused_norms(p, f, s) for p, f, s, _ in probe.runs.values()}
    ttft = [(probe.first[p.tobytes()] - s) * 1e3
            for (p, _, _), s in zip(traffic, subs)]
    steps = probe.steps
    itl = np.diff([e for _, e in steps]) * 1e3
    step_ms = [(e - s) * 1e3 for s, e in steps]
    c1, s1 = _hist_now("paddle_serving_slot_occupancy_ratio")
    occupancy = (s1 - occ0[1]) / max(c1 - occ0[0], 1)
    graphs = _captured(eng._exe)
    # where a decode step's time goes: one step profiled alone
    token = np.ones((ENGINE_B_MAX, 1), "int64")
    pos = np.full((ENGINE_B_MAX, 1), ENGINE_MAX_LEN - 2, "int64")
    prof = _profiled(lambda: eng._lane.decode(token, pos))
    mem = eng._mem
    row = dict(
        n_weights=n_weights, requests=len(traffic), new_tokens=new_tokens,
        setup_s=setup_s, engine_build_s=build_s,
        tokens_per_s=new_tokens / eng_s, wall_s=eng_s,
        sequential_tokens_per_s=new_tokens / seq_s, sequential_s=seq_s,
        ttft_ms=dict(median=float(np.median(ttft)), max=max(ttft)),
        itl_ms=dict(median=float(np.median(itl)), p99=_pct(itl, 99)),
        decode_dispatch_ms=dict(median=float(np.median(step_ms)),
                                p99=_pct(step_ms, 99)),
        decode_steps=len(steps),
        sampling_ms_per_step=probe.sample_s[0] * 1e3 / max(len(steps), 1),
        mean_occupancy=occupancy, captures=len(graphs),
        capture_s=sorted(p.graph.seconds for p in graphs),
        pool_mib=_pool_mib(graphs[0]) if graphs else None,
        predicted_resident_mib=None if mem is None
        else mem["resident"] / 2 ** 20,
        predicted_at_512_mib=None if mem is None
        else eng.predicted_bytes(512) / 2 ** 20,
        allocated_before_mib=base_mib, peak_mib=peak_mib,
        decode_step_profile=prof, k4_per_dispatch=per_kind,
        dispatches=sum(probe.dispatches().values()),
        launches=dict(zip(COUNT_NAMES, meter.total())),
        host_launches=dict(zip(COUNT_NAMES, _counts())))
    eng.stop()
    log("engine (12): GPT-2 small (%d weights), b_max %d, cache %d rows: %d "
        "requests (%d new tokens) at once: %.1f tokens/s (%.3f s); one "
        "after another through generate at batch 1: %.1f tokens/s (%.3f "
        "s); time to first token median %.1f ms, max %.1f ms; between "
        "tokens median %.3f ms, p99 %.3f ms (a decode dispatch median %.3f "
        "ms; sampling %.3f ms a step; one step alone: device busy %.3f ms "
        "of %.3f ms); mean slot occupancy %.3f; %d captures (%s s), pool %s "
        "MiB; memory predicted resident %s MiB, at P = 512 %s MiB; "
        "allocated before %.1f MiB (the reference's weights, which the "
        "engine shares), peak %.1f MiB; every request's tokens equal "
        "generate()'s alone; K4 a dispatch %s on the card" % (
            n_weights, ENGINE_B_MAX, ENGINE_MAX_LEN, len(traffic),
            new_tokens, row["tokens_per_s"], eng_s,
            row["sequential_tokens_per_s"], seq_s, row["ttft_ms"]["median"],
            row["ttft_ms"]["max"], row["itl_ms"]["median"],
            row["itl_ms"]["p99"], row["decode_dispatch_ms"]["median"],
            row["sampling_ms_per_step"], prof["device_busy_ms"],
            prof["wall_ms"], occupancy, len(graphs),
            ["%.3f" % s for s in row["capture_s"]], row["pool_mib"],
            row["predicted_resident_mib"], row["predicted_at_512_mib"],
            base_mib, peak_mib, per_kind))
    _log_breakdown("engine decode step (12)", prof)
    return row, ref


def phase_prefix(seed, ref):
    """Phase 12b: PREFIX_REQUESTS requests sharing a PREFIX_LEN-token
    system prompt, each with its own suffix, half sampled, through an
    engine with a prefix store sized for the prefix and one without:
    each twice (the second pass replays every plan); tokens bitwise
    equal, the store's hits and misses, time to first token of each."""
    cfg = ref.cfg
    rs = np.random.RandomState(seed + 13)
    system = rs.randint(1, cfg["vocab"], (PREFIX_LEN,)).astype("int64")
    traffic = []
    for i in range(PREFIX_REQUESTS):
        suffix = rs.randint(1, cfg["vocab"], (int(rs.choice(
            PREFIX_SUFFIXES)),)).astype("int64")
        kw = dict(SAMPLED, seed=100 + i) if i % 2 else {}
        traffic.append((np.concatenate([system, suffix]), PREFIX_NEW, kw))
    d_head = cfg["d_model"] // cfg["n_head"]
    entry = 2 * cfg["n_layer"] * cfg["n_head"] * PREFIX_LEN * d_head * 4
    out, tokens = {}, {}
    for name, kw in (("no store", {}),
                     ("store", dict(prefix_cache_bytes=entry + (1 << 20)))):
        eng = _engine(ref, **kw)
        probe = _EngineProbe(eng)
        eng.start()
        h0, m0 = (_metric("paddle_serving_prefix_%s_total" % k)
                  for k in ("hits", "misses"))
        passes = []
        try:
            with LaunchMeter() as meter:
                for _ in range(2):
                    meter.mark()
                    before = probe.dispatches()
                    got, subs, wall = _serve_all(eng.submit, traffic,
                                                 prefix_len=PREFIX_LEN)
                    ttft = [(probe.first[p.tobytes()] - s) * 1e3
                            for (p, _, _), s in zip(traffic, subs)]
                    passes.append((got, ttft, wall, probe.k4(before)))
        finally:
            probe.close()
            eng.stop()
        _check_k4("prefix (12b) %s" % name, meter.units,
                  [p[3] for p in passes])
        hits = _metric("paddle_serving_prefix_hits_total") - h0
        misses = _metric("paddle_serving_prefix_misses_total") - m0
        tokens[name] = passes
        out[name] = dict(
            hits=hits, misses=misses,
            ttft_ms=[dict(median=float(np.median(t)), max=max(t))
                     for _, t, _, _ in passes],
            wall_s=[w for _, _, w, _ in passes],
            launches=dict(zip(COUNT_NAMES, meter.total())))
    for i in range(2):
        _check_tokens("prefix (12b) pass %d" % (i + 1),
                      tokens["store"][i][0], tokens["no store"][0][0])
    _check_tokens("prefix (12b) without a store, pass 2",
                  tokens["no store"][1][0], tokens["no store"][0][0])
    st = out["store"]
    if (st["misses"], st["hits"]) != (1, 2 * PREFIX_REQUESTS - 1) or \
            out["no store"]["hits"] or out["no store"]["misses"]:
        raise AssertionError("prefix (12b): %d hits and %d misses with the "
                             "store, %s without" % (
                                 st["hits"], st["misses"],
                                 out["no store"]))
    out["entry_bytes"] = entry
    log("prefix (12b): %d requests sharing a %d-token prefix (suffixes %s, "
        "%d new tokens): with the store (%.1f MB) %d hits and %d miss; "
        "time to first token median %.1f / %.1f ms (passes 1 / 2), without "
        "%.1f / %.1f ms; tokens bitwise the engine's without a store" % (
            PREFIX_REQUESTS, PREFIX_LEN, PREFIX_SUFFIXES, PREFIX_NEW,
            entry / 1e6, st["hits"], st["misses"],
            st["ttft_ms"][0]["median"], st["ttft_ms"][1]["median"],
            out["no store"]["ttft_ms"][0]["median"],
            out["no store"]["ttft_ms"][1]["median"]))
    return out


def _route_cost(ref):
    """GPT-2 small's verify step (ENGINE_B_MAX slots x SPEC_K + 1
    positions) with its products per position (the engine's
    ``products_per_position``) and with one product each, as two
    executors' captured graphs on one scope: the replays in turns
    (ROUTE_ROUNDS rounds of ROUTE_STEPS, CUDA events: device-bound), and
    one step of each on the same caches: (ms a replay per position, ms
    with one product, the logits' max |diff|)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.serving.engine import products_per_position

    plain, start = fluid.Program(), fluid.Program()
    with fluid.program_guard(plain, start):
        logits, _ = ref.gpt.build_multi_token_decode_step(
            ref.cfg, batch=ENGINE_B_MAX, steps=SPEC_K + 1,
            max_len=ENGINE_MAX_LEN)
    routed = plain.clone()
    products_per_position(routed, ENGINE_B_MAX)
    scope = fluid.Scope()
    exes = [fluid.Executor(fluid.CUDAPlace(0)) for _ in range(2)]
    exes[0].run(start, scope=scope)
    for n, v in ref.params.items():
        scope.set_var(n, v)
    feed = {"token": np.ones((ENGINE_B_MAX, SPEC_K + 1), "int64"),
            "pos": np.stack([np.arange(SPEC_K + 1) + 300]
                            * ENGINE_B_MAX).astype("int64")}
    out = []
    for exe, prog in zip(exes, (routed, plain)):
        for _ in range(3):  # eager, capture, replay
            (lv,) = exe.run(prog, feed=feed, fetch_list=[logits],
                            scope=scope)
        out.append(lv)
    graphs = [_captured(exe)[0].graph.graph for exe in exes]
    ms = ([], [])
    for r in range(ROUTE_ROUNDS):
        for i in ((0, 1) if r % 2 == 0 else (1, 0)):
            start_ev, end_ev = torch.cuda.Event(True), torch.cuda.Event(True)
            start_ev.record()
            for _ in range(ROUTE_STEPS):
                graphs[i].replay()
            end_ev.record()
            end_ev.synchronize()
            ms[i].append(start_ev.elapsed_time(end_ev) / ROUTE_STEPS)
    for exe in exes:
        exe.close()
    return (float(np.median(ms[0])), float(np.median(ms[1])),
            float(np.abs(out[0] - out[1]).max()))


def _batch_variant_ops(ref, batch):
    """Where a slot's logits at ``batch`` part from generate()'s at batch
    1: the level-2 serving decode step at ``batch`` (caches drawn from
    the seed, every slot at position 300) lowered op by op on
    ``ref``'s device, each op also run on slot 0's rows of its own
    inputs alone. Returns ({op type: max |diff| of slot 0's output} over
    the ops whose slot-0 output differs, the logits' max |diff| between
    slot 0 and the same ops run on slot 0's caches and feeds alone)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core.executor import feed_to_device
    from paddle_tpu_torch.core.lowering import LowerContext, lower_op
    from paddle_tpu_torch.core.passes import optimize_for_execution

    prog, start = fluid.Program(), fluid.Program()
    with fluid.program_guard(prog, start):
        logits, caches = ref.gpt.build_serving_decode_step(
            ref.cfg, batch=batch, max_len=ENGINE_MAX_LEN)
    device = ref.exe.device
    scope = fluid.Scope()
    ref.exe.run(start, scope=scope)
    prog = optimize_for_execution(prog, [logits.name], level=2)
    block = prog.global_block()
    env = {n: scope.find_var(n) for n in block.vars
           if scope.find_var(n) is not None}
    env.update((n, v.to(device)) for n, v in ref.params.items()
               if n in block.vars)
    gen = torch.Generator(device=device).manual_seed(7)
    for n in caches:
        env[n] = 0.1 * torch.randn(block.var(n).shape, generator=gen,
                                   device=device)
    rs = np.random.RandomState(7)
    feed = {"token": rs.randint(1, ref.cfg["vocab"], (batch, 1)),
            "pos": np.full((batch, 1), 300)}
    for n, v in feed.items():
        env[n] = feed_to_device(n, v.astype("int64"), block.var(n), device)
    one_env = {n: (v[:1].clone() if n in caches or n in feed else v)
               for n, v in env.items()}
    ctx = LowerContext(block, None, device, is_test=True)
    diffs = {}
    with torch.no_grad():
        for op in block.ops:
            solo = {}
            for names in op.inputs.values():
                for n in names:
                    v = env[n]
                    solo[n] = (v[:1].clone() if torch.is_tensor(v)
                               and v.ndim and v.shape[0] == batch else v)
            lower_op(ctx, op, solo)
            lower_op(ctx, op, env)
            lower_op(ctx, op, one_env)
            for names in op.outputs.values():
                for n in names:
                    v, w = env.get(n), solo.get(n)
                    if torch.is_tensor(v) and v.ndim and \
                            v.shape[0] == batch and w.shape[0] == 1:
                        d = float((v[:1].float() - w.float()).abs().max())
                        if d:
                            diffs[op.type] = max(diffs.get(op.type, 0.0), d)
    whole = float((env[logits.name][:1] - one_env[logits.name])
                  .abs().max())
    return diffs, whole


def phase_spec(seed, ref, plain_tps):
    """Phase 12c: SPEC_REQUESTS greedy requests through the engine with
    spec_k = SPEC_K and two drafts (the target's own config and weights,
    and GPT-2 small's widths at DRAFT_LAYERS layers with random weights),
    each against the plain engine on the same requests: tokens bitwise,
    accepted tokens per verify dispatch, tokens/s against the plain
    engine's; a verify dispatch's logits bitwise SPEC_K + 1 single decode
    steps (its products per position) and what that costs; where a
    slot's logits at b_max part from batch 1's."""
    import paddle_tpu_torch as fluid

    cfg = ref.cfg
    traffic = _engine_traffic(cfg["vocab"], np.random.RandomState(seed + 14),
                              SPEC_REQUESTS, SPEC_PROMPTS,
                              (SPEC_NEW, SPEC_NEW), sampled_every=0)
    draft_cfg = dict(cfg, n_layer=DRAFT_LAYERS)
    dprog, dstart = fluid.Program(), fluid.Program()
    dstart.random_seed = seed + 15
    with fluid.program_guard(dprog, dstart):
        _, dcaches = ref.gpt.build_decode_step(draft_cfg, batch=1,
                                               max_len=ENGINE_MAX_LEN)
    dscope = fluid.Scope()
    ref.exe.run(dstart, scope=dscope)
    draft_params = {n: dscope.find_var(n) for n in dprog.global_block().vars
                    if n.startswith("gpt_") and n not in dcaches}
    out, toks = {}, {}
    for name, kw in (("plain", {}),
                     ("agreeing draft", dict(draft_cfg=cfg,
                                             draft_params=ref.params,
                                             spec_k=SPEC_K)),
                     ("disagreeing draft", dict(draft_cfg=draft_cfg,
                                                draft_params=draft_params,
                                                spec_k=SPEC_K))):
        eng = _engine(ref, **kw)
        probe = _EngineProbe(eng)
        eng.start()
        try:
            _warm(eng, SPEC_PROMPTS)
            names = ("spec_proposed_tokens", "spec_accepted_tokens",
                     "spec_verify_steps", "decode_steps", "tokens")
            c0 = [_metric("paddle_serving_%s_total" % k) for k in names]
            before = probe.dispatches()
            with LaunchMeter() as meter:
                meter.mark()
                got, _, wall = _serve_all(eng.submit, traffic)
            c = dict(zip(names, (_metric("paddle_serving_%s_total" % k) - v
                                 for k, v in zip(names, c0))))
            _check_k4("spec (12c) %s" % name, meter.units,
                      [probe.k4(before)])
            if name == "agreeing draft":
                # a verify dispatch against single steps, at full width:
                # the same tokens written at the same positions
                lane = eng._lane
                vtok = np.random.RandomState(seed).randint(
                    1, cfg["vocab"], (ENGINE_B_MAX, SPEC_K + 1))
                vpos = np.stack([np.arange(SPEC_K + 1) + 200]
                                * ENGINE_B_MAX).astype("int64")
                multi = lane.multi_decode(vtok, vpos)
                single = [lane.decode(vtok[:, s:s + 1], vpos[:, s:s + 1])
                          for s in range(SPEC_K + 1)]
                diff = max(float(np.abs(multi[:, s] - single[s][:, 0]).max())
                           for s in range(SPEC_K + 1))
                if diff != 0.0:
                    raise AssertionError("spec (12c): a verify dispatch's "
                                         "logits differ from single steps' "
                                         "by %.3e" % diff)
        finally:
            probe.close()
            eng.stop()
        toks[name] = got
        verifies = max(c["spec_verify_steps"], 1)
        out[name] = dict(
            tokens_per_s=sum(k for _, k, _ in traffic) / wall, wall_s=wall,
            accepted=c["spec_accepted_tokens"],
            proposed=c["spec_proposed_tokens"],
            verify_dispatches=c["spec_verify_steps"],
            plain_steps=c["decode_steps"],
            accepted_per_verify=c["spec_accepted_tokens"] / verifies,
            tokens_per_dispatch=(c["tokens"] - len(traffic)) / max(
                c["spec_verify_steps"] + c["decode_steps"], 1),
            launches=dict(zip(COUNT_NAMES, meter.total())))
    for name in ("agreeing draft", "disagreeing draft"):
        _check_tokens("spec (12c) %s" % name, toks[name], toks["plain"])
    agree = out["agreeing draft"]
    if not agree["accepted"]:
        raise AssertionError("spec (12c): the agreeing draft had none of "
                             "%d drafts accepted" % agree["proposed"])
    per_position, one_product, route_diff = _route_cost(ref)
    variant, batch_diff = _batch_variant_ops(ref, ENGINE_B_MAX)
    out["route"] = dict(ms=per_position, one_product_ms=one_product,
                        logits_max_abs_diff=route_diff)
    out["batch1_vs_b_max"] = dict(logits_max_abs_diff=batch_diff,
                                  ops=variant)
    out["phase12_tokens_per_s"] = plain_tps
    log("spec (12c): %d greedy requests, %d new tokens each, k = %d: plain "
        "engine %.1f tokens/s; agreeing draft %d of %d accepted (%.2f a "
        "verify dispatch), %.2f tokens a target dispatch, %.1f tokens/s; "
        "disagreeing draft (%d layers) %d of %d accepted (%.2f a verify "
        "dispatch), %.2f tokens a target dispatch, %.1f tokens/s (phase "
        "12: %.1f); tokens bitwise the plain engine's; a "
        "verify dispatch's logits bitwise %d single steps; a replayed "
        "verify step with its products per position %.4f ms, with one "
        "product %.4f ms (logits max |diff| %.3e); slot 0's logits at "
        "b_max %d against the same step at batch 1: max |diff| %.3e, the "
        "ops whose slot-0 output depends on the batch (on the same "
        "inputs): %s" % (
            SPEC_REQUESTS, SPEC_NEW, SPEC_K, out["plain"]["tokens_per_s"],
            agree["accepted"], agree["proposed"],
            agree["accepted_per_verify"], agree["tokens_per_dispatch"],
            agree["tokens_per_s"], DRAFT_LAYERS,
            out["disagreeing draft"]["accepted"],
            out["disagreeing draft"]["proposed"],
            out["disagreeing draft"]["accepted_per_verify"],
            out["disagreeing draft"]["tokens_per_dispatch"],
            out["disagreeing draft"]["tokens_per_s"], plain_tps,
            SPEC_K + 1, per_position, one_product, route_diff,
            ENGINE_B_MAX, batch_diff,
            {k: "%.3e" % v for k, v in variant.items()}))
    return out


def phase_router(seed, ref):
    """Phase 12d: two GPT-2 small replicas on the card behind
    ``ReplicaRouter``; ROUTER_REQUESTS requests from tenants "a" and "b"
    (tenant "b" capped at ROUTER_QUOTA in flight: the rest of its
    submits are refused at admission); replica 0's scheduler stopped by
    a fault injected at its ROUTER_FAULT_AT-th decode dispatch. Every
    admitted request ends exactly once with the tokens of ``generate()``
    alone; the stopped replica's requests are readmitted and the replica
    restarted."""
    from paddle_tpu_torch.serving import ReplicaRouter, TenantQuotaExceeded

    cfg = ref.cfg
    traffic = _engine_traffic(cfg["vocab"], np.random.RandomState(seed + 16),
                              ROUTER_REQUESTS, SPEC_PROMPTS,
                              (ROUTER_NEW, ROUTER_NEW))
    built = []

    def factory(idx):
        eng = _engine(ref)
        built.append(idx)
        return eng

    t0 = time.perf_counter()
    router = ReplicaRouter(factory, n_replicas=2,
                           tenant_quotas={"b": ROUTER_QUOTA}, poll_s=0.05,
                           max_readmissions=3)
    try:
        for rep in router.replicas:
            _warm(rep.engine, SPEC_PROMPTS)
        start_s = time.perf_counter() - t0
        eng0 = router.replicas[0].engine
        decode, calls = eng0._lane.decode, [0]

        def faulty(token, pos):
            calls[0] += 1
            if calls[0] == ROUTER_FAULT_AT:
                raise RuntimeError("injected replica fault")
            return decode(token, pos)

        eng0._lane.decode = faulty
        re0 = _metric("paddle_serving_router_readmitted_total")
        rs0 = _metric("paddle_serving_router_replica_restarts_total",
                      replica="0")
        done, reqs, refused = [], [], []
        t1 = time.perf_counter()
        for i, (p, k, kw) in enumerate(traffic):
            tenant = "b" if i % 2 else "a"
            try:
                r = router.submit(p, k, tenant=tenant, **kw)
            except TenantQuotaExceeded:
                refused.append(i)
                continue
            r.add_done_callback(done.append)
            reqs.append((i, r))
        got = [(i, r.result(timeout=600)) for i, r in reqs]
        wall = time.perf_counter() - t1
        readmitted = _metric("paddle_serving_router_readmitted_total") - re0
        deadline = time.monotonic() + 300
        while time.monotonic() < deadline and (
                _metric("paddle_serving_router_replica_restarts_total",
                        replica="0") <= rs0
                or not all(r.engine.alive() for r in router.replicas)):
            time.sleep(0.05)
        restarted = _metric("paddle_serving_router_replica_restarts_total",
                            replica="0") - rs0
        alive = all(r.engine.alive() for r in router.replicas)
    finally:
        router.close()
    want = [ref.generate(traffic[i][0], traffic[i][1], **traffic[i][2])
            for i, _ in got]
    _check_tokens("router (12d)", [g for _, g in got], want)
    if len(done) != len(reqs) or {id(r) for r in done} != \
            {id(r) for _, r in reqs}:
        raise AssertionError("router (12d): %d of %d requests ended, some "
                             "more than once" % (len(done), len(reqs)))
    if calls[0] < ROUTER_FAULT_AT or not readmitted or not restarted or \
            not alive or not refused:
        raise AssertionError("router (12d): fault fired %s, %d readmitted, "
                             "%d restarts, alive %s, %d refused by the "
                             "quota" % (calls[0] >= ROUTER_FAULT_AT,
                                        readmitted, restarted, alive,
                                        len(refused)))
    out = dict(admitted=len(reqs), refused_by_quota=len(refused),
               readmitted=readmitted, restarts=restarted,
               engines_built=len(built), start_s=start_s, wall_s=wall,
               tokens_per_s=sum(len(g) - len(traffic[i][0])
                                for i, g in got) / wall)
    log("router (12d): 2 replicas (started and warmed in %.1f s); %d "
        "requests from 2 tenants: %d admitted, %d refused by tenant b's "
        "quota of %d; replica 0 stopped at its decode dispatch %d: %d "
        "requests readmitted, the replica restarted (%d engines built); "
        "every admitted request ended once, tokens equal generate()'s "
        "alone; %.1f tokens/s through the fault" % (
            start_s, len(traffic), len(reqs), len(refused), ROUTER_QUOTA,
            ROUTER_FAULT_AT, readmitted, len(built), out["tokens_per_s"]))
    return out


def phase_batcher(pred, seed):
    """Phase 12e: ``MicroBatcher`` (max_rows BATCHER_MAX_ROWS) over phase
    4's BERT-base Predictor (buckets 1, 4, 8, each a captured graph):
    BATCHER_REQUESTS requests of 1-3 rows from BATCHER_THREADS threads;
    every answer against its rows run alone within BATCHER_ATOL; each
    dispatch launches K1 12 and K4 25 times on the card."""
    import threading

    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.serving import MicroBatcher

    cfg = bert.base_config()
    rs = np.random.RandomState(seed + 17)
    reqs = [_request(int(rs.randint(1, 4)), cfg, rs)
            for _ in range(BATCHER_REQUESTS)]
    solo = [pred.run(r)[0] for r in reqs]
    b0 = _metric("paddle_serving_batches_total")
    rows0 = _hist_now("paddle_serving_batch_rows")
    results, lat = [None] * len(reqs), [None] * len(reqs)
    errors = []
    n = cfg["n_layer"]
    per = (n, 0, 0, 2 * n + 1, 0, 0, 0, 0, 0, 0)
    with MicroBatcher(pred, max_rows=BATCHER_MAX_ROWS,
                      max_wait_s=0.002) as mb:

        def client(k):
            try:
                for i in range(k, len(reqs), BATCHER_THREADS):
                    t0 = time.perf_counter()
                    results[i] = mb.submit(reqs[i]).result(timeout=600)[0]
                    lat[i] = (time.perf_counter() - t0) * 1e3
            except BaseException as e:  # noqa: BLE001 - fails the phase
                errors.append(e)

        with LaunchMeter() as meter:
            meter.mark()
            t0 = time.perf_counter()
            threads = [threading.Thread(target=client, args=(k,))
                       for k in range(BATCHER_THREADS)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
            wall = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError("batcher (12e): a client failed: %r"
                             % (errors[:1],))
    batches = _metric("paddle_serving_batches_total") - b0
    rows1 = _hist_now("paddle_serving_batch_rows")
    if meter.units != [_times(per, int(batches))]:
        raise AssertionError("batcher (12e): the card ran %s = %s kernels "
                             "in %d dispatches, expected %s each" % (
                                 COUNT_NAMES, meter.units, batches, per))
    err = max(float(np.abs(r - s).max()) for r, s in zip(results, solo))
    if err > BATCHER_ATOL or not all(np.isfinite(r).all()
                                     for r in results):
        raise AssertionError("batcher (12e): coalesced answers differ from "
                             "their rows run alone by %.3e > %.0e"
                             % (err, BATCHER_ATOL))
    rows = rows1[1] - rows0[1]
    out = dict(requests=len(reqs), rows=rows, dispatches=batches,
               rows_per_dispatch=rows / max(batches, 1),
               latency_ms=dict(median=float(np.median(lat)),
                               p99=_pct(lat, 99)),
               wall_s=wall, max_abs_err=err,
               launches=dict(zip(COUNT_NAMES, meter.total())))
    log("batcher (12e): %d requests (%d rows) from %d threads: %d "
        "dispatches, %.2f rows a dispatch; latency median %.3f ms, p99 "
        "%.3f ms; answers within %.3e of their rows alone (<= %.0e); each "
        "dispatch ran %s = %s on the card" % (
            len(reqs), rows, BATCHER_THREADS, batches,
            out["rows_per_dispatch"], out["latency_ms"]["median"],
            out["latency_ms"]["p99"], err, BATCHER_ATOL, COUNT_NAMES, per))
    return out


# ------------------------------------------------------ phases 13-13c
# LAMB at the BERT recipe's settings (You et al., 2020): the Lamb
# optimizer's defaults, beta1 0.9, beta2 0.999, epsilon 1e-6, weight
# decay 0.01, at TRAIN_LR; timed steps after WARMUP_STEPS; replayed
# against eager pairs; steps of the checkpointed train_loop run and the
# step after which it saves
LAMB_STEPS, LAMB_PAIRS, CKPT_STEPS, CKPT_AT = 4, 2, 10, 5
# phase 13c: each optimizer's steps (eager, capture, replay) and its
# batch; the card against the CPU lowerings: elementwise updates at a
# relative 2e-6 (FMA contraction on the card), the norms' reductions
# (lars_momentum) at 1e-5, K6 (ModelAverage's Adam) at OPT_TOL absolute;
# BERT-base's widths at OTHER_LAYERS of its 12 layers (every param shape
# of the 12 is there; the depth cut keeps the whole script in its time)
OTHER_STEPS, OTHER_BATCH, OTHER_LAYERS = 3, 2, 4
OTHER_RTOL, OTHER_NORM_RTOL, OTHER_ATOL = 2e-6, 1e-5, 1e-7


def _lamb_optimizer_ms(scope, params):
    """Device ms of one LAMB update of every param, the unfused ``lamb``
    lowering launched alone on the step's param shapes (random grads and
    moments), profiled: the optimizer's share of a step."""
    from paddle_tpu_torch.core.lowering import LowerContext
    from paddle_tpu_torch.core.registry import get_op

    dev = torch.device("cuda", 0)
    ctx = LowerContext(None, None, dev)
    lamb = get_op("lamb").lowering
    gen = torch.Generator(device=dev).manual_seed(0)
    ins = []
    for n in params:
        p = scope.find_var(n)
        g = torch.randn(p.shape, generator=gen, device=dev) * 1e-3
        ins.append({"Param": [p], "Grad": [g], "Moment1": [g * 0.1],
                    "Moment2": [g * g], "Beta1Pow": [torch.full(
                        (1,), 0.9, device=dev)], "Beta2Pow": [torch.full(
                            (1,), 0.999, device=dev)],
                    "LearningRate": [torch.full((1,), TRAIN_LR,
                                                device=dev)]})
    attrs = dict(beta1=0.9, beta2=0.999, epsilon=1e-6, weight_decay=0.01)
    prof = _profiled(lambda: [lamb(ctx, i, attrs) for i in ins])
    return prof["device_busy_ms"], prof["kernels"]


def phase_lamb(seed, amp):
    """Phase 13 (f32) / 13b (AMP): BERT-base MLM (S = 512, batch 8,
    dropout 0.1) with ``Lamb`` at level 2: each step launches K1 24, K2
    12, K3 12 and K4 25 times and no K6 (level 2 fuses only adam and sgd
    runs: the 157 lamb ops run unfused); replayed steps bitwise eager in
    turns, level 2 against level 0 within phase 8's gates (AMP's under
    AMP), ``train_loop`` at K = 1 bitwise the run loop."""
    what = "LAMB AMP (13b)" if amp else "LAMB (13)"
    t0 = time.perf_counter()
    (exe, scope, main, loss, params, grads, batches,
     tier) = _train_setup("Lamb", seed, amp)
    cfg = bert_cfg()
    n = cfg["n_layer"]
    per_step = _amp_per_step(cfg, "Lamb") if amp else \
        (2 * n, n, n, 2 * n + 1, 0, 0, 0, 0, 0, 0)
    lamb_ops = sum(op.type == "lamb" for op in main.global_block().ops)
    if (tier["ln_residual_fused"], tier["optimizer_groups"], lamb_ops) != (
            2 * n + 1, [], len(params)):
        raise AssertionError("%s: level 2 fused %d layer norms and "
                             "optimizer groups %s over %d lamb ops" % (
                                 what, tier["ln_residual_fused"],
                                 tier["optimizer_groups"], lamb_ops))
    build_s = time.perf_counter() - t0
    step = _amp_step_fn(exe, main, loss)
    snap = _snapshot(scope)
    # ---- the main path: counts zeroed here, read after the last step
    for k in ("PADDLE_TPU_FLASH_MIN_SEQ", "PADDLE_TPU_OPTIMIZE"):
        os.environ.pop(k, None)
    path = _metered_steps(what, step, scope, batches,
                          WARMUP_STEPS + LAMB_STEPS, per_step)
    # ---- end of the main path
    if amp and _f32_masters(scope, params):
        raise AssertionError("%s: params or moments left f32" % what)
    paths = _run_paths(step, snap, batches, params, grads, {
        "main": ({}, ()),
        "level 0": ({"PADDLE_TPU_OPTIMIZE": "0"},
                    (3, 9) if amp else (3,))})
    parity = _parity(paths["main"], paths["level 0"], params, before=snap)
    del paths
    (_check_amp_parity if amp else _check_flip_parity)(what, parity)
    compiled = phase_compiled_train(what, exe, main, loss, snap, batches,
                                    params, step, per_step,
                                    pairs=LAMB_PAIRS)
    # train_loop at K = 1 against the run loop, from the snapshot
    reader = _fresh(batches, 4)
    sc_loop, sc_run = _restored(snap), _restored(snap)
    seen = _loop_values(exe, main, [loss], sc_loop, reader, 1)
    ran = [step(sc_run, b) for b in reader()]
    looped = [float(np.asarray(seen[i][0]).reshape(()))
              for i in range(len(ran))]
    if looped != ran or not all(torch.equal(sc_loop.find_var(p),
                                            sc_run.find_var(p))
                                for p in params):
        raise AssertionError("%s: train_loop differs from the run loop: "
                             "%s / %s" % (what, looped, ran))
    opt_ms, opt_kernels = _lamb_optimizer_ms(scope, params)
    prof = compiled["replay_profile"]
    med = float(np.median(path["step_ms"][WARMUP_STEPS:]))
    out = dict(build_s=build_s, lamb_ops=lamb_ops, tier=tier,
               losses=path["losses"], step_ms=path["step_ms"],
               launches=dict(zip(COUNT_NAMES, path["launches"])),
               host_launches=dict(zip(COUNT_NAMES, path["host_launches"])),
               per_step=dict(zip(COUNT_NAMES, per_step)),
               parity=dict(steps=PARITY_STEPS, **parity),
               compiled=compiled, loop_losses=looped,
               optimizer_device_ms=opt_ms, optimizer_kernels=opt_kernels,
               peak_mem_mib=path["peak_mb"], step_ms_median=med,
               snapshot=snap, exe=exe, main=main, loss=loss,
               params=params, batches=batches)
    log("%s: %d lamb ops unfused, %d fused layer norms; replayed %.3f ms a "
        "step (%.1f tokens/s), eager %.3f ms; busy %.1f%%, %d kernels a "
        "replayed step, device ms by class %s; the %d lamb updates alone "
        "%.3f ms on the device in %d kernels (the optimizer's share); "
        "launches a step %s = %s; train_loop at K = 1 bitwise the run loop "
        "over %d steps; peak memory %.1f MiB" % (
            what, lamb_ops, tier["ln_residual_fused"],
            compiled["replay_median_ms"], compiled["replay_tokens_per_s"],
            compiled["eager_median_ms"], 100 * prof["busy_share"],
            prof["kernels"], {k: round(v, 3) for k, v in
                              prof["by_class_ms"].items()},
            lamb_ops, opt_ms, opt_kernels, COUNT_NAMES, per_step, len(ran),
            path["peak_mb"]))
    return out


def phase_checkpoint(lamb):
    """Phase 13's checkpoint (f32, dropout 0.1): ``train_loop`` for
    CKPT_STEPS steps uninterrupted; on a second scope CKPT_AT steps, then
    ``save_persistables_async(extra_vars=[RNG_VAR])`` while the loop goes
    on; a fresh executor and scope restored with ``load_persistables``
    and the chain take the remaining steps. Those steps' losses and every
    persistable bitwise the uninterrupted run's; the async file equals a
    ``save_persistables`` of the same state; ``save_params`` /
    ``load_params`` round-trip. The blocked ms, write seconds, bytes."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import io
    from paddle_tpu_torch.core.executor import RNG_VAR
    from paddle_tpu_torch.native import tensor_store

    exe, main, loss, snap = (lamb[k] for k in ("exe", "main", "loss",
                                               "snapshot"))
    persist = [v.name for v in main.list_vars() if v.persistable]
    seq = [lamb["batches"][i % len(lamb["batches"])]
           for i in range(CKPT_STEPS)]

    def reader(lo, hi):
        return lambda: ({k: v.copy() for k, v in b.items()}
                        for b in seq[lo:hi])

    def losses(seen):
        return [float(np.asarray(seen[i][0]).reshape(()))
                for i in sorted(seen)]

    sc_a, sc_b = _restored(snap), _restored(snap)
    whole = losses(_loop_values(exe, main, [loss], sc_a,
                                reader(0, CKPT_STEPS), 1))
    first = losses(_loop_values(exe, main, [loss], sc_b,
                                reader(0, CKPT_AT), 1))
    write_s = []
    save = tensor_store.save_tensors

    def timed_save(path, arrays):
        t0 = time.perf_counter()
        save(path, arrays)
        write_s.append(time.perf_counter() - t0)

    with tempfile.TemporaryDirectory() as d:
        tensor_store.save_tensors = timed_save
        try:
            at_save = _snapshot(sc_b)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ckpt = io.save_persistables_async(
                exe, os.path.join(d, "async"), main, scope=sc_b,
                extra_vars=[RNG_VAR])
            blocked_ms = (time.perf_counter() - t0) * 1e3
            rest = losses(_loop_values(exe, main, [loss], sc_b,
                                       reader(CKPT_AT, CKPT_STEPS), 1))
            ckpt.wait()
        finally:
            tensor_store.save_tensors = save
        path = os.path.join(d, "async", "__model_combined__")
        nbytes = os.path.getsize(path)
        io.save_persistables(exe, os.path.join(d, "sync"), main,
                             scope=_restored(at_save))
        a = tensor_store.load_tensors(path)
        s = tensor_store.load_tensors(os.path.join(d, "sync",
                                                   "__model_combined__"))
        same_file = sorted(s) == sorted(persist) and \
            set(a) == set(s) | {RNG_VAR} and all(
                np.array_equal(a[k], s[k]) for k in s)
        exe2, fresh = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
        io.load_persistables(exe2, os.path.join(d, "async"), main,
                             scope=fresh)
        io.load_vars(exe2, os.path.join(d, "async"), main, vars=[RNG_VAR],
                     scope=fresh)
        resumed = losses(_loop_values(exe2, main, [loss], fresh,
                                      reader(CKPT_AT, CKPT_STEPS), 1))
        io.save_params(exe, os.path.join(d, "params"), main, scope=sc_a)
        params_back = fluid.Scope()
        io.load_params(exe2, os.path.join(d, "params"), main,
                       scope=params_back)
        round_trip = all(torch.equal(params_back.find_var(p),
                                     sc_a.find_var(p))
                         for p in lamb["params"])
    exe2.close()
    bitwise = resumed == whole[CKPT_AT:] and \
        first + rest == whole and all(
            torch.equal(fresh.find_var(n), sc_a.find_var(n))
            for n in persist)
    if not (bitwise and same_file and round_trip):
        raise AssertionError("checkpoint (13): resumed bitwise %s (losses "
                             "%s / %s), async file = sync file %s, params "
                             "round trip %s" % (
                                 bitwise, resumed, whole[CKPT_AT:],
                                 same_file, round_trip))
    out = dict(steps=CKPT_STEPS, saved_after=CKPT_AT, blocked_ms=blocked_ms,
               write_s=write_s[0], bytes=nbytes, losses=whole,
               resumed=resumed, vars=len(a))
    log("checkpoint (13): train_loop %d steps; after step %d "
        "save_persistables_async blocked the caller %.1f ms (%d vars, %.1f "
        "MB, every value copied off the card), the background write took "
        "%.3f s while steps %d-%d ran; a fresh executor and scope restored "
        "from the file ran steps %d-%d bitwise the uninterrupted run "
        "(losses and %d persistables); the async file equals "
        "save_persistables of the same state; save_params / load_params "
        "round-trip" % (
            CKPT_STEPS, CKPT_AT, blocked_ms, len(a), nbytes / 1e6,
            write_s[0], CKPT_AT + 1, CKPT_STEPS, CKPT_AT + 1, CKPT_STEPS,
            len(persist)))
    return out


def _other_optimizers():
    """Phase 13c's optimizers (``fluid.optimizer`` classes), each a
    factory of (optimizer, after-minimize hook)."""
    import paddle_tpu_torch as fluid

    o = fluid.optimizer
    lr = TRAIN_LR
    return {
        "LarsMomentum": lambda: o.LarsMomentum(lr, momentum=0.9),
        "Adamax": lambda: o.Adamax(lr),
        "Adagrad": lambda: o.Adagrad(lr),
        "DecayedAdagrad": lambda: o.DecayedAdagrad(lr),
        "Adadelta": lambda: o.Adadelta(lr),
        "RMSProp centered": lambda: o.RMSProp(lr, momentum=0.9,
                                              centered=True),
        "Ftrl": lambda: o.Ftrl(lr, l1=1e-4, l2=1e-4),
        "ModelAverage (Adam)": lambda: o.Adam(lr),
    }


def _cpu_update(main, before, grads):
    """The program's optimize ops lowered on the CPU, in program order,
    from ``before`` (the state before a step) and the step's ``grads``:
    {var: value after} of every var they write."""
    from paddle_tpu_torch.core.lowering import LowerContext
    from paddle_tpu_torch.core.registry import get_op

    ctx = LowerContext(None, None, torch.device("cpu"))
    env = dict(before, **grads)
    written = set()
    for op in main.global_block().ops:
        if op.attrs.get("__op_role__") != "optimize":
            continue
        ins = {s: [env[n] for n in names] for s, names in op.inputs.items()}
        outs = get_op(op.type).lowering(ctx, ins, dict(op.attrs))
        for s, names in op.outputs.items():
            for name, v in zip(names, outs.get(s) or []):
                env[name] = v
                written.add(name)
    return {n: env[n] for n in written}


def phase_other_optimizers(seed):
    """Phase 13c: BERT-base f32 at depth OTHER_LAYERS (batch
    OTHER_BATCH) with each of ``_other_optimizers``: OTHER_STEPS steps
    (eager, capture, replay) bitwise the plan's eager steps on a second
    scope; after every step
    the state each optimize op writes matches the same lowerings run on
    the CPU from the state before it and the step's grads; ModelAverage's
    ``apply()`` swaps in the averages and ``restore()`` brings the
    params back bitwise."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import bert

    cfg = dict(bert_cfg(), n_layer=OTHER_LAYERS)
    n = cfg["n_layer"]
    rs = np.random.RandomState(seed + 18)
    batches = [{k: v[:OTHER_BATCH] for k, v in _train_batch(cfg, rs).items()}
               for _ in range(OTHER_STEPS)]
    out = {}
    for name, make in _other_optimizers().items():
        t0 = time.perf_counter()
        main, startup = fluid.Program(), fluid.Program()
        main.random_seed = startup.random_seed = seed
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            loss, _ = bert.build(cfg, seq_len=SEQ, max_mask=MAX_MASK)
            _, params_grads = make().minimize(loss)
            ma = fluid.optimizer.ModelAverage(
                0.5, min_average_window=2, max_average_window=3) \
                if name.startswith("ModelAverage") else None
        exe = fluid.Executor(fluid.CUDAPlace(0))
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        params = [p.name for p, _ in params_grads]
        grad_names = [g.name for _, g in params_grads]
        scope_e = _restored(_snapshot(scope))
        adam = name.startswith("ModelAverage")
        per = (2 * n, n, n, 2 * n + 1, int(adam), 0, 0, 0, 0, 0)
        def host_state():
            return {k: scope.find_var(k).cpu()
                    for k in scope.local_var_names()
                    if isinstance(scope.find_var(k), torch.Tensor)}

        worst, losses, ran = ("", 0.0), [], (0,) * len(COUNT_NAMES)
        before = host_state()
        for i, feed in enumerate(batches):
            with LaunchMeter() as meter:
                meter.mark()
                vals = exe.run(main, feed=feed,
                               fetch_list=[loss] + grad_names, scope=scope,
                               return_numpy=False)
            eager = exe._run_eager(main, feed=feed,
                                   fetch_list=[loss] + grad_names,
                                   scope=scope_e, return_numpy=False)
            if meter.units != [per]:
                raise AssertionError("%s (13c) step %d ran %s = %s on the "
                                     "card, expected %s" % (
                                         name, i, COUNT_NAMES, meter.units,
                                         per))
            ran = tuple(a + b for a, b in zip(ran, meter.units[0]))
            if not all(torch.equal(a, b) for a, b in zip(vals, eager)):
                raise AssertionError("%s (13c) step %d: the replayed "
                                     "step's loss or grads differ from the "
                                     "eager step's" % (name, i))
            losses.append(float(vals[0].reshape(())))
            grads = {g: v.cpu() for g, v in zip(grad_names, vals[1:])}
            want = _cpu_update(main, before, grads)
            before = host_state()
            for var, w in want.items():
                g = before[var]
                if not torch.equal(scope.find_var(var),
                                   scope_e.find_var(var)):
                    raise AssertionError("%s (13c) step %d: %s replayed "
                                         "differs from eager" % (name, i,
                                                                 var))
                if g.dtype.is_floating_point:
                    rtol = OTHER_NORM_RTOL if name == "LarsMomentum" \
                        else OTHER_RTOL
                    atol = OPT_TOL if adam else OTHER_ATOL
                    # |card - CPU| over its bound atol + rtol |CPU|
                    r = float(((g - w).abs() / (atol + rtol * w.abs()))
                              .max())
                    worst = max(worst, (var, r), key=lambda t: t[1])
                    if r > 1.0:
                        raise AssertionError(
                            "%s (13c) step %d: %s on the card against the "
                            "CPU lowering: %.3f of the bound (atol %.0e, "
                            "rtol %.0e)" % (name, i, var, r, atol, rtol))
                elif not torch.equal(g, w):
                    raise AssertionError("%s (13c) step %d: %s (%s) differs "
                                         "from the CPU lowering" % (
                                             name, i, var, g.dtype))
        plan = next(p for p in _captured(exe) if p.graph.bound_to(scope))
        row = dict(steps=OTHER_STEPS, seconds=time.perf_counter() - t0,
                   capture_s=plan.graph.seconds,
                   losses=losses, worst_vs_cpu=worst,
                   launches=dict(zip(COUNT_NAMES, ran)))
        if ma is not None:
            trained = {p: scope.find_var(p).clone() for p in params}
            with ma.apply(exe, scope):
                avg_ok = all(
                    torch.equal(scope.find_var(p.name), (sum(
                        scope.find_var(s.name).double() for s in sums)
                        / torch.clamp(scope.find_var(na.name).double()
                                      + scope.find_var(ona.name).double(),
                                      min=1.0)).float())
                    for p, sums, na, ona in ma._params)
                moved = not all(torch.equal(scope.find_var(p), trained[p])
                                for p in params)
            restored = all(torch.equal(scope.find_var(p), trained[p])
                           for p in params)
            if not (avg_ok and moved and restored):
                raise AssertionError("ModelAverage (13c): averages exact %s, "
                                     "swapped in %s, restored %s" % (
                                         avg_ok, moved, restored))
            row["model_average"] = dict(averages_exact=avg_ok,
                                        restored=restored)
        exe.close()
        out[name] = row
        log("other optimizers (13c): %s: %d steps (eager, capture, replay) "
            "bitwise eager; state after each step against the CPU "
            "lowerings: worst |diff| %.3f of its bound (%s); %.1f s "
            "(capture %.3f s)%s"
            % (name, OTHER_STEPS, worst[1], worst[0], row["seconds"],
               row["capture_s"], "; apply() averages exact, restore() "
               "bitwise" if ma is not None else ""))
        del exe, scope, scope_e
        _free()
    return out


# ------------------------------------------------------- phases 14-15
# the frozen BERT-base's buckets and requests (14): each request of a
# bucket's exact batch, so every one takes the AOT section
ART_BUCKETS = (1, 4, 8)
ART_REPEATS = 10
# BERT-base's widths at ART_LAYERS of its 12 layers: most of phase 14's
# time is the artifact's deflate, which its size sets (87.7 s at depth 12,
# 44.2 s at 4 on an H100); the depth cut keeps the whole script inside its
# 1200 s on a host as slow as the slowest whole runs seen (1153 s to
# phase 20b at this depth)
ART_LAYERS = 4
# the dygraph encoder (15): BERT-base widths, S = 512, batch 8, 3 steps
DY_BATCH, DY_STEPS, DY_MASK, DY_LR = 8, 3, 80, 1e-4
DY_REPLAYS = 3  # the level-2 capture's replays timed after the gated steps


def _freeze_bert(workdir, seed):
    """BERT-base's serving program (S = 512, random weights from the
    seed) started on the card: frozen to an artifact with AOT buckets
    ``ART_BUCKETS`` and saved as an inference model beside it. Returns
    (cfg, artifact path, model dir, save seconds, artifact bytes,
    the fused layer norms, the encoder output's name)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import export
    from paddle_tpu_torch.models import bert

    cfg = dict(bert.base_config(), n_layer=ART_LAYERS)
    feeds = ["src_ids", "sent_ids", "input_mask"]
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        bert.build(cfg, seq_len=SEQ, is_test=True)
    enc = _encoder_output(main)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope = fluid.Scope()
    model_dir = os.path.join(workdir, "model")
    path = os.path.join(workdir, "bert_base.pdz")
    with fluid.scope_guard(scope):
        exe.run(startup)
        fluid.io.save_inference_model(model_dir, feeds, [enc], exe,
                                      main_program=main)
        t0 = time.perf_counter()
        export.save_artifact(main, path, feed_names=feeds,
                             fetch_names=[enc.name], scope=scope,
                             batch_sizes=ART_BUCKETS, name="bert-base")
        save_s = time.perf_counter() - t0
    fused = _tier_stats(main, [enc.name], scope)["ln_residual_fused"]
    del scope, exe
    _free()
    return cfg, path, model_dir, save_s, os.path.getsize(path), fused, \
        enc.name


def _cold_counters():
    """The counters a cold start may (seeded plans, AOT calls) and may
    not (plan-cache misses, pipeline runs, tuner misses) move."""
    from paddle_tpu_torch.observe import families as fam

    return dict(plan_misses=fam.EXECUTOR_CACHE_MISSES.value,
                optimizer_runs=sum(fam.OPTIMIZER_PROGRAMS.labels(
                    level=lv).value for lv in ("1", "2")),
                tuner_misses=fam.KERNEL_TUNER_MISSES.value,
                plans_seeded=fam.ARTIFACT_PLANS_SEEDED.value,
                aot_calls=fam.ARTIFACT_AOT_CALLS.value)


def _serve_requests(run, reqs, repeats):
    """Each request ``repeats`` times through ``run``: (answers of the
    first time, host-clock ms of every call per request); a repeat that
    answers otherwise fails."""
    answers, lat = [], []
    for req in reqs:
        lat.append([])
        for rep in range(repeats):
            ms, (out,) = _timed(lambda: run(req))
            lat[-1].append(ms)
            if rep == 0:
                answers.append(out)
            elif not np.array_equal(out, answers[-1]):
                raise AssertionError("a repeated request gave another "
                                     "answer")
    return answers, lat


def _lat_row(lat):
    return dict(first_ms=lat[0], steady_median_ms=float(np.median(lat[1:])),
                steady_max_ms=max(lat[1:]))


def phase_artifact(workdir, seed):
    """Phase 14: BERT-base at depth ART_LAYERS (S = 512, f32, level 2)
    frozen by
    ``save_artifact`` with the AOT section at buckets 1, 4, 8, loaded by
    ``load_artifact`` and served through ``LoadedArtifact.predictor()``:
    ART_REPEATS requests per bucket, each through the bucket's
    ``torch.export`` program (its first request runs it, captures it as
    a CUDA graph and replays it; every later one replays). The cold start
    moves no plan-cache miss, no pipeline run and no tuner miss; plans
    are seeded and AOT calls counted; nothing degraded. Every request
    launches K1 once and K4 twice a layer, and K4 once more, on the card
    (the launch meter); the
    answers are bitwise the seeded plan path's and those of a Predictor
    built from scratch (``create_predictor_from_dir``) at level 2."""
    from paddle_tpu_torch import export, inference

    os.environ.pop("PADDLE_TPU_FLASH_MIN_SEQ", None)
    os.environ.pop("PADDLE_TPU_OPTIMIZE", None)
    t0 = time.perf_counter()
    cfg, path, model_dir, save_s, nbytes, fused, out_name = _freeze_bert(
        workdir, seed)
    build_s = time.perf_counter() - t0 - save_s
    rs = np.random.RandomState(seed + 14)
    reqs = [_request(b, cfg, rs) for b in ART_BUCKETS]
    per_request = (cfg["n_layer"], 0, 0, fused, 0, 0, 0, 0, 0, 0)
    if fused != 2 * cfg["n_layer"] + 1:
        raise AssertionError("artifact (14): the pipeline fused %d layer "
                             "norms, expected %d" % (fused,
                                                     2 * cfg["n_layer"] + 1))

    # ---- the main path: counts zeroed here, read after the last request
    _zero_counts()
    c0 = _cold_counters()
    with LaunchMeter() as meter:
        meter.mark()
        tl = time.perf_counter()
        art = export.load_artifact(path)
        pred = art.predictor()
        load_s = time.perf_counter() - tl
        marks = []

        def aot_run(req):
            meter.mark()
            marks.append(_counts())
            return pred.run(req)

        aot_answers, aot_lat = _serve_requests(aot_run, reqs, ART_REPEATS)
    host_after = _counts()
    # ---- end of the main path
    c1 = _cold_counters()
    moved = {k: c1[k] - c0[k] for k in c0}
    if art.degraded or sorted(art.aot) != list(ART_BUCKETS):
        raise AssertionError("artifact (14): degraded %s, AOT buckets %s"
                             % (art.degraded, sorted(art.aot)))
    if (moved["plan_misses"], moved["optimizer_runs"],
            moved["tuner_misses"]) != (0, 0, 0) or \
            moved["plans_seeded"] != len(ART_BUCKETS) or \
            moved["aot_calls"] != len(ART_BUCKETS) * ART_REPEATS:
        raise AssertionError("artifact (14): the cold start moved %s" % moved)
    if any(u != (0,) * len(COUNT_NAMES) for u in meter.units[:1]):
        raise AssertionError("artifact (14): the load launched kernels: %s"
                             % (meter.units[0],))
    for i, u in enumerate(meter.units[1:]):
        first = i % ART_REPEATS == 0
        if u != _times(per_request, 2 if first else 1):
            raise AssertionError(
                "artifact (14): request %d ran %s = %s kernels on the card, "
                "expected %s (its bucket's %s)" % (
                    i, COUNT_NAMES, u, _times(per_request, 1 + first),
                    "run, capture and replay" if first else "replay"))
    host_calls = [tuple(b - a for a, b in zip(m0, m1)) for m0, m1 in
                  zip(marks, marks[1:] + [host_after])]
    want_host = [_times(per_request, 2 if i % ART_REPEATS == 0 else 0)
                 for i in range(len(host_calls))]
    if host_calls != want_host:
        raise AssertionError("artifact (14): the wrappers counted %s launch "
                             "calls per request, expected %s" % (
                                 host_calls[:ART_REPEATS + 1],
                                 want_host[:ART_REPEATS + 1]))
    for req, out in zip(reqs, aot_answers):
        b = req["src_ids"].shape[0]
        if out.shape != (b, SEQ, cfg["d_model"]) or \
                not np.isfinite(out).all():
            raise AssertionError("artifact (14): bad output %s" % (out.shape,))
    capture_s = {bs: r.capture_seconds for bs, r in pred._aot.items()}

    # the seeded plan path of the same Predictor (its first run per
    # bucket is eager, the second captures), then a Predictor built from
    # the saved model (load, optimize, per bucket an eager run and a
    # capture), each against the AOT answers bitwise
    aot = pred._aot
    pred._aot = {}
    plan_answers, plan_lat = _serve_requests(pred.run, reqs, ART_REPEATS)
    pred._aot = aot
    cfg_dir = inference.AnalysisConfig(model_dir)
    tf = time.perf_counter()
    scratch = inference.create_predictor_from_dir(model_dir)
    scratch._buckets = list(ART_BUCKETS)
    for bs in ART_BUCKETS:
        scratch._warmup(bs)
    scratch_init_s = time.perf_counter() - tf
    del cfg_dir
    scratch_answers, scratch_lat = _serve_requests(scratch.run, reqs,
                                                   ART_REPEATS)
    for what, got in (("the seeded plan path", plan_answers),
                      ("a Predictor from scratch", scratch_answers)):
        for b, a, g in zip(ART_BUCKETS, aot_answers, got):
            if not np.array_equal(a, g):
                raise AssertionError(
                    "artifact (14): batch %d through the AOT section differs "
                    "from %s by %.3e" % (b, what, float(np.abs(a - g).max())))
    rows = {b: dict(aot=_lat_row(a), seeded_plan=_lat_row(p),
                    from_scratch=_lat_row(s))
            for b, a, p, s in zip(ART_BUCKETS, aot_lat, plan_lat,
                                  scratch_lat)}
    out = dict(artifact_bytes=nbytes, save_s=save_s, build_s=build_s,
               load_and_seed_s=load_s, scratch_init_s=scratch_init_s,
               aot_capture_s=capture_s, cold_start=moved,
               latency_ms=rows, per_request=per_request,
               launches=dict(zip(COUNT_NAMES, meter.total())),
               host_launches=dict(zip(COUNT_NAMES, host_after)),
               degraded=art.degraded, aot_platform=art.aot_meta)
    for b in ART_BUCKETS:
        r = rows[b]
        log("artifact (14): batch %d: AOT first %.3f ms, steady median %.3f "
            "max %.3f ms; seeded plan first %.3f, steady %.3f / %.3f ms; "
            "from scratch steady %.3f / %.3f ms; AOT capture %s s" % (
                b, r["aot"]["first_ms"], r["aot"]["steady_median_ms"],
                r["aot"]["steady_max_ms"], r["seeded_plan"]["first_ms"],
                r["seeded_plan"]["steady_median_ms"],
                r["seeded_plan"]["steady_max_ms"],
                r["from_scratch"]["steady_median_ms"],
                r["from_scratch"]["steady_max_ms"], capture_s[b]))
    log("artifact (14): BERT-base frozen in %.1f s (%d bytes; built and "
        "started in %.1f s), loaded and seeded in %.2f s; cold start moved "
        "%s; a Predictor from scratch started in %.2f s; answers bitwise "
        "across AOT, the seeded plans and the scratch Predictor; launches "
        "%s = %s on the card (a request %s), %s from the host" % (
            save_s, nbytes, build_s, load_s, moved, scratch_init_s,
            COUNT_NAMES, meter.total(), per_request, host_after))
    del pred, scratch, art
    _free()
    return out


def phase_fleet_artifact(seed, ref, engine):
    """Phase 14b: GPT-2 small served from a serving-only artifact
    (``save_artifact(None, params=, serving={cfg, b_max 8, max_len
    1024})``): ``ReplicaRouter`` over two replicas built by
    ``DecodeEngine.from_artifact`` from v1; phase 12's 48 requests
    submitted at once and the fleet rolled to v2 (a copy of v1's file at
    another path) while they run. Every request ends exactly
    once with ``generate()``'s tokens, both replicas end on v2, and the
    roll is counted once."""
    from paddle_tpu_torch import export
    from paddle_tpu_torch.core.executor import to_numpy
    from paddle_tpu_torch.serving import DecodeEngine, ReplicaRouter

    params = {n: to_numpy(v) for n, v in ref.params.items()}
    serving = dict(cfg=ref.cfg, b_max=ENGINE_B_MAX, max_len=ENGINE_MAX_LEN)
    with tempfile.TemporaryDirectory() as d:
        paths = {v: os.path.join(d, "gpt2_%s.pdz" % v) for v in ("v1", "v2")}
        ts = time.perf_counter()
        export.save_artifact(None, paths["v1"], params=params,
                             serving=serving, name="gpt2-small")
        save_s = time.perf_counter() - ts
        # v2: the same artifact at another path (a second save would only
        # deflate the same 650 MB again, about 47 s)
        shutil.copyfile(paths["v1"], paths["v2"])
        art_v1 = export.load_artifact(paths["v1"])
        v1_engines = []

        def v1_factory(idx):
            eng = DecodeEngine.from_artifact(art_v1, queue_capacity=128)
            v1_engines.append(eng)
            return eng

        t0 = time.perf_counter()
        router = ReplicaRouter(v1_factory, n_replicas=2, poll_s=0.05,
                               max_readmissions=3)
        try:
            for rep in router.replicas:
                _warm(rep.engine, ENGINE_PROMPTS)
            start_s = time.perf_counter() - t0
            ok0 = _metric("paddle_export_rolls_total", outcome="ok")
            done, reqs = [], []
            t1 = time.perf_counter()
            for p, k, kw in ref.traffic:
                r = router.submit(p, k, **kw)
                r.add_done_callback(done.append)
                reqs.append(r)
            tr = time.perf_counter()
            rolled = router.roll(paths["v2"], queue_capacity=128)
            roll_s = time.perf_counter() - tr
            got = [r.result(timeout=600) for r in reqs]
            wall = time.perf_counter() - t1
            on_v2 = [rep.engine not in v1_engines and rep.engine.alive()
                     for rep in router.replicas]
            rolls = _metric("paddle_export_rolls_total", outcome="ok") - ok0
        finally:
            router.close()
    _check_tokens("fleet roll (14b)", got, ref.want)
    if len(done) != len(reqs) or {id(r) for r in done} != \
            {id(r) for r in reqs}:
        raise AssertionError("fleet roll (14b): %d of %d requests ended, "
                             "some more than once" % (len(done), len(reqs)))
    if rolled != 2 or not all(on_v2) or rolls != 1:
        raise AssertionError("fleet roll (14b): %d replicas rolled, on v2 %s, "
                             "rolls counted %s" % (rolled, on_v2, rolls))
    new_tokens = sum(k for _, k, _ in ref.traffic)
    out = dict(artifact_save_s=save_s, start_s=start_s, roll_s=roll_s,
               swap_s_per_replica=roll_s / 2, wall_s=wall,
               tokens_per_s=new_tokens / wall,
               phase_12_tokens_per_s=engine["tokens_per_s"])
    log("fleet roll (14b): serving-only artifact saved in %.2f s; 2 replicas "
        "from v1 started and warmed in %.1f s; %d requests at once, the "
        "fleet rolled to v2 under them in %.2f s (%.2f s a replica swap); "
        "%.1f tokens/s through the roll against phase 12's %.1f; every "
        "request ended once with generate()'s tokens; both replicas on v2" % (
            save_s, start_s, len(reqs), roll_s, roll_s / 2,
            out["tokens_per_s"], engine["tokens_per_s"]))
    return out


def _dygraph_model(seed):
    """A BERT-base-width encoder written against ``imperative``: word and
    position embeddings, 12 post-norm layers (q / k / v / out FCs,
    ``fused_attention`` with a key-pad bias and dropout 0.1, gelu FFN,
    dropout 0.1), an MLM head over the masked positions; made under the
    current guard from numpy's global RNG seeded with ``seed``. Returns
    (layers' parameters, the train-step function, its Adam)."""
    from paddle_tpu_torch import imperative
    from paddle_tpu_torch.imperative import nn as inn
    from paddle_tpu_torch.imperative import optimizer as iopt
    from paddle_tpu_torch.models import bert

    trace_op = imperative.trace_op
    cfg = bert.base_config()
    d, h, n_layer = cfg["d_model"], cfg["n_head"], cfg["n_layer"]
    dh = d // h
    np.random.seed(seed)

    class Encoder(imperative.Layer):
        def __init__(self):
            super().__init__("encoder")
            self.p_drop = cfg["dropout"]  # 0: the inference forward
            self.word = inn.Embedding("word", [cfg["vocab"], d])
            self.pos = inn.Embedding("pos", [SEQ, d])
            self.ln0 = self._ln("ln0")
            self.layers = []
            for i in range(n_layer):
                lay = {k: inn.FC("l%d_%s" % (i, k), n, num_flatten_dims=2)
                       for k, n in (("q", d), ("k", d), ("v", d), ("o", d),
                                    ("f1", cfg["d_ff"]), ("f2", d))}
                for k, v in lay.items():
                    self.add_sublayer("l%d_%s" % (i, k), v)
                lay["ln1"] = self._ln("l%d_ln1" % i)
                lay["ln2"] = self._ln("l%d_ln2" % i)
                self.layers.append(lay)
            self.head = inn.FC("mlm_out", cfg["vocab"])
            # the FCs' weights made now, in the order their first forward
            # would make them, so a fresh model's parameters exist before
            # its first step
            for fc, n_in in [(lay[k], cfg["d_ff"] if k == "f2" else d)
                             for lay in self.layers
                             for k in ("q", "k", "v", "o", "f1", "f2")] \
                    + [(self.head, d)]:
                fc._w = fc.create_parameter("w", (n_in, fc._size))
                fc._b = fc.create_parameter("b", (fc._size,),
                                            initializer=0.0)

        def _ln(self, name):
            return (self.create_parameter(name + "_s", (d,), initializer=1.0),
                    self.create_parameter(name + "_b", (d,), initializer=0.0))

        def norm(self, x, sb):
            return trace_op("layer_norm", {"X": [x], "Scale": [sb[0]],
                                           "Bias": [sb[1]]},
                            {"begin_norm_axis": 2, "epsilon": 1e-12})["Y"][0]

        def drop(self, x):
            if not self.p_drop:
                return x
            return trace_op("dropout", {"X": [x]},
                            {"dropout_prob": self.p_drop,
                             "is_test": False,
                             "dropout_implementation": "upscale_in_train"}
                            )["Out"][0]

        def heads(self, x):
            x = trace_op("reshape2", {"X": [x]},
                         {"shape": [DY_BATCH, SEQ, h, dh]})["Out"][0]
            return trace_op("transpose2", {"X": [x]},
                            {"axis": [0, 2, 1, 3]})["Out"][0]

        def forward(self, ids, pos, bias, mask_pos, labels):
            x = self.word(ids) + self.pos(pos)
            x = self.drop(self.norm(x, self.ln0))
            for lay in self.layers:
                q, k, v = (self.heads(lay[n](x)) for n in ("q", "k", "v"))
                a = trace_op("fused_attention",
                             {"Q": [q], "K": [k], "V": [v], "Bias": [bias]},
                             {"scale": dh ** -0.5,
                              "dropout": self.p_drop})["Out"][0]
                a = trace_op("transpose2", {"X": [a]},
                             {"axis": [0, 2, 1, 3]})["Out"][0]
                a = trace_op("reshape2", {"X": [a]},
                             {"shape": [DY_BATCH, SEQ, d]})["Out"][0]
                x = self.norm(x + self.drop(lay["o"](a)), lay["ln1"])
                f = trace_op("gelu", {"X": [lay["f1"](x)]}, {})["Out"][0]
                x = self.norm(x + self.drop(lay["f2"](f)), lay["ln2"])
            flat = trace_op("reshape2", {"X": [x]},
                            {"shape": [DY_BATCH * SEQ, d]})["Out"][0]
            picked = trace_op("gather", {"X": [flat], "Index": [mask_pos]},
                              {})["Out"][0]
            loss = trace_op("softmax_with_cross_entropy",
                            {"Logits": [self.head(picked)],
                             "Label": [labels]}, {})["Loss"][0]
            return trace_op("mean", {"X": [loss]}, {})["Out"][0]

    model = Encoder()
    adam = iopt.Adam(learning_rate=DY_LR)

    def step(ids, pos, bias, mask_pos, labels):
        loss = model(ids, pos, bias, mask_pos, labels)
        loss.backward()
        adam.step(model.parameters())
        return loss

    return model, step, adam


def _dygraph_batches(cfg, seed):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(DY_STEPS):
        mask = np.ones((DY_BATCH, SEQ), "float32")
        for i in range(DY_BATCH):
            mask[i, SEQ - rs.randint(SEQ // 10, 2 * SEQ // 5 + 1):] = 0.0
        bias = ((mask - 1.0) * 1e9)[:, None, None, :].astype("float32")
        out.append((
            rs.randint(0, cfg["vocab"], (DY_BATCH, SEQ)).astype("int64"),
            np.tile(np.arange(SEQ, dtype="int64"), (DY_BATCH, 1)), bias,
            (rs.randint(0, SEQ, (DY_BATCH, DY_MASK))
             + SEQ * np.arange(DY_BATCH)[:, None]).reshape(-1)
            .astype("int64"),
            rs.randint(0, cfg["vocab"], (DY_BATCH * DY_MASK, 1))
            .astype("int64")))
    return out


def _dygraph_run(seed, batches, mode, autotune=None, extras=True):
    """DY_STEPS train steps of a fresh model from ``seed`` under a guard
    seeded with ``seed``: eagerly (``mode`` None) or through
    ``imperative.jit(exact_numerics=mode, autotune=autotune)``, each step
    under the launch meter. Returns the losses, the params after (host),
    the chain's state, step ms, each step's device launches and the
    capture; with ``extras`` and ``mode`` False also steady replays'
    times, a profiled replay and the graphs' capture seconds."""
    from paddle_tpu_torch import imperative

    with imperative.guard(seed=seed):
        model, step, _ = _dygraph_model(seed)
        fn = step if mode is None else imperative.jit(
            step, exact_numerics=mode, autotune=autotune)
        losses, ms = [], []
        with LaunchMeter() as meter:
            for b in batches:
                args = [imperative.to_variable(a) for a in b]
                for a in args:
                    a.stop_gradient = True
                meter.mark()
                t, loss = _timed(lambda: fn(*args))
                ms.append(t)
                losses.append(float(loss.numpy()))
        params = {p.name + "#%d" % i: p.value.detach().cpu().clone()
                  for i, p in enumerate(model.parameters())}
        chain = imperative.get_tracer()._rng.get_state().clone()
        prof, replay_ms, graph_s = None, [], []
        if mode is False and extras:
            # steady replays of the captured graph (they go on training)
            args = [imperative.to_variable(a) for a in batches[-1]]
            for a in args:
                a.stop_gradient = True
            replay_ms = [_timed(lambda: fn(*args))[0]
                         for _ in range(DY_REPLAYS)]
            prof = _profiled(lambda: fn(*args))
            graph_s = [p.graph.seconds for p in fn._exe._cache.values()
                       if p.graph is not None]
    return dict(losses=losses, params=params, chain=chain, step_ms=ms,
                units=meter.units, captured=None if mode is None else fn,
                profile=prof, replay_ms=replay_ms, graph_capture_s=graph_s)


def phase_dygraph(seed):
    """Phase 15: a dygraph encoder at BERT-base width (hidden 768, FFN
    3072, 12 layers, 12 heads of 64, S = 512, batch 8, dropout 0.1)
    written against ``imperative`` and trained by
    ``imperative.optimizer.Adam``: DY_STEPS eager steps, then the same
    steps from the same state through ``imperative.jit`` with
    ``exact_numerics=True`` (bitwise the eager steps: losses, params and
    the generator chain) and with ``exact_numerics=False`` (level 2, the
    plan's CUDA graph, K4 and K6; within the flip-parity gates of the
    exact capture). K1-K3 launches counted on the card in every step; an
    inference capture's ``as_predictor()`` bitwise the eager forward."""
    from paddle_tpu_torch import imperative
    from paddle_tpu_torch.models import bert

    cfg = bert.base_config()
    batches = _dygraph_batches(cfg, seed + 15)
    _zero_counts()
    eager = _dygraph_run(seed, batches, None)
    _free()
    exact = _dygraph_run(seed, batches, True)
    _free()
    fast = _dygraph_run(seed, batches, False)
    _free()
    per_step = (2 * cfg["n_layer"], cfg["n_layer"], cfg["n_layer"])
    for what, run in (("eager", eager), ("exact capture", exact),
                      ("level-2 capture", fast)):
        for i, u in enumerate(run["units"]):
            if u[:3] != per_step:
                raise AssertionError(
                    "dygraph (15) %s step %d ran flash %s on the card, "
                    "expected %s" % (what, i, u[:3], per_step))
        if not np.isfinite(run["losses"]).all():
            raise AssertionError("dygraph (15) %s: losses %s"
                                 % (what, run["losses"]))
    for what, run in (("eager", eager), ("exact capture", exact)):
        if any(u[3] or u[4] for u in run["units"]):
            raise AssertionError("dygraph (15) %s launched K4 or K6" % what)
    fast_k46 = [(u[3], u[4]) for u in fast["units"][1:]]
    if any(k4 == 0 or k6 != 1 for k4, k6 in fast_k46):
        raise AssertionError("dygraph (15) level-2 replays ran K4 / K6 %s"
                             % fast_k46)
    same = (eager["losses"] == exact["losses"]
            and all(torch.equal(eager["params"][n], exact["params"][n])
                    for n in eager["params"])
            and torch.equal(eager["chain"], exact["chain"]))
    if not same:
        raise AssertionError("dygraph (15): the exact capture is not bitwise "
                             "the eager steps (losses %s / %s)"
                             % (eager["losses"], exact["losses"]))
    if not torch.equal(exact["chain"], fast["chain"]):
        raise AssertionError("dygraph (15): the level-2 capture advanced the "
                             "generator chain otherwise")
    with imperative.guard(seed=seed):
        model = _dygraph_model(seed)[0]
        keyed = list(enumerate(model.parameters()))
        before = {p.name + "#%d" % i: p.value.detach().cpu().clone()
                  for i, p in keyed}
        # the key projections' biases take a gradient that is zero in
        # exact arithmetic (softmax is invariant to a shift of a row's
        # scores): their Adam updates are rounding noise in both paths
        key_bias = {id(lay["k"]._b) for lay in model.layers}
        names = [p.name + "#%d" % i for i, p in keyed
                 if id(p) not in key_bias]
        del model
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(fast["losses"],
                                                       exact["losses"]))
    share = max(((n, float(((fast["params"][n] - exact["params"][n]).abs()
                            > PARITY_PARAM_ATOL).float().mean()))
                 for n in names), key=lambda t: t[1])
    upd = _update_l2(fast["params"], exact["params"], before, names)
    log("dygraph (15): level-2 capture against the exact one over %d steps: "
        "loss rel diff %.3e (<= %.0e), worst share past %.0e %.3e (%s, <= "
        "%.0e), update worst l2 rel %.3e (%s, <= %.2g)" % (
            DY_STEPS, loss_rel, PARITY_LOSS_RTOL, PARITY_PARAM_ATOL,
            share[1], share[0], PARITY_FLIP_SHARE, upd[1], upd[0],
            PARITY_UPDATE_L2))
    if loss_rel > PARITY_LOSS_RTOL or share[1] > PARITY_FLIP_SHARE or \
            upd[1] > PARITY_UPDATE_L2:
        raise AssertionError("dygraph (15): the level-2 capture and the "
                             "exact one disagree")

    # an inference capture (the forward alone, no dropout) served by its
    # Predictor against the eager forward
    with imperative.guard(seed=seed):
        model, _, _ = _dygraph_model(seed)
        model.p_drop = 0.0
        args = [imperative.to_variable(a) for a in batches[0]]
        for a in args:
            a.stop_gradient = True
        fwd = imperative.jit(lambda *a: model(*a))
        want = fwd(*args).numpy()
        imperative.get_tracer().tape.clear()
        pred = fwd.as_predictor()
        (got,) = pred.run({n: a.value for n, a in zip(
            fwd._last_entry.feed_order, args)})
        eager_again = model(*args).numpy()
        imperative.get_tracer().tape.clear()
    if not (np.array_equal(got.reshape(want.shape), want)):
        raise AssertionError("dygraph (15): as_predictor() differs from the "
                             "eager forward by %.3e"
                             % float(np.abs(got - want).max()))
    del pred, model
    _free()
    exact_cap = exact["captured"]
    fast_cap = fast["captured"]
    out = dict(
        eager_step_ms=eager["step_ms"], exact_step_ms=exact["step_ms"],
        graph_step_ms=fast["step_ms"],
        eager_median_ms=float(np.median(eager["step_ms"][1:])),
        exact_replay_median_ms=float(np.median(exact["step_ms"][1:])),
        graph_replay_ms=fast["replay_ms"],
        graph_replay_median_ms=float(np.median(fast["replay_ms"])),
        graph_capture_s=fast["graph_capture_s"],
        capture_first_call_ms=dict(exact=exact["step_ms"][0],
                                   graph=fast["step_ms"][0]),
        losses=eager["losses"], level2_loss_rel=loss_rel,
        level2_worst_share=share, level2_update_l2=upd,
        launches=dict(zip(COUNT_NAMES, np.sum(
            eager["units"] + exact["units"] + fast["units"], axis=0)
            .tolist())),
        launches_by_run={k: [dict(zip(COUNT_NAMES, u)) for u in r["units"]]
                         for k, r in (("eager", eager), ("exact", exact),
                                      ("graph", fast))},
        graph_replay_profile=fast["profile"],
        captures=dict(exact=exact_cap.stats["captures"],
                      graph=fast_cap.stats["captures"]),
        eager_forward_rerun_equal=bool(np.array_equal(eager_again, want)))
    log("dygraph (15): BERT-base-width encoder, %d steps each: eager %s ms, "
        "exact capture %s ms (first call traces), level-2 capture %s ms "
        "(first call traces, second runs the plan, third captures the CUDA "
        "graph in %s s), then replays %s ms; the exact capture bitwise "
        "eager (losses %s, params, chain), as_predictor() bitwise the eager "
        "forward; flash launches per step %s, K4 / K6 per level-2 step %s; "
        "a profiled replayed step: wall %.3f ms, device busy %.3f ms "
        "(%.1f%%)" % (
            DY_STEPS, ["%.1f" % t for t in eager["step_ms"]],
            ["%.1f" % t for t in exact["step_ms"]],
            ["%.1f" % t for t in fast["step_ms"]],
            ["%.3f" % t for t in fast["graph_capture_s"]],
            ["%.1f" % t for t in fast["replay_ms"]], eager["losses"],
            per_step, fast_k46, fast["profile"]["wall_ms"],
            fast["profile"]["device_busy_ms"],
            100 * fast["profile"]["busy_share"]))
    return out


# -------------------------------------------------- phases 16 - 16d (A9)
S2S_BEAM = 4
S2S_MAX_LEN = 50
S2S_BUCKETS = [1, 16]
S2S_REPEATS = 10
S2S_SCORE_ATOL = 1e-3  # level 0 against level 2: 50 steps of summed
#                        f32 log-probs (about -460); the ids exactly
LSTM_BATCH = 64
MT_BATCH = 32
SEQ_EAGER_STEPS = 3    # a training phase's main path: the eager first
SEQ_REPLAY_STEPS = 10  # steps (eager, capture) and then replays
SEQ_PAIRS = 3          # replayed against eager steps, in turns (6c)
CF_WIDTH = 512
CF_STEPS = 3
LOOP_STEPS = 8         # train_loop against run: steady steps timed


def _s2s_decoder(cfg):
    """Phase 16's program: ``machine_translation``'s encoder (embedding,
    a bidirectional ``dynamic_gru`` of ``hidden`` over T, the last valid
    step, an fc to the decoder state) and a ``StateCell`` whose updater
    is ``layers.gru_unit`` at ``hidden``, decoded by
    ``BeamSearchDecoder`` (beam S2S_BEAM, S2S_MAX_LEN steps, the target
    vocabulary): (translation ids [B, beam, max_len], scores [B, beam])."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import layers
    from paddle_tpu_torch.contrib.decoder import (BeamSearchDecoder,
                                                  InitState, StateCell)
    from paddle_tpu_torch.models import machine_translation as mt

    H, T = cfg["hidden"], cfg["seq_len"]
    src = layers.data("src_ids", [T], dtype="int64")
    src_len = layers.data("src_len", [], dtype="int64")
    init_ids = layers.data("init_ids", [1], dtype="int64")
    init_scores = layers.data("init_scores", [1], dtype="float32")
    enc_out = mt._encoder(src, src_len, cfg)
    enc_last = layers.sequence_last_step(enc_out, length=src_len)
    dec_init = layers.fc(enc_last, size=H, act="tanh")
    cell = StateCell(inputs={"x": None},
                     states={"h": InitState(init=dec_init)}, out_state="h")

    @cell.state_updater
    def _update(c):
        xp = layers.fc(c.get_input("x"), size=3 * H,
                       param_attr=fluid.ParamAttr(name="dec_in.w_0"),
                       bias_attr=fluid.ParamAttr(name="dec_in.b_0"))
        nh, _, _ = layers.gru_unit(
            xp, c.get_state("h"), size=3 * H,
            param_attr=fluid.ParamAttr(name="dec_gru.w_0"),
            bias_attr=fluid.ParamAttr(name="dec_gru.b_0"))
        c.set_state("h", nh)

    bsd = BeamSearchDecoder(
        cell, init_ids, init_scores, target_dict_dim=cfg["trg_vocab"],
        word_dim=cfg["emb_dim"], max_len=S2S_MAX_LEN, beam_size=S2S_BEAM,
        end_id=cfg["eos_id"], word_emb_param_name="trg_emb",
        score_fc_param_name="dec_score")
    bsd.decode()
    return bsd()


def _s2s_requests(cfg, rs):
    T = cfg["seq_len"]
    return [{"src_ids": rs.randint(2, cfg["src_vocab"], (b, T))
             .astype("int64"),
             "src_len": rs.randint(20, T + 1, (b,)).astype("int64"),
             "init_ids": np.full((b, 1), cfg["bos_id"], "int64"),
             "init_scores": np.zeros((b, 1), "float32")}
            for b in S2S_BUCKETS]


def phase_seq2seq_serve(workdir, seed):
    """Phase 16: seq2seq decoding served. ``_s2s_decoder`` at
    ``machine_translation.config()`` (vocab 10000, embedding 256, hidden
    512, T = 50), random weights from ``seed``, saved with
    ``io.save_inference_model`` and served by the Predictor at buckets 1
    and 16 (each warmed up eagerly, then captured at load), each request
    answered S2S_REPEATS times, every answer a replay and the same every
    time; the answers against the plan's eager step (bitwise) and a
    level-0 Predictor (the ids exactly, the scores within
    S2S_SCORE_ATOL); replayed and eager requests timed in turns, one
    profiled request of each bucket (busy share, kernels a request)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import machine_translation as mt

    what = "serve seq2seq (16)"
    cfg = mt.config()
    t0 = time.perf_counter()
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        ids, scores = _s2s_decoder(cfg)
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    exe.run(startup, scope=scope)
    feeds = ["src_ids", "src_len", "init_ids", "init_scores"]
    with fluid.scope_guard(scope):
        fluid.io.save_inference_model(workdir, feeds, [ids, scores], exe,
                                      main_program=main)
    n_weights = sum(int(np.prod(p.shape))
                    for p in main.global_block().all_parameters())
    n_ops = len(main.global_block().ops)
    exe.close()
    del exe, scope
    _free()
    reqs = _s2s_requests(cfg, np.random.RandomState(seed + 16))
    log("%s: %d ops, %d weights; built, started and saved in %.1f s" % (
        what, n_ops, n_weights, time.perf_counter() - t0))
    config = fluid.inference.AnalysisConfig(workdir)
    config.warmup_batch_sizes = list(S2S_BUCKETS)
    per_dispatch = (0,) * len(COUNT_NAMES)  # none of K1-K7 on this path
    answers, lat_ms = [], []

    # ---- the main path: counts zeroed here, read after the last request
    _zero_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with LaunchMeter() as meter:
        meter.mark()
        t0 = time.perf_counter()
        pred = fluid.inference.create_paddle_predictor(config)
        init_s = time.perf_counter() - t0
        for req in reqs:
            b = req["src_ids"].shape[0]
            lat_ms.append([])
            for rep in range(S2S_REPEATS):
                meter.mark()
                ms, out = _timed(lambda: pred.run(req))
                lat_ms[-1].append(ms)
                if rep == 0:
                    if out[0].shape != (b, S2S_BEAM, S2S_MAX_LEN) or \
                            out[1].shape != (b, S2S_BEAM) or \
                            not np.isfinite(out[1]).all() or \
                            out[0].min() < 0 or \
                            out[0].max() >= cfg["trg_vocab"]:
                        raise AssertionError("%s: batch %d: bad answer %s" %
                                             (what, b, [o.shape for o in
                                                        out]))
                    answers.append(out)
                elif not all(np.array_equal(o, a)
                             for o, a in zip(out, answers[-1])):
                    raise AssertionError("%s: batch %d: a repeated request "
                                         "gave another answer" % (what, b))
    # ---- end of the main path
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    if any(u != per_dispatch for u in meter.units) or \
            _counts() != per_dispatch:
        raise AssertionError("%s: the path ran %s kernels of the port"
                             % (what, meter.units))
    plans = _captured(pred._exe)
    if len(plans) != len(S2S_BUCKETS):
        raise AssertionError("%s: %d captured bucket plans, expected %d" % (
            what, len(plans), len(S2S_BUCKETS)))
    rows = []
    for req, ans, lat in zip(reqs, answers, lat_ms):
        b = req["src_ids"].shape[0]
        eager = _pred_eager(pred, req)
        if not all(np.array_equal(e, a) for e, a in zip(eager, ans)):
            raise AssertionError("%s: batch %d: the replayed answer differs "
                                 "from the plan's eager step" % (what, b))
        turns = ([], [])
        for i in range(4):
            for e in ((False, True) if i % 2 else (True, False)):
                ms, _ = _timed(lambda e=e: _pred_eager(pred, req) if e
                               else pred.run(req))
                turns[e].append(ms)
        prof_r = _profiled(lambda: pred.run(req))
        prof_e = _profiled(lambda: _pred_eager(pred, req))
        plan = _request_plan(pred, req)
        rows.append(dict(
            batch=b, latency_ms=lat, latency_median_ms=float(np.median(lat)),
            replay_ms=turns[0], eager_ms=turns[1],
            replay_median_ms=float(np.median(turns[0])),
            eager_median_ms=float(np.median(turns[1])),
            capture_s=plan.graph.seconds, replay_profile=prof_r,
            eager_profile=prof_e, kernels_per_request=prof_r["kernels"],
            best_ids=ans[0][:2, 0, :8].tolist()))
        _log_breakdown("%s batch %d replayed request" % (what, b), prof_r)
    del pred
    _free()
    os.environ["PADDLE_TPU_OPTIMIZE"] = "0"
    try:
        pred0 = fluid.inference.create_paddle_predictor(config)
        level0 = [pred0.run(r) for r in reqs]
    finally:
        os.environ.pop("PADDLE_TPU_OPTIMIZE", None)
    del pred0
    _free()
    for row, ans, l0 in zip(rows, answers, level0):
        row["level0_ids_equal"] = bool(np.array_equal(ans[0], l0[0]))
        row["level0_bitwise"] = bool(row["level0_ids_equal"] and
                                     np.array_equal(ans[1], l0[1]))
        row["level0_max_score_diff"] = float(np.abs(ans[1] - l0[1]).max())
        log("%s: batch %d: replayed request median %.3f ms (over %d "
            "repeats, max %.3f), in turns replayed %.3f ms against eager "
            "%.3f ms; a replayed request %.1f%% busy, %d kernels (eager "
            "%.1f%% busy); capture %.3f s; level 0: ids equal %s, bitwise "
            "%s, max score diff %.3e" % (
                what, row["batch"], row["latency_median_ms"], S2S_REPEATS,
                max(row["latency_ms"]), row["replay_median_ms"],
                row["eager_median_ms"],
                100 * row["replay_profile"]["busy_share"],
                row["kernels_per_request"],
                100 * row["eager_profile"]["busy_share"], row["capture_s"],
                row["level0_ids_equal"], row["level0_bitwise"],
                row["level0_max_score_diff"]))
        if not row["level0_ids_equal"] or \
                row["level0_max_score_diff"] > S2S_SCORE_ATOL:
            raise AssertionError("%s: batch %d: level 2 against level 0: "
                                 "ids equal %s, scores off by %.3e" % (
                                     what, row["batch"],
                                     row["level0_ids_equal"],
                                     row["level0_max_score_diff"]))
    log("%s: predictor init %.2f s (each bucket eager, then captured); "
        "peak memory %.1f MiB" % (what, init_s, peak_mb))
    return dict(cfg=cfg, beam=S2S_BEAM, max_len=S2S_MAX_LEN,
                n_weights=n_weights, n_ops=n_ops, init_s=init_s,
                peak_mem_mib=peak_mb, rows=rows,
                launches=dict(zip(COUNT_NAMES, meter.total())))


def _seq_batches(model, cfg, seed, n=4):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        if model == "stacked_lstm":
            T = cfg["seq_len"]
            out.append({
                "words": rs.randint(0, cfg["vocab"], (LSTM_BATCH, T))
                .astype("int64"),
                "label": rs.randint(0, cfg["num_classes"], (LSTM_BATCH, 1))
                .astype("int64"),
                "length": rs.randint(16, T + 1, (LSTM_BATCH,))
                .astype("int64")})
        else:
            T = cfg["seq_len"]
            ids = lambda v: rs.randint(2, v, (MT_BATCH, T)).astype(  # noqa
                "int64")
            out.append({"src_ids": ids(cfg["src_vocab"]),
                        "trg_ids": ids(cfg["trg_vocab"]),
                        "lbl_ids": ids(cfg["trg_vocab"]),
                        "src_len": rs.randint(20, T + 1, (MT_BATCH,))
                        .astype("int64"),
                        "trg_len": rs.randint(20, T + 1, (MT_BATCH,))
                        .astype("int64")})
    return out


def _seq_setup(model, seed):
    """``stacked_lstm`` or ``machine_translation`` at its config's widths
    with Adam at TRAIN_LR, started on the card from ``seed``."""
    import importlib

    import paddle_tpu_torch as fluid

    mod = importlib.import_module("paddle_tpu_torch.models." + model)
    cfg = mod.config()
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        loss = mod.build(cfg)[0]
        fluid.optimizer.Adam(learning_rate=TRAIN_LR).minimize(loss)
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    exe.run(startup, scope=scope)
    params = [p.name for p in main.global_block().all_parameters()]
    tier = _tier_stats(main, [loss.name], scope)
    return exe, scope, main, loss, cfg, params, tier


def _per_step(opt, groups):
    """A step's launches (``COUNT_NAMES``): K6 (Adam) or K7 (SGD) once
    per optimizer group level 2 made."""
    return (0, 0, 0, 0, groups * (opt == "Adam"), groups * (opt == "SGD"),
            0, 0, 0, 0)


def _seq_train(what, exe, scope, main, loss, params, tier, batches, tokens,
               unit, opt="Adam", steps=SEQ_EAGER_STEPS + SEQ_REPLAY_STEPS,
               eager_readings=True):
    """A sequence training phase's main path and 6c's readings: K6 (or,
    with ``opt`` SGD, K7) once a step (counted on the card) over
    ``steps`` steps (the first eager, the second captures), then
    SEQ_PAIRS replayed steps against eager ones in turns, bitwise
    (``eager_readings``: phase_compiled_train's)."""
    per_step = _per_step(opt, 1)
    trainable = [p for p in main.global_block().all_parameters()
                 if p.trainable]
    if tier["optimizer_groups"] != [len(trainable)]:
        raise AssertionError("%s: level 2 made optimizer groups %s of %d "
                             "trainable params" % (
                                 what, tier["optimizer_groups"],
                                 len(trainable)))
    step = _amp_step_fn(exe, main, loss)
    snap = _snapshot(scope)
    os.environ.pop("PADDLE_TPU_OPTIMIZE", None)
    # ---- the main path: counts zeroed here, read after the last step
    path = _metered_steps(what, step, scope, batches, steps, per_step)
    # ---- end of the main path
    compiled = phase_compiled_train(what, exe, main, loss, snap, batches,
                                    params, step, per_step, tokens=tokens,
                                    pairs=SEQ_PAIRS, unit=unit,
                                    eager_readings=eager_readings)
    prof = compiled["replay_profile"]
    log("%s: losses %s; replayed in turns %.3f ms a step (%.1f %s/s), "
        "eager %.3f ms; a profiled replayed step %.1f%% busy, %d kernels, "
        "device ms by class %s; capture %.3f s; peak memory %.1f MiB on "
        "the main path (%.1f allocated as it began, %.1f above), %.1f "
        "replayed, %s eager; launches %s = %s on the card (host calls "
        "%s)" % (
            what, ["%.4f" % v for v in path["losses"]],
            compiled["replay_median_ms"], compiled["replay_tokens_per_s"],
            unit, compiled["eager_median_ms"], 100 * prof["busy_share"],
            prof["kernels"], {k: round(v, 3) for k, v in
                              prof["by_class_ms"].items()},
            compiled["capture_s"], path["peak_mb"], path["base_mb"],
            path["rise_mb"], compiled["peak_mem_mib"]["replay"],
            "%.1f" % compiled["peak_mem_mib"]["eager"]
            if eager_readings else "not read", COUNT_NAMES,
            path["launches"], path["host_launches"]))
    return snap, step, dict(
        n_params=len(params), n_weights=sum(
            int(np.prod(main.global_block().var(n).shape)) for n in params),
        tier=tier, losses=path["losses"], step_ms=path["step_ms"],
        launches=dict(zip(COUNT_NAMES, path["launches"])),
        host_launches=dict(zip(COUNT_NAMES, path["host_launches"])),
        per_step=dict(zip(COUNT_NAMES, per_step)),
        peak_mem_mib=path["peak_mb"], base_mem_mib=path["base_mb"],
        rise_mem_mib=path["rise_mb"], compiled=compiled)


def phase_stacked_lstm(seed):
    """Phase 16b: ``stacked_lstm`` at its config (vocab 5000, embedding
    128, hidden 128, 3 ``dynamic_lstm`` layers, T = 80) trained at batch
    LSTM_BATCH with lengths 16-80, Adam, f32, level 2: the main path
    (``_seq_train``), K6 once a step on the card, replays bitwise the
    eager steps."""
    what = "stacked_lstm (16b)"
    t0 = time.perf_counter()
    exe, scope, main, loss, cfg, params, tier = _seq_setup("stacked_lstm",
                                                           seed)
    batches = _seq_batches("stacked_lstm", cfg, seed + 17)
    log("%s: batch %d, T %d: %d params; built and started in %.1f s; "
        "level 2: %d ops of %d" % (what, LSTM_BATCH, cfg["seq_len"],
                                   len(params), time.perf_counter() - t0,
                                   tier["ops_after"], tier["ops_before"]))
    _, _, out = _seq_train(what, exe, scope, main, loss, params, tier,
                           batches, LSTM_BATCH, "sequences")
    exe.close()
    return dict(cfg=cfg, batch=LSTM_BATCH, **out)


def phase_mt_train(seed):
    """Phase 16c: ``machine_translation`` at its config (vocab 10000,
    embedding 256, hidden 512, T = 50: a bidirectional ``dynamic_gru``
    encoder, attention, a ``dynamic_gru`` decoder) trained at batch
    MT_BATCH with lengths 20-50, Adam, f32, level 2: ``_seq_train``'s
    readings, then ``train_loop`` at K = 1 bitwise the run loop, and
    LOOP_STEPS steady steps of each timed."""
    what = "machine_translation (16c)"
    t0 = time.perf_counter()
    exe, scope, main, loss, cfg, params, tier = _seq_setup(
        "machine_translation", seed)
    batches = _seq_batches("machine_translation", cfg, seed + 18)
    log("%s: batch %d, T %d: %d params; built and started in %.1f s; "
        "level 2: %d ops of %d" % (what, MT_BATCH, cfg["seq_len"],
                                   len(params), time.perf_counter() - t0,
                                   tier["ops_after"], tier["ops_before"]))
    snap, step, out = _seq_train(what, exe, scope, main, loss, params, tier,
                                 batches, MT_BATCH, "sentence pairs")
    _loop_against_run(what, exe, main, loss, snap, batches, params, 3)
    # the plan keeps one graph, bound to one scope: each loop is timed
    # right after two steps on its own scope (a capture on it), so no
    # timed step captures
    sc_run, sc_loop = _restored(snap), _restored(snap)
    for b in batches[:2]:
        exe.run(main, feed=b, fetch_list=[loss], scope=sc_run)
    run_ms, _ = _timed(lambda: [exe.run(main, feed=b, fetch_list=[loss],
                                        scope=sc_run)
                                for b in _fresh(batches, LOOP_STEPS)()])
    _loop_values(exe, main, [loss], sc_loop, _fresh(batches, 2), 1)
    loop_ms, _ = _timed(lambda: _loop_values(
        exe, main, [loss], sc_loop, _fresh(batches, LOOP_STEPS), 1))
    out["run_steady_ms"] = run_ms / LOOP_STEPS
    out["train_loop_steady_ms"] = loop_ms / LOOP_STEPS
    log("%s: train_loop at K = 1 bitwise the run loop; over %d steady "
        "steps %.3f ms a step through train_loop, %.3f ms through run" % (
            what, LOOP_STEPS, out["train_loop_steady_ms"],
            out["run_steady_ms"]))
    exe.close()
    return dict(cfg=cfg, batch=MT_BATCH, **out)


def _cf_train_program(kind, seed):
    """Phase 16d's training programs at width CF_WIDTH, Adam: ``cond``:
    a ``cond``, a ``Switch`` and an ``IfElse`` (one branch with
    dropout) in the step; ``static`` / ``dynamic``: a StaticRNN /
    DynamicRNN of an fc step with dropout 0.3 over 16 steps."""
    import paddle_tpu_torch as fluid

    L = fluid.layers
    W, T, B = CF_WIDTH, 16, 16
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        if kind == "cond":
            x = L.data("x", [W])
            lab = L.data("lab", [1], dtype="int64")
            gate = L.data("gate", [1], append_batch_size=False)
            scale = L.fill_constant([1], "float32", 1.0)
            L.cond(L.greater_than(gate, L.fill_constant([1], "float32",
                                                        0.0)),
                   true_fn=lambda: L.assign(
                       L.fill_constant([1], "float32", 2.0), output=scale),
                   false_fn=lambda: L.assign(
                       L.fill_constant([1], "float32", 0.5), output=scale))
            sw = L.fill_constant([1], "float32", 0.0)
            s = L.Switch()
            with s.case(L.less_than(gate, L.fill_constant([1], "float32",
                                                          -0.5))):
                L.assign(L.fill_constant([1], "float32", 1.0), output=sw)
            with s.default():
                L.assign(L.fill_constant([1], "float32", 3.0), output=sw)
            ie = L.IfElse(L.less_than(lab, L.fill_constant([1], "int64", 1)))
            with ie.true_block():
                ie.output(L.fc(ie.input(x), size=W, act="tanh"))
            with ie.false_block():
                ie.output(L.dropout(L.fc(ie.input(x), size=W, act="relu"),
                                    dropout_prob=0.2))
            h = L.elementwise_mul(ie()[0], L.elementwise_add(scale, sw))
        elif kind == "static":
            x = L.data("x", [T, B, W], append_batch_size=False)
            rnn = L.StaticRNN()
            with rnn.step():
                word = rnn.step_input(x)
                prev = rnn.memory(shape=[-1, W], batch_ref=word,
                                  ref_batch_dim_idx=1)
                hid = L.dropout(L.fc([word, prev], size=W, act="tanh"),
                                dropout_prob=0.3)
                rnn.update_memory(prev, hid)
                rnn.step_output(hid)
            h = rnn()
        else:
            x = L.data("x", [B, T, W], append_batch_size=False)
            ln = L.data("ln", [B], dtype="int64", append_batch_size=False)
            rnn = L.DynamicRNN()
            with rnn.block():
                word = rnn.step_input(x, length=ln)
                prev = rnn.memory(shape=[W], value=0.0, dtype="float32")
                hid = L.dropout(L.fc([word, prev], size=W, act="tanh"),
                                dropout_prob=0.3)
                rnn.update_memory(prev, hid)
                rnn.output(hid)
            h = rnn()
        loss = L.mean(L.square(h))
        fluid.optimizer.Adam(learning_rate=TRAIN_LR).minimize(loss)
    rs = np.random.RandomState(seed)
    batches = []
    for i in range(4):
        if kind == "cond":
            batches.append({"x": rs.randn(B, W).astype("float32"),
                            "lab": rs.randint(0, 2, (B, 1)).astype("int64"),
                            "gate": np.array([(-1.0, 0.3, -0.2, 1.0)[i]],
                                             "float32")})
        else:
            shape = (T, B, W) if kind == "static" else (B, T, W)
            b = {"x": rs.randn(*shape).astype("float32")}
            if kind == "dynamic":
                b["ln"] = rs.randint(1, T + 1, (B,)).astype("int64")
            batches.append(b)
    return main, startup, loss, batches


def _cf_while(seed):
    """A ``While`` accumulating a [CF_WIDTH] row over a count fed as
    data: the plan is never captured (its condition is read on the host
    each iteration), counted once in
    ``paddle_executor_uncaptured_plans_total{op="while"}``, and the sums
    are right at every count."""
    import warnings

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core.executor import UNCAPTURED_PLANS

    L = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        n = L.data("n", [1], append_batch_size=False)
        x = L.data("x", [CF_WIDTH], append_batch_size=False)
        i = L.fill_constant([1], "float32", 0.0)
        acc = L.fill_constant([CF_WIDTH], "float32", 0.0)
        cond = L.less_than(i, n)
        w = L.While(cond)
        with w.block():
            L.assign(L.elementwise_add(acc, x), output=acc)
            L.increment(i, 1.0)
            L.assign(L.less_than(i, n), output=cond)
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    xv = np.random.RandomState(seed).randint(-8, 8, CF_WIDTH).astype(
        "float32")
    before = UNCAPTURED_PLANS.labels(op="while").value
    counts, wrong = [3, 7, 0, 12, 5], []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        ms = []
        for k in counts:
            t, (got,) = _timed(lambda: exe.run(
                main, feed={"n": np.array([k], "float32"), "x": xv},
                fetch_list=[acc], scope=scope))
            ms.append(t)
            if not np.array_equal(got, k * xv):
                wrong.append(k)
    (plan,) = exe._cache.values()
    counted = UNCAPTURED_PLANS.labels(op="while").value - before
    warned = [str(w_.message) for w_ in caught
              if issubclass(w_.category, RuntimeWarning)]
    exe.close()
    if wrong or plan.graph is not None or counted != 1 or \
            plan.host_sync != ["while"]:
        raise AssertionError("control flow (16d): while: wrong sums at %s, "
                             "captured %s, counted %s, host-sync ops %s" % (
                                 wrong, plan.graph is not None, counted,
                                 plan.host_sync))
    log("control flow (16d): while over counts %s: sums right, the plan "
        "uncaptured (host-sync ops %s), counted %d; %s; run ms %s" % (
            counts, plan.host_sync, counted,
            "warned: %s" % warned[0] if warned else
            "warned earlier in the process", ["%.2f" % v for v in ms]))
    return dict(counts=counts, run_ms=ms, counted=counted,
                host_sync=plan.host_sync)


def _cf_beam_ties(seed):
    """``beam_search`` on the card against the CPU on tied candidates:
    dead beams and a uniform step, and rounded log-probs, at beam
    S2S_BEAM and a vocabulary of 10000: parents, ids and scores equal."""
    from paddle_tpu_torch.core.lowering import LowerContext
    from paddle_tpu_torch.core.registry import get_op

    B, K, V = 16, S2S_BEAM, 10000
    rs = np.random.RandomState(seed)
    cases = [
        (np.ones((B, K), "int32"),
         np.array([[0.0] + [-1e9] * (K - 1)] * B, "float32"),
         np.log(np.full((B, K, V), 1.0 / V, "float32"))),
        (np.array([[1, 0, 2, 0]] * B, "int32"), np.zeros((B, K), "float32"),
         np.round(np.log(rs.dirichlet(np.ones(V), (B, K))), 1)
         .astype("float32"))]
    dev = torch.device("cuda", 0)
    for pre_ids, pre_sc, sc in cases:
        outs = []
        for d in (torch.device("cpu"), dev):
            o = get_op("beam_search").lowering(
                LowerContext(None, None, d),
                {"pre_ids": [torch.from_numpy(pre_ids).to(d)],
                 "pre_scores": [torch.from_numpy(pre_sc).to(d)],
                 "scores": [torch.from_numpy(sc).to(d)]},
                {"beam_size": K, "end_id": 0})
            outs.append({k: v[0].cpu() for k, v in o.items()})
        bad = [k for k in outs[0] if not torch.equal(outs[0][k], outs[1][k])]
        if bad:
            raise AssertionError("control flow (16d): beam_search on the "
                                 "card differs from the CPU on ties: %s"
                                 % bad)
    log("control flow (16d): beam_search ties (dead beams, a uniform step, "
        "rounded log-probs; beam %d, V %d): the card's parents, ids and "
        "scores are the CPU's" % (K, V))
    return dict(cases=len(cases), equal=True)


def phase_control_flow(seed):
    """Phase 16d: control flow on the card at width CF_WIDTH: a While
    over a data-dependent count (``_cf_while``); a training step
    holding ``cond`` / ``Switch`` / ``IfElse`` and a StaticRNN and a
    DynamicRNN with dropout, each trained CF_STEPS steps on the main path
    (K6 once a step on the card where level 2 groups the Adam updates:
    the cond step's), captured, and its replays bitwise its eager steps (losses and params: the replays' dropout masks, the
    recurrent grad's replayed ones included, are the eager steps');
    ``beam_search``'s ties on the card (``_cf_beam_ties``)."""
    import paddle_tpu_torch as fluid

    out = dict(while_loop=_cf_while(seed))
    launches = np.zeros(len(COUNT_NAMES), dtype=np.int64)
    for kind in ("cond", "static", "dynamic"):
        what = "control flow %s (16d)" % kind
        main, startup, loss, batches = _cf_train_program(kind, seed)
        exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
        exe.run(startup, scope=scope)
        params = [p.name for p in main.global_block().all_parameters()]
        # K6 once a step where level 2 groups the Adam updates: the
        # pipeline (the JAX package's) leaves a param that a sub-block
        # reads unfused, so the RNN steps run their 3 ``adam`` ops
        tier = _tier_stats(main, [loss.name], scope)
        per_step = (0, 0, 0, 0, len(tier["optimizer_groups"]), 0, 0, 0, 0,
                    0)
        if per_step[4] != int(kind == "cond"):
            raise AssertionError("%s: level 2 made optimizer groups %s"
                                 % (what, tier["optimizer_groups"]))
        step = _amp_step_fn(exe, main, loss)
        snap = _snapshot(scope)
        # ---- the main path: counts zeroed here, read after the last step
        path = _metered_steps(what, step, scope, batches, CF_STEPS, per_step)
        # ---- end of the main path
        if not _captured(exe):
            raise AssertionError("%s: the plan was not captured" % what)
        compiled = phase_compiled_train(what, exe, main, loss, snap,
                                        batches, params, step, per_step,
                                        tokens=16, pairs=2, unit="rows")
        exe.close()
        launches += np.asarray(path["launches"])
        out[kind] = dict(losses=path["losses"], step_ms=path["step_ms"],
                         optimizer_groups=tier["optimizer_groups"],
                         launches=dict(zip(COUNT_NAMES, path["launches"])),
                         peak_mem_mib=path["peak_mb"], compiled=compiled)
        log("%s: %d steps, losses %s, launches %s = %s on the card; "
            "captured, replays bitwise eager; replayed %.3f ms a step, "
            "eager %.3f ms, capture %.3f s" % (
                what, CF_STEPS, ["%.5f" % v for v in path["losses"]],
                COUNT_NAMES, path["launches"], compiled["replay_median_ms"],
                compiled["eager_median_ms"], compiled["capture_s"]))
    out["beam_ties"] = _cf_beam_ties(seed)
    out["launches"] = dict(zip(COUNT_NAMES, (int(v) for v in launches)))
    return out


# --------------------------------------------------------- phases 17-17c
# the book (phase 17) at tests/test_book.py's sizes: a replayed step's
# fetches and the final params bitwise its eager step's, in turns over
# 1 + BOOK_PAIRS steps from the startup's snapshot; the first
# BOOK_PARITY_STEPS losses on the card against the port on the CPU from
# the same snapshot (f32, TF32 off: sums, convs and the recurrences'
# loops in another order, no difference amplified in 3 steps but
# resnet_cifar10's, below) within BOOK_CPU_TOL * max(1, |loss|). The chapters at their widths (17, and
# db_lstm in 17b): _seq_train's steps, pairs and readings, the first
# BOOK_PARITY_STEPS losses (and db_lstm's CRF transition after them)
# against the CPU's at the same tolerance
BOOK_PARITY_STEPS, BOOK_PAIRS = 3, 3
BOOK_CPU_TOL = 1e-4
CHAPTER_STEPS = 4  # a chapter's main path: eager, capture, 2 replays
# resnet_cifar10 at batch 128 is ill-conditioned in f32 from its
# startup: its first grads come out of f32 only roughly on either
# device (the CPU's f32 step against the same step run by a float64
# copy of the program), so after the first step its f32 losses drift
# from exact, on the CPU as on the card. They are held
# against the CPU's float64 losses instead, within F64_FACTOR times the
# CPU's own f32 distance from them (_cpu_parity; the log prints both)
CHAPTER_F64, F64_FACTOR = ("image_classification_cifar_conv_bn",), 4.0
# the op tail on the card against the CPU (phase 17c): f32 without TF32
# summed in another order, 1e-5 plus a relative 1e-5 (the convs and
# products 1e-4); integers and bools exactly
OP_TAIL_TOL, OP_TAIL_PRODUCT_TOL = 1e-5, 1e-4
OP_TAIL_STEPS = 4  # the CRF and CTC plans' steps: eager, capture, replays


def _book_programs():
    """tools/book_programs.py: the Fluid book's seven programs, their data
    and their assertions (numpy and the port's layers only)."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tools"))
    import book_programs

    return book_programs


def _on_cpu(snap):
    """A CPU scope of copies of a card snapshot's values."""
    import paddle_tpu_torch as fluid

    scope = fluid.Scope()
    for n, v in snap.items():
        scope.set_var(n, v.cpu().clone() if isinstance(v, torch.Tensor)
                      else v)
    return scope


def _fetched(vals):
    return [v.cpu().numpy() for v in vals]


def _cpu_losses(main, loss, snap, feeds, dtype=torch.float32):
    """The losses of ``len(feeds)`` steps of ``main`` in the port on the
    CPU from the snapshot ``snap``, and its scope after them; at
    ``dtype`` float64, a copy of the program whose float32 vars are
    float64, run on float64 copies of the snapshot and the feeds."""
    import paddle_tpu_torch as fluid

    prog, scope = main, _on_cpu(snap)
    if dtype == torch.float64:
        prog = main.clone()
        for v in prog.global_block().vars.values():
            if getattr(v, "dtype", None) == "float32":
                v.dtype = "float64"
        for n in scope.local_var_names():
            v = scope.find_var(n)
            if isinstance(v, torch.Tensor) and v.is_floating_point():
                scope.set_var(n, v.double())
        feeds = [{k: v.astype(np.float64) if v.dtype == np.float32 else v
                  for k, v in f.items()} for f in feeds]
    exe = fluid.Executor(fluid.CPUPlace())
    return [float(np.asarray(exe.run(prog, feed=f, fetch_list=[loss.name],
                                     scope=scope)[0]).reshape(-1)[0])
            for f in feeds], scope


def _cpu_parity(what, exe, main, loss, snap, feeds, card, param=None,
                f64=False):
    """The losses ``card`` of the first ``len(card)`` steps on the card
    (over ``feeds`` in turn) against the port's on the CPU from the same
    snapshot ``snap`` (and, with ``param``, that param after those
    steps, eager on the card), each within BOOK_CPU_TOL * max(1, |CPU
    value|). With ``f64``, for a network whose f32 steps f32 itself
    computes only roughly (``CHAPTER_F64``), the card's losses are held
    against the CPU's in float64 instead, within F64_FACTOR times the
    CPU's f32 losses' distance from those (or BOOK_CPU_TOL): the card's
    f32 as near exact as the CPU's. Returns the CPU's f32 losses, the
    largest gap and the tolerance it was held to."""
    feeds = [feeds[i % len(feeds)] for i in range(len(card))]
    rel = lambda a, b: abs(a - b) / max(1.0, abs(b))  # noqa: E731
    cpu, cpu_scope = _cpu_losses(main, loss, snap, feeds)
    tol, ref = BOOK_CPU_TOL, cpu
    if f64:
        ref = _cpu_losses(main, loss, snap, feeds, torch.float64)[0]
        tol = max(tol, F64_FACTOR * max(rel(a, b) for a, b in zip(cpu, ref)))
    gaps = [rel(a, b) for a, b in zip(card, ref)]
    if param is not None:
        sc = _restored(snap)
        for f in feeds:
            exe._run_eager(main, feed=f, fetch_list=[loss], scope=sc)
        a = sc.find_var(param).detach().cpu().double()
        b = cpu_scope.find_var(param).detach().double()
        gaps.append(float(((a - b).abs() / b.abs().clamp(min=1.0)).max()))
    gap = max(gaps)
    if gap > tol:
        raise AssertionError("%s: the card's first losses %s, the CPU's %s%s "
                             "(%s after them): a gap of %.3e over %.3e" % (
                                 what, card, cpu, ", in float64 %s" % ref
                                 if f64 else "", param, gap, tol))
    return cpu, gap, tol


def _book_functional(fluid, bp, name, seed):
    """Book ``name`` at tests/test_book.py's sizes: started on the card,
    its whole training at level 2 as its chapter runs it (every step
    ``exe.run``; then its final fetch and its post step) on the main
    path, K6 or K7 once a step; the chapter's assertion; the first
    losses the CPU's (fit_a_line's 60, a book the JAX package misses);
    replays bitwise eager."""
    what = "book %s (17)" % name
    t0 = time.perf_counter()
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        book = bp.build(fluid, name)
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    exe.run(startup, scope=scope)
    params = [p.name for p in main.global_block().all_parameters()]
    tier = _tier_stats(main, [v.name for v in book.fetch], scope)
    if not tier["optimizer_groups"]:
        raise AssertionError("%s: level 2 grouped no optimizer update"
                             % what)
    per_step = _per_step(book.optimizer, len(tier["optimizer_groups"]))
    snap = _snapshot(scope)
    step, extra = _amp_step_fn(exe, main, book.fetch[0]), book.fetch[1:]

    def fetch_step(sc, feed, eager=False):
        """A step's fetches, each as its first value."""
        if not extra:
            return (step(sc, feed, eager=eager),)
        loss, rest = step(sc, feed, fetch=extra, eager=eager)
        return (loss,) + tuple(float(r.reshape(-1)[0]) for r in rest)

    steps = []

    def main_step(sc, feed):
        steps.append(fetch_step(sc, feed))
        return steps[-1][0]

    def after():
        final = (_fetched(exe.run(main, feed=book.final_feed,
                                  fetch_list=book.final_fetch, scope=scope,
                                  return_numpy=False))
                 if book.final_feed is not None else [])
        if book.post is not None:
            book.post(fluid, exe, scope)
        return final

    # ---- the main path: counts zeroed here, read after the last step
    path = _metered_steps(what, main_step, scope, book.feeds,
                          len(book.feeds), per_step, after=after)
    # ---- end of the main path
    n_cpu = len(book.feeds) if book.reference_fault else BOOK_PARITY_STEPS
    cpu, gap, _ = _cpu_parity(what, exe, main, book.fetch[0], snap,
                              book.feeds, path["losses"][:n_cpu])
    value, bar, ok = book.check(steps, path["after"])
    if not ok and not book.reference_fault:
        raise AssertionError("%s: the book's assertion fails on the card: "
                             "%s against %s" % (what, value, bar))
    if not ok:
        log("%s: the book's assertion missed, %s against %s, as on the CPU "
            "(its %d losses within %.2e) and in the JAX package: %s"
            % (what, value, bar, n_cpu, gap, book.reference_fault))
    _replay_turns(what, exe, snap, book.feeds, params, fetch_step,
                  BOOK_PAIRS)
    exe.close()
    out = dict(
        steps=len(book.feeds), optimizer=book.optimizer,
        optimizer_groups=tier["optimizer_groups"],
        ops=(tier["ops_before"], tier["ops_after"]),
        assertion=dict(value=value, bar=bar, met=ok,
                       reference_fault=book.reference_fault),
        losses_first=path["losses"][:BOOK_PARITY_STEPS],
        cpu_losses_first=cpu[:BOOK_PARITY_STEPS], cpu_gap=gap,
        loss_last=path["losses"][-1],
        launches=dict(zip(COUNT_NAMES, path["launches"])),
        seconds=time.perf_counter() - t0)
    log("%s: %d steps (%s, %d optimizer group(s), level 2: %d ops of %d); "
        "the book's assertion %s against %s; first losses %s, the CPU's "
        "(%d) within %.2e; replays bitwise eager; launches %s = %s on the "
        "card; %.1f s" % (what, len(book.feeds), book.optimizer,
                          len(tier["optimizer_groups"]), tier["ops_after"],
                          tier["ops_before"], value, bar,
                          ["%.5f" % v for v in out["losses_first"]], n_cpu,
                          gap, COUNT_NAMES, path["launches"], out["seconds"]))
    return out


def _chapter_at_widths(fluid, bp, name, seed):
    """Book ``name``'s chapter network at its widths
    (``book_programs.CHAPTER``): started on the card, trained by
    ``_seq_train`` (the main path, K6 or K7 once a step; pairs in turns
    bitwise; replayed and eager ms, a profiled replayed step, peak
    memory), its first losses the CPU's."""
    what = "chapter %s at its widths (17)" % name
    t0 = time.perf_counter()
    cfg = bp.CHAPTER[name]
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        feeds, loss, opt = bp.chapter(fluid, name)
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    exe.run(startup, scope=scope)
    params = [p.name for p in main.global_block().all_parameters()]
    tier = _tier_stats(main, [loss.name], scope)
    snap, _, res = _seq_train(what, exe, scope, main, loss, params, tier,
                              feeds, cfg["batch"], "examples", opt=opt,
                              steps=CHAPTER_STEPS, eager_readings=False)
    cpu, gap, tol = _cpu_parity(what, exe, main, loss, snap, feeds,
                                res["losses"][:BOOK_PARITY_STEPS],
                                f64=name in CHAPTER_F64)
    exe.close()
    c = res["compiled"]
    prof = c["replay_profile"]
    out = dict(cfg=cfg, optimizer=opt, n_params=res["n_params"],
               n_weights=res["n_weights"],
               ops=(tier["ops_before"], tier["ops_after"]),
               losses=res["losses"], cpu_losses_first=cpu, cpu_gap=gap,
               cpu_tol=tol,
               replay_ms=c["replay_median_ms"], eager_ms=c["eager_median_ms"],
               capture_s=c["capture_s"], kernels=prof["kernels"],
               busy_share=prof["busy_share"],
               busy_ms=prof["device_busy_ms"],
               by_class_ms=prof["by_class_ms"],
               peak_mem_mib=res["peak_mem_mib"],
               base_mem_mib=res["base_mem_mib"],
               rise_mem_mib=res["rise_mem_mib"], launches=res["launches"],
               seconds=time.perf_counter() - t0)
    log("%s: %d params (%d weights), batch %d; first losses the CPU's "
        "within %.2e%s; %.1f s" % (what, res["n_params"], res["n_weights"],
                                 cfg["batch"], gap,
                                 " of float64's (the CPU's f32 within "
                                 "%.2e of them, held to %.2e)" % (
                                     tol / F64_FACTOR, tol)
                                 if name in CHAPTER_F64 else "",
                                 out["seconds"]))
    return out


def phase_book(seed):
    """Phase 17: the Fluid book's seven trainings at tests/test_book.py's
    sizes (built by tools/book_programs.py with the port's layers), each
    started on the card, its whole training at level 2 (replayed from
    the plan's CUDA graph from the second step on) with K6 (Adam) or K7
    (fit_a_line's SGD) once a step on the card, and the chapter's end
    assertion met; the first 3 losses against the port on the CPU from
    the same startup; replayed steps bitwise the eager steps. Then the
    six chapters' networks but label_semantic_roles' (17b) at their
    widths: trained on the card, their first losses the CPU's, replays
    bitwise eager, the replayed and eager ms a step, the kernels and
    busy share of a replayed step and the peak memory."""
    import paddle_tpu_torch as fluid

    bp = _book_programs()
    out = {}
    launches = np.zeros(len(COUNT_NAMES), dtype=np.int64)
    for name in bp.BOOK:
        out[name] = _book_functional(fluid, bp, name, seed)
        launches += [out[name]["launches"][c] for c in COUNT_NAMES]
    for name in bp.CHAPTER:
        key = "chapter " + name
        out[key] = _chapter_at_widths(fluid, bp, name, seed)
        launches += [out[key]["launches"][c] for c in COUNT_NAMES]
        _free()
    out["launches"] = dict(zip(COUNT_NAMES, (int(v) for v in launches)))
    return out


def phase_srl(seed):
    """Phase 17b: label_semantic_roles' ``db_lstm`` at the chapter's
    widths (word embedding 32, mark embedding 5, hidden 512, 8 stacked
    ``dynamic_lstm``s alternating direction, ``linear_chain_crf`` and
    ``crf_decoding``; conll05's 512 words, 64 verbs and 6 labels), batch
    32 padded to T = 24, the pretrained embedding loaded, Adam at level
    2: ``_seq_train``'s main path with K6 once a step on the card, the
    loss falling, its pairs and readings; the first 3 losses and the CRF
    transition after them the port's on the CPU from the same snapshot;
    then a decode."""
    import paddle_tpu_torch as fluid

    bp = _book_programs()
    what = "srl db_lstm (17b)"
    t0 = time.perf_counter()
    held_mb = torch.cuda.memory_allocated() / 2 ** 20
    cfg = bp.SRL
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        _, loss, decode = bp.srl_db_lstm(fluid, cfg)
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    exe.run(startup, scope=scope)
    scope.find_var("emb").copy_(torch.from_numpy(
        fluid.dataset.conll05.get_embedding()))
    params = [p.name for p in main.global_block().all_parameters()]
    tier = _tier_stats(main, [loss.name], scope)
    batches = bp.srl_batches(cfg)
    snap, _, res = _seq_train(what, exe, scope, main, loss, params, tier,
                              batches, cfg["batch"], "sentences",
                              eager_readings=False)
    losses = res["losses"]
    first, last = (float(np.mean(losses[k])) for k in (slice(0, 4),
                                                       slice(-4, None)))
    if not last < first:
        raise AssertionError("%s: the loss does not fall: %s"
                             % (what, losses))
    cpu, gap, _ = _cpu_parity(what, exe, main, loss, snap, batches,
                              losses[:BOOK_PARITY_STEPS], param="crfw")
    b = batches[0]
    (path_ids,) = exe.run(main, feed=b, fetch_list=[decode], scope=scope)
    lengths, target = b["length"], b["target"]
    valid = np.arange(cfg["max_len"])[None, :] < lengths[:, None]
    if path_ids.shape != target.shape or path_ids[~valid].any() or \
            path_ids.min() < 0 or path_ids.max() >= len(
                fluid.dataset.conll05.get_dict()[2]):
        raise AssertionError("%s: the decode is not a tag path: shape %s, "
                             "range [%s, %s]" % (what, path_ids.shape,
                                                 path_ids.min(),
                                                 path_ids.max()))
    acc = float((path_ids == target)[valid].mean())
    exe.close()
    c = res["compiled"]
    prof = c["replay_profile"]
    out = dict(cfg=cfg, n_params=res["n_params"], n_weights=res["n_weights"],
               ops=(tier["ops_before"], tier["ops_after"]), losses=losses,
               cpu_losses_first=cpu, cpu_gap=gap,
               replay_ms=c["replay_median_ms"], eager_ms=c["eager_median_ms"],
               capture_s=c["capture_s"], kernels=prof["kernels"],
               busy_share=prof["busy_share"], busy_ms=prof["device_busy_ms"],
               by_class_ms=prof["by_class_ms"],
               peak_mem_mib=res["peak_mem_mib"],
               base_mem_mib=res["base_mem_mib"],
               rise_mem_mib=res["rise_mem_mib"], held_mem_mib=held_mb,
               decode_accuracy=acc, launches=res["launches"],
               seconds=time.perf_counter() - t0)
    log("%s: %d params (%d weights); the loss %.3f -> %.3f; first losses "
        "and the CRF transition after them the CPU's within %.2e; %.1f MiB "
        "held by earlier phases as it began; decode accuracy %.3f; %.1f s"
        % (what, res["n_params"], res["n_weights"], first, last, gap,
           held_mb, acc, out["seconds"]))
    return out


def _op_tail_cases(rs):
    """(op, inputs as numpy, attrs, differentiable input slots, tolerance)
    for one small case of each of phase 17c's op types, shaped like
    tests/test_torch_ops.py's cases (ties, repeated ids, lengths 0 and
    1, ids past a table); the random ops and nce are checked apart
    (``_op_tail_random``), as is im2sequence, which raises."""
    f = lambda *s: rs.randn(*s).astype("float32")  # noqa: E731
    i32 = lambda hi, *s: rs.randint(0, hi, s).astype("int32")  # noqa
    T, P = OP_TAIL_TOL, OP_TAIL_PRODUCT_TOL
    x3, x4 = f(2, 3, 4), f(2, 3, 4, 5)
    lens = np.array([0, 1, 6, 3], "int32")
    return [
        ("split", {"X": [x3]}, {"axis": 2, "sections": [1, 3]}, ["X"], T),
        ("squeeze", {"X": [f(2, 1, 4)]}, {}, ["X"], T),
        ("unsqueeze", {"X": [x3]}, {"axes": [0, 3]}, ["X"], T),
        ("flatten", {"X": [x3]}, {"axis": 2}, ["X"], T),
        ("flatten2", {"X": [x3]}, {"axis": 1}, ["X"], T),
        ("unstack", {"X": [x3]}, {"axis": 1}, ["X"], T),
        ("strided_slice", {"Input": [f(7, 6, 5)]},
         {"axes": [0, 1], "starts": [-1, 0], "ends": [-8, 6],
          "strides": [-3, 2]}, ["Input"], T),
        ("gather_nd", {"X": [f(4, 5, 3)], "Index": [np.array(
            [[0, 1], [3, 4], [9, -1]], "int32")]}, {}, ["X"], T),
        ("scatter", {"X": [f(6, 3)], "Ids": [np.array([4, 0, 2], "int32")],
                     "Updates": [f(3, 3)]}, {"overwrite": True},
         ["X", "Updates"], T),
        ("expand_as", {"X": [f(2, 1, 4)], "target_tensor": [x3]}, {},
         ["X"], T),
        ("tile", {"X": [f(2, 3)]}, {"repeat_times": [2, 1, 2]}, ["X"], T),
        ("pad", {"X": [x3]}, {"paddings": [1, 0, 0, 2, 1, 1],
                              "pad_value": 0.5}, ["X"], T),
        ("pad2d", {"X": [x4]}, {"paddings": [1, 0, 2, 1],
                                "mode": "reflect"}, ["X"], T),
        ("crop", {"X": [x3]}, {"offsets": [0, 1, 1], "shape": [2, 2, 2]},
         ["X"], T),
        ("reverse", {"X": [x3]}, {"axis": [0, 2]}, ["X"], T),
        ("shard_index", {"X": [np.array([[0], [7], [12], [19]], "int32")]},
         {"index_num": 20, "nshards": 3, "shard_id": 1}, [], T),
        ("roll", {"X": [x3]}, {"shifts": [1, -1], "axis": [1, 2]}, ["X"], T),
        ("meshgrid", {"X": [f(3), f(4)]}, {}, ["X"], T),
        ("matmul_v2", {"X": [f(2, 4, 3)], "Y": [f(2, 4, 5)]},
         {"trans_x": True}, ["X", "Y"], P),
        ("bmm", {"X": [f(3, 2, 4)], "Y": [f(3, 4, 5)]}, {}, ["X", "Y"], P),
        ("arg_max", {"X": [i32(3, 4, 6).astype("float32")]}, {}, [], T),
        ("arg_min", {"X": [i32(3, 4, 6).astype("float32")]}, {"axis": 0},
         [], T),
        ("argsort", {"X": [i32(3, 4, 6).astype("float32")]}, {}, [], T),
        ("cumsum", {"X": [f(3, 5)]}, {"exclusive": True, "reverse": True},
         ["X"], T),
        ("cumsum", {"X": [i32(9, 3, 5)]}, {"axis": 0}, [], T),
        ("norm", {"X": [x3]}, {"axis": 1}, ["X"], T),
        ("dot", {"X": [f(3, 5)], "Y": [f(3, 5)]}, {}, ["X", "Y"], T),
        ("maximum_with_index", {"X": [i32(3, 4, 6).astype("float32")]}, {},
         [], T),
        ("fill_any_like", {"X": [f(2, 3)]}, {"value": 3, "dtype": "int32"},
         [], T),
        ("share_data", {"X": [f(2, 3)]}, {}, ["X"], T),
        ("shape", {"Input": [x3]}, {}, [], T),
        ("isfinite", {"X": [np.array([1.0, np.inf], "float32")]}, {}, [],
         T),
        ("linspace", {"Start": [np.full(1, -3.5, "float32")],
                      "Stop": [np.full(1, 2.25, "float32")],
                      "Num": [np.full(1, 11, "int32")]}, {}, [], T),
        ("prelu", {"X": [x4], "Alpha": [f(3)]}, {"mode": "channel"},
         ["X", "Alpha"], T),
        ("depthwise_conv2d", {"Input": [f(2, 4, 7, 6)],
                              "Filter": [f(8, 1, 3, 3)]},
         {"strides": [2, 1], "paddings": [1, 1], "groups": 4},
         ["Input", "Filter"], P),
        ("conv2d_transpose", {"Input": [f(2, 4, 5, 6)],
                              "Filter": [f(4, 3, 3, 2)]},
         {"strides": [2, 1], "paddings": [1, 0], "dilations": [1, 2]},
         ["Input", "Filter"], P),
        ("conv3d", {"Input": [f(2, 4, 4, 5, 4)],
                    "Filter": [f(4, 2, 2, 3, 2)]},
         {"strides": [1, 2, 1], "paddings": [1, 0, 1], "groups": 2},
         ["Input", "Filter"], P),
        ("pool2d_with_index", {"X": [i32(3, 2, 6, 5, 4).astype(
            "float32")]}, {"ksize": [3, 2], "strides": [2, 2],
                           "paddings": [1, 0]}, [], T),
        ("pool2d_with_index", {"X": [f(2, 6, 5, 4)]},
         {"ksize": [3, 2], "strides": [2, 2], "paddings": [1, 0]}, ["X"],
         T),
        ("group_norm", {"X": [f(2, 6, 3, 4)], "Scale": [f(6)],
                        "Bias": [f(6)]}, {"groups": 3},
         ["X", "Scale", "Bias"], T),
        ("lrn", {"X": [f(2, 6, 3, 4)]}, {"n": 3, "alpha": 0.1}, ["X"], T),
        ("log_softmax", {"X": [x3]}, {"axis": 1}, ["X"], T),
        ("sigmoid_cross_entropy_with_logits",
         {"X": [f(5, 3)], "Label": [rs.rand(5, 3).astype("float32")]},
         {"normalize": True}, ["X"], T),
        ("square_error_cost", {"X": [f(5, 3)], "Y": [f(5, 3)]}, {},
         ["X", "Y"], T),
        ("smooth_l1_loss", {"X": [f(5, 3)], "Y": [f(5, 3)]},
         {"sigma": 2.0}, ["X"], T),
        ("huber_loss", {"X": [f(5, 1)], "Y": [f(5, 1)]}, {"delta": 0.7},
         ["X", "Y"], T),
        ("log_loss", {"Predicted": [rs.rand(5, 1).astype("float32")],
                      "Labels": [i32(2, 5, 1).astype("float32")]}, {},
         ["Predicted"], T),
        ("lookup_table_v2", {"W": [f(10, 4)], "Ids": [np.array(
            [[1, 2, 2], [7, 1, 12]], "int32")]}, {"padding_idx": 2},
         ["W"], T),
        ("maxout", {"X": [f(2, 6, 3, 4)]}, {"groups": 3}, ["X"], T),
        ("cos_sim", {"X": [f(5, 3)], "Y": [f(1, 3)]}, {}, ["X", "Y"], T),
        ("rank_loss", {"Label": [i32(2, 5, 1).astype("float32")],
                       "Left": [f(5, 1)], "Right": [f(5, 1)]}, {},
         ["Left", "Right"], T),
        ("margin_rank_loss", {"Label": [np.sign(f(5, 1))],
                              "X1": [f(5, 1)], "X2": [f(5, 1)]},
         {"margin": 0.1}, ["X1", "X2"], T),
        ("bpr_loss", {"X": [f(5, 3)], "Label": [np.array(
            [[0], [2], [1], [1], [0]], "int32")]}, {}, ["X"], T),
        ("hierarchical_sigmoid", {"X": [f(6, 5)], "W": [f(6, 5)],
                                  "Bias": [f(6)],
                                  "Label": [i32(7, 6, 1)]},
         {"num_classes": 7}, ["X", "W", "Bias"], T),
        ("warpctc", {"Logits": [f(4, 6, 5)], "Label": [rs.randint(
            1, 5, (4, 3)).astype("int32")],
            "LogitsLength": [np.array([1, 2, 6, 4], "int32")],
            "LabelLength": [np.array([0, 1, 3, 2], "int32")]},
         {"blank": 0}, ["Logits"], T),
        ("linear_chain_crf", {"Emission": [f(4, 6, 4)],
                              "Transition": [f(6, 4)],
                              "Label": [i32(4, 4, 6)], "Length": [lens]},
         {}, ["Emission", "Transition"], T),
        ("crf_decoding", {"Emission": [np.round(f(4, 6, 4))],
                          "Transition": [np.round(f(6, 4))],
                          "Length": [lens]}, {}, [], T),
        ("edit_distance", {"Hyps": [i32(3, 4, 5)], "Refs": [i32(3, 4, 6)],
                           "HypsLength": [np.array([5, 0, 3, 1], "int32")],
                           "RefsLength": [np.array([6, 2, 0, 4], "int32")]},
         {"normalized": True}, [], T),
        ("bilinear_interp", {"X": [x4]}, {"out_h": 6, "out_w": 9,
                                          "align_corners": False}, ["X"], T),
        ("nearest_interp", {"X": [x4]}, {"out_h": 7, "out_w": 3}, ["X"], T),
        ("affine_channel", {"X": [x4], "Scale": [f(3)], "Bias": [f(3)]},
         {}, ["X", "Scale", "Bias"], T),
    ]


def _op_on(dev, op_type, ins, attrs, chain=None):
    from paddle_tpu_torch.core.lowering import LowerContext
    from paddle_tpu_torch.core.registry import get_op

    return get_op(op_type).lowering(
        LowerContext(None, chain, dev),
        {k: [torch.from_numpy(np.array(v)).to(dev) for v in vs]
         for k, vs in ins.items()}, dict(attrs))


def _op_grad_on(dev, op_type, ins, outs, cots, attrs, diff):
    """``<op>_grad`` on ``dev``: numpy forward inputs, outputs (None kept)
    and output cotangents; the grads of the slots ``diff``."""
    from paddle_tpu_torch.core.autodiff import (ATTR_DIFF, ATTR_FWD_IN,
                                                ATTR_FWD_OUT)
    from paddle_tpu_torch.core.lowering import LowerContext
    from paddle_tpu_torch.core.registry import get_op

    gattrs = dict(attrs)
    gattrs[ATTR_FWD_IN] = {k: len(v) for k, v in ins.items()}
    gattrs[ATTR_FWD_OUT] = {k: len(v) for k, v in outs.items()}
    gattrs[ATTR_DIFF] = [[s, i] for s in diff for i in range(len(ins[s]))]
    gins = dict(ins, **outs, **cots)
    got = get_op(op_type + "_grad").lowering(
        LowerContext(None, None, dev),
        {k: [None if v is None else torch.from_numpy(np.array(v)).to(dev)
             for v in vs] for k, vs in gins.items()}, gattrs)
    return {s: [g.cpu() for g in got[s + "@GRAD"]] for s in diff}


def _same(a, b, tol):
    """``a`` (the card's) against ``b`` (the CPU's): floats within tol +
    a relative tol, NaN where NaN; others exactly; the same dtype."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if not a.is_floating_point():
        return torch.equal(a, b)
    return bool(torch.allclose(a, b, rtol=tol, atol=tol, equal_nan=True))


def _ops_against_cpu(cases, rs, dev, repeat=False):
    """Each case (op, numpy inputs, attrs, differentiable slots,
    tolerance) on ``dev`` against the same op on the CPU: every output
    within its tolerance (``_same``), and the grads of its
    differentiable slots on random cotangents from ``rs`` (with
    ``repeat``, taken twice on the card and bitwise equal). Returns the
    op types checked and what differed."""
    cpu = torch.device("cpu")
    done, bad = set(), []
    for op_type, ins, attrs, diff, tol in cases:
        outs = [_op_on(d, op_type, ins, attrs) for d in (dev, cpu)]
        for slot, vals in outs[1].items():
            for a, b in zip(outs[0][slot], vals):
                if b is not None and not _same(a.cpu(), b, tol):
                    bad.append("%s.%s" % (op_type, slot))
        if diff:
            fwd = {k: [None if v is None else v.cpu().numpy() for v in vs]
                   for k, vs in outs[1].items()}
            cots = {k + "@GRAD": [np.asarray(rs.randn(*v.shape))
                                  .astype(v.dtype) for v in vs]
                    for k, vs in fwd.items()
                    if all(v is not None and v.dtype.kind == "f"
                           for v in vs)}
            g = [_op_grad_on(d, op_type, ins, fwd, cots, attrs, diff)
                 for d in ((dev, dev, cpu) if repeat else (dev, cpu))]
            for s in diff:
                for a, a2, b in zip(g[0][s], g[-2][s], g[-1][s]):
                    if not (_same(a, b, tol) and torch.equal(a, a2)):
                        bad.append("%s %s@GRAD" % (op_type, s))
        done.add(op_type)
    return done, bad


def _op_tail_random(dev):
    """The random ops on the card: shapes, ranges, moments, a nonzero
    ``seed`` attr's fixed draw; nce's negatives in range with the label
    first, its cost and grads the CPU's on those negatives."""
    from paddle_tpu_torch.ops.loss_ops import nce_loss

    chain = lambda s: torch.Generator().manual_seed(s)  # noqa: E731
    tg = lambda s, **a: _op_on(  # noqa: E731
        dev, "truncated_gaussian_random", {}, dict(
            {"shape": [256, 256], "mean": 0.5, "std": 2.0}, **a),
        chain(s))["Out"][0].cpu()
    z = tg(1)
    if not (z.min() >= -3.5 and z.max() <= 4.5 and abs(z.mean() - 0.5) <
            0.03 and abs(z.std() - 2 * 0.8796) < 0.03):
        raise AssertionError("op tail (17c): truncated_gaussian_random on "
                             "the card: range [%s, %s], mean %s, std %s" % (
                                 z.min(), z.max(), z.mean(), z.std()))
    if not torch.equal(tg(1, seed=9), tg(2, seed=9)) or torch.equal(tg(2),
                                                                    z):
        raise AssertionError("op tail (17c): truncated_gaussian_random's "
                             "seeds on the card")
    u = _op_on(dev, "uniform_random_batch_size_like",
               {"Input": [np.zeros((3, 7), "float32")]},
               {"shape": [-1, 500], "input_dim_idx": 1, "min": -0.5,
                "max": 2.0}, chain(1))["Out"][0].cpu()
    if tuple(u.shape) != (7, 500) or u.min() < -0.5 or u.max() >= 2.0:
        raise AssertionError("op tail (17c): uniform_random_batch_size_like "
                             "on the card: %s in [%s, %s]" % (
                                 tuple(u.shape), u.min(), u.max()))
    p = np.tile(np.array([[0.2, 0.0, 0.8]], "float32"), (4000, 1))
    ids = _op_on(dev, "sampling_id", {"X": [p]}, {}, chain(1))["Out"][0]
    share = torch.bincount(ids.long().cpu(), minlength=3) / 4000.0
    if ids.dtype != torch.int32 or share[1] != 0 or \
            abs(float(share[2]) - 0.8) > 0.05:
        raise AssertionError("op tail (17c): sampling_id on the card: %s"
                             % share.tolist())
    rs = np.random.RandomState(3)
    x, w, b = (rs.randn(5, 6).astype("float32"),
               rs.randn(20, 6).astype("float32"),
               rs.randn(20).astype("float32"))
    ins = {"Input": [x], "Weight": [w], "Bias": [b],
           "Label": [np.array([[3], [0], [19], [3], [7]], "int32")]}
    attrs = {"num_neg_samples": 8, "num_total_classes": 20}
    got = _op_on(dev, "nce", ins, attrs, chain(1))
    sl = got["SampleLabels"][0].cpu()
    want = nce_loss(torch.from_numpy(x), torch.from_numpy(w),
                    torch.from_numpy(b), sl, 8, 20)[0]
    if sl.dtype != torch.int32 or not torch.equal(
            sl[:, 0], torch.tensor([3, 0, 19, 3, 7], dtype=torch.int32)) \
            or sl.min() < 0 or sl.max() >= 20 or \
            not _same(got["Cost"][0].cpu(), want, OP_TAIL_TOL):
        raise AssertionError("op tail (17c): nce on the card")
    outs = {k: [v[0].cpu().numpy()] for k, v in got.items()}
    cots = {"Cost@GRAD": [rs.randn(5, 1).astype("float32")]}
    g = [_op_grad_on(d, "nce", ins, outs, cots, attrs,
                     ["Input", "Weight", "Bias"])
         for d in (dev, torch.device("cpu"))]
    bad = [s for s in g[0] if not _same(g[0][s][0], g[1][s][0],
                                        OP_TAIL_TOL)]
    if bad:
        raise AssertionError("op tail (17c): nce's grads on the card: %s"
                             % bad)
    with_raise = False
    try:
        _op_on(dev, "im2sequence", {"X": [np.zeros((1, 1, 4, 4),
                                                   "float32")]}, {})
    except NotImplementedError:
        with_raise = True
    if not with_raise:
        raise AssertionError("op tail (17c): im2sequence did not raise")
    return ["truncated_gaussian_random", "uniform_random_batch_size_like",
            "sampling_id", "nce", "im2sequence"]


def _op_tail_scatter(dev):
    """``scatter`` over 20000 repeated ids in 100 rows (some past the
    rows): two runs on the card bitwise equal; overwrite the CPU's
    (the last write wins), adds within 1e-4 of the CPU's."""
    rs = np.random.RandomState(4)
    ins = {"X": [rs.randn(100, 8).astype("float32")],
           "Ids": [rs.randint(-100, 110, 20000).astype("int32")],
           "Updates": [rs.randn(20000, 8).astype("float32")]}
    for overwrite in (True, False):
        a, b, c = (_op_on(d, "scatter", ins, {"overwrite": overwrite})[
            "Out"][0].cpu() for d in (dev, dev, torch.device("cpu")))
        if not torch.equal(a, b) or not (
                torch.equal(a, c) if overwrite else
                torch.allclose(a, c, rtol=1e-5, atol=1e-4)):
            raise AssertionError("op tail (17c): scatter overwrite=%s over "
                                 "repeated ids on the card" % overwrite)


def _op_tail_linspace(seed):
    """A ``linspace`` plan on the card: never captured (it reads its
    bounds on the host), right at every run, counted once in
    ``paddle_executor_uncaptured_plans_total{op="linspace"}``."""
    import warnings

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core.executor import UNCAPTURED_PLANS

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        start = fluid.layers.data("start", [1], append_batch_size=False)
        out = fluid.layers.linspace(start, 4.0, 9)
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    before = UNCAPTURED_PLANS.labels(op="linspace").value
    wrong = []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for k in (0.0, 2.0, -4.0, 1.0):
            (got,) = exe.run(main, feed={"start": np.array([k], "float32")},
                             fetch_list=[out], scope=scope)
            if not np.allclose(got, np.linspace(k, 4.0, 9), atol=1e-6):
                wrong.append(k)
    (plan,) = exe._cache.values()
    counted = UNCAPTURED_PLANS.labels(op="linspace").value - before
    exe.close()
    if wrong or plan.graph is not None or counted != 1 or \
            plan.host_sync != ["linspace"]:
        raise AssertionError("op tail (17c): linspace: wrong at %s, "
                             "captured %s, counted %s, host-sync ops %s" % (
                                 wrong, plan.graph is not None, counted,
                                 plan.host_sync))
    return dict(counted=counted, host_sync=plan.host_sync)


def _op_tail_scan_plans(seed):
    """Training plans of a CRF and a CTC loss (an fc over a padded [B, T,
    D] batch, Adam) on the card: OP_TAIL_STEPS steps under the launch
    meter (K6 once a step), captured, and replays bitwise the eager
    steps."""
    import paddle_tpu_torch as fluid

    L = fluid.layers
    rs = np.random.RandomState(seed)
    B, T, D, C = 16, 20, 32, 6
    out, launches = {}, np.zeros(len(COUNT_NAMES), dtype=np.int64)
    for kind in ("crf", "ctc"):
        what = "op tail %s plan (17c)" % kind
        main, startup = fluid.Program(), fluid.Program()
        main.random_seed = startup.random_seed = seed
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            x = L.data("x", [T, D])
            ln = L.data("len", [], dtype="int64")
            emit = L.fc(x, size=C, num_flatten_dims=2)
            if kind == "crf":
                tags = L.data("tags", [T], dtype="int64")
                cost = L.scale(L.linear_chain_crf(emit, tags, length=ln),
                               scale=-1.0)
            else:
                lab = L.data("lab", [5], dtype="int64")
                lab_len = L.data("lab_len", [], dtype="int64")
                cost = L.warpctc(emit, lab, ln, lab_len)
            loss = L.mean(cost)
            fluid.optimizer.Adam(learning_rate=1e-2).minimize(loss)
        feeds = []
        for _ in range(OP_TAIL_STEPS):
            f = {"x": rs.randn(B, T, D).astype("float32"),
                 "len": rs.randint(1, T + 1, B).astype("int64")}
            if kind == "crf":
                f["tags"] = rs.randint(0, C, (B, T)).astype("int64")
            else:
                f["lab"] = rs.randint(1, C, (B, 5)).astype("int64")
                f["lab_len"] = rs.randint(0, 6, B).astype("int64")
                f["len"] = np.maximum(f["len"], 11)
            feeds.append(f)
        exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
        exe.run(startup, scope=scope)
        params = [p.name for p in main.global_block().all_parameters()]
        per_step = _per_step("Adam", len(_tier_stats(
            main, [loss.name], scope)["optimizer_groups"]))
        snap = _snapshot(scope)
        path = _metered_steps(what, _amp_step_fn(exe, main, loss), scope,
                              feeds, OP_TAIL_STEPS, per_step)
        _replay_turns(what, exe, snap, feeds, params,
                      _amp_step_fn(exe, main, loss), len(feeds) - 1)
        exe.close()
        launches += np.asarray(path["launches"])
        out[kind] = dict(losses=path["losses"],
                         launches=dict(zip(COUNT_NAMES, path["launches"])))
    return out, launches


def phase_op_tail(seed):
    """Phase 17c: each of the 64 op types of this slice on the card
    against the same op on the CPU (one small case, and its grad where it
    is differentiable; the random ops by their properties), scatter over
    repeated ids repeatable, a linspace plan uncaptured and counted, and
    the CRF and CTC training plans captured with replays bitwise
    eager."""
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    rs = np.random.RandomState(seed)
    done, bad = _ops_against_cpu(_op_tail_cases(rs), rs, dev)
    done.update(_op_tail_random(dev))
    if bad:
        raise AssertionError("op tail (17c): the card differs from the CPU: "
                             "%s" % bad)
    if len(done) != 64:
        raise AssertionError("op tail (17c): %d op types checked, not 64"
                             % len(done))
    _op_tail_scatter(dev)
    lin = _op_tail_linspace(seed)
    plans, launches = _op_tail_scan_plans(seed)
    secs = time.perf_counter() - t0
    log("op tail (17c): %d op types on the card against the CPU (forward, "
        "and the grads of the differentiable ones), the random ones by "
        "their properties; scatter over repeated ids repeatable; a linspace "
        "plan uncaptured, counted %d; the CRF and CTC plans captured, "
        "replays bitwise eager, losses %s / %s; launches %s = %s; %.1f s" % (
            len(done), lin["counted"],
            ["%.4f" % v for v in plans["crf"]["losses"]],
            ["%.4f" % v for v in plans["ctc"]["losses"]], COUNT_NAMES,
            tuple(int(v) for v in launches), secs))
    return dict(op_types=sorted(done), linspace=lin, plans=plans,
                launches=dict(zip(COUNT_NAMES, (int(v) for v in launches))),
                seconds=secs)


# --------------------------------------------------------------- phase 18
ZOO_BATCH = 8      # the JAX package's zoo gate's batch
ZOO_REPLAYS = 5    # replayed steps timed per zoo program (after 3 warm-up)
ZOO_MIN_WITHIN = 9  # of 11 within ZOO_COST_GATE_FACTOR
FULL_REPLAYS = 5   # replayed steps timed for a full-width model under
                   # --phases when its phase did not run


def _zoo_feed(main, batch):
    """The JAX package's zoo gate's feeds: zeros of each data var's shape
    (the batch dim at ``batch``)."""
    feed = {}
    for v in main.global_block().vars.values():
        if not v.is_data:
            continue
        shape = [batch if (d is None or d < 0) else int(d)
                 for d in (v.shape or [])]
        dt = str(v.dtype or "float32")
        feed[v.name] = np.zeros(
            shape, dtype="int64" if "int" in dt else "float32")
    return feed


def _replayed_median_ms(exe, main, loss, feed, scope, n):
    """The median host-clock ms of ``n`` replayed ``Executor.run`` steps
    (their fetch included), after three warm-up runs: the eager step,
    the capture, a first replay."""
    for _ in range(3):
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    ms = []
    for _ in range(n):
        t0 = time.perf_counter()
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        ms.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ms))


def _gpt_program(amp=False):
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import gpt

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        loss, _ = gpt.build(gpt.base_config(), seq_len=GPT_SEQ)
        optimizer = fluid.optimizer.Adam(learning_rate=TRAIN_LR)
        if amp:
            optimizer = fluid.contrib.mixed_precision.decorate(optimizer)
        optimizer.minimize(loss)
    return main, startup, loss


def _resnet_program():
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import resnet

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        loss, _, _ = resnet.build(class_dim=IMG_CLASSES, depth=50,
                                  image_shape=(3, 224, 224))
        fluid.optimizer.Adam(learning_rate=TRAIN_LR).minimize(loss)
    return main, startup, loss


def _full_width_cases(seed):
    """(what, phase, build() -> (main, startup, loss), batch, feed())
    of the full-width models whose predicted step phase 18 prints."""
    bert_prog = lambda amp: lambda: _bert_train_program(  # noqa: E731
        "Adam", amp)[:3]
    rs = np.random.RandomState(seed)
    return [
        ("BERT-base MLM f32", "6", bert_prog(False), TRAIN_BATCH,
         lambda: _train_batch(bert_cfg(), rs)),
        ("BERT-base MLM AMP", "6b", bert_prog(True), TRAIN_BATCH,
         lambda: _train_batch(bert_cfg(), rs)),
        ("GPT-2 small f32", "8", _gpt_program, GPT_BATCH,
         lambda: _gpt_batch(50304, rs)),
        ("ResNet-50 f32", "10", _resnet_program, IMG_BATCH,
         lambda: _image_batches(seed + 12, 1)[0]),
    ]


def phase_cost_model(seed, R):
    """Phase 18: the roofline cost model on the card. The device model
    (the H100's peaks by dtype from its datasheet table, the overheads
    probed through the port's executor; not ``default``); the JAX
    package's zoo gate held on the card: all eleven zoo train programs
    (tools/torch_cost_report.py's builders, batch 8) price, and the
    predicted step is within ``ZOO_COST_GATE_FACTOR`` of the measured
    replayed step on at least 9 of 11; then predicted against measured
    at full width for BERT-base MLM (f32 and AMP), GPT-2 small and
    ResNet-50, the replayed medians of phases 6, 6b, 8 and 10 where they
    ran (measured here otherwise)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.analysis.cost import (CostAnalysis, DeviceModel,
                                                ZOO_COST_GATE_FACTOR)

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tools"))
    import torch_cost_report

    t0 = time.perf_counter()
    dev = DeviceModel.current()
    model = dev.to_dict()
    log("cost model (18): %s: f32 %.4g FLOP/s, %.4g B/s, op overhead %.3f "
        "us, call overhead %.3f us; peaks by dtype %s; conv %.4g; source %s "
        "(probed in %.1f s)" % (
            dev.kind, dev.peak_flops, dev.peak_bandwidth,
            dev.op_overhead * 1e6, dev.call_overhead * 1e6,
            {k: "%.4g" % v for k, v in sorted(dev.dtype_peaks.items())},
            dev.conv_peak_flops, dev.source, time.perf_counter() - t0))
    if dev.source == "default" or not dev.kind.startswith("cuda:"):
        raise AssertionError("cost model (18): the device model resolved "
                             "to %r on %s" % (dev.source, dev.kind))

    zoo, within = {}, 0
    for name in sorted(torch_cost_report.EXAMPLE_BUILDERS):
        main, startup, loss = torch_cost_report.build_example(name)
        scope = fluid.Scope()
        exe = fluid.Executor(fluid.CUDAPlace(0))
        exe.run(startup, scope=scope)
        ca = CostAnalysis(main, fetch_names=[loss.name], scope=scope)
        pred_ms = ca.predicted_seconds(ZOO_BATCH) * 1e3
        meas_ms = _replayed_median_ms(exe, main, loss,
                                      _zoo_feed(main, ZOO_BATCH), scope,
                                      ZOO_REPLAYS)
        ratio = pred_ms / meas_ms
        ok = 1.0 / ZOO_COST_GATE_FACTOR <= ratio <= ZOO_COST_GATE_FACTOR
        within += ok
        zoo[name] = dict(predicted_ms=pred_ms, measured_ms=meas_ms,
                         ratio=ratio, within=ok, ops=len(ca.op_costs),
                         flops=ca.flops(ZOO_BATCH),
                         bytes=ca.bytes_moved(ZOO_BATCH),
                         uncaptured=bool(exe._cache and all(
                             p.graph is None for p in exe._cache.values())))
        log("cost model (18): zoo %-19s batch %d: predicted %.3f ms, "
            "measured %.3f ms replayed (median of %d), ratio %.3f%s; %d ops"
            % (name, ZOO_BATCH, pred_ms, meas_ms, ZOO_REPLAYS, ratio,
               "" if ok else " (outside %gx)" % ZOO_COST_GATE_FACTOR,
               len(ca.op_costs)))
        exe.close()
        del exe, scope
    _free()
    if within < ZOO_MIN_WITHIN:
        raise AssertionError("cost model (18): %d of 11 zoo programs within "
                             "%gx of the measured step, want >= %d: %s" % (
                                 within, ZOO_COST_GATE_FACTOR,
                                 ZOO_MIN_WITHIN,
                                 {k: round(v["ratio"], 3)
                                  for k, v in zoo.items()}))

    full = {}
    for what, phase, build, batch, feed_fn in _full_width_cases(seed):
        main, startup, loss = build()
        ca = CostAnalysis(main, fetch_names=[loss.name])
        pred_ms = ca.predicted_seconds(batch) * 1e3
        done = R.get(phase)
        if done is not None:
            meas_ms, where = done["compiled"]["replay_median_ms"], \
                "phase %s" % phase
        else:
            scope = fluid.Scope()
            exe = fluid.Executor(fluid.CUDAPlace(0))
            exe.run(startup, scope=scope)
            meas_ms = _replayed_median_ms(exe, main, loss, feed_fn(), scope,
                                          FULL_REPLAYS)
            where = "measured here"
            exe.close()
            del exe, scope
            _free()
        top = ca.by_op_type(batch)[:3]
        full[what] = dict(predicted_ms=pred_ms, measured_ms=meas_ms,
                          ratio=pred_ms / meas_ms, batch=batch,
                          predicted_mfu=ca.predicted_mfu(batch),
                          program_peak=ca.program_peak(),
                          flops=ca.flops(batch), bytes=ca.bytes_moved(batch),
                          ops=len(ca.op_costs), source=where,
                          top=[(r["op_type"], r["count"], r["seconds"] * 1e3)
                               for r in top])
        log("cost model (18): %s at batch %d: predicted %.3f ms (MFU %.1f%% "
            "of %.4g FLOP/s; %.4g FLOP, %.4g B, %d ops; most: %s), measured "
            "%.3f ms replayed (%s), ratio %.3f" % (
                what, batch, pred_ms, 100 * ca.predicted_mfu(batch),
                ca.program_peak(), ca.flops(batch), ca.bytes_moved(batch),
                len(ca.op_costs), ", ".join("%s x%d %.3f ms" % t
                                            for t in full[what]["top"]),
                meas_ms, where, pred_ms / meas_ms))
    secs = time.perf_counter() - t0
    log("cost model (18): %d of 11 zoo programs within %gx; %.1f s" % (
        within, ZOO_COST_GATE_FACTOR, secs))
    return dict(device=model, zoo=zoo, zoo_within=within, full_width=full,
                seconds=secs)


# -------------------------------------------------------------- phase 18b
AUTOTUNE_WINDOWS = "1,2,4,8"


class _Env:
    """Environment variables set inside a ``with`` block, restored
    after."""

    def __init__(self, **kw):
        self.kw = kw

    def __enter__(self):
        self.saved = {k: os.environ.get(k) for k in self.kw}
        os.environ.update(self.kw)

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        return False


def _log_search(what, report):
    """One line per axis of an ``autotune_program`` report."""
    for axis in report["axes"]:
        if axis["axis"] == "quantize":
            log("autotune (18b) %s: quantize outlook %s" % (
                what, axis["outlook"]))
            continue
        dec = axis["decision"]
        parts = []
        for t in dec["timings"]:
            if t.get("pruned"):
                parts.append("%s pruned (predicted %.3f ms)" % (
                    t["label"], t["predicted_seconds"] * 1e3))
            else:
                parts.append("%s %.3f ms" % (t["label"],
                                             t["seconds"] * 1e3))
        for p in dec.get("pruned", ()):
            parts.append("%s pruned (predicted %.3f ms)" % (
                p["label"], p["predicted_seconds"] * 1e3))
        log("autotune (18b) %s: %s%s: %s -> %s %s" % (
            what, axis["axis"],
            " %s %s" % (axis.get("op"), axis.get("sig")) if axis["axis"]
            == "kernel" else "", "; ".join(parts), dec["choice"],
            dec["cfg"]))


def phase_autotune(seed):
    """Phase 18b: the unified autotuner on BERT-base training at full
    width (phase 6's program: batch 8, S = 512, Adam, level 2), window
    candidates 1, 2, 4, 8: once with the cost model off (measures every
    candidate), once with it on (prunes by the roofline); each search's
    timings, what was pruned with the prediction that pruned it, the
    winners, whether the pruned search kept the exhaustive winner, and
    the kernel axis's launches (K1 against the composed attention at
    (512, 512)). Then the steps a ``train_loop`` takes at the tuned
    window (``resolve_steps_per_call``), losses and params bitwise the
    same steps run one at a time, its launches counted."""
    from paddle_tpu_torch.core import window_tune as wt
    from paddle_tpu_torch.kernels import autotune as at
    from paddle_tpu_torch.kernels import tune

    t0 = time.perf_counter()
    (exe, scope, main, loss, params, grads, batches,
     tier) = _train_setup("Adam", seed)
    feed = batches[0]
    snap = _snapshot(scope)
    orig_kernel = at.autotune_kernel
    searches = {}
    for what, cost in (("exhaustive", "0"), ("pruned", "1")):
        tune.reset()
        with _Env(PADDLE_TPU_WINDOW_CANDIDATES=AUTOTUNE_WINDOWS,
                  PADDLE_TPU_COST_MODEL=cost), LaunchMeter() as meter:
            def marked(*a, **kw):
                meter.mark()
                out = orig_kernel(*a, **kw)
                meter.mark()
                return out

            # the kernel axis's launches: the meter's units between the
            # marks around autotune_kernel
            at.autotune_kernel = marked
            try:
                meter.mark()
                s0 = time.perf_counter()
                report = at.autotune_program(exe, main, feed, [loss], scope,
                                             persist=False)
                secs = time.perf_counter() - s0
            finally:
                at.autotune_kernel = orig_kernel
        _log_search(what, report)
        window = next(a["decision"] for a in report["axes"]
                      if a["axis"] == "window")
        kernel = [a for a in report["axes"] if a["axis"] == "kernel"]
        searches[what] = dict(
            report=report, seconds=secs,
            window_pick=window["cfg"][0] if window["cfg"] else 1,
            kernel_picks={str(a["sig"]): a["decision"]["choice"]
                          for a in kernel},
            kernel_launches=dict(zip(COUNT_NAMES, (
                int(v) for v in meter.units[1]))),
            measured=[t["label"] for t in window["timings"]
                      if not t.get("pruned")])
        log("autotune (18b) %s: %.1f s, window K = %d measured %s; kernel "
            "axis launches %s" % (
                what, secs, searches[what]["window_pick"],
                searches[what]["measured"],
                {k: v for k, v in searches[what]["kernel_launches"].items()
                 if v}))
    kept = searches["pruned"]["window_pick"] == \
        searches["exhaustive"]["window_pick"]
    launches = searches["pruned"]["kernel_launches"]
    if launches["flash fwd"] < 1 or searches["pruned"]["kernel_picks"] \
            .keys() != {str([SEQ, SEQ])}:
        raise AssertionError("autotune (18b): the kernel axis at %s ran %s"
                             % (searches["pruned"]["kernel_picks"], launches))
    if not set(searches["pruned"]["measured"]) < set(
            searches["exhaustive"]["measured"]):
        raise AssertionError("autotune (18b): the pruned search measured %s, "
                             "the exhaustive one %s" % (
                                 searches["pruned"]["measured"],
                                 searches["exhaustive"]["measured"]))
    log("autotune (18b): the pruned search %s the exhaustive winner (K = %d "
        "against %d); attention picks %s / %s" % (
            "kept" if kept else "did not keep",
            searches["pruned"]["window_pick"],
            searches["exhaustive"]["window_pick"],
            searches["pruned"]["kernel_picks"],
            searches["exhaustive"]["kernel_picks"]))

    # the tuned window at work: the winner of the pruned search stays in
    # the tuner's table, and resolve_steps_per_call reads it
    k, source = wt.resolve_steps_per_call(main, feed)
    if (k, source) != (searches["pruned"]["window_pick"], "tuned"):
        raise AssertionError("autotune (18b): resolve_steps_per_call gave "
                             "%d (%s), the tuner picked %d" % (
                                 k, source,
                                 searches["pruned"]["window_pick"]))
    n = max(2 * k, 4)
    n -= n % k
    fetch = [loss]
    one = _restored(snap)
    ref = [float(np.asarray(exe.run(main, feed=b, fetch_list=fetch,
                                    scope=one)[0]).reshape(()))
           for b in _fresh(batches, n)()]
    looped = _restored(snap)
    _zero_counts()
    with LaunchMeter() as meter:
        meter.mark()
        seen = _loop_values(exe, main, fetch, looped, _fresh(batches, n), None)
    torch.cuda.synchronize()
    launches_loop = dict(zip(COUNT_NAMES, (int(v) for v in meter.total())))
    got = {i: float(np.asarray(v[0]).reshape(())) for i, v in seen.items()}
    bad = [i for i, v in got.items() if v != ref[i]] + [
        p for p in params if not torch.equal(looped.find_var(p),
                                             one.find_var(p))]
    if bad or len(got) != n // k:
        raise AssertionError("autotune (18b): train_loop at the tuned K = %d "
                             "against %d single steps: %s differ (%d "
                             "windows)" % (k, n, bad[:5], len(got)))
    tune.reset()
    # the loop runs the tuned attention: the flash kernels where the
    # pruned search picked them, the composed attention (none) otherwise
    flash = searches["pruned"]["kernel_picks"][str([SEQ, SEQ])] == "cuda"
    for c in ("flash fwd", "flash dkv", "flash dq", "K4", "K6"):
        if (launches_loop[c] < n) if (flash or c[0] == "K") else \
                launches_loop[c]:
            raise AssertionError("autotune (18b): the tuned loop ran %s %d "
                                 "times in %d steps (the tuner picked %s)" % (
                                     c, launches_loop[c], n,
                                     searches["pruned"]["kernel_picks"]))
    secs = time.perf_counter() - t0
    log("autotune (18b): train_loop at the tuned K = %d over %d steps: "
        "losses %s bitwise the single steps', params bitwise; launches %s; "
        "%.1f s" % (k, n, ["%.4f" % v for v in ref], {
            c: v for c, v in launches_loop.items() if v}, secs))
    exe.close()
    return dict(searches={w: {x: v for x, v in s.items() if x != "report"}
                          for w, s in searches.items()},
                timings={w: [a for a in s["report"]["axes"]]
                         for w, s in searches.items()},
                kept_exhaustive_winner=kept, tuned_k=k, loop_steps=n,
                losses=ref, launches=launches_loop,
                tune_launches=searches["pruned"]["kernel_launches"],
                seconds=secs)


# -------------------------------------------------------------- phase 18c
JIT_TUNE_WINDOWS = "1,2"  # the capture's window search, kept short


def phase_jit_autotune(seed):
    """Phase 18c: ``imperative.jit(autotune=True)`` on phase 15's dygraph
    encoder at BERT-base width (level 2, the CUDA graph): the first call
    captures, the unified autotuner tunes the capture in a scratch scope
    (window 1 or 2, flash against composed at (512, 512)), and the
    replays are bitwise an untuned capture's from the same state:
    losses, params and the generator chain (the flash threshold pinned
    for both, so the tuner's pick moves no dispatch)."""
    from paddle_tpu_torch.kernels import tune

    t0 = time.perf_counter()
    batches = _dygraph_batches(bert_cfg(), seed)
    with _Env(PADDLE_TPU_WINDOW_CANDIDATES=JIT_TUNE_WINDOWS,
              PADDLE_TPU_FLASH_MIN_SEQ="256"):
        tune.reset()
        tuned = _dygraph_run(seed, batches, False, autotune=True,
                             extras=False)
        picks = tune.export_entries()
        _free()
        untuned = _dygraph_run(seed, batches, False, extras=False)
        tune.reset()
    same = (tuned["losses"] == untuned["losses"]
            and all(torch.equal(tuned["params"][n], untuned["params"][n])
                    for n in tuned["params"])
            and torch.equal(tuned["chain"], untuned["chain"]))
    if not same:
        raise AssertionError("jit autotune (18c): the tuned replays differ "
                             "from the untuned ones: losses %s / %s" % (
                                 tuned["losses"], untuned["losses"]))
    if "attention|%d,%d" % (SEQ, SEQ) not in picks or \
            not any(k.startswith("train_window|") for k in picks):
        raise AssertionError("jit autotune (18c): the tuner left %s" % picks)
    launches = dict(zip(COUNT_NAMES, (int(v) for v in np.sum(
        tuned["units"], axis=0))))
    secs = time.perf_counter() - t0
    log("jit autotune (18c): captured, tuned (%s), replayed: losses %s "
        "bitwise the untuned capture's, params and chain bitwise; step ms "
        "%s tuned, %s untuned; launches %s; %.1f s" % (
            {k: (v["choice"], v["cfg"]) for k, v in picks.items()},
            ["%.4f" % v for v in tuned["losses"]],
            ["%.1f" % v for v in tuned["step_ms"]],
            ["%.1f" % v for v in untuned["step_ms"]],
            {k: v for k, v in launches.items() if v}, secs))
    return dict(picks=picks, losses=tuned["losses"],
                step_ms=dict(tuned=tuned["step_ms"],
                             untuned=untuned["step_ms"]),
                launches=launches, seconds=secs)


# -------------------------------------------------------------- phase 18d
QUANT_SERVE_REPEATS = 5
QAT_STEPS = 5


def _bert_qat_program(transpile):
    """BERT-base MLM with Adam; with ``transpile``, its fake-quant rewrite
    (``QuantizeTranspiler.training_transpile``) before ``minimize``."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import bert

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        loss, _ = bert.build(bert.base_config(), seq_len=SEQ,
                             max_mask=MAX_MASK)
        if transpile:
            fluid.contrib.quantize.QuantizeTranspiler().training_transpile(
                main, startup)
        fluid.optimizer.Adam(learning_rate=TRAIN_LR).minimize(loss)
    return main, startup, loss


def phase_quantize(workdir, seed):
    """Phase 18d: int8. BERT-base (S = 512) saved and served by the
    Predictor with ``PADDLE_TPU_OPTIMIZE_QUANT=1`` at batch 1 and 8: the
    level-2 clone's int8 weights (quantize / dequantize_channel_abs_max)
    within the pass's QUANT_TOLERANCE of the f32 Predictor's answers,
    both latencies in turns beside ``quantize_outlook``'s predicted
    speedup. Then ``QuantizeTranspiler.training_transpile`` on BERT-base
    MLM: 5 replayed steps with every fake-quant op on the card (its
    scale state updated there), the first loss within QUANT_TOLERANCE of
    the untransposed program's from the same startup and RNG chain, the
    replays bitwise eager steps."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core.executor import _HostView
    from paddle_tpu_torch.core.passes import optimize_program
    from paddle_tpu_torch.core.passes.quantize_pass import QUANT_TOLERANCE
    from paddle_tpu_torch.kernels.autotune import quantize_outlook
    from paddle_tpu_torch.models import bert

    t0 = time.perf_counter()
    cfg = bert.base_config()
    feeds = ["src_ids", "sent_ids", "input_mask"]
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        bert.build(cfg, seq_len=SEQ, is_test=True)
    enc = _encoder_output(main)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(startup)
        fluid.io.save_inference_model(workdir, feeds, [enc], exe,
                                      main_program=main)
    del scope, exe
    _free()
    rs = np.random.RandomState(seed + 18)
    reqs = {b: _request(b, cfg, rs) for b in (1, 8)}
    quant = _Env(PADDLE_TPU_OPTIMIZE_QUANT="1")

    def predictor():
        config = fluid.inference.AnalysisConfig(workdir)
        config.warmup_batch_sizes = [1, 8]
        return fluid.inference.create_paddle_predictor(config)

    p32 = predictor()
    with quant:
        pq = predictor()
        opt, _ = optimize_program(pq.program, fetch_list=pq.fetch_names,
                                  scope=_HostView(pq.scope), level=2)
        n_q = [op.type for op in opt.global_block().ops].count(
            "quantize_channel_abs_max")
        outlook = quantize_outlook(pq.program, reqs[8], pq.fetch_names)
    if n_q < 6 * cfg["n_layer"]:  # q, k, v, out and two FFN a layer
        raise AssertionError("quantize (18d): the level-2 clone quantized "
                             "%d weights" % n_q)
    serve = {}
    for b, req in reqs.items():
        want = p32.run(req)[0]
        with quant:
            got = pq.run(req)[0]
        err = float(np.abs(got - want).max())
        if not np.allclose(got, want, **QUANT_TOLERANCE) or \
                got.tobytes() == want.tobytes():
            raise AssertionError("quantize (18d): batch %d: int8 answers "
                                 "%.4g from f32's (QUANT_TOLERANCE %s)" % (
                                     b, err, QUANT_TOLERANCE))
        lat = ([], [])
        for i in range(QUANT_SERVE_REPEATS):
            for j in ((0, 1) if i % 2 == 0 else (1, 0)):
                if j:
                    with quant:
                        lat[1].append(_synced_ms(lambda: pq.run(req)))
                else:
                    lat[0].append(_synced_ms(lambda: p32.run(req)))
        serve[b] = dict(max_abs_err=err, f32_ms=lat[0], int8_ms=lat[1],
                        f32_median_ms=float(np.median(lat[0])),
                        int8_median_ms=float(np.median(lat[1])))
        log("quantize (18d): BERT-base served at batch %d: int8 within %.4g "
            "of f32 (QUANT_TOLERANCE rtol / atol 0.05); median %.3f ms int8, "
            "%.3f ms f32 in turns (%d each)" % (
                b, err, serve[b]["int8_median_ms"], serve[b]["f32_median_ms"],
                QUANT_SERVE_REPEATS))
    log("quantize (18d): %d weights int8 in the level-2 clone; "
        "quantize_outlook at batch 8: %d eligible, predicted %.3f ms -> %.3f "
        "ms, speedup %.3f, recommended %s" % (
            n_q, outlook["weights"], outlook["predicted_seconds"] * 1e3,
            outlook["predicted_seconds_quantized"] * 1e3,
            outlook["predicted_speedup"], outlook["recommended"]))
    del p32, pq
    _free()

    # quantization-aware training: the transposed program from the plain
    # one's startup and chain
    exe = fluid.Executor(fluid.CUDAPlace(0))
    progs = {}
    for name, tr in (("plain", False), ("qat", True)):
        m, s, lo = _bert_qat_program(tr)
        m.random_seed = s.random_seed = seed
        progs[name] = (m, s, lo)
    plain_scope = fluid.Scope()
    exe.run(progs["plain"][1], scope=plain_scope)
    base = _snapshot(plain_scope)
    qscope = fluid.Scope()
    exe.run(progs["qat"][1], scope=qscope)
    for n, v in base.items():
        qscope.set_var(n, _copied(v))
    snap = _snapshot(qscope)
    types = [op.type for op in progs["qat"][0].global_block().ops]
    fq = {t: types.count(t) for t in set(types)
          if t.startswith("fake_quantize")}
    rs = np.random.RandomState(seed + 19)
    batches = [_train_batch(cfg, rs) for _ in range(QAT_STEPS)]
    m, _, lo = progs["plain"]
    loss_of = lambda vals: float(np.asarray(vals[0]).reshape(()))  # noqa
    plain_first = loss_of(exe.run(m, feed=batches[0], fetch_list=[lo],
                                  scope=_restored(base)))
    m, _, lo = progs["qat"]
    written = {n for op in m.global_block().ops
               if op.type.startswith("fake_quantize")
               for names in op.outputs.values() for n in names}
    state = sorted(v.name for v in m.list_vars()
                   if v.persistable and v.name in written)
    replayed, eager = _restored(snap), _restored(snap)
    _zero_counts()
    with LaunchMeter() as meter:
        meter.mark()
        lq = [loss_of(exe.run(m, feed=b, fetch_list=[lo], scope=replayed))
              for b in batches]
    launches = dict(zip(COUNT_NAMES, (int(v) for v in meter.total())))
    le = [loss_of(exe._run_eager(m, feed=b, fetch_list=[lo], scope=eager))
          for b in batches]
    params = [p.name for p in m.global_block().all_parameters()]
    differ = [n for n in params + state
              if not torch.equal(replayed.find_var(n), eager.find_var(n))]
    moved = [n for n in state if replayed.find_var(n).is_cuda and
             not torch.equal(replayed.find_var(n).cpu(),
                             snap[n].cpu())]
    if lq != le or differ:
        raise AssertionError("quantize (18d): QAT replays differ from eager "
                             "steps: losses %s / %s, vars %s" % (
                                 lq, le, differ[:5]))
    if not np.allclose(lq[0], plain_first, **QUANT_TOLERANCE):
        raise AssertionError("quantize (18d): QAT first loss %.5f, the plain "
                             "program's %.5f" % (lq[0], plain_first))
    if not state or len(moved) != len(state) or \
            launches["flash fwd"] < QAT_STEPS * 24:
        raise AssertionError("quantize (18d): fake-quant state on the card "
                             "%d of %d moved; launches %s" % (
                                 len(moved), len(state), launches))
    secs = time.perf_counter() - t0
    log("quantize (18d): QuantizeTranspiler on BERT-base MLM: %s fake-quant "
        "ops, %d scale / state vars on the card, all updated by the steps; "
        "%d steps (eager, capture, replays) bitwise eager: losses %s; first "
        "loss %.5f against the plain program's %.5f; launches %s; %.1f s" % (
            fq, len(state), QAT_STEPS, ["%.4f" % v for v in lq], lq[0],
            plain_first, {k: v for k, v in launches.items() if v}, secs))
    exe.close()
    return dict(serve=serve, quantized_weights=n_q, outlook=outlook,
                qat=dict(fake_quant_ops=fq, state_vars=len(state),
                         losses=lq, plain_first_loss=plain_first),
                launches=launches, seconds=secs)


# -------------------------------------------------------------- phase 18e
def _misc_quant_cases(rs):
    """(op, inputs as numpy, attrs, differentiable input slots, tolerance)
    for the misc and quantization ops of this slice, shaped like
    tests/test_torch_ops.py's cases; the random ones are checked apart
    (``_misc_quant_random``)."""
    f = lambda *s: rs.randn(*s).astype("float32")  # noqa: E731
    i32 = lambda hi, *s: rs.randint(0, hi, s).astype("int32")  # noqa
    T, P = OP_TAIL_TOL, OP_TAIL_PRODUCT_TOL
    x5 = f(2, 3, 5, 6, 4)
    grid = (rs.rand(2, 3, 6, 2) * 2.4 - 1.2).astype("float32")
    edges = np.array([[[1, 2], [1, 3], [2, 4], [0, 0]],
                      [[0, 1], [0, 2], [0, 3], [3, 4]]], "int32")
    rois = np.array([[0.5, 1.0, 5.0, 4.5], [2.0, 0.0, 6.5, 5.5]], "float32")
    quads = np.array([[1, 1, 6, 1.5, 6.5, 6, 0.5, 5.5],
                      [2, 3, 4, 2, 5, 5, 2.5, 6]], "float32")
    return [
        ("selu", {"X": [f(3, 5)]}, {}, ["X"], T),
        ("multiplex", {"X": [f(4, 3), f(4, 3)],
                       "Ids": [np.array([[1], [0], [1], [1]], "int32")]},
         {}, ["X"], T),
        ("space_to_depth", {"X": [f(2, 3, 4, 6)]}, {"blocksize": 2}, ["X"],
         T),
        ("shuffle_channel", {"X": [f(2, 6, 3, 2)]}, {"group": 3}, ["X"], T),
        ("pad_constant_like", {"X": [f(4, 5)], "Y": [f(2, 3)]},
         {"pad_value": 0.5}, ["Y"], T),
        ("dice_loss_op", {"X": [np.abs(f(4, 5, 3))],
                          "Label": [i32(3, 4, 5, 1)]}, {}, ["X"], T),
        ("mean_iou", {"Predictions": [i32(5, 6, 7)],
                      "Labels": [i32(5, 6, 7)]}, {"num_classes": 6}, [], T),
        ("add_position_encoding", {"X": [f(2, 7, 8)]},
         {"alpha": 0.5, "beta": 2.0}, ["X"], T),
        ("bilinear_tensor_product", {"X": [f(3, 4)], "Y": [f(3, 5)],
                                     "Weight": [f(6, 4, 5)],
                                     "Bias": [f(1, 6)]}, {},
         ["X", "Y", "Weight", "Bias"], P),
        ("teacher_student_sigmoid_loss",
         {"X": [f(4, 1)], "Label": [np.array([[-2.0], [-1.0], [0.3], [1.6]],
                                             "float32")]}, {}, ["X"], T),
        ("npair_loss_op", {"Anchor": [f(5, 4)], "Positive": [f(5, 4)],
                           "Labels": [np.array([1, 2, 1, 3, 2], "int32")]},
         {}, ["Anchor", "Positive"], P),
        ("increment_counter", {"X": [np.array([5], "int32")]}, {"step": 3},
         [], T),
        ("pool3d", {"X": [x5]}, {"pooling_type": "avg", "ksize": [3, 3, 3],
                                 "strides": [1, 1, 1],
                                 "paddings": [1, 1, 1]}, ["X"], T),
        ("adaptive_pool3d", {"X": [f(2, 2, 4, 4, 6)]},
         {"ksize": [2, 2, 3], "pooling_type": "max"}, ["X"], T),
        ("conv3d_transpose", {"Input": [f(2, 3, 3, 4, 3)],
                              "Filter": [f(3, 2, 2, 3, 2)]},
         {"strides": [2, 1, 1], "paddings": [0, 1, 0]},
         ["Input", "Filter"], P),
        ("ctc_greedy_decoder", {"Input": [rs.rand(3, 7, 4).astype(
            "float32")], "Length": [np.array([7, 4, 0], "int32")]},
         {"blank": 0}, [], T),
        ("spectral_norm", {"Weight": [f(4, 3, 2)], "U": [f(4)]},
         {"dim": 0, "power_iters": 2}, ["Weight"], P),
        ("affine_grid", {"Theta": [f(2, 2, 3)]},
         {"output_shape": [2, 3, 4, 5]}, ["Theta"], T),
        ("grid_sampler", {"X": [f(2, 3, 5, 4)], "Grid": [grid]}, {},
         ["X", "Grid"], T),
        ("sequence_scatter", {"X": [f(2, 6)], "Ids": [np.array(
            [[0, 2, 2, 5], [1, 1, 3, 1]], "int32")], "Updates": [f(2, 4)],
            "Length": [np.array([3, 4], "int32")]}, {}, ["X", "Updates"], T),
        ("data_norm", {"X": [f(4, 3)], "BatchSize": [np.full(
            (3,), 10.0, "float32")], "BatchSum": [f(3)],
            "BatchSquareSum": [np.abs(f(3)) * 20 + 10]}, {}, ["X"], T),
        ("hash_op", {"X": [rs.randint(-2 ** 31, 2 ** 31 - 1, (5, 4))
                           .astype("int32")]},
         {"num_hash": 2, "mod_by": 100000}, [], T),
        ("psroi_pool", {"X": [f(2, 2 * 2 * 3, 6, 7)], "ROIs": [rois],
                        "RoisBatch": [np.array([1, 0], "int32")]},
         {"pooled_height": 2, "pooled_width": 3, "output_channels": 2,
          "spatial_scale": 0.9}, ["X"], T),
        ("take_along_axis1", {"X": [f(2, 5, 3)], "Index": [np.array(
            [[0, 4, 4, -1], [2, 1, 0, 3]], "int32")]}, {}, [], T),
        ("similarity_focus", {"X": [f(2, 3, 4, 5)]},
         {"axis": 1, "indexes": [0, 2]}, [], T),
        ("roi_perspective_transform", {"X": [f(2, 3, 8, 9)],
                                       "ROIs": [quads],
                                       "RoisBatch": [np.array(
                                           [0, 1], "int32")]},
         {"transformed_height": 3, "transformed_width": 4}, [], P),
        ("generate_mask_labels", {
            "Rois": [np.array([[[0, 0, 8, 8], [2, 2, 6, 7]],
                               [[4, 4, 9, 9], [0, 5, 4, 9]]], "float32")],
            "LabelsInt32": [np.array([[1, 0], [3, 1]], "int32")],
            "GtBoxes": [np.array([[[0, 0, 7, 7], [2, 2, 6, 8]],
                                  [[5, 5, 9, 9], [0, 0, 0, 0]]], "float32")],
            "GtSegms": [(rs.rand(2, 2, 10, 10) > 0.5).astype("float32")]},
         {"resolution": 4}, [], T),
        ("tree_conv", {"NodesVector": [f(2, 5, 3)], "EdgeSet": [edges],
                       "Filter": [f(3, 3, 2, 4)]}, {},
         ["NodesVector", "Filter"], P),
        ("fake_quantize_abs_max", {"X": [f(4, 6)]}, {"bit_length": 8},
         ["X"], T),
        ("fake_quantize_moving_average_abs_max",
         {"X": [f(3, 5)], "InScale": [np.array([1.2], "float32")],
          "InAccum": [np.array([2.0], "float32")],
          "InState": [np.array([1.5], "float32")]},
         {"moving_rate": 0.8}, ["X"], T),
        ("fake_quantize_range_abs_max",
         {"X": [f(3, 5)], "InScale": [np.array([0.5], "float32")]}, {},
         ["X"], T),
        ("fake_dequantize_max_abs", {"X": [np.round(f(3, 4) * 40)],
                                     "Scale": [np.array([2.5], "float32")]},
         {"max_range": 127.0}, ["X"], T),
        ("quantize_channel_abs_max", {"X": [f(4, 6)],
                                      "InScale": [np.abs(f(6)) + 0.5]},
         {"axis": 1}, [], T),
        ("dequantize_channel_abs_max", {
            "X": [rs.randint(-127, 128, (4, 6)).astype("int8")],
            "Scales": [np.abs(f(4)) + 0.5]}, {"axis": 0}, [], T),
    ]


def _misc_quant_random(dev):
    """The random ops on the card: twice from one chain seed bitwise,
    another seed another draw, and their properties: the batch-size-like
    gaussian's shape and moments, random_crop's window of the input,
    sampled softmax's loss bounds."""
    chain = lambda s: torch.Generator().manual_seed(s)  # noqa: E731
    x = np.arange(2 * 3 * 9 * 8, dtype="float32").reshape(2, 3, 9, 8)
    draws = {
        "gaussian_random_batch_size_like": (
            {"Input": [np.zeros((3, 700), "float32")]},
            {"shape": [-1, 40], "input_dim_idx": 1, "mean": 0.5,
             "std": 2.0}, "Out"),
        "random_crop": ({"X": [x]}, {"shape": [4, 5]}, "Out"),
        "sampled_softmax_with_cross_entropy": (
            {"Logits": [np.zeros((64, 50), "float32")],
             "Label": [np.random.RandomState(2).randint(
                 0, 50, (64, 1)).astype("int32")]},
            {"num_samples": 10}, "Loss"),
    }
    out = {}
    for op, (ins, attrs, slot) in draws.items():
        a, b, c = (_op_on(dev, op, ins, attrs, chain(s))[slot][0].cpu()
                   for s in (3, 3, 4))
        if not torch.equal(a, b) or torch.equal(a, c):
            raise AssertionError("misc ops (18e): %s's draws on the card: "
                                 "seed 3 twice %s, seed 4 the same %s" % (
                                     op, torch.equal(a, b),
                                     torch.equal(a, c)))
        out[op] = a
    g = out["gaussian_random_batch_size_like"]
    if tuple(g.shape) != (700, 40) or abs(float(g.mean()) - 0.5) > 0.05 \
            or abs(float(g.std()) - 2.0) > 0.05:
        raise AssertionError("misc ops (18e): gaussian_random_batch_size_"
                             "like on the card: %s, mean %s, std %s" % (
                                 tuple(g.shape), g.mean(), g.std()))
    crop = out["random_crop"].numpy()
    h0, w0 = divmod(int(crop[0, 0, 0, 0]), 8)
    if crop.shape != (2, 3, 4, 5) or not (crop == x[:, :, h0:h0 + 4,
                                                     w0:w0 + 5]).all():
        raise AssertionError("misc ops (18e): random_crop on the card")
    loss = out["sampled_softmax_with_cross_entropy"]
    if tuple(loss.shape) != (64, 1) or loss.min() < -1e-6 or \
            loss.max() > np.log1p(50.0) + 1e-5:
        raise AssertionError("misc ops (18e): sampled softmax on the card: "
                             "%s in [%s, %s]" % (tuple(loss.shape),
                                                 loss.min(), loss.max()))
    return sorted(draws)


def phase_misc_ops(seed):
    """Phase 18e: the 37 op types of this slice (misc_ops' other 31, the
    six quantization ops) on the card against their CPU lowerings,
    forward and the grads of the differentiable ones, within 1e-5 (1e-4
    for products); the random ones twice bitwise from one seed and by
    their properties."""
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    rs = np.random.RandomState(seed)
    done, bad = _ops_against_cpu(_misc_quant_cases(rs), rs, dev)
    done.update(_misc_quant_random(dev))
    if bad:
        raise AssertionError("misc ops (18e): the card differs from the CPU: "
                             "%s" % bad)
    if len(done) != 37:
        raise AssertionError("misc ops (18e): %d op types checked, not 37"
                             % len(done))
    secs = time.perf_counter() - t0
    log("misc ops (18e): %d op types on the card against the CPU (forward, "
        "and the grads of the differentiable ones), the random ones twice "
        "bitwise from one seed and by their properties; %.1f s" % (
            len(done), secs))
    return dict(op_types=sorted(done), seconds=secs)


# --------------------------------------------------------------- phase 19
SSD_BATCH = 8
SSD_STEPS = 6          # the main path: eager, capture, 4 replays
SSD_SERVE_BUCKETS = (1, 8)
SSD_SERVE_REPEATS = 10
SSD_CPU_TOL = 1e-4     # the first loss against the CPU's, relative
# the detections against the CPU's: classes exactly, scores and boxes
# within SSD_DET_TOL; rows whose scores lie within SSD_SWAP_TOL of each
# other may change places (the card's convolutions round apart from the
# CPU's in the last places, and the rows sort by score)
SSD_DET_TOL, SSD_SWAP_TOL = 1e-4, 1e-5
# phase 19b: the 19 ops on the card against the CPU: exp / log / sums
# within 1e-5 plus a relative 1e-5; the rest (the prior tables, built
# on the host, gathers, IoU, NMS, the matchings) exactly
DET_OP_TOL = 1e-5


def _ssd_programs():
    """tools/ssd_programs.py: SSD300 (numpy and the port's layers)."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tools"))
    import ssd_programs

    return ssd_programs


def _uncaptured_total():
    from paddle_tpu_torch.core.executor import UNCAPTURED_PLANS

    return sum(c.value for c in UNCAPTURED_PLANS._children.values())


def _det_groups(scores):
    """[(start, end)] runs of consecutive rows whose scores lie within
    SSD_SWAP_TOL of their neighbour's."""
    out, start = [], 0
    for i in range(1, len(scores) + 1):
        if i == len(scores) or abs(scores[i] - scores[i - 1]) > SSD_SWAP_TOL:
            out.append((start, i))
            start = i
    return out


def _det_rows(card, cpu, used, b, s, e):
    """Match each card row of ``card`` to an unused CPU row of ``cpu``
    (rows s to e of image b) of its class, its score and box within
    SSD_DET_TOL, the CPU's row at its own place first; returns (the
    largest difference, the rows that changed places); a card row with
    no match raises."""
    worst, moved = 0.0, 0
    for i, row in enumerate(card):
        diff = np.abs(cpu - row).max(1)
        diff[(cpu[:, 0] != row[0]) | used] = np.inf
        k = i if i < len(diff) and diff[i] <= SSD_DET_TOL else int(
            diff.argmin())
        if diff[k] > SSD_DET_TOL:
            raise AssertionError(
                "image %d row %d: no CPU row of rows %d-%d within %.0e: "
                "card %s, CPU %s" % (b, s + i, s, e, SSD_DET_TOL, row,
                                     cpu[:8]))
        moved += int(k != i)
        used[k] = True
        worst = max(worst, float(diff[k]))
    return worst, moved


def _det_against_cpu(card, cpu, flipped):
    """Card detections [B, K, 6] against the CPU's, ``cpu`` [B, K', 6]
    with K' >= K: the CPU's ``multiclass_nms`` rows past the K it keeps
    (the same stable order, so its first K rows are the CPU's answer).
    In an image whose NMS made the CPU's decisions (none in ``flipped``,
    image -> {class: score} of the lanes that decided otherwise at a
    candidate of that score, ``_nms_flips``):
    within each run of rows whose CPU scores lie within SSD_SWAP_TOL,
    each card row matches a CPU row of its run of the same class, its
    score and box within SSD_DET_TOL (the CPU's row at its own place if
    that one matches); a run that reaches the last row runs on through
    the CPU's rows past it, so a card row there may match one the CPU
    dropped. In an image with a flipped lane, each card row matches a CPU
    row of its class anywhere (a flipped lane's rows move the rest) but
    a flipped lane's rows from the departing candidate's score down
    (within SSD_SWAP_TOL) and -1 rows, which are counted. Returns
    (the largest difference, the rows that changed places, the rows in
    a run that reaches the last row, the rows of flipped lanes); a
    mismatch raises."""
    worst, moved, tail, loose = 0.0, 0, 0, 0
    K = card.shape[1]
    for b in range(cpu.shape[0]):
        if flipped.get(b):
            out = card[b, :, 0] < 0
            for c, top in flipped[b].items():
                out |= (card[b, :, 0] == c) & (
                    card[b, :, 1] <= top + SSD_SWAP_TOL)
            w, _ = _det_rows(card[b][~out], cpu[b], np.zeros(len(cpu[b]),
                                                              bool),
                             b, 0, cpu.shape[1])
            worst, loose = max(worst, w), loose + int(out.sum())
            continue
        for s, e in _det_groups(cpu[b, :, 1]):
            if s >= K:
                break
            g = card[b, s:min(e, K)]
            tail += len(g) if e > K else 0
            w, m = _det_rows(g, cpu[b, s:e], np.zeros(e - s, bool), b, s, e)
            worst, moved = max(worst, w), moved + m
    return worst, moved, tail, loose


def _nms_lanes(bboxes, scores, attrs):
    """``multiclass_nms``' lanes on the CPU, by the lowering's own steps
    (``_top_k``, ``_greedy_nms``): per (image, class) the nms_top_k
    candidates in score order (``idx``), their scores (``score``, -1
    under score_threshold), the keep decisions (``keep``), and each
    one's largest IoU with a box kept before it (``iou``), [B, C, K]
    numpy each."""
    from paddle_tpu_torch.ops.detection_ops import (_greedy_nms,
                                                    _pairwise_iou_xyxy,
                                                    _top_k)

    boxes, s = torch.from_numpy(bboxes), torch.from_numpy(scores)
    B, C, M = s.shape
    K = min(int(attrs["nms_top_k"]), M)
    s = torch.where(s >= float(attrs["score_threshold"]), s, -1.0)
    top_s, top_i = _top_k(s, K)
    cand = boxes[torch.arange(B)[:, None, None], top_i]
    cls = torch.arange(C)[None, :, None]
    valid = (top_s > -1.0) & (cls != int(attrs.get("background_label",
                                                   -1)))
    thresh = float(attrs["nms_threshold"])
    keep = _greedy_nms(cand.reshape(B * C, K, 4), valid.reshape(B * C, K),
                       thresh, eta=float(attrs.get("nms_eta", 1.0))
                       ).reshape(B, C, K)
    before = keep[:, :, None, :] & torch.ones(K, K, dtype=torch.bool).tril(
        -1)
    iou = torch.where(before, _pairwise_iou_xyxy(cand, cand), 0.0).amax(-1)
    return dict(idx=top_i.numpy(), score=top_s.numpy(), keep=keep.numpy(),
                iou=iou.numpy())


def _nms_departure(lanes, ins, b, c, attrs):
    """The first candidate of lane (image b, class c), in the CPU's order
    and then the card's others, that one side keeps and the other does
    not, and what rounding turned it: "score" (its score within
    SSD_DET_TOL of score_threshold), "cut" (in one side's nms_top_k only,
    its score within SSD_SWAP_TOL of the other side's last one), "iou"
    (its largest IoU with a box kept before it on the two sides of
    nms_threshold, within SSD_DET_TOL on the two inputs) or "order" (a
    box kept on a side, ordered before it on one side only, its scores
    within SSD_SWAP_TOL of it on both inputs, their IoU over
    nms_threshold); None where no rounding can."""
    from paddle_tpu_torch.ops.detection_ops import _pairwise_iou_xyxy

    order = [L["idx"][b, c].tolist() for L in lanes]
    pos = [{x: i for i, x in enumerate(o)} for o in order]

    def kept(side, x):
        i = pos[side].get(x)
        return i is not None and bool(lanes[side]["keep"][b, c, i])

    x = next(x for x in order[1] + order[0]
             if kept(0, x) != kept(1, x))
    sc = [ins[k][1][b, c] for k in (0, 1)]
    thr = float(attrs["nms_threshold"])
    if any(abs(v[x] - float(attrs["score_threshold"])) <= SSD_DET_TOL
           for v in sc):
        return x, "score"
    if any(x not in p for p in pos):
        return x, "cut" if all(abs(v[x] - v[o[-1]]) <= SSD_SWAP_TOL
                               for v, o in zip(sc, order)) else None
    m = [float(L["iou"][b, c, p[x]]) for L, p in zip(lanes, pos)]
    if (m[0] - thr) * (m[1] - thr) <= 0 and abs(m[0] - m[1]) <= SSD_DET_TOL:
        return x, "iou"
    for y in set(order[0]) & set(order[1]):
        if (pos[0][y] < pos[0][x]) != (pos[1][y] < pos[1][x]) and \
                (kept(0, y) or kept(1, y)) and \
                all(abs(v[x] - v[y]) <= SSD_SWAP_TOL for v in sc) and \
                any(float(_pairwise_iou_xyxy(
                    torch.from_numpy(ins[k][0][b, [x]]),
                    torch.from_numpy(ins[k][0][b, [y]]))) > thr
                    for k in (0, 1)):
            return x, "order"
    return x, None


def _nms_flips(card_in, cpu_in, attrs):
    """Where the card's NMS inputs, within SSD_DET_TOL of the CPU's,
    lead ``multiclass_nms`` to keep other boxes: per image, the classes
    whose lane keeps another set of candidates, each explained at its
    first departure by a decision that rounding can turn
    (``_nms_departure``; the later ones follow from it); any other
    departure raises. A lane that keeps the same candidates in another
    order is no departure (its rows may change places). Returns
    ({image: {class: the departing candidate's higher score}}, [(image,
    class, candidate, kind, that score)])."""
    if float(attrs.get("nms_eta", 1.0)) != 1.0:
        raise AssertionError("_nms_flips reads a fixed nms_threshold")
    ins = (card_in, cpu_in)
    lanes = [_nms_lanes(*v, attrs) for v in ins]
    flipped, kinds = {}, []
    B, C, _ = lanes[0]["idx"].shape
    for b in range(B):
        for c in range(C):
            sets = [set(L["idx"][b, c][L["keep"][b, c]].tolist())
                    for L in lanes]
            if sets[0] == sets[1]:
                continue
            x, kind = _nms_departure(lanes, ins, b, c, attrs)
            if kind is None:
                raise AssertionError(
                    "image %d class %d: the card's NMS keeps candidate %d "
                    "%s, the CPU's %s, where rounding cannot turn it "
                    "(scores %s)" % (b, c, x, x in sets[0], x in sets[1],
                                     [v[1][b, c, x] for v in ins]))
            top = max(float(v[1][b, c, x]) for v in ins)
            flipped.setdefault(b, {})[c] = top
            kinds.append((b, c, x, kind, top))
    return flipped, kinds


def _nms_inputs(run, program):
    """``run(extra fetch names)`` -> fetched values, with the inputs of
    ``program``'s one ``multiclass_nms`` op fetched beside its answer:
    (answer, (BBoxes, Scores), the op's attrs)."""
    (op,) = [o for o in program.global_block().ops
             if o.type == "multiclass_nms"]
    got = run(op.input("BBoxes") + op.input("Scores"))
    return got[0], (got[1], got[2]), dict(op.attrs)


def _cpu_detections(fluid, infer, dets, req, params):
    """The CPU's answer to ``req``, with its ``multiclass_nms`` rows past
    keep_top_k: the op's inputs fetched in the same run and its lowering
    run again on them keeping every candidate (``_det_against_cpu``),
    whose first keep_top_k rows must be the program's answer. Returns
    (those rows, the op's inputs, its attrs)."""
    got, ins, attrs = _nms_inputs(
        lambda extra: fluid.Executor(fluid.CPUPlace()).run(
            infer, feed=req, fetch_list=[dets] + extra, scope=params),
        infer)
    every = ins[1].shape[1] * min(int(attrs["nms_top_k"]), ins[1].shape[2])
    wide = _op_on(torch.device("cpu"), "multiclass_nms",
                  {"BBoxes": [ins[0]], "Scores": [ins[1]]},
                  dict(attrs, keep_top_k=every))["Out"][0].numpy()
    if not np.array_equal(wide[:, :got.shape[1]], got):
        raise AssertionError("multiclass_nms keeping every candidate does "
                             "not begin with the program's answer")
    return wide, ins, attrs


def _card_against_cpu(what, pred, req, got, cpu, cpu_in, attrs):
    """The Predictor's detections ``got`` against the CPU's: the card's
    NMS inputs (fetched in an eager run of the Predictor's program that
    gives ``got`` bitwise) within SSD_DET_TOL of the CPU's; ``got``
    bitwise what the CPU's ``multiclass_nms`` lowering makes of them;
    the decisions that differ explained (``_nms_flips``); the rows
    compared (``_det_against_cpu``). Returns a dict of the readings."""
    ans, card_in, _ = _nms_inputs(
        lambda extra: pred._exe._run_eager(
            pred.program, feed=req, fetch_list=pred.fetch_names + extra,
            scope=pred.scope), pred.program)
    if not np.array_equal(ans, got):
        raise AssertionError("%s: fetching the NMS inputs changed the "
                             "answer" % what)
    gap = max(float(np.abs(x - y).max()) for x, y in zip(card_in, cpu_in))
    if gap > SSD_DET_TOL:
        raise AssertionError("%s: the NMS inputs %.3e from the CPU's" % (
            what, gap))
    redo = _op_on(torch.device("cpu"), "multiclass_nms",
                  {"BBoxes": [card_in[0]], "Scores": [card_in[1]]},
                  attrs)["Out"][0].numpy()
    if not np.array_equal(redo, got):
        raise AssertionError("%s: the card's NMS is not the CPU's on the "
                             "card's inputs" % what)
    flipped, kinds = _nms_flips(card_in, cpu_in, attrs)
    worst, moved, tail, loose = _det_against_cpu(got, cpu, flipped)
    return dict(cpu_max_diff=worst, nms_input_diff=gap, rows_moved=moved,
                tail_rows=tail, flipped_lanes=kinds, flipped_rows=loose)


def _ssd_build(fluid, sp, batch, train, seed):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        out, priors = sp.build(fluid, batch, train=train)
    return main, startup, out, priors


def _ssd_serve(fluid, sp, workdir, seed, trained):
    """Phase 19's serving: per bucket an inference program saved with
    ``io.save_inference_model`` from the trained weights, a Predictor
    (warmed up: eager, then captured) answering SSD_SERVE_REPEATS
    replayed requests, each the same and the first the CPU's answer on
    the same weights and image (``_det_against_cpu``) and bitwise the
    Predictor's eager run of its own program; one request profiled."""
    out = {}
    for b in SSD_SERVE_BUCKETS:
        what = "serve SSD300 batch %d (19)" % b
        infer, _, dets, _ = _ssd_build(fluid, sp, b, False, seed)
        exe = fluid.Executor(fluid.CUDAPlace(0))
        scope = _restored(trained)
        path = os.path.join(workdir, "ssd300_b%d" % b)
        with fluid.scope_guard(scope):
            fluid.io.save_inference_model(path, ["img"], [dets], exe,
                                          main_program=infer)
        req = sp.batch_feed(b, seed + 19 + b, train=False)
        cpu, cpu_in, attrs = _cpu_detections(fluid, infer, dets, req,
                                             _on_cpu(trained))
        exe.close()
        del exe, scope
        config = fluid.inference.AnalysisConfig(path)
        config.warmup_batch_sizes = [b]
        answers, lat_ms = [], []

        def check(_, rep, ans):
            if rep == 0:
                answers.append(ans)
            elif not np.array_equal(ans, answers[0]):
                raise AssertionError("%s: a repeated request gave another "
                                     "answer" % what)

        before = _uncaptured_total()
        # ---- the main path: counts zeroed here, read after the last one
        pred, init_s, p = _metered_serving(
            what, lambda: fluid.inference.create_paddle_predictor(config),
            [req], SSD_SERVE_REPEATS, (0,) * len(COUNT_NAMES), lat_ms,
            check, buckets=[b], batch_feed="img")
        # ---- end of the main path
        got = answers[0]
        eager = pred._exe._run_eager(pred.program, feed=req,
                                     fetch_list=pred.fetch_names,
                                     scope=pred.scope)[0]
        plans = list(pred._exe._cache.values())
        if _uncaptured_total() != before or not plans or \
                any(pl.graph is None for pl in plans):
            raise AssertionError("%s: a serving plan was not captured" % what)
        if got.shape != (b, 200, 6) or not np.isfinite(got).all() or \
                not np.array_equal(got, eager):
            raise AssertionError("%s: detections %s, finite %s, bitwise the "
                                 "eager run's %s" % (
                                     what, got.shape, np.isfinite(got).all(),
                                     np.array_equal(got, eager)))
        vs = _card_against_cpu(what, pred, req, got, cpu, cpu_in, attrs)
        prof = _profiled(lambda: pred.run(req))
        kept = int((got[..., 0] >= 0).sum())
        out[b] = dict(latency_ms=lat_ms[0],
                      latency_median_ms=float(np.median(lat_ms[0])),
                      latency_max_ms=max(lat_ms[0]), init_s=init_s,
                      kept_rows=kept, kernels=prof["kernels"],
                      busy_ms=prof["device_busy_ms"],
                      busy_share=prof["busy_share"],
                      by_class_ms=prof["by_class_ms"],
                      peak_mem_mib=p["peak_mb"],
                      launches=dict(zip(COUNT_NAMES, p["launches"])), **vs)
        _log_breakdown("%s replayed request" % what, prof)
        log("%s: latency median %.3f ms, max %.3f ms over %d replayed "
            "requests; [%d, 200, 6] detections (%d rows kept), bitwise the "
            "Predictor's eager run and the CPU's NMS on the card's NMS "
            "inputs (%.2e from the CPU's); the CPU's within %.2e (%d rows "
            "changed places among scores within %.0e; %d rows in a run that "
            "reaches the last row, matched past it); NMS lanes deciding "
            "otherwise on the card's inputs %s (%d rows of theirs not "
            "held); init %.2f s, peak %.1f MiB" % (
                what, out[b]["latency_median_ms"], out[b]["latency_max_ms"],
                len(lat_ms[0]), b, kept, vs["nms_input_diff"],
                vs["cpu_max_diff"], vs["rows_moved"], SSD_SWAP_TOL,
                vs["tail_rows"], vs["flipped_lanes"], vs["flipped_rows"],
                init_s, p["peak_mb"]))
        del pred
        _free()
    return out


def phase_ssd(workdir, seed):
    """Phase 19: SSD300 (tools/ssd_programs.py: VGG-16 base, 300 x 300,
    21 classes, 8732 priors) from ``seed`` at batch SSD_BATCH, f32, level
    2: its first loss the port's on the CPU (the forward on the same
    weights and feed), then the main path (``_seq_train``: SSD_STEPS Adam
    steps, eager, capture, replays, K6 once a step on the card; replayed
    against eager in turns bitwise; ms, kernels, busy share, device ms by
    class, capture s, peak) with no plan left uncaptured; then served
    (``_ssd_serve``)."""
    import paddle_tpu_torch as fluid

    what = "SSD300 (19)"
    t0 = time.perf_counter()
    sp = _ssd_programs()
    main, startup, loss, priors = _ssd_build(fluid, sp, SSD_BATCH, True,
                                             seed)
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    exe.run(startup, scope=scope)
    params = [p.name for p in main.global_block().all_parameters()]
    tier = _tier_stats(main, [loss.name], scope)
    batches = [sp.batch_feed(SSD_BATCH, seed + i) for i in range(4)]
    # the CPU's first loss: the forward alone, from the same weights
    cpu_loss, cpu_priors = fluid.Executor(fluid.CPUPlace()).run(
        main._prune([loss, priors]), feed=batches[0],
        fetch_list=[loss, priors], scope=_on_cpu(_snapshot(scope)))
    cpu_loss, n_priors = float(cpu_loss), int(cpu_priors.shape[0])
    if n_priors != sp.N_PRIORS:
        raise AssertionError("%s: %d priors, not %d" % (what, n_priors,
                                                        sp.N_PRIORS))
    log("%s: batch %d, %d priors, %d params; built, started and the CPU's "
        "first loss taken in %.1f s; level 2: %d ops of %d" % (
            what, SSD_BATCH, n_priors, len(params),
            time.perf_counter() - t0, tier["ops_after"],
            tier["ops_before"]))
    before = _uncaptured_total()
    snap, _, res = _seq_train(what, exe, scope, main, loss, params, tier,
                              batches, SSD_BATCH, "images",
                              steps=SSD_STEPS, eager_readings=False)
    gap = abs(res["losses"][0] - cpu_loss) / max(1.0, abs(cpu_loss))
    if gap > SSD_CPU_TOL:
        raise AssertionError("%s: the first loss %.6f on the card, %.6f on "
                             "the CPU: %.3e apart (> %.0e)" % (
                                 what, res["losses"][0], cpu_loss, gap,
                                 SSD_CPU_TOL))
    if _uncaptured_total() != before or not _captured(exe):
        raise AssertionError("%s: the training plan was not captured" % what)
    trained = _snapshot(scope)
    exe.close()
    del exe, scope
    _free()
    serve = _ssd_serve(fluid, sp, workdir, seed, trained)
    c = res["compiled"]
    prof = c["replay_profile"]
    out = dict(batch=SSD_BATCH, priors=n_priors, n_params=res["n_params"],
               n_weights=res["n_weights"],
               ops=(tier["ops_before"], tier["ops_after"]),
               losses=res["losses"], cpu_first_loss=cpu_loss,
               cpu_gap=gap, replay_ms=c["replay_median_ms"],
               eager_ms=c["eager_median_ms"],
               replay_ms_all=c["replay_ms"], eager_ms_all=c["eager_ms"],
               capture_s=c["capture_s"], kernels=prof["kernels"],
               busy_share=prof["busy_share"],
               busy_ms=prof["device_busy_ms"],
               wall_ms=prof["wall_ms"], by_class_ms=prof["by_class_ms"],
               top_kernels_ms=prof["top_kernels_ms"],
               peak_mem_mib=res["peak_mem_mib"],
               base_mem_mib=res["base_mem_mib"],
               rise_mem_mib=res["rise_mem_mib"],
               replay_peak_mib=c["peak_mem_mib"]["replay"],
               launches=res["launches"], serve=serve,
               seconds=time.perf_counter() - t0)
    log("%s: first loss %.5f, the CPU's %.5f (%.2e apart); replayed %.3f "
        "ms a step, eager %.3f; %d kernels a replayed step, %.1f%% busy; "
        "%.1f s" % (what, res["losses"][0], cpu_loss, gap,
                    out["replay_ms"], out["eager_ms"], out["kernels"],
                    100 * out["busy_share"], out["seconds"]))
    return out


def _detection_cases(rs):
    """(op, inputs as numpy, attrs, differentiable input slots, tolerance)
    for phase 19b: a small case of each of the 19 detection ops but the
    two samplers (``_detection_random``), shaped like
    tests/test_torch_detection.py's (ties, padding gts, nms_eta < 1, a
    background label), 0 where the card must give the CPU's bits."""
    f = lambda *s: rs.randn(*s).astype("float32")  # noqa: E731

    def boxes(*shape, scale=1.0):
        lo = rs.rand(*shape, 2) * 0.7
        return (np.concatenate([lo, lo + rs.rand(*shape, 2) * 0.4 + 0.05],
                               -1) * scale).astype("float32")

    T = DET_OP_TOL
    prior = boxes(40)
    pvar = (rs.rand(40, 4) * 0.2 + 0.1).astype("float32")
    gt = boxes(2, 4)
    gt[:, -1] = 0.0
    nms_b = boxes(2, 30)
    nms_b[:, 15:] = nms_b[:, :15]
    ties = (rs.randint(0, 5, (2, 4, 30)) / 4.0).astype("float32")
    dist = rs.rand(3, 4, 9).astype("float32")
    dist[:, -1] = 0.0
    dist[:, 1, :3] = dist[:, 0, :3]
    feat = np.zeros((1, 8, 4, 5), "float32")
    image = np.zeros((1, 3, 32, 40), "float32")
    anc = _op_on(torch.device("cpu"), "anchor_generator", {"Input": [feat]},
                 {"anchor_sizes": [8.0, 16.0, 24.0], "aspect_ratios": [1.0],
                  "stride": [8.0, 8.0]})
    anc = {k: [v[0].numpy()] for k, v in anc.items()}
    rois = np.array([[0.5, 1.0, 5.0, 4.5], [2.0, 0.0, 6.5, 6.5],
                     [1.0, 1.0, 1.2, 1.1], [-2.0, 3.0, 9.5, 8.0]], "float32")
    roi_ins = {"X": [f(2, 3, 7, 8)], "ROIs": [rois],
               "RoisBatch": [np.array([1, 0, 1, 0], "int32")]}
    ygt = np.zeros((2, 4, 4), "float32")
    ygt[:, :3, :2] = rs.rand(2, 3, 2) * 0.9 + 0.05
    ygt[:, :3, 2:] = rs.rand(2, 3, 2) * 0.4 + 0.05
    ygt[0, 0] = [0.05, 0.05, 0.1, 0.1]
    fpn = np.array([[0, 0, 16, 16], [0, 0, 500, 500], [0, 0, 224, 224],
                    [5, 5, 21, 21], [10, 10, 234, 234], [0, 0, 90, 120],
                    [3, 3, 19, 19], [0, 0, 0, 0]], "float32")
    return [
        ("prior_box", {"Input": [feat], "Image": [image]},
         {"min_sizes": [4.0, 9.0], "max_sizes": [9.0, 16.0],
          "aspect_ratios": [2.0, 3.0], "flip": True, "clip": True}, [], 0),
        ("density_prior_box", {"Input": [feat], "Image": [image]},
         {"densities": [2, 1], "fixed_sizes": [6.0, 12.0],
          "fixed_ratios": [1.0, 2.0], "clip": True}, [], 0),
        ("anchor_generator", {"Input": [feat]},
         {"anchor_sizes": [32.0, 64.0], "aspect_ratios": [0.5, 2.0],
          "stride": [8.0, 6.0]}, [], 0),
        ("iou_similarity", {"X": [boxes(5)], "Y": [boxes(6)]}, {}, [], 0),
        ("box_coder", {"PriorBox": [prior], "PriorBoxVar": [pvar],
                       "TargetBox": [boxes(4)]},
         {"code_type": "encode_center_size"}, [], T),
        ("box_coder", {"PriorBox": [prior], "PriorBoxVar": [pvar],
                       "TargetBox": [f(3, 40, 4) * 0.5]},
         {"code_type": "decode_center_size"}, [], T),
        ("multiclass_nms", {"BBoxes": [nms_b], "Scores": [rs.rand(
            2, 4, 30).astype("float32")]},
         {"score_threshold": 0.1, "nms_top_k": 12, "keep_top_k": 20,
          "nms_threshold": 0.4, "background_label": 0}, [], 0),
        ("multiclass_nms", {"BBoxes": [nms_b], "Scores": [ties]},
         {"score_threshold": 0.3, "nms_top_k": 30, "keep_top_k": 60,
          "nms_threshold": 0.95, "nms_eta": 0.8}, [], 0),
        ("bipartite_match", {"DistMat": [dist]},
         {"match_type": "per_prediction", "dist_threshold": 0.3}, [], 0),
        ("target_assign", {"X": [f(2, 3, 4)], "MatchIndices": [np.array(
            [[2, -1, 0, 0], [-1, 1, 1, 2]], "int32")]},
         {"mismatch_value": 9.0}, [], 0),
        ("ssd_loss", {"Location": [f(2, 40, 4) * 0.5],
                      "Confidence": [f(2, 40, 5)], "GTBox": [gt],
                      "GTLabel": [rs.randint(1, 5, (2, 4)).astype("int32")],
                      "PriorBox": [prior], "PriorBoxVar": [pvar]},
         {"background_label": 0}, ["Location", "Confidence"], T),
        ("generate_proposals", {
            "Scores": [rs.rand(2, 3, 4, 5).astype("float32")],
            "BboxDeltas": [f(2, 12, 4, 5) * 0.3],
            "ImInfo": [np.array([[32.0, 40.0, 1.0], [30.0, 36.0, 0.8]],
                                "float32")],
            "Anchors": anc["Anchors"], "Variances": anc["Variances"]},
         {"pre_nms_topN": 30, "post_nms_topN": 12, "nms_thresh": 0.5,
          "min_size": 2.0, "eta": 0.8}, [], T),
        ("roi_align", roi_ins, {"pooled_height": 2, "pooled_width": 3,
                                "spatial_scale": 0.9, "sampling_ratio": 2},
         ["X"], T),
        ("roi_pool", roi_ins, {"pooled_height": 2, "pooled_width": 3,
                               "spatial_scale": 0.9}, ["X"], T),
        ("distribute_fpn_proposals", {"FpnRois": [fpn]},
         {"min_level": 2, "max_level": 5, "refer_level": 4,
          "refer_scale": 224}, [], 0),
        ("box_decoder_and_assign", {
            "PriorBox": [boxes(5, scale=30.0)], "TargetBox": [f(5, 12) * 3],
            "BoxScore": [rs.rand(5, 3).astype("float32")]},
         {"box_clip": 4.135}, [], T),
        ("box_clip", {"Input": [f(2, 5, 4) * 40 + 20],
                      "ImInfo": [np.array([[40.0, 60.0, 1.0],
                                           [30.0, 20.0, 0.5]], "float32")]},
         {}, [], 0),
        ("polygon_box_transform", {"Input": [f(2, 8, 3, 5)]}, {}, [], 0),
        ("yolov3_loss", {"X": [f(2, 16, 5, 5)], "GTBox": [ygt],
                         "GTLabel": [rs.randint(0, 3, (2, 4)).astype(
                             "int32")]},
         {"anchors": [10, 13, 16, 30, 33, 23], "anchor_mask": [0, 1],
          "class_num": 3, "ignore_thresh": 0.5, "downsample_ratio": 32},
         ["X"], T),
    ]


def _detection_random(dev):
    """The two samplers on the card: tests/test_ssd_stack.py's
    properties, and twice bitwise from one chain seed."""
    chain = lambda s: torch.Generator().manual_seed(s)  # noqa: E731
    feat = np.zeros((1, 8, 4, 4), "float32")
    anc = _op_on(torch.device("cpu"), "anchor_generator", {"Input": [feat]},
                 {"anchor_sizes": [8.0, 16.0, 32.0], "aspect_ratios": [1.0],
                  "stride": [8.0, 8.0]})["Anchors"][0].numpy()
    ins = {"Anchor": [anc], "GtBoxes": [np.array(
        [[[2, 2, 14, 14], [16, 16, 30, 30], [0, 0, 0, 0]]], "float32")]}
    runs = [_op_on(dev, "rpn_target_assign", ins,
                   {"rpn_batch_size_per_im": 16}, chain(3))
            for _ in range(2)]
    r = {k: v[0].cpu().numpy() for k, v in runs[0].items()}
    lbl, inw = r["TargetLabel"], r["BBoxInsideWeight"]
    if not (r["ScoreIndex"].shape == (1, 16) and set(np.unique(lbl)) <= {
            -1, 0, 1} and (lbl == 1).sum() >= 1 and (inw[lbl == 1] == 1).all()
            and (inw[lbl != 1] == 0).all()) or any(
                not torch.equal(runs[0][k][0], runs[1][k][0]) for k in r):
        raise AssertionError("detection ops (19b): rpn_target_assign on the "
                             "card: %s" % r)
    rs = np.random.RandomState(1)
    base = rs.rand(1, 20, 4).astype("float32") * 20
    ins = {"RpnRois": [np.concatenate([base[..., :2], base[..., :2] + 5
                                       + base[..., 2:]], -1)],
           "GtClasses": [np.array([[1, 3, 0]], "int32")],
           "GtBoxes": [np.array([[[2, 2, 10, 10], [12, 12, 20, 20],
                                  [0, 0, 0, 0]]], "float32")]}
    attrs = {"batch_size_per_im": 12, "class_nums": 5, "fg_thresh": 0.5}
    runs = [_op_on(dev, "generate_proposal_labels", ins, attrs, chain(4))
            for _ in range(2)]
    r = {k: v[0].cpu().numpy() for k, v in runs[0].items()}
    lbl, tgt = r["LabelsInt32"], r["BboxTargets"]
    blocks_ok = all(np.abs(np.delete(tgt[0, i].reshape(5, 4), lbl[0, i],
                                     axis=0)).sum() == 0
                    for i in np.where(lbl[0] > 0)[0])
    if not (r["Rois"].shape == (1, 12, 4) and tgt.shape == (1, 12, 20) and
            (lbl > 0).sum() >= 2 and blocks_ok) or any(
                not torch.equal(runs[0][k][0], runs[1][k][0]) for k in r):
        raise AssertionError("detection ops (19b): generate_proposal_labels "
                             "on the card: %s" % r)
    return ["rpn_target_assign", "generate_proposal_labels"]


def _nms_at_ssd_scale(dev):
    """``multiclass_nms`` at SSD300's detection_output shape (batch 8, 21
    classes, 8732 candidates, nms_top_k 400, keep_top_k 200) over
    tie-heavy scores (five levels, repeated boxes, most under the
    threshold): the CPU's bits, twice; then one profiled call on
    continuous scores (its kernels and device ms)."""
    g = torch.Generator().manual_seed(19)
    lo = torch.rand(8, 4366, 2, generator=g) * 0.7
    bx = torch.cat([lo, lo + torch.rand(8, 4366, 2, generator=g) * 0.3
                    + 0.02], -1)
    bx = torch.cat([bx, bx], 1)
    ties = torch.randint(0, 5, (8, 21, 8732), generator=g).float() / 4
    attrs = {"score_threshold": 0.6, "nms_top_k": 400, "keep_top_k": 200,
             "nms_threshold": 0.45, "background_label": 0}
    want = _op_on(torch.device("cpu"), "multiclass_nms",
                  {"BBoxes": [bx.numpy()], "Scores": [ties.numpy()]}, attrs)
    runs = [_op_on(dev, "multiclass_nms", {"BBoxes": [bx.numpy()],
                                           "Scores": [ties.numpy()]},
                   attrs)["Out"][0].cpu() for _ in range(2)]
    if not (torch.equal(runs[0], want["Out"][0]) and
            torch.equal(runs[1], runs[0])):
        raise AssertionError("detection ops (19b): multiclass_nms over ties "
                             "at SSD300's shape differs from the CPU's")
    scores = torch.softmax(torch.randn(8, 21, 8732, generator=g) * 3, 1)
    ins = {"BBoxes": [bx.to(dev)], "Scores": [scores.to(dev)]}
    from paddle_tpu_torch.core.lowering import LowerContext
    from paddle_tpu_torch.core.registry import get_op

    call = lambda: get_op("multiclass_nms").lowering(  # noqa: E731
        LowerContext(None, None, dev), ins, dict(attrs, score_threshold=0.01))
    call()
    prof = _profiled(call)
    _log_breakdown("multiclass_nms at SSD300's shape (19b)", prof)
    return dict(kernels=prof["kernels"], busy_ms=prof["device_busy_ms"],
                wall_ms=prof["wall_ms"], busy_share=prof["busy_share"])


def phase_detection_ops(seed):
    """Phase 19b: the 19 detection op types on the card against their CPU
    lowerings (forward, and the grads of the four differentiable ones,
    which also repeat bitwise on the card), 0-tolerance cases bitwise;
    the two samplers by their properties and twice bitwise from one
    seed; multiclass_nms over ties at SSD300's shape bitwise the CPU's,
    and its kernels and device ms there."""
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    rs = np.random.RandomState(seed)
    done, bad = _ops_against_cpu(_detection_cases(rs), rs, dev, repeat=True)
    done.update(_detection_random(dev))
    if bad:
        raise AssertionError("detection ops (19b): the card differs from the "
                             "CPU: %s" % bad)
    if len(done) != 19:
        raise AssertionError("detection ops (19b): %d op types checked, not "
                             "19" % len(done))
    nms = _nms_at_ssd_scale(dev)
    secs = time.perf_counter() - t0
    log("detection ops (19b): %d op types on the card against the CPU "
        "(forward, and the grads of the differentiable ones, bitwise twice "
        "on the card), the samplers by their properties and bitwise from "
        "one seed; multiclass_nms over ties at SSD300's shape bitwise the "
        "CPU's; %d kernels, %.3f ms busy a call there; %.1f s" % (
            len(done), nms["kernels"], nms["busy_ms"], secs))
    return dict(op_types=sorted(done), nms=nms, seconds=secs)


# -------------------------------------------------------------- phase 20
MNIST_BATCH = 64
MNIST_CAPACITY = 8      # PyReader's queue: batches converted ahead
MNIST_LR = 1e-3
MNIST_MIN_STEPS = 100   # the main path's steps at least (the corpus: 128)
MNIST_ACC_BAR = 0.95    # tests/test_book_mnist.py's bar
FEED_TURNS = 3          # rounds of the three feeding paths, in turns
FEED_TURN_STEPS = 24    # steps a path takes in a round


def _mnist_program(fluid, seed):
    """The book's recognize_digits network at the repo's widths
    (models/mnist.py ``build("cnn")``: 20 and 50 5x5 filters, pool 2,
    fc 10 softmax) with Adam at MNIST_LR, from ``seed``: (main, startup,
    test program, loss, acc, feed vars)."""
    from paddle_tpu_torch.models import mnist

    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        loss, acc, feeds = mnist.build("cnn")
        test = main.clone(for_test=True)
        fluid.optimizer.Adam(learning_rate=MNIST_LR).minimize(loss)
    return main, startup, test, loss, acc, feeds


def _loss(vals):
    return float(np.asarray(vals[0]).reshape(-1)[0])


def _feed_turns(paths):
    """Each of ``paths`` (name -> fn(steps) -> extra seconds) run for
    FEED_TURN_STEPS steps, FEED_TURNS rounds in turns (the order rotated
    each round): per path the rounds' ms a step (wall over steps, the
    card synchronized at the end) and the extra seconds it returned
    over steps, in ms."""
    names = list(paths)
    ms = {n: [] for n in names}
    extra = {n: [] for n in names}
    for r in range(FEED_TURNS):
        for n in names[r % len(names):] + names[:r % len(names)]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            x = paths[n](FEED_TURN_STEPS)
            torch.cuda.synchronize()
            ms[n].append((time.perf_counter() - t0) * 1e3 / FEED_TURN_STEPS)
            extra[n].append(x * 1e3 / FEED_TURN_STEPS)
    return ms, extra


def phase_mnist_fed(seed):
    """Phase 20: the book's recognize_digits trained the Fluid way at the
    repo's widths (``_mnist_program``), f32, level 2: ``dataset.mnist``
    -> ``batch(64)`` -> ``layers.PyReader(capacity=8)`` fed through
    ``decorate_sample_list_generator`` (DataFeeder) to the card, ``for
    feed in reader(): exe.run(main, feed=feed, ...)`` over the corpus's
    128 batches (the main path: K6 once a step, counted; the plan
    captured and replayed; the feeds card tensors, labels int32); the
    losses bitwise those of the same batches fed as DataFeeder numpy
    dicts and through ``train_loop``, each from the same startup. Then
    ``contrib.Trainer`` (its default place, the card) trains the same
    network from the same seed, bitwise the ``exe.run`` loop, and
    ``Trainer.test`` and ``Inferencer.infer`` on its saved params pass
    the book's accuracy bar. Logged: step ms fed by dicts, by PyReader
    and by train_loop in turns; the consumer's wait a step; a profiled
    reader-fed window's busy share; the card memory the queue holds."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.contrib import EndStepEvent, Inferencer, Trainer
    from paddle_tpu_torch.models import mnist

    what = "recognize_digits (20)"
    t0 = time.perf_counter()
    card = fluid.CUDAPlace(0)
    main, startup, test, loss, acc, feeds = _mnist_program(fluid, seed)
    exe, scope = fluid.Executor(card), fluid.Scope()
    exe.run(startup, scope=scope)
    snap = _snapshot(scope)
    tier = _tier_stats(main, [loss.name], scope)
    n_trainable = len([p for p in main.global_block().all_parameters()
                       if p.trainable])
    if tier["optimizer_groups"] != [n_trainable]:
        raise AssertionError("%s: level 2 made optimizer groups %s of %d "
                             "params" % (what, tier["optimizer_groups"],
                                         n_trainable))
    per_step = _per_step("Adam", 1)
    train = fluid.batch(fluid.dataset.mnist.train(), MNIST_BATCH)
    reader = fluid.layers.PyReader(feed_list=feeds, capacity=MNIST_CAPACITY)
    reader.decorate_sample_list_generator(train, places=card)
    losses, kinds = [], None
    # ---- the main path: counts zeroed here, read after the last step
    _zero_counts()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    with LaunchMeter() as meter:
        for feed in reader():
            meter.mark()
            if kinds is None:
                kinds = {n: (str(v.device), str(v.dtype), tuple(v.shape))
                         for n, v in feed.items()}
            losses.append(_loss(exe.run(main, feed=feed, fetch_list=[loss],
                                        scope=scope)))
    path_s = time.perf_counter() - t1
    host = _counts()
    # ---- end of the main path
    bad = [i for i, u in enumerate(meter.units) if u != per_step]
    if bad or host != _times(per_step, 2):
        raise AssertionError("%s: steps %s ran other than %s = %s on the "
                             "card, or the wrappers counted %s" % (
                                 what, bad[:5], COUNT_NAMES, per_step, host))
    if len(losses) < MNIST_MIN_STEPS or not _captured(exe) or \
            not np.isfinite(losses).all():
        raise AssertionError("%s: %d steps, captured %s, losses %s" % (
            what, len(losses), bool(_captured(exe)), losses[-3:]))
    if kinds != {"img": ("cuda:0", "torch.float32", (MNIST_BATCH, 784)),
                 "label": ("cuda:0", "torch.int32", (MNIST_BATCH, 1))}:
        raise AssertionError("%s: the reader fed %s" % (what, kinds))
    launches = meter.total()

    # the same batches as DataFeeder numpy dicts, and through train_loop
    feeder = fluid.DataFeeder(feeds)
    dicts = [feeder.feed(b) for b in train()]
    exe_d, scope_d = fluid.Executor(card), _restored(snap)
    dict_losses = [_loss(exe_d.run(main, feed=d, fetch_list=[loss],
                                   scope=scope_d)) for d in dicts]
    exe_l, scope_l = fluid.Executor(card), _restored(snap)
    loop_losses = []
    exe_l.train_loop(main, lambda: iter(dicts), fetch_list=[loss],
                     scope=scope_l, steps_per_call=1,
                     on_step=lambda i, v: loop_losses.append(_loss(v)))
    if dict_losses != losses or loop_losses != losses:
        first = next((i for i, (a, b, c) in enumerate(zip(
            losses, dict_losses, loop_losses)) if not a == b == c), None)
        raise AssertionError("%s: reader-fed losses differ from dict-fed / "
                             "train_loop ones from step %s: %s / %s / %s" % (
                                 what, first, losses[first:first + 2],
                                 dict_losses[first:first + 2],
                                 loop_losses[first:first + 2]))

    # step ms in turns: dicts (the reader, DataFeeder and run on the
    # loop's thread), PyReader (the conversion and copy on its thread;
    # the consumer's wait apart), train_loop over dicts
    def dict_path(n):
        for b in fluid.reader.firstn(train, n)():
            exe_d.run(main, feed=feeder.feed(b), fetch_list=[loss],
                      scope=scope_d)
        return 0.0

    def reader_path(n):
        r = fluid.layers.PyReader(feed_list=feeds, capacity=MNIST_CAPACITY)
        r.decorate_sample_list_generator(fluid.reader.firstn(train, n),
                                         places=card)
        wait, it = 0.0, iter(r())
        while True:
            w0 = time.perf_counter()
            feed = next(it, None)
            wait += time.perf_counter() - w0
            if feed is None:
                return wait
            exe.run(main, feed=feed, fetch_list=[loss], scope=scope)

    def loop_path(n):
        exe_l.train_loop(main, lambda: (feeder.feed(b) for b in
                                        fluid.reader.firstn(train, n)()),
                         fetch_list=[loss], scope=scope_l, steps_per_call=1)
        return 0.0

    ms, extra = _feed_turns(dict(dicts=dict_path, pyreader=reader_path,
                                 train_loop=loop_path))
    med = {k: float(np.median(v)) for k, v in ms.items()}
    wait_ms = float(np.median(extra["pyreader"]))
    prof = _profiled(lambda: reader_path(FEED_TURN_STEPS))
    # the card memory the queue holds: the consumer takes one batch and
    # stops while the producer fills the queue
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    r = fluid.layers.PyReader(feed_list=feeds, capacity=MNIST_CAPACITY)
    r.decorate_sample_list_generator(
        fluid.reader.firstn(train, 4 * MNIST_CAPACITY), places=card)
    it = iter(r())
    first = next(it)
    batch_bytes = sum(v.numel() * v.element_size() for v in first.values())
    time.sleep(0.5)
    torch.cuda.synchronize()
    queued = torch.cuda.memory_allocated() - base
    it.close()
    del first, it
    exe_d.close()
    exe_l.close()

    # contrib.Trainer from the same seed, on its default place; then
    # Trainer.test and Inferencer.infer on its saved params
    def train_func():
        fluid.default_main_program().random_seed = seed
        fluid.default_startup_program().random_seed = seed
        lo, ac, _ = mnist.build("cnn")
        return [lo, ac]

    def infer_func():
        return mnist.cnn(fluid.layers.data("img", [784]))

    def labelled(reader):
        return fluid.reader.map_readers(
            lambda s: (s[0], np.array([s[1]], "int64")), reader)

    t2 = time.perf_counter()
    trainer = Trainer(train_func,
                      lambda: fluid.optimizer.Adam(learning_rate=MNIST_LR))
    trainer_losses = []
    trainer.train(1, lambda e: isinstance(e, EndStepEvent) and
                  trainer_losses.append(_loss(e.metrics)),
                  fluid.batch(labelled(fluid.dataset.mnist.train()),
                              MNIST_BATCH), ["img", "label"])
    trainer_s = time.perf_counter() - t2
    if trainer.exe.device != torch.device("cuda", 0) or \
            trainer_losses != losses:
        raise AssertionError("%s: the Trainer on %s, its losses %s against "
                             "the exe.run loop's %s" % (
                                 what, trainer.exe.device,
                                 trainer_losses[:3], losses[:3]))
    test_reader = fluid.batch(labelled(fluid.dataset.mnist.test()),
                              MNIST_BATCH)
    test_loss, test_acc = trainer.test(test_reader, ["img", "label"])
    samples = list(fluid.dataset.mnist.test()())
    imgs = np.stack([s[0] for s in samples])
    labels = np.array([s[1] for s in samples])
    with tempfile.TemporaryDirectory() as d:
        trainer.save_params(d)
        inferencer = Inferencer(infer_func, d)
        (probs,) = inferencer.infer({"img": imgs})
    infer_acc = float((probs.argmax(1) == labels).mean())
    if test_acc <= MNIST_ACC_BAR or infer_acc <= MNIST_ACC_BAR or \
            inferencer.exe.device != torch.device("cuda", 0):
        raise AssertionError("%s: test accuracy %.4f, the Inferencer's %.4f "
                             "(on %s), bar %.2f" % (
                                 what, test_acc, infer_acc,
                                 inferencer.exe.device, MNIST_ACC_BAR))
    trainer.exe.close()
    inferencer.exe.close()
    secs = time.perf_counter() - t0
    out = dict(steps=len(losses), losses=losses[:3] + losses[-3:],
               path_s=path_s, launches=dict(zip(COUNT_NAMES, launches)),
               host_launches=dict(zip(COUNT_NAMES, host)),
               feed_kinds=kinds, step_ms=ms, step_ms_median=med,
               wait_ms=extra["pyreader"], wait_ms_median=wait_ms,
               busy_share=prof["busy_share"], busy_ms=prof["device_busy_ms"],
               wall_ms=prof["wall_ms"], kernels=prof["kernels"],
               by_class_ms=prof["by_class_ms"], queued_bytes=queued,
               batch_bytes=batch_bytes, trainer_s=trainer_s,
               test_loss=test_loss, test_acc=test_acc, infer_acc=infer_acc,
               seconds=secs)
    log("%s: %d PyReader-fed steps (capacity %d) at batch %d, K6 %d, the "
        "plan replayed; losses %.4f -> %.4f, bitwise the DataFeeder dicts' "
        "and train_loop's; the feeds %s" % (
            what, len(losses), MNIST_CAPACITY, MNIST_BATCH,
            launches[COUNT_NAMES.index("K6")], losses[0], losses[-1],
            kinds))
    log("%s: ms a step in turns (%d rounds of %d): dicts %s, PyReader %s, "
        "train_loop %s; the consumer's wait %.4f ms a step; a profiled "
        "reader-fed window of %d steps %.1f%% busy (%d kernels, %.3f busy "
        "ms of %.3f); the queue held %d bytes on the card (%.2f batches of "
        "%d)" % (what, FEED_TURNS, FEED_TURN_STEPS,
                 ["%.4f" % v for v in ms["dicts"]],
                 ["%.4f" % v for v in ms["pyreader"]],
                 ["%.4f" % v for v in ms["train_loop"]], wait_ms,
                 FEED_TURN_STEPS, 100 * prof["busy_share"], prof["kernels"],
                 prof["device_busy_ms"], prof["wall_ms"], queued,
                 queued / batch_bytes, batch_bytes))
    log("%s: contrib.Trainer on the card, %d steps bitwise the exe.run "
        "loop (%.1f s); Trainer.test loss %.5f accuracy %.4f, "
        "Inferencer.infer accuracy %.4f on %d images (bar %.2f); %.1f s" % (
            what, len(trainer_losses), trainer_s, test_loss, test_acc,
            infer_acc, len(labels), MNIST_ACC_BAR, secs))
    return out


# ------------------------------------------------------------- phase 20b
CTR_FILES, CTR_LINES, CTR_BATCH, CTR_THREADS = 8, 4096, 1024, 4
CTR_LR = 1e-3
CTR_PROTO = """name: "MultiSlotDataFeed"
batch_size: %d
multi_slot_desc {
    slots { name: "sparse_ids" type: "uint64" is_dense: false is_used: true dim: %d }
    slots { name: "dense" type: "float" is_dense: true is_used: true dim: %d }
    slots { name: "label" type: "uint64" is_dense: false is_used: true dim: 1 }
}
"""


def _ctr_slot_files(workdir, seed, n_fields, n_dense, vocab):
    """CTR_FILES MultiSlot files of CTR_LINES lines (Criteo's layout: the
    26 sparse ids, the 13 dense features, the label, each slot as
    "<count> values"), from ``seed``; dense values are multiples of 1/64,
    exact in float32 and in their printed form. Returns the paths and
    each file's (ids, dense, label) arrays."""
    rs = np.random.RandomState(seed)
    paths, arrays = [], []
    fmt = (["%d"] * (n_fields + 1) + ["%d"] + ["%.6f"] * n_dense
           + ["%d", "%d"])
    for i in range(CTR_FILES):
        ids = rs.randint(0, vocab, (CTR_LINES, n_fields)).astype(np.int64)
        dense = (rs.randint(0, 4096, (CTR_LINES, n_dense)) / 64.0).astype(
            np.float32)
        label = rs.randint(0, 2, (CTR_LINES, 1)).astype(np.int64)
        col = lambda v: np.full((CTR_LINES, 1), v)  # noqa: E731
        rows = np.concatenate([col(n_fields), ids, col(n_dense), dense,
                               col(1), label], axis=1).astype(np.float64)
        path = os.path.join(workdir, "part-%05d" % i)
        np.savetxt(path, rows, fmt=fmt)
        paths.append(path)
        arrays.append((ids, dense, label))
    return paths, arrays


def _batch_hash(feed):
    import hashlib

    h = hashlib.sha256()
    for n in sorted(feed):
        h.update(n.encode())
        h.update(np.ascontiguousarray(np.asarray(feed[n])).tobytes())
    return h.hexdigest()


def phase_async_ctr(workdir, seed):
    """Phase 20b: ``AsyncExecutor`` over MultiSlot files on the card:
    DeepFM at the full width of models/ctr.py's ``build("deepfm")`` (26
    sparse fields, 13 dense features, vocab 1,000,001, embedding 16,
    hidden 400-400: Criteo's layout) with Adam, f32, level 2; CTR_FILES
    files of CTR_LINES lines from ``seed``, a ``DataFeedDesc`` parsed
    from proto text (batch CTR_BATCH). The main path: one reader thread,
    every step's loss (K6 once a step, counted), bitwise a numpy loop
    over the same batches from the same startup; then CTR_THREADS reader
    threads: the batches' multiset (a hash of each) the one-thread run's,
    the last loss finite. Logged: rows/s through AsyncExecutor and
    through the reader alone at 1 and CTR_THREADS threads, a profiled
    file's busy share."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core.executor import (add_feed_observer,
                                                remove_feed_observer)
    from paddle_tpu_torch.models import ctr
    from paddle_tpu_torch.native.data_feed import MultiSlotDataFeed

    what = "AsyncExecutor DeepFM (20b)"
    t0 = time.perf_counter()
    n_fields, n_dense, vocab, emb = 26, 13, 1000001, 16
    files, arrays = _ctr_slot_files(workdir, seed + 20, n_fields, n_dense,
                                    vocab)
    proto = os.path.join(workdir, "data.proto")
    with open(proto, "w") as f:
        f.write(CTR_PROTO % (CTR_BATCH, n_fields, n_dense))
    desc = fluid.DataFeedDesc(proto)
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        loss, _, _ = ctr.build("deepfm", n_fields=n_fields, n_dense=n_dense,
                               vocab=vocab, emb_dim=emb)
        fluid.optimizer.Adam(learning_rate=CTR_LR).minimize(loss)
    exe0, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    exe0.run(startup, scope=scope)
    snap = _snapshot(scope)
    exe0.close()
    params = main.global_block().all_parameters()
    tier = _tier_stats(main, [loss.name], scope)
    if tier["optimizer_groups"] != [len(params)]:
        raise AssertionError("%s: level 2 made optimizer groups %s of %d "
                             "params" % (what, tier["optimizer_groups"],
                                         len(params)))
    setup_s = time.perf_counter() - t0
    rows = CTR_FILES * CTR_LINES
    per_step = _per_step("Adam", 1)

    def run(threads, scope, meter=None):
        """AsyncExecutor (its default place, the card) over every file at
        ``threads`` reader threads: (every step's loss, the batches'
        hashes, seconds). Each step's fetch is read from the executor's
        run (a wrapper of the harness's, marking the meter)."""
        ae = fluid.AsyncExecutor()
        inner, step_losses, hashes = ae._exe.run, [], []

        def recorded(*a, **kw):
            if meter is not None:
                meter.mark()
            vals = inner(*a, **kw)
            step_losses.append(_loss(vals))
            return vals

        def observe(feed):
            hashes.append(_batch_hash(feed))

        ae._exe.run = recorded
        add_feed_observer(observe)
        try:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            ae.run(main, desc, files, thread_num=threads, fetch=[loss],
                   scope=scope)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t1
        finally:
            remove_feed_observer(observe)
        if ae._exe.device != torch.device("cuda", 0):
            raise AssertionError("%s: AsyncExecutor ran on %s"
                                 % (what, ae._exe.device))
        ae._exe.close()
        return step_losses, hashes, secs

    # ---- the main path: counts zeroed here, read after the last step
    _zero_counts()
    with LaunchMeter() as meter:
        one, one_hashes, one_s = run(1, _restored(snap), meter)
    host = _counts()
    # ---- end of the main path
    if any(u != per_step for u in meter.units) or \
            len(meter.units) != len(one) or \
            host != _times(per_step, 2) or len(one) != rows // CTR_BATCH:
        raise AssertionError("%s: %d steps ran %s = %s on the card (%s "
                             "expected each), the wrappers counted %s" % (
                                 what, len(one), COUNT_NAMES, meter.units[:3],
                                 per_step, host))
    # the numpy loop over the same batches, in file order
    exe_n, scope_n = fluid.Executor(fluid.CUDAPlace(0)), _restored(snap)
    numpy_losses, numpy_hashes = [], []
    for ids, dense, label in arrays:
        for b in range(0, CTR_LINES, CTR_BATCH):
            feed = {"sparse_ids": ids[b:b + CTR_BATCH],
                    "dense": dense[b:b + CTR_BATCH],
                    "label": label[b:b + CTR_BATCH]}
            numpy_hashes.append(_batch_hash(feed))
            numpy_losses.append(_loss(exe_n.run(
                main, feed=feed, fetch_list=[loss], scope=scope_n)))
    exe_n.close()
    if one != numpy_losses or one_hashes != numpy_hashes:
        raise AssertionError("%s: at one thread the losses %s, the numpy "
                             "loop's %s (batches equal: %s)" % (
                                 what, one[:3], numpy_losses[:3],
                                 one_hashes == numpy_hashes))
    many, many_hashes, many_s = run(CTR_THREADS, _restored(snap))
    if sorted(many_hashes) != sorted(one_hashes) or \
            not np.isfinite(many[-1]):
        raise AssertionError("%s: at %d threads %d batches, %d of them the "
                             "one-thread run's; last loss %s" % (
                                 what, CTR_THREADS, len(many_hashes),
                                 len(set(many_hashes) & set(one_hashes)),
                                 many[-1]))
    order_moved = many_hashes != one_hashes

    def parse_only(threads):
        feed = MultiSlotDataFeed(files, desc.slot_descs, CTR_BATCH,
                                 n_threads=threads)
        t1 = time.perf_counter()
        n = sum(b[0].shape[0] for b in feed)
        secs = time.perf_counter() - t1
        feed.close()
        if n != rows:
            raise AssertionError("%s: the reader gave %d rows" % (what, n))
        return rows / secs

    parse = {1: parse_only(1), CTR_THREADS: parse_only(CTR_THREADS)}
    # rows/s of a warm AsyncExecutor (its plan prepared and captured, as
    # from a user's second epoch on) at 1 and CTR_THREADS threads in turns
    warm_scope = _restored(snap)
    ae = fluid.AsyncExecutor()
    ae.run(main, desc, files[:1], thread_num=1, fetch=[loss],
           scope=warm_scope)
    rates = {1: [], CTR_THREADS: []}
    for t in (1, CTR_THREADS, CTR_THREADS, 1):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        ae.run(main, desc, files, thread_num=t, fetch=[loss],
               scope=warm_scope)
        torch.cuda.synchronize()
        rates[t].append(rows / (time.perf_counter() - t1))
    prof = _profiled(lambda: ae.run(main, desc, files, thread_num=CTR_THREADS,
                                    fetch=[loss], scope=warm_scope))
    ae._exe.close()
    secs = time.perf_counter() - t0
    out = dict(rows=rows, steps=len(one), losses=one[:3] + one[-3:],
               launches=dict(zip(COUNT_NAMES, meter.total())),
               host_launches=dict(zip(COUNT_NAMES, host)),
               first_run_rows_per_s={1: rows / one_s,
                                     CTR_THREADS: rows / many_s},
               rows_per_s=rates, reader_rows_per_s=parse,
               order_moved=order_moved,
               busy_share=prof["busy_share"], busy_ms=prof["device_busy_ms"],
               wall_ms=prof["wall_ms"], kernels=prof["kernels"],
               by_class_ms=prof["by_class_ms"], setup_s=setup_s,
               seconds=secs)
    log("%s: %d files x %d lines, batch %d; one reader thread: %d steps, "
        "K6 %d, losses %.5f -> %.5f bitwise the numpy loop's; %d threads: "
        "the same %d batches (order moved: %s), last loss %.5f" % (
            what, CTR_FILES, CTR_LINES, CTR_BATCH, len(one),
            out["launches"]["K6"], one[0], one[-1], CTR_THREADS,
            len(many_hashes), order_moved, many[-1]))
    log("%s: rows/s through a warm AsyncExecutor in turns %s at 1 thread, "
        "%s at %d (its first runs, plan prepared and captured: %.0f / %.0f); "
        "the reader alone %.0f / %.0f; a profiled warm run at %d threads "
        "(%d steps) %.1f%% busy, %d kernels, %.3f busy ms of %.3f, by class "
        "%s; set-up %.1f s (files, startup), %.1f s" % (
            what, ["%.0f" % v for v in rates[1]],
            ["%.0f" % v for v in rates[CTR_THREADS]], CTR_THREADS,
            rows / one_s, rows / many_s, parse[1], parse[CTR_THREADS],
            CTR_THREADS, len(one), 100 * prof["busy_share"],
            prof["kernels"], prof["device_busy_ms"], prof["wall_ms"],
            {k: round(v, 3) for k, v in prof["by_class_ms"].items()},
            setup_s, secs))
    return out


# ------------------------------------------------------------- phase 20c
CALIB_BATCH, CALIB_BATCHES, CALIB_CHECK_BATCH = 8, 4, 2
# from its random startup ResNet-50's activations grow through its 16
# residual blocks (the batch norms' running stats are 0 and 1), so its
# logits spread over thousands and its softmax is one-hot; the fc's
# weight is scaled so the shared batch's logits have this std, and the
# answers compared below are probabilities that int8 rounding can move
CALIB_LOGIT_STD = 3.0
CALIB_BINS = 2048          # the Calibrator's default histogram
CALIB_MAX_RTOL = 1e-5      # card against CPU, the max scales
# a KL threshold more than one bin from the CPU's is a rounding
# departure only where the two histograms hold the same counts but for
# CALIB_TV of their mass (the card's convolutions round values across
# bin edges), and then it is at most CALIB_KL_BINS bins away
CALIB_TV = 1e-3
CALIB_KL_BINS = 4
# each op of the served int8 program run on the card at the CPU's inputs
# (``_int8_ops_held``): a float output within CALIB_OP_RTOL of its abs
# max, a fake-quant output equal to the CPU's but for one-level flips in
# at most CALIB_FLIP_SHARE of its elements; an op whose output is off by
# CALIB_FAULT (relative) must fail this, and the check is shown to refuse
# one such conv and one such fake-quant op on every run
CALIB_OP_RTOL = 1e-4
CALIB_FLIP_SHARE = 1e-4
CALIB_FAULT = 1e-3
# the card's whole batch-1 answer within CALIB_GAP_STEPS quantization
# steps (its abs max / 127) of the CPU's, twice the most that rounding
# alone moved it on an H100's host: the rounding control (the CPU with
# every float op's output moved by CALIB_NOISE relative, seeds
# CALIB_CONTROL_SEEDS) read 1.257, 2.291 and 4.003 steps. The whole
# answer cannot tell a small fault from rounding (one deep conv off by
# CALIB_FAULT moved it 0.604 steps), so the op check above is what holds
# each op; this bound catches a gross one. Both readings are logged.
CALIB_GAP_STEPS = 8.0
CALIB_NOISE = 2.0 ** -22
CALIB_CONTROL_SEEDS = (1, 2, 3)
CALIB_SERVE = (1, 8)
CALIB_REPEATS = 5          # requests of each bucket, int8 and f32 in turns


def _int8_program(fluid, int8_dir):
    """The saved int8 program as a Predictor lowers it: loaded on the
    host, through the pass pipeline (``optimize_for_execution``). Returns
    its block, its ops (no feed or fetch op), the host scope and its
    feed and fetch names."""
    from paddle_tpu_torch.core.passes import optimize_for_execution

    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    with fluid.scope_guard(scope):
        prog, feeds, fetches = fluid.io.load_inference_model(int8_dir, exe)
    exe.close()
    fetch = [v.name for v in fetches]
    prog = optimize_for_execution(prog, fetch, scope=scope)
    block = prog.global_block()
    ops = [op for op in block.ops if op.type not in ("feed", "fetch")]
    return block, ops, scope, list(feeds), fetch


def _int8_env(ops, scope, req):
    """The host values the ops read before any op writes them: the
    request's feeds and the scope's state, as CPU tensors."""
    env = {n: torch.from_numpy(np.ascontiguousarray(v))
           for n, v in req.items()}
    written = set()
    for op in ops:
        for n in op.input_names():
            if n and n not in env and n not in written:
                v = scope.find_var(n)
                env[n] = (v.detach().cpu() if isinstance(v, torch.Tensor)
                          else torch.from_numpy(np.asarray(v)))
        written.update(n for n in op.output_names() if n)
    return env


def _run_int8(block, ops, env, hook=None):
    """The ops lowered in order on the CPU over ``env`` (in place);
    ``hook(i, op, env)`` after each."""
    from paddle_tpu_torch.core.lowering import LowerContext, lower_op

    ctx = LowerContext(block, None, torch.device("cpu"))
    for i, op in enumerate(ops):
        lower_op(ctx, op, env)
        if hook is not None:
            hook(i, op, env)
    return env


def _op_departure(op, a, b, env):
    """``a`` (the card's output of ``op``) against ``b`` (the CPU's,
    from the same inputs): (how far, whether within the bound). A
    fake-quant output: the elements that differ, each by one level
    (its InScale / qmax) and at most CALIB_FLIP_SHARE of them; a float
    output: max |a - b| over max |b|, within CALIB_OP_RTOL; other
    dtypes: equal."""
    if not b.is_floating_point():
        same = torch.equal(a.to(b.dtype), b)
        return (0.0 if same else float("inf")), same
    d = (a.double() - b.double()).abs()
    if op.type.startswith("fake_quantize") and "InScale" in op.inputs:
        qmax = float((1 << (int(op.attrs.get("bit_length", 8)) - 1)) - 1)
        step = float(env[op.input("InScale")[0]].reshape(-1)[0]) / qmax
        moved = d > 1e-3 * step
        units = d[moved] / step
        share = float(moved.sum()) / max(d.numel(), 1)
        ok = share <= CALIB_FLIP_SHARE and bool(
            ((units - 1).abs() <= 1e-3).all())
        return share, ok
    rel = float(d.max()) / max(float(b.abs().max()), 1e-30) \
        if d.numel() else 0.0
    return rel, rel <= CALIB_OP_RTOL


def _int8_ops_held(block, ops, env, dev, fault_at=()):
    """Each op of the int8 program lowered on ``dev`` at the CPU's
    inputs (taken from ``env``, the CPU's values, which the same op then
    extends on the CPU), its outputs held to the CPU's
    (``_op_departure``). For each op index in ``fault_at`` the card's
    output is also checked moved by CALIB_FAULT, which must be refused.
    Returns (per op type: count and the worst departure, the ops
    refused, the planted faults' departures and verdicts)."""
    from paddle_tpu_torch.core.lowering import LowerContext, lower_op

    ctx_dev = LowerContext(block, None, dev)
    ctx_cpu = LowerContext(block, None, torch.device("cpu"))
    by_type, refused, planted = {}, [], []
    for i, op in enumerate(ops):
        on_dev = {n: env[n].to(dev) for n in op.input_names() if n}
        lower_op(ctx_dev, op, on_dev)
        lower_op(ctx_cpu, op, env)
        row = by_type.setdefault(op.type, dict(ops=0, worst=0.0))
        row["ops"] += 1
        for n in op.output_names():
            if not n or n not in env:
                continue
            a = on_dev[n].cpu()
            how, ok = _op_departure(op, a, env[n], env)
            row["worst"] = max(row["worst"], how)
            if not ok:
                refused.append(dict(op=i, type=op.type, out=n, how=how))
            if i in fault_at and n == op.output_names()[0]:
                how_f, ok_f = _op_departure(op, a * (1 + CALIB_FAULT),
                                            env[n], env)
                planted.append(dict(op=i, type=op.type, out=n, how=how_f,
                                    refused=not ok_f))
        del on_dev
    return by_type, refused, planted


def phase_calibrate(workdir, seed):
    """Phase 20c: the int8 ``Calibrator`` on ResNet-50's inference program
    at 224 x 224 from its startup (``seed``; the fc's weight scaled to
    CALIB_LOGIT_STD), f32: the scales the card
    computes from one shared batch of CALIB_CHECK_BATCH images against
    the CPU lowering's from the same weights (``max`` within
    CALIB_MAX_RTOL relative, KL within one histogram bin, edge /
    CALIB_BINS, or a rounding departure of at most CALIB_KL_BINS bins
    between histograms within CALIB_TV); then ``algo="KL"`` and ``"max"``
    over CALIB_BATCHES batches of CALIB_BATCH images each, KL's program
    saved with ``save_int8_model`` and served by the Predictor at batch 1
    and 8 (the main path, metered: cuDNN's convolutions and the
    fake-quant ops, no kernel of the port), every answer within
    QUANT_TOLERANCE of the f32 Predictor's; a batch-1 answer held to the
    same saved program served on the CPU within CALIB_GAP_STEPS
    quantization steps (its abs-max / 127), and every op of that program
    on the card held to the CPU's at the CPU's inputs, with two planted
    faults refused (``_int8_ops_held``). Logged: calibration seconds, the
    rounding control and a planted fault's gaps, int8 and f32 latency in
    turns."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.contrib.int8_inference import Calibrator
    from paddle_tpu_torch.core.passes.quantize_pass import QUANT_TOLERANCE
    from paddle_tpu_torch.models import resnet

    what = "Calibrator ResNet-50 (20c)"
    t0 = time.perf_counter()
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        _, _, probs = _resnet_probs(resnet)
    infer = main.clone(for_test=True)
    for op in infer.global_block().ops:
        if op.type in ("batch_norm", "dropout"):
            op.attrs["is_test"] = True
    infer._bump()
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    exe.run(startup, scope=scope)
    rs = np.random.RandomState(seed + 21)
    shared = {"img": rs.randn(CALIB_CHECK_BATCH, 3, 224, 224).astype(
        "float32")}
    blk = infer.global_block()
    logits = next(op for op in blk.ops if op.type == "softmax").input("X")[0]
    fc = [op for op in blk.ops if op.type == "mul"][-1]
    (raw,) = exe.run(infer, feed=shared, fetch_list=[logits], scope=scope)
    spread = CALIB_LOGIT_STD / float(np.std(raw))
    for n in fc.input("Y"):
        scope.set_var(n, scope.find_var(n) * spread)
    snap = _snapshot(scope)
    cpu_exe, cpu_scope = fluid.Executor(fluid.CPUPlace()), _on_cpu(snap)

    # the card's scales against the CPU lowering's, one shared batch
    gaps = {}
    for algo in ("max", "KL"):
        c_card = Calibrator(infer, scope=scope, algo=algo, bins=CALIB_BINS)
        c_card.sample_data(exe, feed=shared, fetch_list=[probs])
        c_cpu = Calibrator(infer, scope=cpu_scope, algo=algo,
                           bins=CALIB_BINS)
        c_cpu.sample_data(cpu_exe, feed=shared, fetch_list=[probs])
        a, b = c_card.scales(), c_cpu.scales()
        if sorted(a) != sorted(b) or not a:
            raise AssertionError("%s: scales of %s on the card, %s on the "
                                 "CPU" % (what, sorted(a)[:3], sorted(b)[:3]))
        departures = {}
        if algo == "max":
            gap = {n: abs(a[n] - b[n]) / abs(b[n]) for n in a}
            bound = CALIB_MAX_RTOL
        else:
            gap = {n: abs(a[n] - b[n]) / (c_cpu._hist_edge[n] / CALIB_BINS)
                   for n in a}
            bound = 1.0
            for n in a:
                if gap[n] > bound:
                    hc, hp = c_card._hist[n], c_cpu._hist[n]
                    departures[n] = 0.5 * float(np.abs(
                        hc / hc.sum() - hp / hp.sum()).sum())
                    log("%s: KL threshold of %s %.6f on the card, %.6f on "
                        "the CPU, %.2f bins apart (at most %d), the "
                        "histograms %.3e apart in total variation (at most "
                        "%.0e)" % (what, n, a[n], b[n], gap[n],
                                   CALIB_KL_BINS, departures[n], CALIB_TV))
        unexplained = {n: g for n, g in gap.items() if g > bound and not (
            g <= CALIB_KL_BINS and departures[n] <= CALIB_TV)}
        worst = max(gap, key=gap.get)
        if unexplained:
            n = max(unexplained, key=unexplained.get)
            raise AssertionError("%s: %s scale of %s %.9g on the card, %.9g "
                                 "on the CPU (%.3e of its bound)%s" % (
                                     what, algo, n, a[n], b[n],
                                     gap[n] / bound,
                                     ", %s" % departures[n]
                                     if n in departures else ""))
        gaps[algo] = dict(vars=len(a), worst=worst, gap=gap[worst],
                          bound=bound, departures=departures,
                          within=sum(g <= bound for g in gap.values()),
                          equal=sum(a[n] == b[n] for n in a))
    check_s = time.perf_counter() - t0

    # calibration proper: 4 batches of 8, KL and max
    batches = [{"img": rs.randn(CALIB_BATCH, 3, 224, 224).astype("float32")}
               for _ in range(CALIB_BATCHES)]
    cal, cal_s = {}, {}
    for algo in ("KL", "max"):
        t1 = time.perf_counter()
        c = Calibrator(infer, scope=scope, algo=algo, bins=CALIB_BINS)
        for b in batches:
            c.sample_data(exe, feed=b, fetch_list=[probs])
        c.scales()
        cal_s[algo] = time.perf_counter() - t1
        cal[algo] = c
    kl, mx = cal["KL"].scales(), cal["max"].scales()
    clipped = sum(kl[n] < mx[n] for n in kl)
    int8_dir = os.path.join(workdir, "int8")
    f32_dir = os.path.join(workdir, "f32")
    with fluid.scope_guard(scope):
        cal["KL"].save_int8_model(int8_dir, exe, ["img"], [probs])
        fluid.io.save_inference_model(f32_dir, ["img"], [probs], exe,
                                      main_program=infer)
    exe.close()
    del exe, scope
    _free()

    def predictor(d, cpu=False):
        config = fluid.inference.AnalysisConfig(d)
        if cpu:
            config.disable_gpu()
        else:
            config.warmup_batch_sizes = list(CALIB_SERVE)
        return fluid.inference.create_paddle_predictor(config)

    reqs = [{"img": rs.randn(b, 3, 224, 224).astype("float32")}
            for b in CALIB_SERVE]
    p32 = predictor(f32_dir)
    want = [p32.run(r)[0] for r in reqs]
    answers, lat_ms = [], []

    def check(b, rep, out):
        if rep == 0:
            answers.append(out)
        elif not np.array_equal(out, answers[-1]):
            raise AssertionError("%s: batch %d: a repeated request gave "
                                 "another answer" % (what, b))

    # ---- the main path: counts zeroed here, read after the last request
    p8, init_s, path = _metered_serving(
        what, lambda: predictor(int8_dir), reqs, CALIB_REPEATS,
        (0,) * len(COUNT_NAMES), lat_ms, check, buckets=list(CALIB_SERVE),
        batch_feed="img")
    # ---- end of the main path
    n_fq = [op.type for op in p8.program.global_block().ops].count(
        "fake_quantize_abs_max")
    errs = [float(np.abs(a - w).max()) for a, w in zip(answers, want)]
    for a, w, b in zip(answers, want, CALIB_SERVE):
        if a.shape != (b, IMG_CLASSES) or not np.isfinite(a).all() or \
                not np.allclose(a, w, **QUANT_TOLERANCE):
            raise AssertionError("%s: batch %d: int8 answers %s, %.4g from "
                                 "f32's" % (what, b, a.shape,
                                            float(np.abs(a - w).max())))
    # the same saved program served on the CPU, one batch-1 request: the
    # card's answer within CALIB_GAP_STEPS quantization steps of it, and
    # every op of the program on the card held to the CPU's at the CPU's
    # inputs, two planted faults refused (``_int8_ops_held``)
    t1 = time.perf_counter()
    cpu_out = predictor(int8_dir, cpu=True).run(reqs[0])[0]
    step = float(np.abs(cpu_out).max()) / 127
    cpu_gap = float(np.abs(answers[0] - cpu_out).max())
    block, ops, hscope, _, fetch = _int8_program(fluid, int8_dir)
    convs = [i for i, op in enumerate(ops) if op.type == "conv2d"]
    quants = [i for i, op in enumerate(ops)
              if op.type.startswith("fake_quantize")]
    if not convs or not quants:
        raise AssertionError("%s: the served program has %d convs and %d "
                             "fake-quant ops" % (what, len(convs),
                                                 len(quants)))
    env = _int8_env(ops, hscope, reqs[0])
    by_type, refused, planted = _int8_ops_held(
        block, ops, env, torch.device("cuda"),
        fault_at=(convs[-1], quants[-1]))
    interp_gap = float(np.abs(env[fetch[0]].numpy() - cpu_out).max())

    def moved(hook):
        e = _run_int8(block, ops, _int8_env(ops, hscope, reqs[0]), hook)
        return float(np.abs(e[fetch[0]].numpy() - cpu_out).max()) / step

    def noise(seed):
        g = torch.Generator().manual_seed(seed)

        def hook(i, op, e):
            if op.type.startswith("fake_quantize"):
                return
            for n in op.output_names():
                v = e.get(n)
                if isinstance(v, torch.Tensor) and v.is_floating_point():
                    e[n] = v * (1 + CALIB_NOISE * (
                        2 * torch.rand(v.shape, generator=g) - 1)).to(v.dtype)
        return hook

    def fault(i, op, e):
        if i == convs[-1]:
            n = op.output_names()[0]
            e[n] = e[n] * (1 + CALIB_FAULT)

    control = [moved(noise(k)) for k in CALIB_CONTROL_SEEDS]
    fault_gap = moved(fault)
    op_check_s = time.perf_counter() - t1
    op_check = dict(by_type=by_type, refused=refused, planted=planted,
                    ops=len(ops), interp_gap=interp_gap,
                    control_steps=control, fault_steps=fault_gap,
                    seconds=op_check_s)
    log("%s: the int8 program's %d ops on the card at the CPU's inputs: "
        "worst by type %s (bounds: fake-quant a share of one-level flips "
        "%.0e, else %.0e of the abs max); planted faults of %.0e %s; "
        "%.1f s" % (what, len(ops), {t: "%d x %.3e" % (r["ops"], r["worst"])
                                     for t, r in by_type.items()},
                    CALIB_FLIP_SHARE, CALIB_OP_RTOL, CALIB_FAULT,
                    ["%s %.3e %s" % (p["type"], p["how"], "refused"
                                     if p["refused"] else "PASSED")
                     for p in planted], op_check_s))
    log("%s: batch 1, the card's answer %.3f steps from the CPU's (bound "
        "%.1f; one step %.3e); the CPU's ops run in turn %.3e from its "
        "Predictor; the rounding control (every float output moved by "
        "%.1e) %s steps; one deep conv off by %.0e: %.3f steps" % (
            what, cpu_gap / step, CALIB_GAP_STEPS, step, interp_gap,
            CALIB_NOISE, ["%.3f" % c for c in control], CALIB_FAULT,
            fault_gap))
    if refused:
        raise AssertionError("%s: %d ops of the int8 program depart on the "
                             "card from the CPU at the CPU's inputs, the "
                             "first %s" % (what, len(refused), refused[0]))
    if not planted or not all(p["refused"] for p in planted):
        raise AssertionError("%s: a planted fault of %.0e passed the op "
                             "check: %s" % (what, CALIB_FAULT, planted))
    if cpu_gap > CALIB_GAP_STEPS * step:
        raise AssertionError("%s: batch 1: the card's int8 answer %.4g from "
                             "the CPU's, %.2f quantization steps of %.4g "
                             "(bound %.1f)" % (what, cpu_gap, cpu_gap / step,
                                               step, CALIB_GAP_STEPS))
    lat = {b: ([], []) for b in CALIB_SERVE}
    for i in range(CALIB_REPEATS):
        for b, r in zip(CALIB_SERVE, reqs):
            for j in ((0, 1) if i % 2 == 0 else (1, 0)):
                p = p8 if j else p32
                lat[b][j].append(_synced_ms(lambda: p.run(r)))
    med = {b: dict(f32=float(np.median(v[0])), int8=float(np.median(v[1])))
           for b, v in lat.items()}
    del p8, p32
    secs = time.perf_counter() - t0
    agree = [float((a.argmax(1) == w.argmax(1)).mean())
             for a, w in zip(answers, want)]
    out = dict(scale_check=gaps, check_s=check_s, calibrate_s=cal_s,
               logit_std_raw=float(np.std(raw)), top1_agree=agree,
               max_prob=[float(a.max()) for a in answers],
               kl_clipped=clipped, act_vars=len(kl), fake_quant_ops=n_fq,
               int8_vs_f32_err=errs, cpu_gap=cpu_gap, cpu_step=step,
               op_check=op_check,
               latency_ms={b: dict(f32=v[0], int8=v[1])
                           for b, v in lat.items()},
               latency_median_ms=med, replay_lat_ms=lat_ms, init_s=init_s,
               launches=dict(zip(COUNT_NAMES, path["launches"])),
               peak_mem_mib=path["peak_mb"], seconds=secs)
    log("%s: %d activation vars; card against CPU on %d images: max %s "
        "(worst %.3e relative, bound %.0e), KL %s, %d within one bin "
        "(worst %.3f bins; %d rounding departures); "
        "%.1f s" % (what, len(kl), CALIB_CHECK_BATCH,
                    "%d of %d equal" % (gaps["max"]["equal"],
                                        gaps["max"]["vars"]),
                    gaps["max"]["gap"], CALIB_MAX_RTOL,
                    "%d of %d equal" % (gaps["KL"]["equal"],
                                        gaps["KL"]["vars"]),
                    gaps["KL"]["within"], gaps["KL"]["gap"],
                    len(gaps["KL"]["departures"]), check_s))
    log("%s: the raw logits' std %.1f, the fc scaled to %.1f; calibrated "
        "over %d x %d images in %.1f s (KL) and %.1f s (max); KL clips %d "
        "of %d ranges below their max; %d fake-quant ops served; int8 "
        "within %s of f32 (QUANT_TOLERANCE), top-1 agreeing %s, largest "
        "probability %s; batch 1 %.3e from the CPU's (one step %.3e)" % (
            what, out["logit_std_raw"], CALIB_LOGIT_STD, CALIB_BATCHES,
            CALIB_BATCH, cal_s["KL"], cal_s["max"], clipped, len(kl), n_fq,
            ["%.3e" % e for e in errs], agree,
            ["%.3f" % v for v in out["max_prob"]], cpu_gap, step))
    log("%s: median ms in turns (%d each): %s; %.1f s" % (
        what, CALIB_REPEATS, {b: {k: round(v, 3) for k, v in m.items()}
                              for b, m in med.items()}, secs))
    return out


def _kernel_row(name, source, replaces, launches, by_path, err, t,
                library_ms, library_call_ms, amp=None):
    """One kernel's entry of the result line: ``ms`` and ``library_ms``
    are device times (torch.profiler), ``library_call_ms`` the library
    call's time from CUDA events around back-to-back calls. ``amp``:
    the same numbers of the AMP path's instantiation or inputs (phase
    3c's AMP case), where the kernel has one."""
    row = dict(name=name, ported=True, route="cuda", source=source,
               replaces=replaces, launches=launches,
               launches_by_path=by_path, max_abs_err=err, ms=t["ms"],
               plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
               bound_by=t["bound_by"], library_ms=library_ms,
               library_call_ms=library_call_ms)
    if amp is not None:
        case, err_amp, t_amp = amp
        row["amp"] = dict(case=case, max_abs_err=err_amp, **{
            k: t_amp[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                  "library_ms", "library_call_ms")})
    return row


# ------------------------------------------------------------ phase 21
# Phases 21-21d: the mesh tier (paddle_tpu_torch/parallel) at full width,
# TF32 off, f32, level 2, each model cut to MESH_DEPTH layers; every run
# on a mesh is held against the port's own single-device Executor.run of
# the same program from the same startup scope, on the card.
MESH_DEPTH = 4
MESH_STEPS = 4          # phase 21's steps a run; 21b-21d take 3
MESH_LOSS_RTOL = 1e-5   # tests/test_torch_training.py's tolerances
MESH_PARAM_ATOL = 1e-4
SP_RTOL, SP_ATOL = 2e-4, 2e-5   # tests/test_parallel_engine.py:236
# the first step's grads, ring against no mesh (21b) and pipe against
# the sequential fallback (21d), by ``_grad_gap``: a param's largest
# error over its grad's largest. At the random init these grads are sums
# of cancelling terms, so two sound f32 runs are about 1e-2 apart on
# that measure (21b: the flash kernels' run and the composed
# attention's; 21d: plain torch autograd in f32 against f64): a mesh run
# is held within GRAD_FACTOR times that control gap, taken as at least
# GRAD_FLOOR (tools/torch_mesh_grad_bounds.py reads both gaps and a
# planted fault's)
GRAD_FACTOR, GRAD_FLOOR = 4.0, 1e-5
SP_POSITIONS = 4
MOE_EXPERTS, MOE_CAPACITY_FACTOR, MOE_ATOL = 8, 1.25, 1e-6
PIPE_STAGES, PIPE_BATCH, PIPE_SEQ, PIPE_MB, PIPE_ATOL = 4, 32, 256, 8, 1e-5
PIPE_D, PIPE_DFF = 768, 3072  # GPT-2 small's widths
MESH_MNIST_STEPS = 8


def _mesh(axes, shape):
    """A mesh of ``shape`` positions, every one on the card."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.parallel.engine import make_mesh

    return make_mesh([fluid.CUDAPlace(0)] * int(np.prod(shape)), axes,
                     shape)


def _engine_step(engine, loss, fetch=()):
    """One engine step on a scope: its loss (and, with ``fetch``, those
    values as f32 tensors on the card)."""
    def step(sc, feed):
        vals = engine.run(feed, [loss, *fetch], sc, return_numpy=False)
        torch.cuda.synchronize()
        val = float(vals[0].float().reshape(()))
        return (val, vals[1:]) if fetch else val

    return step


def _mesh_run(what, step, snap, batches, n_steps, per_step, params):
    """``n_steps`` steps of ``step`` on a scope restored from ``snap``
    under the launch meter (``_metered_steps``: the counts zeroed just
    before, every step's launches on the card ``per_step``): the metered
    path, the params after the steps and the scope."""
    scope = _restored(snap)
    path = _metered_steps(what, step, scope, batches, n_steps, per_step)
    return path, {n: scope.find_var(n).clone() for n in params}, scope


def _held(what, ref, ref_p, got, got_p, rtol, atol):
    """The run ``got`` held to ``ref``: its losses within ``rtol`` of
    the reference's (an absolute bound besides where ``rtol`` is a
    pair), its params within ``atol`` after the steps (not held where
    ``atol`` is None: Adam turns a grad's rounding near 0 into an
    lr-sized move). Returns the errors and whether both were bitwise."""
    rt, at = rtol if isinstance(rtol, tuple) else (rtol, 0.0)
    a, b = np.asarray(got["losses"]), np.asarray(ref["losses"])
    loss_err = float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)))
    ok = np.all(np.abs(a - b) <= at + rt * np.abs(b))
    p_err = max(float((got_p[n] - ref_p[n]).abs().max()) for n in ref_p)
    if not ok or (atol is not None and p_err > atol):
        raise AssertionError(
            "%s: losses %s against %s (rel err %.3e, bound %s), params off "
            "by %.3e (bound %g)" % (what, list(a), list(b), loss_err, rtol,
                                    p_err, atol))
    return dict(loss_rel_err=loss_err, param_max_abs=p_err,
                bitwise=bool(np.array_equal(a, b)) and p_err == 0.0)


def _first_grads(run, snap, feed, params):
    """The grads of ``params`` in one step from a scope restored from
    ``snap`` on ``feed``, as f32 tensors: ``run(scope, feed, names)``
    returns the fetched values (``_exe_fetch``, ``_engine_fetch``)."""
    vals = run(_restored(snap), feed, [p + "@GRAD" for p in params])
    torch.cuda.synchronize()
    return {p: v.float() for p, v in zip(params, vals)}


def _composed_grads(main, snap, feed, params):
    """The first step's grads of ``params`` without a mesh, every
    attention composed (the flash kernels' plain version) on a fresh
    executor: a second sound run beside the flash kernels' one."""
    import paddle_tpu_torch as fluid

    was = os.environ.get("PADDLE_TPU_FLASH_MIN_SEQ")
    os.environ["PADDLE_TPU_FLASH_MIN_SEQ"] = str(1 << 30)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    try:
        return _first_grads(_exe_fetch(exe, main), snap, feed, params)
    finally:
        exe.close()
        if was is None:
            del os.environ["PADDLE_TPU_FLASH_MIN_SEQ"]
        else:
            os.environ["PADDLE_TPU_FLASH_MIN_SEQ"] = was


def _pipe_control(snap, feed, params):
    """The gap (``_grad_gap``) between the first step's grads of
    ``_pipe_program``'s stages (no dropout) from ``snap`` on ``feed`` by
    plain torch autograd in f32 and in f64: the f32 rounding the step
    allows a sound run."""
    n, d, f = PIPE_STAGES, PIPE_D, PIPE_DFF
    roles = {(n, d, f): "w1", (n, f): "b1", (n, f, d): "w2", (n, d): "b2"}

    def grads(dtype):
        ps = {p: snap[p].detach().to(dtype, copy=True).requires_grad_()
              for p in params}
        w = {roles[tuple(t.shape)]: t for t in ps.values()}
        dev = snap[params[0]].device
        h, y = (torch.as_tensor(feed[k], device=dev, dtype=dtype)
                for k in ("x", "y"))
        for i in range(n):
            h = h + torch.relu(h @ w["w1"][i] + w["b1"][i]) @ w["w2"][i] \
                + w["b2"][i]
        loss = torch.mean((h - y) ** 2)
        return dict(zip(ps, torch.autograd.grad(loss, list(ps.values()))))

    return _grad_gap(grads(torch.float64), grads(torch.float32))


def _exe_fetch(exe, main):
    return lambda sc, feed, names: exe.run(
        main, feed=feed, fetch_list=names, scope=sc, return_numpy=False)


def _engine_fetch(engine):
    return lambda sc, feed, names: engine.run(feed, names, sc,
                                              return_numpy=False)


def _grad_gap(ref, got):
    """Each param's largest grad error over its grad's largest magnitude:
    (the largest, its param)."""
    errs = {p: float((got[p] - r).abs().max() / r.abs().max().clamp_min(
        1e-30)) for p, r in ref.items()}
    worst = max(errs, key=errs.get)
    return errs[worst], worst


def _grads_held(what, ref, got, rtol):
    """The first step's grads ``got`` held to ``ref`` (``_grad_gap``)
    within ``rtol``. Returns the gap, its param and the bound."""
    err, worst = _grad_gap(ref, got)
    if not err <= rtol:
        raise AssertionError(
            "%s: the first step's grads off the reference's by %.3e of "
            "their largest (%s; bound %g)" % (what, err, worst, rtol))
    return dict(grad_rel_err=err, grad_worst=worst, grad_bound=rtol,
                grads_bitwise=all(torch.equal(got[p], r)
                                  for p, r in ref.items()))


def _replayed_ms(path):
    return float(np.median(path["step_ms"][2:]))


def phase_mesh_dp_tp(seed):
    """Phase 21: BERT-base MLM at its widths (768, 12 heads, S = 512,
    batch 8) cut to 4 layers, Adam at level 2, from one startup scope:
    MESH_STEPS steps of ``Executor.run`` (the reference), of
    ``CompiledProgram(main).with_data_parallel(loss_name)`` over a (data
    4) mesh on the card through ``Executor.run``, and of a
    ``ParallelEngine`` over (data 2, model 2) with the FFN weights split
    megatron-style (``ffn1`` by columns, ``ffn2`` by rows, as
    examples/train_multichip.py writes them) and ZeRO-1. Each held to
    the reference (losses 1e-5 relative, params 1e-4 after the steps;
    bitwise where the log says so); every step launches the flash
    kernels 8/4/4, K4 9 and K6 once on the card (counted). Then
    ``contrib.Trainer(parallel=True)`` on recognize_digits for
    MESH_MNIST_STEPS steps, its losses those of ``parallel=False``."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.parallel import ParallelEngine, ShardingRules
    from paddle_tpu_torch.parallel.mesh import P

    what = "BERT-base, 4 layers, on a mesh (21)"
    t0 = time.perf_counter()
    card = fluid.CUDAPlace(0)
    cfg = dict(bert.base_config(), n_layer=MESH_DEPTH)
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        loss, _ = bert.build(cfg, seq_len=SEQ, max_mask=MAX_MASK)
        fluid.optimizer.Adam(learning_rate=TRAIN_LR).minimize(loss)
    exe, scope = fluid.Executor(card), fluid.Scope()
    exe.run(startup, scope=scope)
    params = [p.name for p in main.global_block().all_parameters()]
    snap = _snapshot(scope)
    rs = np.random.RandomState(seed)
    batches = [_train_batch(cfg, rs) for _ in range(MESH_STEPS)]
    n = MESH_DEPTH
    per_step = (2 * n, n, n, 2 * n + 1, 1, 0, 0, 0, 0, 0)

    ref, ref_p, _ = _mesh_run(what + " single", _amp_step_fn(exe, main, loss),
                              snap, batches, MESH_STEPS, per_step, params)
    exe.close()
    compiled = fluid.CompiledProgram(main).with_data_parallel(
        loss_name=loss.name, places=[card] * 4)
    exe_c = fluid.Executor(card)
    # ---- the main path (data parallel): counts zeroed in _metered_steps
    dp, dp_p, _ = _mesh_run(what + " data 4", _amp_step_fn(
        exe_c, compiled, loss), snap, batches, MESH_STEPS, per_step, params)
    eng = compiled._engine
    if eng.mesh.shape != {"data": 4} or \
            eng.mesh.device != card.torch_device():
        raise AssertionError("%s: CompiledProgram ran on %r" % (what,
                                                                 eng.mesh))
    dp_held = _held(what + " data 4", ref, ref_p, dp, dp_p, MESH_LOSS_RTOL,
                    MESH_PARAM_ATOL)
    eng._exe.close()

    rules = ShardingRules([(r"^enc_\d+_ffn1\.w_0$", P(None, "model")),
                           (r"^enc_\d+_ffn2\.w_0$", P("model", None))],
                          zero1=True)
    tp_eng = ParallelEngine(main, loss.name,
                            mesh=_mesh(("data", "model"), (2, 2)),
                            rules=rules)
    # ---- the main path (data x tensor parallel, ZeRO-1)
    tp, tp_p, tp_scope = _mesh_run(what + " data 2 x model 2", _engine_step(
        tp_eng, loss), snap, batches, MESH_STEPS, per_step, params)
    tp_held = _held(what + " data 2 x model 2", ref, ref_p, tp, tp_p,
                    MESH_LOSS_RTOL, MESH_PARAM_ATOL)
    specs = next(iter(tp_eng._cache.values())).state_specs
    want = {"enc_0_ffn1.w_0": P(None, "model"),
            "enc_0_ffn2.w_0": P("model", None),
            "enc_0_ffn1.w_0_moment1_0": P("data"),
            "enc_0_ffn1.w_0_beta1_pow_0": P(), "word_embedding": P()}
    got_specs = {k: specs.get(k) for k in want}
    view = tp_eng.shard("enc_0_ffn1.w_0", {"data": 1, "model": 1}, tp_scope)
    half = cfg["d_ff"] // 2
    if got_specs != want or tuple(view.shape) != (cfg["d_model"], half) or \
            view.data_ptr() != tp_scope.find_var(
                "enc_0_ffn1.w_0")[:, half:].data_ptr():
        raise AssertionError("%s: the rules placed %s (want %s); a shard "
                             "%s" % (what, got_specs, want,
                                     tuple(view.shape)))
    tp_eng._exe.close()

    trainer = _mesh_trainer(seed)
    secs = time.perf_counter() - t0
    out = dict(launches=dict(zip(COUNT_NAMES, dp["launches"])),
               tp_launches=dict(zip(COUNT_NAMES, tp["launches"])),
               per_step=dict(zip(COUNT_NAMES, per_step)),
               losses=dict(single=ref["losses"], dp=dp["losses"],
                           tp=tp["losses"]),
               held=dict(dp=dp_held, tp=tp_held),
               replayed_ms=dict(single=_replayed_ms(ref),
                                dp=_replayed_ms(dp), tp=_replayed_ms(tp)),
               specs={k: str(v) for k, v in got_specs.items()},
               trainer=trainer, seconds=secs)
    log("%s: a step launches %s = %s on the card in each run; replayed "
        "step %.3f ms single, %.3f on (data 4) through CompiledProgram, "
        "%.3f on (data 2, model 2) with megatron FFN rules and ZeRO-1; "
        "losses %s; data 4 %s (loss rel %.3e, params %.3e), data x model "
        "%s (loss rel %.3e, params %.3e); Trainer(parallel=True) on "
        "recognize_digits over %d positions: %d losses %s parallel=False's "
        "(%.1f s)" % (
            what, COUNT_NAMES[:5], per_step[:5], out["replayed_ms"]["single"],
            out["replayed_ms"]["dp"], out["replayed_ms"]["tp"],
            ["%.6f" % v for v in ref["losses"]],
            "bitwise" if dp_held["bitwise"] else "held",
            dp_held["loss_rel_err"], dp_held["param_max_abs"],
            "bitwise" if tp_held["bitwise"] else "held",
            tp_held["loss_rel_err"], tp_held["param_max_abs"],
            trainer["positions"], trainer["steps"],
            "bitwise" if trainer["bitwise"] else "within 1e-5 of", secs))
    return out


def _mesh_trainer(seed):
    """``contrib.Trainer`` on recognize_digits (phase 20's network) for
    MESH_MNIST_STEPS steps with ``parallel=True`` (CompiledProgram over
    the card's positions) and ``parallel=False``, from one seed: the
    losses held to each other within 1e-5 relative."""
    import itertools

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.contrib import EndStepEvent, Trainer
    from paddle_tpu_torch.models import mnist

    def train_func():
        fluid.default_main_program().random_seed = seed
        fluid.default_startup_program().random_seed = seed
        lo, ac, _ = mnist.build("cnn")
        return [lo, ac]

    batches = fluid.batch(fluid.reader.map_readers(
        lambda s: (s[0], np.array([s[1]], "int64")),
        fluid.dataset.mnist.train()), MNIST_BATCH)

    def reader():
        return itertools.islice(batches(), MESH_MNIST_STEPS)

    losses, positions = {}, None
    for parallel in (False, True):
        got = []
        t = Trainer(train_func,
                    lambda: fluid.optimizer.Adam(learning_rate=MNIST_LR),
                    place=fluid.CUDAPlace(0), parallel=parallel)
        t.train(1, lambda e: isinstance(e, EndStepEvent) and
                got.append(_loss(e.metrics)), reader, ["img", "label"])
        if parallel:
            positions = t._compiled._engine.device_count
            t._compiled._engine._exe.close()
        t.exe.close()
        losses[parallel] = got
    a, b = np.asarray(losses[True]), np.asarray(losses[False])
    if len(a) != MESH_MNIST_STEPS or not np.allclose(a, b, rtol=1e-5,
                                                      atol=0):
        raise AssertionError("Trainer(parallel=True) (21): losses %s "
                             "against parallel=False's %s" % (a, b))
    return dict(steps=len(a), positions=positions, losses=list(a),
                bitwise=bool(np.array_equal(a, b)))


def _gpt_mesh_program(seed, packed=False):
    """GPT-2 small at its widths cut to MESH_DEPTH layers (dropout 0.1,
    as the model's config), Adam at level 2, started on the card:
    (exe, scope, main, loss, params, feed names)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import gpt

    cfg = dict(gpt.base_config(), n_layer=MESH_DEPTH)
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        loss, feeds = gpt.build(cfg, seq_len=GPT_SEQ, packed=packed)
        fluid.optimizer.Adam(learning_rate=TRAIN_LR).minimize(loss)
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    exe.run(startup, scope=scope)
    params = [p.name for p in main.global_block().all_parameters()]
    return exe, scope, main, loss, params, feeds, cfg


def _ring_lines(eng, feed, loss, scope):
    txt = eng.lowered_collectives(feed, [loss], scope)
    return [ln for ln in txt.splitlines() if ln.startswith("ring_ppermute")]


def phase_mesh_sp(seed):
    """Phase 21b: GPT-2 small at its widths (768, 12 heads, S = 1024,
    batch 8) cut to 4 layers, Adam, dropout 0.1, level 2: 3 steps on a
    (seq 4) mesh, every causal ``fused_attention`` riding the zigzag
    ring (the ids split over ``seq``), against 3 ``Executor.run`` steps
    without a mesh, losses within 2e-4 relative + 2e-5, and the first
    step's grads (``_grad_gap``) within GRAD_FACTOR times the gap
    between two sound runs without a mesh, the flash kernels' and the
    composed attention's (the params' distance logged). A ring step
    batches every position's chunk pairs into one K1
    launch (5 a ring of 4: the first step's diagonal pairs are causal),
    so a step launches K1 40 times (each layer's forward and its grad's
    re-run), K2 and K3 20 each (the no-mesh step: 8, 4, 4), K4 8 and K6
    once, counted; no composed attention runs. Then a packed batch
    (``reader.pack_sequences``, segment ids riding the ring as id
    vectors) the same way, 2 steps."""
    from paddle_tpu_torch import reader
    from paddle_tpu_torch.parallel import ParallelEngine, ShardingRules
    from paddle_tpu_torch.parallel.mesh import P

    what = "GPT-2 small, 4 layers, on (seq 4) (21b)"
    t0 = time.perf_counter()
    n, r = MESH_DEPTH, SP_POSITIONS
    launches = r + 1  # a zigzag ring's K1 launches
    plain = (2 * n, n, n, 2 * n, 1, 0, 0, 0, 0, 0)
    ring = (2 * n * launches, n * launches, n * launches, 2 * n, 1, 0, 0, 0,
            0, 0)
    runs = {}
    for packed in (False, True):
        exe, scope, main, loss, params, feeds, cfg = _gpt_mesh_program(
            seed, packed)
        snap = _snapshot(scope)
        rs = np.random.RandomState(seed + 8)
        if packed:
            docs = [list(rs.randint(1, cfg["vocab"], rs.randint(
                GPT_SEQ // 16, GPT_SEQ // 2))) for _ in range(2 * GPT_BATCH)]
            batches = [reader.pack_sequences(docs, seq_len=GPT_SEQ,
                                             n_rows=GPT_BATCH)]
            steps = 2
        else:
            batches = [_gpt_batch(cfg["vocab"], rs) for _ in range(3)]
            steps = 3
        kind = "packed" if packed else "padded"
        ref, ref_p, _ = _mesh_run("%s %s, no mesh" % (what, kind),
                                  _amp_step_fn(exe, main, loss), snap,
                                  batches, steps, plain, params)
        ref_g = _first_grads(_exe_fetch(exe, main), snap, batches[0], params)
        exe.close()
        control = _grad_gap(ref_g, _composed_grads(main, snap, batches[0],
                                                   params))
        eng = ParallelEngine(main, loss.name, mesh=_mesh(("seq",), (r,)),
                             rules=ShardingRules(feed_rules=[(
                                 "^(%s)$" % "|".join(feeds),
                                 P(None, "seq"))]))
        # ---- the main path: counts zeroed in _metered_steps
        with _ComposedAttention() as composed:
            sp, sp_p, sp_scope = _mesh_run(
                "%s %s" % (what, kind), _engine_step(eng, loss), snap,
                batches, steps, ring, params)
        if composed.calls:
            raise AssertionError("%s: the composed attention ran %d times"
                                 % (what, composed.calls))
        held = _held("%s %s" % (what, kind), ref, ref_p, sp, sp_p,
                     (SP_RTOL, SP_ATOL), None)
        held.update(_grads_held("%s %s" % (what, kind), ref_g, _first_grads(
            _engine_fetch(eng), snap, batches[0], params),
            GRAD_FACTOR * max(control[0], GRAD_FLOOR)))
        held.update(grad_control=control[0], grad_control_worst=control[1])
        lines = _ring_lines(eng, batches[0], loss, sp_scope)
        if len(lines) != 2 * n or not all(
                "positions=%d" % r in ln and "schedule=zigzag" in ln
                and "flash=True" in ln for ln in lines):
            raise AssertionError("%s: the plan's rings %s" % (what, lines))
        runs[kind] = dict(ref=ref, sp=sp, held=held, rings=len(lines))
        eng._exe.close()
        del exe, scope, snap, eng
        _free()
    secs = time.perf_counter() - t0
    padded = runs["padded"]
    out = dict(launches=dict(zip(COUNT_NAMES, padded["sp"]["launches"])),
               packed_launches=dict(zip(COUNT_NAMES,
                                        runs["packed"]["sp"]["launches"])),
               per_step=dict(zip(COUNT_NAMES, ring)),
               no_mesh_per_step=dict(zip(COUNT_NAMES, plain)),
               ring_ppermute=padded["rings"],
               held={k: v["held"] for k, v in runs.items()},
               losses={k: dict(no_mesh=v["ref"]["losses"],
                               seq=v["sp"]["losses"])
                       for k, v in runs.items()},
               replayed_ms={k: dict(no_mesh=_replayed_ms(v["ref"]),
                                    seq=_replayed_ms(v["sp"]))
                            for k, v in runs.items() if k == "padded"},
               seconds=secs)
    log("%s: a step launches %s = %s on the card (no mesh: %s), %d "
        "ring_ppermute collectives a step; replayed step %.3f ms on the "
        "ring, %.3f ms without a mesh; losses %s against %s (rel %.3e, "
        "first grads %.3e of their largest (%s; composed attention "
        "without a mesh %.3e (%s)), params %.3e); packed with segment "
        "ids: rel %.3e, first grads %.3e (%s; composed %.3e (%s)), params "
        "%.3e (%.1f s)" % (
            what, COUNT_NAMES[:5], ring[:5], plain[:5], padded["rings"],
            out["replayed_ms"]["padded"]["seq"],
            out["replayed_ms"]["padded"]["no_mesh"],
            ["%.6f" % v for v in padded["sp"]["losses"]],
            ["%.6f" % v for v in padded["ref"]["losses"]],
            *[runs[k]["held"][f] for k in ("padded", "packed") for f in (
                "loss_rel_err", "grad_rel_err", "grad_worst", "grad_control",
                "grad_control_worst", "param_max_abs")], secs))
    return out


def _switch_program(seed, top_k):
    """A Switch-style stack (Switch Transformer's switch-base-8 layout):
    GPT-2 small's widths, MESH_DEPTH layers of causal self-attention,
    ``layers.moe_ffn`` (8 experts of d_ff 3072, top-k, capacity factor
    1.25) in place of every other FFN, an LM head over the ids, loss
    the mean cross entropy plus 0.01 times the aux losses; Adam, level
    2, started on the card: (exe, scope, main, loss, params, fetches
    (the aux losses, the first MoE layer's input and output), cfg)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import layers
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.models.transformer import (_ffn, _pad_bias,
                                                     _prenorm,
                                                     multi_head_attention)

    cfg = dict(gpt.base_config(), n_layer=MESH_DEPTH, dropout=0.0)
    d, T = cfg["d_model"], GPT_BATCH * GPT_SEQ
    capacity = int(np.ceil(MOE_CAPACITY_FACTOR * T * top_k / MOE_EXPERTS))
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    auxes, moe_io = [], []

    def moe(h):
        out, aux = layers.moe_ffn(h, MOE_EXPERTS, cfg["d_ff"],
                                  capacity=capacity, top_k=top_k)
        auxes.append(aux)
        moe_io.append((h, out))
        return out

    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        ids = layers.data("ids", [GPT_SEQ], dtype="int64")
        bias = _pad_bias(ids)
        x = layers.elementwise_add(
            layers.embedding(ids, [cfg["vocab"], d]),
            layers.embedding(layers.reshape(layers.range(
                0, GPT_SEQ, 1, "int64"), [1, GPT_SEQ]),
                [cfg["max_length"], d]))
        for i in range(MESH_DEPTH):
            nm = "switch_%d" % i
            x = _prenorm(x, lambda h, nm=nm: multi_head_attention(
                h, h, bias, d, cfg["n_head"], 0.0, False, nm + "_att",
                True, causal=True), 0.0, False, nm + "_pre1")
            ffn = moe if i % 2 else (lambda h, nm=nm: _ffn(
                h, d, cfg["d_ff"], nm))
            x = _prenorm(x, ffn, 0.0, False, nm + "_pre2")
        logits = layers.fc(layers.layer_norm(x, begin_norm_axis=2),
                           cfg["vocab"], num_flatten_dims=2)
        cost = layers.mean(layers.softmax_with_cross_entropy(
            logits, layers.reshape(ids, [-1, GPT_SEQ, 1])))
        loss = layers.elementwise_add(cost, layers.scale(
            layers.sums(auxes), scale=0.01))
        fluid.optimizer.Adam(learning_rate=TRAIN_LR).minimize(loss)
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    exe.run(startup, scope=scope)
    params = [p.name for p in main.global_block().all_parameters()]
    fetches = list(auxes) + list(moe_io[0])
    return exe, scope, main, loss, params, fetches, capacity, cfg


def _every_expert(x, w1, b1, w2, b2, gate_w, capacity, top_k):
    """The JAX package's single-device ``moe_ffn`` formula (every expert
    on every token, the outputs selected by routing), in torch: the
    plain reference of the port's lowering, which runs each expert on
    its capacity rows only."""
    from paddle_tpu_torch.parallel.moe import route_tokens

    expert_idx, gate, _pos, keep, _aux = route_tokens(
        x, gate_w, MOE_EXPERTS, capacity, top_k)
    out = torch.zeros_like(x)
    for e in range(MOE_EXPERTS):
        y = torch.relu(x @ w1[e] + b1[e]) @ w2[e] + b2[e]
        for kk in range(top_k):
            sel = ((expert_idx[kk] == e) & keep[kk])[:, None]
            out = out + torch.where(sel, y * gate[kk][:, None], 0.0)
    return out


def phase_mesh_experts(seed):
    """Phase 21c: the Switch-style stack (``_switch_program``) top-1 and
    top-2, 3 steps each on an (expert 8) mesh (each expert at its
    position computes the capacity rows routed to it; one all_gather)
    against the run without a mesh, from one startup scope: the routing
    of the first MoE layer's input bitwise (expert index, slot position,
    keep mask), its output and the losses within 1e-6 (relative for the
    losses), the aux losses within 1e-6; that output within 1e-6 of the
    every-expert formula (``_every_expert``) on the same input; the
    expert params placed P('expert'). Counted: K1 8, K2 4, K3 4, K4
    (what level 2 fuses) and K6 1 a step, on both runs."""
    from paddle_tpu_torch.parallel import ParallelEngine
    from paddle_tpu_torch.parallel.mesh import P
    from paddle_tpu_torch.parallel.moe import route_tokens

    what = "Switch stack, 4 layers (21c)"
    t0 = time.perf_counter()
    out = dict(runs={})
    n = MESH_DEPTH
    for top_k in (1, 2):
        exe, scope, main, loss, params, fetches, capacity, cfg = \
            _switch_program(seed, top_k)
        tier = _tier_stats(main, [loss.name], scope)
        per_step = (2 * n, n, n, tier["ln_residual_fused"], 1, 0, 0, 0, 0, 0)
        snap = _snapshot(scope)
        rs = np.random.RandomState(seed + 21)
        batches = [_gpt_batch(cfg["vocab"], rs) for _ in range(3)]
        eng = ParallelEngine(main, loss.name,
                             mesh=_mesh(("expert",), (MOE_EXPERTS,)))
        vals = {}
        paths = {}
        for kind, step in (("no_mesh", _amp_step_fn(exe, main, loss)),
                           ("expert", _engine_step(eng, loss))):
            # ---- the main path (the expert one): counts zeroed inside
            paths[kind], _, sc = _mesh_run(
                "%s top-%d %s" % (what, top_k, kind), step, snap, batches,
                3, per_step, params)
            # the first step's MoE values, from the snapshot again
            first = _restored(snap)
            if kind == "no_mesh":
                got = exe.run(main, feed=batches[0], fetch_list=fetches,
                              scope=first, return_numpy=False)
            else:
                got = eng.run(batches[0], fetches, first,
                              return_numpy=False)
            vals[kind] = [g.float() for g in got]
        moe_op = next(op for op in main.global_block().ops
                      if op.type == "moe_ffn")
        w1, b1, w2, b2, g = (snap[moe_op.input(k)[0]] for k in (
            "W1", "B1", "W2", "B2", "Gate"))
        x_in = {k: v[-2].reshape(-1, cfg["d_model"])
                for k, v in vals.items()}
        routes = {k: route_tokens(x, g, MOE_EXPERTS, capacity, top_k)
                  for k, x in x_in.items()}
        same_route = all(torch.equal(a, b) for a, b in zip(
            [routes["no_mesh"][i] for i in (0, 2, 3)],
            [routes["expert"][i] for i in (0, 2, 3)]))
        out_err = float((vals["expert"][-1] - vals["no_mesh"][-1]).abs()
                        .max())
        want = _every_expert(x_in["expert"], w1, b1, w2, b2, g, capacity,
                             top_k)
        ref_err = float((vals["expert"][-1].reshape(want.shape) - want)
                        .abs().max())
        aux_err = max(abs(float(a) - float(b)) for a, b in zip(
            vals["expert"][:-2], vals["no_mesh"][:-2]))
        la = np.asarray(paths["expert"]["losses"])
        lb = np.asarray(paths["no_mesh"]["losses"])
        loss_err = float(np.max(np.abs(la - lb) / np.abs(lb)))
        specs = next(iter(eng._cache.values())).state_specs
        placed = all(specs[p] == P("expert") for p in main._expert_params)
        kept = int(routes["expert"][3].sum())
        if not (same_route and torch.equal(x_in["no_mesh"], x_in["expert"])
                ) or out_err > MOE_ATOL or aux_err > MOE_ATOL or \
                loss_err > MOE_ATOL or ref_err > MOE_ATOL or not placed:
            raise AssertionError(
                "%s top-%d: routing the same %s, inputs bitwise %s, output "
                "off by %.3e, aux by %.3e, losses by %.3e, the output off "
                "the every-expert formula by %.3e (bound %g); expert params "
                "placed %s" % (
                    what, top_k, same_route,
                    torch.equal(x_in["no_mesh"], x_in["expert"]), out_err,
                    aux_err, loss_err, ref_err, MOE_ATOL, placed))
        out["runs"]["top%d" % top_k] = dict(
            capacity=capacity, kept=kept, choices=top_k * GPT_BATCH * GPT_SEQ,
            output_max_abs=out_err, aux_max_abs=aux_err,
            loss_rel_err=loss_err, every_expert_max_abs=ref_err,
            bitwise=bool(out_err == 0.0 and loss_err == 0.0),
            losses=dict(no_mesh=list(lb), expert=list(la)),
            replayed_ms=dict(no_mesh=_replayed_ms(paths["no_mesh"]),
                             expert=_replayed_ms(paths["expert"])),
            launches=dict(zip(COUNT_NAMES, paths["expert"]["launches"])))
        exe.close()
        eng._exe.close()
        del exe, scope, snap, eng, vals, paths, want, w1, b1, w2, b2, g
        _free()
    out["launches"] = {
        c: sum(r["launches"][c] for r in out["runs"].values())
        for c in COUNT_NAMES}
    out["seconds"] = time.perf_counter() - t0
    for k, r in out["runs"].items():
        log("%s %s: capacity %d, %d of %d choices kept; routing bitwise on "
            "both runs, the MoE output off by %.3e, aux by %.3e, losses by "
            "%.3e (%s); the output %.3e off the every-expert formula; "
            "replayed step %.3f ms on (expert 8), %.3f without a mesh" % (
                what, k, r["capacity"], r["kept"], r["choices"],
                r["output_max_abs"], r["aux_max_abs"], r["loss_rel_err"],
                "bitwise" if r["bitwise"] else "within 1e-6",
                r["every_expert_max_abs"], r["replayed_ms"]["expert"],
                r["replayed_ms"]["no_mesh"]))
    return out


def _pipe_program(seed, dropout):
    """``layers.pipeline`` of PIPE_STAGES stages, each a GPT-width MLP
    block with a residual (768 -> 3072 -> relu -> 768, + x; dropout 0.1
    after the relu with ``dropout``), PIPE_MB microbatches, on [batch,
    PIPE_SEQ, 768] activations, an MSE loss, Adam, level 2, started on
    the card: (exe, scope, main, loss, params)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import layers

    d, dff = PIPE_D, PIPE_DFF

    def stage(pb, h):
        w1, b1 = pb.param([d, dff]), pb.param([dff], is_bias=True)
        w2, b2 = pb.param([dff, d]), pb.param([d], is_bias=True)
        u = layers.relu(layers.elementwise_add(layers.matmul(h, w1), b1))
        if dropout:
            u = layers.dropout(u, dropout_prob=0.1)
        return layers.elementwise_add(
            h, layers.elementwise_add(layers.matmul(u, w2), b2))

    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = layers.data("x", [PIPE_SEQ, d])
        y = layers.data("y", [PIPE_SEQ, d])
        h = layers.pipeline(x, n_stages=PIPE_STAGES, stage_fn=stage,
                            n_microbatches=PIPE_MB)
        loss = layers.mean(layers.square(layers.elementwise_sub(h, y)))
        fluid.optimizer.Adam(learning_rate=TRAIN_LR).minimize(loss)
    exe, scope = fluid.Executor(fluid.CUDAPlace(0)), fluid.Scope()
    exe.run(startup, scope=scope)
    params = [p.name for p in main.global_block().all_parameters()]
    return exe, scope, main, loss, params


def phase_mesh_pipeline(seed):
    """Phase 21d: ``layers.pipeline`` (``_pipe_program``: 4 GPT-width MLP
    stages, batch 32 of 256 positions, 8 microbatches) trained 3 Adam
    steps on a (pipe 4) and a (data 2, pipe 4) mesh and on the
    sequential fallback, from one startup scope: without dropout the
    meshes' losses within 1e-5 relative and the first step's grads
    (``_grad_gap``) within GRAD_FACTOR times the gap between plain torch
    autograd's f32 and f64 grads of the same step (``_pipe_control``)
    from the fallback's (the params' distance after the steps logged:
    Adam's steps move a param whose grad rounds apart near 0 by up to
    the learning rate); with dropout
    (each (stage, microbatch) on its folded chain) both meshes bitwise
    the fallback, grads too; the stacked params placed P('pipe'); K6
    once a step (counted)."""
    from paddle_tpu_torch.parallel import ParallelEngine
    from paddle_tpu_torch.parallel.mesh import P

    what = "pipeline, 4 stages (21d)"
    t0 = time.perf_counter()
    rs = np.random.RandomState(seed + 4)
    shape = (PIPE_BATCH, PIPE_SEQ, PIPE_D)
    batches = [{"x": rs.randn(*shape).astype("float32"),
                "y": rs.randn(*shape).astype("float32")} for _ in range(3)]
    out = dict(runs={})
    control = None
    for dropout in (False, True):
        exe, scope, main, loss, params = _pipe_program(seed, dropout)
        tier = _tier_stats(main, [loss.name], scope)
        if tier["optimizer_groups"] != [len(params)]:
            raise AssertionError("%s: level 2 made optimizer groups %s of "
                                 "%d params" % (what,
                                                tier["optimizer_groups"],
                                                len(params)))
        per_step = (0, 0, 0, 0, 1, 0, 0, 0, 0, 0)
        snap = _snapshot(scope)
        kind = "dropout" if dropout else "plain"
        ref, ref_p, _ = _mesh_run("%s %s sequential" % (what, kind),
                                  _amp_step_fn(exe, main, loss), snap,
                                  batches, 3, per_step, params)
        ref_g = _first_grads(_exe_fetch(exe, main), snap, batches[0], params)
        exe.close()
        if control is None:
            control = _pipe_control(snap, batches[0], params)
            out["grad_control"], out["grad_control_worst"] = control
        runs = dict(sequential=dict(losses=ref["losses"],
                                    replayed_ms=_replayed_ms(ref)))
        for axes, shape in ((("pipe",), (PIPE_STAGES,)),
                            (("data", "pipe"), (2, PIPE_STAGES))):
            name = " x ".join("%s %d" % a for a in zip(axes, shape))
            eng = ParallelEngine(main, loss.name, mesh=_mesh(axes, shape))
            # ---- the main path: counts zeroed in _metered_steps
            got, got_p, sc = _mesh_run("%s %s on (%s)" % (what, kind, name),
                                       _engine_step(eng, loss), snap,
                                       batches, 3, per_step, params)
            held = _held("%s %s on (%s)" % (what, kind, name), ref, ref_p,
                         got, got_p, PIPE_ATOL, None)
            held.update(_grads_held(
                "%s %s on (%s)" % (what, kind, name), ref_g, _first_grads(
                    _engine_fetch(eng), snap, batches[0], params),
                GRAD_FACTOR * max(control[0], GRAD_FLOOR)))
            if dropout and not (held["bitwise"] and held["grads_bitwise"]):
                raise AssertionError("%s: with dropout (%s) is not bitwise "
                                     "the sequential fallback: %s" % (
                                         what, name, held))
            specs = next(iter(eng._cache.values())).state_specs
            if not all(specs[p] == P("pipe") for p in main._pipeline_params):
                raise AssertionError("%s: stacked params placed %s" % (
                    what, {p: specs[p] for p in main._pipeline_params}))
            txt = eng.lowered_collectives(batches[0], [loss], sc)
            runs[name] = dict(held=held, losses=got["losses"],
                              replayed_ms=_replayed_ms(got),
                              launches=dict(zip(COUNT_NAMES,
                                                got["launches"])),
                              collectives=txt.splitlines()[1:])
            eng._exe.close()
        out["runs"][kind] = runs
        del exe, scope, snap
        _free()
    out["launches"] = {c: sum(r["launches"][c] for k in out["runs"].values()
                              for r in k.values() if "launches" in r)
                       for c in COUNT_NAMES}
    out["seconds"] = time.perf_counter() - t0
    for kind, runs in out["runs"].items():
        log("%s %s: replayed step %s ms; plain torch's f32 grads %.3e of "
            "their largest off its f64 ones (%s); %s" % (
            what, kind, {k: round(v["replayed_ms"], 3)
                         for k, v in runs.items()}, out["grad_control"],
            out["grad_control_worst"],
            {k: ("bitwise" if v["held"]["bitwise"] else
                 "loss rel %.3e, first grads %.3e of their largest (%s), "
                 "params %.3e" % (
                     v["held"]["loss_rel_err"], v["held"]["grad_rel_err"],
                     v["held"]["grad_worst"], v["held"]["param_max_abs"]))
             for k, v in runs.items() if "held" in v}))
    return out


def _free():
    """Between phases: collect what a phase left in reference cycles (its
    executors, whose graphs hold memory pools), then hand the caching
    allocator's free blocks back to the card."""
    gc.collect()
    torch.cuda.empty_cache()


# the phases ``--phases`` selects from, in run order, each with the
# phases whose results it takes (1, the card, and 2, the build, always
# run)
PHASES = (
    ("3", ()), ("3b", ()), ("3c", ()), ("3d", ()),
    ("4", ()), ("4c", ("4",)), ("5", ("4",)), ("12e", ("4",)),
    ("4b", ("4",)),
    ("6", ()), ("6b", ("6",)), ("6e", ("6",)), ("6f", ("6b",)),
    ("6g", ("6",)), ("7", ()), ("7b", ()),
    ("8", ()), ("8c", ("8",)), ("8b", ()), ("9", ()),
    ("10", ()), ("10c", ("10",)), ("10b", ()), ("11", ()), ("11b", ()),
    ("12", ()), ("12b", ("12",)), ("12c", ("12",)), ("12d", ("12",)),
    ("14b", ("12",)),
    ("13", ()), ("13checkpoint", ("13",)), ("13b", ()), ("13c", ()),
    ("14", ()), ("15", ()),
    ("16", ()), ("16b", ()), ("16c", ()), ("16d", ()),
    ("17", ()), ("17b", ()), ("17c", ()),
    ("18", ()), ("18b", ()), ("18c", ()), ("18d", ()), ("18e", ()),
    ("19", ()), ("19b", ()), ("20", ()), ("20b", ()), ("20c", ()),
    ("21", ()), ("21b", ()), ("21c", ()), ("21d", ()))


def selected_phases(spec):
    """The phases ``--phases SPEC`` runs, in run order: the comma list's
    and, in turn, the phases they need; every phase without SPEC."""
    names = [n for n, _ in PHASES]
    if not spec:
        return names
    needs = dict(PHASES)
    todo = [p.strip() for p in spec.split(",") if p.strip()]
    unknown = [p for p in todo if p not in needs]
    if unknown:
        raise SystemExit("chip_smoke: unknown phase(s) %s; the phases are "
                         "%s (1 and 2 always run)" % (unknown,
                                                     ",".join(names)))
    want = set()
    while todo:
        p = todo.pop()
        if p not in want:
            want.add(p)
            todo.extend(needs[p])
    return [n for n in names if n in want]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write every measurement to "
                    "OUT/chip_smoke.json")
    ap.add_argument("--seed", type=int, default=SEED,
                    help="seed of the weights and the synthetic batches "
                    "(default %(default)s)")
    ap.add_argument("--phases", help="a comma list of the phases to run "
                    "(with the phases they need; 1 and 2 always run), "
                    "e.g. 17,17b,17c; every phase by default")
    args = ap.parse_args()
    run = selected_phases(args.phases)
    left_out = [n for n, _ in PHASES if n not in run]
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; this script needs one "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    # the tuner's winners stay in this process: nothing is read from or
    # written to a cache outside the checkout
    os.environ["PADDLE_TPU_KERNEL_CACHE_DIR"] = "0"
    t_start = time.perf_counter()
    phase_s = {}
    R = {}  # each phase's results, by phase name

    def timed(name, fn, *a):
        """``fn(*a)``, its seconds kept in ``phase_s`` and logged."""
        t0 = time.perf_counter()
        out = fn(*a)
        phase_s[name] = time.perf_counter() - t0
        log("phase %s: %.1f s" % (name, phase_s[name]))
        return out

    def want(name):
        return name in run

    if left_out:
        log("phases: %s (left out: %s)" % (",".join(run), ",".join(left_out)))
    smi = timed("1", phase_card)
    build_s = timed("2", phase_build)
    if want("3"):
        R["3 occupancy"] = _fwd_occupancy()
        R["3"] = timed("3", phase_kernels, args.seed)
    if want("3b"):
        R["3b"], R["3b occupancy"] = timed("3b", phase_bwd_kernels,
                                           args.seed)
    if want("3c"):
        R["3c"], R["3c K5 launches"] = timed("3c", phase_tier_kernels,
                                             args.seed)
    if want("3d"):
        R["3d"] = timed("3d", phase_tune)
    _free()
    if want("4"):
        with tempfile.TemporaryDirectory() as workdir:
            serve, pred, reqs = timed("4", phase_serve, workdir, args.seed)
        R["4"] = serve
        if want("4c"):
            serve["compiled"] = timed("4c f32", phase_compiled_serve, "f32",
                                      pred, reqs, serve["per_dispatch"])
        if want("5"):
            R["5"] = timed("5", phase_profile, pred, reqs)
        if want("12e"):
            R["12e"] = timed("12e", phase_batcher, pred, args.seed)
        if want("4b"):
            with tempfile.TemporaryDirectory() as workdir:
                R["4b"] = timed("4b + 4c AMP", phase_serve_amp, workdir,
                                args.seed, pred, reqs)
        del pred
        _free()
    if want("6"):
        train = R["6"] = timed("6 + 6c f32", phase_train, args.seed)
        _free()
        if want("6b"):
            R["6b"] = timed("6b + 6c AMP", phase_train_amp, args.seed, train)
            _free()
        if want("6e"):
            R["6e"] = timed("6e", phase_train_loop, "f32 (6e)", args.seed,
                            False, train["snapshot"], train["per_step"])
            _free()
        if want("6f"):
            R["6f"] = timed("6f", phase_train_loop, "AMP (6f)", args.seed,
                            True, R["6b"]["snapshot"], R["6b"]["per_step"])
            _free()
        if want("6g"):
            R["6g"] = timed("6g", phase_recompute, args.seed, train)
        for k in ("snapshot", "main_path", "batches", "per_step"):
            train.pop(k, None)
            R.get("6b", {}).pop(k, None)
        _free()
    if want("7"):
        R["7"] = timed("7", phase_train_sgd, args.seed)
        _free()
    if want("7b"):
        R["7b"] = timed("7b", phase_train_sgd_amp, args.seed)
        _free()
    if want("8"):
        R["8"] = timed("8", phase_gpt_train, args.seed, False)
        _free()
        params = R["8"].pop("params")
        if want("8c"):
            R["8c"] = timed("8c", phase_gpt_generate, args.seed, params)
        del params
        _free()
    if want("8b"):
        R["8b"] = timed("8b", phase_gpt_train, args.seed, True)
        R["8b"].pop("params")
        _free()
    if want("9"):
        R["9"] = timed("9", phase_transformer, args.seed)
        _free()
    if want("10"):
        R["10"] = timed("10", phase_resnet_train, args.seed, False)
        _free()
        state = R["10"].pop("state")
        if want("10c"):
            with tempfile.TemporaryDirectory() as workdir:
                R["10c"] = timed("10c", phase_resnet_serve, workdir,
                                 args.seed, state)
        del state
        _free()
    if want("10b"):
        R["10b"] = timed("10b", phase_resnet_train, args.seed, True)
        _free()
    if want("11"):
        R["11"] = timed("11", phase_vit_train, args.seed, False)
        _free()
    if want("11b"):
        R["11b"] = timed("11b", phase_vit_train, args.seed, True)
        _free()
    if want("12"):
        engine, ref = timed("12", phase_engine, args.seed)
        R["12"] = engine
        if want("12b"):
            R["12b"] = timed("12b", phase_prefix, args.seed, ref)
        if want("12c"):
            R["12c"] = timed("12c", phase_spec, args.seed, ref,
                             engine["tokens_per_s"])
        if want("12d"):
            R["12d"] = timed("12d", phase_router, args.seed, ref)
        _free()
        if want("14b"):
            R["14b"] = timed("14b", phase_fleet_artifact, args.seed, ref,
                             engine)
        del ref
        _free()
    keep = ("snapshot", "exe", "main", "loss", "params", "batches")
    if want("13"):
        R["13"] = timed("13", phase_lamb, args.seed, False)
        if want("13checkpoint"):
            R["13checkpoint"] = timed("13 checkpoint", phase_checkpoint,
                                      R["13"])
        for k in keep:
            R["13"].pop(k)
        _free()
    if want("13b"):
        R["13b"] = timed("13b", phase_lamb, args.seed, True)
        for k in keep:
            R["13b"].pop(k)
        _free()
    if want("13c"):
        R["13c"] = timed("13c", phase_other_optimizers, args.seed)
        _free()
    if want("14"):
        with tempfile.TemporaryDirectory() as workdir:
            R["14"] = timed("14", phase_artifact, workdir, args.seed)
    if want("15"):
        R["15"] = timed("15", phase_dygraph, args.seed)
        _free()
    if want("16"):
        with tempfile.TemporaryDirectory() as workdir:
            R["16"] = timed("16", phase_seq2seq_serve, workdir, args.seed)
        _free()
    if want("16b"):
        R["16b"] = timed("16b", phase_stacked_lstm, args.seed)
        _free()
    if want("16c"):
        R["16c"] = timed("16c", phase_mt_train, args.seed)
        _free()
    if want("16d"):
        R["16d"] = timed("16d", phase_control_flow, args.seed)
        _free()
    if want("17"):
        R["17"] = timed("17", phase_book, args.seed)
        _free()
    if want("17b"):
        R["17b"] = timed("17b", phase_srl, args.seed)
        _free()
    if want("17c"):
        R["17c"] = timed("17c", phase_op_tail, args.seed)
        _free()
    if want("18"):
        R["18"] = timed("18", phase_cost_model, args.seed, R)
        _free()
    if want("18b"):
        R["18b"] = timed("18b", phase_autotune, args.seed)
        _free()
    if want("18c"):
        R["18c"] = timed("18c", phase_jit_autotune, args.seed)
        _free()
    if want("18d"):
        with tempfile.TemporaryDirectory() as workdir:
            R["18d"] = timed("18d", phase_quantize, workdir, args.seed)
        _free()
    if want("18e"):
        R["18e"] = timed("18e", phase_misc_ops, args.seed)
        _free()
    if want("19"):
        with tempfile.TemporaryDirectory() as workdir:
            R["19"] = timed("19", phase_ssd, workdir, args.seed)
        _free()
    if want("19b"):
        R["19b"] = timed("19b", phase_detection_ops, args.seed)
        _free()
    if want("20"):
        R["20"] = timed("20", phase_mnist_fed, args.seed)
        _free()
    if want("20b"):
        with tempfile.TemporaryDirectory() as workdir:
            R["20b"] = timed("20b", phase_async_ctr, workdir, args.seed)
        _free()
    if want("20c"):
        with tempfile.TemporaryDirectory() as workdir:
            R["20c"] = timed("20c", phase_calibrate, workdir, args.seed)
        _free()
    if want("21"):
        R["21"] = timed("21", phase_mesh_dp_tp, args.seed)
        _free()
    if want("21b"):
        R["21b"] = timed("21b", phase_mesh_sp, args.seed)
        _free()
    if want("21c"):
        R["21c"] = timed("21c", phase_mesh_experts, args.seed)
        _free()
    if want("21d"):
        R["21d"] = timed("21d", phase_mesh_pipeline, args.seed)
        _free()

    kernels = _kernel_rows(R)
    # every TPU kernel of the JAX package (paddle_tpu) that reaches
    # pl.pallas_call has its port; none is left out
    not_ported = []
    log("chip_smoke: all phases passed in %.1f s; %d profiler windows "
        "lost lead spins (at most %d of %d)" % (
            time.perf_counter() - t_start, len(PROFILER_LOSSES),
            max([n for n, _ in PROFILER_LOSSES], default=0),
            PROFILER_LEAD_SPINS))

    if args.out is not None:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
            json.dump(dict(card=smi, torch=torch.__version__,
                           build_s=build_s, phase_s=phase_s, phases=run,
                           phases_left_out=left_out, results=R,
                           kernels=kernels, not_ported=not_ported,
                           profiler_losses=PROFILER_LOSSES), f,
                      indent=1, default=str)
    log(json.dumps({"kernels": kernels, "not_ported": not_ported,
                    "phases_left_out": left_out}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def _launches(R, phase, name, field="launches"):
    """Phase ``phase``'s count ``name`` from its results' ``field``; 0
    where the phase did not run."""
    r = R.get(phase)
    return int(r[field][name]) if r is not None else 0


def _kernel_rows(R):
    """The result line's kernel rows from the phases that ran: each
    kernel's launches on the main paths by path (``_launches``) and its
    measurements from phases 3, 3b and 3c (None where that phase did not
    run)."""
    L = lambda p, c, f="launches": _launches(R, p, c, f)  # noqa: E731
    by_path = lambda **kw: {k: v for k, v in kw.items() if v}  # noqa
    none_t = dict(ms=None, plain_ms=None, bound_ms=None, bound_by=None)
    rows, bwd_rows, tier_rows = R.get("3"), R.get("3b"), R.get("3c")
    fwd = fwd_b = bwd = bwd_b = ln_row = opt_row = ln_amp = opt_amp = None
    if rows:
        # the main paths' shapes: [8, 12, 512, 64] f32 attention; the AMP
        # path's flash shapes: the same at bf16
        fwd = rows[0]
        fwd_b = next(r for r in rows if r["case"] == "bert_bf16")
    if bwd_rows:
        bwd = bwd_rows[0]
        bwd_b = next(r for r in bwd_rows if r["case"] == "bert_bf16")
    if tier_rows:
        # [4096, 768] f32 layer norm rows, BERT-base's 157 params
        ln_row = tier_rows[0]
        opt_row = next(r for r in tier_rows if r["case"] == "bert_base")
        ln_amp = next(r for r in tier_rows if r["case"] == "bert_b8_amp")
        opt_amp = next(r for r in tier_rows
                       if r["case"] == "bert_base_amp")
    flash_amp = lambda row, t, err: (row["case"], err, dict(  # noqa: E731
        t, library_ms=row["library_device_ms"],
        library_call_ms=row["library_ms"]))
    others = R.get("13c", {})
    ot = {c: sum(r["launches"][c] for r in others.values())
          for c in COUNT_NAMES}
    gen_k4 = sum(r["launches"]["K4"] for r in R.get("8c", {}).values())
    serve_k4 = L("12", "K4") + sum(
        r["launches"]["K4"] for k in ("12b", "12c")
        for r in R.get(k, {}).values()
        if isinstance(r, dict) and "launches" in r)
    k1 = by_path(serve=L("4", "flash fwd"), train=L("6", "flash fwd"),
                 serve_amp=L("4b", "flash fwd"),
                 train_amp=L("6b", "flash fwd"),
                 train_sgd_amp=L("7b", "flash fwd"),
                 train_loop=L("6e", "flash fwd"),
                 train_loop_amp=L("6f", "flash fwd"),
                 recompute=L("6g", "flash fwd"),
                 gpt_train=L("8", "flash fwd"),
                 gpt_train_amp=L("8b", "flash fwd"),
                 transformer_train=L("9", "flash fwd"),
                 vit_train_flash=L("11", "flash fwd", "flash_launches"),
                 vit_train_amp_flash=L("11b", "flash fwd",
                                       "flash_launches"),
                 serve_batcher=L("12e", "flash fwd"),
                 lamb_train=L("13", "flash fwd"),
                 lamb_train_amp=L("13b", "flash fwd"),
                 other_optimizers=ot["flash fwd"],
                 artifact_aot=L("14", "flash fwd"),
                 dygraph=L("15", "flash fwd"),
                 autotune_kernel_axis=L("18b", "flash fwd", "tune_launches"),
                 autotune_tuned_loop=L("18b", "flash fwd"),
                 dygraph_autotune=L("18c", "flash fwd"),
                 quantize_aware_train=L("18d", "flash fwd"),
                 mesh_dp=L("21", "flash fwd"),
                 mesh_dp_tp=L("21", "flash fwd", "tp_launches"),
                 mesh_sp_ring=L("21b", "flash fwd"),
                 mesh_sp_ring_packed=L("21b", "flash fwd",
                                       "packed_launches"),
                 mesh_experts=L("21c", "flash fwd"))
    k2, k3 = (by_path(train=L("6", c), train_amp=L("6b", c),
                      train_sgd_amp=L("7b", c), train_loop=L("6e", c),
                      train_loop_amp=L("6f", c), recompute=L("6g", c),
                      gpt_train=L("8", c), gpt_train_amp=L("8b", c),
                      transformer_train=L("9", c),
                      vit_train_flash=L("11", c, "flash_launches"),
                      vit_train_amp_flash=L("11b", c, "flash_launches"),
                      lamb_train=L("13", c), lamb_train_amp=L("13b", c),
                      other_optimizers=ot[c], dygraph=L("15", c),
                      autotune_tuned_loop=L("18b", c),
                      dygraph_autotune=L("18c", c),
                      quantize_aware_train=L("18d", c),
                      mesh_dp=L("21", c),
                      mesh_dp_tp=L("21", c, "tp_launches"),
                      mesh_sp_ring=L("21b", c),
                      mesh_sp_ring_packed=L("21b", c, "packed_launches"),
                      mesh_experts=L("21c", c))
              for c in ("flash dkv", "flash dq"))
    k4 = by_path(serve=L("4", "K4"), train=L("6", "K4"),
                 train_sgd=L("7", "K4"), serve_amp=L("4b", "K4 AMP"),
                 train_amp=L("6b", "K4 AMP"),
                 train_sgd_amp=L("7b", "K4 AMP"),
                 train_loop=L("6e", "K4"), train_loop_amp=L("6f", "K4 AMP"),
                 recompute=L("6g", "K4"), gpt_train=L("8", "K4"),
                 gpt_train_amp=L("8b", "K4 AMP"), gpt_generate=gen_k4,
                 transformer_train=L("9", "K4"), vit_train=L("11", "K4"),
                 vit_train_flash=L("11", "K4", "flash_launches"),
                 vit_train_amp=L("11b", "K4 AMP"),
                 vit_train_amp_flash=L("11b", "K4 AMP", "flash_launches"),
                 gpt_engine=serve_k4, serve_batcher=L("12e", "K4"),
                 lamb_train=L("13", "K4"), lamb_train_amp=L("13b", "K4 AMP"),
                 other_optimizers=ot["K4"], artifact_aot=L("14", "K4"),
                 dygraph=L("15", "K4"), autotune_tuned_loop=L("18b", "K4"),
                 dygraph_autotune=L("18c", "K4"),
                 quantize_aware_train=L("18d", "K4"),
                 mesh_dp=L("21", "K4"),
                 mesh_dp_tp=L("21", "K4", "tp_launches"),
                 mesh_sp_ring=L("21b", "K4"),
                 mesh_sp_ring_packed=L("21b", "K4", "packed_launches"),
                 mesh_experts=L("21c", "K4"))
    k6 = by_path(train=L("6", "K6"), train_amp=L("6b", "K6"),
                 train_loop=L("6e", "K6"), train_loop_amp=L("6f", "K6"),
                 recompute=L("6g", "K6"), gpt_train=L("8", "K6"),
                 gpt_train_amp=L("8b", "K6"),
                 transformer_train=L("9", "K6"),
                 resnet_train=L("10", "K6"), resnet_train_amp=L("10b", "K6"),
                 vit_train=L("11", "K6"),
                 vit_train_flash=L("11", "K6", "flash_launches"),
                 vit_train_amp=L("11b", "K6"),
                 vit_train_amp_flash=L("11b", "K6", "flash_launches"),
                 other_optimizers=ot["K6"], dygraph=L("15", "K6"),
                 stacked_lstm_train=L("16b", "K6"),
                 mt_train=L("16c", "K6"),
                 control_flow_train=L("16d", "K6"),
                 book_train=L("17", "K6"), srl_train=L("17b", "K6"),
                 op_tail_train=L("17c", "K6"),
                 autotune_tuned_loop=L("18b", "K6"),
                 dygraph_autotune=L("18c", "K6"),
                 quantize_aware_train=L("18d", "K6"),
                 ssd_train=L("19", "K6"), mnist_pyreader=L("20", "K6"),
                 deepfm_async=L("20b", "K6"),
                 mesh_dp=L("21", "K6"),
                 mesh_dp_tp=L("21", "K6", "tp_launches"),
                 mesh_sp_ring=L("21b", "K6"),
                 mesh_sp_ring_packed=L("21b", "K6", "packed_launches"),
                 mesh_experts=L("21c", "K6"),
                 mesh_pipeline=L("21d", "K6"))
    k7 = by_path(train_sgd=L("7", "K7"), train_sgd_amp=L("7b", "K7"),
                 book_train=L("17", "K7"))
    k5 = R.get("3c K5 launches", 0)

    def row(name, source, replaces, by, err, t, lib, lib_call, amp=None):
        return _kernel_row(name, source, replaces, sum(by.values()), by,
                           err, t if t is not None else none_t, lib,
                           lib_call, amp=amp)

    kernels = [
        row("flash_attention_fwd",
            "paddle_tpu_torch/csrc/flash_attention_fwd.cu",
            "paddle_tpu/ops/attention.py:281", k1,
            fwd and fwd["max_abs_err"], fwd,
            fwd and fwd["library_device_ms"], fwd and fwd["library_ms"],
            amp=fwd and flash_amp(fwd_b, fwd_b, fwd_b["max_abs_err"])),
        row("flash_attention_dkv",
            "paddle_tpu_torch/csrc/flash_attention_bwd.cu",
            "paddle_tpu/ops/attention.py:383", k2,
            bwd and max(bwd["max_abs_err"][n] for n in ("dk", "dv")),
            bwd and bwd["dkv"], bwd and bwd["library_device_ms"],
            bwd and bwd["library_ms"],
            amp=bwd and flash_amp(bwd_b, bwd_b["dkv"], max(
                bwd_b["max_abs_err"][n] for n in ("dk", "dv")))),
        row("flash_attention_dq",
            "paddle_tpu_torch/csrc/flash_attention_bwd.cu",
            "paddle_tpu/ops/attention.py:432", k3,
            bwd and bwd["max_abs_err"]["dq"], bwd and bwd["dq"],
            bwd and bwd["library_device_ms"], bwd and bwd["library_ms"],
            amp=bwd and flash_amp(bwd_b, bwd_b["dq"],
                                  bwd_b["max_abs_err"]["dq"])),
        row("layernorm_residual_fwd",
            "paddle_tpu_torch/csrc/layernorm_residual.cu",
            "paddle_tpu/kernels/layernorm.py:98", k4,
            ln_row and ln_row["max_abs_err"]["fwd"], ln_row and ln_row["fwd"],
            ln_row and ln_row["fwd"]["library_ms"],
            ln_row and ln_row["fwd"]["library_call_ms"],
            amp=ln_amp and (ln_amp["case"], ln_amp["max_abs_err"]["fwd"],
                            ln_amp["fwd"])),
        row("layernorm_residual_bwd",
            "paddle_tpu_torch/csrc/layernorm_residual.cu",
            "paddle_tpu/kernels/layernorm.py:143", by_path(autograd=k5),
            ln_row and ln_row["max_abs_err"]["bwd"], ln_row and ln_row["bwd"],
            ln_row and ln_row["bwd"]["library_ms"],
            ln_row and ln_row["bwd"]["library_call_ms"]),
        row("adam_group", "paddle_tpu_torch/csrc/optimizer_update.cu",
            "paddle_tpu/kernels/optimizer_update.py:149", k6,
            opt_row and opt_row["max_abs_err"]["adam"],
            opt_row and opt_row["adam"],
            opt_row and opt_row["adam"]["library_ms"],
            opt_row and opt_row["adam"]["library_call_ms"],
            amp=opt_amp and (opt_amp["case"], opt_amp["max_abs_err"]["adam"],
                             opt_amp["adam"])),
        row("sgd_group", "paddle_tpu_torch/csrc/optimizer_update.cu",
            "paddle_tpu/kernels/optimizer_update.py:233", k7,
            opt_row and opt_row["max_abs_err"]["sgd"],
            opt_row and opt_row["sgd"],
            opt_row and opt_row["sgd"]["library_ms"],
            opt_row and opt_row["sgd"]["library_call_ms"],
            amp=opt_amp and (opt_amp["case"], opt_amp["max_abs_err"]["sgd"],
                             opt_amp["sgd"])),
    ]
    # K1-K3 at GPT-2 small's causal shape and at ViT-B/16's ragged S =
    # 197, f32 and bf16 (phases 3, 3b)
    for model in ("gpt", "vit") if rows and bwd_rows else ():
        fwd_g, bwd_g = ({c: next(r for r in rs_ if r["case"] == c)
                         for c in (model + "_f32", model + "_bf16")}
                        for rs_ in (rows, bwd_rows))
        model_rows = (
            {c: dict(max_abs_err=r["max_abs_err"], **{k: r[k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by")},
                library_ms=r["library_device_ms"],
                library_call_ms=r["library_ms"]) for c, r in fwd_g.items()},
            {c: dict(max_abs_err=max(r["max_abs_err"][n]
                                     for n in ("dk", "dv")),
                     library_ms=r["library_device_ms"],
                     library_call_ms=r["library_ms"],
                     **{k: r["dkv"][k] for k in (
                         "ms", "plain_ms", "bound_ms", "bound_by")})
             for c, r in bwd_g.items()},
            {c: dict(max_abs_err=r["max_abs_err"]["dq"],
                     library_ms=r["library_device_ms"],
                     library_call_ms=r["library_ms"],
                     **{k: r["dq"][k] for k in (
                         "ms", "plain_ms", "bound_ms", "bound_by")})
             for c, r in bwd_g.items()})
        for r_, g in zip(kernels[:3], model_rows):
            r_[model] = g
    return kernels


if __name__ == "__main__":
    sys.exit(main())

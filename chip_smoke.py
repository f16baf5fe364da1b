#!/usr/bin/env python3
"""Drive paddle_tpu_torch's serving path, the LM training step (under
Momentum and under the Transformer recipe's Adam, with every block a
rematerialization scope, in its mixture-of-experts form, and through
the high-level Trainer with its
checkpoints, resume, anomaly guard and fault handling, the Inferencer,
and the observability they and the server report into), the ResNet-50
training step, the long-context LM training step and the exp/exp2 probe
once on one CUDA card.

    python3 chip_smoke.py

Every program runs through the Executor's default path on the card: a
prepared program's device segments run eagerly once, are captured as
CUDA graphs on the second run and replayed from then on (the kernel
wrappers' launch counts are added again at each replay, so every count
below counts replays). The first step of t1, a1, r1 and l1 runs under
no_host_sync (torch.cuda.set_sync_debug_mode('error')): a device op
that synchronises with the host fails the run. r2 runs its steps op by
op, since its stand-in kernel must run where Python runs.

Phases, each of which fails the run (non-zero exit, no final "ok" line):
  (a) build every CUDA kernel of the paths with nvcc (one process per
      source, started together): the flash-attention forwards K1, K4a,
      K4b (bf16 K1 is the tensor-core flash_fwd_wgmma_kernel), the
      backwards K2, K3a, K3b, K5 (bf16 K2 and K5 are one tensor-core
      kernel, flash_bwd_wgmma_kernel; bf16 K3a and K3b the tensor-core
      flash_bwd_dq_wgmma_kernel and flash_bwd_dkv_wgmma_kernel), the
      matmul + BN-statistics kernel K6 (bf16: the tensor-core
      matmul_bn_stats_wgmma_kernel; fp32 and ragged bf16: the generic
      matmul_bn_stats_kernel) and the probe P; the registers and spills
      of fp32 K1 (flash_fwd_f32_kernel), of the tensor-core K1, K2/K5,
      K3a and K3b at d = 64 and 128 and of bf16 K6 at BN = 64 and 128
      are logged;
  (b) hold K1, K2, K3a and K3b against their plain PyTorch versions on
      the card, at the shapes the paths give them and at ragged edge
      shapes, fp32 and bf16 (K1 by check_fwd_output: lse within the fp32
      atol in both dtypes, bf16 o also within O_RTOL relative to |o| +
      mean |o|; bf16 K2's dq, dk, dv, K3a's dq and K3b's dk, dv also
      within G_RTOL relative to |g| + mean |g|; K1, K3a and K3b launched
      twice give bit-identical outputs; fp32 K1's o and lse at the
      serving shape and its plain version's are also held against an
      fp64 evaluation, logged), and time kernel, plain version
      and the PyTorch library call (sdpa_yardstick:
      scaled_dot_product_attention on 4-D views under a fused backend
      only; its backward is timed as fwd+bwd minus fwd, timed only);
  (b4) the same for K4a, K4b and K5 at the long-context path's shape
      [16, 8192, 128] causal in bf16 and in fp32 (K4b's o also against
      an fp64 evaluation, logged; K5's dq, dk, dv too, and the plain
      evaluation with P and dS rounded once to bf16) and at phase b's
      ragged shapes, bf16 K4b's o also within O_RTOL of its plain version
      relative to |o| + mean |o| and bf16 K5's gradients within G_RTOL;
      bf16 K1 (the default arm's forward there) at the same shapes by
      check_fwd_output (its o also against fp64, logged); then their
      times, K1 and K4a + K4b against the library forward
      and K5 against the library backward (every "x the library" factor
      is taken on torch.profiler device time, the library's only clock);
  (h) the flash_attention op on CUDA tensors at shapes the kernels do
      not take (UNTAKEN_FLASH: head dim 16 and 32 in fp32 and bf16, 64 in
      fp16, causal): each output has the plain version's bits, the
      plain-on-card counter (FlashAttention.plain_cuda_calls) counts the
      call and no kernel launches. Phases c3, t1, t3, l1 and a1 require
      that counter to stay 0 over their timed work; t2, l2 and a2 run the
      plain versions on purpose and reset it after;
  (c) build the flagship LM (bench.py's transformer: vocab 32768, dim
      2048, 16 heads, 12 layers, ffn 8192, max_len 512, flash attention)
      with random weights from a seed, run its startup program on
      CUDAPlace(0), save_inference_model, load it through
      AnalysisConfig/AnalysisPredictor, prepare_decoding(slots=8,
      prefill_batch=1), and answer 8 requests (prompts of 32..480
      tokens, 32 new tokens each) through LMServer.submit/result, with
      every kernel launch counter set to 0 just before and read just
      after: the flash forward must launch at least prefills x layers
      times;
  (d) each request's prefill logits and first token match the port's own
      full-recompute Predictor.run (rtol = atol = 1e-3);
  (e) each engine stream equals its solo DecodePredictor.generate stream;
  (f), (g) prefill and decode-step timing, and their device time (fp32
      K1's device ms and launches per prefill beside the top kernels);
then the same weights served from the paged KV cache (16-token pages,
the auto pool of 8 x 32 + 1 pages, 64-token prefill chunks), where
neither package runs a Pallas kernel: the paged prefill, decode and
verify programs are kv_page_* ops, matmul, a mask op and softmax. Streams
that the two paths sum in another order are held by the margin rule
(margin_rule: equal, or where they first differ both tokens within
MARGIN_TOL of the reference path's best logit there):
  (v1) LMServer(paged=True) answers c3's 8 requests x 32 tokens: the
      streams vs c3's by the margin rule (the dense decode's logits),
      each paged prefill's logits vs the dense prefill's within
      RECOMPUTE_TOL, no kernel launch, tokens/s, the capture counts the
      same before and after the run (each program captured once), and
      after the drain no page held but the prefix cache's (none once it
      is evicted; PagePool.check());
  (v2) 8 requests over one 256-token system prompt (4 chunks, 16
      pages): the first prefills cold, each of the 7 others one chunk
      (its suffix), prefix_hits 7 reusing 1792 tokens, and every stream
      the tokens of its own cold solo stream (the chunks line up);
  (v3) 8 streams of 200–270 + 96 tokens on two tiers over
      TIGHT_KV_PAGES (half the auto pool): under 'swap' preemptions > 0,
      every request done, and every stream (the swap-resumed ones
      among them) the tokens of its unpreempted solo stream; under
      'reprefill' the streams by the margin rule; swap bytes and the
      resume latency's p50; a deadline_ms spent at submit raises
      DeadlineExceededError, one spent mid-decode fails its request
      with it and its pages come back;
  (v4) LMServer(speculative=True, spec_k=4) with draft_layers 1 and
      12: streams vs v1's by the margin rule, accept rate, tokens a
      verify iteration, tokens/s, a verify iteration's and a draft
      step's ms;
  (v5) ServingEngine(workers=2): request_swap installs a new head
      weight while both workers decode; each worker's last step before
      the swap has the bits of a predictor with its own copy of the old
      weights, its first step after it those of one with the new
      weights, and no worker captures again (the executor copies the
      new weight into the captured tensor at the next replay);
  (v6) the paged decode step over 8 live streams, wall and device ms
      and busy share beside g's dense step, and the paged prefill's ms
      a chunk.
  (t1) build the flagship training program as bench.py's _bench_lm does
      (py_reader feed, fused LM head with chunk 4096, mean,
      Momentum(0.001, 0.9) under contrib.mixed_precision.decorate), run
      its startup program on CUDAPlace(0), then 2 warm-up and 5 timed
      steps through ParallelExecutor(use_cuda=True); with the counters
      set to 0 before the timed steps, K1 must launch >= 12 x steps
      times, K2 exactly 12 x steps, K3, K4 and K5 never; every loss is
      finite;
  (t2) one step from a saved state with the kernels and the same step
      with FLAGS_use_flash_attention=False (the plain versions): the
      losses and the updates of layer0_qkv, layer11_down and lm_head
      agree within TRAIN_LOSS_TOL / TRAIN_UPDATE_TOL;
  (t3) the same step under PADDLE_FLASH_BWD=split: K3a and K3b launch 12
      times each, K2 never, and loss and updates match t2's kernel step;
      then the split step's wall ms and its device time by kernel kind
      from torch.profiler over 3 steps;
  (t4) step ms, tokens/s, MFU (bench.py's FLOPs per token over the bf16
      dense peak), device-busy share and top device items from
      torch.profiler over 3 steps, and peak device memory.
The LM is freed, then the same LM with TransformerConfig's own use_tp /
use_sp (the one-device parallel layers and annotations) trains under
the Transformer recipe: Adam(noam_decay(2048, 4000), beta1 0.9, beta2
0.98, epsilon 1e-9) with GradientClipByGlobalNorm(1.0) set by
set_gradient_clip, under contrib.mixed_precision.decorate:
  (a1) 2 warm-up and 5 timed steps through ParallelExecutor: K1 >= 12 x
      steps and K2 exactly 12 x steps launches, K3-K5 never, no plain
      call, every loss finite; the rate and the step counter fetched in
      every step, every beta power read after the warm-up steps and the
      last one; step ms, tokens/s, MFU, device busy share (one
      torch.profiler step) and peak memory;
  (a2) those records: the rate within SCHEDULE_RTOL of noam_decay, the
      counter s in the s-th step, every beta power beta^(s+1); then one
      step from a saved state with the kernels and one plain step: loss
      within TRAIN_LOSS_TOL and each ADAM_PARAMS_COMPARED weight's step
      gradient (from its first moment) within TRAIN_UPDATE_TOL of the
      largest; the updates are logged;
  (a3) the eleven optimizer updates (sgd, momentum and the nine of this
      slice) at OPT_SHAPES on the card against the same emitter on CPU
      copies, within OPT_TOL of max(1, |ref|);
  (a4) every op type registered after A4_EARLIER_OPS, forward and grads,
      on the card against CPU copies (rtol OP_RTOL, atol OP_ATOL; integer
      and bool outputs exact; the script fails if such an op type has no
      case and no entry in A4_HELD_ELSEWHERE); dropout (is_test bits,
      kept entries and share over DROPOUT_N elements, grad dOut·Mask)
      and truncated_gaussian_random's draw; ROADMAP item 6's op types at
      published shapes (check_item6_ops: C3D's convs and pools, SegNet's
      first pool with index and its unpool, SPP-net's pyramid,
      fake_quantize's three modes on ResNet-50's res2 output, auc's state
      over three batches at batch 4096) and random_crop's draw.
The Adam LM is freed, then the flagship LM in its mixture-of-experts
form (MOE_MODEL: moe_experts=4, top-1, capacity factor 2.0, cut to 6
layers for the script's time):
  (moe1) t1's recipe (py_reader, batch 8, AMP Momentum, ParallelExecutor)
      for MOE_WARMUP + MOE_TIMED steps over two batches in turn: the
      loss falls on each; K1 and K2 launch 6 times a step (the
      wrappers' counts and check_replay_launches), no plain flash call;
      reserved memory under MOE_PEAK_GB; step ms, tokens/s, device busy
      and ms by kind, the executed FLOPs of one op-by-op step; three
      steps captured and op by op from one saved state under the split
      arm (its backward has no atomics): the same bits;
  (moe2) moe_ffn + moe_aux_loss over one [512, 2048] sequence with 4
      experts of [2048, 8192] in fp32, forward and grads, on the card
      against the CPU port within MOE_CPU_RTOL (sum |diff| / sum |cpu|);
      the same top-1 experts but at ties within MOE_TIE; the same dropped
      tokens; top-k at ample capacity against dense within
      MOE_DENSE_TOL; counted FLOPs at 4 and 8 experts within
      MOE_FLOPS_RTOL.
The MoE LM is freed, then ResNet-50 (bench.py's bench_resnet, NCHW,
built with FLAGS_use_pallas_fused_ops so every conv + BN is one
conv2d_bn op):
  (r1) the training step at 224 px, 1000 classes, batch RESNET_BATCH
      (py_reader, train_network(depth=50), Momentum(0.01, 0.9) under
      contrib.mixed_precision.decorate, startup on CUDAPlace(0),
      ParallelExecutor(use_cuda=True)): 2 warm-up and 5 timed steps; K6
      launches exactly 36 x steps, every one the tensor-core kernel
      (the per-kernel counts), every loss is finite and the BN running
      statistics move;
  (b6) K6 against its plain version on the card (k6_check_shapes): in
      bf16 on the tensor-core kernel at the largest, smallest and widest
      of the step's 1x1 shapes (read from r1's program), a path shape
      for every tile width the plan uses and one with K = 64, and at the
      smallest with one row more; on the generic kernel at the three
      picks in fp32 and at a ragged 300 x 70 x 130 in both dtypes. Each
      is launched twice: the second launch gives the same bits, and the
      per-kernel counts show which kernel ran (a path shape on any other
      kernel fails). Then kernel, plain version, the library yardstick
      (torch.matmul, then the two column sums) and the product alone
      (torch.matmul; both timed only) at every one of the step's 15
      shapes by CUDA events, and kernel and product alone by
      torch.profiler device time, summed over its 36 launches (logged
      as n/a where no profiler window of DEVICE_MS_WINDOWS saw any);
  (r2) one step from a saved state with K6, each of its 36 launches (all
      on the tensor-core kernel) also held against the plain version on
      the step's own inputs, and the
      same step with FLAGS_use_pallas_fused_ops cleared at run time (the
      plain version): the losses agree within TRAIN_LOSS_TOL, and the
      updates of the stem conv, a stage-1 1x1 conv and fc within
      TRAIN_UPDATE_TOL or RESNET_SPREAD_FACTOR x the plain step's own
      spread when its column sums are taken in fp64, whichever is larger
      (the bf16 step amplifies any reordering of fp32 sums);
  (r3) one conv_bn against conv2d + batch_norm with shared parameter
      names, fp32, at a stage-1 1x1 shape and a 3x3 shape: Y and the
      loss after 3 SGD steps agree within PAIR_TOL;
  (r4) step ms, images/s, MFU (bench.py's FLOPs per image over the bf16
      dense peak), device-busy share and device time by kernel kind from
      torch.profiler over 3 steps, and peak device memory.
r1's executor is closed (two batch-256 graph pools do not fit on the
card) and ResNet-50 freed; then ResNet-50 as bench.py builds it for an
accelerator, under N1_FLAGS (FLAGS_use_pallas_fused_ops off, as bench.py
leaves it, and FLAGS_amp_bf16_param_grads on, as its main() sets it):
  (n1) train_network(nhwc=True) at 224 px, 1000 classes, batch
      RESNET_BATCH, AMP Momentum(0.01, 0.9), ParallelExecutor: the
      program has 53 conv2d and 53 batch_norm ops at NHWC, no conv2d_bn
      and one transpose (the NCHW feed's, at the stem); 2 warm-up steps
      (the first under no_host_sync) and 5 timed captured steps: K6
      never launches, every loss is finite, every BN running statistic
      moves, one segment is captured, reserved memory stays under
      RESNET_PEAK_GB;
  (n3) its step ms, images/s, MFU, busy share and device time by kernel
      kind (every copy kernel by name), beside r4's;
  (n2) one NHWC step and one step of the same program built NCHW
      (without the fused flag: the same parameter names) from one saved
      state and batch, op by op: losses within TRAIN_LOSS_TOL, the
      updates of NHWC_PARAMS_COMPARED by r2's rule (TRAIN_UPDATE_TOL or
      RESNET_SPREAD_FACTOR x the NCHW step's own spread when its batch
      statistics are summed in fp64);
  (i2) n1's program at batch NAN_CHECK_BATCH: a step under
      FLAGS_check_nan_inf runs op by op (the capture count does not
      move) to a captured step's loss within NAN_CHECK_TOL, and a batch
      with one NaN pixel raises OpExecutionError naming the first op that
      reads the image (nothing else is caught);
then
  (s1) the space-to-depth stem: the retiled 4x4 conv through the port
      (models.resnet.space_to_depth and conv2d) with s2d_filter's
      weights equals the 7x7/2 conv within S2D_TOL in fp32, and
      train_network(space_to_depth=True), NCHW with the fused flag, at
      batch RESNET_BATCH: 2 + 3 steps, finite losses, K6 36 launches a
      step, step ms logged;
  (i1) bench_inference's ResNet-50 leg: resnet_imagenet(is_test=True,
      nhwc=True) at batch INFER_BATCH, 224 px, fp32, its BN affine and
      running statistics drawn from the seed (inference_model), saved
      with save_inference_model and loaded by AnalysisPredictor: with
      ir_optim 53 -> 0 batch_norm ops and 53 more elementwise_add, the
      output within INFER_TOL of an ir_optim=False predictor's, a clone
      the same bits; p50 and p99 ms a call from a host feed, and device
      images/s from a device-resident feed, N/2N differenced as
      bench.py's serving_throughput does.
Then the dense book chapters, fed through fluid.batch + DataFeeder
from the synthetic datasets, and the small one-device modules:
  (bk1) image_classification: models.resnet.resnet_cifar10(depth=32) at
      32 px, batch 128, fp32, Adam(0.001), fed from
      dataset.cifar.train10(): 10 steps through the Executor's default
      path (eager, captured, replayed) against the same steps op by op
      from one saved state by x1's rule; the capture count equal to the
      program's device segments (x1's Adam measure: a2's gradient-
      weighted updates; cuDNN's deterministic algorithms in bk1, bk2 and
      mo1); step ms, images/s, DataFeeder ms a batch, device ms and busy
      share of a replayed step;
  (bk2) the same network built under FLAGS_use_pallas_fused_ops from
      bk1's initial parameters (each conv + BN one conv2d_bn op): 10
      captured steps launch K6 exactly BK2_K6_PER_STEP (its two 1x1
      projections, fp32 on the generic kernel) times a step; a replayed
      step's profiled launches equal the count; the captured steps vs
      op by op by x1's rule; K6 against its plain version at the two
      shapes (as b6) and its ms there; one fused step against bk1's
      unfused step by r2's rule (updates by a2's measure);
  (bk3) fit_a_line (uci_housing, SGD, then the save_inference_model /
      load_inference_model round trip within SAVE_TOL), recognize_digits
      (models.mnist through py_reader, fed fluid.batch's batches by
      decorate_paddle_reader) and word2vec (imikolov N=5, embedding 32):
      BK3_STEPS steps each, the loss falling;
  (mo1) memory_optimize on bk1's program: MO1_STEPS captured steps the
      same bits and a peak of requested memory no higher (the bytes the
      steps ask for, which the caching allocator's history does not
      change; each arm measured on its fresh executor's second pass, so
      the stream's cuBLAS workspace counts in neither); release_memory on
      fit_a_line: the same losses, its delete_var host steps splitting
      the block into more captured segments; a layers.Print of a feed
      and of an fc's output: the JAX package's text on stderr
      (expected_print_text) for PRINT_FIRST_N runs only, and every
      device segment captured.
Then sequences, padded with a lengths companion (no kernel: the LSTM,
GRU and CRF recurrences are plain PyTorch over T); each phase runs 10
steps over SQ_BATCHES batches twice through the Executor's default path
against the same steps op by op from one saved state, by x1's rule and
to the same bits (the embedding grad sums in one order), the loss of
the second pass below the first's, one capture a device segment and
feed signature (jit_cache_stats logged), the steady step timed on the
last feed:
  (sq1) models.stacked_lstm.train_network at tools/bench_suite.py's
      --full shapes (SQ1: vocab 30000, emb 512, hid 512 (H = 128), 3
      LSTMs of alternating direction, T 128, batch 64, fp32 Adam(1e-3)),
      fed as (padded, lengths) with every length T: step ms, samples/s,
      tokens/s, op by op ms, device busy and ms by kind, peak memory, op
      and segment counts; then one step on the card against one on the
      CPU port from the same state on a feed whose lengths are drawn
      from 1..T (loss within SQ_CPU_RTOL, updates by a2's measure);
  (sq2) understand_sentiment's convolution net (two sequence_conv_pool,
      filter 3 and 4, sqrt pool) and stacked LSTM net at the chapter's
      widths (SENTIMENT: emb 128, hid 512, 3 LSTMs, batch 128,
      Adagrad(0.002), embedding is_sparse) fed from dataset.imdb
      through DataFeeder's LoD branch; step ms, samples/s, DataFeeder ms
      a batch, the padded lengths and graphs captured;
  (sq3) recommender at the chapter's widths (RECOMMENDER: the user and
      movie towers, categories sum-pooled, titles through
      sequence_conv_pool, cos_sim, scale 5, SGD(0.2), batch 256) fed
      from dataset.movielens;
  (sq4) label_semantic_roles at the chapter's widths (SRL: word_dim
      32, mark_dim 5, hidden 512, depth 8, relu candidates, sigmoid
      gates and cells, batch 10), the word embedding loaded from
      conll05.get_embedding() and frozen (unchanged after the steps),
      linear_chain_crf with crfw at mix_hidden_lr, SGD under
      exponential_decay; one step against the CPU port; the card's
      crf_decoding path against the CPU port's on the same emission and
      transition by the margin rule (viterbi_margin: equal, or both
      within VITERBI_TOL of the best path's fp64 score); the chapter's
      evaluation, chunk_eval (IOB, conll05's chunk types) over the card's
      paths of each batch, built up in metrics.ChunkEvaluator: the
      counts, precision, recall and F1 the CPU port's.
Then control flow and the machine_translation chapter (no kernel runs on
these paths: while, conditional_block, recurrent and beam_search are
plain PyTorch, the JAX package's plain JAX):
  (cf1) a While whose trip count is a fed limit (1, 7 and 50 trips, each
      twice), its body an fc at [64, 512] fp32, a fed table row and an
      accumulator, on the card (the loop a host step between captured
      segments, its body captured once and replayed every trip) against
      the CPU port within CF_TOL: trips + 1 host reads a run, a second
      run of each trip count captures nothing new, ms a trip replayed
      and op by op; a Switch writing the
      persistable cf_lr, an IfElse at [64, 512] and the tensor arrays,
      the last runs replayed, against the CPU port;
  (mt1) the chapter's model (MT: dict 30000 = wmt14.N, word and hidden
      512, batch 64, fp32 Adam(1e-3)) fed from dataset.wmt14 through
      DataFeeder's LoD branch, sq1's rules: captured vs op by op the same
      bits, the loss falling, one step vs the CPU port (its gradients
      and updates within MT_STEP_TOL), the trained log-probabilities vs
      the CPU port (MT_LOGP_TOL); step ms,
      samples/s, device busy and ms by kind, DataFeeder ms, peak memory;
  (mt2) the chapter's unrolled beam decoder (12 steps, batch 64) from
      mt1's trained scope at beam 1 and 4: card vs CPU port by
      beam_margin (the same beams at every step and the same sentences,
      or a near tie; scores within MT_SCORE_TOL), beam 4's best score at
      least beam 1's in every row (within MT_BEAM_TOL of max(1, |score|):
      the widths run the head's GEMM at other shapes, so one sentence's
      score differs in its last bits); ms a decoded batch;
  (mt3) the contrib TrainingDecoder (a DynamicRNN: recurrent and
      recurrent_grad over T up to 12, a layers.gru_unit cell, hidden
      512, batch 64) by sq1's rules, then the BeamSearchDecoder at beam
      4 from its trained scope against the CPU port by beam_margin.
Then sparse gradients and detection (no kernel: SelectedRows and the
detection ops are plain PyTorch, the JAX package's plain JAX):
  (sp1) mt1's program with both embeddings is_sparse (their grads
      SelectedRows) under Adam(lazy_mode=True): 10 steps captured vs op
      by op the same bits, each step's untouched rows of both tables,
      parameter and both moments, the same bits (lazy_rows_check), one
      step vs the CPU port (MT_STEP_TOL); the program dense and sparse
      under default Adam and SGD, and the word2vec chapter (four lookups
      into one table, the fan-out sum of four SelectedRows) under the
      book's SGD: one step each, updates within SP_TOL of the dense
      one's largest (sparse_vs_dense); step ms sparse and dense;
  (det1) SSD300 (ssd_build at SSD: VGG-16's conv groups by
      nets.img_conv_group, six maps, multi_box_head at SSD300's settings,
      ssd_loss, Momentum(1e-3, 0.9) + L2Decay(5e-4), 300 px, batch 32) on
      seeded synthetic scenes: 10 steps captured vs op by op the same
      bits under cuDNN's deterministic algorithms, the loss falling, one
      2-image step vs the CPU port (SSD_STEP_TOL, or SSD_SPREAD_FACTOR x
      the CPU's own spread between two convolution algorithms, as r2's
      rule); step ms, images/s, busy, peak memory, the map sizes and
      priors;
  (det2) det1's test clone with detection_output (NMS 0.45, top 400,
      keep 200, score 0.01) and detection_map (11point) at batch 8,
      replayed and timed; its detections against the CPU port's decode
      of the same head outputs by detection_margin, the mAP within
      DET_SCORE_TOL; evaluator.DetectionMAP over two batches of the
      ground truths mixed into the decoded rows, within DET_SCORE_TOL of
      the CPU port's.
a4 also holds every detection op type at small shapes, the Faster R-CNN
ops at their published shapes (check_detection_ops) and the SelectedRows
branches of scale, clip, clip_by_norm, sum and squared_l2_norm
(check_sparse_math) on the card against CPU copies.
ResNet-50 is freed, then the long-context LM (bench.py's
bench_long_context: vocab 32768, dim 1024, 8 heads, 4 layers, ffn 4096,
max_len 8192, batch 2, fused LM head with chunk 8192, reader lc_reader,
AMP Momentum, ParallelExecutor), under PADDLE_FLASH_FWD=twopass and
PADDLE_FLASH_BWD=onepass (restored after each phase):
  (l1) 2 warm-up and 5 timed steps: K4a, K4b and K5 launch exactly
      4 x steps each, K1, K2, K3a and K3b never; every loss is finite;
  (l2) one step from a saved state under twopass/onepass, under the
      default arms (online/kvmajor) and with FLAGS_use_flash_attention
      =False (plain): losses and the updates of layer0_qkv, layer3_down
      and lm_head agree within TRAIN_LOSS_TOL / TRAIN_UPDATE_TOL; the
      two kernel steps are timed in turns (in bf16 their backwards run
      the same kernel, so they differ in the forward, K1 against K4a +
      K4b), and each arm's device time by kernel kind over 3 steps;
  (l3) step ms, tokens/s, MFU by bench.py's causal count and by the
      executed FLOPs (take_extra_flops added), device-busy share and
      device time by kernel kind over 3 steps, peak device memory.
  (p) the probe P (paddle_tpu_torch/tools/probe_exp2.py) against its
      plain version, then its exp and exp2 rates against the card's
      special-function-unit rate.
The captured path itself:
  (x1) after t4 (the Momentum step, under PADDLE_FLASH_BWD=split), after
      a2 (the Adam step), after r4 (ResNet-50) and after l3 (the
      long-context step, twopass/onepass): WARMUP_STEPS + X_TIMED_STEPS
      steps op by op (use_program_cache=False) and the same steps
      through a new ParallelExecutor (eager, captured, replayed) from one
      saved state on the same batches: every loss within TRAIN_LOSS_TOL,
      the updates within TRAIN_UPDATE_TOL (t2's measure; a2's
      gradient-weighted one for Adam; r2's rule for ResNet-50), the
      capture count equal to the program's device segments and
      unchanged over the timed steps; whether the bits are equal, and
      each way's ms per step, peak memory and (one more step under
      torch.profiler) device ms and busy share, are logged;
  (x2) after g: the prefill and decode programs' first runs under
      no_host_sync; after two generations on a new decode predictor its
      jit_cache_stats read 2 prepared programs, 2 captured segments and
      2 misses (the JAX package's tests/test_serving.py:197-200); the
      engine run op by op gives c3's streams exactly; its prefill and
      decode step by the host clock beside f's, and their device time;
  (x3) after x1 (Momentum), on a new ParallelExecutor: a replayed step
      under PADDLE_FLASH_BWD=kvmajor launches K2 12 times and K3 never,
      one under split K3a and K3b 12 times each and K2 never: two
      prepared programs; a weight replaced with Scope.set_var after the
      capture: the next replayed step's loss is the eager step's with
      the new weight; a fetch returned with return_numpy=False is the
      same after the next run;
  (x4) before a1: the flagship LM (AMP Momentum, batch TRAIN_BATCH)
      with TransformerConfig(remat=None, 'nothing', 'dots') from the
      same weights and batches, captured: K1 12 launches a step without
      remat and 24 with it, K2 12; losses within TRAIN_LOSS_TOL and the
      updates within TRAIN_UPDATE_TOL of remat=None's; each policy's
      step ms and peak device memory (logged, with whether 'nothing' <
      'dots' < None holds).

After x4, the high-level Trainer and Inferencer on the flagship LM
(AMP Momentum(0.001, 0.9), batch TRAIN_BATCH, fed through layers.data
and feed_order, one epoch of TR_STEPS batches; every Trainer built in a
fresh name scope with a fresh executor, closed before the next one;
checkpoints, ~5.9 GB each, in a tempfile.mkdtemp() directory checked for
room first, each phase's removed as soon as it has checked them):
  (tr1) fluid.Trainer (the flagship LM at full width cut to TR_MODEL's
      4 layers, for the script's time with the mesh phases;
      its checkpoints ~2.6 GB) on its default place under CheckpointConfig(
      step_interval=TR_INTERVAL, max_num_checkpoints=TR_KEEP): K1 and K2
      cfg.layers launches every step, no plain flash call; its losses
      within TRAIN_LOSS_TOL of a bare Executor loop's over the same
      batches from the same seeded state; checkpoints after steps 3, 7
      and the epoch's end, TR_KEEP kept; step ms beside the loop's, save
      ms and bytes, peak memory;
  (tr2) under PADDLE_FLASH_BWD=split (deterministic): an uninterrupted
      run, one killed after step TR_KILL_AFTER (a checkpoint after step
      3), and a fresh Trainer resuming it at step 4: steps 4-7 the same
      bits as the uninterrupted run's; one byte of the newest checkpoint
      flipped: a fresh Trainer quarantines it and resumes at step 4 from
      the one before;
  (tr3) under FLAGS_anomaly_action=rollback, tr2's batches and cadence:
      a NaN written into TR_NAN_PARAM in place before step TR_NAN_STEP,
      once (the LM's feeds are token ids, which the 'nan' step action
      leaves alone): FaultEvents anomaly 1 and 2, then a rollback, and
      every step the same bits as tr2's uninterrupted run; a retryable
      'error' step rule gives one retry event with unchanged losses; the
      guard's cost in step ms against tr2's run without it; its fault
      events go to the trace log;
  (tr4) Trainer.test over TR_TEST_BATCHES batches on tr3's trainer, then
      save_inference_model and fluid.Inferencer(param_path) on its
      default place, the card: each output within TR4_TOL of the test
      program's in fp32 (a saved program carries no AMP mark, in either
      package) and within TRAIN_LOSS_TOL of the AMP one's;
  (o1) tr1's steps on a fresh Trainer with FLAGS_obs_dir set (telemetry
      and trace on): perf.step_latency and perf.steps count the steps,
      perf.mfu and perf.achieved_tflops are set, the train program's
      cost_flops (FlopCounterMode over the warm-up, the flash op priced
      by the attention model) is within COST_FLOPS_RTOL of bench.py's
      count, the hbm.* gauges equal torch.cuda.memory_stats as step_end
      exports them, the xla.jit_cache counters equal the change in
      jit_cache_stats(); step ms with telemetry on against tr1's;
  (o2) LMServer answers c3's requests under FLAGS_slo_rules = O2_RULES
      (ttft p95 under 10 s holds, 1e9 tokens/s cannot): only the second
      rule breaches, its slo.breach events are in the events log, the
      streams are c3's, and report.write_report merges tr3's fault
      events and the breaches into one timeline (lanes trainer and
      serving) and a rollup with the serving.*, perf.* and trainer.*
      series.

Two phases drive the profiler and the record files:
  (pf1) after t4: the verify skill's fit_a_line drive through
      fluid.Executor(fluid.TPUPlace()); then PF_STEPS replayed steps of
      t1's program, each a RecordEvent('train_step'), under
      fluid.profiler.profiler('All', 'total', path) with obs tracing on:
      the host trace holds the train_step, device_segment: and
      host_op:read events, the device trace counts K1 and K2 t1's
      launches a step each, as the wrappers count them (a short window
      is taken again padded longer); the timeline tool
      (--xplane_dir, --hlo_dir) and report.write_report(xplane_dir=)
      put every kernel slice inside a train_step span, on one clock,
      within PF_SLACK_MS; then a fresh prepared program of the same LM
      profiled from its first run (warm-up, capture, PF_STEPS replays):
      every K1 and K2 launch of its graphs carries its flash op's
      `<type>.<idx>` through the op map of the warm-up, and the labeled
      share of the replays' device time is logged;
  (rf1) after r1, its graphs freed: r1's ResNet-50 fed from RF['files']
      RecordIO shards of RF['records'] u8 records (written with
      max_num_records=RF['per_chunk'], removed after the phase) through
      open_files(thread_num=RF['threads'], pass_num=0, image_norm=the
      ImageNet mean/std) -> batch -> double_buffer -> read_file, as
      tools/bench_input_pipeline.py builds it: the native decode's rate
      at 1, 2 and RF['threads'] threads; step ms from the shards and
      from a pre-placed feed by N/2N differencing, device busy; K6 r1's
      launches a step; a fed batch's images (x/255 - mean)/std of their
      records within RF_IMAGE_ATOL and their labels equal; and, under
      cuDNN's deterministic algorithms, a replayed shard-fed step from a
      saved state the same bits (loss and every persistable) as the
      pre-placed program's replay fed that batch through py_reader.

Two phases train in parameter-server mode, after rf1, each a cluster of
subprocesses of this script (`--ps-worker <role> <index>`, their phase
and endpoints in PSW_* env) on free localhost ports: 2 pservers on the
host and 2 trainers sharing the card; a role that fails fails the phase
and every child is killed however the phase ends:
  (ps1) tools/bench_suite.py's pserver row on the flagship LM at full
      width cut to PS1['layers'] layers (fp32, flash attention, sync SGD
      1e-3, batch 8 a trainer, one global batch PS_STEPS times): each
      trainer's blocks after its startup (the pull) are the pservers'
      slices (crc32), the trainers end on the same bits, within
      PS1_LOCAL_TOL of a local run of the program on the card over the
      same global batches, each parameter's update within PS_UPDATE_TOL
      of the local one (gradient-weighted) and the trainers' mean loss
      within PS_LOSS_TOL of the local one at every step, the losses
      fall, K1 fp32 and K2 fp32 launch
      2 a step on each trainer and no plain flash call runs; the step
      split into the device segment, send, the barriers and recv +
      concat, the wire's MB/s each way, the local step and the pservers'
      rounds are logged;
  (ps2) DeepFM at its Criteo settings (PS2) with the 10-wide table
      is_distributed (prefetched, SelectedRows shards backward) and the
      first-order table is_sparse, sync Adam 1e-3, batch 1000 a trainer:
      the same startup and agreement checks (the non-table weights within
      PS2_LOCAL_TOL, logged beside the same local run's spread on the
      CPU), every table row a batch touched changed and every row no
      batch touched the same bits on its pserver, the losses fall; step,
      prefetch and the rows a step on the wire are logged.

Three phases serve from processes of their own, last (after v6 and o2,
which hold c1's model in this process), each process
started fresh (never forked from this one), replicas through the entry
point users run, `python -m paddle_tpu_torch.tools.serve_replica`, each
waited on by its READY line:
  (on1) tests/test_online.py's cluster at the LM's width: ps1's program
      (PS1['layers'] layers, sync SGD 1e-3) trained ON_ROUNDS rounds by
      one trainer on the card with 2 pservers on the host (the same
      `--ps-worker <role> <index>` roles), while one serving process on the
      card runs an LMServer with enable_refresh(pservers): it installs
      version ON_ROUNDS, every parameter it serves has the digest of the
      trainer's pull after the last round, one process did it all
      (weight_swaps >= 1, no refresh failure), and its streams after the
      refresh are held to a fresh LMServer on that round's values by the
      margin rule; the trainer launched K1 fp32 and K2 fp32 2 a round,
      the serving process K1 fp32, and neither a plain flash call; the
      refresh latency, bytes and MB/s are logged;
  (fl1) c1's saved model (full width and depth, fp32) in 2 dense
      replicas behind a FleetRouter in this process: FL1_STREAMS streams
      of FL1_NEW_TOKENS over FL1_SESSIONS sessions while replica 1 exits
      at its FL1_KILL_POLL-th SRV_POLL (a FLAGS_fault_plan exit rule):
      every stream DONE, failovers >= 1, every stream held by the margin
      rule to its prompt served alone by an in-process LMServer over the
      same bytes; then
      a rolling deploy of version 1 (c1's weights plus a seeded
      perturbation, published by a ParameterService in this process) to
      2 fresh replicas with paused subscribers under live traffic: no
      stream dropped, each replica's digests the manifest's, the streams
      after it held to solo streams of the in-process server on version
      1; each clean
      replica's K1 fp32 launches (its LAUNCHES line at exit) > 0 with no
      plain flash call; tokens/s, TTFT, the failover's and each deploy's
      time (from the router's fleet.drain spans) are logged;
  (fl2) a prefill replica and 2 paged decode replicas: the pages shipped
      for a SYSTEM_PROMPT-token system prompt held to the rows this
      process's own paged server exports for it (bit-equal, else within
      RECOMPUTE_TOL), the prefix prefilled once on the prefill tier for
      4 fetches, then two bursts through the router's prefill tier,
      the prefill replica exiting at its FL2_KILL_REPLY-th page reply
      during the second: every stream DONE, local re-prefills >= 1,
      every stream held by the margin rule to its prompt served alone by
      this process's paged server, no kernel launched on the decode
      replicas; the bytes shipped and the ship time are logged.
  (mp1) the mesh, ring attention: the gloo probes (MP_PROBES on CUDA
      tensors in two processes, as parallel/collectives.py's table says)
      beside the ring's blocks at [16, 2048, 128] bf16 against their
      plain versions (a diagonal and an off-diagonal block's K1 and K2,
      one rank's merged (o, lse)) and the one-process step of l1's
      program; then bench_long_context's LM (cut to 2 layers) with
      ring_attention=True on
      DistributedStrategy(sp=4), 4 ranks sharing the card under gloo
      (`--ps-worker rank <r>` processes), 3 AMP Momentum steps: K1 and
      K2 4(r + 1) each a step on rank r, no plain flash call, the loss
      within TRAIN_LOSS_TOL and the first step's updates within
      TRAIN_UPDATE_TOL (gradient-weighted) of the one-process step,
      the ranks' reserved memory under MP_RESERVED_GB summed; each
      rank's step ms, rotation and collective seconds, bytes, memory and
      collective_audit logged;
  (mp2) the flagship LM at full width cut to 2 layers, use_tp and use_sp,
      on DistributedStrategy(dp=2, tp=2), batch 8, 3 AMP Momentum steps
      against the same program in one process (the same bounds); every
      tp weight held as its half by its placements, all-reduces in the
      audit and no tp weight gathered.
  (pp1) the pipeline engine: the flagship LM at full width cut to 4
      layers, pp_stages=2 (2 layers a stage), on DistributedStrategy(
      pp=2, dp=2, micro_batches=4), 4 ranks sharing the card under gloo,
      batch 8, 3 AMP Momentum steps against the same program in one
      process (mp2's bounds); K1 bf16 and K2 each (layers a stage) x
      (microbatches a rank) = 8 a step on every rank, 32 over the 4,
      no plain flash call; each rank's step ms, the seconds it waited in
      the pp receives, the activation and cotangent bytes it sent, the
      pp gradient sum's bytes, memory and collective_audit logged;
  (ck1) sharded checkpoints and the kill: mp2's model on
      DistributedStrategy(dp=2, sharded_params=True) (ZeRO-3) under AMP
      Adam, a fluid.Trainer(strategy=) with CheckpointConfig(
      sharded=True, step_interval=CK1['interval']) on 2 ranks (`--ps-
      worker ckrank <r>` processes) under a Supervisor, CK1['steps']
      steps, twice, beside a3 and a4 (which check values only): fault-free, and with rank 1 killed at its
      CK1['kill_step']-th step (rank 0 then fails in gloo, both restart
      at incarnation 1 on a fresh rendezvous and resume from the last
      committed generation): every final weight and Adam moment the
      same bits as the fault-free run's (sha1 of each rank's part of
      each var), the root's
      OWNER at incarnation 1; the last generation restored in this
      process on the card (no mesh) the same bits; under
      PADDLE_FLASH_BWD=split (the deterministic backward, as tr2), K1,
      K3a and K3b layers a step on each rank of the fault-free run; a
      save's blocking and
      async ms, its bytes and files a rank, its largest host buffer (at
      most one shard) and the restore's ms logged.

It prints the card's name and power limit (nvidia-smi), the kernels
line, the serving and training numbers (an Adam line and a sequences
line among them), its own wall time, and as its last line {"ok": true,
"device": {...}}. Without a CUDA device, or without the package beside
it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import warnings

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

MODEL = dict(vocab=32768, dim=2048, heads=16, layers=12, ffn=8192,
             max_len=512, flash_attention=True, use_tp=False, use_sp=False)
SLOTS, PREFILL_BATCH, N_REQUESTS, NEW_TOKENS = 8, 1, 8, 32
SEED = 1234
# the training step of bench.py's bench_transformer (:253-271)
TRAIN_BATCH, HEAD_CHUNK, WARMUP_STEPS, TIMED_STEPS, PROFILE_STEPS = \
    8, 4096, 2, 5, 3
PARAMS_COMPARED = ('layer0_qkv.w_0', 'layer11_down.w_0', 'lm_head.w_0')

# a1-a4: the same LM with TransformerConfig's own use_tp / use_sp (True:
# the one-device tensor- and sequence-parallel layers and annotations),
# trained with the Transformer recipe Fluid users ran: Adam over
# noam_decay(d_model, 4000), beta2 0.98, epsilon 1e-9, global-norm clip 1
ADAM_MODEL = {k: v for k, v in MODEL.items() if k not in ('use_tp', 'use_sp')}
ADAM = dict(warmup_steps=4000, beta1=0.9, beta2=0.98, epsilon=1e-9,
            clip_norm=1.0)
# PARAMS_COMPARED's three weights under the parallel layers' names (there
# 'layer0_qkv.w_0' is the qkv bias, whose key third has no gradient)
ADAM_PARAMS_COMPARED = ('layer0_qkv_0.w', 'layer11_down_0.w', 'lm_head.w_0')
# the rate, the step counter and the beta powers against their closed
# forms, relative
SCHEDULE_RTOL = 1e-6
# a3: the eleven optimizer updates on the card against the same emitter
# on CPU copies, |out - ref| <= OPT_TOL * max(1, |ref|)
OPT_SHAPES = ((2048, 8192), (1,), (1000, 37))
OPT_TOL = 1e-5
# a4: the op types of the training core on the card against the same
# emitters on CPU copies (fp32); integer and bool outputs exact
OP_RTOL, OP_ATOL = 1e-5, 1e-6
DROPOUT_P, DROPOUT_N = 0.3, 1 << 20
# h: shapes the flash kernels do not take ([B, H, T, d], dtype), routed
# to the plain version on the card
UNTAKEN_FLASH = (((2, 4, 128, 16), 'float32'), ((2, 4, 128, 16), 'bfloat16'),
                 ((2, 4, 128, 32), 'float32'), ((2, 4, 128, 32), 'bfloat16'),
                 ((2, 4, 128, 64), 'float16'))

# bench.py's bench_resnet (:128-189): ResNet-50 at 224 px, 1000 classes,
# NCHW (the fused conv2d_bn op is NCHW-only), batch RESNET_BATCH
RESNET = dict(depth=50, image_hw=224, class_dim=1000)
RESNET_BATCH = 256
RESNET_PARAMS_COMPARED = ('conv_bn_0.w_0', 'conv_bn_2.w_0', 'fc_0.w_0')
# r2: the kernel step's update differences may reach this multiple of the
# plain step's own spread when only its column sums change order (fp64)
RESNET_SPREAD_FACTOR = 2.0
# the ResNet step's peak device memory, captured graphs' pools included,
# stays under this on the 80 GB card (PERF.md section 2)
RESNET_PEAK_GB = 70.0
K6_SOURCE = ('matmul_bn_stats', 'paddle_tpu/pallas/conv_bn.py:38',
             'paddle_tpu_torch/csrc/conv_bn.cu')
# K6 vs its plain version: |y - y_ref| <= tol * max(1, |y_ref|) (bf16 y
# is the same fp32 value rounded once); each column sum within 1e-4 of
# the column's sum of |y| (Σy) or of y² (Σy²): fp32 sums in another order
K6_SUM_RTOL = 1e-4
# fused conv_bn vs conv2d + batch_norm in fp32 (Y is normalised to O(1))
PAIR_TOL = 1e-4

# bench.py's bench_long_context (:274-295): T=8192, batch 2, fused head
# with chunk 8192, under the two alternative flash arms
LC_MODEL = dict(vocab=32768, dim=1024, heads=8, layers=4, ffn=4096,
                max_len=8192, flash_attention=True)
LC_BATCH, LC_HEAD_CHUNK, LC_READER = 2, 8192, 'lc_reader'
LC_ARMS = ('twopass', 'onepass')      # PADDLE_FLASH_FWD, PADDLE_FLASH_BWD
LC_PARAMS_COMPARED = ('layer0_qkv.w_0', 'layer3_down.w_0', 'lm_head.w_0')

# kernel vs plain version on the card: fp32 math in both; bf16 outputs
# are rounded once (2^-8 relative), and K2's dq and K5's dk, dv are
# summed with atomics. lse is fp32 in every dtype: K4a's is held to the
# fp32 tolerance.
KERNEL_ATOL = {'float32': 1e-4, 'bfloat16': 2e-2}
# bf16 K4b also within a relative bound: max |o - o_ref| / (|o_ref| +
# mean |o_ref|). At [16, 8192, 128] typical |o| (~1.8e-2) lies below the
# bf16 atol, which would pass an o a few per cent off everywhere; o is
# rounded to bf16 once (2^-8 relative at most)
O_RTOL = 2e-2
# bf16 K2 and K5 (one tensor-core kernel) also within a relative bound on
# each gradient: max |g - g_ref| / (|g_ref| + mean |g_ref|) for dq, dk and
# dv. At [16, 8192, 128] mean |g| is ~1e-2 while the first rows and keys
# of a head carry |g| near 1, so the atol alone would pass gradients a
# few per cent off where |g| is small; each gradient is rounded to bf16
# once (2^-8 relative at most). A gradient that is zero in exact
# arithmetic (dq and dk at T = 1, a softmax over one key) comes out of
# the fp32 plain version as rounding noise, so the mean in the
# denominator is floored at the fp32 atol, far below mean |g| at the
# paths' shapes (b4 logs it at [16, 8192, 128])
G_RTOL = 2e-2
G_FLOOR = 1e-4
# P vs its plain version: expf / exp2f against torch.exp / torch.exp2,
# each within a few ulps; the chain x <- f(-(x/2 + 1/4)) shrinks errors
# (|d/dx| < 0.4), and its values lie in (0, 1]
PROBE_ATOL = 1e-6
RECOMPUTE_TOL = 1e-3        # prefill vs full recompute (rtol and atol)
# v1-v6: the flagship LM served from the paged cache (FLAGS_serving_*
# defaults: 16-token pages, the auto pool of slots x pages a slot + 1
# pages, 64-token prefill chunks); v3 on half that pool
PAGE_TOKENS, PREFILL_CHUNK, TIGHT_KV_PAGES = 16, 64, 129
SYSTEM_PROMPT = 256         # v2: 4 chunks, 16 pages
V3_STREAMS, V3_NEW_TOKENS, V3_SWAP_HOST_MB = 8, 96, 8192
SPEC_K = 4                  # v4: FLAGS_spec_k's default
SWAP_NEW_TOKENS = 24        # v5
# the margin rule: two greedy streams agree if equal, or if where they
# first differ both tokens are within this of the reference path's best
# logit (d's prefill vs recompute bound)
MARGIN_TOL = RECOMPUTE_TOL
# kernel step vs plain step under bf16 AMP: |loss difference|, and the
# largest update difference over the largest update of each parameter
TRAIN_LOSS_TOL = 1e-2
TRAIN_UPDATE_TOL = 5e-2

# H100 SXM peaks (NVIDIA data sheet, dense): fp32 outside the tensor
# cores, bf16 on the tensor cores, and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989.4e12
PEAK_BYTES_PER_S = 3.35e12


class PhaseError(RuntimeError):
    pass


def log(msg):
    print(msg, flush=True)


def phase(name):
    """Run the decorated function as one named phase: any exception is
    reported and turns into a PhaseError."""
    def deco(fn):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            log('== phase %s' % name)
            try:
                out = fn(*args, **kwargs)
            except Exception as e:
                raise PhaseError('phase %s failed: %s: %s'
                                 % (name, type(e).__name__, e)) from e
            log('== phase %s ok (%.1f s)' % (name, time.perf_counter() - t0))
            return out
        return run
    return deco


def gpu_name_and_power_limit():
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters=20, warmup=3):
    """Mean device time of fn() over `iters` calls, by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


BRACKET_ORDER = ('ms', 'plain_ms', 'library_ms', 'matmul_ms')


def bracketed_ms(fns):
    """Time each of fns {'ms', 'plain_ms', 'library_ms', 'matmul_ms'}
    twice in the order kernel, plain, library, product alone, then back
    (product alone, library, plain, kernel), so the pairs bracket drift
    in clocks; each time is the mean of its two runs."""
    runs = {key: [] for key in fns}
    for key in BRACKET_ORDER + BRACKET_ORDER[::-1]:
        if key in fns:
            runs[key].append(cuda_ms(fns[key]))
    return {key: float(np.mean(v)) for key, v in runs.items()}


# -- (a) ---------------------------------------------------------------------

KERNEL_SOURCES = ('flash_attention_fwd', 'flash_attention_bwd', 'conv_bn',
                  'probe_exp2')


@phase('a: build kernels')
def build_kernels():
    from paddle_tpu_torch.kernels import build
    t0 = time.perf_counter()
    paths = build.build(*KERNEL_SOURCES)
    for name, path in paths.items():
        log('built %s -> %s' % (name, os.path.relpath(path, HERE)))
        for line in build.build_logs.get(name, '').splitlines():
            # each kernel's name, registers and spills, and any warning
            # (a serialised wgmma among them)
            if any(w in line for w in ('Compiling entry', 'registers',
                                       'spill', 'arning')):
                log('  ptxas: %s' % line.strip())
    for source, mark in (('flash_attention_fwd', 'flash_fwd_f32_kernel'),
                         ('flash_attention_fwd', 'flash_fwd_wgmma_kernel'),
                         ('flash_attention_bwd', 'flash_bwd_wgmma_kernel'),
                         ('flash_attention_bwd', 'flash_bwd_dq_wgmma_kernel'),
                         ('flash_attention_bwd',
                          'flash_bwd_dkv_wgmma_kernel'),
                         ('conv_bn', 'matmul_bn_stats_wgmma_kernel')):
        for entry, regs, stores, loads in ptxas_report(
                build.build_logs.get(source, ''), mark):
            log('ptxas %s: %d registers, %d bytes spill stores, %d bytes '
                'spill loads' % (entry, regs, stores, loads))
    log('build seconds: %.2f' % (time.perf_counter() - t0))


def ptxas_report(log_text, mark):
    """[(kernel, registers, spill store bytes, spill load bytes)] for
    every entry function of nvcc's -Xptxas -v log whose mangled name holds
    `mark`; the kernel is named `mark<template arguments>`."""
    import re
    out, entry, spills = [], None, (0, 0)
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = None
            if mark in m.group(1):
                args = re.search(re.escape(mark) + r'I(.*?)EE', m.group(1))
                entry = '%s<%s>' % (mark, ', '.join(
                    re.findall(r'Li(\d+)E', (args.group(1) + 'E')
                               if args else '')))
            continue
        m = re.search(r'(\d+) bytes spill stores, (\d+) bytes spill loads',
                      line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r'Used (\d+) registers', line)
        if m and entry:
            out.append((entry, int(m.group(1))) + spills)
            entry = None
    return out


# -- (b) ---------------------------------------------------------------------

# (name in the kernels line, TPU body it replaces, source, FLOP per
# visited score per head-dim column, [BH, T, d] matrices read, [BH, T, d]
# matrices written, fp32 [BH, T] rows read or written)
KERNELS = {
    'fwd': ('flash_attention_fwd', 'paddle_tpu/pallas/flash_attention.py:171',
            'paddle_tpu_torch/csrc/flash_attention_fwd.cu', 4, 3, 1, 1),
    'k2': ('flash_attention_bwd_kvmajor',
           'paddle_tpu/pallas/flash_attention.py:512',
           'paddle_tpu_torch/csrc/flash_attention_bwd.cu', 10, 4, 3, 2),
    'k3a': ('flash_attention_bwd_dq',
            'paddle_tpu/pallas/flash_attention.py:339',
            'paddle_tpu_torch/csrc/flash_attention_bwd.cu', 6, 4, 1, 2),
    'k3b': ('flash_attention_bwd_dkv',
            'paddle_tpu/pallas/flash_attention.py:385',
            'paddle_tpu_torch/csrc/flash_attention_bwd.cu', 8, 4, 2, 2),
    'k4a': ('flash_attention_fwd_stats',
            'paddle_tpu/pallas/flash_attention.py:229',
            'paddle_tpu_torch/csrc/flash_attention_fwd.cu', 2, 2, 0, 1),
    'k4b': ('flash_attention_fwd_acc',
            'paddle_tpu/pallas/flash_attention.py:276',
            'paddle_tpu_torch/csrc/flash_attention_fwd.cu', 4, 3, 1, 1),
    'k5': ('flash_attention_bwd_onepass',
           'paddle_tpu/pallas/flash_attention.py:436',
           'paddle_tpu_torch/csrc/flash_attention_bwd.cu', 10, 4, 3, 2),
}
PROBE_SOURCE = ('probe_exp2_chain', 'tools/probe_exp2.py:26',
                'paddle_tpu_torch/csrc/probe_exp2.cu')


def flash_bound_ms(kind, BH, T, d, causal, dtype):
    """Least time for the work of one call: the visited scores
    (causal: T(T+1)/2 per head) x FLOP per score at the peak of the
    call's type (fp32 CUDA cores, bf16 tensor cores), against every
    input read once and every output written once (KERNELS: the
    [BH, T, d] matrices in the call's dtype, the rows lse and delta in
    fp32)."""
    flop_per_col, n_in, n_out, n_rows = KERNELS[kind][3:]
    es = 4 if dtype == 'float32' else 2
    pairs = T * (T + 1) // 2 if causal else T * T
    flops = float(flop_per_col) * BH * pairs * d
    nbytes = es * (n_in + n_out) * BH * T * d + 4 * n_rows * BH * T
    peak = PEAK_FP32_FLOPS if dtype == 'float32' else PEAK_BF16_FLOPS
    t_ops = flops / peak * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ('operations' if t_ops >= t_bytes
                                 else 'bytes')


def sdpa_yardstick(q, k, v, causal):
    """The library yardstick of the flash kernels, timed only: returns
    (call, backend), where call() runs scaled_dot_product_attention on
    4-D views [1, BH, T, d] of q, k, v ([BH, T, d], or [B, H, T, d] as
    they are) under the one fused backend that takes them: flash
    attention first, else memory-efficient attention. PyTorch's fused
    backends refuse 3-D inputs, so without the views every call took the
    unfused math path. Raises if no fused backend takes the inputs: the
    math path is never timed."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    q4, k4, v4 = (t if t.dim() == 4 else t.unsqueeze(0) for t in (q, k, v))
    errors = []
    for backend in (SDPBackend.FLASH_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION):
        def call(backend=backend):
            with sdpa_kernel([backend]):
                return F.scaled_dot_product_attention(q4, k4, v4,
                                                      is_causal=causal)
        try:
            with warnings.catch_warnings():
                # a refusing backend warns its reasons before it raises
                warnings.simplefilter('ignore', UserWarning)
                call()
        except RuntimeError as e:
            errors.append('%s: %s' % (backend.name, str(e).splitlines()[0]))
            continue
        return call, backend.name
    raise RuntimeError('no fused scaled_dot_product_attention backend takes '
                       '%s %s: %s' % (tuple(q4.shape), q4.dtype,
                                      '; '.join(errors)))


# edge shapes of every flash kernel check: (BH, T, d, causal)
RAGGED_SHAPES = ((3, 200, 64, False), (2, 130, 128, True), (4, 64, 64, True),
                 (1, 1, 128, False), (2, 1, 64, True))


def _inputs(rng, BH, T, d, dtype, device):
    """q, k, v, dO from a seeded numpy stream, in the working dtype."""
    import torch
    mk = lambda s: torch.from_numpy(  # noqa: E731
        (rng.randn(BH, T, d) * s).astype('float32')).to(device).to(
            getattr(torch, dtype))
    return mk(0.5), mk(0.5), mk(1.0), mk(1.0)


def _max_err(got, want):
    return max((g.float() - w.float()).abs().max().item()
               for g, w in zip(got, want))


def _check_shape(fa, rng, dev, BH, T, d, causal, dtype, fp64=False):
    """Run K1, K2, K3a and K3b once at one shape and hold each against
    its plain version (K1 by check_fwd_output; the gradients of K2, K3a
    and K3b by check_grads: G_RTOL in bf16), and launch K1, K3a and K3b
    a second time on the same inputs: K1 sums each row's keys in one
    order (engine streams must equal solo streams, phase e) and the split
    arm is the deterministic one, so both launches must give the same
    bits. fp64=True also logs K1's and its plain version's distance from
    an fp64 evaluation. Returns {kind: max_abs_err}."""
    import torch
    q, k, v, do = _inputs(rng, BH, T, d, dtype, dev)
    scale = d ** -0.5
    o, lse = fa.flash_attention_fwd(q, k, v, causal, scale)
    o2, lse2 = fa.flash_attention_fwd(q, k, v, causal, scale)
    torch.cuda.synchronize()
    o_ref, lse_ref = fa.flash_attention_reference(q, k, v, causal, scale)
    o_err, o_rel, lse_err, fwd_ok = check_fwd_output(o, lse, o_ref, lse_ref,
                                                     dtype)
    errs = {'fwd': max(o_err, lse_err)}
    if fp64:
        _log_fwd_fp64(q, k, v, causal, scale, (o, lse), (o_ref, lse_ref),
                      '[%d, %d, %d] causal=%s %s' % (BH, T, d, causal,
                                                     dtype))
    finite = bool(torch.isfinite(o).all())
    # the backward kernels get the plain forward's o and lse, so each is
    # held to the plain backward on identical inputs
    delta = fa.bwd_delta(o_ref, do)
    dq, dk, dv = fa.flash_attention_bwd_reference(q, k, v, o_ref, lse_ref,
                                                  do, causal, scale)
    args = (q, k, v, do, lse_ref, delta, causal, scale)
    got = {'k2': fa.flash_attention_bwd_kvmajor(*args),
           'k3a': (fa.flash_attention_bwd_dq(*args),),
           'k3b': fa.flash_attention_bwd_dkv(*args)}
    again = {'k3a': (fa.flash_attention_bwd_dq(*args),),
             'k3b': fa.flash_attention_bwd_dkv(*args)}
    torch.cuda.synchronize()
    want = {'k2': (dq, dk, dv), 'k3a': (dq,), 'k3b': (dk, dv)}
    rels, oks = {}, {'fwd': fwd_ok}
    for kind, out in got.items():
        errs[kind], rels[kind], oks[kind] = check_grads(out, want[kind], dtype)
        finite = finite and all(bool(torch.isfinite(t).all()) for t in out)
    same = {'fwd': torch.equal(o, o2) and torch.equal(lse, lse2)}
    same.update((kind, all(torch.equal(a, b)
                           for a, b in zip(got[kind], out)))
                for kind, out in again.items())
    bad = [kind for kind in errs if not oks[kind]]
    varied = [kind for kind, s in same.items() if not s]
    log('[%d, %d, %d] causal=%s %s: max_abs_err %s (atol %g); %s o %.3e, '
        'lse %.3e (atol %g), o relative %.3e; relative %s (bounds %s); '
        'second launch bit-identical: %s %s'
        % (BH, T, d, causal, dtype,
           ', '.join('%s %.3e' % (KERNELS[kd][0], e)
                     for kd, e in errs.items()),
           KERNEL_ATOL[dtype], KERNELS['fwd'][0], o_err, lse_err,
           KERNEL_ATOL['float32'], o_rel,
           '; '.join('%s %s %s' % (KERNELS[kd][0], _GRAD_NAMES[kd],
                                   ', '.join('%.3e' % r for r in rs))
                     for kd, rs in rels.items()),
           '%g / %g' % (O_RTOL, G_RTOL) if dtype == 'bfloat16' else 'none',
           ', '.join('%s %s' % (KERNELS[kd][0], 'yes' if s else 'NO')
                     for kd, s in same.items()),
           'ok' if not bad and not varied and finite else 'MISMATCH'))
    faults = (['%s disagree with their plain versions'
               % [KERNELS[kd][0] for kd in bad]] if bad else []) + \
        (['%s give other bits on a second launch'
          % [KERNELS[kd][0] for kd in varied]] if varied else []) + \
        ([] if finite else ['a result is not finite'])
    if faults:
        raise AssertionError('%s at [%d, %d, %d] %s'
                             % ('; '.join(faults), BH, T, d, dtype))
    return errs


def _log_fwd_fp64(q, k, v, causal, scale, got, plain, label):
    """Log K1's (o, lse) and its plain version's distance from K1's
    function evaluated in fp64 from the same inputs: shows the fp32
    contract (exact fp32 products, no TF32) rather than assuming it."""
    import torch
    s = torch.matmul(q.double() * scale, k.double().transpose(-1, -2))
    if causal:
        T = q.shape[-2]
        keep = torch.ones((T, T), dtype=torch.bool, device=q.device).tril()
        s.masked_fill_(~keep, float('-inf'))
    lse64 = torch.logsumexp(s, dim=-1)
    o64 = torch.matmul(s.sub_(lse64[..., None]).exp_(), v.double())
    del s
    errs = [(x.double() - want).abs().max().item()
            for pair in (got, plain) for x, want in zip(pair, (o64, lse64))]
    log('%s: vs fp64 max_abs_err flash_attention_fwd o %.3e, lse %.3e; its '
        'plain version o %.3e, lse %.3e' % ((label,) + tuple(errs)))
    return errs


# the gradients each backward kind returns, in the order it returns them
_GRAD_NAMES = {'k2': 'dq, dk, dv', 'k3a': 'dq', 'k3b': 'dk, dv'}


def _row(kind, dtype, shape, causal, err, times, bound):
    name, replaces, source = KERNELS[kind][:3]
    if kind == 'fwd' and dtype == 'bfloat16':
        name = 'flash_attention_fwd_bf16'
    return {'name': name, 'route': 'cuda', 'source': source,
            'replaces': replaces, 'launches': None, 'max_abs_err': err,
            'ms': times['ms'], 'plain_ms': times['plain_ms'],
            'bound_ms': bound[0], 'bound_by': bound[1],
            'library_ms': times.get('library_ms'),
            'device_ms': times.get('device_ms'),
            'shape': list(shape), 'dtype': dtype, 'causal': causal}


def _over_library(device_ms, library_ms):
    """' (N.NNx the library)' from two torch.profiler device times, the
    one clock both are read on; '' where either is missing."""
    if device_ms is None or library_ms is None:
        return ''
    return ' (%.2fx the library by device time)' % (device_ms / library_ms)


def _fmt_ms(x):
    return 'n/a' if x is None else '%.4f' % x


def _log_rows(rows):
    for r in rows:
        log('%s %s %s: kernel %.4f ms (device time %s ms), plain %.4f ms, '
            'library %s ms, bound %.4f ms (%s)%s'
            % (r['name'], r['dtype'], r['shape'], r['ms'],
               _fmt_ms(r.get('device_ms')), r['plain_ms'],
               _fmt_ms(r['library_ms']),
               r['bound_ms'], r['bound_by'],
               _over_library(r.get('device_ms'), r['library_ms'])))


# host seconds a torch.profiler window holds on each side of its calls,
# window by window, before a device time is given up as not measured.
# Late in the script (b6, l1) the profiler has dropped device events near
# a window's edges on an H100: windows over K6 came back empty, or with
# its memsets and without K6, and l1's replay window without the step's
# first K4a launch; windows padded by 0.3 to 4 s saw them all. So every
# window is padded, and each window after a short one longer
WINDOW_PADS_S = (0.1, 0.3, 1.0, 2.0, 4.0, 8.0)
DEVICE_MS_WINDOWS = len(WINDOW_PADS_S)


@contextlib.contextmanager
def device_window(pad=WINDOW_PADS_S[0]):
    """A torch.profiler window over the CPU and the card that holds `pad`
    host seconds before and after its body; yields the profiler."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(pad)
        yield prof
        time.sleep(pad)


def _device_ms(fn, iters=10):
    """Device time of one fn() from torch.profiler: the sum of its
    kernels' time over `iters` calls, per call. A window counts only if
    it saw a device event and every launch the kernel wrappers counted
    in it (LAUNCH_GROUPS; b6 has had windows that kept K6's small
    kernels and lost K6 itself); None if no window of DEVICE_MS_WINDOWS
    (padded as WINDOW_PADS_S) did. Unlike CUDA events around the calls,
    it leaves out the time the card waits for the host."""
    import torch
    from torch.autograd import DeviceType
    fn()
    torch.cuda.synchronize()
    for pad in WINDOW_PADS_S:
        before = wrapper_counts()
        with device_window(pad) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        after = wrapper_counts()
        averages = prof.key_averages()
        device = [e for e in averages
                  if getattr(e, 'device_type', None) == DeviceType.CUDA]
        us = sum(_device_us(e) for e in device)
        seen = {}
        for e in device:
            group = launch_group(e.key)
            if group:
                seen[group] = seen.get(group, 0) + e.count
        missed = launch_mismatch(seen, before, after)
        if us > 0 and not missed:
            if pad != WINDOW_PADS_S[0]:
                log('torch.profiler: device events seen in a window padded '
                    'by %g s' % pad)
            return us / iters / 1e3
        log('torch.profiler: %s in a window padded by %g s (%d host events)'
            % ('launches other than counted, {group: (profiled, counted)} '
               '%r,' % missed if missed else 'no device event', pad,
               len(averages) - len(device)))
    return None


def _library_ms(fn):
    """Device time of one library call fn() by torch.profiler, the only
    clock the yardstick is read on: at small shapes the card runs the
    library's calls faster than the host issues them, so CUDA events
    around the calls would time the host. Raises if the profiler sees no
    device time."""
    ms = _device_ms(fn)
    if ms is None:
        raise RuntimeError('torch.profiler saw no device time in the '
                           'library call')
    return ms


def _library_fwd_bwd(q, k, v, do, causal, label):
    """The yardstick's forward, and its backward as fwd+bwd minus fwd,
    both by _library_ms. Returns (fwd ms, bwd ms)."""
    import torch
    qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))
    fwd, backend = sdpa_yardstick(qg, kg, vg, causal)
    do4 = do.reshape(fwd().shape)

    def fwd_bwd():
        torch.autograd.grad(fwd(), (qg, kg, vg), do4)

    fwd_ms, both_ms = _library_ms(fwd), _library_ms(fwd_bwd)
    log('library (scaled_dot_product_attention, backend %s, %s %s causal=%s):'
        ' device time fwd %.4f ms, bwd %.4f ms (fwd+bwd minus fwd)'
        % (backend, label, list(q.shape), causal, fwd_ms, both_ms - fwd_ms))
    return fwd_ms, both_ms - fwd_ms


def _timed(fns):
    """bracketed_ms of fns, plus the kernel's device time by
    torch.profiler ('device_ms', None if not measured)."""
    times = bracketed_ms(fns)
    times['device_ms'] = _device_ms(fns['ms'])
    return times


@phase('b: kernels vs plain versions')
def check_kernels(cfg):
    """Correctness at the paths' shapes and at ragged ones, then times at
    the paths' shapes. Returns the kernels line's rows."""
    import torch
    from paddle_tpu_torch.kernels import flash_attention as fa
    rng = np.random.RandomState(SEED)
    dev = torch.device('cuda', 0)
    d = cfg.dim // cfg.heads
    T = cfg.max_len
    serve_bh = PREFILL_BATCH * cfg.heads      # the prefill's attention
    train_bh = TRAIN_BATCH * cfg.heads        # the training step's
    path_errs = {}
    shapes = [(serve_bh, T, d, True, 'float32'),
              (train_bh, T, d, True, 'bfloat16'),
              (train_bh, T, d, True, 'float32')]
    shapes += [s + (dtype,) for dtype in ('float32', 'bfloat16')
               for s in RAGGED_SHAPES]
    for BH, t, dd, causal, dtype in shapes:
        serving = (BH, t, dd, dtype) == (serve_bh, T, d, 'float32')
        errs = _check_shape(fa, rng, dev, BH, t, dd, causal, dtype,
                            fp64=serving)
        if serving:
            path_errs[('fwd', 'float32')] = errs['fwd']
        if (BH, t, dd) == (train_bh, T, d) and dtype == 'bfloat16':
            for kind, e in errs.items():
                path_errs[(kind, 'bfloat16')] = e

    rows = []
    scale = d ** -0.5
    # K1 fp32 at the serving shape, as in the first slice
    q, k, v, _ = _inputs(rng, serve_bh, T, d, 'float32', dev)
    library, backend = sdpa_yardstick(q, k, v, True)
    times = _timed({
        'ms': lambda: fa.flash_attention_fwd(q, k, v, True, scale),
        'plain_ms': lambda: fa.flash_attention_reference(q, k, v, True,
                                                         scale)})
    times['library_ms'] = _library_ms(library)
    log('library (scaled_dot_product_attention, backend %s, float32 %s '
        'causal=True): device time fwd %.4f ms'
        % (backend, [serve_bh, T, d], times['library_ms']))
    rows.append(_row('fwd', 'float32', (serve_bh, T, d), True,
                     path_errs[('fwd', 'float32')], times,
                     flash_bound_ms('fwd', serve_bh, T, d, True,
                                    'float32')))

    # the training step's kernels: bf16 [BH, T, d] causal
    q, k, v, do = _inputs(rng, train_bh, T, d, 'bfloat16', dev)
    o, lse = fa.flash_attention_fwd(q, k, v, True, scale)
    delta = fa.bwd_delta(o, do)
    args = (q, k, v, do, lse, delta, True, scale)
    lib_fwd_ms, lib_bwd_ms = _library_fwd_bwd(q, k, v, do, True, 'bf16')
    plain_bwd = lambda: fa.flash_attention_bwd_reference(  # noqa: E731
        q, k, v, o, lse, do, True, scale)
    fns = {
        'fwd': {'ms': lambda: fa.flash_attention_fwd(q, k, v, True, scale),
                'plain_ms': lambda: fa.flash_attention_reference(
                    q, k, v, True, scale)},
        'k2': {'ms': lambda: fa.flash_attention_bwd_kvmajor(*args),
               'plain_ms': plain_bwd},
        'k3a': {'ms': lambda: fa.flash_attention_bwd_dq(*args),
                'plain_ms': plain_bwd},
        'k3b': {'ms': lambda: fa.flash_attention_bwd_dkv(*args),
                'plain_ms': plain_bwd},
    }
    for kind, f in fns.items():
        times = _timed(f)
        times['library_ms'] = lib_fwd_ms if kind == 'fwd' else lib_bwd_ms
        rows.append(_row(kind, 'bfloat16', (train_bh, T, d), True,
                         path_errs[(kind, 'bfloat16')], times,
                         flash_bound_ms(kind, train_bh, T, d, True,
                                        'bfloat16')))
    _log_rows(rows)
    return rows


def _acc_fp64_err(q, k, v, lse, causal, scale, outs):
    """Max |x - o64| for each x in outs, where o64 = exp(s - lse)·v is
    evaluated in fp64 (no all-masked rows): another order of sums and
    another rounding than any fp32 evaluation."""
    import torch
    s = torch.matmul(q.double() * scale, k.double().transpose(-1, -2))
    if causal:
        T = q.shape[-2]
        keep = torch.ones((T, T), dtype=torch.bool, device=q.device).tril()
        s.masked_fill_(~keep, float('-inf'))
    s.sub_(lse.double()[..., None]).exp_()
    o64 = torch.matmul(s, v.double())
    del s
    return [(x.double() - o64).abs().max().item() for x in outs]


def _acc_one_bf16_p(q, k, v, lse, causal, scale):
    """K4b's function with P = exp(s - lse) rounded once to v's dtype
    before P·v, as the TPU kernel rounds it (no all-masked rows)."""
    import torch
    s = torch.matmul(q.float() * scale, k.float().transpose(-1, -2))
    if causal:
        T = q.shape[-2]
        keep = torch.ones((T, T), dtype=torch.bool, device=q.device).tril()
        s.masked_fill_(~keep, float('-inf'))
    p = s.sub_(lse[..., None]).exp_().to(v.dtype)
    del s
    return torch.matmul(p.float(), v.float()).to(q.dtype)


def rel_err(x, ref, floor=0.0):
    """max |x - ref| / (|ref| + max(mean |ref|, floor)), elementwise in
    fp32: K4b's o (no floor) and the backward's gradients (G_RTOL's
    comment says why their floor)."""
    x, ref = x.float(), ref.float()
    mag = ref.abs()
    return ((x - ref).abs() /
            (mag + max(mag.mean().item(), floor))).max().item()


def check_acc_output(o, o_ref, dtype):
    """K4b's o against its plain version: (max_abs_err, rel_err, ok);
    ok needs the atol of the dtype and, in bf16, O_RTOL."""
    err, rel = _max_err((o,), (o_ref,)), rel_err(o, o_ref)
    ok = err <= KERNEL_ATOL[dtype] and (dtype != 'bfloat16' or rel <= O_RTOL)
    return err, rel, ok


def check_fwd_output(o, lse, o_ref, lse_ref, dtype):
    """K1's (o, lse) against its plain version: (o max_abs_err, o rel_err,
    lse max_abs_err, ok); ok needs o as check_acc_output holds K4b's (the
    atol of the dtype and, in bf16, O_RTOL) and lse within the fp32 atol
    in both dtypes, as K4a's lse is held."""
    o_err, o_rel, o_ok = check_acc_output(o, o_ref, dtype)
    lse_err = _max_err((lse,), (lse_ref,))
    return o_err, o_rel, lse_err, o_ok and lse_err <= KERNEL_ATOL['float32']


def check_grads(got, want, dtype):
    """(dq, dk, dv) against their plain versions: (max_abs_err, relative
    error of each by rel_err with G_FLOOR, ok); ok needs the atol of the
    dtype and, in bf16, G_RTOL on each gradient."""
    err = _max_err(got, want)
    rels = [rel_err(g, w, G_FLOOR) for g, w in zip(got, want)]
    ok = err <= KERNEL_ATOL[dtype] and (dtype != 'bfloat16' or
                                        max(rels) <= G_RTOL)
    return err, rels, ok


def _bwd_fp64(q, k, v, o, lse, do, causal, scale, heads=2):
    """The backward's (dq, dk, dv) evaluated in fp64 from the same
    inputs (o and lse as given), `heads` heads at a time; and the same
    function in fp32 with P and dS rounded once to bf16 before their
    products, as the TPU kernels round them (:409, :412). No all-masked
    rows."""
    import torch
    BH, T, _ = q.shape
    keep = (torch.ones((T, T), dtype=torch.bool, device=q.device).tril()
            if causal else None)
    g64 = [torch.empty(q.shape, dtype=torch.float64, device=q.device)
           for _ in range(3)]
    g16 = [torch.empty(q.shape, dtype=torch.float32, device=q.device)
           for _ in range(3)]
    for b0 in range(0, BH, heads):
        sl = slice(b0, b0 + heads)
        for out, dt in ((g64, torch.float64), (g16, torch.float32)):
            qs, kf, vf, dof = (x[sl].to(dt) for x in (q, k, v, do))
            qs = qs * scale
            s = torch.matmul(qs, kf.transpose(-1, -2))
            if causal:
                s.masked_fill_(~keep, float('-inf'))
            p = s.sub_(lse[sl].to(dt)[..., None]).exp_()
            delta = (dof * o[sl].to(dt)).sum(-1)
            ds = torch.matmul(dof, vf.transpose(-1, -2))
            ds.sub_(delta[..., None]).mul_(p)
            if dt == torch.float32:
                p, ds = p.bfloat16().float(), ds.bfloat16().float()
            out[2][sl] = torch.matmul(p.transpose(-1, -2), dof)
            out[1][sl] = torch.matmul(ds.transpose(-1, -2), qs)
            out[0][sl] = torch.matmul(ds, kf) * scale
            del s, p, ds
    return g64, g16


def _log_bwd_fp64(q, k, v, o, lse, do, causal, scale, got, want, label):
    """Log the kernel's and the plain version's (dq, dk, dv) against an
    fp64 evaluation, and how far one bf16 rounding of P and dS puts the
    gradients from the plain version, relative (G_RTOL's measure)."""
    import torch
    g64, g16 = _bwd_fp64(q, k, v, o, lse, do, causal, scale)
    for who, grads in (('flash_attention_bwd_onepass', got),
                       ('its plain version', want)):
        log('%s: %s vs fp64 max_abs_err dq, dk, dv %s; relative %s'
            % (label, who,
               ', '.join('%.3e' % (g.double() - r).abs().max().item()
                         for g, r in zip(grads, g64)),
               ', '.join('%.3e' % rel_err(g, r, G_FLOOR)
                         for g, r in zip(grads, g64))))
    log('%s: mean |g| of the fp64 dq, dk, dv %s (G_FLOOR %g)'
        % (label, ', '.join('%.3e' % r.abs().mean().item() for r in g64),
           G_FLOOR))
    if q.dtype == torch.bfloat16:
        log('%s: with P and dS rounded once to bf16 (the TPU kernels\' '
            'rounding; the kernel carries both as bf16 hi + lo) the plain '
            'evaluation lies %s from its plain version, relative (bound '
            '%g)' % (label, ', '.join('%.3e' % rel_err(g, w, G_FLOOR)
                                      for g, w in zip(g16, want)), G_RTOL))
    del g64, g16
    torch.cuda.empty_cache()


def _check_long_shape(fa, rng, dev, BH, T, d, causal, dtype, fp64=False):
    """Run K4a, K4b and K5 once at one shape and hold each against its
    plain version on the same inputs (K4b gets the plain lse, K5 the
    plain forward's o and lse); in bf16 also K1, the default arm's
    forward, by check_fwd_output. Returns {kind: max_abs_err}. K4b's o is
    also held to O_RTOL and K5's gradients to G_RTOL in bf16. fp64=True
    also logs K4b's, K1's, K5's and their plain versions' distance from
    an fp64 evaluation. The plain intermediates are freed before
    returning."""
    import torch
    q, k, v, do = _inputs(rng, BH, T, d, dtype, dev)
    scale = d ** -0.5
    lse_ref = fa.flash_attention_stats_reference(q, k, causal, scale)
    lse = fa.flash_attention_fwd_stats(q, k, causal, scale)
    o = fa.flash_attention_fwd_acc(q, k, v, lse_ref, causal, scale)
    torch.cuda.synchronize()
    o_ref = fa.flash_attention_acc_reference(q, k, v, lse_ref, causal, scale)
    o_err, o_rel, o_ok = check_acc_output(o, o_ref, dtype)
    errs = {'k4a': _max_err((lse,), (lse_ref,)), 'k4b': o_err}
    fwd_ok, k1_outs = True, ()
    if dtype == 'bfloat16':
        o1, lse1 = fa.flash_attention_fwd(q, k, v, causal, scale)
        torch.cuda.synchronize()
        o1_ref, lse1_ref = fa.flash_attention_reference(q, k, v, causal,
                                                        scale)
        o1_err, o1_rel, lse1_err, fwd_ok = check_fwd_output(
            o1, lse1, o1_ref, lse1_ref, dtype)
        errs['fwd'] = max(o1_err, lse1_err)
        k1_outs = (o1, o1_ref)
        log('[%d, %d, %d] causal=%s %s: flash_attention_fwd o %.3e, lse '
            '%.3e (atol o %g, lse %g), o relative %.3e (bound %g) %s'
            % (BH, T, d, causal, dtype, o1_err, lse1_err, KERNEL_ATOL[dtype],
               KERNEL_ATOL['float32'], o1_rel, O_RTOL,
               'ok' if fwd_ok else 'MISMATCH'))
    if fp64:
        e64 = _acc_fp64_err(q, k, v, lse_ref, causal, scale,
                            (o, o_ref) + k1_outs)
        log('[%d, %d, %d] causal=%s %s: vs fp64 max_abs_err '
            'flash_attention_fwd_acc %.3e, its plain version %.3e%s; mean '
            '|o| %.3e' % (BH, T, d, causal, dtype, e64[0], e64[1],
                          ', flash_attention_fwd %.3e, its plain version '
                          '%.3e' % tuple(e64[2:]) if k1_outs else '',
                          o_ref.float().abs().mean().item()))
    if fp64 and dtype == 'bfloat16':
        log('[%d, %d, %d] causal=%s %s: with P rounded once to bf16 (the '
            'TPU kernel\'s rounding; the kernel carries P as bf16 hi + lo) '
            'the plain evaluation lies %.3e from its plain version, '
            'relative (bound %g)'
            % (BH, T, d, causal, dtype,
               rel_err(_acc_one_bf16_p(q, k, v, lse_ref, causal, scale),
                         o_ref), O_RTOL))
    got = fa.flash_attention_bwd_onepass(q, k, v, do, lse_ref,
                                         fa.bwd_delta(o_ref, do), causal,
                                         scale)
    torch.cuda.synchronize()
    want = fa.flash_attention_bwd_reference(q, k, v, o_ref, lse_ref, do,
                                            causal, scale)
    errs['k5'], g_rels, g_ok = check_grads(got, want, dtype)
    if fp64:
        _log_bwd_fp64(q, k, v, o_ref, lse_ref, do, causal, scale, got, want,
                      '[%d, %d, %d] causal=%s %s' % (BH, T, d, causal, dtype))
    finite = all(bool(torch.isfinite(t).all())
                 for t in (lse, o) + got + k1_outs[:1])
    tols = {'k4a': KERNEL_ATOL['float32'], 'k4b': KERNEL_ATOL[dtype],
            'k5': KERNEL_ATOL[dtype]}
    oks = {'k4a': errs['k4a'] <= tols['k4a'], 'k4b': o_ok, 'k5': g_ok,
           'fwd': fwd_ok}
    bad = [kind for kind in errs if not oks[kind]]
    log('[%d, %d, %d] causal=%s %s: max_abs_err %s (atol lse %g, o and '
        'grads %g); flash_attention_fwd_acc relative %.3e, '
        'flash_attention_bwd_onepass dq, dk, dv relative %s (bounds %s) %s'
        % (BH, T, d, causal, dtype,
           ', '.join('%s %.3e' % (KERNELS[kd][0], e)
                     for kd, e in errs.items()),
           tols['k4a'], tols['k5'], o_rel,
           ', '.join('%.3e' % r for r in g_rels),
           '%g / %g' % (O_RTOL, G_RTOL) if dtype == 'bfloat16' else 'none',
           'ok' if not bad and finite else 'MISMATCH'))
    del q, k, v, do, lse, o, got, want, lse_ref, o_ref, k1_outs
    torch.cuda.empty_cache()
    if bad or not finite:
        raise AssertionError('%s disagree with their plain versions at '
                             '[%d, %d, %d] %s (finite: %s)'
                             % ([KERNELS[kd][0] for kd in bad], BH, T, d,
                                dtype, finite))
    return errs


@phase('b4: K4a, K4b, K5 and bf16 K1 vs plain versions at the '
       'long-context shape')
def check_long_kernels(cfg):
    """Correctness at the long-context path's shape (bf16 causal, and
    fp32, where KERNEL_ATOL is ~1% of typical values: |o| ~1e-2 over up
    to 8192 keys of a near-uniform softmax; bf16 K4b's and K1's o also
    within O_RTOL) and at phase b's ragged shapes, fp32 and bf16; then
    times at the path's shape (K1 bf16 too: the default arm's forward).
    Returns the kernels line's rows."""
    import torch
    from paddle_tpu_torch.kernels import flash_attention as fa
    rng = np.random.RandomState(SEED + 6)
    dev = torch.device('cuda', 0)
    d, T = cfg.dim // cfg.heads, cfg.max_len
    bh = LC_BATCH * cfg.heads
    path_errs = _check_long_shape(fa, rng, dev, bh, T, d, True, 'bfloat16',
                                  fp64=True)
    _check_long_shape(fa, rng, dev, bh, T, d, True, 'float32', fp64=True)
    for dtype in ('float32', 'bfloat16'):
        for shape in RAGGED_SHAPES:
            _check_long_shape(fa, rng, dev, *shape, dtype)

    scale = d ** -0.5
    q, k, v, do = _inputs(rng, bh, T, d, 'bfloat16', dev)
    lse = fa.flash_attention_fwd_stats(q, k, True, scale)
    o = fa.flash_attention_fwd_acc(q, k, v, lse, True, scale)
    delta = fa.bwd_delta(o, do)
    args = (q, k, v, do, lse, delta, True, scale)
    lib_fwd_ms, lib_bwd_ms = _library_fwd_bwd(q, k, v, do, True, 'bf16')
    pair = _timed({
        'ms': lambda: fa.flash_attention_fwd_acc(
            q, k, v, fa.flash_attention_fwd_stats(q, k, True, scale), True,
            scale),
        'plain_ms': lambda: fa.flash_attention_acc_reference(
            q, k, v, fa.flash_attention_stats_reference(q, k, True, scale),
            True, scale)})
    log('K4a + K4b (the twopass forward) at %s bf16 causal: kernels %.4f '
        'ms (device time %s ms), plain %.4f ms, library forward %.4f ms%s'
        % ([bh, T, d], pair['ms'], _fmt_ms(pair['device_ms']),
           pair['plain_ms'], lib_fwd_ms,
           _over_library(pair['device_ms'], lib_fwd_ms)))
    fns = {
        'fwd': {'ms': lambda: fa.flash_attention_fwd(q, k, v, True, scale),
                'plain_ms': lambda: fa.flash_attention_reference(
                    q, k, v, True, scale)},
        'k4a': {'ms': lambda: fa.flash_attention_fwd_stats(q, k, True,
                                                           scale),
                'plain_ms': lambda: fa.flash_attention_stats_reference(
                    q, k, True, scale)},
        'k4b': {'ms': lambda: fa.flash_attention_fwd_acc(q, k, v, lse, True,
                                                         scale),
                'plain_ms': lambda: fa.flash_attention_acc_reference(
                    q, k, v, lse, True, scale)},
        'k5': {'ms': lambda: fa.flash_attention_bwd_onepass(*args),
               'plain_ms': lambda: fa.flash_attention_bwd_reference(
                   q, k, v, o, lse, do, True, scale)},
    }
    rows = []
    for kind, f in fns.items():
        times = _timed(f)
        # one PyTorch call computes K1's function (the library forward)
        # and K5's (the library backward); none computes K4a's or K4b's
        # alone (the pair's line is above)
        times['library_ms'] = {'fwd': lib_fwd_ms, 'k5': lib_bwd_ms}.get(kind)
        rows.append(_row(kind, 'bfloat16', (bh, T, d), True, path_errs[kind],
                         times, flash_bound_ms(kind, bh, T, d, True,
                                               'bfloat16')))
    _log_rows(rows)
    fa.take_extra_flops()     # the timing launches are not a step's work
    del q, k, v, do, lse, o, delta, args
    torch.cuda.empty_cache()
    return rows


# -- (c) ---------------------------------------------------------------------

def prompts_for(vocab, max_len):
    rng = np.random.RandomState(SEED + 1)
    lens = np.linspace(32, min(480, max_len - NEW_TOKENS),
                       N_REQUESTS).astype(int)
    return [rng.randint(1, vocab, size=int(n)).tolist() for n in lens]


@phase('c1: build, initialise and save the model')
def build_and_save(cfg, place, model_dir):
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import transformer
    prog, startup = fluid.Program(), fluid.Program()
    prog.random_seed = startup.random_seed = SEED
    with fluid.unique_name.guard(), fluid.program_guard(prog, startup):
        toks = fluid.layers.data(name='tokens', shape=[1, cfg.max_len, 1],
                                 dtype='int64', append_batch_size=False)
        logits = transformer.language_model_logits(toks, cfg)
    n_params = sum(int(np.prod(v.shape)) for v in prog.list_vars()
                   if v.persistable)
    log('model: vocab %d, dim %d, heads %d, layers %d, ffn %d, max_len %d, '
        'flash %s: %d parameters (%.2f GB fp32), no depth cut'
        % (cfg.vocab, cfg.dim, cfg.heads, cfg.layers, cfg.ffn, cfg.max_len,
           cfg.flash_attention, n_params, n_params * 4 / 1e9))
    exe = fluid.Executor(place)
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(startup)
        fluid.io.save_inference_model(model_dir, ['tokens'], [logits], exe,
                                      main_program=prog)
    return n_params


@phase('c2: load through AnalysisPredictor and prepare decoding')
def load_and_prepare(model_dir, place):
    import paddle_tpu_torch as fluid
    pred = fluid.inference.AnalysisPredictor(
        fluid.inference.AnalysisConfig(model_dir, place=place))
    dec = pred.prepare_decoding(slots=SLOTS, prefill_batch=PREFILL_BATCH)
    return pred, dec


@phase('c3: serve requests through LMServer')
def serve(dec, prompts, counters, sync):
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.kernels import flash_attention as fa
    for c in counters.values():
        c.launches = 0
    fa.FlashAttention.plain_cuda_calls = 0
    t0 = time.perf_counter()
    with fluid.serving.LMServer(dec) as srv:
        handles = [srv.submit(p, max_new_tokens=NEW_TOKENS)
                   for p in prompts]
        streams = [srv.result(h, timeout=600) for h in handles]
        sync()
        wall = time.perf_counter() - t0
        stats = srv.stats()
    launches = {name: c.launches for name, c in counters.items()}
    require_no_plain(fa, 'c3')
    if stats['prefills'] != len(prompts) or stats['completed'] != \
            len(prompts):
        raise AssertionError('engine stats %r' % (stats,))
    for p, s in zip(prompts, streams):
        if len(s) != NEW_TOKENS:
            raise AssertionError('a stream of %d tokens, want %d'
                                 % (len(s), NEW_TOKENS))
    need = stats['prefills'] * dec._pair.spec.layers
    log('main path: %d requests, %d prefills, %d decode steps, %.3f s, '
        '%.1f generated tokens/s; launches %s (flash needs >= %d)'
        % (len(prompts), stats['prefills'], stats['decode_steps'], wall,
           len(prompts) * NEW_TOKENS / wall, json.dumps(launches), need))
    if launches['flash_attention_fwd'] < need:
        raise AssertionError('flash_attention_fwd launched %d times on the '
                             'main path, want >= %d'
                             % (launches['flash_attention_fwd'], need))
    return streams, launches, wall, stats


# -- (d), (e) ----------------------------------------------------------------

def _padded(prompt, T):
    toks = np.zeros((1, T, 1), np.int64)
    toks[0, :len(prompt), 0] = prompt
    return toks


@phase('d: prefill and first token vs full recompute')
def check_recompute(pred, dec, prompts, streams):
    worst = 0.0
    for p, s in zip(prompts, streams):
        full = pred.run([_padded(p, dec.max_len)])[0][0, len(p) - 1]
        ids, logits = dec.prefill([p], [0], return_logits=True)
        if not np.isfinite(logits).all() or logits[0].shape != full.shape:
            raise AssertionError('prefill logits %s not finite or not of '
                                 'shape %s' % (logits[0].shape, full.shape))
        np.testing.assert_allclose(logits[0], full, rtol=RECOMPUTE_TOL,
                                   atol=RECOMPUTE_TOL)
        worst = max(worst, float(np.abs(logits[0] - full).max()))
        # the first token is the recompute's argmax, up to a near tie
        # within the stated tolerance
        if s[0] != int(np.argmax(full)) and \
                full[s[0]] < full.max() - RECOMPUTE_TOL:
            raise AssertionError('first token %d, recompute argmax %d'
                                 % (s[0], int(np.argmax(full))))
        if int(ids[0]) != s[0]:
            raise AssertionError('prefill token %d, engine first token %d'
                                 % (int(ids[0]), s[0]))
    log('prefill vs full recompute: max_abs_diff %.3e over %d requests'
        % (worst, len(prompts)))


@phase('e: engine streams vs solo generate')
def check_solo(dec, prompts, streams):
    dec.reset()
    for i, (p, s) in enumerate(zip(prompts, streams)):
        solo = dec.generate(p, NEW_TOKENS, slot=0)
        if solo != s:
            raise AssertionError('request %d: engine stream differs from '
                                 'solo generate' % i)
    log('engine streams equal solo generate for %d requests' % len(prompts))


def _time_path(dec, prompts, sync):
    """(prefill ms, decode-step ms) of `dec` by the host clock."""
    p = prompts[-1]
    dec.prefill([p], [0])
    sync()
    t0 = time.perf_counter()
    n = 5
    for _ in range(n):
        dec.prefill([p], [0])
    sync()
    prefill_ms = (time.perf_counter() - t0) / n * 1e3
    toks = np.ones((dec.slots,), np.int64)
    poss = np.full((dec.slots,), len(p), np.int32)
    dec.decode_step(toks, poss)
    sync()
    t0 = time.perf_counter()
    n = 20
    for _ in range(n):
        dec.decode_step(toks, poss)
    sync()
    step_ms = (time.perf_counter() - t0) / n * 1e3
    log('prefill (%d-token prompt, padded to %d): %.3f ms; decode step '
        '(%d slots): %.3f ms; %.1f tokens/s at full slots'
        % (len(p), dec.max_len, prefill_ms, dec.slots, step_ms,
           dec.slots / step_ms * 1e3))
    return prefill_ms, step_ms


time_path = phase('f: prefill and decode-step timing')(_time_path)


def _device_us(evt):
    for attr in ('self_device_time_total', 'self_cuda_time_total'):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def _profile_path(dec, prompts, times_ms, sync, label=''):
    """torch.profiler over a few calls of each: device time per call,
    its share of the unprofiled wall time (phase f), and the kernels
    that take most of it. Returns {call: device ms}."""
    from torch.autograd import DeviceType
    p = prompts[-1]
    toks = np.ones((dec.slots,), np.int64)
    poss = np.full((dec.slots,), len(p), np.int32)
    calls = {'prefill': lambda: dec.prefill([p], [0]),
             'decode_step': lambda: dec.decode_step(toks, poss)}
    n = 5
    out = {}
    for name, fn in calls.items():
        fn()
        sync()
        with device_window() as prof:
            for _ in range(n):
                fn()
            sync()
        # kernels only: an aten op's device time repeats its kernels'
        events = [e for e in prof.key_averages()
                  if getattr(e, 'device_type', None) == DeviceType.CUDA
                  and _device_us(e) > 0]
        device_ms = sum(_device_us(e) for e in events) / n / 1e3
        if device_ms == 0:
            log('%s%s: device time not measured (the profiler saw no device '
                'events)' % (label, name))
            continue
        out[name] = device_ms
        top = sorted(events, key=_device_us, reverse=True)[:6]
        k1 = [e for e in events if _kernel_kind(e.key).startswith('K1 fp32')]
        log('%s%s: device busy %.3f ms of %.3f ms wall (%.1f%%); K1 fp32 '
            '(flash_fwd_f32_kernel) %.4f ms in %d launches per call; top: %s'
            % (label, name, device_ms, times_ms[name],
               100.0 * device_ms / times_ms[name],
               sum(_device_us(e) for e in k1) / n / 1e3,
               sum(e.count for e in k1) // n,
               '; '.join('%s %.3f ms' % (e.key[:48], _device_us(e) / n / 1e3)
                         for e in top)))
    return out


profile_path = phase('g: device time inside the prefill and the decode '
                     'step')(_profile_path)


# -- (v1)-(v6): paged serving, preemption, speculation, weight swap -----------

def forced_logits(dec, prompt, forced, slot=0):
    """The logits `dec` (dense or paged) gives for the token at index
    len(forced) of a stream: a cold prefill of `prompt`, then one decode
    step for each token of `forced`, fed in turn."""
    dec.reset()
    _, logits = dec.prefill([prompt], [slot], return_logits=True)
    out = logits[0]
    toks = np.zeros((dec.slots,), np.int64)
    poss = np.zeros((dec.slots,), np.int32)
    for i, tok in enumerate(forced):
        toks[slot], poss[slot] = tok, len(prompt) + i
        _, logits = dec.decode_step(toks, poss, return_logits=True)
        out = logits[slot]
    return out


def margin_rule(ref, got, logits_at, bound=MARGIN_TOL):
    """Two greedy streams of one request agree if they are equal, or if
    at the first index i where they differ both tokens lie within
    `bound` of the best logit the reference path gives there
    (logits_at(i)): a near tie that another summation order may break
    the other way. Returns None for equal streams, else (i, gap), gap
    the larger of the two tokens' distances from the best logit; raises
    AssertionError otherwise."""
    ref, got = [int(t) for t in ref], [int(t) for t in got]
    if ref == got:
        return None
    if len(ref) != len(got):
        raise AssertionError('streams of %d and %d tokens'
                             % (len(ref), len(got)))
    i = next(j for j, (a, b) in enumerate(zip(ref, got)) if a != b)
    logits = np.asarray(logits_at(i), np.float64)
    gap = float(logits.max() - min(logits[ref[i]], logits[got[i]]))
    if not gap <= bound:
        raise AssertionError(
            'streams differ first at token %d (%d vs %d), %.3e below the '
            'best logit: outside the margin rule\'s %.0e'
            % (i, ref[i], got[i], gap, bound))
    return i, gap


def hold_streams(label, prompts, refs, gots, ref_dec):
    """margin_rule for every request, the reference path's logits from
    `ref_dec` (forced_logits). Logs and returns {'equal', 'ties'}."""
    ties = []
    for p, ref, got in zip(prompts, refs, gots):
        tie = margin_rule(ref, got, lambda i, p=p, ref=ref:
                          forced_logits(ref_dec, p, ref[:i]))
        if tie is not None:
            ties.append(tie)
    log('%s: %d of %d streams equal; %s'
        % (label, len(prompts) - len(ties), len(prompts),
           'near ties at (token, gap) %s' % ties if ties else
           'no near tie'))
    return {'equal': len(prompts) - len(ties), 'ties': ties}


def seeded_prompts(seed, lens, vocab):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, vocab, size=int(n)).tolist() for n in lens]


def _paged_kw(**kw):
    return dict(slots=SLOTS, page_tokens=PAGE_TOKENS,
                prefill_chunk=PREFILL_CHUNK, **kw)


def _capture_stats(dec):
    stats = dec.jit_cache_stats()
    return {k: stats[k] for k in ('prepared_programs', 'compiled_segments',
                                  'segment_misses')}


def _drain_prefix(dec):
    """After a drain no stream holds a page: the pool holds only the
    prefix cache's own refs; evicting the cache empties it."""
    st = dec.pool_stats()
    if st['pages_in_use'] != st['prefix_pages']:
        raise AssertionError('after the drain %d pages in use, the prefix '
                             'cache holds %d' % (st['pages_in_use'],
                                                 st['prefix_pages']))
    while dec._prefix.evict_one():
        pass
    dec._pool.check()
    if dec.pool_stats()['pages_in_use'] != 0:
        raise AssertionError('pages in use after evicting the prefix cache')
    return st['prefix_pages']


@phase('v1: paged serving through LMServer(paged=True)')
def paged_serving(pred, dense_dec, prompts, dense_streams, counters, sync):
    """8 requests x 32 tokens through LMServer(paged=True) at the auto
    pool size: streams vs c3's dense streams by the margin rule, every
    paged prefill's logits vs the dense prefill's within RECOMPUTE_TOL,
    no flash launch (the paged path is plain ops), the capture counts
    unchanged over the run, and after the drain no page held."""
    import paddle_tpu_torch as fluid
    srv = fluid.serving.LMServer(pred, **_paged_kw(paged=True))
    dec = srv._decode
    try:
        if dec.num_pages != SLOTS * dec.pages_per_slot + 1:
            raise AssertionError('auto pool of %d pages' % dec.num_pages)
        # warm-up: a 3-chunk prompt runs the prefill program 3 times and
        # the decode program 4 times (eager, capture, replays)
        warm = seeded_prompts(SEED + 20, [3 * PREFILL_CHUNK], dec.vocab)[0]
        srv.generate(warm, 4, timeout=600)
        sync()
        before = _capture_stats(dec)
        base = srv.stats()
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        handles = [srv.submit(p, max_new_tokens=NEW_TOKENS) for p in prompts]
        streams = [srv.result(h, timeout=600) for h in handles]
        sync()
        wall = time.perf_counter() - t0
        launches = {name: c.launches for name, c in counters.items()}
        stats = {k: v - base[k] for k, v in srv.stats().items()
                 if k in ('completed', 'prefills', 'decode_steps')}
        after = _capture_stats(dec)
    finally:
        srv.close()
    if any(launches.values()):
        raise AssertionError('the paged path launched %s' % launches)
    # one capture a program on the card (nothing is captured on the CPU)
    captured = 2 if dec.device.type == 'cuda' else 0
    if before != after or before['compiled_segments'] != captured:
        raise AssertionError('capture counts %s before v1\'s run, %s after'
                             % (before, after))
    held = _drain_prefix(dec)
    if stats['completed'] != len(prompts) or \
            any(len(s) != NEW_TOKENS for s in streams):
        raise AssertionError('engine stats %r' % stats)
    tok_s = len(prompts) * NEW_TOKENS / wall
    log('paged main path: %d requests, %d prefill chunks, %d decode steps, '
        '%.3f s, %.1f generated tokens/s; pool %d pages x %d tokens, %d '
        'held by the prefix cache after the drain (0 after eviction); '
        'captures %s before and after'
        % (len(prompts), stats['prefills'], stats['decode_steps'], wall,
           tok_s, dec.num_pages, dec.page_tokens, held, json.dumps(after)))
    agree = hold_streams('paged vs dense streams (margin rule)', prompts,
                         dense_streams, streams, dense_dec)
    worst = 0.0
    for p in prompts:
        _, want = dense_dec.prefill([p], [0], return_logits=True)
        dec.reset()
        _, got = dec.prefill([p], [0], return_logits=True)
        if not np.isfinite(got).all():
            raise AssertionError('paged prefill logits not finite')
        np.testing.assert_allclose(got, want, rtol=RECOMPUTE_TOL,
                                   atol=RECOMPUTE_TOL)
        worst = max(worst, float(np.abs(got - want).max()))
    dec.reset()
    log('paged vs dense prefill logits: max_abs_diff %.3e over %d prompts '
        '(chunks of %d)' % (worst, len(prompts), PREFILL_CHUNK))
    return dict(dec=dec, streams=streams, wall=wall, tok_s=tok_s,
                stats=stats, captures=after, prefill_err=worst,
                agree=agree)


@phase('v2: prefix sharing over a 256-token system prompt')
def prefix_sharing(dec, sync):
    """One request over the system prompt prefills cold and registers
    its pages; 7 more sharing it each prefill their suffix only (one
    chunk, from position 256 = 4 chunks), and every stream has the
    tokens of its own cold solo stream (the chunks line up)."""
    import paddle_tpu_torch as fluid
    system = seeded_prompts(SEED + 21, [SYSTEM_PROMPT], dec.vocab)[0]
    suffixes = seeded_prompts(SEED + 22, np.linspace(8, 40, N_REQUESTS),
                              dec.vocab)
    prompts = [system + s for s in suffixes]
    dec.reset()
    with fluid.serving.LMServer(dec) as srv:
        first = srv.generate(prompts[0], NEW_TOKENS, timeout=600)
        cold = srv.stats()
        t0 = time.perf_counter()
        handles = [srv.submit(p, max_new_tokens=NEW_TOKENS)
                   for p in prompts[1:]]
        streams = [first] + [srv.result(h, timeout=600) for h in handles]
        sync()
        wall = time.perf_counter() - t0
        warm = srv.stats()
    kv = warm['kv']
    hits = len(prompts) - 1
    chunks = warm['prefills'] - cold['prefills']
    if kv['prefix_hits'] != hits or \
            kv['prefix_tokens_reused'] != hits * SYSTEM_PROMPT:
        raise AssertionError('prefix hits %d, tokens reused %d; want %d and '
                             '%d' % (kv['prefix_hits'],
                                     kv['prefix_tokens_reused'], hits,
                                     hits * SYSTEM_PROMPT))
    if chunks != hits:
        raise AssertionError('%d prefill chunks for %d hits: a hit must '
                             'prefill its suffix only' % (chunks, hits))
    _drain_prefix(dec)
    differ = []
    for i, (p, s) in enumerate(zip(prompts, streams)):
        dec.reset()
        if dec.generate(p, NEW_TOKENS) != s:
            differ.append(i)
    dec.reset()
    if differ:
        raise AssertionError('requests %s: the shared-prefix stream differs '
                             'from its cold solo stream' % differ)
    log('prefix sharing: %d-token system prompt; cold request %d prefill '
        'chunks, each of %d hits 1 (its suffix from token %d); prefix_hits '
        '%d, prefix_tokens_reused %d; %d streams equal their cold solo '
        'streams; %.3f s for the %d hits'
        % (SYSTEM_PROMPT, cold['prefills'], hits, SYSTEM_PROMPT,
           kv['prefix_hits'], kv['prefix_tokens_reused'], len(prompts),
           wall, hits))
    return dict(hits=kv['prefix_hits'], reused=kv['prefix_tokens_reused'],
                cold_chunks=cold['prefills'], warm_chunks=chunks)


def _contended_run(pred, prompts, sync):
    """V3_STREAMS long streams on a pool of TIGHT_KV_PAGES pages: the
    first half at priority 0, the second at priority 1 once the first
    decode. Returns (streams, stats, preempted ids, swap-restored ids,
    resume latencies in ms, swap bytes)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.obs import telemetry
    dec = pred.prepare_decoding(**_paged_kw(paged=True,
                                            kv_pages=TIGHT_KV_PAGES))
    eng = fluid.serving.ServingEngine(dec)
    preempted, restored, resumes = set(), set(), []
    preempt_lane, resume = eng._preempt_lane, eng._resume
    restore_stream = dec.restore_stream

    def record_preempt(pred_, lanes, slot, wstate, policy):
        preempted.add(lanes[slot].req.id)
        return preempt_lane(pred_, lanes, slot, wstate, policy)

    def record_resume(req):
        if req.preempted_at is not None:
            resumes.append((time.perf_counter() - req.preempted_at) * 1e3)
        return resume(req)

    def record_restore(slot, snapshot, prompt=None):
        restore_stream(slot, snapshot, prompt=prompt)
        restored.add(tuple(prompt[:16]))
    eng._preempt_lane, eng._resume = record_preempt, record_resume
    dec.restore_stream = record_restore
    half = len(prompts) // 2
    # the low tier's first decode step after every low stream has a
    # token waits for the high tier's submission: however the host
    # schedules this thread, the high tier arrives while the low tier
    # holds the pool (it cannot decode to its end first)
    low, high_in = [], threading.Event()
    decode_step = dec.decode_step

    def held(tokens, positions, return_logits=False):
        if low and not high_in.is_set() and all(r.tokens for r in low):
            high_in.wait(600)
        return decode_step(tokens, positions, return_logits)
    dec.decode_step = held
    telemetry.enable()
    telemetry.reset()
    try:
        eng.start()
        low += [eng.submit(p, V3_NEW_TOKENS, priority=0)
                for p in prompts[:half]]
        deadline = time.monotonic() + 600
        while not all(r.tokens for r in low):
            if time.monotonic() > deadline:
                raise AssertionError('the low tier never decoded')
            time.sleep(0.002)
        high = [eng.submit(p, V3_NEW_TOKENS, priority=1)
                for p in prompts[half:]]
        high_in.set()
        reqs = low + high
        streams = [r.result(600) for r in reqs]
        sync()
        stats = eng.stats()
        swap_bytes = telemetry.snapshot()['counters']['serving.swap_bytes']
    finally:
        high_in.set()
        eng.stop(timeout=60)
        del dec.decode_step
        telemetry.disable(final_flush=False)
        telemetry.reset()
    _drain_prefix(dec)
    ids = [r.id for r in reqs]
    return (dec, streams, stats, [i for i, r in enumerate(ids)
                                  if r in preempted],
            [i for i, p in enumerate(prompts) if tuple(p[:16]) in restored],
            resumes, swap_bytes)


@phase('v3: exhaustion, preemption and deadlines on half the pool')
def preemption(pred, ref_dec, sync):
    """V3_STREAMS long streams on two tiers over TIGHT_KV_PAGES pages.
    Under 'swap' (host budget V3_SWAP_HOST_MB): preemptions > 0, every
    request finishes, and every stream (swap-resumed ones included) has
    the tokens of its unpreempted solo stream. Under 'reprefill' the
    resumed streams hold by the margin rule. A deadline spent at submit
    raises DeadlineExceededError; one spent mid-decode fails the request
    with it and its pages come back."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.serving import DeadlineExceededError
    prompts = seeded_prompts(SEED + 23, np.linspace(200, 270, V3_STREAMS),
                             ref_dec.vocab)
    solo = []
    for p in prompts:
        ref_dec.reset()
        solo.append(ref_dec.generate(p, V3_NEW_TOKENS))
    ref_dec.reset()
    out = {}
    for policy, flags in (('swap', {'FLAGS_serving_preempt_policy': 'swap',
                                    'FLAGS_serving_swap_host_mb':
                                        V3_SWAP_HOST_MB}),
                          ('reprefill', {'FLAGS_serving_preempt_policy':
                                         'reprefill'})):
        with flags_set(flags):
            dec, streams, stats, preempted, restored, resumes, nbytes = \
                _contended_run(pred, prompts, sync)
        if stats['preemptions'] < 1 or stats['completed'] != len(prompts):
            raise AssertionError('%s: stats %r' % (policy, stats))
        p50 = float(np.percentile(resumes, 50)) if resumes else None
        if policy == 'swap':
            if not restored or stats['swap_host_bytes'] != 0:
                raise AssertionError('swap: %d streams restored from host '
                                     'RAM, %d bytes still held'
                                     % (len(restored),
                                        stats['swap_host_bytes']))
            differ = [i for i in range(len(prompts)) if streams[i] != solo[i]]
            if differ:
                raise AssertionError('swap: streams %s differ from their '
                                     'unpreempted solo streams (preempted '
                                     '%s, restored %s)'
                                     % (differ, preempted, restored))
            agree = {'equal': len(prompts), 'ties': []}
        else:
            agree = hold_streams('reprefill: streams vs unpreempted solo '
                                 '(margin rule)', prompts, solo, streams,
                                 ref_dec)
        log('%s: %d streams x %d tokens on %d pages: %d preemptions, %d '
            'resumes (preempted requests %s; restored from host RAM %s), '
            'swap bytes %d, resume latency p50 %s ms over %d, %d streams '
            'equal their solo streams'
            % (policy, len(prompts), V3_NEW_TOKENS, TIGHT_KV_PAGES,
               stats['preemptions'], stats['resumes'], preempted, restored,
               nbytes, 'not measured' if p50 is None else '%.3f' % p50,
               len(resumes), agree['equal']))
        out[policy] = dict(preemptions=stats['preemptions'],
                           resumes=stats['resumes'], swap_bytes=nbytes,
                           resume_p50_ms=p50, equal=agree['equal'])
    # deadlines: spent at submit, and spent mid-decode
    decode_step = ref_dec.decode_step
    spend = {}
    # the request's first decode step waits until this thread holds it,
    # so that it cannot decode to its end before its deadline is spent
    armed = threading.Event()

    def step_then_spend(tokens, positions, return_logits=False):
        armed.wait(600)
        ids = decode_step(tokens, positions, return_logits)
        req = spend.get('req')
        if req is not None and len(req.tokens) >= 3:
            spend.pop('req').deadline_at = time.perf_counter() - 1.0
        return ids
    ref_dec.decode_step = step_then_spend
    with fluid.serving.LMServer(ref_dec) as srv:
        try:
            srv.submit(prompts[0], 4, deadline_ms=0)
        except DeadlineExceededError:
            pass
        else:
            raise AssertionError('a spent deadline_ms was admitted')
        h = srv.submit(prompts[0], V3_NEW_TOKENS, deadline_ms=600000.0)
        spend['req'] = srv._req(h)
        armed.set()
        try:
            srv.result(h, timeout=600)
        except RuntimeError as e:
            error = str(e)
        else:
            raise AssertionError('the request outlived its deadline')
        if 'DeadlineExceededError: expired mid-decode' not in error:
            raise AssertionError('deadline failure %r' % error)
        srv.drain(timeout=60)
        n_tokens = len(srv.poll(h)['tokens'])
    del ref_dec.decode_step
    _drain_prefix(ref_dec)
    log('deadline: spent at submit raises DeadlineExceededError; spent '
        'after %d tokens: %r, its pages back (the pool empties)'
        % (n_tokens, error))
    return out


def _step_ms(fn, sync, n=10):
    fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    sync()
    return (time.perf_counter() - t0) / n * 1e3


@phase('v4: speculative decoding through LMServer(speculative=True)')
def speculative(pred, prompts, paged_streams, ref_dec, sync):
    """For draft_layers 1 (the default) and the target's full depth: 8
    requests x 32 tokens with spec_k SPEC_K, streams vs v1's paged
    streams by the margin rule; accept rate, tokens a verify iteration,
    tokens/s, and one verify iteration's and one draft step's ms."""
    import paddle_tpu_torch as fluid
    layers = ref_dec._pair.spec.layers
    out = {}
    for draft_layers in (1, layers):
        srv = fluid.serving.LMServer(pred, **_paged_kw(
            speculative=True, spec_k=SPEC_K, draft_layers=draft_layers))
        spec = srv._decode
        try:
            warm = seeded_prompts(SEED + 24, [2 * PREFILL_CHUNK],
                                  spec.vocab)[0]
            srv.generate(warm, 12, timeout=600)
            spec.reset()
            sync()
            t0 = time.perf_counter()
            handles = [srv.submit(p, max_new_tokens=NEW_TOKENS)
                       for p in prompts]
            streams = [srv.result(h, timeout=600) for h in handles]
            sync()
            wall = time.perf_counter() - t0
            st = spec.spec_stats()
        finally:
            srv.close()
        agree = hold_streams('speculative (draft_layers %d) vs paged '
                             'streams (margin rule)' % draft_layers, prompts,
                             paged_streams, streams, ref_dec)
        # one verify iteration with fixed proposals (no draft work), and
        # one draft decode step, over 8 live streams at fixed positions
        spec.reset()
        for s, p in enumerate(prompts):
            spec.prefill([p], [s])
        toks = np.ones((spec.slots,), np.int64)
        poss = np.array([len(p) for p in prompts], np.int32)
        spec._draft_chain = lambda live, t, p, b: {s: [1] * b[s]
                                                   for s in live}
        verify_ms = _step_ms(lambda: spec.spec_step(toks, poss), sync)
        del spec._draft_chain
        draft_ms = _step_ms(lambda: spec.draft.decode_step(toks, poss), sync)
        spec.reset()
        row = dict(accept_rate=st['accept_rate'],
                   tokens_per_step=st['effective_tokens_per_step'],
                   k_live=st['k_live'], steps=st['steps'],
                   fallback_steps=st['fallback_steps'],
                   tok_s=len(prompts) * NEW_TOKENS / wall, wall=wall,
                   verify_ms=verify_ms, draft_ms=draft_ms,
                   equal=agree['equal'])
        log('speculative, spec_k %d, draft_layers %d: accept rate %.4f, '
            '%.3f tokens a verify iteration, k_live %d, %d iterations, %d '
            'fallbacks; %.3f s, %.1f generated tokens/s; verify iteration '
            '%.3f ms, draft step %.3f ms'
            % (SPEC_K, draft_layers, row['accept_rate'],
               row['tokens_per_step'], row['k_live'], row['steps'],
               row['fallback_steps'], wall, row['tok_s'], verify_ms,
               draft_ms))
        out[draft_layers] = row
        del srv, spec
        free_device_memory()
    return out


def predictor_with(pred, replace=None):
    """A predictor over `pred`'s program with its own copy of every
    weight (what loading the saved model again gives), `replace`
    ({name: array}) put in its place first."""
    import torch
    from paddle_tpu_torch.executor import Scope
    fresh = pred.clone()
    scope = Scope()
    for name, val in pred._scope._vars.items():
        if isinstance(val, torch.Tensor):
            scope.set_var(name, val.clone())
    for name, arr in (replace or {}).items():
        cur = scope.find_var(name)
        scope.set_var(name, torch.from_numpy(arr).to(cur.device, cur.dtype))
    fresh._scope = scope
    return fresh


def _step_log(dec, epoch):
    """Wrap dec.decode_step: each call is recorded as (epoch[0] when it
    ran, its live slots, tokens, positions, logits) and returns the ids,
    as the engine expects."""
    decode_step = dec.decode_step
    steps = []

    def recorded(tokens, positions, return_logits=False):
        live = [s for s in sorted(dec._tables) if s not in dec._pending]
        ids, logits = decode_step(tokens, positions, return_logits=True)
        steps.append((epoch[0], live, np.array(tokens), np.array(positions),
                      logits))
        return (ids, logits) if return_logits else ids
    dec.decode_step = recorded
    return steps


def _replayed(step, reqs, fresh):
    """One live lane of a recorded step, found by its fed token and
    position among the finished requests, replayed on `fresh`: (the
    recorded logits row, the replay's)."""
    _, live, tokens, positions, logits = step
    for s in live:
        hits = [r for r in reqs
                if 0 <= positions[s] - len(r.prompt) < len(r.tokens)
                and r.tokens[positions[s] - len(r.prompt)] == tokens[s]]
        if len(hits) == 1:
            r = hits[0]
            j = int(positions[s]) - len(r.prompt)
            return logits[s], forced_logits(fresh, r.prompt,
                                            r.tokens[:j + 1])
    raise AssertionError('no lane of the step names one request')


@phase('v5: weight swap at a step boundary, two workers')
def weight_swap(pred, dec, sync):
    """ServingEngine(workers=2) over v1's paged predictor;
    request_swap(install) replaces the head weight while both workers
    decode. Each worker's last step before the swap has the bits of a
    predictor with its own copy of the old weights, its first step after
    the swap those of one with the new weights; no worker captures
    again."""
    import paddle_tpu_torch as fluid
    head = dec._pair.spec.head[0]
    old = pred._scope.find_var(head)
    new = np.random.RandomState(SEED + 25).randn(*old.shape).astype(
        'float32') * float(old.std())
    fresh_old = predictor_with(pred).prepare_decoding(**_paged_kw(paged=True))
    fresh_new = predictor_with(pred, {head: new}).prepare_decoding(
        **_paged_kw(paged=True))
    staged = dec.stage_weights({head: new})
    prompts = seeded_prompts(SEED + 26, np.linspace(40, 100, 2 * SLOTS),
                             dec.vocab)
    dec.reset()
    eng = fluid.serving.ServingEngine(dec, workers=2)
    workers = eng._predictors
    warm = seeded_prompts(SEED + 20, [3 * PREFILL_CHUNK], dec.vocab)[0]
    for w in workers[1:]:
        w.generate(warm, 4)                # the clone's captures
        w.reset()
    epoch = [0]
    logs = [_step_log(w, epoch) for w in workers]
    # a worker's third step on the old weights waits until the swap is
    # requested (a writer waits at the step gate): however the host
    # schedules this thread, every worker still has steps to run on
    # the new weights
    for w, lg in zip(workers, logs):
        def held(tokens, positions, return_logits=False,
                 _step=w.decode_step, _lg=lg):
            while epoch[0] == 0 and not eng._gate._writers_waiting and \
                    eng._running and sum(1 for s in _lg if s[0] == 0) >= 2:
                time.sleep(0.001)
            return _step(tokens, positions, return_logits)
        w.decode_step = held
    before = [_capture_stats(w) for w in workers]
    waited = []

    def install():
        waited.append(time.perf_counter())
        dec.install_weights(staged)
        epoch[0] = 1
    eng.start()
    try:
        reqs = [eng.submit(p, max_new_tokens=SWAP_NEW_TOKENS)
                for p in prompts]
        deadline = time.monotonic() + 120
        while min(sum(1 for s in lg if s[0] == 0) for lg in logs) < 2:
            if time.monotonic() > deadline:
                raise AssertionError('a worker never decoded')
            time.sleep(0.001)
        t0 = time.perf_counter()
        eng.request_swap(install)
        swap_wait_ms = (waited[0] - t0) * 1e3
        for r in reqs:
            r.result(600)
        sync()
    finally:
        eng.stop(timeout=60)
    after = [_capture_stats(w) for w in workers]
    for w in workers:
        del w.decode_step
    if before != after:
        raise AssertionError('capture counts %s before the swap, %s after'
                             % (before, after))
    checked = []
    for wid, lg in enumerate(logs):
        last_old = [s for s in lg if s[0] == 0][-1]
        first_new = [s for s in lg if s[0] == 1][0]
        for label, step, fresh in (('before', last_old, fresh_old),
                                   ('after', first_new, fresh_new)):
            got, want = _replayed(step, reqs, fresh)
            if not np.array_equal(got, want):
                raise AssertionError(
                    'worker %d, the step %s the swap: max |diff| %.3e from '
                    'a predictor with the %s weights'
                    % (wid, label, float(np.abs(got - want).max()),
                       'old' if label == 'before' else 'new'))
            checked.append('%d %s' % (wid, label))
    for p in (dec, fresh_old, fresh_new):
        p.reset()
    _drain_prefix(dec)
    log('weight swap: %s replaced while %d workers decoded %d requests; '
        'swap_wait %.3f ms; steps %s have the bits of a predictor with the '
        'old / new weights; captures %s before and after'
        % (head, len(workers), len(reqs), swap_wait_ms, ', '.join(checked),
           json.dumps(after)))
    return dict(swap_wait_ms=swap_wait_ms, checked=checked)


@phase('v6: the paged decode step and prefill chunk, timed')
def paged_timing(dec, prompts, dense, sync):
    """The paged decode step over 8 live streams (those of the c3
    prompts) by the host clock and its device time (torch.profiler),
    with its busy share beside g's dense step; the paged prefill's ms a
    chunk (the longest prompt, cold)."""
    from torch.autograd import DeviceType
    dec.reset()
    for s, p in enumerate(prompts):
        dec.prefill([p], [s])
    toks = np.ones((dec.slots,), np.int64)
    poss = np.array([len(p) for p in prompts], np.int32)
    step_ms = _step_ms(lambda: dec.decode_step(toks, poss), sync, n=20)
    p = prompts[-1]
    chunks = -(-len(p) // PREFILL_CHUNK)

    def cold_prefill():
        dec.reset()
        sync()
        t0 = time.perf_counter()
        dec.prefill([p], [0])
        sync()
        return time.perf_counter() - t0
    cold_prefill()
    prefill_ms = min(cold_prefill() for _ in range(3)) * 1e3
    device = {}
    for name, fn, n in (('decode_step', lambda: dec.decode_step(toks, poss),
                         5),
                        ('prefill', lambda: dec.prefill([p], [0]), 1)):
        if name == 'prefill':
            dec.reset()
        sync()
        with device_window() as prof:
            for _ in range(n):
                fn()
            sync()
        events = [e for e in prof.key_averages()
                  if getattr(e, 'device_type', None) == DeviceType.CUDA
                  and _device_us(e) > 0]
        ms = sum(_device_us(e) for e in events) / n / 1e3
        device[name] = ms or None
        top = sorted(events, key=_device_us, reverse=True)[:5]
        log('paged %s top device items: %s' % (name, '; '.join(
            '%s %.3f ms' % (e.key[:48], _device_us(e) / n / 1e3)
            for e in top)))
    dec.reset()
    if device['decode_step'] is None:
        log('paged decode step: device time not measured')
    busy = None if device['decode_step'] is None \
        else device['decode_step'] / step_ms
    log('paged decode step (8 streams at %d..%d tokens): %.3f ms wall, '
        'device %s ms, busy %s; dense step (f, g): %.3f ms wall, device %s '
        'ms, busy %s; paged prefill of %d tokens: %.3f ms, %.3f ms a chunk '
        'of %d (device %s ms a chunk)'
        % (int(poss.min()), int(poss.max()), step_ms,
           _fmt_ms(device['decode_step']), _fmt_busy(busy), dense['step_ms'],
           _fmt_ms(dense['device_ms']), _fmt_busy(
               None if not dense['device_ms'] else
               dense['device_ms'] / dense['step_ms']),
           len(p), prefill_ms, prefill_ms / chunks, PREFILL_CHUNK,
           _fmt_ms(None if device['prefill'] is None
                   else device['prefill'] / chunks)))
    return dict(step_ms=step_ms, device_ms=device['decode_step'], busy=busy,
                prefill_ms=prefill_ms, chunk_ms=prefill_ms / chunks,
                chunk_device_ms=(None if device['prefill'] is None
                                 else device['prefill'] / chunks))


# -- (t1)-(t4): the training step --------------------------------------------

def train_flops_per_token(cfg, causal=False):
    """bench.py's _transformer_train_flops_per_token (:93-100): 2 FLOP
    per MAC over qkv+proj, ffn, attention and the head, x3 for forward +
    backward. Attention counts T per token, or the useful T/2 when
    causal (bench.py's long-context series)."""
    d, f, t, v, n = cfg.dim, cfg.ffn, cfg.max_len, cfg.vocab, cfg.layers
    per_layer = 4 * d * d + 2 * d * f
    attn = (t if causal else 2 * t) * d
    return 3 * 2 * (n * (per_layer + attn) + d * v)


class LMRun(object):
    """An LM training step built as bench.py's _bench_lm builds it
    (:198-235): py_reader `reader_name` fed `batch` sequences a step,
    trunk, fused LM head with `head_chunk`, mean, Momentum(0.001, 0.9)
    under AMP; its state on the card. With adam=True the optimizer is
    the Transformer recipe (ADAM): Adam over noam_decay with the
    global-norm clip set by set_gradient_clip, under AMP; self.lr is
    then the schedule's rate, a var of the program."""

    def __init__(self, cfg, place, batch, head_chunk, reader_name,
                 adam=False):
        import paddle_tpu_torch as fluid
        from paddle_tpu_torch.models import transformer as tfm
        self.fluid, self.cfg, self.batch = fluid, cfg, batch
        self.lr = None
        self.main, startup = fluid.Program(), fluid.Program()
        self.main.random_seed = startup.random_seed = SEED
        with fluid.unique_name.guard(), \
                fluid.program_guard(self.main, startup):
            self.reader = fluid.layers.py_reader(
                capacity=4,
                shapes=[(-1, cfg.max_len, 1), (-1, cfg.max_len, 1)],
                dtypes=['int64', 'int64'], name=reader_name,
                use_double_buffer=True)
            tokens, labels = fluid.layers.read_file(self.reader)
            trunk = tfm.language_model_trunk(tokens, cfg)
            cost = fluid.layers.fused_softmax_cross_entropy(
                trunk, labels, cfg.vocab, chunk=head_chunk, name='lm_head')
            self.avg_cost = fluid.layers.mean(cost)
            if adam:
                fluid.clip.set_gradient_clip(
                    fluid.clip.GradientClipByGlobalNorm(ADAM['clip_norm']))
                self.lr = fluid.layers.noam_decay(
                    d_model=cfg.dim, warmup_steps=ADAM['warmup_steps'])
                opt = fluid.optimizer.Adam(
                    learning_rate=self.lr, beta1=ADAM['beta1'],
                    beta2=ADAM['beta2'], epsilon=ADAM['epsilon'])
            else:
                opt = fluid.optimizer.Momentum(learning_rate=0.001,
                                               momentum=0.9)
            opt = fluid.contrib.mixed_precision.decorate(opt)
            opt.minimize(self.avg_cost)
        self.scope = fluid.Scope()
        fluid.Executor(place).run(startup, scope=self.scope)
        self.use_cuda = place.device.type == 'cuda'
        self.pe = fluid.ParallelExecutor(
            use_cuda=self.use_cuda, loss_name=self.avg_cost.name,
            main_program=self.main, scope=self.scope)
        self.persistables = [v.name for v in self.main.list_vars()
                             if v.persistable and
                             self.scope.find_var(v.name) is not None]

    def feed(self, provider):
        if self.reader._started:
            self.reader.reset()
        self.reader.decorate_tensor_provider(provider)
        self.reader.start()

    def step(self, sync_checked=False):
        """One step through the ParallelExecutor. sync_checked: under
        no_host_sync, so an op that synchronises with the host raises
        (run it as the prepared program's first, eager run)."""
        if not sync_checked:
            return float(self.pe.run(fetch_list=[self.avg_cost.name])[0])
        with no_host_sync():
            out = self.pe.run(fetch_list=[self.avg_cost.name],
                              return_numpy=False)
        return float(out[0])

    def drop_graphs(self):
        """Close self.pe: its captured graphs, and the memory pool they
        hold, go back to the card (the next step prepares anew)."""
        self.pe.close()
        if self.use_cuda:
            free_device_memory()

    def fresh_executor(self):
        """A new ParallelExecutor in place of self.pe, which is closed
        first: its jit_cache_stats() count from 0."""
        self.drop_graphs()
        self.pe = self.fluid.ParallelExecutor(
            use_cuda=self.use_cuda, loss_name=self.avg_cost.name,
            main_program=self.main, scope=self.scope)

    def batch_of(self, rng):
        toks = rng.randint(0, self.cfg.vocab, size=(
            self.batch, self.cfg.max_len, 1)).astype('int64')
        return [toks, np.roll(toks, -1, axis=1)]

    def snapshot(self):
        return {n: self.scope.find_var(n).clone() for n in self.persistables}

    def restore(self, saved):
        for n, t in saved.items():
            self.scope.find_var(n).copy_(t)


def bench_provider(cfg, batch, rng):
    """bench.py's token provider (:228-232)."""
    def provider():
        while True:
            toks = rng.randint(0, cfg.vocab,
                               size=(batch, cfg.max_len, 1)).astype('int64')
            yield [toks, np.roll(toks, -1, axis=1)]
    return provider


@phase('t1: train the flagship LM (AMP Momentum, py_reader, '
       'ParallelExecutor)')
def train_steps(cfg, place, counters, sync):
    import torch
    from paddle_tpu_torch.kernels import flash_attention as fa
    t0 = time.perf_counter()
    tr = LMRun(cfg, place, TRAIN_BATCH, HEAD_CHUNK, 'tfm_reader')
    n_params = sum(int(np.prod(v.shape)) for v in tr.main.list_vars()
                   if v.persistable and getattr(v, 'trainable', False))
    ops = tr.main.global_block().ops
    log('training program: %d ops of %d types, %d parameters (%.2f GB '
        'fp32), batch %d x %d tokens, no depth cut; built and initialised '
        'in %.1f s' % (len(ops), len(set(o.type for o in ops)), n_params,
                       n_params * 4 / 1e9, tr.batch, cfg.max_len,
                       time.perf_counter() - t0))
    tr.feed(bench_provider(cfg, tr.batch, np.random.RandomState(0)))
    # the peak covers the eager warm-up, the capture and the replays
    torch.cuda.reset_peak_memory_stats()
    losses = [tr.step(sync_checked=True)]
    losses += [tr.step() for _ in range(WARMUP_STEPS - 1)]
    sync()
    for c in counters.values():
        c.launches = 0
    fa.FlashAttention.plain_cuda_calls = 0
    t0 = time.perf_counter()
    losses += [tr.step() for _ in range(TIMED_STEPS)]
    sync()
    wall = time.perf_counter() - t0
    launches = {name: c.launches for name, c in counters.items()}
    require_no_plain(fa, 't1')
    peak_gb = peak_memory_gb()
    step_ms = wall / TIMED_STEPS * 1e3
    log('losses: %s' % ', '.join('%.6f' % x for x in losses))
    log('timed steps: %d in %.3f s, %.3f ms per step; launches %s; peak '
        'device memory %.2f GB' % (TIMED_STEPS, wall, step_ms,
                                   json.dumps(launches), peak_gb))
    if not all(np.isfinite(losses)):
        raise AssertionError('a training loss is not finite: %r' % losses)
    need = cfg.layers * TIMED_STEPS
    if launches['flash_attention_fwd'] < need:
        raise AssertionError('K1 launched %d times in %d steps, want >= %d'
                             % (launches['flash_attention_fwd'],
                                TIMED_STEPS, need))
    if launches['flash_attention_bwd_kvmajor'] != need:
        raise AssertionError('K2 launched %d times in %d steps, want %d'
                             % (launches['flash_attention_bwd_kvmajor'],
                                TIMED_STEPS, need))
    others = [KERNELS[kd][0] for kd in ('k3a', 'k3b', 'k4a', 'k4b', 'k5')]
    if any(launches[n] for n in others):
        raise AssertionError('K3, K4 or K5 launched on the default arms: %r'
                             % launches)
    check_replay_launches('t1', tr.step, sync)
    return tr, losses, step_ms, launches, peak_gb


def _one_step(tr, saved, batch, params=PARAMS_COMPARED, eager=None):
    """Restore the saved state, run one step on `batch`, and return the
    loss and the updates of `params`. eager: an Executor that runs the
    step op by op (use_program_cache=False) in place of the
    ParallelExecutor's captured path."""
    tr.restore(saved)

    def provider():
        while True:
            yield batch
    tr.feed(provider)
    if eager is None:
        loss = tr.step()
    else:
        loss = float(eager.run(tr.main, fetch_list=[tr.avg_cost.name],
                               scope=tr.scope, use_program_cache=False)[0])
    updates = {n: (tr.scope.find_var(n) - saved[n]).float()
               for n in params}
    return loss, updates


def _update_diffs(a, b, params):
    """Per parameter: max |update difference| over max |update| of b."""
    return {n: ((a[1][n] - b[1][n]).abs().max() /
                b[1][n].abs().max().clamp_min(1e-30)).item()
            for n in params}


def _first_order_diffs(a, b, grads, params):
    """Per parameter: sum |g|·|update difference| over sum |g|·|update of
    b|, g from `grads`: how far the first-order change of the loss, g·u,
    that a's update u buys strays from b's, element by element. 1 for an
    update of 0, 2 for b's reversed; an element whose gradient is near 0,
    which Adam may step either way, weighs next to nothing."""
    out = {}
    for n in params:
        w = grads[n].abs()
        out[n] = ((w * (a[n] - b[n]).abs()).sum() /
                  (w * b[n].abs()).sum().clamp_min(1e-30)).item()
    return out


def _compare(what, a, b, params=PARAMS_COMPARED):
    """|loss difference| and, per parameter, max |update difference| over
    max |update|; raises beyond TRAIN_LOSS_TOL / TRAIN_UPDATE_TOL."""
    loss_diff = abs(a[0] - b[0])
    rel = _update_diffs(a, b, params)
    log('%s: loss %.6f vs %.6f (|diff| %.3e, tol %g); update max '
        'diff / max update: %s (tol %g)'
        % (what, a[0], b[0], loss_diff, TRAIN_LOSS_TOL,
           ', '.join('%s %.3e' % kv for kv in rel.items()),
           TRAIN_UPDATE_TOL))
    if not (np.isfinite(a[0]) and loss_diff <= TRAIN_LOSS_TOL
            and all(r <= TRAIN_UPDATE_TOL for r in rel.values())):
        raise AssertionError('%s disagree beyond the stated tolerance'
                             % what)
    return loss_diff, rel


@phase('t2: kernel step vs plain-version step from one saved state')
def check_plain_step(tr, counters):
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.kernels import flash_attention as fa
    rng = np.random.RandomState(SEED + 2)
    toks = rng.randint(0, tr.cfg.vocab, size=(tr.batch, tr.cfg.max_len,
                                              1)).astype('int64')
    batch = [toks, np.roll(toks, -1, axis=1)]
    saved = tr.snapshot()
    kernel = _one_step(tr, saved, batch)
    fluid.set_flags({'FLAGS_use_flash_attention': False})
    try:
        for c in counters.values():
            c.launches = 0
        plain = _one_step(tr, saved, batch)
        if any(c.launches for c in counters.values()):
            raise AssertionError('a kernel launched in the plain step: %r'
                                 % {n: c.launches
                                    for n, c in counters.items()})
    finally:
        fluid.set_flags({'FLAGS_use_flash_attention': True})
        fa.FlashAttention.plain_cuda_calls = 0
    diffs = _compare('kernel step vs plain step', kernel, plain)
    return saved, batch, kernel, diffs


@phase('t3: one step under the split backward arm (K3a + K3b)')
def check_split_step(tr, saved, batch, kernel, counters, sync):
    """One step from the saved state under PADDLE_FLASH_BWD=split, held
    to the kvmajor kernel step; then the split step's wall ms over
    TIMED_STEPS steps and its device time by kernel kind over
    PROFILE_STEPS. Returns (launches, differences, wall ms, device
    ms)."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    fa.FlashAttention.plain_cuda_calls = 0
    with flash_arms(None, 'split'):
        for c in counters.values():
            c.launches = 0
        split = _one_step(tr, saved, batch)
        launches = {n: c.launches for n, c in counters.items()}
    log('split-arm step launches: %s' % json.dumps(launches))
    L = tr.cfg.layers
    if launches['flash_attention_bwd_dq'] != L or \
            launches['flash_attention_bwd_dkv'] != L or \
            launches['flash_attention_bwd_kvmajor']:
        raise AssertionError('split arm: want K3a and K3b %d times each and '
                             'K2 never, got %r' % (L, launches))
    diffs = _compare('split-arm step vs kvmajor step', split, kernel)
    with flash_arms(None, 'split'):
        tr.feed(bench_provider(tr.cfg, tr.batch, np.random.RandomState(3)))
        tr.step()
        sync()
        t0 = time.perf_counter()
        for _ in range(TIMED_STEPS):
            tr.step()
        sync()
        step_ms = (time.perf_counter() - t0) / TIMED_STEPS * 1e3
        device_ms, _ = _profile_steps(tr, step_ms, sync, 'split-arm step')
        tr.reader.reset()
    require_no_plain(fa, 't3')
    tr.restore(saved)
    return launches, diffs, step_ms, device_ms


@phase('t4: step time, tokens/s, MFU, device time')
def profile_train(tr, step_ms, sync):
    cfg = tr.cfg
    tokens = tr.batch * cfg.max_len
    fl = train_flops_per_token(cfg)
    tok_s = tokens / step_ms * 1e3
    mfu = tok_s * fl / PEAK_BF16_FLOPS
    log('train step: %.3f ms, %.1f tokens/s, %.1f TFLOP/s at %.3f GFLOP '
        'per token (%.2f TFLOP per step), MFU %.4f of the %.1f TFLOP/s '
        'bf16 dense peak' % (step_ms, tok_s, tok_s * fl / 1e12, fl / 1e9,
                             fl * tokens / 1e12, mfu,
                             PEAK_BF16_FLOPS / 1e12))
    tr.feed(bench_provider(cfg, tr.batch, np.random.RandomState(1)))
    tr.step()
    sync()
    device_ms, busy = _profile_steps(tr, step_ms, sync, 'train step')
    tr.reader.reset()
    return tok_s, mfu, device_ms, busy


def _profile_steps(tr, step_ms, sync, label, steps=PROFILE_STEPS,
                   step=None, by_kind_out=None):
    """torch.profiler over `steps` steps (tr.step, or `step`): device
    time per step, its share of the unprofiled step, the top kernels,
    the time by kernel kind (written into `by_kind_out` when given) and
    every copy kernel by name. Returns (device ms, busy share or
    None)."""
    from torch.autograd import DeviceType
    step = step or tr.step
    with device_window() as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        sync()
        prof_wall_ms = (time.perf_counter() - t0) / steps * 1e3
    events = [e for e in prof.key_averages()
              if getattr(e, 'device_type', None) == DeviceType.CUDA
              and _device_us(e) > 0]
    device_ms = sum(_device_us(e) for e in events) / steps / 1e3
    if device_ms == 0:
        log('%s: device time not measured (the profiler saw no device '
            'events)' % label)
        return device_ms, None
    busy = device_ms / step_ms
    top = sorted(events, key=_device_us, reverse=True)[:10]
    log('%s: device busy %.3f ms of %.3f ms unprofiled wall (%.1f%%; %.3f '
        'ms wall under the profiler); top: %s'
        % (label, device_ms, step_ms, 100.0 * busy, prof_wall_ms,
           '; '.join('%s %.3f ms' % (e.key[:60],
                                     _device_us(e) / steps / 1e3)
                     for e in top)))
    by_kind = {}
    for e in events:
        kind = _kernel_kind(e.key)
        by_kind[kind] = by_kind.get(kind, 0.0) + \
            _device_us(e) / steps / 1e3
    log('%s device time by kind: %s'
        % (label, ', '.join('%s %.3f ms' % kv for kv in
                            sorted(by_kind.items(), key=lambda kv: -kv[1]))))
    copies = sorted((e for e in events if _kernel_kind(e.key) == 'copies'),
                    key=_device_us, reverse=True)
    log('%s copies by name: %s'
        % (label, '; '.join('%s %.3f ms (%d calls)'
                            % (e.key[:80], _device_us(e) / steps / 1e3,
                               e.count // steps) for e in copies) or 'none'))
    if by_kind_out is not None:
        by_kind_out.update(by_kind)
    return device_ms, busy


def _kernel_kind(name):
    """Coarse class of a device kernel by its name."""
    low = name.lower()
    if 'flash_bwd_wgmma_kernel' in low:
        return 'K2/K5 bf16 (flash_bwd_wgmma_kernel)'
    if 'flash_bwd_dq_wgmma_kernel' in low:
        return 'K3a bf16 (flash_bwd_dq_wgmma_kernel)'
    if 'flash_bwd_dkv_wgmma_kernel' in low:
        return 'K3b bf16 (flash_bwd_dkv_wgmma_kernel)'
    if 'flash_fwd_wgmma_kernel' in low:
        return 'K1 bf16 (flash_fwd_wgmma_kernel)'
    if 'flash_fwd_f32_kernel' in low:
        return 'K1 fp32 (flash_fwd_f32_kernel)'
    if 'matmul_bn_stats_wgmma_kernel' in low:
        return 'K6 (matmul + BN statistics)'
    if 'flash_bwd_q_kernel' in low and 'true>' in low:
        return 'K5 (flash_bwd_q_kernel<..., true>)'
    for kind, marks in (('K4a (flash_fwd_stats_kernel)', ('flash_fwd_stats',)),
                        ('K4b (flash_fwd_acc_kernel)', ('flash_fwd_acc',)),
                        ('flash kernels (K1/K2/K3)', ('flash_',)),
                        ('K6 (matmul + BN statistics)',
                         ('matmul_bn_stats', 'column_sums')),
                        ('convolutions (cuDNN)',
                         ('cudnn', 'fprop', 'dgrad', 'wgrad', 'implicit',
                          'convolution', 'conv2d')),
                        ('GEMMs (cuBLAS)', ('gemm', 'nvjet', 'cutlass')),
                        ('reductions', ('reduce',)),
                        ('copies', ('memcpy', 'memset', 'copy')),
                        ('elementwise', ('elementwise', 'index', 'scatter',
                                         'gather'))):
        if any(m in low for m in marks):
            return kind
    return 'other'


# torch.profiler's name of each kernel a wrapper launches once a call ->
# its group in LAUNCH_GROUPS; the fp32 backward kernels are told apart
# by their last template argument (csrc/flash_attention_bwd.cu)
LAUNCH_SYMBOLS = {
    'flash_fwd_wgmma_kernel': 'K1', 'flash_fwd_f32_kernel': 'K1',
    'flash_fwd_stats_wgmma_kernel': 'K4a', 'flash_fwd_stats_kernel': 'K4a',
    'flash_fwd_acc_wgmma_kernel': 'K4b', 'flash_fwd_acc_kernel': 'K4b',
    'flash_bwd_wgmma_kernel': 'K2/K5', ('flash_bwd_kv_kernel', 'true'):
    'K2/K5', ('flash_bwd_q_kernel', 'true'): 'K2/K5',
    'flash_bwd_dq_wgmma_kernel': 'K3a', ('flash_bwd_q_kernel', 'false'):
    'K3a', 'flash_bwd_dkv_wgmma_kernel': 'K3b',
    ('flash_bwd_kv_kernel', 'false'): 'K3b',
    'matmul_bn_stats_wgmma_kernel': 'K6', 'matmul_bn_stats_kernel': 'K6'}
# group -> the wrappers whose launch counts it answers to
LAUNCH_GROUPS = {'K1': ('flash_attention_fwd',),
                 'K4a': ('flash_attention_fwd_stats',),
                 'K4b': ('flash_attention_fwd_acc',),
                 'K2/K5': ('flash_attention_bwd_kvmajor',
                           'flash_attention_bwd_onepass'),
                 'K3a': ('flash_attention_bwd_dq',),
                 'K3b': ('flash_attention_bwd_dkv',),
                 'K6': ('matmul_bn_stats_kernel',)}


def launch_group(name):
    """The LAUNCH_GROUPS group of a profiled kernel's name, or None."""
    m = re.search(r'(\w+_kernel)(?:<([^()]*)>)?', name)
    if m is None:
        return None
    args = (m.group(2) or '').split(',')
    return LAUNCH_SYMBOLS.get(m.group(1)) or \
        LAUNCH_SYMBOLS.get((m.group(1), args[-1].strip()))


def wrapper_counts():
    """{wrapper name: launches} of every wrapper in LAUNCH_GROUPS."""
    from paddle_tpu_torch.kernels import conv_bn, flash_attention as fa
    counts = {n: getattr(fa, n).launches for names in LAUNCH_GROUPS.values()
              for n in names if n != 'matmul_bn_stats_kernel'}
    counts['matmul_bn_stats_kernel'] = conv_bn.matmul_bn_stats_kernel.launches
    return counts


def launch_mismatch(seen, before, after):
    """{group: (profiled launches, counted launches)} where the two
    differ: `seen` {group: kernels the profiler saw}, the counts
    wrapper_counts() read before and after the profiled calls."""
    counted = {g: sum(after[n] - before[n] for n in names)
               for g, names in LAUNCH_GROUPS.items()}
    return {g: (seen.get(g, 0), counted[g]) for g in LAUNCH_GROUPS
            if seen.get(g, 0) != counted[g]}


def check_replay_launches(label, step, sync):
    """One step() under torch.profiler (on a captured program: a replay,
    whose counts are what its capture recorded): for every kernel group,
    the kernels the profiler saw launch equal what the wrappers' counts
    gained. A window that saw fewer launches of a group than counted,
    and no more of any, is taken again padded longer (the profiler drops
    device events near a window's edge; a replay launches the same
    kernels every time). Fails on a launch the wrappers did not count,
    on a shortfall in the last window, or where no window of
    DEVICE_MS_WINDOWS (padded as WINDOW_PADS_S) shows a device event.
    Returns {group: launches}."""
    from torch.autograd import DeviceType
    wrong = None
    for pad in WINDOW_PADS_S:
        before = wrapper_counts()
        with device_window(pad) as prof:
            step()
            sync()
        after = wrapper_counts()
        seen = {}
        events = [e for e in prof.key_averages()
                  if getattr(e, 'device_type', None) == DeviceType.CUDA]
        for e in events:
            group = launch_group(e.key)
            if group:
                seen[group] = seen.get(group, 0) + e.count
        if not events:
            continue
        wrong = launch_mismatch(seen, before, after)
        log('%s: one replayed step under the profiler: kernel launches %s, '
            'the same as the wrappers\' counts: %s'
            % (label, json.dumps(seen), not wrong))
        if not wrong:
            return seen
        if any(got > counted for got, counted in wrong.values()):
            break
        log('%s: the window (padded by %g s) saw fewer launches than '
            'counted; trying again' % (label, pad))
    if wrong:
        raise AssertionError('%s: the profiler saw other launches than '
                             'the wrappers counted, {group: (profiled, '
                             'counted)}: %r' % (label, wrong))
    raise AssertionError('%s: the profiler saw no device events in %d '
                         'windows: the launch counts were not checked'
                         % (label, DEVICE_MS_WINDOWS))


# -- (h): shapes the flash kernels do not take --------------------------------

def require_no_plain(fa, label):
    """Fail where a timed path ran the plain flash version on the card: the
    route (fa.kernel_takes) must never hide the kernels where they should
    launch."""
    n = fa.FlashAttention.plain_cuda_calls
    if n:
        raise AssertionError('%s: %d flash_attention calls ran the plain '
                             'version on the card, want 0' % (label, n))


def _flash_op_program(fluid, shape, dtype):
    """One flash_attention op (causal, default scale) on fed q, k, v."""
    prog = fluid.Program()
    block = prog.global_block()
    ins = {slot: [block.create_var(name=slot.lower(), shape=shape,
                                   dtype=dtype, is_data=True)]
           for slot in ('Q', 'K', 'V')}
    block.append_op(type='flash_attention', inputs=ins,
                    outputs={'Out': [block.create_var(name='out')]},
                    attrs={'causal': True, 'sm_scale': None})
    return prog


@phase('h: the flash_attention op at shapes the kernels do not take')
def check_untaken_flash(place, counters):
    """Each UNTAKEN_FLASH case through the op on CUDA tensors: the output
    has the plain version's bits, the plain-on-card counter counts the
    call, and no kernel launches."""
    import torch
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.kernels import flash_attention as fa
    exe = fluid.Executor(place)
    rng = np.random.RandomState(SEED + 7)
    for shape, dtype in UNTAKEN_FLASH:
        feed = {n: torch.from_numpy((rng.randn(*shape) * 0.5).astype(
            'float32')).to(exe.device).to(getattr(torch, dtype))
            for n in ('q', 'k', 'v')}
        for c in counters.values():
            c.launches = 0
        fa.FlashAttention.plain_cuda_calls = 0
        out, = exe.run(_flash_op_program(fluid, shape, dtype), feed=feed,
                       fetch_list=['out'], scope=fluid.Scope(),
                       return_numpy=False)
        torch.cuda.synchronize()
        plain = fa.FlashAttention.plain_cuda_calls
        launches = {n: c.launches for n, c in counters.items() if c.launches}
        B, H, T, d = shape
        want, _ = fa.flash_attention_reference(
            *(feed[n].reshape(B * H, T, d) for n in ('q', 'k', 'v')), True,
            d ** -0.5)
        same = out.device.type == 'cuda' and out.dtype == want.dtype and \
            torch.equal(out.reshape(want.shape), want)
        log('flash_attention op %s %s on the card: plain calls %d, kernel '
            'launches %s, bits equal to the plain version: %s'
            % (list(shape), dtype, plain, launches or 'none', same))
        if plain != 1 or launches or not same:
            raise AssertionError('%s %s: want one plain call, no kernel '
                                 'launch and the plain version\'s bits'
                                 % (list(shape), dtype))
    fa.FlashAttention.plain_cuda_calls = 0


# -- (a1)-(a4): the training core ---------------------------------------------

def noam_rate(step, d_model):
    """noam_decay's rate in the step-th step (the counter reads step)."""
    return d_model ** -0.5 * min(step ** -0.5,
                                 step * ADAM['warmup_steps'] ** -1.5)


def _beta_pows(tr):
    """Every Adam beta power of the step, read in one copy per kind:
    {'beta1': array, 'beta2': array}."""
    import torch
    out = {}
    for key in ('beta1', 'beta2'):
        names = [n for n in tr.persistables if '_%s_pow_acc_' % key in n]
        out[key] = torch.cat([tr.scope.find_var(n).reshape(-1).float()
                              for n in names]).cpu().numpy()
    return out


def check_adam_records(records, d_model):
    """In each record of step s: the rate noam_rate(s), the step counter
    s, and every beta power read after the step beta^(s + 1), within
    SCHEDULE_RTOL. Raises on the first that is not; returns the worst
    relative errors of the rate and of the beta powers."""
    worst = {'lr': 0.0, 'beta': 0.0}
    for r in records:
        s = r['step']
        if r['counter'] != s:
            raise AssertionError('step %d: the step counter reads %d'
                                 % (s, r['counter']))
        err = abs(r['lr'] / noam_rate(s, d_model) - 1.0)
        worst['lr'] = max(worst['lr'], err)
        if err > SCHEDULE_RTOL:
            raise AssertionError('step %d: the rate is %.9g, noam_decay '
                                 'gives %.9g' % (s, r['lr'],
                                                 noam_rate(s, d_model)))
        for key in ('beta1', 'beta2'):
            if r.get(key) is None:
                continue
            want = ADAM[key] ** (s + 1)
            err = float(np.abs(np.asarray(r[key], 'float64') / want
                               - 1.0).max())
            worst['beta'] = max(worst['beta'], err)
            if err > SCHEDULE_RTOL:
                raise AssertionError('step %d: a %s power is %.3e off '
                                     '%s^%d' % (s, key, err, key, s + 1))
    return worst


@phase('a1: train the flagship LM under AMP Adam + noam_decay + global-norm '
       'clip (py_reader, ParallelExecutor)')
def adam_steps(cfg, place, counters, sync):
    import torch
    from paddle_tpu_torch.kernels import flash_attention as fa
    t0 = time.perf_counter()
    tr = LMRun(cfg, place, TRAIN_BATCH, HEAD_CHUNK, 'adam_reader',
                 adam=True)
    n_params = sum(int(np.prod(v.shape)) for v in tr.main.list_vars()
                   if v.persistable and getattr(v, 'trainable', False))
    ops = tr.main.global_block().ops
    counts = {}
    for o in ops:
        counts[o.type] = counts.get(o.type, 0) + 1
    log('Adam training program: %d ops of %d types, %d parameters (%.2f GB '
        'fp32), use_tp %s, use_sp %s, batch %d x %d tokens, no depth cut; '
        'built and initialised in %.1f s; op types: %s'
        % (len(ops), len(counts), n_params, n_params * 4 / 1e9, cfg.use_tp,
           cfg.use_sp, tr.batch, cfg.max_len, time.perf_counter() - t0,
           json.dumps(dict(sorted(counts.items())))))
    tr.feed(bench_provider(cfg, tr.batch, np.random.RandomState(0)))
    records, losses = [], []

    def step(s):
        fetches = [tr.avg_cost.name, tr.lr.name, '@STEP_COUNTER@']
        if s == 1:
            with no_host_sync():
                out = tr.pe.run(fetch_list=fetches, return_numpy=False)
            loss, lr, counter = (t.cpu().numpy() for t in out)
        else:
            loss, lr, counter = tr.pe.run(fetch_list=fetches)
        losses.append(float(loss))
        records.append(dict(step=s, lr=float(np.asarray(lr).reshape(-1)[0]),
                            counter=int(np.asarray(counter).reshape(-1)[0])))

    # the peak covers the eager warm-up, the capture and the replays
    torch.cuda.reset_peak_memory_stats()
    for s in range(1, WARMUP_STEPS + 1):
        step(s)
        records[-1].update(_beta_pows(tr))
    sync()
    for c in counters.values():
        c.launches = 0
    fa.FlashAttention.plain_cuda_calls = 0
    t0 = time.perf_counter()
    for s in range(WARMUP_STEPS + 1, WARMUP_STEPS + TIMED_STEPS + 1):
        step(s)
    sync()
    wall = time.perf_counter() - t0
    launches = {name: c.launches for name, c in counters.items()}
    require_no_plain(fa, 'a1')
    records[-1].update(_beta_pows(tr))
    peak_gb = peak_memory_gb()
    step_ms = wall / TIMED_STEPS * 1e3
    tokens = tr.batch * cfg.max_len
    fl = train_flops_per_token(cfg)
    tok_s = tokens / step_ms * 1e3
    mfu = tok_s * fl / PEAK_BF16_FLOPS
    log('losses: %s' % ', '.join('%.6f' % x for x in losses))
    log('rates: %s' % ', '.join('%.6e' % r['lr'] for r in records))
    log('timed steps: %d in %.3f s, %.3f ms per step, %.1f tokens/s, MFU '
        '%.4f at %.3f GFLOP per token; launches %s; peak device memory %.2f '
        'GB' % (TIMED_STEPS, wall, step_ms, tok_s, mfu, fl / 1e9,
                json.dumps(launches), peak_gb))
    if not all(np.isfinite(losses)):
        raise AssertionError('an Adam training loss is not finite: %r'
                             % losses)
    need = cfg.layers * TIMED_STEPS
    if launches['flash_attention_fwd'] < need or \
            launches['flash_attention_bwd_kvmajor'] != need:
        raise AssertionError('want K1 >= %d and K2 exactly %d launches in %d '
                             'steps, got %r' % (need, need, TIMED_STEPS,
                                                launches))
    others = [KERNELS[kd][0] for kd in ('k3a', 'k3b', 'k4a', 'k4b', 'k5')]
    if any(launches[n] for n in others):
        raise AssertionError('K3, K4 or K5 launched in the Adam step: %r'
                             % launches)
    device_ms, busy = _profile_steps(tr, step_ms, sync, 'Adam step',
                                     steps=1)
    tr.reader.reset()
    return dict(tr=tr, losses=losses, step_ms=step_ms, launches=launches,
                peak_gb=peak_gb, records=records, tok_s=tok_s, mfu=mfu,
                device_ms=device_ms, busy=busy, n_ops=len(ops))


def _adam_step(tr, saved, batch):
    """_one_step for the Adam LM: (loss, {param: (1 - beta1)·g}) and the
    updates of ADAM_PARAMS_COMPARED, where g is the step's clipped
    gradient, read from the Adam op's first moment: m1 - beta1·m1_saved."""
    loss, updates = _one_step(tr, saved, batch, ADAM_PARAMS_COMPARED)
    grads = {}
    for p in ADAM_PARAMS_COMPARED:
        m1, = [n for n in tr.persistables if n.startswith(p + '_moment1_')]
        grads[p] = (tr.scope.find_var(m1) -
                    ADAM['beta1'] * saved[m1]).float()
    return (loss, grads), updates


@phase('a2: Adam kernel step vs plain step; the rate, the counter and the '
       'beta powers over a1\'s steps')
def check_adam_step(tr, records, counters):
    """The records of a1 (check_adam_records), then one step from a saved
    state with the kernels and with FLAGS_use_flash_attention=False, held
    to t2's bounds: the losses within TRAIN_LOSS_TOL, and each compared
    weight's step gradient, as the Adam op took it into its first moment,
    within TRAIN_UPDATE_TOL of the largest. Each compared weight's update
    is held within TRAIN_UPDATE_TOL too, weighted by the plain step's
    gradient (_first_order_diffs): Adam's step is about lr·sign(m)
    element by element, so an element whose gradient lies within the two
    steps' bf16 rounding of zero steps the other way, and the largest
    update is no scale for that difference."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.kernels import flash_attention as fa
    worst = check_adam_records(records, tr.cfg.dim)
    log('over %d steps: the rate within %.2e of noam_decay, every beta power '
        'within %.2e of beta^(s+1) (%d accumulators), the counter s in the '
        's-th step (tol %g)' % (len(records), worst['lr'], worst['beta'],
                                2 * len(records[-1]['beta1']),
                                SCHEDULE_RTOL))
    rng = np.random.RandomState(SEED + 8)
    toks = rng.randint(0, tr.cfg.vocab, size=(tr.batch, tr.cfg.max_len,
                                              1)).astype('int64')
    batch = [toks, np.roll(toks, -1, axis=1)]
    saved = tr.snapshot()
    for c in counters.values():
        c.launches = 0
    kernel, kernel_upd = _adam_step(tr, saved, batch)
    L = tr.cfg.layers
    if counters['flash_attention_fwd'].launches < L or \
            counters['flash_attention_bwd_kvmajor'].launches != L:
        raise AssertionError('the kernel step launched %r'
                             % {n: c.launches for n, c in counters.items()})
    fluid.set_flags({'FLAGS_use_flash_attention': False})
    try:
        for c in counters.values():
            c.launches = 0
        plain, plain_upd = _adam_step(tr, saved, batch)
        if any(c.launches for c in counters.values()):
            raise AssertionError('a kernel launched in the plain step: %r'
                                 % {n: c.launches
                                    for n, c in counters.items()})
    finally:
        fluid.set_flags({'FLAGS_use_flash_attention': True})
        fa.FlashAttention.plain_cuda_calls = 0
    tr.reader.reset()
    tr.restore(saved)
    diffs = _compare('Adam kernel step vs plain step, step gradients',
                     kernel, plain, ADAM_PARAMS_COMPARED)
    upd = _first_order_diffs(kernel_upd, plain_upd, plain[1],
                             ADAM_PARAMS_COMPARED)
    log('Adam kernel step vs plain step, updates: sum |g|·|diff| / sum '
        '|g|·|update| %s (tol %g)'
        % (', '.join('%s %.3e' % kv for kv in upd.items()),
           TRAIN_UPDATE_TOL))
    if not all(r <= TRAIN_UPDATE_TOL for r in upd.values()):
        raise AssertionError('Adam kernel step vs plain step: updates '
                             'disagree beyond the stated tolerance')
    return worst, diffs, upd


def optimizer_cases(rng, shape):
    """The eleven update ops at `shape`, inputs from rng: [(op type,
    inputs, attrs, output slots)]. Accumulators that a root or a division
    reads are positive, except Ftrl's squared one, which is 0 at every
    other element, as it starts, with a gradient of 0 at every third."""
    def f():
        return rng.randn(*shape).astype('float32')

    def pos():
        return (rng.rand(*shape) + 0.1).astype('float32')

    def one(v):
        return np.array([v], 'float32')

    def fresh(a, step):
        # Ftrl's accumulators start at 0 and a gradient may be exactly 0
        a.flat[::step] = 0.0
        return a
    cases = [
        ('sgd', {}, {}, ['ParamOut']),
        ('momentum', {'Velocity': f()}, {'mu': 0.9, 'use_nesterov': True},
         ['ParamOut', 'VelocityOut']),
        ('adam', {'Moment1': f(), 'Moment2': pos(),
                  'Beta1Pow': one(0.9 ** 3), 'Beta2Pow': one(0.98 ** 3)},
         {'beta1': 0.9, 'beta2': 0.98, 'epsilon': 1e-9, 'lazy_mode': False},
         ['ParamOut', 'Moment1Out', 'Moment2Out', 'Beta1PowOut',
          'Beta2PowOut']),
        ('adagrad', {'Moment': pos()}, {'epsilon': 1e-6},
         ['ParamOut', 'MomentOut']),
        ('decayed_adagrad', {'Moment': pos()},
         {'decay': 0.95, 'epsilon': 1e-6}, ['ParamOut', 'MomentOut']),
        ('adamax', {'Moment': f(), 'InfNorm': pos(),
                    'Beta1Pow': one(0.9 ** 2)},
         {'beta1': 0.9, 'beta2': 0.999, 'epsilon': 1e-8},
         ['ParamOut', 'MomentOut', 'InfNormOut']),
        ('adadelta', {'AvgSquaredGrad': pos(), 'AvgSquaredUpdate': pos()},
         {'rho': 0.95, 'epsilon': 1e-6},
         ['ParamOut', 'AvgSquaredGradOut', 'AvgSquaredUpdateOut']),
        ('rmsprop', {'MeanSquare': pos(), 'Moment': f()},
         {'decay': 0.9, 'epsilon': 1e-6, 'momentum': 0.5},
         ['ParamOut', 'MeanSquareOut', 'MomentOut']),
        ('ftrl', {'SquaredAccumulator': fresh(pos(), 2),
                  'LinearAccumulator': f(), 'Grad': fresh(f(), 3)},
         {'l1': 0.1, 'l2': 0.2, 'lr_power': -0.5},
         ['ParamOut', 'SquaredAccumOut', 'LinearAccumOut']),
        ('proximal_gd', {}, {'l1': 0.1, 'l2': 0.2}, ['ParamOut']),
        ('proximal_adagrad', {'Moment': pos()}, {'l1': 0.1, 'l2': 0.2},
         ['ParamOut', 'MomentOut']),
    ]
    return [(t, dict({'Param': f(), 'Grad': f(),
                      'LearningRate': one(0.01)}, **accs), attrs, outs)
            for t, accs, attrs, outs in cases]


def run_update(fluid, place, op_type, inputs, attrs, outs):
    """One update op on `place`, fed copies of `inputs`; its outputs as
    CPU tensors."""
    prog = fluid.Program()
    block = prog.global_block()
    ins = {s: [block.create_var(name='in_' + s.lower(), shape=a.shape,
                                dtype='float32', is_data=True)]
           for s, a in inputs.items()}
    out_vars = {s: [block.create_var(name='out_' + s.lower())] for s in outs}
    block.append_op(type=op_type, inputs=ins, outputs=out_vars, attrs=attrs)
    got = fluid.Executor(place).run(
        prog, feed={'in_' + s.lower(): a.copy() for s, a in inputs.items()},
        fetch_list=['out_' + s.lower() for s in outs], scope=fluid.Scope(),
        return_numpy=False)
    return [g.detach().cpu() for g in got]


def check_update(label, got, want):
    """Every output within OPT_TOL of max(1, |ref|), finite and of the
    reference's shape; raises otherwise. Returns the worst error."""
    worst = 0.0
    for g, w in zip(got, want):
        g = np.asarray(g, 'float64')
        w = np.asarray(w, 'float64')
        if g.shape != w.shape or not np.isfinite(g).all():
            raise AssertionError('%s: an output of shape %s (want %s) or '
                                 'not finite' % (label, g.shape, w.shape))
        worst = max(worst, float((np.abs(g - w) /
                                  np.maximum(1.0, np.abs(w))).max()))
    if len(got) != len(want) or worst > OPT_TOL:
        raise AssertionError('%s: an update is %.3e off the CPU one (tol '
                             '%g)' % (label, worst, OPT_TOL))
    return worst


@phase('a3: the eleven optimizer updates on the card vs on CPU copies')
def check_optimizer_ops(place):
    import paddle_tpu_torch as fluid
    rng = np.random.RandomState(SEED + 9)
    worst = {}
    for shape in OPT_SHAPES:
        for op_type, inputs, attrs, outs in optimizer_cases(rng, shape):
            label = '%s %s' % (op_type, list(shape))
            got = run_update(fluid, place, op_type, inputs, attrs, outs)
            want = run_update(fluid, fluid.CPUPlace(), op_type, inputs,
                              attrs, outs)
            worst[op_type] = max(worst.get(op_type, 0.0),
                                 check_update(label, got, want))
    log('optimizer updates on the card vs CPU copies at %s, max error of '
        'max(1, |ref|): %s (tol %g)'
        % (', '.join(str(list(s)) for s in OPT_SHAPES),
           ', '.join('%s %.2e' % kv for kv in worst.items()), OPT_TOL))
    return worst


# op types registered before the training core (phases b to t hold them)
A4_EARLIER_OPS = (
    'abs', 'accuracy', 'argmax', 'assign', 'batch_norm', 'causal_mask',
    'clip', 'clip_by_norm', 'conv2d', 'conv2d_bn', 'cross_entropy',
    'decode_mask', 'depthwise_conv2d', 'elementwise_add', 'elementwise_div',
    'elementwise_max', 'elementwise_mul', 'fill_constant', 'fill_zeros_like',
    'flash_attention', 'fused_softmax_cross_entropy', 'gather_time',
    'gaussian_random', 'gelu', 'kv_cache_append', 'kv_cache_write',
    'layer_norm', 'load', 'load_combine', 'lookup_table', 'matmul', 'mean',
    'momentum', 'mul', 'pool2d', 'position_embedding',
    'position_embedding_at', 'read', 'relu', 'reshape2',
    'reshape_grad_helper', 'save', 'save_combine', 'scale', 'sgd',
    'sharding_constraint', 'slice', 'softmax', 'sqrt', 'square_error_cost',
    'squared_l2_norm', 'sum', 'top_k', 'transpose2', 'uniform_random')
# op types of the training core that a4's table leaves to other checks
A4_HELD_ELSEWHERE = {
    'dropout': 'a4\'s own checks: is_test bits, kept entries, kept share, '
               'grad = dOut·Mask',
    'truncated_gaussian_random': 'a4\'s own check of the draw: the card\'s '
                                 'stream is not the CPU\'s',
    'remat_block': 'x4: the flagship LM with each block a remat scope, '
                   'against remat=None',
    'uniform_random_batch_size_like': 'a4\'s own check of the draw\'s shape '
                                      'and moments',
    'gaussian_random_batch_size_like': 'a4\'s own check of the draw\'s '
                                       'shape and moments',
    'print': 'mo1: its text on stderr, first_n, the captured segments',
    'delete_var': 'mo1: release_memory on fit_a_line, the same losses',
    'nce': 'a4\'s own check: one SGD step is -lr times the grad of the '
           'sampled loss rebuilt from the same draw',
    'sampling_id': 'a4\'s own check of the draw\'s distribution',
    'while': 'cf1: fed trip counts, vs the CPU port',
    'conditional_block': 'cf1: the Switch, vs the CPU port',
    'recurrent': 'mt3: the TrainingDecoder\'s steps and grads, vs op by op '
                 'and the CPU port',
    'write_to_array': 'cf1: the arrays, vs the CPU port',
    'read_from_array': 'cf1: the arrays, vs the CPU port',
    'lod_array_length': 'cf1: the arrays, vs the CPU port',
    'array_to_lod_tensor': 'tests/test_torch_control_flow.py (CPU): a '
                           'stack, no other device work',
    'lod_tensor_to_array': 'tests/test_torch_control_flow.py (CPU): an '
                           'unbind, no other device work',
    'rpn_target_assign': 'a4\'s own check at Faster R-CNN\'s shapes: the '
                         'draw by its properties (check_detection_ops)',
}
for _t in ('adam', 'adagrad', 'decayed_adagrad', 'adamax', 'adadelta',
           'rmsprop', 'ftrl', 'proximal_gd', 'proximal_adagrad'):
    A4_HELD_ELSEWHERE[_t] = 'a3'
A4_HELD_ELSEWHERE.update({
    'feed': 'a marker with no emitter: the Executor consumes it',
    'fetch': 'a marker with no emitter: the Executor consumes it',
    'chunk_eval': 'sq4: a host op over the card\'s Viterbi paths, vs the '
                  'CPU port',
    'random_crop': 'a4\'s own check of the draw\'s properties '
                   '(check_random_crop)',
    'auc': 'a4\'s own check at batch 4096, its state over three batches '
           '(check_item6_ops)',
    'fake_quantize': 'a4\'s own check in its three modes at ResNet-50\'s '
                     'conv outputs (check_item6_ops)',
    'moe_ffn': 'moe1 (the MoE LM) and moe2 (one full-width sequence, vs '
               'the CPU port)',
    'moe_aux_loss': 'moe2: vs the CPU port',
    'ring_attention': 'mp1: the ring of 4 ranks on the card (each block\'s '
                      'K1 and K2 vs their plain versions, the step vs the '
                      'one-process step)',
})
# the parameter-server host ops: on the card's trainers in ps1 and ps2,
# on the host's pservers by design; each also against the JAX package on
# the CPU (tests/test_torch_dist_*.py, test_torch_supervisor.py)
A4_HELD_ELSEWHERE.update({
    t: 'ps1, ps2: %s' % what for t, what in (
        ('send', 'each trainer\'s gradients, pinned and sent'),
        ('recv', 'the pulls into the captured segments\' tensors'),
        ('send_barrier', 'the sync rounds'),
        ('fetch_barrier', 'the sync rounds'),
        ('prefetch', 'ps2\'s distributed table rows'),
        ('split_ids', 'ps2\'s table gradients by shard'),
        ('split_selected_rows', 'ps2\'s first-order table by block'),
        ('slice_rows', 'the pservers\' startups (the host)'),
        ('listen_and_serv', 'the pservers (the host)'))})
A4_HELD_ELSEWHERE.update({
    'merge_ids': 'tests/test_torch_dist_transpiler.py (CPU): a host op, '
                 'vs the JAX package (prefetch merges its own rows)',
    'checkpoint_notify': 'tests/test_torch_supervisor.py (CPU): a host '
                         'op, the pservers\' shards saved',
})

_UNARY_CASES = {
    'sigmoid': {}, 'logsigmoid': {}, 'tanh': {}, 'tanh_shrink': {},
    'exp': {}, 'square': {}, 'ceil': {}, 'floor': {}, 'round': {},
    'sin': {}, 'cos': {}, 'softplus': {}, 'softsign': {}, 'relu6': {},
    'softshrink': {'lambda': 0.5}, 'leaky_relu': {'alpha': 0.1},
    'elu': {'alpha': 1.0}, 'hard_sigmoid': {}, 'brelu': {'t_max': 2.0},
    'swish': {'beta': 1.5}, 'stanh': {}, 'thresholded_relu': {},
    'hard_shrink': {'threshold': 0.5}}
_POSITIVE_UNARY_CASES = {'log': {}, 'rsqrt': {}, 'reciprocal': {},
                         'pow': {'factor': 2.5}}


def training_op_cases(rng):
    """a4's table, inputs from rng: [(name, op type, {slot: array or
    [(var name, array)]}, attrs, {slot: [var names]} or None for {'Out':
    ['out']}, [input var names whose grads are held])]. An array input of
    slot S is the var in_<s>."""
    def f(*s):
        return rng.randn(*s).astype('float32')

    def pos(*s):
        return (rng.rand(*s) * 0.8 + 0.3).astype('float32')
    x, y = f(4, 6), f(4, 6)
    cases = []

    def add(op, inputs=None, attrs=None, outputs=None, check=('in_x',),
            name=None):
        cases.append((name or op, op, inputs or {}, attrs or {}, outputs,
                      list(check)))
    for op, attrs in _UNARY_CASES.items():
        add(op, {'X': 3 * f(4, 6)}, attrs)
    for op, attrs in _POSITIVE_UNARY_CASES.items():
        add(op, {'X': pos(4, 6)}, attrs)
    add('logit', {'X': np.clip(pos(4, 6), 0.2, 0.8)})
    add('elementwise_sub', {'X': f(2, 3, 4), 'Y': f(3)}, {'axis': 1},
        check=('in_x', 'in_y'))
    add('elementwise_min', {'X': x, 'Y': y}, check=('in_x', 'in_y'))
    add('elementwise_pow', {'X': pos(4, 6), 'Y': pos(4, 6) + 1.0},
        check=('in_x', 'in_y'))
    add('elementwise_mod', {'X': pos(4, 6) * 3, 'Y': pos(4, 6) + 1.0})
    add('elementwise_floordiv', {'X': pos(4, 6) * 3, 'Y': pos(4, 6) + 0.5})
    for red in ('sum', 'mean', 'max', 'min', 'prod'):
        add('reduce_' + red, {'X': pos(3, 4, 5) if red == 'prod'
                              else f(3, 4, 5)},
            {'dim': [1], 'keep_dim': red == 'sum', 'reduce_all': False})
    for op in ('less_than', 'less_equal', 'greater_than', 'greater_equal',
               'equal', 'not_equal'):
        add(op, {'X': x, 'Y': np.where(rng.rand(4, 6) < 0.3, x, y)},
            check=())
    b1, b2 = rng.rand(4, 6) < 0.5, rng.rand(4, 6) < 0.5
    for op in ('logical_and', 'logical_or', 'logical_xor'):
        add(op, {'X': b1, 'Y': b2}, check=())
    add('logical_not', {'X': b1}, check=())
    xinf = x.copy()
    xinf[2, 3] = np.inf
    add('isfinite', {'X': [('fin_a', x), ('fin_b', xinf)]}, check=())
    add('argsort', {'X': f(5, 7)}, {'axis': -1},
        {'Out': ['as_out'], 'Indices': ['as_idx']}, check=())
    add('cumsum', {'X': x}, {'axis': 1, 'exclusive': True, 'reverse': True})
    add('where', {'Cond': x > 0, 'X': x, 'Y': y}, check=('in_x', 'in_y'))
    add('increment', {'X': np.array([4.5], 'float32')}, {'step': 1.0},
        check=())
    add('cast', {'X': 3 * x}, {'in_dtype': 'float32', 'out_dtype': 'int64'},
        check=())
    add('concat', {'X': [('cc_a', x), ('cc_b', y)]}, {'axis': 1},
        check=('cc_a', 'cc_b'))
    add('split', {'X': f(5, 4)}, {'sections': [2, 3], 'axis': 0},
        {'Out': ['sp_a', 'sp_b']})
    add('stack', {'X': [('st_a', x), ('st_b', y)]}, {'axis': 1},
        {'Y': ['stack_y']}, check=('st_a', 'st_b'))
    add('expand', {'X': f(2, 3)}, {'expand_times': [2, 3]})
    add('gather', {'X': x, 'Index': np.array([3, 0, 2], 'int64')})
    add('scatter', {'X': x, 'Ids': np.array([2, 0], 'int64'),
                    'Updates': f(2, 6)}, {'overwrite': True},
        check=('in_x', 'in_updates'))
    add('one_hot', {'X': np.array([[1], [0], [4]], 'int64')}, {'depth': 5},
        check=())
    add('pad', {'X': f(2, 3, 4)}, {'paddings': [0, 1, 2, 0, 1, 1],
                                   'pad_value': -1.5})
    add('shape', {'Input': f(2, 3, 4)}, check=())
    add('reshape', {'X': x}, {'shape': [3, -1]})
    add('transpose', {'X': f(2, 3, 4)}, {'axis': [2, 0, 1]})
    add('squeeze', {'X': f(4, 1, 6)}, {'axes': [1]})
    add('unsqueeze', {'X': x}, {'axes': [1]})
    add('squeeze2', {'X': f(4, 1, 6)}, {'axes': [1]},
        {'Out': ['out'], 'XShape': ['xshape']})
    add('unsqueeze2', {'X': x}, {'axes': [0]},
        {'Out': ['out'], 'XShape': ['xshape']})
    add('range', attrs={'start': 2, 'end': 11, 'step': 3, 'dtype': 'int64'},
        check=())
    add('reverse', {'X': x}, {'axis': [0, 1]})
    add('label_smooth', {'X': pos(4, 6)}, {'epsilon': 0.1})
    add('assign_value', attrs={'shape': [2, 3], 'dtype': 'float32',
                               'values': [0.5, -1.0, 2.0, 3.5, 0.0, 1.25]},
        check=())
    add('softmax_with_cross_entropy',
        {'Logits': 2 * f(4, 7),
         'Label': np.array([[0], [6], [-100], [3]], 'int64')},
        {'soft_label': False, 'ignore_index': -100},
        {'Softmax': ['swce_sm'], 'Loss': ['swce_loss']}, check=('in_logits',))
    add('sigmoid_cross_entropy_with_logits',
        {'X': 3 * f(4, 3), 'Label': (rng.rand(4, 3) < 0.5).astype('float32')},
        {'ignore_index': -100})
    # the paged-cache ops (v1-v6 run them at full width), in place on
    # their fed pool; at most one dead row a case (dead rows all land on
    # the null page's row 0, in no set order)
    i32 = np.int32
    add('kv_page_cow', {'Pool': f(4, 2, 2, 2), 'Src': np.array([2, 0, 3], i32),
                        'Dst': np.array([1, 0, 2], i32)}, check=())
    add('kv_page_write', {'Pool': f(5, 2, 2, 3), 'X': f(1, 4, 2, 3),
                          'Table': np.array([[3, 1]], i32),
                          'Positions': np.array([1, 2, 3, 4], i32),
                          'Len': np.array([3], i32)}, check=())
    add('kv_page_append', {'Pool': f(4, 2, 2, 2), 'X': f(3, 1, 2, 2),
                           'Table': np.array([[2, 3], [0, 0], [1, 0]], i32),
                           'Positions': np.array([3, 0, 1], i32)}, check=())
    add('kv_page_append', {'Pool': f(6, 2, 2, 2), 'X': f(2, 3, 2, 2),
                           'Table': np.array([[2, 3], [4, 5]], i32),
                           'Positions': np.array([[1, 2, 3], [2, 3, 4]], i32)},
        check=(), name='kv_page_append_rows')
    add('kv_page_gather', {'Pool': f(4, 2, 2, 2),
                           'Table': np.array([[1, 3], [2, 0]], i32)}, check=())
    add('paged_decode_mask', {'X': f(2, 2, 1, 6),
                              'Positions': np.array([1, 5], i32)}, check=())
    add('spec_verify_mask', {'X': f(2, 2, 3, 6),
                             'Positions': np.array([[1, 2, 3], [3, 4, 9]], i32)},
        check=())
    add('paged_prefill_mask', {'X': f(1, 2, 3, 6),
                               'Positions': np.array([2, 3, 4], i32)},
        check=())
    # the dense ops of the book chapters (bk1-bk3 run none of them)
    add('conv2d_transpose', {'Input': f(2, 3, 5, 5), 'Filter': f(3, 2, 3, 3)},
        {'strides': [2, 2], 'paddings': [1, 1], 'dilations': [1, 1],
         'groups': 1}, {'Output': ['out']}, check=('in_input', 'in_filter'))
    add('huber_loss', {'X': x, 'Y': y}, {'delta': 0.8},
        {'Out': ['out'], 'Residual': ['hl_res']}, check=('in_x', 'in_y'))
    add('smooth_l1_loss', {'X': x, 'Y': y}, {'sigma': 1.5},
        {'Diff': ['sl_diff'], 'Out': ['out']})
    add('prelu', {'X': f(2, 3, 4, 4), 'Alpha': pos(1, 3, 1, 1)},
        {'mode': 'channel'}, check=('in_x', 'in_alpha'))
    add('lrn', {'X': f(2, 6, 4, 4)}, {'n': 5, 'k': 1.0, 'alpha': 1e-4,
                                      'beta': 0.75},
        {'Out': ['out'], 'MidOut': ['lrn_mid']})
    add('argmin', {'X': f(5, 7)}, {'axis': 1}, check=())
    add('fill_constant_batch_size_like', {'Input': f(5, 2)},
        {'shape': [-1, 3], 'dtype': 'float32', 'value': 2.5,
         'input_dim_idx': 0, 'output_dim_idx': 0}, check=())
    # the 19 sequence op types (sq1-sq4 run them at the chapters' widths)
    # over ragged lengths with 1 and T among them
    lens = np.array([5, 1, 3], i32)
    xs = f(3, 5, 4)
    for pool in ('SUM', 'AVERAGE', 'SQRT', 'MAX', 'LAST', 'FIRST'):
        add('sequence_pool', {'X': xs, 'SeqLens': lens}, {'pooltype': pool},
            {'Out': ['out'], 'MaxIndex': ['sp_idx']},
            name='sequence_pool_' + pool.lower())
    add('sequence_softmax', {'X': f(3, 5, 1), 'SeqLens': lens})
    add('sequence_expand', {'X': f(3, 4), 'Y': f(3, 5, 2)})
    add('sequence_conv', {'X': xs, 'Filter': f(12, 6), 'SeqLens': lens},
        {'contextLength': 3, 'contextStart': -1, 'contextStride': 1},
        check=('in_x', 'in_filter'))
    H = 4
    add('lstm', {'Input': 0.5 * f(3, 5, 4 * H), 'Weight': 0.5 * f(H, 4 * H),
                 'Bias': 0.5 * f(1, 7 * H), 'H0': f(3, H), 'C0': f(3, H),
                 'SeqLens': lens},
        {'use_peepholes': True, 'is_reverse': True,
         'gate_activation': 'sigmoid', 'cell_activation': 'tanh',
         'candidate_activation': 'tanh'},
        {'Hidden': ['hidden'], 'Cell': ['cell']},
        check=('in_input', 'in_weight', 'in_bias', 'in_h0', 'in_c0'))
    add('gru', {'Input': f(3, 5, 3 * H), 'Weight': f(H, 3 * H),
                'Bias': f(1, 3 * H), 'H0': f(3, H), 'SeqLens': lens},
        {'is_reverse': True, 'gate_activation': 'sigmoid',
         'activation': 'tanh'}, {'Hidden': ['hidden']},
        check=('in_input', 'in_weight', 'in_bias', 'in_h0'))
    add('cos_sim', {'X': x, 'Y': y}, check=('in_x', 'in_y'))
    crf = {'Emission': f(3, 5, 4), 'Transition': f(6, 4),
           'Label': rng.randint(0, 4, (3, 5, 1)).astype('int64'),
           'SeqLens': lens}
    add('linear_chain_crf', crf, outputs={
        'LogLikelihood': ['crf_ll'], 'Alpha': ['crf_alpha'],
        'EmissionExps': ['crf_eexps'], 'TransitionExps': ['crf_texps']},
        check=('in_emission', 'in_transition'))
    add('crf_decoding', {k: v for k, v in crf.items() if k != 'Label'},
        outputs={'ViterbiPath': ['path']}, check=())
    add('sequence_concat',
        {'X': [('sc_a', f(3, 5, 2)), ('sc_b', f(3, 4, 2))],
         'SeqLens': [('sc_la', lens), ('sc_lb', np.array([2, 4, 1], i32))]},
        outputs={'Out': ['out'], 'OutLens': ['sc_lens']},
        check=('sc_a', 'sc_b'))
    add('sequence_mask', {'X': lens}, {'maxlen': 6, 'out_dtype': 'int64'},
        {'Y': ['y']}, check=())
    add('sequence_pad', {'X': f(3, 5, 2), 'SeqLens': lens,
                         'PadValue': np.array([-2.5], 'float32')},
        {'padded_length': 7}, {'Out': ['out'], 'Length': ['spad_len']})
    add('sequence_unpad', {'X': f(3, 5, 2), 'Length': lens.astype('int64')})
    add('sequence_erase', {'X': rng.randint(0, 5, (3, 5, 1)).astype('int64'),
                           'SeqLens': lens}, {'tokens': [2, 3]},
        {'Out': ['out'], 'OutLens': ['se_lens']}, check=())
    add('sequence_reshape', {'X': f(3, 4, 6),
                             'SeqLens': np.array([4, 1, 2], i32)},
        {'new_dim': 3}, {'Out': ['out'], 'OutLens': ['sr_lens']})
    add('sequence_slice', {'X': f(3, 5, 2),
                           'Offset': np.array([[1], [0], [2]], 'int64'),
                           'Length': np.array([[3], [1], [1]], 'int64'),
                           'SeqLens': lens},
        outputs={'Out': ['out'], 'OutLens': ['ssl_lens']})
    add('row_conv', {'X': xs, 'Filter': f(3, 4), 'SeqLens': lens},
        check=('in_x', 'in_filter'))
    add('im2sequence', {'X': f(2, 3, 5, 6)},
        {'kernels': [2, 3], 'strides': [1, 2], 'paddings': [1, 0, 0, 1]},
        {'Out': ['out'], 'OutLens': ['i2s_lens']})
    add('edit_distance', {'Hyps': rng.randint(0, 4, (3, 5, 1)).astype('int64'),
                          'Refs': rng.randint(0, 4, (3, 6, 1)).astype('int64'),
                          'HypLens': lens,
                          'RefLens': np.array([6, 2, 0], i32)},
        {'normalized': True}, {'Out': ['out'], 'SequenceNum': ['ed_num']},
        check=())
    # the two repaired sequence op types (the JAX package gives them no
    # grad), the RNN units, CTC, the remaining losses, the rank table and
    # the beam ops (cf1 and mt1-mt3 run the rest of the slice's new types)
    add('sequence_first_step', {'X': xs, 'SeqLens': lens}, check=())
    add('sequence_last_step', {'X': xs, 'SeqLens': lens}, check=())
    add('lstm_unit', {'X': f(3, 4 * H), 'C_prev': f(3, H)},
        {'forget_bias': 0.5}, {'C': ['luc'], 'H': ['luh']},
        check=('in_x', 'in_c_prev'))
    add('gru_unit', {'Input': f(3, 3 * H), 'HiddenPrev': f(3, H),
                     'Weight': f(H, 3 * H), 'Bias': f(1, 3 * H)},
        {'activation': 'tanh', 'gate_activation': 'sigmoid'},
        {'Hidden': ['hidden'], 'Gate': ['gu_gate'],
         'ResetHiddenPrev': ['gu_reset']},
        check=('in_input', 'in_hiddenprev', 'in_weight', 'in_bias'))
    add('lstmp', {'Input': 0.5 * f(3, 5, 4 * H), 'Weight': 0.5 * f(3, 4 * H),
                  'ProjWeight': 0.5 * f(H, 3), 'Bias': 0.5 * f(1, 7 * H),
                  'H0': f(3, H), 'C0': f(3, H), 'SeqLens': lens},
        {'use_peepholes': True, 'is_reverse': True,
         'gate_activation': 'sigmoid', 'cell_activation': 'tanh',
         'candidate_activation': 'tanh', 'proj_activation': 'tanh'},
        {'Projection': ['proj'], 'Cell': ['cell']},
        check=('in_input', 'in_weight', 'in_projweight', 'in_bias', 'in_h0',
               'in_c0'))
    for blank, norm in ((0, False), (2, True)):
        labels = rng.randint(0, 4, (4, 3))
        add('warpctc', {'Logits': f(4, 6, 5),
                        'Label': np.where(labels >= blank, labels + 1,
                                          labels).astype(i32),
                        'SeqLens': np.array([6, 5, 2, 4], i32),
                        'LabelLens': np.array([3, 2, 1, 0], i32)},
            {'blank': blank, 'norm_by_times': norm}, {'Loss': ['loss']},
            check=('in_logits',), name='warpctc_blank%d' % blank)
    add('ctc_align', {'Input': rng.randint(0, 4, (3, 6)).astype(i32),
                      'SeqLens': np.array([6, 5, 3], i32)},
        {'blank': 0, 'padding_value': 0},
        {'Output': ['out'], 'OutLens': ['ca_lens']}, check=())
    add('hinge_loss', {'Logits': f(4, 1),
                       'Labels': (rng.rand(4, 1) < 0.5).astype('float32')},
        outputs={'Loss': ['loss']}, check=('in_logits',))
    add('log_loss', {'Predicted': pos(4, 1) * 0.9,
                     'Labels': (rng.rand(4, 1) < 0.5).astype('float32')},
        {'epsilon': 1e-4}, {'Loss': ['loss']}, check=('in_predicted',))
    add('margin_rank_loss', {'X1': f(4, 1), 'X2': f(4, 1),
                             'Label': np.sign(f(4, 1))},
        {'margin': 0.1}, {'Out': ['out'], 'Activated': ['mr_act']},
        check=('in_x1', 'in_x2'))
    add('squared_l2_distance', {'X': f(3, 4), 'Y': f(1, 4)},
        outputs={'Out': ['out'], 'sub_result': ['sq_sub']},
        check=('in_x', 'in_y'))
    add('maxout', {'X': f(2, 6, 3, 3)}, {'groups': 3})
    add('hierarchical_sigmoid', {'X': f(4, 5), 'W': f(6, 5), 'Bias': f(6),
                                 'Label': np.array([[0], [6], [2], [3]],
                                                   'int64')},
        {'num_classes': 7}, check=('in_x', 'in_w', 'in_bias'))
    add('lod_rank_table', {'X': xs, 'SeqLens': lens}, check=())
    add('reorder_lod_tensor_by_rank',
        {'X': xs, 'RankTable': np.array([0, 2, 1], i32), 'SeqLens': lens},
        outputs={'Out': ['out'], 'OutLens': ['ro_lens']})
    add('max_sequence_len', {'RankTable': lens}, check=())
    add('is_empty', {'X': x}, check=())
    logp = np.log(rng.dirichlet(np.ones(7), (3, 4))).astype('float32')
    logp[1, 2] = logp[1, 1]                       # a tie across beams
    add('beam_search', {'PreIds': np.array([[1, 0, 2, 3], [4, 5, 6, 1],
                                            [0, 0, 0, 0]], 'int64'),
                        'PreScores': np.array([[0., -1e9, -1e9, -1e9],
                                               [-1., -2., -2., -3.],
                                               [-1., -1., -2., -2.]],
                                              'float32'),
                        'Scores': logp},
        {'beam_size': 4, 'end_id': 0},
        {'SelectedIds': ['bs_ids'], 'SelectedScores': ['bs_scores'],
         'ParentIdx': ['bs_parents']}, check=())
    add('beam_search_decode', {'Ids': rng.randint(0, 9, (5, 3, 4)).astype(
        'int64'), 'ParentIdx': rng.randint(0, 4, (5, 3, 4)).astype(i32),
        'Scores': f(3, 4)},
        outputs={'SentenceIds': ['bsd_ids'], 'SentenceScores': ['bsd_sc']},
        check=())
    add('beam_gather', {'X': f(3, 4, 6),
                        'Indices': rng.randint(0, 4, (3, 4)).astype(i32)})
    return cases + detection_op_cases(rng) + item6_op_cases(rng)


def item6_op_cases(rng):
    """a4's cases of ROADMAP item 6's op types at small shapes (as
    training_op_cases): the misc tensor ops, the 3-D and indexed pooling
    and convolution, precision_recall, positive_negative_pair and
    fake_dequantize_max_abs. check_item6_ops holds them again at
    published shapes."""
    def f(*s):
        return rng.randn(*s).astype('float32')
    cases = []

    def add(op, inputs=None, attrs=None, outputs=None, check=('in_x',),
            name=None):
        cases.append((name or op, op, inputs or {}, attrs or {}, outputs,
                      list(check)))
    add('sign', {'X': f(4, 5)}, check=())
    add('minus', {'X': f(4, 5), 'Y': f(4, 5)}, check=('in_x', 'in_y'))
    add('multiplex', {'X': [('mx%d' % i, f(4, 5)) for i in range(3)],
                      'Ids': np.array([[2], [0], [1], [2]], 'int32')},
        check=('mx0', 'mx1', 'mx2'))
    add('rank_loss', {'Label': (rng.rand(6, 1) > 0.5).astype('float32'),
                      'Left': f(6, 1), 'Right': f(6, 1)},
        check=('in_left', 'in_right'))
    add('modified_huber_loss',
        {'X': 2 * f(8, 1), 'Y': (rng.rand(8, 1) > 0.5).astype('float32')},
        outputs={'Out': ['out'], 'IntermediateVal': ['mh_inter']})
    add('l1_norm', {'X': f(3, 4)})
    add('norm', {'X': f(2, 3, 4)}, {'axis': 1, 'epsilon': 1e-6},
        {'Out': ['out'], 'Norm': ['norm_n']})
    add('mean_iou', {'Predictions': rng.randint(0, 4, (3, 7)).astype(
        'int32'), 'Labels': rng.randint(0, 4, (3, 7)).astype('int32')},
        {'num_classes': 5}, {'OutMeanIou': ['miou'], 'OutWrong': ['mw'],
                             'OutCorrect': ['mc']}, check=())
    add('flatten', {'X': f(2, 3, 4, 5)}, {'axis': 2})
    add('crop', {'X': f(3, 5, 6)}, {'shape': [2, 3, 4],
                                    'offsets': [1, 2, 1]})
    add('crop', {'X': f(3, 5, 6), 'Offsets': np.array([1, 4, 3], 'int32')},
        {'shape': [2, 3, 4]}, name='crop offsets')
    add('pad_constant_like', {'X': f(4, 5, 6), 'Y': f(2, 5, 3)},
        {'pad_value': 1.5}, check=('in_y',))
    add('unstack', {'X': f(3, 4, 2)}, {'axis': 1},
        {'Y': ['us%d' % i for i in range(4)]})
    add('bilinear_tensor_product', {'X': f(4, 3), 'Y': f(4, 5),
                                    'Weight': f(6, 3, 5), 'Bias': f(1, 6)},
        check=('in_x', 'in_y', 'in_weight', 'in_bias'))
    add('bilinear_interp', {'X': f(2, 3, 5, 7)}, {'out_h': 9, 'out_w': 4})
    add('fill', {}, {'value': [0.5, -1.0, 2.0, 3.25], 'shape': [2, 2],
                     'dtype': 'float32'}, check=())
    add('lod_reset', {'X': f(3, 4, 2),
                      'TargetLens': np.array([0, 2, 6, 7], 'int32')},
        {'target_is_offsets': True}, {'Out': ['out'], 'OutLens': ['lr_lens']})
    add('conv3d', {'Input': f(2, 3, 4, 5, 6), 'Filter': 0.3 * f(4, 3, 3, 3,
                                                               3)},
        {'paddings': [1, 1, 1], 'strides': [1, 2, 1]},
        {'Output': ['out']}, check=('in_input', 'in_filter'))
    add('conv3d_transpose', {'Input': f(2, 3, 3, 4, 3),
                             'Filter': f(3, 2, 3, 3, 2)},
        {'strides': [2, 1, 2], 'paddings': [1, 0, 0]},
        {'Output': ['out']}, check=('in_input', 'in_filter'))
    add('depthwise_conv2d_transpose', {'Input': f(2, 3, 4, 5),
                                       'Filter': f(3, 1, 3, 3)},
        {'strides': [2, 2], 'paddings': [1, 0]}, {'Output': ['out']},
        check=('in_input', 'in_filter'))
    for ptype in ('max', 'avg'):
        add('pool3d', {'X': f(2, 3, 5, 6, 7)},
            {'pooling_type': ptype, 'ksize': [2, 2, 3], 'strides': [2, 2, 2],
             'paddings': [0, 1, 1], 'ceil_mode': True},
            name='pool3d %s' % ptype)
    add('max_pool2d_with_index', {'X': f(2, 3, 7, 8)},
        {'ksize': [3, 3], 'strides': [2, 2], 'paddings': [1, 1]},
        {'Out': ['out'], 'Mask': ['mp2_mask']})
    add('max_pool3d_with_index', {'X': f(2, 3, 4, 5, 6)},
        {'ksize': [2, 3, 2], 'strides': [2, 2, 2], 'paddings': [1, 1, 0]},
        {'Out': ['out'], 'Mask': ['mp3_mask']})
    add('unpool', {'X': f(2, 3, 3, 3), 'Indices': rng.randint(
        0, 36, (2, 3, 3, 3)).astype('int32')},
        {'unpooled_height': 6, 'unpooled_width': 6})
    add('spp', {'X': f(2, 3, 7, 9)}, {'pyramid_height': 3,
                                      'pooling_type': 'max'})
    add('conv_shift', {'X': f(3, 8), 'Y': f(3, 5)}, check=('in_x', 'in_y'))
    add('precision_recall',
        {'Indices': rng.randint(0, 5, (16, 1)).astype('int64'),
         'Labels': rng.randint(0, 5, (16, 1)).astype('int64'),
         'Weights': rng.rand(16, 1).astype('float32'),
         'StatesInfo': (3 * rng.rand(5, 4)).astype('float32')},
        {'class_number': 5},
        {'BatchMetrics': ['pr_batch'], 'AccumMetrics': ['pr_accum'],
         'AccumStatesInfo': ['pr_states']}, check=())
    add('positive_negative_pair',
        {'Score': rng.rand(24, 3).astype('float32'),
         'Label': rng.randint(0, 3, (24, 1)).astype('float32'),
         'QueryID': rng.randint(0, 4, (24, 1)).astype('int64'),
         'Weight': rng.rand(24, 1).astype('float32')}, {'column': 1},
        {'PositivePair': ['pnp_pos'], 'NegativePair': ['pnp_neg'],
         'NeutralPair': ['pnp_neu']}, check=())
    add('fake_dequantize_max_abs',
        {'X': rng.randint(-127, 128, (5, 7)).astype('float32'),
         'Scale': np.array([3.7], 'float32')}, {'max_range': 127.0},
        check=())
    return cases


def uncovered_op_types(cases):
    """Op types of the port registered after A4_EARLIER_OPS that neither
    the table nor A4_HELD_ELSEWHERE holds."""
    from paddle_tpu_torch import registry
    new = {t for t in registry._REGISTRY if not t.endswith('_grad')} - \
        set(A4_EARLIER_OPS)
    return sorted(new - {c[1] for c in cases} - set(A4_HELD_ELSEWHERE))


def run_op_case(fluid, place, case, shapes=None, host=True):
    """One case's op on `place`, fed copies: {var name: numpy array} of
    its outputs and of the held inputs' grads against a fixed cotangent
    on its Loss, Out, Output, OutputBox, Hidden, LogLikelihood or Y
    outputs. shapes: the targets' run-time shapes where the caller knows
    them (else a forward run on the CPU finds them). host=False: the
    tensors as the run left them, on `place`."""
    import torch
    _, op_type, inputs, attrs, outputs, check = case
    prog = fluid.Program()
    block = prog.global_block()
    feed, ins = {}, {}
    for slot, val in inputs.items():
        named = val if isinstance(val, list) else \
            [('in_' + slot.lower(), val)]
        ins[slot] = []
        for name, arr in named:
            ins[slot].append(block.create_var(
                name=name, shape=arr.shape, dtype=arr.dtype.name,
                is_data=True, stop_gradient=name not in check))
            feed[name] = arr.copy()
    outputs = outputs or {'Out': ['out']}
    outs = {slot: [block.create_var(name=n) for n in names]
            for slot, names in outputs.items()}
    fetch = [n for names in outputs.values() for n in names]
    with fluid.program_guard(prog, fluid.Program()):
        block.append_op(type=op_type, inputs=ins, outputs=outs,
                        attrs=dict(attrs))
        if check:
            targets = outs.get('Loss') or outs.get('Out') or \
                outs.get('Output') or outs.get('OutputBox') or \
                outs.get('Hidden') or \
                outs.get('LogLikelihood') or outs.get('Projection') or \
                outs.get('H') or outs['Y']
            # the cotangents take the outputs' run-time shapes (a sequence
            # op's declared shape can differ: sequence_pool keeps its
            # input's, the CRF's is [-1, 1])
            if shapes is None:
                shapes = [tuple(np.shape(v)) for v in fluid.Executor(
                    fluid.CPUPlace()).run(prog, feed=feed,
                                          fetch_list=targets,
                                          scope=fluid.Scope())]
            cots = []
            for i, (t, shape) in enumerate(zip(targets, shapes)):
                cot = block.create_var(name='cot_%d' % i, shape=shape,
                                       dtype='float32', is_data=True,
                                       stop_gradient=True)
                feed[cot.name] = np.asarray(np.random.RandomState(
                    i + 1).randn(*shape), 'float32')
                cots.append(cot)
            grads = fluid.backward.calc_gradient(
                targets, [block.var(n) for n in check],
                target_gradients=cots)
            fetch += [g.name for g in grads]
    got = fluid.Executor(place).run(prog, feed=feed, fetch_list=fetch,
                                    scope=fluid.Scope(), return_numpy=False)
    if not host:
        return dict(zip(fetch, got))
    return {n: (g.detach().float() if g.dtype == torch.bfloat16 else
                g.detach()).cpu().numpy() for n, g in zip(fetch, got)}


def check_op_outputs(label, got, want):
    """fp32 within OP_ATOL + OP_RTOL·|ref|; integer and bool outputs
    exact; the same names and shapes. Raises; returns the worst fp32
    error over (OP_ATOL + OP_RTOL·|ref|)."""
    if sorted(got) != sorted(want):
        raise AssertionError('%s: outputs %s, want %s'
                             % (label, sorted(got), sorted(want)))
    worst = 0.0
    for n, w in want.items():
        g = got[n]
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError('%s: %s is %s %s, want %s %s'
                                 % (label, n, g.dtype, g.shape, w.dtype,
                                    w.shape))
        if w.dtype.kind in 'biu':
            if not np.array_equal(g, w):
                raise AssertionError('%s: %s differs' % (label, n))
            continue
        both_inf = np.isinf(w) & (g == w)
        err = np.where(both_inf, 0.0, np.abs(g.astype('float64') - w) /
                       (OP_ATOL + OP_RTOL * np.abs(w)))
        worst = max(worst, float(err.max()) if err.size else 0.0)
        if not (err <= 1.0).all():
            raise AssertionError('%s: %s is %.3g x the tolerance off'
                                 % (label, n, float(np.nanmax(err))))
    return worst


def _dropout_program(fluid, shape, impl, is_test):
    """dropout (seed 0: the executor's generator) of a fed x, its grad
    against a fed cotangent."""
    prog = fluid.Program()
    block = prog.global_block()
    with fluid.program_guard(prog, fluid.Program()):
        x = block.create_var(name='x', shape=shape, dtype='float32',
                             is_data=True, stop_gradient=False)
        out, mask = block.create_var(name='out'), block.create_var(
            name='mask', stop_gradient=True)
        block.append_op(type='dropout', inputs={'X': [x]},
                        outputs={'Out': [out], 'Mask': [mask]},
                        attrs={'dropout_prob': DROPOUT_P, 'is_test': is_test,
                               'seed': 0, 'dropout_implementation': impl})
        cot = block.create_var(name='cot', shape=shape, dtype='float32',
                               is_data=True, stop_gradient=True)
        grad, = fluid.backward.calc_gradient([out], [x],
                                             target_gradients=[cot])
    prog.random_seed = SEED
    return prog, grad.name


def check_dropout(place):
    """is_test: the card's outputs are the CPU's bits. Training, over
    DROPOUT_N elements: dropped entries 0, kept ones x (downgrade_in_infer)
    or x / (1 - p) (upscale_in_train; within 1e-6 relative, as the mask's
    1 / (1 - p)), the kept share within 0.01 of 1 - p, and the grad
    exactly dOut·Mask. Returns the kept shares."""
    import paddle_tpu_torch as fluid
    rng = np.random.RandomState(SEED + 11)
    shares = {}
    for impl in ('downgrade_in_infer', 'upscale_in_train'):
        x = (rng.randn(4, 6) + 3).astype('float32')
        res = []
        for p in (place, fluid.CPUPlace()):
            prog, gname = _dropout_program(fluid, x.shape, impl, True)
            res.append(fluid.Executor(p).run(
                prog, feed={'x': x.copy(), 'cot': np.ones_like(x)},
                fetch_list=['out', 'mask'], scope=fluid.Scope()))
        for g, w in zip(*res):
            if not np.array_equal(g, w):
                raise AssertionError('dropout %s is_test: the card\'s '
                                     'output is not the CPU\'s' % impl)
        x = (rng.randn(DROPOUT_N // 1024, 1024) + 3).astype('float32')
        dout = rng.randn(*x.shape).astype('float32')
        prog, gname = _dropout_program(fluid, x.shape, impl, False)
        out, mask, dx = fluid.Executor(place).run(
            prog, feed={'x': x.copy(), 'cot': dout},
            fetch_list=['out', 'mask', gname], scope=fluid.Scope())
        keep = mask > 0
        kept = x / np.float32(1.0 - DROPOUT_P) \
            if impl == 'upscale_in_train' else x
        scale = 1.0 / (1.0 - DROPOUT_P) if impl == 'upscale_in_train' \
            else 1.0
        share = float(keep.mean())
        shares[impl] = share
        # x / (1 - p) on the card may be x times the rounded reciprocal:
        # within a few ulps
        if not (np.allclose(out[keep], kept[keep], rtol=1e-6, atol=0)
                and not out[~keep].any()
                and np.allclose(mask[keep], scale, rtol=1e-6, atol=0)
                and abs(share - (1.0 - DROPOUT_P)) <= 0.01
                and np.array_equal(dx, dout * mask)):
            raise AssertionError('dropout %s on the card: kept share %.4f, '
                                 'or an entry, the mask or the grad wrong'
                                 % (impl, share))
    return shares


def check_truncated_normal(place):
    """The card's truncated_gaussian_random draw: within mean +- 2 std,
    its mean and std (0.8796 of std at a 2-sigma cut) within 0.01."""
    import paddle_tpu_torch as fluid
    prog = fluid.Program()
    prog.random_seed = SEED
    block = prog.global_block()
    block.append_op(type='truncated_gaussian_random',
                    outputs={'Out': [block.create_var(name='w')]},
                    attrs={'shape': [1024, 1024], 'mean': 0.0, 'std': 1.0,
                           'dtype': 'float32'})
    w, = fluid.Executor(place).run(prog, fetch_list=['w'],
                                   scope=fluid.Scope())
    if not (np.abs(w).max() <= 2.0 and abs(w.mean()) < 0.01
            and abs(w.std() - 0.8796) < 0.01):
        raise AssertionError('truncated_gaussian_random: |w| max %.4f, mean '
                             '%.4f, std %.4f' % (np.abs(w).max(), w.mean(),
                                                 w.std()))
    return float(w.mean()), float(w.std())


def check_batch_size_like(place):
    """The card's uniform and gaussian *_batch_size_like draws: the
    shape from the input's batch, within the uniform's bounds, and
    moments within 0.02 of the asked ones."""
    import paddle_tpu_torch as fluid
    prog = fluid.Program()
    prog.random_seed = SEED
    with fluid.program_guard(prog, fluid.Program()):
        x = fluid.layers.data(name='x', shape=[7], dtype='float32')
        u = fluid.layers.uniform_random_batch_size_like(
            x, shape=[-1, 4096], min=-2.0, max=3.0)
        g = fluid.layers.gaussian_random_batch_size_like(
            x, shape=[-1, 4096], mean=1.0, std=0.5)
    uv, gv = fluid.Executor(place).run(
        prog, feed={'x': np.zeros((64, 7), 'float32')}, fetch_list=[u, g],
        scope=fluid.Scope())
    ok = (uv.shape == gv.shape == (64, 4096) and uv.min() >= -2.0 and
          uv.max() < 3.0 and abs(uv.mean() - 0.5) < 0.02 and
          abs(uv.std() - 5 / 12 ** 0.5) < 0.02 and
          abs(gv.mean() - 1.0) < 0.02 and abs(gv.std() - 0.5) < 0.02)
    if not ok:
        raise AssertionError('*_batch_size_like draws: shapes %s %s, uniform '
                             'mean %.4f std %.4f, gaussian mean %.4f std %.4f'
                             % (uv.shape, gv.shape, uv.mean(), uv.std(),
                                gv.mean(), gv.std()))
    return float(uv.mean()), float(gv.std())


AMP_TOL = 2e-2               # a4: lstmp under AMP, the card vs the CPU


def check_lstmp_amp(place):
    """lstmp behind an fc under AMP (the bf16 stream; its H0 projection
    cast to it): the card's projection, cell and grads within AMP_TOL
    of the CPU port's. Returns the largest difference."""
    import paddle_tpu_torch as fluid
    rng = np.random.RandomState(SEED + 12)
    B, T, H, P = 3, 5, 4, 3

    def build(fluid):
        L = fluid.layers
        x = L.data(name='x', shape=[B, T, 6], dtype='float32',
                   append_batch_size=False)
        h0 = L.data(name='h0', shape=[B, H], dtype='float32',
                    append_batch_size=False)
        lens = L.data(name='lens', shape=[B], dtype='int32',
                      append_batch_size=False)
        proj = L.fc(input=x, size=4 * H, num_flatten_dims=2)
        helper = fluid.layer_helper.LayerHelper('lstmp')
        w = helper.create_parameter(attr=None, shape=[P, 4 * H],
                                    dtype='float32')
        pw = helper.create_parameter(attr=None, shape=[H, P],
                                     dtype='float32')
        b = helper.create_parameter(attr=None, shape=[1, 7 * H],
                                    dtype='float32', is_bias=True)
        out = [helper.create_variable_for_type_inference('float32')
               for _ in range(2)]
        helper.append_op(type='lstmp', inputs={
            'Input': [proj], 'Weight': [w], 'ProjWeight': [pw], 'Bias': [b],
            'H0': [h0], 'SeqLens': [lens]},
            outputs={'Projection': [out[0]], 'Cell': [out[1]]},
            attrs={'use_peepholes': True, 'is_reverse': False,
                   'gate_activation': 'sigmoid', 'cell_activation': 'tanh',
                   'candidate_activation': 'tanh',
                   'proj_activation': 'tanh'})
        loss = L.reduce_sum(L.cast(out[0], 'float32'))
        grads = fluid.backward.calc_gradient(loss, [w, pw])
        return out + grads

    main, startup, fetch = _cf_program(build)
    main._use_bf16 = True
    feed = {'x': rng.randn(B, T, 6).astype('float32'),
            'h0': rng.randn(B, H).astype('float32'),
            'lens': np.array([5, 1, 3], 'int32')}
    got = []
    for p in (place, fluid.CPUPlace()):
        scope = fluid.Scope()
        if got:
            for n, t in saved.items():
                scope.set_var(n, t.cpu().clone())
        else:
            fluid.Executor(p).run(startup, scope=scope)
            saved = {v.name: scope.find_var(v.name) for v in
                     startup.list_vars() if v.persistable}
        got.append([np.asarray(v, np.float32) for v in fluid.Executor(p).run(
            main, feed=feed, fetch_list=fetch, scope=scope)])
    err = max(float(np.abs(g - w).max() / max(1.0, np.abs(w).max()))
              for g, w in zip(*got))
    if not err <= AMP_TOL:
        raise AssertionError('lstmp under AMP: the card is %.3e from the '
                             'CPU port (tol %g)' % (err, AMP_TOL))
    return err


def check_sampled_ops(place):
    """nce and sampling_id on the card, by the JAX package's properties:
    one SGD step through nce equals -lr times the gradient of the
    sampled loss rebuilt from the same draw (the op's first draw of a
    generator seeded from the program's random_seed), so its grad saw
    its forward's negatives; sampling_id's draws follow their
    distribution."""
    import torch
    import torch.nn.functional as F
    import paddle_tpu_torch as fluid
    V, D, Bn, S, LR, seed = 1000, 64, 256, 16, 0.1, SEED + 13
    rng = np.random.RandomState(seed)
    tv = rng.randint(0, V, (Bn, 1)).astype('int64')
    xv = rng.randn(Bn, D).astype('float32')

    def build(fluid):
        L = fluid.layers
        x = L.data(name='x', shape=[D], dtype='float32')
        t = L.data(name='t', shape=[1], dtype='int64')
        loss = L.mean(L.nce(x, t, num_total_classes=V, num_neg_samples=S,
                            param_attr=_attr(fluid, 'nw'),
                            bias_attr=_attr(fluid, 'nb')))
        fluid.optimizer.SGD(LR).minimize(loss)
        return [loss]
    main, startup, fetch = _cf_program(build, seed=seed)
    scope = fluid.Scope()
    fluid.Executor(place).run(startup, scope=scope)
    w0, b0 = scope.find_var('nw').clone(), scope.find_var('nb').clone()
    fluid.Executor(place).run(main, feed={'x': xv, 't': tv},
                              fetch_list=fetch, scope=scope)
    dev = w0.device
    negs = torch.randint(0, V, (Bn, S), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(
                             seed))
    w = w0.clone().requires_grad_()
    lab = torch.from_numpy(tv.reshape(-1)).to(dev)
    x = torch.from_numpy(xv).to(dev)
    log_nq = float(np.log(np.float32(S / V)))
    s_pos = (x * w[lab]).sum(-1) + b0[lab] - log_nq
    s_neg = (x[:, None] * w[negs]).sum(-1) + b0[negs] - log_nq
    ref = (F.softplus(-s_pos) + F.softplus(s_neg).sum(1)).mean()
    gw, = torch.autograd.grad(ref, w)
    err = float((scope.find_var('nw') - (w0 - LR * gw)).abs().max())
    if not err <= 1e-6 + 1e-4 * float(w0.abs().max()):
        raise AssertionError('nce on the card: the step is %.3e from -lr x '
                             'the sampled loss\'s grad' % err)

    def sample(fluid):
        return [fluid.layers.sampling_id(fluid.layers.data(
            name='p', shape=[3], dtype='float32'))]
    main, _, fetch = _cf_program(sample, seed=seed)
    probs = np.tile(np.array([[0.05, 0.9, 0.05]], 'float32'), (4096, 1))
    exe = fluid.Executor(place)
    draws = [exe.run(main, feed={'p': probs}, fetch_list=fetch)[0]
             for _ in range(3)]
    share = float((draws[-1] == 1).mean())
    if not (0.88 < share < 0.92 and (draws[0] != draws[-1]).any()):
        raise AssertionError('sampling_id on the card: share %.4f of the '
                             '0.9 class, or the replays drew alike' % share)
    log('a4 sampled ops: nce step within %.3e of -lr x the grad of its '
        'sampled loss; sampling_id share %.4f of the 0.9 class over 4096 '
        'rows (the third run a replay)' % (err, share))


def _det_boxes(rng, n, scale=1.0, size=0.4):
    xy = rng.rand(n, 2) * scale
    wh = (0.05 + rng.rand(n, 2) * size) * scale
    return np.concatenate([xy, xy + wh], -1).astype('float32')


def detection_op_cases(rng):
    """a4's cases of the detection op types at small shapes (as
    training_op_cases); rpn_target_assign draws, so check_detection_ops
    holds it by its properties."""
    def f(*s):
        return rng.randn(*s).astype('float32')
    i32 = 'int32'
    cases = []

    def add(name, op, inputs, attrs=None, outputs=None, check=()):
        cases.append((name, op, inputs, attrs or {}, outputs, list(check)))
    add('iou_similarity', 'iou_similarity',
        {'X': _det_boxes(rng, 5), 'Y': _det_boxes(rng, 6)},
        check=('in_x', 'in_y'))
    add('prior_box', 'prior_box', {'Input': np.zeros((1, 4, 3, 5), 'f4'),
                                   'Image': np.zeros((1, 3, 48, 80), 'f4')},
        {'min_sizes': [16.0], 'max_sizes': [32.0],
         'aspect_ratios': [1.0, 2.0, 3.0], 'flip': True, 'clip': True},
        {'Boxes': ['pb_boxes'], 'Variances': ['pb_var']})
    priors = _det_boxes(rng, 6)
    add('box_coder encode', 'box_coder',
        {'PriorBox': priors, 'PriorBoxVar': np.full((6, 4), 0.1, 'f4'),
         'TargetBox': _det_boxes(rng, 3)},
        {'code_type': 'encode_center_size'}, {'OutputBox': ['bc_out']},
        check=('in_targetbox',))
    add('box_coder decode', 'box_coder',
        {'PriorBox': priors, 'PriorBoxVar': np.full((6, 4), 0.2, 'f4'),
         'TargetBox': 0.5 * f(3, 6, 4)},
        {'code_type': 'decode_center_size'}, {'OutputBox': ['bc_out']},
        check=('in_targetbox',))
    boxes = np.stack([_det_boxes(rng, 20, size=0.5) for _ in range(2)])
    scores = rng.dirichlet(np.ones(3), (2, 20)).transpose(0, 2, 1).astype(
        'float32')
    scores[:, 1, :6] = 0.5                        # ties
    add('multiclass_nms', 'multiclass_nms', {'BBoxes': boxes,
                                             'Scores': scores},
        {'score_threshold': 0.05, 'nms_top_k': 10, 'keep_top_k': 12,
         'nms_threshold': 0.4},
        {'Out': ['nms_out'], 'ValidCount': ['nms_count']})
    dist = rng.rand(2, 3, 7).astype('float32')
    dist[0, 1, 2] = dist[0, 0, 4] = dist.max() + 0.1      # a tie
    add('bipartite_match', 'bipartite_match', {'DistMat': dist},
        {'match_type': 'per_prediction', 'dist_threshold': 0.4},
        {'ColToRowMatchIndices': ['bm_idx'], 'ColToRowMatchDist': ['bm_d']})
    add('target_assign', 'target_assign',
        {'X': f(2, 3, 4), 'MatchIndices': rng.randint(-1, 3, (2, 6)).astype(
            i32)}, {'mismatch_value': -7},
        {'Out': ['ta_out'], 'OutWeight': ['ta_w']})
    add('anchor_generator', 'anchor_generator',
        {'Input': np.zeros((1, 4, 3, 5), 'f4')},
        {'anchor_sizes': [32.0, 64.0], 'aspect_ratios': [0.5, 1.0, 2.0],
         'stride': [16.0, 16.0]},
        {'Anchors': ['ag_anchors'], 'Variances': ['ag_var']})
    g = np.arange(4) / 4.0
    gx, gy = np.meshgrid(g, g)
    grid = np.stack([gx.ravel(), gy.ravel(), gx.ravel() + 0.25,
                     gy.ravel() + 0.25], -1).astype('float32')
    labels = rng.randint(1, 3, (2, 3)).astype('int64')
    labels[1, 2] = -1
    add('ssd_loss', 'ssd_loss',
        {'Location': 0.1 * f(2, 16, 4), 'Confidence': f(2, 16, 3),
         'GtBox': np.stack([_det_boxes(rng, 3, size=0.3)
                            for _ in range(2)]),
         'GtLabel': labels, 'PriorBox': grid,
         'PriorBoxVar': np.full((16, 4), 0.1, 'f4')},
        {'overlap_threshold': 0.3}, {'Loss': ['ssd_loss_out']},
        check=('in_location', 'in_confidence'))
    match = rng.randint(-1, 3, (2, 10)).astype(i32)
    add('mine_hard_examples', 'mine_hard_examples',
        {'ClsLoss': np.round(rng.rand(2, 10), 1).astype('float32'),
         'MatchIndices': match},
        {'neg_pos_ratio': 1.0},
        {'NegMask': ['mh_neg'], 'UpdatedMatchIndices': ['mh_upd']})
    x = f(2, 3, 8, 9)
    rois = np.array([[0, 0, 16, 18], [4, 2, 10, 12], [-3, -2, 6, 5],
                     [10, 8, 30, 20]], 'float32')
    bidx = np.array([0, 1, 1, 0], i32)
    for op, ph in (('roi_align', 3), ('roi_pool', 2)):
        add(op, op, {'X': x, 'ROIs': rois, 'RoisBatchIdx': bidx},
            {'pooled_height': ph, 'pooled_width': 2, 'spatial_scale': 0.5,
             'sampling_ratio': 2}, check=('in_x',))
    A, H, W = 3, 4, 5
    add('generate_proposals', 'generate_proposals',
        {'Scores': rng.rand(1, A, H, W).astype('float32'),
         'BboxDeltas': 0.2 * f(1, 4 * A, H, W),
         'ImInfo': np.array([[30.0, 38.0, 1.0]], 'float32'),
         'Anchors': frcnn_anchors(H, W, [8.0, 16.0, 24.0], [1.0], 8.0),
         'Variances': np.ones((H, W, A, 4), 'float32')},
        {'pre_nms_topN': 30, 'post_nms_topN': 10, 'nms_thresh': 0.5,
         'min_size': 2.0},
        {'RpnRois': ['gp_rois'], 'RpnRoiProbs': ['gp_probs'],
         'RpnRoisNum': ['gp_num']})
    add('polygon_box_transform', 'polygon_box_transform',
        {'Input': f(2, 4, 3, 5)}, outputs={'Output': ['pbt_out']})
    det = np.zeros((2, 6, 6), 'float32')
    det[..., 0] = [[1, 2, 1, 3, -1, 2], [3, 3, 1, -1, -1, 2]]
    det[..., 1] = rng.rand(2, 6)
    det[..., 2:] = np.stack([_det_boxes(rng, 6, size=0.5) for _ in range(2)])
    gt = np.zeros((2, 3, 5), 'float32')
    gt[..., 0] = [[1, 2, 3], [3, 1, 0]]
    gt[..., 1:] = det[:, :3, 2:] + 0.02 * f(2, 3, 4)
    gt[1, 2, 1:] = 0
    add('detection_map', 'detection_map', {'DetectRes': det, 'Label': gt},
        {'class_num': 4, 'ap_type': '11point'}, {'MAP': ['dm_map']})
    return cases


# Faster R-CNN (Ren et al., 2015) as its Fluid config runs it: the C4 map
# of an 800 x 1333 image at stride 16, 15 anchors, the RPN's proposal and
# sampling settings, 512 RoIs a batch for the box head
FRCNN = dict(image=(800.0, 1333.0), feat=(1, 1024, 50, 84), stride=16.0,
             sizes=(32.0, 64.0, 128.0, 256.0, 512.0),
             ratios=(0.5, 1.0, 2.0), pre_nms=6000, post_nms=1000, nms=0.7,
             min_size=0.1, rois=512, align=14, pool=7, sampling=2,
             rpn_batch=256, fg_fraction=0.5, gts=8,
             sparse=(30000, 512, 768))    # check_sparse_math: mt1's table


def frcnn_anchors(H, W, sizes, ratios, stride):
    """anchor_generator's anchors [H, W, A, 4] in pixels (the port's own
    numpy grid)."""
    from paddle_tpu_torch.ops.detection_ops import _anchors_np
    return _anchors_np(H, W, list(sizes), list(ratios), [stride, stride],
                       0.5)


def check_scaled_outputs(label, got, want):
    """Each output within OP_ATOL + OP_RTOL x its largest |element|
    (a grad summed over hundreds of RoIs cancels: an element's own size
    says nothing of its sum's rounding); integer outputs equal. Returns
    the worst error over that bound."""
    if sorted(got) != sorted(want):
        raise AssertionError('%s: outputs %s, want %s'
                             % (label, sorted(got), sorted(want)))
    worst = 0.0
    for n, w in want.items():
        g = got[n]
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError('%s: %s is %s %s, want %s %s'
                                 % (label, n, g.dtype, g.shape, w.dtype,
                                    w.shape))
        if w.dtype.kind in 'biu':
            if not np.array_equal(g, w):
                raise AssertionError('%s: %s differs' % (label, n))
            continue
        bound = OP_ATOL + OP_RTOL * float(np.abs(w).max() if w.size else 0)
        err = float(np.abs(g.astype('float64') - w).max()) / bound \
            if w.size else 0.0
        worst = max(worst, err)
        if not err <= 1.0:
            raise AssertionError('%s: %s is %.3g x the tolerance off'
                                 % (label, n, err))
    return worst


def rpn_label_properties(label, anchors, gts, labels, tgt, batch, fg_frac,
                         pos, neg, valid=None):
    """rpn_target_assign's draw, held by what any draw must hold: at most
    `batch` labels, at most fg_frac of them fg; fg only where an anchor
    reaches pos IoU or is a valid gt's best anchor; bg only under neg
    IoU; where the fg budget holds every candidate, every anchor over
    pos and a best anchor of each gt fg; each anchor's target the box of
    a gt it overlaps best. IoUs in fp64; a tie within 1e-6 may go either
    way."""
    a = anchors.reshape(-1, 4).astype('float64')
    budget = int(batch * fg_frac)
    for n in range(len(gts)):
        g = gts[n].astype('float64')
        ok_gt = np.ones(len(g), bool) if valid is None else valid[n] > 0
        ix = np.clip(np.minimum(g[:, None, 2], a[None, :, 2]) -
                     np.maximum(g[:, None, 0], a[None, :, 0]), 0, None)
        iy = np.clip(np.minimum(g[:, None, 3], a[None, :, 3]) -
                     np.maximum(g[:, None, 1], a[None, :, 1]), 0, None)
        inter = ix * iy
        union = ((g[:, 2] - g[:, 0]) * (g[:, 3] - g[:, 1]))[:, None] + \
            ((a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1]))[None] - inter
        iou = np.where(ok_gt[:, None], inter / union, -1.0)    # [G, M]
        best, top = iou.max(0), iou.max(1)
        near_best = (iou >= top[:, None] - 1e-6) & \
            (ok_gt & (top > 0))[:, None]
        allowed = (best >= pos - 1e-6) | near_best.any(0)
        lab = labels[n]
        fg = lab == 1
        n_fg, n_lab = int(fg.sum()), int((lab >= 0).sum())
        match = np.all(np.abs(gts[n][:, None, :] - tgt[n][None]) <= 1e-4, -1)
        ok = (n_lab <= batch and n_fg <= budget and
              not fg[~allowed].any() and
              not (lab == 0)[~(best < neg + 1e-6)].any() and
              (match & (iou >= best[None] - 1e-6)).any(0).all())
        if ok and allowed.sum() <= budget:
            ok = fg[best >= pos + 1e-6].all() and all(
                fg[row].any() for row in near_best if row.any())
        if not ok:
            raise AssertionError('%s: image %d\'s labels break the rule (%d '
                                 'fg, %d labelled)' % (label, n, n_fg, n_lab))
    return int((labels == 1).sum()), int((labels >= 0).sum())


def _sparse_math_program(fluid, V, D):
    """Two sparse lookup grads of one table (fed ids and cotangents) and
    the ops that take a SelectedRows: scale, clip, clip_by_norm, sum,
    squared_l2_norm. Returns (program, fetch names)."""
    prog = fluid.Program()
    block = prog.global_block()
    w = block.create_var(name='sm_w', shape=(V, D), dtype='float32',
                         persistable=True)
    grads = []
    for k in range(2):
        ids = block.create_var(name='sm_ids%d' % k, shape=(-1,),
                               dtype='int64', is_data=True)
        cot = block.create_var(name='sm_cot%d' % k, shape=(-1, D),
                               dtype='float32', is_data=True)
        g = block.create_var(name='sm_g%d' % k)
        block.append_op(type='lookup_table_grad',
                        inputs={'Ids': [ids], 'W': [w], 'Out@GRAD': [cot]},
                        outputs={'W@GRAD': [g]},
                        attrs={'is_sparse': True, 'padding_idx': -1})
        grads.append(g)
    outs = []
    for op, ins, attrs in (
            ('scale', {'X': [grads[0]]}, {'scale': 0.5}),
            ('clip', {'X': [grads[0]]}, {'min': -0.1, 'max': 0.1}),
            ('clip_by_norm', {'X': [grads[0]]}, {'max_norm': 0.5}),
            ('sum', {'X': grads}, {}),
            ('squared_l2_norm', {'X': [grads[0]]}, {})):
        out = block.create_var(name='sm_' + op)
        block.append_op(type=op, inputs=ins, outputs={'Out': [out]},
                        attrs=attrs)
        outs.append(out.name)
    return prog, outs


def check_sparse_math(place, rng, V=30000, D=512, N=768):
    """The SelectedRows branches of scale, clip, clip_by_norm, sum and
    squared_l2_norm on the card against the CPU on the same grads (ids
    drawn with repeats, mt1's sizes): SelectedRows rows equal and values,
    dense outputs within OP_ATOL + OP_RTOL·|ref|. Returns the worst."""
    import paddle_tpu_torch as fluid
    feed = {}
    for k in range(2):
        feed['sm_ids%d' % k] = rng.randint(0, V // 100, N).astype('int64')
        feed['sm_cot%d' % k] = (rng.randn(N, D) * 0.01).astype('float32')
    table = np.zeros((V, D), 'float32')
    res = {}
    for p in (place, fluid.CPUPlace()):
        prog, fetch = _sparse_math_program(fluid, V, D)
        scope = fluid.Scope()
        fluid.io.load_numpy_params(scope, {'sm_w': table}, p)
        got = fluid.Executor(p).run(prog, feed=feed, fetch_list=fetch,
                                    scope=scope)
        res[p.device.type] = dict(zip(fetch, got))
    worst = 0.0
    for n, want in res['cpu'].items():
        got = res[place.device.type][n]
        kinds = (want.dtype == object, got.dtype == object)
        if kinds[0] != kinds[1] or kinds[0] != (n in (
                'sm_scale', 'sm_clip_by_norm', 'sm_sum')):
            raise AssertionError('a4 sparse %s: SelectedRows %s on the card, '
                                 '%s on the CPU' % (n, kinds[1], kinds[0]))
        if kinds[0]:
            got, want = got[()], want[()]
            if not np.array_equal(got.rows, want.rows):
                raise AssertionError('a4 sparse %s: rows differ' % n)
            got, want = got.values, want.values
        worst = max(worst, check_op_outputs('a4 sparse ' + n,
                                            {n: np.asarray(got)},
                                            {n: np.asarray(want)}))
    return worst


def check_detection_ops(place, fr=None):
    """The detection ops at Faster R-CNN's published shapes (FRCNN), on
    the card against CPU copies by check_scaled_outputs: anchor_generator
    (15 anchors on the 50 x 84 map), generate_proposals (pre 6000, post
    1000, NMS 0.7; its deltas' dw and dh 0, so the decoded boxes are the
    same bits on both: exp's last bit differs between them, and a box
    within it of the IoU threshold would flip), roi_align 14x14 (sampling
    2) and roi_pool 7x7 over 512 RoIs, forward and X's grad;
    rpn_target_assign by rpn_label_properties, twice (a replay draws
    anew); check_sparse_math. Returns the worst error and the ms of each
    op's card run."""
    import paddle_tpu_torch as fluid
    fr = fr or FRCNN
    rng = np.random.RandomState(SEED + 14)
    N, C, H, W = fr['feat']
    anchors = frcnn_anchors(H, W, fr['sizes'], fr['ratios'], fr['stride'])
    A = anchors.shape[2]
    deltas = (0.1 * rng.randn(N, A, 4, H, W)).astype('float32')
    deltas[:, :, 2:] = 0.0
    x1 = rng.uniform(0, fr['image'][1] - 64, fr['rois'])
    y1 = rng.uniform(0, fr['image'][0] - 64, fr['rois'])
    rois = np.stack([x1, y1, x1 + rng.uniform(16, 400, fr['rois']),
                     y1 + rng.uniform(16, 400, fr['rois'])], -1).astype(
        'float32')
    feat = rng.randn(*fr['feat']).astype('float32')
    cases = [
        ('frcnn anchor_generator', 'anchor_generator',
         {'Input': np.zeros((1, 1, H, W), 'float32')},
         {'anchor_sizes': list(fr['sizes']),
          'aspect_ratios': list(fr['ratios']),
          'stride': [fr['stride']] * 2},
         {'Anchors': ['anchors'], 'Variances': ['var']}, []),
        ('frcnn generate_proposals', 'generate_proposals',
         {'Scores': (1 / (1 + np.exp(-rng.randn(N, A, H, W)))).astype('f4'),
          'BboxDeltas': deltas.reshape(N, 4 * A, H, W),
          'ImInfo': np.array([[fr['image'][0], fr['image'][1], 1.0]], 'f4'),
          'Anchors': anchors,
          'Variances': np.tile(np.array([0.1, 0.1, 0.2, 0.2], 'f4'),
                               (H, W, A, 1))},
         {'pre_nms_topN': fr['pre_nms'], 'post_nms_topN': fr['post_nms'],
          'nms_thresh': fr['nms'], 'min_size': fr['min_size']},
         {'RpnRois': ['rois'], 'RpnRoiProbs': ['probs'],
          'RpnRoisNum': ['num']}, []),
        ('frcnn roi_align', 'roi_align', {'X': feat, 'ROIs': rois},
         {'pooled_height': fr['align'], 'pooled_width': fr['align'],
          'spatial_scale': 1.0 / fr['stride'],
          'sampling_ratio': fr['sampling']}, None, ['in_x']),
        ('frcnn roi_pool', 'roi_pool', {'X': feat, 'ROIs': rois},
         {'pooled_height': fr['pool'], 'pooled_width': fr['pool'],
          'spatial_scale': 1.0 / fr['stride']}, None, ['in_x']),
    ]
    out_shape = {'roi_align': [(fr['rois'], C, fr['align'], fr['align'])],
                 'roi_pool': [(fr['rois'], C, fr['pool'], fr['pool'])]}
    worst, ms = {}, {}
    for case in cases:
        shapes = out_shape.get(case[1])
        t0 = time.perf_counter()
        got = run_op_case(fluid, place, case, shapes)
        ms[case[0]] = (time.perf_counter() - t0) * 1e3
        want = run_op_case(fluid, fluid.CPUPlace(), case, shapes)
        worst[case[0]] = check_scaled_outputs(case[0], got, want)
        if case[1] == 'generate_proposals' and not 0 < got['num'][0] <= \
                fr['post_nms']:
            raise AssertionError('a4 frcnn: %d proposals' % got['num'][0])
    gts = np.stack([_det_boxes(rng, fr['gts'], scale=700.0, size=0.4)])
    prog = fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(prog,
                                                        fluid.Program()):
        g = fluid.layers.data(name='g', shape=[fr['gts'], 4],
                              dtype='float32')
        labels, tgt = fluid.layers.rpn_target_assign(
            fluid.layers.assign(anchors), g,
            rpn_batch_size_per_im=fr['rpn_batch'],
            rpn_fg_fraction=fr['fg_fraction'])
    exe = fluid.Executor(place)
    draws = []
    for _ in range(3):
        lab, tg = (np.asarray(v) for v in exe.run(
            prog, feed={'g': gts}, fetch_list=[labels, tgt],
            scope=fluid.Scope()))
        draws.append(rpn_label_properties(
            'a4 frcnn rpn_target_assign', anchors, gts, lab, tg,
            fr['rpn_batch'], fr['fg_fraction'], 0.7, 0.3))
    exe.close()
    worst['sparse math'] = check_sparse_math(place, rng, *fr['sparse'])
    log('a4 detection ops at Faster R-CNN\'s shapes (C4 map %s, %d '
        'anchors, %d RoIs) on the card vs CPU copies, worst error over '
        'OP_ATOL + OP_RTOL x max|ref|: %s; card ms (one eager run with the '
        'grads, feeds and fetches included): %s; rpn_target_assign (fg, labelled) of three draws %s; '
        'SelectedRows math within %.3f of its tolerance'
        % (list(fr['feat']), H * W * A, fr['rois'],
           ', '.join('%s %.3f' % kv for kv in worst.items()),
           ', '.join('%s %.1f' % kv for kv in ms.items()), draws,
           worst['sparse math']))
    return max(worst.values())


# a4 at published shapes (ROADMAP item 6's op types, which no model of
# the repo runs): C3D (Tran et al., 2015) clips of 16 x 112 x 112 at batch
# 8, conv1a-conv3b 3x3x3 and pool1 (1x2x2), pool2-pool3 (2x2x2); SegNet
# (Badrinarayanan et al., 2017) the first encoder pool and its decoder
# unpool at 360 x 480, 64 channels, batch 4; SPP-net (He et al., 2014) a
# 3-level pyramid over conv5's 13 x 13 x 256 at batch 32; fake_quantize
# on ResNet-50's res2 output [32, 256, 56, 56]; auc at batch 4096 with
# 200 thresholds over three batches
C3D = dict(batch=8, frames=16, hw=112, cmp_batch=1,
           convs=(('conv1a', 3, 64, 16, 112), ('conv2a', 64, 128, 16, 56),
                  ('conv3a', 128, 256, 8, 28), ('conv3b', 256, 256, 8, 28)),
           pools=(('pool1', 64, 16, 112, [1, 2, 2]),
                  ('pool2', 128, 16, 56, [2, 2, 2]),
                  ('pool3', 256, 8, 28, [2, 2, 2])))
SEGNET = dict(batch=4, channels=64, hw=(360, 480))
SPPNET = dict(batch=32, channels=256, hw=13, levels=3)
QUANT = dict(shape=(32, 256, 56, 56), bits=8)
AUC = dict(batch=4096, thresholds=200, batches=3)


def _timed_case(fluid, place, case, sync, host=True):
    """run_op_case on `place`, with its wall ms (one eager run: feeds,
    grads and fetches included)."""
    t0 = time.perf_counter()
    got = run_op_case(fluid, place, case, host=host)
    sync()
    return got, (time.perf_counter() - t0) * 1e3


def item6_published_cases(rng, c3d=None, seg=None, spp=None, quant=None):
    """[(case at the compared batch, the same case at the published batch
    or None)] of check_item6_ops."""
    c3d, seg = c3d or C3D, seg or SEGNET
    spp, quant = spp or SPPNET, quant or QUANT

    def f(*shape, scale=1.0):
        return (scale * rng.randn(*shape)).astype('float32')
    out = []

    def both(name, op, make, attrs, outputs, check):
        small, full = make(c3d['cmp_batch']), make(c3d['batch'])
        out.append(((name, op, small, attrs, outputs, list(check)),
                    (name, op, full, attrs, outputs, list(check))))
    for name, cin, cout, t, hw in c3d['convs']:
        w = f(cout, cin, 3, 3, 3, scale=(cin * 27) ** -0.5)
        both('C3D %s' % name, 'conv3d',
             lambda b, cin=cin, t=t, hw=hw, w=w: {
                 'Input': f(b, cin, t, hw, hw), 'Filter': w},
             {'paddings': [1, 1, 1]}, {'Output': ['out']},
             ('in_input', 'in_filter'))
    for name, ch, t, hw, k in c3d['pools']:
        for op, attrs, outputs in (
                ('pool3d', {'pooling_type': 'max', 'ksize': k,
                            'strides': k}, None),
                ('pool3d', {'pooling_type': 'avg', 'ksize': k,
                            'strides': k}, None),
                ('max_pool3d_with_index', {'ksize': k, 'strides': k},
                 {'Out': ['out'], 'Mask': ['mask']})):
            label = 'C3D %s %s' % (name, op if op != 'pool3d'
                                   else attrs['pooling_type'])
            both(label, op, lambda b, ch=ch, t=t, hw=hw: {
                'X': f(b, ch, t, hw, hw)}, attrs, outputs, ('in_x',))
    n, ch, (h, w) = seg['batch'], seg['channels'], seg['hw']
    x = f(n, ch, h, w)
    pool = ('SegNet pool1 with index', 'max_pool2d_with_index', {'X': x},
            {'ksize': [2, 2], 'strides': [2, 2]},
            {'Out': ['out'], 'Mask': ['mask']}, ['in_x'])
    out.append((pool, None))
    n, ch, hw = spp['batch'], spp['channels'], spp['hw']
    out.append((('SPP-net spp over conv5', 'spp', {'X': f(n, ch, hw, hw)},
                 {'pyramid_height': spp['levels'], 'pooling_type': 'max'},
                 None, ['in_x']), None))
    y = f(*quant['shape'])
    for mode, prev in (('abs_max', None), ('range_abs_max', 5.0),
                       ('moving_average_abs_max', 5.0)):
        inputs = {'X': y}
        if prev is not None:
            inputs['InMovingScale'] = np.array([prev], 'float32')
        out.append((('ResNet-50 res2 fake_quantize %s' % mode,
                     'fake_quantize', inputs,
                     {'quantize_type': mode, 'bit_length': quant['bits']},
                     {'Out': ['out'], 'OutMovingScale': ['scale']},
                     ['in_x']), None))
    return out


def check_unpool_at(place, fluid, x, seg_label):
    """SegNet's decoder unpool of pool1's values at pool1's Mask (from the
    card's pool; the same Mask on both), forward and grad, card vs CPU."""
    pooled, mask = (np.asarray(v) for v in fluid.Executor(place).run(
        *_pool_program(fluid, x), scope=fluid.Scope()))
    case = (seg_label, 'unpool', {'X': pooled, 'Indices': mask},
            {'unpooled_height': x.shape[2], 'unpooled_width': x.shape[3]},
            None, ['in_x'])
    got = run_op_case(fluid, place, case)
    want = run_op_case(fluid, fluid.CPUPlace(), case)
    return check_scaled_outputs(seg_label, got, want)


def _pool_program(fluid, x):
    prog = fluid.Program()
    block = prog.global_block()
    xv = block.create_var(name='x', shape=x.shape, dtype='float32',
                          is_data=True)
    out, mask = block.create_var(name='out'), block.create_var(name='mask')
    block.append_op(type='max_pool2d_with_index', inputs={'X': [xv]},
                    outputs={'Out': [out], 'Mask': [mask]},
                    attrs={'ksize': [2, 2], 'strides': [2, 2]})
    return prog, {'x': x}, ['out', 'mask']


def check_auc_state(place, w=None):
    """The auc layer at w's batch and thresholds: w['batches'] runs of one
    program on `place` (on the card the third is a replay) and on the
    CPU port: after each run the AUC and the TP/FP/TN/FN state equal
    within OP_ATOL + OP_RTOL x max |ref| (counts exact). Returns the
    worst error."""
    import paddle_tpu_torch as fluid
    w = w or AUC
    rng = np.random.RandomState(SEED + 15)
    feeds = []
    for _ in range(w['batches']):
        y = rng.randint(0, 2, (w['batch'], 1)).astype('int64')
        s = np.clip(0.35 * y[:, 0] + 0.65 * rng.rand(w['batch']), 0, 1)
        feeds.append({'p': np.stack([1 - s, s], 1).astype('float32'),
                      'y': y})
    runs = {}
    for p in (place, fluid.CPUPlace()):
        prog, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(prog, startup):
            pv = fluid.layers.data(name='p', shape=[2], dtype='float32')
            yv = fluid.layers.data(name='y', shape=[1], dtype='int64')
            a = fluid.layers.auc(pv, yv, num_thresholds=w['thresholds'])
        fetch = [a] + ['auc_0.%s' % t for t in ('tp', 'fp', 'tn', 'fn')]
        exe, scope = fluid.Executor(p), fluid.Scope()
        exe.run(startup, scope=scope)
        runs[p.device.type] = [
            {f.name if hasattr(f, 'name') else f: np.asarray(v)
             for f, v in zip(fetch, exe.run(prog, feed=fd, fetch_list=fetch,
                                            scope=scope))}
            for fd in feeds]
    worst = 0.0
    for i, (got, want) in enumerate(zip(runs[place.device.type],
                                        runs['cpu'])):
        worst = max(worst, check_scaled_outputs('a4 auc run %d' % i, got,
                                                want))
    tp = runs[place.device.type][-1]['auc_0.tp']
    n_pos = sum(int(fd['y'].sum()) for fd in feeds)
    if tp[0] != n_pos:
        raise AssertionError('a4 auc: the state holds %d positives after '
                             '%d batches, want %d' % (tp[0], w['batches'],
                                                      n_pos))
    return worst


def check_random_crop(place, shape=(64, 3, 40, 40), crop=(32, 32), runs=3):
    """random_crop on the card (runs after the first are replays): each
    example's crop is a window of its input at an offset in range,
    offsets vary across examples, and each run draws anew."""
    import paddle_tpu_torch as fluid
    x = np.arange(int(np.prod(shape)), dtype='float32').reshape(shape)
    prog = fluid.Program()
    with fluid.program_guard(prog, fluid.Program()):
        xv = fluid.layers.data(name='x', shape=list(shape), dtype='float32',
                               append_batch_size=False)
        out = fluid.layers.random_crop(xv, list(crop))
    exe, scope = fluid.Executor(place), fluid.Scope()
    outs = [np.asarray(exe.run(prog, feed={'x': x}, fetch_list=[out],
                               scope=scope)[0]) for _ in range(runs)]
    H, W = shape[-2:]
    offsets = set()
    for got in outs:
        first = got[..., 0, 0] - x[..., 0, 0]
        oy, ox = (first // W).astype(int), (first % W).astype(int)
        if not ((0 <= oy) & (oy <= H - crop[0]) & (0 <= ox) &
                (ox <= W - crop[1])).all():
            raise AssertionError('a4 random_crop: an offset out of range')
        for idx in np.ndindex(*shape[:-2]):
            want = x[idx][oy[idx]:oy[idx] + crop[0], ox[idx]:ox[idx] + crop[1]]
            if not np.array_equal(got[idx], want):
                raise AssertionError('a4 random_crop: crop %s is not a '
                                     'window of its input' % (idx,))
        offsets |= set(zip(oy.ravel().tolist(), ox.ravel().tolist()))
    if len(offsets) < 10 or np.array_equal(outs[0], outs[1]) or \
            np.array_equal(outs[1], outs[2]):
        raise AssertionError('a4 random_crop: the draws do not vary')
    return len(offsets)


def check_item6_ops(place, sync, c3d=None, seg=None, spp=None, quant=None,
                    auc=None):
    """ROADMAP item 6's op types at published shapes (C3D, SEGNET, SPPNET,
    QUANT, AUC), on the card against CPU copies by check_scaled_outputs,
    forward and grads: C3D's convs and pools compared at one clip, and
    timed on the card at the published batch; the rest compared at the
    published shape. Then random_crop's draw (check_random_crop). Returns
    the worst error and {case: card ms}."""
    import paddle_tpu_torch as fluid
    seg = seg or SEGNET
    rng = np.random.RandomState(SEED + 16)
    worst, ms = {}, {}
    for small, full in item6_published_cases(rng, c3d, seg, spp, quant):
        got, ms[small[0]] = _timed_case(fluid, place, small, sync)
        want = run_op_case(fluid, fluid.CPUPlace(), small)
        worst[small[0]] = check_scaled_outputs(small[0], got, want)
        if full is not None:
            label = '%s at batch %d' % (full[0], len(full[2].get(
                'Input', full[2].get('X'))))
            # left on the card: only their finiteness is read back
            got, ms[label] = _timed_case(fluid, place, full, sync,
                                         host=False)
            bad = [n for n, v in got.items() if v.is_floating_point() and
                   not bool(v.isfinite().all())]
            if bad:
                raise AssertionError('%s at the published batch: %s not '
                                     'finite' % (full[0], bad))
    n, ch, (h, w) = seg['batch'], seg['channels'], seg['hw']
    x = np.random.RandomState(SEED + 17).randn(n, ch, h, w).astype('float32')
    worst['SegNet unpool'] = check_unpool_at(place, fluid, x,
                                             'SegNet unpool')
    worst['auc'] = check_auc_state(place, auc)
    offsets = check_random_crop(place)
    log('a4 item 6 at published shapes, worst error over OP_ATOL + OP_RTOL '
        'x max|ref|: %s; card ms (one eager run, grads, feeds and fetches '
        'included): %s; random_crop %d distinct offsets'
        % (', '.join('%s %.3f' % kv for kv in worst.items()),
           ', '.join('%s %.1f' % kv for kv in ms.items()), offsets))
    return max(worst.values()), ms


@phase('a4: the training core\'s op types on the card vs on CPU copies, '
       'forward and grads')
def check_training_ops(place):
    import paddle_tpu_torch as fluid
    cases = training_op_cases(np.random.RandomState(SEED + 10))
    missing = uncovered_op_types(cases)
    if missing:
        raise AssertionError('op types of the training core with no case '
                             'and no other check: %s' % missing)
    worst = {}
    for case in cases:
        got = run_op_case(fluid, place, case)
        want = run_op_case(fluid, fluid.CPUPlace(), case)
        worst[case[0]] = check_op_outputs(case[0], got, want)
    shares = check_dropout(place)
    mean_std = check_truncated_normal(place)
    check_batch_size_like(place)
    amp_err = check_lstmp_amp(place)
    check_sampled_ops(place)
    worst['detection ops at Faster R-CNN\'s shapes'] = \
        check_detection_ops(place)
    worst['item 6 at published shapes'] = check_item6_ops(
        place, torch_sync(place))[0]
    top = sorted(worst.items(), key=lambda kv: -kv[1])[:5]
    log('%d op cases on the card vs CPU copies (%d op types), worst error '
        'over the tolerance (rtol %g, atol %g): %s; dropout kept shares %s '
        '(1 - p = %.2f); truncated normal mean %.4f, std %.4f; lstmp under '
        'AMP within %.3e of the CPU (tol %g)'
        % (len(cases), len({c[1] for c in cases}), OP_RTOL, OP_ATOL,
           ', '.join('%s %.3f' % kv for kv in top), json.dumps(shares),
           1.0 - DROPOUT_P, mean_std[0], mean_std[1], amp_err, AMP_TOL))
    return max(worst.values())


# -- (b6), (r1)-(r4): ResNet-50 through the fused conv + BN op ----------------

def resnet50_train_flops_per_image(image_hw, class_dim):
    """bench.py's _resnet50_train_flops_per_image (:62-90): 2 FLOP per
    MAC over the convs and fc, x3 for forward + backward."""
    flops = 0

    def conv(hw_in, cin, cout, k, stride):
        hw_out = hw_in // stride
        return hw_out, 2 * (hw_out ** 2) * cout * cin * k * k

    hw, f = conv(image_hw, 3, 64, 7, 2)
    flops += f
    hw //= 2
    cin = 64
    for ch, count, stride in [(64, 3, 1), (128, 4, 2), (256, 6, 2),
                              (512, 3, 2)]:
        for i in range(count):
            s = stride if i == 0 else 1
            hw2, f1 = conv(hw, cin, ch, 1, s)
            _, f2 = conv(hw2, ch, ch, 3, 1)
            _, f3 = conv(hw2, ch, ch * 4, 1, 1)
            flops += f1 + f2 + f3
            if i == 0:
                _, fp = conv(hw, cin, ch * 4, 1, s)
                flops += fp
            hw = hw2
            cin = ch * 4
    flops += 2 * cin * class_dim
    return 3 * flops


def resnet_program(nhwc=False, space_to_depth=False,
                   reader_name='resnet_reader'):
    """bench.py's bench_resnet program (:136-158), built under the flags
    set now: py_reader, train_network(depth=50, nhwc=, space_to_depth=),
    Momentum(0.01, 0.9) under contrib.mixed_precision.decorate. Returns
    (main, startup, reader, image, avg_cost)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import resnet
    hw = RESNET['image_hw']
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        reader = fluid.layers.py_reader(
            capacity=4, shapes=[(-1, 3, hw, hw), (-1, 1)],
            dtypes=['float32', 'int64'], name=reader_name,
            use_double_buffer=True)
        image, label = fluid.layers.read_file(reader)
        _, avg_cost, _ = resnet.train_network(
            image, label, class_dim=RESNET['class_dim'],
            depth=RESNET['depth'], nhwc=nhwc, space_to_depth=space_to_depth)
        opt = fluid.optimizer.Momentum(learning_rate=0.01, momentum=0.9)
        opt = fluid.contrib.mixed_precision.decorate(opt)
        opt.minimize(avg_cost)
    return main, startup, reader, image, avg_cost


class ResNetTrainer(LMRun):
    """resnet_program's step with its state on the card: NCHW with
    FLAGS_use_pallas_fused_ops set (r1), NHWC as bench.py builds it for
    an accelerator (n1), or NCHW with the space-to-depth stem (s1)."""

    def __init__(self, place, batch, nhwc=False, space_to_depth=False,
                 reader_name='resnet_reader'):
        import paddle_tpu_torch as fluid
        self.fluid, self.batch = fluid, batch
        (self.main, startup, self.reader, self.image,
         self.avg_cost) = resnet_program(nhwc, space_to_depth, reader_name)
        self.scope = fluid.Scope()
        fluid.Executor(place).run(startup, scope=self.scope)
        self.use_cuda = place.device.type == 'cuda'
        self.pe = fluid.ParallelExecutor(
            use_cuda=self.use_cuda, loss_name=self.avg_cost.name,
            main_program=self.main, scope=self.scope)
        self.persistables = [v.name for v in self.main.list_vars()
                             if v.persistable and
                             self.scope.find_var(v.name) is not None]

    def batch_of(self, rng):
        return image_batch(rng, self.batch)


def image_batch(rng, batch, device=None):
    """bench.py's batch (:160-164): uniform images and random labels from
    a seeded numpy stream, on `device` when given (bench.py puts them on
    the chip once and feeds the same batch every step)."""
    import torch
    hw, classes = RESNET['image_hw'], RESNET['class_dim']
    img = rng.rand(batch, 3, hw, hw).astype('float32')
    lbl = rng.randint(0, classes, size=(batch, 1)).astype('int64')
    if device is None:
        return [img, lbl]
    return [torch.from_numpy(img).to(device), torch.from_numpy(lbl).to(device)]


def k6_path_shapes(program, batch):
    """{(M, K, N): launches per step} of the 1x1 conv2d_bn ops of the
    program (the ones that run K6), with M = batch x Ho x Wo."""
    shapes = {}
    block = program.global_block()
    for op in block.ops:
        if op.type != 'conv2d_bn':
            continue
        w = block.var_recursive(op.single_input('Filter'))
        if tuple(w.shape[2:]) != (1, 1) or \
                list(op.attr('paddings', [0, 0])) != [0, 0]:
            continue
        y = block.var_recursive(op.single_output('Y'))
        key = (batch * y.shape[2] * y.shape[3], w.shape[1], w.shape[0])
        shapes[key] = shapes.get(key, 0) + 1
    return shapes


def k6_bound_ms(M, K, N, dtype):
    """Least time for one call, (bytes time, operations time) in ms: x, w
    read once, y and the two fp32 sums written once, against 2·M·K·N
    FLOP at the peak of the call's type. The bound is the larger."""
    es = 4 if dtype == 'float32' else 2
    nbytes = es * (M * K + K * N + M * N) + 2 * 4 * N
    peak = PEAK_FP32_FLOPS if dtype == 'float32' else PEAK_BF16_FLOPS
    return nbytes / PEAK_BYTES_PER_S * 1e3, 2.0 * M * K * N / peak * 1e3


def _k6_inputs(gen, M, K, N, dtype, dev):
    import torch
    x = torch.randn((M, K), generator=gen, device=dev)
    w = torch.randn((K, N), generator=gen, device=dev) * (2.0 / K) ** 0.5
    dt = getattr(torch, dtype)
    return x.to(dt), w.to(dt)


def _k6_check(k6, gen, dev, M, K, N, dtype, want):
    """Launch K6 twice on the same inputs and hold it against its plain
    version: y within KERNEL_ATOL of max(1, |y|), the sums within
    K6_SUM_RTOL, the second launch the same bits, and both launches by
    the kernel `want` (from the per-kernel counts). Returns the max abs
    error of y."""
    import torch
    x, w = _k6_inputs(gen, M, K, N, dtype, dev)
    counts = k6.matmul_bn_stats_kernel.launches_by_kernel
    before = dict(counts)
    y, s, q = k6.matmul_bn_stats_kernel(x, w)
    y2, s2, q2 = k6.matmul_bn_stats_kernel(x, w)
    torch.cuda.synchronize()
    ran = {k: n - before.get(k, 0) for k, n in counts.items()
           if n != before.get(k, 0)}
    same = all(torch.equal(a, b) for a, b in ((y, y2), (s, s2), (q, q2)))
    yr, sr, qr = k6.matmul_bn_stats_reference(x, w)
    abs_sum = torch.matmul(x.float(), w.float()).abs().sum(0)
    tol = KERNEL_ATOL[dtype]
    dy = (y.float() - yr.float()).abs()
    ok_y = bool((dy <= tol * yr.float().abs().clamp_min(1.0)).all())
    err_s = ((s - sr).abs() / abs_sum.clamp_min(1e-30)).max().item()
    err_q = ((q - qr).abs() / qr.clamp_min(1e-30)).max().item()
    finite = all(bool(torch.isfinite(t).all()) for t in (y, s, q))
    ok = ok_y and err_s <= K6_SUM_RTOL and err_q <= K6_SUM_RTOL and finite
    err = dy.max().item()
    log('K6 [%d, %d, %d] %s on %s: y max_abs_err %.3e (tol %g x max(1, '
        '|y|)), colsum err %.3e of sum|y|, colsumsq err %.3e of sum y^2 (tol '
        '%g), second launch bit-identical %s %s'
        % (M, K, N, dtype, ', '.join('%s x %d' % kv for kv in ran.items())
           or 'no kernel', err, tol, err_s, err_q, K6_SUM_RTOL,
           'yes' if same else 'NO', 'ok' if ok and same else 'MISMATCH'))
    if ran != {want: 2}:
        raise AssertionError('K6 at [%d, %d, %d] %s ran %s, want %s twice'
                             % (M, K, N, dtype, ran, want))
    if not same:
        raise AssertionError('K6 at [%d, %d, %d] %s: a second launch on the '
                             'same inputs gave other bits' % (M, K, N, dtype))
    if not ok:
        raise AssertionError('K6 disagrees with its plain version at '
                             '[%d, %d, %d] %s (finite: %s)'
                             % (M, K, N, dtype, finite))
    return err


def k6_check_shapes(k6, path_shapes, sms):
    """[(shape, dtype, kernel that must run, on the path)] of phase b6:
    the largest, smallest and widest path shapes, a path shape for every
    tile width the plan uses and one with K = 64 (a single k slice) in
    bf16, all on the tensor-core kernel; the smallest path shape with
    one row more (M not a multiple of the tile), the routing's pick; the
    three picks in fp32 and the ragged 300 x 70 x 130 in both dtypes, on
    the generic kernel."""
    nbytes = lambda s: s[0] * s[1] + s[1] * s[2] + s[0] * s[2]  # noqa: E731
    shapes = sorted(path_shapes)
    picks = [max(shapes, key=nbytes), min(shapes, key=nbytes),
             max(shapes, key=lambda s: (s[2], s[1]))]
    by_bn = {}
    for s in shapes:
        by_bn.setdefault(k6._plan(*s, sms).bn, s)
    k64 = [s for s in shapes if s[1] == 64][:1]
    path = []
    for s in picks + [by_bn[bn] for bn in sorted(by_bn)] + k64:
        if s not in path:
            path.append(s)
    M, K, N = picks[1]
    out = [(s, 'bfloat16', k6.WGMMA_KERNEL, True) for s in path]
    out.append(((M + 1, K, N), 'bfloat16',
                k6._route(M + 1, K, N, _torch_dtype('bfloat16')), False))
    out += [(s, 'float32', k6.GENERIC_KERNEL, False) for s in picks]
    out += [((300, 70, 130), dt, k6.GENERIC_KERNEL, False)
            for dt in ('float32', 'bfloat16')]
    return out


def _torch_dtype(name):
    import torch
    return getattr(torch, name)


def check_k6_outputs(k6, gen, dev, path_shapes, sms):
    """Every shape of k6_check_shapes through _k6_check; returns the max
    abs error of y over the bf16 path shapes."""
    path_err = 0.0
    for shape, dtype, want, on_path in k6_check_shapes(k6, path_shapes, sms):
        err = _k6_check(k6, gen, dev, *shape, dtype, want)
        if on_path:
            path_err = max(path_err, err)
    return path_err


@phase('b6: K6 (matmul + BN statistics) vs its plain version')
def check_k6(path_shapes):
    """Correctness and bit-identical second launches at the shapes of
    k6_check_shapes; then times of kernel, plain version, yardstick and
    the product alone at every path shape in bf16, summed over one
    step's launches. Returns the kernels line's row."""
    import torch
    from paddle_tpu_torch.kernels import conv_bn as k6
    dev = torch.device('cuda', 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 3)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    path_err = check_k6_outputs(k6, gen, dev, path_shapes, sms)
    torch.cuda.empty_cache()

    totals = {'ms': 0.0, 'plain_ms': 0.0, 'library_ms': 0.0,
              'matmul_ms': 0.0, 'device_ms': 0.0, 'matmul_device_ms': 0.0,
              'bound_ms': 0.0, 'bytes_ms': 0.0, 'ops_ms': 0.0}
    for (M, K, N), count in sorted(path_shapes.items()):
        x, w = _k6_inputs(gen, M, K, N, 'bfloat16', dev)

        def library():
            yf = torch.matmul(x, w).float()
            return yf.sum(0), (yf * yf).sum(0)

        times = bracketed_ms({
            'ms': lambda: k6.matmul_bn_stats_kernel(x, w),
            'plain_ms': lambda: k6.matmul_bn_stats_reference(x, w),
            'library_ms': library,
            'matmul_ms': lambda: torch.matmul(x, w)})
        # device time alone (the events above also hold any time the
        # card waits for the host between calls); None where the profiler
        # saw none, and then the step's total is not measured either
        for key, fn in (('device_ms', lambda: k6.matmul_bn_stats_kernel(x, w)),
                        ('matmul_device_ms', lambda: torch.matmul(x, w))):
            times[key] = _device_ms(fn)
        t_bytes, t_ops = k6_bound_ms(M, K, N, 'bfloat16')
        plan = k6._plan(M, K, N, sms)
        kernel_ms = times['device_ms']
        log('K6 [%d, %d, %d] bf16 x %d per step: kernel %.4f ms, plain '
            '%.4f ms, library %.4f ms, product alone %.4f ms, bound %.4f ms '
            '(%s); device: kernel %s ms (%s TB/s, %s TFLOP/s), '
            'product alone %s ms; plan BN %d, %d tiles on %d CTAs, %d '
            'stages, w %s'
            % (M, K, N, count, times['ms'], times['plain_ms'],
               times['library_ms'], times['matmul_ms'], max(t_bytes, t_ops),
               'bytes' if t_bytes >= t_ops else 'operations',
               _fmt_ms(kernel_ms),
               'n/a' if kernel_ms is None else
               '%.2f' % (t_bytes * PEAK_BYTES_PER_S / 1e12 / kernel_ms),
               'n/a' if kernel_ms is None else
               '%.1f' % (2.0 * M * K * N / kernel_ms / 1e9),
               _fmt_ms(times['matmul_device_ms']), plan.bn, plan.tiles,
               plan.grid, plan.stages,
               'resident' if plan.resident else 'streamed'))
        for key in ('ms', 'plain_ms', 'library_ms', 'matmul_ms', 'device_ms',
                    'matmul_device_ms'):
            totals[key] = (None if totals[key] is None or times[key] is None
                           else totals[key] + count * times[key])
        totals['bound_ms'] += count * max(t_bytes, t_ops)
        totals['bytes_ms'] += count * t_bytes
        totals['ops_ms'] += count * t_ops
        del x, w
    torch.cuda.empty_cache()
    n_launch = sum(path_shapes.values())
    log('K6 per step (%d launches over %d shapes, bf16): kernel %.4f ms, '
        'plain %.4f ms, library %.4f ms, product alone %.4f ms, bound %.4f '
        'ms (the sum of each launch\'s bound; bytes alone %.4f ms, '
        'operations alone %.4f ms); device: kernel %s ms, product alone '
        '%s ms'
        % (n_launch, len(path_shapes), totals['ms'], totals['plain_ms'],
           totals['library_ms'], totals['matmul_ms'], totals['bound_ms'],
           totals['bytes_ms'], totals['ops_ms'], _fmt_ms(totals['device_ms']),
           _fmt_ms(totals['matmul_device_ms'])))
    name, replaces, source = K6_SOURCE
    return {'name': name, 'route': 'cuda', 'source': source,
            'replaces': replaces, 'launches': None, 'max_abs_err': path_err,
            'ms': totals['ms'], 'plain_ms': totals['plain_ms'],
            'bound_ms': totals['bound_ms'],
            'bound_by': ('bytes' if totals['bytes_ms'] >= totals['ops_ms']
                         else 'operations'),
            'library_ms': totals['library_ms'],
            'matmul_ms': totals['matmul_ms'],
            'device_ms': totals['device_ms'],
            'matmul_device_ms': totals['matmul_device_ms'],
            'kernel': k6.WGMMA_KERNEL,
            'shape': 'one step: %d launches over the %d 1x1 shapes at batch '
                     '%d' % (n_launch, len(path_shapes), RESNET_BATCH),
            'dtype': 'bfloat16'}


@phase('r1: train ResNet-50 through the fused conv + BN op (AMP Momentum, '
       'py_reader, ParallelExecutor)')
def resnet_steps(place, sync):
    import torch
    from paddle_tpu_torch.kernels import conv_bn as k6
    t0 = time.perf_counter()
    tr = ResNetTrainer(place, RESNET_BATCH)
    ops = tr.main.global_block().ops
    n_params = sum(int(np.prod(v.shape)) for v in tr.main.list_vars()
                   if v.persistable and getattr(v, 'trainable', False))
    path_shapes = k6_path_shapes(tr.main, RESNET_BATCH)
    per_step = sum(path_shapes.values())
    log('ResNet-50 program: %d ops of %d types (%d conv2d_bn, %d of them '
        '1x1 on K6), %d parameters, batch %d x 3 x %d x %d, %d classes, no '
        'depth cut; built and initialised in %.1f s'
        % (len(ops), len(set(o.type for o in ops)),
           sum(o.type == 'conv2d_bn' for o in ops), per_step, n_params,
           RESNET_BATCH, RESNET['image_hw'], RESNET['image_hw'],
           RESNET['class_dim'], time.perf_counter() - t0))
    stats = [n for n in tr.persistables if n.endswith(('.mean', '.variance'))]
    stats0 = {n: tr.scope.find_var(n).clone() for n in stats}
    batch = image_batch(np.random.RandomState(0), RESNET_BATCH,
                        torch.device('cuda', 0))

    def provider():
        while True:
            yield batch
    tr.feed(provider)
    # the peak covers the eager warm-up, the capture and the replays
    torch.cuda.reset_peak_memory_stats()
    losses = [tr.step(sync_checked=True)]
    losses += [tr.step() for _ in range(WARMUP_STEPS - 1)]
    sync()
    k6.reset_launches()
    t0 = time.perf_counter()
    losses += [tr.step() for _ in range(TIMED_STEPS)]
    sync()
    wall = time.perf_counter() - t0
    launches = k6.matmul_bn_stats_kernel.launches
    by_kernel = dict(k6.matmul_bn_stats_kernel.launches_by_kernel)
    peak_gb = peak_memory_gb()
    reserved_gb = torch.cuda.max_memory_reserved() / 1e9
    step_ms = wall / TIMED_STEPS * 1e3
    moved = sum(not torch.equal(tr.scope.find_var(n), stats0[n])
                for n in stats)
    log('losses: %s' % ', '.join('%.6f' % x for x in losses))
    log('timed steps: %d in %.3f s, %.3f ms per step, %.1f images/s; K6 '
        'launches %d (want %d x %d; by kernel: %s); peak device memory %.2f '
        'GB; BN running statistics moved: %d of %d'
        % (TIMED_STEPS, wall, step_ms, RESNET_BATCH / step_ms * 1e3,
           launches, per_step, TIMED_STEPS,
           ', '.join('%s %d' % kv for kv in by_kernel.items()), peak_gb,
           moved, len(stats)))
    if not all(np.isfinite(losses)):
        raise AssertionError('a ResNet loss is not finite: %r' % losses)
    if per_step != 36 or launches != per_step * TIMED_STEPS:
        raise AssertionError('K6 launched %d times in %d steps, want 36 x %d'
                             ' (the program has %d 1x1 conv2d_bn ops)'
                             % (launches, TIMED_STEPS, TIMED_STEPS, per_step))
    if by_kernel.get(k6.WGMMA_KERNEL) != launches:
        raise AssertionError('K6 launched %s in the timed steps: every '
                             'launch must be %s' % (by_kernel,
                                                    k6.WGMMA_KERNEL))
    if moved != len(stats) or not stats:
        raise AssertionError('BN running statistics moved for %d of %d vars'
                             % (moved, len(stats)))
    if reserved_gb > RESNET_PEAK_GB:
        raise AssertionError('peak reserved device memory %.2f GB over the '
                             '%g GB the batch of %d is held to'
                             % (reserved_gb, RESNET_PEAK_GB, RESNET_BATCH))
    check_replay_launches('r1', tr.step, sync)
    return tr, path_shapes, losses, step_ms, launches, peak_gb


def _reordered_reference(x, w):
    """The plain version with its column sums taken in fp64: the same
    math in another order of summation, timed and used only as the
    yardstick of r2."""
    import torch
    y = torch.matmul(x.float(), w.float())
    yd = y.double()
    return y.to(x.dtype), yd.sum(0).float(), (yd * yd).sum(0).float()


@phase('r2: K6 step vs plain-version step from one saved state')
def check_resnet_plain_step(tr):
    """One step with K6, every launch also held against the plain version
    on its own inputs; the same step with FLAGS_use_pallas_fused_ops
    cleared (the plain version); and the same step with the plain
    version's column sums in fp64. The bf16 AMP step amplifies any change
    in the order of the fp32 sums (it rounds every activation to bf16
    after each op), so the updates of the kernel step are held to the
    plain step within TRAIN_UPDATE_TOL or within RESNET_SPREAD_FACTOR
    times the plain step's own spread under the fp64 sums, whichever is
    larger."""
    import torch
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.kernels import conv_bn as k6
    batch = image_batch(np.random.RandomState(SEED + 2), RESNET_BATCH)
    saved = tr.snapshot()
    # the captured step's pool and an eager step do not fit together
    tr.drop_graphs()
    kernel_fn, plain_fn = k6.matmul_bn_stats_kernel, \
        k6.matmul_bn_stats_reference
    worst = {'y': 0.0, 'colsum': 0.0, 'colsumsq': 0.0, 'flips': 0.0}

    def checked_kernel(x, w):
        y, s, q = kernel_fn(x, w)
        yr, sr, qr = plain_fn(x, w)
        abs_sum = torch.matmul(x.float(), w.float()).abs().sum(0)
        dy = (y.float() - yr.float()).abs()
        worst['y'] = max(worst['y'], (dy / yr.float().abs().clamp_min(
            1.0)).max().item())
        worst['colsum'] = max(worst['colsum'], ((s - sr).abs() /
                                                abs_sum.clamp_min(1e-30))
                              .max().item())
        worst['colsumsq'] = max(worst['colsumsq'], ((q - qr).abs() /
                                                    qr.clamp_min(1e-30))
                                .max().item())
        worst['flips'] = max(worst['flips'], (y != yr).float().mean().item())
        return y, s, q

    # the kernel counts its launches on the module's name, which is
    # checked_kernel while it stands in
    checked_kernel.launches = 0
    checked_kernel.launches_by_kernel = {}
    k6.matmul_bn_stats_kernel = checked_kernel
    # op by op: a captured graph replays without calling the stand-in
    eager = fluid.Executor(fluid.CUDAPlace(0))
    try:
        kernel = _one_step(tr, saved, batch, RESNET_PARAMS_COMPARED, eager)
    finally:
        k6.matmul_bn_stats_kernel = kernel_fn
    log('K6 on the step\'s own 36 inputs vs its plain version: y max diff / '
        'max(1, |y|) %.3e (tol %g), bf16 y that differ %.2e of the '
        'elements, colsum %.3e of sum|y|, colsumsq %.3e of sum y^2 (tol %g)'
        % (worst['y'], KERNEL_ATOL['bfloat16'], worst['flips'],
           worst['colsum'], worst['colsumsq'], K6_SUM_RTOL))
    if checked_kernel.launches_by_kernel != {k6.WGMMA_KERNEL: 36}:
        raise AssertionError('K6 launched %s in the kernel step, want %s x 36'
                             % (checked_kernel.launches_by_kernel,
                                k6.WGMMA_KERNEL))
    if not (worst['y'] <= KERNEL_ATOL['bfloat16'] and
            worst['colsum'] <= K6_SUM_RTOL and
            worst['colsumsq'] <= K6_SUM_RTOL):
        raise AssertionError('K6 disagrees with its plain version on the '
                             'step\'s inputs: %r' % worst)
    fluid.set_flags({'FLAGS_use_pallas_fused_ops': False})
    try:
        kernel_fn.launches = 0
        plain = _one_step(tr, saved, batch, RESNET_PARAMS_COMPARED, eager)
        k6.matmul_bn_stats_reference = _reordered_reference
        reordered = _one_step(tr, saved, batch, RESNET_PARAMS_COMPARED,
                              eager)
        if kernel_fn.launches:
            raise AssertionError('K6 launched %d times in the plain steps'
                                 % kernel_fn.launches)
    finally:
        k6.matmul_bn_stats_reference = plain_fn
        fluid.set_flags({'FLAGS_use_pallas_fused_ops': True})
    tr.restore(saved)
    spread = _update_diffs(reordered, plain, RESNET_PARAMS_COMPARED)
    got = _update_diffs(kernel, plain, RESNET_PARAMS_COMPARED)
    loss_diff = abs(kernel[0] - plain[0])
    log('K6 step vs plain step: loss %.6f vs %.6f (|diff| %.3e, tol %g; '
        'fp64-sum plain step %.6f, |diff| %.3e); update max diff / max '
        'update: %s; the plain step\'s spread under fp64 sums: %s (tol: '
        'the larger of %g and %g x that spread)'
        % (kernel[0], plain[0], loss_diff, TRAIN_LOSS_TOL, reordered[0],
           abs(reordered[0] - plain[0]),
           ', '.join('%s %.3e' % kv for kv in got.items()),
           ', '.join('%s %.3e' % kv for kv in spread.items()),
           TRAIN_UPDATE_TOL, RESNET_SPREAD_FACTOR))
    bad = [n for n in RESNET_PARAMS_COMPARED
           if not got[n] <= max(TRAIN_UPDATE_TOL,
                                RESNET_SPREAD_FACTOR * spread[n])]
    if not np.isfinite(kernel[0]) or loss_diff > TRAIN_LOSS_TOL or bad:
        raise AssertionError('K6 step vs plain step disagree beyond the '
                             'stated tolerance (%s)' % bad)
    return loss_diff, got, spread, worst


def _pair_program(fluid, fused, channels, filters, fs, pad):
    """test_pallas_fused.py's pair at a ResNet shape: conv_bn, or conv2d
    + batch_norm, with shared parameter names, then mean and SGD(0.1)."""
    prog, startup = fluid.Program(), fluid.Program()
    prog.random_seed = startup.random_seed = SEED
    with fluid.unique_name.guard(), fluid.program_guard(prog, startup):
        x = fluid.layers.data(name='x', shape=[channels, 56, 56],
                              dtype='float32')
        if fused:
            y = fluid.layers.conv_bn(
                x, num_filters=filters, filter_size=fs, padding=pad,
                act='relu', param_attr=fluid.ParamAttr(name='cw'),
                bn_param_attr=fluid.ParamAttr(name='bs'),
                bn_bias_attr=fluid.ParamAttr(name='bb'))
        else:
            c = fluid.layers.conv2d(
                x, num_filters=filters, filter_size=fs, padding=pad,
                bias_attr=False, param_attr=fluid.ParamAttr(name='cw'))
            y = fluid.layers.batch_norm(
                c, act='relu', param_attr=fluid.ParamAttr(name='bs'),
                bias_attr=fluid.ParamAttr(name='bb'))
        loss = fluid.layers.mean(y)
        fluid.optimizer.SGD(0.1).minimize(loss)
    return prog, startup, y, loss


@phase('r3: fused conv_bn vs conv2d + batch_norm on the card')
def check_fused_pair(place):
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.kernels import conv_bn as k6
    xv = np.random.RandomState(SEED + 4).rand(8, 64, 56, 56).astype(
        'float32')
    worst = {}
    for label, filters, fs, pad in (('1x1 64->256', 256, 1, 0),
                                    ('3x3 64->64', 64, 3, 1)):
        results, init = {}, None
        for fused in (False, True):
            prog, startup, y, loss = _pair_program(fluid, fused, 64,
                                                   filters, fs, pad)
            scope = fluid.Scope()
            exe = fluid.Executor(place)
            exe.run(startup, scope=scope)
            if init is None:
                init = scope.find_var('cw').clone()
            else:
                scope.find_var('cw').copy_(init)
            k6.matmul_bn_stats_kernel.launches = 0
            vals = [exe.run(prog, feed={'x': xv}, fetch_list=[y, loss],
                            scope=scope) for _ in range(3)]
            if fused and fs == 1 and k6.matmul_bn_stats_kernel.launches != 3:
                raise AssertionError('the fused 1x1 pair launched K6 %d '
                                     'times in 3 steps, want 3'
                                     % k6.matmul_bn_stats_kernel.launches)
            results[fused] = vals
        dy = max(float(np.max(np.abs(a[0] - b[0]) /
                              np.maximum(np.abs(b[0]), 1.0)))
                 for a, b in zip(results[True], results[False]))
        dl = max(abs(float(a[1]) - float(b[1])) /
                 max(abs(float(b[1])), 1.0)
                 for a, b in zip(results[True], results[False]))
        worst[label] = (dy, dl)
        log('fused vs unfused %s, [8, 64, 56, 56] fp32, 3 SGD steps: Y max '
            'diff / max(1, |Y|) %.3e, loss %.3e (tol %g)'
            % (label, dy, dl, PAIR_TOL))
        if not (dy <= PAIR_TOL and dl <= PAIR_TOL):
            raise AssertionError('fused and unfused %s disagree' % label)
    return worst


def _profile_resnet(tr, step_ms, sync, label):
    """images/s and MFU of a ResNet-50 step of step_ms (bench.py's FLOPs
    per image over the bf16 dense peak), then a fresh batch, two steps
    and PROFILE_STEPS profiled. Returns (images/s, MFU, device ms, busy
    share, {kernel kind: device ms})."""
    import torch
    fl = resnet50_train_flops_per_image(RESNET['image_hw'],
                                        RESNET['class_dim'])
    img_s = RESNET_BATCH / step_ms * 1e3
    mfu = img_s * fl / PEAK_BF16_FLOPS
    log('%s: %.3f ms, %.1f images/s, %.1f TFLOP/s at %.3f GFLOP per image, '
        'MFU %.4f of the %.1f TFLOP/s bf16 dense peak'
        % (label, step_ms, img_s, img_s * fl / 1e12, fl / 1e9, mfu,
           PEAK_BF16_FLOPS / 1e12))
    batch = image_batch(np.random.RandomState(1), RESNET_BATCH,
                        torch.device('cuda', 0))

    def provider():
        while True:
            yield batch
    tr.feed(provider)
    tr.step()       # after a new executor: the warm-up, then the capture
    tr.step()
    sync()
    by_kind = {}
    device_ms, busy = _profile_steps(tr, step_ms, sync, label,
                                     by_kind_out=by_kind)
    tr.reader.reset()
    return img_s, mfu, device_ms, busy, by_kind


@phase('r4: ResNet-50 step time, images/s, MFU, device time')
def profile_resnet(tr, step_ms, sync):
    return _profile_resnet(tr, step_ms, sync, 'ResNet-50 step')


# -- (n1)-(n3), (i2): bench.py's accelerator ResNet-50 (NHWC) ---------------

# bench.py builds ResNet-50 NHWC on an accelerator (bench_resnet :148),
# with FLAGS_use_pallas_fused_ops at its default and bf16 parameter
# grads (main :524-527); set for n1-n3 and i2, restored after
N1_FLAGS = {'FLAGS_use_pallas_fused_ops': False,
            'FLAGS_amp_bf16_param_grads': True}
# the stem conv, a stage-1 1x1 conv and fc of the unfused program
NHWC_PARAMS_COMPARED = ('conv2d_0.w_0', 'conv2d_2.w_0', 'fc_0.w_0')
RESNET_CONV_BN = 53          # conv + BN pairs of ResNet-50
NAN_CHECK_BATCH = 32
NAN_CHECK_TOL = 1e-5         # the flagged step's loss vs the captured one
S2D_TOL = 1e-5               # tests/test_resnet_s2d.py's bound
S2D_BATCH = 8
S2D_TIMED_STEPS = 3
INFER_BATCH = 16             # bench_inference's ResNet leg (:377-410)
INFER_ITERS = 20
INFER_TOL = 2e-4             # tests/test_parity_modules.py:252


@contextlib.contextmanager
def flags_set(flags):
    """set_flags(flags) for the body, the earlier values restored after."""
    import paddle_tpu_torch as fluid
    prev = fluid.get_flags(list(flags))
    fluid.set_flags(flags)
    try:
        yield
    finally:
        fluid.set_flags(prev)


def check_nhwc_program(program):
    """bench.py's accelerator ResNet-50: RESNET_CONV_BN conv2d and
    batch_norm ops, all NHWC, no conv2d_bn, one transpose (the stem's, of
    the NCHW feed). Returns the op count."""
    ops = program.global_block().ops
    convs = [op for op in ops if op.type == 'conv2d']
    bns = [op for op in ops if op.type == 'batch_norm']
    fused = sum(op.type == 'conv2d_bn' for op in ops)
    transposes = sum(op.type == 'transpose2' for op in ops)
    log('NHWC program: %d ops, %d conv2d (%d NHWC), %d batch_norm (%d NHWC), '
        '%d conv2d_bn, %d transpose2'
        % (len(ops), len(convs),
           sum(op.attr('data_format') == 'NHWC' for op in convs), len(bns),
           sum(op.attr('data_layout') == 'NHWC' for op in bns), fused,
           transposes))
    if not (len(convs) == len(bns) == RESNET_CONV_BN and fused == 0 and
            transposes == 1 and
            all(op.attr('data_format') == 'NHWC' for op in convs) and
            all(op.attr('data_layout') == 'NHWC' for op in bns)):
        raise AssertionError('the NHWC program is not bench.py\'s: want %d '
                             'NHWC conv2d and batch_norm ops, no conv2d_bn '
                             'and one transpose' % RESNET_CONV_BN)
    return len(ops)


@phase('n1: bench.py\'s accelerator ResNet-50 (NHWC, conv2d + batch_norm, '
       'bf16 parameter grads)')
def nhwc_steps(place, sync):
    import torch
    from paddle_tpu_torch.kernels import conv_bn as k6
    t0 = time.perf_counter()
    tr = ResNetTrainer(place, RESNET_BATCH, nhwc=True)
    n_ops = check_nhwc_program(tr.main)
    log('built and initialised in %.1f s' % (time.perf_counter() - t0))
    stats = [n for n in tr.persistables if n.endswith(('.mean', '.variance'))]
    stats0 = {n: tr.scope.find_var(n).clone() for n in stats}
    batch = image_batch(np.random.RandomState(0), RESNET_BATCH,
                        place.device)

    def provider():
        while True:
            yield batch
    tr.feed(provider)
    torch.cuda.reset_peak_memory_stats()
    losses = [tr.step(sync_checked=True)]
    losses += [tr.step() for _ in range(WARMUP_STEPS - 1)]
    sync()
    k6.reset_launches()
    t0 = time.perf_counter()
    losses += [tr.step() for _ in range(TIMED_STEPS)]
    sync()
    wall = time.perf_counter() - t0
    launches = k6.matmul_bn_stats_kernel.launches
    peak_gb = peak_memory_gb()
    reserved_gb = torch.cuda.max_memory_reserved() / 1e9
    step_ms = wall / TIMED_STEPS * 1e3
    moved = sum(not torch.equal(tr.scope.find_var(n), stats0[n])
                for n in stats)
    segments = device_segments(tr.main)
    captured = tr.pe.jit_cache_stats()['compiled_segments']
    log('losses: %s' % ', '.join('%.6f' % x for x in losses))
    log('timed steps: %d in %.3f s, %.3f ms per step, %.1f images/s; K6 '
        'launches %d; BN running statistics moved: %d of %d; captured '
        'segments %d (the program has %d); peak device memory %.2f GB '
        'allocated, %.2f GB reserved'
        % (TIMED_STEPS, wall, step_ms, RESNET_BATCH / step_ms * 1e3,
           launches, moved, len(stats), captured, segments, peak_gb,
           reserved_gb))
    if not all(np.isfinite(losses)):
        raise AssertionError('an NHWC loss is not finite: %r' % losses)
    if launches:
        raise AssertionError('K6 launched %d times on the NHWC path' %
                             launches)
    if moved != len(stats) or len(stats) != 2 * RESNET_CONV_BN:
        raise AssertionError('BN running statistics moved for %d of %d vars'
                             % (moved, len(stats)))
    if captured != segments or segments != 1:
        raise AssertionError('%d segments captured, the program has %d: '
                             'want one' % (captured, segments))
    if reserved_gb > RESNET_PEAK_GB:
        raise AssertionError('peak reserved device memory %.2f GB over the '
                             '%g GB the batch of %d is held to'
                             % (reserved_gb, RESNET_PEAK_GB, RESNET_BATCH))
    return tr, dict(losses=losses, step_ms=step_ms, peak_gb=peak_gb,
                    reserved_gb=reserved_gb, n_ops=n_ops)


@phase('n3: the NHWC step\'s time, images/s, MFU, device time')
def profile_nhwc(tr, step_ms, sync):
    return _profile_resnet(tr, step_ms, sync, 'NHWC ResNet-50 step')


def _bn_batch_stats_fp64(x, axes):
    """batch_norm's batch statistics with the sums taken in fp64: the
    same math in another order of summation (n2's yardstick)."""
    import torch
    xd = x.double()
    m = 1
    for i in axes:
        m *= x.shape[i]
    mean = torch.sum(xd, dim=axes) / m
    var = torch.clamp(torch.sum(xd * xd, dim=axes) / m - mean * mean,
                      min=0.0)
    return mean.float(), var.float()


@phase('n2: the NHWC step vs the NCHW step from one saved state')
def check_nhwc_vs_nchw(tr, place):
    """One step of n1's program from its saved state, and one step of the
    same program built NCHW (without the fused flag, so the same
    parameter names) from the same state and batch, both op by op: the
    losses within TRAIN_LOSS_TOL, the updates of NHWC_PARAMS_COMPARED by
    t2's measure within TRAIN_UPDATE_TOL or RESNET_SPREAD_FACTOR x the
    NCHW step's own spread when its batch statistics are summed in fp64,
    whichever is larger (r2's rule: the bf16 step amplifies any
    reordering of fp32 sums)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.ops import nn_ops
    batch = image_batch(np.random.RandomState(SEED + 5), RESNET_BATCH)
    saved = tr.snapshot()
    # the captured step's pool and an eager step do not fit together
    tr.drop_graphs()
    # a reader of its own: the read op finds its reader by name
    nchw = ResNetTrainer(place, RESNET_BATCH, reader_name='resnet_nchw')
    if sorted(nchw.persistables) != sorted(tr.persistables):
        raise AssertionError('the NCHW and NHWC programs name their '
                             'persistables differently')
    eager = fluid.Executor(place)
    params = NHWC_PARAMS_COMPARED
    nhwc = _one_step(tr, saved, batch, params, eager)
    plain = _one_step(nchw, saved, batch, params, eager)
    stats_fn = nn_ops._bn_batch_stats
    nn_ops._bn_batch_stats = _bn_batch_stats_fp64
    try:
        reordered = _one_step(nchw, saved, batch, params, eager)
    finally:
        nn_ops._bn_batch_stats = stats_fn
    tr.restore(saved)
    nchw.drop_graphs()
    spread = _update_diffs(reordered, plain, params)
    got = _update_diffs(nhwc, plain, params)
    loss_diff = abs(nhwc[0] - plain[0])
    bound = {n: max(TRAIN_UPDATE_TOL, RESNET_SPREAD_FACTOR * spread[n])
             for n in params}
    log('NHWC step vs NCHW step: loss %.6f vs %.6f (|diff| %.3e, tol %g; '
        'fp64-sum NCHW step %.6f, |diff| %.3e); update max diff / max '
        'update: %s; the NCHW step\'s spread under fp64 sums: %s (tol: the '
        'larger of %g and %g x that spread)'
        % (nhwc[0], plain[0], loss_diff, TRAIN_LOSS_TOL, reordered[0],
           abs(reordered[0] - plain[0]),
           ', '.join('%s %.3e' % kv for kv in got.items()),
           ', '.join('%s %.3e' % kv for kv in spread.items()),
           TRAIN_UPDATE_TOL, RESNET_SPREAD_FACTOR))
    bad = [n for n in params if not got[n] <= bound[n]]
    if not np.isfinite(nhwc[0]) or loss_diff > TRAIN_LOSS_TOL or bad:
        raise AssertionError('the NHWC and NCHW steps disagree beyond the '
                             'stated tolerance (%s)' % bad)
    return dict(loss_diff=loss_diff, updates=got, spread=spread)


def first_reader_of(program, name):
    """(index, op) of the first op of the program's global block that
    reads `name`."""
    for i, op in enumerate(program.global_block().ops):
        if name in op.input_arg_names():
            return i, op
    raise AssertionError('no op reads %r' % name)


def check_nan_error(program, image, run_bad):
    """run_bad() must raise OpExecutionError for a NaN in `image`, naming
    the first op that reads it; any other outcome fails (nothing else is
    caught). Returns the message."""
    from paddle_tpu_torch.executor import OpExecutionError
    pos, op = first_reader_of(program, image)
    try:
        run_bad()
    except OpExecutionError as e:
        msg = str(e)
    else:
        raise AssertionError('FLAGS_check_nan_inf: a NaN in %r raised no '
                             'OpExecutionError' % image)
    want = 'op #%d %r' % (pos, op.type)
    log('a NaN pixel under FLAGS_check_nan_inf: %s' % msg.splitlines()[0])
    if 'NaN/Inf detected in output' not in msg or want not in msg:
        raise AssertionError('FLAGS_check_nan_inf named another op than '
                             '%s, the first reader of %r: %s'
                             % (want, image, msg))
    return msg


@phase('i2: FLAGS_check_nan_inf on the card (n1\'s program at batch %d)'
       % NAN_CHECK_BATCH)
def check_nan_inf_mode(tr, sync):
    """From one saved state: a captured step (warm-up, then the capture
    and its replay) and a step under FLAGS_check_nan_inf, which runs op
    by op (the capture count does not move) to the captured step's loss
    within NAN_CHECK_TOL; then a batch with one NaN pixel must raise
    OpExecutionError naming the first op that reads the image."""
    rng = np.random.RandomState(SEED + 7)
    batch = image_batch(rng, NAN_CHECK_BATCH)
    saved = tr.snapshot()
    tr.fresh_executor()
    _one_step(tr, saved, batch, ())
    captured = _one_step(tr, saved, batch, ())[0]
    before = tr.pe.jit_cache_stats()['compiled_segments']
    with flags_set({'FLAGS_check_nan_inf': True}):
        t0 = time.perf_counter()
        checked = _one_step(tr, saved, batch, ())[0]
        sync()
        checked_ms = (time.perf_counter() - t0) * 1e3
        after = tr.pe.jit_cache_stats()['compiled_segments']
        bad = [batch[0].copy(), batch[1]]
        hw = RESNET['image_hw']
        bad[0][NAN_CHECK_BATCH // 2, 1, hw // 2, hw // 3] = float('nan')
        try:
            msg = check_nan_error(tr.main, tr.image.name,
                                  lambda: _one_step(tr, saved, bad, ()))
        finally:
            tr.reader.reset()
    tr.restore(saved)
    tr.drop_graphs()
    diff = abs(checked - captured)
    log('batch %d: captured step loss %.6f, checked step (op by op, every '
        'output scanned) %.6f, |diff| %.3e (tol %g), %.1f ms; captured '
        'segments %d before the checked step, %d after'
        % (NAN_CHECK_BATCH, captured, checked, diff, NAN_CHECK_TOL,
           checked_ms, before, after))
    if after != before or before < 1:
        raise AssertionError('the checked step was captured (%d -> %d)'
                             % (before, after))
    if not np.isfinite(checked) or diff > NAN_CHECK_TOL:
        raise AssertionError('the checked step\'s loss is not the captured '
                             'step\'s')
    return dict(loss_diff=diff, checked_ms=checked_ms, message=msg)


# -- (s1): the space-to-depth stem --------------------------------------------

def s2d_filter(w):
    """[O, C, 7, 7] -> [O, 4C, 4, 4]: the space-to-depth stem's filter,
    w'[o, c*4+di*2+dj, m, n] = w[o, c, 2m+di-1, 2n+dj-1], zero outside
    the 7x7 support."""
    import torch
    O, C = w.shape[:2]
    w4 = w.new_zeros((O, C * 4, 4, 4))
    chans = torch.arange(C, device=w.device) * 4
    for di in range(2):
        for dj in range(2):
            for m in range(4):
                for n in range(4):
                    u, v = 2 * m + di - 1, 2 * n + dj - 1
                    if 0 <= u < 7 and 0 <= v < 7:
                        w4[:, chans + di * 2 + dj, m, n] = w[:, :, u, v]
    return w4


def s2d_stem_conv(x, w4):
    """The retiled stem through the port on x's device: models.resnet's
    space_to_depth (reshape, transpose, reshape, pad) and a 4x4 conv2d
    with filter w4, fp32."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import resnet
    _, C, H, W = x.shape
    prog, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(prog, startup):
        xv = fluid.layers.data(name='x', shape=[C, H, W], dtype='float32')
        out = fluid.layers.conv2d(
            resnet.space_to_depth(xv), num_filters=w4.shape[0],
            filter_size=4, bias_attr=False,
            param_attr=fluid.ParamAttr(name='stem4.w'))
    place = fluid.CPUPlace() if x.device.type == 'cpu' \
        else fluid.CUDAPlace(x.device.index or 0)
    scope = fluid.Scope()
    scope.set_var('stem4.w', w4)
    return fluid.Executor(place).run(prog, feed={'x': x}, fetch_list=[out],
                                     scope=scope, return_numpy=False)[0]


@phase('s1: the space-to-depth stem (exactness; ResNet-50 with it, NCHW, '
       'K6)')
def s2d_steps(place, sync):
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.kernels import conv_bn as k6
    dev = place.device
    gen = torch.Generator(device=dev).manual_seed(SEED)
    hw = RESNET['image_hw']
    x = torch.rand((S2D_BATCH, 3, hw, hw), generator=gen, device=dev)
    w = torch.randn((64, 3, 7, 7), generator=gen, device=dev) * 0.1
    want = F.conv2d(x, w, stride=2, padding=3)
    got = s2d_stem_conv(x, s2d_filter(w))
    err = (got - want).abs().max().item()
    log('the retiled 4x4 stem vs the 7x7/2 conv, [%d, 3, %d, %d] fp32: max '
        '|diff| %.3e (tol %g, relative to max |y| %.3f)'
        % (S2D_BATCH, hw, hw, err, S2D_TOL, want.abs().max().item()))
    if tuple(got.shape) != tuple(want.shape) or \
            not err <= S2D_TOL * max(1.0, want.abs().max().item()):
        raise AssertionError('the space-to-depth stem is not the 7x7 stem')
    # r1's configuration: NCHW, every conv + BN one conv2d_bn, whose 1x1
    # path runs K6 (the flag is read when the program is built and when
    # the op runs)
    with flags_set({'FLAGS_use_pallas_fused_ops': True}):
        tr = ResNetTrainer(place, RESNET_BATCH, space_to_depth=True)
        path_shapes = k6_path_shapes(tr.main, RESNET_BATCH)
        per_step = sum(path_shapes.values())
        ops = [op.type for op in tr.main.global_block().ops]
        batch = image_batch(np.random.RandomState(0), RESNET_BATCH, dev)

        def provider():
            while True:
                yield batch
        tr.feed(provider)
        losses = [tr.step() for _ in range(WARMUP_STEPS)]
        sync()
        k6.reset_launches()
        t0 = time.perf_counter()
        losses += [tr.step() for _ in range(S2D_TIMED_STEPS)]
        sync()
        step_ms = (time.perf_counter() - t0) / S2D_TIMED_STEPS * 1e3
    launches = k6.matmul_bn_stats_kernel.launches
    log('s2d program: %d conv2d_bn, %d pad; losses: %s; %d timed steps, '
        '%.3f ms per step, %.1f images/s; K6 launches %d (want %d x %d)'
        % (ops.count('conv2d_bn'), ops.count('pad'),
           ', '.join('%.6f' % v for v in losses), S2D_TIMED_STEPS, step_ms,
           RESNET_BATCH / step_ms * 1e3, launches, per_step,
           S2D_TIMED_STEPS))
    tr.drop_graphs()
    if not all(np.isfinite(losses)):
        raise AssertionError('an s2d loss is not finite: %r' % losses)
    if ops.count('pad') != 1 or per_step != 36 or \
            launches != per_step * S2D_TIMED_STEPS:
        raise AssertionError('K6 launched %d times in %d s2d steps, want 36 '
                             'a step' % (launches, S2D_TIMED_STEPS))
    return dict(stem_err=err, losses=losses, step_ms=step_ms,
                launches=launches)


# -- (i1): bench_inference's ResNet-50 leg ------------------------------------

def inference_model(model_dir, place, batch, hw, classes, depth, seed):
    """bench_inference's ResNet program (resnet_imagenet(is_test=True,
    nhwc=True)), initialised on `place`, saved with save_inference_model
    into model_dir. So that the fold is not the identity, each batch
    norm's affine is drawn from `seed`, and its running statistics are
    the batch statistics it sees in one training-mode forward over a
    batch drawn from `seed` (as training would leave them: the
    activations stay normalised, and the softmax is not saturated).
    Returns the input name."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import resnet

    def build(is_test):
        main, startup = fluid.Program(), fluid.Program()
        main.random_seed = startup.random_seed = seed
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            image = fluid.layers.data(name='image', shape=[3, hw, hw],
                                      dtype='float32')
            pred = resnet.resnet_imagenet(image, class_dim=classes,
                                          depth=depth, is_test=is_test,
                                          nhwc=True)
        return main, startup, pred
    main, startup, pred = build(True)
    calib = build(False)[0]
    scope = fluid.Scope()
    exe = fluid.Executor(place)
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(seed)
    bns = [op for op in main.global_block().ops if op.type == 'batch_norm']
    for op in bns:
        c = main.global_block().var(op.single_input('Scale')).shape[0]
        fluid.io.load_numpy_params(scope, {
            op.single_input('Scale'): (1.0 + 0.1 * rng.randn(c)).astype(
                'float32'),
            op.single_input('Bias'): (0.1 * rng.randn(c)).astype('float32')},
            place, program=main)
    # the same network in training mode (the same names): each batch
    # norm's SavedMean / SavedVariance
    saved = [op.single_output(s) for op in calib.global_block().ops
             if op.type == 'batch_norm'
             for s in ('SavedMean', 'SavedVariance')]
    stats = exe.run(calib, feed={'image': rng.rand(batch, 3, hw, hw)
                                 .astype('float32')},
                    fetch_list=saved, scope=scope, use_program_cache=False)
    for op, mean, var in zip(bns, stats[0::2], stats[1::2]):
        fluid.io.load_numpy_params(scope, {op.single_input('Mean'): mean,
                                           op.single_input('Variance'): var},
                                   place, program=main)
    with fluid.scope_guard(scope):
        fluid.io.save_inference_model(model_dir, ['image'], [pred], exe,
                                      main_program=main)
    return 'image'


def op_counts(predictor):
    types = [op.type for op in predictor._program.global_block().ops]
    return {t: types.count(t) for t in ('batch_norm', 'elementwise_add',
                                        'conv2d')}


def check_fold(folded, plain, img, runs=3):
    """The folded predictor against the ir_optim=False one on `img`:
    batch_norm ops gone, each replaced by one elementwise_add, outputs
    within INFER_TOL; a clone of the folded one gives its bits. Each
    predictor runs `runs` times (on the card: warm-up, capture, replay)
    and its last output is compared. Returns (max |diff|, op counts)."""
    cf, cp = op_counts(folded), op_counts(plain)
    outs = {}
    clone = folded.clone()
    for name, p in (('folded', folded), ('plain', plain), ('clone', clone)):
        for _ in range(runs):
            outs[name] = p.run([img])[0]
    err = float(np.abs(outs['folded'] - outs['plain']).max())
    same = bool(np.array_equal(outs['clone'], outs['folded']))
    log('ir_optim: batch_norm %d -> %d, elementwise_add %d -> %d, conv2d %d '
        '-> %d; folded vs unfolded output max |diff| %.3e (tol %g; outputs '
        'in [%.3e, %.3e]); the clone gives the same bits: %s'
        % (cp['batch_norm'], cf['batch_norm'], cp['elementwise_add'],
           cf['elementwise_add'], cp['conv2d'], cf['conv2d'], err,
           INFER_TOL, outs['plain'].min(), outs['plain'].max(), same))
    if not (cf['batch_norm'] == 0 and cp['batch_norm'] > 0 and
            cf['elementwise_add'] == cp['elementwise_add'] +
            cp['batch_norm'] and cf['conv2d'] == cp['conv2d']):
        raise AssertionError('the fold did not replace every batch_norm by '
                             'one elementwise_add: %r vs %r' % (cf, cp))
    if not np.isfinite(outs['folded']).all() or err > INFER_TOL or not same:
        raise AssertionError('the folded predictor disagrees with the '
                             'unfolded one or with its clone')
    return err, cf, cp


def _latency_ms(fn, iters):
    """bench.py's _latency_stats: p50, p99 and mean ms of fn()."""
    lats = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        lats.append(time.perf_counter() - t0)
    lats.sort()
    p50 = lats[len(lats) // 2]
    p99 = lats[min(len(lats) - 1, int(len(lats) * 0.99))]
    return p50 * 1e3, p99 * 1e3, sum(lats) / len(lats) * 1e3


def serving_throughput(predictor, feed, batch, iters, sync):
    """bench.py's serving_throughput (:313-342): predictor.run(feed,
    return_numpy=False) on a device-resident feed, synchronised once,
    N/2N differenced; N doubles until the differenced work is more than
    half the shorter run. Returns (images/s, ms per batch) or (None,
    None)."""
    def _loop(n):
        t0 = time.perf_counter()
        for _ in range(n):
            predictor.run(feed, return_numpy=False)
        sync()
        return time.perf_counter() - t0
    _loop(3)
    for _ in range(4):
        w1, w2 = _loop(iters), _loop(2 * iters)
        d = w2 - w1
        if d > 0.5 * w1:
            return batch * iters / d, d / iters * 1e3
        iters *= 2
    return None, None


@phase('i1: bench_inference\'s ResNet-50 leg (batch %d, 224 px, NHWC) '
       'through AnalysisPredictor\'s batch-norm fold' % INFER_BATCH)
def inference_leg(place, sync):
    import torch
    from paddle_tpu_torch.inference import AnalysisConfig, AnalysisPredictor
    hw = RESNET['image_hw']
    build_root = os.path.join(HERE, 'build')
    os.makedirs(build_root, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_root) as model_dir:
        name = inference_model(model_dir, place, INFER_BATCH, hw,
                               RESNET['class_dim'], RESNET['depth'], SEED)
        folded = AnalysisPredictor(AnalysisConfig(model_dir, place=place))
        plain = AnalysisPredictor(AnalysisConfig(model_dir, place=place)
                                  .switch_ir_optim(False))
    img = np.random.RandomState(SEED + 9).rand(
        INFER_BATCH, 3, hw, hw).astype('float32')
    err, cf, cp = check_fold(folded, plain, img)
    del plain
    p50, p99, mean = _latency_ms(lambda: folded.run([img]), INFER_ITERS)
    feed = {name: torch.from_numpy(img).to(place.device)}
    thr, ms = serving_throughput(folded, feed, INFER_BATCH, INFER_ITERS,
                                 sync)
    log('ResNet-50 inference, batch %d, fp32, folded: host feed p50 %.3f ms, '
        'p99 %.3f ms, mean %.3f ms (%.1f images/s); device-resident feed '
        '%s images/s (%s ms a batch, N/2N differenced)'
        % (INFER_BATCH, p50, p99, mean, INFER_BATCH / mean * 1e3,
           'not measured' if thr is None else '%.1f' % thr,
           'not measured' if ms is None else '%.3f' % ms))
    if thr is None:
        raise AssertionError('the device throughput was not measured: the '
                             'differenced work never dominated')
    return dict(err=err, p50=p50, p99=p99, images_s=thr, batch_ms=ms,
                folded=cf, plain=cp)


# -- (l1)-(l3): the long-context LM under twopass / onepass ------------------

@contextlib.contextmanager
def flash_arms(fwd, bwd):
    """PADDLE_FLASH_FWD / PADDLE_FLASH_BWD set to fwd / bwd (None: unset)
    for the body, and restored after it."""
    names = ('PADDLE_FLASH_FWD', 'PADDLE_FLASH_BWD')
    prev = {n: os.environ.get(n) for n in names}
    try:
        for n, value in zip(names, (fwd, bwd)):
            if value is None:
                os.environ.pop(n, None)
            else:
                os.environ[n] = value
        yield
    finally:
        for n, value in prev.items():
            if value is None:
                os.environ.pop(n, None)
            else:
                os.environ[n] = value


@phase('l1: train the long-context LM under twopass / onepass (K4a, K4b, '
       'K5)')
def lc_steps(cfg, place, counters, sync):
    import torch
    from paddle_tpu_torch.kernels import flash_attention as fa
    t0 = time.perf_counter()
    tr = LMRun(cfg, place, LC_BATCH, LC_HEAD_CHUNK, LC_READER)
    ops = tr.main.global_block().ops
    n_params = sum(int(np.prod(v.shape)) for v in tr.main.list_vars()
                   if v.persistable and getattr(v, 'trainable', False))
    log('long-context program: vocab %d, dim %d, heads %d, layers %d, ffn '
        '%d, max_len %d; %d ops of %d types, %d parameters, batch %d x %d '
        'tokens, fused head chunk %d, no depth cut; built and initialised '
        'in %.1f s'
        % (cfg.vocab, cfg.dim, cfg.heads, cfg.layers, cfg.ffn, cfg.max_len,
           len(ops), len(set(o.type for o in ops)), n_params, tr.batch,
           cfg.max_len, LC_HEAD_CHUNK, time.perf_counter() - t0))
    with flash_arms(*LC_ARMS):
        tr.feed(bench_provider(cfg, tr.batch, np.random.RandomState(0)))
        # the peak covers the eager warm-up, the capture and the replays
        torch.cuda.reset_peak_memory_stats()
        losses = [tr.step(sync_checked=True)]
        losses += [tr.step() for _ in range(WARMUP_STEPS - 1)]
        sync()
        for c in counters.values():
            c.launches = 0
        fa.FlashAttention.plain_cuda_calls = 0
        fa.take_extra_flops()
        t0 = time.perf_counter()
        losses += [tr.step() for _ in range(TIMED_STEPS)]
        sync()
        wall = time.perf_counter() - t0
        launches = {name: c.launches for name, c in counters.items()}
        require_no_plain(fa, 'l1')
        extra_per_step = fa.take_extra_flops() / TIMED_STEPS
        check_replay_launches('l1', tr.step, sync)
        fa.take_extra_flops()  # the checked step's notes
        tr.reader.reset()
    peak_gb = peak_memory_gb()
    step_ms = wall / TIMED_STEPS * 1e3
    log('losses: %s' % ', '.join('%.6f' % x for x in losses))
    log('timed steps: %d in %.3f s, %.3f ms per step; launches %s; peak '
        'device memory %.2f GB; extra FLOP noted by K4a %.4g per step'
        % (TIMED_STEPS, wall, step_ms, json.dumps(launches), peak_gb,
           extra_per_step))
    if not all(np.isfinite(losses)):
        raise AssertionError('a long-context loss is not finite: %r'
                             % losses)
    need = cfg.layers * TIMED_STEPS
    wrong = {n: c for n, c in launches.items()
             if c != (need if n in [KERNELS[kd][0] for kd in
                                    ('k4a', 'k4b', 'k5')] else 0)}
    if wrong:
        raise AssertionError('want K4a, K4b and K5 exactly %d times in %d '
                             'steps and K1, K2, K3a, K3b never; got %r'
                             % (need, TIMED_STEPS, wrong))
    return tr, losses, step_ms, launches, peak_gb, extra_per_step


def _timed_step(tr, saved, batch, sync):
    """Wall ms of one step from the saved state (feed started first)."""
    tr.restore(saved)

    def provider():
        while True:
            yield batch
    tr.feed(provider)
    sync()
    t0 = time.perf_counter()
    tr.step()
    sync()
    return (time.perf_counter() - t0) * 1e3


@phase('l2: twopass/onepass step vs default-arm step vs plain step')
def check_lc_arms(tr, counters, sync):
    """One step from a saved state under each of twopass/onepass,
    online/kvmajor and the plain versions, with their launch counts. In
    bf16 the onepass and kvmajor backwards launch the same tensor-core
    kernel (flash_bwd_wgmma_kernel) through their own wrappers, so the
    two kernel steps differ in the forward only: K4a + K4b against K1.
    Returns the losses' and updates' differences, each arm's mean wall
    ms of one step, the launches and each arm's device ms per step."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.kernels import flash_attention as fa
    cfg = tr.cfg
    rng = np.random.RandomState(SEED + 5)
    toks = rng.randint(0, cfg.vocab, size=(tr.batch, cfg.max_len,
                                           1)).astype('int64')
    batch = [toks, np.roll(toks, -1, axis=1)]
    saved = tr.snapshot()
    # the three steps below run eagerly (each its prepared program's
    # first run), with no captured pool held
    tr.drop_graphs()
    results, launches = {}, {}
    for label, arms, flash in (('twopass/onepass', LC_ARMS, True),
                               ('online/kvmajor', (None, None), True),
                               ('plain', (None, None), False)):
        with flash_arms(*arms):
            fluid.set_flags({'FLAGS_use_flash_attention': flash})
            try:
                for c in counters.values():
                    c.launches = 0
                results[label] = _one_step(tr, saved, batch,
                                           LC_PARAMS_COMPARED)
                launches[label] = {n: c.launches
                                   for n, c in counters.items()}
            finally:
                fluid.set_flags({'FLAGS_use_flash_attention': True})
                fa.FlashAttention.plain_cuda_calls = 0
        log('%s step launches: %s' % (label, json.dumps(launches[label])))
    L = cfg.layers
    want = {'twopass/onepass': ('k4a', 'k4b', 'k5'),
            'online/kvmajor': ('fwd', 'k2'), 'plain': ()}
    for label, kinds in want.items():
        names = [KERNELS[kd][0] for kd in kinds]
        bad = {n: c for n, c in launches[label].items()
               if c != (L if n in names else 0)}
        if bad:
            raise AssertionError('%s step: want %s %d times each and no '
                                 'other flash kernel; got %r'
                                 % (label, names, L, bad))
    diffs = {
        'plain': _compare('twopass/onepass step vs plain step',
                          results['twopass/onepass'], results['plain'],
                          LC_PARAMS_COMPARED),
        'default': _compare('twopass/onepass step vs online/kvmajor step',
                            results['twopass/onepass'],
                            results['online/kvmajor'], LC_PARAMS_COMPARED)}
    # each kernel arm's capture, then its replayed steps in turns: A, B,
    # B, A
    for arms in (LC_ARMS, (None, None)):
        with flash_arms(*arms):
            _timed_step(tr, saved, batch, sync)
    times = {'twopass/onepass': [], 'online/kvmajor': []}
    for label in ('twopass/onepass', 'online/kvmajor', 'online/kvmajor',
                  'twopass/onepass'):
        with flash_arms(*(LC_ARMS if label == 'twopass/onepass'
                          else (None, None))):
            times[label].append(_timed_step(tr, saved, batch, sync))
    tr.reader.reset()
    tr.restore(saved)
    step_ms = {k: float(np.mean(v)) for k, v in times.items()}
    log('one step from the saved state, in turns A B B A: twopass/onepass '
        '%s ms, online/kvmajor %s ms (means %.3f / %.3f ms)'
        % (', '.join('%.3f' % t for t in times['twopass/onepass']),
           ', '.join('%.3f' % t for t in times['online/kvmajor']),
           step_ms['twopass/onepass'], step_ms['online/kvmajor']))
    # the arms' device time per step, which the host's noise in the wall
    # times above does not reach
    device_ms = {}
    for label, arms in (('twopass/onepass', LC_ARMS),
                        ('online/kvmajor', (None, None))):
        with flash_arms(*arms):
            tr.feed(bench_provider(cfg, tr.batch, np.random.RandomState(2)))
            tr.step()
            sync()
            device_ms[label], _ = _profile_steps(
                tr, step_ms[label], sync, 'long-context %s step' % label)
            tr.reader.reset()
    tr.restore(saved)
    return diffs, step_ms, launches, device_ms


@phase('l3: long-context step time, tokens/s, MFU, device time')
def profile_lc(tr, step_ms, extra_per_step, sync):
    cfg = tr.cfg
    tokens = tr.batch * cfg.max_len
    fl = train_flops_per_token(cfg, causal=True)
    tok_s = tokens / step_ms * 1e3
    mfu = tok_s * fl / PEAK_BF16_FLOPS
    executed = fl * tokens + extra_per_step
    mfu_exec = executed / (step_ms / 1e3) / PEAK_BF16_FLOPS
    log('long-context step: %.3f ms, %.1f tokens/s, MFU %.4f at bench.py\'s '
        'causal %.4f GFLOP per token (%.3f TFLOP per step); by the executed '
        'FLOPs (+ %.4g noted by K4a per step: %.3f TFLOP) MFU %.4f, of the '
        '%.1f TFLOP/s bf16 dense peak'
        % (step_ms, tok_s, mfu, fl / 1e9, fl * tokens / 1e12,
           extra_per_step, executed / 1e12, mfu_exec,
           PEAK_BF16_FLOPS / 1e12))
    with flash_arms(*LC_ARMS):
        tr.feed(bench_provider(cfg, tr.batch, np.random.RandomState(1)))
        tr.step()
        sync()
        device_ms, busy = _profile_steps(tr, step_ms, sync,
                                         'long-context step')
        tr.reader.reset()
    return tok_s, mfu, mfu_exec, device_ms, busy


# -- (p): the exp / exp2 probe ------------------------------------------------

@phase('p: the exp/exp2 probe P vs its plain version, and its rates')
def check_probe():
    import torch
    from paddle_tpu_torch.tools import probe_exp2 as probe
    x = probe.probe_input()
    ragged = probe.probe_input((3, 7, 111))
    errs = {}
    for inp in (x, ragged):
        for fn in probe.FNS:
            for reps in (4, 8):
                got = probe.exp_chain_kernel(inp, reps, fn)
                torch.cuda.synchronize()
                want = probe.exp_chain_reference(inp, reps, fn)
                errs[(tuple(inp.shape), fn, reps)] = _max_err((got,), (want,))
    worst = max(errs.values())
    log('P vs its plain version: max_abs_err %s (atol %g) %s'
        % (', '.join('%s %s x%d %.3e' % (list(sh), fn, r, e)
                     for (sh, fn, r), e in errs.items()), PROBE_ATOL,
           'ok' if worst <= PROBE_ATOL else 'MISMATCH'))
    if not worst <= PROBE_ATOL:
        raise AssertionError('P disagrees with its plain version')
    # the probe's own run is P's main path
    rate, how = probe.sfu_rate()
    log('special-function-unit rate: %s' % how)
    probe.exp_chain_kernel.launches = 0
    rows = probe.measure(x)
    launches = probe.exp_chain_kernel.launches
    ratio = probe.report(rows, rate)
    reps, fn, n = 8, 'exp2', x.numel()
    times = bracketed_ms({
        'ms': lambda: probe.exp_chain_kernel(x, reps, fn),
        'plain_ms': lambda: probe.exp_chain_reference(x, reps, fn)})
    # x read once and out written once; per element and step one exp2 on
    # the special-function unit and a multiply and an add in fp32
    t_bytes = 2 * 4 * n / PEAK_BYTES_PER_S * 1e3
    t_ops = max(reps * n / rate, 2 * reps * n / PEAK_FP32_FLOPS) * 1e3
    name, replaces, source = PROBE_SOURCE
    row = {'name': name, 'route': 'cuda', 'source': source,
           'replaces': replaces, 'launches': launches,
           'max_abs_err': errs[(tuple(x.shape), fn, reps)],
           'ms': times['ms'], 'plain_ms': times['plain_ms'],
           'bound_ms': max(t_bytes, t_ops),
           'bound_by': 'bytes' if t_bytes >= t_ops else 'operations',
           'library_ms': None, 'shape': list(x.shape), 'dtype': 'float32',
           'fn': fn, 'reps': reps}
    _log_rows([row])
    return row, rows, ratio


# -- (x1)-(x4): the Executor's captured path ----------------------------------

# x1 and x4: WARMUP_STEPS steps (the eager warm-up, then the capture) and
# then X_TIMED_STEPS replays
X_TIMED_STEPS = 3
# x4: the policies, and K1's launches per block and step under each
REMAT_POLICIES = (None, 'nothing', 'dots')
# x4's dropout check: the width of its input and the bound on dL/dw
# against the forward's masked batch mean (fp32 sums in two orders)
REMAT_DROPOUT_WIDTH = 1024
REMAT_DROPOUT_RTOL = 1e-5
# x4's seeded dropout: the op's own seed attr
DROPOUT_OP_SEED = 7
# x5: the reader's second, smaller batch on ResNet-50's captured executor
RESNET_SECOND_BATCH = 64


@contextlib.contextmanager
def no_host_sync():
    """torch.cuda.set_sync_debug_mode('error') for the body: any op that
    synchronises with the host raises. A device op must not: it would
    fail inside a CUDA graph capture."""
    import torch
    torch.cuda.set_sync_debug_mode('error')
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(0)


def device_segments(program):
    """The number of device segments the Executor splits the program's
    global block into."""
    from paddle_tpu_torch.executor import PreparedProgram, _DeviceSegment
    return sum(isinstance(s, _DeviceSegment)
               for s in PreparedProgram(program, 0, [], []).steps)


def _x_run(tr, saved, batches, step, sync, names, label, stats=None):
    """From the saved state, feed `batches` in turn and run WARMUP_STEPS +
    X_TIMED_STEPS steps of step(), then one more under torch.profiler.
    Returns the losses of the first ones, {name: value after them}, the
    timed ms per step, the peak device memory, the profiled step's
    device ms and busy share and, with `stats` (an executor's
    jit_cache_stats), compiled_segments after the warm-up steps and at
    the end of the timed ones."""
    import itertools
    import torch
    tr.restore(saved)
    tr.feed(lambda: itertools.cycle(batches))
    sync()
    torch.cuda.reset_peak_memory_stats()
    losses = [step() for _ in range(WARMUP_STEPS)]
    sync()
    mid = stats()['compiled_segments'] if stats else None
    t0 = time.perf_counter()
    losses += [step() for _ in range(X_TIMED_STEPS)]
    sync()
    ms = (time.perf_counter() - t0) / X_TIMED_STEPS * 1e3
    end = stats()['compiled_segments'] if stats else None
    peak_gb = peak_memory_gb()
    device_ms, busy = _profile_steps(tr, ms, sync, label, steps=1,
                                     step=step)
    tr.reader.reset()
    state = {n: tr.scope.find_var(n).clone() for n in names}
    return dict(losses=losses, state=state, ms=ms, compiled=(mid, end),
                peak_gb=peak_gb, device_ms=device_ms, busy=busy)


def _fmt_busy(busy):
    return 'not measured' if busy is None else '%.1f%%' % (100 * busy)


def check_x1(label, eager, captured, saved, params, n_segments, form,
             grads=None, eager2=None):
    """Hold the captured run to the eager one: every loss within
    TRAIN_LOSS_TOL, each parameter's update (value after the steps minus
    saved) within TRAIN_UPDATE_TOL by t2's measure ('max'), by a2's
    gradient-weighted measure ('weighted', grads {param: g}) or by r2's
    rule ('spread': within the larger of TRAIN_UPDATE_TOL and
    RESNET_SPREAD_FACTOR x a second eager run's own spread); the
    capture count equal to the program's device segments after the
    warm-up steps and unchanged over the timed ones. Returns (worst loss
    difference, {param: update measure}, bits equal)."""
    loss_diff = max(abs(a - b) for a, b in zip(captured['losses'],
                                               eager['losses']))

    def updates(run):
        return {n: (run['state'][n] - saved[n]).float() for n in params}
    ue, uc = updates(eager), updates(captured)
    if form == 'weighted':
        got = _first_order_diffs(uc, ue, grads, params)
        bound = {n: TRAIN_UPDATE_TOL for n in params}
    else:
        got = _update_diffs((0, uc), (0, ue), params)
        bound = {n: TRAIN_UPDATE_TOL for n in params}
        if form == 'spread':
            spread = _update_diffs((0, updates(eager2)), (0, ue), params)
            bound = {n: max(TRAIN_UPDATE_TOL,
                            RESNET_SPREAD_FACTOR * spread[n])
                     for n in params}
    bits = (captured['losses'] == eager['losses'] and
            all(bool((captured['state'][n] == eager['state'][n]).all())
                for n in eager['state']))
    log('%s captured vs eager: loss max |diff| %.3e (tol %g); updates: %s '
        '(%s); the same bits: %s; captured segments %s after the warm-up '
        'and the timed steps (the program has %d)'
        % (label, loss_diff, TRAIN_LOSS_TOL,
           ', '.join('%s %.3e (tol %.3e)' % (n, got[n], bound[n])
                     for n in params),
           {'max': 'max diff / max update', 'weighted':
            'sum |g|·|diff| / sum |g|·|update|',
            'spread': 'max diff / max update'}[form], bits,
           captured['compiled'], n_segments))
    if not all(np.isfinite(captured['losses'])) or \
            loss_diff > TRAIN_LOSS_TOL or \
            any(got[n] > bound[n] for n in params):
        raise AssertionError('%s: the captured steps disagree with the eager '
                             'steps beyond the stated tolerance' % label)
    if captured['compiled'] != (n_segments, n_segments):
        raise AssertionError('%s: %r segments captured after the warm-up and '
                             'the timed steps, want %d both times'
                             % (label, captured['compiled'], n_segments))
    return loss_diff, got, bits


@phase('x1: captured steps vs eager steps from one saved state')
def check_captured_steps(tr, label, params, form, place, sync):
    """WARMUP_STEPS + X_TIMED_STEPS steps of `tr`'s program through a new
    ParallelExecutor (eager, captured, then replayed) and the same steps
    op by op (use_program_cache=False), from one saved state on the same
    batches: check_x1. Returns the comparison and both runs' ms per
    timed step and busy shares."""
    import paddle_tpu_torch as fluid
    rng = np.random.RandomState(SEED + 11)
    batches = [tr.batch_of(rng) for _ in range(WARMUP_STEPS +
                                               X_TIMED_STEPS)]
    saved = tr.snapshot()
    names = list(params)
    m1 = {}
    if form == 'weighted':
        for p in params:
            m1[p], = [n for n in tr.persistables
                      if n.startswith(p + '_moment1_')]
        names += list(m1.values())
    tr.fresh_executor()
    captured = _x_run(tr, saved, batches, tr.step, sync, names,
                      '%s captured' % label, tr.pe.jit_cache_stats)
    # the captured run first, then its pool dropped: a ResNet-50 pool
    # and an eager step do not fit together, and a pool captured after
    # eager runs sits beside the blocks they leave pinned, near the
    # card's size
    tr.drop_graphs()
    eager_exe = fluid.Executor(place)

    def eager_step():
        return float(eager_exe.run(tr.main, fetch_list=[tr.avg_cost.name],
                                   scope=tr.scope,
                                   use_program_cache=False)[0])
    eager = _x_run(tr, saved, batches, eager_step, sync, names,
                   '%s op by op' % label)
    eager2 = (_x_run(tr, saved, batches, eager_step, sync, names,
                     '%s op by op, again' % label)
              if form == 'spread' else None)
    tr.restore(saved)
    grads = ({p: eager['state'][m1[p]].float() for p in params}
             if form == 'weighted' else None)
    out = check_x1(label, eager, captured, saved, params,
                   device_segments(tr.main), form, grads, eager2)
    log('%s: op by op %.3f ms a step (%d timed steps), device %s ms, busy '
        '%s, peak %.2f GB; captured %.3f ms, device %s ms, busy %s, peak '
        '%.2f GB' % (label, eager['ms'], X_TIMED_STEPS,
                     _fmt_ms(eager['device_ms'] or None),
                     _fmt_busy(eager['busy']), eager['peak_gb'],
                     captured['ms'], _fmt_ms(captured['device_ms'] or None),
                     _fmt_busy(captured['busy']), captured['peak_gb']))
    return dict(loss_diff=out[0], updates=out[1], bits=out[2],
                eager_ms=eager['ms'], captured_ms=captured['ms'],
                eager_busy=eager['busy'], captured_busy=captured['busy'])


def check_decode_stats(stats):
    """After a generation loop on a new decode predictor: the JAX
    package's own numbers (tests/test_serving.py:197-200)."""
    want = {'prepared_programs': 2, 'compiled_segments': 2,
            'segment_misses': 2}
    got = {k: stats[k] for k in want}
    if got != want or stats['segment_hits'] < 1:
        raise AssertionError('decode predictor stats %r, want %r and '
                             'segment_hits >= 1' % (stats, want))


@phase('x2: the serving path captured vs eager; the decode predictor\'s '
       'stats')
def check_serving_capture(dec, prompts, streams, sync, captured_ms):
    """The prefill and decode programs' first (eager) runs under
    no_host_sync, on feeds already on the card; a generation loop's
    jit_cache_stats (check_decode_stats); the engine's streams with
    every op run eagerly equal c3's captured streams exactly; the eager
    prefill and decode step by the host clock beside f's captured ones."""
    import functools
    import torch
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.executor import Executor
    fresh = dec.clone()
    dev = fresh.device
    tokens, pos, slots = fresh._pad_prompts([prompts[0]], [0])
    feeds = [({'prefill_tokens': torch.from_numpy(tokens).to(dev),
               'prefill_pos': torch.from_numpy(pos).to(dev),
               'prefill_slots': torch.from_numpy(slots).to(dev)},
              fresh._pair.prefill_program, fresh._pair.prefill_fetches),
             ({'decode_tokens': torch.ones((fresh.slots, 1, 1),
                                           dtype=torch.int64, device=dev),
               'decode_step_idx': torch.full((fresh.slots,), len(prompts[0]),
                                             dtype=torch.int32, device=dev)},
              fresh._pair.decode_program, fresh._pair.decode_fetches)]
    sync()
    with no_host_sync():
        for feed, program, fetches in feeds:
            fresh._exe.run(program, feed=feed, fetch_list=fetches,
                           scope=fresh._scope, return_numpy=False)
    del fresh
    gen = dec.clone()
    for p in prompts[:2]:
        gen.generate(p, 8)
    stats = gen.jit_cache_stats()
    log('decode predictor after two generations: %s' % json.dumps(stats))
    check_decode_stats(stats)
    del gen
    eager = dec.clone()
    eager._exe.run = functools.partial(Executor.run, eager._exe,
                                       use_program_cache=False)
    with fluid.serving.LMServer(eager) as srv:
        handles = [srv.submit(p, max_new_tokens=NEW_TOKENS)
                   for p in prompts]
        eager_streams = [srv.result(h, timeout=600) for h in handles]
    differ = [i for i, (a, b) in enumerate(zip(streams, eager_streams))
              if a != b]
    log('engine streams captured vs eager: %d of %d equal'
        % (len(prompts) - len(differ), len(prompts)))
    if differ:
        raise AssertionError('requests %s: the captured engine\'s stream '
                             'differs from the eager engine\'s' % differ)
    prefill_ms, step_ms = _time_path(eager, prompts, sync)
    _profile_path(eager, prompts, {'prefill': prefill_ms,
                                   'decode_step': step_ms}, sync,
                  'op by op ')
    log('op by op: prefill %.3f ms, decode step %.3f ms; captured (f): '
        'prefill %.3f ms, decode step %.3f ms'
        % (prefill_ms, step_ms, captured_ms['prefill'],
           captured_ms['decode_step']))
    return dict(stats=stats, eager_prefill_ms=prefill_ms,
                eager_step_ms=step_ms)


def check_arm_launches(kvmajor, split, layers):
    """One step each: K2 `layers` times under kvmajor and never under
    split, K3a and K3b `layers` times each under split and never under
    kvmajor."""
    k2, k3a, k3b = (KERNELS[k][0] for k in ('k2', 'k3a', 'k3b'))
    want_kv = {k2: layers, k3a: 0, k3b: 0}
    want_split = {k2: 0, k3a: layers, k3b: layers}
    if {k: kvmajor[k] for k in want_kv} != want_kv or \
            {k: split[k] for k in want_split} != want_split:
        raise AssertionError('arm launches kvmajor %r, split %r; want %r and '
                             '%r' % (kvmajor, split, want_kv, want_split))


def check_replaced_weight(captured, eager, before):
    """The loss of the captured step after Scope.set_var replaced a
    weight is the eager step's with the new weight (within
    TRAIN_LOSS_TOL) and nearer to it than to the step with the old
    weight: the graph read the new one."""
    if not abs(captured - eager) <= TRAIN_LOSS_TOL or \
            not abs(captured - eager) < abs(captured - before):
        raise AssertionError('after Scope.set_var: captured loss %.6f, eager '
                             'with the new weight %.6f, with the old %.6f'
                             % (captured, eager, before))


@phase('x3: the cache key (the flash arms), a weight replaced after the '
       'capture, a fetch kept')
def check_cache_key(tr, counters, place, sync):
    """On a new ParallelExecutor over the flagship LM's program: a step
    under PADDLE_FLASH_BWD=kvmajor and then under split, each the third
    run of its prepared program (replayed): K2 in the first, K3a + K3b in
    the second, two prepared programs (check_arm_launches). Then a
    weight replaced with Scope.set_var after the capture: the next
    (replayed) step equals an eager step with the new weight
    (check_replaced_weight). Then a fetch returned with
    return_numpy=False is the same after the next run."""
    import torch
    import paddle_tpu_torch as fluid
    rng = np.random.RandomState(SEED + 12)
    batch = tr.batch_of(rng)
    saved = tr.snapshot()
    pe = fluid.ParallelExecutor(use_cuda=True, loss_name=tr.avg_cost.name,
                                main_program=tr.main, scope=tr.scope)
    loss_name = tr.avg_cost.name

    def replayed_step(fetches=(loss_name,), return_numpy=True):
        out = None
        for _ in range(3):         # warm-up, capture, replay
            tr.restore(saved)
            for c in counters.values():
                c.launches = 0
            out = pe.run(fetch_list=list(fetches),
                         return_numpy=return_numpy)
        return out

    def provider():
        while True:
            yield batch
    tr.feed(provider)
    launches = {}
    for arm in ('kvmajor', 'split'):
        with flash_arms(None, arm):
            replayed_step()
            launches[arm] = {n: c.launches for n, c in counters.items()}
    log('one replayed step under kvmajor: %s; under split: %s; prepared '
        'programs %d' % (json.dumps(launches['kvmajor']),
                         json.dumps(launches['split']),
                         pe.jit_cache_stats()['prepared_programs']))
    check_arm_launches(launches['kvmajor'], launches['split'],
                       tr.cfg.layers)
    if pe.jit_cache_stats()['prepared_programs'] != 2:
        raise AssertionError('want a prepared program for each arm, got %r'
                             % pe.jit_cache_stats())
    name = PARAMS_COMPARED[0]
    with flash_arms(None, 'split'):
        before = float(replayed_step()[0])
        new_w = saved[name] * 0.5
        tr.restore(saved)
        tr.scope.set_var(name, new_w.clone())
        captured = float(pe.run(fetch_list=[loss_name])[0])
        tr.restore(saved)
        tr.scope.set_var(name, new_w.clone())
        eager = float(fluid.Executor(place).run(
            tr.main, fetch_list=[loss_name], scope=tr.scope,
            use_program_cache=False)[0])
    log('after Scope.set_var(%r, w / 2): captured step loss %.6f, eager '
        'step %.6f, the step with the old weight %.6f'
        % (name, captured, eager, before))
    check_replaced_weight(captured, eager, before)
    tr.scope.set_var(name, saved[name].clone())
    out = replayed_step((loss_name, name), return_numpy=False)
    kept = [t.clone() for t in out]
    pe.run(fetch_list=[loss_name, name], return_numpy=False)
    sync()
    if not all(torch.equal(a, b) for a, b in zip(out, kept)):
        raise AssertionError('a fetch returned with return_numpy=False '
                             'changed in the next run')
    log('fetches returned with return_numpy=False (the loss and %s) are '
        'unchanged by the next run' % name)
    tr.reader.reset()
    tr.restore(saved)
    return launches


def check_remat(runs, layers):
    """x4's bounds: under each policy K1 launches layers (None) or 2 x
    layers (a remat scope runs its forward again in the backward) per
    step and K2 layers; 'nothing' and 'dots' hold every loss within
    TRAIN_LOSS_TOL and each compared update within TRAIN_UPDATE_TOL (t2's
    measure) of remat=None's."""
    k1, k2 = KERNELS['fwd'][0], KERNELS['k2'][0]
    base = runs[None]
    for policy, run in runs.items():
        want = layers * (1 if policy is None else 2)
        if run['per_step'][k1] != want or run['per_step'][k2] != layers:
            raise AssertionError('remat=%r: K1 %r and K2 %r launches per '
                                 'step, want %d and %d'
                                 % (policy, run['per_step'][k1],
                                    run['per_step'][k2], want, layers))
        if policy is None:
            continue
        loss_diff = max(abs(a - b) for a, b in zip(run['losses'],
                                                   base['losses']))
        upd = _update_diffs((0, run['updates']), (0, base['updates']),
                            PARAMS_COMPARED)
        run['loss_diff'], run['update_diffs'] = loss_diff, upd
        if not all(np.isfinite(run['losses'])) or \
                loss_diff > TRAIN_LOSS_TOL or \
                any(v > TRAIN_UPDATE_TOL for v in upd.values()):
            raise AssertionError('remat=%r vs None: loss |diff| %.3e, '
                                 'updates %r beyond the stated tolerance'
                                 % (policy, loss_diff, upd))


def remat_dropout_program(fluid):
    """test_recompute.py:52's program: a dropout and a 1-output fc in
    one remat scope, SGD(0): (the program, its startup, the dropout's
    output h, the fc's weight grad name)."""
    prog, startup = fluid.Program(), fluid.Program()
    prog.random_seed = startup.random_seed = SEED
    with fluid.unique_name.guard(), fluid.program_guard(prog, startup):
        x = fluid.layers.data(name='x', shape=[REMAT_DROPOUT_WIDTH],
                              dtype='float32')

        def body(xv):
            h = fluid.layers.dropout(xv, dropout_prob=0.5)
            return [h, fluid.layers.fc(input=h, size=1, name='w',
                                       bias_attr=False)]
        h, y = fluid.layers.recompute(body, x)
        fluid.optimizer.SGD(0.0).minimize(fluid.layers.mean(y))
    return prog, startup, h, 'w.w_0@GRAD'


def check_remat_dropout(fluid, place, runs=4):
    """remat_dropout_program run `runs` times through one executor (on
    the card: the warm-up, the capture, then replays): in every run dL/dw,
    which the recompute computes, is the batch mean of h, which the
    forward drew (the same mask in both, within REMAT_DROPOUT_RTOL), and
    the mask is new in every run. Returns the masks' kept shares."""
    prog, startup, h, grad = remat_dropout_program(fluid)
    scope = fluid.Scope()
    exe = fluid.Executor(place)
    exe.run(startup, scope=scope)
    xv = np.random.RandomState(SEED).rand(
        64, REMAT_DROPOUT_WIDTH).astype('float32') + 0.5
    shares, masks = [], []
    for _ in range(runs):
        hv, g = exe.run(prog, feed={'x': xv}, fetch_list=[h, grad],
                        scope=scope)
        np.testing.assert_allclose(g.ravel(), hv.mean(0),
                                   rtol=REMAT_DROPOUT_RTOL)
        masks.append(hv != 0)
        shares.append(float(masks[-1].mean()))
    if not all(0.4 < k < 0.6 for k in shares) or \
            any((a == b).all() for a, b in zip(masks, masks[1:])):
        raise AssertionError('dropout in the remat scope: kept shares %r, '
                             'or a mask repeated between runs' % shares)
    return shares, exe.jit_cache_stats()


def check_seeded_dropout(fluid, place, runs=4):
    """A dropout with its own seed attr (DROPOUT_OP_SEED) run `runs`
    times through one executor (on the card: the warm-up, the capture,
    then replays) and once op by op: the seed promises the same mask
    every time. Returns the kept share and the executor's stats."""
    prog = fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(prog,
                                                        fluid.Program()):
        x = fluid.layers.data(name='x', shape=[REMAT_DROPOUT_WIDTH],
                              dtype='float32')
        h = fluid.layers.dropout(x, dropout_prob=0.5, seed=DROPOUT_OP_SEED)
    feed = {'x': np.ones((64, REMAT_DROPOUT_WIDTH), 'float32')}
    exe = fluid.Executor(place)
    masks = [exe.run(prog, feed=feed, fetch_list=[h])[0] != 0
             for _ in range(runs)]
    masks.append(fluid.Executor(place).run(
        prog, feed=feed, fetch_list=[h], use_program_cache=False)[0] != 0)
    share = float(masks[0].mean())
    if not 0.4 < share < 0.6 or \
            any(not np.array_equal(m, masks[0]) for m in masks[1:]):
        raise AssertionError('a dropout with seed %d: kept share %.4f, or '
                             'not the same mask in each of %d runs and op '
                             'by op' % (DROPOUT_OP_SEED, share, runs))
    return share, exe.jit_cache_stats()


@phase('x4: the flagship LM with remat None, nothing and dots (captured)')
def remat_steps(place, counters, sync):
    """The flagship LM (AMP Momentum, batch TRAIN_BATCH, py_reader) built
    with TransformerConfig(remat=policy) for each of REMAT_POLICIES, from
    the same initial weights and batches: WARMUP_STEPS + X_TIMED_STEPS
    steps each through ParallelExecutor (captured), the launches per
    timed step, the timed ms per step and the peak device memory of all
    of its steps; check_remat. Each trainer is freed before the next."""
    import gc
    import torch
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models.transformer import TransformerConfig
    shares, stats = check_remat_dropout(fluid, place)
    log('dropout in a remat scope, 4 runs (eager, captured, replayed): the '
        'recompute\'s grad is the forward\'s masked batch mean in every '
        'run (rtol %g), kept shares %s, executor stats %s'
        % (REMAT_DROPOUT_RTOL, ', '.join('%.4f' % k for k in shares),
           json.dumps(stats)))
    if stats['compiled_segments'] != 1:
        raise AssertionError('the dropout program was not captured: %r'
                             % stats)
    share, stats = check_seeded_dropout(fluid, place)
    log('dropout with seed %d, 4 runs (eager, captured, replayed) and op '
        'by op: the same mask each time, kept share %.4f, executor stats %s'
        % (DROPOUT_OP_SEED, share, json.dumps(stats)))
    if stats['compiled_segments'] != 1:
        raise AssertionError('the seeded dropout program was not captured: '
                             '%r' % stats)
    rng = np.random.RandomState(SEED + 13)
    runs, init, batches = {}, None, None
    for policy in REMAT_POLICIES:
        tr = LMRun(TransformerConfig(remat=policy, **MODEL), place,
                     TRAIN_BATCH, HEAD_CHUNK, 'remat_reader')
        params = [v.name for v in tr.main.list_vars()
                  if getattr(v, 'trainable', False) and v.persistable]
        if init is None:
            init = {n: tr.scope.find_var(n).clone() for n in params}
            batches = [tr.batch_of(rng) for _ in range(WARMUP_STEPS +
                                                       X_TIMED_STEPS)]
        for n in params:
            tr.scope.find_var(n).copy_(init[n])
        saved = {n: init[n] for n in PARAMS_COMPARED}
        tr.feed(lambda: iter(batches))
        gc.collect()
        torch.cuda.empty_cache()
        sync()
        torch.cuda.reset_peak_memory_stats()
        losses = [tr.step() for _ in range(WARMUP_STEPS)]
        sync()
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        losses += [tr.step() for _ in range(X_TIMED_STEPS)]
        sync()
        ms = (time.perf_counter() - t0) / X_TIMED_STEPS * 1e3
        peak_gb = peak_memory_gb()
        per_step = {n: c.launches / X_TIMED_STEPS
                    for n, c in counters.items()}
        updates = {n: (tr.scope.find_var(n) - saved[n]).float()
                   for n in PARAMS_COMPARED}
        n_remat = sum(op.type == 'remat_block'
                      for op in tr.main.global_block().ops)
        log('remat=%r: %d remat scopes, %d ops; losses %s; %.3f ms a step, '
            'peak device memory %.2f GB; launches per step %s'
            % (policy, n_remat, len(tr.main.global_block().ops),
               ', '.join('%.6f' % x for x in losses), ms, peak_gb,
               json.dumps(per_step)))
        runs[policy] = dict(losses=losses, ms=ms, peak_gb=peak_gb,
                            per_step=per_step, updates=updates)
        tr.reader.reset()
        del tr, saved
        gc.collect()
        torch.cuda.empty_cache()
    check_remat(runs, MODEL['layers'])
    for policy in REMAT_POLICIES[1:]:
        log('remat=%r vs None: loss max |diff| %.3e (tol %g), updates %s '
            '(tol %g)' % (policy, runs[policy]['loss_diff'], TRAIN_LOSS_TOL,
                          ', '.join('%s %.3e' % kv for kv in
                                    runs[policy]['update_diffs'].items()),
                          TRAIN_UPDATE_TOL))
    peaks = [runs[p]['peak_gb'] for p in REMAT_POLICIES]
    log('peak device memory None %.2f, nothing %.2f, dots %.2f GB: %s'
        % (peaks[0], peaks[1], peaks[2],
           'nothing < dots < None, as expected'
           if peaks[1] < peaks[2] < peaks[0] else
           'NOT in the expected order nothing < dots < None'))
    return runs


def check_second_shape_runs(runs, params, n_segments, stats0, stats,
                            reserved_gb):
    """x5's bounds over its runs ({label: (loss, {param: update})}): the
    second batch's replay ('small replayed') and its capture run
    ('small captured') within TRAIN_LOSS_TOL and TRAIN_UPDATE_TOL (t2's
    measure) of its op-by-op step, the first batch's replay after that
    capture ('big again') of its replay before it ('big'); one prepared
    program, n_segments more captures, and the reserved peak within
    RESNET_PEAK_GB. Returns {pair: (loss |diff|, worst update measure,
    same bits)}."""
    out = {}
    for a, b in (('small replayed', 'small op by op'),
                 ('small captured', 'small op by op'),
                 ('big again', 'big')):
        loss_diff = abs(runs[a][0] - runs[b][0])
        upd = _update_diffs(runs[a], runs[b], params)
        bits = runs[a][0] == runs[b][0] and all(
            bool((runs[a][1][n] == runs[b][1][n]).all()) for n in params)
        out['%s vs %s' % (a, b)] = (loss_diff, max(upd.values()), bits)
        if not np.isfinite(runs[a][0]) or loss_diff > TRAIN_LOSS_TOL or \
                any(v > TRAIN_UPDATE_TOL for v in upd.values()):
            raise AssertionError('x5: %s vs %s: loss |diff| %.3e, updates '
                                 '%r beyond the stated tolerance'
                                 % (a, b, loss_diff, upd))
    if stats['prepared_programs'] != stats0['prepared_programs'] or \
            stats['compiled_segments'] != \
            stats0['compiled_segments'] + n_segments:
        raise AssertionError('x5: stats %r after %r: want the same prepared '
                             'programs and %d more captured segments'
                             % (stats, stats0, n_segments))
    if reserved_gb > RESNET_PEAK_GB:
        raise AssertionError('x5: peak reserved device memory %.2f GB over '
                             '%g GB' % (reserved_gb, RESNET_PEAK_GB))
    return out


@phase('x5: a second batch size of ResNet-50 on the captured executor')
def check_second_shape(tr, place, sync):
    """tr's executor holds r1's step at RESNET_BATCH, captured. Each from
    one saved state, through that executor and its reader: the step at
    RESNET_BATCH (a replay); RESNET_SECOND_BATCH three times (its
    warm-up, its capture in the executor's one pool beside the first
    graph, a replay); the smaller step op by op; RESNET_BATCH's replay
    again. check_second_shape_runs holds them."""
    import itertools
    import torch
    import paddle_tpu_torch as fluid
    params = RESNET_PARAMS_COMPARED
    rng = np.random.RandomState(SEED + 17)
    dev = torch.device('cuda', 0)
    big = image_batch(rng, RESNET_BATCH, dev)
    small = image_batch(rng, RESNET_SECOND_BATCH, dev)
    saved = tr.snapshot()
    eager_exe = fluid.Executor(place)

    def op_by_op():
        return float(eager_exe.run(tr.main, fetch_list=[tr.avg_cost.name],
                                   scope=tr.scope,
                                   use_program_cache=False)[0])

    def from_saved(batch, step=tr.step):
        tr.restore(saved)
        tr.feed(lambda: itertools.repeat(batch))
        loss = step()
        sync()
        tr.reader.reset()
        return loss, {n: (tr.scope.find_var(n) - saved[n]).float()
                      for n in params}
    stats0 = tr.pe.jit_cache_stats()
    torch.cuda.reset_peak_memory_stats()
    runs = {'big': from_saved(big)}
    from_saved(small)
    runs['small captured'] = from_saved(small)
    runs['small replayed'] = from_saved(small)
    runs['small op by op'] = from_saved(small, op_by_op)
    runs['big again'] = from_saved(big)
    tr.restore(saved)
    stats = tr.pe.jit_cache_stats()
    reserved_gb = torch.cuda.max_memory_reserved() / 1e9
    log('batch %d then %d on one executor: losses %s; stats %s after %s; '
        'peak device memory reserved %.2f GB'
        % (RESNET_BATCH, RESNET_SECOND_BATCH,
           ', '.join('%s %.6f' % (k, v[0]) for k, v in runs.items()),
           json.dumps(stats), json.dumps(stats0), reserved_gb))
    out = check_second_shape_runs(runs, params, device_segments(tr.main),
                                  stats0, stats, reserved_gb)
    log('x5: %s' % '; '.join('%s: loss |diff| %.3e, updates within %.3e, '
                             'the same bits %s' % ((k,) + v)
                             for k, v in out.items()))
    return out


# -- (tr1)-(tr4): the high-level Trainer and Inferencer ----------------------

# tr1-tr4 and o1 train MODEL at full width cut to 4 layers: the script
# keeps under its 1200 s with the mesh phases (PERF.md §6)
TR_MODEL = dict(MODEL, layers=4)
TR_STEPS = 8                 # one epoch of tr1-tr3 and o1
TR_INTERVAL = 4              # a checkpoint after steps 3 and 7
TR_KEEP = 2                  # CheckpointConfig(max_num_checkpoints=)
TR_KILL_AFTER = 5            # tr2: the killed run's last step
TR_NAN_STEP = 5              # tr3: one weight NaN-poisoned before this step
TR_NAN_PARAM = 'layer0_qkv.w_0'
TR_RETRY_CALL = 2            # tr3: the 2nd step-hook call (step 1) fails
TR_TIMED_FROM = 2            # steps 0 and 1 are the warm-up and the capture
TR_TEST_BATCHES = 2          # tr4
TR4_TOL = 1e-5               # tr4: the Inferencer vs the fp32 test program
COST_FLOPS_RTOL = 0.10       # o1: cost_flops vs bench.py's count
SLO_CHECK_SECS = 0.1         # o2: the watchdog's period
O2_RULES = [
    {'name': 'ttft_p95', 'metric': 'serving.ttft', 'kind': 'p95_max',
     'threshold': 10.0},
    {'name': 'tokens_floor', 'metric': 'serving.tokens_generated',
     'kind': 'rate_min', 'threshold': 1e9}]
O2_BREACHING = {'tokens_floor'}


def lm_train_func(cfg, fluid):
    """fluid.Trainer's train_func for the flagship LM step as bench.py's
    _bench_lm builds it (trunk, fused LM head with HEAD_CHUNK, mean), fed
    through layers.data: tokens and labels [-1, T, 1] int64."""
    from paddle_tpu_torch.models import transformer as tfm

    def train_func():
        fluid.default_main_program().random_seed = SEED
        fluid.default_startup_program().random_seed = SEED
        tokens = fluid.layers.data(name='tokens', shape=[cfg.max_len, 1],
                                   dtype='int64')
        labels = fluid.layers.data(name='labels', shape=[cfg.max_len, 1],
                                   dtype='int64')
        trunk = tfm.language_model_trunk(tokens, cfg)
        cost = fluid.layers.fused_softmax_cross_entropy(
            trunk, labels, cfg.vocab, chunk=HEAD_CHUNK, name='lm_head')
        return fluid.layers.mean(cost)
    return train_func


def lm_optimizer_func(fluid):
    return lambda: fluid.contrib.mixed_precision.decorate(
        fluid.optimizer.Momentum(learning_rate=0.001, momentum=0.9))


def tr_batches(cfg, batch, n=TR_STEPS, seed=SEED + 20):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        toks = rng.randint(0, cfg.vocab, size=(batch, cfg.max_len, 1)) \
            .astype('int64')
        out.append([toks, np.roll(toks, -1, axis=1)])
    return out


class _Killed(Exception):
    """A run stopped on purpose after a step (a kill)."""


def _median(xs):
    return float(np.median(xs)) if xs else float('nan')


def run_trainer(cfg, batches, counters, place=None, ckpt_dir=None,
                epoch_interval=1, kill_after=None, on_begin=None):
    """One fluid.Trainer life over one epoch of `batches` (a fresh name
    generator and executor, as a restarted process has). Returns a dict:
    the trainer, its loss and wall ms for each step, the per-step kernel
    launches, the FaultEvents as (action, step, attempt), every
    checkpoint save as (step, ms, bytes), and whether it resumed."""
    import paddle_tpu_torch as fluid
    cfg_ck = None
    if ckpt_dir is not None:
        cfg_ck = fluid.CheckpointConfig(
            checkpoint_dir=ckpt_dir, step_interval=TR_INTERVAL,
            max_num_checkpoints=TR_KEEP, epoch_interval=epoch_interval)
    with fluid.unique_name.guard():
        tr = fluid.Trainer(lm_train_func(cfg, fluid),
                           lm_optimizer_func(fluid), place=place,
                           checkpoint_config=cfg_ck)
    out = {'trainer': tr, 'losses': {}, 'ms': {}, 'launches': {},
           'faults': [], 'saves': [], 'resumed': tr._resumed,
           'start': tr.step_id}
    save = tr._save_checkpoint

    def timed_save(epoch_id, step_id):
        t0 = time.perf_counter()
        save(epoch_id, step_id)
        ms = (time.perf_counter() - t0) * 1e3
        newest = max((d for d in os.listdir(ckpt_dir)
                      if d.split('_')[-1].isdigit()),
                     key=lambda d: int(d.split('_')[-1]))
        path = os.path.join(ckpt_dir, newest)
        size = sum(os.path.getsize(os.path.join(path, f))
                   for f in os.listdir(path))
        out['saves'].append((step_id, ms, size))
    tr._save_checkpoint = timed_save
    state = {}

    def handler(event):
        if isinstance(event, fluid.BeginStepEvent):
            if on_begin is not None:
                on_begin(tr, event)
            state['counts'] = {n: c.launches for n, c in counters.items()}
            state['t0'] = time.perf_counter()
        elif isinstance(event, fluid.EndStepEvent):
            out['ms'][event.step] = (time.perf_counter() - state['t0']) * 1e3
            out['losses'][event.step] = float(np.asarray(event.metrics[0]))
            out['launches'][event.step] = {
                n: c.launches - state['counts'][n]
                for n, c in counters.items()}
            if kill_after is not None and event.step == kill_after:
                raise _Killed()
        elif isinstance(event, fluid.FaultEvent):
            out['faults'].append((event.action, event.step, event.attempt))
    try:
        tr.train(num_epochs=1, event_handler=handler, reader=lambda: iter(
            batches), feed_order=['tokens', 'labels'])
    except _Killed:
        pass
    return out


def free_trainer(run):
    """Close the Trainer's executor (its captured graphs and their pool)
    and drop its scope before the next Trainer."""
    tr = run.pop('trainer')
    tr.exe.close()
    del tr
    free_device_memory()


def timed_ms(run):
    """Median wall ms of a run's replayed steps."""
    return _median([ms for s, ms in run['ms'].items() if s >= TR_TIMED_FROM])


def checkpoint_bytes(program, scope):
    """Bytes of the tensors a checkpoint of `program`'s persistables in
    `scope` writes."""
    from paddle_tpu_torch import io as fio
    total = 0
    for v in program.list_vars():
        t = scope.find_var(v.name)
        if fio.is_persistable(v) and t is not None:
            total += t.numel() * t.element_size()
    return total


def check_disk(root, nbytes, copies):
    """Room under `root` for `copies` checkpoints of `nbytes`, or fail
    stating the numbers (a full disk would fail a save mid-write)."""
    import shutil
    free = shutil.disk_usage(root).free
    log('checkpoint root %s: %.2f GB free for %d checkpoints of %.2f GB'
        % (root, free / 1e9, copies, nbytes / 1e9))
    if free < copies * nbytes:
        raise AssertionError(
            'checkpoint root %s has %d bytes free, fewer than %d checkpoints '
            'of %d bytes' % (root, free, copies, nbytes))


def check_step_launches(label, run, layers, kinds):
    """Every step of `run` launched each of `kinds` exactly `layers`
    times and nothing else of the flash family."""
    for step, got in sorted(run['launches'].items()):
        want = {n: (layers if n in kinds else 0) for n in got}
        if got != want:
            raise AssertionError('%s step %d launched %r, want %r'
                                 % (label, step, got, want))


def same_bits(label, got, want, steps):
    """The losses of `steps` are the same floats in both runs."""
    bad = [(s, got.get(s), want.get(s)) for s in steps
           if got.get(s) != want.get(s)]
    if bad:
        raise AssertionError('%s: losses differ from the uninterrupted run '
                             'at (step, got, want) %r' % (label, bad))


@phase('tr1: fluid.Trainer, 8 steps with checkpoints, vs a bare Executor '
       'loop')
def trainer_steps(cfg, place, counters, ckpt_root, sync):
    """fluid.Trainer over TR_STEPS batches under CheckpointConfig(
    step_interval=TR_INTERVAL, max_num_checkpoints=TR_KEEP): K1 and K2
    TRAIN-layers launches every step and no plain flash call; its
    losses within TRAIN_LOSS_TOL of a bare Executor loop's over the same
    batches from the same seeded state; step ms beside the loop's, save
    ms and bytes, peak memory."""
    import torch
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.kernels import flash_attention as fa
    batches = tr_batches(cfg, TRAIN_BATCH)
    # the bare loop: the same program, startup and batches on an Executor
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        loss = lm_train_func(cfg, fluid)()
        lm_optimizer_func(fluid)().minimize(loss)
    scope, exe = fluid.Scope(), fluid.Executor(place)
    exe.run(startup, scope=scope)
    # a new checkpoint is written before the oldest is pruned
    check_disk(ckpt_root, checkpoint_bytes(main, scope), TR_KEEP + 1)
    bare, bare_ms = [], []
    for toks, labels in batches:
        t0 = time.perf_counter()
        bare.append(float(exe.run(main, feed={'tokens': toks,
                                              'labels': labels},
                                  fetch_list=[loss], scope=scope)[0]))
        bare_ms.append((time.perf_counter() - t0) * 1e3)
    exe.close()
    del scope, exe
    free_device_memory()
    ckpt_dir = os.path.join(ckpt_root, 'tr1')
    torch.cuda.reset_peak_memory_stats()
    fa.FlashAttention.plain_cuda_calls = 0
    run = run_trainer(cfg, batches, counters, ckpt_dir=ckpt_dir)
    require_no_plain(fa, 'tr1')
    peak_gb = peak_memory_gb()
    check_step_launches('tr1', run, cfg.layers,
                        ('flash_attention_fwd',
                         'flash_attention_bwd_kvmajor'))
    losses = [run['losses'][s] for s in range(TR_STEPS)]
    diffs = [abs(a - b) for a, b in zip(losses, bare)]
    ms, loop_ms = timed_ms(run), _median(bare_ms[TR_TIMED_FROM:])
    log('tr1 losses: %s' % ', '.join('%.6f' % x for x in losses))
    log('tr1: Trainer step %.3f ms, bare Executor loop %.3f ms (medians of '
        'steps %d-%d); loss |diff| vs the loop max %.3e (tol %g); saves '
        '(after step, ms, bytes): %s; peak %.2f GB'
        % (ms, loop_ms, TR_TIMED_FROM, TR_STEPS - 1, max(diffs),
           TRAIN_LOSS_TOL, run['saves'], peak_gb))
    if not (np.isfinite(losses).all() and max(diffs) <= TRAIN_LOSS_TOL):
        raise AssertionError('the Trainer\'s losses %r are not the bare '
                             'loop\'s %r within %g'
                             % (losses, bare, TRAIN_LOSS_TOL))
    if [s for s, _, _ in run['saves']] != [TR_INTERVAL - 1, TR_STEPS - 1,
                                           -1]:
        raise AssertionError('checkpoints after steps %r' % run['saves'])
    kept = sorted(os.listdir(ckpt_dir))
    if len(kept) != TR_KEEP:
        raise AssertionError('%d checkpoints kept, want %d: %r'
                             % (len(kept), TR_KEEP, kept))
    free_trainer(run)
    return {'ms': ms, 'loop_ms': loop_ms, 'loss_diff': max(diffs),
            'saves': run['saves'], 'peak_gb': peak_gb, 'losses': losses}


def _flip_byte(path):
    with open(path, 'r+b') as f:
        f.seek(os.path.getsize(path) // 2)
        b = f.read(1)
        f.seek(-1, 1)
        f.write(bytes([b[0] ^ 0xFF]))


@phase('tr2: exact resume under the split arm; a corrupt checkpoint')
def trainer_resume(cfg, place, counters, ckpt_root, sync):
    """Under PADDLE_FLASH_BWD=split (deterministic): an uninterrupted
    run; a run killed after step TR_KILL_AFTER with a checkpoint after
    step TR_INTERVAL - 1; a fresh Trainer and executor resuming it:
    steps TR_INTERVAL..TR_STEPS-1 the same bits as the uninterrupted
    run's. Then one byte of the newest checkpoint flipped: a fresh
    Trainer quarantines it and resumes from the one before."""
    batches = tr_batches(cfg, TRAIN_BATCH)
    ckpt_dir = os.path.join(ckpt_root, 'tr2')
    kinds = ('flash_attention_fwd', 'flash_attention_bwd_dq',
             'flash_attention_bwd_dkv')
    with flash_arms(None, 'split'):
        full = run_trainer(cfg, batches, counters, place=place)
        if place.device.type == 'cuda':
            check_step_launches('tr2', full, cfg.layers, kinds)
        free_trainer(full)
        killed = run_trainer(cfg, batches, counters, place=place,
                             ckpt_dir=ckpt_dir, epoch_interval=2,
                             kill_after=TR_KILL_AFTER)
        free_trainer(killed)
        same_bits('tr2 killed run', killed['losses'], full['losses'],
                  range(TR_KILL_AFTER + 1))
        resumed = run_trainer(cfg, batches, counters, place=place,
                              ckpt_dir=ckpt_dir, epoch_interval=2)
        free_trainer(resumed)
    if not resumed['resumed'] or resumed['start'] != TR_INTERVAL:
        raise AssertionError('resumed %r at step %d, want step %d'
                             % (resumed['resumed'], resumed['start'],
                                TR_INTERVAL))
    same_bits('tr2 resumed run', resumed['losses'], full['losses'],
              range(TR_INTERVAL, TR_STEPS))
    dirs = sorted(os.listdir(ckpt_dir), key=lambda d: int(d.split('_')[-1]))
    newest = os.path.join(ckpt_dir, dirs[-1])
    with open(os.path.join(newest, 'CHECKPOINT_DIGESTS')) as f:
        victim = max(json.load(f).items(), key=lambda kv: kv[1][1])[0]
    _flip_byte(os.path.join(newest, victim))
    import paddle_tpu_torch as fluid
    with fluid.unique_name.guard():
        tr = fluid.Trainer(lm_train_func(cfg, fluid),
                           lm_optimizer_func(fluid), place=place,
                           checkpoint_config=fluid.CheckpointConfig(
                               checkpoint_dir=ckpt_dir))
    fallback = (tr._resumed, tr.step_id)
    free_trainer({'trainer': tr})
    log('tr2: %d steps uninterrupted, killed after step %d, resumed at step '
        '%d: steps %d-%d the same bits; saves (after step, ms, bytes) %s; '
        'one byte of %s/%s flipped: quarantined %s, resumed %s at step %d'
        % (TR_STEPS, TR_KILL_AFTER, resumed['start'], TR_INTERVAL,
           TR_STEPS - 1, killed['saves'] + resumed['saves'], dirs[-1], victim,
           os.path.exists(newest + '.corrupt'), fallback[0], fallback[1]))
    if not os.path.exists(newest + '.corrupt') or os.path.exists(newest) \
            or fallback != (True, TR_INTERVAL):
        raise AssertionError('the corrupt checkpoint was not quarantined '
                             'with a fall back to step %d: %r'
                             % (TR_INTERVAL - 1, fallback))
    return {'losses': full['losses'], 'ms': timed_ms(full),
            'saves': killed['saves'] + resumed['saves']}


@phase('tr3: the anomaly guard rolls back to the same bits; a step retry')
def trainer_faults(cfg, place, counters, ckpt_root, obs_dir, full_losses,
                   split_ms, sync):
    """Under FLAGS_anomaly_action=rollback and PADDLE_FLASH_BWD=split,
    tr2's batches and cadence: a NaN written in place into TR_NAN_PARAM
    before step TR_NAN_STEP (once; the LM's feeds are token ids, so the
    'nan' step action would poison nothing) gives anomaly 1 and 2, then
    a rollback to the checkpoint after step TR_INTERVAL - 1, and the
    replayed steps are tr2's uninterrupted bits; a retryable 'error'
    step rule (the TR_RETRY_CALL-th step-hook call) gives one retry
    event and unchanged losses. The guard's cost: step ms against tr2's
    uninterrupted run without it. Its FaultEvents go to the trace log in
    obs_dir (o2 merges them)."""
    from paddle_tpu_torch.distributed import resilience
    from paddle_tpu_torch.obs import trace
    poisoned = []

    def poison(tr, event):
        if event.step == TR_NAN_STEP and not poisoned:
            import torch
            with torch.no_grad():
                tr.scope.find_var(TR_NAN_PARAM).view(-1)[0] = float('nan')
            poisoned.append(event.step)
    plan = resilience.FaultPlan([resilience.FaultRule(
        'step', TR_RETRY_CALL, 'error', retryable=True)])
    with flags_set({'FLAGS_anomaly_action': 'rollback',
                    'FLAGS_anomaly_skip_steps': 1}), \
            flash_arms(None, 'split'), resilience.active_plan(plan):
        trace.enable(obs_dir, role='trainer')
        try:
            run = run_trainer(cfg, tr_batches(cfg, TRAIN_BATCH), counters,
                              place=place,
                              ckpt_dir=os.path.join(ckpt_root, 'tr3'),
                              epoch_interval=2, on_begin=poison)
        finally:
            trace.disable()
    # the rollback is reported at the last step the loop finished (the
    # skipped one)
    want = [('retry', 1, 1), ('anomaly', TR_NAN_STEP, 1),
            ('anomaly', TR_NAN_STEP + 1, 2), ('rollback', TR_NAN_STEP, 1)]
    guard_ms = timed_ms(run)
    log('tr3: fault events %s; steps %s; guard on %.3f ms a step vs %.3f '
        'without it (%+.3f ms); saves %s'
        % (run['faults'], sorted(run['losses']), guard_ms, split_ms,
           guard_ms - split_ms, run['saves']))
    if run['faults'] != want:
        raise AssertionError('fault events %r, want %r'
                             % (run['faults'], want))
    same_bits('tr3', run['losses'], full_losses, range(TR_STEPS))
    return run, {'faults': run['faults'], 'ms': guard_ms,
                 'cost_ms': guard_ms - split_ms}


@phase('tr4: Trainer.test, save_inference_model, Inferencer on the card')
def trainer_test_and_infer(cfg, run, build_root, sync, place=None):
    """Trainer.test over TR_TEST_BATCHES batches on tr3's trainer; then
    save_inference_model of its loss and fluid.Inferencer(param_path) on
    its default place (the card; `place` only for a CPU rehearsal): each
    batch's output within TR4_TOL of the test
    program's run in fp32 (the saved program carries no AMP mark, as in
    the JAX package), and within TRAIN_LOSS_TOL of the AMP test
    program's."""
    import tempfile
    import paddle_tpu_torch as fluid
    tr = run['trainer']
    batches = tr_batches(cfg, TRAIN_BATCH, TR_TEST_BATCHES, seed=SEED + 21)
    t0 = time.perf_counter()
    mean = tr.test(reader=lambda: iter(batches),
                   feed_order=['tokens', 'labels'])[0]
    test_ms = (time.perf_counter() - t0) * 1e3 / TR_TEST_BATCHES
    fp32 = tr._test_program.clone()
    fp32._use_bf16 = False
    feeds = [{'tokens': t, 'labels': lb} for t, lb in batches]
    with fluid.scope_guard(tr.scope):
        amp = [float(tr.exe.run(tr._test_program, feed=f,
                                fetch_list=[tr.loss])[0]) for f in feeds]
        want = [float(tr.exe.run(fp32, feed=f, fetch_list=[tr.loss])[0])
                for f in feeds]
    with tempfile.TemporaryDirectory(dir=build_root) as model_dir:
        with fluid.scope_guard(tr.scope):
            fluid.io.save_inference_model(
                model_dir, ['tokens', 'labels'], [tr.loss], tr.exe,
                main_program=tr.train_program)
        free_trainer(run)
        inf = fluid.Inferencer(param_path=model_dir, place=place)
        got = [float(inf.infer(f)[0]) for f in feeds]
        device = inf.exe.device
        inf.exe.close()
        del inf
        free_device_memory()
    rel = max(abs(g - w) / abs(w) for g, w in zip(got, want))
    amp_diff = max(abs(g - a) for g, a in zip(got, amp))
    log('tr4: test() mean loss %.6f (%.3f ms a batch); Inferencer on %s: %s '
        'vs the fp32 test program %s (max rel %.3e, tol %g), vs the AMP one '
        '%s (max |diff| %.3e, tol %g)'
        % (mean, test_ms, device, got, want, rel, TR4_TOL, amp, amp_diff,
           TRAIN_LOSS_TOL))
    want_device = 'cuda' if place is None else place.device.type
    if device.type != want_device or \
            abs(np.mean(amp) - mean) > 1e-6 * abs(mean):
        raise AssertionError('the Inferencer ran on %s; test() %r vs %r'
                             % (device, mean, amp))
    if not (rel <= TR4_TOL and amp_diff <= TRAIN_LOSS_TOL):
        raise AssertionError('the Inferencer\'s outputs %r are not the test '
                             'program\'s %r / %r' % (got, want, amp))
    return {'mean': mean, 'rel': rel, 'amp_diff': amp_diff}


# -- (o1), (o2): the observability the Trainer and the server report into ----

def _obs_on(obs_dir, role):
    """What FLAGS_obs_dir does at import: telemetry and the trace log on,
    into obs_dir, under `role`."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.obs import telemetry, trace
    fluid.set_flags({'FLAGS_obs_dir': obs_dir, 'FLAGS_obs_role': role})
    telemetry.reset()
    telemetry.enable(obs_dir, role=role)
    trace.enable(obs_dir, role=role)


def _obs_off():
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.obs import telemetry, trace
    telemetry.flush()
    telemetry.disable(final_flush=False)
    telemetry.reset()
    trace.disable()
    fluid.set_flags({'FLAGS_obs_dir': '', 'FLAGS_obs_role': ''})


@phase('o1: perf, hbm and jit-cache telemetry of the Trainer\'s steps')
def trainer_telemetry(cfg, place, counters, obs_dir, off_ms, sync):
    """tr1's steps on a fresh Trainer under FLAGS_obs_dir: a
    perf.step_latency count equal to the steps run, perf.mfu and
    perf.achieved_tflops set, the train program's cost_flops within
    COST_FLOPS_RTOL of bench.py's count for its tokens, the hbm.* gauges
    equal to torch.cuda.memory_stats read as step_end exports them, the
    xla.jit_cache counters equal to the change in jit_cache_stats(); the
    step ms with telemetry on against tr1's (off)."""
    import torch
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.obs import perf, telemetry
    batches = tr_batches(cfg, TRAIN_BATCH)
    with fluid.unique_name.guard():
        tr = fluid.Trainer(lm_train_func(cfg, fluid),
                           lm_optimizer_func(fluid), place=place)
    _obs_on(obs_dir, 'trainer')
    stats0 = tr.exe.jit_cache_stats()
    seen = []
    export = perf.update_hbm

    def recorded(device=None, scope=None):
        export(device=device, scope=scope)
        stats = torch.cuda.memory_stats(device)
        seen.append((telemetry.snapshot()['gauges'],
                     stats['allocated_bytes.all.current'],
                     stats['allocated_bytes.all.peak'],
                     torch.cuda.mem_get_info(device)[1]))
    perf.update_hbm = recorded
    ms = {}
    try:
        def handler(event):
            if isinstance(event, fluid.BeginStepEvent):
                ms['t0'] = time.perf_counter()
            elif isinstance(event, fluid.EndStepEvent):
                ms[event.step] = (time.perf_counter() - ms['t0']) * 1e3
        tr.train(num_epochs=1, event_handler=handler,
                 reader=lambda: iter(batches),
                 feed_order=['tokens', 'labels'])
    finally:
        perf.update_hbm = export
    snap = telemetry.snapshot()
    telemetry.flush()
    stats1 = tr.exe.jit_cache_stats()
    prepared = [p for p in tr.exe._prepared_cache.values()
                if p.program is tr.train_program]
    cost = prepared[0].cost_flops if len(prepared) == 1 else float('nan')
    bench_flops = train_flops_per_token(cfg) * TRAIN_BATCH * cfg.max_len
    free_trainer({'trainer': tr})
    on_ms = _median([m for s, m in ms.items()
                     if s != 't0' and s >= TR_TIMED_FROM])
    gauges, current, peak, total = seen[-1]
    hits = stats1['segment_hits'] - stats0['segment_hits']
    misses = stats1['segment_misses'] - stats0['segment_misses']
    counts = (snap['hists']['perf.step_latency']['count'],
              snap['counters']['perf.steps'])
    log('o1: %d steps: perf.step_latency count %d, perf.steps %d; perf.mfu '
        '%.4f, perf.achieved_tflops %.2f; cost_flops %.4e vs bench.py\'s '
        '%.4e (%+.2f%%, tol %g); hbm bytes_in_use %d / peak %d / limit %d vs '
        'memory_stats %d / %d / %d; xla.jit_cache hit %d miss %d vs '
        'jit_cache_stats %d / %d; xla.compile_latency n=%d; step %.3f ms '
        'with telemetry on vs %.3f off (%+.3f ms)'
        % (TR_STEPS, counts[0], counts[1], snap['gauges']['perf.mfu'],
           snap['gauges']['perf.achieved_tflops'], cost, bench_flops,
           100 * (cost / bench_flops - 1), COST_FLOPS_RTOL,
           gauges['hbm.bytes_in_use'], gauges['hbm.peak_bytes'],
           gauges['hbm.bytes_limit'], current, peak, total,
           snap['counters']['xla.jit_cache.hit'],
           snap['counters']['xla.jit_cache.miss'], hits, misses,
           snap['hists']['xla.compile_latency']['count'], on_ms, off_ms,
           on_ms - off_ms))
    if counts != (TR_STEPS, TR_STEPS) or len(seen) != TR_STEPS:
        raise AssertionError('step counts %r and %d exports for %d steps'
                             % (counts, len(seen), TR_STEPS))
    if not (snap['gauges']['perf.mfu'] > 0
            and snap['gauges']['perf.achieved_tflops'] > 0):
        raise AssertionError('perf.mfu / perf.achieved_tflops not set')
    if not abs(cost / bench_flops - 1) <= COST_FLOPS_RTOL:
        raise AssertionError('cost_flops %r is not bench.py\'s %r within %g'
                             % (cost, bench_flops, COST_FLOPS_RTOL))
    if (gauges['hbm.bytes_in_use'], gauges['hbm.peak_bytes'],
            gauges['hbm.bytes_limit']) != (current, max(peak, current),
                                           total):
        raise AssertionError('hbm gauges %r vs memory_stats %r'
                             % (gauges, (current, peak, total)))
    if (snap['counters']['xla.jit_cache.hit'],
            snap['counters']['xla.jit_cache.miss']) != (hits, misses):
        raise AssertionError('jit cache counters vs stats %r'
                             % ((hits, misses),))
    return {'on_ms': on_ms, 'cost_rel': cost / bench_flops - 1,
            'mfu': snap['gauges']['perf.mfu'],
            'tflops': snap['gauges']['perf.achieved_tflops']}


def _events_of(obs_dir):
    out = []
    for fn in sorted(os.listdir(obs_dir)):
        if fn.startswith('events-'):
            with open(os.path.join(obs_dir, fn)) as f:
                out.extend(json.loads(line) for line in f if line.strip())
    return out


@phase('o2: the server\'s SLO watchdog; the merged report')
def serving_slo(model_dir, place, prompts, streams, obs_dir, sync):
    """LMServer answers c3's requests under FLAGS_slo_rules = O2_RULES
    (one holds, one cannot): only O2_BREACHING breaches, its slo.breach
    events are in the events log, and the streams are c3's. Then
    report.write_report merges tr3's fault events and the breaches into
    one timeline, and its rollup holds the serving.*, perf.* and
    trainer.* series."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.obs import report, slo, telemetry
    _obs_on(obs_dir, 'serving')
    try:
        with flags_set({'FLAGS_slo_rules': json.dumps(O2_RULES),
                        'FLAGS_slo_check_secs': SLO_CHECK_SECS}):
            with fluid.serving.LMServer(model_dir, place=place, slots=SLOTS,
                                        prefill_batch=PREFILL_BATCH) as srv:
                wd = srv._engine._slo
                # a rate rule is judged from its second check on
                time.sleep(3 * SLO_CHECK_SECS)
                handles = [srv.submit(p, max_new_tokens=NEW_TOKENS)
                           for p in prompts]
                got = [srv.result(h, timeout=600) for h in handles]
            released = srv._engine._slo is None
        snap = telemetry.snapshot()
    finally:
        _obs_off()
    events = _events_of(obs_dir)
    breaches = [e for e in events if e['type'] == 'slo.breach']
    breached = {e['rule'] for e in breaches}
    timeline, rollup = report.write_report(
        obs_dir, timeline_path=os.path.join(obs_dir, 'timeline.json'),
        rollup_path=os.path.join(obs_dir, 'rollup.json'))
    instants = sorted({e['name'] for e in timeline['traceEvents']
                       if e.get('ph') == 'i'})
    lanes = sorted(e['args']['name'] for e in timeline['traceEvents']
                   if e.get('ph') == 'M')
    series = sorted({n.split('.')[0] for r in rollup['roles'].values()
                     for kind in ('counters', 'gauges', 'hists')
                     for n, v in r[kind].items()
                     if (v.get('count') if kind == 'hists' else v)})
    log('o2: watchdog %s (period %g s, released at stop %s); %d slo.breach '
        'events, rules %s; slo.breaches %d; streams equal to c3\'s %d of %d; '
        'timeline: %d events, lanes %s, instants %s; rollup roles %s, '
        'nonzero series families %s'
        % (type(wd).__name__, SLO_CHECK_SECS, released, len(breaches),
           sorted(breached), snap['counters']['slo.breaches'],
           sum(a == b for a, b in zip(got, streams)), len(streams),
           len(timeline['traceEvents']), lanes, instants,
           sorted(rollup['roles']), series))
    if not isinstance(wd, slo.SLOWatchdog) or not released:
        raise AssertionError('the engine did not own and release a watchdog')
    if breached != O2_BREACHING or not snap['counters']['slo.breaches']:
        raise AssertionError('breached %r, want %r' % (breached,
                                                       O2_BREACHING))
    if got != streams:
        raise AssertionError('the watched server\'s streams are not c3\'s')
    want_instants = {'fault:retry', 'fault:anomaly', 'fault:rollback',
                     'slo.breach:'}
    if not want_instants <= set(instants) or \
            lanes != ['serving', 'trainer']:
        raise AssertionError('timeline instants %r, lanes %r' % (instants,
                                                                  lanes))
    if not {'serving', 'perf', 'trainer'} <= set(series):
        raise AssertionError('rollup series families %r' % series)
    return {'breaches': len(breaches), 'events': len(
        timeline['traceEvents']), 'series': series}


# -- (bk1)-(bk3), (mo1): the dense book chapters fed through fluid.batch +
# DataFeeder, and memory_optimize, release_memory and Print on the card ------

# bk1, bk2: image_classification's ResNet at the book's width and input
BOOK = dict(depth=32, batch=128, steps=10, hw=32, classes=10)
# resnet_cifar10(depth=32)'s 1x1 conv2d_bn ops, each of which _route
# sends to a kernel (fp32: the generic one); counted from the port's own
# program on the CPU (tests/test_torch_chip_smoke.py)
BK2_K6_PER_STEP = 2
BK3_STEPS = 5
MO1_STEPS = 3                # mo1: warm-up, capture, replay
PRINT_FIRST_N = 2
PRINT_RUNS = 4
SAVE_TOL = 1e-5              # bk3: a loaded inference program vs its source


def expected_print_text(name, arr, message=''):
    """What the JAX package's print op writes for `arr` (its io_ops.py
    _print_emit with the layer's attrs): the message, the var's name,
    shape and dtype, then np.array2string(threshold=20)."""
    lines = [message] if message else []
    lines += ['Variable: %s' % name, 'shape: %s' % (list(arr.shape),),
              'dtype: %s' % arr.dtype,
              'data: %s' % np.array2string(arr, threshold=20)]
    return '\n'.join(lines) + '\n'


def book_params_compared(program):
    """The parameters bk1, bk2 and mo1 compare, named as in the unfused
    program (bk2's fused names are mapped by op order): the stem conv's
    filter, the last 1x1 conv's (the stage-3 projection, K6's in bk2)
    and fc's weight."""
    block = program.global_block()
    filters = [op.single_input('Filter') for op in block.ops
               if op.type == 'conv2d']
    ones = [f for f in filters if tuple(block.var(f).shape[2:]) == (1, 1)]
    return (filters[0], ones[-1], 'fc_0.w_0')


def book_k6_launches(program, batch):
    """K6 launches one training step of `program` makes: its 1x1
    conv2d_bn ops (k6_path_shapes) that conv_bn._route sends to a
    kernel, in the program's dtype."""
    from paddle_tpu_torch.kernels import conv_bn as k6
    dtype = _torch_dtype('bfloat16' if program._use_bf16 else 'float32')
    return sum(n for (M, K, N), n in k6_path_shapes(program, batch).items()
               if k6._route(M, K, N, dtype) is not None)


def book_image_net(fluid, depth=None):
    """image_classification's ResNet (models.resnet.resnet_cifar10) under
    the book's Adam(0.001): (feed names, prediction, loss)."""
    from paddle_tpu_torch.models import resnet
    img = fluid.layers.data(name='pixel', shape=[3, BOOK['hw'], BOOK['hw']],
                            dtype='float32')
    lbl = fluid.layers.data(name='label', shape=[1], dtype='int64')
    pred = resnet.resnet_cifar10(img, class_dim=BOOK['classes'],
                                 depth=depth or BOOK['depth'])
    loss = fluid.layers.mean(fluid.layers.cross_entropy(input=pred,
                                                        label=lbl))
    fluid.optimizer.Adam(learning_rate=0.001).minimize(loss)
    return ['pixel', 'label'], pred, loss


def book_fit_a_line(fluid):
    x = fluid.layers.data(name='x', shape=[13], dtype='float32')
    y = fluid.layers.data(name='y', shape=[1], dtype='float32')
    pred = fluid.layers.fc(input=x, size=1, act=None)
    loss = fluid.layers.mean(fluid.layers.square_error_cost(input=pred,
                                                            label=y))
    fluid.optimizer.SGD(learning_rate=0.01).minimize(loss)
    return ['x', 'y'], pred, loss


def book_word2vec(fluid, embed=32, hidden=256, is_sparse=False, sgd_lr=None):
    """The word2vec chapter: four context words' shared embeddings,
    concatenated, a sigmoid hidden layer and a softmax over the dict;
    Adam(0.005), or the book's SGD at sgd_lr (with is_sparse, as the
    book sets it, the four lookups' grads are SelectedRows that
    backward's fan-out sum concatenates)."""
    dict_size = len(fluid.dataset.imikolov.build_dict())
    names = ['firstw', 'secondw', 'thirdw', 'forthw', 'nextw']
    words = [fluid.layers.data(name=n, shape=[1], dtype='int64')
             for n in names]
    embs = [fluid.layers.embedding(
        input=w, size=[dict_size, embed], is_sparse=is_sparse,
        param_attr=fluid.ParamAttr(name='shared_w')) for w in words[:4]]
    concat = fluid.layers.reshape(fluid.layers.concat(input=embs, axis=-1),
                                  shape=[-1, 4 * embed])
    hid = fluid.layers.fc(input=concat, size=hidden, act='sigmoid')
    pred = fluid.layers.fc(input=hid, size=dict_size, act='softmax')
    loss = fluid.layers.mean(fluid.layers.cross_entropy(input=pred,
                                                        label=words[4]))
    if sgd_lr is None:
        fluid.optimizer.Adam(learning_rate=0.005).minimize(loss)
    else:
        fluid.optimizer.SGD(learning_rate=sgd_lr).minimize(loss)
    return names, pred, loss


class BookRun(object):
    """A book chapter's program with its state on `place`, fed batches
    of `reader` through fluid.batch + DataFeeder, run by one Executor
    (its default path: eager, captured, replayed on the card)."""

    def __init__(self, place, build, reader, batch):
        import paddle_tpu_torch as fluid
        self.fluid, self.place = fluid, place
        self.main, self.startup = fluid.Program(), fluid.Program()
        self.main.random_seed = self.startup.random_seed = SEED
        with fluid.unique_name.guard(), \
                fluid.program_guard(self.main, self.startup):
            self.feed_names, self.pred, self.loss = build(fluid)
        self.scope = fluid.Scope()
        fluid.Executor(place).run(self.startup, scope=self.scope)
        self.exe = fluid.Executor(place)
        self.feeder = fluid.DataFeeder(feed_list=self.feed_names,
                                       place=place, program=self.main)
        self.batches = fluid.batch(reader, batch, drop_last=True)
        self.persistables = [v.name for v in self.main.list_vars()
                             if v.persistable and
                             self.scope.find_var(v.name) is not None]

    def feeds(self, n):
        """The first n batches through DataFeeder, and the ms one took."""
        import itertools
        t0 = time.perf_counter()
        out = [self.feeder.feed(b)
               for b in itertools.islice(self.batches(), n)]
        return out, (time.perf_counter() - t0) / max(len(out), 1) * 1e3

    def step(self, feed, eager=False):
        return float(np.asarray(self.exe.run(
            self.main, feed=feed, fetch_list=[self.loss], scope=self.scope,
            use_program_cache=not eager)[0]))

    def snapshot(self):
        return {n: self.scope.find_var(n).clone() for n in self.persistables}

    def restore(self, saved):
        for n, t in saved.items():
            self.scope.find_var(n).copy_(t)

    def fresh_executor(self):
        self.exe.close()
        self.exe = self.fluid.Executor(self.place)


def _book_run(run, saved, feeds, sync, eager, names):
    """From `saved`, one step per feed; returns the losses, the ms per
    step after the first two (the warm-up and the capture), the values
    of `names` after the steps and the peak device memory above what was
    held when the run began (after a collection): allocated (`peak_gb`,
    the caching allocator's blocks) and requested (`requested_gb`, the
    bytes the program asked for, which the allocator's history does not
    round up)."""
    import torch
    run.restore(saved)
    on_card = run.place.device.type == 'cuda'
    base = base_req = 0
    if on_card:
        sync()
        free_device_memory()
        base = torch.cuda.memory_allocated()
        base_req = torch.cuda.memory_stats().get(
            'requested_bytes.all.current', 0)
        torch.cuda.reset_peak_memory_stats()
    losses, t0 = [], None
    for i, feed in enumerate(feeds):
        if i == min(2, len(feeds) - 1):
            sync()
            t0 = time.perf_counter()
        losses.append(run.step(feed, eager=eager))
    sync()
    timed = len(feeds) - min(2, len(feeds) - 1)
    ms = (time.perf_counter() - t0) / timed * 1e3
    state = {n: run.scope.find_var(n).clone() for n in names}
    peak = req = 0.0
    if on_card:
        peak = (torch.cuda.max_memory_allocated() - base) / 1e9
        req = (torch.cuda.memory_stats()['requested_bytes.all.peak']
               - base_req) / 1e9
    return dict(losses=losses, ms=ms, state=state, peak_gb=peak,
                requested_gb=req)


@contextlib.contextmanager
def deterministic_convs():
    """cuDNN's deterministic algorithms for the body (no atomics in the
    filter gradients), the earlier settings restored after: bk1, bk2
    and mo1 hold runs of one program to each other's bits."""
    import torch
    prev = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, \
            torch.backends.cudnn.benchmark = prev


def book_moments(run, params):
    """{param: its Adam first-moment var}."""
    return {p: [n for n in run.persistables
                if n.startswith(p + '_moment1_')][0] for p in params}


def _book_x1(label, eager, captured, saved, params, moments, grads=None):
    """x1's rule: every loss within TRAIN_LOSS_TOL, each update within
    TRAIN_UPDATE_TOL by a2's gradient-weighted measure (g: `grads`, or
    for Adam the eager run's first moment, named by `moments`). Returns
    (loss diff, updates, same bits)."""
    loss_diff = max(abs(a - b) for a, b in zip(captured['losses'],
                                               eager['losses']))
    if grads is None:
        grads = {n: eager['state'][moments[n]].float() for n in params}
    got = _first_order_diffs(
        {n: (captured['state'][n] - saved[n]).float() for n in params},
        {n: (eager['state'][n] - saved[n]).float() for n in params},
        grads, params)
    bits = captured['losses'] == eager['losses'] and all(
        bool((captured['state'][n] == eager['state'][n]).all())
        for n in captured['state'])
    log('%s captured vs eager: loss max |diff| %.3e (tol %g); updates '
        'sum |g|·|diff| / sum |g|·|update|: %s (tol %g); the same bits: %s'
        % (label, loss_diff, TRAIN_LOSS_TOL,
           ', '.join('%s %.3e' % kv for kv in got.items()),
           TRAIN_UPDATE_TOL, bits))
    if not all(np.isfinite(captured['losses'])) or \
            loss_diff > TRAIN_LOSS_TOL or \
            any(v > TRAIN_UPDATE_TOL for v in got.values()):
        raise AssertionError('%s: the captured steps disagree with the eager '
                             'steps beyond the stated tolerance' % label)
    return loss_diff, got, bits


def _book_captured(run, label, params, sync, profile=True):
    """BOOK['steps'] batches through run's executor (eager, captured,
    replayed) and op by op from one saved state: _book_x1, the capture
    count equal to the device segments, step ms, images/s and (one more
    step under torch.profiler) device ms and busy share."""
    feeds, feed_ms = run.feeds(BOOK['steps'])
    saved = run.snapshot()
    moments = book_moments(run, params)
    names = list(params) + list(moments.values())
    run.fresh_executor()
    captured = _book_run(run, saved, feeds, sync, False, names)
    compiled = run.exe.jit_cache_stats()['compiled_segments']
    device_ms = busy = None
    if profile and run.place.device.type == 'cuda':
        device_ms, busy = _profile_steps(None, captured['ms'], sync,
                                         label, steps=1,
                                         step=lambda: run.step(feeds[-1]))
    eager = _book_run(run, saved, feeds, sync, True, names)
    run.restore(saved)
    out = _book_x1(label, eager, captured, saved, params, moments)
    n_seg = device_segments(run.main)
    batch = len(next(iter(feeds[0].values())))
    img_s = batch / captured['ms'] * 1e3
    log('%s: %d steps, losses %s; captured %.3f ms a step (%.1f images/s), '
        'op by op %.3f ms; the reader and DataFeeder %.3f ms a batch (host, '
        'before the steps); %d segments captured (the program has %d); '
        'peak %.4f GB allocated over the run\'s start'
        % (label, len(feeds), ', '.join('%.6f' % x for x in
                                        captured['losses']),
           captured['ms'], img_s, eager['ms'], feed_ms, compiled, n_seg,
           captured['peak_gb']))
    if run.place.device.type == 'cuda' and compiled != n_seg:
        raise AssertionError('%s: %d segments captured, the program has %d'
                             % (label, compiled, n_seg))
    return dict(losses=captured['losses'], ms=captured['ms'], img_s=img_s,
                eager_ms=eager['ms'], feed_ms=feed_ms, loss_diff=out[0],
                updates=out[1], bits=out[2], device_ms=device_ms,
                busy=busy, saved=saved, feeds=feeds,
                peak_gb=captured['peak_gb'])


@phase('bk1: image_classification (resnet_cifar10, Adam) fed by fluid.batch '
       '+ DataFeeder, captured')
def book_image_steps(place, sync, depth=None, batch=None):
    """resnet_cifar10(depth=BOOK['depth']) at 32 px, batch BOOK['batch'],
    fp32, Adam(0.001), fed from dataset.cifar.train10() through
    fluid.batch and DataFeeder: BOOK['steps'] steps captured vs op by
    op (x1's rule). Returns the run and its numbers."""
    import paddle_tpu_torch as fluid
    with flags_set({'FLAGS_use_pallas_fused_ops': False}), \
            deterministic_convs():
        run = BookRun(place, lambda f: book_image_net(f, depth),
                      fluid.dataset.cifar.train10(), batch or BOOK['batch'])
        ops = run.main.global_block().ops
        log('image_classification: %d ops (%d conv2d, %d batch_norm), '
            'resnet_cifar10 depth %d, batch %d x 3 x %d x %d, fp32'
            % (len(ops), sum(o.type == 'conv2d' for o in ops),
               sum(o.type == 'batch_norm' for o in ops),
               depth or BOOK['depth'], batch or BOOK['batch'], BOOK['hw'],
               BOOK['hw']))
        out = _book_captured(run, 'bk1 image_classification',
                             book_params_compared(run.main), sync)
    out.update(run=run, depth=depth or BOOK['depth'],
               batch=batch or BOOK['batch'])
    return out


def _fused_names(unfused, fused):
    """{unfused persistable: fused persistable}: the i-th conv2d and the
    batch_norm after it against the i-th conv2d_bn (Filter, Scale, Bias,
    Mean, Variance); every other parameter by its own name."""
    ub, fb = unfused.global_block(), fused.global_block()
    convs = [o for o in ub.ops if o.type == 'conv2d']
    bns = [o for o in ub.ops if o.type == 'batch_norm']
    fused_ops = [o for o in fb.ops if o.type == 'conv2d_bn']
    if not (len(convs) == len(bns) == len(fused_ops)):
        raise AssertionError('%d conv2d, %d batch_norm, %d conv2d_bn'
                             % (len(convs), len(bns), len(fused_ops)))
    out = {}
    for c, b, f in zip(convs, bns, fused_ops):
        out[c.single_input('Filter')] = f.single_input('Filter')
        for slot in ('Scale', 'Bias', 'Mean', 'Variance'):
            out[b.single_input(slot)] = f.single_input(slot)
    for p in ub.all_parameters():
        if p.name not in out and fb.has_var(p.name):
            out[p.name] = p.name
    return out


@phase('bk2: image_classification under FLAGS_use_pallas_fused_ops: K6 '
       'at the cifar shapes, the fused step vs bk1\'s')
def book_fused_steps(bk1, place, sync):
    """bk1's network built with the fused flag (every conv + BN one
    conv2d_bn op; its 1x1 projections run K6), from bk1's initial
    parameters: K6 launches exactly BK2_K6_PER_STEP a step over
    BOOK['steps'] captured steps, K6 held against its plain version at
    each of those shapes (as b6) and timed there, the captured steps vs
    op by op (x1's rule), and one fused step vs bk1's unfused step by
    r2's rule."""
    import torch
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.kernels import conv_bn as k6
    urun, batch = bk1['run'], bk1['batch']
    on_card = place.device.type == 'cuda'
    with flags_set({'FLAGS_use_pallas_fused_ops': True}), \
            deterministic_convs():
        run = BookRun(place, lambda f: book_image_net(f, bk1['depth']),
                      fluid.dataset.cifar.train10(), batch)
        names = _fused_names(urun.main, run.main)
        for u, f in names.items():
            run.scope.find_var(f).copy_(bk1['saved'][u])
        shapes = k6_path_shapes(run.main, batch)
        per_step = book_k6_launches(run.main, batch)
        log('bk2: %d conv2d_bn ops, %d of them 1x1 on K6: %s'
            % (sum(o.type == 'conv2d_bn' for o in run.main.global_block().ops),
               per_step, ', '.join('[%d, %d, %d] x %d' % (s + (n,))
                                   for s, n in sorted(shapes.items()))))
        if per_step != BK2_K6_PER_STEP:
            raise AssertionError('the fused program has %d 1x1 conv2d_bn ops '
                                 'on K6, want %d' % (per_step,
                                                     BK2_K6_PER_STEP))
        params = [names[n] for n in book_params_compared(urun.main)]
        feeds = bk1['feeds']
        saved = run.snapshot()
        moments = book_moments(run, params)
        state_names = params + list(moments.values())
        # the main path: BOOK['steps'] captured steps, K6 counted from 0
        run.fresh_executor()
        k6.reset_launches()
        captured = _book_run(run, saved, feeds, sync, False, state_names)
        launches = k6.matmul_bn_stats_kernel.launches
        by_kernel = dict(k6.matmul_bn_stats_kernel.launches_by_kernel)
        # the CPU runs K6's plain version, which launches nothing
        want = BK2_K6_PER_STEP * len(feeds) if on_card else 0
        log('bk2 fused steps: losses %s; %.3f ms a step (%.1f images/s); K6 '
            'launches %d (want %d x %d; by kernel %s)'
            % (', '.join('%.6f' % x for x in captured['losses']),
               captured['ms'], batch / captured['ms'] * 1e3,
               launches, BK2_K6_PER_STEP, len(feeds),
               ', '.join('%s %d' % kv for kv in by_kernel.items())))
        if launches != want:
            raise AssertionError('K6 launched %d times in %d fused steps, '
                                 'want %d' % (launches, len(feeds), want))
        device_ms = busy = None
        if on_card:
            check_replay_launches('bk2', lambda: run.step(feeds[-1]), sync)
            device_ms, busy = _profile_steps(
                None, captured['ms'], sync, 'bk2 fused step', steps=1,
                step=lambda: run.step(feeds[-1]))
        eager = _book_run(run, saved, feeds, sync, True, state_names)
        x1 = _book_x1('bk2 fused', eager, captured, saved, params, moments)
        run.exe.close()
        k6_ms = _book_k6_shapes(k6, shapes, place)
        r2 = _book_fused_vs_unfused(run, urun, bk1['saved'], saved, names,
                                    feeds[0])
    run.restore(saved)
    return dict(launches=launches, shapes=shapes, k6_ms=k6_ms, r2=r2,
                x1=x1, ms=captured['ms'], losses=captured['losses'],
                device_ms=device_ms, busy=busy)


def _book_k6_shapes(k6, shapes, place):
    """K6 against its plain version at each of bk2's shapes, in the
    program's dtype (fp32: the generic kernel, as _route sends it), and
    its ms there beside the plain version's. Returns {shape: (kernel,
    ms, plain ms)}."""
    import torch
    if place.device.type != 'cuda':
        return {}
    dev = torch.device('cuda', 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 5)
    out = {}
    for (M, K, N) in sorted(shapes):
        kernel = k6._route(M, K, N, torch.float32)
        _k6_check(k6, gen, dev, M, K, N, 'float32', kernel)
        x, w = _k6_inputs(gen, M, K, N, 'float32', dev)
        times = bracketed_ms({
            'ms': lambda: k6.matmul_bn_stats_kernel(x, w),
            'plain_ms': lambda: k6.matmul_bn_stats_reference(x, w)})
        t_bytes, t_ops = k6_bound_ms(M, K, N, 'float32')
        log('K6 [%d, %d, %d] fp32 (bk2) on %s: kernel %.4f ms, plain %.4f '
            'ms, bound %.4f ms (%s)'
            % (M, K, N, kernel, times['ms'], times['plain_ms'],
               max(t_bytes, t_ops),
               'bytes' if t_bytes >= t_ops else 'operations'))
        out[(M, K, N)] = (kernel, times['ms'], times['plain_ms'])
    return out


def _book_fused_vs_unfused(run, urun, usaved, fsaved, names, feed):
    """r2's rule between programs: one fused step with K6, the same step
    with the fused flag cleared (K6's plain version), and with the plain
    version's column sums in fp64, against bk1's unfused step from the
    same parameters, op by op. The updates are compared by a2's
    gradient-weighted measure (an Adam step is ~lr·sign(g), so an
    element whose gradient is near 0 may step either way; g is the
    unfused step's first moment): the fused step's to the unfused one's
    within the larger of TRAIN_UPDATE_TOL and RESNET_SPREAD_FACTOR x
    the plain fused step's own spread under the fp64 sums; the losses
    within TRAIN_LOSS_TOL."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.kernels import conv_bn as k6
    params = list(book_params_compared(urun.main))

    def step(r, saved, mapped):
        moments = book_moments(r, [mapped[u] for u in params])
        r.restore(saved)
        loss = r.step(feed, eager=True)
        ups = {u: (r.scope.find_var(mapped[u]) - saved[mapped[u]]).float()
               for u in params}
        g = {u: r.scope.find_var(moments[mapped[u]]).float().clone()
             for u in params}
        r.restore(saved)
        return loss, ups, g
    kernel = step(run, fsaved, names)
    plain_fn = k6.matmul_bn_stats_reference
    fluid.set_flags({'FLAGS_use_pallas_fused_ops': False})
    try:
        plain = step(run, fsaved, names)
        k6.matmul_bn_stats_reference = _reordered_reference
        reordered = step(run, fsaved, names)
    finally:
        k6.matmul_bn_stats_reference = plain_fn
        fluid.set_flags({'FLAGS_use_pallas_fused_ops': True})
    unfused = step(urun, usaved, {u: u for u in params})
    spread = _first_order_diffs(reordered[1], plain[1], plain[2], params)
    got = _first_order_diffs(kernel[1], unfused[1], unfused[2], params)
    loss_diff = abs(kernel[0] - unfused[0])
    log('bk2 fused step (K6) vs bk1 unfused step: loss %.6f vs %.6f (|diff| '
        '%.3e, tol %g; K6\'s plain version %.6f); updates sum |g|·|diff| / '
        'sum |g|·|update|: %s; the plain fused step\'s spread under fp64 '
        'sums: %s (tol: the larger of %g and %g x that spread)'
        % (kernel[0], unfused[0], loss_diff, TRAIN_LOSS_TOL, plain[0],
           ', '.join('%s %.3e' % kv for kv in got.items()),
           ', '.join('%s %.3e' % kv for kv in spread.items()),
           TRAIN_UPDATE_TOL, RESNET_SPREAD_FACTOR))
    bad = [n for n in params if not got[n] <= max(
        TRAIN_UPDATE_TOL, RESNET_SPREAD_FACTOR * spread[n])]
    if not np.isfinite(kernel[0]) or loss_diff > TRAIN_LOSS_TOL or bad:
        raise AssertionError('the fused step and the unfused step disagree '
                             'beyond the stated tolerance (%s)' % bad)
    return dict(loss_diff=loss_diff, updates=got, spread=spread)


def _round_trip(run, feed, model_dir):
    """save_inference_model, load_inference_model and the loaded
    program's outputs against the trained program's (cloned for test)
    on the same rows. Returns the max abs difference."""
    fluid = run.fluid
    with fluid.scope_guard(run.scope):
        fluid.io.save_inference_model(model_dir, [run.feed_names[0]],
                                      [run.pred], run.exe,
                                      main_program=run.main)
        prog, feed_names, fetch = fluid.io.load_inference_model(model_dir,
                                                                run.exe)
        loaded = np.asarray(run.exe.run(
            prog, feed={feed_names[0]: feed[run.feed_names[0]]},
            fetch_list=fetch)[0])
    direct = np.asarray(run.exe.run(
        run.main.clone(for_test=True), feed=feed, fetch_list=[run.pred],
        scope=run.scope)[0])
    err = float(np.abs(loaded - direct).max())
    log('save/load inference round trip: %d outputs, max |loaded - direct| '
        '%.3e (tol %g x max(1, |direct|))' % (loaded.size, err, SAVE_TOL))
    if loaded.shape != direct.shape or not np.all(
            np.abs(loaded - direct) <= SAVE_TOL *
            np.maximum(1.0, np.abs(direct))):
        raise AssertionError('the loaded inference program disagrees with '
                             'its source beyond %g' % SAVE_TOL)
    return err


def _lowers(label, losses):
    log('%s: losses %s' % (label, ', '.join('%.6f' % x for x in losses)))
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError('%s: the loss did not fall over %d steps: %r'
                             % (label, len(losses), losses))


@phase('bk3: fit_a_line, recognize_digits (py_reader) and word2vec, '
       '5 steps each')
def book_chapter_steps(place, sync, model_dir, scale=1):
    """fit_a_line (uci_housing, SGD, DataFeeder; then the inference round
    trip), recognize_digits (models.mnist's LeNet through py_reader, fed
    fluid.batch's batches by decorate_paddle_reader, Adam) and word2vec
    (imikolov N=5, embedding 32, DataFeeder, Adam): BK3_STEPS steps
    each, captured, every loss finite and the last below the first.
    scale shrinks the batches (a CPU rehearsal)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import mnist
    out = {}
    t0 = time.perf_counter()
    fit = BookRun(place, book_fit_a_line, fluid.dataset.uci_housing.train(),
                  20)
    feeds, _ = fit.feeds(BK3_STEPS)
    losses = [fit.step(f) for f in feeds]
    _lowers('fit_a_line', losses)
    out['fit_a_line'] = dict(losses=losses, round_trip=_round_trip(
        fit, {n: v[:5] for n, v in feeds[0].items()}, model_dir),
        s=time.perf_counter() - t0)
    fit.exe.close()

    t0 = time.perf_counter()
    batch = max(64 // scale, 4)
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        reader = fluid.layers.py_reader(
            capacity=4, shapes=[(-1, 1, 28, 28), (-1, 1)],
            dtypes=['float32', 'int64'], name='bk3_digits',
            use_double_buffer=True)
        img, label = fluid.layers.read_file(reader)
        _, avg_cost, acc = mnist.train_network(img, label)
        fluid.optimizer.Adam(learning_rate=0.001).minimize(avg_cost)
    samples = fluid.reader.map_readers(
        lambda s: (s[0].reshape(1, 28, 28), [s[1]]),
        fluid.dataset.mnist.train())
    reader.decorate_paddle_reader(fluid.batch(samples, batch,
                                              drop_last=True))
    scope = fluid.Scope()
    exe = fluid.Executor(place)
    exe.run(startup, scope=scope)
    reader.start()
    try:
        losses = [float(np.asarray(exe.run(main, fetch_list=[avg_cost],
                                           scope=scope)[0]))
                  for _ in range(BK3_STEPS)]
    finally:
        reader.reset()
    exe.close()
    _lowers('recognize_digits', losses)
    out['recognize_digits'] = dict(losses=losses,
                                   s=time.perf_counter() - t0)

    t0 = time.perf_counter()
    w2v = BookRun(place, book_word2vec,
                  fluid.dataset.imikolov.train(
                      fluid.dataset.imikolov.build_dict(), 5),
                  max(100 // scale, 4))
    feeds, _ = w2v.feeds(BK3_STEPS)
    losses = [w2v.step(f) for f in feeds]
    w2v.exe.close()
    _lowers('word2vec', losses)
    out['word2vec'] = dict(losses=losses, s=time.perf_counter() - t0)
    sync()
    log('bk3: %s' % ', '.join('%s %.1f s' % (k, v['s'])
                              for k, v in out.items()))
    return out


@phase('mo1: memory_optimize, release_memory and Print on the card')
def memory_modules(bk1, place, sync):
    """memory_optimize on bk1's program: MO1_STEPS captured steps the same
    bits as without it, peak allocated memory no higher; release_memory
    on fit_a_line: the same bits as the plain program, its segments
    logged; a layers.Print between two fcs writes the JAX package's text
    to stderr for the first PRINT_FIRST_N runs only, and the step still
    captures each of its device segments."""
    import io
    import paddle_tpu_torch as fluid
    on_card = place.device.type == 'cuda'
    run = bk1['run']
    feeds = bk1['feeds'][:MO1_STEPS]
    names = list(book_params_compared(run.main))
    out = {}
    runs = {}
    with flags_set({'FLAGS_use_pallas_fused_ops': False}), \
            deterministic_convs():
        for label in ('plain', 'memory_optimize'):
            if label == 'memory_optimize':
                plan = fluid.memory_optimize(run.main)
                log('memory_optimize: %d vars could reuse a dead buffer'
                    % len(plan))
            run.fresh_executor()
            # a first pass allocates what the new executor's stream keeps
            # for the process (cuBLAS's workspace is 32 MiB on the H100;
            # PyTorch keeps one a stream); the measured pass, its graphs
            # dropped, starts from a warm stream, so each arm's peak counts
            # its own steps only (two arms of one program read 0.0336 GB
            # apart when one arm's stream was new)
            _book_run(run, bk1['saved'], feeds, sync, False, [])
            run.exe.close()
            runs[label] = _book_run(run, bk1['saved'], feeds, sync, False,
                                    names)
        run.exe.close()
    run.restore(bk1['saved'])
    a, b = runs['plain'], runs['memory_optimize']
    bits = a['losses'] == b['losses'] and all(
        bool((a['state'][n] == b['state'][n]).all()) for n in names)
    # the peak held is the program's requested bytes: the allocated
    # peak also counts how the caching allocator rounds and reuses its
    # blocks, which earlier phases' allocations change (one program read
    # 0.5654 GB allocated in one arm and 0.5638 GB in the other after the
    # fleet phases had loaded and freed c1's model in this process)
    log('mo1 memory_optimize: %d captured steps the same bits %s; peak '
        'requested over the run\'s start %.6f GB with it, %.6f GB without '
        '(allocated %.4f GB and %.4f GB)'
        % (len(feeds), bits, b['requested_gb'], a['requested_gb'],
           b['peak_gb'], a['peak_gb']))
    if not bits or b['requested_gb'] > a['requested_gb']:
        raise AssertionError('memory_optimize changed the steps (bits %s) '
                             'or raised the peak' % bits)
    out['memory_optimize'] = (a['requested_gb'], b['requested_gb'])

    fits = {}
    for label in ('plain', 'release_memory'):
        fit = BookRun(place, book_fit_a_line,
                      fluid.dataset.uci_housing.train(), 20)
        if label == 'release_memory':
            fluid.release_memory(fit.main)
            fit.restore(fits['plain'][1])
        f, _ = fit.feeds(BK3_STEPS)
        saved = fit.snapshot()
        fits[label] = ([fit.step(x) for x in f], saved,
                       device_segments(fit.main),
                       fit.exe.jit_cache_stats()['compiled_segments'])
        fit.exe.close()
    log('mo1 release_memory on fit_a_line: losses %s the same bits as '
        'without it: %s; device segments %d (without it %d), %d captured'
        % (', '.join('%.6f' % x for x in fits['release_memory'][0]),
           fits['release_memory'][0] == fits['plain'][0],
           fits['release_memory'][2], fits['plain'][2],
           fits['release_memory'][3]))
    if fits['release_memory'][0] != fits['plain'][0]:
        raise AssertionError('release_memory changed fit_a_line\'s losses')
    if on_card and fits['release_memory'][3] != fits['release_memory'][2]:
        raise AssertionError('release_memory: %d of %d device segments '
                             'captured' % (fits['release_memory'][3],
                                           fits['release_memory'][2]))
    out['release_memory'] = dict(segments=fits['release_memory'][2],
                                 plain_segments=fits['plain'][2])

    # Print between two fcs, over a feed and an activation
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name='x', shape=[6], dtype='float32')
        y = fluid.layers.data(name='y', shape=[1], dtype='float32')
        h = fluid.layers.fc(input=x, size=8, act='relu')
        fluid.layers.Print(x, message='the feed', first_n=PRINT_FIRST_N)
        fluid.layers.Print(h, first_n=PRINT_FIRST_N)
        pred = fluid.layers.fc(input=h, size=1)
        loss = fluid.layers.mean(fluid.layers.square_error_cost(
            input=pred, label=y))
        fluid.optimizer.SGD(learning_rate=0.05).minimize(loss)
    scope = fluid.Scope()
    exe = fluid.Executor(place)
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(SEED + 7)
    want, printed = '', io.StringIO()
    prev, sys.stderr = sys.stderr, printed
    try:
        for i in range(PRINT_RUNS):
            xv = rng.randn(3, 6).astype('float32')
            yv = rng.randn(3, 1).astype('float32')
            _, hv = exe.run(main, feed={'x': xv, 'y': yv},
                            fetch_list=[loss, h], scope=scope)
            if i < PRINT_FIRST_N:
                want += expected_print_text('x', xv, 'the feed')
                want += expected_print_text(h.name, np.asarray(hv))
    finally:
        sys.stderr = prev
    text = printed.getvalue()
    n_seg = device_segments(main)
    compiled = exe.jit_cache_stats()['compiled_segments']
    exe.close()
    log('mo1 Print: %d runs, %d characters printed, the JAX package\'s text '
        'for the first %d runs and nothing after: %s; %d device segments, '
        '%d captured' % (PRINT_RUNS, len(text), PRINT_FIRST_N, text == want,
                         n_seg, compiled))
    sys.stderr.write(text)
    if text != want:
        raise AssertionError('the print ops wrote other text than the JAX '
                             'package\'s format')
    if n_seg < 2 or (on_card and compiled != n_seg):
        raise AssertionError('%d device segments captured, the Print '
                             'program has %d' % (compiled, n_seg))
    out['print'] = dict(segments=n_seg, chars=len(text))
    return out


# -- sq1-sq4: the stacked LSTM and the sequence book chapters -----------------

# tools/bench_suite.py --full's stacked_lstm (:75-90): vocab 30000, T 128,
# batch 64, models.stacked_lstm's default emb 512 and hid 512 (H = 128),
# Adam(1e-3), fp32, fed as (padded, lengths) with every length T
SQ1 = dict(vocab=30000, T=128, batch=64, emb=512, hid=512)
# Paddle book 06.understand_sentiment
SENTIMENT = dict(emb=128, hid=512, stacked=3, batch=128, lr=0.002)
# Paddle book 05.recommender_system
RECOMMENDER = dict(batch=256, lr=0.2)
# Paddle book 07.label_semantic_roles
SRL = dict(word_dim=32, mark_dim=5, hidden=512, depth=8, batch=10,
           mix_hidden_lr=1e-3)
SRL_FEEDS = ['word_data', 'ctx_n2_data', 'ctx_n1_data', 'ctx_0_data',
             'ctx_p1_data', 'ctx_p2_data', 'verb_data', 'mark_data',
             'target']
SQ_BATCHES = 5               # distinct batches; the steps pass over them twice
SQ_CPU_RTOL = 1e-4           # one step's loss, the card vs the CPU (fp32)
VITERBI_TOL = 1e-4           # sq4: a path's score vs the best (margin rule)


def _sq_falls(label, losses):
    """Two passes over the same batches: the second pass's mean loss must
    be below the first's."""
    half = len(losses) // 2
    first, second = float(np.mean(losses[:half])), \
        float(np.mean(losses[half:]))
    log('%s: losses %s; mean over the first pass %.6f, the second %.6f'
        % (label, ', '.join('%.6f' % x for x in losses), first, second))
    if not (all(np.isfinite(losses)) and second < first):
        raise AssertionError('%s: the loss did not fall over %d steps'
                             % (label, len(losses)))
    return first, second


def _sq_accumulators(run, params, optimizer):
    """The accumulator of each parameter that tells its gradient's size:
    Adam's first moment, Adagrad's sum of squares, Momentum's velocity;
    none for SGD."""
    if optimizer == 'sgd':
        return []
    mark = {'adam': '_moment1_', 'momentum': '_velocity_'}.get(
        optimizer, '_moment_')
    return [[m for m in run.persistables if m.startswith(n + mark)][0]
            for n in params]


def sq_grad_weights(run, params, optimizer, eager, saved):
    """|g| per compared parameter for x1's weighted update measure: Adam's
    first moment, Momentum's velocity, the square root of Adagrad's
    accumulator, SGD's own update (it is lr·g)."""
    if optimizer == 'sgd':
        return {n: (eager['state'][n] - saved[n]).float() for n in params}
    accs = _sq_accumulators(run, params, optimizer)
    return {n: (eager['state'][a].float() if optimizer in ('adam', 'momentum')
                else eager['state'][a].float().sqrt())
            for n, a in zip(params, accs)}


def sq_params(program, *prefixes):
    """The first parameter of each name prefix, a weight (.w_) where the
    prefix has one; a trailing '$' takes the last one instead."""
    names = [p.name for p in program.global_block().all_parameters()]
    out = []
    for pre in prefixes:
        hits = [n for n in names if n.startswith(pre.rstrip('$'))]
        hits = [n for n in hits if '.w_' in n] or hits
        out.append(hits[-1] if pre.endswith('$') else hits[0])
    return tuple(out)


def _steady_ms(run, feed, sync, eager, n=3):
    """ms a step over n steps of one feed whose signature the executor
    has captured (or op by op with eager)."""
    sync()
    t0 = time.perf_counter()
    for _ in range(n):
        run.step(feed, eager=eager)
    sync()
    return (time.perf_counter() - t0) / n * 1e3


def feed_signatures(program, feeds):
    """The distinct shapes the Executor sees for `feeds` once each LoD
    feed is padded: each is its own capture of every device segment."""
    from paddle_tpu_torch.executor import _expand_sequence_feeds
    return len({tuple(sorted((k, tuple(np.shape(v))) for k, v in
                             _expand_sequence_feeds(program, f).items()))
                for f in feeds})


def _sq_captured(run, label, feeds, params, optimizer, sync, profile=False):
    """feeds through run's executor (eager, captured, replayed) and op by
    op from one saved state: the losses fall, x1's rule, and the same
    bits (every op of these programs sums in one order: the embedding
    grad's index_put_ included), the captures and their signatures.
    Returns the numbers."""
    saved = run.snapshot()
    names = list(params) + _sq_accumulators(run, params, optimizer)
    run.fresh_executor()
    captured = _book_run(run, saved, feeds, sync, False, names)
    stats = run.exe.jit_cache_stats()
    # the last feed's signature was warmed up and captured in the steps:
    # its steps from here on replay
    captured['ms'] = _steady_ms(run, feeds[-1], sync, False)
    device_ms = busy = None
    if profile and run.place.device.type == 'cuda':
        device_ms, busy = _profile_steps(None, captured['ms'], sync, label,
                                         steps=1,
                                         step=lambda: run.step(feeds[-1]))
    eager = _book_run(run, saved, feeds, sync, True, names)
    eager['ms'] = _steady_ms(run, feeds[-1], sync, True)
    run.restore(saved)
    loss_diff, upd, bits = _book_x1(
        label, eager, captured, saved, params, None,
        grads=sq_grad_weights(run, params, optimizer, eager, saved))
    signatures = feed_signatures(run.main, feeds)
    n_seg = device_segments(run.main)
    log('%s: jit_cache_stats %s (%d device segments x %d feed signatures)'
        % (label, json.dumps(stats), n_seg, signatures))
    if not bits:
        raise AssertionError('%s: the captured steps are not the eager '
                             'steps\' bits' % label)
    if run.place.device.type == 'cuda' and \
            stats['compiled_segments'] != n_seg * signatures:
        raise AssertionError('%s: %d segments captured, expected %d'
                             % (label, stats['compiled_segments'],
                                n_seg * signatures))
    falls = _sq_falls(label, captured['losses'])
    return dict(losses=captured['losses'], ms=captured['ms'],
                eager_ms=eager['ms'], loss_diff=loss_diff, updates=upd,
                bits=bits, stats=stats, segments=n_seg,
                signatures=signatures, device_ms=device_ms, busy=busy,
                peak_gb=captured['peak_gb'], saved=saved,
                falls=falls, n_ops=len(run.main.global_block().ops))


def card_vs_cpu(run, build, saved, feed, params, optimizer, label,
                update_tol=TRAIN_UPDATE_TOL, grad_tol=None, floors=None):
    """One step of the port on the card and one on the CPU from the same
    parameters and feed: the losses within SQ_CPU_RTOL relative, the
    updates within update_tol by x1's weighted measure (g from the
    card's step) and, with grad_tol, each parameter's gradient (Adam's
    first moment after its first step, from zero) within grad_tol by
    sum |g_card - g_cpu| / sum |g_cpu|. floors: {param: a bound} that
    raises a parameter's two tolerances to it (det1: the CPU's own
    spread). Returns (relative loss difference, updates)."""
    import paddle_tpu_torch as fluid
    cpu = BookRun(fluid.CPUPlace(), build, None, 1)
    cpu.restore({n: t.cpu() for n, t in saved.items()})
    names = list(params) + _sq_accumulators(cpu, params, optimizer)
    run.restore(saved)
    card_loss = run.step(feed, eager=True)
    card = dict(state={n: run.scope.find_var(n).cpu().clone()
                       for n in names})
    cpu_loss = cpu.step(feed)
    cpu_state = {n: cpu.scope.find_var(n).clone() for n in names}
    run.restore(saved)
    host_saved = {n: saved[n].cpu() for n in params}
    grads = sq_grad_weights(run, params, optimizer, card, host_saved)
    upd = _first_order_diffs(
        {n: (cpu_state[n] - host_saved[n]).float() for n in params},
        {n: (card['state'][n] - host_saved[n]).float() for n in params},
        grads, params)
    gdiff = {}
    if grad_tol is not None:
        for n, m in zip(params, _sq_accumulators(run, params, optimizer)):
            a, b = card['state'][m].double(), cpu_state[m].double()
            gdiff[n] = ((a - b).abs().sum() /
                        b.abs().sum().clamp_min(1e-30)).item()
    rel = abs(card_loss - cpu_loss) / max(abs(cpu_loss), 1e-30)
    floors = floors or {}
    log('%s: one step on the card vs the CPU: loss %.7f vs %.7f (relative '
        '%.3e, tol %g); updates %s (tol %g)%s%s'
        % (label, card_loss, cpu_loss, rel, SQ_CPU_RTOL,
           ', '.join('%s %.3e' % kv for kv in upd.items()), update_tol,
           '; gradients sum |diff| / sum |g|: %s (tol %g)'
           % (', '.join('%s %.3e' % kv for kv in gdiff.items()), grad_tol)
           if gdiff else '',
           '; raised to %s' % ', '.join('%s %.3e' % kv
                                        for kv in floors.items())
           if floors else ''))
    if not (np.isfinite(card_loss) and rel <= SQ_CPU_RTOL and
            all(v <= max(update_tol, floors.get(n, 0.0))
                for n, v in upd.items()) and
            all(v <= max(grad_tol, floors.get(n, 0.0))
                for n, v in gdiff.items())):
        raise AssertionError('%s: the card and the CPU disagree' % label)
    return rel, upd


def stacked_lstm_build(sq1):
    def build(fluid):
        from paddle_tpu_torch.models import stacked_lstm
        data = fluid.layers.data(name='words', shape=[1], dtype='int64',
                                 lod_level=1)
        label = fluid.layers.data(name='label', shape=[1], dtype='int64')
        pred, loss, _ = stacked_lstm.train_network(
            data, label, sq1['vocab'], emb_dim=sq1['emb'],
            hid_dim=sq1['hid'])
        fluid.optimizer.Adam(learning_rate=1e-3).minimize(loss)
        return ['words', 'label'], pred, loss
    return build


def stacked_lstm_feed(rng, sq1, lens=None):
    """bench_suite's feed: ids in [1, vocab), (padded, lengths) with every
    length T unless `lens` is given (the ids past a length stay, so the
    masking must hide them)."""
    B, T = sq1['batch'], sq1['T']
    ids = rng.randint(1, sq1['vocab'], (B, T, 1)).astype('int64')
    lens = np.full((B,), T, 'int32') if lens is None else lens
    return {'words': (ids, lens),
            'label': rng.randint(0, 2, (B, 1)).astype('int64')}


@phase('sq1: the stacked LSTM at bench_suite --full shapes (vocab 30000, '
       'hid 512, T 128, batch 64), captured')
def stacked_lstm_steps(place, sync, sq1=None):
    """models.stacked_lstm.train_network under Adam(1e-3), fp32: 10 steps
    over SQ_BATCHES batches twice, captured vs op by op (x1), the loss
    falling; its step ms, samples/s, tokens/s, device busy share and
    time by kind, peak memory, ops and segments; then one step on the
    card vs the CPU on a feed whose lengths are drawn from 1..T."""
    sq1 = sq1 or SQ1
    build = stacked_lstm_build(sq1)
    run = BookRun(place, build, None, sq1['batch'])
    rng = np.random.RandomState(SEED + 30)
    feeds = [stacked_lstm_feed(rng, sq1) for _ in range(SQ_BATCHES)] * 2
    params = sq_params(run.main, 'embedding_', 'lstm_', 'lstm_$', 'fc_$')
    out = _sq_captured(run, 'sq1 stacked LSTM', feeds, params, 'adam', sync,
                       profile=True)
    B, T = sq1['batch'], sq1['T']
    out.update(samples_s=B / out['ms'] * 1e3,
               tokens_s=B * T / out['ms'] * 1e3)
    log('sq1 stacked LSTM (vocab %d, emb %d, hid %d, T %d, batch %d, fp32 '
        'Adam): %d ops, %d device segments; captured %.3f ms a step (%.1f '
        'samples/s, %.1f tokens/s), op by op %.3f ms; device %s ms, busy %s; '
        'peak %.4f GB allocated over the run\'s start'
        % (sq1['vocab'], sq1['emb'], sq1['hid'], T, B, out['n_ops'],
           out['segments'], out['ms'], out['samples_s'], out['tokens_s'],
           out['eager_ms'], _fmt_ms(out['device_ms'] or None),
           _fmt_busy(out['busy']), out['peak_gb']))
    ragged = stacked_lstm_feed(np.random.RandomState(SEED + 31), sq1,
                               lens=np.random.RandomState(SEED + 32).randint(
                                   1, T + 1, B).astype('int32'))
    out['cpu'] = card_vs_cpu(run, build, out.pop('saved'), ragged, params,
                             'adam', 'sq1 stacked LSTM, lengths 1..%d' % T)
    run.exe.close()
    return out


def sentiment_build(kind, w=None):
    """The chapter's convolution_net or stacked_lstm_net (embedding
    is_sparse=True, as the chapter sets it), cross entropy, Adagrad."""
    w = w or SENTIMENT

    def build(fluid):
        L = fluid.layers
        data = L.data(name='words', shape=[1], dtype='int64', lod_level=1)
        label = L.data(name='label', shape=[1], dtype='int64')
        dict_dim = len(fluid.dataset.imdb.word_dict())
        emb = L.embedding(input=data, size=[dict_dim, w['emb']],
                          is_sparse=True)
        if kind == 'conv':
            convs = [fluid.nets.sequence_conv_pool(
                input=emb, num_filters=w['hid'], filter_size=fs, act='tanh',
                pool_type='sqrt') for fs in (3, 4)]
            pred = L.fc(input=convs, size=2, act='softmax')
        else:
            fc1 = L.fc(input=emb, size=w['hid'])
            lstm1, _ = L.dynamic_lstm(input=fc1, size=w['hid'])
            inputs = [fc1, lstm1]
            for i in range(2, w['stacked'] + 1):
                fc = L.fc(input=inputs, size=w['hid'])
                lstm, _ = L.dynamic_lstm(input=fc, size=w['hid'],
                                         is_reverse=(i % 2) == 0)
                inputs = [fc, lstm]
            pred = L.fc(input=[L.sequence_pool(input=inputs[0],
                                               pool_type='max'),
                               L.sequence_pool(input=inputs[1],
                                               pool_type='max')],
                        size=2, act='softmax')
        loss = L.mean(L.cross_entropy(input=pred, label=label))
        fluid.optimizer.Adagrad(learning_rate=w['lr']).minimize(loss)
        return ['words', 'label'], pred, loss
    return build


@phase('sq2: understand_sentiment (both nets) fed by fluid.batch + '
       'DataFeeder, captured')
def sentiment_steps(place, sync, w=None):
    """Both nets of the chapter at its widths (emb 128, hid 512, 3
    stacked LSTMs, batch 128, Adagrad(0.002)), fed from dataset.imdb
    through the LoD branch of DataFeeder: 10 steps over SQ_BATCHES
    batches twice, captured vs op by op, the loss falling."""
    import paddle_tpu_torch as fluid
    w = w or SENTIMENT
    out = {}
    for kind in ('conv', 'stacked_lstm'):
        label = 'sq2 understand_sentiment %s' % kind
        run = BookRun(place, sentiment_build(kind, w),
                      fluid.dataset.imdb.train(), w['batch'])
        feeds, feed_ms = run.feeds(SQ_BATCHES)
        params = sq_params(run.main, 'embedding_', 'fc_$') if \
            kind == 'conv' else sq_params(run.main, 'embedding_', 'lstm_',
                                          'fc_$')
        r = _sq_captured(run, label, feeds * 2, params, 'adagrad', sync)
        r.pop('saved')
        lens = [max(f['words'].recursive_sequence_lengths()[0])
                for f in feeds]
        r.update(feed_ms=feed_ms, samples_s=w['batch'] / r['ms'] * 1e3,
                 longest=lens)
        log('%s: %d ops; captured %.3f ms a step (%.1f samples/s), op by op '
            '%.3f ms; DataFeeder %.3f ms a batch; padded lengths %s; %d '
            'graphs captured'
            % (label, r['n_ops'], r['ms'], r['samples_s'], r['eager_ms'],
               feed_ms, lens, r['stats']['compiled_segments']))
        run.exe.close()
        out[kind] = r
    return out


def recommender_build(w=None):
    """The chapter's user and movie towers, cos_sim, scale(5),
    square_error_cost, SGD(0.2)."""
    w = w or RECOMMENDER

    def build(fluid):
        L = fluid.layers
        ml = fluid.dataset.movielens

        def feature(name, vocab, emb, fc, table):
            ids = L.data(name=name, shape=[1], dtype='int64')
            e = L.embedding(input=ids, size=[vocab, emb], is_sparse=True,
                            param_attr=table)
            return L.fc(input=e, size=fc)

        usr = L.fc(input=L.concat(input=[
            feature('user_id', ml.max_user_id() + 1, 32, 32, 'user_table'),
            feature('gender_id', 2, 16, 16, 'gender_table'),
            feature('age_id', len(ml.age_table), 16, 16, 'age_table'),
            feature('job_id', ml.max_job_id() + 1, 16, 16, 'job_table')],
            axis=1), size=200, act='tanh')
        mov_fc = feature('movie_id', ml.max_movie_id() + 1, 32, 32,
                         'movie_table')
        cats = L.data(name='category_id', shape=[1], dtype='int64',
                      lod_level=1)
        cat_emb = L.embedding(input=cats, size=[len(ml.movie_categories()),
                                                32], is_sparse=True)
        cat_hidden = L.sequence_pool(input=cat_emb, pool_type='sum')
        title = L.data(name='movie_title', shape=[1], dtype='int64',
                       lod_level=1)
        title_emb = L.embedding(
            input=title, size=[len(ml.get_movie_title_dict()), 32],
            is_sparse=True)
        title_conv = fluid.nets.sequence_conv_pool(
            input=title_emb, num_filters=32, filter_size=3, act='tanh',
            pool_type='sum')
        mov = L.fc(input=L.concat(input=[mov_fc, cat_hidden, title_conv],
                                  axis=1), size=200, act='tanh')
        pred = L.scale(x=L.cos_sim(X=usr, Y=mov), scale=5.0)
        score = L.data(name='score', shape=[1], dtype='float32')
        loss = L.mean(L.square_error_cost(input=pred, label=score))
        fluid.optimizer.SGD(learning_rate=w['lr']).minimize(loss)
        return ['user_id', 'gender_id', 'age_id', 'job_id', 'movie_id',
                'category_id', 'movie_title', 'score'], pred, loss
    return build


@phase('sq3: recommender fed by fluid.batch + DataFeeder, captured')
def recommender_steps(place, sync, w=None):
    """The chapter at its widths (batch 256, SGD(0.2)) fed from
    dataset.movielens through DataFeeder (categories and titles are LoD
    slots): 10 steps over SQ_BATCHES batches twice, captured vs op by
    op, the loss falling."""
    import paddle_tpu_torch as fluid
    w = w or RECOMMENDER
    samples = fluid.reader.map_readers(lambda s: s[:7] + ([s[7]],),
                                       fluid.dataset.movielens.train())
    run = BookRun(place, recommender_build(w), samples, w['batch'])
    feeds, feed_ms = run.feeds(SQ_BATCHES)
    params = sq_params(run.main, 'user_table', 'sequence_conv_', 'fc_$')
    out = _sq_captured(run, 'sq3 recommender', feeds * 2, params, 'sgd',
                       sync)
    out.pop('saved')
    out.update(feed_ms=feed_ms, samples_s=w['batch'] / out['ms'] * 1e3)
    log('sq3 recommender: %d ops; captured %.3f ms a step (%.1f samples/s), '
        'op by op %.3f ms; DataFeeder %.3f ms a batch; %d graphs captured'
        % (out['n_ops'], out['ms'], out['samples_s'], out['eager_ms'],
           feed_ms, out['stats']['compiled_segments']))
    run.exe.close()
    return out


def srl_build(w=None):
    """db_lstm at the chapter's widths: 8 embedded features (the word
    embedding 'emb' frozen), depth LSTMs of alternating direction with
    relu candidates and sigmoid gates and cells, a linear-chain CRF whose
    transition 'crfw' learns at mix_hidden_lr, crf_decoding, SGD under
    exponential_decay(0.01, 100000, 0.5, staircase)."""
    w = w or SRL

    def build(fluid):
        L = fluid.layers
        word_dict, verb_dict, label_dict = fluid.dataset.conll05.get_dict()
        feeds = [L.data(name=n, shape=[1], dtype='int64', lod_level=1)
                 for n in SRL_FEEDS]
        word, ctx_n2, ctx_n1, ctx_0, ctx_p1, ctx_p2, verb, mark, target = \
            feeds
        embs = [L.embedding(input=x, size=[len(word_dict), w['word_dim']],
                            param_attr=fluid.ParamAttr(name='emb',
                                                       trainable=False))
                for x in (word, ctx_n2, ctx_n1, ctx_0, ctx_p1, ctx_p2)]
        embs.append(L.embedding(input=verb, size=[len(verb_dict),
                                                  w['word_dim']],
                                is_sparse=True, param_attr='vemb'))
        embs.append(L.embedding(input=mark, size=[2, w['mark_dim']],
                                is_sparse=True))
        hidden_0 = L.sums(input=[L.fc(input=e, size=w['hidden'], act='tanh')
                                 for e in embs])
        kw = dict(candidate_activation='relu', gate_activation='sigmoid',
                  cell_activation='sigmoid')
        lstm_0, _ = L.dynamic_lstm(input=hidden_0, size=w['hidden'], **kw)
        tmp = [hidden_0, lstm_0]
        for i in range(1, w['depth']):
            mix = L.sums(input=[
                L.fc(input=tmp[0], size=w['hidden'], act='tanh'),
                L.fc(input=tmp[1], size=w['hidden'], act='tanh')])
            lstm, _ = L.dynamic_lstm(input=mix, size=w['hidden'],
                                     is_reverse=(i % 2) == 1, **kw)
            tmp = [mix, lstm]
        feature_out = L.sums(input=[
            L.fc(input=tmp[0], size=len(label_dict), act='tanh'),
            L.fc(input=tmp[1], size=len(label_dict), act='tanh')])
        crf_cost = L.linear_chain_crf(
            input=feature_out, label=target,
            param_attr=fluid.ParamAttr(name='crfw',
                                       learning_rate=w['mix_hidden_lr']))
        loss = L.mean(crf_cost)
        fluid.optimizer.SGD(learning_rate=L.exponential_decay(
            learning_rate=0.01, decay_steps=100000, decay_rate=0.5,
            staircase=True)).minimize(loss)
        decode = L.crf_decoding(input=feature_out,
                                param_attr=fluid.ParamAttr(name='crfw'))
        return SRL_FEEDS, (feature_out, decode), loss
    return build


def path_score(emission, transition, path, length):
    """A label path's CRF score over its first `length` steps, in fp64:
    the start row, the emissions, the transitions, the stop row."""
    e = np.asarray(emission, np.float64)
    tr = np.asarray(transition, np.float64)
    s = tr[0, path[0]] + e[0, path[0]] + tr[1, path[length - 1]]
    for t in range(1, length):
        s += tr[2 + path[t - 1], path[t]] + e[t, path[t]]
    return s


def best_path_score(emission, transition, length):
    """The Viterbi maximum over all paths of the first `length` steps,
    in fp64 on the host."""
    e = np.asarray(emission, np.float64)
    tr = np.asarray(transition, np.float64)
    delta = tr[0] + e[0]
    for t in range(1, length):
        delta = (delta[:, None] + tr[2:]).max(0) + e[t]
    return float((delta + tr[1]).max())


def viterbi_margin(emission, transition, lens, got, want, tol=VITERBI_TOL):
    """Two decoders' paths [B, T] for the same emission [B, T, N] and
    transition: each sequence's paths equal, or, where they differ, both
    scoring within tol (relative to max(1, |best|)) of the best path.
    Returns (sequences equal, the largest shortfall seen)."""
    equal, worst = 0, 0.0
    for b, L in enumerate(lens):
        L = int(L)
        if np.array_equal(got[b, :L], want[b, :L]):
            equal += 1
            continue
        best = best_path_score(emission[b], transition, L)
        for path in (got[b], want[b]):
            gap = (best - path_score(emission[b], transition, path, L)) / \
                max(1.0, abs(best))
            worst = max(worst, gap)
            if gap > tol:
                raise AssertionError(
                    'sequence %d: a path scores %.3e below the best '
                    '(relative), beyond %g' % (b, gap, tol))
    return equal, worst


def cpu_viterbi(emission, transition, lens):
    """The CPU port's crf_decoding on the same emission and transition."""
    import paddle_tpu_torch as fluid
    prog = fluid.Program()
    block = prog.global_block()
    ins = {}
    for slot, arr in (('Emission', emission), ('Transition', transition),
                      ('SeqLens', lens)):
        ins[slot] = [block.create_var(name=slot.lower(), shape=arr.shape,
                                      dtype=arr.dtype.name, is_data=True)]
    path = block.create_var(name='path')
    block.append_op(type='crf_decoding', inputs=ins,
                    outputs={'ViterbiPath': [path]})
    return np.asarray(fluid.Executor(fluid.CPUPlace()).run(
        prog, feed={'emission': emission, 'transition': transition,
                    'seqlens': lens},
        fetch_list=[path], scope=fluid.Scope())[0])


def _chunk_program(fluid, B, T, num_chunk_types):
    """chunk_eval (IOB) of fed [B, T] paths against fed labels over fed
    lengths: (program, fetches: the six outputs)."""
    prog = fluid.Program()
    with fluid.program_guard(prog, fluid.Program()):
        L = fluid.layers
        path = L.data(name='path', shape=[B, T], dtype='int64',
                      append_batch_size=False)
        label = L.data(name='label', shape=[B, T], dtype='int64',
                       append_batch_size=False)
        path.seq_lens = L.data(name='lens', shape=[B], dtype='int32',
                               append_batch_size=False)
        outs = L.chunk_eval(path, label, chunk_scheme='IOB',
                            num_chunk_types=num_chunk_types)
    return prog, list(outs)


def srl_chunk_eval(run, decode, feeds, saved, place):
    """label_semantic_roles' evaluation, as upstream's chapter does it:
    chunk_eval (IOB; conll05's ceil((labels - 1) / 2) chunk types) over
    the card's Viterbi paths of each batch (a host step on the card,
    from the saved state), built up in metrics.ChunkEvaluator; the CPU
    port's chunk_eval on the same paths, in a second ChunkEvaluator.
    Fails unless every batch's counts and the accumulated precision,
    recall and F1 are equal. Returns (precision, recall, F1)."""
    import paddle_tpu_torch as fluid
    labels = fluid.dataset.conll05.get_dict()[2]
    n_types = int(np.ceil((len(labels) - 1) / 2.0))
    evs = [fluid.metrics.ChunkEvaluator(), fluid.metrics.ChunkEvaluator()]
    for feed in feeds:
        run.restore(saved)
        paths, = run.exe.run(run.main, feed=feed, fetch_list=[decode],
                             scope=run.scope)
        lens = np.asarray(feed['target'].recursive_sequence_lengths()[0],
                          'int32')
        B, T = len(lens), paths.shape[1]
        tags = np.full((B, T), n_types * 2, 'int64')
        flat = np.asarray(feed['target'].numpy()).reshape(-1)
        offs = np.concatenate([[0], np.cumsum(lens)])
        for b in range(B):
            tags[b, :lens[b]] = flat[offs[b]:offs[b + 1]]
        chunk_feed = {'path': paths[..., 0].astype('int64'),
                      'label': tags, 'lens': lens}
        counts = []
        for p, ev in zip((place, fluid.CPUPlace()), evs):
            prog, fetch = _chunk_program(fluid, B, T, n_types)
            got = [np.asarray(v) for v in fluid.Executor(p).run(
                prog, feed=chunk_feed, fetch_list=fetch, scope=fluid.Scope())]
            ev.update(got[3], got[4], got[5])
            counts.append([int(v[0]) for v in got[3:]])
        if counts[0] != counts[1]:
            raise AssertionError('sq4 chunk_eval: chunk counts %s on the '
                                 'card, %s on the CPU' % tuple(counts))
    run.restore(saved)
    card, cpu = (tuple(float(v) for v in ev.eval()) for ev in evs)
    if card != cpu or evs[0].num_label_chunks == 0:
        raise AssertionError('sq4 chunk_eval: P/R/F1 %s on the card, %s on '
                             'the CPU' % (card, cpu))
    return card


@phase('sq4: label_semantic_roles fed by fluid.batch + DataFeeder, '
       'captured, the CRF and Viterbi on the card')
def srl_steps(place, sync, w=None):
    """The chapter at its widths (word_dim 32, mark_dim 5, hidden 512,
    depth 8, batch 10), the word embedding loaded from
    conll05.get_embedding() and frozen: 10 steps over SQ_BATCHES batches
    twice, captured vs op by op, the CRF loss falling; one step on the
    card vs the CPU; the card's Viterbi path vs the CPU port's by the
    margin rule."""
    import torch
    import paddle_tpu_torch as fluid
    w = w or SRL
    build = srl_build(w)
    run = BookRun(place, build, fluid.dataset.conll05.test(), w['batch'])
    emb = fluid.dataset.conll05.get_embedding()
    run.scope.find_var('emb').copy_(torch.from_numpy(emb))
    feeds, feed_ms = run.feeds(SQ_BATCHES)
    params = sq_params(run.main, 'crfw', 'lstm_', 'fc_$')
    out = _sq_captured(run, 'sq4 label_semantic_roles', feeds * 2, params,
                       'sgd', sync)
    if not np.array_equal(run.scope.find_var('emb').cpu().numpy(), emb):
        raise AssertionError('sq4: the frozen embedding changed')
    saved = out.pop('saved')
    out['cpu'] = card_vs_cpu(run, build, saved, feeds[0], params, 'sgd',
                             'sq4 label_semantic_roles')
    feature_out, decode = run.pred
    run.restore(saved)
    emission, path, transition = run.exe.run(
        run.main, feed=feeds[0], fetch_list=[feature_out, decode, 'crfw'],
        scope=run.scope)
    run.restore(saved)
    lens = np.asarray(feeds[0]['target'].recursive_sequence_lengths()[0],
                      'int32')
    want = cpu_viterbi(emission, transition, lens)
    out['viterbi'] = viterbi_margin(emission, transition, lens,
                                    path[..., 0], want[..., 0])
    out['chunks'] = srl_chunk_eval(run, decode, feeds, saved, place)
    log('sq4 label_semantic_roles: %d ops; captured %.3f ms a step, op by op '
        '%.3f ms; DataFeeder %.3f ms a batch; %d graphs captured; Viterbi: '
        '%d of %d paths equal to the CPU port\'s, largest shortfall %.3e; '
        'chunk_eval (IOB) over the paths of %d batches: precision %.6f, '
        'recall %.6f, F1 %.6f, the CPU port\'s'
        % (out['n_ops'], out['ms'], out['eager_ms'], feed_ms,
           out['stats']['compiled_segments'], out['viterbi'][0], len(lens),
           out['viterbi'][1], len(feeds), *out['chunks']))
    out['feed_ms'] = feed_ms
    run.exe.close()
    return out


# -- cf1, mt1-mt3: control flow, machine_translation and the contrib decoders

# cf1: a While whose trip count is a fed limit, its body an fc over
# [batch, width] fp32 and an accumulator
CF1 = dict(batch=64, width=512, trips=(1, 7, 50))
CF_TOL = 1e-5                # cf1: card vs CPU port, relative to max(1, |x|)
# machine_translation (tests/test_book_machine_translation.py's model) at
# the reference's dict size (dataset.wmt14.N) and sq1's width; wmt14's
# own lengths (3-11 source tokens, 4-12 target tokens with <s> or <e>)
MT = dict(dict_size=30000, word=512, hidden=512, batch=64, lr=1e-3,
          max_len=12, beam=4)
MT_SCORE_TOL = 1e-4          # mt2, mt3: beam scores, card vs CPU (relative)
MT_LOGP_TOL = 1e-5           # mt1, mt3: log-probabilities, card vs CPU (abs)
MT_STEP_TOL = 1e-4           # mt1, mt3: one step's updates and gradients
MT_BEAM_TOL = 1e-5           # mt2: beam 4's best score vs beam 1's (relative)
MT_START, MT_END = 0, 1      # wmt14's <s> and <e>


def _attr(fluid, name):
    return fluid.ParamAttr(name=name)


def cf_loop_build(w):
    """cf1's loop program: h = x, then limit times h = tanh(fc(h) +
    table[i]) and acc += h; a reduce_sum after the loop (a second device
    segment). Each trip adds a row of the fed table, drawn at std 1, so
    every trip's h is O(1) and its own: a trip that replays stale inputs
    or reads the wrong row is O(1) off in acc and h, on the fiftieth trip
    as on the first. The fc's weights are drawn with std 0.25 /
    sqrt(width), so the map contracts (spectral norm ~0.5) and the
    card's and the CPU's rounding do not grow over the trips; with the
    default Xavier init it about doubles a trip (3.4e-5 apart after 7
    trips)."""
    def build(fluid):
        L = fluid.layers
        x = L.data(name='x', shape=[w['width']], dtype='float32')
        table = L.data(name='table', shape=[w['width']], dtype='float32')
        limit = L.data(name='limit', shape=[1], dtype='int64',
                       append_batch_size=False)
        i = L.fill_constant(shape=[1], dtype='int64', value=0)
        h = L.scale(x, scale=1.0)
        acc = L.fill_constant_batch_size_like(
            x, shape=[-1, w['width']], dtype='float32', value=0.0)
        cond = L.less_than(x=i, y=limit)
        loop = L.While(cond=cond)
        with loop.block():
            row = L.reshape(L.gather(table, i), shape=[w['width']])
            pre = L.fc(input=h, size=w['width'],
                       param_attr=fluid.ParamAttr(
                           name='cf_w', initializer=fluid.initializer.Normal(
                               0.0, 0.25 / w['width'] ** 0.5)),
                       bias_attr=_attr(fluid, 'cf_b'))
            new_h = L.tanh(L.elementwise_add(pre, row))
            L.assign(new_h, output=h)
            L.assign(L.elementwise_add(acc, new_h), output=acc)
            L.increment(x=i, value=1, in_place=True)
            L.less_than(x=i, y=limit, cond=cond)
        return [acc, h, i, L.reduce_sum(acc, dim=1)]
    return build


def cf_select_build(w):
    """cf1's select program: a Switch piecewise schedule writing the
    persistable 'cf_lr', an IfElse over [batch, width] (an fc where a
    row's sum is positive, -x elsewhere) and the tensor arrays."""
    def build(fluid):
        L = fluid.layers
        step = L.data(name='step', shape=[1], dtype='float32',
                      append_batch_size=False)
        x = L.data(name='x', shape=[w['width']], dtype='float32')
        lr = L.create_global_var(shape=[1], value=0.0, dtype='float32',
                                 persistable=True, name='cf_lr')
        bounds = [L.fill_constant(shape=[1], dtype='float32', value=v)
                  for v in (10.0, 20.0)]
        with L.Switch() as switch:
            for b, v in zip(bounds, (1.0, 0.5)):
                with switch.case(L.less_than(step, b)):
                    L.assign(L.fill_constant(shape=[1], dtype='float32',
                                             value=v), output=lr)
            with switch.default():
                L.assign(L.fill_constant(shape=[1], dtype='float32',
                                         value=0.1), output=lr)
        zero = L.fill_constant(shape=[1], dtype='float32', value=0.0)
        ie = L.IfElse(L.greater_than(L.reduce_sum(x, dim=1, keep_dim=True),
                                     zero))
        with ie.true_block():
            ie.output(L.fc(input=x, size=w['width'], act='tanh',
                           param_attr=_attr(fluid, 'cf_ie_w'),
                           bias_attr=_attr(fluid, 'cf_ie_b')))
        with ie.false_block():
            ie.output(L.scale(x, scale=-1.0))
        sel, = ie()
        i0 = L.fill_constant(shape=[1], dtype='int64', value=0)
        i1 = L.fill_constant(shape=[1], dtype='int64', value=1)
        arr = L.array_write(sel, i0)
        L.array_write(L.scale(sel, scale=2.0), i1, array=arr)
        return [lr, sel, L.array_read(arr, i1), L.array_length(arr)]
    return build


def _cf_program(build, seed=SEED):
    import paddle_tpu_torch as fluid
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        fetch = build(fluid)
    return main, startup, fetch


def _cf_close(label, got, want, tol=CF_TOL, scales=None):
    """Each output within tol of the CPU's, relative to max(1, |x|) or,
    where `scales` gives one, to max(1, scale): a sum is held relative
    to the sum of its terms' magnitudes, which its rounding follows
    (a row sum that cancels to near 0 keeps the rounding of its terms).
    Returns the largest such difference."""
    worst = 0.0
    scales = scales or [None] * len(got)
    for k, (g, w, scale) in enumerate(zip(got, want, scales)):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        if g.shape != w.shape:
            raise AssertionError('%s: output %d: the card gave shape %s, the '
                                 'CPU port %s' % (label, k, g.shape, w.shape))
        ref = np.abs(w) if scale is None else np.asarray(scale, np.float64)
        d = float((np.abs(g - w) / np.maximum(1.0, ref)).max()) \
            if g.size else 0.0
        if not d <= tol:
            raise AssertionError('%s: output %d: the card and the CPU port '
                                 'disagree (%.3e relative to max(1, %s))'
                                 % (label, k, d, '|x|' if scale is None
                                    else 'the magnitudes summed'))
        worst = max(worst, d)
    return worst


@phase('cf1: control flow on the card (a While with a fed trip count, '
       'Switch, IfElse, tensor arrays) vs the CPU port')
def control_flow_steps(place, sync, w=None):
    """cf1_loop: the While at CF1's shape for each trip count of
    w['trips'], twice each, on the card (segments captured, the body
    captured once a signature and replayed each trip) and on the CPU
    port from the same parameters: outputs within CF_TOL, the host reads
    trips + 1 a run, a second run of each trip count captures nothing
    new; ms a replayed trip, and ms a trip op by op (the body eager).
    cf1_select: the Switch, IfElse and arrays
    program, three runs (warm-up, capture, replay) at steps 5, 15, 25:
    the persistable cf_lr written under replay, outputs within CF_TOL."""
    import paddle_tpu_torch as fluid
    w = w or CF1
    rng = np.random.RandomState(SEED + 40)
    out = {}
    main, startup, fetch = _cf_program(cf_loop_build(w))
    scope, cpu_scope = fluid.Scope(), fluid.Scope()
    fluid.Executor(place).run(startup, scope=scope)
    for n in ('cf_w', 'cf_b'):
        cpu_scope.set_var(n, scope.find_var(n).cpu().clone())
    exe, cpu = fluid.Executor(place), fluid.Executor(fluid.CPUPlace())
    x = rng.randn(w['batch'], w['width']).astype('float32')
    table = rng.randn(max(w['trips']), w['width']).astype('float32')
    n_seg = device_segments(main)
    runs, err = [], 0.0
    for rep in range(2):
        for trips in w['trips']:
            feed = {'x': x, 'table': table,
                    'limit': np.array([trips], 'int64')}
            before = exe.loop_stats()
            compiled = exe.jit_cache_stats()['compiled_segments']
            sync()
            t0 = time.perf_counter()
            got = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
            ms = (time.perf_counter() - t0) * 1e3
            after = exe.loop_stats()
            new = exe.jit_cache_stats()['compiled_segments'] - compiled
            want = cpu.run(main, feed=feed, fetch_list=fetch,
                           scope=cpu_scope)
            # the row sums: relative to each row's sum of |acc|
            err = max(err, _cf_close(
                'cf1 loop, %d trips' % trips, got, want,
                scales=[None] * 3 + [np.abs(np.asarray(want[0])).sum(1)]))
            reads = after['host_reads'] - before['host_reads']
            if int(np.asarray(got[2])[0]) != trips or reads != trips + 1:
                raise AssertionError('cf1: %d trips ran, %d host reads'
                                     % (int(np.asarray(got[2])[0]), reads))
            if rep and new:
                raise AssertionError('cf1: a second run of %d trips '
                                     'captured %d graphs' % (trips, new))
            runs.append(dict(trips=trips, ms=ms, reads=reads, captured=new))
    stats = exe.jit_cache_stats()
    # the segments before and after the loop, and the body once
    if place.device.type == 'cuda' and \
            stats['compiled_segments'] != n_seg + 1:
        raise AssertionError('cf1: %d graphs captured, expected %d segments '
                             '+ 1 body' % (stats['compiled_segments'], n_seg))
    long_trips, short_trips = max(w['trips']), min(w['trips'])
    feeds = {t: {'x': x, 'table': table, 'limit': np.array([t], 'int64')}
             for t in (long_trips, short_trips)}

    def trip_ms(eager):
        # the long run less the short, over the trips between them
        timed = {}
        for t in (long_trips, short_trips, long_trips, short_trips):
            sync()
            t0 = time.perf_counter()
            exe.run(main, feed=feeds[t], fetch_list=fetch, scope=scope,
                    use_program_cache=not eager)
            sync()
            timed.setdefault(t, []).append((time.perf_counter() - t0) * 1e3)
        return (min(timed[long_trips]) - min(timed[short_trips])) / \
            (long_trips - short_trips)
    replay_ms, eager_ms = trip_ms(False), trip_ms(True)
    log('cf1 loop (fc [%d, %d] fp32 + a table row + accumulator a trip): '
        '%s; %d device segments + 1 body, jit_cache_stats %s, loop_stats '
        '%s; %.4f ms a replayed trip, %.4f ms a trip op by op; card vs CPU '
        '%.3e relative to max(1, |x|) (tol %g)'
        % (w['batch'], w['width'],
           '; '.join('%d trips %.3f ms, %d host reads, %d captured'
                     % (r['trips'], r['ms'], r['reads'], r['captured'])
                     for r in runs), n_seg, json.dumps(stats),
           json.dumps(exe.loop_stats()), replay_ms, eager_ms, err, CF_TOL))
    out['loop'] = dict(runs=runs, stats=stats, trip_ms=replay_ms,
                       eager_trip_ms=eager_ms, err=err, segments=n_seg)

    main, startup, fetch = _cf_program(cf_select_build(w))
    scope, cpu_scope = fluid.Scope(), fluid.Scope()
    fluid.Executor(place).run(startup, scope=scope)
    for v in startup.list_vars():
        if v.persistable and scope.find_var(v.name) is not None:
            cpu_scope.set_var(v.name, scope.find_var(v.name).cpu().clone())
    exe = fluid.Executor(place)
    err = 0.0
    for step, lr in ((5.0, 1.0), (15.0, 0.5), (25.0, 0.1), (3.0, 1.0)):
        feed = {'step': np.array([step], 'float32'),
                'x': rng.randn(w['batch'], w['width']).astype('float32')}
        got = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
        want = cpu.run(main, feed=feed, fetch_list=fetch, scope=cpu_scope)
        err = max(err, _cf_close('cf1 select, step %g' % step, got, want))
        held = float(scope.find_var('cf_lr').cpu()[0])
        if np.asarray(got[0])[0] != np.float32(lr) or \
                np.float32(held) != np.float32(lr):
            raise AssertionError('cf1: the Switch gave %g (the scope holds '
                                 '%g) at step %g, want %g'
                                 % (float(np.asarray(got[0])[0]), held, step,
                                    lr))
    sel_stats = exe.jit_cache_stats()
    log('cf1 select (Switch writing the persistable cf_lr, IfElse over [%d, '
        '%d], arrays): 4 runs, the last two replayed, cf_lr 1.0 / 0.5 / 0.1 '
        '/ 1.0 in the scope; jit_cache_stats %s; card vs CPU %.3e relative '
        'to max(1, |x|)' % (w['batch'], w['width'], json.dumps(sel_stats),
                            err))
    out['select'] = dict(stats=sel_stats, err=err)
    return out


def mt_encoder(fluid, src, w):
    """The chapter's encoder: embedding -> fc -> dynamic_gru, with its
    shared parameter names."""
    L = fluid.layers
    emb = L.embedding(input=src, size=[w['dict_size'], w['word']],
                      is_sparse=w.get('sparse', False),
                      param_attr=_attr(fluid, 'src_emb_w'))
    fc1 = L.fc(input=emb, size=w['hidden'] * 3,
               param_attr=_attr(fluid, 'enc_fc_w'),
               bias_attr=_attr(fluid, 'enc_fc_b'))
    return L.dynamic_gru(input=fc1, size=w['hidden'],
                         param_attr=_attr(fluid, 'enc_gru_w'),
                         bias_attr=_attr(fluid, 'enc_gru_b'))


def mt_head(fluid, emb, encoded, w, flatten):
    """The chapter's attention decoder at one position: the query, the
    attention over the encoder's states, the tanh state and the softmax
    over the target dict."""
    L = fluid.layers
    kw = dict(num_flatten_dims=2) if flatten else {}
    q = L.fc(input=emb, size=w['hidden'], param_attr=_attr(fluid, 'dec_q_w'),
             bias_attr=_attr(fluid, 'dec_q_b'), **kw)
    att = L.softmax(L.matmul(q, encoded, transpose_y=True))
    ctx = L.matmul(att, encoded)
    hidden = L.fc(input=L.concat([emb, ctx], axis=-1), size=w['hidden'],
                  act='tanh', param_attr=_attr(fluid, 'dec_h_w'),
                  bias_attr=_attr(fluid, 'dec_h_b'), **kw)
    return L.fc(input=hidden, size=w['dict_size'], act='softmax',
                param_attr=_attr(fluid, 'dec_o_w'),
                bias_attr=_attr(fluid, 'dec_o_b'), **kw)


MT_FEEDS = ['src_word_id', 'target_language_word',
            'target_language_next_word']


def _mt_data(fluid):
    return [fluid.layers.data(name=n, shape=[1], dtype='int64', lod_level=1)
            for n in MT_FEEDS]


def _mt_loss(fluid, probs, nxt):
    """The chapter's loss: cross entropy, averaged over each target's
    length, then over the batch."""
    L = fluid.layers
    cost = L.cross_entropy(input=probs, label=nxt)
    cost.seq_lens = nxt.seq_lens
    cost.lod_level = 1
    return L.mean(L.sequence_pool(cost, 'average'))


def mt_train_build(w):
    def build(fluid):
        src, trg, nxt = _mt_data(fluid)
        encoded = mt_encoder(fluid, src, w)
        emb = fluid.layers.embedding(input=trg,
                                     size=[w['dict_size'], w['word']],
                                     is_sparse=w.get('sparse', False),
                                     param_attr=_attr(fluid, 'trg_emb_w'))
        predict = mt_head(fluid, emb, encoded, w, flatten=False)
        loss = _mt_loss(fluid, predict, nxt)
        mt_optimizer(fluid, w).minimize(loss)
        return MT_FEEDS, predict, loss
    return build


def mt_optimizer(fluid, w):
    """mt1's Adam(w['lr']); w['optimizer'] 'adam_lazy' takes its
    lazy_mode, 'sgd' SGD(w['sgd_lr']) (sp1)."""
    kind = w.get('optimizer', 'adam')
    if kind == 'sgd':
        return fluid.optimizer.SGD(learning_rate=w['sgd_lr'])
    return fluid.optimizer.Adam(learning_rate=w['lr'],
                                lazy_mode=kind == 'adam_lazy')


def mt_decode_build(w, beam):
    """tests/test_book_machine_translation.py's _decode_program: max_len
    unrolled steps of the head over the beams, beam_search (end_id 0, as
    there), beam_search_decode."""
    def build(fluid):
        L = fluid.layers
        src = L.data(name='src_word_id', shape=[1], dtype='int64',
                     lod_level=1)
        ids = L.data(name='init_ids', shape=[beam], dtype='int64')
        scores = L.data(name='init_scores', shape=[beam], dtype='float32')
        encoded = mt_encoder(fluid, src, w)
        step_ids, step_parents = [], []
        for _ in range(w['max_len']):
            emb = L.embedding(input=L.unsqueeze(ids, axes=[2]),
                              size=[w['dict_size'], w['word']],
                              param_attr=_attr(fluid, 'trg_emb_w'))
            probs = mt_head(fluid, emb, encoded, w, flatten=True)
            logp = L.log(L.scale(probs, scale=1.0, bias=1e-9))
            ids, scores, parents = L.beam_search(ids, scores, logp,
                                                 beam_size=beam, end_id=0)
            step_ids.append(ids)
            step_parents.append(parents)
        return list(L.beam_search_decode(L.stack(step_ids, axis=0),
                                         L.stack(step_parents, axis=0),
                                         scores))
    return build


def beam_steps(main):
    """The outputs of every beam_search op of `main`, in program order:
    each step's selected ids, selected scores and parents, to fetch
    beside the sentences for beam_margin."""
    return [op.single_output(slot) for op in main.global_block().ops
            if op.type == 'beam_search'
            for slot in ('SelectedIds', 'SelectedScores', 'ParentIdx')]


def _beam_decode(fetched):
    """(sentence ids, sentence scores, the steps) from a run that fetched
    the sentences, their scores and then beam_steps()."""
    rest = [np.asarray(v) for v in fetched[2:]]
    return (np.asarray(fetched[0]), np.asarray(fetched[1]),
            [tuple(rest[k:k + 3]) for k in range(0, len(rest), 3)])


def beam_margin(label, got, want, tol=MT_SCORE_TOL):
    """The margin rule for two beam decodes of one batch. got and want
    are (sentence ids [B, beam, T], sentence scores [B, beam], the steps:
    each beam_search op's (selected ids, selected scores, parents), each
    [B, beam]). A row agrees if both decodes take the same beams (ids and
    parents) at every step, their selected scores within tol (relative
    to max(1, |score|)), and then give the same sentences, their scores
    within tol: the backtrack and the state shuffle saw the same lattice.
    Where a row's beams first differ at a step, the scores the two took
    there must lie within tol of each other, rank by rank (a near tie
    that another summation order breaks the other way), and the row is
    compared no further, as margin_rule stops at a stream's first
    difference; at most a quarter of the rows may end so. Returns (rows
    that agree, rows ending at a near tie, the largest relative score
    difference); raises AssertionError otherwise."""
    def rel(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return float((np.abs(a - b) / np.maximum(1.0, np.abs(b))).max())
    g_ids, g_scores, g_steps = got
    w_ids, w_scores, w_steps = want
    if len(g_steps) != len(w_steps) or not w_steps:
        raise AssertionError('%s: %d and %d beam steps'
                             % (label, len(g_steps), len(w_steps)))
    batch = len(w_scores)
    equal, ties, worst = 0, [], 0.0
    for r in range(batch):
        for t, (g, w) in enumerate(zip(g_steps, w_steps)):
            d = rel(g[1][r], w[1][r])
            if not d <= tol:
                raise AssertionError(
                    '%s: row %d, step %d: the selected beam scores %.3e '
                    'apart (relative), over %g' % (label, r, t, d, tol))
            worst = max(worst, d)
            if not (np.array_equal(g[0][r], w[0][r]) and
                    np.array_equal(g[2][r], w[2][r])):
                ties.append((r, t))
                break
        else:
            d = rel(g_scores[r], w_scores[r])
            if not (d <= tol and np.array_equal(g_ids[r], w_ids[r])):
                raise AssertionError(
                    '%s: row %d takes the same beams at every step, but '
                    'its sentences differ (ids equal: %s, scores %.3e '
                    'apart)' % (label, r, np.array_equal(g_ids[r], w_ids[r]),
                                d))
            worst = max(worst, d)
            equal += 1
    if len(ties) > batch // 4:
        raise AssertionError('%s: %d of %d rows end at a near tie (rows and '
                             'steps %s)' % (label, len(ties), batch, ties))
    return equal, len(ties), worst


def _decode_feed(feed, beam, batch):
    scores = np.full((batch, beam), -1e9, 'float32')
    scores[:, 0] = 0.0
    return {'src_word_id': feed['src_word_id'],
            'init_ids': np.full((batch, beam), MT_END, 'int64'),
            'init_scores': scores}


def _cpu_scope_of(run, names):
    import paddle_tpu_torch as fluid
    scope = fluid.Scope()
    for n in names:
        scope.set_var(n, run.scope.find_var(n).cpu().clone())
    return scope


def mt_forward_vs_cpu(run, feed, label, lengths):
    """The log-probabilities of run's prediction on the card and on the
    CPU port from run's present parameters (the test clone of its
    program: the forward alone), over each target's own positions
    (`lengths`, [B]): within MT_LOGP_TOL absolute. Their spread over the
    dict (the standard deviation, averaged over the positions) must be
    at least 100 x the tolerance, or the check could not tell the model
    from a constant. Returns (max |diff|, the spread)."""
    import paddle_tpu_torch as fluid
    test = run.main.clone(for_test=True)
    name = run.pred.name
    got = fluid.Executor(run.place).run(test, feed=feed, fetch_list=[name],
                                        scope=run.scope,
                                        use_program_cache=False)[0]
    want = fluid.Executor(fluid.CPUPlace()).run(
        test, feed=feed, fetch_list=[name],
        scope=_cpu_scope_of(run, _param_names(run)))[0]
    got, want = (np.log(np.maximum(np.asarray(v, np.float64), 1e-30))
                 for v in (got, want))
    lengths = np.asarray(lengths).reshape(-1)
    if got.shape != want.shape or got.ndim != 3 or \
            got.shape[0] != len(lengths):
        raise AssertionError('%s: predictions of shapes %s and %s'
                             % (label, got.shape, want.shape))
    valid = np.arange(got.shape[1])[None, :] < lengths[:, None]
    diff = float(np.abs(got - want)[valid].max())
    spread = float(want[valid].std(axis=-1).mean())
    log('%s: log-probabilities on the card vs the CPU from the trained '
        'parameters, over %d target positions: max |diff| %.3e (tol %g); '
        'their spread over the dict %.4f' % (label, int(valid.sum()), diff,
                                             MT_LOGP_TOL, spread))
    if not (diff <= MT_LOGP_TOL and spread >= 100 * MT_LOGP_TOL):
        raise AssertionError('%s: the card\'s and the CPU\'s predictions '
                             'disagree (%.3e), or spread %.3e over the dict'
                             % (label, diff, spread))
    return diff, spread


def _param_names(run):
    """run's persistables but the optimizer's accumulators."""
    return [n for n in run.persistables
            if '_moment' not in n and '_pow_acc' not in n]


def _timed_runs(exe, main, feed, fetch, scope, sync, n=3):
    """Two runs (the warm-up and the capture), then the ms of each of n
    replays; returns the last run's fetches and the mean ms."""
    for _ in range(2):
        out = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
    sync()
    t0 = time.perf_counter()
    for _ in range(n):
        out = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
    sync()
    return out, (time.perf_counter() - t0) / n * 1e3


@phase('mt1: machine_translation (dict 30000, word and hidden 512, batch 64, '
       'Adam) fed by fluid.batch + DataFeeder, captured')
def mt_steps(place, sync, w=None):
    """The chapter's encoder (embedding -> fc -> dynamic_gru) and its
    attention decoder under Adam, fp32, fed from dataset.wmt14 through
    DataFeeder's LoD branch: 10 steps over SQ_BATCHES batches twice,
    captured vs op by op (the same bits), the loss falling; step ms,
    samples/s, device busy and ms by kind, graphs captured, DataFeeder ms
    a batch, peak memory; one step on the card vs the CPU port (loss
    within SQ_CPU_RTOL, updates and gradients within MT_STEP_TOL); after
    the 10 steps, the log-probabilities on the card vs the CPU port
    (mt_forward_vs_cpu). Leaves the run trained over the 10 steps for
    mt2."""
    import paddle_tpu_torch as fluid
    w = w or MT
    build = mt_train_build(w)
    run = BookRun(place, build, fluid.dataset.wmt14.train(w['dict_size']),
                  w['batch'])
    feeds, feed_ms = run.feeds(SQ_BATCHES)
    params = ('src_emb_w', 'enc_gru_w', 'dec_h_w', 'dec_o_w')
    out = _sq_captured(run, 'mt1 machine_translation', feeds * 2, params,
                       'adam', sync, profile=True)
    saved = out.pop('saved')
    out['cpu'] = card_vs_cpu(run, build, saved, feeds[0], params, 'adam',
                             'mt1 machine_translation',
                             update_tol=MT_STEP_TOL, grad_tol=MT_STEP_TOL)
    run.restore(saved)
    for f in feeds * 2:
        run.step(f)
    out['logp'] = mt_forward_vs_cpu(
        run, feeds[0], 'mt1 machine_translation',
        feeds[0]['target_language_word'].recursive_sequence_lengths()[0])
    lens = [max(f['target_language_word'].recursive_sequence_lengths()[0])
            for f in feeds]
    out.update(feed_ms=feed_ms, samples_s=w['batch'] / out['ms'] * 1e3,
               run=run, feeds=feeds, longest=lens)
    log('mt1 machine_translation (dict %d, word %d, hidden %d, batch %d, '
        'fp32 Adam): %d ops, %d device segments; captured %.3f ms a step '
        '(%.1f samples/s), op by op %.3f ms; device %s ms, busy %s; '
        'DataFeeder %.3f ms a batch; padded target lengths %s; %d graphs '
        'captured; peak %.4f GB allocated over the run\'s start'
        % (w['dict_size'], w['word'], w['hidden'], w['batch'], out['n_ops'],
           out['segments'], out['ms'], out['samples_s'], out['eager_ms'],
           _fmt_ms(out['device_ms'] or None), _fmt_busy(out['busy']),
           feed_ms, lens, out['stats']['compiled_segments'],
           out['peak_gb']))
    return out


@phase('mt2: machine_translation beam decoding from mt1\'s scope (beam 1 '
       'and 4, 12 steps, batch 64), captured')
def mt_decode(mt1, place, sync, w=None):
    """tests/test_book_machine_translation.py's unrolled beam decoder
    from mt1's trained parameters on its first batch's sources, at beam 1
    and beam 4: on the card (the third run on are replays, timed) and on
    the CPU port: the beams by beam_margin (every step's beams and the
    sentences; scores within MT_SCORE_TOL),
    and beam 4's best score at least beam 1's in every row (within
    MT_BEAM_TOL relative). Logs ms a decoded batch."""
    import paddle_tpu_torch as fluid
    w = w or MT
    run, feed = mt1['run'], mt1['feeds'][0]
    batch = len(feed['src_word_id'].recursive_sequence_lengths()[0])
    cpu_scope = _cpu_scope_of(run, _param_names(run))
    out, best = {}, {}
    for beam in (1, w['beam']):
        main, _, fetch = _cf_program(mt_decode_build(w, beam))
        dfeed = _decode_feed(feed, beam, batch)
        exe = fluid.Executor(place)
        fetch = fetch + beam_steps(main)
        got, ms = _timed_runs(exe, main, dfeed, fetch, run.scope, sync)
        got = _beam_decode(got)
        want = _beam_decode(fluid.Executor(fluid.CPUPlace()).run(
            main, feed=dfeed, fetch_list=fetch, scope=cpu_scope))
        equal, ties, rel = beam_margin('mt2 beam %d' % beam, got, want)
        ids, scores, _ = got
        best[beam] = (scores[:, 0], ids[:, 0])
        out[beam] = dict(ms=ms, equal=equal, ties=ties, rel=rel,
                         compiled=exe.jit_cache_stats()['compiled_segments'])
        log('mt2 beam %d: %.3f ms a decoded batch (%d sentences x %d steps, '
            'replayed), %d graphs captured; %d of %d rows take the CPU '
            'port\'s beams at every step and give its sentences, %d end at '
            'a near tie; scores within %.3e (relative)'
            % (beam, ms, batch, w['max_len'], out[beam]['compiled'], equal,
               batch, ties, rel))
        exe.close()
    # relative: the two widths run the head's GEMM at other shapes, so
    # one sentence's score differs between them in its last bits
    (greedy, gids), (wide, wids) = best[1], best[w['beam']]
    short = (greedy - wide) / np.maximum(1.0, np.abs(greedy))
    if not (short <= MT_BEAM_TOL).all():
        raise AssertionError('mt2: beam %d\'s best score falls %.3e '
                             '(relative) below greedy\'s in a row'
                             % (w['beam'], float(short.max())))
    same = int((gids == wids).all(-1).sum())
    log('mt2: beam %d\'s best score at least beam 1\'s in every row (mean '
        'gain %.4f, largest relative shortfall %.3e); %d of %d rows the '
        'same best sentence' % (w['beam'], float((wide - greedy).mean()),
                                float(short.max()), same, len(greedy)))
    out['same_best'] = same
    run.exe.close()
    return out


def mt3_cell(fluid, context, w, beam=None):
    """A StateCell whose updater steps layers.gru_unit: the word's
    projection (no bias) into the three gates, the previous hidden in;
    over [B, beam, ...] in the beam decoder, row by row."""
    dec = fluid.contrib.decoder.beam_search_decoder
    L = fluid.layers
    H = w['hidden']
    cell = dec.StateCell(inputs={'x': None},
                         states={'h': dec.InitState(init=context,
                                                    need_reorder=True)},
                         out_state='h')

    @cell.state_updater
    def updater(cell):
        word, prev_h = cell.get_input('x'), cell.get_state('h')
        flat = len(word.shape) - 1
        gates = L.fc(input=word, size=3 * H, num_flatten_dims=flat,
                     param_attr=_attr(fluid, 'mt3_wx'), bias_attr=False)
        if flat > 1:
            gates = L.reshape(gates, shape=[-1, 3 * H])
            prev_h = L.reshape(prev_h, shape=[-1, H])
        h, _, _ = L.gru_unit(gates, prev_h, 3 * H,
                             param_attr=_attr(fluid, 'mt3_wh'),
                             bias_attr=_attr(fluid, 'mt3_b'))
        if flat > 1:
            h = L.reshape(h, shape=[-1, beam, H])
        cell.set_state('h', h)
    return cell


MT3_FEEDS = ['src_word_id', 'trg', 'trg_next', 'trg_len']


def mt3_reader(w):
    """wmt14 samples with the targets padded to max_len and their
    lengths: the TrainingDecoder steps over a fixed T (a sequence var's
    declared shape has no time axis to step over)."""
    import paddle_tpu_torch as fluid
    T = w['max_len']

    def pad(seq):
        return list(seq[:T]) + [0] * (T - len(seq[:T]))
    return fluid.reader.map_readers(
        lambda s: (s[0], pad(s[1]), [[t] for t in pad(s[2])],
                   [min(len(s[1]), T)]),
        fluid.dataset.wmt14.train(w['dict_size']))


def mt3_train_build(w):
    """The contrib TrainingDecoder (a DynamicRNN: a recurrent op and its
    grad, rows masked past their target length) over the padded target,
    its initial state the encoder's last state, the step's softmax over
    the target dict; the chapter's loss, Adam."""
    def build(fluid):
        L = fluid.layers
        dec = fluid.contrib.decoder.beam_search_decoder
        T = w['max_len']
        src = L.data(name='src_word_id', shape=[1], dtype='int64',
                     lod_level=1)
        trg = L.data(name='trg', shape=[T], dtype='int64')
        nxt = L.data(name='trg_next', shape=[T, 1], dtype='int64')
        lens = L.data(name='trg_len', shape=[1], dtype='int32')
        context = L.sequence_last_step(mt_encoder(fluid, src, w))
        cell = mt3_cell(fluid, context, w)
        emb = L.embedding(input=L.unsqueeze(trg, axes=[2]),
                          size=[w['dict_size'], w['word']],
                          param_attr=_attr(fluid, 'trg_emb_w'))
        emb.seq_lens = lens
        decoder = dec.TrainingDecoder(cell)
        with decoder.block():
            cur = decoder.step_input(emb)
            decoder.state_cell.compute_state(inputs={'x': cur})
            score = L.fc(input=decoder.state_cell.get_state('h'),
                         size=w['dict_size'], act='softmax',
                         param_attr=_attr(fluid, 'mt3_decoder_out_w'),
                         bias_attr=_attr(fluid, 'mt3_decoder_out_b'))
            decoder.state_cell.update_states()
            decoder.output(score)
        probs = decoder()
        nxt.seq_lens = lens
        loss = _mt_loss(fluid, probs, nxt)
        fluid.optimizer.Adam(learning_rate=w['lr']).minimize(loss)
        return MT3_FEEDS, probs, loss
    return build


def mt3_decode_build(w):
    """The contrib BeamSearchDecoder over mt3's cell and parameters:
    max_len steps at w['beam'], from <s>, ending on <e>."""
    def build(fluid):
        L = fluid.layers
        dec = fluid.contrib.decoder.beam_search_decoder
        beam = w['beam']
        src = L.data(name='src_word_id', shape=[1], dtype='int64',
                     lod_level=1)
        context = L.sequence_last_step(mt_encoder(fluid, src, w))
        cell = mt3_cell(fluid, context, w, beam=beam)
        init_ids = L.data(name='init_ids', shape=[beam], dtype='int64')
        init_scores = L.data(name='init_scores', shape=[beam],
                             dtype='float32')
        bs = dec.BeamSearchDecoder(
            state_cell=cell, init_ids=init_ids, init_scores=init_scores,
            target_dict_dim=w['dict_size'], word_dim=w['word'],
            max_len=w['max_len'], beam_size=beam, end_id=MT_END,
            sparse_emb=False, name='mt3_decoder')
        bs._embedding_param = 'trg_emb_w'
        bs.decode()
        return list(bs())
    return build


@phase('mt3: the contrib TrainingDecoder (recurrent, gru_unit) and '
       'BeamSearchDecoder at machine_translation\'s widths, captured')
def mt_contrib_steps(place, sync, w=None):
    """mt3_train_build over dataset.wmt14 through DataFeeder at MT's
    widths (T up to 12, hidden 512, batch 64): 10 steps captured vs op by
    op (the same bits, recurrent and recurrent_grad in the step), the
    loss falling; one step vs the CPU port (as mt1's) and, after the 10
    steps, the log-probabilities vs the CPU port; then the
    BeamSearchDecoder at beam w['beam'] from the trained scope, card vs
    CPU port by beam_margin, its ms a decoded batch."""
    import paddle_tpu_torch as fluid
    w = w or MT
    build = mt3_train_build(w)
    run = BookRun(place, build, mt3_reader(w), w['batch'])
    types = [op.type for op in run.main.global_block().ops]
    if 'recurrent' not in types or 'recurrent_grad' not in types:
        raise AssertionError('mt3: the step has no recurrent op or grad')
    feeds, feed_ms = run.feeds(SQ_BATCHES)
    params = ('src_emb_w', 'mt3_wh', 'mt3_wx', 'mt3_decoder_out_w')
    out = _sq_captured(run, 'mt3 TrainingDecoder', feeds * 2, params, 'adam',
                       sync)
    saved = out.pop('saved')
    out['cpu'] = card_vs_cpu(run, build, saved, feeds[0], params, 'adam',
                             'mt3 TrainingDecoder',
                             update_tol=MT_STEP_TOL, grad_tol=MT_STEP_TOL)
    run.restore(saved)
    for f in feeds * 2:
        run.step(f)
    out['logp'] = mt_forward_vs_cpu(run, feeds[0], 'mt3 TrainingDecoder',
                                    feeds[0]['trg_len'])
    main, _, fetch = _cf_program(mt3_decode_build(w))
    fetch = fetch + beam_steps(main)
    batch = len(feeds[0]['src_word_id'].recursive_sequence_lengths()[0])
    dfeed = _decode_feed(feeds[0], w['beam'], batch)
    dfeed['init_ids'][:] = MT_START
    exe = fluid.Executor(place)
    got, dec_ms = _timed_runs(exe, main, dfeed, fetch, run.scope, sync)
    want = fluid.Executor(fluid.CPUPlace()).run(
        main, feed=dfeed, fetch_list=fetch,
        scope=_cpu_scope_of(run, _param_names(run)))
    out['beams'] = beam_margin('mt3 BeamSearchDecoder', _beam_decode(got),
                               _beam_decode(want))
    out.update(feed_ms=feed_ms, samples_s=w['batch'] / out['ms'] * 1e3,
               dec_ms=dec_ms)
    log('mt3 TrainingDecoder (gru_unit cell, hidden %d, batch %d, T up to '
        '%d): %d ops; captured %.3f ms a step (%.1f samples/s), op by op '
        '%.3f ms; %d graphs captured; BeamSearchDecoder beam %d: %.3f ms a '
        'decoded batch, %d of %d rows take the CPU port\'s beams at every '
        'step and give its sentences, %d end at a near tie; scores within '
        '%.3e (relative)'
        % (w['hidden'], w['batch'], w['max_len'], out['n_ops'], out['ms'],
           out['samples_s'], out['eager_ms'],
           out['stats']['compiled_segments'], w['beam'], dec_ms,
           out['beams'][0], batch, out['beams'][1], out['beams'][2]))
    exe.close()
    run.exe.close()
    return out


# -- (sp1), (det1), (det2): sparse gradients and the detection ops ----------------

SP_TOL = 1e-6                # sp1 (b), (c): sparse vs dense, relative to
#                              the update's largest element
SP_SGD_LR = 0.1              # sp1 (b): mt1's program under SGD
W2V = dict(embed=32, hidden=256, batch=100, lr=0.001)   # the book's word2vec
# SSD300 (Liu et al., 2016) as upstream Fluid's multi_box_head documents
# it, over VGG-16's conv groups as models/vgg.py builds them (batch
# norm): conv1-conv3 pooled, conv4's three convs the first map, pool,
# conv5's three convs, fc6 (3x3, 1024) and fc7 (1x1, 1024) the second,
# then four extra 1x1 -> 3x3 layers, stride 2 but the last
SSD = dict(hw=300, classes=21, batch=32, max_boxes=8, lr=1e-3, momentum=0.9,
           l2=5e-4, vgg=((64, 2, 2), (128, 2, 2), (256, 3, 2), (512, 3, 1)),
           conv5=(512, 3), fc=1024,
           extras=((256, 512, 2, 1), (128, 256, 2, 1), (128, 256, 2, 1),
                   (128, 256, 1, 0)),
           base_size=300, min_ratio=20, max_ratio=90,
           aspect_ratios=[[2.], [2., 3.], [2., 3.], [2., 3.], [2.], [2.]],
           decode_batch=8, nms_threshold=0.45, nms_top_k=400,
           keep_top_k=200, score_threshold=0.01)
# the CPU tests' SSD: 64 px, three maps, 5 classes
SSD_TINY = dict(SSD, hw=64, classes=5, batch=2, max_boxes=4,
                vgg=((8, 1, 2), (8, 1, 2), (16, 1, 1)), conv5=(16, 1),
                fc=16, extras=((8, 16, 2, 1),), base_size=64,
                aspect_ratios=[[2.], [2., 3.], [2.]], decode_batch=2,
                nms_top_k=20, keep_top_k=10)
SSD_BATCHES = 5              # det1: distinct batches, each twice
SSD_CPU_BATCH = 2            # det1: the card-vs-CPU step's images
SSD_STEP_TOL = 1e-4          # det1: one step's gradients and updates,
SSD_SPREAD_FACTOR = 2.0      # or this x the CPU's own spread (as r2's rule)
DET_SCORE_TOL = 1e-5         # det2: detections and mAP, card vs CPU


def sparse_touched(program, feed, names):
    """The table rows a feed's ids look up, by the ids feeds `names`
    (padded as the Executor pads them: a padded position looks up id 0
    too)."""
    from paddle_tpu_torch.executor import _expand_sequence_feeds
    fed = _expand_sequence_feeds(program, feed)
    return np.unique(np.concatenate([np.asarray(fed[n]).reshape(-1)
                                     for n in names]))


def lazy_rows_check(run, feeds, tables, sync):
    """One step per feed through run's executor (eager, captured,
    replayed): every row of each table the step's ids miss keeps its
    parameter and both Adam moments to the bit, and some touched row
    moves. tables: {table: the feed names whose ids it looks up}.
    Returns (steps, the rows held a step on average)."""
    held = []
    for feed in feeds:
        names = {t: [t] + [n for n in run.persistables
                           if n.startswith((t + '_moment1_',
                                            t + '_moment2_'))]
                 for t in tables}
        before = {n: run.scope.find_var(n).clone()
                  for ns in names.values() for n in ns}
        run.step(feed)
        sync()
        for t, ids in tables.items():
            touched = sparse_touched(run.main, feed, ids)
            keep = np.ones(before[t].shape[0], bool)
            keep[touched] = False
            rows = torch_index(keep, before[t].device)
            for n in names[t]:
                a, b = before[n][rows], run.scope.find_var(n)[rows]
                if not bool((a == b).all()):
                    raise AssertionError(
                        'sp1: %s moved at rows this step did not touch' % n)
            touched = torch_index(~keep, before[t].device)
            if bool((run.scope.find_var(t)[touched] ==
                     before[t][touched]).all()):
                raise AssertionError('sp1: no touched row of %s moved' % t)
            held.append(int(keep.sum()))
    return len(feeds), float(np.mean(held))


def torch_index(mask, device):
    import torch
    return torch.from_numpy(np.flatnonzero(mask)).to(device)


def sparse_vs_dense(place, sync, build_of, reader, batch, feeds, label,
                    init=None):
    """The same program built dense and sparse (build_of(is_sparse)), one
    step each from one parameter state on feeds[0], then 3 more replayed
    steps for their ms: every parameter's update within SP_TOL of the
    dense one's largest element. Returns ({name: relative difference},
    dense ms, sparse ms)."""
    runs, ms = {}, {}
    for sparse in (False, True):
        run = BookRun(place, build_of(sparse), reader, batch)
        if init is None:
            init = {n: run.scope.find_var(n).clone()
                    for n in run.persistables}
        run.restore({n: t for n, t in init.items()
                     if n in run.persistables})
        before = {p.name: run.scope.find_var(p.name).clone()
                  for p in run.main.global_block().all_parameters()}
        run.step(feeds[0])
        runs[sparse] = {n: (run.scope.find_var(n) - t).double().cpu()
                        for n, t in before.items()}
        run.step(feeds[0])
        ms[sparse] = _steady_ms(run, feeds[0], sync, False)
        run.exe.close()
        del run
        if place.device.type == 'cuda':
            free_device_memory()
    rel = {}
    for n, d in runs[False].items():
        rel[n] = float((runs[True][n] - d).abs().max() /
                       max(float(d.abs().max()), 1e-30))
    worst = max(rel.values())
    log('%s: sparse vs dense one step, max |update diff| / max |update| '
        '%.3e (tol %g; per parameter %s); step ms dense %.3f, sparse %.3f'
        % (label, worst, SP_TOL, ', '.join('%s %.3e' % kv for kv in
                                           sorted(rel.items())),
           ms[False], ms[True]))
    if not worst <= SP_TOL:
        raise AssertionError('%s: the sparse step is not the dense one'
                             % label)
    return rel, ms[False], ms[True]


@phase('sp1: sparse embeddings (SelectedRows) under lazy Adam, Adam and SGD '
       '(machine_translation) and the word2vec chapter\'s shared table')
def sparse_steps(place, sync, w=None, w2v=None):
    """(a) mt1's program (MT) with both embeddings is_sparse=True under
    Adam(lazy_mode=True): each of 10 captured steps leaves every row its
    ids miss, parameter and both moments, the same bits, and moves a
    touched one (lazy_rows_check); captured vs op by op the same bits
    (sq1's rules); one step vs the CPU port (gradients and updates within
    MT_STEP_TOL, gradient-weighted as mt1). (b) the program dense and
    sparse under default Adam and under SGD(SP_SGD_LR): one step each
    from one state, the updates within SP_TOL (sparse_vs_dense). (c) the
    word2vec chapter (four lookups into one shared table, the fan-out
    sum of four SelectedRows) dense and sparse under the book's SGD.
    Logs step ms sparse and dense."""
    import paddle_tpu_torch as fluid
    w = dict(w or MT, sparse=True, optimizer='adam_lazy')
    w2v = w2v or W2V
    build = mt_train_build(w)
    reader = fluid.dataset.wmt14.train(w['dict_size'])
    run = BookRun(place, build, reader, w['batch'])
    feeds, _ = run.feeds(SQ_BATCHES)
    grads = [op for op in run.main.global_block().ops
             if op.type == 'lookup_table_grad']
    if len(grads) != 2 or not all(op.attr('is_sparse') for op in grads):
        raise AssertionError('sp1: the program has no sparse lookup grads')
    params = ('src_emb_w', 'trg_emb_w', 'enc_gru_w', 'dec_o_w')
    out = _sq_captured(run, 'sp1 lazy Adam', feeds * 2, params, 'adam',
                       sync)
    saved = out.pop('saved')
    run.restore(saved)
    fetched = run.exe.run(run.main, feed=feeds[0],
                          fetch_list=['src_emb_w@GRAD'], scope=run.scope,
                          return_numpy=False)[0]
    if type(fetched).__name__ != 'SelectedRows':
        raise AssertionError('sp1: src_emb_w@GRAD is a %s'
                             % type(fetched).__name__)
    run.restore(saved)
    out['lazy'] = lazy_rows_check(
        run, feeds * 2, {'src_emb_w': ['src_word_id'],
                         'trg_emb_w': ['target_language_word']}, sync)
    out['cpu'] = card_vs_cpu(run, build, saved, feeds[0], params, 'adam',
                             'sp1 lazy Adam', update_tol=MT_STEP_TOL,
                             grad_tol=MT_STEP_TOL)
    init = {n: t for n, t in saved.items() if '_moment' not in n and
            '_pow_acc' not in n}
    run.exe.close()
    del run
    if place.device.type == 'cuda':
        free_device_memory()
    out['adam'] = sparse_vs_dense(
        place, sync, lambda sp: mt_train_build(dict(w, sparse=sp,
                                                    optimizer='adam')),
        reader, w['batch'], feeds, 'sp1 Adam', init)
    out['sgd'] = sparse_vs_dense(
        place, sync, lambda sp: mt_train_build(dict(
            w, sparse=sp, optimizer='sgd', sgd_lr=SP_SGD_LR)),
        reader, w['batch'], feeds, 'sp1 SGD', init)
    w2v_reader = fluid.dataset.imikolov.train(
        fluid.dataset.imikolov.build_dict(), 5)

    def w2v_build(sparse):
        return lambda f: book_word2vec(f, w2v['embed'], w2v['hidden'],
                                       is_sparse=sparse, sgd_lr=w2v['lr'])
    probe = BookRun(place, w2v_build(True), w2v_reader, w2v['batch'])
    w2v_feeds, _ = probe.feeds(1)
    sums = [op for op in probe.main.global_block().ops if op.type == 'sum'
            and op.output('Out') == ['shared_w@GRAD']]
    if len(sums) != 1 or len(sums[0].input('X')) != 4:
        raise AssertionError('sp1: word2vec has no fan-out sum of the four '
                             'lookups\' grads')
    g = probe.exe.run(probe.main, feed=w2v_feeds[0],
                      fetch_list=['shared_w@GRAD'], scope=probe.scope,
                      return_numpy=False)[0]
    if type(g).__name__ != 'SelectedRows' or \
            g.rows.shape[0] != 4 * w2v['batch']:
        raise AssertionError('sp1: the fan-out sum is not a SelectedRows of '
                             '4 x batch rows')
    probe.exe.close()
    out['word2vec'] = sparse_vs_dense(place, sync, w2v_build, w2v_reader,
                                      w2v['batch'], w2v_feeds,
                                      'sp1 word2vec SGD')
    log('sp1 sparse embeddings: lazy Adam %d steps, %.1f rows a table held '
        'a step; card vs CPU loss %.3e; step ms (dense / sparse): Adam '
        '%.3f / %.3f, SGD %.3f / %.3f, word2vec SGD %.3f / %.3f, lazy Adam '
        'captured %.3f (%s)'
        % (out['lazy'][0], out['lazy'][1], out['cpu'][0], out['adam'][1],
           out['adam'][2], out['sgd'][1], out['sgd'][2],
           out['word2vec'][1], out['word2vec'][2], out['ms'],
           gpu_name_and_power_limit() if place.device.type == 'cuda'
           else 'CPU'))
    return out


def ssd_net(fluid, img, w):
    """The six (SSD_TINY: three) feature maps: VGG-16's conv groups by
    nets.img_conv_group with batch norm (a group of pool 1 keeps its
    size), pool, conv5's group, fc6 and fc7, then the extra layers."""
    L = fluid.layers
    net = img
    for width, convs, pool in w['vgg']:
        net = fluid.nets.img_conv_group(
            input=net, conv_num_filter=[width] * convs, pool_size=pool,
            pool_stride=pool, conv_filter_size=3, conv_act='relu',
            conv_with_batchnorm=True, pool_type='max')
    maps = [net]
    net = L.pool2d(net, pool_size=2, pool_stride=2, pool_type='max')
    width, convs = w['conv5']
    net = fluid.nets.img_conv_group(
        input=net, conv_num_filter=[width] * convs, pool_size=1,
        pool_stride=1, conv_filter_size=3, conv_act='relu',
        conv_with_batchnorm=True, pool_type='max')
    net = L.conv2d(net, num_filters=w['fc'], filter_size=3, padding=1,
                   act='relu')
    net = L.conv2d(net, num_filters=w['fc'], filter_size=1, act='relu')
    maps.append(net)
    for mid, width, stride, pad in w['extras']:
        net = L.conv2d(net, num_filters=mid, filter_size=1, act='relu')
        net = L.conv2d(net, num_filters=width, filter_size=3, stride=stride,
                       padding=pad, act='relu')
        maps.append(net)
    return maps


SSD_FEEDS = ['image', 'gt_box', 'gt_label']


def ssd_build(w):
    """SSD over ssd_net's maps: multi_box_head (SSD300's settings, w's
    aspect ratios), ssd_loss, mean, Momentum(w['lr'], w['momentum']) with
    L2Decay(w['l2']). build(fluid) returns {feeds, loss, locs, confs,
    priors, vars, maps}."""
    def build(fluid):
        L = fluid.layers
        img = L.data(name='image', shape=[3, w['hw'], w['hw']],
                     dtype='float32')
        gt_box = L.data(name='gt_box', shape=[w['max_boxes'], 4],
                        dtype='float32')
        gt_label = L.data(name='gt_label', shape=[w['max_boxes']],
                          dtype='int64')
        maps = ssd_net(fluid, img, w)
        locs, confs, priors, pvars = L.multi_box_head(
            maps, img, base_size=w['base_size'], num_classes=w['classes'],
            min_ratio=w['min_ratio'], max_ratio=w['max_ratio'],
            aspect_ratios=w['aspect_ratios'], offset=0.5, flip=True)
        loss = L.mean(L.ssd_loss(locs, confs, gt_box, gt_label, priors,
                                 pvars))
        fluid.optimizer.Momentum(
            learning_rate=w['lr'], momentum=w['momentum'],
            regularization=fluid.regularizer.L2Decay(w['l2'])).minimize(loss)
        return dict(feeds=list(SSD_FEEDS), loss=loss, locs=locs,
                    confs=confs, priors=priors, vars=pvars, maps=maps)
    return build


def ssd_book_build(w):
    """ssd_build for BookRun: (feed names, the outputs, the loss)."""
    def build(fluid):
        out = ssd_build(w)(fluid)
        return out['feeds'], out, out['loss']
    return build


def ssd_feed(rng, w, batch=None):
    """A seeded batch of synthetic scenes: 1..max_boxes boxes an image,
    labels 1..classes-1, each box a filled rectangle in its label's
    colour over noise; gt padded to max_boxes with label -1 and a zero
    box, the detection_map label [B, G, 5] (label, box) beside them."""
    B, hw, G = batch or w['batch'], w['hw'], w['max_boxes']
    colours = np.random.RandomState(SEED).rand(w['classes'], 3) * 2 - 1
    img = (rng.randn(B, 3, hw, hw) * 0.3).astype('float32')
    box = np.zeros((B, G, 4), 'float32')
    label = np.full((B, G), -1, 'int64')
    for b in range(B):
        for g in range(rng.randint(1, G + 1)):
            lo = rng.uniform(0.0, 0.7, 2)
            hi = np.minimum(lo + rng.uniform(0.1, 0.5, 2), 1.0)
            box[b, g] = [lo[0], lo[1], hi[0], hi[1]]
            label[b, g] = rng.randint(1, w['classes'])
            x0, y0, x1, y1 = (box[b, g] * hw).astype(int)
            img[b, :, y0:y1 + 1, x0:x1 + 1] += \
                colours[label[b, g]][:, None, None].astype('float32')
    gt = np.concatenate([np.maximum(label, 0)[..., None].astype('float32'),
                         box], -1)
    return {'image': img, 'gt_box': box, 'gt_label': label, 'gt': gt}


def ssd_train_feed(feed):
    return {n: feed[n] for n in SSD_FEEDS}


def ssd_map_sizes(run):
    """The feature maps' sizes and the prior count the program gives."""
    sizes = [tuple(m.shape[2:]) for m in run.pred['maps']]
    return sizes, int(run.pred['priors'].shape[0])


def ssd_params(program, n_maps):
    """The first and a middle backbone conv, and the first map's two head
    convs (multi_box_head's loc and conf convs, two a map)."""
    convs = [p.name for p in program.global_block().all_parameters()
             if p.name.startswith('conv2d_') and p.name.endswith('.w_0')]
    return (convs[0], convs[len(convs) // 3], convs[-2 * n_maps],
            convs[-2 * n_maps + 1])


def cpu_conv_spread(build, saved, feed, params, optimizer):
    """The CPU port's own spread on one step: the step with oneDNN's
    convolutions against the step with PyTorch's native ones, from the
    same state and feed. {param: the larger of its gradient's (the first
    velocity, sum |diff| / sum |g|) and its update's (gradient-weighted)
    relative differences}."""
    import torch
    import paddle_tpu_torch as fluid
    cpu = BookRun(fluid.CPUPlace(), build, None, 1)
    host = {n: t.cpu() for n, t in saved.items()}
    accs = _sq_accumulators(cpu, params, optimizer)
    states = []
    prev = torch.backends.mkldnn.enabled
    try:
        for onednn in (True, False):
            torch.backends.mkldnn.enabled = onednn
            cpu.restore(host)
            cpu.step(feed)
            states.append({n: cpu.scope.find_var(n).clone()
                           for n in list(params) + accs})
    finally:
        torch.backends.mkldnn.enabled = prev
    a, b = states
    upd = _first_order_diffs(
        {n: (b[n] - host[n]).float() for n in params},
        {n: (a[n] - host[n]).float() for n in params},
        {n: a[m].float() for n, m in zip(params, accs)}, params)
    out = {}
    for n, m in zip(params, accs):
        g = ((a[m].double() - b[m].double()).abs().sum() /
             b[m].double().abs().sum().clamp_min(1e-30)).item()
        out[n] = max(g, upd[n])
    log('the CPU\'s own spread on one step (oneDNN vs native convolutions): '
        '%s' % ', '.join('%s %.3e' % kv for kv in out.items()))
    return out


@phase('det1: SSD300 (VGG-16 conv groups, six maps, 21 classes, batch 32) '
       'trained under Momentum + L2Decay, captured')
def ssd_steps(place, sync, w=None):
    """ssd_build at SSD (300 px, batch 32) on seeded synthetic scenes:
    10 steps over SSD_BATCHES batches twice, captured vs op by op the
    same bits (under cuDNN's deterministic algorithms), the loss falling,
    one capture a device segment; step ms, images/s, device busy, peak
    memory, graphs captured; the map sizes and prior count; then one
    step on SSD_CPU_BATCH images vs the CPU port (loss within
    SQ_CPU_RTOL, gradients (the first velocity) and updates within
    SSD_STEP_TOL or SSD_SPREAD_FACTOR x the CPU's own spread between two
    convolution algorithms, whichever is larger, as r2's rule: the first
    conv's gradient sums ~180,000 products a weight into a small
    difference, where two CPU algorithms already disagree by more than
    SSD_STEP_TOL). Returns the run for det2."""
    w = w or SSD
    with deterministic_convs():
        run = BookRun(place, ssd_book_build(w), None, w['batch'])
        sizes, priors = ssd_map_sizes(run)
        log('det1 SSD (%d px, %d classes): feature maps %s, %d priors'
            % (w['hw'], w['classes'], sizes, priors))
        rng = np.random.RandomState(SEED + 40)
        feeds = [ssd_train_feed(ssd_feed(rng, w))
                 for _ in range(SSD_BATCHES)]
        params = ssd_params(run.main, len(sizes))
        out = _sq_captured(run, 'det1 SSD', feeds * 2, params, 'momentum',
                           sync, profile=True)
        saved = out.pop('saved')
        small = ssd_train_feed(ssd_feed(np.random.RandomState(SEED + 41), w,
                                        SSD_CPU_BATCH))
        spread = cpu_conv_spread(ssd_book_build(w), saved, small, params,
                                 'momentum')
        out['cpu'] = card_vs_cpu(
            run, ssd_book_build(w), saved, small, params, 'momentum',
            'det1 SSD', update_tol=SSD_STEP_TOL, grad_tol=SSD_STEP_TOL,
            floors={n: SSD_SPREAD_FACTOR * v for n, v in spread.items()})
        out['spread'] = spread
        run.restore(saved)
        for f in feeds * 2:
            run.step(f)
    out.update(run=run, sizes=sizes, priors=priors,
               img_s=w['batch'] / out['ms'] * 1e3)
    log('det1 SSD (batch %d, %d px, fp32 Momentum + L2Decay): %d ops, %d '
        'device segments; captured %.3f ms a step (%.1f images/s), op by op '
        '%.3f ms; device %s ms, busy %s; %d graphs captured; peak %.4f GB '
        'allocated over the run\'s start'
        % (w['batch'], w['hw'], out['n_ops'], out['segments'], out['ms'],
           out['img_s'], out['eager_ms'], _fmt_ms(out['device_ms'] or None),
           _fmt_busy(out['busy']), out['stats']['compiled_segments'],
           out['peak_gb']))
    return out


def ssd_decode_program(fluid, w):
    """detection_output (w's NMS settings) and detection_map ('11point',
    overlap 0.5) over fed head outputs: (program, feed names, fetches)."""
    main = fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main,
                                                        fluid.Program()):
        L = fluid.layers
        locs = L.data(name='locs', shape=[-1, 4], dtype='float32')
        scores = L.data(name='scores', shape=[w['classes'], -1],
                        dtype='float32')
        priors = L.data(name='priors', shape=[4], dtype='float32')
        pvars = L.data(name='pvars', shape=[4], dtype='float32')
        gt = L.data(name='gt', shape=[w['max_boxes'], 5], dtype='float32')
        dets, count = L.detection_output(
            locs, scores, priors, pvars, nms_threshold=w['nms_threshold'],
            nms_top_k=w['nms_top_k'], keep_top_k=w['keep_top_k'],
            score_threshold=w['score_threshold'])
        m_ap = L.detection_map(dets, gt, class_num=w['classes'],
                               overlap_threshold=0.5, ap_version='11point')
    return main, [dets, count, m_ap]


def ssd_test_program(run, w):
    """The trained program's test clone with softmax, detection_output
    and detection_map appended: (program, fetches: the decode's inputs,
    the detections, the valid counts, the mAP)."""
    fluid = run.fluid
    test = run.main.clone(for_test=True)
    block = test.global_block()
    with fluid.unique_name.guard('decode_'), \
            fluid.program_guard(test, fluid.Program()):
        L = fluid.layers
        gt = L.data(name='gt', shape=[w['max_boxes'], 5], dtype='float32')
        locs = block.var(run.pred['locs'].name)
        scores = L.transpose(L.softmax(block.var(run.pred['confs'].name)),
                             perm=[0, 2, 1])
        priors = block.var(run.pred['priors'].name)
        pvars = block.var(run.pred['vars'].name)
        dets, count = L.detection_output(
            locs, scores, priors, pvars, nms_threshold=w['nms_threshold'],
            nms_top_k=w['nms_top_k'], keep_top_k=w['keep_top_k'],
            score_threshold=w['score_threshold'])
        m_ap = L.detection_map(dets, gt, class_num=w['classes'],
                               overlap_threshold=0.5, ap_version='11point')
    return test, [locs, scores, priors, pvars, dets, count, m_ap]


def detection_margin(label, got, want, tol=DET_SCORE_TOL):
    """The margin rule for two detection batches (det2): got and want are
    [B, K, 6] rows (label, score, box) in score order. An image agrees if
    every row has the other's label and its score and box within tol.
    Where an image's rows first differ, both scores there must differ by
    at most tol and not be equal (a near tie in the score order: equal
    scores sort by index alike on both devices, so a different row at an
    equal score is an error), and the image is compared no further; at
    most a quarter of the images may end so. Returns (images that agree,
    images ending at a near tie, the largest score difference); raises
    AssertionError otherwise."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape:
        raise AssertionError('%s: detections of shapes %s and %s'
                             % (label, got.shape, want.shape))
    equal, ties, worst = 0, [], 0.0
    for b in range(want.shape[0]):
        for k in range(want.shape[1]):
            g, t = got[b, k], want[b, k]
            ds = abs(g[1] - t[1])
            if g[0] == t[0] and ds <= tol and \
                    np.abs(g[2:] - t[2:]).max() <= tol:
                worst = max(worst, ds)
                continue
            if not (0.0 < ds <= tol):
                raise AssertionError(
                    '%s: image %d, row %d: %s against %s (score difference '
                    '%.3e, tol %g)' % (label, b, k, g.tolist(), t.tolist(),
                                       ds, tol))
            worst = max(worst, ds)
            ties.append((b, k))
            break
        else:
            equal += 1
    if len(ties) > want.shape[0] // 4:
        raise AssertionError('%s: %d of %d images end at a near tie (%s)'
                             % (label, len(ties), want.shape[0], ties))
    return equal, len(ties), worst


@phase('det2: SSD300 decoding (detection_output: NMS 0.45, top 400, keep '
       '200) and detection_map from det1\'s scope, batch 8, captured')
def ssd_decode(det1, place, sync, w=None):
    """det1's trained program's test clone with softmax, detection_output
    and detection_map (11point, overlap 0.5) at w['decode_batch'] images
    on the card (the third run on replays, timed), then the CPU port's
    detection_output and detection_map (ssd_decode_program) on the head
    outputs the card computed: the detections by detection_margin, the
    valid counts equal, the mAP within DET_SCORE_TOL; then the mAP of
    the ground truths mixed into the decoded rows (map_of_mixed). Logs
    ms a decoded batch."""
    import paddle_tpu_torch as fluid
    w = w or SSD
    run = det1['run']
    test, fetch = ssd_test_program(run, w)
    feed = ssd_feed(np.random.RandomState(SEED + 42), w, w['decode_batch'])
    exe = fluid.Executor(place)
    with deterministic_convs():
        got, dec_ms = _timed_runs(exe, test, feed, fetch, run.scope, sync)
    locs, scores, priors, pvars, dets, count, m_ap = (np.asarray(v)
                                                      for v in got)
    main, cpu_fetch = ssd_decode_program(fluid, w)
    want = fluid.Executor(fluid.CPUPlace()).run(
        main, feed={'locs': locs, 'scores': scores, 'priors': priors,
                    'pvars': pvars, 'gt': feed['gt']},
        fetch_list=cpu_fetch, scope=fluid.Scope())
    wdets, wcount, wmap = (np.asarray(v) for v in want)
    margin = detection_margin('det2 detections', dets, wdets)
    map_diff = float(np.abs(m_ap - wmap).max())
    log('det2 SSD decode (batch %d, %d priors, %d classes): %.3f ms a '
        'decoded batch (test clone, replayed); valid detections %s; %d of %d '
        'images equal to the CPU port\'s, %d end at a near tie, scores '
        'within %.3e; mAP (11point) %.6f on the card, %.6f on the CPU '
        '(|diff| %.3e, tol %g)'
        % (w['decode_batch'], priors.shape[0], w['classes'], dec_ms,
           count.tolist(), margin[0], w['decode_batch'], margin[1],
           margin[2], float(m_ap[0]), float(wmap[0]), map_diff,
           DET_SCORE_TOL))
    if not (np.array_equal(count, wcount) and map_diff <= DET_SCORE_TOL and
            np.isfinite(m_ap).all() and (count > 0).all()):
        raise AssertionError('det2: the valid counts or the mAP differ from '
                             'the CPU port\'s (counts %s vs %s)'
                             % (count.tolist(), wcount.tolist()))
    exe.close()
    scored = map_of_mixed(place, dets, feed['gt'], w)
    evaluated = detection_map_evaluator(place, dets, feed['gt'], w)
    return dict(ms=dec_ms, margin=margin, map=float(m_ap[0]),
                map_diff=map_diff, count=count.tolist(), mixed=scored,
                evaluator=evaluated)


def detection_map_evaluator(place, dets, gt, w):
    """fluid.evaluator.DetectionMAP (11point, overlap 0.5) over two
    batches, the two halves of mixed_detections' batch, on the card and
    on the CPU port: reset, two runs, eval(); the two mAPs within
    DET_SCORE_TOL and strictly between 0 and 1. Returns (the card's,
    |diff|)."""
    import paddle_tpu_torch as fluid
    mixed = mixed_detections(dets, gt)
    half = len(mixed) // 2
    got = []
    for p in (place, fluid.CPUPlace()):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard(), fluid.program_guard(main, startup):
            L = fluid.layers
            d = L.data(name='d', shape=list(mixed.shape[1:]),
                       dtype='float32')
            gl = L.data(name='gl', shape=[gt.shape[1], 1], dtype='float32')
            gb = L.data(name='gb', shape=[gt.shape[1], 4], dtype='float32')
            ev = fluid.evaluator.DetectionMAP(
                d, gl, gb, class_num=w['classes'], overlap_threshold=0.5,
                ap_version='11point')
        exe = fluid.Executor(p)
        with fluid.scope_guard(fluid.Scope()):
            exe.run(startup)
            ev.reset(exe)
            for part in (slice(0, half), slice(half, None)):
                exe.run(main, feed={'d': mixed[part],
                                    'gl': gt[part, :, :1],
                                    'gb': gt[part, :, 1:]},
                        fetch_list=ev.metrics)
            got.append(float(ev.eval(exe)))
        exe.close()
    card, cpu = got
    log('det2 evaluator.DetectionMAP over two batches of %d images: %.6f '
        'on the card, %.6f on the CPU' % (half, card, cpu))
    if not (abs(card - cpu) <= DET_SCORE_TOL and 0.0 < card < 1.0):
        raise AssertionError('det2: DetectionMAP %.6f on the card, %.6f on '
                             'the CPU' % (card, cpu))
    return card, abs(card - cpu)


def mixed_detections(dets, gt):
    """The ground truths as detections (their boxes nudged by 1% of the
    image), each scored just under the decoder's row 3g+1 of its image,
    beside the decoder's own rows: a batch whose mAP lies between 0 and
    1 (after 10 steps the decoder's rows alone score 0)."""
    B, K, _ = dets.shape
    G = gt.shape[1]
    rng = np.random.RandomState(SEED + 43)
    own = np.full((B, G, 6), -1.0, 'float32')
    valid = np.abs(gt[..., 1:]).sum(-1) > 0
    own[..., 0] = np.where(valid, gt[..., 0], -1)
    at = np.minimum(3 * np.arange(G) + 1, K - 1)
    near = dets[:, at, 1]
    own[..., 1] = np.where(valid, np.where(near > 0, near - 1e-3, 0.5), -1)
    own[..., 2:] = np.where(valid[..., None], gt[..., 1:] + 0.01 *
                            rng.randn(B, G, 4), -1)
    return np.concatenate([own, dets[:, :K - G]], 1).astype('float32')


def map_of_mixed(place, dets, gt, w):
    """detection_map (11point, overlap 0.5) of mixed_detections on the
    card and on the CPU: equal within DET_SCORE_TOL, and strictly
    between 0 and 1. Returns (the card's mAP, |diff|)."""
    import paddle_tpu_torch as fluid
    mixed = mixed_detections(dets, gt)
    got = {}
    for p in (place, fluid.CPUPlace()):
        main = fluid.Program()
        with fluid.unique_name.guard(), \
                fluid.program_guard(main, fluid.Program()):
            d = fluid.layers.data(name='d', shape=list(mixed.shape[1:]),
                                  dtype='float32')
            g = fluid.layers.data(name='g', shape=list(gt.shape[1:]),
                                  dtype='float32')
            m = fluid.layers.detection_map(d, g, class_num=w['classes'],
                                           overlap_threshold=0.5,
                                           ap_version='11point')
        got[p.device.type] = float(np.asarray(fluid.Executor(p).run(
            main, feed={'d': mixed, 'g': gt}, fetch_list=[m],
            scope=fluid.Scope())[0])[0])
    card, cpu = got[place.device.type], got['cpu']
    log('det2 detection_map of the ground truths mixed into the decoded '
        'rows: %.6f on the card, %.6f on the CPU' % (card, cpu))
    if not (abs(card - cpu) <= DET_SCORE_TOL and 0.0 < card < 1.0):
        raise AssertionError('det2: the mixed batch\'s mAP %.6f on the card, '
                             '%.6f on the CPU' % (card, cpu))
    return card, abs(card - cpu)


# -- moe1, moe2: the flagship LM's mixture-of-experts form ----------------------

# TransformerConfig(moe_experts=4): each block's FFN a top-1 mixture of 4
# experts of [2048, 8192] at capacity factor 2.0 (moe_layer's defaults),
# the LM cut to 6 layers (for the script's time);
# t1's recipe otherwise (py_reader, batch 8, AMP Momentum,
# ParallelExecutor, captured), MOE_STEPS steps over two batches in turn
MOE_MODEL = dict(MODEL, moe_experts=4, layers=6)
MOE_WARMUP, MOE_TIMED = 2, 8
MOE_BITS_STEPS = 3           # captured vs op by op from one saved state
MOE_PEAK_GB = RESNET_PEAK_GB  # reserved memory, r1's rule
# moe2: one full-width sequence through moe_ffn + moe_aux_loss in fp32
MOE2 = dict(S=512, D=2048, H=8192, E=4, k=1, cf=2.0)
MOE_CPU_RTOL = 1e-4          # card vs CPU: sum |diff| / sum |cpu|
MOE_DENSE_TOL = 1e-5         # top-k at ample capacity vs dense, / max |dense|
MOE_TIE = 1e-6               # a top-1 flip only where the top two gates tie
MOE_FLOPS_RTOL = 0.10        # counted FLOPs at E and 2E


def moe_checksums(scope, names):
    """{name: the int64 sum of the tensor's 32- (or 16-) bit words}: two
    states with equal checksums for every name hold the same bits but by
    a vanishing chance."""
    import torch
    out = {}
    for n in names:
        t = scope.find_var(n).detach().contiguous()
        words = t.view(torch.int16 if t.element_size() == 2 else torch.int32)
        out[n] = int(words.to(torch.int64).sum())
    return out


def moe_bits(tr, batches, place, sync):
    """MOE_BITS_STEPS steps of the MoE LM from one saved state (a host
    copy) under the split arm, whose backward kernels have no atomics:
    through a fresh ParallelExecutor (eager, captured, replayed) and op
    by op (use_program_cache=False). Returns (the same bits: losses and
    every persistable's checksum; the losses of each run)."""
    import itertools
    import paddle_tpu_torch as fluid
    saved = {n: tr.scope.find_var(n).detach().cpu().clone()
             for n in tr.persistables}
    runs = {}
    with flash_arms(None, 'split'):
        for form in ('captured', 'op by op'):
            tr.restore(saved)
            tr.feed(lambda: itertools.cycle(batches))
            if form == 'captured':
                tr.fresh_executor()
                step = tr.step
            else:
                tr.drop_graphs()
                exe = fluid.Executor(place)

                def step():
                    return float(np.asarray(exe.run(
                        tr.main, fetch_list=[tr.avg_cost.name],
                        scope=tr.scope, use_program_cache=False)[0]))
            losses = [step() for _ in range(MOE_BITS_STEPS)]
            sync()
            runs[form] = (losses, moe_checksums(tr.scope, tr.persistables))
            tr.reader.reset()
    tr.restore(saved)
    del saved
    same = runs['captured'] == runs['op by op']
    log('moe1 captured vs op by op, %d steps from one state (split arm): '
        'losses %s vs %s; every persistable the same bits: %s'
        % (MOE_BITS_STEPS, runs['captured'][0], runs['op by op'][0], same))
    if not same:
        bad = [n for n in tr.persistables
               if runs['captured'][1][n] != runs['op by op'][1][n]]
        raise AssertionError('moe1: the captured steps differ from the op by '
                             'op steps (%d persistables, %s ...)'
                             % (len(bad), bad[:4]))
    return same, runs['captured'][0]


@phase('moe1: train the flagship LM in its mixture-of-experts form (4 '
       'experts, top-1, AMP Momentum, py_reader, ParallelExecutor)')
def moe_steps(place, counters, sync, model=None, batch=None):
    """TransformerConfig(**MOE_MODEL) trained with t1's recipe:
    MOE_WARMUP + MOE_TIMED steps over two batches in turn (the loss
    falls on each), timed on the replays; on the card K1 and K2 launch
    `layers` times a step (the wrappers' counts and
    check_replay_launches), the flash path never runs its plain version,
    reserved memory stays under MOE_PEAK_GB, and the step is profiled
    (device ms, busy share, ms by kind). Then moe_bits, and the executed
    FLOPs of one op-by-op step (FlopCounterMode with the flash pricing,
    obs/perf.py's segment_cost)."""
    import itertools
    import torch
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.models.transformer import TransformerConfig
    from paddle_tpu_torch.obs import perf
    on_card = place.device.type == 'cuda'
    cfg = TransformerConfig(**(model or MOE_MODEL))
    batch = batch or TRAIN_BATCH
    t0 = time.perf_counter()
    tr = LMRun(cfg, place, batch, HEAD_CHUNK, 'moe_reader')
    params = [v for v in tr.main.list_vars()
              if v.persistable and getattr(v, 'trainable', False)]
    n_params = sum(int(np.prod(v.shape)) for v in params)
    n_expert = sum(int(np.prod(v.shape)) for v in params
                   if len(v.shape) == 3)
    ops = tr.main.global_block().ops
    log('moe1 program: %d ops (%d moe_ffn), %d parameters (%d in the '
        'experts, %.2f GB fp32), batch %d x %d tokens; built and '
        'initialised in %.1f s'
        % (len(ops), sum(o.type == 'moe_ffn' for o in ops), n_params,
           n_expert, n_params * 4 / 1e9, batch, cfg.max_len,
           time.perf_counter() - t0))
    rng = np.random.RandomState(SEED + 50)
    batches = [tr.batch_of(rng) for _ in range(2)]
    tr.feed(lambda: itertools.cycle(batches))
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    losses = [tr.step(sync_checked=on_card)]
    losses += [tr.step() for _ in range(MOE_WARMUP - 1)]
    sync()
    for c in counters.values():
        c.launches = 0
    fa.FlashAttention.plain_cuda_calls = 0
    t0 = time.perf_counter()
    losses += [tr.step() for _ in range(MOE_TIMED)]
    sync()
    step_ms = (time.perf_counter() - t0) / MOE_TIMED * 1e3
    launches = {name: c.launches for name, c in counters.items()}
    tokens = batch * cfg.max_len
    out = dict(losses=losses, ms=step_ms, tok_s=tokens / step_ms * 1e3,
               n_params=n_params, n_expert=n_expert, launches=launches)
    log('moe1 losses: %s; %d timed steps %.3f ms a step, %.1f tokens/s; '
        'launches %s' % (', '.join('%.6f' % x for x in losses), MOE_TIMED,
                         step_ms, out['tok_s'], json.dumps(launches)))
    if not all(np.isfinite(losses)):
        raise AssertionError('moe1: a loss is not finite: %r' % losses)
    n = len(losses)
    if not (losses[n - 2] < losses[0] and losses[n - 1] < losses[1]):
        raise AssertionError('moe1: the loss does not fall on each batch: %r'
                             % losses)
    if on_card:
        out['peak_gb'] = peak_memory_gb()
        out['reserved_gb'] = torch.cuda.max_memory_reserved() / 1e9
        if out['reserved_gb'] > MOE_PEAK_GB:
            raise AssertionError('moe1: %.2f GB reserved, over %g GB'
                                 % (out['reserved_gb'], MOE_PEAK_GB))
        require_no_plain(fa, 'moe1')
        need = cfg.layers * MOE_TIMED
        for kind in ('fwd', 'k2'):
            name = KERNELS[kind][0]
            if launches[name] != need:
                raise AssertionError('moe1: %s launched %d times in %d '
                                     'steps, want %d' % (name,
                                                         launches[name],
                                                         MOE_TIMED, need))
        others = [KERNELS[kd][0] for kd in ('k3a', 'k3b', 'k4a', 'k4b',
                                            'k5')]
        if any(launches[n] for n in others):
            raise AssertionError('moe1: K3, K4 or K5 launched: %r'
                                 % launches)
        kinds = {}
        out['device_ms'], out['busy'] = _profile_steps(
            tr, step_ms, sync, 'moe1 step', by_kind_out=kinds)
        out['kinds'] = kinds
        seen = check_replay_launches('moe1', tr.step, sync)
        if (seen.get('K1'), seen.get('K2/K5')) != (cfg.layers, cfg.layers):
            raise AssertionError('moe1: a replayed step launched K1 %s and '
                                 'K2 %s times, want %d each'
                                 % (seen.get('K1'), seen.get('K2/K5'),
                                    cfg.layers))
    tr.reader.reset()
    out['bits'], out['bits_losses'] = moe_bits(tr, batches, place, sync)
    tr.drop_graphs()
    exe = fluid.Executor(place)
    tr.feed(lambda: itertools.cycle(batches))
    out['flops'] = perf.segment_cost(lambda: exe.run(
        tr.main, fetch_list=[tr.avg_cost.name], scope=tr.scope,
        use_program_cache=False))
    tr.reader.reset()
    exe.close()
    log('moe1: %.4f TFLOP executed a step (FlopCounterMode and the flash '
        'work model), %.1f TFLOP/s at the timed step'
        % (out['flops'] / 1e12, out['flops'] / step_ms / 1e9))
    return out


def moe2_program(fluid, w, dispatch='topk', capacity_factor=None,
                 loss='out'):
    """One [S, D] sequence: a softmax gate from a fed [D, E] weight,
    moe_ffn over fed experts and moe_aux_loss. loss 'out': sum(out *
    cot) and the grads of x and both experts (the gate weight's grad on
    this path is rounding noise: top-1's renormalised weight is 1);
    loss 'aux': the aux loss and the gate weight's grad.
    (program, fetches)."""
    S, D, H, E = w['S'], w['D'], w['H'], w['E']
    prog = fluid.Program()
    block = prog.global_block()
    with fluid.program_guard(prog, fluid.Program()):
        L = fluid.layers

        def data(name, shape, grad=True):
            return L.data(name=name, shape=list(shape), dtype='float32',
                          append_batch_size=False, stop_gradient=not grad)
        x, gw = data('x', (S, D)), data('gate_w', (D, E))
        w_up, w_down = data('w_up', (E, D, H)), data('w_down', (E, H, D))
        cot = data('cot', (S, D), grad=False)
        gate = L.softmax(L.matmul(x, gw))
        out, aux = block.create_var(name='moe_out'), \
            block.create_var(name='moe_aux')
        block.append_op(type='moe_ffn',
                        inputs={'X': [x], 'Gate': [gate], 'WUp': [w_up],
                                'WDown': [w_down]},
                        outputs={'Out': [out]},
                        attrs={'k': w['k'], 'dispatch': dispatch,
                               'capacity_factor': capacity_factor or w['cf'],
                               'act': 'gelu'})
        block.append_op(type='moe_aux_loss', inputs={'Gate': [gate]},
                        outputs={'Out': [aux]})
        if loss == 'aux':
            grads = fluid.backward.calc_gradient(aux, [gw])
            return prog, [gate, aux] + grads
        grads = fluid.backward.calc_gradient(
            L.reduce_sum(L.elementwise_mul(out, cot)), [x, w_up, w_down])
    return prog, [gate, out] + grads


def moe2_feed(w, seed=SEED + 51):
    rng = np.random.RandomState(seed)
    S, D, H, E = w['S'], w['D'], w['H'], w['E']
    return {'x': rng.randn(S, D).astype('float32'),
            'gate_w': (rng.randn(D, E) * D ** -0.5).astype('float32'),
            'w_up': (rng.randn(E, D, H) * D ** -0.5).astype('float32'),
            'w_down': (rng.randn(E, H, D) * H ** -0.5).astype('float32'),
            'cot': rng.randn(S, D).astype('float32')}


def moe2_routing(label, gate_card, gate_cpu, w):
    """Top-1 experts of the two gates equal, or where they differ, the
    two largest gates within MOE_TIE of each other on both sides; the
    tokens dropped past capacity equal. Returns (flips, dropped)."""
    import math
    C = max(1, int(math.ceil(w['S'] * w['k'] * w['cf'] / w['E'])))
    flips, dropped = 0, []
    for g in (gate_card, gate_cpu):
        top = np.argmax(g, -1)
        dropped.append(int(sum(max(0, int((top == e).sum()) - C)
                               for e in range(w['E']))))
    a, b = np.argmax(gate_card, -1), np.argmax(gate_cpu, -1)
    for s in np.nonzero(a != b)[0]:
        for g in (gate_card, gate_cpu):
            top2 = np.sort(g[s])[-2:]
            if top2[1] - top2[0] > MOE_TIE:
                raise AssertionError('%s: token %d goes to expert %d on the '
                                     'card, %d on the CPU, gates %.3e apart'
                                     % (label, s, a[s], b[s],
                                        top2[1] - top2[0]))
        flips += 1
    if flips == 0 and dropped[0] != dropped[1]:
        raise AssertionError('%s: %d tokens dropped on the card, %d on the '
                             'CPU' % (label, dropped[0], dropped[1]))
    return flips, dropped[0]


@phase('moe2: moe_ffn and moe_aux_loss at one full-width sequence (S 512, '
       'D 2048, H 8192, 4 experts, fp32), forward and grads, vs the CPU port')
def moe_op_check(place, sync, w=None):
    """moe2_program's two paths on the card (the third run replayed and
    timed) against the CPU port on the same feed: each output and grad
    within MOE_CPU_RTOL by sum |diff| / sum |cpu|; the routing by moe2_routing;
    top-k at ample capacity (capacity factor E) against dense on the
    card, forward, within MOE_DENSE_TOL of max |dense|; the FLOPs
    FlopCounterMode counts for one op-by-op run at E and 2E experts
    (capacity halving) within MOE_FLOPS_RTOL."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.obs import perf
    w = w or MOE2
    feed = moe2_feed(w)
    diffs, ms, finite = {}, {}, True
    for path in ('out', 'aux'):
        prog, fetch = moe2_program(fluid, w, loss=path)
        exe = fluid.Executor(place)
        for _ in range(2):
            exe.run(prog, feed=feed, fetch_list=fetch, scope=fluid.Scope())
        sync()
        t0 = time.perf_counter()
        card = exe.run(prog, feed=feed, fetch_list=fetch, scope=fluid.Scope())
        sync()
        ms[path] = (time.perf_counter() - t0) * 1e3
        exe.close()
        cpu = fluid.Executor(fluid.CPUPlace()).run(
            prog, feed=feed, fetch_list=fetch, scope=fluid.Scope())
        for v, a, b in zip(fetch, card, cpu):
            a, b = np.asarray(a, 'float64'), np.asarray(b, 'float64')
            diffs['%s %s' % (path, v.name)] = float(
                np.abs(a - b).sum() / max(np.abs(b).sum(), 1e-30))
        finite = finite and all(np.isfinite(np.asarray(v)).all()
                                for v in card)
        if path == 'out':
            gates = np.asarray(card[0]), np.asarray(cpu[0])
    ms = ms['out']
    flips, dropped = moe2_routing('moe2', gates[0], gates[1], w)
    dense_prog, dense_fetch = moe2_program(fluid, w, 'dense')
    ample_prog, ample_fetch = moe2_program(fluid, w, 'topk',
                                           capacity_factor=float(w['E']))
    exe = fluid.Executor(place)
    dense = np.asarray(exe.run(dense_prog, feed=feed,
                               fetch_list=dense_fetch[1:2],
                               scope=fluid.Scope())[0])
    ample = np.asarray(exe.run(ample_prog, feed=feed,
                               fetch_list=ample_fetch[1:2],
                               scope=fluid.Scope())[0])
    exe.close()
    dense_err = float(np.abs(ample - dense).max() /
                      max(np.abs(dense).max(), 1e-30))
    flops = {}
    for e in (w['E'], 2 * w['E']):
        we = dict(w, E=e)
        p, f = moe2_program(fluid, we)
        fd = moe2_feed(we)
        ex = fluid.Executor(place)
        flops[e] = perf.segment_cost(lambda: ex.run(
            p, feed=fd, fetch_list=f, scope=fluid.Scope(),
            use_program_cache=False))
        ex.close()
    flops_rel = abs(flops[2 * w['E']] - flops[w['E']]) / flops[w['E']]
    log('moe2 (S %d, D %d, H %d, E %d, top-%d, capacity factor %g, fp32): '
        'forward + grads %.3f ms replayed (the out path); card vs CPU sum '
        '|diff| / sum |cpu| of the out path (sum(out * cot): gate, out, '
        'x, experts) and the aux path (aux loss, gate weight): %s (tol %g); '
        'top-1 flips %d (near ties), %d tokens dropped '
        'on both; top-k at ample capacity vs dense %.3e of max |dense| (tol '
        '%g); counted FLOPs %.4f TFLOP at E %d, %.4f at E %d (%.2f%% apart, '
        'tol %g%%)'
        % (w['S'], w['D'], w['H'], w['E'], w['k'], w['cf'], ms,
           ', '.join('%s %.3e' % kv for kv in diffs.items()), MOE_CPU_RTOL,
           flips, dropped, dense_err, MOE_DENSE_TOL,
           flops[w['E']] / 1e12, w['E'], flops[2 * w['E']] / 1e12,
           2 * w['E'], 100 * flops_rel, 100 * MOE_FLOPS_RTOL))
    if not (all(v <= MOE_CPU_RTOL for v in diffs.values()) and
            dense_err <= MOE_DENSE_TOL and flops_rel <= MOE_FLOPS_RTOL and
            finite):
        raise AssertionError('moe2: beyond the stated tolerance')
    return dict(ms=ms, diffs=diffs, flips=flips, dropped=dropped,
                dense_err=dense_err, flops=flops)


# -- pf1: fluid.profiler over the captured flagship LM step -------------------

PF_STEPS = 3                 # replayed steps under the profiler
# a kernel slice in the merged timeline or the report lies inside a
# train_step span within this (the host and device clocks are converted
# apart: perf_counter + its offset, the trace's baseTimeNanoseconds)
PF_SLACK_MS = 1.0
FLASH_LABELS = {'K1': re.compile(r'^flash_attention\.\d+$'),
                'K2/K5': re.compile(r'^flash_attention_grad\.\d+$')}
OP_LABEL = re.compile(r'^[A-Za-z_]\w*\.\d+$')


def tpu_place_drive(fluid, place=None, steps=200):
    """The verify skill's canonical drive as written for the JAX package
    (fit_a_line: fc over 13 features, SGD(0.01), 200 batches of 32), run
    through fluid.Executor(fluid.TPUPlace()) (here CUDAPlace(0)). Returns
    (first loss, last loss); the last must be under 5% of the first."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name='x', shape=[13], dtype='float32')
        y = fluid.layers.data(name='y', shape=[1], dtype='float32')
        pred = fluid.layers.fc(input=x, size=1)
        loss = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
        fluid.optimizer.SGD(0.01).minimize(loss)
    exe = fluid.Executor(place or fluid.TPUPlace())
    scope = fluid.Scope()
    rng = np.random.RandomState(0)
    w = rng.randn(13, 1).astype('f4')
    losses = []
    with fluid.scope_guard(scope):
        exe.run(startup)
        for _ in range(steps):
            xb = rng.randn(32, 13).astype('f4')
            l, = exe.run(main, feed={'x': xb, 'y': xb @ w},
                         fetch_list=[loss])
            losses.append(float(np.asarray(l)))
    if not losses[-1] < 0.05 * losses[0]:
        raise AssertionError('the TPUPlace drive did not converge: %r'
                             % losses[::50])
    return losses[0], losses[-1]


def flash_counts(events):
    """{launch group: launches} among device events (dicts of
    fluid.profiler.device_events), by kernel name."""
    out = {}
    for e in events:
        group = launch_group(e['name'])
        if group:
            out[group] = out.get(group, 0) + 1
    return out


def unlabeled_flash(events):
    """The K1 and K2 launches of graph runs (phase capture or replay)
    whose label is not their flash op's `<type>.<idx>`: [(group, name,
    label)]."""
    bad = []
    for e in events:
        group = launch_group(e['name'])
        if group in FLASH_LABELS and e['phase'] in ('capture', 'replay') \
                and not FLASH_LABELS[group].match(e['label']):
            bad.append((group, e['name'], e['label']))
    return bad


def labeled_share(events):
    """The share of the replays' device time that carries an op label
    (`<type>.<idx>`), or None if there is no replay."""
    total = labeled = 0
    for e in events:
        if e['phase'] == 'replay':
            total += e['dur_ns']
            if OP_LABEL.match(e['label']):
                labeled += e['dur_ns']
    return labeled / total if total else None


def is_kernel_slice(name):
    """A device slice that is a kernel, not a copy or a memset (the
    double buffer's host-to-device copies run between the steps)."""
    return not name.startswith(('Memcpy', 'Memset'))


def outside_spans(slices, spans, slack_us):
    """The largest distance (us) by which a slice (ts, dur) leaves every
    span (ts, dur) that overlaps it, 0.0 if each lies inside one; a
    slice that overlaps no span counts by its distance to the nearest."""
    worst = 0.0
    for s0, sd in slices:
        s1 = s0 + sd
        best = None
        for t0, td in spans:
            t1 = t0 + td
            out = max(t0 - s0, s1 - t1, 0.0)
            best = out if best is None else min(best, out)
        worst = max(worst, best if best is not None else float('inf'))
    return worst if worst > slack_us else 0.0


def check_profiled_steps(host_trace, events, counted, per_step, steps):
    """pf1's checks of one profiled window: the host trace holds `steps`
    train_step events, device_segment: events and the read op's
    host_op:read; the device trace counts K1 and K2 per_step x steps
    times each, which the wrappers counted (`counted`, {group:
    launches}) too. Returns the device counts; raises otherwise."""
    names = [e['name'] for e in host_trace['traceEvents']
             if e.get('ph') == 'X']
    n_steps = names.count('train_step')
    if n_steps != steps or 'host_op:read' not in names or not any(
            n.startswith('device_segment:') for n in names):
        raise AssertionError('the host trace holds %d train_step events '
                             '(want %d), host_op:read %s, device_segment: %s'
                             % (n_steps, steps, 'host_op:read' in names,
                                any(n.startswith('device_segment:')
                                    for n in names)))
    seen = flash_counts(events)
    want = {g: per_step * steps for g in FLASH_LABELS}
    got = {g: (seen.get(g, 0), counted[g]) for g in FLASH_LABELS}
    if any(s != w or c != w for (s, c), w in
           zip(got.values(), want.values())):
        raise ShortWindow('K1, K2 {group: (profiled, counted)} %r, want %r '
                          'each' % (got, want))
    return {g: seen.get(g, 0) for g in FLASH_LABELS}


class ShortWindow(AssertionError):
    """A profiled window whose device counts fell short of the wrappers'
    (the profiler drops events near a window's edge late in a long
    process): taken again with a longer pad."""


def _counted(before, after, groups=FLASH_LABELS):
    return {g: sum(after[n] - before[n] for n in LAUNCH_GROUPS[g])
            for g in groups}


def _profiled_window(prof, path, pad, run, steps):
    """`steps` calls of run(), each a RecordEvent('train_step'), inside
    fluid.profiler.profiler('All', 'total', path), padded by `pad`
    seconds inside the block. Returns the wrappers' counts before and
    after."""
    before = wrapper_counts()
    with prof.profiler('All', 'total', path):
        time.sleep(pad)
        for _ in range(steps):
            with prof.RecordEvent('train_step'):
                run()
        time.sleep(pad)
    return before, wrapper_counts()


def _retrying(label, attempt):
    """attempt(pad) for each pad of WINDOW_PADS_S until it returns; a
    ShortWindow, or a session that lost its device trace, is taken again
    with the next pad; the last one raises."""
    for i, pad in enumerate(WINDOW_PADS_S):
        try:
            return attempt(pad)
        except (ShortWindow, RuntimeError) as e:
            if not isinstance(e, ShortWindow) and \
                    'no device activity' not in str(e):
                raise
            if i == len(WINDOW_PADS_S) - 1:
                raise
            log('%s: %s (window padded by %g s); trying again'
                % (label, e, pad))
    raise AssertionError('unreachable')


@phase('pf1: fluid.profiler over the captured flagship LM step (3 replays), '
       'the timeline and the report; a fresh prepared program from its '
       'first run')
def profile_lm_steps(tr, per_step, sync, build_root, place=None):
    fluid = tr.fluid
    prof = fluid.profiler
    from paddle_tpu_torch.tools import timeline
    t0 = time.perf_counter()
    root = scratch(tempfile.mkdtemp(dir=build_root))
    drive = tpu_place_drive(fluid, place)
    log('the verify skill\'s drive through fluid.Executor(fluid.TPUPlace()): '
        'loss %.4f -> %.6f in 200 steps' % drive)
    tr.feed(bench_provider(tr.cfg, tr.batch, np.random.RandomState(2)))
    tr.step()
    sync()
    path = os.path.join(root, 'replayed')
    obs_dir = os.path.join(root, 'obs')

    def replayed(pad):
        shutil.rmtree(obs_dir, ignore_errors=True)
        fluid.obs.trace.enable(obs_dir, role='pf1')
        try:
            before, after = _profiled_window(prof, path, pad, tr.step,
                                             PF_STEPS)
        finally:
            fluid.obs.trace.disable()
        with open(path) as f:
            host = json.load(f)
        events = prof.device_events(path + '.xplane',
                                    prof.read_op_maps(path + '.hlo'))
        counted = _counted(before, after)
        return check_profiled_steps(host, events, counted, per_step,
                                    PF_STEPS), events, counted
    seen, events, counted = _retrying('pf1 replays', replayed)
    log('pf1: %d replayed steps under fluid.profiler: K1 %d, K2 %d device '
        'launches (%d a step, as the wrappers counted and as t1), %d device '
        'events in all' % (PF_STEPS, seen['K1'], seen['K2/K5'], per_step,
                           len(events)))
    # the timeline tool and the report on that capture: the device lane,
    # its kernels inside the train_step spans on one clock
    tl_path = os.path.join(root, 'timeline.json')
    timeline.main(['--profile_path', path, '--timeline_path', tl_path,
                   '--xplane_dir', path + '.xplane', '--hlo_dir',
                   path + '.hlo'])
    with open(tl_path) as f:
        tl = json.load(f)['traceEvents']
    steps = [(e['ts'], e['dur']) for e in tl
             if e.get('name') == 'train_step']
    kernels = [(e['ts'], e['dur']) for e in tl if e.get('pid') == 1 and
               e.get('ph') == 'X' and is_kernel_slice(e['name'])]
    tl_out = outside_spans(kernels, steps, PF_SLACK_MS * 1e3)
    report, _ = fluid.obs.report.write_report(
        obs_dir, xplane_dir=path + '.xplane', hlo_dir=path + '.hlo')
    lanes = {e['pid']: e['args']['name'] for e in report['traceEvents']
             if e.get('ph') == 'M'}
    spans = [e for e in report['traceEvents'] if e.get('ph') == 'X']
    device_lane = 'device:%s:0' % ('GPU' if tr.use_cuda else 'CPU')
    r_steps = [(e['ts'], e['dur']) for e in spans
               if e['name'] == 'train_step' and lanes[e['pid']] == 'pf1']
    r_kernels = [(e['ts'], e['dur']) for e in spans
                 if lanes[e['pid']] == device_lane and
                 is_kernel_slice(e['name'])]
    r_out = outside_spans(r_kernels, r_steps, PF_SLACK_MS * 1e3)
    log('pf1: timeline %d train_step spans, %d kernel slices on the device '
        'lane, outside by %.1f us; report lanes %s, %d train_step spans, '
        '%d kernel slices, outside by %.1f us'
        % (len(steps), len(kernels), tl_out, sorted(lanes.values()),
           len(r_steps), len(r_kernels), r_out))
    if len(steps) != PF_STEPS or not kernels or tl_out or \
            len(r_steps) != PF_STEPS or not r_kernels or r_out or \
            device_lane not in lanes.values():
        raise AssertionError('the merged timeline or the report does not '
                             'hold the device lane inside the train_step '
                             'spans')

    # a fresh prepared program from its first run: warm-up (eager, the
    # op ranges), capture, then replays labeled through the op maps
    fresh = os.path.join(root, 'fresh')
    n_runs = WARMUP_STEPS + PF_STEPS

    def first_runs(pad):
        tr.drop_graphs()
        before, after = _profiled_window(prof, fresh, pad, tr.step, n_runs)
        with open(fresh) as f:
            host = json.load(f)
        events = prof.device_events(fresh + '.xplane',
                                    prof.read_op_maps(fresh + '.hlo'))
        counted = _counted(before, after)
        return check_profiled_steps(host, events, counted, per_step,
                                    n_runs), events, counted
    seen2, events2, counted2 = _retrying('pf1 fresh program', first_runs)
    bad = unlabeled_flash(events2)
    replays = flash_counts([e for e in events2 if e['phase'] == 'replay'])
    share = labeled_share(events2)
    maps = prof.read_op_maps(fresh + '.hlo')
    log('pf1: a fresh prepared program, %d runs (warm-up, capture, %d '
        'replays): K1 %d, K2 %d launches, %d of them in replays; op maps of '
        '%d segments (%d kernels); K1/K2 graph launches without their flash '
        'op\'s label: %d; labeled share of the replays\' device time %s'
        % (n_runs, PF_STEPS, seen2['K1'], seen2['K2/K5'],
           sum(replays.get(g, 0) for g in FLASH_LABELS), len(maps),
           sum(len(k) for k in maps.values()), len(bad),
           'not measured' if share is None else '%.1f%%' % (100 * share)))
    if bad or any(replays.get(g, 0) != per_step * PF_STEPS
                  for g in FLASH_LABELS):
        raise AssertionError('K1/K2 replay launches unlabeled %r or short: '
                             '%r' % (bad[:5], replays))
    tr.reader.reset()
    tr.drop_graphs()
    seconds = time.perf_counter() - t0
    return dict(counts=seen, fresh=seen2, share=share, tl_out=tl_out,
                r_out=r_out, drive=drive, seconds=seconds,
                maps=len(maps), launches={
                    g: counted[g] + counted2[g] for g in FLASH_LABELS})


# -- rf1: ResNet-50 trained from record shards --------------------------------

# tools/bench_input_pipeline.py's full configuration, at 128 records a
# file: 8 shards of u8 CHW records written with max_num_records=64 (154 MB),
# open_files(thread_num=4, pass_num=0, image_norm=ImageNet mean/std)
RF = dict(files=8, records=128, per_chunk=64, threads=4, decode_s=2.0,
          warmup=3, iters=5)
IMAGENET_NORM = dict(mean=[0.485, 0.456, 0.406], std=[0.229, 0.224, 0.225])
RF_IMAGE_ATOL = 1e-6         # a fed image vs (x/255 - mean)/std of a record


def write_image_shards(dirname, n_files, recs_per_file, shape, per_chunk,
                       seed=SEED):
    """tools/bench_input_pipeline.py's write_shards (:35-47): u8 CHW
    images and int64 labels in [0, 1000) from a seeded stream, one
    RecordIOWriter(max_num_records=per_chunk) a file. Returns (paths,
    {md5 of a record's image bytes: (u8 image, label)})."""
    import hashlib
    from paddle_tpu_torch.recordio import RecordIOWriter
    rng = np.random.RandomState(seed)
    paths, records = [], {}
    for f in range(n_files):
        p = os.path.join(dirname, 'imagenet-%03d.recordio' % f)
        with RecordIOWriter(p, max_num_records=per_chunk) as w:
            for _ in range(recs_per_file):
                img = rng.randint(0, 256, shape, dtype='uint8')
                label = rng.randint(0, 1000, (1,)).astype('int64')
                w.append_sample([img, label])
                records[hashlib.md5(img.tobytes()).hexdigest()] = \
                    (img, int(label[0]))
        paths.append(p)
    return paths, records


def normalized(img, norm):
    """(x/255 - mean[c]) / std[c] in fp32, as the native decode does."""
    mean = np.asarray(norm['mean'], 'f4').reshape(-1, 1, 1)
    std = np.asarray(norm['std'], 'f4').reshape(-1, 1, 1)
    return (img.astype('f4') / np.float32(255.0) - mean) / std


def check_read_slots(images, labels, records, norm, atol=RF_IMAGE_ATOL):
    """Each fed image is (x/255 - mean)/std of a record within atol, and
    its label that record's: the record is found by the u8 bytes the
    image rounds back to. Returns the worst |diff|; raises naming the
    first image no record gave, or whose label or values differ."""
    import hashlib
    mean = np.asarray(norm['mean'], 'f4').reshape(-1, 1, 1)
    std = np.asarray(norm['std'], 'f4').reshape(-1, 1, 1)
    labels = np.asarray(labels).reshape(-1)
    worst = 0.0
    for i, img in enumerate(np.asarray(images)):
        u8 = np.clip(np.rint((img * std + mean) * 255.0), 0, 255)
        rec = records.get(hashlib.md5(u8.astype('uint8').tobytes())
                          .hexdigest())
        if rec is None:
            raise AssertionError('fed image %d is no record of the shards'
                                 % i)
        if int(labels[i]) != rec[1]:
            raise AssertionError('fed image %d has label %d, its record %d'
                                 % (i, int(labels[i]), rec[1]))
        worst = max(worst, float(np.abs(img - normalized(rec[0], norm))
                                 .max()))
    if worst > atol:
        raise AssertionError('a fed image is %.3e from its record\'s '
                             'decode, over %g' % (worst, atol))
    return worst


def decode_throughput(paths, shape, n_threads, seconds, norm):
    """tools/bench_input_pipeline.py's decode_throughput (:50): samples
    a second drained from the native decode scanner at `n_threads`."""
    from paddle_tpu_torch.recordio import ParallelImageScanner
    n = 0
    t0 = time.perf_counter()
    with ParallelImageScanner(paths, shape, mean=norm['mean'],
                              std=norm['std'], n_threads=n_threads,
                              capacity=8, loop=True) as sc:
        for imgs, _ in sc:
            n += imgs.shape[0]
            if time.perf_counter() - t0 > seconds:
                break
    return n / (time.perf_counter() - t0)


def rf_program(paths, threads, norm, batch):
    """tools/bench_input_pipeline.py's `pipeline` chain (:73-82) over r1's
    network, built as resnet_program builds r1's: open_files(thread_num,
    pass_num=0, image_norm) -> batch -> double_buffer -> read_file ->
    train_network(depth=50, NCHW) -> AMP Momentum(0.01, 0.9). Returns
    (main, startup, reader, avg_cost)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import resnet
    hw = RESNET['image_hw']
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        rdr = fluid.layers.open_files(
            paths, shapes=[(-1, 3, hw, hw), (-1, 1)],
            dtypes=['float32', 'int64'], thread_num=threads, pass_num=0,
            image_norm=norm)
        rdr = fluid.layers.batch(rdr, batch_size=batch)
        rdr = fluid.layers.double_buffer(rdr)
        image, label = fluid.layers.read_file(rdr)
        _, avg_cost, _ = resnet.train_network(
            image, label, class_dim=RESNET['class_dim'],
            depth=RESNET['depth'])
        opt = fluid.optimizer.Momentum(learning_rate=0.01, momentum=0.9)
        opt = fluid.contrib.mixed_precision.decorate(opt)
        opt.minimize(avg_cost)
    return main, startup, rdr, avg_cost


def read_slots(program):
    """The output names of a program's read op (the reader's slots)."""
    op, = [o for o in program.global_block().ops if o.type == 'read']
    return list(op.output('Out'))


def run_steps(step, warmup, iters, sync):
    """tools/bench_input_pipeline.py's run_steps (:97): seconds a step by
    N/2N differencing after `warmup` steps (what the two timings share,
    the launch of the first and the wait for the last, cancels)."""
    for _ in range(warmup):
        step()
    sync()

    def timed(n):
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        sync()
        return time.perf_counter() - t0
    t1 = timed(iters)
    t2 = timed(2 * iters)
    return max(t2 - t1, 1e-9) / iters


def _persistables(program, scope):
    return sorted(v.name for v in program.list_vars()
                  if v.persistable and scope.find_var(v.name) is not None)


@phase('rf1: ResNet-50 trained from RecordIO shards (open_files with the '
       'native decode, batch, double_buffer, read_file) beside a pre-placed '
       'feed')
def record_file_steps(place, sync, build_root, r1_per_step,
                      batch=RESNET_BATCH):
    import torch
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import recordio
    from paddle_tpu_torch.kernels import conv_bn as k6
    t_phase = time.perf_counter()
    hw = RESNET['image_hw']
    shape = (3, hw, hw)
    cuda = place.device.type == 'cuda'
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    shard_dir = scratch(tempfile.mkdtemp(dir=build_root))
    try:
        t0 = time.perf_counter()
        paths, records = write_image_shards(shard_dir, RF['files'],
                                            RF['records'], shape,
                                            RF['per_chunk'])
        mb = sum(os.path.getsize(p) for p in paths) / 1e6
        log('rf1: %d shards of %d u8 %s records (%d a chunk), %.1f MB on '
            'disk, written in %.1f s (the writer\'s g++ build included)'
            % (RF['files'], RF['records'], 'x'.join(map(str, shape)),
               RF['per_chunk'], mb, time.perf_counter() - t0))
        # the prefetcher's build (g++, once a source) stays out of the
        # decode rates
        t0 = time.perf_counter()
        recordio._prefetch_lib()
        log('rf1: the native prefetcher built and loaded in %.1f s'
            % (time.perf_counter() - t0))
        rates = {n: decode_throughput(paths, shape, n, RF['decode_s'],
                                      IMAGENET_NORM)
                 for n in (1, 2, RF['threads'])}
        log('rf1: native decode %s samples/s'
            % ', '.join('%.1f at %d threads' % (r, n)
                        for n, r in rates.items()))
        with flags_set({'FLAGS_use_pallas_fused_ops': True}):
            out = _rf_legs(fluid, place, sync, paths, records, batch,
                           r1_per_step, k6)
    finally:
        shutil.rmtree(shard_dir, ignore_errors=True)
    reserved_gb = torch.cuda.max_memory_reserved() / 1e9 if cuda else 0.0
    peak_gb = peak_memory_gb() if cuda else 0.0
    out.update(rates=rates, mb=mb, reserved_gb=reserved_gb, peak_gb=peak_gb,
               u8_mb=batch * int(np.prod(shape)) / 1e6,
               f32_mb=batch * int(np.prod(shape)) * 4 / 1e6,
               seconds=time.perf_counter() - t_phase)
    log('rf1: step %.3f ms from the shards, %.3f ms pre-placed (%+.1f%%), '
        'device busy %s; the host inflates %.1f MB of u8 and copies %.1f MB '
        'of fp32 to the card a batch; reserved %.2f GB'
        % (out['rec_ms'], out['pre_ms'],
           100 * (out['rec_ms'] / out['pre_ms'] - 1), _fmt_busy(out['busy']),
           out['u8_mb'], out['f32_mb'], reserved_gb))
    if reserved_gb > RESNET_PEAK_GB:
        raise AssertionError('rf1 reserved %.2f GB, over %g GB'
                             % (reserved_gb, RESNET_PEAK_GB))
    return out


def _rf_legs(fluid, place, sync, paths, records, batch, r1_per_step, k6):
    import torch
    pre_main, pre_startup, pre_rdr, _, pre_cost = resnet_program(
        reader_name='rf_preplaced')
    rec_main, _, rec_rdr, rec_cost = rf_program(
        paths, RF['threads'], IMAGENET_NORM, batch)
    scope = fluid.Scope()
    fluid.Executor(place).run(pre_startup, scope=scope)
    names = _persistables(pre_main, scope)
    if names != _persistables(rec_main, scope):
        raise AssertionError('the shard-fed program\'s persistables are not '
                             'the pre-placed one\'s')
    pre_fetch = [pre_cost.name] + read_slots(pre_main)
    rec_fetch = [rec_cost.name] + read_slots(rec_main)

    cuda = place.device.type == 'cuda'

    def executor(main, cost):
        return fluid.ParallelExecutor(use_cuda=cuda, loss_name=cost.name,
                                      main_program=main, scope=scope)

    # the pre-placed feed: one batch on the card, served every step
    # (bench.py's MFU-isolation path)
    dev_batch = image_batch(np.random.RandomState(0), batch,
                            place.device if cuda else None)
    pre_rdr.decorate_tensor_provider(lambda: iter(lambda: dev_batch, None))
    pre_rdr.start()
    pe = executor(pre_main, pre_cost)
    pre_s = run_steps(lambda: pe.run(fetch_list=pre_fetch,
                                     return_numpy=False),
                      RF['warmup'], RF['iters'], sync)
    pre_rdr.reset()
    pe.close()
    del pe
    free_device_memory()

    # the shards: native decode on RF['threads'] workers, batches sliced
    # from its chunks, the double buffer's side-stream copy
    rec_rdr.start()
    pe = executor(rec_main, rec_cost)

    def rec_step():
        return pe.run(fetch_list=rec_fetch, return_numpy=False)
    for _ in range(RF['warmup']):
        rec_step()
    sync()
    k6.reset_launches()
    rec_s = run_steps(rec_step, 0, RF['iters'], sync)
    launches = k6.matmul_bn_stats_kernel.launches
    by_kernel = dict(k6.matmul_bn_stats_kernel.launches_by_kernel)
    per_step = launches / (3 * RF['iters'])
    log('rf1: step %.3f ms from the shards, %.3f ms pre-placed (N/2N, %d '
        'and %d steps after %d)' % (rec_s * 1e3, pre_s * 1e3, RF['iters'],
                                    2 * RF['iters'], RF['warmup']))
    device_ms, busy = _profile_steps(None, rec_s * 1e3, sync,
                                     'rf1 shard-fed step', step=rec_step)
    loss, images, labels = pe.run(fetch_list=rec_fetch)
    worst = check_read_slots(images, labels, records, IMAGENET_NORM)
    log('rf1: K6 %d launches in %d timed steps (%g a step, r1 %d); a fed '
        'batch: %d images, each its record\'s decode within %.3e, labels '
        'equal; loss %.6f' % (launches, 3 * RF['iters'], per_step,
                              r1_per_step, len(images), worst,
                              float(np.asarray(loss))))
    if per_step != r1_per_step or (
            cuda and by_kernel.get(k6.WGMMA_KERNEL) != launches):
        raise AssertionError('K6 launched %g a step from the shards, r1 %d '
                             '(by kernel %r)' % (per_step, r1_per_step,
                                                 by_kernel))
    if not np.isfinite(float(np.asarray(loss))):
        raise AssertionError('the shard-fed loss is not finite')
    pe.close()
    del pe
    free_device_memory()

    # the same step from the batches the reader gave: one saved state, a
    # replayed shard-fed step, then the pre-placed program's replay fed
    # those arrays through its py_reader; under cuDNN's deterministic
    # algorithms both give the same bits
    with deterministic_convs():
        saved = {n: scope.find_var(n).clone() for n in names}

        def restore():
            for n in names:
                scope.find_var(n).copy_(saved[n])

        def three_runs(main, cost, fetch):
            pe = executor(main, cost)
            for _ in range(3):       # warm-up, capture, replay
                restore()
                out = pe.run(fetch_list=fetch, return_numpy=False)
            stats = pe.jit_cache_stats()
            state = {n: scope.find_var(n).clone() for n in names}
            pe.close()
            return out, state, stats
        (a_loss, a_img, a_lbl), a_state, a_stats = three_runs(
            rec_main, rec_cost, rec_fetch)
        rec_rdr.reset()
        free_device_memory()
        fed = [a_img, a_lbl]
        pre_rdr.decorate_tensor_provider(lambda: iter(lambda: fed, None))
        pre_rdr.start()
        (b_loss, _, _), b_state, b_stats = three_runs(pre_main, pre_cost,
                                                      pre_fetch)
        pre_rdr.reset()
        restore()
        del saved
    differ = [n for n in names if not torch.equal(a_state[n], b_state[n])]
    same = bool(torch.equal(a_loss, b_loss)) and not differ
    log('rf1: the replayed shard-fed step vs the pre-placed program fed the '
        'same batch through py_reader (both captured, %d and %d graphs): '
        'loss %.6f / %.6f, %d of %d persistables differ, the same bits %s'
        % (a_stats['compiled_segments'], b_stats['compiled_segments'],
           float(a_loss), float(b_loss), len(differ), len(names), same))
    if not same:
        raise AssertionError('the shard-fed step and the py_reader step '
                             'differ: loss %r vs %r, persistables %r'
                             % (float(a_loss), float(b_loss), differ[:5]))
    free_device_memory()
    return dict(pre_ms=pre_s * 1e3, rec_ms=rec_s * 1e3, busy=busy,
                device_ms=device_ms, launches=launches, per_step=per_step,
                img_err=worst, bits=same)


# -- (ps1, ps2): parameter-server training, the pservers on the host --------

PS_TRAINERS, PS_PSERVERS, PS_STEPS = 2, 2, 4
# tools/bench_suite.py's pserver row (:465-563): SGD 1e-3, sync mode, 2
# pservers; 2 trainers at batch 8 each; the flagship LM at full width
# (MODEL, fp32, flash_attention=True) cut to 2 layers for the time limit
PS1 = dict(layers=2, batch=8, lr=1e-3)
PS1_LOCAL_TOL = 1e-4       # tests/test_dist_pserver.py's claim at the LM's width
# DeepFM (Guo et al., 2017) at its Criteo settings: 39 fields (13 dense,
# 26 categorical), embedding 10, a 400-400-400 deep tower, ids hashed to
# 1,000,001 (PaddlePaddle models' ctr/deepfm); Adam 1e-3, sync, 2
# trainers at batch 1000; categorical ids Zipf(1.1); no dropout (cut
# from the model, so that the distributed and local runs draw nothing)
PS2 = dict(dense=13, sparse=26, emb=10, hidden=(400, 400, 400),
           ids=1000001, batch=1000, lr=1e-3, zipf=1.1, click_rate=0.25)
# The distributed run against the local run, with fixed limits set from
# readings on the card of sound clusters (3 seeds) and of clusters with
# one fault planted: a trainer's gradient dropped from the merge, the
# merge not divided by the trainer count, one received block kept stale,
# prefetched rows cached stale (PERF.md, the parameter-server findings):
# - each parameter's update, gradient-weighted (_first_order_diffs: sum
#   |g|·|update difference| over sum |g|·|local update|, g the local
#   run's gradients summed over its steps): sound <= 1.318e-06 (ps1) and
#   8.764e-05 (ps2), the faults >= 0.496 (ps1) and 0.0213 (ps2);
# - the mean of the trainers' losses, step by step, against the local
#   run's: sound <= 9.537e-07, the faults >= 3.195e-05;
# - the largest weight difference: ps1 within PS1_LOCAL_TOL (sound
#   3.725e-09); ps2 within PS2_LOCAL_TOL (sound <= 2.335e-04, the faults
#   >= 1.820e-03): Adam (eps 1e-8) steps deep_w0, whose gradients are
#   below epsilon, linearly in them and so amplifies any fp32 reordering
#   (the same local run on the card and on the CPU are as far apart)
PS_UPDATE_TOL = 1e-3
PS_LOSS_TOL = 1e-5
PS2_LOCAL_TOL = 1e-3
PS_TIMEOUT = 300           # seconds a cluster may take, start to end
# ps1 trains PS_STEPS steps on one global batch drawn from the seed, so
# that its losses fall by the optimizer's steps, not by batch-to-batch
# noise (4 steps of SGD at 1e-3 move an LM's loss by less than its
# spread over batches); ps2 draws a global batch a step (Adam's steps
# lower the loss by more than that spread; on one batch repeated its
# update of a weight whose gradient is within rounding of Adam's
# epsilon would take the same rounding difference 4 times)


def ps_lm_cfg(spec):
    from paddle_tpu_torch.models.transformer import TransformerConfig
    cfg = dict(MODEL, layers=PS1['layers'])
    cfg.update(spec.get('model', {}))
    return TransformerConfig(**cfg)


def ps_lm_program(spec):
    """ps1's program: tokens and labels fed, the trunk, the fused LM
    head, mean, SGD(PS1['lr']); fp32, flash attention. Returns (main,
    startup, loss name, the global batches)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import transformer as tfm
    cfg = ps_lm_cfg(spec)
    seed = spec.get('seed', SEED)
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        tokens = fluid.layers.data(name='tokens', shape=[cfg.max_len, 1],
                                   dtype='int64')
        labels = fluid.layers.data(name='labels', shape=[cfg.max_len, 1],
                                   dtype='int64')
        trunk = tfm.language_model_trunk(tokens, cfg)
        cost = fluid.layers.fused_softmax_cross_entropy(
            trunk, labels, cfg.vocab, chunk=spec.get('head_chunk',
                                                     HEAD_CHUNK),
            name='lm_head')
        loss = fluid.layers.mean(cost)
        fluid.optimizer.SGD(PS1['lr']).minimize(loss)
    rng = np.random.RandomState(seed + 41)
    toks = rng.randint(0, cfg.vocab, size=(
        PS_TRAINERS * spec.get('batch', PS1['batch']), cfg.max_len,
        1)).astype('int64')
    # one global batch, a step each time, with a learnable next token:
    # the loss falls by the optimizer's steps alone
    batch = {'tokens': toks, 'labels': (7 * toks + 3) % cfg.vocab}
    return main, startup, loss.name, [batch] * PS_STEPS


def deepfm_batches(ps2, steps, batch, seed=SEED):
    """Criteo-shaped CTR batches from the seed: the dense fields at their
    own ids with values in [0, 1), the categorical ones hashed into the
    table from Zipf(ps2['zipf']) draws with value 1, labels clicked at
    ps2['click_rate']."""
    rng = np.random.RandomState(seed + 43)
    nd, ns, n = ps2['dense'], ps2['sparse'], ps2['ids']
    out = []
    for _ in range(steps):
        idx = np.empty((batch, nd + ns), 'int64')
        idx[:, :nd] = np.arange(nd)
        z = np.minimum(rng.zipf(ps2['zipf'], size=(batch, ns)), 1 << 40)
        idx[:, nd:] = nd + (z * 1000003 + np.arange(ns) * 7919) % (n - nd)
        val = np.ones((batch, nd + ns), 'float32')
        val[:, :nd] = rng.rand(batch, nd)
        label = (rng.rand(batch, 1) < ps2['click_rate']).astype('float32')
        out.append({'feat_idx': idx, 'feat_value': val, 'label': label})
    return out


def deepfm_program(spec):
    """ps2's program: DeepFM over feat_idx / feat_value, the 10-wide
    table `fm_emb` is_distributed (mod-sharded over the pservers,
    prefetched), the first-order table `fm_w1` is_sparse; every
    initializer seeded, so that the CPU draws of any program holding a
    parameter are one; Adam(PS2['lr']). Returns (main, startup, loss
    name, the global batches)."""
    import paddle_tpu_torch as fluid
    ps2 = dict(PS2, **spec.get('ps2', {}))
    seed = spec.get('seed', SEED)
    L = fluid.layers
    nf, emb_w = ps2['dense'] + ps2['sparse'], ps2['emb']

    def attr(name, scale, k):
        return fluid.ParamAttr(name=name, initializer=fluid.initializer.Normal(
            scale=scale, seed=seed + k))
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        idx = L.data(name='feat_idx', shape=[nf], dtype='int64')
        val = L.data(name='feat_value', shape=[nf], dtype='float32')
        label = L.data(name='label', shape=[1], dtype='float32')
        first = L.embedding(idx, size=[ps2['ids'], 1], is_sparse=True,
                            param_attr=attr('fm_w1', 1e-2, 1))
        first = L.reduce_sum(L.elementwise_mul(
            L.reshape(first, [-1, nf]), val), dim=1, keep_dim=True)
        emb = L.embedding(idx, size=[ps2['ids'], emb_w], is_sparse=True,
                          is_distributed=True,
                          param_attr=attr('fm_emb', 1e-2, 2))
        emb = L.elementwise_mul(emb, val, axis=0)          # [B, F, 10]
        summed = L.reduce_sum(emb, dim=1)
        second = L.scale(L.reduce_sum(L.elementwise_sub(
            L.square(summed), L.reduce_sum(L.square(emb), dim=1)),
            dim=1, keep_dim=True), scale=0.5)
        h = L.reshape(emb, [-1, nf * emb_w])
        width = nf * emb_w
        for i, w in enumerate(ps2['hidden']):
            h = L.fc(h, w, act='relu',
                     param_attr=attr('deep_w%d' % i, width ** -0.5, 10 + i),
                     bias_attr=fluid.ParamAttr(
                         name='deep_b%d' % i,
                         initializer=fluid.initializer.Constant(0.0)))
            width = w
        deep = L.fc(h, 1, param_attr=attr('deep_out_w', width ** -0.5, 20),
                    bias_attr=fluid.ParamAttr(
                        name='deep_out_b',
                        initializer=fluid.initializer.Constant(0.0)))
        logit = L.elementwise_add(L.elementwise_add(first, second), deep)
        loss = L.mean(L.sigmoid_cross_entropy_with_logits(logit, label))
        fluid.optimizer.Adam(ps2['lr']).minimize(loss)
    return main, startup, loss.name, deepfm_batches(
        ps2, PS_STEPS, PS_TRAINERS * spec.get('batch', ps2['batch']), seed)


PS_PROGRAMS = {'ps1': ps_lm_program, 'ps2': deepfm_program}


def _crc_rows(t, offset=0, rows=None):
    """crc32 of rows [offset, offset + rows) of a tensor's bytes."""
    from paddle_tpu_torch.integrity import crc32
    t = t.detach()
    if rows is not None:
        t = t[offset:offset + rows]
    return crc32(t.contiguous().cpu().numpy().tobytes())


def _host_events(path):
    """The events of fluid.profiler's host trace at `path` (what
    stop_profiler wrote): [(name, start us, duration us)]."""
    with open(path) as f:
        return [(e['name'], e['ts'], e['dur'])
                for e in json.load(f)['traceEvents']]


def _step_parts(events):
    """A trainer step split by part, in ms, from the profiler's host
    events of that step: device (the segments before recv, and send's
    wait for the last of them), send, the barriers, recv, concat (the
    segments after recv), prefetch and the split ops."""
    recv = min([t for n, t, _ in events if n == 'host_op:recv'] or
               [float('inf')])

    def ms(pred):
        return sum(d for n, t, d in events if pred(n, t)) / 1e3
    wait = ms(lambda n, t: n == 'send:wait_for_device')
    seg = 'device_segment:'
    return {'device': ms(lambda n, t: n.startswith(seg) and t < recv) +
            wait,
            'concat': ms(lambda n, t: n.startswith(seg) and t > recv),
            'send': ms(lambda n, t: n == 'host_op:send') - wait,
            'barriers': ms(lambda n, t: n in ('host_op:send_barrier',
                                              'host_op:fetch_barrier')),
            'recv': ms(lambda n, t: n == 'host_op:recv'),
            'prefetch': ms(lambda n, t: n == 'host_op:prefetch'),
            'split': ms(lambda n, t: n in ('host_op:split_ids',
                                           'host_op:split_selected_rows'))}


def _ps_transpiled(phase, spec, trainer_id, eps):
    import paddle_tpu_torch as fluid
    main, startup, loss, batches = PS_PROGRAMS[phase](spec)
    t = fluid.DistributeTranspiler()
    t.transpile(trainer_id, program=main, pservers=eps,
                trainers=PS_TRAINERS, sync_mode=True,
                startup_program=startup)
    return t, loss, batches


def ps_pserver(phase, index, eps, spec):
    """One pserver on the host: its startup on the CPU, the owned blocks'
    crc32s, then listen_and_serv until both trainers complete; each
    round's ms (the profiler's param_service:round: merge to snapshot); for ps2, which
    rows of its table shard changed."""
    import torch
    import paddle_tpu_torch as fluid
    t, _, batches = _ps_transpiled(phase, spec, 0, eps)
    ep = eps.split(',')[index]
    main, startup = t.get_pserver_programs(ep)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    t0 = time.perf_counter()
    exe.run(startup, scope=scope)
    startup_s = time.perf_counter() - t0
    digests = {i.pname: _crc_rows(scope.find_var(i.pname))
               for i in t.var_blocks if i.ep == ep}
    table = t.table_name
    table0 = scope.find_var(table).clone() if table else None
    trace = os.path.join(os.environ['PSW_OUT'], 'pserver%d.trace' % index)
    fluid.profiler.start_profiler('CPU')
    t0 = time.perf_counter()
    exe.run(main, scope=scope)
    serve_s = time.perf_counter() - t0
    fluid.profiler.stop_profiler(None, trace)
    rounds = [d / 1e3 for n, _, d in _host_events(trace)
              if n == 'param_service:round']
    out = dict(startup_s=startup_s, serve_s=serve_s, digests=digests,
               round_ms=rounds)
    if table:
        n = len(t.pserver_endpoints)
        changed = (scope.find_var(table) != table0).any(dim=1)
        changed_ids = (torch.nonzero(changed).reshape(-1) * n + index)
        touched = set()
        for b in batches:
            touched.update(int(i) for i in np.unique(b['feat_idx'])
                           if int(i) % n == index)
        changed_ids = set(int(i) for i in changed_ids.tolist())
        out['table'] = dict(rows=int(table0.shape[0]),
                            touched=len(touched), changed=len(changed_ids),
                            changed_untouched=len(changed_ids - touched),
                            touched_unchanged=len(touched - changed_ids))
    return out


def ps_trainer(phase, index, eps, spec, place):
    """One trainer on `place`: its startup (ending with the pull from the
    pservers) and the blocks' crc32s, PS_STEPS steps of its half of each
    global batch, the last split by part (the profiler's host events of
    it), the kernel launches, every parameter's crc32; trainer 0 then
    runs the same program locally on the same place from the same
    initial values over the whole global batches (_ps_local)."""
    import torch
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.kernels import flash_attention as fa
    t, loss, batches = _ps_transpiled(phase, spec, index, eps)
    prog = t.get_trainer_program()
    exe = fluid.Executor(place)
    scope = fluid.Scope()
    sync = torch_sync(place)
    t0 = time.perf_counter()
    exe.run(t.get_trainer_startup_program(), scope=scope)
    sync()
    startup_s = time.perf_counter() - t0
    params = [p.name for p in t.origin_program.global_block()
              .all_parameters() if scope.find_var(p.name) is not None]
    digests = {i.pname: _crc_rows(scope.find_var(i.param.name), i.offset,
                                  i.rows) for i in t.var_blocks}
    initial = {p: scope.find_var(p).clone() for p in params} \
        if index == 0 else None
    counters = {KERNELS[k][0]: getattr(fa, KERNELS[k][0]) for k in KERNELS}
    for c in counters.values():
        c.launches = 0
    fa.FlashAttention.plain_cuda_calls = 0
    trace = os.path.join(os.environ['PSW_OUT'], 'trainer%d.trace' % index)
    per = batches[0][next(iter(batches[0]))].shape[0] // PS_TRAINERS
    losses, step_ms = [], []
    for step, gb in enumerate(batches):
        feed = {k: v[index * per:(index + 1) * per] for k, v in gb.items()}
        if step == len(batches) - 1:
            fluid.profiler.start_profiler('CPU')
        t0 = time.perf_counter()
        losses.append(float(exe.run(prog, feed=feed, fetch_list=[loss],
                                    scope=scope)[0]))
        step_ms.append((time.perf_counter() - t0) * 1e3)
    fluid.profiler.stop_profiler(None, trace)
    launches = {n: c.launches for n, c in counters.items()}
    plain = fa.FlashAttention.plain_cuda_calls
    final = {p: _crc_rows(scope.find_var(p)) for p in params}
    param_bytes = sum(scope.find_var(p).numel() *
                      scope.find_var(p).element_size() for p in params)
    exe.close()              # COMPLETE to every pserver
    out = dict(startup_s=startup_s, digests=digests, final=final,
               losses=losses, step_ms=step_ms,
               parts=_step_parts(_host_events(trace)),
               launches=launches, plain=plain, param_bytes=param_bytes)
    if phase == 'ps2':
        # the table rows a step moves each way: prefetched in, their
        # gradients out as SelectedRows (one row a lookup)
        out['rows'] = int(np.prod(feed['feat_idx'].shape))
    if index == 0:
        out['local'] = _ps_local(phase, spec, place, scope, params, initial,
                                 batches, sync)
    return out


def _ps_local(phase, spec, place, dist_scope, params, initial, batches,
              sync):
    """The same program trained locally on `place` over the whole global
    batches from the distributed run's initial values: ps1 from the
    values the trainer pulled, ps2 from a CPU run of its startup (which
    also holds the distributed table, as the pservers drew it); ps2's
    pulled values must be that run's exactly. Each parameter's largest
    difference from the distributed run and the gradient-weighted
    difference of the two runs' updates (_first_order_diffs, the local
    run's |g| summed over its steps); for ps2 on the card also the
    largest difference between this run and the same run on the CPU
    (the card's own rounding under Adam, logged beside it)."""
    import torch
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.selected_rows import SelectedRows
    main, startup, loss, _ = PS_PROGRAMS[phase](spec)

    def train(run_place, init_from):
        scope = fluid.Scope()
        exe = fluid.Executor(run_place)
        exe.run(startup, scope=scope)
        for n, v in init_from.items():
            scope.find_var(n).copy_(v)
        start = {p: scope.find_var(p).clone() for p in params}
        grads = [p + '@GRAD' for p in params]
        gsum = {p: torch.zeros_like(start[p]) for p in params}
        losses, step_ms = [], []
        for gb in batches:
            t0 = time.perf_counter()
            out = exe.run(main, feed=gb, fetch_list=[loss] + grads,
                          scope=scope, return_numpy=False)
            losses.append(float(out[0]))
            step_ms.append((time.perf_counter() - t0) * 1e3)
            for p, g in zip(params, out[1:]):
                g = g.to_dense() if isinstance(g, SelectedRows) else g
                gsum[p] += g.abs().to(gsum[p].device)
        exe.close()
        return scope, start, gsum, losses, step_ms
    pulled_mismatch = []
    if phase == 'ps2':
        cpu = fluid.Scope()
        fluid.Executor(fluid.CPUPlace()).run(startup, scope=cpu)
        init = {v.name: cpu.find_var(v.name)
                for v in startup.global_block().vars.values()
                if v.persistable and cpu.find_var(v.name) is not None}
        pulled_mismatch = [p for p in params if not torch.equal(
            initial[p].cpu(), init[p])]
    else:
        init = {p: initial[p] for p in params}
    scope, start, gsum, losses, step_ms = train(place, init)
    sync()
    diffs = {p: float((scope.find_var(p) - dist_scope.find_var(p)).abs()
                      .max()) for p in params}
    upd = {p: scope.find_var(p) - start[p] for p in params}
    dist_upd = {p: dist_scope.find_var(p) - start[p] for p in params}
    out = dict(diffs=diffs, losses=losses, step_ms=step_ms,
               pulled_mismatch=pulled_mismatch,
               weighted=_first_order_diffs(dist_upd, upd, gsum, params))
    if phase == 'ps2' and place.device.type == 'cuda':
        cpu_scope = train(fluid.CPUPlace(), init)[0]
        out['cpu_spread'] = {p: float(
            (cpu_scope.find_var(p) - scope.find_var(p).cpu()).abs()
            .max()) for p in params}
    return out


def ps_worker_main(role, index):
    """`chip_smoke.py --ps-worker <role> <index>`: one role of a ps1, ps2
    or on1 cluster, or a rank of mp1's, mp2's or pp1's mesh (role 'rank';
    role 'probe' for the gloo probes), or of ck1's job (role 'ckrank') (env PSW_PHASE, PSW_ENDPOINTS, PSW_OUT,
    PSW_SPEC, PSW_PLACE); its result goes to PSW_OUT/<role><index>.json."""
    import torch
    import paddle_tpu_torch as fluid
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase, eps = os.environ['PSW_PHASE'], os.environ['PSW_ENDPOINTS']
    work = os.environ['PSW_OUT']
    spec = json.loads(os.environ.get('PSW_SPEC') or '{}')
    if role == 'probe':
        out = mp_probe_rank(index, work)
    elif role == 'probesr':
        out = mp_probe_sendrecv(index, work)
    elif role == 'ckrank':
        # a rank of ck1's Trainer job, run by a Supervisor: a failure
        # exits at once (its checkpoint threads must not hold the exit)
        place = fluid.CPUPlace() if os.environ.get('PSW_PLACE') == 'cpu' \
            else fluid.CUDAPlace(0)
        try:
            out = ck_rank(index, spec, place, work)
        except BaseException:
            import traceback
            traceback.print_exc()
            sys.stdout.flush()
            sys.stderr.flush()
            os._exit(1)
    elif role == 'rank':
        # a rank of mp1's or mp2's mesh: the env contract of
        # init_parallel_env, the rendezvous a file in the work dir
        os.environ.update(
            PADDLE_TRAINER_ID=str(index),
            PADDLE_TRAINERS_NUM=str(spec['world']),
            PADDLE_DIST_INIT_METHOD='file://' + os.path.join(work, 'store'))
        place = fluid.CPUPlace() if os.environ.get('PSW_PLACE') == 'cpu' \
            else fluid.CUDAPlace(0)
        out = mesh_rank(phase, index, spec, place, work)
    elif role == 'pserver':
        out = on_pserver(index, eps, spec) if phase == 'on1' else \
            ps_pserver(phase, index, eps, spec)
    else:
        place = fluid.CPUPlace() if os.environ.get('PSW_PLACE') == 'cpu' \
            else fluid.CUDAPlace(0)
        if phase != 'on1':
            out = ps_trainer(phase, index, eps, spec, place)
        elif role == 'trainer':
            out = on_trainer(eps, spec, place, work)
        else:
            out = on_serving(eps, spec, place, work)
    with open(os.path.join(work, '%s%d.json' % (role, index)), 'w') as f:
        json.dump(out, f)
    return 0


def _free_ports(n):
    import socket
    socks = []
    for _ in range(n):
        s = socket.socket()
        s.bind(('127.0.0.1', 0))
        socks.append(s)
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:        # all held before any is freed: no repeats
        s.close()
    return ports


def run_ps_cluster(phase, work_dir, spec=None, place_name='cuda',
                   roles=None):
    """The (role, index) pairs of `phase` (by default PS_PSERVERS
    pservers and PS_TRAINERS trainers) as subprocesses of this script
    (`--ps-worker <role> <index>`) on free localhost ports, each with its
    output in work_dir/<role><index>.log (the pservers on the host, the
    other roles on the card); returns {role<i>: result}. A role that
    fails or outlives PS_TIMEOUT fails the phase with the logs' tails;
    every child is killed however this ends."""
    eps = ','.join('127.0.0.1:%d' % p for p in _free_ports(PS_PSERVERS))
    env = dict(os.environ, PSW_PHASE=phase, PSW_ENDPOINTS=eps,
               PSW_OUT=work_dir, PSW_SPEC=json.dumps(spec or {}),
               PSW_PLACE=place_name)
    if place_name == 'cpu':
        # a rehearsal's roles share the host's cores
        env.setdefault('OMP_NUM_THREADS', '1')
    roles = roles or [('pserver', i) for i in range(PS_PSERVERS)] + \
        [('trainer', i) for i in range(PS_TRAINERS)]
    procs, logs = {}, {}
    deadline = time.monotonic() + PS_TIMEOUT
    try:
        for role, i in roles:
            name = '%s%d' % (role, i)
            logs[name] = os.path.join(work_dir, name + '.log')
            with open(logs[name], 'wb') as lf:
                procs[name] = subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__),
                     '--ps-worker', role, str(i)],
                    env=env, cwd=HERE, stdout=lf, stderr=subprocess.STDOUT)
        while any(p.poll() is None for p in procs.values()):
            if any(p.poll() not in (None, 0) for p in procs.values()) or \
                    time.monotonic() > deadline:
                break
            time.sleep(0.05)
        bad = [n for n, p in procs.items() if p.poll() != 0]
        if bad:
            raise AssertionError('%s: roles %s failed or timed out after %d '
                                 's\n%s' % (phase, bad, PS_TIMEOUT, '\n'.join(
                                     '--- %s:\n%s' % (n, _tail(logs[n]))
                                     for n in bad)))
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    out = {}
    for name in procs:
        with open(os.path.join(work_dir, name + '.json')) as f:
            out[name] = json.load(f)
    return out


def _tail(path, n=3000):
    try:
        with open(path, errors='replace') as f:
            return f.read()[-n:]
    except OSError as e:
        return '(no log: %s)' % e


def _ps_common_checks(phase, res):
    """Each trainer's blocks after startup are the pservers' exactly,
    the trainers end on the same bits and their losses fall. Returns the
    number of blocks."""
    served = {}
    for i in range(PS_PSERVERS):
        served.update(res['pserver%d' % i]['digests'])
    for i in range(PS_TRAINERS):
        got = res['trainer%d' % i]['digests']
        if got != served:
            bad = sorted(k for k in served if got.get(k) != served[k])
            raise AssertionError('%s: trainer %d after startup differs from '
                                 'the pservers\' slices in %s'
                                 % (phase, i, bad[:8]))
    f0, f1 = res['trainer0']['final'], res['trainer1']['final']
    if f0 != f1:
        raise AssertionError('%s: the trainers end on different parameters '
                             '(%s): want the same bits'
                             % (phase, sorted(k for k in f0
                                              if f0[k] != f1.get(k))[:8]))
    for i in range(PS_TRAINERS):
        losses = res['trainer%d' % i]['losses']
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            raise AssertionError('%s: trainer %d losses %s do not fall'
                                 % (phase, i, losses))
    return len(served)


def _ps_local_check(phase, res):
    """Trainer 0's local run against the cluster: ps2's pulled values
    are the startup's CPU draws; every parameter's gradient-weighted
    update difference within PS_UPDATE_TOL; the trainers' mean loss
    within PS_LOSS_TOL of the local run's at every step; the largest
    weight difference within PS1_LOCAL_TOL / PS2_LOCAL_TOL. Returns (the
    largest weight difference, the largest weighted update difference,
    the largest loss difference)."""
    local = res['trainer0']['local']
    if local['pulled_mismatch']:
        raise AssertionError('%s: the pulled %s are not the startup\'s CPU '
                             'draws' % (phase, local['pulled_mismatch']))
    bad = sorted(p for p, d in local['weighted'].items()
                 if not d <= PS_UPDATE_TOL)
    if bad:
        raise AssertionError('%s: the updates of %s differ from the local '
                             'run\'s by %s gradient-weighted, want <= %g'
                             % (phase, bad[:8], [local['weighted'][p]
                                                 for p in bad[:8]],
                                PS_UPDATE_TOL))
    mean = np.mean([res['trainer%d' % i]['losses']
                    for i in range(PS_TRAINERS)], axis=0)
    loss_diff = float(np.max(np.abs(mean - np.asarray(local['losses']))))
    if not loss_diff <= PS_LOSS_TOL:
        raise AssertionError('%s: the trainers\' mean losses %s differ from '
                             'the local run\'s %s by %.3e, want <= %g'
                             % (phase, mean.tolist(), local['losses'],
                                loss_diff, PS_LOSS_TOL))
    worst = max(local['diffs'].values())
    tol = PS1_LOCAL_TOL if phase == 'ps1' else PS2_LOCAL_TOL
    if not worst <= tol:
        raise AssertionError('%s: parameters differ from the local run by '
                             '%.3e (%s), want <= %g'
                             % (phase, worst, local['diffs'], tol))
    return worst, max(local['weighted'].values()), loss_diff


@phase('ps1: the flagship LM in parameter-server mode (2 trainers on the '
       'card x 2 pservers on the host, sync SGD)')
def ps_lm_steps(work_root, spec=None, place_name='cuda'):
    """bench_suite's pserver row on MODEL cut to PS1['layers'] layers:
    the trainers start from the pservers' slices exactly, end on the
    same bits, within PS1_LOCAL_TOL of a local run on the card over the
    same global batches, each parameter's update and the losses as the
    local run's (_ps_local_check), and their losses fall; K1 fp32 and
    K2 fp32
    launch cfg.layers times a step on each trainer and no plain flash
    call runs. Logs the step split by part, the wire's MB/s each way,
    the local step's ms and the pservers' round ms."""
    spec = spec or {}
    t0 = time.perf_counter()
    work = scratch(tempfile.mkdtemp(dir=work_root))
    res = run_ps_cluster('ps1', work, spec, place_name)
    nblocks = _ps_common_checks('ps1', res)
    worst, weighted, loss_diff = _ps_local_check('ps1', res)
    layers = ps_lm_cfg(spec).layers
    launches = {'K1': 0, 'K2': 0}
    for i in range(PS_TRAINERS):
        r = res['trainer%d' % i]
        _check_flash_launches(
            'ps1: trainer %d in %d steps' % (i, PS_STEPS),
            dict(r['launches'], plain_cuda_calls=r['plain']),
            {KERNELS['fwd'][0]: layers * PS_STEPS,
             KERNELS['k2'][0]: layers * PS_STEPS}, place_name)
        launches['K1'] += r['launches'][KERNELS['fwd'][0]]
        launches['K2'] += r['launches'][KERNELS['k2'][0]]
    r0 = res['trainer0']
    parts = r0['parts']
    mb = r0['param_bytes'] / 1e6
    rounds = [ms for i in range(PS_PSERVERS)
              for ms in res['pserver%d' % i]['round_ms']]
    wall = time.perf_counter() - t0
    log('ps1: %d parameter blocks on %d pservers, %.1f MB of gradients '
        'out and of parameters in a trainer step; startup (the pull) %.3f s '
        'on the trainers, %.3f s on the pservers; trainer 0 step ms %s '
        '(the last: device %.3f, send %.3f, barriers %.3f, recv + concat '
        '%.3f); the '
        'wire %.1f MB/s out, %.1f MB/s in; the local step on the card '
        '(batch %d) %s ms; pserver rounds %s ms; losses %s; launches a '
        'trainer %d K1 + %d K2; vs the local run: max |diff| %.3e, updates '
        '%.3e gradient-weighted, mean losses %.3e; %.1f s'
        % (nblocks, PS_PSERVERS, mb,
           max(res['trainer%d' % i]['startup_s'] for i in range(2)),
           max(res['pserver%d' % i]['startup_s'] for i in range(2)),
           ' '.join('%.3f' % x for x in r0['step_ms']), parts['device'],
           parts['send'], parts['barriers'], parts['recv'] + parts['concat'],
           mb / max(parts['send'], 1e-9) * 1e3,
           mb / max(parts['recv'], 1e-9) * 1e3,
           PS_TRAINERS * spec.get('batch', PS1['batch']),
           ' '.join('%.3f' % x for x in r0['local']['step_ms']),
           ' '.join('%.3f' % x for x in rounds),
           ' '.join('%.6f' % x for x in r0['losses']),
           launches['K1'] // PS_TRAINERS, launches['K2'] // PS_TRAINERS,
           worst, weighted, loss_diff, wall))
    return dict(launches=launches, seconds=wall, worst=worst,
                weighted=weighted, parts=parts,
                step_ms=r0['step_ms'], local_ms=r0['local']['step_ms'],
                round_ms=rounds, mb=mb, losses=r0['losses'])


@phase('ps2: DeepFM CTR in parameter-server mode with a distributed lookup '
       'table (2 trainers on the card x 2 pservers on the host, sync Adam)')
def ps_deepfm_steps(work_root, spec=None, place_name='cuda'):
    """PS2's DeepFM: the trainers start from the pservers' slices
    exactly, which are a CPU run of the startup's draws; the non-table
    weights, their updates and the losses as a local run's on the card
    over the same global batches (_ps_local_check); every table row no
    batch touched the same bits on its pserver and every row one touched
    changed; the losses fall. Logs
    step ms, prefetch ms, the rows a step on the wire and the largest
    weight difference from the local run beside the same local run's
    on the CPU."""
    spec = spec or {}
    t0 = time.perf_counter()
    work = scratch(tempfile.mkdtemp(dir=work_root))
    res = run_ps_cluster('ps2', work, spec, place_name)
    nblocks = _ps_common_checks('ps2', res)
    local = res['trainer0']['local']
    worst, weighted, loss_diff = _ps_local_check('ps2', res)
    spread = max(local['cpu_spread'].values()) \
        if local.get('cpu_spread') else None
    tables = [res['pserver%d' % i]['table'] for i in range(PS_PSERVERS)]
    if any(t['changed_untouched'] or t['touched_unchanged']
           for t in tables):
        raise AssertionError('ps2: table rows no batch touched changed, or '
                             'rows a batch touched did not: %s' % tables)
    r0 = res['trainer0']
    parts = r0['parts']
    rounds = [ms for i in range(PS_PSERVERS)
              for ms in res['pserver%d' % i]['round_ms']]
    wall = time.perf_counter() - t0
    per_step = r0['rows']
    log('ps2: %d parameter blocks and a %d-row table on %d pservers (%s); '
        'trainer 0 step ms %s (the last: prefetch %.3f, device %.3f, '
        'split_ids %.3f, send %.3f, barriers %.3f, recv + concat %.3f); %d '
        'rows a step on the wire '
        'each way (prefetched in, SelectedRows out); the local step on the '
        'card %s ms; pserver rounds %s ms; losses %s; vs the local run: '
        'updates %.3e gradient-weighted, mean losses %.3e, max |diff| '
        '%.3e (the local run on the card vs on the CPU: %s); %.1f s'
        % (nblocks, sum(t['rows'] for t in tables), PS_PSERVERS,
           ', '.join('%d rows touched, %d changed, %d changed untouched'
                     % (t['touched'], t['changed'], t['changed_untouched'])
                     for t in tables),
           ' '.join('%.3f' % x for x in r0['step_ms']), parts['prefetch'],
           parts['device'], parts['split'], parts['send'], parts['barriers'],
           parts['recv'] + parts['concat'], per_step,
           ' '.join('%.3f' % x for x in local['step_ms']),
           ' '.join('%.3f' % x for x in rounds),
           ' '.join('%.6f' % x for x in r0['losses']), weighted,
           loss_diff, worst,
           'not measured' if spread is None else '%.3e' % spread, wall))
    return dict(seconds=wall, worst=worst, weighted=weighted,
                spread=spread, parts=parts,
                tables=tables,
                step_ms=r0['step_ms'], local_ms=local['step_ms'],
                round_ms=rounds, rows=per_step, losses=r0['losses'])


# -- on1, fl1, fl2: online refresh and fleet serving --------------------------

# on1: tests/test_online.py's trainer x pserver x serving cluster at the
# flagship LM's width, cut to PS1['layers'] layers as ps1 is: one trainer
# on the card and PS_PSERVERS pservers on the host train ps1's program
# (sync SGD PS1['lr'], batch PS1['batch']) for ON_ROUNDS rounds while one
# serving process on the card runs an LMServer over the same weights with
# enable_refresh(pserver endpoints) and tracks the published versions;
# 2 rounds, for the script's time
ON_ROUNDS = 2
ON_PROMPTS, ON_NEW_TOKENS = 4, 16
ON_POLL_SECS = 0.1
FLEET_TIMEOUT = 300     # seconds a cluster, a replica start or a wait may take
# fl1: c1's saved model (MODEL: full width and depth, fp32) served by
# replica processes (`python -m paddle_tpu_torch.tools.serve_replica`, a
# dense LMServer on the card each) behind a FleetRouter in this process.
# Failover: FL1_STREAMS seeded streams of FL1_NEW_TOKENS over FL1_SESSIONS
# sessions on 2 replicas; replica 1 exits at its FL1_KILL_POLL-th SRV_POLL
# (a FLAGS_fault_plan exit rule, as tools/chaos_sweep.py --fleet plants
# it): the router polls each replica once a FLAGS_fleet_poll_secs tick, so
# the rule fires a few hundred ms into the burst, with every stream live
# (8 a replica, 64 tokens each). Rolling deploy: 2 fresh replicas with
# paused subscribers on a ParameterService in this process that hosts c1's
# parameters; version 1 is c1's weights plus FL1_PERTURB x N(0, 1) from
# the seed, deployed under FL1_DEPLOY_STREAMS streams of live traffic
FL1_STREAMS, FL1_NEW_TOKENS, FL1_SESSIONS = 16, 64, 8
FL1_KILL_POLL = 30
FL1_PERTURB = 2e-3
FL1_DEPLOY_STREAMS, FL1_DEPLOY_TOKENS = 8, 32
# fl2: one prefill replica and 2 paged decode replicas (16-token pages,
# the auto pool), all on the card; every other stream opens with one of
# two SYSTEM_PROMPT-token system prompts and a suffix shorter than a page,
# so its shippable chain is the system prompt's 16 pages. The prefill
# replica exits at its FL2_KILL_REPLY-th SRV_PAGES reply: the first fetch
# of the second system prompt (replies 1-2 are this script's own fetches,
# 3-4 the decode replicas' warm-up ships of the first)
FL2_STREAMS = 8             # a burst; two bursts
FL2_KILL_REPLY = 5


def on_serving_program(spec):
    """on1's serving program: language_model_logits over ps1's config on
    one fed sequence; its parameter names are the trainer program's."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import transformer as tfm
    cfg = ps_lm_cfg(spec)
    prog, startup = fluid.Program(), fluid.Program()
    prog.random_seed = startup.random_seed = spec.get('seed', SEED) + 51
    with fluid.unique_name.guard(), fluid.program_guard(prog, startup):
        toks = fluid.layers.data(name='tokens', shape=[1, cfg.max_len, 1],
                                 dtype='int64', append_batch_size=False)
        logits = tfm.language_model_logits(toks, cfg)
    return prog, startup, logits


def _on_transpiled(spec, eps):
    import paddle_tpu_torch as fluid
    main, startup, loss, batches = ps_lm_program(spec)
    t = fluid.DistributeTranspiler()
    t.transpile(0, program=main, pservers=eps, trainers=1, sync_mode=True,
                startup_program=startup)
    return t, loss, batches


def _wire_digest(value):
    from paddle_tpu_torch.distributed import wire
    from paddle_tpu_torch.integrity import crc32
    return crc32(wire._payload_of(value)[1])


def _wait_file(path, timeout=FLEET_TIMEOUT):
    deadline = time.monotonic() + timeout
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise AssertionError('timed out waiting for %s' % path)
        time.sleep(0.05)


def on_pserver(index, eps, spec):
    """One pserver on the host: listen_and_serv until the trainer
    completes (the service publishes a version a closed round). With
    spec['plant'] == 'digest' it stamps one parameter's digest wrong: a
    sound subscriber then refuses every pull of that shard."""
    import paddle_tpu_torch as fluid
    if spec.get('plant') == 'digest':
        from paddle_tpu_torch.distributed import param_service
        orig = param_service.ParameterService._manifest_locked

        def bad(self):
            out = dict(orig(self))
            name = sorted(out)[0]
            out[name] ^= 1
            return out
        param_service.ParameterService._manifest_locked = bad
    t, _, _ = _on_transpiled(spec, eps)
    main, startup = t.get_pserver_programs(eps.split(',')[index])
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    exe.run(main, scope=scope)
    return {}


def on_trainer(eps, spec, place, work):
    """The trainer on `place`: ON_ROUNDS sync rounds of ps1's program on
    batch PS1['batch'], then each parameter's digest as pulled after the
    last round (the pservers' version ON_ROUNDS) and its values for the
    serving side's reference, and the flash kernels' launches of the
    rounds; COMPLETE only once serving is done."""
    import torch
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.tools.serve_replica import launch_counts
    t, loss, batches = _on_transpiled(spec, eps)
    exe = fluid.Executor(place)
    scope = fluid.Scope()
    exe.run(t.get_trainer_startup_program(), scope=scope)
    prog = t.get_trainer_program()
    per = spec.get('batch', PS1['batch'])
    losses, step_ms = [], []
    # the rounds start once the serving process subscribes
    _wait_file(os.path.join(work, 'SERVING_SUBSCRIBED'))
    for step in range(ON_ROUNDS):
        feed = {k: v[:per] for k, v in batches[step].items()}
        t0 = time.perf_counter()
        losses.append(float(exe.run(prog, feed=feed, fetch_list=[loss],
                                    scope=scope)[0]))
        step_ms.append((time.perf_counter() - t0) * 1e3)
    params = [p.name for p in t.origin_program.global_block()
              .all_parameters() if scope.find_var(p.name) is not None]
    digests = {p: _wire_digest(scope.find_var(p)) for p in params}
    torch.save({p: scope.find_var(p).cpu() for p in params},
               os.path.join(work, 'round%d.pt' % ON_ROUNDS))
    with open(os.path.join(work, 'TRAINER_DONE'), 'w') as f:
        f.write('done')
    _wait_file(os.path.join(work, 'SERVING_DONE'))
    exe.close()                 # COMPLETE to both pservers
    return dict(losses=losses, step_ms=step_ms, digests=digests,
                launches=launch_counts())


def on_serving(eps, spec, place, work):
    """The serving process on `place`: its own model directory from the
    serving program's startup (other weights than the trainer's), an
    LMServer over it, streams before; enable_refresh(pservers) and wait
    for version ON_ROUNDS (failing on the first refresh failure); streams
    after, the installed parameters' digests and the server's stats, then
    the same streams from a fresh LMServer whose weights are the trainer's
    round-ON_ROUNDS values, read from its file; the flash kernels'
    launches of all of it."""
    import torch
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.obs import telemetry
    from paddle_tpu_torch.tools.serve_replica import launch_counts
    prog, startup, logits = on_serving_program(spec)
    model_dir = os.path.join(work, 'serving_model')
    exe = fluid.Executor(place)
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(startup)
        fluid.io.save_inference_model(model_dir, ['tokens'], [logits], exe,
                                      main_program=prog)
    del scope
    cfg = ps_lm_cfg(spec)
    prompts = seeded_prompts(
        SEED + 52, np.linspace(8, spec.get('max_prompt', 64), ON_PROMPTS),
        cfg.vocab)
    new = spec.get('new_tokens', ON_NEW_TOKENS)

    def server(weights=None):
        pred = fluid.inference.AnalysisPredictor(
            fluid.inference.AnalysisConfig(model_dir, place=place))
        if weights is not None:
            for n, v in weights.items():
                pred._scope.find_var(n).copy_(v)
        dec = pred.prepare_decoding(slots=ON_PROMPTS, prefill_batch=1)
        return dec, fluid.serving.LMServer(dec)

    def streams(srv):
        hs = [srv.submit(p, max_new_tokens=new) for p in prompts]
        return [srv.result(h, timeout=FLEET_TIMEOUT) for h in hs]
    telemetry.enable()
    _, srv = server()
    try:
        before = streams(srv)
        t0 = time.perf_counter()
        sub = srv.enable_refresh(eps.split(','), poll_secs=ON_POLL_SECS)
        with open(os.path.join(work, 'SERVING_SUBSCRIBED'), 'w') as f:
            f.write('subscribed')
        deadline = time.monotonic() + spec.get('refresh_timeout',
                                               FLEET_TIMEOUT)
        while sub.installed_version < ON_ROUNDS:
            if sub.failures or time.monotonic() > deadline:
                raise AssertionError(
                    'on1: refresh stopped at version %d of %d: %r'
                    % (sub.installed_version, ON_ROUNDS, sub.stats()))
            time.sleep(0.02)
        track_s = time.perf_counter() - t0
        after = streams(srv)
        digests = srv.param_digests()
        stats = srv.stats()
        snap = telemetry.snapshot()
    finally:
        with open(os.path.join(work, 'SERVING_DONE'), 'w') as f:
            f.write('done')
        srv.close()
    _wait_file(os.path.join(work, 'TRAINER_DONE'))
    weights = torch.load(os.path.join(work, 'round%d.pt' % ON_ROUNDS))
    served = set(digests)
    ref_dec, ref = server({n: v for n, v in weights.items() if n in served})
    with ref:
        refs = streams(ref)
    held = hold_streams('on1: streams after the refresh vs a fresh '
                        'LMServer on round %d\'s values' % ON_ROUNDS,
                        prompts, refs, after, ref_dec)
    lat = snap['hists']['online.refresh_latency']
    nbytes = snap['hists']['online.refresh_bytes']
    return dict(installed=sub.installed_version, digests=digests,
                weight_swaps=stats['weight_swaps'],
                refreshes=stats['refreshes'],
                refresh_failures=stats['refresh_failures'],
                param_version=stats['param_version'],
                before=before, after=after, equal=held['equal'],
                ties=held['ties'], track_s=track_s,
                refresh_s=[lat['count'], lat['sum'], lat['max']],
                refresh_bytes=[nbytes['count'], nbytes['sum']],
                launches=launch_counts())


@phase('on1: online refresh (1 trainer on the card x 2 pservers on the '
       'host, sync SGD; one serving process on the card tracks the '
       'published versions with LMServer.enable_refresh)')
def online_refresh(work_root, spec=None, place_name='cuda'):
    """tests/test_online.py:671's cluster at the LM's width: the serving
    process installs version ON_ROUNDS; every parameter it serves has
    the digest of the trainer's pull after the last round, byte for
    byte; one serving process did it all (weight_swaps >= 1, no refresh
    failure); its streams after the refresh are held to a fresh
    LMServer on round ON_ROUNDS's values by the margin rule. The trainer
    starts its rounds once the server has subscribed, so the server
    follows them as they close. Logs the refresh latency, the bytes
    pulled and MB/s."""
    spec = spec or {}
    t0 = time.perf_counter()
    work = scratch(tempfile.mkdtemp(dir=work_root))
    res = run_ps_cluster('on1', work, spec, place_name, roles=[
        ('pserver', i) for i in range(PS_PSERVERS)] + [('trainer', 0),
                                                       ('serving', 0)])
    tr, sv = res['trainer0'], res['serving0']
    if sv['installed'] != ON_ROUNDS or sv['param_version'] != ON_ROUNDS:
        raise AssertionError('on1: installed version %r (stats %r), want %d'
                             % (sv['installed'], sv['param_version'],
                                ON_ROUNDS))
    if not sv['digests']:
        raise AssertionError('on1: the server reports no parameter')
    bad = sorted(n for n, d in sv['digests'].items()
                 if tr['digests'].get(n) != d)
    if bad:
        raise AssertionError('on1: served %s differ from the trainer\'s '
                             'version-%d bytes' % (bad[:8], ON_ROUNDS))
    if sv['weight_swaps'] < 1 or sv['refresh_failures'] != 0:
        raise AssertionError('on1: weight_swaps %d, refresh_failures %d; '
                             'want >= 1 and 0' % (sv['weight_swaps'],
                                                  sv['refresh_failures']))
    if not all(np.isfinite(tr['losses'])):
        raise AssertionError('on1: losses %s' % tr['losses'])
    rounds = ps_lm_cfg(spec).layers * ON_ROUNDS
    _check_flash_launches('on1: the trainer', tr['launches'], {
        KERNELS['fwd'][0]: rounds, KERNELS['k2'][0]: rounds}, place_name)
    _check_flash_launches('on1: the serving process', sv['launches'],
                          {KERNELS['fwd'][0]: None}, place_name)
    n, lat, lat_max = sv['refresh_s']
    nb = sv['refresh_bytes'][1]
    wall = time.perf_counter() - t0
    log('on1: %d parameters served, every digest equal to the trainer\'s '
        'pull after round %d; %d refreshes (version %d), %d weight swaps, '
        '0 failures, in one serving process; from enable_refresh to version '
        '%d %.3f s; a refresh %.3f s on average (the longest %.3f s), %.1f '
        'MB pulled, %.1f MB/s; trainer step ms %s, losses %s; streams after '
        'the refresh vs the fresh server: %d of %d equal (bit-exact %s); '
        'K1 fp32 launches %d in the trainer and %d in the serving process, '
        'K2 %d in the trainer, plain flash calls 0; %.1f s'
        % (len(sv['digests']), ON_ROUNDS, sv['refreshes'], sv['installed'],
           sv['weight_swaps'], ON_ROUNDS, sv['track_s'], lat / max(n, 1),
           lat_max, nb / 1e6, nb / 1e6 / max(lat, 1e-9),
           ' '.join('%.1f' % x for x in tr['step_ms']),
           ' '.join('%.6f' % x for x in tr['losses']), sv['equal'],
           ON_PROMPTS, sv['equal'] == ON_PROMPTS,
           tr['launches'][KERNELS['fwd'][0]],
           sv['launches'][KERNELS['fwd'][0]],
           tr['launches'][KERNELS['k2'][0]], wall))
    return dict(seconds=wall, refreshes=sv['refreshes'],
                refresh_s=lat / max(n, 1), mb=nb / 1e6 / max(n, 1),
                mb_s=nb / 1e6 / max(lat, 1e-9), equal=sv['equal'],
                track_s=sv['track_s'], n_params=len(sv['digests']),
                launches={'K1': tr['launches'][KERNELS['fwd'][0]]
                          + sv['launches'][KERNELS['fwd'][0]],
                          'K2': tr['launches'][KERNELS['k2'][0]]})


# -- replica processes --------------------------------------------------------

def start_replicas(label, specs, work, model_dir, place_name,
                   timeout=FLEET_TIMEOUT):
    """Start one `python -m paddle_tpu_torch.tools.serve_replica` process
    per (name, env overrides) of `specs`, all at once, each serving
    `model_dir` on an ephemeral port, and wait for every READY line.
    Returns {name: {'proc', 'ep', 'log'}}; a replica that exits or is not
    ready within `timeout` fails `label` (every child is killed then)."""
    reps = {}
    try:
        for name, extra in specs:
            logp = os.path.join(work, name + '.log')
            env = dict(os.environ, SERVE_MODEL_DIR=model_dir,
                       SERVE_ENDPOINT='127.0.0.1:0',
                       SERVE_PLACE='cpu' if place_name == 'cpu' else 'cuda')
            if place_name == 'cpu':
                # a rehearsal's replicas share the host's cores
                env.setdefault('OMP_NUM_THREADS', '1')
            env.update(extra)
            with open(logp, 'wb') as lf:
                proc = subprocess.Popen(
                    [sys.executable, '-m',
                     'paddle_tpu_torch.tools.serve_replica'],
                    env=env, cwd=HERE, stdout=lf, stderr=subprocess.STDOUT)
            reps[name] = {'proc': proc, 'ep': None, 'log': logp}
        deadline = time.monotonic() + timeout
        while any(r['ep'] is None for r in reps.values()):
            for name, r in reps.items():
                if r['ep'] is not None:
                    continue
                m = re.search(r'^READY (\d+)$', _tail(r['log'], 1 << 20),
                              re.M)
                if m:
                    r['ep'] = '127.0.0.1:%s' % m.group(1)
                elif r['proc'].poll() is not None or \
                        time.monotonic() > deadline:
                    raise AssertionError('%s: replica %s %s\n%s' % (
                        label, name, 'exited %s' % r['proc'].returncode
                        if r['proc'].poll() is not None else
                        'not ready after %d s' % timeout, _tail(r['log'])))
            time.sleep(0.05)
    except BaseException:
        stop_replicas(reps)
        raise
    return reps


def stop_replicas(reps, timeout=60):
    """COMPLETE every live replica (a clean exit 0 that prints its
    LAUNCHES line), kill any that does not exit within `timeout`, and
    return {name: (exit code, launch counts or None)}."""
    from paddle_tpu_torch.distributed import wire
    import socket
    for r in reps.values():
        if r['ep'] is None or r['proc'].poll() is not None:
            continue
        host, port = r['ep'].rsplit(':', 1)
        try:
            with socket.create_connection((host, int(port)),
                                          timeout=5.0) as s:
                s.settimeout(timeout)
                wire.write_msg(s, wire.COMPLETE, {'seq': 0})
                wire.read_msg(s)
        except OSError:
            pass
    out = {}
    for name, r in reps.items():
        try:
            r['proc'].wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            r['proc'].kill()
            r['proc'].wait()
        m = re.search(r'^LAUNCHES (\{.*\})$', _tail(r['log'], 1 << 20), re.M)
        out[name] = (r['proc'].returncode,
                     json.loads(m.group(1)) if m else None)
    return out


def _replica_call(ep, msg_type, meta=None, value=None, timeout=FLEET_TIMEOUT):
    """One request to a replica on a connection of its own -> (reply
    type, meta, value)."""
    from paddle_tpu_torch.distributed import wire
    import socket
    host, port = ep.rsplit(':', 1)
    with socket.create_connection((host, int(port)), timeout=10.0) as s:
        s.settimeout(timeout)
        wire.write_msg(s, msg_type, dict(meta or {}, seq=0), value)
        return wire.read_msg(s)


def warm_replica(ep, prompt, budget, extra=None, timeout=FLEET_TIMEOUT):
    """One throwaway stream on a replica over a direct connection,
    watched through SRV_HEALTH until the replica is idle (never SRV_POLL:
    a fault rule counting SRV_POLLs keeps its count): the replica's
    programs run once and are captured before the measured traffic."""
    from paddle_tpu_torch.distributed import wire
    meta = dict({'rid': 'warm%d' % len(prompt), 'mnt': int(budget)},
                **(extra or {}))
    rt, m, _ = _replica_call(ep, wire.SRV_SUBMIT, meta,
                             np.asarray(prompt, np.int64))
    if rt != wire.REPLY_OK:
        raise AssertionError('warm-up submit to %s: %r' % (ep, m))
    deadline = time.monotonic() + timeout
    while True:
        _, h, _ = _replica_call(ep, wire.SRV_HEALTH)
        if not h.get('active') and not h.get('queue_depth'):
            return h
        if time.monotonic() > deadline:
            raise AssertionError('warm-up of %s timed out' % ep)
        time.sleep(0.02)


def ship_warm(ep, prompt, peer, timeout=FLEET_TIMEOUT):
    """One stream on a paged decode replica naming `peer` as its prefill
    replica, as the router dispatches one (the replica ships the
    prompt's pages from the peer, then decodes 2 tokens); polled to DONE
    over SRV_POLL. Returns the replica's SRV_HEALTH after it."""
    from paddle_tpu_torch.distributed import wire
    rid = 'ship%d' % len(prompt)
    rt, m, _ = _replica_call(ep, wire.SRV_SUBMIT,
                             {'rid': rid, 'mnt': 2, 'prefill_from': peer},
                             np.asarray(prompt, np.int64))
    if rt != wire.REPLY_OK:
        raise AssertionError('ship warm-up submit to %s: %r' % (ep, m))
    deadline = time.monotonic() + timeout
    while True:
        st = _replica_call(ep, wire.SRV_POLL, {'rids': [rid]})[1][
            'streams'][rid]
        if st['state'] == 'DONE':
            return _replica_call(ep, wire.SRV_HEALTH)[1]
        if st['state'] not in ('QUEUED', 'RUNNING') or \
                time.monotonic() > deadline:
            raise AssertionError('ship warm-up on %s: %r' % (ep, st))
        time.sleep(0.01)


def _check_flash_launches(label, launches, want, place_name):
    """On the card: of the flash wrappers' counts in `launches` (with
    'plain_cuda_calls'), each named in `want` is its count there (None:
    at least one), every other is 0, and no plain flash call ran."""
    if place_name != 'cuda':
        return
    bad = launches['plain_cuda_calls'] != 0 or any(
        c != want.get(n, 0) and not (n in want and want[n] is None and c > 0)
        for n, c in launches.items() if n != 'plain_cuda_calls') or \
        not set(want) <= set(launches)
    if bad:
        raise AssertionError(
            '%s launched %s: want %s, no other flash kernel and no plain '
            'flash call' % (label, launches, ', '.join(
                '%s %s' % (n, '> 0' if c is None else c)
                for n, c in sorted(want.items())) or 'none'))


def _check_replica_launches(label, exits, names, place_name, flash):
    """Each named replica exited 0 with its LAUNCHES line, and launched
    the flash forward (flash=True: > 0 times) or no flash kernel at all
    and no plain flash call on the card."""
    out = {}
    for name in names:
        code, launches = exits[name]
        if code != 0 or launches is None:
            raise AssertionError('%s: replica %s exited %s without its '
                                 'LAUNCHES line' % (label, name, code))
        out[name] = launches
        _check_flash_launches('%s: replica %s' % (label, name), launches,
                              {KERNELS['fwd'][0]: None} if flash else {},
                              place_name)
    return out


def _fleet_streams(label, reqs, budgets, timeout=FLEET_TIMEOUT):
    """Wait for every FleetRequest: each DONE with its whole budget."""
    for r, n in zip(reqs, budgets):
        if not r.wait(timeout=timeout):
            raise AssertionError('%s: request %d still %s after %d s'
                                 % (label, r.id, r.state, timeout))
        if r.state != 'DONE' or len(r.tokens) != n:
            raise AssertionError('%s: request %d %s with %d of %d tokens '
                                 '(%s)' % (label, r.id, r.state,
                                           len(r.tokens), n, r.error))
    return [list(r.tokens) for r in reqs]


def _solo_streams(srv, prompts, budgets):
    """Each prompt alone on `srv`: the next is submitted once the last
    is done."""
    return [srv.result(srv.submit(p, max_new_tokens=n), timeout=FLEET_TIMEOUT)
            for p, n in zip(prompts, budgets)]


def _deploy_parts(obs_dir, endpoints):
    """{endpoint: seconds} of each replica's turn in a rolling deploy,
    read from the router's trace under `obs_dir`: from its fleet.drain
    span's start to the next replica's (the last: to the fleet.deploy
    span's end), which covers its drain, refresh, health check and
    rejoin."""
    spans = []
    for name in os.listdir(obs_dir):
        with open(os.path.join(obs_dir, name)) as f:
            spans += [e for e in map(json.loads, f) if e['type'] == 'span']
    deploy = [e for e in spans if e['name'] == 'fleet.deploy']
    drains = sorted((e['t0'], e['endpoint']) for e in spans
                    if e['name'] == 'fleet.drain')
    if len(deploy) != 1 or [ep for _, ep in drains] != list(endpoints):
        raise AssertionError('the router traced %d deploys and drains of '
                             '%s, want 1 and %s' % (
                                 len(deploy), [ep for _, ep in drains],
                                 list(endpoints)))
    ends = [t for t, _ in drains[1:]] + [deploy[0]['t1']]
    return {ep: t1 - t0 for (t0, ep), t1 in zip(drains, ends)}


def _fl_place(place_name):
    import paddle_tpu_torch as fluid
    return fluid.CPUPlace() if place_name == 'cpu' else fluid.CUDAPlace(0)


@phase('fl1: a fleet of dense replicas (2 replica processes on the card '
       'behind a FleetRouter, one killed mid-stream; then a rolling '
       'deploy of version 1 to 2 fresh replicas under live traffic)')
def fleet_serving(model_dir, work_root, spec=None, place_name='cuda'):
    """Failover: FL1_STREAMS streams over 2 replicas, replica 1 killed at
    its FL1_KILL_POLL-th SRV_POLL: every stream DONE, failovers >= 1, and
    every stream held by the margin rule to its prompt served alone by an
    in-process LMServer over c1's bytes (re-prefill vs uninterrupted).
    Rolling deploy: zero drops, each replica's param_digests() the
    published manifest, and the streams after the deploy held to solo
    streams of an in-process server on version 1. Each clean replica
    launched K1 fp32 and never the plain version. Logs tokens/s, TTFT,
    the failover and each replica's deploy (from the router's trace)."""
    import torch
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.distributed import wire
    from paddle_tpu_torch.distributed.param_service import ParameterService
    from paddle_tpu_torch.distributed.rpc import PSClient, PSServer
    from paddle_tpu_torch.obs import trace
    from paddle_tpu_torch.serving import FleetRouter
    spec = spec or {}
    t_phase = time.perf_counter()
    place = _fl_place(place_name)
    work = scratch(tempfile.mkdtemp(dir=work_root))
    n_streams = spec.get('streams', FL1_STREAMS)
    new = spec.get('new_tokens', FL1_NEW_TOKENS)
    sessions = spec.get('sessions', FL1_SESSIONS)
    slots = spec.get('slots', SLOTS)
    kill = json.dumps({'rules': [{'when': 'recv', 'type': 'SRV_POLL',
                                  'nth': spec.get('kill_poll', FL1_KILL_POLL),
                                  'action': 'exit'}]})
    params = {}
    svc = ParameterService(num_trainers=1, sync_mode=True,
                           get_param=lambda n: params[n],
                           run_round=lambda merged: None, rpc_deadline=600.0,
                           param_names=[])
    ps = PSServer('127.0.0.1:0', svc)
    ps_thread = threading.Thread(target=ps.serve_forever, daemon=True)
    ps_thread.start()
    ps_ep = '127.0.0.1:%d' % ps.port
    base = {'SERVE_SLOTS': str(slots)}
    deploy_env = dict(base, SERVE_PS_ENDPOINTS=ps_ep,
                      FLAGS_online_pull_timeout='600')
    t0 = time.perf_counter()
    reps = start_replicas('fl1', [
        ('r0', base), ('r1', dict(base, FLAGS_fault_plan=kill)),
        ('d0', dict(deploy_env, SERVE_SUBSCRIBER_ID='1')),
        ('d1', dict(deploy_env, SERVE_SUBSCRIBER_ID='2'))],
        work, model_dir, place_name)
    start_s = time.perf_counter() - t0
    routers = []
    try:
        # the in-process reference over the same bytes, and the
        # parameter service's copy of them (version 0)
        pred = fluid.inference.AnalysisPredictor(
            fluid.inference.AnalysisConfig(model_dir, place=place))
        ref_dec = pred.prepare_decoding(slots=slots, prefill_batch=1)
        names = ref_dec.param_names()
        for n in names:
            params[n] = ref_dec._weight_scope.find_var(n).detach().cpu()
        svc.param_names = sorted(names)
        vocab = ref_dec.vocab
        warm = seeded_prompts(SEED + 60, [8], vocab)[0]
        ths = [threading.Thread(target=warm_replica,
                                 args=(r['ep'], warm, 4)) for r in
               reps.values()]
        for t in ths:
            t.start()
        for t in ths:
            t.join()

        # -- failover ---------------------------------------------------
        prompts = seeded_prompts(
            SEED + 61, np.linspace(16, spec.get('max_prompt', 200), n_streams),
            vocab)
        router = FleetRouter([reps['r0']['ep'], reps['r1']['ep']],
                             probe_secs=0.05, probe_fail_threshold=2)
        routers.append(router)
        router.start()
        router.wait_healthy(timeout=FLEET_TIMEOUT)
        t0 = time.perf_counter()
        reqs = [router.submit(p, max_new_tokens=new, session=i % sessions)
                for i, p in enumerate(prompts)]
        # the failover's time: from the router's first failover to the
        # first new token of the last stream it moved
        fo = {}
        while not all(r.wait(0) for r in reqs):
            if 'at' not in fo and router.stats()['failovers']:
                fo['at'] = time.perf_counter()
                fo['moved'] = {r.id: len(r.tokens) for r in reqs
                               if r.segment and not r.wait(0)}
            if 'at' in fo and 'done' not in fo and all(
                    len(r.tokens) > fo['moved'][r.id] or r.wait(0)
                    for r in reqs if r.id in fo['moved']):
                fo['done'] = time.perf_counter()
            if time.perf_counter() - t0 > FLEET_TIMEOUT:
                break
            time.sleep(0.002)
        gots = _fleet_streams('fl1 failover', reqs, [new] * n_streams)
        wall = time.perf_counter() - t0
        fst = router.stats()
        router.stop()
        if fst['failovers'] < 1:
            raise AssertionError('fl1: no failover (stats %r): replica 1 '
                                 'was not killed mid-stream' % (fst,))
        if reps['r1']['proc'].wait(timeout=60) == 0:
            raise AssertionError('fl1: replica 1 exited cleanly; its fault '
                                 'rule did not fire')
        ttft = sorted((r.first_token_at - r.submitted_at) * 1e3
                      for r in reqs)
        moved = sum(1 for r in reqs if r.segment)
        with fluid.serving.LMServer(ref_dec) as srv:
            refs = _solo_streams(srv, prompts, [new] * n_streams)
        fo_held = hold_streams('fl1 failover: streams vs solo streams in '
                               'process', prompts, refs, gots, ref_dec)

        # -- rolling deploy of version 1 --------------------------------
        gen = torch.Generator(device=ref_dec.device).manual_seed(SEED + 71)
        for n in svc.param_names:
            w = ref_dec._weight_scope.find_var(n)
            params[n] = (w + FL1_PERTURB * torch.randn(
                w.shape, generator=gen, device=w.device,
                dtype=w.dtype)).cpu()
        want = {n: _wire_digest(params[n]) for n in svc.param_names}
        d_eps = [reps['d0']['ep'], reps['d1']['ep']]
        router = FleetRouter(d_eps, probe_secs=0.05)
        routers.append(router)
        router.start()
        router.wait_healthy(timeout=FLEET_TIMEOUT)
        lens = np.linspace(16, spec.get('max_prompt', 96), FL1_DEPLOY_STREAMS)
        live = seeded_prompts(SEED + 72, lens, vocab)
        during, stop_traffic = [], threading.Event()

        def traffic():
            # one replica's slots of streams in flight at any time: the
            # other replica is drained for its deploy
            i = 0
            while not stop_traffic.is_set():
                if sum(not r.wait(0) for r in during) < slots:
                    during.append(router.submit(
                        live[i % len(live)],
                        max_new_tokens=FL1_DEPLOY_TOKENS))
                    i += 1
                stop_traffic.wait(0.005)
        feeder = threading.Thread(target=traffic, daemon=True)
        feeder.start()
        # the deploy starts once streams are live on both replicas
        deadline = time.monotonic() + FLEET_TIMEOUT
        while not all(router.stats()['replicas'][ep]['active']
                      for ep in d_eps):
            if time.monotonic() > deadline:
                raise AssertionError('fl1: traffic never reached both '
                                     'deploy replicas')
            time.sleep(0.005)
        svc.on_send_var('fl1@GRAD', 0, torch.zeros(1), seq=('fl1', 1))
        svc.on_batch_barrier(0, seq=('fl1', 2))          # version 1
        obs_dir = os.path.join(work, 'deploy_trace')
        trace.enable(obs_dir, role='fl1')
        t0 = time.perf_counter()
        try:
            out = router.rolling_deploy(min_version=1,
                                        timeout=spec.get('deploy_timeout',
                                                         FLEET_TIMEOUT))
        finally:
            trace.disable()
        deploy_s = time.perf_counter() - t0
        stop_traffic.set()
        feeder.join(timeout=60)
        if out != {ep: 1 for ep in d_eps}:
            raise AssertionError('fl1: rolling_deploy returned %r' % (out,))
        _fleet_streams('fl1 deploy traffic', during,
                       [FL1_DEPLOY_TOKENS] * len(during))
        post = seeded_prompts(SEED + 73, lens, vocab)
        after = [router.submit(p, max_new_tokens=FL1_DEPLOY_TOKENS)
                 for p in post]
        after = _fleet_streams('fl1 after the deploy', after,
                               [FL1_DEPLOY_TOKENS] * len(post))
        dst = router.stats()
        if dst['failed'] or dst['shed']:
            raise AssertionError('fl1: the deploy dropped streams: %r'
                                 % (dst,))
        for name in ('d0', 'd1'):
            _, h, _ = _replica_call(reps[name]['ep'], wire.SRV_HEALTH,
                                    {'digests': True})
            bad = sorted(n for n in want if h['digests'].get(n) != want[n])
            if bad or set(h['digests']) != set(want) or \
                    h['param_version'] != 1:
                raise AssertionError(
                    'fl1: replica %s (version %r) serves %s not as '
                    'published' % (name, h['param_version'],
                                   bad[:8] or sorted(set(h['digests'])
                                                     ^ set(want))[:8]))
        router.stop()
        deploy_each = _deploy_parts(obs_dir, d_eps)
        for n in svc.param_names:
            ref_dec._weight_scope.find_var(n).copy_(params[n])
        with fluid.serving.LMServer(ref_dec) as srv:
            refs1 = _solo_streams(srv, post, [FL1_DEPLOY_TOKENS] * len(post))
        dep_held = hold_streams('fl1 deploy: streams after it vs solo '
                                'streams in process on version 1', post,
                                refs1, after, ref_dec)
    finally:
        for r in routers:
            r.stop()
        exits = stop_replicas(reps)
        cli = PSClient(ps_ep, trainer_id=0)
        cli.complete()
        cli.close()
        ps_thread.join(timeout=30)
    launches = _check_replica_launches('fl1', exits, ('r0', 'd0', 'd1'),
                                       place_name, flash=True)
    del ref_dec, pred
    wall_phase = time.perf_counter() - t_phase
    tokens = n_streams * new
    log('fl1: %d replicas ready %.1f s after their start; failover burst %d '
        'streams x %d tokens over %d sessions: %.3f s, %.1f tokens/s '
        'through the router over the burst (the failover included), TTFT '
        'p50 %.1f ms, the longest of %d %.1f ms; replica 1 '
        'killed at its SRV_POLL %d (exit %s), %d streams moved (%d '
        'failovers), the last of them on its next token %s ms after the '
        'router\'s first failover; %d of %d streams equal to the solo '
        'streams in process; rolling deploy %.3f s (%s, each from its '
        'fleet.drain span to the next), %d streams of live traffic through '
        'it, none dropped, both replicas\' digests the manifest\'s (%d '
        'parameters); %d of %d streams after it equal to the solo streams '
        'in process on version 1; K1 fp32 launches %s (replica 1 killed: not '
        'read), plain flash calls 0; %.1f s'
        % (len(reps), start_s, n_streams, new, sessions, wall,
           tokens / wall, ttft[len(ttft) // 2], len(ttft), ttft[-1],
           spec.get('kill_poll', FL1_KILL_POLL), exits['r1'][0], moved,
           fst['failovers'], _fmt_ms((fo['done'] - fo['at']) * 1e3)
           if 'done' in fo else 'not measured', fo_held['equal'], n_streams,
           deploy_s, ', '.join('%s %.3f s' % (n, deploy_each[reps[n]['ep']])
                               for n in ('d0', 'd1')),
           len(during), len(want), dep_held['equal'], len(post),
           ', '.join('%s %d' % (n, v['flash_attention_fwd'])
                     for n, v in launches.items()), wall_phase))
    return dict(seconds=wall_phase, start_s=start_s, wall=wall,
                tok_s=tokens / wall, ttft_p50=ttft[len(ttft) // 2],
                ttft_max=ttft[-1], failovers=fst['failovers'], moved=moved,
                failover_ms=(fo['done'] - fo['at']) * 1e3
                if 'done' in fo else None,
                equal=fo_held['equal'], deploy_s=deploy_s,
                deploy_each={n: deploy_each[reps[n]['ep']]
                             for n in ('d0', 'd1')},
                deploy_equal=dep_held['equal'], during=len(during),
                launches={n: v['flash_attention_fwd']
                          for n, v in launches.items()})


@phase('fl2: disaggregated prefill (a prefill replica and 2 paged decode '
       'replicas on the card; the prefill replica killed mid-ship)')
def disagg_serving(model_dir, work_root, spec=None, place_name='cuda'):
    """The pages the prefill replica ships for a system prompt are held
    to the rows this process's own paged server exports for the same
    prefix (bit-equal, else within RECOMPUTE_TOL); the prefill tier
    prefills that prefix once for 2 fetches of this script and the 2
    decode replicas' warm-up ships; a burst over it and a burst over a
    second system prompt, during which the prefill replica exits at its
    FL2_KILL_REPLY-th SRV_PAGES reply: every stream DONE, local
    re-prefills >= 1, and every stream held by the margin rule to its
    prompt served alone by this process's paged server. The decode
    replicas launch no kernel.
    Logs the bytes shipped and the ship time."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.distributed import wire
    from paddle_tpu_torch.serving import FleetRouter, disagg
    spec = spec or {}
    t_phase = time.perf_counter()
    place = _fl_place(place_name)
    work = scratch(tempfile.mkdtemp(dir=work_root))
    new = spec.get('new_tokens', NEW_TOKENS)
    slots = spec.get('slots', SLOTS)
    page_tokens = spec.get('page_tokens', PAGE_TOKENS)
    system_len = spec.get('system', SYSTEM_PROMPT)
    paged = {'SERVE_SLOTS': str(slots), 'SERVE_PAGED': '1',
             'SERVE_PAGE_TOKENS': str(page_tokens),
             'SERVE_PREFILL_CHUNK': str(spec.get('chunk', PREFILL_CHUNK))}
    kill = json.dumps({'rules': [{'when': 'send', 'type': 'SRV_PAGES',
                                  'nth': FL2_KILL_REPLY, 'action': 'exit'}]})
    t0 = time.perf_counter()
    reps = start_replicas('fl2', [
        ('p0', dict(paged, FLAGS_fault_plan=kill)), ('d0', paged),
        ('d1', paged)], work, model_dir, place_name)
    start_s = time.perf_counter() - t0
    router = None
    try:
        pred = fluid.inference.AnalysisPredictor(
            fluid.inference.AnalysisConfig(model_dir, place=place))
        dec = pred.prepare_decoding(
            slots=slots, paged=True, page_tokens=page_tokens,
            prefill_chunk=spec.get('chunk', PREFILL_CHUNK))
        vocab = dec.vocab
        systems = seeded_prompts(SEED + 81, [system_len, system_len], vocab)
        warm = seeded_prompts(SEED + 82, [page_tokens // 2], vocab)[0]
        ths = [threading.Thread(target=warm_replica,
                                 args=(r['ep'], warm, 4))
               for r in reps.values()]
        for t in ths:
            t.start()
        for t in ths:
            t.join()
        p_ep = reps['p0']['ep']

        def burst(seed, system):
            out = []
            rng = np.random.RandomState(seed)
            for i in range(spec.get('streams', FL2_STREAMS)):
                if i % 2 == 0:
                    out.append(system + rng.randint(
                        1, vocab, size=int(rng.randint(
                            2, page_tokens))).tolist())
                else:
                    # shorter than a page: no shippable chain
                    out.append(rng.randint(1, vocab, size=int(
                        rng.randint(2, page_tokens))).tolist())
            return out
        first = burst(SEED + 83, systems[0])
        second = burst(SEED + 84, systems[1])
        misses0 = _replica_call(p_ep, wire.SRV_HEALTH)[1]['prefix_misses']

        # this process's own fetches of the first system prompt: cold
        # (the prefill replica prefills it), then warm (a pure ship)
        fetch_ms, shipped = [], None
        for _ in range(2):
            t0 = time.perf_counter()
            rt, meta, value = _replica_call(
                p_ep, wire.SRV_PAGE_FETCH, {'have': []},
                np.asarray(first[0], np.int64))
            fetch_ms.append((time.perf_counter() - t0) * 1e3)
            if rt != wire.SRV_PAGES or value is None:
                raise AssertionError('fl2: the page fetch answered %d %r'
                                     % (rt, meta))
            shipped = (meta, disagg.unpack_rows(meta, value))
        ship_bytes = int(value.numel() * value.element_size())
        meta, rows = shipped
        with fluid.serving.LMServer(dec) as srv:
            srv.generate(first[0], 1, timeout=FLEET_TIMEOUT)
            export = srv.export_prefix(first[0])
        if export is None or export['keys'] != meta['keys'] or \
                len(rows) != len(export['data']):
            raise AssertionError('fl2: shipped keys %s vs the local '
                                 'export\'s %s' % (
                                     meta['keys'][:2], None if export is None
                                     else export['keys'][:2]))
        row_err = max(float(np.abs(np.asarray(a, np.float64) - b).max())
                      for a, b in zip(rows, export['data']))
        bit_equal = all(np.array_equal(a, b)
                        for a, b in zip(rows, export['data']))
        if not row_err <= RECOMPUTE_TOL:
            raise AssertionError('fl2: shipped page rows differ from the '
                                 'local export by %.3e, want <= %g'
                                 % (row_err, RECOMPUTE_TOL))
        # each decode replica ships the chain once, as the router's
        # dispatch would (SRV_SUBMIT naming the prefill peer)
        # (the stream then hits the shipped chain in its prefix cache)
        for name in ('d0', 'd1'):
            h = ship_warm(reps[name]['ep'], first[0], p_ep)
            if h['local_reprefills'] or h['prefix_hits'] < 1 or \
                    h['prefix_entries'] < len(meta['keys']):
                raise AssertionError(
                    'fl2: replica %s after its ship: %d local re-prefills, '
                    '%d prefix hits, %d chain entries; want 0, >= 1 and %d'
                    % (name, h['local_reprefills'], h['prefix_hits'],
                       h['prefix_entries'], len(meta['keys'])))
        misses = _replica_call(p_ep, wire.SRV_HEALTH)[1]['prefix_misses']
        if misses - misses0 != 1:
            raise AssertionError('fl2: the prefill tier prefilled the system '
                                 'prompt %d times for 4 fetches, want once'
                                 % (misses - misses0))

        router = FleetRouter([reps['d0']['ep'], reps['d1']['ep']],
                             prefill_replicas=[p_ep], probe_secs=0.05)
        router.start()
        router.wait_healthy(timeout=FLEET_TIMEOUT)
        t0 = time.perf_counter()
        reqs = [router.submit(p, max_new_tokens=new) for p in first]
        got_a = _fleet_streams('fl2 first burst', reqs, [new] * len(first))
        wall_a = time.perf_counter() - t0
        reqs = [router.submit(p, max_new_tokens=new) for p in second]
        got_b = _fleet_streams('fl2 second burst', reqs,
                               [new] * len(second))
        if reps['p0']['proc'].wait(timeout=60) == 0:
            raise AssertionError('fl2: the prefill replica exited cleanly; '
                                 'its fault rule did not fire')
        deadline = time.monotonic() + FLEET_TIMEOUT
        while router.stats()['local_reprefills'] < 1:
            if time.monotonic() > deadline:
                raise AssertionError('fl2: no local re-prefill after the '
                                     'prefill replica died: %r'
                                     % (router.stats(),))
            time.sleep(0.01)
        st = router.stats()
        router.stop()
        prompts = first + second
        with fluid.serving.LMServer(dec) as srv:
            refs = _solo_streams(srv, prompts, [new] * len(prompts))
        held = hold_streams('fl2: streams vs solo streams on this process\'s '
                            'paged server',
                            prompts, refs, got_a + got_b, dec)
    finally:
        if router is not None:
            router.stop()
        exits = stop_replicas(reps)
    _check_replica_launches('fl2', exits, ('d0', 'd1'), place_name,
                            flash=False)
    del dec, pred
    wall_phase = time.perf_counter() - t_phase
    log('fl2: %d replicas ready %.1f s after their start; the %d-token '
        'system prompt\'s %d pages (%d pools) shipped in %d bytes: fetch '
        '%.3f ms cold (prefill included), %.3f ms warm (%.1f MB/s); the '
        'rows vs the local export: bit-equal %s, max |diff| %.3e; prefilled '
        'once on the prefill tier for 4 fetches; first burst %d streams x '
        '%d tokens %.3f s; the prefill replica killed at its SRV_PAGES reply '
        '%d (exit %s) during the second: every stream DONE, local '
        're-prefills %d, pages shipped %d, %d ship bytes (the router\'s sum); '
        '%d of %d streams equal to solo streams on the local paged server; '
        '%.1f s'
        % (len(reps), start_s, system_len, len(meta['keys']), len(rows),
           ship_bytes, fetch_ms[0], fetch_ms[1],
           ship_bytes / 1e3 / max(fetch_ms[1], 1e-9), bit_equal, row_err,
           len(first), new, wall_a, FL2_KILL_REPLY, exits['p0'][0],
           st['local_reprefills'], st['pages_shipped'], st['ship_bytes'],
           held['equal'], len(prompts), wall_phase))
    return dict(seconds=wall_phase, start_s=start_s, ship_bytes=ship_bytes,
                fetch_ms=fetch_ms, bit_equal=bit_equal, row_err=row_err,
                local_reprefills=st['local_reprefills'],
                equal=held['equal'], streams=len(prompts))


_SCRATCH_DIRS = []


# ---------------------------------------------------------------------------
# mp1, mp2: the device mesh. The ranks of a mesh are processes of this
# script (`--ps-worker rank <r>`, started by run_ps_cluster) that share the
# one card under gloo; each holds its shards, runs its ops by their layout
# rules (paddle_tpu_torch/parallel/layout.py) and meets the others in the
# collectives. What crosses between them is measured here; it is not a
# multi-card speed.
# ---------------------------------------------------------------------------

# mp1: bench_long_context's model with ring attention, sp=4 (T/4 = 2048
# tokens a rank: K/V blocks [16, 2048, 128] bf16), cut to 2 layers (for
# the script's time); mp2: the flagship LM at
# full width cut to 2 layers (as ps1), use_tp and use_sp, dp=2 x tp=2
MP1 = dict(model=dict(LC_MODEL, layers=2, ring_attention=True),
           batch=LC_BATCH, head_chunk=LC_HEAD_CHUNK, mesh=dict(sp=4))
MP2 = dict(model=dict(MODEL, layers=2, use_tp=True, use_sp=True),
           batch=TRAIN_BATCH, head_chunk=HEAD_CHUNK, mesh=dict(dp=2, tp=2))
# pp1: the flagship LM at full width cut to 4 layers, 2 a stage, on
# pp=2 x dp=2: each dp rank's 4 rows in 4 microbatches of one row
PP1 = dict(model=dict(MODEL, layers=4, pp_stages=2), batch=TRAIN_BATCH,
           head_chunk=HEAD_CHUNK, mesh=dict(pp=2, dp=2, micro_batches=4))
MP_STEPS = 3
# the ranks' reserved device memory, summed, stays under this (PERF.md §2)
MP_RESERVED_GB = 70.0
# the gloo probes: each collective of the slice on CUDA tensors; the ones
# parallel/collectives.py stages through the host must refuse, the others
# must give the right sums
MP_PROBES = ('all_reduce', 'all_gather_into_tensor', 'reduce_scatter_tensor',
             'all_to_all_single', 'send_recv')


def mp_spec(name, spec):
    base = dict({'mp1': MP1, 'mp2': MP2, 'pp1': PP1}[name])
    spec = dict(spec or {})
    if 'model' in spec:
        spec['model'] = dict(base['model'], **spec['model'])
    base.update(spec)
    return base


def mp_program(cfg, head_chunk):
    """bench.py's LM step (trunk, fused head, mean, AMP Momentum(0.001,
    0.9)) fed by a feed dict; the same seed as every LM phase."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import transformer as tfm
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        tokens = fluid.layers.data(name='tokens', shape=[cfg.max_len, 1],
                                   dtype='int64')
        labels = fluid.layers.data(name='labels', shape=[cfg.max_len, 1],
                                   dtype='int64')
        trunk = tfm.language_model_trunk(tokens, cfg)
        cost = fluid.layers.fused_softmax_cross_entropy(
            trunk, labels, cfg.vocab, chunk=head_chunk, name='lm_head')
        avg = fluid.layers.mean(cost)
        opt = fluid.contrib.mixed_precision.decorate(
            fluid.optimizer.Momentum(learning_rate=0.001, momentum=0.9))
        opt.minimize(avg)
    return main, startup, avg


def mp_batches(cfg, batch, steps=MP_STEPS):
    rng = np.random.RandomState(SEED)
    out = []
    for _ in range(steps):
        toks = rng.randint(0, cfg.vocab, size=(batch, cfg.max_len, 1)
                           ).astype('int64')
        out.append({'tokens': toks, 'labels': np.roll(toks, -1, axis=1)})
    return out


def mp_compared(cfg):
    """The first qkv weight, the last down weight and the head (the
    parallel layers' names under use_tp)."""
    w = '_0.w' if cfg.use_tp else '.w_0'
    return ('layer0_qkv' + w, 'layer%d_down' % (cfg.layers - 1) + w,
            'lm_head.w_0')


def _mp_steps(pe, avg, batches, params, read, sync):
    """MP_STEPS steps: the losses, each step's ms, and after the first
    the compared parameters and their velocities (the first step's
    gradients) read by `read`."""
    losses, ms, first = [], [], None
    for i, feed in enumerate(batches):
        sync()
        t0 = time.perf_counter()
        losses.append(float(np.asarray(pe.run(
            fetch_list=[avg.name], feed=feed)[0]).reshape(-1)[0]))
        sync()
        ms.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            first = {n: read(n) for n in params}
            first.update({n + '_velocity_0': read(n + '_velocity_0')
                          for n in params})
    return losses, ms, first


def mp_reference(name, spec, place):
    """The same program in one process (mp1: full attention over T
    through K1, l1's program), from the same weights and batches."""
    import torch
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models.transformer import TransformerConfig
    kw = dict(spec['model'], ring_attention=False)
    cfg = TransformerConfig(**kw)
    main, startup, avg = mp_program(cfg, spec['head_chunk'])
    scope = fluid.Scope()
    fluid.Executor(place).run(startup, scope=scope)
    pe = fluid.ParallelExecutor(use_cuda=place.device.type == 'cuda',
                                loss_name=avg.name, main_program=main,
                                scope=scope)
    params = mp_compared(cfg)
    start = {n: scope.find_var(n).float().cpu().clone() for n in params}
    losses, ms, first = _mp_steps(
        pe, avg, mp_batches(cfg, spec['batch']), params,
        lambda n: scope.find_var(n).float().cpu().clone(), torch_sync(place))
    pe.close()
    del pe, scope
    if place.device.type == 'cuda':
        free_device_memory()
    return dict(losses=losses, ms=ms, first=first, start=start)


def mesh_rank(name, index, spec, place, work):
    """One rank of mp1, mp2 or pp1 (in its own process): the mesh
    program's MP_STEPS steps through ParallelExecutor(strategy=); returns
    its losses, step ms, launches, collectives, the pipeline's counts of
    the last step (pp1) and memory. Rank 0 also saves the compared
    parameters after the first step (whole values)."""
    import torch
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.models.transformer import TransformerConfig
    from paddle_tpu_torch.parallel import DistributedStrategy
    from paddle_tpu_torch.parallel import ring_attention as ra
    cfg = TransformerConfig(**spec['model'])
    main, startup, avg = mp_program(cfg, spec['head_chunk'])
    scope = fluid.Scope()
    fluid.Executor(place).run(startup, scope=scope)
    params = mp_compared(cfg)
    start = {n: float(scope.find_var(n).double().sum()) for n in params}
    cuda = place.device.type == 'cuda'
    pe = fluid.ParallelExecutor(
        use_cuda=cuda, loss_name=avg.name, main_program=main, scope=scope,
        strategy=DistributedStrategy(**spec['mesh']))
    sync = torch_sync(place)
    names = [KERNELS[k][0] for k in KERNELS]
    for n in names:
        getattr(fa, n).launches = 0
    fa.FlashAttention.plain_cuda_calls = 0
    ra.RingCounters.fwd_blocks = ra.RingCounters.bwd_blocks = 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    losses, ms, first = _mp_steps(
        pe, avg, mp_batches(cfg, spec['batch']), params,
        lambda n: pe.global_value(n).float().cpu().clone(), sync)
    recs = pe.collective_records()
    pp = pe.pp_stats()
    if index == 0:
        torch.save(first, os.path.join(work, 'first.pt'))
    shards = {}
    for p in main.global_block().all_parameters():
        if pe.storage_spec(p.name):
            shards[p.name] = dict(
                local=list(scope.find_var(p.name).shape),
                full=list(p.shape),
                placements=[str(x) for x in pe.placements(p.name)])
    audit = fluid.profiler.collective_audit(recs)
    return dict(
        losses=losses, ms=ms, start=start,
        launches={n: getattr(fa, n).launches for n in names},
        plain=fa.FlashAttention.plain_cuda_calls,
        blocks=[ra.RingCounters.fwd_blocks, ra.RingCounters.bwd_blocks],
        audit={k: [len(v), int(sum(v))] for k, v in audit.items()},
        permute_s=sum(r['seconds'] for r in recs
                      if r['kind'] == 'collective-permute'),
        pp=None if pp is None else dict(
            act_bytes=pp.act_bytes, cot_bytes=pp.cot_bytes,
            grad_bytes=pp.grad_bytes, recv_wait_s=pp.recv_wait_s),
        coll_s=sum(r['seconds'] for r in recs),
        sent=int(sum(r['bytes'] for r in recs)),
        param_gathers=[list(g) for g in pe.param_gathers()],
        shards=shards,
        peak_gb=torch.cuda.max_memory_allocated() / 1e9 if cuda else 0.0,
        reserved_gb=torch.cuda.max_memory_reserved() / 1e9 if cuda else 0.0)


def mp_probe_rank(index, work):
    """`--ps-worker probe <i>`: each collective of MP_PROBES on CUDA
    tensors under gloo, unstaged; returns {name: 'ok' | error} with the
    sums checked. send/recv runs last (a refused send breaks the pair)."""
    import torch
    import torch.distributed as dist
    import datetime
    dist.init_process_group('gloo', init_method='file://' + os.path.join(
        work, 'probe_store'), rank=index, world_size=2,
        timeout=datetime.timedelta(seconds=30))
    dev = torch.device('cuda', 0)
    out = {}

    def attempt(name, fn, want):
        try:
            got = fn()
            torch.cuda.synchronize()
            ok = torch.equal(got.cpu(), want)
            out[name] = 'ok' if ok else 'wrong values'
        except Exception as e:
            out[name] = '%s: %s' % (type(e).__name__, str(e)[:160])
    x = torch.full((4,), float(index + 1), device=dev)

    def ar():
        t = x.clone()
        dist.all_reduce(t)
        return t
    attempt('all_reduce', ar, torch.full((4,), 3.0))

    def ag():
        t = torch.empty(8, device=dev)
        dist.all_gather_into_tensor(t, x)
        return t
    attempt('all_gather_into_tensor', ag,
            torch.tensor([1.0] * 4 + [2.0] * 4))

    def rs():
        t = torch.empty(2, device=dev)
        dist.reduce_scatter_tensor(t, torch.arange(4.0, device=dev))
        return t
    attempt('reduce_scatter_tensor', rs,
            torch.arange(4.0)[2 * index:2 * index + 2] * 2)

    def a2a():
        t = torch.empty(4, device=dev)
        dist.all_to_all_single(t, torch.arange(4.0, device=dev) +
                               10 * index)
        return t
    attempt('all_to_all_single', a2a, torch.tensor(
        [2.0 * index, 2.0 * index + 1, 10 + 2.0 * index,
         11 + 2.0 * index]))

    dist.barrier()
    dist.destroy_process_group()
    # a refused send aborts its process (gloo throws from its own
    # thread), so the pair runs in child processes of its own
    try:
        child = subprocess.run(
            [sys.executable, os.path.abspath(__file__), '--ps-worker',
             'probesr', str(index)], cwd=HERE, capture_output=True,
            text=True, timeout=90)
        tail = (child.stdout + child.stderr).strip().splitlines()
        out['send_recv'] = 'ok' if child.returncode == 0 else \
            'exit %d: %s' % (child.returncode, (tail or [''])[-1][:160])
    except subprocess.TimeoutExpired:
        out['send_recv'] = 'timed out'
    return out


def mp_probe_sendrecv(index, work):
    """`--ps-worker probesr <i>`: send/recv of a CUDA tensor under gloo,
    unstaged (rank 0 sends ones to rank 1); exits 0 only if it works."""
    import datetime
    import torch
    import torch.distributed as dist
    dist.init_process_group('gloo', init_method='file://' + os.path.join(
        work, 'probe_sr_store'), rank=index, world_size=2,
        timeout=datetime.timedelta(seconds=30))
    t = torch.full((4,), float(index == 0), device='cuda')
    if index == 0:
        dist.send(t, 1)
    else:
        dist.recv(t, 0)
        torch.cuda.synchronize()
        if not bool((t == 1).all()):
            raise AssertionError('send/recv delivered %s' % t.tolist())
    dist.barrier()
    return {'send_recv': 'ok'}


def check_gloo_probes(work_root):
    """MP_PROBES on CUDA tensors under gloo in two processes: the ones
    collectives.GLOO_CUDA_HOST_STAGED names must be refused, every other
    must give the right values (so the fixed table is the truth)."""
    from paddle_tpu_torch.parallel import collectives as C
    work = scratch(tempfile.mkdtemp(dir=work_root))
    res = run_ps_cluster('mp0', work, {}, 'cuda',
                         roles=[('probe', 0), ('probe', 1)])
    staged = {'send_recv'} if {'send', 'recv'} <= C.GLOO_CUDA_HOST_STAGED \
        else set()
    out = {}
    for name in MP_PROBES:
        got = [res['probe%d' % i][name] for i in range(2)]
        refused = any(g != 'ok' for g in got)
        out[name] = 'refused' if refused else 'ok'
        log('gloo probe on CUDA tensors: %s: %s' % (name, ' | '.join(got)))
        if refused != (name in staged):
            raise AssertionError(
                'gloo probe %s: %s, but parallel/collectives.py %s it '
                'through the host' % (name, got, 'stages' if name in staged
                                      else 'does not stage'))
    return out


def _mp_ranks(name, spec, place_name, work):
    world = 1
    for ax in ('pp', 'dp', 'ep', 'sp', 'tp'):
        world *= spec['mesh'].get(ax, 1)
    spec = dict(spec, world=world)
    return run_ps_cluster(name, work, spec, place_name,
                          roles=[('rank', i) for i in range(world)]), world


def _mp_check_steps(name, res, world, ref, work, place_name):
    """The ranks agree, start from the reference's weights, and their
    losses and first-step updates are the one-process run's within
    TRAIN_LOSS_TOL and TRAIN_UPDATE_TOL (updates weighted by the
    gradient, _first_order_diffs)."""
    import torch
    r0 = res['rank0']
    for i in range(1, world):
        if res['rank%d' % i]['losses'] != r0['losses']:
            raise AssertionError('%s: rank %d fetched losses %s, rank 0 %s'
                                 % (name, i, res['rank%d' % i]['losses'],
                                    r0['losses']))
    start = {n: float(t.double().sum()) for n, t in ref['start'].items()}
    if any(abs(start[n] - r0['start'][n]) > 1e-6 * max(1.0, abs(start[n]))
           for n in start):
        raise AssertionError('%s: the ranks did not start from the '
                             'reference\'s weights: %s vs %s'
                             % (name, r0['start'], start))
    loss_diff = max(abs(a - b) for a, b in zip(r0['losses'], ref['losses']))
    first = torch.load(os.path.join(work, 'first.pt'))
    params = [n for n in ref['start']]
    grads = {n: ref['first'][n + '_velocity_0'] for n in params}
    upd_ring = {n: first[n] - ref['start'][n] for n in params}
    upd_ref = {n: ref['first'][n] - ref['start'][n] for n in params}
    upd = _first_order_diffs(upd_ring, upd_ref, grads, params)
    log('%s: losses %s vs the one-process run %s (max |diff| %.3e, tol '
        '%g); first-step updates vs it, gradient-weighted: %s (tol %g)'
        % (name, ' '.join('%.6f' % x for x in r0['losses']),
           ' '.join('%.6f' % x for x in ref['losses']), loss_diff,
           TRAIN_LOSS_TOL, ', '.join('%s %.3e' % kv for kv in upd.items()),
           TRAIN_UPDATE_TOL))
    if not (all(np.isfinite(r0['losses'])) and loss_diff <= TRAIN_LOSS_TOL
            and max(upd.values()) <= TRAIN_UPDATE_TOL):
        raise AssertionError('%s: the mesh step disagrees with the one-'
                             'process step beyond the stated tolerance'
                             % name)
    reserved = sum(res['rank%d' % i]['reserved_gb'] for i in range(world))
    if place_name == 'cuda' and reserved > MP_RESERVED_GB:
        raise AssertionError('%s: the ranks reserved %.2f GB together, over '
                             '%g GB' % (name, reserved, MP_RESERVED_GB))
    return loss_diff, upd, reserved


def _mp_log_ranks(name, res, world):
    for i in range(world):
        r = res['rank%d' % i]
        log('%s rank %d: step ms %s (rotation %.3f s, all collectives %.3f '
            's in the last step), %.1f MB sent in the last step, peak %.2f '
            'GB allocated / %.2f GB reserved, launches %s, blocks %s'
            % (name, i, ' '.join('%.3f' % x for x in r['ms']),
               r['permute_s'], r['coll_s'], r['sent'] / 1e6, r['peak_gb'],
               r['reserved_gb'], json.dumps({k: v for k, v in
                                             r['launches'].items() if v}),
               r['blocks']))
    log('%s: collective_audit of one step (rank 0): %s'
        % (name, json.dumps(res['rank0']['audit'])))


def check_ring_blocks(spec):
    """K1 on a diagonal (causal) and an off-diagonal block, K2 on both,
    and one rank's merged (o, lse) at mp1's block shape, against their
    plain versions on the same inputs on the card (KERNEL_ATOL, O_RTOL,
    G_RTOL: the bf16 training bounds)."""
    import torch
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.parallel import ring_attention as ra
    m = spec['model']
    sp = spec['mesh']['sp']
    BH = spec['batch'] * m['heads']
    Tl, d = m['max_len'] // sp, m['dim'] // m['heads']
    g = torch.Generator(device='cuda').manual_seed(SEED)
    q, k0, k1, v0, v1, do = (torch.randn(BH, Tl, d, device='cuda',
                                         generator=g).to(torch.bfloat16)
                             for _ in range(6))
    scale = d ** -0.5
    out = {}
    for tag, kb, vb, causal in (('diagonal', k1, v1, True),
                                ('off-diagonal', k0, v0, False)):
        o, lse = fa.flash_attention_fwd(q, kb, vb, causal, scale)
        o_ref, lse_ref = fa.flash_attention_reference(q, kb, vb, causal,
                                                      scale)
        o_err, o_rel, lse_err, ok = check_fwd_output(o, lse, o_ref, lse_ref,
                                                     'bfloat16')
        delta = fa.bwd_delta(o_ref, do)
        got = fa.flash_attention_bwd_kvmajor(q, kb, vb, do, lse_ref, delta,
                                             causal, scale)
        want = fa.flash_attention_bwd_reference(q, kb, vb, o_ref, lse_ref,
                                                do, causal, scale)
        g_err, g_rels, g_ok = check_grads(got, want, 'bfloat16')
        out[tag] = dict(k1=[o_err, lse_err], k2=g_err)
        log('mp1 %s block [%d, %d, %d] bf16: K1 o max |err| %.3e (rel %.3e), '
            'lse %.3e; K2 max |err| %.3e (rel %s)'
            % (tag, BH, Tl, d, o_err, o_rel, lse_err, g_err,
               ' '.join('%.2e' % x for x in g_rels)))
        if not (ok and g_ok):
            raise AssertionError('mp1: the %s block disagrees with its '
                                 'plain version' % tag)
    # rank 1's merged partial: its diagonal block and rank 0's block
    o_a, l_a = fa.flash_attention_fwd(q, k1, v1, True, scale)
    o_b, l_b = fa.flash_attention_fwd(q, k0, v0, False, scale)
    o_m, l_m = ra.merge_partials(o_a.float(), l_a, o_b, l_b)
    p_a = fa.flash_attention_reference(q, k1, v1, True, scale)
    p_b = fa.flash_attention_reference(q, k0, v0, False, scale)
    r_m, rl_m = ra.merge_partials(p_a[0].float(), p_a[1], *p_b)
    o_err, o_rel, lse_err, ok = check_fwd_output(
        o_m.to(torch.bfloat16), l_m, r_m.to(torch.bfloat16), rl_m,
        'bfloat16')
    out['merged'] = [o_err, lse_err]
    log('mp1 rank 1 merged (o, lse): o max |err| %.3e (rel %.3e), lse %.3e'
        % (o_err, o_rel, lse_err))
    if not ok:
        raise AssertionError('mp1: the merged partial disagrees with its '
                             'plain version')
    return out


@phase('mp1: ring attention at full width (bench_long_context\'s LM, '
       'sp=4 ranks sharing the card under gloo, K1 and K2 per block)')
def mesh_ring_steps(work_root, spec=None, place_name='cuda'):
    import paddle_tpu_torch as fluid
    t0 = time.perf_counter()
    spec = mp_spec('mp1', spec)
    place = fluid.CUDAPlace(0) if place_name == 'cuda' else fluid.CPUPlace()
    blocks = probes = None
    probe_out = {}
    if place_name == 'cuda':
        # the probes' four processes run beside the checks and the
        # reference step here (they move a few bytes each)
        import threading

        def run_probes():
            try:
                probe_out['ok'] = check_gloo_probes(work_root)
            except Exception as e:      # re-raised below, in the phase
                probe_out['error'] = e
        prober = threading.Thread(target=run_probes)
        prober.start()
        try:
            blocks = check_ring_blocks(spec)
            ref = mp_reference('mp1', spec, place)
        finally:
            prober.join()
        if 'error' in probe_out:
            raise probe_out['error']
        probes = probe_out['ok']
    else:
        ref = mp_reference('mp1', spec, place)
    work = scratch(tempfile.mkdtemp(dir=work_root))
    t_ranks = time.perf_counter()
    res, world = _mp_ranks('mp1', spec, place_name, work)
    ranks_s = time.perf_counter() - t_ranks
    layers = spec['model']['layers']
    launches = {'K1': 0, 'K2': 0}
    for i in range(world):
        r = res['rank%d' % i]
        n = layers * (i + 1) * MP_STEPS
        _check_flash_launches(
            'mp1: rank %d in %d steps' % (i, MP_STEPS),
            dict(r['launches'], plain_cuda_calls=r['plain']),
            {KERNELS['fwd'][0]: n, KERNELS['k2'][0]: n}, place_name)
        if r['blocks'] != [n, n]:
            raise AssertionError('mp1: rank %d computed %s blocks, want %d '
                                 'each way' % (i, r['blocks'], n))
        launches['K1'] += r['launches'][KERNELS['fwd'][0]]
        launches['K2'] += r['launches'][KERNELS['k2'][0]]
    _mp_log_ranks('mp1', res, world)
    loss_diff, upd, reserved = _mp_check_steps('mp1', res, world, ref, work,
                                               place_name)
    wall = time.perf_counter() - t0
    log('mp1: %d ranks, K1 %d and K2 %d launches in %d steps (%d each a '
        'step), the one-process step %s ms; ranks %.1f s, phase %.1f s'
        % (world, launches['K1'], launches['K2'], MP_STEPS,
           launches['K1'] // MP_STEPS, ' '.join('%.3f' % x
                                                for x in ref['ms']),
           ranks_s, wall))
    return dict(launches=launches, seconds=wall, loss_diff=loss_diff,
                upd=upd, reserved=reserved, blocks=blocks, probes=probes,
                ms=[res['rank%d' % i]['ms'] for i in range(world)],
                ref_ms=ref['ms'])


@phase('mp2: tensor, sequence and data parallelism (the flagship LM at '
       'full width cut to 2 layers, dp=2 x tp=2 ranks sharing the card)')
def mesh_tp_steps(work_root, spec=None, place_name='cuda'):
    import paddle_tpu_torch as fluid
    t0 = time.perf_counter()
    spec = mp_spec('mp2', spec)
    place = fluid.CUDAPlace(0) if place_name == 'cuda' else fluid.CPUPlace()
    ref = mp_reference('mp2', spec, place)
    work = scratch(tempfile.mkdtemp(dir=work_root))
    res, world = _mp_ranks('mp2', spec, place_name, work)
    layers = spec['model']['layers']
    _mp_log_ranks('mp2', res, world)
    launches = {'K1': 0, 'K2': 0}
    for i in range(world):
        r = res['rank%d' % i]
        _check_flash_launches(
            'mp2: rank %d in %d steps' % (i, MP_STEPS),
            dict(r['launches'], plain_cuda_calls=r['plain']),
            {KERNELS['fwd'][0]: layers * MP_STEPS,
             KERNELS['k2'][0]: layers * MP_STEPS}, place_name)
        launches['K1'] += r['launches'][KERNELS['fwd'][0]]
        launches['K2'] += r['launches'][KERNELS['k2'][0]]
        # every tp weight is its dim's half, read from the placements
        for pname, sh in r['shards'].items():
            half = list(sh['full'])
            for pl in sh['placements']:
                if pl.startswith('S('):
                    half[int(pl[2:-1])] //= spec['mesh']['tp']
            if sh['local'] != half:
                raise AssertionError('mp2: rank %d holds %s as %s, want %s '
                                     '(placements %s)'
                                     % (i, pname, sh['local'], half,
                                        sh['placements']))
        bad = [g for g in r['param_gathers'] if 'tp' in g[1]]
        if bad:
            raise AssertionError('mp2: rank %d all-gathered a whole tp '
                                 'weight: %s' % (i, bad))
        if 'all-reduce' not in r['audit']:
            raise AssertionError('mp2: no all-reduce in rank %d\'s audit'
                                 % i)
    tp_names = sorted(res['rank0']['shards'])
    if not tp_names:
        raise AssertionError('mp2: no weight is sharded over tp')
    loss_diff, upd, reserved = _mp_check_steps('mp2', res, world, ref, work,
                                               place_name)
    r0 = res['rank0']
    wall = time.perf_counter() - t0
    log('mp2: %d tp-sharded weights held as halves (%s, ...); rank 0 step '
        '%.3f ms, of it %.3f ms in collectives (the rest device work and '
        'the host); the one-process step %s ms; K1 %d, K2 %d launches; '
        'phase %.1f s'
        % (len(tp_names), ', '.join(tp_names[:3]), r0['ms'][-1],
           r0['coll_s'] * 1e3, ' '.join('%.3f' % x for x in ref['ms']),
           launches['K1'], launches['K2'], wall))
    return dict(launches=launches, seconds=wall, loss_diff=loss_diff,
                upd=upd, reserved=reserved, ms=r0['ms'],
                coll_ms=r0['coll_s'] * 1e3, ref_ms=ref['ms'],
                audit=r0['audit'])


@phase('pp1: the pipeline engine (the flagship LM at full width cut to 4 '
       'layers, 2 a stage, pp=2 x dp=2 ranks sharing the card, 4 '
       'microbatches a dp rank)')
def pipeline_steps(work_root, spec=None, place_name='cuda'):
    import paddle_tpu_torch as fluid
    t0 = time.perf_counter()
    spec = mp_spec('pp1', spec)
    place = fluid.CUDAPlace(0) if place_name == 'cuda' else fluid.CPUPlace()
    ref = mp_reference('pp1', spec, place)
    work = scratch(tempfile.mkdtemp(dir=work_root))
    res, world = _mp_ranks('pp1', spec, place_name, work)
    _mp_log_ranks('pp1', res, world)
    m = spec['mesh']
    n_micro = max(m.get('micro_batches', 1), m['pp'])
    per_step = spec['model']['layers'] // spec['model']['pp_stages'] * \
        n_micro
    launches = {'K1': 0, 'K2': 0}
    for i in range(world):
        r = res['rank%d' % i]
        _check_flash_launches(
            'pp1: rank %d in %d steps' % (i, MP_STEPS),
            dict(r['launches'], plain_cuda_calls=r['plain']),
            {KERNELS['fwd'][0]: per_step * MP_STEPS,
             KERNELS['k2'][0]: per_step * MP_STEPS}, place_name)
        launches['K1'] += r['launches'][KERNELS['fwd'][0]]
        launches['K2'] += r['launches'][KERNELS['k2'][0]]
        pp = r['pp']
        log('pp1 rank %d: step ms %s; the last step waited %.3f s in pp '
            'receives (%.1f%% of it), sent %.2f MB of activations and %.2f '
            'MB of cotangents, summed %.2f MB of gradients over pp'
            % (i, ' '.join('%.1f' % x for x in r['ms']), pp['recv_wait_s'],
               100 * pp['recv_wait_s'] * 1e3 / r['ms'][-1],
               pp['act_bytes'] / 1e6, pp['cot_bytes'] / 1e6,
               pp['grad_bytes'] / 1e6))
        if not pp['grad_bytes'] or not (pp['act_bytes'] or pp['cot_bytes']):
            raise AssertionError('pp1: rank %d moved nothing over pp: %s'
                                 % (i, pp))
    loss_diff, upd, reserved = _mp_check_steps('pp1', res, world, ref, work,
                                               place_name)
    wall = time.perf_counter() - t0
    log('pp1: %d ranks, K1 %d and K2 %d launches in %d steps (%d each a '
        'step), the one-process step %s ms; phase %.1f s'
        % (world, launches['K1'], launches['K2'], MP_STEPS,
           launches['K1'] // MP_STEPS,
           ' '.join('%.1f' % x for x in ref['ms']), wall))
    return dict(launches=launches, seconds=wall, loss_diff=loss_diff,
                upd=upd, reserved=reserved, ref_ms=ref['ms'],
                ms=[res['rank%d' % i]['ms'] for i in range(world)],
                pp=[res['rank%d' % i]['pp'] for i in range(world)])


# ck1: mp2's model (the flagship LM at full width cut to 2 layers) on dp=2
# ranks with ZeRO-3 under AMP Adam: a Trainer with sharded checkpoints
# every `interval` steps trains `steps` steps; in the second run rank 1
# exits at its `kill_step`-th step
CK1 = dict(model=dict(MODEL, layers=2, use_tp=True, use_sp=True),
           batch=TRAIN_BATCH, head_chunk=HEAD_CHUNK, dp=2, steps=6,
           interval=2, kill_step=5)
CK_DIST_TIMEOUT = 300     # seconds a rank's collective may wait
CK_TIMEOUT = 900          # seconds one run of ck1's job may take


def ck_train_func(cfg, head_chunk):
    """mp_program's LM (trunk, fused head, mean) as a Trainer's
    train_func, seeded as every LM phase is."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import transformer as tfm

    def train_func():
        fluid.default_main_program().random_seed = SEED
        fluid.default_startup_program().random_seed = SEED
        tokens = fluid.layers.data(name='tokens', shape=[cfg.max_len, 1],
                                   dtype='int64')
        labels = fluid.layers.data(name='labels', shape=[cfg.max_len, 1],
                                   dtype='int64')
        trunk = tfm.language_model_trunk(tokens, cfg)
        return fluid.layers.mean(fluid.layers.fused_softmax_cross_entropy(
            trunk, labels, cfg.vocab, chunk=head_chunk, name='lm_head'))
    return train_func


def var_digest(t):
    """sha1 of a tensor's raw bytes (bf16 as its 16-bit words)."""
    import hashlib
    import torch
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return hashlib.sha1(t.numpy().tobytes()).hexdigest()


def ck_rank(index, spec, place, work):
    """One rank of ck1's job (`--ps-worker ckrank <r>`): the Trainer's
    epoch of spec['steps'] steps on the rendezvous of its incarnation
    (a save every spec['interval'] steps, none at the epoch's end: it
    would repeat the last); returns its step ms, the last save's stats,
    its largest local shard, its launches, whether it resumed, and the
    digest and storage spec of every checkpointed var's final local
    part on this rank."""
    import torch
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.models.transformer import TransformerConfig
    from paddle_tpu_torch.parallel import DistributedStrategy
    inc = int(os.environ.get('FLAGS_trainer_incarnation', 0))
    os.environ.update(
        PADDLE_TRAINER_ID=str(index), PADDLE_TRAINERS_NUM=str(spec['dp']),
        PADDLE_DIST_INIT_METHOD='file://' + os.path.join(
            work, 'store.%d' % inc),
        PADDLE_DIST_TIMEOUT=str(CK_DIST_TIMEOUT))
    cfg = TransformerConfig(**spec['model'])
    names = [KERNELS[k][0] for k in KERNELS]
    for n in names:
        getattr(fa, n).launches = 0
    fa.FlashAttention.plain_cuda_calls = 0
    trainer = fluid.Trainer(
        ck_train_func(cfg, spec['head_chunk']),
        lambda: fluid.contrib.mixed_precision.decorate(
            fluid.optimizer.Adam(learning_rate=1e-4)),
        place=place, checkpoint_config=fluid.CheckpointConfig(
            checkpoint_dir=spec['root'], step_interval=spec['interval'],
            epoch_interval=2, sharded=True),
        strategy=DistributedStrategy(dp=spec['dp'], sharded_params=True))
    sync = torch_sync(place)
    batches = mp_batches(cfg, spec['batch'], spec['steps'])
    marks = []

    def handler(event):
        if isinstance(event, (fluid.BeginStepEvent, fluid.EndEpochEvent)):
            sync()
            marks.append(time.perf_counter())

    def reader():
        for b in batches:
            yield [b['tokens'], b['labels']]
    trainer.train(num_epochs=1, event_handler=handler, reader=reader,
                  feed_order=['tokens', 'labels'])
    mc = trainer._mesh_checkpointer
    mc.wait()
    stats = dict(mc.last_stats)
    mc.close()
    pe = trainer._pe
    local = mc.checkpoint_vars(trainer.scope, trainer.train_program)
    local_max = max(t.numel() * t.element_size() for t in local.values())
    # each var's local part and its spec: the same layout in every run
    digests = {n: [var_digest(t), pe.storage_spec(n)]
               for n, t in sorted(local.items())}
    return dict(
        resumed=bool(trainer._resumed), incarnation=inc,
        ms=[(b - a) * 1e3 for a, b in zip(marks, marks[1:])],
        stats=stats, local_max=int(local_max), digests=digests,
        launches={n: getattr(fa, n).launches for n in names},
        plain=fa.FlashAttention.plain_cuda_calls)


def _ck_job(spec, place_name, work, kill):
    """One run of ck1's job: spec['dp'] `--ps-worker ckrank` processes
    under a Supervisor (rank 1 with a fault plan that exits at its
    spec['kill_step']-th step when `kill`); every process is gone when
    it returns. Returns (states, restarts, {rank: result}, seconds)."""
    from paddle_tpu_torch.distributed.supervisor import Supervisor
    # the split backward (K3a + K3b) is the deterministic arm: K2's dq
    # sums by atomics, so two runs of it differ in the last bits
    env = dict(os.environ, PSW_PHASE='ck1', PSW_ENDPOINTS='', PSW_OUT=work,
               PSW_SPEC=json.dumps(spec), PSW_PLACE=place_name,
               PADDLE_FLASH_FWD='', PADDLE_FLASH_BWD='split')
    if place_name == 'cpu':
        env.setdefault('OMP_NUM_THREADS', '1')
    sup = Supervisor(max_restarts=2, backoff=0.5, log_dir=work)
    for i in range(spec['dp']):
        e = dict(env)
        if kill and i == 1:
            e['FLAGS_fault_plan'] = json.dumps({'rules': [
                {'when': 'step', 'type': '*', 'nth': spec['kill_step'],
                 'action': 'exit'}]})
        sup.add_role('ckrank%d' % i, [sys.executable,
                                      os.path.abspath(__file__),
                                      '--ps-worker', 'ckrank', str(i)],
                     env=e)
    t0 = time.perf_counter()
    sup.start()
    try:
        states = sup.wait(timeout=CK_TIMEOUT)
    finally:
        sup.stop()
    wall = time.perf_counter() - t0
    restarts = sup.restarts
    if any(v != 'done' for v in states.values()):
        raise AssertionError('ck1: the job ended %s after %.1f s (restarts '
                             '%s)\n%s' % (states, wall, restarts, '\n'.join(
                                 '--- %s:\n%s' % (n, sup.output(n)[-3000:])
                                 for n in sorted(states))))
    out = {}
    for i in range(spec['dp']):
        with open(os.path.join(work, 'ckrank%d.json' % i)) as f:
            out[i] = json.load(f)
    return states, restarts, out, wall


@phase('ck1: sharded checkpoints and the kill (mp2\'s model on dp=2 ranks '
       'with ZeRO-3 under AMP Adam, a fluid.Trainer(strategy=) under a '
       'Supervisor)')
def checkpoint_kill_steps(work_root, spec=None, place_name='cuda'):
    import torch
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import checkpoint
    t0 = time.perf_counter()
    spec = dict(CK1, **(spec or {}))
    spec['model'] = dict(CK1['model'], **spec['model'])
    place = fluid.CUDAPlace(0) if place_name == 'cuda' else fluid.CPUPlace()
    runs = {}
    for tag in ('base', 'kill'):
        work = scratch(tempfile.mkdtemp(dir=work_root))
        root = os.path.join(work, 'ckpt')
        states, restarts, res, wall = _ck_job(dict(spec, root=root),
                                              place_name, work,
                                              tag == 'kill')
        want = {'ckrank%d' % i: int(tag == 'kill')
                for i in range(spec['dp'])}
        if restarts != want:
            raise AssertionError('ck1 %s: restarts %s, want %s'
                                 % (tag, restarts, want))
        runs[tag] = dict(res=res, wall=wall, root=root)
        log('ck1 %s run: %.1f s, restarts %s, step ms by rank %s, the last '
            'save: %s'
            % (tag, wall, restarts, ' | '.join(
                ' '.join('%.1f' % x for x in r['ms'])
                for r in res.values()), ' | '.join(json.dumps(
                    {k: r['stats'][k] for k in ('generation', 'bytes',
                                                'files', 'max_host_bytes',
                                                'snapshot_ms', 'latency')})
                    for r in res.values())))
        if tag == 'base':
            # only its digests are kept: the disk holds one root at a time
            shutil.rmtree(root, ignore_errors=True)
    base, kill = runs['base']['res'], runs['kill']['res']
    if not all(r['resumed'] and r['incarnation'] == 1
               for r in kill.values()):
        raise AssertionError('ck1: the killed job did not resume at '
                             'incarnation 1: %s' % {
                                 i: (r['resumed'], r['incarnation'])
                                 for i, r in kill.items()})
    for i in base:
        d_base, d_kill = base[i]['digests'], kill[i]['digests']
        if not d_base or d_base != d_kill:
            raise AssertionError(
                'ck1: rank %s of the resumed job ends on other bits than the '
                'fault-free one in %s' % (i, sorted(
                    n for n in set(d_base) | set(d_kill)
                    if d_base.get(n) != d_kill.get(n))[:8]))
    d_kill = kill[0]['digests']
    if not any('moment' in n for n in d_kill):
        raise AssertionError('ck1: no Adam moment among %s' % sorted(d_kill))
    with open(os.path.join(runs['kill']['root'], 'OWNER')) as f:
        owner = json.load(f)['incarnation']
    if owner != 1:
        raise AssertionError('ck1: the root\'s OWNER is incarnation %s'
                             % owner)
    for i, r in list(base.items()) + list(kill.items()):
        if r['stats']['max_host_bytes'] > r['local_max']:
            raise AssertionError(
                'ck1: rank %s\'s save held a %d-byte host buffer, over its '
                'largest shard (%d bytes)' % (i, r['stats']['max_host_bytes'],
                                              r['local_max']))
    layers = spec['model']['layers']
    launches = {'K1': 0, 'K3a': 0, 'K3b': 0}
    for i, r in base.items():
        _check_flash_launches(
            'ck1: rank %s in %d steps' % (i, spec['steps']),
            dict(r['launches'], plain_cuda_calls=r['plain']),
            {KERNELS[k][0]: layers * spec['steps']
             for k in ('fwd', 'k3a', 'k3b')}, place_name)
        for kind, k in (('K1', 'fwd'), ('K3a', 'k3a'), ('K3b', 'k3b')):
            launches[kind] += r['launches'][KERNELS[k][0]]
    sync = torch_sync(place)
    sync()
    t_r = time.perf_counter()
    vals, extras, gen = checkpoint.restore_sharded(runs['kill']['root'],
                                                   device=place.device)
    sync()
    restore_ms = (time.perf_counter() - t_r) * 1e3
    restored_bytes = sum(v.numel() * v.element_size() for v in vals.values())
    # each restored whole value, cut by each rank's layout, is that rank's
    # final part, bit for bit
    from paddle_tpu_torch.parallel.layout import local_part, normalize
    from paddle_tpu_torch.parallel.mesh import MeshConfig
    mesh = MeshConfig(dp=spec['dp']).build()
    bad = set(vals) ^ set(d_kill)
    for i, r in kill.items():
        for n, (digest, sp) in r['digests'].items():
            v = vals.get(n)
            if v is None or var_digest(local_part(
                    v, normalize(sp, v.ndim, mesh), mesh, int(i))) != digest:
                bad.add(n)
    del vals
    if bad:
        raise AssertionError('ck1: the one-process restore of generation %d '
                             'differs from the mesh\'s final values in %s'
                             % (gen, sorted(bad)[:8]))
    wall = time.perf_counter() - t0
    log('ck1: the killed job (rank 1 at its step %d) resumed from the last '
        'committed generation and ends on the fault-free bits in all %d '
        'vars; OWNER incarnation %d; generation %d (step %s) restored in '
        'one process on %s in %.1f ms (%.1f MB), the same bits; K1 %d, K3a '
        '%d and K3b %d launches in the fault-free run; phase %.1f s'
        % (spec['kill_step'], len(d_kill), owner, gen, extras.get('step_id'),
           place.device, restore_ms, restored_bytes / 1e6, launches['K1'],
           launches['K3a'], launches['K3b'], wall))
    return dict(seconds=wall, launches=launches, restore_ms=restore_ms,
                restored_mb=restored_bytes / 1e6, n_vars=len(d_kill),
                walls={k: v['wall'] for k, v in runs.items()},
                stats={k: {i: r['stats'] for i, r in v['res'].items()}
                       for k, v in runs.items()},
                ms={i: r['ms'] for i, r in base.items()})


def run_beside(out, fn, *args):
    """Run the phase fn(*args) in this thread, for a caller that runs it
    beside its own work: out['result'] holds what it returns, or
    out['error'] the PhaseError it raised, for the caller to raise."""
    try:
        out['result'] = fn(*args)
    except PhaseError as e:
        out['error'] = e


def scratch(path):
    """Register a temporary directory (the saved serving model, the
    checkpoints, the obs logs) for remove_scratch()."""
    _SCRATCH_DIRS.append(path)
    return path


def remove_scratch():
    """Remove every directory scratch() registered (main() does, however
    it ends)."""
    import shutil
    while _SCRATCH_DIRS:
        shutil.rmtree(_SCRATCH_DIRS.pop(), ignore_errors=True)


def drop_checkpoints(ckpt_root, name):
    """Remove the checkpoint directory of Trainer phase `name`."""
    import shutil
    shutil.rmtree(os.path.join(ckpt_root, name), ignore_errors=True)


def peak_memory_gb():
    """Peak allocated device memory since the last reset, in GB (a
    captured graph's pool counts while its tensors are alive in the
    capture; torch.cuda.max_memory_reserved() is logged beside it)."""
    import torch
    log('peak device memory allocated %.2f GB, reserved %.2f GB'
        % (torch.cuda.max_memory_allocated() / 1e9,
           torch.cuda.max_memory_reserved() / 1e9))
    return torch.cuda.max_memory_allocated() / 1e9


def torch_sync(place):
    """torch.cuda.synchronize on a card's place, a no-op on the CPU."""
    import torch
    return torch.cuda.synchronize if place.device.type == 'cuda' else \
        (lambda: None)


def free_device_memory():
    """Collect what the freed trainers left (their executors' captured
    graphs and pools) and return the cached blocks to the card."""
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def main():
    t_start = time.perf_counter()
    try:
        import torch
    except ImportError:
        print('chip_smoke: torch is not installed', file=sys.stderr)
        return 2
    if len(sys.argv) == 4 and sys.argv[1] == '--ps-worker' and \
            os.path.isdir(os.path.join(HERE, 'paddle_tpu_torch')):
        # one role of ps1's, ps2's or on1's cluster, started by
        # run_ps_cluster
        sys.path.insert(0, HERE)
        return ps_worker_main(sys.argv[2], int(sys.argv[3]))
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device (torch.cuda.is_available() is '
              'false); nothing run', file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, 'paddle_tpu_torch')):
        print('chip_smoke: paddle_tpu_torch/ is not beside this script; run '
              'it from a checkout of the repository', file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.models.transformer import TransformerConfig
    counters = {KERNELS[kind][0]: getattr(fa, KERNELS[kind][0])
                for kind in KERNELS}

    card = gpu_name_and_power_limit()
    log('card: %s' % card)
    log('python %s, torch %s, cuda %s' % (sys.version.split()[0],
                                        torch.__version__, torch.version.cuda))
    cfg = TransformerConfig(**MODEL)
    adam_cfg = TransformerConfig(**ADAM_MODEL)
    lc_cfg = TransformerConfig(**LC_MODEL)
    place = fluid.CUDAPlace(0)
    sync = torch.cuda.synchronize
    try:
        build_kernels()
        rows = check_kernels(cfg)
        long_rows = check_long_kernels(lc_cfg)
        check_untaken_flash(place, counters)
        prompts = prompts_for(cfg.vocab, cfg.max_len)
        build_root = os.path.join(HERE, 'build')
        os.makedirs(build_root, exist_ok=True)
        # kept for o2's server
        model_dir = scratch(tempfile.mkdtemp(dir=build_root))
        build_and_save(cfg, place, model_dir)
        torch.cuda.empty_cache()
        pred, dec = load_and_prepare(model_dir, place)
        torch.cuda.reset_peak_memory_stats()
        streams, launches, wall, stats = serve(dec, prompts, counters, sync)
        check_recompute(pred, dec, prompts, streams)
        check_solo(dec, prompts, streams)
        prefill_ms, step_ms = time_path(dec, prompts, sync)
        g_device = profile_path(dec, prompts, {'prefill': prefill_ms,
                                               'decode_step': step_ms}, sync)
        serve_peak_gb = torch.cuda.max_memory_allocated() / 1e9
        x2 = check_serving_capture(dec, prompts, streams, sync,
                                   {'prefill': prefill_ms,
                                    'decode_step': step_ms})
        v1 = paged_serving(pred, dec, prompts, streams, counters, sync)
        pdec = v1.pop('dec')
        v2 = prefix_sharing(pdec, sync)
        v3 = preemption(pred, pdec, sync)
        v4 = speculative(pred, prompts, v1['streams'], pdec, sync)
        v5 = weight_swap(pred, pdec, sync)
        v6 = paged_timing(pdec, prompts,
                          {'step_ms': step_ms,
                           'device_ms': g_device.get('decode_step')}, sync)
        del pred, dec, pdec
        free_device_memory()

        tr, losses, train_ms, train_launches, train_peak_gb = train_steps(
            cfg, place, counters, sync)
        saved, batch, kernel_step, plain_diffs = check_plain_step(
            tr, counters)
        split_launches, split_diffs, split_ms, split_device_ms = \
            check_split_step(tr, saved, batch, kernel_step, counters, sync)
        del saved
        tok_s, mfu, device_ms, busy = profile_train(tr, train_ms, sync)
        pf1 = profile_lm_steps(
            tr, train_launches['flash_attention_bwd_kvmajor'] // TIMED_STEPS,
            sync, build_root)
        with flash_arms(None, 'split'):
            x1 = {'Momentum': check_captured_steps(
                tr, 'the Momentum step (split arm)', PARAMS_COMPARED, 'max',
                place, sync)}
        x3 = check_cache_key(tr, counters, place, sync)
        # the LM is freed before the remat LMs, those before the Adam LM,
        # and that one before ResNet
        del tr
        free_device_memory()
        x4 = remat_steps(place, counters, sync)

        # the high-level Trainer and Inferencer, then the observability
        # they and the server report into; checkpoints (~6 GB each) go to
        # a temporary directory, removed with the others at the end
        ckpt_root = scratch(tempfile.mkdtemp())
        obs_dir = scratch(tempfile.mkdtemp(dir=build_root))
        # each phase's checkpoints (~12 GB) are removed once it has
        # checked them, so they do not sit in the host's page cache and
        # temporary space through the later phases
        tr_cfg = TransformerConfig(**TR_MODEL)
        tr1 = trainer_steps(tr_cfg, place, counters, ckpt_root, sync)
        drop_checkpoints(ckpt_root, 'tr1')
        tr2 = trainer_resume(tr_cfg, place, counters, ckpt_root, sync)
        drop_checkpoints(ckpt_root, 'tr2')
        tr3_run, tr3 = trainer_faults(tr_cfg, place, counters, ckpt_root,
                                      obs_dir, tr2['losses'], tr2['ms'], sync)
        drop_checkpoints(ckpt_root, 'tr3')
        tr4 = trainer_test_and_infer(tr_cfg, tr3_run, build_root, sync)
        o1 = trainer_telemetry(tr_cfg, place, counters, obs_dir, tr1['ms'],
                               sync)
        o2 = serving_slo(model_dir, place, prompts, streams, obs_dir, sync)

        adam = adam_steps(adam_cfg, place, counters, sync)
        atr = adam.pop('tr')
        adam_worst, adam_diffs, adam_upd = check_adam_step(
            atr, adam['records'], counters)
        x1['Adam'] = check_captured_steps(
            atr, 'the Adam step', ADAM_PARAMS_COMPARED, 'weighted', place,
            sync)
        del atr
        free_device_memory()
        # ck1's ranks run beside a3 and a4, which check values only (ck1's
        # own readings are taken beside them); its failure fails the run
        ck1_out = {}
        ck1_thread = threading.Thread(target=run_beside, args=(
            ck1_out, checkpoint_kill_steps, build_root))
        ck1_thread.start()
        try:
            opt_worst = check_optimizer_ops(place)
            op_worst = check_training_ops(place)
        finally:
            ck1_thread.join()
        if 'error' in ck1_out:
            raise ck1_out['error']
        ck1 = ck1_out['result']
        free_device_memory()
        t_moe = time.perf_counter()
        moe1 = moe_steps(place, counters, sync)
        free_device_memory()
        moe2 = moe_op_check(place, sync)
        moe_s = time.perf_counter() - t_moe
        free_device_memory()

        fluid.set_flags({'FLAGS_use_pallas_fused_ops': True})
        torch.cuda.reset_peak_memory_stats()
        (rtr, path_shapes, r_losses, r_step_ms, r_launches,
         r_peak_gb) = resnet_steps(place, sync)
        k6_row = check_k6(path_shapes)
        x5 = check_second_shape(rtr, place, sync)
        r_plain_diffs = check_resnet_plain_step(rtr)
        pair_diffs = check_fused_pair(place)
        img_s, r_mfu, r_device_ms, r_busy, r_kinds = profile_resnet(
            rtr, r_step_ms, sync)
        x1['ResNet-50'] = check_captured_steps(
            rtr, 'the ResNet-50 step', RESNET_PARAMS_COMPARED, 'spread',
            place, sync)
        # r1's executor is closed before n1: two batch-256 graph pools do
        # not fit on the card together
        rtr.drop_graphs()
        del rtr
        free_device_memory()
        rf1 = record_file_steps(place, sync, build_root,
                                r_launches // TIMED_STEPS)
        free_device_memory()
        t_ps = time.perf_counter()
        ps1 = ps_lm_steps(build_root)
        ps2 = ps_deepfm_steps(build_root)
        ps_s = time.perf_counter() - t_ps

        with flags_set(N1_FLAGS):
            ntr, n1 = nhwc_steps(place, sync)
            n_img_s, n_mfu, n_device_ms, n_busy, n_kinds = profile_nhwc(
                ntr, n1['step_ms'], sync)
            n2 = check_nhwc_vs_nchw(ntr, place)
            i2 = check_nan_inf_mode(ntr, sync)
        del ntr
        free_device_memory()
        s1 = s2d_steps(place, sync)
        free_device_memory()
        i1 = inference_leg(place, sync)
        free_device_memory()

        bk1 = book_image_steps(place, sync)
        bk2 = book_fused_steps(bk1, place, sync)
        mo1 = memory_modules(bk1, place, sync)
        bk3 = book_chapter_steps(place, sync, scratch(
            tempfile.mkdtemp(dir=build_root)))
        del bk1['run']
        free_device_memory()

        t_sq = time.perf_counter()
        sq1 = stacked_lstm_steps(place, sync)
        free_device_memory()
        sq2 = sentiment_steps(place, sync)
        sq3 = recommender_steps(place, sync)
        sq4 = srl_steps(place, sync)
        sq_s = time.perf_counter() - t_sq
        free_device_memory()

        t_mt = time.perf_counter()
        cf1 = control_flow_steps(place, sync)
        mt1 = mt_steps(place, sync)
        mt2 = mt_decode(mt1, place, sync)
        del mt1['run']
        free_device_memory()
        mt3 = mt_contrib_steps(place, sync)
        mt_s = time.perf_counter() - t_mt
        free_device_memory()

        t_det = time.perf_counter()
        sp1 = sparse_steps(place, sync)
        free_device_memory()
        det1 = ssd_steps(place, sync)
        det2 = ssd_decode(det1, place, sync)
        del det1['run']
        det_s = time.perf_counter() - t_det
        free_device_memory()

        (ltr, l_losses, l_step_ms, l_launches, l_peak_gb,
         l_extra) = lc_steps(lc_cfg, place, counters, sync)
        l_diffs, l_arm_ms, l_arm_launches, l_arm_dev = check_lc_arms(
            ltr, counters, sync)
        l_tok_s, l_mfu, l_mfu_exec, l_device_ms, l_busy = profile_lc(
            ltr, l_step_ms, l_extra, sync)
        with flash_arms(*LC_ARMS):
            x1['long-context'] = check_captured_steps(
                ltr, 'the long-context step (twopass/onepass)',
                LC_PARAMS_COMPARED, 'max', place, sync)
        del ltr
        free_device_memory()

        probe_row, probe_rows, exp_over_exp2 = check_probe()
        # the fleet phases come after v6 and o2, which hold c1's model
        # in this process, and their replica processes need the card's
        # memory that the phases before them free
        free_device_memory()
        on1 = online_refresh(build_root)
        fl1 = fleet_serving(model_dir, build_root)
        free_device_memory()
        fl2 = disagg_serving(model_dir, build_root)
        free_device_memory()
        # the mesh: ranks on the card after every one-process phase
        t_mp = time.perf_counter()
        mp1 = mesh_ring_steps(build_root)
        free_device_memory()
        mp2 = mesh_tp_steps(build_root)
        mp_s = time.perf_counter() - t_mp
        free_device_memory()
        pp1 = pipeline_steps(build_root)
    except PhaseError as e:
        print('chip_smoke: %s' % e, file=sys.stderr)
        import traceback
        traceback.print_exception(e.__cause__, file=sys.stderr)
        return 1
    finally:
        remove_scratch()
    # launches on each kernel's own main path: K1 fp32 in serving, K1
    # bf16 and K2 in the timed training steps, K3a/K3b in the split step,
    # K4a/K4b/K5 in the timed long-context steps, K1 bf16 at T = 8192 in
    # l2's default-arm step
    # (and pf1's profiled runs of the same step)
    # (ps1's fp32 K1 and K2 on its two trainers too, on1's in its trainer
    # and serving process, and fl1's fp32 K1 in its replica processes
    # that exited cleanly)
    path_launches = {'flash_attention_fwd': launches['flash_attention_fwd']
                     + ps1['launches']['K1'] + on1['launches']['K1']
                     + sum(fl1['launches'].values()),
                     'flash_attention_fwd_bf16':
                         train_launches['flash_attention_fwd'] +
                         pf1['launches']['K1'] + mp1['launches']['K1'] +
                         mp2['launches']['K1'] + pp1['launches']['K1'] +
                         ck1['launches']['K1'],
                     'flash_attention_bwd_kvmajor':
                         train_launches['flash_attention_bwd_kvmajor'] +
                         pf1['launches']['K2/K5'] + ps1['launches']['K2']
                         + on1['launches']['K2'] + mp1['launches']['K2']
                         + mp2['launches']['K2'] + pp1['launches']['K2'],
                     'flash_attention_bwd_dq':
                         split_launches['flash_attention_bwd_dq'] +
                         ck1['launches']['K3a'],
                     'flash_attention_bwd_dkv':
                         split_launches['flash_attention_bwd_dkv'] +
                         ck1['launches']['K3b']}
    long_launches = {'flash_attention_fwd_bf16':
                     l_arm_launches['online/kvmajor']['flash_attention_fwd']}
    for kind in ('k4a', 'k4b', 'k5'):
        long_launches[KERNELS[kind][0]] = l_launches[KERNELS[kind][0]]
    for r in rows:
        r['launches'] = path_launches[r['name']]
    for r in long_rows:
        r['launches'] = long_launches[r['name']]
    rows += long_rows
    # r1's timed ResNet-50 steps, rf1's shard-fed steps and bk2's fused
    # cifar steps
    k6_row['launches'] = r_launches + rf1['launches'] + bk2['launches']
    rows += [k6_row, probe_row]
    log('serving: %.3f s for %d requests x %d tokens, prefill %.3f ms, '
        'decode step %.3f ms, peak device memory %.2f GB'
        % (wall, N_REQUESTS, NEW_TOKENS, prefill_ms, step_ms, serve_peak_gb))
    log('training: step %.3f ms, %.1f tokens/s, MFU %.4f, device busy %s, '
        'peak device memory %.2f GB, loss after %d steps %.6f; kernel vs '
        'plain step loss |diff| %.3e, split vs kvmajor %.3e; split-arm step '
        '%.3f ms, device %s ms (kvmajor %s ms)'
        % (train_ms, tok_s, mfu,
           'not measured' if busy is None else '%.1f%%' % (100 * busy),
           train_peak_gb, len(losses), losses[-1], plain_diffs[0],
           split_diffs[0], split_ms, _fmt_ms(split_device_ms or None),
           _fmt_ms(device_ms or None)))
    log('Adam training (the flagship LM, batch %d, AMP Adam + noam_decay + '
        'global-norm clip, use_tp/use_sp on): step %.3f ms, %.1f tokens/s, '
        'MFU %.4f, device busy %s, peak device memory %.2f GB, %d ops, loss '
        'after %d steps %.6f; K1 %d and K2 %d launches in %d steps; kernel '
        'vs plain step loss |diff| %.3e, updates within %.3e (gradient-'
        'weighted); rate within %.2e of noam_decay, '
        'beta powers within %.2e; optimizer updates on the card within '
        '%.2e of the CPU\'s; training-core ops within %.3f of their '
        'tolerance'
        % (TRAIN_BATCH, adam['step_ms'], adam['tok_s'], adam['mfu'],
           'not measured' if adam['busy'] is None
           else '%.1f%%' % (100 * adam['busy']),
           adam['peak_gb'], adam['n_ops'], len(adam['losses']),
           adam['losses'][-1], adam['launches']['flash_attention_fwd'],
           adam['launches']['flash_attention_bwd_kvmajor'], TIMED_STEPS,
           adam_diffs[0], max(adam_upd.values()), adam_worst['lr'],
           adam_worst['beta'],
           max(opt_worst.values()), op_worst))
    log('ResNet-50 training (batch %d, 224 px, AMP Momentum): step %.3f ms, '
        '%.1f images/s, MFU %.4f, device busy %s, peak device memory %.2f '
        'GB, loss after %d steps %.6f, K6 launches %d; K6 vs plain step loss '
        '|diff| %.3e; fused vs unfused Y %s'
        % (RESNET_BATCH, r_step_ms, img_s, r_mfu,
           'not measured' if r_busy is None else '%.1f%%' % (100 * r_busy),
           r_peak_gb, len(r_losses), r_losses[-1], r_launches,
           r_plain_diffs[0],
           ', '.join('%s %.3e' % (k, v[0]) for k, v in pair_diffs.items())))
    log('ResNet-50 as bench.py builds it for an accelerator (NHWC, conv2d '
        '+ batch_norm, bf16 parameter grads, batch %d): step %.3f ms, %.1f '
        'images/s, MFU %.4f, device %s ms, busy %s, copies %.3f ms and '
        'elementwise %.3f ms a step (NCHW r4: %.3f ms, %.1f images/s, device '
        '%s ms, busy %s, copies %.3f ms, elementwise %.3f ms), peak %.2f GB '
        'allocated / %.2f GB reserved, %d ops; NHWC vs NCHW step loss |diff| '
        '%.3e; check_nan_inf step %.1f ms, loss |diff| %.3e; s2d stem max '
        '|diff| %.3e, s2d step %.3f ms; inference batch %d p50 %.3f ms, p99 '
        '%.3f ms, device %.1f images/s, folded vs unfolded %.3e'
        % (RESNET_BATCH, n1['step_ms'], n_img_s, n_mfu,
           _fmt_ms(n_device_ms or None), _fmt_busy(n_busy),
           n_kinds.get('copies', 0.0), n_kinds.get('elementwise', 0.0),
           r_step_ms, img_s, _fmt_ms(r_device_ms or None), _fmt_busy(r_busy),
           r_kinds.get('copies', 0.0), r_kinds.get('elementwise', 0.0),
           n1['peak_gb'], n1['reserved_gb'], n1['n_ops'], n2['loss_diff'],
           i2['checked_ms'], i2['loss_diff'], s1['stem_err'], s1['step_ms'],
           INFER_BATCH, i1['p50'], i1['p99'], i1['images_s'], i1['err']))
    log('long-context training (T %d, batch %d, twopass/onepass): step %.3f '
        'ms, %.1f tokens/s, MFU %.4f (causal count), %.4f (executed), '
        'device busy %s, peak device memory %.2f GB, loss after %d steps '
        '%.6f; loss |diff| vs plain %.3e, vs online/kvmajor %.3e; one step '
        'twopass/onepass %.3f ms, online/kvmajor %.3f ms; device ms per '
        'step twopass/onepass %.3f, online/kvmajor %.3f'
        % (lc_cfg.max_len, LC_BATCH, l_step_ms, l_tok_s, l_mfu, l_mfu_exec,
           'not measured' if l_busy is None else '%.1f%%' % (100 * l_busy),
           l_peak_gb, len(l_losses), l_losses[-1], l_diffs['plain'][0],
           l_diffs['default'][0], l_arm_ms['twopass/onepass'],
           l_arm_ms['online/kvmajor'], l_arm_dev['twopass/onepass'],
           l_arm_dev['online/kvmajor']))
    log('probe: one exp step costs %.3f x one exp2 step' % exp_over_exp2)
    log('paged serving (8 slots, %d-token pages, %d-token chunks): v1 %.1f '
        'tokens/s, %d of %d streams equal to dense, prefill logits within '
        '%.3e; v2 %d prefix hits reusing %d tokens (%d chunks cold, %d for '
        'the hits); v3 swap %d preemptions, %d swap bytes, resume p50 %s '
        'ms, reprefill %d preemptions, %d of %d streams equal; v4 accept '
        'rate %s, tokens a verify iteration %s, tokens/s %s; v5 swap_wait '
        '%.3f ms; v6 paged step %.3f ms wall, device %s ms, busy %s, '
        '%.3f ms a prefill chunk'
        % (PAGE_TOKENS, PREFILL_CHUNK, v1['tok_s'], v1['agree']['equal'],
           N_REQUESTS, v1['prefill_err'], v2['hits'], v2['reused'],
           v2['cold_chunks'], v2['warm_chunks'], v3['swap']['preemptions'],
           v3['swap']['swap_bytes'], _fmt_ms(v3['swap']['resume_p50_ms']),
           v3['reprefill']['preemptions'], v3['reprefill']['equal'],
           V3_STREAMS,
           ' / '.join('%.4f' % r['accept_rate'] for r in v4.values()),
           ' / '.join('%.3f' % r['tokens_per_step'] for r in v4.values()),
           ' / '.join('%.1f' % r['tok_s'] for r in v4.values()),
           v5['swap_wait_ms'], v6['step_ms'], _fmt_ms(v6['device_ms']),
           _fmt_busy(v6['busy']), v6['chunk_ms']))
    log('captured path: %s; decode predictor stats %s, eager prefill %.3f '
        'ms and decode step %.3f ms; remat peak GB / step ms / K1 per step: '
        '%s; arms %s; ResNet-50 at batch %d then %d on one executor: %s'
        % ('; '.join('%s %.3f ms captured vs %.3f ms op by op, loss |diff| '
                     '%.3e, same bits %s' % (k, v['captured_ms'],
                                             v['eager_ms'], v['loss_diff'],
                                             v['bits'])
                     for k, v in x1.items()),
           json.dumps(x2['stats']), x2['eager_prefill_ms'],
           x2['eager_step_ms'],
           ', '.join('%s %.2f / %.3f / %g' % (p, r['peak_gb'], r['ms'],
                                               r['per_step'][
                                                   KERNELS['fwd'][0]])
                     for p, r in x4.items()),
           json.dumps(x3), RESNET_BATCH, RESNET_SECOND_BATCH,
           '; '.join('%s same bits %s' % (k, v[2]) for k, v in x5.items())))
    log('Trainer (the flagship LM, batch %d, AMP Momentum, %d steps): tr1 '
        'step %.3f ms vs a bare Executor loop %.3f ms, losses within %.3e, '
        'saves %s (after step, ms, bytes), peak %.2f GB; tr2 split-arm '
        'resume the same bits, a flipped byte quarantined, saves %s; tr3 '
        'faults %s, the same bits, guard %.3f ms a step (%+.3f ms); tr4 '
        'test() %.6f, Inferencer within %.3e of the fp32 test program, '
        '%.3e of the AMP one'
        % (TRAIN_BATCH, TR_STEPS, tr1['ms'], tr1['loop_ms'],
           tr1['loss_diff'], tr1['saves'], tr1['peak_gb'], tr2['saves'],
           tr3['faults'], tr3['ms'], tr3['cost_ms'], tr4['mean'],
           tr4['rel'], tr4['amp_diff']))
    log('obs: o1 telemetry on %.3f ms a step vs off %.3f (%+.3f ms), MFU '
        '%.4f, %.2f TFLOP/s, cost_flops %+.2f%% of bench.py\'s count; o2 %d '
        'slo.breach events (only %s), timeline %d events, rollup series %s'
        % (o1['on_ms'], tr1['ms'], o1['on_ms'] - tr1['ms'], o1['mfu'],
           o1['tflops'], 100 * o1['cost_rel'], o2['breaches'],
           sorted(O2_BREACHING), o2['events'], o2['series']))
    log('book chapters (fed by fluid.batch + DataFeeder): bk1 '
        'image_classification resnet_cifar10 depth %d, batch %d, fp32 Adam: '
        'step %.3f ms captured (%.1f images/s), %.3f ms op by op, device %s '
        'ms, busy %s, reader + DataFeeder %.3f ms a batch, captured vs '
        'eager loss |diff| %.3e, the same bits %s; bk2 fused: step %.3f ms, '
        'device %s '
        'ms, K6 %d launches, K6 ms at %s, fused vs unfused loss |diff| '
        '%.3e; bk3 losses %s; mo1 peak requested %.6f GB with '
        'memory_optimize vs %.6f without, release_memory %d segments '
        '(plain %d), Print %d segments'
        % (BOOK['depth'], BOOK['batch'], bk1['ms'], bk1['img_s'],
           bk1['eager_ms'], _fmt_ms(bk1['device_ms'] or None),
           _fmt_busy(bk1['busy']), bk1['feed_ms'], bk1['loss_diff'],
           bk1['bits'], bk2['ms'], _fmt_ms(bk2['device_ms'] or None),
           bk2['launches'],
           ', '.join('[%d, %d, %d] %.4f (plain %.4f)' % (s + v[1:])
                     for s, v in sorted(bk2['k6_ms'].items())),
           bk2['r2']['loss_diff'],
           '; '.join('%s %s' % (k, ' '.join('%.4f' % x for x in v['losses']))
                     for k, v in bk3.items()),
           mo1['memory_optimize'][1], mo1['memory_optimize'][0],
           mo1['release_memory']['segments'],
           mo1['release_memory']['plain_segments'], mo1['print']['segments']))
    log('sequences (%.1f s for sq1-sq4): sq1 stacked LSTM (vocab %d, hid %d, '
        'T %d, batch %d, Adam): step %.3f ms captured (%.1f samples/s, %.1f '
        'tokens/s), %.3f ms op by op, device %s ms, busy %s, peak %.4f GB, '
        '%d ops, %d segments, captured vs eager loss |diff| %.3e, card vs '
        'CPU %.3e; sq2 sentiment conv %.3f ms (%.1f samples/s), stacked '
        'LSTM %.3f ms (%.1f samples/s), DataFeeder %.3f / %.3f ms a batch; '
        'sq3 recommender %.3f ms (%.1f samples/s); sq4 label_semantic_roles '
        '%.3f ms, card vs CPU %.3e, Viterbi %d of %d equal'
        % (sq_s, SQ1['vocab'], SQ1['hid'], SQ1['T'], SQ1['batch'], sq1['ms'],
           sq1['samples_s'], sq1['tokens_s'], sq1['eager_ms'],
           _fmt_ms(sq1['device_ms'] or None), _fmt_busy(sq1['busy']),
           sq1['peak_gb'], sq1['n_ops'], sq1['segments'], sq1['loss_diff'],
           sq1['cpu'][0], sq2['conv']['ms'], sq2['conv']['samples_s'],
           sq2['stacked_lstm']['ms'], sq2['stacked_lstm']['samples_s'],
           sq2['conv']['feed_ms'], sq2['stacked_lstm']['feed_ms'], sq3['ms'],
           sq3['samples_s'], sq4['ms'], sq4['cpu'][0], sq4['viterbi'][0],
           SRL['batch']))
    log('control flow and machine_translation (%.1f s for cf1 and mt1-mt3): '
        'cf1 While %s trips %s host reads, %.4f ms a replayed trip (%.4f op '
        'by op), %d segments + 1 body captured, card vs CPU %.3e; '
        'Switch/IfElse/arrays '
        'card vs CPU %.3e; mt1 (dict %d, word %d, hidden %d, batch %d, Adam) '
        'step %.3f ms captured (%.1f samples/s), %.3f ms op by op, device %s '
        'ms, busy %s, peak %.4f GB, DataFeeder %.3f ms a batch, captured vs '
        'eager the same bits %s, card vs CPU loss %.3e, log-probabilities '
        '%.3e; mt2 beam 1 %.3f ms, beam %d %.3f ms a decoded batch (%d '
        'steps), rows equal to the CPU %d / %d (near ties %d / %d); mt3 '
        'TrainingDecoder step %.3f ms captured, %.3f ms op by op, the same '
        'bits %s, card vs CPU loss %.3e, log-probabilities %.3e, '
        'BeamSearchDecoder %.3f ms a decoded batch, rows equal %d (near ties '
        '%d)'
        % (mt_s, '/'.join(str(r['trips']) for r in cf1['loop']['runs'][:3]),
           '/'.join(str(r['reads']) for r in cf1['loop']['runs'][:3]),
           cf1['loop']['trip_ms'], cf1['loop']['eager_trip_ms'],
           cf1['loop']['segments'], cf1['loop']['err'],
           cf1['select']['err'], MT['dict_size'], MT['word'], MT['hidden'],
           MT['batch'], mt1['ms'], mt1['samples_s'], mt1['eager_ms'],
           _fmt_ms(mt1['device_ms'] or None), _fmt_busy(mt1['busy']),
           mt1['peak_gb'], mt1['feed_ms'], mt1['bits'], mt1['cpu'][0],
           mt1['logp'][0], mt2[1]['ms'], MT['beam'], mt2[MT['beam']]['ms'],
           MT['max_len'], mt2[1]['equal'], mt2[MT['beam']]['equal'],
           mt2[1]['ties'], mt2[MT['beam']]['ties'], mt3['ms'],
           mt3['eager_ms'], mt3['bits'], mt3['cpu'][0], mt3['logp'][0],
           mt3['dec_ms'], mt3['beams'][0], mt3['beams'][1]))
    log('sparse gradients and detection (%.1f s for sp1, det1 and det2): '
        'sp1 lazy Adam (mt1\'s program, both tables sparse) step %.3f ms '
        'captured, %.3f ms op by op, the same bits %s, %d steps each holding '
        '%.1f untouched rows a table to the bit, card vs CPU loss %.3e; '
        'sparse vs dense ms (and update difference): Adam %.3f vs %.3f '
        '(%.3e), SGD %.3f vs %.3f (%.3e), word2vec SGD %.3f vs %.3f (%.3e); '
        'det1 SSD (%d px, batch %d, maps %s, %d priors) step %.3f ms '
        'captured (%.1f images/s), %.3f ms op by op, device %s ms, busy %s, '
        'peak %.4f GB, %d graphs, the same bits %s, card vs CPU loss %.3e; '
        'det2 decode batch %d %.3f ms, %d of %d images equal (%d near ties), '
        'mAP %.6f (card vs CPU %.3e), with the ground truths mixed in %.6f '
        '(%.3e)'
        % (det_s, sp1['ms'], sp1['eager_ms'], sp1['bits'], sp1['lazy'][0],
           sp1['lazy'][1], sp1['cpu'][0], sp1['adam'][2], sp1['adam'][1],
           max(sp1['adam'][0].values()), sp1['sgd'][2], sp1['sgd'][1],
           max(sp1['sgd'][0].values()), sp1['word2vec'][2],
           sp1['word2vec'][1], max(sp1['word2vec'][0].values()),
           SSD['hw'], SSD['batch'], det1['sizes'], det1['priors'],
           det1['ms'], det1['img_s'], det1['eager_ms'],
           _fmt_ms(det1['device_ms'] or None), _fmt_busy(det1['busy']),
           det1['peak_gb'], det1['stats']['compiled_segments'], det1['bits'],
           det1['cpu'][0], SSD['decode_batch'], det2['ms'], det2['margin'][0],
           SSD['decode_batch'], det2['margin'][1], det2['map'],
           det2['map_diff'], det2['mixed'][0], det2['mixed'][1]))
    log('mixture of experts (%.1f s for moe1 and moe2): moe1 the flagship LM '
        'with %d experts a block, top-1 (%d parameters, %d in the experts), '
        'batch %d, AMP Momentum: step %.3f ms, %.1f tokens/s, %.4f TFLOP '
        'executed a step (%.1f TFLOP/s), device %s ms, busy %s, by kind %s, '
        'peak %.2f GB allocated / %.2f GB reserved, K1 %d and K2 %d launches '
        'in %d steps, captured vs op by op the same bits %s, loss %.6f -> '
        '%.6f; moe2 forward + grads %.3f ms, card vs CPU worst %.3e, top-1 '
        'flips %d, dropped %d, top-k vs dense %.3e, FLOPs at E %s'
        % (moe_s, MOE_MODEL['moe_experts'], moe1['n_params'],
           moe1['n_expert'], TRAIN_BATCH, moe1['ms'], moe1['tok_s'],
           moe1['flops'] / 1e12, moe1['flops'] / moe1['ms'] / 1e9,
           _fmt_ms(moe1['device_ms'] or None), _fmt_busy(moe1['busy']),
           ', '.join('%s %.3f' % kv for kv in sorted(
               moe1['kinds'].items(), key=lambda kv: -kv[1])),
           moe1['peak_gb'], moe1['reserved_gb'],
           moe1['launches']['flash_attention_fwd'],
           moe1['launches']['flash_attention_bwd_kvmajor'], MOE_TIMED,
           moe1['bits'], moe1['losses'][0], moe1['losses'][-1], moe2['ms'],
           max(moe2['diffs'].values()), moe2['flips'], moe2['dropped'],
           moe2['dense_err'],
           ', '.join('%d %.4f TFLOP' % (e, f / 1e12)
                     for e, f in moe2['flops'].items())))
    log('profiler and record files (%.1f s pf1, %.1f s rf1): pf1 %d replayed '
        'LM steps under fluid.profiler, K1 %d and K2 %d device launches (the '
        'wrappers\' counts), kernel slices outside the train_step spans by '
        '%.1f us (timeline) and %.1f us (report); a fresh program from its '
        'first run: every K1/K2 graph launch labeled by its op, labeled '
        'share of the replays\' device time %s, op maps of %d segments; '
        'the TPUPlace drive %.4f -> %.6f; rf1 ResNet-50 (batch %d, 224 px) '
        'from %d RecordIO shards (%.1f MB): step %.3f ms from the shards, '
        '%.3f ms pre-placed (%+.1f%%), device busy %s, K6 %g a step, fed '
        'images within %.3e of their records\' decode, the same bits as '
        'the batches fed through py_reader %s; native decode %s samples/s; '
        'the host inflates %.1f MB and copies %.1f MB to the card a batch'
        % (pf1['seconds'], rf1['seconds'], PF_STEPS, pf1['counts']['K1'],
           pf1['counts']['K2/K5'], pf1['tl_out'], pf1['r_out'],
           'not measured' if pf1['share'] is None
           else '%.1f%%' % (100 * pf1['share']), pf1['maps'],
           pf1['drive'][0], pf1['drive'][1], RESNET_BATCH, RF['files'],
           rf1['mb'], rf1['rec_ms'], rf1['pre_ms'],
           100 * (rf1['rec_ms'] / rf1['pre_ms'] - 1), _fmt_busy(rf1['busy']),
           rf1['per_step'], rf1['img_err'], rf1['bits'],
           ' / '.join('%.1f at %d threads' % (r, n)
                      for n, r in rf1['rates'].items()),
           rf1['u8_mb'], rf1['f32_mb']))
    log('parameter-server training (%.1f s for ps1 and ps2, imports and '
        'CUDA start-up of their 8 processes included): ps1 the flagship LM '
        '(%d layers, 2 x batch %d, sync SGD) trainer step %s ms (device '
        '%.3f, send %.3f, barriers %.3f, recv %.3f) against %s ms local, '
        '%.1f MB each way a trainer step, pserver rounds %s ms, vs local '
        'max |diff| %.3e, updates %.3e gradient-weighted, K1 %d and K2 %d '
        'launches; ps2 DeepFM (2 x batch %d, sync Adam, a %d-row '
        'distributed table) step %s ms (prefetch %.3f), %d rows a step '
        'each way, vs local updates %.3e gradient-weighted (max |diff| '
        '%.3e), untouched rows the same bits'
        % (ps_s, PS1['layers'], PS1['batch'],
           ' '.join('%.1f' % x for x in ps1['step_ms']),
           ps1['parts']['device'], ps1['parts']['send'],
           ps1['parts']['barriers'], ps1['parts']['recv'],
           ' '.join('%.1f' % x for x in ps1['local_ms']), ps1['mb'],
           ' '.join('%.1f' % x for x in ps1['round_ms']), ps1['worst'],
           ps1['weighted'], ps1['launches']['K1'], ps1['launches']['K2'],
           PS2['batch'], PS2['ids'],
           ' '.join('%.1f' % x for x in ps2['step_ms']),
           ps2['parts']['prefetch'], ps2['rows'], ps2['weighted'],
           ps2['worst']))
    log('online refresh and fleet serving (%.1f s for on1, fl1 and fl2, '
        'their processes\' start included): on1 %.1f s, a refresh %.3f s '
        'for %.1f MB (%.1f MB/s), %d of %d streams after it equal to the '
        'fresh server; fl1 %.1f s, %.1f tokens/s through the router, TTFT '
        'p50 %.1f ms, failover %s ms, deploys %s, K1 fp32 launches %s; fl2 '
        '%.1f s, %d bytes shipped in %.3f ms, rows bit-equal %s, %d local '
        're-prefills'
        % (on1['seconds'] + fl1['seconds'] + fl2['seconds'], on1['seconds'],
           on1['refresh_s'], on1['mb'], on1['mb_s'], on1['equal'],
           ON_PROMPTS, fl1['seconds'], fl1['tok_s'], fl1['ttft_p50'],
           _fmt_ms(fl1['failover_ms']),
           ', '.join('%s %.3f s' % kv for kv in fl1['deploy_each'].items()),
           json.dumps(fl1['launches']), fl2['seconds'], fl2['ship_bytes'],
           fl2['fetch_ms'][1], fl2['bit_equal'], fl2['local_reprefills']))
    log('the mesh (%.1f s for mp1 and mp2, their processes\' start '
        'included; ranks share the card under gloo): mp1 %.1f s, the ring '
        'step ms by rank %s vs the one-process step %s ms, loss |diff| '
        '%.3e, updates %s, ranks reserved %.2f GB together, gloo probes '
        '%s; mp2 %.1f s, step %s ms (%.3f ms of it in collectives) vs '
        'one process %s ms, loss |diff| %.3e, updates %s, audit %s'
        % (mp_s, mp1['seconds'], ' | '.join(
            ' '.join('%.1f' % x for x in ms) for ms in mp1['ms']),
           ' '.join('%.1f' % x for x in mp1['ref_ms']), mp1['loss_diff'],
           ', '.join('%s %.3e' % kv for kv in mp1['upd'].items()),
           mp1['reserved'], json.dumps(mp1['probes']), mp2['seconds'],
           ' '.join('%.1f' % x for x in mp2['ms']), mp2['coll_ms'],
           ' '.join('%.1f' % x for x in mp2['ref_ms']), mp2['loss_diff'],
           ', '.join('%s %.3e' % kv for kv in mp2['upd'].items()),
           json.dumps(mp2['audit'])))
    log('the pipeline and the sharded checkpoints (their processes\' start '
        'included; ranks share the card under gloo): pp1 %.1f s, step ms '
        'by rank %s vs the one-process step %s ms, loss |diff| %.3e, '
        'updates %s, pp receive waits %s s, sent activations %s MB and '
        'cotangents %s MB, pp gradient sums %s MB, K1 %d and K2 %d '
        'launches; ck1 %.1f s beside a3 and a4 (fault-free run %.1f s, '
        'killed run %.1f s), the last save a rank %s, restore %.1f ms for '
        '%.1f MB, K1 %d, K3a %d and K3b %d launches'
        % (pp1['seconds'], ' | '.join(
            ' '.join('%.1f' % x for x in ms) for ms in pp1['ms']),
           ' '.join('%.1f' % x for x in pp1['ref_ms']), pp1['loss_diff'],
           ', '.join('%s %.3e' % kv for kv in pp1['upd'].items()),
           ' '.join('%.3f' % r['recv_wait_s'] for r in pp1['pp']),
           ' '.join('%.1f' % (r['act_bytes'] / 1e6) for r in pp1['pp']),
           ' '.join('%.1f' % (r['cot_bytes'] / 1e6) for r in pp1['pp']),
           ' '.join('%.1f' % (r['grad_bytes'] / 1e6) for r in pp1['pp']),
           pp1['launches']['K1'], pp1['launches']['K2'], ck1['seconds'],
           ck1['walls']['base'], ck1['walls']['kill'], ' | '.join(
               'snapshot %.1f ms, async %.3f s, %.1f MB in %d files, host '
               'buffer %.1f MB' % (st['snapshot_ms'], st['latency'],
                                   st['bytes'] / 1e6, st['files'],
                                   st['max_host_bytes'] / 1e6)
               for st in ck1['stats']['base'].values()),
           ck1['restore_ms'], ck1['restored_mb'], ck1['launches']['K1'],
           ck1['launches']['K3a'], ck1['launches']['K3b']))
    log('chip_smoke wall time: %.1f s' % (time.perf_counter() - t_start))
    log(json.dumps({'kernels': rows}))
    log(card)
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())

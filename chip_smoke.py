#!/usr/bin/env python3
"""Smoke test and measurement of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--seed N] [--iters N] [--profile DIR]

Phases, in order; any failure ends the run with a non-zero exit code and
no result lines:

1. device: requires CUDA; prints the card's name, the device count and
   ``nvidia-smi --query-gpu=name,power.limit``.
2. build: compiles every CUDA source of the port (one nvcc each, all at
   once) and prints the seconds; then, from ``ptxas -v``, the registers,
   stack and spill bytes and the dynamic shared memory of the flash
   backward kernels, and the registers and spill bytes of every RMSNorm
   instantiation (a spill fails the run).
3. kernels: each kernel at its path's shapes against its plain PyTorch
   version on the card, with the tolerance: the serving kernels at the
   engine's shapes (GPT-2 small, bf16, 8 slots, pages of 16, max_len
   1024, prefill windows of 32), the training kernels at the training
   step's (flash attention b 48, s 256, 12 heads of 64, bf16, causal;
   Adam on the 38.6M-element word embedding and a [768, 3072] kernel),
   plus flash at s 1024, an f32 GQA / kv-valid / ragged case and the
   decode path's prompt prefills (bf16 causal: GPT-2 [4, 256], beam
   [2, 127], speculative [1, 256], Llama [4, 512] GQA 32:8 head dim
   128), and LayerNorm at those prefills' rows ([1024, 768], [254,
   768]); the Llama-3-8B serving kernels at its engine's shapes
   (RMSNorm [8, 4096] and [32, 4096] bf16 and an f32 case, and [2048,
   4096] bf16, its prefill's rows, timed also cold: ``RMS_COLD_PAIRS``
   x/out pairs in turn, 201 MB, beside ``F.rms_norm`` and a copy of x
   (``torch.clone``: the same bytes moved, no arithmetic) on the same;
   the int8 paged decode at 8 slots of q [8, 1, 32, 128] bf16 over
   pages of 16, max_len 8192, and the int8 window at q [1, 32, 32, 128]
   after a prefix of several pages),
   plus the bf16 GQA head-dim-128 paged case at the same shapes.  Times
   the kernel, the plain version and one PyTorch library call computing
   the same function (``ms``: CUDA events over many back-to-back calls,
   what a caller pays, host issue time included when the kernel is
   shorter), times the kernel and the library call again with the host
   out of the way (``graph_ms``: the calls captured in one CUDA graph and
   replayed, the device's own time per call), and computes the least
   time the card could take from the bytes and flops these inputs need
   (3.35 TB/s, 989 TFLOP/s bf16: H100 SXM data sheet).  Each decode
   entry also logs its route, its split plan and its graph time at a
   forced single split.  The flash dQ record is the kernel as the
   backward runs it (computing D from O); the whole backward (dQ, then
   dK/dV) is logged beside SDPA's backward, whose graph time comes from
   calling the aten op SDPA dispatches to directly (its device time from
   ``torch.profiler`` too), and torch's ``row_dot`` D is timed alone.
4. engine: GPT-2 small at full width (random weights from ``--seed``)
   behind ``Engine``: 12 requests (4 sharing a 256-token system prompt),
   drained; checks budgets, the prefix-cache hit rate, that every
   kernel's launch count rose during this run, and row independence (a
   request's tokens alone, in the batch and on a prefix hit are equal).
   Prints tokens/s and TTFT.
5. reference: a 2-layer f32 model on the card and the same weights on
   the CPU (plain versions) must emit the same greedy tokens.
6. training: GPT-2 small at full width, bf16 compute over f32 weights,
   ``adamw(1e-4)``, global-norm clip 1.0, dropout 0, batch 48 x 256
   tokens (rows of 257 ids from ``--seed``, the JAX package's bench
   row): 2 warm-up and 10 timed steps on one batch.  Checks finite
   losses, the last below the first, and that each training kernel
   launched exactly its per-step count times the steps.  Prints step ms,
   tokens/s, mfu (model flops / step time / 989 TFLOP/s) and peak memory.
7. training reference: a 2-layer f32 model trained 3 steps on the card
   (kernels) and from the same weights on the CPU (plain versions):
   per-step losses and final parameters must agree.
8. train-then-serve: the trained GPT-2-small weights serve 2 requests
   through ``Engine``; serving builds no autograd graph.
9. Llama engine: Llama-3-8B at full width and all 32 layers (random
   weights from ``--seed``, bf16 compute over f32 weights) with an int8
   KV cache behind ``Engine(num_slots=8, max_len=8192,
   prefill_chunk=32, tick_steps=8)``, phase 4's 12-request mix drawn
   from vocab 128256; checks budgets, a prefix hit, that both int8
   paged entries launched and LayerNorm did not, that RMSNorm launched
   exactly 2 a layer in every forward plus one for each forward with a
   head (the model's forward entries counted), and row independence.
   Prints tokens/s, TTFT, peak memory and the pool's bytes beside a
   bf16 pool's.  (d) Then two of the mix's requests, exported
   mid-decode from one int8 engine over the model, have their pages
   (int8 ``k``/``v`` and f32 ``k_scale``/``v_scale``) framed, parsed and
   spliced into a second engine (a second 4.43 GB pool); checks the
   pages land bit-equal, the resumed prefills skip at least the windows
   the pages cover, budgets, and RMSNorm and both int8 paged entries
   launched.
10. Llama reference: a 2-layer f32 Llama with head dim 64 on the card
   and with the same weights on the CPU: equal greedy tokens with a pool
   in f32; with an int8 pool, window and decode-step logits within
   ``INT8_REF_LOGIT_TOL`` (tokens compared and reported).
11. decode (run after phase 4, on its model): single-stream decoding on
   the contiguous cache, GPT-2 small in bf16: ``generate`` on 4 prompts
   x 256 + 64 new, greedy, with GPT-2's EOS; the same with
   ``prefill_chunk=64``; a ragged batch of 96-256 tokens through
   ``prompt_valid``; ``beam_search``, beam 4, on 2 prompts x 128 + 32;
   ``generate_speculative``, 1 prompt x 256 + 64, gamma 4, with a draft
   of the target's first 2 layers.  Every run is driven with the launch
   counts at 0 and checked: the flash forward 12 times for each
   one-block prefill (12 + 2 for the speculative target and draft), 0 on
   the chunked and ragged runs, LayerNorm launched, RMSNorm and every
   paged entry not.  Checks shapes and budgets, and decode_block's
   last-position logits against one decode_window over the same prompt
   within ``BLOCK_WINDOW_TOL``.  Prints tokens/s, the prefill ms, the
   speculative acceptance rate and how many greedy tokens the
   speculative run shares with ``generate`` before the first divergence
   (reported, not required: the two round bf16 differently).
12. contiguous engine (after phase 11): ``Engine(paged=False)`` on phase
   4's mix; checks budgets, zero page counters, no paged and no flash
   launch; prints tokens/s and TTFT beside phase 4's and the share of
   requests whose tokens equal the paged engine's (reported: the paged
   kernel and the dense stripe round differently in bf16).
13. decode reference (after phase 5): a 2-layer f32 GPT-2-shaped model
   (head dim 64) on the card and the same weights on the CPU give equal
   greedy tokens for ``generate`` (plain, ragged, chunked, EOS),
   ``beam_search``, ``generate_speculative`` (the model's first layer as
   the draft; its acceptance must lie strictly between 0 and 1, so that
   rounds roll back) and ``Engine(paged=False)``; a 2-layer f32 Llama
   with an int8 contiguous cache gives prefill and decode-step logits
   within ``INT8_REF_LOGIT_TOL``.  (e) The same 2-layer shape with its
   weight matrices scaled 5x (so that greedy tokens vary) and two LoRA
   adapters: equal card and CPU tokens for a mixed adapter/None batch,
   an export mid-decode moved through the page wire, and both on
   ``paged=False``; the adapter requests equal ``generate`` on the
   merged weights.
14. Llama generate (after phase 9, on its model): ``generate`` on 4
   prompts x 512 + 32 new, greedy, into an int8 contiguous cache; checks
   32 flash launches (one prefill), exactly (2 x 32 + 1) x 32 = 2,080
   RMSNorm launches (65 a forward, 32 forwards), LayerNorm and every
   paged entry none; prints tokens/s, prefill ms, peak memory and the
   cache's bytes beside a bf16 cache's.  Phase 3 holds the flash forward
   at this prefill's shape (bf16, GQA 32:8, head dim 128).
16. serve surface (after phase 12, on phase 4's model and mix): (a) the
   mix under 3 LoRA adapters of rank 16 (``SERVE_*``; requests i % 4
   == 3 without one): budgets, the adapter-free requests' tokens equal
   phase 4's exactly, every adapter changes some request's tokens; the
   paged window launches equal phase 4's plus one a layer for each
   window phase 4's prefix hits skipped and this run's do not (a prefix
   is matched within one adapter only, and the shared system prompt
   runs under three adapters and none), and LayerNorm's equal what the
   run's windows and decode steps fix; prints tokens/s and
   TTFT beside phase 4's and the share of adapter requests equal to
   ``generate`` on ``merge_lora`` weights (reported: bf16 rounds the
   two differently).  (b) Admission: tenant "a" at a token quota it
   reaches (the next submit raises), a request with ``deadline_s=0``
   (ends ``deadline_exceeded``), the queue at ``max_queue_depth`` (the
   next submit raises ``QueueFullError``); the admitted requests' tokens
   equal phase 4's.  (c) Migration: the mix on engine A for 6 ticks,
   ``export_inflight``, every snapshot's pages framed, parsed and
   spliced into engine B (checked bit-equal), imported and drained:
   budgets, delivered prefixes kept, B's skipped windows at least those
   the pages cover; prints pages, frame bytes, export, frame/parse and
   import-to-first-token ms and how many requests end equal to phase 4.
   Then ``drain(timeout_s=0)`` on a busy engine returns a falsy result
   whose snapshots finish on B.
15. with ``--profile DIR`` only: the engine phases, 3 training steps
   (of phase 6's configuration and of phase 17's (a), (b) and session
   step (e)) and the GPT-2 and Llama ``generate`` of phases 11 and 14
   again under
   ``torch.profiler``; the device's busy share, its top kernels, µs per
   paged-attention launch, and (training, Llama engine, generate) device
   ms by part; then µs per paged launch in the Llama
   engine over 4 requests of the mix at the planned split counts and at
   one forced split (what split-K gives inside the engine).

17. training session (after phase 8): GPT-2 small at phase 6's batch,
   bf16, ``adamw(1e-4)``, clip 1.0, rows of the order-1
   ``synthetic_lm_corpus`` through ``Dataset``.  (a) ``remat`` "full",
   (b) "dots", (c) "full" with ``loss_seq_chunk=1024`` (the JAX bench
   configuration with its chunk lever), (d) ``accum_steps=4`` on phase
   6's batch and weights (its losses against phase 6's within
   ``ACCUM_*_TOL``): each 2 warm-up and 4 timed steps, with exact launch
   counts (remat: the flash forward twice a layer, LayerNorm 4 a layer
   plus one; microbatches multiply them), finite and falling losses, 0
   host syncs a step, and the peak memory of (a) and (c) below phase
   6's.  (e) The full ``TrainSession``: ``with_ema(adamw)``,
   ``policy="mixed_bfloat16"``, ``DynamicLossScale`` from 2**127, remat
   "full", the chunked head, 2 microbatches, dropout 0.1; hooks
   ``StopAtStepHook``, ``LoggingHook``, ``NaNHook``, ``StepCounterHook``,
   ``SummaryHook`` (event file), ``CheckpointHook`` every 5 steps; to
   step 10; every batch carries a loss mask of ones.  The first steps
   overflow (see ``SESSION_SCALE``) and skip: on each the parameters stay
   bit-equal, Adam launches 0 times, the count holds and the scale
   halves; every applied step keeps the scale; exactly 1 host sync a
   step; its rows equal those of an uninterrupted run of 15 steps with
   the same hooks, which is the session's timed window: nothing of the
   harness runs between its steps (no sync counter, no parameter copy,
   no per-step synchronise), and its tokens/s count the applied steps'
   tokens over the loop's wall time (saves in, and apart).
   (f) A second session on the directory restores step 10
   (``restore_latest_good``) and runs to 15: its parameters and EMA
   shadow equal the uninterrupted run's bit for bit; then a byte flipped
   in the newest checkpoint is quarantined and the restore falls back to
   step 10.  (g) Card against CPU, ``gpt_tiny`` in f32, 3 steps each of
   accumulation, remat (three policies), the chunked loss and loss
   scaling (a planted overflow) at dropout 0 (the CUDA and CPU
   generators draw different bits), within ``TRAIN_LOSS_TOL`` and
   ``TRAIN_PARAM_TOL``; and remat against no remat on the card at dropout
   0.1 (equal).  Prints step ms, tokens/s, mfu (phase 6's model flops:
   the recomputation is not model work), peak memory, launches, syncs a
   step, and for (e)/(f) checkpoint bytes, save ms, verify-and-restore ms
   and the event file's records (the watched arms are not timed).

18. xor (after the Llama phases): ``example.py``'s path.  (a) The Adam
   kernel against its plain version at the XOR MLP's six leaf shapes
   ([64, 128], [128], [128, 128], [128], [128, 32], [32]) at steps 1 and
   3, called as ``optim.adam()`` calls it, with kernel and plain ms.
   (b) ``make_train_step`` on the card against the CPU: one set of
   weights from ``--seed``, dropout 0, 20 steps on the same batches, in
   f32 with TF32 off (asserted; the entry point sets the precision):
   losses within ``XOR_LOSS_RTOL``, parameters within ``XOR_PARAM_TOL``.
   (c) One epoch of the entry point's step loop timed (step ms, steps/s,
   samples/s) and profiled (the card's busy share, ``obs.device
   .device_busy``); then ``python -m distributed_tensorflow_tpu_torch
   .example`` run in-process at ``example.py``'s configuration for 50
   epochs, or 8 when that epoch's time says 50 would not fit
   ``XOR_BUDGET_S``: the last printed val accuracy above 0.95, Adam
   launches exactly 6 a step and no other kernel, a checkpoint at the
   last step and the graph record in the event file.  (d) The entry point
   again with one epoch more on the same log dir: it restores at the
   last step, runs 600 steps with 0 host syncs in each (counted as phase
   11 counts them) and prints the epoch line.  (e) ``cluster.initialize``
   on a one-process environment (NCCL), ``make_train_step(mesh=...)`` for
   10 steps at dropout 0 from (b)'s weights: parameters equal to (b)'s
   card run within ``XOR_DP_TOL``, one all-reduce a step (counted).

19. sequential (after phase 18): the high-level tier.  (a) The Adam
   kernel against its plain version at the CIFAR CNN's 12 and the MNIST
   MLP's 4 leaf shapes, with kernel, graph, plain and bound ms and
   ``torch.optim.Adam(fused=True)``'s ms and graph ms (phase 18 (a)
   logs the same at the XOR leaves).  (b) Precision, TF32 off in cuBLAS and
   cuDNN: the CIFAR CNN's four convolutions alone at batch 256 against
   f64 (CPU f32; card through cuDNN, deterministic cuDNN and PyTorch's
   own convolutions; a TF32-on control that must read above the limit);
   then from the card's weights, in the cuDNN modes and the control, the
   CNN's first loss and gradients against the CPU's (given the card's
   ReLU masks; the disagreements of the two forwards' masks counted) and
   5 ``train_on_batch`` steps, and the MNIST MLP for 5 ``TrainSession``
   steps (``CONV_TOL``, ``SEQ_*`` tolerances).  (c) ``python -m
   distributed_tensorflow_tpu_torch.example2`` in-process at its defaults
   but ``EX2_EPOCHS`` (7 of 50 epochs): val accuracy at each epoch line,
   the first above 0.95,
   Adam launches exactly 6 a step and nothing else; beside it one epoch
   of the same ``fit`` timed, profiled (busy share) and its host syncs
   counted.  (d) ``...outline_keras`` at its defaults but
   ``CIFAR_EPOCHS`` (1 epoch of batch 256 on the synthetic CIFAR-10,
   crop + flip): final val accuracy
   above 0.35, examples/s, the augment's host ms a batch, Adam 12 a
   step; one epoch probed as in (c).  (e) ``...outline_tensorflow`` at
   its defaults: final val accuracy above 0.9, examples/s, Adam 4 a step.
   (f) ``steps_per_execution=8`` against 1 over one CIFAR epoch (cuDNN
   deterministic): parameters and History bit-equal, step ms of each.
   (g) ``[Dense(128), LayerNorm(fused="auto"), Dense(10)]`` for 3 fit
   steps: one LayerNorm launch a forward; the LayerNorm kernel against
   its plain version at [1024, 128] and [1024, 129] f32, with
   ``F.layer_norm``'s ms and graph ms.
20. obs and resilience, both main paths at GPT-2-small width.  (c) and
   the engine half of (d) run after phase 16, on phase 4's model and mix;
   (a), (b) and the session half of (d) after phase 17.  (a) A
   ``Supervisor`` around a ``TrainSession`` (phase 6's widths and batch,
   ``adamw``, clip 1.0, ``device_health`` and ``skip_nonfinite``) on the
   synthetic corpus through ``Dataset`` and ``prefetch_to_device``,
   saving every ``OBS_EVERY`` steps, with ``NonfiniteGuardHook(3)``,
   ``TraceHook`` and ``MetricsExportHook`` under one
   ``Telemetry(metrics_port=0)``, and a ``FaultPlan``: the first save
   raises, the next good save but one is truncated, three NaN steps trip
   the guard, the prefetch producer dies later.  Checks: the run reaches
   its last step; one restart per transient fault (the plan's audit
   trail lists each fault once); the corrupt checkpoint is quarantined
   and the one before it restored; the parameters equal those of an
   unfaulted session from that checkpoint over the same batches (run
   twice: bit-equal when those two are, else within twice their
   spread); the flash, LayerNorm and Adam kernels ran (counted).  (b)
   ``/metrics`` scraped over loopback and parsed: steps and step-time
   count equal the steps run, live bytes above 0, restarts as in (a);
   the trace file holds step, data_load, dispatch and checkpoint spans;
   the goodput buckets sum to the wall within 2%, with fault_recovery,
   restart_backoff and checkpoint_restore above 0.  (c) Phase 4's engine
   with a fresh registry, request traces and a critical-path ledger, and
   a plan that fails request ``OBS_FAIL_RID`` at delivery and stalls one
   tick: that request ends ``failed`` with the injected fault, the other
   11 streams equal phase 4's, every finished request's trace has the
   queued, prefill and decode stages and its critical path sums to its
   e2e, ``ServeMetrics`` equals ``EngineStats`` and the handles, and the
   paged and LayerNorm kernels ran (counted).  (d) In turns (off, on, on,
   off) in this call: the engine with (c)'s instrumentation off and on
   (tokens/s, TTFT p50; tokens unchanged), and ``OBS_PAIR_STEPS``
   session steps with the telemetry hooks off and on (step ms; busy
   share from a profiled run of ``OBS_BUSY_STEPS`` steps of each).
21. fleet (after phase 20's engine half, on phase 4's model): three
   replicas of phase 4's engine (each its own page pool and registry)
   share the model behind ``fleet.Router``.  (a) Phase 4's mix drawn
   twice (24 requests; 8 share one of two 256-token system prompts, the
   first of each submitted first, the other 6 once those have a token;
   three draws until phase 32 needed the room) through
   ``Router(affinity_weight=1.0)`` and, the same
   way, through one engine: every stream equals the single engine's, the
   placements are equal over two fleet runs, the late shared-prompt
   requests land on their prompt's holder (``dttpu_router_affinity_
   hits_total`` 6), and the paged and LayerNorm launches are exact
   against the single engine's (as phase 16 counts them); prints fleet
   and single-engine tokens/s and TTFT p50/p95.  Then the JAX package's
   adversarial three-tenant mix (``bench.py`` ``bench_fleet``: equal
   demand of 240 tokens each for free, pro and batch in blocks in that
   order, pro under a rank-16 LoRA broadcast by ``Router.load_adapter``,
   ``TenantPolicy(quantum=8)``): budgets; prints per-tenant TTFT p50/p95
   and the bench's fairness ratio.  (b) Failover with a ``PageWire`` (2
   pages a frame, a flight of one) over ``InProcessLink``: replica 1 is
   killed (``kill_replica``) once two of its requests decode, and the
   wire drops, corrupts and stalls one frame each; then again with the
   link down (``kill_host``) instead.  Checks every request ``ok`` with
   its budget and an exact stream, ``dttpu_migrations_total`` equal to
   the victims, wire migrations >= 1 (then exactly one degraded to
   re-prefill), and the survivors' skipped windows at least what the
   adopted pages cover; prints the kill step's ms, the mean transfer ms,
   frames, bytes, retries, and how many migrated requests end equal to
   the single engine (reported: a resumed bf16 decode may round
   differently).  (c) Watchdog: a pump thread drives the fleet and checks
   ``Watchdog(tick_deadline_s=0.25)`` after each step; once replica 2's
   stalled tick (0.6 s) is quarantined ``stalled``, the main thread
   checks every 20 ms as well and quarantines replica 0, wedged in a
   tick, ``wedged``: its requests exported ``clean=False`` finish on the
   survivor, and every victim has a forensic dump; prints the detection
   latencies and the healthy replica's longest tick.  (d) Under traffic,
   ``drain_replica(migrate=True)``, ``resume_replica``, ``remove_replica``
   and ``add_replica`` of a fresh engine: no request lost.  (e) A
   ``fleet.synthesize`` trace (64 requests, one burst) mapped to seeded
   prompts and replayed on a virtual clock (0.25 s a router step) under
   an ``Autoscaler`` from one replica (``min_replicas=1``,
   ``max_replicas=3``, engines built on the card): a scale-out in the
   burst and a migrate-based scale-in after it, no request lost; then
   ``FederatedMetrics`` over the replicas' registries, served by
   ``MetricsServer`` on loopback and scraped: each replica's series under
   its ``replica`` label, and the ``dttpu_slo_*`` series.

22. zoo (after phase 19): the encoder zoo.  (a) The flash kernel on its
   new routes against its plain version (forward out and lse, and the
   backward through ``flash_attention``'s autograd route), timed beside
   the plain version, ``F.scaled_dot_product_attention`` with the
   boolean key mask (the backend it took is logged) and the bound:
   BERT-base's bidirectional attention with key padding ([128, 128, 12,
   64] bf16, lengths from ``--seed``, one row with no valid key),
   ViT-B/16's 197 tokens ([64, 197, 12, 64] bf16), and the head dims
   the wrapper zero-pads to 64: train_vit's [64, 17, 4, 16] f32 and
   finetune_bert's [32, 32, 4, 32] bf16; LayerNorm at [16384, 768],
   eps 1e-12, in bf16 within phase 3's tolerance and in f32 (the
   embeddings' norm) within F32_TOL, beside ``F.layer_norm``.  (b)
   BERT-base MLM, ``bench_bert``'s row as promoted (seq 128, 25 gathered
   predictions, remat "dots", batch ladder 128/96/48/24 descending on
   out-of-memory, bf16, dropout 0, ``adamw(1e-4)``, clip 1.0, 2 + 10
   steps), and an arm without those levers at batch 96: step ms,
   tokens/s, peak memory, finite losses, exact launches.  (c) A 2-layer
   BERT in f32 with TF32 off, card against CPU with a ragged mask:
   logits, then 3 steps' losses and parameters.  (d) ViT-B/16 at 224,
   bf16, batch 64, 2 + 10 steps (images/s, exact launches), and the
   ``train_vit`` entry point at ``ZOO_VIT_STEPS`` (150) of its default
   300 steps in-process: its eval accuracy above chance.  (e) ``finetune_bert`` at its defaults
   and with ``--mlm_steps=4 --mlm_predictions_per_seq=8``, exact
   launches.  (f) ResNet-50, ``bench_resnet50``'s row (224,
   ``mixed_bfloat16``, ``momentum(0.1, beta=0.9)``, ladder
   512/256/128/64, 2 + 10 steps: examples/s), and ``resnet_cifar`` card
   against CPU in f32 (2 steps: losses, parameters, BatchNorm moments).
   (g) ``Seq2SeqConfig()`` at full width in bf16 (batch 32, 128 + 128
   tokens, 2 + 10 steps), and greedy ``generate`` of 32 tokens on a
   2 + 2-layer f32 copy: the card's tokens equal the CPU's.
23. gpt family (after phase 22): the GPT stack's last configurations.
   (a) The paged kernel at head dim 32 on all 16 branches (decode and
   window; bf16 and f32 q; a pool in q's type and int8; MHA, the
   serve_gpt demo's 4 heads, and GQA, llama_tiny's 4q/2kv) against its
   plain version with phase 3's tolerances, at 8 slots over a view of 128
   columns in pages of 16 (ragged rows, one on the trash page, one with
   no valid column) and a window of 32 queries at pos 96: ms, graph ms,
   the plain version's ms, gather + SDPA (int8: dequantized first) and
   the bound.  (b) ``bench_gpt_moe``'s row (bench.py:2604): GPT-2 small
   with 8 experts, top 2, capacity factor 1.25, bf16 over f32 weights,
   remat "full", ``adamw(1e-4)``, clip 1.0, dropout 0, ladder 48/24/12 x
   256, 2 + 10 steps: finite and falling losses, ``moe_aux`` above 0,
   exact launches a step (flash forward 24, dK/dV 12, dQ 12, LayerNorm
   49, Adam 208: a MoE block has 5 FFN leaves); step ms, tokens/s, peak
   memory, mfu (the inactive experts' 6N discounted, bench.py:951-959)
   and each layer's dropped fraction in one forward.  (c) The same model
   (random weights, capacity factor 4.0 = E / k) behind ``Engine`` on
   phase 4's mix: budgets, a prefix hit, paged and LayerNorm launches
   equal to phase 4's, row independence; tokens/s and TTFT beside phase
   4's.  (d) A 2-layer f32 MoE model (weights scaled 5x), TF32 off, card
   against CPU: ``lm_loss_fn``'s loss and ``moe_aux`` (``TRAIN_LOSS_TOL``)
   and every gradient (``FAM_GRAD_TOL``) at train=False, and greedy
   ``Engine`` tokens equal.  (e) ``bench_llama``'s row (bench.py:975:
   vocab 32,000, d 768, 12 layers, GQA 12q/4kv, ff 2048, seq 256, remat
   "full"), ladder 48/24/12: exact launches a step (RMSNorm 49, flash
   forward 24, dK/dV 12, dQ 12, Adam 111, LayerNorm 0); step ms,
   tokens/s, mfu, peak memory; then ``llama_tiny`` (head dim 32) card
   against CPU over 3 ``adamw`` steps (losses, parameters).  (f)
   ``python -m distributed_tensorflow_tpu_torch.examples.serve_gpt
   --engine --replicas=2 --shared_prefix`` in-process on the card: its
   engine == lock-step, fleet == lock-step and speculative greedy-match
   lines read 1.000, and the paged kernel (head dim 32), the flash
   forward and LayerNorm launched.
24. hf (after phase 23): text and Hugging Face interop.  First the flash
   kernels at (a)'s shape ([16, 32, 12, 64] bf16 causal) against their
   plain versions, the forward timed beside SDPA and the bound.  (a) A
   GPT-2-small
   checkpoint directory (``openai-community/gpt2``'s config.json widths,
   dropout 0; an HF-layout ``pytorch_model.bin`` of random weights from
   ``--seed`` with Conv1D kernels [in, out] and a tied ``lm_head``; a
   ``vocab.json`` / ``merges.txt`` of ``HF_MERGES`` merges that
   ``BPETokenizer.train`` learned on the example's corpus and seeded
   text, renamed into GPT-2's byte symbols, ``<|endoftext|>`` at 50256)
   fine-tuned by ``examples.finetune_gpt2_hf`` at its defaults (50 steps
   of 16 x 32, ``adamw(3e-4)``, clip 1.0, greedy 12 tokens) with
   ``--dtype=bfloat16``: finite losses, the last below the first, the
   generated text starts with the prompt, and exact launches (flash
   forward, dK/dV and dQ 12 a step, LayerNorm 25 a step, Adam 196 a
   step; the generate's prefill 12 flash forwards and 25 LayerNorms a
   forward over 12 forwards); prints step ms (steps 10-49), tokens/s
   and ``load_hf_dir``'s seconds for the 0.5 GB file (warm cache).  (b)
   The same entry point on a 2-layer f32 copy written as
   ``model.safetensors`` (``write_safetensors``), ``HF_REF_STEPS`` steps
   on the card and on the CPU: losses within ``TRAIN_LOSS_TOL``
   (relative), generated ids equal.  (c) BERT-base (MLM logits, batch 8
   x 128 with key padding), ViT-B/16 (1000 labels, batch 16) and the
   Llama recipe at ``bench_llama``'s width (batch 4 x 256) converted from
   HF-layout state dicts made from ``--seed`` (no ``transformers``) in
   bf16: finite logits, exact launches a forward (flash 12; LayerNorm 26,
   25; RMSNorm 25), forward ms; and a 2-layer f32 copy of each, card
   against CPU within ``ZOO_LOGIT_TOL``.  (d) On the card's host: the
   BPE encoder (``backend="native"``) against the Python loop on
   ``HF_PY_BYTES`` of text (ids equal, both times) and alone on 1 MB,
   ``GPT2BPETokenizer`` on 1 MB (ids/s, round trip), and
   ``Dataset(backend="native")`` against ``"numpy"`` over an epoch of
   phase 19's MNIST arrays (every row once; batches/s).
25. sp (after phase 24): sequence parallelism.  (a) Ring-flash's
   kernel routes at full width on a virtual ring of ``SP_RING`` = 4
   ranks (``parallel/ring_flash.py``'s ``forward_step`` and
   ``backward_step`` driven in lockstep for every rank in one process,
   ``virtual_ring_flash``): GPT-2 small's ``bench_gpt_long`` blocks
   (q [6, 2048, 12, 64] bf16 causal, blocks of 512), Llama-3-8B's
   attention (q [4, 2048, 32, 128], 8 kv heads, causal) and BERT-base's
   (q [16, 512, 12, 64], bidirectional, every row's last shard of keys
   all padding).  Output, lse and the three gradients against the plain
   whole-sequence flash within phase 3's bf16 tolerance, no NaN, exact
   launches by route (a causal ring of 4: 6 full and 4 diag blocks of
   each of forward, dQ and dK/dV; bidirectional: 16 full); each block
   route (forward full and diag, the given-lse backward full and diag)
   timed beside its plain version, SDPA at the block shape and the
   bound.  (b) GPT-2 small with ``seq_axis="seq"`` on ``make_mesh({"seq":
   1})`` at 6 x 2048 (``max_position`` 2048), ``SP_WARMUP`` +
   ``SP_STEPS`` ``adamw(1e-4)`` steps with clip 1.0, against the same
   weights without ``seq_axis``: the first loss within ``SP_FIRST_TOL``,
   every loss within ``SP_LOSS_TOL``, the first gradient norm within
   ``SP_GRAD_TOL``, the parameters' gap within ``SP_PARAM_TOL`` of their
   movement, exact launches of flash, LayerNorm, Adam and the
   ring's routes; step ms and tokens/s of both.  (c) The same for the
   Llama recipe at Llama-3-8B's widths cut to ``SP_LLAMA_LAYERS``
   layers (4 x 2048) and BERT-base MLM (16 x 512, ragged key padding).
   Last on the card: SDPA's autograd backwards of phase 22's
   whole-backward rows and of (a)'s backward routes, replayed from a
   CUDA graph (their library graph ms).
26. zero (after phase 25): ZeRO over the ``fsdp`` axis.  (a) GPT-2 small
   at phase 6's batch (48 x 256, bf16, dropout 0) under
   ``with_ema(adamw(1e-4), 0.99)``, clip 1.0, ``mixed_bfloat16``: the
   state placed by ``GPT.partition_rules(fsdp=True)`` and
   ``shard_train_state`` on ``make_mesh({"data": 1, "fsdp": 1})``
   against the plain state from the same weights, ``ZERO_WARMUP`` +
   ``ZERO_STEPS`` steps an arm, the arms in turns (ZeRO, plain, plain,
   ZeRO): losses, parameters, moments and the EMA shadow equal to the bit, exact launches a step (Adam 196, flash
   forward, dK/dV and dQ 12 each, LayerNorm 25), no collective; step ms
   and each arm's own peak memory.  Then ``TrainSession(
   sharded_checkpoint=True)``: ``ZERO_SESSION`` steps and a save (s,
   bytes), a fresh session from other weights restores (s) a bit-equal
   state, and one more step equals the uninterrupted run's.  (b) A
   virtual ``fsdp`` line of ``ZERO_VIRTUAL`` ranks at the same width:
   the Adam kernel on every virtual rank's blocks (784 launches) equals
   the whole-leaf launches to the bit (deltas and moments); the blocks
   joined along each rule's dim give back every leaf; the sharded writer
   called as pids 0-3 writes one checkpoint that ``restore_sharded``
   reads back bit-equal onto the fsdp-2 and fsdp-1 layouts, that
   ``verify_sharded`` passes, and fails once a shard file is gone; the
   Adam kernel timed at the word embedding's block [50257, 192] beside
   its plain version, ``AdamW(fused=True)`` and the bound.  (c) ``python
   -m distributed_tensorflow_tpu_torch.examples.train_gpt`` at its
   defaults (200 steps; ``--log_dir`` under ``build/``) in a subprocess:
   exit 0, live and EMA eval losses below uniform (ln 256), the
   ``generated:`` line, a complete sharded checkpoint; again with
   ``--steps=220``: restored at step 200, ends at 220; ``--family=
   llama`` exits 0.
27. tp (after phase 26): tensor parallelism.  First the flash kernels at
   the shapes a rank of (b) runs (BERT-base's 6 of 12 heads at 128 x 128
   with the key plane, bidirectional; the Llama recipe's 16 q / 4 kv
   heads of 128 at 4 x 512, causal), forward and whole backward against
   their plain versions, timed beside them, SDPA and the bound.  (a) A
   line of one (``make_mesh({"tensor": 1})``) at full width against the
   plain model from the same weights: BERT-base MLM at phase 22's batch
   (128 x 128, bf16, ragged key padding) and the Llama recipe at
   Llama-3-8B's widths cut to ``TP_LLAMA_LAYERS`` layers (4 x 512, GQA
   32:8), ``TP_WARMUP`` + ``TP_STEPS`` ``adamw(1e-4)`` steps with clip
   1.0 an arm, the arms in turns (line, plain, plain, line): losses, the
   gradient norm and every parameter equal to the bit, exact launches a
   step, no collective; step ms, tokens/s and peak memory of each.  (b) Two ranks of this script (``--ranks-for=tp``)
   on the one card over gloo with CUDA tensors, ``{"tensor": 2}``:
   BERT-base, the Llama recipe with ``shard_kv=True`` and with
   replicated kv, from the same weights and batches as (a): losses
   within ``TP_LOSS_TOL`` of (a)'s plain arm, the first gradient norm
   within ``TP_GRAD_TOL``, the parameters' gap within ``TP_PARAM_TOL``
   of their movement, both ranks' losses equal, the tensor line's
   collectives exact a step (``tp_collectives``), exact kernel launches,
   each rank's peak memory below (a)'s.  (c) A f32 copy of the Llama
   recipe decoded on the two ranks (``decode_block``, ``decode_step``,
   greedy ``generate``) against the plain model: the same tokens, logits
   within ``TP_DECODE_TOL``, exact launches and collectives.  (d)
   ``python -m distributed_tensorflow_tpu_torch.examples.finetune_bert``
   on two ranks of the card (tp=2, ``DTTPU_DIST_BACKEND=gloo``) beside
   (b): exit 0, ``mesh={'data': 1, 'tensor': 2}``, eval accuracy above
   chance, both ranks' lines equal.
28. pp (after phase 27): pipeline parallelism.  First the flash kernels
   at a microbatch's shape (6 x 256, 12 heads of 64, causal), forward and
   whole backward against their plain versions, timed beside them, SDPA
   and the bound.  (a) GPT-2 small at phase 6's batch (48 x 256, bf16,
   dropout 0, ``adamw(1e-4)``, clip 1.0): the plain step in this process,
   then two ranks of this script (``--ranks-for=pp``) on the one card over
   gloo with CUDA tensors, ``{"pipe": 2}`` (6 layers a stage, 8
   microbatches), GPipe (``make_custom_train_step``) and 1F1B
   (``make_1f1b_train_step``), ``PP_WARMUP`` + ``PP_STEPS`` steps an arm
   from the same weights: losses within ``PP_LOSS_TOL`` of the plain arm,
   the first gradient norm within ``PP_GRAD_TOL``, the parameters' gap
   within ``PP_PARAM_TOL`` of their movement, GPipe against 1F1B within
   ``PP_SCHED_TOL``, both ranks' losses equal, each rank's kernel launches,
   exchanges, staged host copies and broadcasts exact a step
   (``pp_per_step``, ``pp_collectives``), 1F1B's peak memory below
   GPipe's on both ranks; step ms and each rank's peak memory printed.
   (b) ``python -m distributed_tensorflow_tpu_torch.examples.train_gpt
   --pipeline_stages=2`` on two ranks of the card beside (a), with
   ``--pp_schedule=gpipe``, ``=1f1b`` and ``--family=llama``: exit 0,
   ``mesh={'pipe': 2, 'data': 1}``, live and EMA eval loss below ln 256,
   the ``generated:`` line, a complete sharded checkpoint; the GPipe run
   again with more steps resumes from it.
29. ep (after phase 28): the expert axis and the vision zoo on a mesh.
   (c) First the flash kernels at ViT-B/16's rank heads ([64, 197, 6 of
   12 heads, 64] bf16, bidirectional), forward and whole backward
   against their plain versions, timed beside them, SDPA and the bound.
   Then two ranks of this script (``--ranks-for=ep``) on the one card
   over gloo with CUDA tensors run (b) while this process runs (a).  (a)
   A line of one at full width: bench_gpt_moe's MoE GPT (GPT-2 small, 8
   experts, top-2, remat "full") in f32 and as the row has it in bf16 on
   ``{"expert": 1}``, ViT-B/16 at 224 (bf16) on ``{"tensor": 1}`` and
   ResNet-50 at 224 (f32, TF32 off) without a mesh, ``EP_WARMUP`` +
   ``EP_STEPS`` steps an arm at the cut batches ``EP_MOE_BATCH`` x 256,
   ``EP_VIT_BATCH`` and ``EP_RESNET_BATCH``, the router jitter on: exact
   launches a step (phase 23 (b)'s and phase 22 (d)'s), no collective.
   (b) The same models from the same weights and batches on the two
   ranks, which draw (a)'s jitter (a mesh of one replica folds none into
   the step's generator): the MoE GPTs on ``{"expert": 2}``, ViT-B/16
   and ResNet-50 on ``{"tensor": 2}``: both ranks' losses equal, the
   first losses, the first gradient norm and the parameters' gap after
   the first step against their movement within each arm's
   ``EP_LIMITS`` of (a)'s, each rank's kernel launches and the lines'
   collectives exact a step (``ep_collectives``).  ``--ep-seeds`` runs
   (a) and (b) alone over several seeds and logs what each arm reads
   there (the readings ``EP_LIMITS`` comes from).
30. tpf (after phase 29): seq2seq under tensor parallelism, ``tensor``
   beside ``fsdp``.  First, on a quiet card, Adam at the word
   embedding's fsdp part of its tensor block ([16064, 256] f32) and
   LayerNorm at a rank's rows ([2048, 512] f32), each against its plain
   version, timed beside it, ``AdamW(fused=True)`` or ``F.layer_norm``
   and the bound.  Then four ranks of this script (``--ranks-for=tpf``)
   on the one card over gloo with CUDA tensors run (b) to (d) while this
   process runs (a) and (b)'s reference.  (a) A line of one at full
   width: ``Seq2SeqConfig()`` in bf16 on ``{"data": 1, "fsdp": 1,
   "tensor": 1}`` under ``partition_rules(fsdp=True)``, zoo (g)'s batch,
   against the plain model from the same weights, the arms in turns:
   losses, the norm and every parameter bit-equal, LayerNorm 32 and Adam
   259 launches a step, no collective; step ms, tokens/s and peak
   memory.  (b) The same model in f32 (TF32 off) on ``{"fsdp": 2,
   "tensor": 2}``: every rank's losses equal; the first losses, the first
   gradient norm and the parameters' gap after the first step against
   their movement within ``TPF_LIMITS`` of a plain f32 run; each rank's
   kernel launches and the lines' collectives exact a step
   (``tpf_collectives``); each rank's peak memory below (a)'s.  (c) The
   ranks' sharded checkpoint restores bit-equal onto their layout and
   onto a whole model here; ``verify_sharded`` passes.  (d) Greedy
   ``generate`` on the ranks gives the card's plain model's tokens (zoo
   (g)'s 2 + 2-layer f32 copy).  ``--tpf-seeds`` runs the phase alone
   (without the kernel times) over several seeds and logs its readings
   (the readings ``TPF_LIMITS`` comes from).
31. tsp (after phase 30): ``tensor`` beside ``seq``, the JAX package's
   multi-chip BERT mesh ``{"seq": 2, "tensor": 2}``.  (a) First, on a
   quiet card, the ring-flash block routes at a rank's heads on a
   virtual ring of 2 (BERT-base [16, 256, 6, 64] bf16 with the key
   plane; the Llama recipe [2, 1024, 16 q / 4 kv, 128] bf16, full and
   diag), forward and dQ + dK/dV, and LayerNorm at a rank's rows ([4096,
   768] f32), each against its plain version, timed beside it, SDPA or
   ``F.layer_norm`` and the bound; then (d)'s plain reference.  Four
   ranks of this script (``--ranks-for=tsp``) on the one card over gloo
   with CUDA tensors run (c) and (d) while this process runs (b) and
   (c)'s reference.  (b) BERT-base MLM (16 x 512, key padding, bf16) on
   ``{"seq": 1, "tensor": 1}`` against the same model on ``{"seq": 1}``,
   in turns: bit-equal, exact launches, no collective.  (c) The same
   model in f32 (TF32 off) on ``{"seq": 2, "tensor": 2}``: every rank's
   losses equal; the first losses, the first gradient norm and the
   parameters' gap after the first step against their movement within
   ``TSP_LIMITS`` of a plain f32 run; each rank's kernel launches and the
   lines' collectives exact a step (``tsp_collectives``).  (d) The Llama
   recipe at Llama-3-8B's widths (2 layers, 2 x 2048, bf16,
   ``shard_kv=True``), forward and loss on the ranks' mesh: every rank's
   loss equal and within ``TSP_LLAMA_TOL`` of the plain model's, the
   launches by route exact.  ``--tsp-seeds`` runs the phase alone
   (without (a)) over several seeds and logs its readings.
32. fleet tools (after phase 21, on phase 4's model): the fleet's host
   tooling.  (a) ``fleet.sim`` held to the engine on the card, as the JAX
   package's bench validates its simulator (``bench.py``
   ``_fleet_sim_validate``): phase 4's engine alone behind ``Router``,
   warmed; the least of up to 12 steps with all 8 slots decoding and of
   up to 12 pure-window steps of a 192-token prompt alone; ``Cost``s of
   the window and the tick in closed form (2 x P FLOPs a token) into
   ``CostModel.calibrate``; a burst of 48 requests of 3-65 tokens and 10
   new tokens replayed 3 times through the router (fresh tokens each
   time: the simulator's trace shares no prefix), the least wall and
   TTFT p50 taken; the same burst through ``FleetSim`` (one replica, the
   engine's geometry, a round of one measured tick).  Checks every
   request's budget, the paged and LayerNorm launches over the replays
   exactly (windows from the prompt lengths, LayerNorm from the windows
   and decode steps), and sim/real tokens/s and TTFT p50 within 25%.
   (b) 100,000 synthesized
   requests over 1,800 virtual seconds through ``FleetSim`` on 4 replicas
   under the ``Autoscaler`` (up to 32), priced by (a)'s model: completed + expired +
   lost == submitted; two runs of 10,000 give equal reports; logs the
   host's requests/s, TTFT p50/p95 and attainment; it runs while (d)'s
   respawn trains.  (c) While (b) and (d) run:
   ``examples.launch_multihost_smoke`` (two hosts on the card over gloo)
   exits 0, every host done with no restart, host 0 the chief, each
   all-reduce sum exact.  (d) ``fleet.Launcher`` supervises one host, a
   process of this script (``--ranks-for=chaos``) training the XOR MLP
   of ``example.py`` (Adam on the card) through ``TrainSession`` with a
   checkpoint every 600 steps and a heartbeat every step; once a
   checkpoint past step 0 is on disk, ``kill_host`` at its next poll:
   one restart (exit history -9, 0), the respawn starts at the restored
   step, Adam launched in both incarnations, final val accuracy >= 0.95;
   logs the time to recover (the kill to the respawn's first step).
   ``--fleet-tools`` runs the phase alone (after the build, on a GPT-2
   small of its own) and logs its readings.

The last lines are the kernels' JSON record (``launches`` from phases 4,
6 and 9; ``decode_launches`` for the kernels phases 11, 12 and 14 ran;
``session_launches`` for those of phase 17's session, (e) and (f);
``xor_launches`` for Adam on phase 18's entry point run, (c);
``seq_launches`` for Adam on phase 19's three entry point runs and
LayerNorm in (g); ``obs_launches`` for the kernels of phase 20's (a) and
(c); ``fleet_launches`` for the serving kernels of phase 21 (a)'s fleet
run; ``zoo_launches`` for the training kernels of phase 22's (b), (d),
(e) and (g); ``gpt_family_launches`` for every kernel over phase 23's
(b), (c), (e) and (f); ``hf_launches`` for those of phase 24's (a) and
(c); ``sp_launches`` for the training kernels of phase 25's (b) and
(c) seq_axis arms, and on the flash records ``sp_routes``, (a)'s route
times; ``zero_launches`` for the training kernels of phase 26 (a)'s ZeRO
arm, and on the Adam record ``zero_shard``, (b)'s block times;
``tp_launches`` for the training kernels of phase 27's (a) line-of-one
arms and (b)'s two ranks, and on the flash records ``tp_shapes``, the
times at the ranks' shapes; ``pp_launches`` for the training kernels of
phase 28 (a)'s two ranks under both schedules, and on the flash records
``pp_shapes``, the times at a microbatch's shape; ``ep_launches`` for the
training kernels of phase 29's (a) arms and (b)'s two ranks, whose (c)
rows join ``tp_shapes``; ``tpf_launches`` for the training kernels of
phase 30's (a) arms, (b)'s reference and its four ranks, and on the
Adam and LayerNorm records ``tpf_shapes``, the times at a rank's
shapes; ``tsp_launches`` for the kernels of phase 31's (b) arms, (c)'s
reference and ranks and (d)'s plain model and ranks, and on the flash
and LayerNorm records ``tsp_shapes``, (a)'s times at a rank's shapes;
``sim_launches`` for the serving kernels of phase 32 (a)'s real replays;
``chaos_launches`` for Adam over (d)'s two incarnations), the card's
name and power limit, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import gc
import itertools
import json
import math
import shutil
import socket
import subprocess
import sys
import time
import warnings
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12        # H100 SXM
BF16_FLOPS_PER_S = 989e12        # H100 SXM, dense
F32_FLOPS_PER_S = 67e12          # H100 SXM, f32 outside the tensor cores

DECODE_TOL = 2e-2     # bf16: the plain version rounds logits and weights
WINDOW_TOL = 2e-2
LN_TOL = 1e-2         # about one bf16 ulp at unit scale
F32_TOL = 1e-4        # f32: summation order only
# flash attention, relative to the output's scale (tol * max(1, max|want|)):
# in bf16 both sides compute in f32 from the same inputs and round once
# (one bf16 ulp is 2**-8 relative); in f32 summation order only
FLASH_BF16_TOL = 1e-2
FLASH_F32_TOL = 1e-4
ADAM_TOL = 1e-6       # f32, |values| <= a few: a contracted multiply-add
# paged attention over an int8 pool, relative to the output's scale
# (tol * max(1, max|want|)): both sides dequantize and attend in f32; the
# kernel folds each scale into the logit and the softmax weight (another
# rounding order), so f32 queries agree to round-off and bf16 queries to
# about one bf16 ulp (2**-8) of the single final rounding
INT8_BF16_TOL = 1e-2
INT8_F32_TOL = 1e-4
RMS_TOL = 1e-2        # bf16: about one bf16 ulp at unit scale
# bf16 RMSNorm, every case: each element within one bf16 ulp of the plain
# one (at the prompt prefill's rows the outputs reach |4|-|8|, where one
# ulp is 2^-5 and RMS_TOL, set at unit scale, no longer covers it)
RMS_ULPS = 1.0
# RMSNorm at the prefill's rows timed cold: x/out pairs of 16.8 MB each
# in turn, 201 MB in all, four times the 50 MB L2
RMS_COLD_PAIRS = 6
# card vs CPU Llama logits with int8 pools written on each side: an f32
# round-off difference may flip one int8 rounding by a step of amax/127;
# one such flip moved a 2-layer model's logits by ~1e-5 in a CPU trial,
# so 1e-3 leaves room for ~100 flips while a wrong kernel is off by O(0.1)
INT8_REF_LOGIT_TOL = 1e-3
TRAIN_LOSS_TOL = 1e-4     # card vs CPU, f32 losses: summation order
# card vs CPU, f32 parameters after 3 Adam steps at lr 1e-4: an element
# whose gradient is ~0 may step by up to 2 lr differently per step
TRAIN_PARAM_TOL = 1e-3

TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR = 48, 256, 1e-4
TRAIN_WARMUP, TRAIN_STEPS = 2, 10

# the training session (phase 17), GPT-2 small at phase 6's batch: arms
# (a)-(d) take 2 warm-up and 4 timed steps; the chunked head takes 1024
# tokens at a time (the JAX bench row's lever); (d) accumulates 4
# microbatches, (e)/(f) 2; the session saves every 5 steps, (e) stops at
# step 10 and (f) resumes to step 15, against an uninterrupted run of 15
SESSION_WARMUP, SESSION_STEPS, SESSION_CHUNK = 2, 4, 1024
SESSION_ACCUM, SESSION_E_ACCUM = 4, 2
SESSION_EVERY, SESSION_STOP, SESSION_END = 5, 10, 15
# the session's loss scale starts at 2**127: its batches carry a loss
# mask of ones, so accumulation weights each microbatch's scaled
# gradients by its 6,144 tokens, and those products overflow until the
# scale has halved to about 2**120 (without a mask no gradient of GPT-2
# small overflows at 2**127; only the scaled loss does, and the step
# reports the loss itself)
SESSION_SCALE = 2.0 ** 127
# (d) against phase 6 on the same batch and weights, bf16: the first
# loss (before any update) differs only by the GEMMs' tiling at 12 rows
# against 48 (each bf16 output rounded once, averaged over 12,288
# tokens); later steps also by Adam steps taken from those gradients.
# The sound runs on the H100 read 0.0 for the first loss and at most
# 8.6e-4 over the 6 steps (every run alike); the limits are about 3x
# that, so an accumulation that keeps only the last microbatch's
# gradients fails them (planted once on the card; PERF.md)
ACCUM_FIRST_TOL, ACCUM_LOSS_TOL = 1e-4, 3e-3

# example.py's XOR MLP (phase 18): its leaf shapes (Adam launches one
# kernel each a step), its batch and epoch; the entry point runs
# XOR_EPOCHS (the reference's default) when one measured epoch says that
# (c) and (d) fit XOR_BUDGET_S, else XOR_EPOCHS_SHORT (6,000 steps; the
# JAX package's convergence test passes 0.95 in about 9,600; the card's
# runs passed it at epoch 5 and read 0.976 at epoch 10; 8 since phase 31
# came, when a whole run took 1,127 s on a slow host with 10; 7 since phase
# 32, when one took 1,241 s on a slower host: the 6th epoch's print read
# over 0.95 in every run); the last val
# accuracy must pass XOR_ACC
# (the reference's oracle, tests/test_convergence.py).  The budget keeps
# the whole script near half its time limit: 50 epochs took 106 s of an
# 806 s run on an H100 (PERF.md), at ~2.1 s an epoch, so the short
# run is the one taken there
XOR_SHAPES = ((64, 128), (128,), (128, 128), (128,), (128, 32), (32,))
# the busy-share probes of phases 18 (c) and 19 (c), (d) profile the first
# 1 / PROBE_PROFILED_PART of an epoch's steps (the whole epoch until PR
# 18; a quarter until phase 32 needed the room): the profiler's recording
# and key_averages cost tens of seconds a 600-step epoch, and the steps of
# an epoch are alike
PROBE_PROFILED_PART = 8
XOR_BATCH, XOR_STEPS_PER_EPOCH = 50, 600
XOR_EPOCHS, XOR_EPOCHS_SHORT, XOR_BUDGET_S, XOR_ACC = 50, 7, 60.0, 0.95
# (b) card against CPU in f32 with TF32 off, 20 steps of adam(1e-3):
# losses within 1e-6 relative (summation order in the GEMMs and the
# mean), parameters within 1e-5 absolute; (e) the data-parallel step at
# world size 1 against (b)'s card run after 10 steps
XOR_REF_STEPS, XOR_DP_STEPS = 20, 10
XOR_LOSS_RTOL, XOR_PARAM_TOL, XOR_DP_TOL = 1e-6, 1e-5, 1e-6

# the high-level tier (phase 19): the CIFAR CNN's 12 and the MNIST MLP's
# 4 leaf shapes (Adam launches one kernel each a step); the entry points'
# batches and epochs (outline_keras's 10 epochs, outline_tensorflow's 5);
# the synthetic-data gates of the JAX package's bench (bench.py:626 CIFAR
# 0.35, :825 MNIST 0.9) and the XOR oracle; (b) the CNN's convolutions
# alone against f64 at the main path's batch within CONV_TOL (relative
# to the largest value; the sound modes read at most 2.1e-6, the TF32
# control 3.6e-5-7.7e-4); then card against CPU at batch 64 from the
# card's weights: the first loss within SEQ_CNN_LOSS_RTOL (sound 8.7e-8,
# control 5.7e-5) and the first gradients, with the CPU given the card's
# ReLU masks, within SEQ_GRAD_TOL (relative to each leaf's largest;
# sound <= 4.2e-6, control 2.5e-2); one pre-activation on the other side
# of its kink (measured: 1 of 1.2M at conv2d_2) moves the gradients below
# it by 4e-3 and sends the 5 adam() steps apart, so those are held to
# limits that catch a card that does not train alike (a step that does
# not update reads 1.0, an lr off by 2x 0.5) but not precision: losses
# within SEQ_STEPS_LOSS_RTOL (sound 2.1e-3), each leaf's change over the
# 5 steps within SEQ_UPDATE_TOL (relative L2; sound 9.3e-2); the MNIST
# MLP (no kink flips: its losses and parameters read 2.1e-7 and 1.4e-7)
# within SEQ_LOSS_RTOL and SEQ_PARAM_TOL absolute, well below lr 1e-3;
# (f) K of steps_per_execution against 1
CIFAR_SHAPES = ((3, 3, 3, 32), (32,), (3, 3, 32, 32), (32,),
                (3, 3, 32, 64), (64,), (3, 3, 64, 64), (64,), (4096, 256),
                (256,), (256, 10), (10,))
MNIST_SHAPES = ((784, 128), (128,), (128, 10), (10,))
# (d) outline_keras runs CIFAR_EPOCHS of its epochs (10 until phase 27 came
# and needed the room: the 4th epoch's val accuracy read 0.9812 against
# the gate's 0.35 on an H100 80GB HBM3; 4 until phase 29 needed more, 3
# until phase 31 did: the 2nd read 0.9519; 2 until phase 32 did: the 2nd
# read 0.9618)
CIFAR_BATCH, CIFAR_EPOCHS, MNIST_BATCH, MNIST_EPOCHS = 256, 1, 1024, 5
CIFAR_ACC, MNIST_ACC = 0.35, 0.9
SEQ_REF_STEPS, SEQ_REF_BATCH = 5, 64
# (c) example2's entry point runs EX2_EPOCHS of its 50 (the first epoch
# past 0.95 was the 6th in every card run, and the 10th read 0.976; 50
# took 98 s, 20 took 46-63 s; 10 until phase 27 needed the room, 8 until
# phase 31 did: the 7th read 0.9673 on an H100 80GB HBM3)
EX2_EPOCHS = 7
CONV_TOL, SEQ_GRAD_TOL, SEQ_CNN_LOSS_RTOL = 1e-5, 3e-5, 1e-5
SEQ_STEPS_LOSS_RTOL, SEQ_UPDATE_TOL = 1e-2, 0.3
SEQ_LOSS_RTOL, SEQ_PARAM_TOL = 1e-5, 1e-5
SPE_K = 8

# the Llama-3-8B engine: 8 slots of 8192 tokens in pages of 16
LLAMA_SLOTS, LLAMA_MAX_LEN, LLAMA_PAGE = 8, 8192, 16

# single-stream decoding on the contiguous cache: GPT-2 small generates
# 4 prompts of 256 + 64 new (GPT-2's <|endoftext|> as EOS), beams 2
# prompts of 128 + 32 at beam 4, speculates 1 prompt of 256 + 64 at
# gamma 4 with a draft of the target's first 2 layers; Llama-3-8B
# generates 4 prompts of 512 + 32 into an int8 cache
GEN_BATCH, GEN_PROMPT, GEN_NEW, GPT2_EOS = 4, 256, 64, 50256
BEAM_BATCH, BEAM_PROMPT, BEAM_NEW, BEAM_SIZE = 2, 128, 32, 4
SPEC_GAMMA, SPEC_DRAFT_LAYERS = 4, 2
LLAMA_GEN_BATCH, LLAMA_GEN_PROMPT, LLAMA_GEN_NEW = 4, 512, 32
# decode_block (the flash forward over the block) against one
# decode_window over the same prompt (dense attention read back from the
# cache), GPT-2 small in bf16, last-position logits, relative to
# max(1, max |logit|): each path rounds its bf16 activations on its own
# (2**-8 relative a rounding) through 12 layers; a wrong kernel is off by
# the logits' own scale
BLOCK_WINDOW_TOL = 5e-2

# the serve surface (phase 16): 3 LoRA adapters of rank 16 in a table of
# 4 rows, a from init_lora (truncated normal, std 0.02), b ~ N(0, 1), so
# that a delta (~0.08 an entry) outweighs the random kernels' 0.02 and
# changes tokens; the admission engine's queue bound; page-wire frames
# of 4 pages; engine B's pool, twice the default so that no shipped
# chain is evicted before its request is admitted
SERVE_ADAPTERS, SERVE_CAPACITY, SERVE_RANK, LORA_B_STD = 3, 4, 16, 1.0
SERVE_QUEUE_DEPTH, WIRE_FRAME_PAGES = 6, 4

# the sight and the survival of both main paths (phase 20): (a) a
# supervised GPT-2-small session at phase 6's batch to OBS_LAST, saving
# every OBS_EVERY steps; its plan fails the first save, truncates the
# checkpoint of the next good save but one (step 2 * OBS_EVERY), NaNs the
# steps from OBS_NAN so that NonfiniteGuardHook(3) trips before the next
# save, and kills the prefetch producer at batch OBS_KILL_BATCH: the
# first two attempts consume OBS_EVERY + OBS_NAN + 3 = 18 batches and
# their producers call the plan at most 2 + 1 ahead each, so the third
# attempt always reaches it; backoff from OBS_BACKOFF_S.  (c) phase 4's
# engine fails request OBS_FAIL_RID at its first delivery and stalls tick
# OBS_STALL_TICK by OBS_STALL_S.  (d) OBS_PAIR_STEPS steps a session arm
# (8 until phase 32 needed the room; OBS_EVERY, so that the metrics
# export runs once in each arm with the hooks on, as it did),
# OBS_BUSY_STEPS under the profiler (its processing of 8 steps took ~60 s)
OBS_LAST, OBS_EVERY, OBS_NAN, OBS_KILL_BATCH = 20, 5, 10, 25
OBS_BACKOFF_S = 0.05
OBS_FAIL_RID, OBS_STALL_TICK, OBS_STALL_S = 4, 3, 0.05
OBS_PAIR_STEPS, OBS_BUSY_STEPS = OBS_EVERY, 2

# the serving fleet (phase 21): FLEET_REPLICAS engines of phase 4's shape
# share phase 4's model.  (a) phase 4's mix drawn FLEET_MIXES times;
# the adversarial tenant mix of the JAX package's fleet bench (equal
# demand of FLEET_DEMAND tokens for each tenant's block, in that order,
# prompts of 3-64 tokens, pro under a rank-SERVE_RANK adapter,
# TenantPolicy(quantum=FLEET_QUANTUM)).  (b) the page wire in frames of
# FLEET_WIRE_PAGES pages, a flight of one, FLEET_WIRE_TIMEOUT_S a
# flight, the stalled frame late by FLEET_WIRE_STALL_S; replica 1 is
# killed once FLEET_KILL_ACTIVE of its requests decode.  (c) the
# watchdog's deadline; replica 2's tick FLEET_STALL_TICK stalls
# FLEET_STALL_S, replica 0's tick FLEET_WEDGE_TICK wedges, over
# FLEET_WD_REQUESTS requests of one prefill window and 48-64 new tokens
# (their ticks read 0.11-0.15 s at most in a probe with prompts of up to
# two windows, and one such tick took 0.33 s in a full run on a slower
# host: a false stall at the 0.25 s deadline).  (e) a synthesized trace of
# FLEET_TRACE_N requests over FLEET_TRACE_S seconds of a virtual clock
# that advances FLEET_STEP_S a router step, one burst; the autoscaler
# evaluates every FLEET_EVAL_S virtual seconds
FLEET_REPLICAS, FLEET_MIXES = 3, 2
FLEET_DEMAND, FLEET_QUANTUM = 240, 8
FLEET_TENANTS = {"free": (2, 5), "pro": (5, 9), "batch": (10, 16)}
FLEET_WIRE_PAGES, FLEET_WIRE_TIMEOUT_S, FLEET_WIRE_STALL_S = 2, 0.2, 0.3
FLEET_KILL_ACTIVE = 2
FLEET_WD_DEADLINE_S, FLEET_STALL_TICK, FLEET_STALL_S = 0.25, 3, 0.6
FLEET_WEDGE_TICK, FLEET_WD_REQUESTS = 5, 6
FLEET_TRACE_N, FLEET_TRACE_S, FLEET_STEP_S, FLEET_EVAL_S = 64, 40.0, 0.25, 1.0


_T0 = time.perf_counter()


def log(obj) -> None:
    """One line of the log; a dict gets ``t_s``, the seconds since the
    script started."""
    if isinstance(obj, dict):
        obj = json.dumps(dict(obj, t_s=round(time.perf_counter() - _T0, 3)))
    print(obj, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` launches (CUDA events,
    after warm-up)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(torch, fn, iters: int) -> float:
    """Device time per call of ``fn`` with the host out of the way: after
    a warm-up on the capture stream, ``iters`` calls captured in one CUDA
    graph; CUDA events around one replay, divided by ``iters``."""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, stream=s):
        for _ in range(iters):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    g.replay()
    end.record()
    end.synchronize()
    del g
    return start.elapsed_time(end) / iters


def rotating(fn, inputs):
    """A call that applies ``fn`` to the next of ``inputs`` in turn and
    keeps its output until that input comes round again, so that inputs
    and outputs both rotate over ``len(inputs)`` buffers: passed to
    ``graph_ms``, each call finds its data cold once they exceed the
    50 MB L2."""
    outs = [None] * len(inputs)
    turn = [0]

    def call():
        i = turn[0] = (turn[0] + 1) % len(inputs)
        outs[i] = None
        outs[i] = fn(inputs[i])
    return call


def _graph_or_why(torch, fn, iters):
    """(graph_ms, None), or (None, why) for a library call that cannot be
    captured; used for yardsticks only, never for the port's kernels."""
    try:
        return graph_ms(torch, fn, iters), None
    except RuntimeError as e:
        torch.cuda.synchronize()
        return None, f"{type(e).__name__}: {str(e).splitlines()[0][:200]}"


# SDPA's autograd backwards, timed from a CUDA graph at the end of the run
# (a capture that failed could leave the context unusable, so nothing
# runs on the card after them): (label, forward, inputs, dO)
_LIB_BACKWARDS = []


def _autograd_graph_ms(torch, fwd, inputs, dout, iters):
    """Device time of one ``torch.autograd.grad`` through ``fwd()``'s
    graph, replayed from a CUDA graph of ``iters`` calls: the forward runs
    on the capture stream, so autograd runs the backward there too, as
    ``torch.cuda.make_graphed_callables`` captures it."""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        out = fwd()

        def call():
            return torch.autograd.grad(out, inputs, dout, retain_graph=True)
        for _ in range(3):
            call()
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, stream=s):
        for _ in range(iters):
            call()
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    g.replay()
    end.record()
    end.synchronize()
    del g
    return start.elapsed_time(end) / iters


def time_library_backwards(torch, args, smi):
    """The library graph ms of every backward registered in
    ``_LIB_BACKWARDS`` (the zoo's whole-backward rows of phase 22, the
    ring's block routes of phase 25): {label: ms or None}.  The last card
    work of the run; after a failed capture the rest are skipped."""
    out = {}
    iters = max(20, args.iters // 4)
    for label, fwd, inputs, dout in _LIB_BACKWARDS:
        try:
            out[label] = _autograd_graph_ms(torch, fwd, inputs, dout, iters)
            note = None
        except RuntimeError as e:
            out[label] = None
            note = f"{type(e).__name__}: {str(e).splitlines()[0][:200]}"
        log({"time": "library backward graph", "case": label,
             "library_graph_ms": out[label], "note": note,
             "library": "autograd backward of F.scaled_dot_product_attention"
                        " (dq, dk, dv) replayed from a CUDA graph",
             "card": smi})
        if note is not None:
            break
    _LIB_BACKWARDS.clear()
    return out


def bound_ms(nbytes: float, flops: float, flops_per_s=BF16_FLOPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def _decode_variants(torch, pa, q, kv, tab, valid, nxt, iters):
    """The decode kernel's split plan for these shapes, and its graph time
    at a forced single split, beside the planned launch's record."""
    B, _, h, _ = q.shape
    kvh = kv["k"].shape[3]
    tc = pa.tensor_cores(q.dtype == torch.bfloat16, "k_scale" in kv, False)
    _, splits, per = pa.launch_plan(B, 1, h, kvh, tab.shape[1] * kv[
        "k"].shape[2], tc, q.get_device())
    return {"route": "tensor_cores" if tc else "cuda_cores",
            "splits": splits, "subtiles_per_split": per,
            "graph_ms_one_split": graph_ms(torch, lambda: pa._launch(
                q, kv, nxt(), tab, valid, 0, window=False, scale=None,
                splits=1), iters)}


def log_backward_resources(_build) -> None:
    """Registers, stack and spill bytes (``ptxas -v`` at the build) and
    dynamic shared memory a block of the bf16 and f32 flash backward
    kernels, at head dims 64 and 128; registers and spills of every
    RMSNorm instantiation, none of which may spill."""
    import ctypes
    smem = _build.bind("flash_attention", "flash_smem_bytes",
                       [ctypes.c_int] * 3)
    which = {"dq": 1, "dkv": 2}
    kernels = {}
    for name, info in _build.ptxas_report("flash_attention").items():
        part = next((w for w in which if f"flash_{w}_" in name), None)
        if part is None:
            continue
        hd = int(name[name.index("<") + 1:-1])
        info = dict(info, dynamic_smem_bytes=smem(
            which[part], int("mma" in name), hd))
        kernels[name] = info
    log({"phase": "ptxas", "source": "flash_attention.cu",
         "kernels": kernels})
    norms = _build.ptxas_report("rmsnorm")
    log({"phase": "ptxas", "source": "rmsnorm.cu", "kernels": norms})
    spills = [k for k, v in norms.items()
              if v.get("spill_stores") or v.get("spill_loads")]
    if spills:
        raise AssertionError(f"rmsnorm kernels spill: {spills}")


def check_kernels(torch, args):
    """Phase 3: returns {kernel name: record} for the kernels line."""
    import torch.nn.functional as F

    from distributed_tensorflow_tpu_torch.ops.kernels import fused
    from distributed_tensorflow_tpu_torch.ops.kernels import \
        paged_attention as pa

    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(args.seed)
    L, h, kvh, hd, pg, P, S = 12, 12, 12, 64, 16, 64, 8
    NP = S * P + 1                     # the engine's default pool
    view_len = P * pg
    records = {}

    def pool(dtype):
        shape = (L, NP, pg, kvh, hd)
        return {k: torch.randn(shape, generator=gen, device=dev,
                               dtype=torch.float32).to(dtype)
                for k in ("k", "v")}

    # --- paged decode: ragged rows, two rows wholly on the trash page
    perm = torch.randperm(NP - 1, generator=gen, device=dev) + 1
    tab = perm[:S * P].reshape(S, P).to(torch.int32)
    tab[3] = 0
    tab[6] = 0
    lengths = torch.tensor([37, 300, 1000, 5, 513, 64, 129, 777],
                           device=dev)
    starts = torch.tensor([0, 0, 16, 0, 100, 0, 0, 3], device=dev)
    cols = torch.arange(view_len, device=dev)[None, :]
    valid = ((cols >= starts[:, None]) & (cols < lengths[:, None]))
    valid = valid.contiguous()
    kv = pool(torch.bfloat16)
    q = torch.randn(S, 1, h, hd, generator=gen, device=dev).to(
        torch.bfloat16)
    err = 0.0
    for layer in (0, 5, 11):
        got = pa.paged_decode_attention(q, kv, layer, tab, valid)
        want = pa.paged_decode_attention_plain(q, kv, layer, tab, valid)
        err = max(err, (got.float() - want.float()).abs().max().item())
    log({"check": "paged_decode_attention", "dtype": "bf16",
         "max_abs_err": err, "tol": DECODE_TOL})
    if not err <= DECODE_TOL:
        raise AssertionError(f"paged decode kernel disagrees: {err}")
    kv32 = {k: v.float() for k, v in kv.items()}
    q32 = q.float()
    got = pa.paged_decode_attention(q32, kv32, 7, tab, valid)
    want = pa.paged_decode_attention_plain(q32, kv32, 7, tab, valid)
    err32 = (got - want).abs().max().item()
    log({"check": "paged_decode_attention", "dtype": "f32",
         "max_abs_err": err32, "tol": F32_TOL})
    if not err32 <= F32_TOL:
        raise AssertionError(f"paged decode kernel (f32) disagrees: {err32}")
    del kv32, q32

    layers = iter(range(10 ** 9))

    def nxt():
        return next(layers) % L

    def sdpa_decode():
        k, v = pa.paged_layer_kv(kv, nxt(), tab)
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=valid[:, None, None, :])

    ms = time_ms(torch, lambda: pa.paged_decode_attention(
        q, kv, nxt(), tab, valid), args.iters)
    plain = time_ms(torch, lambda: pa.paged_decode_attention_plain(
        q, kv, nxt(), tab, valid), args.iters)
    lib = time_ms(torch, sdpa_decode, args.iters)
    g_ms = graph_ms(torch, lambda: pa.paged_decode_attention(
        q, kv, nxt(), tab, valid), args.iters)
    g_lib = graph_ms(torch, sdpa_decode, args.iters)
    # what these inputs need: each pool page some valid column of a row
    # maps, read once per leaf; q, the table, the valid plane, the output
    n_valid = int(valid.sum())
    pages = torch.unique(tab.long().repeat_interleave(pg, dim=1)[valid])
    nbytes = (pages.numel() * pg * kvh * hd * 2 * 2 + 2 * S * h * hd * 2
              + S * P * 4 + S * view_len)
    flops = 4.0 * n_valid * h * hd
    b_ms, b_by = bound_ms(nbytes, flops)
    records["paged_decode_attention"] = dict(
        source="distributed_tensorflow_tpu_torch/csrc/paged_attention.cu",
        replaces="distributed_tensorflow_tpu/ops/pallas/paged_attention.py:226",
        max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
        library_ms=lib, graph_ms=g_ms, library_graph_ms=g_lib)
    log({"time": "paged_decode_attention", "shape": "q[8,1,12,64] "
         "pool[12,513,16,12,64] bf16", "valid_cols": n_valid,
         "kernel_ms": ms, "plain_ms": plain, "library_ms": lib,
         "graph_ms": g_ms, "library_graph_ms": g_lib,
         "bound_ms": b_ms, "bound_by": b_by,
         **_decode_variants(torch, pa, q, kv, tab, valid, nxt, args.iters)})

    # --- paged window: one row, 32 queries, pos in {0, 96, 500}
    row = perm[-P:].to(torch.int32).contiguous()
    qw = torch.randn(1, 32, h, hd, generator=gen, device=dev).to(
        torch.bfloat16)
    werr = 0.0
    for pos in (0, 96, 500):
        got = pa.paged_window_attention(qw, kv, 3, row, pos)
        want = pa.paged_window_attention_plain(qw, kv, 3, row, pos)
        e = (got.float() - want.float()).abs().max().item()
        log({"check": "paged_window_attention", "pos": pos, "dtype": "bf16",
             "max_abs_err": e, "tol": WINDOW_TOL})
        werr = max(werr, e)
    if not werr <= WINDOW_TOL:
        raise AssertionError(f"paged window kernel disagrees: {werr}")
    pos = 500
    wcol = torch.arange(view_len, device=dev)[None, :]
    wmask = (wcol <= pos + torch.arange(32, device=dev)[:, None])[None, None]

    def sdpa_window():
        k, v = pa.paged_layer_kv(kv, nxt(), row[None, :])
        return F.scaled_dot_product_attention(
            qw.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=wmask)

    ms = time_ms(torch, lambda: pa.paged_window_attention(
        qw, kv, nxt(), row, pos), args.iters)
    plain = time_ms(torch, lambda: pa.paged_window_attention_plain(
        qw, kv, nxt(), row, pos), args.iters)
    lib = time_ms(torch, sdpa_window, args.iters)
    g_ms = graph_ms(torch, lambda: pa.paged_window_attention(
        qw, kv, nxt(), row, pos), args.iters)
    g_lib = graph_ms(torch, sdpa_window, args.iters)
    last_col = min(pos + 31, view_len - 1)
    n_pages = len(set(row[:last_col // pg + 1].tolist()))
    nbytes = n_pages * pg * kvh * hd * 2 * 2 + 2 * 32 * h * hd * 2 + P * 4
    flops = 4.0 * sum(min(pos + j + 1, view_len) for j in range(32)) * h * hd
    b_ms, b_by = bound_ms(nbytes, flops)
    records["paged_window_attention"] = dict(
        source="distributed_tensorflow_tpu_torch/csrc/paged_attention.cu",
        replaces="distributed_tensorflow_tpu/ops/pallas/paged_attention.py:226",
        max_abs_err=werr, ms=ms, plain_ms=plain, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib, graph_ms=g_ms, library_graph_ms=g_lib)
    log({"time": "paged_window_attention", "shape": "q[1,32,12,64] pos 500",
         "kernel_ms": ms, "plain_ms": plain, "library_ms": lib,
         "graph_ms": g_ms, "library_graph_ms": g_lib,
         "bound_ms": b_ms, "bound_by": b_by})
    del kv

    # --- LayerNorm at the decode path's prompt prefills' rows (generate,
    # beam), the window's and the decode tick's; the decode tick's [8,
    # 768] is the record, held to F.layer_norm's times
    d = 768
    gamma = 1 + 0.1 * torch.randn(d, generator=gen, device=dev)
    beta = 0.1 * torch.randn(d, generator=gen, device=dev)
    lerr = 0.0
    for rows in (GEN_BATCH * GEN_PROMPT, BEAM_BATCH * (BEAM_PROMPT - 1),
                 256, 32, 8):
        x = (torch.randn(rows, d, generator=gen, device=dev) * 2 + 0.5).to(
            torch.bfloat16)
        got = fused.fused_layernorm(x, gamma, beta, 1e-5)
        want = fused.layernorm_plain(x, gamma, beta, 1e-5)
        e = (got.float() - want.float()).abs().max().item()
        g16, b16 = gamma.to(torch.bfloat16), beta.to(torch.bfloat16)

        def kern():
            return fused.fused_layernorm(x, gamma, beta, 1e-5)

        def library():
            return F.layer_norm(x, (d,), g16, b16, 1e-5)
        ms = time_ms(torch, kern, args.iters)
        plain = time_ms(torch, lambda: fused.layernorm_plain(
            x, gamma, beta, 1e-5), args.iters)
        lib = time_ms(torch, library, args.iters)
        g_ms = graph_ms(torch, kern, args.iters)
        g_lib = graph_ms(torch, library, args.iters)
        b_ms, b_by = bound_ms(rows * d * 2 * 2 + d * 4 * 2, 8.0 * rows * d)
        log({"check": "layernorm", "shape": [rows, d], "dtype": "bf16",
             "max_abs_err": e, "tol": LN_TOL, "kernel_ms": ms,
             "plain_ms": plain, "library_ms": lib, "graph_ms": g_ms,
             "library_graph_ms": g_lib, "library": "F.layer_norm",
             "ms_vs_library": ms / lib, "graph_ms_vs_library": g_ms / g_lib,
             "bound_ms": b_ms, "bound_by": b_by})
        lerr = max(lerr, e)
        if rows == 8:
            records["layernorm"] = dict(
                source="distributed_tensorflow_tpu_torch/csrc/layernorm.cu",
                replaces="distributed_tensorflow_tpu/ops/pallas/fused.py:161",
                max_abs_err=lerr, ms=ms, plain_ms=plain, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib, graph_ms=g_ms,
                library_graph_ms=g_lib)
    if not lerr <= LN_TOL:
        raise AssertionError(f"layernorm kernel disagrees: {lerr}")
    records["layernorm"]["max_abs_err"] = lerr
    torch.cuda.synchronize()
    return records


def check_llama_kernels(torch, args):
    """Phase 3, the Llama-3-8B serving kernels: returns {kernel name:
    record} for RMSNorm and the int8 paged entries, and checks (and
    times, without a record) the bf16 GQA head-dim-128 paged case."""
    import torch.nn.functional as F

    from distributed_tensorflow_tpu_torch.ops import quant
    from distributed_tensorflow_tpu_torch.ops.kernels import fused
    from distributed_tensorflow_tpu_torch.ops.kernels import \
        paged_attention as pa

    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(args.seed + 2)
    records = {}
    site = "distributed_tensorflow_tpu/ops/pallas/"

    # --- RMSNorm at the prompt prefill's, the window's and the decode
    # tick's rows, and f32
    d = 4096
    gamma = 1 + 0.1 * torch.randn(d, generator=gen, device=dev)
    rerr = 0.0
    for rows, dtype in ((LLAMA_GEN_BATCH * LLAMA_GEN_PROMPT, torch.bfloat16),
                        (32, torch.float32), (32, torch.bfloat16),
                        (8, torch.bfloat16)):
        x = (torch.randn(rows, d, generator=gen, device=dev) * 2 + 0.5).to(
            dtype)
        got = fused.fused_rmsnorm(x, gamma, 1e-5)
        want = fused.rmsnorm_plain(x, gamma, 1e-5)
        e = (got.float() - want.float()).abs().max().item()
        tol = RMS_TOL if dtype == torch.bfloat16 else F32_TOL
        # the prefill's rows: one bf16 ulp an element; the decode tick's
        # and the window's (unit scale): RMS_TOL, and one ulp as well
        ulps = _bf16_ulps(torch, got, want) \
            if dtype == torch.bfloat16 else 0.0
        prefill = rows > 32
        if not ((prefill or e <= tol) and ulps <= RMS_ULPS):
            raise AssertionError(f"rmsnorm kernel disagrees ({rows}, "
                                 f"{dtype}): {e} ({ulps} bf16 ulps)")
        g_lib = gamma.to(dtype)
        ms = time_ms(torch, lambda: fused.fused_rmsnorm(x, gamma, 1e-5),
                     args.iters)
        plain = time_ms(torch, lambda: fused.rmsnorm_plain(x, gamma, 1e-5),
                        args.iters)
        lib = time_ms(torch, lambda: F.rms_norm(x, (d,), g_lib, 1e-5),
                      args.iters)
        g_ms = graph_ms(torch, lambda: fused.fused_rmsnorm(x, gamma, 1e-5),
                        args.iters)
        g_libms = graph_ms(torch, lambda: F.rms_norm(x, (d,), g_lib, 1e-5),
                           args.iters)
        size = x.element_size()
        b_ms, b_by = bound_ms(rows * d * size * 2 + d * 4, 4.0 * rows * d)
        cold = {}
        if prefill:
            # the prefill's rows fit the L2 (33.5 MB in and out), so the
            # warm graph above replays them from it; here each call finds
            # x and out cold: RMS_COLD_PAIRS pairs in turn (> 100 MB)
            xs = [(torch.randn(rows, d, generator=gen, device=dev) * 2
                   + 0.5).to(dtype) for _ in range(RMS_COLD_PAIRS)]
            c_ms = graph_ms(torch, rotating(
                lambda xi: fused.fused_rmsnorm(xi, gamma, 1e-5), xs),
                args.iters)
            c_lib = graph_ms(torch, rotating(
                lambda xi: F.rms_norm(xi, (d,), g_lib, 1e-5), xs),
                args.iters)
            # the same rotation through back-to-back calls, the host's
            # issue time included (the cold row's ms and library ms)
            c_call = time_ms(torch, rotating(
                lambda xi: fused.fused_rmsnorm(xi, gamma, 1e-5), xs),
                args.iters)
            c_lib_call = time_ms(torch, rotating(
                lambda xi: F.rms_norm(xi, (d,), g_lib, 1e-5), xs),
                args.iters)
            # what the card takes to move the same bytes with no
            # arithmetic: a copy of x, over the same rotation
            c_copy = graph_ms(torch, rotating(torch.clone, xs), args.iters)
            cold = {"cold_pairs": len(xs),
                    "cold_mb": 2 * len(xs) * x.numel() * size / 1e6,
                    "ms_cold": c_call, "library_ms_cold": c_lib_call,
                    "graph_ms_cold": c_ms, "library_graph_ms_cold": c_lib,
                    "copy_graph_ms_cold": c_copy,
                    "graph_ms_cold_vs_library": c_ms / c_lib,
                    "graph_ms_cold_vs_copy": c_ms / c_copy,
                    "bound_share_cold": b_ms / c_ms,
                    "bound_share_warm": b_ms / g_ms}
            del xs
        log({"check": "rmsnorm", "shape": [rows, d], "dtype": str(dtype),
             "max_abs_err": e, "tol": "1 bf16 ulp" if prefill else tol,
             "max_bf16_ulps": ulps, "kernel_ms": ms,
             "plain_ms": plain, "library_ms": lib, "graph_ms": g_ms,
             "library_graph_ms": g_libms, "library": "F.rms_norm",
             "ms_vs_library": ms / lib, "graph_ms_vs_library": g_ms / g_libms,
             "bound_ms": b_ms, "bound_by": b_by, **cold})
        if dtype == torch.bfloat16:
            rerr = max(rerr, e)
        if rows == 8:
            records["rmsnorm"] = dict(
                source="distributed_tensorflow_tpu_torch/csrc/rmsnorm.cu",
                replaces=site + "fused.py:240", max_abs_err=rerr, ms=ms,
                plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=lib,
                graph_ms=g_ms, library_graph_ms=g_libms)

    # --- the pool: Llama-3-8B's kv heads and head dim, pages of 16, 8
    # slots of 8192 columns (the engine's default pool), 4 layers so the
    # timing loop reads a cold layer each launch
    L, h, kvh, hd, pg, S = 4, 32, 8, 128, LLAMA_PAGE, LLAMA_SLOTS
    P = LLAMA_MAX_LEN // pg
    NP = S * P + 1
    view_len = P * pg
    shape = (L, NP, pg, kvh, hd)
    kv8, kv16 = {}, {}
    for name in ("k", "v"):
        x = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        qt = quant.quantize_tensor(x, reduce_axes=(-1,))   # the KV write
        kv16[name] = x
        kv8[name], kv8[name + "_scale"] = qt.q, qt.scale
        del x, qt

    # decode: 8 rows at a realistic fill (ragged lengths up to the full
    # 8192; row 4 starts late; row 6 retired onto the trash page)
    perm = torch.randperm(NP - 1, generator=gen, device=dev) + 1
    tab = perm[:S * P].reshape(S, P).to(torch.int32)
    tab[6] = 0
    lengths = torch.tensor([296, 1200, 2500, 4000, 700, 8192, 150, 5000],
                           device=dev)
    starts = torch.tensor([0, 0, 0, 0, 48, 0, 0, 0], device=dev)
    cols = torch.arange(view_len, device=dev)[None, :]
    valid = ((cols >= starts[:, None]) & (cols < lengths[:, None]))
    valid = valid.contiguous()
    q = torch.randn(S, 1, h, hd, generator=gen, device=dev).to(
        torch.bfloat16)
    layers = iter(range(10 ** 9))

    def nxt():
        return next(layers) % L

    n_valid = int(valid.sum())
    pages = torch.unique(tab.long().repeat_interleave(pg, dim=1)[valid])
    cells = pages.numel() * pg * kvh
    side = 2 * S * h * hd * 2 + S * P * 4 + S * view_len
    flops = 4.0 * n_valid * h * hd

    def sdpa(qq, k, v, mask):
        return F.scaled_dot_product_attention(
            qq.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask, enable_gqa=True)

    def decode_lib(kv):
        def fn():
            k, v = pa.paged_layer_kv(kv, nxt(), tab)
            return sdpa(q, k.to(q.dtype), v.to(q.dtype),
                        valid[:, None, None, :])
        return fn

    q32 = q.float()
    err8, err8_32, scale8 = 0.0, 0.0, 1.0
    for layer in range(L):
        e, sc = _err_and_scale(torch, pa.paged_decode_attention(q, kv8, layer, tab,
                                                      valid),
                     pa.paged_decode_attention_plain(q, kv8, layer, tab,
                                                     valid))
        err8, scale8 = max(err8, e), max(scale8, sc)
    e32, sc32 = _err_and_scale(torch, pa.paged_decode_attention(q32, kv8, 1, tab,
                                                      valid),
                     pa.paged_decode_attention_plain(q32, kv8, 1, tab, valid))
    log({"check": "paged_decode_int8", "shape": "q[8,1,32,128] bf16 "
         "pool int8 [4,4097,16,8,128] + f32 scales", "max_abs_err": err8,
         "tol": INT8_BF16_TOL * scale8, "f32_max_abs_err": e32,
         "f32_tol": INT8_F32_TOL * sc32})
    if not (err8 <= INT8_BF16_TOL * scale8 and e32 <= INT8_F32_TOL * sc32):
        raise AssertionError(f"paged decode int8 kernel disagrees: {err8}, "
                             f"f32 {e32}")
    ms = time_ms(torch, lambda: pa.paged_decode_attention(
        q, kv8, nxt(), tab, valid), args.iters)
    plain = time_ms(torch, lambda: pa.paged_decode_attention_plain(
        q, kv8, nxt(), tab, valid), max(5, args.iters // 10))
    lib = time_ms(torch, decode_lib(kv8), max(5, args.iters // 10))
    g_ms = graph_ms(torch, lambda: pa.paged_decode_attention(
        q, kv8, nxt(), tab, valid), args.iters)
    g_lib = graph_ms(torch, decode_lib(kv8), max(5, args.iters // 10))
    b_ms, b_by = bound_ms(cells * (hd + 4) * 2 + side, flops)
    records["paged_decode_int8"] = dict(
        source="distributed_tensorflow_tpu_torch/csrc/paged_attention.cu",
        replaces=site + "paged_attention.py:226", max_abs_err=err8, ms=ms,
        plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=lib,
        graph_ms=g_ms, library_graph_ms=g_lib)
    log({"time": "paged_decode_int8", "shape": "q[8,1,32,128] bf16, int8 "
         "pool, max_len 8192", "valid_cols": n_valid, "kernel_ms": ms,
         "plain_ms": plain, "library_ms": lib, "graph_ms": g_ms,
         "library_graph_ms": g_lib,
         "library": "dequant + gather + F.scaled_dot_product_attention",
         "bound_ms": b_ms, "bound_by": b_by,
         **_decode_variants(torch, pa, q, kv8, tab, valid, nxt, args.iters)})

    # the bf16 GQA head-dim-128 case at the same shapes: a check and a
    # time beside the int8 branch, no record
    e16, sc16 = _err_and_scale(torch, pa.paged_decode_attention(q, kv16, 2, tab,
                                                      valid),
                     pa.paged_decode_attention_plain(q, kv16, 2, tab, valid))
    if not e16 <= DECODE_TOL:
        raise AssertionError(f"paged decode bf16 GQA hd128 disagrees: {e16}")
    ms16 = time_ms(torch, lambda: pa.paged_decode_attention(
        q, kv16, nxt(), tab, valid), args.iters)
    g16 = graph_ms(torch, lambda: pa.paged_decode_attention(
        q, kv16, nxt(), tab, valid), args.iters)
    lib16 = time_ms(torch, decode_lib(kv16), max(5, args.iters // 10))
    b16, _ = bound_ms(cells * hd * 2 * 2 + side, flops)
    log({"check": "paged_decode_bf16_gqa_hd128", "shape": "q[8,1,32,128] "
         "bf16 pool [4,4097,16,8,128] bf16", "max_abs_err": e16,
         "tol": DECODE_TOL, "kernel_ms": ms16, "graph_ms": g16,
         "library_ms": lib16, "bound_ms": b16, "int8_kernel_ms": ms,
         "int8_bound_ms": b_ms,
         **_decode_variants(torch, pa, q, kv16, tab, valid, nxt, args.iters)})

    # window: one row of 32 queries after a prefix of several pages
    row = perm[-P:].to(torch.int32).contiguous()
    qw = torch.randn(1, 32, h, hd, generator=gen, device=dev).to(
        torch.bfloat16)
    werr, wscale = 0.0, 1.0
    for pos in (0, 96, 300):
        e, sc = _err_and_scale(torch, pa.paged_window_attention(qw, kv8, 3, row, pos),
                     pa.paged_window_attention_plain(qw, kv8, 3, row, pos))
        werr, wscale = max(werr, e), max(wscale, sc)
    e32, sc32 = _err_and_scale(torch, pa.paged_window_attention(qw.float(), kv8, 0,
                                                      row, 300),
                     pa.paged_window_attention_plain(qw.float(), kv8, 0,
                                                     row, 300))
    e16, _ = _err_and_scale(torch, pa.paged_window_attention(qw, kv16, 3, row, 300),
                  pa.paged_window_attention_plain(qw, kv16, 3, row, 300))
    log({"check": "paged_window_int8", "shape": "q[1,32,32,128] bf16, pos "
         "0/96/300", "max_abs_err": werr, "tol": INT8_BF16_TOL * wscale,
         "f32_max_abs_err": e32, "f32_tol": INT8_F32_TOL * sc32,
         "bf16_pool_max_abs_err": e16, "bf16_pool_tol": WINDOW_TOL})
    if not (werr <= INT8_BF16_TOL * wscale and e32 <= INT8_F32_TOL * sc32
            and e16 <= WINDOW_TOL):
        raise AssertionError(f"paged window kernels disagree: int8 {werr}, "
                             f"f32 {e32}, bf16 pool {e16}")
    pos = 300
    wmask = (cols <= pos + torch.arange(32, device=dev)[:, None])[None, None]

    def window_lib(kv):
        def fn():
            k, v = pa.paged_layer_kv(kv, nxt(), row[None, :])
            return sdpa(qw, k.to(qw.dtype), v.to(qw.dtype), wmask)
        return fn

    ms = time_ms(torch, lambda: pa.paged_window_attention(
        qw, kv8, nxt(), row, pos), args.iters)
    plain = time_ms(torch, lambda: pa.paged_window_attention_plain(
        qw, kv8, nxt(), row, pos), max(5, args.iters // 10))
    lib = time_ms(torch, window_lib(kv8), max(5, args.iters // 10))
    ms16 = time_ms(torch, lambda: pa.paged_window_attention(
        qw, kv16, nxt(), row, pos), args.iters)
    g_ms = graph_ms(torch, lambda: pa.paged_window_attention(
        qw, kv8, nxt(), row, pos), args.iters)
    g_lib = graph_ms(torch, window_lib(kv8), max(5, args.iters // 10))
    n_pages = len(set(row[:(pos + 31) // pg + 1].tolist()))
    wside = 2 * 32 * h * hd * 2 + P * 4
    wflops = 4.0 * sum(pos + j + 1 for j in range(32)) * h * hd
    b_ms, b_by = bound_ms(n_pages * pg * kvh * (hd + 4) * 2 + wside, wflops)
    b16, _ = bound_ms(n_pages * pg * kvh * hd * 2 * 2 + wside, wflops)
    records["paged_window_int8"] = dict(
        source="distributed_tensorflow_tpu_torch/csrc/paged_attention.cu",
        replaces=site + "paged_attention.py:226", max_abs_err=werr, ms=ms,
        plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=lib,
        graph_ms=g_ms, library_graph_ms=g_lib)
    log({"time": "paged_window_int8", "shape": "q[1,32,32,128] pos 300",
         "kernel_ms": ms, "plain_ms": plain, "library_ms": lib,
         "graph_ms": g_ms, "library_graph_ms": g_lib,
         "library": "dequant + gather + F.scaled_dot_product_attention",
         "bound_ms": b_ms, "bound_by": b_by, "bf16_pool_kernel_ms": ms16,
         "bf16_pool_bound_ms": b16})
    del kv8, kv16
    torch.cuda.synchronize()
    return records


def _bf16_ulps(torch, got, want) -> float:
    """max |got - want| over the elements, each in units of its plain
    value's bf16 ulp (2^(e - 8) for |want| in [2^(e-1), 2^e))."""
    want = want.float()
    _, e = torch.frexp(want)
    ulp = torch.ldexp(torch.ones_like(want), e - 8)
    return ((got.float() - want).abs() / ulp).max().item()


def _err_and_scale(torch, got, want):
    """(max |got - want| over want's finite entries, max(1, max |want|));
    the error is inf if the two disagree on which entries are finite (a
    row with no unmasked key has lse -inf)."""
    got, want = got.float(), want.float()
    fin = torch.isfinite(want)
    if not torch.equal(torch.isfinite(got), fin):
        return float("inf"), 1.0
    if not fin.any():
        return 0.0, 1.0
    return ((got[fin] - want[fin]).abs().max().item(),
            max(1.0, want[fin].abs().max().item()))


def _flash_case(torch, fa, gen, b, s, h, hk, hd, dtype, masked):
    """Flash forward, dQ (computing D, and given D), dK/dV and the whole
    backward as ``_Flash`` runs it (causal) at one shape against their
    plain versions: returns {record: (max abs err, tol)} and the operands
    (q, k, v, do, lse, dvec, out)."""
    dev = torch.device("cuda")

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)
    q, k, v, do = rnd(b, s, h, hd), rnd(b, s, hk, hd), rnd(b, s, hk, hd), \
        rnd(b, s, h, hd)
    valid = None
    if masked:
        valid = torch.rand(b, s, generator=gen, device=dev) < 0.7
        valid[0] = False                   # batch row 0: no valid key
        valid[1:, 0] = True
    scale = 1.0 / hd ** 0.5
    out, lse = fa.flash_forward(q, k, v, valid, True)
    vb = fa._checked(q, k, v, valid)
    dq, dvec = fa._launch_dq_d(q, k, v, vb, do, out, lse, True, scale)
    want_dq, want_d = fa.flash_backward_dq_d_plain(q, k, v, valid, do, out,
                                                   lse, True)
    pairs = {
        "flash_forward": zip((out, lse), fa.flash_forward_plain(
            q, k, v, valid, True)),
        "flash_backward_dq": [
            (dq, want_dq), (dvec, want_d),
            (fa.flash_backward_dq(q, k, v, valid, do, lse, dvec, True),
             want_dq)],
        "flash_backward_dkv": zip(
            fa.flash_backward_dkv(q, k, v, valid, do, lse, dvec, True),
            fa.flash_backward_dkv_plain(q, k, v, valid, do, lse, dvec,
                                        True)),
        "flash_backward": zip(
            fa._backward(q, k, v, vb, do, out, lse, True, scale),
            fa.flash_backward_plain(q, k, v, valid, do, out, lse, True))}
    rel = FLASH_BF16_TOL if dtype == torch.bfloat16 else FLASH_F32_TOL
    result = {}
    for name, ps in pairs.items():
        errs = [_err_and_scale(torch, got, want) for got, want in ps]
        result[name] = (max(e for e, _ in errs),
                        rel * max(sc for _, sc in errs))
    torch.cuda.synchronize()
    return result, (q, k, v, do, lse, dvec, out)


def _sdpa_backward_direct(torch, qt, kt, vt, dot, iters):
    """SDPA's backward (causal, no dropout) timed as the aten op its
    backend dispatches to, called on the saved forward outputs, so that it
    can be captured in a CUDA graph (``autograd.grad`` cannot); and its
    device time from ``torch.profiler`` kernel rows over autograd calls.
    For timing only: the port never calls it."""
    from torch.profiler import ProfilerActivity, profile
    aten = torch.ops.aten
    res = {"backend": int(aten._fused_sdp_choice(qt, kt, vt, None, 0.0,
                                                 True))}
    try:
        if res["backend"] != 3:         # the backend the H100 runs: cuDNN
            raise RuntimeError(f"backend {res['backend']}: no direct call")
        res["op"] = "_scaled_dot_product_cudnn_attention_backward"
        op = getattr(aten, res["op"])
        with torch.no_grad():
            o, lse, cq, ck, mq, mk, seed, off, _ = \
                aten._scaled_dot_product_cudnn_attention(
                    qt, kt, vt, None, True, 0.0, True, False)
            g_o = torch.empty_like(o).copy_(dot)      # o's strides

        def direct():
            with torch.no_grad():
                return op(g_o, qt, kt, vt, o, lse, seed, off, None, cq, ck,
                          mq, mk, 0.0, True)
        got = direct()
        want = torch.autograd.grad(
            torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True), (qt, kt, vt), dot)
        res["max_abs_diff_vs_autograd"] = max(
            (a.float() - b.float()).abs().max().item()
            for a, b in zip(got, want))
        res["ms"] = time_ms(torch, direct, iters)
        res["graph_ms"], res["graph_note"] = _graph_or_why(torch, direct,
                                                           iters)
    except RuntimeError as e:
        torch.cuda.synchronize()
        res["graph_ms"] = None
        res["graph_note"] = f"{type(e).__name__}: {str(e)[:200]}"
    out = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt,
                                                           is_causal=True)
    for _ in range(3):
        torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True)
        torch.cuda.synchronize()
    rows = _kernel_rows(prof)
    res["profiler_device_ms"] = sum(r[1] for r in rows) / 1e3 / iters
    res["profiler_kernels"] = [[k[:100], us / 1e3 / iters, n // iters]
                               for k, us, n in rows]
    return res


def check_train_kernels(torch, args):
    """Phase 3, the training kernels: returns {kernel name: record}."""
    import torch.nn.functional as F

    from distributed_tensorflow_tpu_torch.ops.kernels import \
        flash_attention as fa
    from distributed_tensorflow_tpu_torch.ops.kernels import fused

    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(args.seed + 1)
    records = {}
    site = "distributed_tensorflow_tpu/ops/pallas/flash_attention.py:"
    replaces = {"flash_forward": site + "169",
                "flash_backward_dkv": site + "346",
                "flash_backward_dq": site + "379"}

    # agreement at the training shape, at s 1024, on an f32 case with
    # GQA (12 query heads on 4 kv heads), a kv-valid plane with fully
    # masked rows, a length no tile divides and head dim 128, and at the
    # decode path's prompt prefills (bf16: GPT-2 generate's 4 prompts of
    # 256, beam search's 2 of 127, the speculative target's and draft's
    # 1 of 256, and Llama-3-8B's 4 of 512 with 32 query heads on 8 kv
    # heads of 128)
    worst = dict.fromkeys([*replaces, "flash_backward"], 0.0)
    main = long = None
    for label, shape in (
            ("train", (TRAIN_BATCH, TRAIN_SEQ, 12, 12, 64, torch.bfloat16,
                       False)),
            ("s1024", (12, 1024, 12, 12, 64, torch.bfloat16, False)),
            ("f32_gqa_valid_ragged_hd128", (3, 300, 12, 4, 128,
                                            torch.float32, True)),
            ("gpt2_prefill_bf16", (GEN_BATCH, GEN_PROMPT, 12, 12, 64,
                                   torch.bfloat16, False)),
            ("beam_prefill_bf16_ragged", (BEAM_BATCH, BEAM_PROMPT - 1, 12,
                                          12, 64, torch.bfloat16, False)),
            ("spec_prefill_bf16", (1, GEN_PROMPT, 12, 12, 64,
                                   torch.bfloat16, False)),
            ("llama_prefill_bf16_gqa_hd128", (LLAMA_GEN_BATCH,
                                              LLAMA_GEN_PROMPT, 32, 8, 128,
                                              torch.bfloat16, False))):
        result, ops = _flash_case(torch, fa, gen, *shape)
        for name, (err, tol) in result.items():
            log({"check": name, "case": label, "max_abs_err": err,
                 "tol": tol})
            if not err <= tol:
                raise AssertionError(f"{name} disagrees ({label}): "
                                     f"{err} > {tol}")
            worst[name] = max(worst[name], err)
        if label == "train":
            main = ops
        elif label == "s1024":
            long = ops[:3]
        del ops

    # the forward at s 1024 beside SDPA at s 1024, logged
    ql, kl, vl = long
    lt = [x.transpose(1, 2) for x in long]
    iters = max(20, args.iters // 4)

    def fwd_long():
        return fa.flash_forward(ql, kl, vl, None, True)

    def sdpa_long():
        return F.scaled_dot_product_attention(*lt, is_causal=True)
    log({"time": "flash_forward", "shape": f"q{list(ql.shape)} bf16 causal",
         "kernel_ms": time_ms(torch, fwd_long, iters),
         "library_ms": time_ms(torch, sdpa_long, iters),
         "graph_ms": graph_ms(torch, fwd_long, iters),
         "library_graph_ms": graph_ms(torch, sdpa_long, iters),
         "library": "F.scaled_dot_product_attention(is_causal=True)",
         "bound_ms": bound_ms(4 * ql.numel() * 2 + ql.shape[0] * ql.shape[2]
                              * ql.shape[1] * 4,
                              2.0 * ql.numel() * ql.shape[1])[0]})
    del long, ql, kl, vl, lt

    # the forward at the decode path's prompt prefills (phases 11 and 14:
    # one launch a layer), beside its plain version and SDPA on the same
    # inputs (their agreement is held above)
    for label, (b, s, h, hk, hd) in (
            ("gpt2_prefill", (GEN_BATCH, GEN_PROMPT, 12, 12, 64)),
            ("beam_prefill", (BEAM_BATCH, BEAM_PROMPT - 1, 12, 12, 64)),
            ("spec_prefill", (1, GEN_PROMPT, 12, 12, 64)),
            ("llama_prefill", (LLAMA_GEN_BATCH, LLAMA_GEN_PROMPT, 32, 8,
                               128))):
        q = torch.randn(b, s, h, hd, generator=gen, device=dev).to(
            torch.bfloat16)
        k, v = (torch.randn(b, s, hk, hd, generator=gen, device=dev).to(
            torch.bfloat16) for _ in range(2))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

        def fwd():
            return fa.flash_forward(q, k, v, None, True)

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                  enable_gqa=hk != h)
        lib_graph, why = _graph_or_why(torch, sdpa, iters)
        b_ms, b_by = bound_ms(2 * (2 * q.numel() + 2 * k.numel())
                              + 4 * b * h * s, 2.0 * b * h * s * s * hd)
        log({"time": "flash_forward", "case": label,
             "shape": f"q[{b},{s},{h},{hd}] kv heads {hk} bf16 causal",
             "kernel_ms": time_ms(torch, fwd, iters),
             "graph_ms": graph_ms(torch, fwd, iters),
             "plain_ms": time_ms(torch, lambda: fa.flash_forward_plain(
                 q, k, v, None, True), max(5, iters // 10)),
             "library_ms": time_ms(torch, sdpa, iters),
             "library_graph_ms": lib_graph, "library_graph_note": why,
             "library": "F.scaled_dot_product_attention(is_causal=True, "
                        "enable_gqa)", "bound_ms": b_ms, "bound_by": b_by})
        del q, k, v, qt, kt, vt

    # times at the training shape; the library call is SDPA, causal; its
    # backward's graph time is that of the aten op SDPA dispatches to
    q, k, v, do, lse, dvec, out = main
    b, s, h, hd = q.shape
    sc = 1.0 / hd ** 0.5
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    dot = do.transpose(1, 2)

    def sdpa_fwd():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    lib_out = sdpa_fwd()

    def sdpa_bwd():
        return torch.autograd.grad(lib_out, (qt, kt, vt), dot,
                                   retain_graph=True)
    lib_fwd = time_ms(torch, sdpa_fwd, iters)
    lib_bwd = time_ms(torch, sdpa_bwd, iters)
    lib_fwd_graph = graph_ms(torch, sdpa_fwd, iters)
    lib_direct = _sdpa_backward_direct(torch, qt, kt, vt, dot, iters)
    log({"time": "sdpa_backward", "shape": f"q[{b},{s},{h},{hd}] bf16 causal",
         "autograd_ms": lib_bwd, **lib_direct})
    lib_bwd_graph = lib_direct["graph_ms"]
    bwd_note = None
    if lib_bwd_graph is None:           # the profiler's device time instead
        lib_bwd_graph = lib_direct["profiler_device_ms"]
        bwd_note = ("library graph ms: torch.profiler device time of SDPA's "
                    "backward kernels (" + lib_direct["graph_note"] + ")")
    tensor = q.numel() * q.element_size()     # q, k, v, o, do, dq, dk, dv
    row = b * h * s * 4                       # lse or D, f32
    pairs = 0.5 * b * h * s * s * hd          # causal: half of s x s
    work = {  # (bytes each input read once + output written once, flops)
        "flash_forward": (4 * tensor + row, 4 * pairs),
        "flash_backward_dkv": (6 * tensor + 2 * row, 8 * pairs),
        # q, k, v, do, o read, dq written; lse read, D written
        "flash_backward_dq": (6 * tensor + 2 * row, 6 * pairs),
        # q, k, v, do, o read, dq, dk, dv written; lse read; the function
        # needs S once and dV, dP, dQ, dK: 5 products of 2 flops a pair
        "flash_backward": (8 * tensor + row, 10 * pairs)}
    calls = {
        "flash_forward": (
            lambda: fa.flash_forward(q, k, v, None, True),
            lambda: fa.flash_forward_plain(q, k, v, None, True), lib_fwd),
        "flash_backward_dkv": (
            lambda: fa.flash_backward_dkv(q, k, v, None, do, lse, dvec,
                                          True),
            lambda: fa.flash_backward_dkv_plain(q, k, v, None, do, lse,
                                                dvec, True), lib_bwd),
        "flash_backward_dq": (
            lambda: fa._launch_dq_d(q, k, v, None, do, out, lse, True, sc),
            lambda: fa.flash_backward_dq_d_plain(q, k, v, None, do, out, lse,
                                                 True), lib_bwd),
        "flash_backward": (
            lambda: fa._backward(q, k, v, None, do, out, lse, True, sc),
            lambda: fa.flash_backward_plain(q, k, v, None, do, out, lse,
                                            True), lib_bwd)}
    for name, (kern, plain, lib) in calls.items():
        ms = time_ms(torch, kern, iters)
        plain_ms = time_ms(torch, plain, max(5, iters // 10))
        g_ms = graph_ms(torch, kern, iters)
        fwd = name == "flash_forward"
        b_ms, b_by = bound_ms(*work[name])
        rec = dict(
            source="distributed_tensorflow_tpu_torch/csrc/flash_attention.cu",
            replaces=replaces.get(name), max_abs_err=worst[name], ms=ms,
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib,
            graph_ms=g_ms,
            library_graph_ms=lib_fwd_graph if fwd else lib_bwd_graph)
        if not fwd and bwd_note:
            rec["graph_note"] = bwd_note
        if name in replaces:            # a kernel (the whole backward is
            records[name] = rec         # two, logged only)
        log({"time": name, "shape": f"q[{b},{s},{h},{hd}] bf16 causal",
             "kernel_ms": ms, **{k_: v_ for k_, v_ in rec.items()
                                 if k_ not in ("source", "replaces", "ms")},
             "library": "F.scaled_dot_product_attention(is_causal=True)"
             + ("" if fwd else " backward, dq dk dv together")})
    # D = rowsum(dO * O) as torch computes it (two bf16 reads, f32
    # temporaries, one f32 [b, h, s] write), which the dQ kernel replaced
    log({"time": "row_dot", "shape": f"do[{b},{s},{h},{hd}] bf16",
         "ms": time_ms(torch, lambda: fa.row_dot(do, out), iters),
         "graph_ms": graph_ms(torch, lambda: fa.row_dot(do, out), iters),
         "bound_ms": bound_ms(2 * tensor + row, 2.0 * q.numel())[0]})
    del main, q, k, v, do, lse, dvec, out, qt, kt, vt, lib_out, dot

    # Adam on the word embedding and one [768, 3072] kernel, called as the
    # optimizer calls it (delta out, moments in place, decay folded in)
    kw = dict(lr=TRAIN_LR, weight_decay=0.01, tf14_eps=True,
              return_delta=True)
    adam_err = 0.0
    for shape in ((50257, 768), (768, 3072)):
        p, g, m = (torch.randn(shape, generator=gen, device=dev)
                   for _ in range(3))
        v = torch.rand(shape, generator=gen, device=dev)
        want = fused.adam_plain(p, g, m, v, 3, **kw)
        m2, v2 = m.clone(), v.clone()
        got = fused.fused_adam_update(p, g, m2, v2, 3, out=(None, m2, v2),
                                      **kw)
        torch.cuda.synchronize()
        err = max((x - y).abs().max().item() for x, y in zip(got, want))
        log({"check": "fused_adam", "shape": list(shape),
             "max_abs_err": err, "tol": ADAM_TOL})
        if not err <= ADAM_TOL:
            raise AssertionError(f"Adam kernel disagrees: {err}")
        adam_err = max(adam_err, err)
        ms = time_ms(torch, lambda: fused.fused_adam_update(
            p, g, m2, v2, 3, out=(None, m2, v2), **kw), args.iters)
        plain = time_ms(torch, lambda: fused.adam_plain(
            p, g, m2, v2, 3, out=(None, m2, v2), **kw), iters)
        lib_p = p.clone()
        lib_p.grad = g
        lib_opt = torch.optim.AdamW([lib_p], lr=TRAIN_LR, eps=1e-8,
                                    weight_decay=0.01, fused=True)
        lib = time_ms(torch, lib_opt.step, args.iters)
        g_ms = graph_ms(torch, lambda: fused.fused_adam_update(
            p, g, m2, v2, 3, out=(None, m2, v2), **kw), args.iters)
        # a captured optimizer step needs its step count on the card
        cap_opt = torch.optim.AdamW([lib_p], lr=TRAIN_LR, eps=1e-8,
                                    weight_decay=0.01, fused=True,
                                    capturable=True)
        g_lib, why = _graph_or_why(torch, cap_opt.step, args.iters)
        # 4 f32 streams in, 3 out; about 12 flops an element
        b_ms, b_by = bound_ms(28.0 * p.numel(), 12.0 * p.numel())
        log({"time": "fused_adam", "shape": list(shape), "kernel_ms": ms,
             "plain_ms": plain, "library_ms": lib, "graph_ms": g_ms,
             "library_graph_ms": g_lib,
             "library": "torch.optim.AdamW(fused=True).step(); graph: "
                        "capturable=True", "library_graph_note": why,
             "bound_ms": b_ms, "bound_by": b_by})
        if "fused_adam" not in records:      # the word embedding's times
            records["fused_adam"] = dict(
                source="distributed_tensorflow_tpu_torch/csrc/adam.cu",
                replaces="distributed_tensorflow_tpu/ops/pallas/fused.py:119",
                ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib, graph_ms=g_ms, library_graph_ms=g_lib)
            if why:
                records["fused_adam"]["graph_note"] = (
                    "library step not captured: " + why)
        del p, g, m, v, m2, v2, want, got, lib_p, lib_opt, cap_opt
    records["fused_adam"]["max_abs_err"] = adam_err
    torch.cuda.synchronize()
    return records


def _requests(np, seed, vocab=50257):
    """12 requests: 4 share a 256-token system prompt (the first goes in
    first, the other 3 last), 8 are independent; budgets 8-64 new
    tokens; token ids below ``vocab``."""
    rng = np.random.default_rng(seed)

    def toks(n):
        return rng.integers(0, vocab, int(n), dtype=np.int32)

    system = toks(256)
    shared = [np.concatenate([system, toks(rng.integers(16, 49))])
              for _ in range(4)]
    own = [toks(n) for n in rng.integers(16, 701, 8)]
    prompts = [shared[0]] + own + shared[1:]
    budgets = [int(b) for b in rng.integers(8, 65, len(prompts))]
    return prompts, budgets


def _serve_engine(model, max_len=1024, **kw):
    """The engine of every serving phase: 8 slots, prefill windows of 32,
    ticks of 8 steps."""
    from distributed_tensorflow_tpu_torch import Engine
    return Engine(model, device=model.device, num_slots=8, max_len=max_len,
                  prefill_chunk=32, tick_steps=8, **kw)


def run_engine(torch, model, prompts, budgets, late=0, max_len=1024,
               paged=True, adapters=None, adapter_ids=None, **engine_kw):
    """Serve ``prompts`` on a fresh engine and drain it.  The last
    ``late`` requests are submitted once the first one has its first
    token (on a paged engine its prompt pages are then in the radix
    cache).  ``adapters`` ({id: adapter}) are loaded first and request i
    goes with ``adapter_ids[i]``."""
    eng = _serve_engine(model, max_len=max_len, paged=paged, **engine_kw)
    for name, ad in (adapters or {}).items():
        eng.load_adapter(name, ad)
    ids = adapter_ids or [None] * len(prompts)
    n = len(prompts) - late
    t0 = time.perf_counter()
    hs = [eng.submit(p, b, adapter_id=a)
          for p, b, a in zip(prompts[:n], budgets[:n], ids[:n])]
    while late and not hs[0].tokens:
        eng.step()
    hs += [eng.submit(p, b, adapter_id=a)
           for p, b, a in zip(prompts[n:], budgets[n:], ids[n:])]
    eng.drain()
    torch.cuda.synchronize()
    return eng, hs, time.perf_counter() - t0


def check_engine(torch, np, args, smi):
    """Phase 4: returns the launch counts of the main path's run, and the
    model with the run's tokens, tokens/s and TTFT (for phase 12)."""
    from distributed_tensorflow_tpu_torch import GPT, gpt_small
    from distributed_tensorflow_tpu_torch.ops.kernels import fused
    from distributed_tensorflow_tpu_torch.ops.kernels import \
        paged_attention as pa

    model = GPT(gpt_small(dtype=torch.bfloat16), device="cuda",
                generator=torch.Generator("cuda").manual_seed(args.seed))
    prompts, budgets = _requests(np, args.seed)
    pa.LAUNCHES.clear()
    fused.LAUNCHES.clear()
    eng, hs, wall = run_engine(torch, model, prompts, budgets,
                                late=3)
    launches = {"paged_decode_attention": pa.LAUNCHES["paged_decode"],
                "paged_window_attention": pa.LAUNCHES["paged_window"],
                "layernorm": fused.LAUNCHES["layernorm"]}
    st = eng.stats()
    for h, b in zip(hs, budgets):
        if h.status != "ok" or len(h.tokens) != b:
            raise AssertionError(f"request {h.rid}: status {h.status}, "
                                 f"{len(h.tokens)} of {b} tokens")
    if not st.prefix_hit_rate > 0:
        raise AssertionError("no prefix-cache hit")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} never launched on the main path")
    ttft = sorted(h.ttft_s for h in hs)
    n_tok = sum(len(h.tokens) for h in hs)
    log({"engine": "gpt2-small bf16", "requests": len(hs),
         "prompt_tokens": int(sum(p.size for p in prompts)),
         "new_tokens": n_tok, "wall_s": wall, "tokens_per_s": n_tok / wall,
         "ttft_p50_s": ttft[len(ttft) // 2], "ttft_max_s": ttft[-1],
         "prefix_hit_rate": st.prefix_hit_rate,
         "prefill_windows_skipped": st.prefill_windows_skipped_total,
         "launches": launches, "card": smi})
    del eng
    _row_independence(torch, model, prompts, budgets, hs)
    return launches, dict(model=model, tokens=[h.tokens for h in hs],
                          tokens_per_s=n_tok / wall,
                          ttft_p50_s=ttft[len(ttft) // 2],
                          windows_skipped=st.prefill_windows_skipped_total)


def _row_independence(torch, model, prompts, budgets, hs, max_len=1024):
    """A request's tokens alone == in the batch == on a prefix hit."""
    hit = len(prompts) - 1             # a shared-prompt request that hit
    own = 1
    for idx in (own, hit):
        _, (h,), _ = run_engine(torch, model, [prompts[idx]],
                                [budgets[idx]], max_len=max_len)
        if h.tokens != hs[idx].tokens:
            raise AssertionError(f"request {idx} alone differs from batch")
    eng, _, _ = run_engine(torch, model, [prompts[0]], [budgets[0]],
                           max_len=max_len)
    h = eng.submit(prompts[hit], budgets[hit])
    eng.drain()
    if eng.stats().prefix_hits_total != 1 or h.tokens != hs[hit].tokens:
        raise AssertionError("prefix-hit tokens differ from the batch")
    log({"row_independence": "ok", "vocab": model.config.vocab_size,
         "layers": model.config.num_layers, "checked": [own, hit]})


def check_reference(torch, np):
    """Phase 5: the card's kernels and the CPU's plain versions decode the
    same greedy tokens from the same f32 weights."""
    from distributed_tensorflow_tpu_torch import GPT, Engine, gpt_tiny
    gpu = GPT(gpt_tiny(), device="cuda")
    cpu = GPT(gpt_tiny(), device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 512, n, dtype=np.int32) for n in (5, 17, 40)]
    outs = []
    for model, device in ((gpu, "cuda"), (cpu, "cpu")):
        eng = Engine(model, device=device, num_slots=2, max_len=128,
                     prefill_chunk=16, tick_steps=4)
        outs.append(eng.generate_batch(prompts, 12))
    if outs[0] != outs[1]:
        raise AssertionError(f"card and CPU reference disagree: {outs}")
    log({"reference": "ok", "requests": len(prompts)})


def _reset_counts():
    """Set every kernel launch count, and the all-reduce count, to 0."""
    from distributed_tensorflow_tpu_torch.ops.kernels import \
        flash_attention as fa
    from distributed_tensorflow_tpu_torch.ops.kernels import fused
    from distributed_tensorflow_tpu_torch.ops.kernels import \
        paged_attention as pa
    from distributed_tensorflow_tpu_torch.parallel import (data_parallel,
                                                           pipeline, ring,
                                                           ring_flash)
    for counter in (fa.LAUNCHES, fused.LAUNCHES, pa.LAUNCHES,
                    data_parallel.LAUNCHES, ring.LAUNCHES,
                    ring_flash.LAUNCHES, pipeline.LAUNCHES):
        counter.clear()


def _read_counts(torch):
    """The launch counts since ``_reset_counts``, after a synchronize:
    flash forward, the two norms, and every paged entry summed."""
    from distributed_tensorflow_tpu_torch.ops.kernels import \
        flash_attention as fa
    from distributed_tensorflow_tpu_torch.ops.kernels import fused
    from distributed_tensorflow_tpu_torch.ops.kernels import \
        paged_attention as pa
    torch.cuda.synchronize()
    return {"flash_forward": fa.LAUNCHES["flash_forward"],
            "layernorm": fused.LAUNCHES["layernorm"],
            "rmsnorm": fused.LAUNCHES["rmsnorm"],
            "paged": sum(pa.LAUNCHES.values())}


def _driven(torch, fn, read=None):
    """(fn's result, host seconds, launch counts) of one run of ``fn``,
    with every count set to 0 just before it and read just after
    (``read(torch)``: ``_read_counts`` by default)."""
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    counts = (read or _read_counts)(torch)
    return out, time.perf_counter() - t0, counts


def _expect(name, counts, flash, norm, n_norm=None):
    """Fail unless ``counts`` shows ``flash`` flash launches, launches of
    the ``norm`` kernel only (exactly ``n_norm`` when given), and no
    paged launch."""
    other = "rmsnorm" if norm == "layernorm" else "layernorm"
    if counts["flash_forward"] != flash or counts[norm] <= 0 \
            or n_norm is not None and counts[norm] != n_norm \
            or counts[other] or counts["paged"]:
        raise AssertionError(f"{name}: launches {counts}; expected "
                             f"flash_forward {flash}, {norm} "
                             f"{'> 0' if n_norm is None else n_norm}, no "
                             f"{other}, no paged kernel")


def _counted(torch, fn):
    """(fn's result, its host syncs): the operations that wait for the
    card (a read of a device value, a copy from pageable host memory), as
    ``torch.cuda.set_sync_debug_mode("warn")`` reports them."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    # the first switch to "warn" in a process also warns that the mode is
    # a prototype; that warning names no sync
    return out, sum("synchroniz" in str(w.message)
                    and "prototype feature" not in str(w.message)
                    for w in caught)


def _syncs(torch, fn) -> int:
    """Host syncs in one run of ``fn`` (see ``_counted``)."""
    torch.cuda.synchronize()
    return _counted(torch, fn)[1]


def _new_tokens(out, plen, eos_id):
    """Generated tokens per row: up to and including the first EOS."""
    counts = []
    for row in out[:, plen:].tolist():
        counts.append(row.index(eos_id) + 1 if eos_id in row else len(row))
    return counts


def _agree_prefix(a, b):
    """How many leading entries two token lists share."""
    n = 0
    for x, y in zip(a, b):
        if x != y:
            break
        n += 1
    return n


def _prefill_ms(torch, model, ids, max_len, reps=5):
    """Device ms of one ``prefill_cache`` (one decode_block) of ``ids``
    into a fresh cache: CUDA events around ``reps`` calls, after one."""
    model.prefill_cache(model.init_cache(ids.shape[0], max_len), ids)
    caches = [model.init_cache(ids.shape[0], max_len) for _ in range(reps)]
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for cache in caches:
        model.prefill_cache(cache, ids)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _truncated_draft(torch, model, layers, seed):
    """The target's first ``layers`` layers under its embeddings, final
    norm and head, as a shallower model (the JAX bench row's draft)."""
    import dataclasses

    from distributed_tensorflow_tpu_torch import GPT
    draft = GPT(dataclasses.replace(model.config, num_layers=layers),
                device=model.device,
                generator=torch.Generator(model.device).manual_seed(seed))
    keep = {k: v for k, v in model.state_dict().items()
            if not k.startswith("blocks.")
            or int(k.split(".")[1]) < layers}
    draft.load_state_dict(keep)
    return draft


def check_decode(torch, np, args, smi, model):
    """Phase 11: single-stream decoding on the contiguous cache, GPT-2
    small at full width in bf16 (phase 4's model).  Returns the flash,
    LayerNorm and RMSNorm launches of its runs."""
    from distributed_tensorflow_tpu_torch import generate_speculative
    c = model.config
    L = c.num_layers
    dev = model.device
    rng = np.random.default_rng(args.seed + 11)
    ids = torch.from_numpy(rng.integers(0, c.vocab_size, (GEN_BATCH,
                                                          GEN_PROMPT),
                                        dtype=np.int32)).to(dev)
    total = GEN_PROMPT + GEN_NEW
    model.generate(ids, 2, eos_id=GPT2_EOS)             # warm-up
    driven = {}

    def run(name, fn, flash):
        out, wall, counts = _driven(torch, fn)
        _expect(name, counts, flash, "layernorm")
        driven[name] = counts
        return out, wall

    out, wall = run("generate", lambda: model.generate(
        ids, GEN_NEW, eos_id=GPT2_EOS), L)
    if out.shape != (GEN_BATCH, total) or out.dtype != torch.int32:
        raise AssertionError(f"generate gave {tuple(out.shape)} {out.dtype}")
    if not torch.equal(out[:, :GEN_PROMPT], ids):
        raise AssertionError("generate changed the prompt")
    n_new = _new_tokens(out, GEN_PROMPT, GPT2_EOS)
    prefill = _prefill_ms(torch, model, ids, total)
    out_chunked, wall_chunked = run("generate prefill_chunk=64",
                                    lambda: model.generate(
                                        ids, GEN_NEW, eos_id=GPT2_EOS,
                                        prefill_chunk=64), 0)
    # ragged: prompts of 96..256 tokens, left-padded to 256
    lengths = np.linspace(96, GEN_PROMPT, GEN_BATCH).astype(int)
    valid = torch.from_numpy(np.arange(GEN_PROMPT)[None, :]
                             >= GEN_PROMPT - lengths[:, None]).to(dev)
    out_ragged, wall_ragged = run("generate ragged", lambda: model.generate(
        ids, GEN_NEW, eos_id=GPT2_EOS, prompt_valid=valid), 0)
    for name, o in (("chunked", out_chunked), ("ragged", out_ragged)):
        if o.shape != (GEN_BATCH, total):
            raise AssertionError(f"{name} gave {tuple(o.shape)}")

    bids = ids[:BEAM_BATCH, :BEAM_PROMPT]
    beam, wall_beam = run("beam_search", lambda: model.beam_search(
        bids, BEAM_NEW, beam_size=BEAM_SIZE), L)
    if beam.shape != (BEAM_BATCH, BEAM_PROMPT + BEAM_NEW) \
            or not torch.equal(beam[:, :BEAM_PROMPT], bids):
        raise AssertionError(f"beam_search gave {tuple(beam.shape)}")

    draft = _truncated_draft(torch, model, SPEC_DRAFT_LAYERS, args.seed)
    (spec, acc), wall_spec = run(
        "generate_speculative", lambda: generate_speculative(
            model, draft, ids[:1], GEN_NEW, gamma=SPEC_GAMMA),
        L + SPEC_DRAFT_LAYERS)
    greedy = model.generate(ids[:1], GEN_NEW)
    if spec.shape != (1, total) or not 0.0 <= acc <= 1.0:
        raise AssertionError(f"speculative gave {tuple(spec.shape)}, {acc}")
    agree_spec = _agree_prefix(spec[0, GEN_PROMPT:].tolist(),
                               greedy[0, GEN_PROMPT:].tolist())

    # decode_block's logits against one decode_window over the prompt
    block, _ = model.decode_block(model.init_cache(GEN_BATCH, GEN_PROMPT),
                                  ids)
    window, _ = model.decode_window(model.init_cache(GEN_BATCH, GEN_PROMPT),
                                    ids, head="last")
    err = (block - window).abs().max().item()
    tol = BLOCK_WINDOW_TOL * max(1.0, window.abs().max().item())
    log({"check": "decode_block vs decode_window", "shape": list(ids.shape),
         "max_abs_err": err, "tol": tol})
    if not err <= tol:
        raise AssertionError(f"decode_block and decode_window disagree: "
                             f"{err} > {tol}")
    # host syncs of each entry point (one extra run each, untimed), over
    # the positions it generates
    syncs = {
        "generate": (_syncs(torch, lambda: model.generate(ids, GEN_NEW)),
                     GEN_NEW),
        "generate eos": (_syncs(torch, lambda: model.generate(
            ids, GEN_NEW, eos_id=GPT2_EOS)), GEN_NEW),
        "beam_search eos": (_syncs(torch, lambda: model.beam_search(
            bids, BEAM_NEW, beam_size=BEAM_SIZE, eos_id=GPT2_EOS)),
            BEAM_NEW),
        "generate_speculative": (_syncs(torch, lambda: generate_speculative(
            model, draft, ids[:1], GEN_NEW, gamma=SPEC_GAMMA)), GEN_NEW)}
    del draft

    def agree(a, b):
        return [_agree_prefix(x[GEN_PROMPT:].tolist(), y[GEN_PROMPT:].tolist())
                for x, y in zip(a, b)]
    log({"decode": "gpt2-small bf16, contiguous cache",
         "prompt": [GEN_BATCH, GEN_PROMPT], "new": GEN_NEW,
         "eos_id": GPT2_EOS, "new_tokens": sum(n_new),
         "generate_wall_s": wall, "tokens_per_s": sum(n_new) / wall,
         "prefill_ms": prefill,
         "chunked_wall_s": wall_chunked,
         "chunked_agree_prefix_with_one_block": agree(out_chunked, out),
         "ragged_lengths": lengths.tolist(), "ragged_wall_s": wall_ragged,
         "ragged_full_row_agree_prefix": agree(out_ragged[-1:], out[-1:]),
         "beam": [BEAM_BATCH, BEAM_PROMPT, BEAM_NEW, BEAM_SIZE],
         "beam_wall_s": wall_beam,
         "beam_tokens_per_s": BEAM_BATCH * BEAM_NEW / wall_beam,
         "speculative_gamma": SPEC_GAMMA,
         "speculative_draft_layers": SPEC_DRAFT_LAYERS,
         "speculative_wall_s": wall_spec,
         "speculative_tokens_per_s": GEN_NEW / wall_spec,
         "speculative_acceptance": acc,
         "speculative_greedy_agree_prefix": agree_spec,
         "syncs": {k: {"syncs": n, "positions": t, "per_position": n / t}
                   for k, (n, t) in syncs.items()},
         "launches": driven, "card": smi})
    return {k: sum(d[k] for d in driven.values())
            for k in ("flash_forward", "layernorm", "rmsnorm")}


def check_contiguous_engine(torch, np, args, smi, paged):
    """Phase 12: ``Engine(paged=False)`` on phase 4's 12-request mix, with
    phase 4's paged run (``paged``: its model, tokens, tokens/s and
    TTFT) beside it."""
    model = paged["model"]
    prompts, budgets = _requests(np, args.seed)
    (eng, hs, wall), _, counts = _driven(torch, lambda: run_engine(
        torch, model, prompts, budgets, late=3, paged=False))
    if counts["flash_forward"] or counts["paged"] \
            or counts["layernorm"] <= 0:
        raise AssertionError(f"contiguous engine launches {counts}")
    for h, b in zip(hs, budgets):
        if h.status != "ok" or len(h.tokens) != b:
            raise AssertionError(f"request {h.rid}: status {h.status}, "
                                 f"{len(h.tokens)} of {b} tokens")
    st = eng.stats()
    if st.pages_total or st.prefix_lookups_total:
        raise AssertionError(f"contiguous engine has page counters: {st}")
    ttft = sorted(h.ttft_s for h in hs)
    n_tok = sum(len(h.tokens) for h in hs)
    same = [h.tokens == t for h, t in zip(hs, paged["tokens"])]
    log({"engine": "gpt2-small bf16, paged=False", "requests": len(hs),
         "new_tokens": n_tok, "wall_s": wall, "tokens_per_s": n_tok / wall,
         "ttft_p50_s": ttft[len(ttft) // 2], "ttft_max_s": ttft[-1],
         "paged_tokens_per_s": paged["tokens_per_s"],
         "paged_ttft_p50_s": paged["ttft_p50_s"],
         "share_equal_to_paged": sum(same) / len(same),
         "launches": counts, "card": smi})
    return {"layernorm": counts["layernorm"]}


def _check_budgets(hs, budgets, what):
    for h, b in zip(hs, budgets):
        if h.status != "ok" or len(h.tokens) != b:
            raise AssertionError(f"{what}, request {h.rid}: status "
                                 f"{h.status}, {len(h.tokens)} of {b} "
                                 "tokens")


def _lora_adapters(torch, model, n, seed):
    """``n`` rank-``SERVE_RANK`` adapters from ``seed``: ``a`` as
    ``init_lora`` draws it, ``b`` ~ N(0, ``LORA_B_STD``^2)."""
    gen = torch.Generator(model.device).manual_seed(seed)
    ads = {}
    for j in range(n):
        ad = model.init_lora(gen, rank=SERVE_RANK)
        for leaves in ad.values():
            leaves["b"] = LORA_B_STD * torch.randn(
                leaves["b"].shape, generator=gen, device=model.device)
        ads[f"adapter{j}"] = ad
    return ads


def _merged_model(torch, model, adapter):
    """A copy of ``model`` with ``adapter`` merged into its weights."""
    from distributed_tensorflow_tpu_torch import GPT
    merged = GPT(model.config, device=model.device,
                 generator=torch.Generator(model.device).manual_seed(0))
    merged.load_state_dict(model.merge_lora(adapter))
    return merged


def _pool_counts(pa, fused):
    return {"paged_decode_attention": pa.LAUNCHES["paged_decode"],
            "paged_window_attention": pa.LAUNCHES["paged_window"],
            "layernorm": fused.LAUNCHES["layernorm"]}


def _wire(torch, src, dst, snap):
    """Ship ``snap``'s pages from ``src`` to ``dst``: read them off the
    card, frame them ``WIRE_FRAME_PAGES`` to a frame, parse the frames,
    splice the records into ``dst``'s pool, and check that they landed
    bit-equal.  Returns (pages shipped, frame bytes, export ms,
    frame + parse ms)."""
    from distributed_tensorflow_tpu_torch.fleet import pagewire
    t0 = time.perf_counter()
    records = src.export_wire_pages(snap)
    t1 = time.perf_counter()
    tokens = dict(snap.shipped_pages or ())
    recs = [pagewire.PageRecord(i, c, tokens[c], p) for i, c, p in records]
    got, nbytes = [], 0
    for seq in range(0, len(recs), WIRE_FRAME_PAGES):
        frame = pagewire.frame_chunk(seq, recs[seq:seq + WIRE_FRAME_PAGES])
        nbytes += len(frame)
        got += pagewire.parse_frame(frame)[1]
    t2 = time.perf_counter()
    if not recs:
        return 0, 0, (t1 - t0) * 1e3, 0.0
    adopted = dst.import_wire_pages(snap, got)
    if adopted != len(recs):
        raise AssertionError(f"request {snap.rid}: {adopted} of "
                             f"{len(recs)} shipped pages adopted")
    kv = dst.scheduler._cache["kv"]
    chain = dst.scheduler.pages.chain_pages(snap.context)
    for (_, page, _), (_, _, payload) in zip(chain, records):
        for name, leaf in payload.items():
            if not torch.equal(kv[name][:, page].cpu(), leaf):
                raise AssertionError(f"request {snap.rid}: shipped page "
                                     f"{page} leaf {name} differs")
    return len(recs), nbytes, (t1 - t0) * 1e3, (t2 - t1) * 1e3


def _migrate(torch, src, dst, snaps, window):
    """Ship every snapshot's pages from ``src`` into ``dst`` and import
    the snapshots there; returns (handles, pages, bytes, export ms,
    frame + parse ms, prefill windows the shipped pages cover)."""
    pages = nbytes = covered = 0
    export_ms = frame_ms = 0.0
    for snap in snaps:
        n, b, e_ms, f_ms = _wire(torch, src, dst, snap)
        pages, nbytes = pages + n, nbytes + b
        export_ms, frame_ms = export_ms + e_ms, frame_ms + f_ms
        if n:
            covered += snap.shipped_pages[n - 1][1] // window
    hs = [dst.import_request(s) for s in snaps]
    return hs, pages, nbytes, export_ms, frame_ms, covered


def _check_resumed(snaps, hs, what):
    """Every resumed request met its original budget and kept the tokens
    delivered before its export."""
    for snap, h in zip(snaps, hs):
        kept = h.tokens[:snap.stream_offset] == snap.generated
        if h.status != "ok" or len(h.tokens) != snap.max_new_tokens \
                or not kept:
            raise AssertionError(
                f"{what}, request {snap.rid}: status {h.status}, "
                f"{len(h.tokens)} of {snap.max_new_tokens} tokens, "
                f"delivered prefix kept: {kept}")


def _check_serve_launches(model, counts, launches, n_requests, skipped,
                          skipped4, what="adapter engine"):
    """A run's paged and LayerNorm launches (``counts``) against those of
    a run of the same requests (``launches``, phase 4's for the adapter
    engine), which skipped ``skipped4`` windows on prefix hits where this
    run skipped ``skipped``.  A prefix hit is matched within one adapter's
    namespace only, so the mix's shared system prompt, which runs under
    three adapters and none, skips ``skipped4 - skipped`` fewer windows
    than phase 4: exactly that many more windows run (each a launch a
    layer).  The ticks may differ with them, so the decode launches are
    checked through LayerNorm's count, which every forward fixes: 2 a
    layer, plus ``ln_f`` in every decode step and every request's last
    window."""
    L = model.config.num_layers
    windows = counts["paged_window_attention"]
    steps = counts["paged_decode_attention"]
    want_windows = launches["paged_window_attention"] \
        + L * (skipped4 - skipped)
    want_norms = (2 * L + 1) * steps // L + 2 * windows + n_requests
    if windows != want_windows or steps <= 0 or steps % L \
            or counts["layernorm"] != want_norms:
        raise AssertionError(
            f"{what} launches {counts}; against {launches} with "
            f"{skipped4} windows skipped, this run {skipped}: expected "
            f"{want_windows} windows and {want_norms} layernorms")


def check_serve_surface(torch, np, args, smi, paged, launches):
    """Phase 16: adapters, admission and migration on phase 4's model
    and mix (``paged``: phase 4's model, tokens, tokens/s and TTFT;
    ``launches``: its paged and LayerNorm launch counts)."""
    from distributed_tensorflow_tpu_torch import (QueueFullError,
                                                  QuotaExceededError,
                                                  TenantPolicy, TenantQuota)
    from distributed_tensorflow_tpu_torch.obs import Registry
    from distributed_tensorflow_tpu_torch.ops.kernels import fused
    from distributed_tensorflow_tpu_torch.ops.kernels import \
        paged_attention as pa

    model = paged["model"]
    prompts, budgets = _requests(np, args.seed)
    n = len(prompts)

    # (a) adapters: requests i % 4 == 3 without one, the rest in turn
    ads = _lora_adapters(torch, model, SERVE_ADAPTERS, args.seed + 16)
    names = sorted(ads)
    ids, k = [], 0
    for i in range(n):
        if i % 4 == 3:
            ids.append(None)
        else:
            ids.append(names[k % len(names)])
            k += 1
    (eng, hs, wall), _, _ = _driven(torch, lambda: run_engine(
        torch, model, prompts, budgets, late=3, adapters=ads,
        adapter_ids=ids, adapter_capacity=SERVE_CAPACITY,
        adapter_rank=SERVE_RANK, registry=Registry()))
    counts = _pool_counts(pa, fused)
    _check_budgets(hs, budgets, "adapter engine")
    _check_serve_launches(model, counts, launches, n,
                          eng.stats().prefill_windows_skipped_total,
                          paged["windows_skipped"])
    for i, (h, a) in enumerate(zip(hs, ids)):
        if a is None and h.tokens != paged["tokens"][i]:
            raise AssertionError(f"request {i} without an adapter differs "
                                 "from phase 4")
    for name in names:
        if all(hs[i].tokens == paged["tokens"][i]
               for i in range(n) if ids[i] == name):
            raise AssertionError(f"{name} changed no request's tokens")
    if eng.adapters.pinned():
        raise AssertionError(f"{eng.adapters.pinned()} adapter pins left")
    merged_agree = {}
    for name in names:
        merged = _merged_model(torch, model, ads[name])
        for i in (i for i in range(n) if ids[i] == name):
            out = merged.generate(torch.from_numpy(prompts[i][None]).cuda(),
                                  budgets[i])
            merged_agree[i] = _agree_prefix(
                out[0, prompts[i].size:].tolist(), hs[i].tokens)
        del merged
    merged_equal = sum(merged_agree[i] == budgets[i] for i in merged_agree)
    ttft = sorted(h.ttft_s for h in hs)
    n_tok = sum(len(h.tokens) for h in hs)
    n_ad = sum(a is not None for a in ids)
    log({"serve_surface": "adapters", "adapters": len(names),
         "rank": SERVE_RANK, "requests": n, "adapter_requests": n_ad,
         "new_tokens": n_tok, "wall_s": wall, "tokens_per_s": n_tok / wall,
         "ttft_p50_s": ttft[len(ttft) // 2],
         "phase4_tokens_per_s": paged["tokens_per_s"],
         "phase4_ttft_p50_s": paged["ttft_p50_s"],
         "share_equal_to_merged_generate": merged_equal / n_ad,
         "merged_generate_agree_prefix": [merged_agree[i]
                                          for i in sorted(merged_agree)],
         "adapter_loads": eng.metrics.registry.get(
             "dttpu_adapter_loads_total").value,
         "windows_skipped": eng.stats().prefill_windows_skipped_total,
         "phase4_windows_skipped": paged["windows_skipped"],
         "launches": counts, "phase4_launches": launches,
         "card": smi})
    del eng

    # (b) admission: tenant "a" up to a token quota it reaches, a request
    # that expires at once, and a queue at its bound
    quota = sum(budgets[:3])
    eng = _serve_engine(model, max_queue_depth=SERVE_QUEUE_DEPTH,
                        tenancy=TenantPolicy(
                            {"a": TenantQuota(max_tokens_inflight=quota)}))
    hs = [eng.submit(prompts[i], budgets[i], tenant="a") for i in range(3)]
    try:
        eng.submit(prompts[3], 1, tenant="a")
        raise AssertionError("the token quota did not raise")
    except QuotaExceededError:
        pass
    late = eng.submit(prompts[3], budgets[3], tenant="b", deadline_s=0.0)
    hs += [eng.submit(prompts[i], budgets[i], tenant="b")
           for i in range(4, SERVE_QUEUE_DEPTH)]
    try:
        eng.submit(prompts[n - 1], budgets[n - 1], tenant="b")
        raise AssertionError("the queue bound did not raise")
    except QueueFullError:
        pass
    eng.drain()
    kept = [0, 1, 2] + list(range(4, SERVE_QUEUE_DEPTH))
    _check_budgets(hs, [budgets[i] for i in kept], "admission engine")
    if late.status != "deadline_exceeded" or late.tokens:
        raise AssertionError(f"the expired request ended {late.status} "
                             f"with {len(late.tokens)} tokens")
    if any(h.tokens != paged["tokens"][i] for h, i in zip(hs, kept)):
        raise AssertionError("admitted requests' tokens differ from "
                             "phase 4")
    st = eng.stats()
    if st.inflight_per_tenant or st.tokens_inflight_per_tenant:
        raise AssertionError(f"tenant counts left: {st}")
    log({"serve_surface": "admission", "token_quota": quota,
         "queue_depth": SERVE_QUEUE_DEPTH, "admitted": len(hs),
         "expired": late.status, "quota_raised": True,
         "queue_full_raised": True})
    del eng

    # (c) migration: engine A runs the mix a few ticks, exports every
    # request in flight; their pages ship to engine B, which resumes them
    src = _serve_engine(model)
    dst = _serve_engine(model, num_pages=2 * 8 * (1024 // 16) + 1)
    hs = [src.submit(p, b) for p, b in zip(prompts, budgets)]
    for _ in range(6):
        src.step()
    st = src.stats()
    state = {"active": st.active, "prefilling": st.prefilling,
             "queued": st.queued}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    snaps = src.export_inflight()
    export_all_ms = (time.perf_counter() - t0) * 1e3
    if not snaps:
        raise AssertionError("nothing in flight to export")
    _reset_counts()
    t0 = time.perf_counter()
    hs2, pages, nbytes, export_ms, frame_ms, covered = _migrate(
        torch, src, dst, snaps, 32)
    dst.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _read_counts(torch)
    _check_resumed(snaps, hs2, "migration")
    skipped = dst.stats().prefill_windows_skipped_total
    if not pages or skipped < covered:
        raise AssertionError(f"{pages} pages shipped covering {covered} "
                             f"windows; B skipped {skipped}")
    if counts["paged"] <= 0 or counts["layernorm"] <= 0:
        raise AssertionError(f"migration launches {counts}")
    final = {h.rid: h.tokens for h in hs if h.status == "ok"}
    final.update({s.rid: h.tokens for s, h in zip(snaps, hs2)})
    equal = sum(final.get(i) == paged["tokens"][i] for i in range(n))
    if len(final) != n:
        raise AssertionError(f"{n - len(final)} requests lost")
    ttft = sorted(h.ttft_s for h in hs2)
    log({"serve_surface": "migration", "state_at_export": state,
         "exported": len(snaps), "pages_shipped": pages,
         "frame_bytes": nbytes, "export_inflight_ms": export_all_ms,
         "export_wire_ms": export_ms, "frame_parse_ms": frame_ms,
         "import_to_first_token_p50_ms": ttft[len(ttft) // 2] * 1e3,
         "windows_covered": covered, "windows_skipped": skipped,
         "resume_wall_s": wall, "token_equal_to_phase4": equal,
         "requests": n, "launches": counts, "card": smi})

    # a drain that runs out of time exports; the snapshots finish on B
    busy = _serve_engine(model)
    for p, b in zip(prompts[:4], budgets[:4]):
        busy.submit(p, b)
    busy.step()
    busy.step()
    res = busy.drain(timeout_s=0.0)
    if res or not res.exported or busy.busy:
        raise AssertionError(f"drain(timeout_s=0) gave {res}")
    hs3 = [dst.import_request(s) for s in res.exported]
    dst.drain()
    _check_resumed(res.exported, hs3, "drain export")
    log({"serve_surface": "drain(timeout_s=0)",
         "exported": len(res.exported), "resumed": "ok"})
    del src, dst, busy


def check_llama_migration(torch, np, args, smi, model):
    """Phase 9(d): two mid-decode Llama-3-8B requests move between two
    int8 engines over phase 9's model; their pages (int8 K/V and f32
    scale planes) land bit-equal."""
    c = model.config
    prompts, budgets = _requests(np, args.seed, vocab=c.vocab_size)
    pick = [i for i, p in enumerate(prompts) if p.size >= 64][:2]
    src = _serve_engine(model, max_len=LLAMA_MAX_LEN)
    dst = _serve_engine(model, max_len=LLAMA_MAX_LEN)
    # budgets of 16 or more: a request's first tick leaves it at 9
    # tokens, still decoding when it is exported
    hs = [src.submit(prompts[i], max(budgets[i], 16)) for i in pick]
    snaps = [None] * len(hs)
    while None in snaps:
        src.step()
        for j, h in enumerate(hs):
            if snaps[j] is None and len(h.tokens) >= 2:
                snaps[j] = src.export_request(h)
    _reset_counts()
    hs2, pages, nbytes, export_ms, frame_ms, covered = _migrate(
        torch, src, dst, snaps, 32)
    dst.drain()
    counts = _read_counts(torch)
    from distributed_tensorflow_tpu_torch.ops.kernels import \
        paged_attention as pa
    _check_resumed(snaps, hs2, "llama migration")
    skipped = dst.stats().prefill_windows_skipped_total
    leaves = sorted(dst.scheduler._cache["kv"])
    if leaves != ["k", "k_scale", "v", "v_scale"] or not pages \
            or skipped < covered:
        raise AssertionError(f"llama migration: leaves {leaves}, {pages} "
                             f"pages covering {covered} windows, "
                             f"{skipped} skipped")
    if counts["rmsnorm"] <= 0 or counts["layernorm"] \
            or pa.LAUNCHES["paged_decode_int8"] <= 0 \
            or pa.LAUNCHES["paged_window_int8"] <= 0:
        raise AssertionError(f"llama migration launches {counts}, "
                             f"{dict(pa.LAUNCHES)}")
    log({"serve_surface": "llama3-8b int8 migration",
         "requests": len(snaps), "pages_shipped": pages,
         "frame_bytes": nbytes, "export_wire_ms": export_ms,
         "frame_parse_ms": frame_ms, "windows_covered": covered,
         "windows_skipped": skipped, "launches": counts,
         "paged_int8": {k: pa.LAUNCHES[k] for k in
                        ("paged_decode_int8", "paged_window_int8")},
         "card": smi})
    del src, dst


def check_serve_reference(torch, np):
    """Phase 13(e): a 2-layer f32 GPT-2-shaped model (head dim 64, weight
    matrices scaled 5x so that greedy tokens vary) and two adapters on
    the card and on the CPU give equal tokens for a mixed adapter/None
    batch, an export mid-decode moved through the wire, and both again
    on ``paged=False``; the adapter requests equal ``generate`` on the
    merged weights."""
    from distributed_tensorflow_tpu_torch import GPT, Engine, gpt_tiny
    cpu = GPT(gpt_tiny(), device="cpu")
    with torch.no_grad():
        for p in cpu.parameters():
            if p.dim() >= 2:
                p.mul_(5.0)
    gpu = GPT(gpt_tiny(), device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    g = torch.Generator().manual_seed(13)
    L = cpu.config.num_layers
    ads = {f"adapter{j}": {
        name: {"a": 0.5 * torch.randn((L,) + a, generator=g),
               "b": 0.5 * torch.randn((L,) + b, generator=g)}
        for name, (a, b) in cpu.lora_shapes(4).items()} for j in range(2)}
    rng = np.random.default_rng(13)
    prompts = [rng.integers(0, 512, n, dtype=np.int32)
               for n in (5, 19, 40, 33)]
    ids = ["adapter0", None, "adapter1", None]

    def engine(m, paged):
        eng = Engine(m, device=m.device, num_slots=2, max_len=128,
                     prefill_chunk=16, tick_steps=4, paged=paged,
                     adapter_capacity=2, adapter_rank=4)
        for name, ad in ads.items():
            eng.load_adapter(name, ad)
        return eng

    def batch(m, paged):
        eng = engine(m, paged)
        hs = [eng.submit(p, 12, adapter_id=a) for p, a in zip(prompts, ids)]
        eng.drain()
        return [h.tokens for h in hs]

    def migrated(m, paged):
        from distributed_tensorflow_tpu_torch.fleet import pagewire
        src, dst = engine(m, paged), engine(m, paged)
        hs = [src.submit(p, 16, adapter_id=a) for p, a in zip(prompts, ids)]
        while min(len(h.tokens) for h in hs[:2]) < 5:
            src.step()
        out = []
        for snap in src.export_inflight():
            recs = [pagewire.PageRecord(i, c, 0, p)
                    for i, c, p in src.export_wire_pages(snap)]
            if recs:
                recs = pagewire.parse_frame(pagewire.frame_chunk(0, recs))[1]
                if dst.import_wire_pages(snap, recs) != len(recs):
                    raise AssertionError("shipped pages not adopted")
            out.append(dst.import_request(snap))
        dst.drain()
        return [h.tokens for h in out]

    runs = {"adapter batch": lambda m: batch(m, True),
            "migration + wire": lambda m: migrated(m, True),
            "adapter batch, paged=False": lambda m: batch(m, False),
            "migration, paged=False": lambda m: migrated(m, False)}
    got = {}
    for name, fn in runs.items():
        got[name] = fn(gpu)
        if got[name] != fn(cpu):
            raise AssertionError(f"card and CPU disagree on {name}")
    for i, a in enumerate(ids):
        if a is None:
            continue
        merged = _merged_model(torch, gpu, ads[a])
        want = merged.generate(torch.from_numpy(prompts[i][None]).cuda(),
                               12)[0, prompts[i].size:].tolist()
        if got["adapter batch"][i] != want:
            raise AssertionError(f"request {i} under {a} differs from "
                                 "generate on the merged weights")
    log({"serve_reference": "ok", "equal_tokens": sorted(runs),
         "merged_generate": "equal"})


def check_decode_reference(torch, np):
    """Phase 13: a 2-layer f32 GPT-2-shaped model (head dim 64) on the
    card and the same weights on the CPU give EQUAL greedy tokens through
    every new entry point; a 2-layer f32 Llama with an int8 contiguous
    cache gives decode-step logits within ``INT8_REF_LOGIT_TOL``."""
    from distributed_tensorflow_tpu_torch import (GPT, Engine,
                                                  generate_speculative,
                                                  gpt_tiny, llama_tiny)

    def pair(config):
        """The same weights on the card and the CPU, made on the CPU (from
        its seed-0 generator, so that they do not depend on the card's)."""
        cpu = GPT(config, device="cpu")
        gpu = GPT(config, device="cuda")
        gpu.load_state_dict(cpu.state_dict())
        return gpu, cpu

    gpu, cpu = pair(gpt_tiny())
    accepted = {}

    def spec(m):
        """Greedy speculative decoding with the model's first layer as the
        draft, so that rounds accept part of the drafts and roll back."""
        out, acc = generate_speculative(
            m, _truncated_draft(torch, m, 1, 0), ids[:1], 16, gamma=4)
        accepted[m.device.type] = acc
        return out
    rng = np.random.default_rng(5)
    ids = torch.from_numpy(rng.integers(0, 512, (3, 40), dtype=np.int32))
    valid = torch.from_numpy(np.arange(40)[None, :]
                             >= np.array([[12], [0], [31]]))
    eos = int(cpu.generate(ids, 16)[1, 48])
    runs = {
        "generate": lambda m: m.generate(ids, 16),
        "generate ragged": lambda m: m.generate(ids, 16, prompt_valid=valid),
        "generate chunked": lambda m: m.generate(ids, 16, prefill_chunk=16),
        "generate eos": lambda m: m.generate(ids, 16, eos_id=eos),
        "beam_search": lambda m: m.beam_search(ids[:2], 12, beam_size=4,
                                               eos_id=eos),
        "generate_speculative": lambda m: spec(m)[0],
        "Engine(paged=False)": lambda m: torch.tensor(Engine(
            m, device=m.device, num_slots=2, max_len=128, prefill_chunk=16,
            tick_steps=4, paged=False).generate_batch(
                [ids[0, :9].numpy(), ids[1].numpy(), ids[2, :23].numpy()],
                12)),
    }
    for name, fn in runs.items():
        got, want = fn(gpu).cpu(), fn(cpu)
        if not torch.equal(got, want):
            raise AssertionError(f"card and CPU disagree on {name}")
    log({"decode_reference": "ok", "equal_tokens": sorted(runs),
         "speculative_acceptance": accepted})
    if not 0.0 < accepted["cuda"] < 1.0:
        raise AssertionError(f"the truncated draft's acceptance "
                             f"{accepted['cuda']} is not partial: no "
                             f"round rolled back")

    gpu, cpu = pair(llama_tiny(hidden_size=256, intermediate_size=512,
                               kv_cache_dtype="int8"))
    toks = torch.from_numpy(rng.integers(0, 512, (2, 24), dtype=np.int32))
    logits = []
    for m in (gpu, cpu):
        lg, cache = m.prefill_cache(m.init_cache(2, 32), toks[:, :20])
        got = [lg]
        for t in range(20, 24):
            lg, cache = m.decode_step(cache, toks[:, t])
            got.append(lg)
        logits.append([g.cpu() for g in got])
    err = max((a - b).abs().max().item() for a, b in zip(*logits))
    log({"decode_reference": "llama int8 contiguous cache",
         "logit_max_abs_err": err, "logit_tol": INT8_REF_LOGIT_TOL})
    if not err <= INT8_REF_LOGIT_TOL:
        raise AssertionError(f"card and CPU Llama int8 decode logits "
                             f"differ by {err}")


def check_llama_generate(torch, np, args, smi, model):
    """Phase 14: Llama-3-8B (phase 9's model) ``generate`` into an int8
    contiguous cache.  Returns its flash and RMSNorm launches."""
    c = model.config
    rng = np.random.default_rng(args.seed + 14)
    ids = torch.from_numpy(rng.integers(
        0, c.vocab_size, (LLAMA_GEN_BATCH, LLAMA_GEN_PROMPT),
        dtype=np.int32)).to(model.device)
    total = LLAMA_GEN_PROMPT + LLAMA_GEN_NEW
    model.generate(ids, 2)                              # warm-up
    torch.cuda.reset_peak_memory_stats()
    out, wall, counts = _driven(torch, lambda: model.generate(
        ids, LLAMA_GEN_NEW))
    # one prefill and LLAMA_GEN_NEW - 1 steps, each 2 norms a layer and ln_f
    _expect("llama generate", counts, c.num_layers, "rmsnorm",
            (2 * c.num_layers + 1) * LLAMA_GEN_NEW)
    peak = torch.cuda.max_memory_allocated()
    if out.shape != (LLAMA_GEN_BATCH, total) \
            or not torch.equal(out[:, :LLAMA_GEN_PROMPT], ids) \
            or int(out.max()) >= c.vocab_size or int(out.min()) < 0:
        raise AssertionError(f"llama generate gave {tuple(out.shape)}")
    prefill = _prefill_ms(torch, model, ids, total, reps=3)
    syncs = _syncs(torch, lambda: model.generate(ids, LLAMA_GEN_NEW))
    cache = model.init_cache(LLAMA_GEN_BATCH, total)
    cache_bytes = sum(t.numel() * t.element_size()
                      for n, t in cache.items() if n != "pos")
    bf16_bytes = 2 * cache["k"].numel() * 2
    del cache
    n_tok = LLAMA_GEN_BATCH * LLAMA_GEN_NEW
    log({"decode": "llama3-8b bf16, int8 contiguous cache",
         "layers": c.num_layers, "prompt": list(ids.shape),
         "new": LLAMA_GEN_NEW, "wall_s": wall, "tokens_per_s": n_tok / wall,
         "prefill_ms": prefill, "peak_memory_gb": peak / 1e9,
         "syncs": syncs, "syncs_per_position": syncs / LLAMA_GEN_NEW,
         "cache_gb": cache_bytes / 1e9, "bf16_cache_gb": bf16_bytes / 1e9,
         "launches": counts, "card": smi})
    return {k: counts[k] for k in ("flash_forward", "rmsnorm")}


def _count_forwards(model, *names):
    """Wrap the model's forward entries ``names`` on the instance so that
    each call is counted by its ``head`` argument ("none": no ln_f and
    no head); returns {name: Counter}.  ``delattr(model, name)`` undoes
    a wrap."""
    counts = {}
    for name in names:
        fn, counts[name] = getattr(model, name), collections.Counter()

        def call(*a, _fn=fn, _n=counts[name], **kw):
            _n["none" if kw.get("head") == "none" else "head"] += 1
            return _fn(*a, **kw)
        setattr(model, name, call)
    return counts


def _llama_model(torch, args):
    """Llama-3-8B at full width and depth, bf16 compute, int8 KV cache,
    random weights from ``--seed``."""
    from distributed_tensorflow_tpu_torch import GPT, llama3_8b
    return GPT(llama3_8b(dtype=torch.bfloat16, kv_cache_dtype="int8"),
               device="cuda",
               generator=torch.Generator("cuda").manual_seed(args.seed))


def check_llama_engine(torch, np, args, smi, model):
    """Phase 9, the main path of this slice: returns the launch counts of
    the Llama engine's run."""
    from distributed_tensorflow_tpu_torch.ops.kernels import fused
    from distributed_tensorflow_tpu_torch.ops.kernels import \
        paged_attention as pa

    c = model.config
    prompts, budgets = _requests(np, args.seed, vocab=c.vocab_size)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pa.LAUNCHES.clear()
    fused.LAUNCHES.clear()
    forwards = _count_forwards(model, "decode_window_paged",
                               "decode_step_slots_paged")
    try:
        eng, hs, wall = run_engine(torch, model, prompts, budgets, late=3,
                                   max_len=LLAMA_MAX_LEN)
    finally:
        for name in forwards:
            delattr(model, name)
    launches = {"rmsnorm": fused.LAUNCHES["rmsnorm"],
                "paged_decode_int8": pa.LAUNCHES["paged_decode_int8"],
                "paged_window_int8": pa.LAUNCHES["paged_window_int8"]}
    others = {"layernorm": fused.LAUNCHES["layernorm"],
              "paged_decode": pa.LAUNCHES["paged_decode"],
              "paged_window": pa.LAUNCHES["paged_window"]}
    peak = torch.cuda.max_memory_allocated()
    st = eng.stats()
    kv = eng.scheduler._cache["kv"]
    pool_bytes = sum(t.numel() * t.element_size() for t in kv.values())
    bf16_pool_bytes = 2 * kv["k"].numel() * 2
    for h, b in zip(hs, budgets):
        if h.status != "ok" or len(h.tokens) != b:
            raise AssertionError(f"request {h.rid}: status {h.status}, "
                                 f"{len(h.tokens)} of {b} tokens")
    if not st.prefix_hit_rate > 0:
        raise AssertionError("no prefix-cache hit")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} never launched on the main path")
    if any(others.values()):
        raise AssertionError(f"the Llama int8 path launched {others}")
    # 2 norms a layer in every forward, and ln_f in those with a head
    # (a mid prefill window, head="none", has none)
    n_fwd = sum(sum(f.values()) for f in forwards.values())
    n_head = n_fwd - sum(f["none"] for f in forwards.values())
    if launches["rmsnorm"] != 2 * c.num_layers * n_fwd + n_head:
        raise AssertionError(
            f"rmsnorm launched {launches['rmsnorm']} times over {n_fwd} "
            f"forwards, {n_head} with a head; expected "
            f"{2 * c.num_layers * n_fwd + n_head}")
    ttft = sorted(h.ttft_s for h in hs)
    n_tok = sum(len(h.tokens) for h in hs)
    log({"engine": "llama3-8b bf16, int8 KV", "layers": c.num_layers,
         "requests": len(hs), "prompt_tokens": int(sum(p.size
                                                       for p in prompts)),
         "new_tokens": n_tok, "wall_s": wall, "tokens_per_s": n_tok / wall,
         "ttft_p50_s": ttft[len(ttft) // 2], "ttft_max_s": ttft[-1],
         "prefix_hit_rate": st.prefix_hit_rate,
         "prefill_windows_skipped": st.prefill_windows_skipped_total,
         "peak_memory_gb": peak / 1e9,
         "weights_gb": sum(p.numel() * p.element_size()
                           for p in model.parameters()) / 1e9,
         "pool_gb": pool_bytes / 1e9, "bf16_pool_gb": bf16_pool_bytes / 1e9,
         "pool_pages": kv["k"].shape[1], "launches": launches,
         "forwards": {k: dict(v) for k, v in forwards.items()},
         "card": smi})
    del eng, kv
    _row_independence(torch, model, prompts, budgets, hs,
                      max_len=LLAMA_MAX_LEN)
    return launches


def check_llama_reference(torch, np):
    """Phase 10: a 2-layer f32 Llama with head dim 64 on the card and,
    with the same weights, on the CPU: equal greedy tokens with an f32
    pool; window and decode-step logits within ``INT8_REF_LOGIT_TOL``
    with int8 pools (tokens compared and reported)."""
    from distributed_tensorflow_tpu_torch import GPT, Engine, llama_tiny
    from distributed_tensorflow_tpu_torch.serve import pages

    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 512, n, dtype=np.int32) for n in (5, 17, 40)]
    toks = rng.integers(0, 512, (1, 48), dtype=np.int32)
    for kv_cache_dtype in (None, "int8"):
        config = llama_tiny(hidden_size=256, intermediate_size=512,
                            kv_cache_dtype=kv_cache_dtype)
        gpu = GPT(config, device="cuda")
        cpu = GPT(config, device="cpu")
        cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
        outs, logits = [], []
        for model, device in ((gpu, "cuda"), (cpu, "cpu")):
            eng = Engine(model, device=device, num_slots=2, max_len=128,
                         prefill_chunk=16, tick_steps=4)
            outs.append(eng.generate_batch(prompts, 12))
            # two windows, then decode steps for a live row and a retired
            # one, straight through the model's entries
            cache = pages.init_paged_cache(model, 2, 10, 16)
            kv = cache["kv"]
            row = torch.arange(1, 9, dtype=torch.int32, device=device)
            got = []
            for pos in (0, 32):
                lg, kv = model.decode_window_paged(
                    kv, torch.from_numpy(toks[:, pos:pos + 32]).to(device),
                    row, pos)
                got.append(lg[0])
            tab = torch.stack([row, torch.zeros_like(row)])
            wc = torch.tensor([64, 0], dtype=torch.int32, device=device)
            cols = torch.arange(128, device=device)[None, :]
            for t in range(4):
                valid = cols < wc[:, None]
                lg, kv = model.decode_step_slots_paged(
                    kv, torch.tensor([7 + t, 3], dtype=torch.int32,
                                     device=device), tab, wc, valid, wc)
                got.append(lg)
                wc = wc + torch.tensor([1, 0], dtype=torch.int32,
                                       device=device)
            logits.append([g.cpu() for g in got])
        err = max((a - b).abs().max().item()
                  for a, b in zip(*logits))
        same = outs[0] == outs[1]
        log({"llama_reference": kv_cache_dtype or "f32 pool",
             "tokens_equal": same, "logit_max_abs_err": err,
             "logit_tol": INT8_REF_LOGIT_TOL if kv_cache_dtype else None})
        if kv_cache_dtype is None and not same:
            raise AssertionError(f"card and CPU Llama disagree: {outs}")
        if kv_cache_dtype == "int8" and not err <= INT8_REF_LOGIT_TOL:
            raise AssertionError(f"card and CPU Llama int8 logits differ by "
                                 f"{err}")


def _train_setup(torch, model, lr, seed):
    from distributed_tensorflow_tpu_torch import (TrainState, adamw,
                                                  make_custom_train_step)
    params = dict(model.named_parameters())
    opt = adamw(lr)
    state = TrainState.create(params, opt.init(params))
    step = make_custom_train_step(model.lm_loss_fn(), opt, seed=seed,
                                  grad_clip_norm=1.0)
    return state, step


def _train_batch(torch, np, seed, batch, seq, vocab, device):
    """Rows of seq + 1 ids drawn with numpy, as the JAX package's bench
    row draws them; the loss shifts them into inputs and targets."""
    ids = np.random.default_rng(seed).integers(0, vocab, (batch, seq + 1))
    return {"input_ids": torch.from_numpy(ids.astype(np.int32)).to(device)}


def _model_flops(model, tokens, seq):
    """Training flops of one step: 6 N T for the matrix products (N: the
    parameters a token's products touch, the tied head included, the
    position table not, nor the word table beside an untied head, which
    is a lookup) plus causal attention, 3 x 2 h hd s^2 per sequence and
    layer (QK^T and PV, half of the s x s pairs)."""
    c = model.config
    lookups = ("position",) if c.tied_head else ("position", "word")
    n = sum(p.numel() for name, p in model.named_parameters()
            if name not in lookups)
    attn = 6.0 * c.num_layers * c.num_heads * c.head_dim * seq * tokens
    return 6.0 * n * tokens + attn


def check_training(torch, np, args, smi):
    """Phase 6, the main path of this slice: returns the launch counts of
    the training kernels over the phase and the trained model."""
    from distributed_tensorflow_tpu_torch import GPT, gpt_small
    from distributed_tensorflow_tpu_torch.ops.kernels import \
        flash_attention as fa
    from distributed_tensorflow_tpu_torch.ops.kernels import fused

    model = GPT(gpt_small(dtype=torch.bfloat16, dropout_rate=0.0),
                device="cuda",
                generator=torch.Generator("cuda").manual_seed(args.seed))
    state, step = _train_setup(torch, model, TRAIN_LR, args.seed)
    batch = _train_batch(torch, np, args.seed, TRAIN_BATCH, TRAIN_SEQ,
                         model.config.vocab_size, "cuda")
    n_params = len(state.params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.LAUNCHES.clear()
    fused.LAUNCHES.clear()
    losses = []
    for _ in range(TRAIN_WARMUP):
        state, metrics = step(state, batch)
        losses.append(metrics["loss"].item())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    timed = []
    for _ in range(TRAIN_STEPS):
        state, metrics = step(state, batch)
        timed.append(metrics)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_forward": fa.LAUNCHES["flash_forward"],
                "flash_backward_dkv": fa.LAUNCHES["flash_backward_dkv"],
                "flash_backward_dq": fa.LAUNCHES["flash_backward_dq"],
                "layernorm": fused.LAUNCHES["layernorm"],
                "fused_adam": fused.LAUNCHES["adam"]}
    losses += [m["loss"].item() for m in timed]
    c = model.config
    steps = TRAIN_WARMUP + TRAIN_STEPS
    per_step = {"flash_forward": c.num_layers,
                "flash_backward_dkv": c.num_layers,
                "flash_backward_dq": c.num_layers,
                "layernorm": 2 * c.num_layers + 1, "fused_adam": n_params}
    step_ms = wall / TRAIN_STEPS * 1e3
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops = _model_flops(model, tokens, TRAIN_SEQ)
    log({"training": "gpt2-small bf16", "batch": TRAIN_BATCH,
         "seq": TRAIN_SEQ, "steps": TRAIN_STEPS, "step_ms": step_ms,
         "tokens_per_s": tokens / (step_ms / 1e3),
         "mfu": flops / (step_ms / 1e3) / BF16_FLOPS_PER_S,
         "model_tflop_per_step": flops / 1e12,
         "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
         "losses": losses, "grad_norm_last": timed[-1]["grad_norm"].item(),
         "launches": launches,
         "launches_per_step": per_step, "parameter_tensors": n_params,
         "card": smi})
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite training loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    for name, n in launches.items():
        if n != per_step[name] * steps:
            raise AssertionError(f"{name}: {n} launches, expected "
                                 f"{per_step[name]} x {steps}")
    return launches, model, {
        "losses": losses, "step_ms": step_ms,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}


def check_train_reference(torch, np):
    """Phase 7: 3 f32 gpt_tiny steps on the card (kernels) and on the CPU
    (plain versions) from the same weights agree."""
    from distributed_tensorflow_tpu_torch import GPT, gpt_tiny
    init = GPT(gpt_tiny(), device="cpu").state_dict()
    runs = []
    for device in ("cuda", "cpu"):
        model = GPT(gpt_tiny(dropout_rate=0.0), device=device)
        model.load_state_dict(init)
        state, step = _train_setup(torch, model, TRAIN_LR, 0)
        batch = _train_batch(torch, np, 1, 4, 32, 512, device)
        losses = []
        for _ in range(3):
            state, metrics = step(state, batch)
            losses.append(metrics["loss"].item())
        runs.append((losses, {k: p.detach().cpu()
                              for k, p in state.params.items()}))
    (card_l, card_p), (cpu_l, cpu_p) = runs
    loss_err = max(abs(a - b) for a, b in zip(card_l, cpu_l))
    param_err = max((card_p[k] - cpu_p[k]).abs().max().item()
                    for k in cpu_p)
    log({"train_reference": "gpt_tiny f32, 3 steps", "card_losses": card_l,
         "cpu_losses": cpu_l, "loss_err": loss_err, "loss_tol":
         TRAIN_LOSS_TOL, "param_err": param_err,
         "param_tol": TRAIN_PARAM_TOL})
    if not (loss_err <= TRAIN_LOSS_TOL and param_err <= TRAIN_PARAM_TOL):
        raise AssertionError("card and CPU training disagree")


def check_train_then_serve(torch, np, model):
    """Phase 8: the trained weights serve through Engine, with no
    autograd graph."""
    from distributed_tensorflow_tpu_torch import Engine
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, 50257, n, dtype=np.int32) for n in (40, 130)]
    budgets = [8, 16]
    eng = Engine(model, device=model.device, num_slots=2, max_len=256,
                 prefill_chunk=32, tick_steps=4)
    hs = [eng.submit(p, b) for p, b in zip(prompts, budgets)]
    eng.drain()
    for h, b in zip(hs, budgets):
        if h.status != "ok" or len(h.tokens) != b:
            raise AssertionError(f"request {h.rid}: status {h.status}, "
                                 f"{len(h.tokens)} of {b} tokens")
    c = model.config
    kv = {n: torch.zeros(c.num_layers, 3, 16, c.kv_heads, c.head_dim,
                         dtype=c.dtype, device=model.device)
          for n in ("k", "v")}
    logits, _ = model.decode_window_paged(
        kv, torch.from_numpy(prompts[0][None, :16]).to(model.device),
        torch.tensor([1, 2], dtype=torch.int32, device=model.device), 0)
    if logits.requires_grad or any(p.grad is not None
                                   for p in model.parameters()):
        raise AssertionError("serving built an autograd graph")
    log({"train_then_serve": "ok", "tokens": [len(h.tokens) for h in hs]})


# -- phase 17: the training session ----------------------------------------

_SESSION_DIR = Path(__file__).resolve().parent / "build" / "train_session"


def _train_counts(torch):
    """The training kernels' launches since ``_reset_counts``."""
    from distributed_tensorflow_tpu_torch.ops.kernels import \
        flash_attention as fa
    from distributed_tensorflow_tpu_torch.ops.kernels import fused
    torch.cuda.synchronize()
    return {"flash_forward": fa.LAUNCHES["flash_forward"],
            "flash_backward_dkv": fa.LAUNCHES["flash_backward_dkv"],
            "flash_backward_dq": fa.LAUNCHES["flash_backward_dq"],
            "layernorm": fused.LAUNCHES["layernorm"],
            "fused_adam": fused.LAUNCHES["adam"]}


def _per_step(config, n_params, remat, microbatches):
    """Each training kernel's launches a step, written before the run:
    per microbatch the flash forward once a layer (twice under remat: the
    backward recomputes every block, and no remat policy saves a kernel
    the dispatcher never sees), dK/dV and dQ once a layer, LayerNorm 2 a
    layer plus ``ln_f`` (plus 2 a layer recomputed); Adam once a
    parameter tensor a step it applies."""
    L = config.num_layers
    return {"flash_forward": L * (2 if remat else 1) * microbatches,
            "flash_backward_dkv": L * microbatches,
            "flash_backward_dq": L * microbatches,
            "layernorm": (2 * L + 1 + (2 * L if remat else 0))
            * microbatches,
            "fused_adam": n_params}


def _check_counts(name, counts, per_step, steps, applied=None):
    applied = steps if applied is None else applied
    for k, n in per_step.items():
        want = n * (applied if k == "fused_adam" else steps)
        if counts[k] != want:
            raise AssertionError(f"{name}: {k} launched {counts[k]} times, "
                                 f"expected {want} ({n} a step)")


def _session_batches(torch, np, args, n):
    """``n`` batches of 48 rows of 257 ids (on the card) from the order-1
    synthetic corpus through ``Dataset``, as ``examples/train_gpt.py``
    draws them."""
    from distributed_tensorflow_tpu_torch.data import (Dataset,
                                                       lm_sequences,
                                                       synthetic_lm_corpus)
    rows = lm_sequences(synthetic_lm_corpus(
        50257, n * TRAIN_BATCH * (TRAIN_SEQ + 1) + TRAIN_SEQ + 1,
        seed=args.seed, order=1), TRAIN_SEQ)
    ds = Dataset([rows], TRAIN_BATCH, seed=args.seed)
    return [{"input_ids": torch.from_numpy(b).to("cuda")}
            for (b,) in list(ds)[:n]]


def _gpt2(torch, args, **kw):
    from distributed_tensorflow_tpu_torch import GPT, gpt_small
    kw.setdefault("dropout_rate", 0.0)
    return GPT(gpt_small(dtype=torch.bfloat16, **kw), device="cuda",
               generator=torch.Generator("cuda").manual_seed(args.seed))


def _session_arm(torch, np, args, smi, name, batches, accum=1, **config):
    """One of arms (a)-(d): 2 warm-up and 4 timed steps of ``adamw`` with
    clip 1.0 on ``batches`` (one per step)."""
    from distributed_tensorflow_tpu_torch import (TrainState, adamw,
                                                  make_custom_train_step)
    model = _gpt2(torch, args, **config)
    params = dict(model.named_parameters())
    opt = adamw(TRAIN_LR)
    state = TrainState.create(params, opt.init(params))
    step = make_custom_train_step(model.lm_loss_fn(), opt, seed=args.seed,
                                  grad_clip_norm=1.0, accum_steps=accum)
    per_step = _per_step(model.config, len(params), model.config.remat,
                         accum)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    metrics = []
    state, m = step(state, batches[0])
    metrics.append(m)
    torch.cuda.synchronize()
    (state, m), syncs = _counted(torch, lambda: step(state, batches[1]))
    metrics.append(m)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(SESSION_STEPS):
        state, m = step(state, batches[SESSION_WARMUP + i])
        metrics.append(m)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _train_counts(torch)
    losses = [m["loss"].item() for m in metrics]
    step_ms = wall / SESSION_STEPS * 1e3
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops = _model_flops(model, tokens, TRAIN_SEQ)
    c = model.config
    run = {"train_session": name, "remat": c.remat,
           "remat_policy": c.remat_policy if c.remat else None,
           "loss_seq_chunk": c.loss_seq_chunk, "accum_steps": accum,
           "steps": SESSION_STEPS, "step_ms": step_ms,
           "tokens_per_s": tokens / (step_ms / 1e3),
           "mfu": flops / (step_ms / 1e3) / BF16_FLOPS_PER_S,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "losses": losses, "launches": counts,
           "launches_per_step": per_step, "syncs_per_step": syncs,
           "card": smi}
    log(run)
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{name}: non-finite loss {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{name}: loss did not fall: {losses}")
    _check_counts(name, counts, per_step, SESSION_WARMUP + SESSION_STEPS)
    if syncs:
        raise AssertionError(f"{name}: {syncs} host syncs in a step")
    del model, params, opt, state, step, metrics
    torch.cuda.empty_cache()
    return run


def _session_setup(torch, args):
    """The session's model, state and step (arms (e), (f) and the
    uninterrupted run): ``with_ema(adamw)``, mixed bf16, a dynamic loss
    scale from ``SESSION_SCALE``, remat "full", the chunked head, 2
    microbatches, dropout 0.1."""
    from distributed_tensorflow_tpu_torch import (TrainState, adamw,
                                                  make_custom_train_step,
                                                  with_ema)
    from distributed_tensorflow_tpu_torch.train import precision
    model = _gpt2(torch, args, dropout_rate=0.1, remat=True,
                  loss_seq_chunk=SESSION_CHUNK)
    params = dict(model.named_parameters())
    opt = with_ema(adamw(TRAIN_LR))
    state = precision.attach_loss_scale(
        TrainState.create(params, opt.init(params)),
        precision.DynamicLossScale.create(SESSION_SCALE, device="cuda"))
    step = make_custom_train_step(model.lm_loss_fn(), opt, seed=args.seed,
                                  grad_clip_norm=1.0,
                                  accum_steps=SESSION_E_ACCUM,
                                  policy="mixed_bfloat16", loss_scale=True)
    return model, state, step


def _session_run(torch, state, step, batches, last_step, hooks=(),
                 checkpoint_dir=None, watch=True):
    """A ``TrainSession`` to ``last_step`` with ``hooks``: (the final
    state, a row per step, syncs per step, save seconds, the session's
    construction seconds (its restore), the loop's seconds).

    ``watch=True``: every step runs under the sync counter and a hook
    reads its finite flag, scale and loss at once, and on a skipped step
    compares the parameters with a copy taken before it; not timed.
    ``watch=False``: the loop runs as a user's does, with nothing of the
    harness between the steps; the rows' device values are read after
    the loop, whose wall time (saves included) is the session's window."""
    from distributed_tensorflow_tpu_torch import train
    from distributed_tensorflow_tpu_torch.ops.kernels import fused
    rows, syncs, saves = [], [], []

    def counted(state, batch):
        out, n = _counted(torch, lambda: step(state, batch))
        syncs.append(n)
        return out

    def read(row):
        return {**row, "finite": bool(row["finite"]),
                "scale": float(row["scale"]), "loss": float(row["loss"])}

    class Watch(train.Hook):
        """Per step: Adam launches and the optimizer count (host values)
        and, watched, the parameters before it; its finite flag, scale and
        loss after."""

        def before_step(self, session):
            st = session.state
            if watch:
                self.before = [p.detach().clone()
                               for p in st.params.values()]
            self.count = st.opt_state.count
            self.adam = fused.LAUNCHES["adam"]

        def after_step(self, session, metrics):
            st = session.state
            row = {"step": session.step, "finite": metrics["grads_finite"],
                   "scale": metrics["loss_scale"], "loss": metrics["loss"],
                   "adam": fused.LAUNCHES["adam"] - self.adam,
                   "count": st.opt_state.count}
            if watch:
                row = read(row)
                if not row["finite"]:
                    row["params_equal"] = all(
                        torch.equal(a, b)
                        for a, b in zip(self.before, st.params.values()))
                    row["count_held"] = st.opt_state.count == self.count
                self.before = None
            rows.append(row)

    class Timed(train.TrainSession):
        def save(self):
            t0 = time.perf_counter()
            path = super().save()
            saves.append(time.perf_counter() - t0)
            return path

    t0 = time.perf_counter()
    sess = Timed(state, counted if watch else step,
                 checkpoint_dir=checkpoint_dir,
                 hooks=[train.StopAtStepHook(last_step=last_step),
                        *hooks, Watch()])
    built = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with sess:
        while not sess.should_stop():
            sess.run_step(batches[sess.step])
    torch.cuda.synchronize()
    loop = time.perf_counter() - t0
    if not watch:
        rows = [read(r) for r in rows]
    return sess.state, rows, syncs, saves, built, loop


def _check_skips(name, rows, per_step_adam):
    """On each skipped step the parameters stayed bit-equal, Adam
    launched 0 times, the count held and the scale halved; every applied
    step launched Adam once a tensor, reported a finite loss and kept the
    scale (it grows only after 2000 finite steps)."""
    prev = SESSION_SCALE
    for r in rows:
        if not r["finite"]:
            if not (r["params_equal"] and r["count_held"]
                    and r["adam"] == 0 and r["scale"] == prev / 2):
                raise AssertionError(f"{name}: skipped step {r}, scale "
                                     f"before {prev}")
        else:
            if r["scale"] != prev or r["adam"] != per_step_adam \
                    or not math.isfinite(r["loss"]):
                raise AssertionError(f"{name}: applied step {r}")
        prev = r["scale"]


def _event_records(log_dir):
    from distributed_tensorflow_tpu_torch.data import read_tfrecord
    return {p.name: len(list(read_tfrecord(str(p))))
            for p in sorted(Path(log_dir).glob("events.out.tfevents.*"))}


def check_train_session(torch, np, args, smi, phase6):
    """Phase 17: arms (a)-(g) of the training session.  Returns the
    training kernels' launches over the session's (e) and (f)."""
    from distributed_tensorflow_tpu_torch import SummaryWriter, train
    from distributed_tensorflow_tpu_torch.optim import ema_params
    from distributed_tensorflow_tpu_torch.train import checkpoint as ckpt
    t_phase = time.perf_counter()
    shutil.rmtree(_SESSION_DIR, ignore_errors=True)
    batches = _session_batches(torch, np, args,
                               max(SESSION_END,
                                   SESSION_WARMUP + SESSION_STEPS))
    arms = {
        "a": _session_arm(torch, np, args, smi, "(a) remat full", batches,
                          remat=True),
        "b": _session_arm(torch, np, args, smi, "(b) remat dots", batches,
                          remat=True, remat_policy="dots"),
        "c": _session_arm(torch, np, args, smi,
                          "(c) remat full + chunked loss", batches,
                          remat=True, loss_seq_chunk=SESSION_CHUNK)}
    phase6_batch = _train_batch(torch, np, args.seed, TRAIN_BATCH, TRAIN_SEQ,
                                50257, "cuda")
    arms["d"] = _session_arm(
        torch, np, args, smi, "(d) accumulation x4 on phase 6's batch",
        [phase6_batch] * (SESSION_WARMUP + SESSION_STEPS),
        accum=SESSION_ACCUM)
    errs = [abs(a - b) for a, b in zip(arms["d"]["losses"],
                                       phase6["losses"])]
    log({"train_session": "(d) against phase 6", "loss_err": errs,
         "first_tol": ACCUM_FIRST_TOL, "tol": ACCUM_LOSS_TOL})
    if not (errs[0] <= ACCUM_FIRST_TOL and max(errs) <= ACCUM_LOSS_TOL):
        raise AssertionError(f"(d) losses {arms['d']['losses']} against "
                             f"phase 6's {phase6['losses']}")
    for k in ("a", "c"):
        if not arms[k]["peak_memory_gb"] < phase6["peak_memory_gb"]:
            raise AssertionError(f"({k}) peak {arms[k]['peak_memory_gb']} "
                                 f"GB, phase 6 {phase6['peak_memory_gb']}")

    # the uninterrupted run (the session's timed window), then (e) to
    # SESSION_STOP and (f) on to the end (watched); every session batch
    # carries a loss mask of ones
    mask = torch.ones(TRAIN_BATCH, TRAIN_SEQ, device="cuda")
    batches = [dict(b, loss_mask=mask) for b in batches[:SESSION_END]]
    ckpt_dir, log_dir = _SESSION_DIR / "ckpt", _SESSION_DIR / "logs"
    session_counts = collections.Counter()

    def hooks(writer):
        return [train.LoggingHook(every_steps=SESSION_EVERY),
                train.NaNHook(every_steps=1),
                train.StepCounterHook(every_steps=SESSION_EVERY,
                                      writer=writer, batch_size=TRAIN_BATCH),
                train.SummaryHook(writer, every_steps=1),
                train.CheckpointHook(every_steps=SESSION_EVERY,
                                     every_secs=None)]

    model, state, step = _session_setup(torch, args)
    per_step = _per_step(model.config, len(state.params), True,
                         SESSION_E_ACCUM)
    _reset_counts()
    writer = SummaryWriter(str(log_dir / "whole"))
    whole, rows_w, _, saves_w, _, loop_w = _session_run(
        torch, state, step, batches, SESSION_END, hooks(writer),
        str(_SESSION_DIR / "whole"), watch=False)
    writer.close()
    counts_w = _train_counts(torch)
    applied_w = sum(r["finite"] for r in rows_w)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops = _model_flops(model, tokens, TRAIN_SEQ)
    save_w = sum(saves_w)
    log({"train_session": "(e)+(f) uninterrupted, one window",
         "steps": f"1..{SESSION_END}", "applied_steps": applied_w,
         "window_s": loop_w, "save_s": saves_w,
         "step_ms_excl_saves": (loop_w - save_w) / SESSION_END * 1e3,
         "tokens_per_s_window": applied_w * tokens / loop_w,
         "tokens_per_s_excl_saves": applied_w * tokens / (loop_w - save_w),
         "mfu_excl_saves": applied_w * flops / (loop_w - save_w)
         / BF16_FLOPS_PER_S,
         "rows": rows_w, "launches": counts_w, "card": smi})
    if rows_w[0]["finite"] or applied_w < 3:
        raise AssertionError(f"uninterrupted run: expected the first steps "
                             f"to overflow and at least 3 to apply: "
                             f"{rows_w}")
    _check_counts("uninterrupted", counts_w, per_step, SESSION_END,
                  applied_w)

    for arm, last in (("(e) session", SESSION_STOP),
                      ("(f) resumed session", SESSION_END)):
        m_arm, s_arm, step_arm = _session_setup(torch, args)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        arm_logs = log_dir / arm[1]
        writer = SummaryWriter(str(arm_logs))
        final, rows, syncs, saves, built, _ = _session_run(
            torch, s_arm, step_arm, batches, last, hooks(writer),
            str(ckpt_dir))
        writer.close()
        counts = _train_counts(torch)
        session_counts.update(counts)
        first = SESSION_STOP if arm.startswith("(f)") else 0
        applied = sum(r["finite"] for r in rows)
        newest = ckpt.latest_checkpoint(str(ckpt_dir))
        log({"train_session": arm, "steps": f"{first + 1}..{last}",
             "restore_s": built, "save_ms": [t * 1e3 for t in saves],
             "checkpoint_bytes": (Path(newest) / "arrays.npz").stat().st_size,
             "rows": rows, "syncs_per_step": syncs,
             "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
             "launches": counts, "launches_per_step": per_step,
             "event_records": _event_records(arm_logs), "card": smi})
        if set(syncs) != {1}:
            raise AssertionError(f"{arm}: host syncs a step {syncs}")
        if [r["step"] for r in rows] != list(range(first + 1, last + 1)):
            raise AssertionError(f"{arm}: ran steps {rows}")
        if [{k: r[k] for k in rows_w[0]} for r in rows] != \
                rows_w[first:last]:
            raise AssertionError(f"{arm}: steps {rows} differ from the "
                                 f"uninterrupted run's {rows_w[first:last]}")
        _check_counts(arm, counts, per_step, last - first, applied)
        if first == 0:
            _check_skips(arm, rows, per_step["fused_adam"])
            del m_arm, s_arm, step_arm, final
            torch.cuda.empty_cache()
    # (f): bit-equal to the uninterrupted run
    for k, p in whole.params.items():
        if not torch.equal(final.params[k], p):
            raise AssertionError(f"(f) resumed parameter {k} differs")
    ema_w, ema_f = ema_params(whole.opt_state), ema_params(final.opt_state)
    for k, p in ema_w.items():
        if not torch.equal(ema_f[k], p):
            raise AssertionError(f"(f) resumed EMA shadow {k} differs")
    # an event file an arm: the version record, a summary a step, a step
    # counter every SESSION_EVERY steps
    for arm, steps in (("whole", SESSION_END), ("e", SESSION_STOP),
                       ("f", SESSION_END - SESSION_STOP)):
        records = list(_event_records(log_dir / arm).values())
        if records != [1 + steps + steps // SESSION_EVERY]:
            raise AssertionError(f"({arm}) event files hold {records} "
                                 "records")
    # a flipped byte in the newest checkpoint: quarantined, one step back
    newest = Path(ckpt.latest_checkpoint(str(ckpt_dir)))
    data = bytearray((newest / "arrays.npz").read_bytes())
    data[len(data) // 2] ^= 0xFF
    (newest / "arrays.npz").write_bytes(bytes(data))
    t0 = time.perf_counter()
    restored, path = ckpt.restore_latest_good(whole, str(ckpt_dir))
    fallback_s = time.perf_counter() - t0
    quarantined = sorted(p.name for p in ckpt_dir.glob("corrupt-*"))
    log({"train_session": "(f) flipped byte", "restored": Path(path).name,
         "quarantined": quarantined, "verify_and_restore_s": fallback_s})
    if Path(path).name != f"ckpt-{SESSION_STOP:010d}" or \
            restored.step != SESSION_STOP or \
            quarantined != [f"corrupt-{newest.name}"]:
        raise AssertionError(f"fallback restored {path}, quarantined "
                             f"{quarantined}")
    del model, state, step, whole, final, restored, ema_w, ema_f
    torch.cuda.empty_cache()
    shutil.rmtree(_SESSION_DIR, ignore_errors=True)
    check_train_session_reference(torch, np)
    log({"phase": "train session", "seconds": time.perf_counter() - t_phase})
    return session_counts


def _tiny_run(torch, np, device, steps=3, accum=1, planted=None, **config):
    """(losses, parameters) of ``steps`` f32 gpt_tiny steps on ``device``
    from the CPU's seed-0 weights, with a mask whose row counts differ;
    ``planted``: a step whose mask carries an infinite weight (under a
    loss scale from 2**20: a skip)."""
    from distributed_tensorflow_tpu_torch import (GPT, TrainState, adamw,
                                                  gpt_tiny,
                                                  make_custom_train_step)
    from distributed_tensorflow_tpu_torch.train import precision
    config.setdefault("dropout_rate", 0.0)
    init = GPT(gpt_tiny(**config), device="cpu").state_dict()
    model = GPT(gpt_tiny(**config), device=device)
    model.load_state_dict(init)
    params = dict(model.named_parameters())
    opt = adamw(TRAIN_LR)
    state = TrainState.create(params, opt.init(params))
    if planted is not None:
        state = precision.attach_loss_scale(
            state, precision.DynamicLossScale.create(2.0 ** 20,
                                                     device=device))
    step = make_custom_train_step(model.lm_loss_fn(), opt, seed=1,
                                  grad_clip_norm=1.0, accum_steps=accum,
                                  loss_scale=planted is not None)
    rng = np.random.default_rng(4)
    losses = []
    for i in range(steps):
        ids = rng.integers(0, 512, (4, 33))
        mask = (rng.random((4, 32)) < [[0.3], [0.6], [0.9], [1.0]]).astype(
            np.float32)
        if i == planted:
            mask[0, 0] = np.inf
        state, m = step(state, {"input_ids": torch.from_numpy(ids).to(device),
                                "loss_mask": torch.from_numpy(mask).to(
                                    device)})
        losses.append(m["loss"].item())
    return losses, {k: p.detach().cpu() for k, p in params.items()}


def check_train_session_reference(torch, np):
    """Phase 17(g): card against CPU on gpt_tiny f32, and remat against no
    remat on the card with dropout."""
    cases = {"accumulation x2": dict(accum=2),
             "remat full": dict(remat=True),
             "remat dots": dict(remat=True, remat_policy="dots"),
             "remat dots_no_batch": dict(remat=True,
                                         remat_policy="dots_no_batch"),
             "chunked loss 48": dict(loss_seq_chunk=48),
             "loss scale, planted overflow": dict(planted=1)}
    out = {}
    for name, kw in cases.items():
        (card_l, card_p), (cpu_l, cpu_p) = (
            _tiny_run(torch, np, d, **kw) for d in ("cuda", "cpu"))
        loss_err = max(abs(a - b) for a, b in zip(card_l, cpu_l))
        param_err = max((card_p[k] - cpu_p[k]).abs().max().item()
                        for k in cpu_p)
        out[name] = {"card_losses": card_l, "cpu_losses": cpu_l,
                     "loss_err": loss_err, "param_err": param_err}
        if not (loss_err <= TRAIN_LOSS_TOL and param_err <= TRAIN_PARAM_TOL):
            raise AssertionError(f"(g) {name}: card and CPU disagree: "
                                 f"{out[name]}")
    plain = _tiny_run(torch, np, "cuda", dropout_rate=0.1)
    for policy in ("full", "dots", "dots_no_batch"):
        got = _tiny_run(torch, np, "cuda", dropout_rate=0.1, remat=True,
                        remat_policy=policy)
        equal = got[0] == plain[0] and all(
            torch.equal(got[1][k], p) for k, p in plain[1].items())
        out[f"card remat {policy} vs none, dropout 0.1"] = {"equal": equal}
        if not equal:
            raise AssertionError(f"(g) remat {policy} with dropout differs "
                                 "from no remat on the card")
    log({"train_session": "(g) card against CPU, gpt_tiny f32, 3 steps",
         "loss_tol": TRAIN_LOSS_TOL, "param_tol": TRAIN_PARAM_TOL,
         "cases": out})


# -- phase 18: example.py's XOR MLP ------------------------------------------

_XOR_DIR = Path(__file__).resolve().parent / "build" / "xor_example"


def _xor_model(ops, rate):
    return ops.serial(ops.Dense(128, activation="relu"), ops.Dropout(rate),
                      ops.Dense(128, activation="relu"), ops.Dropout(rate),
                      ops.Dense(32, activation="sigmoid"))


def _xor_tree(np, seed):
    """The XOR MLP's weights, in the JAX package's tree, from ``seed``:
    glorot-uniform kernels, small uniform biases."""
    rng = np.random.default_rng(seed)
    tree = {}
    for name, (i, o) in (("dense", (64, 128)), ("dense_1", (128, 128)),
                         ("dense_2", (128, 32))):
        lim = math.sqrt(6.0 / (i + o))
        tree[name] = {
            "kernel": rng.uniform(-lim, lim, (i, o)).astype(np.float32),
            "bias": rng.uniform(-0.05, 0.05, (o,)).astype(np.float32)}
    return tree


def _adam_leaves(torch, args, shapes, tag):
    """The Adam kernel against its plain version at ``shapes``, at steps
    1 and 3, called as ``optim.adam()`` calls it; per shape the kernel's
    ms and graph ms, the plain ms, the bound (28 bytes an element) and
    ``torch.optim.Adam(fused=True)`` on the same tensor, its ms and its
    graph ms (``capturable=True``, so that its step count lives on the
    card and a graph can hold it).  Returns the largest error."""
    from distributed_tensorflow_tpu_torch.ops.kernels import fused
    gen = torch.Generator("cuda").manual_seed(args.seed)
    kw = dict(lr=1e-3, tf14_eps=True, return_delta=True)
    worst = 0.0
    for shape in shapes:
        p, g, m = (torch.randn(shape, generator=gen, device="cuda")
                   for _ in range(3))
        v = torch.rand(shape, generator=gen, device="cuda")
        errs = []
        for step in (1, 3):
            want = fused.adam_plain(p, g, m, v, step, **kw)
            m2, v2 = m.clone(), v.clone()
            got = fused.fused_adam_update(p, g, m2, v2, step,
                                          out=(None, m2, v2), **kw)
            torch.cuda.synchronize()
            errs.append(max((a - b).abs().max().item()
                            for a, b in zip(got, want)))
        if not max(errs) <= ADAM_TOL:
            raise AssertionError(f"Adam kernel at {shape} disagrees: {errs}")
        worst = max(worst, *errs)
        ms = time_ms(torch, lambda: fused.fused_adam_update(
            p, g, m2, v2, 3, out=(None, m2, v2), **kw), args.iters)
        plain = time_ms(torch, lambda: fused.adam_plain(
            p, g, m2, v2, 3, out=(None, m2, v2), **kw), args.iters)
        g_ms = graph_ms(torch, lambda: fused.fused_adam_update(
            p, g, m2, v2, 3, out=(None, m2, v2), **kw), args.iters)
        lib_p = p.clone()
        lib_p.grad = g
        lib = time_ms(torch, torch.optim.Adam([lib_p], lr=1e-3,
                                              fused=True).step, args.iters)
        cap_p = p.clone()
        cap_p.grad = g
        lib_graph, why = _graph_or_why(torch, torch.optim.Adam(
            [cap_p], lr=1e-3, fused=True, capturable=True).step, args.iters)
        n = p.numel()
        b_ms, b_by = bound_ms(28.0 * n, 12.0 * n)
        log({tag: "(a) fused_adam", "shape": list(shape),
             "max_abs_err": errs, "tol": ADAM_TOL, "kernel_ms": ms,
             "graph_ms": g_ms, "plain_ms": plain,
             "library_ms": lib, "library_graph_ms": lib_graph,
             **({"library_graph_note": why} if why else {}),
             "library": "torch.optim.Adam(fused=True).step()",
             "bound_ms": b_ms, "bound_by": b_by})
    return worst


def check_xor_reference(torch, np, args):
    """Phase 18 (b): ``make_train_step`` on the card against the CPU, one
    set of weights (``_xor_tree``), dropout 0, ``XOR_REF_STEPS`` steps on
    the same batches, in f32 with TF32 off.  Returns (the weights, the
    batches, the card's parameters after ``XOR_DP_STEPS`` steps)."""
    from distributed_tensorflow_tpu_torch import data, ops, optim, train
    from distributed_tensorflow_tpu_torch.models.convert import \
        stack_params_from_jax
    precision = torch.get_float32_matmul_precision()
    if precision != "highest" or torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError(f"TF32 is on ({precision}): the XOR path is "
                             "held to the CPU in full f32")
    tree = _xor_tree(np, args.seed)
    (x, y), _ = data.xor_data(XOR_REF_STEPS * XOR_BATCH, 1, seed=args.seed)
    batches = [(x[i:i + XOR_BATCH], y[i:i + XOR_BATCH])
               for i in range(0, len(x), XOR_BATCH)]
    runs = {}
    for dev in ("cuda", "cpu"):
        opt = optim.adam()
        params = stack_params_from_jax(tree, device=dev)
        state = train.TrainState.create(params, opt.init(params), {})
        step = train.make_train_step(
            _xor_model(ops, 0.0), "mse", opt,
            metric_fns={"accuracy": "bitwise_accuracy"}, seed=args.seed)
        losses, early = [], None
        for i, (bx, by) in enumerate(batches):
            state, m = step(state, (torch.from_numpy(bx).to(dev),
                                    torch.from_numpy(by).to(dev)))
            losses.append(m["loss"])
            if i + 1 == XOR_DP_STEPS:
                early = {k: t.detach().clone()
                         for k, t in state.params.items()}
        runs[dev] = ([float(l) for l in losses], state.params, early)
    card, cpu = runs["cuda"], runs["cpu"]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(card[0], cpu[0]))
    param_err = max((card[1][k].detach().cpu() - cpu[1][k].detach())
                    .abs().max().item() for k in cpu[1])
    log({"xor": "(b) card vs CPU", "steps": XOR_REF_STEPS,
         "matmul_precision": precision,
         "allow_tf32": torch.backends.cuda.matmul.allow_tf32,
         "loss_rel_err": loss_err, "loss_tol": XOR_LOSS_RTOL,
         "param_err": param_err, "param_tol": XOR_PARAM_TOL,
         "losses_card": card[0][:3] + card[0][-2:]})
    if not (loss_err <= XOR_LOSS_RTOL and param_err <= XOR_PARAM_TOL):
        raise AssertionError(f"XOR card vs CPU: loss {loss_err}, params "
                             f"{param_err}")
    return tree, batches, card[2]


def _xor_epoch_time(torch, np, args, smi):
    """Phase 18 (c), first part: one epoch of ``example.py``'s step loop
    (the MLP at dropout 0.3, ``adam()``, batches of 50 through ``Dataset``
    and ``prefetch_to_device``), after a warm-up epoch: timed, then again
    under the profiler for the card's busy share.  Returns the timed
    epoch's seconds."""
    from distributed_tensorflow_tpu_torch import data, ops, optim, train
    from distributed_tensorflow_tpu_torch.obs import device as obs_device
    model, opt = _xor_model(ops, 0.3), optim.adam()
    state = train.init_train_state(
        model, opt, torch.Generator("cuda").manual_seed(args.seed), (64,))
    step = train.make_train_step(model, "mse", opt,
                                 metric_fns={"accuracy": "bitwise_accuracy"},
                                 seed=args.seed)
    (xt, yt), _ = data.xor_data(30000, 1000, seed=args.seed)
    ds = data.Dataset([xt, yt], XOR_BATCH, seed=args.seed)

    def epoch(n=None):
        nonlocal state
        total = None
        for batch in itertools.islice(
                data.prefetch_to_device(iter(ds), device="cuda"), n):
            state, m = step(state, batch)
            total = m["loss"] if total is None else total + m["loss"]
        return total

    epoch()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    epoch()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps = len(ds)
    part = steps // PROBE_PROFILED_PART
    t0 = time.perf_counter()
    epoch(part)
    torch.cuda.synchronize()
    part_wall = time.perf_counter() - t0
    _, busy_s, kernels = obs_device.device_busy(lambda: epoch(part))
    log({"xor": "(c) one epoch of the step loop", "steps": steps,
         "step_ms": wall / steps * 1e3, "steps_per_s": steps / wall,
         "samples_per_s": steps * XOR_BATCH / wall, "wall_s": wall,
         "profiled_steps": part, "device_busy_s": busy_s,
         "busy_share": busy_s / part_wall,
         "device_ops_per_step": kernels / part, "card": smi})
    return wall


def _run_entry(torch, main, argv):
    """(stdout, wall seconds) of one in-process run of an entry point's
    ``main``."""
    import contextlib
    import io
    out = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"entry point {argv} exited {rc}:\n"
                             f"{out.getvalue()}")
    return out.getvalue(), wall


def _xor_counts(torch):
    """The launches since ``_reset_counts``: Adam, every other kernel of
    the port summed, and the all-reduces."""
    from distributed_tensorflow_tpu_torch.ops.kernels import \
        flash_attention as fa
    from distributed_tensorflow_tpu_torch.ops.kernels import fused
    from distributed_tensorflow_tpu_torch.ops.kernels import \
        paged_attention as pa
    from distributed_tensorflow_tpu_torch.parallel import data_parallel
    torch.cuda.synchronize()
    other = (sum(fa.LAUNCHES.values()) + sum(pa.LAUNCHES.values())
             + sum(v for k, v in fused.LAUNCHES.items() if k != "adam"))
    return {"fused_adam": fused.LAUNCHES["adam"], "other_kernels": other,
            "all_reduce": data_parallel.LAUNCHES["all_reduce"]}


def _val_accs(out):
    """[(epoch, val accuracy)] of the entry point's epoch lines."""
    return [(int(line.split()[1]), float(line.split("val acc:")[1]))
            for line in out.splitlines() if line.startswith("Epoch:")]


def _graph_records(log_dir):
    """Graph records (Event field 4) in the event files of ``log_dir``."""
    from distributed_tensorflow_tpu_torch.data import read_tfrecord
    return sum(r[0] == 0x09 and r[9] == 0x22
               for p in Path(log_dir).glob("events.out.tfevents.*")
               for r in read_tfrecord(str(p)))


def check_xor(torch, np, args, smi):
    """Phase 18: ``example.py``'s path.  Returns the Adam launches of the
    entry point's run, (c)."""
    import torch.distributed as dist

    from distributed_tensorflow_tpu_torch import (example, ops, optim,
                                                  parallel, train)
    from distributed_tensorflow_tpu_torch.models.convert import \
        stack_params_from_jax
    from distributed_tensorflow_tpu_torch.parallel import cluster
    from distributed_tensorflow_tpu_torch.train import checkpoint as ckpt
    t_phase = time.perf_counter()
    shutil.rmtree(_XOR_DIR, ignore_errors=True)

    worst = _adam_leaves(torch, args, XOR_SHAPES, "xor")
    tree, batches, card_early = check_xor_reference(torch, np, args)

    # (c) the entry point at example.py's configuration; E from one
    # epoch's time: 50 epochs (the reference's default) when (c) and (d)
    # fit XOR_BUDGET_S, else XOR_EPOCHS_SHORT
    epoch_s = _xor_epoch_time(torch, np, args, smi)
    epochs = XOR_EPOCHS if epoch_s * (XOR_EPOCHS + 1) <= XOR_BUDGET_S \
        else XOR_EPOCHS_SHORT
    steps = epochs * XOR_STEPS_PER_EPOCH
    argv = ["--device=cuda", f"--log_dir={_XOR_DIR}", f"--seed={args.seed}"]
    _reset_counts()
    out, wall = _run_entry(torch, example.main, argv + [f"--epochs={epochs}"])
    counts = _xor_counts(torch)
    accs = _val_accs(out)
    first_pass = next((e for e, a in accs if a > XOR_ACC), None)
    log({"xor": "(c) entry point", "epochs": epochs, "steps": steps,
         "wall_s": wall, "step_ms": wall / steps * 1e3,
         "steps_per_s": steps / wall,
         "samples_per_s": steps * XOR_BATCH / wall, "launches": counts,
         "val_acc": accs, "first_print_over_0.95": first_pass,
         "checkpoint_step": ckpt.latest_step(str(_XOR_DIR)),
         "graph_records": _graph_records(_XOR_DIR), "card": smi,
         "stdout_tail": out.splitlines()[-3:]})
    if not accs or not accs[-1][1] > XOR_ACC:
        raise AssertionError(f"XOR val accuracy {accs} not above {XOR_ACC}")
    if counts["fused_adam"] != 6 * steps or counts["other_kernels"] \
            or counts["all_reduce"]:
        raise AssertionError(f"XOR launches {counts}; expected Adam "
                             f"{6 * steps} (6 a step), nothing else")
    if ckpt.latest_step(str(_XOR_DIR)) != steps \
            or _graph_records(_XOR_DIR) != 1:
        raise AssertionError("XOR: no checkpoint at the last step or no "
                             "graph record in the event file")
    xor_launches = counts["fused_adam"]

    # (d) resume: one more epoch from the checkpoint, its host syncs
    # counted in each step
    syncs = []
    make = train.make_train_step

    def counted_builder(*a, **kw):
        step = make(*a, **kw)

        def counted(state, batch):
            out_, n = _counted(torch, lambda: step(state, batch))
            syncs.append(n)
            return out_
        return counted

    _reset_counts()
    train.make_train_step = counted_builder
    try:
        out, wall = _run_entry(torch, example.main,
                               argv + [f"--epochs={epochs + 1}"])
    finally:
        train.make_train_step = make
    counts = _xor_counts(torch)
    restored = (f"Restored checkpoint ckpt-{steps:010d} at step {steps}"
                in out)
    last = [line for line in out.splitlines() if line.startswith("Epoch:")]
    log({"xor": "(d) resume", "restored_at": steps if restored else None,
         "steps": len(syncs), "host_syncs": sum(syncs), "launches": counts,
         "wall_s": wall, "epoch_line": last[-1:], "card": smi})
    if not restored or len(syncs) != XOR_STEPS_PER_EPOCH \
            or not last or not last[-1].startswith(f"Epoch: {epochs:4d}"):
        raise AssertionError(f"XOR resume: restored {restored}, "
                             f"{len(syncs)} steps, {last}")
    if sum(syncs) or counts["fused_adam"] != 6 * XOR_STEPS_PER_EPOCH:
        raise AssertionError(f"XOR resume: {sum(syncs)} host syncs in the "
                             f"steps, launches {counts}")

    # (e) the data-parallel path at world size 1 over NCCL
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    config = cluster.initialize(cluster.cluster_from_env(environ={
        "COORDINATOR_ADDRESS": f"localhost:{port}", "NUM_PROCESSES": "1",
        "PROCESS_ID": "0"}), timeout_s=120)
    try:
        backend = dist.get_backend()
        mesh = parallel.data_parallel_mesh()
        opt = optim.adam()
        params = stack_params_from_jax(tree, device="cuda")
        state = train.TrainState.create(params, opt.init(params), {})
        step = train.make_train_step(
            _xor_model(ops, 0.0), "mse", opt,
            metric_fns={"accuracy": "bitwise_accuracy"}, seed=args.seed,
            mesh=mesh)
        _reset_counts()
        for bx, by in batches[:XOR_DP_STEPS]:
            state, _ = step(state, (torch.from_numpy(bx).to("cuda"),
                                    torch.from_numpy(by).to("cuda")))
        counts = _xor_counts(torch)
        err = max((state.params[k].detach() - card_early[k]).abs().max()
                  .item() for k in card_early)
    finally:
        dist.destroy_process_group()
    log({"xor": "(e) data parallel, world size 1", "backend": backend,
         "coordinator": config.coordinator_address, "mesh": repr(mesh),
         "steps": XOR_DP_STEPS, "all_reduce_launches": counts["all_reduce"],
         "adam_launches": counts["fused_adam"],
         "param_err_vs_(b)": err, "tol": XOR_DP_TOL})
    if backend != "nccl" or counts["all_reduce"] != XOR_DP_STEPS \
            or not err <= XOR_DP_TOL:
        raise AssertionError(f"XOR data parallel: {backend}, {counts}, "
                             f"{err}")
    shutil.rmtree(_XOR_DIR, ignore_errors=True)
    log({"phase": "xor", "seconds": time.perf_counter() - t_phase,
         "adam_max_abs_err": worst})
    return xor_launches


def profile_engine(torch, np, args, smi, model, *, max_len=1024,
                   name="profile", parts=None):
    """``--profile DIR``: the engine phase's requests once more under
    ``torch.profiler``, after a warm-up and an unprofiled run of them;
    writes the kernel table to DIR/<name>.txt and prints the device's
    busy share, the top kernels by device time and, given ``parts``
    ((part, kernel-name marks), first match wins), device ms by part."""
    import os

    from torch.profiler import ProfilerActivity, profile

    prompts, budgets = _requests(np, args.seed, vocab=model.config.vocab_size)
    run_engine(torch, model, prompts[:2], budgets[:2], max_len=max_len)
    _, _, plain_wall = run_engine(torch, model, prompts, budgets, late=3,
                                  max_len=max_len)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, _, wall = run_engine(torch, model, prompts, budgets, late=3,
                                max_len=max_len)
    rows = _kernel_rows(prof)
    busy_s = sum(r[1] for r in rows) / 1e6
    os.makedirs(args.profile, exist_ok=True)
    with open(os.path.join(args.profile, f"{name}.txt"), "w") as f:
        f.write(f"{smi}\nwall_s {wall} (unprofiled {plain_wall})\n")
        for key, us, n in rows:
            f.write(f"{us / 1e3:12.3f} ms {n:8d}  {key}\n")
    result = {"wall_s": wall, "unprofiled_wall_s": plain_wall,
              "device_busy_s": busy_s,
              "busy_share_of_unprofiled_wall": busy_s / plain_wall,
              "top": [[k[:80], us / 1e3, n] for k, us, n in rows[:15]],
              "paged_us_per_launch": {k[:80]: us / n for k, us, n in rows
                                      if "paged_" in k},
              "card": smi}
    if parts:
        by_part = {}
        for key, us, _ in rows:
            part = next((p for p, marks in parts
                         if any(m in key for m in marks)),
                        "elementwise and reductions")
            by_part[part] = by_part.get(part, 0.0) + us / 1e3
        result["device_ms_by_part"] = dict(sorted(by_part.items(),
                                                  key=lambda kv: -kv[1]))
    log({name: result})


_DECODE_PARTS = (
    ("flash forward (ours)", ("flash_",)),
    ("LayerNorm (ours)", ("layernorm_",)),
    ("RMSNorm (ours)", ("rmsnorm_",)),
    ("GEMMs", ("nvjet", "gemm", "Gemm", "gemv", "splitK")),
    ("f32 -> bf16 weight casts and other copies", ("copy", "Copy")),
)


def profile_generate(torch, np, args, smi, model, name, batch, prompt, new):
    """``--profile DIR``: one greedy ``generate`` of ``batch`` prompts of
    ``prompt`` tokens + ``new`` under ``torch.profiler``, after an
    unprofiled run of the same call; writes the kernel table to
    DIR/<name>.txt and prints the device's busy share of the unprofiled
    wall and device ms by part."""
    import os

    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(args.seed + 15)
    ids = torch.from_numpy(rng.integers(0, model.config.vocab_size,
                                        (batch, prompt), dtype=np.int32)
                           ).to(model.device)
    model.generate(ids, 2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.generate(ids, new)
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        model.generate(ids, new)
        torch.cuda.synchronize()
    rows = _kernel_rows(prof)
    busy_s = sum(r[1] for r in rows) / 1e6
    os.makedirs(args.profile, exist_ok=True)
    with open(os.path.join(args.profile, f"{name}.txt"), "w") as f:
        f.write(f"{smi}\nunprofiled wall_s {plain_wall}\n")
        for key, us, n in rows:
            f.write(f"{us / 1e3:12.3f} ms {n:8d}  {key}\n")
    by_part = {}
    for key, us, _ in rows:
        part = next((p for p, marks in _DECODE_PARTS
                     if any(m in key for m in marks)),
                    "elementwise, reductions and dense attention")
        by_part[part] = by_part.get(part, 0.0) + us / 1e3
    log({name: {"shape": [batch, prompt, new],
                "unprofiled_wall_s": plain_wall, "device_busy_s": busy_s,
                "busy_share_of_unprofiled_wall": busy_s / plain_wall,
                "kernels": sum(n for _, _, n in rows),
                "device_ms_by_part": dict(sorted(by_part.items(),
                                                 key=lambda kv: -kv[1])),
                "top": [[k[:80], us / 1e3, n] for k, us, n in rows[:12]],
                "card": smi}})


def profile_paged_splits(torch, np, args, model):
    """``--profile DIR``: device µs per paged launch in the Llama engine at
    the planned split counts and at one forced split, over the same 4
    requests of the mix (budgets capped at 16), each under
    ``torch.profiler`` with device activity only."""
    from torch.profiler import ProfilerActivity, profile

    from distributed_tensorflow_tpu_torch.ops.kernels import \
        paged_attention as pa

    prompts, budgets = _requests(np, args.seed,
                                 vocab=model.config.vocab_size)
    budgets = [min(b, 16) for b in budgets[:4]]
    planned = pa._MAX_SPLITS
    result = {}
    for name, max_splits in (("planned", planned), ("one_split", 1)):
        pa._MAX_SPLITS = max_splits
        try:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                run_engine(torch, model, prompts[:4], budgets,
                           max_len=LLAMA_MAX_LEN)
        finally:
            pa._MAX_SPLITS = planned
        result[name] = {k[:80]: [us / n, n] for k, us, n in _kernel_rows(prof)
                        if "paged_" in k}
    log({"profile_llama_paged_splits": {"us_per_launch_and_launches": result,
                                        "requests": 4, "budgets": budgets}})


# kernel-name marks of the step's parts, first match wins
_TRAIN_PARTS = (
    ("GEMMs on cuBLAS's align1 path (the vocab-50257 tied head)",
     ("align1",)),
    ("other GEMMs", ("nvjet", "gemm", "Gemm")),
    ("flash attention (ours)", ("flash_",)),
    ("log-softmax and its gradient", ("SoftMax",)),
    ("Adam (ours)", ("adam_",)),
    ("LayerNorm forward (ours)", ("layernorm_",)),
)


def _profile_steps(torch, smi, name, state, step, batches, f):
    """3 steps of ``step`` (batches in turn) under ``torch.profiler``,
    after 2 warm-up steps and 3 timed unprofiled ones; writes the kernel
    table to ``f`` and logs the device's busy share, kernels a step and
    device ms by part."""
    from torch.profiler import ProfilerActivity, profile
    for i in range(2):
        state, _ = step(state, batches[i % len(batches)])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(3):
        state, _ = step(state, batches[i % len(batches)])
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(3):
            state, _ = step(state, batches[i % len(batches)])
        torch.cuda.synchronize()
    rows = _kernel_rows(prof)
    busy_s = sum(r[1] for r in rows) / 1e6
    parts = {}
    for key, us, _ in rows:
        part = next((name for name, marks in _TRAIN_PARTS
                     if any(m in key for m in marks)),
                    "elementwise, reductions, copies")
        parts[part] = parts.get(part, 0.0) + us / 1e3 / 3
    f.write(f"{name}: 3 steps, unprofiled wall_s {plain_wall}\n")
    for key, us, n in rows:
        f.write(f"{us / 1e3:12.3f} ms {n:8d}  {key}\n")
    log({"profile_train": {
        "config": name, "steps": 3, "unprofiled_wall_s": plain_wall,
        "device_busy_s": busy_s,
        "busy_share_of_unprofiled_wall": busy_s / plain_wall,
        "kernels_per_step": sum(r[2] for r in rows) / 3,
        "device_ms_per_step_by_part": dict(sorted(
            parts.items(), key=lambda kv: -kv[1])),
        "top": [[k[:80], us / 1e3, n] for k, us, n in rows[:15]],
        "card": smi}})
    return state


def profile_training(torch, np, args, smi):
    """``--profile DIR``: 3 training steps under ``torch.profiler`` (see
    ``_profile_steps``) of the phase-6 configuration, of phase 17's
    arms (a) and (b) (remat "full" and "dots") and of its session step
    (e) once its loss scale has settled (its first 7 steps skip); writes
    the kernel tables to DIR/profile_train.txt and prints each one's
    busy share and device ms by part."""
    import os

    from distributed_tensorflow_tpu_torch import (TrainState, adamw,
                                                  make_custom_train_step)
    batch = _train_batch(torch, np, args.seed, TRAIN_BATCH, TRAIN_SEQ,
                         50257, "cuda")
    os.makedirs(args.profile, exist_ok=True)
    with open(os.path.join(args.profile, "profile_train.txt"), "w") as f:
        f.write(f"{smi}\n")
        for name, config in (("phase 6", {}),
                             ("(a) remat full", {"remat": True}),
                             ("(b) remat dots", {"remat": True,
                                                 "remat_policy": "dots"})):
            model = _gpt2(torch, args, **config)
            params = dict(model.named_parameters())
            opt = adamw(TRAIN_LR)
            step = make_custom_train_step(model.lm_loss_fn(), opt,
                                          seed=args.seed, grad_clip_norm=1.0)
            _profile_steps(torch, smi, name,
                           TrainState.create(params, opt.init(params)),
                           step, [batch], f)
            del model, params, opt, step
            torch.cuda.empty_cache()
        batches = [dict(b, loss_mask=torch.ones(TRAIN_BATCH, TRAIN_SEQ,
                                                device="cuda"))
                   for b in _session_batches(torch, np, args, 3)]
        model, state, step = _session_setup(torch, args)
        for i in range(5):
            state, _ = step(state, batches[i % 3])
        _profile_steps(torch, smi, "(e) session step", state, step,
                       batches, f)


# kernel-name marks of the Llama engine's parts, first match wins
_LLAMA_PARTS = (
    ("paged attention, int8 (ours)", ("paged_cc_kernel", "paged_tc_kernel")),
    ("RMSNorm (ours)", ("rmsnorm_",)),
    ("GEMMs", ("nvjet", "gemm", "Gemm", "gemv", "splitK")),
    ("f32 -> bf16 weight casts and other copies", ("copy", "Copy")),
)

# -- phase 19: the high-level tier -------------------------------------

_SEQ_DIR = Path(__file__).resolve().parent / "build" / "seq_entry"
_OBS_DIR = Path(__file__).resolve().parent / "build" / "obs_session"


def _cnn_first_step(torch, m, x, y):
    """(loss, gradients by parameter name) of ``m``'s CIFAR CNN on one
    batch at its current weights: the train-mode forward at dropout 0,
    the loss and its gradients."""
    from distributed_tensorflow_tpu_torch.ops import losses
    dev = m.device
    params = m.state.params
    preds, _ = m.stack.apply(params, m.state.model_state,
                             torch.from_numpy(x).to(dev), train=True)
    loss = losses.get("sparse_categorical_crossentropy")(
        preds, torch.from_numpy(y).to(dev))
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss.item(), {k: g.detach().cpu()
                         for k, g in zip(params, grads)}


def _rel(got, want):
    """max |got - want| / max |want| of two tensors (on the CPU)."""
    got, want = got.detach().cpu().double(), want.detach().cpu().double()
    return float((got - want).abs().max() / want.abs().max())


# the card's precision modes of phase 19 (b): name -> (cudnn enabled,
# cudnn deterministic, TF32 in cuDNN); the last is the control
_CONV_MODES = {"cudnn": (True, False, False),
               "cudnn_deterministic": (True, True, False),
               "no_cudnn": (False, False, False),
               "cudnn_tf32_control": (True, False, True)}


def _conv_mode(torch, mode):
    """Set the cuDNN flags of ``mode``; returns what to restore."""
    b = torch.backends.cudnn
    saved = (b.enabled, b.deterministic, b.allow_tf32)
    b.enabled, b.deterministic, b.allow_tf32 = _CONV_MODES[mode]
    return saved


def _unset_conv_mode(torch, saved):
    b = torch.backends.cudnn
    b.enabled, b.deterministic, b.allow_tf32 = saved


def check_conv_precision(torch, np, args):
    """Phase 19 (b), first part: each of the CIFAR CNN's four convolutions
    at the main path's batch (``CIFAR_BATCH``), on its real input and
    upstream gradient (one f64 forward and backward on the CPU through
    the layers' own code, from ``--seed``'s weights and data): the
    product and its data and weight gradients in f32 on the CPU and on
    the card in each of ``_CONV_MODES``, each against the f64 values:
    max |got - want| / max |want|.  The sound modes must read at most
    ``CONV_TOL``, the TF32 control more (else the check could not tell
    the two apart).  Returns the worst sound reading by mode."""
    from distributed_tensorflow_tpu_torch import data, models, ops
    from distributed_tensorflow_tpu_torch.ops import layers as L
    from distributed_tensorflow_tpu_torch.ops import losses
    (x, y), _ = data.synthetic_image_classes((32, 32, 3), 10, CIFAR_BATCH,
                                             1, seed=args.seed)
    stack = models.cifar_cnn()
    params, _ = stack.init(torch.Generator().manual_seed(args.seed),
                           (32, 32, 3))
    params = {k: v.detach().double().requires_grad_()
              for k, v in params.items()}
    h = torch.from_numpy(x).double()
    taps = []
    for key, layer in zip(stack.keys, stack.layers):
        p = stack._layer_params(params, key)
        if isinstance(layer, ops.Conv2D):
            z = L._nhwc_conv(h, p["kernel"], layer.strides, layer.padding)
            z.retain_grad()
            taps.append((key, layer, h.detach(), p["kernel"].detach(), z))
            h = layer._finish(p, z)
        else:
            h, _ = layer.apply(p, {}, h, train=False)
    losses.get("sparse_categorical_crossentropy")(
        h, torch.from_numpy(y)).backward()

    def product(layer, xin, w, dz):
        xin, w = xin.requires_grad_(), w.requires_grad_()
        z = L._nhwc_conv(xin, w, layer.strides, layer.padding)
        dx, dw = torch.autograd.grad(z, (xin, w), dz)
        return z, dx, dw

    readings = {}
    for key, layer, xin, w, z in taps:
        want = product(layer, xin.clone(), w.clone(), z.grad)
        row = {"shape": list(xin.shape) + [int(w.shape[-1])]}
        runs = {"cpu_f32": ("cpu", None)}
        runs.update({m: ("cuda", m) for m in _CONV_MODES})
        for name, (dev, mode) in runs.items():
            saved = _conv_mode(torch, mode) if mode else None
            try:
                got = product(layer, xin.float().to(dev), w.float().to(dev),
                              z.grad.float().to(dev))
                torch.cuda.synchronize()
            finally:
                if saved:
                    _unset_conv_mode(torch, saved)
            row[name] = {n: _rel(g, wt) for n, g, wt in
                         zip(("y", "dx", "dw"), got, want)}
        readings[key] = row
    worst = {m: max(max(r[m].values()) for r in readings.values())
             for m in ("cpu_f32", *_CONV_MODES)}
    conv = getattr(torch.backends.cudnn, "conv", None)
    log({"seq": "(b) convolutions against f64", "batch": CIFAR_BATCH,
         "readings": readings, "worst": worst, "tol": CONV_TOL,
         "cudnn_version": torch.backends.cudnn.version(),
         "conv_fp32_precision": getattr(conv, "fp32_precision", None)})
    sound = [m for m in worst if m != "cudnn_tf32_control"]
    if max(worst[m] for m in sound) > CONV_TOL:
        raise AssertionError(f"convolutions off against f64: {worst}")
    if not worst["cudnn_tf32_control"] > CONV_TOL:
        raise AssertionError(
            f"the TF32 control reads {worst['cudnn_tf32_control']} <= "
            f"{CONV_TOL}: the limit cannot tell TF32 from f32")
    return worst


def _update_err(np, got, want, start):
    """Per leaf: ||(got - start) - (want - start)|| / ||want - start||,
    the parameters' change over the run held against the reference's."""
    out = []
    for g, w, s in zip(got, want, start):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        out.append(float(np.linalg.norm(g - w) / np.linalg.norm(w - s)))
    return out


def _cnn_grads(torch, stack, params, x, y, masks=None):
    """(loss, gradients by name, ReLU masks) of one batch of the CIFAR
    CNN, forward by hand through the layers' own code: a layer with a
    ReLU runs without it, and its pre-activation ``u`` is multiplied by a
    mask, its own ``u > 0`` or, where ``masks`` are given, those (another
    run's, so that both runs take the same side of every kink)."""
    import copy
    from distributed_tensorflow_tpu_torch.ops import losses
    dev = next(iter(params.values())).device
    h, out = torch.from_numpy(x).to(dev), []
    for key, layer in zip(stack.keys, stack.layers):
        p = stack._layer_params(params, key)
        if getattr(layer, "_raw", {}).get("activation") == "relu":
            bare = copy.copy(layer)
            bare.activation = lambda t: t
            u, _ = bare.apply(p, {}, h, train=True)
            m = (u > 0) if masks is None else masks[len(out)].to(u.device)
            out.append(m.cpu())
            h = u * m.to(u.dtype)
        else:
            h, _ = layer.apply(p, {}, h, train=True)
    loss = losses.get("sparse_categorical_crossentropy")(
        h, torch.from_numpy(y).to(h.device))
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss.item(), {k: g.detach().cpu()
                         for k, g in zip(params, grads)}, out


# the card's modes of (b)'s whole-model comparison: the main path's,
# cuDNN restricted to its deterministic algorithms, and the TF32 control
_SEQ_MODES = ("cudnn", "cudnn_deterministic", "cudnn_tf32_control")


def check_seq_reference(torch, np, args):
    """Phase 19 (b): card against CPU with TF32 off in cuBLAS.  First the
    convolutions alone against f64 (``check_conv_precision``).  Then
    ``Sequential(cifar_cnn at dropout 0)`` from the weights its
    ``build`` draws on the card (the main path's), in each of
    ``_SEQ_MODES``: the first batch's loss and gradients through the
    model, the same by hand (``_cnn_grads``) on the card and on the CPU
    with the card's ReLU masks (the mask disagreements of the two
    devices' own forwards counted), then ``SEQ_REF_STEPS``
    ``train_on_batch`` steps of ``adam()`` against the CPU's; and the
    MNIST MLP (dropout 0) for as many ``TrainSession`` steps."""
    from distributed_tensorflow_tpu_torch import optim, train
    from distributed_tensorflow_tpu_torch import data, models, ops
    check_conv_precision(torch, np, args)
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        (x, y), _ = data.synthetic_image_classes(
            (32, 32, 3), 10, SEQ_REF_STEPS * SEQ_REF_BATCH, 1, seed=args.seed)
        xb, yb = x[:SEQ_REF_BATCH], y[:SEQ_REF_BATCH]
        weights = None

        def make(dev):
            layers = [ops.Dropout(0.0) if isinstance(l, ops.Dropout) else l
                      for l in models.cifar_cnn().layers]
            m = models.Sequential(layers, device=dev)
            m.compile("sparse_categorical_crossentropy", "adam",
                      ["accuracy"], seed=args.seed)
            m.build((32, 32, 3), seed=args.seed)
            if weights is not None:
                m.set_weights(weights)
            return m

        def steps(m):
            return [m.train_on_batch(x[i:i + SEQ_REF_BATCH],
                                     y[i:i + SEQ_REF_BATCH])["loss"]
                    for i in range(0, len(x), SEQ_REF_BATCH)]
        weights = make("cuda").get_weights()
        cpu = make("cpu")
        l_cpu, g_cpu = _cnn_first_step(torch, cpu, xb, yb)
        masks_cpu = _cnn_grads(torch, cpu.stack, cpu.state.params, xb,
                               yb)[2]
        cnn = {}
        for name in _SEQ_MODES:
            m = make("cuda")
            mode = _conv_mode(torch, name)
            try:
                l_model, g_model = _cnn_first_step(torch, m, xb, yb)
                _, g_hand, masks = _cnn_grads(torch, m.stack, m.state.params,
                                              xb, yb)
                losses = steps(m)
            finally:
                _unset_conv_mode(torch, mode)
            w_card = m.get_weights()
            del m
            _, g_match, _ = _cnn_grads(torch, cpu.stack, cpu.state.params,
                                       xb, yb, masks)
            cnn[name] = {
                "first_loss_rel": abs(l_model - l_cpu) / abs(l_cpu),
                "relu_mask_flips": [int((a != b).sum())
                                    for a, b in zip(masks, masks_cpu)],
                "first_grad_rel_own_masks": {k: _rel(g_model[k], g_cpu[k])
                                             for k in g_cpu},
                "model_vs_hand_rel": max(_rel(g_model[k], g_hand[k])
                                         for k in g_hand),
                "first_grad_rel": {k: _rel(g_hand[k], g_match[k])
                                   for k in g_match},
                "run": (losses, w_card)}
        losses_cpu = steps(cpu)
        for r in cnn.values():
            losses, w_card = r.pop("run")
            r["loss_rel_by_step"] = [abs(a - b) / abs(b)
                                     for a, b in zip(losses, losses_cpu)]
            r["update_rel_by_leaf"] = _update_err(np, w_card,
                                                  cpu.get_weights(), weights)
        (xm, ym), _ = data.mnist(None, flatten=True, seed=args.seed)
        mlp = {}
        tree = None
        for dev in ("cuda", "cpu"):
            model = ops.serial(ops.Dense(128, activation="relu"),
                               ops.Dropout(0.0), ops.Dense(10))
            opt = optim.adam()
            state = train.init_train_state(
                model, opt, torch.Generator(dev).manual_seed(args.seed),
                (784,))
            if tree is None:
                tree = {k: v.detach().cpu().clone() for k, v in state.params.items()}
            with torch.no_grad():
                for k, v in state.params.items():
                    v.copy_(tree[k])
            step = train.make_train_step(
                model, "sparse_categorical_crossentropy", opt,
                metric_fns={"accuracy": "accuracy"}, seed=args.seed)
            losses = []
            with train.TrainSession(state, step, hooks=[
                    train.StopAtStepHook(last_step=SEQ_REF_STEPS)]) as sess:
                i = 0
                while not sess.should_stop():
                    b = slice(i * MNIST_BATCH, (i + 1) * MNIST_BATCH)
                    losses.append(float(sess.run_step(
                        (torch.from_numpy(xm[b]).to(dev),
                         torch.from_numpy(ym[b]).to(dev)))["loss"]))
                    i += 1
                mlp[dev] = (losses, [sess.state.params[k].detach().cpu()
                                     for k in sorted(tree)])
        mlp_loss = max(abs(a - b) / abs(b) for a, b in zip(mlp["cuda"][0],
                                                         mlp["cpu"][0]))
        mlp_param = max(float((a - b).abs().max())
                        for a, b in zip(mlp["cuda"][1], mlp["cpu"][1]))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    worst = {name: {"first_loss_rel": r["first_loss_rel"],
                    "relu_mask_flips": sum(r["relu_mask_flips"]),
                    "model_vs_hand_rel": r["model_vs_hand_rel"],
                    "first_grad_rel": max(r["first_grad_rel"].values()),
                    "first_grad_rel_own_masks": max(
                        r["first_grad_rel_own_masks"].values()),
                    "loss_rel": max(r["loss_rel_by_step"]),
                    "update_rel": max(r["update_rel_by_leaf"])}
             for name, r in cnn.items()}
    log({"seq": "(b) card vs CPU", "steps": SEQ_REF_STEPS,
         "batch": SEQ_REF_BATCH, "allow_tf32_matmul": False,
         "cifar_cnn": cnn, "cifar_cnn_worst": worst,
         "tols": {"first_loss": SEQ_CNN_LOSS_RTOL, "grad": SEQ_GRAD_TOL,
                  "loss": SEQ_STEPS_LOSS_RTOL, "update": SEQ_UPDATE_TOL},
         "mnist_mlp_loss_rel_err": mlp_loss,
         "mnist_mlp_param_err": mlp_param,
         "mlp_loss_rtol": SEQ_LOSS_RTOL, "mlp_param_tol": SEQ_PARAM_TOL,
         "cifar_losses_cpu": losses_cpu})

    def sound(w):
        return (w["first_loss_rel"] <= SEQ_CNN_LOSS_RTOL
                and w["model_vs_hand_rel"] <= SEQ_GRAD_TOL
                and w["first_grad_rel"] <= SEQ_GRAD_TOL
                and w["loss_rel"] <= SEQ_STEPS_LOSS_RTOL
                and w["update_rel"] <= SEQ_UPDATE_TOL)
    bad = [n for n, w in worst.items()
           if sound(w) == (n == "cudnn_tf32_control")]
    if bad or not (mlp_loss <= SEQ_LOSS_RTOL and mlp_param <= SEQ_PARAM_TOL):
        raise AssertionError(
            f"high-level tier card vs CPU: modes off {bad} (the TF32 "
            f"control must fail the limits): {worst}; MLP {mlp_loss}, "
            f"{mlp_param}")


def _epoch_probe(torch, name, make, x, y, batch, val, augment=None,
                 smi=None):
    """One epoch of ``fit`` on a fresh model from ``make()`` after a
    warm-up epoch: timed, then counting host syncs; and the first
    1 / PROBE_PROFILED_PART of its steps (with the validation pass) timed
    and then run under the profiler (the card's busy share of that
    part).  Logs and returns the record."""
    from distributed_tensorflow_tpu_torch.obs import device as obs_device
    model = make()
    steps = len(x) // batch
    part = steps // PROBE_PROFILED_PART

    def epoch(n=len(x)):
        return model.fit(x[:n], y[:n], epochs=1, batch_size=batch,
                         validation_data=val, verbose=0, augment=augment)

    epoch()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    epoch()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    epoch(part * batch)
    torch.cuda.synchronize()
    part_wall = time.perf_counter() - t0
    _, busy_s, kernels = obs_device.device_busy(lambda: epoch(part * batch))
    syncs = _syncs(torch, epoch)
    rec = {"seq": f"{name} one epoch of fit", "steps": steps,
           "step_ms": wall / steps * 1e3, "steps_per_s": steps / wall,
           "examples_per_s": steps * batch / wall, "wall_s": wall,
           "profiled_steps": part, "device_busy_s": busy_s,
           "busy_share": busy_s / part_wall,
           "device_ops_per_step": kernels / part,
           "host_syncs_per_epoch": syncs,
           "allow_tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
           "allow_tf32_cudnn": torch.backends.cudnn.allow_tf32, "card": smi}
    log(rec)
    return rec


def _expect_adam(name, counts, adam):
    """Fail unless ``counts`` (``_xor_counts``) shows ``adam`` Adam
    launches and nothing else."""
    if counts["fused_adam"] != adam or counts["other_kernels"] \
            or counts["all_reduce"]:
        raise AssertionError(f"{name} launches {counts}; expected Adam "
                             f"{adam}, nothing else")


def _epoch_vals(out, key):
    """[(epoch, value of ``key``)] of ``fit``'s epoch lines."""
    rows = []
    for line in out.splitlines():
        if line.startswith("Epoch ") and f"{key}=" in line:
            epoch = int(line.split()[1].split("/")[0])
            rows.append((epoch, float(line.split(f"{key}=")[1].split(",")[0])))
    return rows


def check_seq_example2(torch, np, args, smi):
    """Phase 19 (c): ``python -m ...example2`` at its defaults but
    ``EX2_EPOCHS``.  Returns its Adam launches."""
    from distributed_tensorflow_tpu_torch import example2
    from distributed_tensorflow_tpu_torch import data, models, ops
    (xt, yt), (xv, yv) = data.xor_data(30000, 1000, seed=args.seed)

    def make():
        m = models.Sequential(models.xor_mlp().layers, device="cuda")
        m.compile("mean_squared_error", "adam", ["bitwise_accuracy"],
                  seed=args.seed)
        return m
    probe = _epoch_probe(torch, "(c) example2", make, xt, yt, XOR_BATCH,
                         (xv, yv), smi=smi)
    steps = EX2_EPOCHS * XOR_STEPS_PER_EPOCH
    _reset_counts()
    out, wall = _run_entry(torch, example2.main, [
        "--device=cuda", f"--log_dir={_SEQ_DIR}/xor2_{{}}",
        f"--seed={args.seed}", f"--epochs={EX2_EPOCHS}"])
    counts = _xor_counts(torch)
    accs = _epoch_vals(out, "val_bitwise_accuracy")
    first = next((e for e, a in accs if a > XOR_ACC), None)
    final = float(out.split("Final validation accuracy:")[1].split()[0])
    log({"seq": "(c) example2 entry point", "epochs": len(accs),
         "steps": steps, "wall_s": wall, "step_ms": wall / steps * 1e3,
         "steps_per_s": steps / wall, "samples_per_s":
         steps * XOR_BATCH / wall, "launches": counts,
         "val_acc": [a for _, a in accs], "first_epoch_over_0.95": first,
         "final_val_acc": final, "busy_share_(probe)": probe["busy_share"],
         "host_syncs_per_epoch_(probe)": probe["host_syncs_per_epoch"],
         "card": smi})
    if len(accs) != EX2_EPOCHS or not final > XOR_ACC or first is None:
        raise AssertionError(f"example2: val accuracy {accs}, final {final}")
    _expect_adam("example2", counts, 6 * steps)
    return counts["fused_adam"]


def check_seq_keras(torch, np, args, smi):
    """Phase 19 (d) and (f): ``...outline_keras`` at its defaults (CIFAR-10
    CNN, synthetic data), then K = 8 against K = 1 over one epoch.
    Returns the entry point's Adam launches."""
    from distributed_tensorflow_tpu_torch import outline_keras
    from distributed_tensorflow_tpu_torch import data, models, ops
    t0 = time.perf_counter()
    (xt, yt), (xv, yv) = data.cifar10(None, seed=args.seed)
    data_s = time.perf_counter() - t0
    augment = data.augment.compose(data.augment.random_crop(4),
                                   data.augment.random_flip_lr())
    rng = np.random.default_rng(args.seed)
    batch = (xt[:CIFAR_BATCH], yt[:CIFAR_BATCH])
    augment(rng, batch)
    t0 = time.perf_counter()
    for _ in range(20):
        augment(rng, batch)
    augment_ms = (time.perf_counter() - t0) / 20 * 1e3

    def make(spe=1):
        m = models.Sequential(models.cifar_cnn().layers, device="cuda")
        m.compile("sparse_categorical_crossentropy", "adam", ["accuracy"],
                  seed=args.seed, steps_per_execution=spe)
        return m
    probe = _epoch_probe(torch, "(d) outline_keras", make, xt, yt,
                         CIFAR_BATCH, (xv[:4096], yv[:4096]), augment, smi)
    steps = CIFAR_EPOCHS * (len(xt) // CIFAR_BATCH)
    _reset_counts()
    out, wall = _run_entry(torch, outline_keras.main, [
        "--device=cuda", f"--log_dir={_SEQ_DIR}/cifar_{{}}",
        f"--seed={args.seed}", f"--epochs={CIFAR_EPOCHS}"])
    counts = _xor_counts(torch)
    accs = _epoch_vals(out, "val_accuracy")
    final = float(out.split("Final validation accuracy:")[1].split()[0])
    train_s = wall - data_s
    log({"seq": "(d) outline_keras entry point", "epochs": CIFAR_EPOCHS,
         "steps": steps, "wall_s": wall,
         "step_ms_without_data": train_s / steps * 1e3,
         "examples_per_s_without_data": steps * CIFAR_BATCH / train_s,
         "augment_host_ms_per_batch": augment_ms, "data_s": data_s,
         "launches": counts,
         "val_acc": [a for _, a in accs], "final_val_acc": final,
         "gate": CIFAR_ACC, "busy_share_(probe)": probe["busy_share"],
         "host_syncs_per_epoch_(probe)": probe["host_syncs_per_epoch"],
         "allow_tf32_cudnn": torch.backends.cudnn.allow_tf32, "card": smi})
    if not final > CIFAR_ACC:
        raise AssertionError(f"outline_keras: final val accuracy {final} "
                             f"not above {CIFAR_ACC}")
    _expect_adam("outline_keras", counts, 12 * steps)

    # (f) K = 8 against K = 1: one epoch each from one seed, cuDNN
    # deterministic so that equal calls give equal bits
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        runs = {}
        for spe in (1, SPE_K):
            m = make(spe)
            m.build((32, 32, 3), seed=args.seed)
            m.fit(xt[:CIFAR_BATCH * 16], yt[:CIFAR_BATCH * 16], epochs=1,
                  batch_size=CIFAR_BATCH, verbose=0, seed=args.seed)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            h = m.fit(xt, yt, epochs=1, batch_size=CIFAR_BATCH, verbose=0,
                      seed=args.seed + 1, augment=augment)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            runs[spe] = (h.history, m.get_weights(), wall)
    finally:
        torch.backends.cudnn.deterministic = saved
    equal = all(np.array_equal(a, b) for a, b in zip(runs[1][1],
                                                     runs[SPE_K][1]))
    per_epoch = len(xt) // CIFAR_BATCH
    log({"seq": "(f) steps_per_execution", "k": SPE_K,
         "params_bit_equal": equal,
         "history_equal": runs[1][0] == runs[SPE_K][0],
         "step_ms_k1": runs[1][2] / per_epoch * 1e3,
         "step_ms_k8": runs[SPE_K][2] / per_epoch * 1e3, "card": smi})
    if not equal or runs[1][0] != runs[SPE_K][0]:
        raise AssertionError("steps_per_execution=8 is not bit-equal to 1")
    return counts["fused_adam"]


def check_seq_mnist(torch, np, args, smi):
    """Phase 19 (e): ``...outline_tensorflow`` at its defaults (MNIST MLP,
    synthetic data, ``TrainSession`` with its hooks).  Returns its Adam
    launches."""
    from distributed_tensorflow_tpu_torch import outline_tensorflow
    from distributed_tensorflow_tpu_torch import data
    steps = MNIST_EPOCHS * (60000 // MNIST_BATCH)
    t0 = time.perf_counter()
    data.mnist(None, flatten=True, seed=args.seed)
    data_s = time.perf_counter() - t0
    _reset_counts()
    out, wall = _run_entry(torch, outline_tensorflow.main, [
        "--device=cuda", f"--log_dir={_SEQ_DIR}/mnist",
        f"--seed={args.seed}"])
    counts = _xor_counts(torch)
    last = [l for l in out.splitlines() if l.startswith("Final step")]
    acc = float(last[-1].split("val accuracy")[1]) if last else float("nan")
    # LoggingHook's lines: "step N: ... (R steps/s)" over its windows
    rates = [float(l.rsplit("(", 1)[1].split()[0])
             for l in out.splitlines() if l.startswith("step ")
             and "steps/s)" in l]
    train_s = wall - data_s
    log({"seq": "(e) outline_tensorflow entry point", "steps": steps,
         "wall_s": wall, "data_s": data_s,
         "step_ms_without_data": train_s / steps * 1e3,
         "examples_per_s_without_data": steps * MNIST_BATCH / train_s,
         "logging_hook_steps_per_s": rates, "launches": counts,
         "final": last[-1:], "val_acc": acc, "gate": MNIST_ACC,
         "card": smi})
    if not last or not last[-1].startswith(f"Final step {steps}:") \
            or not acc > MNIST_ACC:
        raise AssertionError(f"outline_tensorflow: {last}")
    _expect_adam("outline_tensorflow", counts, 4 * steps)
    return counts["fused_adam"]


def check_seq_layernorm(torch, np, args, smi):
    """Phase 19 (g): ``[Dense(128), LayerNorm(fused="auto"), Dense(10)]``
    for 3 fit steps on MNIST rows (one LayerNorm launch a forward), then
    the kernel against ``layernorm_plain`` at [1024, 128] and at the odd
    [1024, 129] (the looped path).  Returns the fit's LayerNorm
    launches."""
    from distributed_tensorflow_tpu_torch.ops.kernels import fused
    from distributed_tensorflow_tpu_torch import data, models, ops
    (x, y), _ = data.synthetic_image_classes((784,), 10, 3 * MNIST_BATCH, 1,
                                             seed=args.seed)
    m = models.Sequential([ops.Dense(128, activation="relu"),
                           ops.LayerNorm(fused="auto"), ops.Dense(10)],
                          device="cuda")
    m.compile("sparse_categorical_crossentropy", "adam", ["accuracy"],
              seed=args.seed)
    m.build((784,), seed=args.seed)
    _reset_counts()
    h = m.fit(x, y, epochs=1, batch_size=MNIST_BATCH, verbose=0)
    counts = dict(_read_counts(torch), adam=fused.LAUNCHES["adam"])
    log({"seq": "(g) LayerNorm in a Sequential", "steps": 3,
         "launches": counts, "loss": h.history["loss"]})
    if counts != {"flash_forward": 0, "layernorm": 3, "rmsnorm": 0,
                  "paged": 0, "adam": 6 * 3}:
        raise AssertionError(f"(g) launches {counts}: expected LayerNorm 3 "
                             "(one a forward), Adam 18, nothing else")
    norm = counts["layernorm"]
    gen = torch.Generator("cuda").manual_seed(args.seed)
    for d in (128, 129):
        xx = torch.randn((MNIST_BATCH, d), generator=gen, device="cuda")
        gamma = torch.rand(d, generator=gen, device="cuda") + 0.5
        beta = torch.randn(d, generator=gen, device="cuda")
        got = fused.fused_layernorm(xx, gamma, beta)
        want = fused.layernorm_plain(xx, gamma, beta)
        err = (got - want).abs().max().item()
        rec = {"seq": "(g) layernorm kernel", "shape": [MNIST_BATCH, d],
               "dtype": "float32", "max_abs_err": err, "tol": F32_TOL,
               "kernel_ms": time_ms(torch, lambda: fused.fused_layernorm(
                   xx, gamma, beta), args.iters),
               "graph_ms": graph_ms(torch, lambda: fused.fused_layernorm(
                   xx, gamma, beta), args.iters),
               "plain_ms": time_ms(torch, lambda: fused.layernorm_plain(
                   xx, gamma, beta), args.iters),
               "library_ms": time_ms(torch, lambda: torch.nn.functional
                                     .layer_norm(xx, (d,), gamma, beta,
                                                 1e-6), args.iters),
               "library_graph_ms": graph_ms(
                   torch, lambda: torch.nn.functional.layer_norm(
                       xx, (d,), gamma, beta, 1e-6), args.iters)}
        rec["bound_ms"], rec["bound_by"] = bound_ms(
            (2 * MNIST_BATCH * d + 2 * d) * 4.0, 8.0 * MNIST_BATCH * d)
        log(rec)
        if not err <= F32_TOL:
            raise AssertionError(f"LayerNorm kernel at d={d}: {err}")
    return norm


def check_sequential(torch, np, args, smi):
    """Phase 19: the high-level tier.  Returns the Adam launches of the
    three entry points and the LayerNorm launches of (g)."""
    t_phase = time.perf_counter()
    shutil.rmtree(_SEQ_DIR, ignore_errors=True)
    worst = _adam_leaves(torch, args, CIFAR_SHAPES + MNIST_SHAPES, "seq")
    check_seq_reference(torch, np, args)
    adam = check_seq_example2(torch, np, args, smi)
    adam += check_seq_keras(torch, np, args, smi)
    adam += check_seq_mnist(torch, np, args, smi)
    norm = check_seq_layernorm(torch, np, args, smi)
    shutil.rmtree(_SEQ_DIR, ignore_errors=True)
    log({"phase": "sequential", "seconds": time.perf_counter() - t_phase,
         "adam_max_abs_err": worst, "adam_launches": adam,
         "layernorm_launches": norm})
    return {"fused_adam": adam, "layernorm": norm}


def _obs_batches(np, args, n):
    """``n`` host batches (48 rows of 257 ids, and a loss mask of ones: a
    NaN-poisoned step poisons its float leaf) from the order-1 synthetic
    corpus through ``Dataset``, as phase 17's session draws them."""
    from distributed_tensorflow_tpu_torch.data import (Dataset,
                                                       lm_sequences,
                                                       synthetic_lm_corpus)
    rows = lm_sequences(synthetic_lm_corpus(
        50257, n * TRAIN_BATCH * (TRAIN_SEQ + 1) + TRAIN_SEQ + 1,
        seed=args.seed, order=1), TRAIN_SEQ)
    mask = np.ones((TRAIN_BATCH, TRAIN_SEQ), np.float32)
    return [(b, mask) for (b,) in list(Dataset([rows], TRAIN_BATCH,
                                               seed=args.seed))[:n]]


def _clone_tree(torch, tree):
    """A copy of a tree of dicts, (named) tuples and tensors."""
    if isinstance(tree, dict):
        return {k: _clone_tree(torch, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_clone_tree(torch, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_clone_tree(torch, v) for v in tree)
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def _obs_loop(torch, sess, batches, staged=False):
    """Run ``sess`` over ``batches[sess.step:]`` (through
    ``prefetch_to_device``, unless already on the card) until it stops."""
    from distributed_tensorflow_tpu_torch.data import prefetch_to_device
    it = (iter(batches[sess.step:]) if staged else
          prefetch_to_device(iter(batches[sess.step:]), device="cuda"))
    for ids, mask in it:
        if sess.should_stop():
            break
        sess.run_step({"input_ids": ids, "loss_mask": mask})
    return sess


def check_obs_session(torch, np, args, smi):
    """Phase 20 (a), (b) and the session half of (d).  Returns the
    training kernels' launches over (a)'s supervised run."""
    import urllib.request
    from distributed_tensorflow_tpu_torch import (TrainState, adamw,
                                                  make_custom_train_step,
                                                  train)
    from distributed_tensorflow_tpu_torch.obs import (GoodputAccountant,
                                                      Registry, Telemetry,
                                                      goodput,
                                                      parse_exposition)
    from distributed_tensorflow_tpu_torch.obs.device import device_busy
    from distributed_tensorflow_tpu_torch.resilience import (
        FaultPlan, NonfiniteGuardHook, Supervisor, faults)
    from distributed_tensorflow_tpu_torch.train import checkpoint as ckpt
    t_phase = time.perf_counter()
    shutil.rmtree(_OBS_DIR, ignore_errors=True)
    model = _gpt2(torch, args)
    params = dict(model.named_parameters())
    init = {k: p.detach().clone() for k, p in params.items()}
    opt = adamw(TRAIN_LR)
    step = make_custom_train_step(model.lm_loss_fn(), opt, seed=args.seed,
                                  grad_clip_norm=1.0, device_health=True,
                                  skip_nonfinite=True)
    batches = _obs_batches(np, args, OBS_LAST)
    ckpt_dir = str(_OBS_DIR / "ckpt")
    tokens = TRAIN_BATCH * TRAIN_SEQ

    def fresh_state():
        with torch.no_grad():              # every attempt starts anew
            for k, p in params.items():
                p.copy_(init[k])
        return TrainState.create(params, opt.init(params))

    # (a) + (b): the supervised session under one Telemetry
    tele = Telemetry(trace_dir=str(_OBS_DIR / "trace"), metrics_port=0,
                     registry=Registry())
    reg = tele.registry
    planned = [{"kind": "save_oserror", "at": 0},
               {"kind": "corrupt_checkpoint", "at": 2},
               *({"kind": "nan_grads", "at": OBS_NAN + i}
                 for i in range(3)),
               {"kind": "kill_prefetch", "at": OBS_KILL_BATCH}]
    plan = FaultPlan(planned, seed=args.seed, registry=reg)
    sup = Supervisor(max_restarts=5, backoff_base=OBS_BACKOFF_S,
                     seed=args.seed, registry=reg)
    acct = GoodputAccountant(registry=reg)
    restored, run_steps = [], [0]

    class Count(train.Hook):
        def after_step(self, session, metrics):
            run_steps[0] += 1

    def build():
        sess = train.TrainSession(
            fresh_state(), step, checkpoint_dir=ckpt_dir, telemetry=tele,
            hooks=[train.StopAtStepHook(last_step=OBS_LAST),
                   train.CheckpointHook(every_steps=OBS_EVERY,
                                        every_secs=None),
                   NonfiniteGuardHook(3), train.TraceHook(tele),
                   train.MetricsExportHook(tele, every_steps=OBS_EVERY,
                                           tokens_per_step=tokens),
                   Count()])
        restored.append(sess.step)
        return sess

    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with goodput.activated(acct), faults.activated(plan):
        sess = sup.run(build, lambda s: _obs_loop(torch, s, batches))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _train_counts(torch)
    final = {k: p.detach().clone() for k, p in params.items()}
    with urllib.request.urlopen(tele.metrics_url(), timeout=30) as r:
        fams = parse_exposition(r.read().decode("utf-8"))
    tele.close()
    with open(tele.trace_path) as f:
        spans = collections.Counter(
            e["name"] for e in json.load(f)["traceEvents"]
            if e["ph"] == "X")
    quarantined = sorted(p.name for p in Path(ckpt_dir).glob("corrupt-*"))
    kinds = [e["kind"] for e in plan.log]
    transient = sum(k in ("save_oserror", "kill_prefetch") for k in kinds) \
        + kinds.count("nan_grads") // 3
    report = acct.report()

    def sample(name, suffix=""):
        return fams[name]["samples"][(name + suffix, ())]

    log({"obs": "(a) supervised session", "steps": OBS_LAST,
         "steps_run": run_steps[0], "wall_s": wall,
         "restart_log": sup.restart_log, "restored_at": restored,
         "quarantined": quarantined, "audit": plan.log,
         "recovery_s": sample("dttpu_recovery_seconds", "_sum"),
         "recoveries": sample("dttpu_recovery_seconds", "_count"),
         "launches": counts, "card": smi})
    if sess.step != OBS_LAST or restored[:3] != [0, 0, OBS_EVERY] or \
            quarantined != [f"corrupt-ckpt-{2 * OBS_EVERY:010d}"]:
        raise AssertionError(f"(a) ended at {sess.step}, restored at "
                             f"{restored}, quarantined {quarantined}")
    if sorted(kinds) != sorted(f["kind"] for f in planned) or \
            any(f.fired != 1 for f in plan.faults):
        raise AssertionError(f"(a) audit trail {plan.log}")
    if transient != 3 or len(sup.restart_log) != transient or \
            sup.restarts_total.value != transient:
        raise AssertionError(f"(a) {sup.restart_log} for {transient} "
                             "transient faults")
    for name in ("flash_forward", "flash_backward_dkv", "flash_backward_dq",
                 "layernorm", "fused_adam"):
        if counts[name] <= 0:
            raise AssertionError(f"(a) {name} never launched")

    # (a): against an unfaulted session from the restored checkpoint over
    # the same batches, run twice: bit-equal where those two are
    st = ckpt.restore(fresh_state(), ckpt.ckpt_path(ckpt_dir, OBS_EVERY))
    p5, o5 = _clone_tree(torch, dict(params)), _clone_tree(torch,
                                                           st.opt_state)
    refs = []
    for _ in range(2):
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(p5[k])
        run = st._replace(opt_state=_clone_tree(torch, o5))
        with train.TrainSession(run, step, hooks=[train.StopAtStepHook(
                last_step=OBS_LAST)]) as ref:
            _obs_loop(torch, ref, batches)
        refs.append({k: p.detach().clone() for k, p in params.items()})
    spread = max(float((refs[0][k] - refs[1][k]).abs().max())
                 for k in params)
    err = max(float((final[k] - refs[0][k]).abs().max()) for k in params)
    tol = 2 * spread          # the card's own run-to-run spread, if any
    log({"obs": "(a) against the unfaulted run", "from_step": OBS_EVERY,
         "unfaulted_runs_max_abs_diff": spread, "max_abs_err": err,
         "tol": tol, "card": smi})
    if err > tol:
        raise AssertionError(f"(a) parameters off the unfaulted run's by "
                             f"{err} (tolerance {tol})")
    del p5, o5, refs, st, final

    # (b) the telemetry of (a)
    buckets = report["buckets_s"]
    log({"obs": "(b) telemetry", "steps_total": sample("dttpu_steps_total"),
         "step_time_count": sample("dttpu_step_time_seconds", "_count"),
         "live_arrays_bytes": sample("dttpu_live_arrays_bytes"),
         "restarts_total": sample("dttpu_restarts_total"),
         "faults_injected_total": sample("dttpu_faults_injected_total"),
         "spans": spans, "goodput": report, "card": smi})
    if sample("dttpu_steps_total") != run_steps[0] or \
            sample("dttpu_step_time_seconds", "_count") != run_steps[0] or \
            not sample("dttpu_live_arrays_bytes") > 0 or \
            sample("dttpu_restarts_total") != transient:
        raise AssertionError(f"(b) scraped series disagree with (a)")
    if any(spans[s] <= 0 for s in ("step", "data_load", "dispatch",
                                   "checkpoint")):
        raise AssertionError(f"(b) trace spans {spans}")
    if abs(sum(buckets.values()) - report["wall_s"]) > \
            0.02 * report["wall_s"] or any(
            buckets[b] <= 0 for b in ("fault_recovery", "restart_backoff",
                                      "checkpoint_restore")):
        raise AssertionError(f"(b) goodput {report}")

    # (d) the session step with the telemetry hooks on and off, in turns
    staged = [(torch.from_numpy(ids).cuda(), torch.from_numpy(m).cuda())
              for ids, m in batches[:OBS_PAIR_STEPS]]

    def arm(on, steps=OBS_PAIR_STEPS):
        hooks = [train.StopAtStepHook(num_steps=steps)]
        tele = None
        if on:
            tele = Telemetry(trace_dir=str(_OBS_DIR / "pair"),
                             metrics_port=0, registry=Registry())
            hooks += [train.TraceHook(tele),
                      train.MetricsExportHook(tele, every_steps=OBS_EVERY,
                                              tokens_per_step=tokens)]
        state = TrainState(0, params, opt_state, ())

        def go():
            with train.TrainSession(state, step, hooks=hooks,
                                    telemetry=tele) as s:
                _obs_loop(torch, s, staged, staged=True)
        return go, tele

    opt_state = opt.init(params)
    arm(False)[0]()                        # warm-up
    pairs = {False: [], True: []}
    for on in (False, True, True, False):
        go, t = arm(on)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        go()
        torch.cuda.synchronize()
        pairs[on].append((time.perf_counter() - t0) / OBS_PAIR_STEPS * 1e3)
        if t is not None:
            t.close()
    busy = {}
    for on in (False, True):
        go, t = arm(on, OBS_BUSY_STEPS)
        _, busy_s, _ = device_busy(go)
        busy[on] = busy_s * 1e3 / OBS_BUSY_STEPS / np.mean(pairs[on])
        if t is not None:
            t.close()
    log({"obs": "(d) session step, telemetry hooks off/on in turns",
         "steps": OBS_PAIR_STEPS, "profiled_steps": OBS_BUSY_STEPS,
         "step_ms_off": pairs[False],
         "step_ms_on": pairs[True], "busy_share_off": busy[False],
         "busy_share_on": busy[True], "card": smi})
    del model, params, init, opt_state, step, sess, staged
    torch.cuda.empty_cache()
    shutil.rmtree(_OBS_DIR, ignore_errors=True)
    log({"phase": "obs session", "seconds": time.perf_counter() - t_phase})
    return counts


def check_obs_engine(torch, np, args, smi, paged):
    """Phase 20 (c) and the engine half of (d), on phase 4's model and mix
    (``paged``: its model and tokens).  Returns the serving kernels'
    launches over (c)'s run."""
    from distributed_tensorflow_tpu_torch.obs import (CritpathLedger,
                                                      Registry, Tracer,
                                                      critpath, reqtrace,
                                                      trace)
    from distributed_tensorflow_tpu_torch.obs.critpath import PHASES
    from distributed_tensorflow_tpu_torch.ops.kernels import fused
    from distributed_tensorflow_tpu_torch.ops.kernels import \
        paged_attention as pa
    from distributed_tensorflow_tpu_torch.resilience import (FaultPlan,
                                                             InjectedFault,
                                                             faults)
    t_phase = time.perf_counter()
    model = paged["model"]
    prompts, budgets = _requests(np, args.seed)
    n = len(prompts)

    def serve(on, plan=None):
        """Phase 4's run on a fresh registry; ``on``: request traces and
        a critical-path ledger active."""
        reg = Registry()
        if not on:
            return run_engine(torch, model, prompts, budgets, late=3,
                              registry=reg) + (None,)
        reqtrace.reset()
        ledger = CritpathLedger(registry=reg)
        with trace.activated(Tracer(enabled=True)), \
                critpath.activated(ledger), \
                (faults.activated(plan) if plan is not None
                 else contextlib.nullcontext()):
            return run_engine(torch, model, prompts, budgets, late=3,
                              registry=reg) + (ledger,)

    # (c) the instrumented engine under a fault plan
    plan = FaultPlan([{"kind": "fail_decode", "at": OBS_FAIL_RID},
                      {"kind": "stall_tick", "at": OBS_STALL_TICK,
                       "seconds": OBS_STALL_S}], seed=args.seed,
                     registry=Registry())
    _reset_counts()
    torch.cuda.synchronize()
    eng, hs, wall, ledger = serve(True, plan)
    counts = _pool_counts(pa, fused)
    torch.cuda.synchronize()
    st = eng.stats()
    reg = eng.metrics.registry

    def value(name):
        return reg.get(name).value

    failed = hs[OBS_FAIL_RID]
    if failed.status != "failed" or not isinstance(failed.error,
                                                   InjectedFault):
        raise AssertionError(f"(c) request {OBS_FAIL_RID}: status "
                             f"{failed.status}, error {failed.error!r}")
    same = [i for i, h in enumerate(hs) if i != OBS_FAIL_RID
            and h.status == "ok" and h.tokens == paged["tokens"][i]]
    shares = []
    for i, h in enumerate(hs):
        tree = reqtrace.tree(h.trace_id)
        root = tree["spans"][0]
        stages = [c["name"] for c in root["children"]]
        if i == OBS_FAIL_RID:
            if tree["status"] != "failed":
                raise AssertionError(f"(c) failed request's trace {tree}")
            continue
        cp = h.critpath
        shares.append(sum(cp[p] for p in PHASES) / cp["e2e_s"])
        if tree["status"] != "ok" or root["name"] != "request" or \
                stages != ["queued", "prefill", "decode"]:
            raise AssertionError(f"(c) request {i}: trace stages {stages}, "
                                 f"status {tree['status']}")
    metrics = {"tokens_total": value("dttpu_serve_tokens_total"),
               "requests_total": value("dttpu_serve_requests_total"),
               "failed_total": value("dttpu_serve_failed_total"),
               "prefix_hits_total": value("dttpu_serve_prefix_hits_total"),
               "prefix_evictions_total":
                   value("dttpu_serve_prefix_evictions_total"),
               "pages_free": value("dttpu_serve_pages_free"),
               "queue_depth": value("dttpu_serve_queue_depth"),
               "active_slots": value("dttpu_serve_active_slots"),
               "ttft_count": reg.get("dttpu_serve_ttft_seconds").count}
    want = {"tokens_total": sum(len(h.tokens) for h in hs),
            "requests_total": n, "failed_total": 1,
            "prefix_hits_total": st.prefix_hits_total,
            "prefix_evictions_total": st.prefix_evictions_total,
            "pages_free": st.pages_free, "queue_depth": st.queued,
            "active_slots": st.active, "ttft_count": n}
    log({"obs": "(c) instrumented engine", "requests": n,
         "equal_to_phase4": len(same), "failed_rid": OBS_FAIL_RID,
         "audit": plan.log, "critpath_share_sums": [min(shares),
                                                    max(shares)],
         "ledger_requests": ledger.report()["requests"],
         "interference_ratio": ledger.report()["interference_ratio"],
         "serve_metrics": metrics, "engine_stats": want,
         "wall_s": wall, "launches": counts, "card": smi})
    if len(same) != n - 1:
        raise AssertionError(f"(c) {len(same)} of {n - 1} streams equal "
                             "phase 4's")
    if any(abs(s - 1.0) > 1e-6 for s in shares):
        raise AssertionError(f"(c) critical-path shares sum to {shares}")
    if metrics != want:
        raise AssertionError(f"(c) ServeMetrics {metrics} against "
                             f"EngineStats and the handles {want}")
    if sorted(e["kind"] for e in plan.log) != ["fail_decode", "stall_tick"]:
        raise AssertionError(f"(c) audit trail {plan.log}")
    for name, k in counts.items():
        if k <= 0:
            raise AssertionError(f"(c) {name} never launched")
    del eng, hs

    # (d) the same engine with (c)'s instrumentation off and on, in turns
    rows = {False: [], True: []}
    for on in (False, True, True, False):
        _, hs, wall, _ = serve(on)
        ttft = sorted(h.ttft_s for h in hs)
        rows[on].append({"tokens_per_s": sum(len(h.tokens) for h in hs)
                         / wall, "ttft_p50_s": ttft[len(ttft) // 2]})
        if any(h.tokens != t for h, t in zip(hs, paged["tokens"])):
            raise AssertionError(f"(d) instrumentation {on} changed tokens")
    log({"obs": "(d) engine, instrumentation off/on in turns",
         "off": rows[False], "on": rows[True], "card": smi})
    log({"phase": "obs engine", "seconds": time.perf_counter() - t_phase})
    return counts


def _fleet_engine(torch, model, **kw):
    """A replica of the fleet: phase 4's engine with a registry of its
    own (the federation labels each replica's)."""
    from distributed_tensorflow_tpu_torch.obs import Registry
    kw.setdefault("registry", Registry())
    return _serve_engine(model, **kw)


def _fleet_requests(np, seed):
    """Phase 4's mix drawn ``FLEET_MIXES`` times (seeds ``seed``...):
    (early, late) lists of (mix, index) pairs.  Early: each mix's first
    shared-prompt request, then every independent one; late: the other
    shared-prompt requests, submitted once each mix's first has its
    first token (its system prompt's pages are then cached)."""
    mixes = [_requests(np, seed + m) for m in range(FLEET_MIXES)]
    n = len(mixes[0][0])
    early = [(m, 0) for m in range(FLEET_MIXES)] + [
        (m, i) for m in range(FLEET_MIXES) for i in range(1, n - 3)]
    late = [(m, i) for m in range(FLEET_MIXES) for i in range(n - 3, n)]
    return mixes, early, late


def _fleet_drive(torch, front, mixes, early, late, step):
    """Submit ``early`` to ``front`` (an engine or a router), pump until
    each mix's first request has a token, submit ``late``, drain.
    Returns ({(mix, i): handle}, {(mix, i): stream}, wall seconds)."""
    hs, streams = {}, {}

    def submit(key):
        m, i = key
        streams[key] = []
        hs[key] = front.submit(mixes[m][0][i], mixes[m][1][i],
                               on_token=streams[key].extend)

    t0 = time.perf_counter()
    for key in early:
        submit(key)
    while not all(hs[(m, 0)].tokens for m in range(FLEET_MIXES)):
        step()
    for key in late:
        submit(key)
    front.drain()
    torch.cuda.synchronize()
    return hs, streams, time.perf_counter() - t0


def _pct(vals, q):
    vals = sorted(vals)
    return vals[int(q * (len(vals) - 1))]


def _streams_exact(hs, streams, what):
    """Every request ended ``ok`` with its budget, and its ``on_token``
    stream is its tokens: no gap, no repeat."""
    for key, h in hs.items():
        if h.status != "ok" or h.tokens != streams[key]:
            raise AssertionError(f"{what}, request {key}: status "
                                 f"{h.status} ({h.error!r}), stream of "
                                 f"{len(streams[key])} for "
                                 f"{len(h.tokens)} tokens")


def _fleet_placement(torch, np, args, smi, model):
    """Phase 21 (a): returns the single engine's tokens by (mix, index)
    and the fleet run's launch counts."""
    from distributed_tensorflow_tpu_torch import fleet
    from distributed_tensorflow_tpu_torch.obs import Registry
    from distributed_tensorflow_tpu_torch.ops.kernels import fused
    from distributed_tensorflow_tpu_torch.ops.kernels import \
        paged_attention as pa

    mixes, early, late = _fleet_requests(np, args.seed)
    n = len(early) + len(late)
    single = _fleet_engine(torch, model)
    _reset_counts()
    (hs1, st1, wall1), _, _ = _driven(torch, lambda: _fleet_drive(
        torch, single, mixes, early, late, single.step))
    one = _pool_counts(pa, fused)
    _streams_exact(hs1, st1, "(a) single engine")
    one_skipped = single.stats().prefill_windows_skipped_total
    del single
    runs = []
    for _ in range(2):
        reg = Registry()
        router = fleet.Router([_fleet_engine(torch, model)
                               for _ in range(FLEET_REPLICAS)],
                              registry=reg, affinity_weight=1.0)
        (hs, streams, wall), _, _ = _driven(torch, lambda: _fleet_drive(
            torch, router, mixes, early, late, router.step))
        counts = _pool_counts(pa, fused)
        skipped = sum(s.prefill_windows_skipped_total
                      for s in router.stats().values())
        runs.append((router, reg, hs, streams, wall, counts, skipped))
    router, reg, hs, streams, wall, counts, skipped = runs[0]
    _streams_exact(hs, streams, "(a) fleet")
    if runs[1][0].placements != router.placements:
        raise AssertionError("(a) placements differ between two runs")
    differ = [k for k in hs if hs[k].tokens != hs1[k].tokens]
    if differ:
        raise AssertionError(f"(a) fleet streams differ from the single "
                             f"engine's: {differ}")
    holders = {m: hs[(m, 0)].replica_id for m in range(FLEET_MIXES)}
    stray = [k for k in late if hs[k].replica_id != holders[k[0]]]
    hits = reg.get("dttpu_router_affinity_hits_total").value
    if stray or hits != len(late):
        raise AssertionError(f"(a) shared-prompt requests {stray} off "
                             f"their holders {holders}; affinity hits "
                             f"{hits} of {len(late)}")
    _check_serve_launches(model, counts, one, n, skipped, one_skipped,
                          what="(a) fleet")

    def summary(hs, wall):
        ttft = [h.ttft_s for h in hs.values()]
        tok = sum(len(h.tokens) for h in hs.values())
        return {"new_tokens": tok, "wall_s": wall,
                "tokens_per_s": tok / wall,
                "ttft_p50_s": _pct(ttft, 0.5), "ttft_p95_s": _pct(ttft, 0.95)}

    per_replica = collections.Counter(r for _, r in router.placements)
    log({"fleet": "(a) placement", "replicas": FLEET_REPLICAS,
         "requests": n, "shared_prompt_requests": FLEET_MIXES * 4,
         "fleet": summary(hs, wall), "single_engine": summary(hs1, wall1),
         "placements_per_replica": dict(sorted(per_replica.items())),
         "holders": holders, "affinity_hits": hits,
         "windows_skipped": skipped, "single_windows_skipped": one_skipped,
         "launches": counts, "single_launches": one, "card": smi})
    single_tokens = {k: h.tokens for k, h in hs1.items()}
    del runs, router
    _fleet_tenants(torch, np, args, smi, model)
    return single_tokens, counts


def _fleet_tenants(torch, np, args, smi, model):
    """Phase 21 (a), second run: the JAX package's adversarial
    three-tenant mix (``bench.py`` ``bench_fleet``) over the fleet."""
    from distributed_tensorflow_tpu_torch import TenantPolicy, fleet
    from distributed_tensorflow_tpu_torch.obs import Registry

    rng = np.random.default_rng(args.seed)
    reqs = []
    for tenant, (lo, hi) in FLEET_TENANTS.items():
        left = FLEET_DEMAND
        while left > 0:
            budget = min(int(rng.integers(lo, hi)), left)
            prompt = rng.integers(0, model.config.vocab_size,
                                  int(rng.integers(3, 65)), dtype=np.int32)
            reqs.append((tenant, prompt, budget,
                         "pro-tuned" if tenant == "pro" else None))
            left -= budget
    policy = TenantPolicy(quantum=FLEET_QUANTUM)
    router = fleet.Router([_fleet_engine(
        torch, model, tenancy=policy, adapter_capacity=2,
        adapter_rank=SERVE_RANK) for _ in range(FLEET_REPLICAS)],
        registry=Registry())
    ad = _lora_adapters(torch, model, 1, args.seed + 21)["adapter0"]
    router.load_adapter("pro-tuned", ad)
    t0 = time.perf_counter()
    handles = [(t, b, router.submit(p, b, tenant=t, adapter_id=a))
               for t, p, b, a in reqs]
    router.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for t, b, h in handles:
        if h.status != "ok" or len(h.tokens) != b:
            raise AssertionError(f"(a) tenant {t}: status {h.status}, "
                                 f"{len(h.tokens)} of {b} tokens")
    # the bench's fairness: admitted token budgets per tenant (weight-
    # normalized) in TTFT order, up to the admission that exhausts the
    # first tenant's backlog; min over max
    tenants = tuple(FLEET_TENANTS)
    remaining = collections.Counter(t for t, _, _ in handles)
    admitted = dict.fromkeys(tenants, 0)
    for t, b, _ in sorted(handles, key=lambda r: r[2].ttft_s):
        admitted[t] += b
        remaining[t] -= 1
        if remaining[t] == 0:
            break
    norm = [admitted[t] / policy.quota(t).weight for t in tenants]
    ttft = {t: [h.ttft_s for tt, _, h in handles if tt == t]
            for t in tenants}
    tok = sum(len(h.tokens) for _, _, h in handles)
    log({"fleet": "(a) three tenants", "requests": len(handles),
         "demand_per_tenant": FLEET_DEMAND, "quantum": FLEET_QUANTUM,
         "adapter_rank": SERVE_RANK, "tokens_per_s": tok / wall,
         "ttft_p50_s": {t: _pct(v, 0.5) for t, v in ttft.items()},
         "ttft_p95_s": {t: _pct(v, 0.95) for t, v in ttft.items()},
         "fairness_ratio": min(norm) / max(norm) if max(norm) else 0.0,
         "card": smi})


def _victims_mid_decode(router, hs, rid, steps):
    """Pump ``router`` until ``FLEET_KILL_ACTIVE`` of replica ``rid``'s
    requests decode; returns the router steps taken."""
    while True:
        mine = [h for h in hs.values() if h.replica_id == rid]
        if sum(bool(h.tokens) and not h.done for h in mine) \
                >= FLEET_KILL_ACTIVE:
            return steps
        router.step()
        steps += 1


def _fleet_failover(torch, np, args, smi, model, single, kill_host):
    """Phase 21 (b): one run, the wire's faults drop/corrupt/stall (or,
    with ``kill_host``, the link down)."""
    from distributed_tensorflow_tpu_torch import fleet
    from distributed_tensorflow_tpu_torch.obs import Registry
    from distributed_tensorflow_tpu_torch.resilience import (Fault,
                                                             FaultPlan,
                                                             faults)

    prompts, budgets = _requests(np, args.seed)
    reg = Registry()
    wire = fleet.PageWire(chunk_pages=FLEET_WIRE_PAGES, overlap=1,
                          timeout_s=FLEET_WIRE_TIMEOUT_S, seed=args.seed,
                          link=fleet.InProcessLink(wire_id=0),
                          registry=reg)
    engines = [_fleet_engine(torch, model) for _ in range(FLEET_REPLICAS)]
    router = fleet.Router(engines, registry=reg, page_wire=wire)
    adopted = []
    for eng in engines:
        def recording(snap, records, timeout_s=5.0,
                      _imp=eng.import_wire_pages):
            n = _imp(snap, records, timeout_s=timeout_s)
            adopted.append((snap, n))
            return n
        eng.import_wire_pages = recording
    wire_faults = ([{"kind": "kill_host", "at": 0}] if kill_host else
                   [{"kind": "drop_chunk", "at": 0},
                    {"kind": "corrupt_chunk", "at": 2},
                    {"kind": "stall_wire", "at": 4,
                     "seconds": FLEET_WIRE_STALL_S}])
    plan = FaultPlan(wire_faults, seed=args.seed, registry=Registry())
    hs, streams = {}, {}
    with faults.activated(plan):
        for i, (p, b) in enumerate(zip(prompts, budgets)):
            streams[i] = []
            hs[i] = router.submit(p, b, deadline_s=120.0,
                                  on_token=streams[i].extend)
        steps = _victims_mid_decode(router, hs, 1, 0)
        victims = [i for i, h in hs.items()
                   if h.replica_id == 1 and not h.done]
        before = {r: s.prefill_windows_skipped_total
                  for r, s in router.stats().items() if r != 1}
        plan.add(Fault(kind="kill_replica", at=steps, replica=1))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        router.step()                   # replica 1 dies; victims move
        torch.cuda.synchronize()
        kill_ms = (time.perf_counter() - t0) * 1e3
        router.drain(timeout_s=120)
    torch.cuda.synchronize()
    _streams_exact(hs, streams, "(b) failover")
    kinds = sorted(e["kind"] for e in plan.log)
    want_kinds = sorted([f["kind"] for f in wire_faults] + ["kill_replica"])
    value = lambda name: reg.get(name).value        # noqa: E731
    migrations = value("dttpu_migrations_total")
    shipped = value("dttpu_router_wire_migrations_total")
    degraded = value("dttpu_router_wire_degraded_total")
    if kinds != want_kinds or migrations != len(victims) \
            or router.replica_ids != (0, 2):
        raise AssertionError(f"(b) audit {kinds}, migrations {migrations} "
                             f"for {len(victims)} victims, replicas "
                             f"{router.replica_ids}")
    if (kill_host and degraded != 1) or (not kill_host and (
            shipped < 1 or degraded)):
        raise AssertionError(f"(b) wire migrations {shipped}, degraded "
                             f"{degraded}")
    covered = sum(snap.shipped_pages[k - 1][1] // 32
                  for snap, k in adopted if k)
    skipped = sum(router.stats()[r].prefill_windows_skipped_total - v
                  for r, v in before.items())
    if skipped < covered:
        raise AssertionError(f"(b) shipped pages cover {covered} windows; "
                             f"the survivors skipped {skipped}")
    seconds = reg.get("dttpu_wire_transfer_seconds")
    log({"fleet": "(b) failover" + (", kill_host" if kill_host else ""),
         "victims": len(victims), "killed_at_pump": steps,
         "audit": plan.log, "migrations": migrations,
         "wire_migrations": shipped, "wire_degraded": degraded,
         "kill_step_ms": kill_ms,
         "wire_transfer_ms_mean": (seconds.sum / seconds.count * 1e3
                                   if seconds.count else None),
         "frames": value("dttpu_wire_chunks_total"),
         "bytes": value("dttpu_wire_bytes_total"),
         "retries": value("dttpu_wire_chunk_retries_total"),
         "pages_adopted": value("dttpu_wire_pages_shipped_total"),
         "windows_covered": covered, "windows_skipped": skipped,
         "migrated_equal_to_single_engine": sum(
             hs[i].tokens == single[(0, i)] for i in victims),
         "card": smi})


def _fleet_watchdog(torch, np, args, smi, model):
    """Phase 21 (c): a pump thread drives the fleet and checks the
    watchdog after each step, which sees replica 2's stalled tick once it
    completes; then the main thread checks every 20 ms too, and sees
    replica 0's wedged tick in progress.  (Checked while it runs, a
    stall longer than the deadline reads as a wedge.)"""
    import threading

    from distributed_tensorflow_tpu_torch import fleet
    from distributed_tensorflow_tpu_torch.obs import (Registry, Tracer,
                                                      reqtrace, trace)
    from distributed_tensorflow_tpu_torch.resilience import (FaultPlan,
                                                             faults)

    rng = np.random.default_rng(args.seed + 3)
    reqs = [(rng.integers(0, model.config.vocab_size,
                          int(rng.integers(8, 33)), dtype=np.int32),
             int(rng.integers(48, 65))) for _ in range(FLEET_WD_REQUESTS)]
    engines = [_fleet_engine(torch, model) for _ in range(FLEET_REPLICAS)]
    for eng in engines:                 # a first tick off the clock
        eng.submit(reqs[0][0], 2)
        eng.drain()
    reg = Registry()
    router = fleet.Router(engines, registry=reg)
    wd = fleet.Watchdog(router, tick_deadline_s=FLEET_WD_DEADLINE_S,
                        registry=reg)
    clean, victims, at = [], {}, {}
    export = engines[0].export_request

    def recording(handle, timeout_s=None):
        snap = export(handle, timeout_s=timeout_s)
        clean.append(snap.clean)
        return snap

    engines[0].export_request = recording
    quarantine = router.quarantine_replica

    def watched(rid, **kw):
        at[rid] = time.perf_counter()
        victims[rid] = set(router.replica(rid).inflight_trace_ids())
        return quarantine(rid, **kw)

    router.quarantine_replica = watched
    plan = FaultPlan([{"kind": "stall_tick", "at": FLEET_STALL_TICK,
                       "replica": 2, "seconds": FLEET_STALL_S},
                      {"kind": "wedge_replica", "at": FLEET_WEDGE_TICK,
                       "replica": 0, "seconds": 120.0}],
                     seed=args.seed, registry=Registry())
    reqtrace.reset()
    tracer = trace.activate(Tracer(enabled=True))
    stop = threading.Event()

    ticks = {}                  # (replica, tick) -> seconds, every tick

    def pump():
        while not stop.is_set() and router.busy:
            router.step()
            ticks.update(((r, s.ticks_completed), s.last_tick_duration_s)
                         for r, s in router.stats().items())
            wd.check()

    thread = threading.Thread(target=pump, name="dttpu-fleet-pump",
                              daemon=True)
    try:
        with faults.activated(plan):
            streams = {i: [] for i in range(len(reqs))}
            hs = {i: router.submit(p, b, on_token=streams[i].extend)
                  for i, (p, b) in enumerate(reqs)}
            first = {i: h.replica_id for i, h in hs.items()}
            thread.start()
            deadline = time.perf_counter() + 60
            while not wd.log:
                if time.perf_counter() > deadline:
                    raise AssertionError("(c) no stall verdict")
                time.sleep(0.02)
            while len(wd.log) < 2:
                if time.perf_counter() > deadline:
                    raise AssertionError(f"(c) verdicts {wd.log}")
                time.sleep(0.02)
                wd.check()
            wedged_at = router.quarantined[0][0].stats().last_tick_start_s
            stalled = router.quarantined[2][0].stats()
            ticks.pop((2, stalled.ticks_completed), None)
            deadline = time.perf_counter() + 120
            while any(not h.done for h in hs.values()):
                if time.perf_counter() > deadline:
                    raise AssertionError("(c) migrated requests hung")
                router.step()
    finally:
        plan.release_wedges()
        stop.set()
        thread.join(timeout=60)
        trace.deactivate(tracer)
    torch.cuda.synchronize()
    dumps = {d["trace_id"] for d in reqtrace.forensics_log()
             if d["reason"] == "watchdog_quarantine"}
    reqtrace.reset()
    _streams_exact(hs, streams, "(c) watchdog")
    reasons = dict(wd.log)
    moved = [i for i, r in first.items() if r == 0 and hs[i].migrations]
    if thread.is_alive() or sorted(reasons) != [0, 2] \
            or not reasons[0].startswith("wedged") \
            or not reasons[2].startswith("stalled") \
            or sorted(router.quarantined) != [0, 2]:
        raise AssertionError(f"(c) verdicts {wd.log}, quarantined "
                             f"{sorted(router.quarantined)}; longest "
                             f"ticks {sorted(ticks.values())[-5:]} s")
    if not clean or any(clean) or not moved \
            or any(hs[i].replica_id != 1 for i in moved):
        raise AssertionError(f"(c) wedged replica's exports clean "
                             f"{clean}, moved {moved}")
    missing = set().union(*victims.values()) - dumps
    if missing or not victims[0]:
        raise AssertionError(f"(c) no forensic dump for {missing}")
    log({"fleet": "(c) watchdog", "deadline_s": FLEET_WD_DEADLINE_S,
         "verdicts": wd.log,
         "wedge_detect_s": at[0] - wedged_at,
         "stall_detect_after_tick_end_s": at[2] - stalled.last_tick_end_s,
         "stalled_tick_s": stalled.last_tick_duration_s,
         "healthy_ticks": len(ticks),
         "healthy_max_tick_s": max(ticks.values()),
         "wedged_exports": len(clean),
         "moved_to_survivor": len(moved),
         "forensic_dumps": len(dumps), "card": smi})


def _fleet_rolling(torch, np, args, smi, model, single):
    """Phase 21 (d): drain with migration, resume, remove and add under
    traffic."""
    from distributed_tensorflow_tpu_torch import fleet
    from distributed_tensorflow_tpu_torch.obs import Registry

    reg = Registry()
    router = fleet.Router([_fleet_engine(torch, model)
                           for _ in range(FLEET_REPLICAS)], registry=reg)
    hs, streams = {}, {}

    def submit(m):
        prompts, budgets = _requests(np, args.seed + m)
        for i, (p, b) in enumerate(zip(prompts, budgets)):
            streams[(m, i)] = []
            hs[(m, i)] = router.submit(p, b,
                                       on_token=streams[(m, i)].extend)

    submit(0)
    for _ in range(3):
        router.step()
    drained = router.drain_replica(0, timeout_s=120, migrate=True)
    submit(1)
    router.resume_replica(0)
    for _ in range(3):
        router.step()
    removed = router.remove_replica(1)
    added = router.add_replica(_fleet_engine(torch, model))
    router.drain(timeout_s=300)
    torch.cuda.synchronize()
    _streams_exact(hs, streams, "(d) rolling")
    if not drained or router.replica_ids != (0, 2, added) or removed.busy:
        raise AssertionError(f"(d) drained {drained}, replicas "
                             f"{router.replica_ids}")
    moved = [k for k, h in hs.items() if h.migrations]
    log({"fleet": "(d) rolling", "requests": len(hs),
         "migrated": len(moved),
         "migrations": reg.get("dttpu_migrations_total").value,
         "replicas": router.replica_ids,
         "migrated_equal_to_single_engine": sum(
             hs[k].tokens == single.get(k) for k in moved),
         "card": smi})


def _fleet_autoscale(torch, np, args, smi, model):
    """Phase 21 (e): a synthesized trace with one burst on a virtual
    clock, the autoscaler from one replica to ``FLEET_REPLICAS`` and back,
    and the replicas' registries federated behind one ``/metrics``."""
    import urllib.request

    from distributed_tensorflow_tpu_torch import fleet
    from distributed_tensorflow_tpu_torch.obs import (FederatedMetrics,
                                                      Registry,
                                                      parse_exposition)

    trace = fleet.synthesize(
        FLEET_TRACE_N, seed=args.seed, horizon_s=FLEET_TRACE_S, bursts=1,
        burst_magnitude=20.0, burst_width_s=1.0, plen_mean=48.0,
        plen_max=256, new_tokens_mean=24.0, new_tokens_max=64,
        prefix_populations=4, prefix_fraction=0.3, adapters=0)
    rng = np.random.default_rng(args.seed + 5)
    vocab = model.config.vocab_size
    prefixes = {p: rng.integers(0, vocab, 256, dtype=np.int32)
                for p in range(1, 5)}
    prompts = []
    for j in range(len(trace)):
        own = rng.integers(0, vocab, int(trace.plen[j]), dtype=np.int32)
        k = int(trace.prefix_len[j])
        if trace.prefix_id[j]:
            own[:k] = prefixes[int(trace.prefix_id[j])][:k]
        prompts.append(own)
    fed = FederatedMetrics()
    made = []

    def factory():
        reg = Registry()
        fed.add_registry(reg, replica=str(len(made)))
        made.append(_fleet_engine(torch, model, registry=reg))
        return made[-1]

    reg = Registry()
    fed.add_registry(reg)
    router = fleet.Router([factory()], registry=reg)
    slo = fleet.SLO(ttft_s=2.0, itl_s=1.0)
    auto = fleet.Autoscaler(router, factory, slo, min_replicas=1,
                            max_replicas=FLEET_REPLICAS, backlog_high=1.0,
                            eval_interval_s=FLEET_EVAL_S, cooldown_s=5.0,
                            drain_timeout_s=120.0, registry=reg)
    hs, streams, first, done = {}, {}, {}, set()
    now, nxt, evals, width = 0.0, 0, 0, []
    t0 = time.perf_counter()
    while nxt < len(trace) or router.busy or not auto.scale_ins:
        if now > 4 * FLEET_TRACE_S:
            raise AssertionError(f"(e) no scale-in by {now} virtual s: "
                                 f"{auto.history}")
        while nxt < len(trace) and trace.arrival_s[nxt] <= now:
            streams[nxt] = []
            hs[nxt] = router.submit(prompts[nxt], int(trace.new_tokens[nxt]),
                                    tenant=trace.tenants[
                                        int(trace.tenant[nxt])][0],
                                    on_token=streams[nxt].extend)
            nxt += 1
        router.step()
        now += FLEET_STEP_S
        for j, h in hs.items():
            if j not in first and h.tokens:
                first[j] = now - trace.arrival_s[j]
                auto.record(ttft_ok=first[j] <= slo.ttft_s)
            if j not in done and h.done:
                done.add(j)
                gaps = (now - trace.arrival_s[j] - first[j]) \
                    / max(1, len(h.tokens) - 1)
                auto.record(itl_ok=gaps <= slo.itl_s)
                fed.ingest(h.tenant, ttft_s=first[j], tpot_s=gaps,
                           ttft_ok=first[j] <= slo.ttft_s,
                           itl_ok=gaps <= slo.itl_s)
        if now >= (evals + 1) * FLEET_EVAL_S:
            evals += 1
            auto.charge(FLEET_EVAL_S, len(router.replica_ids))
            auto.evaluate(now)
            width.append(len(router.replica_ids))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    _streams_exact(hs, streams, "(e) autoscaled")
    for j, h in hs.items():
        if len(h.tokens) != int(trace.new_tokens[j]):
            raise AssertionError(f"(e) request {j}: {len(h.tokens)} of "
                                 f"{trace.new_tokens[j]} tokens")
    burst = [a for a in auto.history if a[1] == "scale_out"]
    after = [a for a in auto.history if a[1] == "scale_in"
             and burst and a[0] > burst[0][0]]
    if not burst or not after:
        raise AssertionError(f"(e) actions {auto.history}")
    server = fed.serve(port=0)
    try:
        with urllib.request.urlopen(server.url + "/metrics",
                                    timeout=30) as r:
            text = r.read().decode()
    finally:
        server.stop()
    fams = parse_exposition(text)
    labelled = {dict(lbls).get("replica") for (_, lbls) in
                fams["dttpu_serve_tokens_total"]["samples"]}
    slo_series = sorted(n for n in fams if n.startswith("dttpu_slo_"))
    if labelled != {str(i) for i in range(len(made))} or len(slo_series) \
            < 5:
        raise AssertionError(f"(e) federated replicas {labelled} of "
                             f"{len(made)}; slo series {slo_series}")
    arrivals = np.histogram(trace.arrival_s, bins=8,
                            range=(0.0, FLEET_TRACE_S))[0]
    log({"fleet": "(e) autoscaler", "requests": len(trace),
         "trace_fingerprint": trace.fingerprint(),
         "arrivals_per_5s": arrivals.tolist(), "actions": auto.history,
         "replicas_by_eval": width, "virtual_s": now, "wall_s": wall,
         "replica_seconds": auto.replica_seconds,
         "migrations": reg.get("dttpu_migrations_total").value,
         "ttft_p50_virtual_s": _pct(list(first.values()), 0.5),
         "ttft_p95_virtual_s": _pct(list(first.values()), 0.95),
         "federated_sources": fed.source_count(),
         "federated_replicas": sorted(labelled), "slo_series": slo_series,
         "exposition_bytes": len(text), "card": smi})


def check_fleet(torch, np, args, smi, paged):
    """Phase 21: the serving fleet on phase 4's model (``paged``).
    Returns the serving kernels' launches over (a)'s fleet run."""
    t_phase = time.perf_counter()
    model = paged["model"]
    single, launches = _fleet_placement(torch, np, args, smi, model)
    for kill_host in (False, True):
        _fleet_failover(torch, np, args, smi, model, single, kill_host)
    _fleet_watchdog(torch, np, args, smi, model)
    _fleet_rolling(torch, np, args, smi, model, single)
    _fleet_autoscale(torch, np, args, smi, model)
    log({"phase": "fleet", "seconds": time.perf_counter() - t_phase})
    return launches


# the encoder zoo (phase 22).  (a) the flash kernel's new routes at the
# zoo's shapes: BERT-base's bidirectional attention with key padding
# (bench_bert's batch 128 x 128, 12 heads of 64, bf16; lengths drawn
# from --seed, one row with no valid key), ViT-B/16's 197 tokens at batch
# 64 (three full 64-row tiles and a ragged one, unmasked), and the
# padded head dims of the two entry points (train_vit: f32, batch 64 of
# 17 tokens, 4 heads of 16; finetune_bert: bf16, batch 32 of 32 tokens,
# 4 heads of 32); LayerNorm at BERT-base's rows (128 x 128 = 16,384 of
# 768, bf16, eps 1e-12).  (b) bench_bert's row as the JAX package's
# bench promotes it (docs/PROMOTED.json: the gathered head at seq // 5 =
# 25 predictions, remat "dots"), on its batch ladder, beside an arm
# without those levers at batch 96; (d) ViT-B/16 at 224 beside it;
# (f) bench_resnet50's row; (g) Seq2SeqConfig() at full width.  Each
# arm takes ZOO_WARMUP + ZOO_STEPS steps on one batch
ZOO_BERT_SEQ = 128
ZOO_BERT_GATHER = ZOO_BERT_SEQ // 5
ZOO_BERT_LADDER = (128, 96, 48, 24)
ZOO_BERT_PLAIN_BATCH = 96
ZOO_VIT_BATCH = 64
ZOO_RESNET_LADDER = (512, 256, 128, 64)
ZOO_S2S_BATCH, ZOO_S2S_LEN, ZOO_S2S_GEN = 32, 128, 32
ZOO_WARMUP, ZOO_STEPS = 2, 10
# (d) train_vit runs ZOO_VIT_STEPS of its default 300 (cut to make room for
# phase 27; at 300 its last printed loss read 0.0101)
ZOO_VIT_STEPS = 150
ZOO_LR = 1e-4
# (c), (f) and (g)'s card-against-CPU references, f32 with TF32 off: the
# logits within ZOO_LOGIT_TOL of their scale (summation order), losses
# and parameters after the steps within phase 7's TRAIN_LOSS_TOL and
# TRAIN_PARAM_TOL; the ResNet's BatchNorm moments within TRAIN_LOSS_TOL
ZOO_LOGIT_TOL = 1e-4


def _zoo_driven(torch, fn):
    """``_driven`` reading the training kernels' launches."""
    return _driven(torch, fn, _train_counts)


def _zoo_expect(name, counts, want):
    """Fail unless every kernel in ``want`` launched exactly that often."""
    bad = {k: (counts.get(k, 0), n) for k, n in want.items()
           if counts.get(k, 0) != n}
    if bad:
        raise AssertionError(f"{name}: launches (got, expected) {bad}")


def _sdpa_backend(torch, q, k, v, mask, causal=False):
    """The name of the backend SDPA dispatches these inputs to."""
    kw = {} if q.shape[1] == k.shape[1] else {"enable_gqa": True}
    choice = int(torch.ops.aten._fused_sdp_choice(q, k, v, mask, 0.0,
                                                  causal, **kw))
    try:
        from torch.nn.attention import SDPBackend
        return SDPBackend(choice).name
    except (ImportError, ValueError):
        return str(choice)


def _zoo_flash_case(torch, fa, gen, label, b, s, h, hd, dtype, lengths,
                    iters, hk=None, causal=False):
    """One of (a)'s flash cases: the forward (out, lse) and the backward
    through ``flash_attention``'s autograd route (the padding of head
    dims 16 and 32 included) against the plain versions; times of the
    forward and of the backward's two kernels beside their plain
    versions, SDPA (the boolean key mask) and the bound: Q, O (and dO,
    dQ, dK, dV) once each, K and V of the valid keys only, and the
    operations of the (query, valid key) pairs.  ``hk`` kv heads (GQA;
    None: h) and ``causal`` for phase 27's shard shapes.  Returns the
    time records by name."""
    import torch.nn.functional as F
    dev = torch.device("cuda")
    hk = h if hk is None else hk

    def rnd(heads=h):
        return torch.randn(b, s, heads, hd, generator=gen,
                           device=dev).to(dtype)
    q, k, v, do = rnd(), rnd(hk), rnd(hk), rnd()
    valid = None
    if lengths is not None:
        valid = (torch.arange(s, device=dev)[None, :]
                 < torch.as_tensor(lengths, device=dev)[:, None])
    rel = FLASH_BF16_TOL if dtype == torch.bfloat16 else FLASH_F32_TOL
    out, lse = fa.flash_forward(q, k, v, valid, causal)
    errs = {"flash_forward": [
        _err_and_scale(torch, got, want) for got, want in
        zip((out, lse), fa.flash_forward_plain(q, k, v, valid, causal))]}
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    y = fa.flash_attention(*leaves, kv_valid=valid, causal=causal)
    got = (y, *torch.autograd.grad(y, leaves, do))
    plain = [t.clone().requires_grad_() for t in (q, k, v)]
    y0 = fa.flash_attention_plain(*plain, kv_valid=valid, causal=causal)
    want = (y0, *torch.autograd.grad(y0, plain, do))
    errs["flash_forward"].append(_err_and_scale(torch, got[0], want[0]))
    errs["flash_backward_dq"] = [_err_and_scale(torch, got[1], want[1])]
    errs["flash_backward_dkv"] = [_err_and_scale(torch, g, w) for g, w in
                                  zip(got[2:], want[2:])]
    torch.cuda.synchronize()
    for name, es in errs.items():
        err, tol = max(e for e, _ in es), rel * max(sc for _, sc in es)
        log({"check": name, "case": label, "max_abs_err": err, "tol": tol})
        if not err <= tol:
            raise AssertionError(f"{name} disagrees ({label}): {err} > "
                                 f"{tol}")
    del leaves, plain, got, want, y, y0

    # times: the forward as the path calls it (the padding and the slice
    # included at head dims 16 and 32), the backward's two kernels on the
    # padded operands _Flash holds
    sc = 1.0 / hd ** 0.5
    pq, pk, pv, pdo = fa._pad_head_dim(q, k, v, do)
    vb = fa._checked(pq, pk, pv, valid)
    pout, plse = fa._launch_forward(pq, pk, pv, vb, causal, sc)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    mask = None if valid is None else valid[:, None, None, :]
    gqa = {} if hk == h else {"enable_gqa": True}

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                              is_causal=causal, **gqa)
    lib_out = sdpa()
    dot = do.transpose(1, 2)

    def sdpa_bwd():
        return torch.autograd.grad(lib_out, (qt, kt, vt), dot,
                                   retain_graph=True)
    _LIB_BACKWARDS.append((f"whole backward {label}", sdpa, (qt, kt, vt),
                           dot))
    n_keys = b * s if lengths is None else int(sum(lengths))
    tensor = b * s * h * hd * q.element_size()
    # K and V (and dK, dV) of the valid keys
    kv_read = 2 * tensor * hk / h * n_keys / (b * s)
    row = b * h * s * 4
    vbytes = 0 if valid is None else b * s
    # (query, valid key) pairs x hd: under causal each query's keys up to
    # its own
    pairs = (h * hd * b * s * (s + 1) // 2 if causal
             else h * hd * s * n_keys)
    peak = BF16_FLOPS_PER_S if dtype == torch.bfloat16 else F32_FLOPS_PER_S
    calls = {
        "flash_forward": (
            lambda: fa.flash_forward(q, k, v, valid, causal),
            lambda: fa.flash_forward_plain(q, k, v, valid, causal), sdpa,
            (2 * tensor + kv_read + row + vbytes, 4 * pairs)),
        "flash_backward": (
            lambda: fa._backward(pq, pk, pv, vb, pdo, pout, plse, causal,
                                 sc),
            lambda: fa.flash_backward_plain(q, k, v, valid, do, out, lse,
                                            causal), sdpa_bwd,
            # S once and dV, dP, dQ, dK: 5 products of 2 flops a pair;
            # Q, O, dO, dQ and every key's dK, dV written
            (4 * tensor + 2 * tensor * hk / h + kv_read + row + vbytes,
             10 * pairs))}
    backend = _sdpa_backend(torch, qt.detach(), kt.detach(), vt.detach(),
                            mask, causal)
    recs = {}
    for name, (kern, plain_fn, lib, (nbytes, flops)) in calls.items():
        # an autograd backward is captured at the end of the run (a
        # failed capture can leave the context unusable)
        lib_graph, why = ((None, "timed at the end of the run")
                          if lib is sdpa_bwd
                          else _graph_or_why(torch, lib, iters))
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / peak * 1e3
        recs[name] = rec = {
            "time": name, "case": label,
            "shape": f"q[{b},{s},{h}" + ("" if hk == h else f" q / {hk} kv")
                     + f",{hd}] {str(dtype)[6:]} "
                     + ("causal" if causal else "bidirectional")
                     + ("" if valid is None else " kv_valid"),
            "ms": time_ms(torch, kern, iters),
            "graph_ms": graph_ms(torch, kern, iters),
            "plain_ms": time_ms(torch, plain_fn, max(5, iters // 10)),
            "library_ms": time_ms(torch, lib, iters),
            "library_graph_ms": lib_graph, "library_graph_note": why,
            "library": "F.scaled_dot_product_attention("
                       + ("is_causal=True" if causal
                          else "attn_mask=bool [b,1,1,s]")
                       + (", enable_gqa=True" if gqa else "") + ")"
                       + (" backward, dq dk dv together"
                          if name != "flash_forward" else ""),
            "sdpa_backend": backend,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "keys_valid": n_keys, "keys": b * s}
        log(rec)
    torch.cuda.synchronize()
    return recs


def _zoo_layernorm(torch, fused, gen, iters):
    """(a)'s LayerNorm at BERT-base's rows, eps 1e-12, on phase 3's
    unit-scale inputs (gamma near 1, beta near 0, as a BERT norm starts),
    in bf16 (the encoder's norms) and in f32 (the embeddings' norm, which
    runs before the cast to bf16).  bf16: each element within phase 3's
    LN_TOL at its own scale (LN_TOL x max(1, |plain|)): over 12.6M
    unit-normal outputs some lie in [2, 4), where one bf16 rounding step
    is 2^-6 = 0.0156 > LN_TOL; and every element of |plain| >= 0.5
    within one bf16 ulp of it.  f32: within F32_TOL, as phase 19."""
    import torch.nn.functional as F
    rows, d = ZOO_BERT_LADDER[0] * ZOO_BERT_SEQ, 768
    dev = torch.device("cuda")
    x32 = torch.randn(rows, d, generator=gen, device=dev) * 2 + 0.5
    gamma = 1 + 0.1 * torch.randn(d, generator=gen, device=dev)
    beta = 0.1 * torch.randn(d, generator=gen, device=dev)
    for dtype in (torch.bfloat16, torch.float32):
        x = x32.to(dtype)
        case = ("bert_base_rows_eps1e-12" if dtype == torch.bfloat16
                else "bert_base_embedding_rows_eps1e-12_f32")
        got = fused.fused_layernorm(x, gamma, beta, 1e-12).float()
        want = fused.layernorm_plain(x, gamma, beta, 1e-12).float()
        diff = (got - want).abs()
        err = diff.max().item()
        if dtype == torch.bfloat16:
            scaled = (diff / torch.clamp(want.abs(), min=1.0)).max().item()
            big = want.abs() >= 0.5
            ulps = _bf16_ulps(torch, got[big], want[big])
            log({"check": "layernorm", "case": case, "max_abs_err": err,
                 "max_err_at_scale": scaled, "tol": LN_TOL,
                 "max_bf16_ulps_where_abs_ge_0.5": ulps,
                 "elements_over_tol_abs": int((diff > LN_TOL).sum().item())})
            if not (scaled <= LN_TOL and ulps <= 1.0):
                raise AssertionError(f"layernorm disagrees at eps 1e-12: "
                                     f"{err} ({scaled} at scale, {ulps} "
                                     "ulps)")
        else:
            log({"check": "layernorm", "case": case, "max_abs_err": err,
                 "tol": F32_TOL})
            if not err <= F32_TOL:
                raise AssertionError(f"f32 layernorm disagrees at eps "
                                     f"1e-12: {err}")
        g_lib, b_lib = gamma.to(dtype), beta.to(dtype)

        def kern():
            return fused.fused_layernorm(x, gamma, beta, 1e-12)

        def lib():
            return F.layer_norm(x, (d,), g_lib, b_lib, 1e-12)
        b_ms, b_by = bound_ms(2 * x.numel() * x.element_size() + 2 * d * 4,
                              8.0 * x.numel())
        log({"time": "layernorm", "case": case,
             "shape": f"[{rows}, {d}] {str(dtype)[6:]}",
             "ms": time_ms(torch, kern, iters),
             "graph_ms": graph_ms(torch, kern, iters),
             "plain_ms": time_ms(torch, lambda: fused.layernorm_plain(
                 x, gamma, beta, 1e-12), max(5, iters // 10)),
             "library_ms": time_ms(torch, lib, iters),
             "library_graph_ms": graph_ms(torch, lib, iters),
             "library": f"F.layer_norm ({str(dtype)[6:]} gamma, beta)",
             "bound_ms": b_ms, "bound_by": b_by})
        del got, want, diff


def _zoo_steps(torch, np, step, state, batch):
    """ZOO_WARMUP + ZOO_STEPS steps on one batch: (losses, timed seconds,
    peak GB); fails on a non-finite loss."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses = []
    for _ in range(ZOO_WARMUP):
        state, m = step(state, batch)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ZOO_STEPS):
        state, m = step(state, batch)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    losses = [float(x) for x in losses]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite loss: {losses}")
    return losses, wall, torch.cuda.max_memory_allocated() / 1e9


def _zoo_ladder(torch, name, ladder, run):
    """(batch, ``run(batch)``) on the first rung of ``ladder`` that fits;
    a rung that raises ``torch.cuda.OutOfMemoryError`` is logged and the
    next one tried (bench.py's ``_run_batch_ladder``)."""
    for batch in ladder:
        try:
            return batch, run(batch)
        except torch.cuda.OutOfMemoryError as e:
            log({"zoo": name, "rung": batch, "oom": str(e).splitlines()[0]
                 [:160]})
        torch.cuda.empty_cache()
    raise AssertionError(f"{name}: every rung of {ladder} ran out of memory")


def _bert_arm(torch, np, args, smi, name, batches, gather, remat):
    """(b): BERT-base MLM at seq 128, bf16, dropout 0, adamw(1e-4), clip
    1.0, bench_bert's batch (ids, labels, a 15% mask, every position
    valid); the launches a step written before the run and checked."""
    from distributed_tensorflow_tpu_torch import (TrainState, adamw,
                                                  make_custom_train_step)
    from distributed_tensorflow_tpu_torch.models import bert
    config = bert.BertConfig(max_position=ZOO_BERT_SEQ, dtype=torch.bfloat16,
                             dropout_rate=0.0, mlm_predictions_per_seq=gather,
                             remat=remat, remat_policy="dots")
    model = bert.Bert(config)
    L = config.num_layers
    # the flash forward once a layer (twice under remat: the backward
    # recomputes each layer, and no policy saves a kernel the dispatcher
    # never sees), dK/dV and dQ once; LayerNorm the embeddings', 2 a
    # layer and the MLM head's (and 2 a layer recomputed); Adam once a
    # leaf (5 + 16 a layer + 7)
    per_step = {"flash_forward": L * (2 if remat else 1),
                "flash_backward_dkv": L, "flash_backward_dq": L,
                "layernorm": 2 * L + 2 + (2 * L if remat else 0),
                "fused_adam": 5 + 16 * L + 7}

    def run(b):
        params = model.init(torch.Generator("cuda").manual_seed(args.seed))
        opt = adamw(ZOO_LR, mask=model.decay_mask)
        state = TrainState.create(params, opt.init(params))
        step = make_custom_train_step(model.mlm_loss_fn(), opt,
                                      seed=args.seed, grad_clip_norm=1.0)
        rng = np.random.default_rng(args.seed)
        host = {"input_ids": rng.integers(0, config.vocab_size,
                                          (b, ZOO_BERT_SEQ)),
                "labels": rng.integers(0, config.vocab_size,
                                       (b, ZOO_BERT_SEQ)),
                "mlm_mask": (rng.random((b, ZOO_BERT_SEQ)) < 0.15
                             ).astype(np.float32),
                "attention_mask": np.ones((b, ZOO_BERT_SEQ), np.int32)}
        data = {k: torch.from_numpy(v).cuda() for k, v in host.items()}
        try:
            return _zoo_driven(torch, lambda: _zoo_steps(torch, np, step,
                                                         state, data))
        finally:
            del params, state, step, data
    batch, ((losses, wall, peak), _, counts) = _zoo_ladder(
        torch, name, batches, run)
    step_ms = wall / ZOO_STEPS * 1e3
    log({"zoo": name, "batch": batch, "seq": ZOO_BERT_SEQ,
         "mlm_predictions_per_seq": gather,
         "remat_policy": "dots" if remat else None, "steps": ZOO_STEPS,
         "step_ms": step_ms,
         "tokens_per_s": batch * ZOO_BERT_SEQ / (step_ms / 1e3),
         "peak_memory_gb": peak, "losses": losses, "launches": counts,
         "launches_per_step": per_step, "card": smi})
    _zoo_expect(name, counts, {k: n * (ZOO_WARMUP + ZOO_STEPS)
                               for k, n in per_step.items()})
    torch.cuda.empty_cache()
    return counts


def _card_and_cpu(torch, init, run):
    """``run(params, device)`` from copies of ``init`` on the card and
    on the CPU."""
    return [run({k: v.detach().clone().to(device).requires_grad_()
                 for k, v in init.items()}, device)
            for device in ("cuda", "cpu")]


def _bert_reference(torch, np):
    """(c): a 2-layer BERT (head dim 64) in f32 on the card and on the
    CPU from the same weights with a ragged attention_mask: logits, then
    3 adamw steps of the gathered head: losses and parameters."""
    from distributed_tensorflow_tpu_torch import (TrainState, adamw,
                                                  make_custom_train_step)
    from distributed_tensorflow_tpu_torch.models import bert
    model = bert.bert_tiny(dropout_rate=0.0, mlm_predictions_per_seq=12)
    rng = np.random.default_rng(5)
    b, s = 6, 48
    lengths = rng.integers(1, s + 1, b)
    lengths[0] = s
    host = {"input_ids": rng.integers(0, 1000, (b, s)),
            "labels": rng.integers(0, 1000, (b, s)),
            "mlm_mask": (rng.random((b, s)) < 0.3).astype(np.float32),
            "attention_mask": (np.arange(s)[None] < lengths[:, None])
            .astype(np.int32)}

    def run(params, device):
        batch = {k: torch.from_numpy(v).to(device) for k, v in host.items()}
        with torch.no_grad():
            seq = model.apply(params, batch["input_ids"],
                              attention_mask=batch["attention_mask"])
            logits = model.mlm_logits(params, seq).cpu()
        opt = adamw(ZOO_LR, mask=model.decay_mask)
        state = TrainState.create(params, opt.init(params))
        step = make_custom_train_step(model.mlm_loss_fn(), opt,
                                      grad_clip_norm=1.0)
        losses = []
        for _ in range(3):
            state, m = step(state, batch)
            losses.append(m["loss"].item())
        return logits, losses, {k: p.detach().cpu()
                                for k, p in state.params.items()}
    (cl, closs, cp), (pl, ploss, pp) = _card_and_cpu(
        torch, model.init(torch.Generator().manual_seed(0)), run)
    err, scale = _err_and_scale(torch, cl, pl)
    loss_err = max(abs(a - c) for a, c in zip(closs, ploss))
    param_err = max((cp[k] - pp[k]).abs().max().item() for k in pp)
    log({"zoo": "(c) bert card vs CPU", "logit_err": err,
         "logit_tol": ZOO_LOGIT_TOL * scale, "card_losses": closs,
         "cpu_losses": ploss, "loss_err": loss_err,
         "loss_tol": TRAIN_LOSS_TOL, "param_err": param_err,
         "param_tol": TRAIN_PARAM_TOL, "lengths": lengths.tolist()})
    if not (err <= ZOO_LOGIT_TOL * scale and loss_err <= TRAIN_LOSS_TOL
            and param_err <= TRAIN_PARAM_TOL):
        raise AssertionError("BERT: card and CPU disagree")


def _resnet_reference(torch, np):
    """(f): resnet_cifar in f32 on the card and on the CPU over 2
    momentum(0.01) steps: losses, parameters and the BatchNorm moments."""
    from distributed_tensorflow_tpu_torch import optim, train
    from distributed_tensorflow_tpu_torch.models import resnet
    from distributed_tensorflow_tpu_torch.ops.layers import _flat, _nest

    def flat_cpu(tree):
        return {k: v.detach().cpu() for k, v in _flat(tree, "").items()}
    model = resnet.resnet_cifar()
    init, init_state = model.init(torch.Generator().manual_seed(0),
                                  (32, 32, 3))
    rng = np.random.default_rng(6)
    data = [(rng.standard_normal((8, 32, 32, 3)).astype(np.float32),
             rng.integers(0, 10, 8)) for _ in range(2)]

    def run(params, device):
        mstate = _nest({k: v.to(device)
                        for k, v in _flat(init_state, "").items()})
        opt = optim.momentum(0.01, beta=0.9)
        state = train.TrainState.create(params, opt.init(params), mstate)
        step = train.make_train_step(model, "sparse_categorical_crossentropy",
                                     opt)
        losses = []
        for x, y in data:
            state, m = step(state, (torch.from_numpy(x).to(device),
                                    torch.from_numpy(y).to(device)))
            losses.append(m["loss"].item())
        return (losses, {k: p.detach().cpu()
                         for k, p in state.params.items()},
                flat_cpu(state.model_state))
    (cl, cp, cs), (pl, pp, ps) = _card_and_cpu(torch, init, run)
    loss_err = max(abs(a - b) for a, b in zip(cl, pl))
    param_err = max((cp[k] - pp[k]).abs().max().item() for k in pp)
    state_err = max((cs[k] - ps[k]).abs().max().item() for k in ps)
    log({"zoo": "(f) resnet_cifar card vs CPU", "card_losses": cl,
         "cpu_losses": pl, "loss_err": loss_err, "param_err": param_err,
         "batchnorm_state_err": state_err, "loss_tol": TRAIN_LOSS_TOL,
         "param_tol": TRAIN_PARAM_TOL, "state_tol": TRAIN_LOSS_TOL})
    if not (loss_err <= TRAIN_LOSS_TOL and param_err <= TRAIN_PARAM_TOL
            and state_err <= TRAIN_LOSS_TOL):
        raise AssertionError("ResNet: card and CPU disagree")


def vit_per_step(L):
    """ViT's training kernels a step: the flash kernels once a layer,
    LayerNorm 2 a layer and the final one, Adam once a leaf (the patch
    kernel and bias, the CLS token, the positions, 16 a layer, the final
    norm's two and the head's two)."""
    return {"flash_forward": L, "flash_backward_dkv": L,
            "flash_backward_dq": L, "layernorm": 2 * L + 1,
            "fused_adam": 4 + 16 * L + 4}


def _vit_base(torch, np, args, smi):
    """(d): ViT-B/16 at 224, bf16, batch 64, adamw(1e-4), clip 1.0."""
    from distributed_tensorflow_tpu_torch import (TrainState, adamw,
                                                  make_custom_train_step)
    from distributed_tensorflow_tpu_torch.models import vit
    model = vit.vit_base(dtype=torch.bfloat16)
    params = model.init(torch.Generator("cuda").manual_seed(args.seed))
    opt = adamw(ZOO_LR, mask=model.decay_mask)
    state = TrainState.create(params, opt.init(params))
    step = make_custom_train_step(model.loss_fn(), opt, seed=args.seed,
                                  grad_clip_norm=1.0)
    rng = np.random.default_rng(args.seed)
    b = ZOO_VIT_BATCH
    data = (torch.from_numpy(rng.random((b, 224, 224, 3), np.float32))
            .cuda(), torch.from_numpy(rng.integers(0, 1000, b)).cuda())
    (losses, wall, peak), _, counts = _zoo_driven(
        torch, lambda: _zoo_steps(torch, np, step, state, data))
    per_step = vit_per_step(model.config.num_layers)
    step_ms = wall / ZOO_STEPS * 1e3
    log({"zoo": "(d) vit_b16", "batch": b, "tokens": 197,
         "steps": ZOO_STEPS, "step_ms": step_ms,
         "images_per_s": b / (step_ms / 1e3), "peak_memory_gb": peak,
         "losses": losses, "launches": counts,
         "launches_per_step": per_step, "card": smi})
    _zoo_expect("(d) vit_b16", counts,
                {k: n * (ZOO_WARMUP + ZOO_STEPS)
                 for k, n in per_step.items()})
    del params, state, step, data
    torch.cuda.empty_cache()
    return counts


def _eval_acc(out):
    line = [x for x in out.splitlines() if x.startswith("eval accuracy:")]
    if len(line) != 1:
        raise AssertionError(f"no eval accuracy line in:\n{out}")
    return float(line[0].split(":")[1])


def _zoo_entry_points(torch, smi):
    """(d) train_vit and (e) finetune_bert in-process on the card; their
    launches checked exactly against the counts their steps imply."""
    from distributed_tensorflow_tpu_torch.examples import (finetune_bert,
                                                           train_vit)
    counts = collections.Counter()

    # train_vit: 4 layers, 4 + 16 x 4 + 4 = 72 leaves, ZOO_VIT_STEPS steps
    # and one eval forward
    steps, L = ZOO_VIT_STEPS, 4
    (out, wall), _, c = _zoo_driven(
        torch, lambda: _run_entry(torch, train_vit.main, [
            "--device=cuda", f"--steps={steps}"]))
    acc = _eval_acc(out)
    log({"zoo": "(d) train_vit entry point", "wall_s": wall,
         "step_ms": wall / steps * 1e3, "eval_accuracy": acc,
         "printed": out.splitlines()[-3:], "launches": c, "card": smi})
    _zoo_expect("train_vit", c, {
        "flash_forward": L * (steps + 1), "flash_backward_dkv": L * steps,
        "flash_backward_dq": L * steps,
        "layernorm": (2 * L + 1) * (steps + 1),
        "fused_adam": (8 + 16 * L) * steps})
    if not acc > 1.0 / 4:
        raise AssertionError(f"train_vit eval accuracy {acc} is not above "
                             "chance (0.25)")
    counts.update(c)

    # finetune_bert: 2 layers, 5 + 16 x 2 + 7 BERT leaves and the
    # classifier's 2; the classifier's loss runs no MLM head (5 LayerNorms
    # a forward), the MLM steps do (6)
    L, steps = 2, 150
    for argv, mlm in ((["--device=cuda"], 0),
                      (["--device=cuda", "--mlm_steps=4",
                        "--mlm_predictions_per_seq=8"], 4)):
        (out, wall), _, c = _zoo_driven(
            torch, lambda: _run_entry(torch, finetune_bert.main, argv))
        acc = _eval_acc(out)
        log({"zoo": "(e) finetune_bert entry point", "argv": argv,
             "wall_s": wall, "eval_accuracy": acc,
             "printed": out.splitlines(), "launches": c, "card": smi})
        _zoo_expect(f"finetune_bert {argv}", c, {
            "flash_forward": L * (steps + mlm + 1),
            "flash_backward_dkv": L * (steps + mlm),
            "flash_backward_dq": L * (steps + mlm),
            "layernorm": 5 * (steps + 1) + 6 * mlm,
            "fused_adam": (5 + 16 * L + 7 + 2) * (steps + mlm)})
        if mlm and not any(x.startswith("mlm step 4:")
                           for x in out.splitlines()):
            raise AssertionError(f"no 'mlm step 4:' line in:\n{out}")
        counts.update(c)
    return counts


def _resnet50(torch, np, args, smi):
    """(f): bench_resnet50's row: 224, mixed_bfloat16, momentum(0.1,
    beta=0.9), on its batch ladder; the convolutions are cuDNN's and no
    kernel of the port's runs (the momentum update has none)."""
    from distributed_tensorflow_tpu_torch import optim, train
    from distributed_tensorflow_tpu_torch.models import resnet
    model = resnet.resnet50(num_classes=1000)

    def run(b):
        opt = optim.momentum(0.1, beta=0.9)
        state = train.init_train_state(
            model, opt, torch.Generator("cuda").manual_seed(args.seed),
            (224, 224, 3))
        step = train.make_train_step(model, "sparse_categorical_crossentropy",
                                     opt, policy="mixed_bfloat16")
        rng = np.random.default_rng(args.seed)
        data = (torch.from_numpy(rng.random((b, 224, 224, 3), np.float32))
                .cuda().to(torch.bfloat16),
                torch.from_numpy(rng.integers(0, 1000, b)).cuda())
        try:
            return _zoo_driven(torch, lambda: _zoo_steps(torch, np, step,
                                                         state, data))
        finally:
            del state, step, data
    batch, ((losses, wall, peak), _, counts) = _zoo_ladder(
        torch, "(f) resnet50", ZOO_RESNET_LADDER, run)
    step_ms = wall / ZOO_STEPS * 1e3
    log({"zoo": "(f) resnet50", "batch": batch, "image_size": 224,
         "policy": "mixed_bfloat16", "steps": ZOO_STEPS, "step_ms": step_ms,
         "examples_per_s": batch / (step_ms / 1e3), "peak_memory_gb": peak,
         "losses": losses, "launches": counts, "card": smi})
    torch.cuda.empty_cache()


def s2s_per_step(c):
    """A seq2seq training step's kernel launches (every rank's alike):
    dense attention (no flash); LayerNorm 2 an encoder layer, 3 a decoder
    layer and each stack's final; Adam once a leaf."""
    return {"flash_forward": 0,
            "layernorm": 2 * c.num_encoder_layers
            + 3 * c.num_decoder_layers + 2,
            "fused_adam": 3 + 16 * c.num_encoder_layers
            + 26 * c.num_decoder_layers + 4}


def _seq2seq(torch, np, args, smi):
    """(g): Seq2SeqConfig() at full width, bf16, batch 32 of 128 source
    and 128 target tokens, adamw(1e-4), clip 1.0; then greedy generate of
    32 tokens on a 2 + 2-layer f32 copy, card against CPU."""
    from distributed_tensorflow_tpu_torch import (TrainState, adamw,
                                                  make_custom_train_step)
    from distributed_tensorflow_tpu_torch.models import seq2seq
    c = seq2seq.Seq2SeqConfig(dtype=torch.bfloat16, dropout_rate=0.0)
    model = seq2seq.Seq2Seq(c)
    params = model.init(torch.Generator("cuda").manual_seed(args.seed))
    opt = adamw(ZOO_LR, mask=model.decay_mask)
    state = TrainState.create(params, opt.init(params))
    step = make_custom_train_step(model.seq2seq_loss_fn(), opt,
                                  seed=args.seed, grad_clip_norm=1.0)
    rng = np.random.default_rng(args.seed)
    b, n = ZOO_S2S_BATCH, ZOO_S2S_LEN
    data = {"src_ids": torch.from_numpy(rng.integers(2, c.vocab_size,
                                                     (b, n))).cuda(),
            "tgt_ids": torch.from_numpy(rng.integers(2, c.vocab_size,
                                                     (b, n + 1))).cuda()}
    (losses, wall, peak), _, counts = _zoo_driven(
        torch, lambda: _zoo_steps(torch, np, step, state, data))
    per_step = s2s_per_step(c)
    step_ms = wall / ZOO_STEPS * 1e3
    log({"zoo": "(g) seq2seq", "batch": b, "src": n, "tgt": n,
         "steps": ZOO_STEPS, "step_ms": step_ms,
         "tokens_per_s": b * n / (step_ms / 1e3), "peak_memory_gb": peak,
         "losses": losses, "launches": counts,
         "launches_per_step": per_step, "card": smi})
    _zoo_expect("(g) seq2seq", counts,
                {k: v * (ZOO_WARMUP + ZOO_STEPS)
                 for k, v in per_step.items()})
    del params, state, step, data
    torch.cuda.empty_cache()

    small = seq2seq.Seq2Seq(seq2seq.Seq2SeqConfig(
        num_encoder_layers=2, num_decoder_layers=2, dropout_rate=0.0))
    init = small.init(torch.Generator().manual_seed(1))
    with torch.no_grad():       # 5x: tokens that vary (not one repeated)
        for v in init.values():
            if v.dim() > 1:
                v.mul_(5.0)
    src = rng.integers(2, small.config.vocab_size, (2, 24))
    valid = np.ones((2, 24), np.int32)
    valid[1, 15:] = 0
    toks = [small.generate({k: v.detach().to(device)
                            for k, v in init.items()},
                           torch.from_numpy(src).to(device), ZOO_S2S_GEN,
                           src_valid=torch.from_numpy(valid).to(device)
                           ).cpu() for device in ("cuda", "cpu")]
    log({"zoo": "(g) seq2seq greedy generate card vs CPU",
         "tokens_equal": bool(torch.equal(*toks)),
         "distinct_tokens": int(torch.unique(toks[1]).numel())})
    if not torch.equal(*toks):
        raise AssertionError("seq2seq greedy tokens differ on the card")
    return counts


def check_zoo(torch, np, args, smi):
    """Phase 22, the encoder zoo: returns the kernels' launches over its
    main-path runs ((b), (d), (e), (g))."""
    from distributed_tensorflow_tpu_torch.ops.kernels import \
        flash_attention as fa
    from distributed_tensorflow_tpu_torch.ops.kernels import fused
    t_phase = time.perf_counter()
    gen = torch.Generator("cuda").manual_seed(args.seed + 22)
    iters = max(20, args.iters // 4)
    rng = np.random.default_rng(args.seed)
    lengths = rng.integers(1, ZOO_BERT_SEQ + 1, ZOO_BERT_LADDER[0])
    lengths[0] = 0                     # a row with no valid key
    for label, shape in (
            ("bert_base_kv_valid", (ZOO_BERT_LADDER[0], ZOO_BERT_SEQ, 12, 64,
                                    torch.bfloat16, lengths.tolist())),
            ("vit_b16_197", (ZOO_VIT_BATCH, 197, 12, 64, torch.bfloat16,
                             None)),
            ("train_vit_hd16_f32", (64, 17, 4, 16, torch.float32, None)),
            ("finetune_bert_hd32", (32, 32, 4, 32, torch.bfloat16, None))):
        _zoo_flash_case(torch, fa, gen, label, *shape, iters)
    _zoo_layernorm(torch, fused, gen, iters)
    log({"zoo": "(a) kernels", "seconds": time.perf_counter() - t_phase})

    counts = collections.Counter()
    counts.update(_bert_arm(torch, np, args, smi,
                            "(b) bert_base mlm promoted", ZOO_BERT_LADDER,
                            ZOO_BERT_GATHER, True))
    counts.update(_bert_arm(torch, np, args, smi,
                            "(b) bert_base mlm no levers",
                            (ZOO_BERT_PLAIN_BATCH,), 0, False))
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        _bert_reference(torch, np)
        _resnet_reference(torch, np)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
    counts.update(_vit_base(torch, np, args, smi))
    counts.update(_zoo_entry_points(torch, smi))
    _resnet50(torch, np, args, smi)
    counts.update(_seq2seq(torch, np, args, smi))
    log({"phase": "zoo", "seconds": time.perf_counter() - t_phase,
         "launches": dict(counts)})
    return counts


# -- phase 23: the GPT family's last configurations --------------------------

# (a) the paged kernel at head dim 32 (the serve_gpt demo's model and
# llama_tiny): FAM_S slots in pages of FAM_PG over a view of FAM_P pages
# (128 columns: llama_tiny's max_position), FAM_L layers; the window
# FAM_WIN queries at FAM_WIN_POS.  (b) bench_gpt_moe's row (bench.py:
# 2604, 855-884): GPT-2 small with FAM_EXPERTS experts, top FAM_TOP_K,
# capacity factor 1.25, remat "full", the bench's ladder at FAM_SEQ;
# (c) the same weights served at capacity factor FAM_SERVE_CAPACITY = E
# / k, so that a prefill window of 32 never drops a token (JAX
# models/gpt.py:370-375: a generous factor at eval); (d) a 2-layer f32
# MoE model card against CPU, gradients within FAM_GRAD_TOL of each
# leaf's scale (f32 summation order; TF32 off); (e) bench_llama's row
# (bench.py:975-1010) on the same ladder
FAM_L, FAM_S, FAM_PG, FAM_P, FAM_HD = 4, 8, 16, 8, 32
FAM_WIN, FAM_WIN_POS = 32, 96
FAM_EXPERTS, FAM_TOP_K, FAM_SERVE_CAPACITY = 8, 2, 4.0
FAM_LADDER, FAM_SEQ = (48, 24, 12), 256
FAM_GRAD_TOL = 1e-4
_FAMILY_KERNELS = ("flash_forward", "flash_backward_dkv", "flash_backward_dq",
                   "layernorm", "rmsnorm", "fused_adam",
                   "paged_decode_attention", "paged_window_attention",
                   "paged_decode_int8", "paged_window_int8")


def _family_counts(torch):
    """Phase 23's reader: every kernel's launches since ``_reset_counts``,
    under the kernels line's names (the paged entries by branch)."""
    from distributed_tensorflow_tpu_torch.ops.kernels import \
        flash_attention as fa
    from distributed_tensorflow_tpu_torch.ops.kernels import fused
    from distributed_tensorflow_tpu_torch.ops.kernels import \
        paged_attention as pa
    torch.cuda.synchronize()
    return {"flash_forward": fa.LAUNCHES["flash_forward"],
            "flash_backward_dkv": fa.LAUNCHES["flash_backward_dkv"],
            "flash_backward_dq": fa.LAUNCHES["flash_backward_dq"],
            "layernorm": fused.LAUNCHES["layernorm"],
            "rmsnorm": fused.LAUNCHES["rmsnorm"],
            "fused_adam": fused.LAUNCHES["adam"],
            "paged_decode_attention": pa.LAUNCHES["paged_decode"],
            "paged_window_attention": pa.LAUNCHES["paged_window"],
            "paged_decode_int8": pa.LAUNCHES["paged_decode_int8"],
            "paged_window_int8": pa.LAUNCHES["paged_window_int8"]}


def _family_want(**launches):
    """Exact launches for ``_zoo_expect``: the kernels named, and 0 for
    every other kernel ``_family_counts`` reads."""
    want = dict.fromkeys(_FAMILY_KERNELS, 0)
    want.update(launches)
    return want


def _family_pool(torch, gen, L, NP, pg, kvh, hd, dtype, int8):
    """A page pool of ``L`` layers: unit-normal K/V in ``dtype``, or int8
    values with per-(token, kv head) f32 scales as the serving write
    leaves them (amax / 127 of values of about unit scale)."""
    shape = (L, NP, pg, kvh, hd)
    kv = {}
    for name in ("k", "v"):
        if int8:
            kv[name] = torch.randint(-127, 128, shape, generator=gen,
                                     device=gen.device, dtype=torch.int8)
            kv[name + "_scale"] = 0.01 + 0.02 * torch.rand(
                shape[:-1] + (1,), generator=gen, device=gen.device)
        else:
            kv[name] = torch.randn(shape, generator=gen,
                                   device=gen.device).to(dtype)
    return kv


def _family_paged_case(torch, pa, args, label, q, kv, window, tab, valid,
                       row, wmask, n_cols, n_pages, flops):
    """One branch of (a): the kernel against its plain version on every
    layer, with the branch's tolerance; then ms, graph ms, the plain
    version's ms, gather + SDPA (int8: dequantized first) and the bound."""
    import torch.nn.functional as F
    L = kv["k"].shape[0]
    int8 = "k_scale" in kv
    bf16 = q.dtype == torch.bfloat16
    layers = iter(range(10 ** 9))

    def nxt():
        return next(layers) % L

    if window:
        def kern(layer=None):
            return pa.paged_window_attention(
                q, kv, nxt() if layer is None else layer, row, FAM_WIN_POS)

        def plain(layer=None):
            return pa.paged_window_attention_plain(
                q, kv, nxt() if layer is None else layer, row, FAM_WIN_POS)
        lib_tab, mask = row[None, :], wmask
    else:
        def kern(layer=None):
            return pa.paged_decode_attention(
                q, kv, nxt() if layer is None else layer, tab, valid)

        def plain(layer=None):
            return pa.paged_decode_attention_plain(
                q, kv, nxt() if layer is None else layer, tab, valid)
        lib_tab, mask = tab, valid[:, None, None, :]

    def lib():
        k, v = pa.paged_layer_kv(kv, nxt(), lib_tab)
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.to(q.dtype).transpose(1, 2),
            v.to(q.dtype).transpose(1, 2), attn_mask=mask, enable_gqa=True)

    err, scale = 0.0, 1.0
    for layer in range(L):
        e, sc = _err_and_scale(torch, kern(layer), plain(layer))
        err, scale = max(err, e), max(scale, sc)
    if int8:
        tol = (INT8_BF16_TOL if bf16 else INT8_F32_TOL) * scale
    else:
        tol = (WINDOW_TOL if window else DECODE_TOL) if bf16 else F32_TOL
    iters = args.iters
    ms = time_ms(torch, kern, iters)
    plain_ms = time_ms(torch, plain, max(5, iters // 10))
    lib_ms = time_ms(torch, lib, max(5, iters // 10))
    g_ms = graph_ms(torch, kern, iters)
    g_lib, why = _graph_or_why(torch, lib, max(5, iters // 10))
    B, sq, h, hd = q.shape
    kvh = kv["k"].shape[3]
    cell = 2 * (hd * (1 if int8 else q.element_size()) + (4 if int8 else 0))
    side = 2 * q.numel() * q.element_size() + lib_tab.numel() * 4 + (
        0 if window else valid.numel())
    nbytes = n_pages * kv["k"].shape[2] * kvh * cell + side
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / (BF16_FLOPS_PER_S if bf16 else F32_FLOPS_PER_S) * 1e3
    rec = {"check": "paged_hd32", "case": label,
           "shape": f"q[{B},{sq},{h},{hd}] {'bf16' if bf16 else 'f32'}, "
                    f"{'int8' if int8 else 'q-type'} pool "
                    f"[{L},{kv['k'].shape[1]},{kv['k'].shape[2]},{kvh},"
                    f"{hd}]" + (f", pos {FAM_WIN_POS}" if window else ""),
           "route": "tensor_cores" if pa.tensor_cores(bf16, int8, window)
           else "cuda_cores", "valid_cols": n_cols,
           "max_abs_err": err, "tol": tol, "kernel_ms": ms,
           "graph_ms": g_ms, "plain_ms": plain_ms, "library_ms": lib_ms,
           "library_graph_ms": g_lib,
           "library": ("dequant + " if int8 else "")
           + "gather + F.scaled_dot_product_attention",
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    if why:
        rec["library_graph_note"] = why
    log(rec)
    if not err <= tol:
        raise AssertionError(f"paged kernel at head dim 32 ({label}) "
                             f"disagrees: {err} > {tol}")
    return rec


def _family_paged_hd32(torch, args):
    """(a): the paged kernel at head dim 32 on all 16 of its branches:
    decode and window, bf16 and f32 q, a pool in q's type and int8, MHA
    (the serve_gpt demo: 4 heads) and GQA (llama_tiny: 4q/2kv).  Decode
    rows are ragged, one wholly on the trash page, one with no valid
    column."""
    from distributed_tensorflow_tpu_torch.ops.kernels import \
        paged_attention as pa
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(args.seed + 23)
    L, S, pg, P, hd = FAM_L, FAM_S, FAM_PG, FAM_P, FAM_HD
    view, NP = P * pg, S * P + 1
    perm = torch.randperm(NP - 1, generator=gen, device=dev) + 1
    tab = perm[:S * P].reshape(S, P).to(torch.int32)
    tab[3] = 0                                   # retired: the trash page
    starts = torch.tensor([0, 0, 16, 0, 40, 90, 0, 3], device=dev)
    ends = torch.tensor([37, 128, 100, 5, 127, 90, 64, 128], device=dev)
    cols = torch.arange(view, device=dev)[None, :]
    valid = ((cols >= starts[:, None]) & (cols < ends[:, None])).contiguous()
    row = perm[-P:].to(torch.int32).contiguous()
    pos, sq = FAM_WIN_POS, FAM_WIN
    wmask = (cols <= pos + torch.arange(sq, device=dev)[:, None])[None, None]
    n_valid = int(valid.sum())
    d_pages = torch.unique(tab.long().repeat_interleave(pg, dim=1)[valid])
    w_pages = len(set(row[:(pos + sq - 1) // pg + 1].tolist()))
    w_cols = sum(min(pos + j + 1, view) for j in range(sq))
    recs = []
    for heads, h, kvh in (("mha", 4, 4), ("gqa", 4, 2)):
        for dtype in (torch.float32, torch.bfloat16):
            for int8 in (False, True):
                kv = _family_pool(torch, gen, L, NP, pg, kvh, hd, dtype,
                                  int8)
                for window in (False, True):
                    shape = (1, sq, h, hd) if window else (S, 1, h, hd)
                    q = torch.randn(shape, generator=gen,
                                    device=dev).to(dtype)
                    label = "_".join((
                        "window" if window else "decode", heads,
                        "bf16" if dtype == torch.bfloat16 else "f32",
                        "int8" if int8 else "pool"))
                    n_cols = w_cols if window else n_valid
                    recs.append(_family_paged_case(
                        torch, pa, args, label, q, kv, window, tab, valid,
                        row, wmask, n_cols,
                        w_pages if window else d_pages.numel(),
                        4.0 * n_cols * h * hd))
                del kv
    torch.cuda.synchronize()
    return recs


def _family_steps(torch, np, step, state, batch, keys):
    """``_zoo_steps`` keeping each step's ``keys`` metrics beside the
    losses: (losses, {key: [values]}, timed seconds, peak GB)."""
    kept = []

    def keep(state, batch):
        state, m = step(state, batch)
        kept.append({k: m[k] for k in keys})
        return state, m
    losses, wall, peak = _zoo_steps(torch, np, keep, state, batch)
    return losses, {k: [float(m[k]) for m in kept] for k in keys}, wall, peak


def _family_train_arm(torch, np, args, smi, name, config, per_step,
                      keys=()):
    """One training arm on ``FAM_LADDER`` (a fresh model from ``--seed``
    on each rung): ``adamw(1e-4)``, clip 1.0, rows of FAM_SEQ + 1 ids;
    exact launches; step ms, tokens/s, mfu, peak memory.  Returns (the
    model, the counts, the run's numbers)."""
    from distributed_tensorflow_tpu_torch import GPT
    built = {}

    def run(b):
        built.pop("model", None)         # a rung that ran out of memory
        model = built["model"] = GPT(
            config, device="cuda",
            generator=torch.Generator("cuda").manual_seed(args.seed))
        state, step = _train_setup(torch, model, TRAIN_LR, args.seed)
        batch = _train_batch(torch, np, args.seed, b, FAM_SEQ,
                             config.vocab_size, "cuda")
        try:
            return _driven(torch, lambda: _family_steps(
                torch, np, step, state, batch, keys), _family_counts)
        finally:
            del state, step, batch
    batch, ((losses, kept, wall, peak), _, counts) = _zoo_ladder(
        torch, name, FAM_LADDER, run)
    model = built["model"]
    step_ms = wall / ZOO_STEPS * 1e3
    tokens = batch * FAM_SEQ
    flops = _model_flops(model, tokens, FAM_SEQ)
    if config.moe_experts:
        # 6N counts every expert, but a token runs through top_k of them
        # (bench.py:951-959 discounts the rest)
        n_exp = sum(p.numel() for n, p in model.named_parameters()
                    if ".moe.experts." in n)
        flops -= 6.0 * n_exp * (1 - config.moe_top_k / config.moe_experts) \
            * tokens
    out = {"batch": batch, "step_ms": step_ms,
           "tokens_per_s": tokens / (step_ms / 1e3),
           "mfu": flops / (step_ms / 1e3) / BF16_FLOPS_PER_S,
           "model_tflop_per_step": flops / 1e12, "peak_memory_gb": peak,
           "losses": losses, **kept}
    log({"family": name, "seq": FAM_SEQ, "steps": ZOO_STEPS, **out,
         "launches": counts, "launches_per_step": per_step, "card": smi})
    _zoo_expect(name, counts, _family_want(
        **{k: n * (ZOO_WARMUP + ZOO_STEPS) for k, n in per_step.items()}))
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{name}: loss did not fall: {losses}")
    return model, counts, out


def moe_config(torch):
    """bench_gpt_moe's row: GPT-2 small with FAM_EXPERTS experts, top
    FAM_TOP_K, remat "full", bf16, dropout 0, positions of FAM_SEQ."""
    from distributed_tensorflow_tpu_torch import gpt_small
    return gpt_small(dtype=torch.bfloat16, dropout_rate=0.0, remat=True,
                     remat_policy="full", moe_experts=FAM_EXPERTS,
                     moe_top_k=FAM_TOP_K, max_position=FAM_SEQ)


def moe_per_step(L):
    """The MoE GPT's training kernels a step under remat "full": the flash
    forward twice a layer (the recomputation runs it again), dK/dV and dQ
    once; LayerNorm 2 a layer + ln_f, and 2 a layer again; Adam once a
    leaf: word, position, ln_f's two, and 17 a layer (a MoE block has 5
    FFN leaves where a dense one has 4)."""
    return {"flash_forward": 2 * L, "flash_backward_dkv": L,
            "flash_backward_dq": L, "layernorm": 4 * L + 1,
            "fused_adam": 4 + 17 * L}


def _family_moe_train(torch, np, args, smi):
    """(b): bench_gpt_moe's row; returns the counts."""
    from distributed_tensorflow_tpu_torch.models import gpt as gpt_mod
    config = moe_config(torch)
    per_step = moe_per_step(config.num_layers)
    model, counts, out = _family_train_arm(
        torch, np, args, smi, "(b) gpt2-small moe 8x top-2", config,
        per_step, keys=("moe_aux",))
    aux = out["moe_aux"]
    if not all(a > 0 and math.isfinite(a) for a in aux):
        raise AssertionError(f"(b) moe_aux not finite and positive: {aux}")
    # the dropped fraction of each layer on the last batch's shape, read
    # from the router's metrics in one forward at train=False
    dropped = []
    real = gpt_mod.apply_moe

    def spy(*a, **kw):
        y, m = real(*a, **kw)
        dropped.append(float(m["dropped_fraction"]))
        return y, m
    ids = _train_batch(torch, np, args.seed, out["batch"], FAM_SEQ,
                       config.vocab_size, "cuda")["input_ids"]
    gpt_mod.apply_moe = spy
    try:
        with torch.no_grad():
            model.apply(ids[:, :-1])
    finally:
        gpt_mod.apply_moe = real
    log({"family": "(b) dropped fraction", "per_layer": dropped,
         "mean": sum(dropped) / len(dropped), "moe_aux_last": aux[-1]})
    del model
    torch.cuda.empty_cache()
    return counts


def _family_moe_serve(torch, np, args, smi, phase4):
    """(c): (b)'s model (random weights from ``--seed``, phase 4's
    max_position) behind ``Engine`` at capacity factor
    FAM_SERVE_CAPACITY on phase 4's mix: budgets, a prefix hit, the
    paged and LayerNorm launches equal to phase 4's (the same requests
    run the same windows and decode steps), row independence."""
    from distributed_tensorflow_tpu_torch import GPT, gpt_small
    config = gpt_small(dtype=torch.bfloat16, moe_experts=FAM_EXPERTS,
                       moe_top_k=FAM_TOP_K,
                       moe_capacity_factor=FAM_SERVE_CAPACITY)
    model = GPT(config, device="cuda",
                generator=torch.Generator("cuda").manual_seed(args.seed))
    prompts, budgets = _requests(np, args.seed)
    (eng, hs, wall), _, counts = _driven(torch, lambda: run_engine(
        torch, model, prompts, budgets, late=3), _family_counts)
    st = eng.stats()
    _check_budgets(hs, budgets, "(c) moe engine")
    if not st.prefix_hit_rate > 0:
        raise AssertionError("(c) moe engine: no prefix-cache hit")
    ttft = sorted(h.ttft_s for h in hs)
    n_tok = sum(len(h.tokens) for h in hs)
    log({"family": "(c) gpt2-small moe engine", "requests": len(hs),
         "capacity_factor": FAM_SERVE_CAPACITY, "new_tokens": n_tok,
         "wall_s": wall, "tokens_per_s": n_tok / wall,
         "ttft_p50_s": ttft[len(ttft) // 2],
         "dense_tokens_per_s": phase4["tokens_per_s"],
         "dense_ttft_p50_s": phase4["ttft_p50_s"],
         "prefix_hit_rate": st.prefix_hit_rate,
         "prefill_windows_skipped": st.prefill_windows_skipped_total,
         "launches": counts, "card": smi})
    _zoo_expect("(c) moe engine", counts, _family_want(**phase4["launches"]))
    del eng
    _row_independence(torch, model, prompts, budgets, hs)
    return counts


def _family_moe_reference(torch, np):
    """(d): a 2-layer f32 MoE model (4 experts, head dim 64, its weight
    matrices scaled 5x so that greedy tokens vary) on the card and on the
    CPU from the same weights, TF32 off: ``lm_loss_fn``'s loss, moe_aux
    and every gradient at train=False, and greedy tokens through
    ``Engine``."""
    from distributed_tensorflow_tpu_torch import GPT, Engine, gpt_tiny
    config = gpt_tiny(moe_experts=4, dropout_rate=0.0)
    cpu = GPT(config, device="cpu",
              generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        for p in cpu.parameters():
            if p.dim() >= 2:
                p.mul_(5.0)
    gpu = GPT(config, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(5)
    ids = torch.from_numpy(rng.integers(0, 512, (4, 65)).astype(np.int32))
    runs = []
    for model in (gpu, cpu):
        params = dict(model.named_parameters())
        loss, (m, _) = model.lm_loss_fn()(
            params, None, {"input_ids": ids.to(model.device)}, None, False)
        grads = torch.autograd.grad(loss, list(params.values()))
        runs.append((loss.item(), m["moe_aux"].item(),
                     {k: g.cpu() for k, g in zip(params, grads)}))
    (gl, ga, gg), (cl, ca, cg) = runs
    grad_err = max((gg[k] - cg[k]).abs().max().item()
                   / max(1.0, cg[k].abs().max().item()) for k in cg)
    prompts = [rng.integers(0, 512, n, dtype=np.int32) for n in (5, 17, 40)]
    toks = [Engine(model, device=model.device, num_slots=2, max_len=128,
                   prefill_chunk=16, tick_steps=4).generate_batch(prompts, 12)
            for model in (gpu, cpu)]
    log({"family": "(d) moe card vs cpu", "loss": [gl, cl],
         "moe_aux": [ga, ca], "grad_err": grad_err,
         "grad_tol": FAM_GRAD_TOL, "tokens_equal": toks[0] == toks[1],
         "distinct_tokens": len({t for r in toks[1] for t in r})})
    if not (abs(gl - cl) <= TRAIN_LOSS_TOL and abs(ga - ca) <= TRAIN_LOSS_TOL
            and grad_err <= FAM_GRAD_TOL and toks[0] == toks[1]):
        raise AssertionError("(d) the MoE model on the card and the CPU "
                             "disagree")


def _family_llama_train(torch, np, args, smi):
    """(e): bench_llama's row, then ``llama_tiny`` (head dim 32) card
    against CPU over 3 steps; returns the row's counts."""
    from distributed_tensorflow_tpu_torch import GPT, llama_config, \
        llama_tiny
    config = llama_config(vocab_size=32000, hidden_size=768, num_layers=12,
                          num_heads=12, num_kv_heads=4,
                          intermediate_size=2048, max_position=FAM_SEQ,
                          dtype=torch.bfloat16, remat=True,
                          remat_policy="full")
    L = config.num_layers
    # RMSNorm's forward kernel 2 a layer + ln_f and 2 a layer again (the
    # recomputation; its backward is the plain version's, no launch); the
    # flash forward twice a layer, dK/dV and dQ once; Adam once a leaf:
    # word, lm_head, ln_f and 9 a layer
    per_step = {"flash_forward": 2 * L, "flash_backward_dkv": L,
                "flash_backward_dq": L, "rmsnorm": 4 * L + 1,
                "fused_adam": 3 + 9 * L}
    model, counts, _ = _family_train_arm(
        torch, np, args, smi, "(e) llama recipe 12x768 gqa 12:4", config,
        per_step)
    del model
    torch.cuda.empty_cache()
    init = GPT(llama_tiny(), device="cpu",
               generator=torch.Generator().manual_seed(3)).state_dict()
    runs = []
    for device in ("cuda", "cpu"):
        model = GPT(llama_tiny(), device=device)
        model.load_state_dict(init)
        state, step = _train_setup(torch, model, TRAIN_LR, 0)
        batch = _train_batch(torch, np, 4, 4, 64, 512, device)
        losses = []
        for _ in range(3):
            state, metrics = step(state, batch)
            losses.append(metrics["loss"].item())
        runs.append((losses, {k: p.detach().cpu()
                              for k, p in state.params.items()}))
    (card_l, card_p), (cpu_l, cpu_p) = runs
    loss_err = max(abs(a - b) for a, b in zip(card_l, cpu_l))
    param_err = max((card_p[k] - cpu_p[k]).abs().max().item()
                    for k in cpu_p)
    log({"family": "(e) llama_tiny card vs cpu, 3 steps",
         "card_losses": card_l, "cpu_losses": cpu_l, "loss_err": loss_err,
         "loss_tol": TRAIN_LOSS_TOL, "param_err": param_err,
         "param_tol": TRAIN_PARAM_TOL})
    if not (loss_err <= TRAIN_LOSS_TOL and param_err <= TRAIN_PARAM_TOL):
        raise AssertionError("(e) llama_tiny training on the card and the "
                             "CPU disagree")
    return counts


def _family_serve_gpt(torch, smi):
    """(f): the serve_gpt demo on the card, in-process, with its engine,
    fleet and shared-prefix demos: its exactness lines read 1.000 and the
    paged kernel (head dim 32: the demo's 4 heads of 32) launched."""
    from distributed_tensorflow_tpu_torch.examples import serve_gpt
    argv = ["--device=cuda", "--engine", "--replicas=2", "--shared_prefix"]
    (out, wall), _, counts = _driven(
        torch, lambda: _run_entry(torch, serve_gpt.main, argv),
        _family_counts)
    lines = out.splitlines()
    log({"family": "(f) serve_gpt", "argv": argv, "wall_s": wall,
         "printed": lines, "launches": counts, "card": smi})
    for key in ("engine==lock-step greedy 1.000",
                "fleet==lock-step greedy 1.000", "greedy match 1.000"):
        if not any(key in line for line in lines):
            raise AssertionError(f"(f) serve_gpt printed no '{key}'")
    for name in ("paged_decode_attention", "paged_window_attention",
                 "flash_forward", "layernorm"):
        if counts[name] <= 0:
            raise AssertionError(f"(f) serve_gpt: {name} never launched")
    return counts


def check_gpt_family(torch, np, args, smi, phase4):
    """Phase 23, the GPT family's last configurations: returns the
    kernels' launches over its main-path runs ((b), (c), (e), (f))."""
    t_phase = time.perf_counter()
    _family_paged_hd32(torch, args)
    log({"family": "(a) paged hd32", "seconds": time.perf_counter() - t_phase})
    counts = collections.Counter(_family_moe_train(torch, np, args, smi))
    counts.update(_family_moe_serve(torch, np, args, smi, phase4))
    torch.cuda.empty_cache()
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        _family_moe_reference(torch, np)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
    counts.update(_family_llama_train(torch, np, args, smi))
    counts.update(_family_serve_gpt(torch, smi))
    log({"phase": "gpt family", "seconds": time.perf_counter() - t_phase,
         "launches": dict(counts)})
    return counts


# Phase 24 (text and Hugging Face interop).  (a) A GPT-2-small checkpoint
# directory with openai-community/gpt2's config.json widths (vocab 50257,
# 1024 positions, d 768, 12 layers of 12 heads, gelu_new, eps 1e-5;
# dropout 0), random HF-layout weights from --seed, and a GPT-2
# tokenizer of HF_MERGES merges learned by BPETokenizer.train on the
# example's corpus and HF_TEXT_SAMPLE bytes of seeded text; the entry
# point fine-tunes it at its defaults in bf16.  (b) a 2-layer f32 copy
# (safetensors) for HF_REF_STEPS steps, card against CPU.  (c) BERT-base
# (bert-base-uncased), ViT-B/16 (vit-base-patch16-224, 1000 labels) and
# the Llama recipe at bench_llama's width (bench.py:975), bf16, from
# HF-layout state dicts made from --seed.  (d) the host routines.
HF_MERGES = 300
HF_TEXT_SAMPLE = 8_000
HF_REF_STEPS = 5
HF_BERT_BATCH, HF_BERT_SEQ = 8, 128
HF_VIT_BATCH = 16
HF_LLAMA_BATCH, HF_LLAMA_SEQ = 4, 256
HF_FWD_ITERS = 10
# (d): the Python merge loop takes about a minute a MB, so it and the
# host encoder meet on HF_PY_BYTES (256 KiB until phase 27 needed the
# room: the loop took 11.0 s there); the encoder alone
# and GPT-2's tokenizer on HF_TEXT_BYTES; the loaders on phase 19's MNIST
# arrays in batches that divide its 60,000 rows
HF_TEXT_BYTES, HF_PY_BYTES = 1 << 20, 1 << 16
HF_LOADER_BATCH = 1000
_HF_DIR = Path(__file__).resolve().parent / "build" / "hf_ckpt"
_HF_WORDS = (
    "the quick brown fox jumps over lazy dog a an of to in is was for on "
    "that with as at by it from this be are or have not but had they "
    "which one you were her all she there would their we him been has "
    "when who will more no if out so said what up its about into than "
    "them can only other new some could time these two may then do first "
    "any my now such like our man me even most made after also did many "
    "before must through back years where much your way well down should "
    "because each just those people how too little state good very make "
    "world still own see men work long get here between both life being "
    "under never day same another know while last might us great old "
    "year off come since against go came right used take three").split()


def hf_text(np, seed: int, nbytes: int) -> str:
    """About ``nbytes`` of seeded text: words of ``_HF_WORDS``, numbers
    and punctuation, separated by spaces."""
    rng = np.random.default_rng(seed)
    out, n = [], 0
    while n < nbytes:
        w = _HF_WORDS[rng.integers(len(_HF_WORDS))]
        if rng.random() < 0.05:
            w = str(rng.integers(0, 10000))
        if rng.random() < 0.08:
            w += ",.!?"[rng.integers(4)]
        out.append(w)
        n += len(w) + 1
    return " ".join(out)


def write_safetensors(path, tensors) -> None:
    """``tensors`` ({name: CPU tensor of f32, f16 or bf16}) as a
    ``.safetensors`` file: the inverse of ``models.convert``'s reader (an
    8-byte little-endian header length, a JSON header padded to 8 bytes,
    the raw little-endian bytes)."""
    import torch
    names = {torch.float32: "F32", torch.float16: "F16",
             torch.bfloat16: "BF16"}
    header, blobs, off = {}, [], 0
    for name, t in tensors.items():
        t = t.detach().contiguous().cpu()
        raw = (t.view(torch.int16) if t.dtype == torch.bfloat16 else t)
        blob = raw.numpy().tobytes()
        header[name] = {"dtype": names[t.dtype], "shape": list(t.shape),
                        "data_offsets": [off, off + len(blob)]}
        blobs.append(blob)
        off += len(blob)
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(len(head).to_bytes(8, "little"))
        f.write(head)
        for blob in blobs:
            f.write(blob)


def gpt2_tokenizer_files(directory, tokenizer, eos_id=None) -> None:
    """``vocab.json`` and ``merges.txt`` of a GPT-2 tokenizer whose merges
    are ``tokenizer``'s (a trained ``BPETokenizer``) renamed into GPT-2's
    byte symbols: the 256 byte symbols are ids 0-255, each new merged
    string the next id, and ``<|endoftext|>`` ``eos_id`` (the next id
    when None)."""
    from distributed_tensorflow_tpu_torch.data.text import \
        _gpt2_bytes_to_unicode
    b2u = _gpt2_bytes_to_unicode()
    sym = {b: b2u[b] for b in range(256)}
    vocab = {b2u[b]: b for b in range(256)}
    merges = []
    for r, (a, b) in enumerate(tokenizer.merges):
        sym[tokenizer._base + r] = sym[a] + sym[b]
        merges.append(f"{sym[a]} {sym[b]}")
        vocab.setdefault(sym[a] + sym[b], len(vocab))
    vocab["<|endoftext|>"] = len(vocab) if eos_id is None else eos_id
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    (directory / "vocab.json").write_text(json.dumps(vocab),
                                          encoding="utf-8")
    (directory / "merges.txt").write_text(
        "#version: 0.2\n" + "\n".join(merges) + "\n", encoding="utf-8")


def hf_state(torch, shapes, seed: int, device="cuda"):
    """An HF-layout state dict on the CPU: every tensor normal(0, 0.02)
    from a generator on ``device`` seeded with ``seed``, norm scales 1 +
    that."""
    gen = torch.Generator(device).manual_seed(seed)
    sd = {}
    for name, shape in shapes.items():
        t = torch.empty(shape, device=device).normal_(0.0, 0.02,
                                                      generator=gen)
        low = name.lower()
        if name.endswith(".weight") and len(shape) == 1 and (
                "norm" in low or ".ln_" in low):
            t += 1.0
        sd[name] = t.cpu()
    return sd


def gpt2_hf_shapes(L, V=50257, P=1024, d=768):
    """GPT2LMHeadModel's state dict shapes (Conv1D weights [in, out])."""
    s = {"transformer.wte.weight": (V, d), "transformer.wpe.weight": (P, d),
         "transformer.ln_f.weight": (d,), "transformer.ln_f.bias": (d,)}
    for i in range(L):
        p = f"transformer.h.{i}."
        s.update({p + "ln_1.weight": (d,), p + "ln_1.bias": (d,),
                  p + "attn.c_attn.weight": (d, 3 * d),
                  p + "attn.c_attn.bias": (3 * d,),
                  p + "attn.c_proj.weight": (d, d),
                  p + "attn.c_proj.bias": (d,),
                  p + "ln_2.weight": (d,), p + "ln_2.bias": (d,),
                  p + "mlp.c_fc.weight": (d, 4 * d),
                  p + "mlp.c_fc.bias": (4 * d,),
                  p + "mlp.c_proj.weight": (4 * d, d),
                  p + "mlp.c_proj.bias": (d,)})
    return s


def _encoder_hf_shapes(prefix, L, d, ff, attn, ln_a, ln_f):
    """A BERT-style encoder's shapes (``nn.Linear`` [out, in])."""
    s = {}
    for i in range(L):
        p = f"{prefix}encoder.layer.{i}."
        for m in ("query", "key", "value"):
            s[f"{p}{attn}.{m}.weight"] = (d, d)
            s[f"{p}{attn}.{m}.bias"] = (d,)
        s.update({p + "attention.output.dense.weight": (d, d),
                  p + "attention.output.dense.bias": (d,),
                  p + "intermediate.dense.weight": (ff, d),
                  p + "intermediate.dense.bias": (ff,),
                  p + "output.dense.weight": (d, ff),
                  p + "output.dense.bias": (d,),
                  p + ln_a + ".weight": (d,), p + ln_a + ".bias": (d,),
                  p + ln_f + ".weight": (d,), p + ln_f + ".bias": (d,)})
    return s


def bert_hf_shapes(L, V=30522, P=512, d=768, ff=3072):
    """BertForMaskedLM's shapes (no pooler; the decoder is tied)."""
    s = {"bert.embeddings.word_embeddings.weight": (V, d),
         "bert.embeddings.position_embeddings.weight": (P, d),
         "bert.embeddings.token_type_embeddings.weight": (2, d),
         "bert.embeddings.LayerNorm.weight": (d,),
         "bert.embeddings.LayerNorm.bias": (d,),
         "cls.predictions.transform.dense.weight": (d, d),
         "cls.predictions.transform.dense.bias": (d,),
         "cls.predictions.transform.LayerNorm.weight": (d,),
         "cls.predictions.transform.LayerNorm.bias": (d,),
         "cls.predictions.bias": (V,)}
    s.update(_encoder_hf_shapes("bert.", L, d, ff, "attention.self",
                                "attention.output.LayerNorm",
                                "output.LayerNorm"))
    return s


def vit_hf_shapes(L, d=768, ff=3072, image=224, patch=16, labels=1000):
    """ViTForImageClassification's shapes."""
    n = (image // patch) ** 2 + 1
    s = {"vit.embeddings.cls_token": (1, 1, d),
         "vit.embeddings.position_embeddings": (1, n, d),
         "vit.embeddings.patch_embeddings.projection.weight":
             (d, 3, patch, patch),
         "vit.embeddings.patch_embeddings.projection.bias": (d,),
         "vit.layernorm.weight": (d,), "vit.layernorm.bias": (d,),
         "classifier.weight": (labels, d), "classifier.bias": (labels,)}
    s.update(_encoder_hf_shapes("vit.", L, d, ff, "attention.attention",
                                "layernorm_before", "layernorm_after"))
    return s


def llama_hf_shapes(L, V=32000, d=768, h=12, kv=4, ff=2048):
    """LlamaForCausalLM's shapes (untied head)."""
    hd = d // h
    s = {"model.embed_tokens.weight": (V, d), "model.norm.weight": (d,),
         "lm_head.weight": (V, d)}
    for i in range(L):
        p = f"model.layers.{i}."
        s.update({p + "input_layernorm.weight": (d,),
                  p + "post_attention_layernorm.weight": (d,),
                  p + "self_attn.q_proj.weight": (h * hd, d),
                  p + "self_attn.k_proj.weight": (kv * hd, d),
                  p + "self_attn.v_proj.weight": (kv * hd, d),
                  p + "self_attn.o_proj.weight": (d, h * hd),
                  p + "mlp.gate_proj.weight": (ff, d),
                  p + "mlp.up_proj.weight": (ff, d),
                  p + "mlp.down_proj.weight": (d, ff)})
    return s


def hf_configs(layers):
    """The (c) configs as HF's config.json holds them (model_type and
    the keys the converters read), at ``layers`` layers."""
    return {
        "bert": {"model_type": "bert", "vocab_size": 30522,
                 "hidden_size": 768, "num_hidden_layers": layers,
                 "num_attention_heads": 12, "intermediate_size": 3072,
                 "hidden_act": "gelu", "hidden_dropout_prob": 0.1,
                 "max_position_embeddings": 512, "type_vocab_size": 2,
                 "layer_norm_eps": 1e-12,
                 "position_embedding_type": "absolute"},
        "vit": {"model_type": "vit", "hidden_size": 768,
                "num_hidden_layers": layers, "num_attention_heads": 12,
                "intermediate_size": 3072, "hidden_act": "gelu",
                "hidden_dropout_prob": 0.0, "layer_norm_eps": 1e-12,
                "image_size": 224, "patch_size": 16, "num_channels": 3,
                "qkv_bias": True, "num_labels": 1000},
        "llama": {"model_type": "llama", "vocab_size": 32000,
                  "hidden_size": 768, "intermediate_size": 2048,
                  "num_hidden_layers": layers, "num_attention_heads": 12,
                  "num_key_value_heads": 4, "hidden_act": "silu",
                  "max_position_embeddings": 2048, "rms_norm_eps": 1e-5,
                  "tie_word_embeddings": False, "rope_theta": 10000.0,
                  "rope_scaling": None},
    }


def gpt2_hf_config(layers=12):
    """openai-community/gpt2's config.json, dropout 0."""
    return {"activation_function": "gelu_new",
            "architectures": ["GPT2LMHeadModel"], "attn_pdrop": 0.0,
            "bos_token_id": 50256, "embd_pdrop": 0.0, "eos_token_id": 50256,
            "initializer_range": 0.02, "layer_norm_epsilon": 1e-05,
            "model_type": "gpt2", "n_ctx": 1024, "n_embd": 768,
            "n_head": 12, "n_layer": layers, "n_positions": 1024,
            "resid_pdrop": 0.0, "vocab_size": 50257}


def _hf_tokenizer(np, args):
    """The GPT-2 tokenizer's merges: ``BPETokenizer.train`` on the
    example's corpus and seeded text."""
    from distributed_tensorflow_tpu_torch.data import BPETokenizer
    from distributed_tensorflow_tpu_torch.examples import finetune_gpt2_hf
    t0 = time.perf_counter()
    tok = BPETokenizer.train(
        [finetune_gpt2_hf.CORPUS, hf_text(np, args.seed, HF_TEXT_SAMPLE)],
        256 + 3 + HF_MERGES)
    return tok, time.perf_counter() - t0


def _hf_run(example, argv):
    """``example.run(argv)``, its printed line kept out of the log."""
    import io
    with contextlib.redirect_stdout(io.StringIO()):
        return example.run(argv)


def _hf_finetune(torch, np, args, smi, tok):
    """(a): the GPT-2-small checkpoint directory fine-tuned through the
    entry point at its defaults in bf16; exact launches."""
    from distributed_tensorflow_tpu_torch.examples import finetune_gpt2_hf
    from distributed_tensorflow_tpu_torch.models import convert
    d = _HF_DIR / "gpt2"
    d.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    sd = hf_state(torch, gpt2_hf_shapes(12), args.seed)
    sd["lm_head.weight"] = sd["transformer.wte.weight"]      # tied
    (d / "config.json").write_text(json.dumps(gpt2_hf_config()))
    torch.save(sd, d / "pytorch_model.bin")
    gpt2_tokenizer_files(d, tok, eos_id=50256)
    write_s = time.perf_counter() - t0
    nbytes = (d / "pytorch_model.bin").stat().st_size
    t0 = time.perf_counter()
    convert.load_hf_dir(str(d))
    load_s = time.perf_counter() - t0
    argv = [f"--hf_dir={d}", "--dtype=bfloat16"]
    res, wall, counts = _driven(
        torch, lambda: _hf_run(finetune_gpt2_hf, argv), _family_counts)
    steps, new = 50, finetune_gpt2_hf.NEW_TOKENS
    want = _family_want(flash_forward=12 * steps + 12,
                        flash_backward_dkv=12 * steps,
                        flash_backward_dq=12 * steps,
                        layernorm=25 * steps + 25 * new,
                        fused_adam=196 * steps)
    losses = res["losses"]
    (i0, t_0), (i1, t_1) = res["marks"][2], res["marks"][-1]
    step_s = (t_1 - t_0) / (i1 - i0)
    tokens = res["batch"] * res["seq_len"]
    log({"hf": "(a) finetune_gpt2_hf", "argv": argv, "card": smi,
         "checkpoint_bytes": nbytes, "write_s": write_s,
         "load_hf_dir_s": load_s, "load_note": "warm file cache",
         "wall_s": wall, "step_ms": 1e3 * step_s,
         "step_ms_steps": [i0, i1], "tokens_per_s": tokens / step_s,
         "first_loss": losses[0], "last_loss": losses[-1],
         "generated": res["text"], "ids": res["ids"], "launches": counts,
         "expected": want})
    if len(losses) != steps or not all(map(math.isfinite, losses)) \
            or not losses[-1] < losses[0]:
        raise AssertionError(f"(a): losses {losses}")
    if not res["text"].startswith(finetune_gpt2_hf.PROMPT):
        raise AssertionError(f"(a): generated {res['text']!r}")
    _zoo_expect("(a) finetune_gpt2_hf", counts, want)
    return counts, sd


def _hf_reference(torch, np, sd):
    """(b): the entry point on a 2-layer f32 copy (safetensors), card
    against CPU: per-step losses and generated ids."""
    from distributed_tensorflow_tpu_torch.examples import finetune_gpt2_hf
    d = _HF_DIR / "gpt2_2l"
    d.mkdir(parents=True, exist_ok=True)
    for name in ("vocab.json", "merges.txt"):
        shutil.copy(_HF_DIR / "gpt2" / name, d / name)
    (d / "config.json").write_text(json.dumps(gpt2_hf_config(2)))
    write_safetensors(d / "model.safetensors",
                      {k: sd[k] for k in gpt2_hf_shapes(2)})
    runs = {device: _hf_run(finetune_gpt2_hf, [
        f"--hf_dir={d}", f"--device={device}", f"--steps={HF_REF_STEPS}"])
        for device in ("cuda", "cpu")}
    card, cpu = runs["cuda"], runs["cpu"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(card["losses"],
                                                  cpu["losses"]))
    log({"hf": "(b) card vs CPU", "card_losses": card["losses"],
         "cpu_losses": cpu["losses"], "loss_rel_err": rel,
         "tol": TRAIN_LOSS_TOL, "ids_equal": card["ids"] == cpu["ids"],
         "card_text": card["text"]})
    if rel > TRAIN_LOSS_TOL or card["ids"] != cpu["ids"]:
        raise AssertionError("(b): card and CPU disagree")


def _hf_forward_ms(torch, fn):
    """Host ms of one call of ``fn`` over ``HF_FWD_ITERS`` calls (CUDA
    events), after one warm-up."""
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(HF_FWD_ITERS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / HF_FWD_ITERS


def _hf_models(torch, np, args, smi):
    """(c): BERT-base, ViT-B/16 and the Llama recipe converted from
    HF-layout state dicts at full width in bf16: finite logits, exact
    launches a forward, forward ms; then a 2-layer f32 copy of each,
    card against CPU."""
    import types

    from distributed_tensorflow_tpu_torch.models import convert
    rng = np.random.default_rng(args.seed)
    lengths = rng.integers(HF_BERT_SEQ // 4, HF_BERT_SEQ + 1, HF_BERT_BATCH)
    lengths[0] = HF_BERT_SEQ
    host = {"bert": (rng.integers(0, 30522, (HF_BERT_BATCH, HF_BERT_SEQ)),
                     (np.arange(HF_BERT_SEQ)[None] < lengths[:, None])
                     .astype(np.int32)),
            "vit": rng.random((HF_VIT_BATCH, 224, 224, 3), np.float32),
            "llama": rng.integers(0, 32000, (HF_LLAMA_BATCH, HF_LLAMA_SEQ))}

    def forward(kind, model, params, device, n=None):
        if kind == "bert":
            ids, mask = (torch.from_numpy(a[:n]).to(device)
                         for a in host["bert"])
            return model.mlm_logits(params, model.apply(
                params, ids, attention_mask=mask))
        if kind == "vit":
            return model.apply(params, torch.from_numpy(
                host["vit"][:n]).to(device))
        ids = torch.from_numpy(host["llama"][:n]).to(device)
        return model.logits(model.apply(ids))

    convert_fn = {"bert": convert.bert_from_hf, "vit": convert.vit_from_hf,
                  "llama": convert.llama_from_hf}
    shapes = {"bert": bert_hf_shapes, "vit": vit_hf_shapes,
              "llama": llama_hf_shapes}
    per_forward = {"bert": dict(flash_forward=12, layernorm=26),
                   "vit": dict(flash_forward=12, layernorm=25),
                   "llama": dict(flash_forward=12, rmsnorm=25)}
    total = collections.Counter()
    for seed, kind in enumerate(("bert", "vit", "llama"), args.seed + 1):
        sd = hf_state(torch, shapes[kind](12), seed)
        pair = (types.SimpleNamespace(**hf_configs(12)[kind]), sd)
        t0 = time.perf_counter()
        model, params = convert_fn[kind](pair, device="cuda",
                                         dtype=torch.bfloat16)
        torch.cuda.synchronize()
        convert_s = time.perf_counter() - t0
        with torch.no_grad():
            logits, _, counts = _driven(
                torch, lambda: forward(kind, model, params, "cuda"),
                _family_counts)
            ms = _hf_forward_ms(
                torch, lambda: forward(kind, model, params, "cuda"))
        want = _family_want(**per_forward[kind])
        finite = bool(torch.isfinite(logits).all())
        log({"hf": f"(c) {kind}", "card": smi, "shape": list(logits.shape),
             "finite": finite, "convert_s": convert_s, "forward_ms": ms,
             "launches": counts})
        if not finite:
            raise AssertionError(f"(c) {kind}: non-finite logits")
        _zoo_expect(f"(c) {kind}", counts, want)
        total.update(counts)
        del model, params, logits
        # the 2-layer f32 copy, card against CPU
        small = {k: sd[k] for k in shapes[kind](2)}
        pair = (types.SimpleNamespace(**hf_configs(2)[kind]), small)
        outs = []
        for device in ("cuda", "cpu"):
            model, params = convert_fn[kind](pair, device=device)
            with torch.no_grad():
                outs.append(forward(kind, model, params, device, 2).cpu())
        err, scale = _err_and_scale(torch, outs[0], outs[1])
        log({"hf": f"(c) {kind} 2-layer f32 card vs CPU", "err": err,
             "tol": ZOO_LOGIT_TOL * scale})
        if err > ZOO_LOGIT_TOL * scale:
            raise AssertionError(f"(c) {kind}: card and CPU disagree")
        del sd, small
        torch.cuda.empty_cache()
    return total


def _hf_host(torch, np, args, smi, tok):
    """(d): the host routines on the card's machine: the BPE encoder
    against the Python loop, GPT-2's tokenizer, and the native loader
    against numpy over an epoch."""
    from distributed_tensorflow_tpu_torch import data
    from distributed_tensorflow_tpu_torch.data import GPT2BPETokenizer
    text = hf_text(np, args.seed + 7, HF_TEXT_BYTES)
    part = text[:HF_PY_BYTES]
    times = {}
    ids = {}
    for backend, t in (("native", part), ("python", part),
                       ("native_1mb", text)):
        t0 = time.perf_counter()
        ids[backend] = tok.encode(t, backend=backend.split("_")[0])
        times[backend] = time.perf_counter() - t0
    g2 = GPT2BPETokenizer.load(str(_HF_DIR / "gpt2" / "vocab.json"),
                               str(_HF_DIR / "gpt2" / "merges.txt"))
    t0 = time.perf_counter()
    g2_ids = g2.encode(text)
    g2_s = time.perf_counter() - t0
    equal = bool(np.array_equal(ids["native"], ids["python"]))
    round_trip = g2.decode(g2_ids) == text and \
        tok.decode(ids["native_1mb"]) == text
    (x, _), _ = data.mnist(None, flatten=True, seed=args.seed)
    rows = np.arange(len(x), dtype=np.int32)
    rates, seen = {}, {}
    for backend in ("native", "numpy"):
        ds = data.Dataset([x, rows], HF_LOADER_BATCH, seed=args.seed,
                          backend=backend)
        t0 = time.perf_counter()
        got = [b[1] for b in ds]
        rates[backend] = len(got) / (time.perf_counter() - t0)
        seen[backend] = np.sort(np.concatenate(got))
    covered = all(np.array_equal(s, rows) for s in seen.values())
    log({"hf": "(d) host", "card": smi, "bpe_bytes": len(part.encode()),
         "bpe_native_s": times["native"], "bpe_python_s": times["python"],
         "bpe_speedup": times["python"] / times["native"],
         "bpe_ids_equal": equal, "bpe_native_1mb_s": times["native_1mb"],
         "text_bytes": len(text.encode()),
         "gpt2_ids_per_s": len(g2_ids) / g2_s, "gpt2_s": g2_s,
         "round_trip": round_trip, "loader_batch": HF_LOADER_BATCH,
         "native_batches_per_s": rates["native"],
         "numpy_batches_per_s": rates["numpy"], "rows_covered": covered})
    if not (equal and round_trip and covered):
        raise AssertionError("(d): host routines disagree")


def _hf_flash(torch, args, smi):
    """The flash kernels at (a)'s shape, [16, 32, 12, 64] bf16 causal,
    against their plain versions (phase 3's tolerances); the forward
    timed beside its plain version, SDPA and the bound."""
    import torch.nn.functional as F

    from distributed_tensorflow_tpu_torch.ops.kernels import \
        flash_attention as fa
    gen = torch.Generator("cuda").manual_seed(args.seed)
    b, s, h, hd = 16, 32, 12, 64
    result, (q, k, v, *_) = _flash_case(torch, fa, gen, b, s, h, h, hd,
                                        torch.bfloat16, False)
    for name, (err, tol) in result.items():
        log({"check": name, "case": "finetune_gpt2_hf", "max_abs_err": err,
             "tol": tol})
        if not err <= tol:
            raise AssertionError(f"{name} disagrees (finetune_gpt2_hf): "
                                 f"{err} > {tol}")
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    iters = max(20, args.iters // 4)

    def fwd():
        return fa.flash_forward(q, k, v, None, True)

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    lib_graph, why = _graph_or_why(torch, sdpa, iters)
    b_ms, b_by = bound_ms(2 * 4 * q.numel() + 4 * b * h * s,
                          2.0 * b * h * s * s * hd)
    log({"time": "flash_forward", "case": "finetune_gpt2_hf", "card": smi,
         "shape": f"q[{b},{s},{h},{hd}] bf16 causal",
         "kernel_ms": time_ms(torch, fwd, iters),
         "graph_ms": graph_ms(torch, fwd, iters),
         "plain_ms": time_ms(torch, lambda: fa.flash_forward_plain(
             q, k, v, None, True), max(5, iters // 10)),
         "library_ms": time_ms(torch, sdpa, iters),
         "library_graph_ms": lib_graph, "library_graph_note": why,
         "library": "F.scaled_dot_product_attention(is_causal=True)",
         "bound_ms": b_ms, "bound_by": b_by})


def check_hf(torch, np, args, smi):
    """Phase 24, text and Hugging Face interop: returns the kernels'
    launches over its main-path runs ((a) and (c)'s full-width
    forwards)."""
    t_phase = time.perf_counter()
    shutil.rmtree(_HF_DIR, ignore_errors=True)
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    try:
        _hf_flash(torch, args, smi)
        tok, train_s = _hf_tokenizer(np, args)
        log({"hf": "tokenizer", "merges": len(tok.merges),
             "train_s": train_s})
        counts, sd = _hf_finetune(torch, np, args, smi, tok)
        counts = collections.Counter(counts)
        _hf_reference(torch, np, sd)
        del sd
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        counts.update(_hf_models(torch, np, args, smi))
        _hf_host(torch, np, args, smi, tok)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
        shutil.rmtree(_HF_DIR, ignore_errors=True)
    log({"phase": "hf", "seconds": time.perf_counter() - t_phase,
         "launches": dict(counts)})
    return counts


# -- phase 25: sequence parallelism -----------------------------------------

# (a) ring-flash's kernel routes at full width on a virtual ring of
# SP_RING ranks: ``parallel/ring_flash.py``'s step functions driven in
# lockstep for every rank in one process (NCCL cannot put two ranks on one
# card), on the blocks of bench_gpt_long (bench.py:2616: GPT-2 small at
# seq 2048, batch 48 x 256 / 2048 = 6), of Llama-3-8B's attention (32 q /
# 8 kv heads of 128) at 4 x 2048, and of BERT-base at 16 x 512 with every
# row's last shard of keys all padding.  (b) GPT-2 small with seq_axis on
# a mesh of one at 6 x 2048, against the same weights without it; (c) the
# same for the Llama recipe at Llama-3-8B's widths cut to SP_LLAMA_LAYERS
# layers (4 x 2048) and for BERT-base MLM (16 x 512).  Each arm takes
# SP_WARMUP + SP_STEPS adamw(1e-4) steps with clip 1.0 on one batch.
# The first loss of the two arms comes from the same forward (a ring of
# one merges its single block exactly) and agrees to f32 round-off
# (SP_FIRST_TOL, of a loss of ~10); later ones follow gradients whose D
# = rowsum(dO * O) the ring computes in torch and the plain path inside
# the dQ kernel (another summation order in f32 before the bf16
# products), so they agree as phase 17's accumulated bf16 steps do
# (SP_LOSS_TOL).  The first step's gradient norm (the same weights and
# batch in both arms) agrees to SP_GRAD_TOL, relative: a gradient that
# is wrong in scale or misses a part moves it.  Adam moves an element by
# about lr a step whatever its gradient's size, so an absolute bound on
# the parameters could not fail; they are held by their movement
# instead: |p_sp - p_dense| / |p_dense - p_start| over all the tensors
# (2-norms) within SP_PARAM_TOL, where an arm with no gradient or a
# wrong one gives about 1 or more (the gap: elements whose gradient is
# ~0 step by up to 2 lr differently a step).  Measured on an H100 80GB
# HBM3 at 700 W: gradient norms within 3.0e-4, gaps 0.010-0.013 of the
# movement; the tolerances are about 10x and 4x those
SP_RING = 4
SP_CASES = (("gpt2_long", 6, 2048, 12, 12, 64, True),
            ("llama3_8b", 4, 2048, 32, 8, 128, True),
            ("bert_base", 16, 512, 12, 12, 64, False))
SP_WARMUP, SP_STEPS = 1, 3
SP_LLAMA_LAYERS = 2
SP_FIRST_TOL, SP_LOSS_TOL, SP_GRAD_TOL, SP_PARAM_TOL = 1e-5, 3e-3, 3e-3, 0.05
_SP_ROUTES = ("forward_full", "forward_diag", "dq_full", "dq_diag",
              "dkv_full", "dkv_diag")


def virtual_ring_flash(torch, q, k, v, valid, do, ring, causal):
    """Ring-flash attention, forward and backward, over ``ring`` virtual
    ranks in one process: each rank's shard of the global ``q``, ``k``,
    ``v``, ``valid`` and ``do`` (dim 1), the steps of
    ``ring_flash.forward_step`` / ``backward_step`` run for every rank in
    lockstep, rank ``my`` at step i holding the block of rank ``(my - i)
    mod ring`` as the rotation would bring it; each block's dK/dV
    accumulate in f32 where the P2P ring would rotate them home.  Returns
    the global (out, lse, dq, dk, dv)."""
    from distributed_tensorflow_tpu_torch.ops.kernels import \
        flash_attention as fa
    from distributed_tensorflow_tpu_torch.parallel import ring_flash as rf

    def parts(x):
        return [None] * ring if x is None else [
            c.contiguous() for c in x.chunk(ring, dim=1)]
    qs, ks, vs, vals, dos = (parts(x) for x in (q, k, v, valid, do))
    scale = 1.0 / q.shape[-1] ** 0.5
    b, s, h, d = qs[0].shape
    outs = [torch.zeros(b, s, h, d, dtype=torch.float32, device=q.device)
            for _ in range(ring)]
    lses = [torch.full((b, h, s), -math.inf, device=q.device)
            for _ in range(ring)]
    for i in range(ring):
        for my in range(ring):
            src = (my - i) % ring
            outs[my], lses[my] = rf.forward_step(
                qs[my], ks[src], vs[src], vals[src], outs[my], lses[my],
                src, my, causal, scale)
    outs = [o.to(q.dtype) for o in outs]
    dvecs = [fa.row_dot(dos[my], outs[my]) for my in range(ring)]
    dq = [torch.zeros(x.shape, device=q.device) for x in qs]
    dk = [torch.zeros(x.shape, device=q.device) for x in ks]
    dv = [torch.zeros(x.shape, device=q.device) for x in vs]
    for i in range(ring):
        for my in range(ring):
            src = (my - i) % ring
            got = rf.backward_step(qs[my], ks[src], vs[src], vals[src],
                                   dos[my], lses[my], dvecs[my], src, my,
                                   causal, scale)
            if got is not None:
                dq[my] += got[0].float()
                dk[src] += got[1].float()
                dv[src] += got[2].float()
    return (torch.cat(outs, 1), torch.cat(lses, 2),
            torch.cat(dq, 1).to(q.dtype), torch.cat(dk, 1).to(k.dtype),
            torch.cat(dv, 1).to(v.dtype))


def _sp_valid(torch, b, s, ring, dev, gen):
    """BERT's key plane: every row's last shard all padding, and ragged
    padding inside the shard before it."""
    n = s // ring
    lengths = (s - 2 * n) + torch.randint(1, n + 1, (b,), generator=gen,
                                          device=dev)
    return torch.arange(s, device=dev)[None, :] < lengths[:, None]


def _sp_ring_case(torch, args, smi, name, b, s, h, hk, hd, causal,
                  ring=SP_RING):
    """(a) at one shape: the virtual ring of ``ring`` ranks against the
    plain whole-sequence flash (forward, lse, dQ, dK, dV; phase 3's bf16
    tolerance), exact launches by route, no NaN; then each block route
    timed beside its plain version, SDPA at the block shape and the
    bound.  Returns the routes' records."""
    import torch.nn.functional as F

    from distributed_tensorflow_tpu_torch.ops.kernels import \
        flash_attention as fa
    from distributed_tensorflow_tpu_torch.parallel import ring_flash as rf
    dev = torch.device("cuda")
    gen = torch.Generator("cuda").manual_seed(args.seed)

    def rnd(heads):
        return torch.randn(b, s, heads, hd, generator=gen,
                           device=dev).to(torch.bfloat16)
    q, k, v, do = rnd(h), rnd(hk), rnd(hk), rnd(h)
    valid = None if causal else _sp_valid(torch, b, s, ring, dev, gen)
    fa.LAUNCHES.clear()
    rf.LAUNCHES.clear()
    got = virtual_ring_flash(torch, q, k, v, valid, do, ring, causal)
    torch.cuda.synchronize()
    launches = dict(rf.LAUNCHES)
    kernel_launches = {n: fa.LAUNCHES[n] for n in (
        "flash_forward", "flash_backward_dq", "flash_backward_dkv")}
    n_full = ring * (ring - 1) // 2 if causal else ring ** 2
    n_diag = ring if causal else 0
    want_launches = {f"{p}_{r}": n for p in ("forward", "dq", "dkv")
                     for r, n in (("full", n_full), ("diag", n_diag)) if n}
    want_out, want_lse = fa.flash_forward_plain(q, k, v, valid, causal)
    want = (want_out, want_lse, *fa.flash_backward_plain(
        q, k, v, valid, do, want_out, want_lse, causal))
    errs = {}
    for part, g, w in zip(("out", "lse", "dq", "dk", "dv"), got, want):
        e, sc = _err_and_scale(torch, g, w)
        errs[part] = {"max_abs_err": e, "tol": FLASH_BF16_TOL * sc}
    nan = any(bool(torch.isnan(x).any()) for x in got)
    finite = all(bool(torch.isfinite(x).all())
                 for x in (got[0], *got[2:]))
    log({"check": "ring_flash virtual ring", "case": name,
         "shape": f"q[{b},{s},{h},{hd}] kv heads {hk} bf16 "
                  f"{'causal' if causal else 'bidirectional kv_valid'}",
         "ring": ring, "errors": errs, "launches": launches,
         "expected_launches": want_launches,
         "kernel_launches": kernel_launches, "nan": nan,
         "finite": finite, "card": smi})
    bad = [p for p, r in errs.items() if not r["max_abs_err"] <= r["tol"]]
    if bad or nan or not finite:
        raise AssertionError(f"ring-flash {name} disagrees with the plain "
                             f"flash ({bad}) or is not finite")
    if launches != want_launches or set(kernel_launches.values()) != {
            n_full + n_diag}:
        raise AssertionError(f"ring-flash {name}: launches {launches}, "
                             f"kernels {kernel_launches}; expected "
                             f"{want_launches}")
    del want, got

    # the block routes at the block shape: rank 1 holding rank 0's block
    # (full) and rank 0 its own (diag), from that rank's global lse and D
    n = s // ring
    q0, k0, v0, do0 = (x[:, :n].contiguous() for x in (q, k, v, do))
    val0 = None if valid is None else valid[:, :n].contiguous()
    out0, lse0 = fa.flash_forward(q0, k0, v0, val0, causal)
    d0 = fa.row_dot(do0, out0)
    qt, kt, vt, dot = (x.transpose(1, 2) for x in (q0, k0, v0, do0))
    qg, kg, vg = (x.detach().requires_grad_() for x in (qt, kt, vt))
    mask = None if val0 is None else val0[:, None, None, :]
    iters = max(20, args.iters // 4)
    elt = q.element_size()
    tq, tk = b * n * h * hd * elt, b * n * hk * hd * elt
    rows = b * h * n * 4
    vbytes = 0 if val0 is None else b * n
    pairs = b * h * n * n * hd
    records = {}
    for route in (("full", "diag") if causal else ("full",)):
        diag = route == "diag"
        share = 0.5 if diag else 1.0

        def sdpa(diag=diag):
            return F.scaled_dot_product_attention(
                qg, kg, vg, attn_mask=mask, is_causal=diag,
                enable_gqa=hk != h)
        lib_out = sdpa()

        def sdpa_bwd(lib_out=lib_out):
            return torch.autograd.grad(lib_out, (qg, kg, vg), dot,
                                       retain_graph=True)
        _LIB_BACKWARDS.append((f"ring {route} backward {name}", sdpa,
                               (qg, kg, vg), dot))
        calls = {
            "forward": (lambda diag=diag: fa.flash_forward(
                q0, k0, v0, val0, diag),
                lambda diag=diag: fa.flash_forward_plain(
                    q0, k0, v0, val0, diag), sdpa,
                2 * tq + 2 * tk + rows + vbytes, 4 * pairs * share),
            "backward": (lambda diag=diag: (
                fa.flash_backward_dq(q0, k0, v0, val0, do0, lse0, d0, diag),
                fa.flash_backward_dkv(q0, k0, v0, val0, do0, lse0, d0,
                                      diag)),
                lambda diag=diag: (
                fa.flash_backward_dq_plain(q0, k0, v0, val0, do0, lse0, d0,
                                           diag),
                fa.flash_backward_dkv_plain(q0, k0, v0, val0, do0, lse0,
                                            d0, diag)), sdpa_bwd,
                # Q, dO read and dQ written, K, V read and dK, dV
                # written, lse and D read (D is given: no O); S once and
                # dV, dP, dQ, dK: 5 products of 2 flops a pair
                3 * tq + 4 * tk + 2 * rows + vbytes, 10 * pairs * share)}
        for part, (kern, plain_fn, lib, nbytes, flops) in calls.items():
            b_ms, b_by = bound_ms(nbytes, flops)
            lib_graph, why = ((None, "timed at the end of the run")
                              if lib is sdpa_bwd
                              else _graph_or_why(torch, lib, iters))
            rec = {"ms": time_ms(torch, kern, iters),
                   "graph_ms": graph_ms(torch, kern, iters),
                   "plain_ms": time_ms(torch, plain_fn,
                                       max(5, iters // 10)),
                   "library_ms": time_ms(torch, lib, iters),
                   "library_graph_ms": lib_graph, "bound_ms": b_ms,
                   "bound_by": b_by}
            records[f"{part}_{route}"] = rec
            log({"time": f"ring_flash {part} {route}", "case": name,
                 "shape": f"block q[{b},{n},{h},{hd}] kv heads {hk} bf16"
                          + (" kv_valid" if val0 is not None else ""),
                 **rec, "library_graph_note": why,
                 "library": "F.scaled_dot_product_attention(is_causal="
                            f"{diag}" + (", bool key mask" if mask is not
                                         None else "")
                            + (", enable_gqa" if hk != h else "") + ")"
                            + (" backward (autograd, dq dk dv)"
                               if part == "backward" else ""),
                 "card": smi})
    del q, k, v, do
    torch.cuda.synchronize()
    return records


def _sp_counts(torch):
    """Phase 25's reader: the training kernels' and the ring's routes'
    launches since ``_reset_counts``."""
    from distributed_tensorflow_tpu_torch.ops.kernels import fused
    from distributed_tensorflow_tpu_torch.parallel import ring_flash as rf
    counts = _train_counts(torch)
    counts["rmsnorm"] = fused.LAUNCHES["rmsnorm"]
    counts.update({f"ring_{r}": rf.LAUNCHES[r] for r in _SP_ROUTES})
    return counts


def _sp_steps(torch, np, step, state, batch, warmup=SP_WARMUP,
              steps=SP_STEPS, after_first=None):
    """``warmup`` + ``steps`` steps on one batch (SP_WARMUP + SP_STEPS
    unless given): (losses, the first step's gradient norm, timed seconds
    of the last ``steps``, peak GB).  ``after_first()``, when given, runs
    after the first step (a warm-up step: untimed)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses = []
    for i in range(warmup + steps):
        if i == warmup:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        state, m = step(state, batch)
        losses.append(m["loss"])
        if i == 0:
            grad_norm = m["grad_norm"]
            if after_first is not None:
                after_first()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    losses = [float(x) for x in losses]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite loss: {losses}")
    return (losses, float(grad_norm), wall,
            torch.cuda.max_memory_allocated() / 1e9)


def _sp_pair(torch, np, smi, name, tokens, build, per_step, routes):
    """(b)/(c): one model trained with ``seq_axis`` on a mesh of one and
    without it, from the same weights on the same batch.  ``build(sp)`` ->
    (params, state, step, batch) for each arm.  Checks exact launches (the SP
    arm's ring routes ``routes`` a step, the other none), the first loss
    within SP_FIRST_TOL, every loss within SP_LOSS_TOL, the first step's
    gradient norm within SP_GRAD_TOL and the parameters' gap within
    SP_PARAM_TOL of their movement (see SP_PARAM_TOL); logs step ms,
    tokens/s and peak memory of both.  Returns the SP arm's counts."""
    arms, kept, start = {}, None, None
    n_steps = SP_WARMUP + SP_STEPS
    for arm in ("sp", "dense"):
        params, state, step, batch = build(arm == "sp")
        if start is None:
            start = {k: p.detach().clone() for k, p in params.items()}
        else:
            start_err = max((start[k] - p.detach()).abs().max().item()
                            for k, p in params.items())
        (losses, grad_norm, wall, peak), _, counts = _driven(
            torch, lambda: _sp_steps(torch, np, step, state, batch),
            _sp_counts)
        want = {k: n * n_steps for k, n in per_step.items()}
        want.update({f"ring_{r}": (routes.get(r, 0) * n_steps
                                   if arm == "sp" else 0)
                     for r in _SP_ROUTES})
        step_ms = wall / SP_STEPS * 1e3
        arms[arm] = {"losses": losses, "grad_norm": grad_norm,
                     "step_ms": step_ms,
                     "tokens_per_s": tokens / (step_ms / 1e3),
                     "peak_memory_gb": peak, "launches": counts}
        log({"sp": name, "arm": arm, "tokens_a_step": tokens,
             "steps": SP_STEPS, **arms[arm], "card": smi})
        _zoo_expect(f"{name} {arm}", counts, want)
        del state, step, batch
        if kept is None:
            kept = params
        else:
            sq = {"gap": 0.0, "move": 0.0}
            for k, p in params.items():
                p = p.detach()
                sq["gap"] += float(((kept[k].detach() - p).double() ** 2)
                                   .sum())
                sq["move"] += float(((p - start[k]).double() ** 2).sum())
            param_max_err = max((kept[k].detach() - p.detach()).abs().max()
                                .item() for k, p in params.items())
        del params
        torch.cuda.empty_cache()
    del kept, start
    torch.cuda.empty_cache()
    sp, dense = arms["sp"]["losses"], arms["dense"]["losses"]
    first_err = abs(sp[0] - dense[0])
    loss_err = max(abs(a - b) for a, b in zip(sp, dense))
    grad_err = (abs(arms["sp"]["grad_norm"] - arms["dense"]["grad_norm"])
                / arms["dense"]["grad_norm"])
    param_err = math.sqrt(sq["gap"] / sq["move"])
    log({"sp": name, "check": "seq_axis vs none", "start_err": start_err,
         "first_loss_err": first_err, "first_tol": SP_FIRST_TOL,
         "loss_err": loss_err, "loss_tol": SP_LOSS_TOL,
         "grad_norm_rel_err": grad_err, "grad_tol": SP_GRAD_TOL,
         "param_gap_over_move": param_err, "param_tol": SP_PARAM_TOL,
         "param_move": math.sqrt(sq["move"]),
         "param_max_abs_err": param_max_err,
         "step_ms_sp_over_dense": arms["sp"]["step_ms"]
         / arms["dense"]["step_ms"]})
    if not (start_err == 0 and first_err <= SP_FIRST_TOL
            and loss_err <= SP_LOSS_TOL and grad_err <= SP_GRAD_TOL
            and param_err <= SP_PARAM_TOL):
        raise AssertionError(f"{name}: seq_axis training disagrees with "
                             f"the model without it")
    return arms["sp"]["launches"]


def _sp_gpt(torch, np, args, smi, name, config, b, s, per_step):
    """(b)/(c) for a GPT config: ``_sp_pair`` over ``GPT(config)`` with
    and without ``seq_axis`` (the same weights from ``--seed``), batch b x
    s; its ring routes: one diag block a layer (a ring of one)."""
    import dataclasses

    from distributed_tensorflow_tpu_torch import GPT, parallel
    mesh = parallel.make_mesh({"seq": 1})

    def build(sp):
        model = GPT(dataclasses.replace(config,
                                        seq_axis="seq" if sp else None),
                    device="cuda", mesh=mesh if sp else None,
                    generator=torch.Generator("cuda").manual_seed(args.seed))
        state, step = _train_setup(torch, model, TRAIN_LR, args.seed)
        return (dict(model.named_parameters()), state, step,
                _train_batch(torch, np, args.seed, b, s, config.vocab_size,
                             "cuda"))
    L = config.num_layers
    return _sp_pair(torch, np, smi, name, b * s, build, per_step,
                    {"forward_diag": L, "dq_diag": L, "dkv_diag": L})


def _sp_bert(torch, np, args, smi, b, s):
    """(c) BERT-base MLM, bf16, dropout 0, at b x s with ragged key
    padding and a 15% MLM mask: ``_sp_pair`` with and without
    ``seq_axis`` (a ring of one: one full block a layer with the key
    plane)."""
    from distributed_tensorflow_tpu_torch import (TrainState, adamw,
                                                  make_custom_train_step,
                                                  parallel)
    from distributed_tensorflow_tpu_torch.models.bert import Bert, BertConfig
    mesh = parallel.make_mesh({"seq": 1})
    dev = torch.device("cuda")
    init = Bert(BertConfig()).init(torch.Generator("cuda").manual_seed(
        args.seed))
    rng = np.random.default_rng(args.seed)
    lengths = rng.integers(s // 2, s + 1, b)
    batch = {"input_ids": rng.integers(0, 30522, (b, s)),
             "labels": rng.integers(0, 30522, (b, s)),
             "mlm_mask": (rng.random((b, s)) < 0.15)
             & (np.arange(s)[None] < lengths[:, None]),
             "attention_mask": np.arange(s)[None] < lengths[:, None]}
    batch = {k: torch.from_numpy(v.astype(np.int32)).to(dev)
             for k, v in batch.items()}

    def build(sp):
        model = Bert(BertConfig(dtype=torch.bfloat16, dropout_rate=0.0,
                                seq_axis="seq" if sp else None),
                     mesh=mesh if sp else None)
        params = {k: v.detach().clone().requires_grad_(True)
                  for k, v in init.items()}
        opt = adamw(TRAIN_LR, mask=model.decay_mask)
        state = TrainState.create(params, opt.init(params))
        step = make_custom_train_step(model.mlm_loss_fn(), opt,
                                      seed=args.seed, grad_clip_norm=1.0)
        return params, state, step, batch
    L = 12
    # flash a layer (forward, dK/dV, dQ); LayerNorm: the embeddings', 2 a
    # layer, the MLM head's; Adam once a leaf (phase 22's 204)
    per_step = {"flash_forward": L, "flash_backward_dkv": L,
                "flash_backward_dq": L, "layernorm": 2 * L + 2,
                "rmsnorm": 0, "fused_adam": 204}
    return _sp_pair(torch, np, smi, f"(c) bert-base mlm {b}x{s}", b * s,
                    build, per_step, {"forward_full": L, "dq_full": L,
                                      "dkv_full": L})


def check_sp(torch, np, args, smi):
    """Phase 25, sequence parallelism: returns ({case: the ring routes'
    time records}, the kernels' launches over (b) and (c)'s seq_axis
    arms)."""
    from distributed_tensorflow_tpu_torch import gpt_small, llama3_8b
    t_phase = time.perf_counter()
    routes = {case[0]: _sp_ring_case(torch, args, smi, *case)
              for case in SP_CASES}
    torch.cuda.empty_cache()
    L = 12
    counts = collections.Counter(_sp_gpt(
        torch, np, args, smi, "(b) gpt2 small 6x2048",
        gpt_small(dtype=torch.bfloat16, dropout_rate=0.0,
                  max_position=2048), 6, 2048,
        # flash a layer, LayerNorm 2 a layer and ln_f, Adam once a leaf
        {"flash_forward": L, "flash_backward_dkv": L,
         "flash_backward_dq": L, "layernorm": 2 * L + 1, "rmsnorm": 0,
         "fused_adam": 4 + 16 * L}))
    L = SP_LLAMA_LAYERS
    counts.update(_sp_gpt(
        torch, np, args, smi, f"(c) llama3-8b widths x{L} layers 4x2048",
        llama3_8b(dtype=torch.bfloat16, num_layers=L, max_position=2048),
        4, 2048,
        # RMSNorm 2 a layer and ln_f; Adam: word, lm_head, ln_f and 9 a
        # layer
        {"flash_forward": L, "flash_backward_dkv": L,
         "flash_backward_dq": L, "layernorm": 0, "rmsnorm": 2 * L + 1,
         "fused_adam": 3 + 9 * L}))
    counts.update(_sp_bert(torch, np, args, smi, 16, 512))
    counts = {k: v for k, v in counts.items() if not k.startswith("ring_")}
    log({"phase": "sp", "seconds": time.perf_counter() - t_phase,
         "launches": counts})
    return routes, counts


# -- phase 26: ZeRO over fsdp -------------------------------------------------
# (a) two warm-up and five timed steps an arm (with one, the ZeRO arms'
# timed steps ran 3-8% slower than the plain arms' in three runs, on the
# same kernels and launches); the session saves after 2 steps; (b) a
# virtual fsdp line of 4; (c) the entry point's second run resumes its
# 200 steps to 220.  Checkpoints and logs under ZERO_DIR, removed at the
# phase's end.
ZERO_WARMUP, ZERO_STEPS, ZERO_SESSION = 2, 5, 2
ZERO_VIRTUAL, ZERO_RESUME = 4, 220
ZERO_DIR = Path("build") / "zero"


def _zero_arm(torch, args, sharded, seed):
    """(model, state, step) of (a): GPT-2 small bf16 from ``seed``'s
    weights, ``with_ema(adamw(1e-4), 0.99)``, clip 1.0, mixed bf16, on
    a mesh of one; ``sharded`` places the state by the fsdp rules."""
    from distributed_tensorflow_tpu_torch import (GPT, gpt_small, optim,
                                                  parallel, train)
    model = GPT(gpt_small(dtype=torch.bfloat16, dropout_rate=0.0),
                device="cuda",
                generator=torch.Generator("cuda").manual_seed(seed))
    opt = optim.with_ema(optim.adamw(TRAIN_LR), 0.99)
    params = dict(model.named_parameters())
    state = train.TrainState.create(params, opt.init(params))
    mesh = parallel.make_mesh({"data": 1, "fsdp": 1})
    if sharded:
        state = train.shard_train_state(state, mesh,
                                        model.partition_rules(fsdp=True))
    step = train.make_custom_train_step(
        model.lm_loss_fn(), opt, seed=args.seed, mesh=mesh,
        grad_clip_norm=1.0, policy="mixed_bfloat16")
    return model, state, step


def _zero_counts(torch):
    """The training kernels' launches and the collectives issued since
    ``_reset_counts``."""
    from distributed_tensorflow_tpu_torch.parallel import data_parallel
    counts = _train_counts(torch)
    counts["collectives"] = sum(data_parallel.LAUNCHES.values())
    return counts


def _leaves(torch, state):
    """(path, value) of every leaf of a state (tensors cloned)."""
    from distributed_tensorflow_tpu_torch.train import checkpoint
    return [(p, v.detach().clone() if isinstance(v, torch.Tensor) else v)
            for p, v in checkpoint._flatten(state)]


def _same(torch, got, want, what):
    """Fail unless two ``_leaves`` lists are equal to the bit."""
    if [p for p, _ in got] != [p for p, _ in want]:
        raise AssertionError(f"{what}: the states' leaves differ")
    for (path, a), (_, b) in zip(got, want):
        same = (torch.equal(a, b) if isinstance(a, torch.Tensor)
                else a == b)
        if not same:
            raise AssertionError(f"{what}: {path} differs")


def _zero_pair(torch, np, args, smi, batch):
    """(a)'s arms in turns (ZeRO, plain, plain, ZeRO, so that neither
    kind always runs first): every arm's losses and final state equal to
    the bit, exact launches, no collective.  Returns (the first ZeRO
    arm's launch counts, a plain arm's (model, state))."""
    steps = ZERO_WARMUP + ZERO_STEPS
    rows, first, plain = [], None, None
    for arm in ("zero", "plain", "plain", "zero"):
        gc.collect()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        model, state, step = _zero_arm(torch, args, arm == "zero", args.seed)

        def run():
            losses, t0 = [], None
            st = state
            for i in range(steps):
                if i == ZERO_WARMUP:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                st, m = step(st, batch)
                losses.append(m["loss"])
            torch.cuda.synchronize()
            return st, [float(x) for x in losses], time.perf_counter() - t0
        (state, losses, wall), _, counts = _driven(torch, run, _zero_counts)
        row = {"arm": arm, "losses": losses,
               "step_ms": wall / ZERO_STEPS * 1e3,
               "peak_memory_gb": (torch.cuda.max_memory_allocated() - base)
               / 1e9, "launches": counts}
        rows.append(row)
        log({"zero": "(a) gpt2 small 48x256", "turn": len(rows),
             "steps": steps, **row, "card": smi})
        per_step = _per_step(model.config, len(state.params), False, 1)
        _check_counts(f"zero (a) {arm}", counts, per_step, steps)
        if counts["collectives"]:
            raise AssertionError(f"zero (a) {arm}: {counts['collectives']} "
                                 f"collectives on a mesh of one")
        leaves = _leaves(torch, state)
        if first is None:
            first = (losses, leaves)
        elif losses != first[0]:
            raise AssertionError(f"zero (a) {arm}: losses {losses} != "
                                 f"{first[0]}")
        else:
            _same(torch, leaves, first[1], f"zero (a) {arm}")
        del leaves
        if arm == "plain":
            plain = (model, state)
        del model, state, step
    del first

    def mean(kind, key):
        vals = [r[key] for r in rows if r["arm"] == kind]
        return sum(vals) / len(vals)
    log({"zero": "(a) zero vs plain", "bit_equal": True,
         "step_ms_zero": mean("zero", "step_ms"),
         "step_ms_plain": mean("plain", "step_ms"),
         "step_ms_zero_over_plain": mean("zero", "step_ms")
         / mean("plain", "step_ms"),
         "peak_memory_gb_zero": mean("zero", "peak_memory_gb"),
         "peak_memory_gb_plain": mean("plain", "peak_memory_gb")})
    return rows[0]["launches"], plain


def _zero_session(torch, np, args, smi, batch):
    """(a)'s session: saves after ZERO_SESSION steps; a fresh session from
    other weights restores a bit-equal state and its next step equals the
    uninterrupted run's."""
    from distributed_tensorflow_tpu_torch import train
    d = ZERO_DIR / "session"
    shutil.rmtree(d, ignore_errors=True)
    model, state, step = _zero_arm(torch, args, True, args.seed)
    with train.TrainSession(state, step, checkpoint_dir=str(d),
                            sharded_checkpoint=True) as sess:
        for _ in range(ZERO_SESSION):
            sess.run_step(batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = sess.save()
        save_s = time.perf_counter() - t0
        state = sess.state
    nbytes = sum(f.stat().st_size for f in Path(path).iterdir())
    saved = _leaves(torch, state)
    state, m = step(state, batch)
    want_loss = float(m["loss"])
    want = _leaves(torch, state)
    del model, state, step
    torch.cuda.empty_cache()
    model, state, step = _zero_arm(torch, args, True, args.seed + 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sess = train.TrainSession(state, step, checkpoint_dir=str(d),
                              sharded_checkpoint=True)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    if sess.step != ZERO_SESSION:
        raise AssertionError(f"zero session resumed at {sess.step}")
    _same(torch, _leaves(torch, sess.state), saved, "zero session restore")
    loss = float(sess.run_step(batch)["loss"])
    if loss != want_loss:
        raise AssertionError(f"zero session: resumed step loss {loss} != "
                             f"{want_loss}")
    _same(torch, _leaves(torch, sess.state), want, "zero session step")
    log({"zero": "(a) session", "save_s": save_s, "checkpoint_bytes": nbytes,
         "restore_s": restore_s, "resumed_at": ZERO_SESSION,
         "next_step_bit_equal": True, "card": smi})
    del model, state, step, sess, saved, want
    torch.cuda.empty_cache()


def _zero_adam_shard(torch, args, smi, shape=(50257, 768 // ZERO_VIRTUAL),
                     tag=("zero", "(b) fused_adam at a block")):
    """The Adam kernel at a block (phase 26: the word embedding's on a
    line of 4, [50257, 192], dim 1 cut), as ``adamw`` calls it: against
    its plain version, its ms and graph ms, the plain ms,
    ``AdamW(fused=True)``'s, the bound (28 bytes an element)."""
    from distributed_tensorflow_tpu_torch.ops.kernels import fused
    gen = torch.Generator("cuda").manual_seed(args.seed)
    kw = dict(lr=TRAIN_LR, weight_decay=0.01, tf14_eps=True,
              return_delta=True)
    p, g, m = (torch.randn(shape, generator=gen, device="cuda")
               for _ in range(3))
    v = torch.rand(shape, generator=gen, device="cuda")
    want = fused.adam_plain(p, g, m, v, 3, **kw)
    m2, v2 = m.clone(), v.clone()
    got = fused.fused_adam_update(p, g, m2, v2, 3, out=(None, m2, v2), **kw)
    torch.cuda.synchronize()
    err = max((x - y).abs().max().item() for x, y in zip(got, want))
    if not err <= ADAM_TOL:
        raise AssertionError(f"Adam kernel at {shape} disagrees: {err}")

    def call():
        fused.fused_adam_update(p, g, m2, v2, 3, out=(None, m2, v2), **kw)
    lib_p = p.clone()
    lib_p.grad = g
    cap_p = p.clone()
    cap_p.grad = g
    lib_graph, why = _graph_or_why(torch, torch.optim.AdamW(
        [cap_p], lr=TRAIN_LR, eps=1e-8, weight_decay=0.01, fused=True,
        capturable=True).step, args.iters)
    b_ms, b_by = bound_ms(28.0 * p.numel(), 12.0 * p.numel())
    rec = {"shape": list(shape), "max_abs_err": err,
           "ms": time_ms(torch, call, args.iters),
           "graph_ms": graph_ms(torch, call, args.iters),
           "plain_ms": time_ms(torch, lambda: fused.adam_plain(
               p, g, m2, v2, 3, out=(None, m2, v2), **kw), args.iters),
           "library_ms": time_ms(torch, torch.optim.AdamW(
               [lib_p], lr=TRAIN_LR, eps=1e-8, weight_decay=0.01,
               fused=True).step, args.iters),
           "library_graph_ms": lib_graph, "bound_ms": b_ms,
           "bound_by": b_by}
    log({tag[0]: tag[1], **rec,
         **({"library_graph_note": why} if why else {}),
         "library": "torch.optim.AdamW(fused=True).step()", "card": smi})
    return rec


def _zero_virtual(torch, np, args, smi, model, state):
    """(b) on (a)'s plain arm after its steps: the Adam kernel a virtual
    rank's blocks against the whole leaves; the blocks' join; the sharded
    checkpoint of 4 virtual pids restored onto the fsdp-2 and fsdp-1
    layouts.  Returns the Adam launches over the virtual ranks."""
    from distributed_tensorflow_tpu_torch import optim, parallel, train
    from distributed_tensorflow_tpu_torch.ops.kernels import fused
    from distributed_tensorflow_tpu_torch.train import \
        sharded_checkpoint as sc
    rules = model.partition_rules(fsdp=True)
    params = dict(model.named_parameters())
    opt = optim.adamw(TRAIN_LR)
    inner = state.opt_state.inner["opt"]
    gen = torch.Generator("cuda").manual_seed(args.seed)
    grads = {k: torch.randn(p.shape, generator=gen, device="cuda") * 1e-3
             for k, p in params.items()}

    def moments():
        return optim.OptState(inner.count, {
            n: {k: t.clone() for k, t in inner.inner[n].items()}
            for n in ("m", "v")})
    whole_state = moments()
    whole, whole_state = opt.update(grads, whole_state, params)

    def rank(r, n=ZERO_VIRTUAL):
        return parallel.Mesh(n, r, None, axes={"fsdp": n}, lines={})

    placed, ups = [], []
    fused.LAUNCHES.clear()
    for r in range(ZERO_VIRTUAL):
        st = train.shard_train_state(
            train.TrainState.create(params, moments()), rank(r), rules)
        g = {k: t if st.params.layout[k] is None
             else st.params.layout[k].take(t) for k, t in grads.items()}
        up, st_opt = opt.update(g, st.opt_state, st.params)
        placed.append((st.params, st_opt))
        ups.append(up)
    torch.cuda.synchronize()
    launches = fused.LAUNCHES["adam"]
    if launches != ZERO_VIRTUAL * len(params):
        raise AssertionError(f"zero (b): {launches} Adam launches, expected "
                             f"{ZERO_VIRTUAL} x {len(params)}")
    layout = placed[0][0].layout

    def joined(parts, k):
        s = layout[k]
        return parts[0] if s is None else torch.cat(parts, s.dim)
    for k in params:
        if not torch.equal(joined([pl[0][k] for pl in placed], k),
                           params[k]):
            raise AssertionError(f"zero (b): the blocks of {k} do not join")
        for what, got, want in (
                ("delta", [u[k] for u in ups], whole[k]),
                ("m", [pl[1].inner["m"][k] for pl in placed],
                 whole_state.inner["m"][k]),
                ("v", [pl[1].inner["v"][k] for pl in placed],
                 whole_state.inner["v"][k])):
            if not torch.equal(joined(got, k), want):
                raise AssertionError(f"zero (b): Adam's {what} of {k} on "
                                     f"the blocks != the whole leaf's")
    cut = sorted({(k.split(".")[-2] if k.startswith("blocks") else k,
                   s.dim) for k, s in layout.items() if s is not None})
    log({"zero": "(b) virtual fsdp line", "ranks": ZERO_VIRTUAL,
         "adam_launches": launches, "cut_leaves": sum(
             s is not None for s in layout.values()), "cut_dims": cut,
         "bit_equal": True})
    del placed, ups, whole, whole_state, grads
    torch.cuda.empty_cache()

    d = ZERO_DIR / "virtual"
    shutil.rmtree(d, ignore_errors=True)
    want = _leaves(torch, state)
    t0 = time.perf_counter()
    for r in range(ZERO_VIRTUAL):
        path = sc.save_sharded(str(d), state.step, train.shard_train_state(
            state, rank(r), rules), process_index=r,
            process_count=ZERO_VIRTUAL)
    save_s = time.perf_counter() - t0
    nbytes = sum(f.stat().st_size for f in Path(path).iterdir())
    restore_s = {}
    for n in (2, 1):
        t0 = time.perf_counter()
        parts = []
        for r in range(n):
            zeros = {k: torch.zeros_like(p) for k, p in params.items()}
            opt_ema = optim.with_ema(optim.adamw(TRAIN_LR), 0.99)
            target = train.TrainState.create(zeros, opt_ema.init(zeros))
            if n > 1:
                target = train.shard_train_state(target, rank(r, n), rules)
            parts.append(sc.restore_sharded(target, path))
        torch.cuda.synchronize()
        restore_s[f"fsdp{n}"] = time.perf_counter() - t0
        got = (_leaves(torch, parts[0]) if n == 1 else
               _joined_leaves(torch, parts))
        _same(torch, got, want, f"zero (b) restore onto fsdp {n}")
        del parts, got
        torch.cuda.empty_cache()
    ok, why = sc.verify_sharded(path)
    if not ok:
        raise AssertionError(f"zero (b): verify_sharded failed: {why}")
    (Path(path) / f"shards-{ZERO_VIRTUAL - 1:05d}.npz").unlink()
    gone, why_gone = sc.verify_sharded(path)
    if gone:
        raise AssertionError("zero (b): verify_sharded passed without a "
                             "shard file")
    log({"zero": "(b) sharded checkpoint of 4 pids", "save_s": save_s,
         "checkpoint_bytes": nbytes, "restore_s": restore_s,
         "bit_equal": True, "verify_without_a_shard": why_gone,
         "card": smi})
    return launches


def _joined_leaves(torch, states):
    """``_leaves`` of the whole state that the ZeRO ``states`` of one
    line's ranks hold: each cut block joined along its dim."""
    from distributed_tensorflow_tpu_torch.parallel import sharding
    from distributed_tensorflow_tpu_torch.train import checkpoint

    def join(trees):
        t0 = trees[0]
        if isinstance(t0, sharding.ShardedDict):
            return {k: (t0[k] if s is None else torch.cat(
                [t[k] for t in trees], s.dim)) for k, s in t0.layout.items()}
        if isinstance(t0, dict):
            return {k: join([t[k] for t in trees]) for k in t0}
        if isinstance(t0, tuple) and hasattr(t0, "_fields"):
            return type(t0)(*(join(list(x)) for x in zip(*trees)))
        return t0
    return [(p, v.detach().clone() if isinstance(v, torch.Tensor) else v)
            for p, v in checkpoint._flatten(join(states))]


def _zero_entry(torch, smi):
    """(c): the entry point at its defaults, resumed to ZERO_RESUME, and
    the Llama family."""
    import re

    from distributed_tensorflow_tpu_torch.train import \
        sharded_checkpoint as sc
    root = Path(__file__).resolve().parent

    def start(log_dir, *argv):
        return time.perf_counter(), argv, subprocess.Popen(
            [sys.executable, "-m",
             "distributed_tensorflow_tpu_torch.examples.train_gpt",
             f"--log_dir={log_dir}", *argv], cwd=root,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def wait(run):
        t0, argv, p = run
        try:
            out, err = p.communicate(timeout=600)
        finally:
            if p.poll() is None:
                p.kill()
                p.wait()
        if p.returncode != 0:
            raise AssertionError(f"train_gpt {argv}: rc {p.returncode}\n"
                                 f"{err[-3000:]}")
        return out, time.perf_counter() - t0

    d = ZERO_DIR / "entry"
    shutil.rmtree(d, ignore_errors=True)
    # the Llama family runs beside the defaults' first run (its own log
    # dir): two processes of a 2-layer model share the card
    llama = start(ZERO_DIR / "entry_llama", "--family=llama")
    out, secs = wait(start(d))
    ev = re.search(r"eval loss: live=([\d.]+) ema=([\d.]+) "
                   r"\(uniform=([\d.]+)\)", out)
    if ev is None or "generated:" not in out:
        raise AssertionError(f"train_gpt printed no eval or generated line:"
                             f"\n{out[-2000:]}")
    live, ema, uniform = (float(x) for x in ev.groups())
    if not (live < uniform and ema < uniform):
        raise AssertionError(f"train_gpt: eval live {live} ema {ema} not "
                             f"below uniform {uniform}")
    last = sc.all_sharded_checkpoints(str(d))[-1]
    if not last.endswith("ckpt-0000000200") or not sc.verify_sharded(
            last)[0]:
        raise AssertionError(f"train_gpt: checkpoint {last}")
    out3, secs3 = wait(llama)
    out2, secs2 = wait(start(d, f"--steps={ZERO_RESUME}"))
    resumed = "Restored checkpoint ckpt-0000000200 at step 200" in out2
    ends = sc.all_sharded_checkpoints(str(d))[-1].endswith(
        f"ckpt-{ZERO_RESUME:010d}")
    if not (resumed and ends):
        raise AssertionError(f"train_gpt --steps={ZERO_RESUME}: resumed "
                             f"{resumed}, ends at {ZERO_RESUME} {ends}")
    log({"zero": "(c) train_gpt", "seconds": secs, "eval_live": live,
         "eval_ema": ema, "uniform": uniform,
         "generated": [l for l in out.splitlines()
                       if l.startswith("generated:")][0],
         "resume_seconds": secs2, "llama_seconds": secs3,
         "llama_eval": [l for l in out3.splitlines()
                        if l.startswith("eval loss:")], "card": smi})


def check_zero(torch, np, args, smi):
    """Phase 26, ZeRO over fsdp: returns ((a)'s ZeRO arm's launch
    counts, (b)'s Adam record at a block)."""
    t_phase = time.perf_counter()
    batch = _train_batch(torch, np, args.seed, TRAIN_BATCH, TRAIN_SEQ,
                         50257, "cuda")
    counts, (model, state) = _zero_pair(torch, np, args, smi, batch)
    _zero_session(torch, np, args, smi, batch)
    virtual_adam = _zero_virtual(torch, np, args, smi, model, state)
    del model, state
    torch.cuda.empty_cache()
    shard = _zero_adam_shard(torch, args, smi)
    _zero_entry(torch, smi)
    shutil.rmtree(ZERO_DIR, ignore_errors=True)
    counts.pop("collectives")
    log({"phase": "zero", "seconds": time.perf_counter() - t_phase,
         "launches": counts, "virtual_adam_launches": virtual_adam})
    return counts, shard


# -- phase 27: tensor parallelism ---------------------------------------------
# (a) A line of one (``make_mesh({"tensor": 1})``) at full width against the
# plain model from the same weights on the same batch: BERT-base MLM at
# phase 22's batch (TP_BERT_BATCH x TP_BERT_SEQ, bf16, ragged key padding,
# a 15% MLM mask) and the Llama recipe at Llama-3-8B's widths cut to
# TP_LLAMA_LAYERS layers (TP_LLAMA_BATCH x TP_LLAMA_SEQ, GQA 32:8).  Each
# arm takes TP_WARMUP + TP_STEPS adamw(1e-4) steps with clip 1.0.  A line of
# one runs the plain code path, so losses, the gradient norm and every
# parameter must be equal to the bit, with the plain launches and no
# collective; the arms run in turns (line, plain, plain, line).  (b) Two
# ranks on the one card, each a process of this script (``--ranks-for=tp``) over
# gloo with CUDA tensors (NCCL refuses two ranks on one device), on
# ``{"tensor": 2}``: the same models from the same
# weights and batches, BERT-base (flash on 6 of the 12 heads, with the key
# plane), the Llama recipe with ``shard_kv=True`` (16 q / 4 kv heads a
# rank) and with replicated kv projections (16 q heads reading 4 of the 8
# kv heads).  Their losses, first gradient norm and parameters are held to
# (a)'s plain arm as phase 25 holds its rings: a rank's row-parallel sums
# round each rank's bf16 partial product before adding them, where one
# GEMM rounds once, so the losses agree to TP_LOSS_TOL, the first step's
# gradient norm to TP_GRAD_TOL (relative), and the parameters' gap to
# TP_PARAM_TOL of their movement (2-norms over every TP_SAMPLE-th row a
# rank holds; Adam moves an element by about lr a step whatever its
# gradient, so an absolute bound could not fail).  The tensor line's
# collectives are exact a step (``tp_collectives``, a formula in L), the
# kernels' launches too, and each rank's peak memory is below (a)'s.
# (c) Contiguous decoding of a f32 copy of the Llama recipe (TF32 off) on
# the same two ranks: ``decode_block`` of a TP_DECODE_PROMPT prompt,
# ``decode_step`` and greedy ``generate`` of TP_DECODE_NEW tokens against
# the plain model: the same tokens, logits within TP_DECODE_TOL.  (d)
# ``python -m distributed_tensorflow_tpu_torch.examples.finetune_bert`` on
# two ranks of the card (``DTTPU_DIST_BACKEND=gloo``), beside (b): exit 0,
# its mesh printed as ``{'data': 1, 'tensor': 2}``, eval accuracy above
# chance.  Before all of it the flash kernels are timed at the ranks'
# shapes beside their plain versions, SDPA and the bound.  Files under
# TP_DIR, removed at the phase's end.  Measured on an H100 80GB HBM3 at
# 700 W (the phase's first run): loss errors 5.5e-4-9.5e-4 (losses of
# 10.4 and 12.4 at the start), first gradient norms within 4.5e-5, gaps
# 0.024-0.032 of the movement, decoded logits within 1.2e-5; the
# tolerances are about 10x, 10x, 3x and 8x those.
# (2 + 3 until phase 29 needed the room: a rank's BERT-base step takes
# 2.4-4.3 s of gloo's host copies)
TP_WARMUP, TP_STEPS = 1, 2
TP_BERT_BATCH, TP_BERT_SEQ = 128, 128
TP_LLAMA_LAYERS, TP_LLAMA_BATCH, TP_LLAMA_SEQ = 2, 4, 512
TP_LOSS_TOL, TP_GRAD_TOL, TP_PARAM_TOL = 1e-2, 5e-4, 0.1
TP_DECODE_PROMPT, TP_DECODE_NEW, TP_DECODE_TOL = (2, 64), 16, 1e-4
TP_SAMPLE = {"bert": 4, "llama": 64}
# (b)'s arms: (name, model, shard_kv)
TP_ARMS = (("bert", "bert", None), ("llama shard_kv", "llama", True),
           ("llama", "llama", None))
TP_RANK_TIMEOUT_S = 600
TP_DIR = Path("build") / "tp"


def tp_collectives(kind, L):
    """The collectives of one training step on a tensor line of more than
    one rank: forward, the embedding's sum, the attention output's and the
    FFN's sums a layer and the cross entropy's two all-reduces; backward,
    the column-parallel inputs' gradient sums (2 a layer, the head's 1);
    the vocabulary-parallel argmax's gather; BERT's MLM transform adds its
    gather and its gradient sum; one stats all-reduce for the clip's
    norm over the line; no data-line all-reduce on a data line of one."""
    bert = kind == "bert"
    return {"tp_all_reduce": 4 * L + (5 if bert else 4),
            "tp_all_gather": 2 if bert else 1, "stats_all_reduce": 1,
            "all_reduce": 0}


def _tp_counts(torch):
    """The training kernels' launches (RMSNorm too) and the collectives
    since ``_reset_counts``."""
    from distributed_tensorflow_tpu_torch.ops.kernels import fused
    from distributed_tensorflow_tpu_torch.parallel import data_parallel
    counts = _train_counts(torch)
    counts["rmsnorm"] = fused.LAUNCHES["rmsnorm"]
    counts.update(data_parallel.LAUNCHES)
    return counts


def _tp_llama_config(torch, dtype=None):
    from distributed_tensorflow_tpu_torch import llama3_8b
    return llama3_8b(dtype=dtype or torch.bfloat16,
                     num_layers=TP_LLAMA_LAYERS, max_position=TP_LLAMA_SEQ)


def _tp_per_step(kind):
    """Each training kernel's launches a step (every rank's the same)."""
    if kind == "bert":
        L = 12
        # LayerNorm: the embeddings', 2 a layer, the MLM head's; Adam once
        # a leaf (phase 22's 204)
        return {"flash_forward": L, "flash_backward_dkv": L,
                "flash_backward_dq": L, "layernorm": 2 * L + 2,
                "rmsnorm": 0, "fused_adam": 204}
    L = TP_LLAMA_LAYERS
    # RMSNorm 2 a layer and ln_f; Adam: word, lm_head, ln_f, 9 a layer
    return {"flash_forward": L, "flash_backward_dkv": L,
            "flash_backward_dq": L, "layernorm": 0, "rmsnorm": 2 * L + 1,
            "fused_adam": 3 + 9 * L}


def _tp_build(torch, np, seed, kind, mesh, shard_kv=None):
    """(params, state, step, batch) of one arm of (a) or (b): ``kind``
    "bert" or "llama" from ``seed``'s weights, on ``mesh`` (None: the
    plain model), ``adamw(1e-4)`` with clip 1.0; under a mesh the state
    placed by ``shard_train_state``."""
    from distributed_tensorflow_tpu_torch import (GPT, TrainState, adamw,
                                                  make_custom_train_step,
                                                  train)
    from distributed_tensorflow_tpu_torch.models.bert import Bert, BertConfig
    gen = torch.Generator("cuda").manual_seed(seed)
    if kind == "bert":
        model = Bert(BertConfig(dtype=torch.bfloat16, dropout_rate=0.0),
                     mesh=mesh)
        params = model.init(gen)
        loss_fn, opt = model.mlm_loss_fn(), adamw(TRAIN_LR,
                                                  mask=model.decay_mask)
        rng = np.random.default_rng(seed)
        b, s = TP_BERT_BATCH, TP_BERT_SEQ
        lengths = rng.integers(s // 2, s + 1, b)
        valid = np.arange(s)[None] < lengths[:, None]
        batch = {"input_ids": rng.integers(0, 30522, (b, s)),
                 "labels": rng.integers(0, 30522, (b, s)),
                 "mlm_mask": (rng.random((b, s)) < 0.15) & valid,
                 "attention_mask": valid}
        batch = {k: torch.from_numpy(v.astype(np.int32)).to("cuda")
                 for k, v in batch.items()}
    else:
        config = _tp_llama_config(torch)
        model = GPT(config, device="cuda", generator=gen, mesh=mesh,
                    shard_kv=shard_kv)
        params = dict(model.named_parameters())
        loss_fn, opt = model.lm_loss_fn(), adamw(TRAIN_LR)
        batch = _train_batch(torch, np, seed, TP_LLAMA_BATCH, TP_LLAMA_SEQ,
                             config.vocab_size, "cuda")
    state = TrainState.create(params, opt.init(params))
    if mesh is not None:
        state = train.shard_train_state(state, mesh, model.partition_rules())
    step = make_custom_train_step(loss_fn, opt, seed=seed, mesh=mesh,
                                  grad_clip_norm=1.0)
    return params, state, step, batch


def _tp_arm(torch, np, seed, kind, mesh, shard_kv=None, keep_start=False):
    """One arm's run: (record, its parameters after the steps, with
    ``keep_start`` a copy of them before the steps on the card).  The
    record's peak memory is the arm's own: the most allocated while it
    steps, less what was allocated before it began and the copy."""
    base = torch.cuda.memory_allocated()
    params, state, step, batch = _tp_build(torch, np, seed, kind, mesh,
                                           shard_kv)
    start = ({k: p.detach().clone() for k, p in params.items()}
             if keep_start else None)
    if start is not None:
        base += sum(t.numel() * t.element_size() for t in start.values())
    n_steps = TP_WARMUP + TP_STEPS
    (losses, grad_norm, wall, peak), _, counts = _driven(
        torch, lambda: _sp_steps(torch, np, step, state, batch, TP_WARMUP,
                                 TP_STEPS), _tp_counts)
    tokens = batch["input_ids"].numel() if kind == "bert" else (
        TP_LLAMA_BATCH * TP_LLAMA_SEQ)
    step_ms = wall / TP_STEPS * 1e3
    want = {k: n * n_steps for k, n in _tp_per_step(kind).items()}
    rec = {"losses": losses, "grad_norm": grad_norm, "step_ms": step_ms,
           "tokens_per_s": tokens / (step_ms / 1e3),
           "peak_memory_gb": peak - base / 1e9, "launches": counts,
           "launches_expected": want}
    del state, step, batch
    return rec, params, start


def _tp_line_of_one(torch, np, args, smi, kind):
    """(a) for ``kind``: the line of one and the plain model in turns
    (line, plain, plain, line, so that neither kind always runs first),
    every arm bit-equal to the first, exact launches, no collective.
    Returns (the first line arm's launches, the first plain arm's record,
    (its parameters at the start, after the steps), kept on the card as
    (b)'s reference)."""
    from distributed_tensorflow_tpu_torch import parallel
    name = {"bert": f"bert-base mlm {TP_BERT_BATCH}x{TP_BERT_SEQ}",
            "llama": f"llama3-8b widths x{TP_LLAMA_LAYERS} layers "
                     f"{TP_LLAMA_BATCH}x{TP_LLAMA_SEQ}"}[kind]
    recs, kept, ref = [], None, None
    for arm in ("tensor 1", "plain", "plain", "tensor 1"):
        gc.collect()
        torch.cuda.empty_cache()
        mesh = parallel.make_mesh({"tensor": 1}) if arm == "tensor 1" \
            else None
        first_plain = arm == "plain" and ref is None
        rec, params, start = _tp_arm(torch, np, args.seed, kind, mesh,
                                     keep_start=first_plain)
        recs.append((arm, rec))
        log({"tp": f"(a) {name}", "arm": arm, "turn": len(recs),
             "steps": TP_STEPS, **rec, "card": smi})
        extra = {k: v for k, v in rec["launches"].items()
                 if k not in rec["launches_expected"] and v}
        _zoo_expect(f"tp (a) {name} {arm}", rec["launches"],
                    rec["launches_expected"])
        if extra:
            raise AssertionError(f"tp (a) {name} {arm}: collectives on a "
                                 f"line of one: {extra}")
        if kept is None:
            kept = (rec, {k: p.detach() for k, p in params.items()})
        elif not (rec["losses"] == kept[0]["losses"]
                  and rec["grad_norm"] == kept[0]["grad_norm"]
                  and all(torch.equal(kept[1][k], p.detach())
                          for k, p in params.items())):
            raise AssertionError(f"tp (a) {name} {arm} (turn {len(recs)}):"
                                 f" not the first arm to the bit")
        if first_plain:
            ref = (rec, (start, {k: p.detach() for k, p in params.items()}))
        del params, start
    del kept
    gc.collect()
    torch.cuda.empty_cache()

    def mean(kind_, key):
        vals = [r[key] for a, r in recs if a == kind_]
        return sum(vals) / len(vals)
    log({"tp": f"(a) {name}", "check": "tensor 1 vs plain",
         "bit_equal": True,
         "step_ms_tensor1": mean("tensor 1", "step_ms"),
         "step_ms_plain": mean("plain", "step_ms"),
         "step_ms_tensor1_over_plain": mean("tensor 1", "step_ms")
         / mean("plain", "step_ms")})
    return recs[0][1]["launches"], ref[0], ref[1]


def _tp_sample(t, n):
    """Every n-th row (dim 0) of a tensor, on the host."""
    return t.detach()[::n].to("cpu", copy=True)


def _tp_decode_plain(torch, np, args):
    """(c)'s reference: the f32 Llama copy's decode on one process."""
    from distributed_tensorflow_tpu_torch import GPT
    model = GPT(_tp_llama_config(torch, torch.float32), device="cuda",
                generator=torch.Generator("cuda").manual_seed(args.seed))
    out = _tp_decode(torch, np, args, model)
    del model
    torch.cuda.empty_cache()
    return out


def _tp_decode(torch, np, args, model):
    """``decode_block`` of the prompt, one ``decode_step`` of its argmax,
    and greedy ``generate``: (block logits, step logits, tokens) on the
    host."""
    b, s = TP_DECODE_PROMPT
    ids = torch.from_numpy(np.random.default_rng(args.seed + 1).integers(
        0, model.config.vocab_size, (b, s))).to("cuda")
    with torch.no_grad():
        cache = model.init_cache(b, s + TP_DECODE_NEW)
        block, cache = model.decode_block(cache, ids)
        step, cache = model.decode_step(cache, block.argmax(-1))
        tokens = model.generate(ids, TP_DECODE_NEW,
                                max_len=s + TP_DECODE_NEW)
    torch.cuda.synchronize()
    return block.cpu(), step.cpu(), tokens.cpu()


def tp_rank_main(args) -> int:
    """One rank of (b) and (c), a process of this script: the arms of
    TP_ARMS on ``{"tensor": 2}`` over gloo, then (c)'s decode; results
    to ``TP_DIR`` (``rank<r>.json``, ``rank<r>_<arm>.pt``)."""
    import datetime

    import numpy as np
    import torch
    import torch.distributed as dist

    from distributed_tensorflow_tpu_torch import GPT, parallel
    from distributed_tensorflow_tpu_torch.parallel import sharding
    r = args.rank
    torch.cuda.set_device(0)
    dist.init_process_group(
        "gloo", init_method=f"tcp://localhost:{args.rank_port}",
        world_size=2, rank=r,
        timeout=datetime.timedelta(seconds=TP_RANK_TIMEOUT_S))
    try:
        mesh = parallel.make_mesh({"tensor": 2})
        out = {}
        for name, kind, shard_kv in TP_ARMS:
            gc.collect()
            torch.cuda.empty_cache()
            rec, params, _ = _tp_arm(torch, np, args.seed, kind, mesh,
                                     shard_kv)
            samples = {}
            for k, p in params.items():
                s = sharding.marked_shard(p)
                samples[k] = ((-1, 0, p.shape[0]) if s is None
                              else (s.dim, s.start, s.length),
                              _tp_sample(p, TP_SAMPLE[kind]))
            torch.save(samples, TP_DIR / f"rank{r}_{name}.pt")
            out[name] = rec
            del params
        gc.collect()
        torch.cuda.empty_cache()
        model = GPT(_tp_llama_config(torch, torch.float32), device="cuda",
                    generator=torch.Generator("cuda").manual_seed(args.seed),
                    mesh=mesh)
        _reset_counts()
        decoded = _tp_decode(torch, np, args, model)
        out["decode"] = {"launches": _tp_counts(torch)}
        torch.save(decoded, TP_DIR / f"rank{r}_decode.pt")
        (TP_DIR / f"rank{r}.json").write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()
    return 0


def _tp_flash_rows(torch, args, smi):
    """The flash kernels timed at the ranks' shapes: BERT-base's 6 of 12
    heads with the key plane, the Llama recipe's 16 q / 4 kv causal."""
    from distributed_tensorflow_tpu_torch.ops.kernels import \
        flash_attention as fa
    import numpy as np
    gen = torch.Generator("cuda").manual_seed(args.seed)
    lengths = np.random.default_rng(args.seed).integers(
        TP_BERT_SEQ // 2, TP_BERT_SEQ + 1, TP_BERT_BATCH)
    rows = {"bert_base tp2": _zoo_flash_case(
        torch, fa, gen, "bert_base tp2", TP_BERT_BATCH, TP_BERT_SEQ, 6, 64,
        torch.bfloat16, lengths, args.iters)}
    rows["llama3_8b tp2"] = _zoo_flash_case(
        torch, fa, gen, "llama3_8b tp2", TP_LLAMA_BATCH, TP_LLAMA_SEQ, 16,
        128, torch.bfloat16, None, args.iters, hk=4, causal=True)
    for case, recs in rows.items():
        for rec in recs.values():
            rec["card"] = smi
    return rows


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _start_ranks(args, port, phase="tp", env_extra=None, module=None,
                 argv=(), world=2):
    """``world`` processes: this script's ranks of ``phase``
    (``--ranks-for``; ``module`` None) or ``python -m module argv`` with
    the cluster's environment."""
    import os
    root = Path(__file__).resolve().parent
    procs = []
    for r in range(world):
        if module is None:
            cmd = [sys.executable, str(Path(__file__).resolve()),
                   f"--ranks-for={phase}", f"--rank={r}",
                   f"--rank-port={port}", f"--seed={args.seed}"]
            env = None
        else:
            cmd = [sys.executable, "-m", module, *argv]
            env = dict(os.environ, COORDINATOR_ADDRESS=f"localhost:{port}",
                       NUM_PROCESSES=str(world), PROCESS_ID=str(r),
                       **(env_extra or {}))
        procs.append(subprocess.Popen(cmd, cwd=root, env=env,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    return procs


def _tp_wait(procs, what):
    """Every process's (stdout, stderr); fails on a non-zero exit or a
    hang, and stops every process it started."""
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=TP_RANK_TIMEOUT_S)
            if p.returncode != 0:
                raise AssertionError(f"{what}: rc {p.returncode}\n"
                                     f"{err[-3000:]}")
            outs.append((out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def _tp_gap(torch, kind, ranks, ref):
    """(b)'s parameter check of one arm: the 2-norm of every sampled
    element's gap to (a)'s plain final parameters over that of their
    movement from the start, and the largest element gap."""
    start, final = ref
    n = TP_SAMPLE[kind]
    gap = move = 0.0
    worst = 0.0
    for samples in ranks:
        for k, ((dim, lo, length), got) in samples.items():
            want, was = final[k], start[k]
            if dim >= 0:
                want = want.narrow(dim, lo, length)
                was = was.narrow(dim, lo, length)
            want, was = want[::n], was[::n]
            d = got.to(want.device).double() - want.double()
            gap += float((d ** 2).sum())
            move += float(((want.double() - was.double()) ** 2).sum())
            worst = max(worst, float(d.abs().max()))
    return math.sqrt(gap / move), worst


def check_tp(torch, np, args, smi):
    """Phase 27, tensor parallelism: returns (the kernels' launches over
    (a)'s line-of-one arms and (b)'s ranks, the flash timing rows)."""
    t_phase = time.perf_counter()
    shutil.rmtree(TP_DIR, ignore_errors=True)
    TP_DIR.mkdir(parents=True)
    rows = _tp_flash_rows(torch, args, smi)
    torch.cuda.empty_cache()
    launches = collections.Counter()
    refs = {}
    for kind in ("bert", "llama"):
        counts, plain, ref = _tp_line_of_one(torch, np, args, smi, kind)
        launches.update({k: v for k, v in counts.items()
                         if k in _tp_per_step(kind)})
        refs[kind] = (plain, ref)
    want_decode = _tp_decode_plain(torch, np, args)
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    ranks = _start_ranks(args, _free_port())
    entry = _start_ranks(
        args, _free_port(), env_extra={"DTTPU_DIST_BACKEND": "gloo"},
        module="distributed_tensorflow_tpu_torch.examples.finetune_bert")
    try:
        _tp_wait(ranks, "tp (b) ranks")
        ranks_s = time.perf_counter() - t0
        results = [json.loads((TP_DIR / f"rank{r}.json").read_text())
                   for r in range(2)]
        for name, kind, _ in TP_ARMS:
            plain, ref = refs[kind]
            per_rank = [res[name] for res in results]
            L = 12 if kind == "bert" else TP_LLAMA_LAYERS
            n_steps = TP_WARMUP + TP_STEPS
            want = {k: n * n_steps for k, n in tp_collectives(kind, L)
                    .items()}
            want.update(per_rank[0]["launches_expected"])
            for r, rec in enumerate(per_rank):
                _zoo_expect(f"tp (b) {name} rank {r}", rec["launches"],
                            want)
                launches.update({k: v for k, v in rec["launches"].items()
                                 if k in _tp_per_step(kind)})
            samples = [torch.load(TP_DIR / f"rank{r}_{name}.pt")
                       for r in range(2)]
            param_err, param_max = _tp_gap(torch, kind, samples, ref)
            losses = per_rank[0]["losses"]
            loss_err = max(abs(x - y) for x, y in zip(losses,
                                                      plain["losses"]))
            grad_err = (abs(per_rank[0]["grad_norm"] - plain["grad_norm"])
                        / plain["grad_norm"])
            peaks = [rec["peak_memory_gb"] for rec in per_rank]
            check = {"tp": f"(b) {name}", "ranks": 2,
                     "losses": [rec["losses"] for rec in per_rank],
                     "plain_losses": plain["losses"],
                     "loss_err": loss_err, "loss_tol": TP_LOSS_TOL,
                     "grad_norm_rel_err": grad_err, "grad_tol": TP_GRAD_TOL,
                     "param_gap_over_move": param_err,
                     "param_tol": TP_PARAM_TOL, "param_max_abs_err":
                     param_max, "peak_memory_gb": peaks,
                     "plain_peak_memory_gb": plain["peak_memory_gb"],
                     "step_ms": [rec["step_ms"] for rec in per_rank],
                     "collectives_a_step": {
                         k: per_rank[0]["launches"].get(k, 0) // n_steps
                         for k in tp_collectives(kind, L)},
                     "launches": per_rank[0]["launches"], "card": smi}
            log(check)
            if not (per_rank[0]["losses"] == per_rank[1]["losses"]
                    and loss_err <= TP_LOSS_TOL and grad_err <= TP_GRAD_TOL
                    and param_err <= TP_PARAM_TOL
                    and max(peaks) < plain["peak_memory_gb"]):
                raise AssertionError(f"tp (b) {name}: two ranks disagree "
                                     f"with the plain model: {check}")
        got = torch.load(TP_DIR / "rank0_decode.pt")
        errs = [float((g - w).abs().max()) for g, w in
                zip(got[:2], want_decode[:2])]
        same = torch.equal(got[2], want_decode[2])
        dec = results[0]["decode"]["launches"]
        L = TP_LLAMA_LAYERS
        # a forward: the embedding's sum and 2 sums a layer, one gather of
        # the logits; decode_block, decode_step, then generate's prefill
        # and TP_DECODE_NEW - 1 steps
        forwards = 2 + TP_DECODE_NEW
        want = {"tp_all_reduce": forwards * (1 + 2 * L),
                "tp_all_gather": forwards,
                "flash_forward": 2 * L, "rmsnorm": forwards * (2 * L + 1)}
        log({"tp": "(c) decode llama f32", "prompt": list(TP_DECODE_PROMPT),
             "new": TP_DECODE_NEW, "logit_max_abs_err": errs,
             "logit_tol": TP_DECODE_TOL, "tokens_equal": same,
             "launches": dec, "card": smi})
        _zoo_expect("tp (c) decode", dec, want)
        if not (same and max(errs) <= TP_DECODE_TOL):
            raise AssertionError("tp (c): decoding on two ranks disagrees "
                                 "with the plain model")
        outs = _tp_wait(entry, "tp (d) finetune_bert")
        entry_s = time.perf_counter() - t0
    finally:
        for p in ranks + entry:
            if p.poll() is None:
                p.kill()
                p.wait()
    accs = [_eval_acc(out) for out, _ in outs]
    meshes = ["mesh={'data': 1, 'tensor': 2}" in err for _, err in outs]
    log({"tp": "(d) finetune_bert on two ranks", "eval_accuracy": accs,
         "mesh_printed": meshes, "printed": outs[0][0].splitlines()[-2:],
         "seconds_with_b": entry_s, "ranks_seconds": ranks_s, "card": smi})
    if not all(meshes) or not all(a > 0.5 for a in accs) \
            or outs[0][0] != outs[1][0]:
        raise AssertionError(f"tp (d): finetune_bert {accs}, {meshes}")
    shutil.rmtree(TP_DIR, ignore_errors=True)
    log({"phase": "tp", "seconds": time.perf_counter() - t_phase,
         "launches": dict(launches)})
    return dict(launches), rows


# -- phase 28: pipeline parallelism -------------------------------------------
# (a) GPT-2 small at full width (bf16 compute over f32 weights, dropout 0,
# phase 6's batch of TRAIN_BATCH x TRAIN_SEQ, adamw(1e-4), clip 1.0) split
# into PP_STAGES stages of 6 layers over PP_MICRO microbatches of 6 rows.
# First the plain step in this process from ``--seed``'s weights on the
# batch; then two ranks on the one card, each a process of this script
# (``--ranks-for=pp``) over gloo with CUDA tensors, on ``{"pipe": 2}``: the
# same weights and batch through ``make_custom_train_step`` (GPipe: the
# pipelined ``lm_loss_fn``) and ``make_1f1b_train_step`` (1F1B), PP_WARMUP
# + PP_STEPS steps an arm.  Microbatching changes the GEMMs' row counts
# (and so cuBLAS's algorithms and roundings), not the arithmetic, so the
# losses agree with the plain arm to PP_LOSS_TOL, the first gradient norm
# to PP_GRAD_TOL (relative) and the parameters' gap to PP_PARAM_TOL of
# their movement (2-norms over every PP_SAMPLE-th row of the leaves a rank
# holds; phase 27's measure); GPipe and 1F1B run the same stage kernels on
# the same microbatches (the recompute replays them), so they agree to
# PP_SCHED_TOL (the head's GEMM over one microbatch or the whole batch
# differs).  Both ranks report the same loss; each rank's kernel launches
# are exact a step (``pp_per_step``), so are its exchanges, staged host
# copies and broadcasts (``pp_collectives``, worked out from the schedule);
# 1F1B's peak memory is below GPipe's on both ranks.  (b) ``python -m
# distributed_tensorflow_tpu_torch.examples.train_gpt --pipeline_stages=2``
# on two ranks of the card (``DTTPU_DIST_BACKEND=gloo``) with
# ``--pp_schedule=gpipe`` and ``=1f1b`` and ``--family=llama``, beside (a),
# at PP_ENTRY_STEPS[0] steps (cut from 200: the eval still beats the
# uniform loss), then the GPipe run again to PP_ENTRY_STEPS[1]: exit 0,
# ``mesh={'pipe': 2, 'data': 1}``, live and EMA eval losses below ln 256,
# the ``generated:`` line, a complete sharded checkpoint of both
# processes, and the rerun restored from it.  Before all of it the flash
# kernels are timed at a microbatch's shape beside their plain versions,
# SDPA and the bound.  Files under PP_DIR, removed at the phase's end.
PP_STAGES, PP_MICRO, PP_LAYERS = 2, 8, 12
# (1 + 3 until phase 29 needed the room)
PP_WARMUP, PP_STEPS = 1, 2
PP_LOSS_TOL, PP_GRAD_TOL, PP_PARAM_TOL, PP_SCHED_TOL = 1e-2, 5e-3, 0.1, 0.05
PP_SAMPLE = 8
PP_ENTRY_STEPS = (20, 24)
PP_RANK_TIMEOUT_S = 600
PP_DIR = Path("build") / "pp"


def _pp_ticks(schedule, M, S, s):
    """(ticks with an exchange, tensors sent and received) of stage ``s``
    in one pass of ``schedule``, from the schedule alone: GPipe forwards
    microbatch m at tick m + s and backwards it in the reverse pass at
    tick (M - 1 - m) + (S - 1 - s); 1F1B forwards it at tick m + s and
    backwards it at tick m + 2(S - 1) - s; an output leaves at the tick
    after its compute, an input arrives at its compute's tick."""
    first, last = s == 0, s == S - 1

    def run(lo, on):
        return set(range(lo, lo + M)) if on else set()
    if schedule == "gpipe":
        fwd = run(s, not first) | run(s + 1, not last)
        back = run(S - 1 - s, not last) | run(S - s, not first)
        return len(fwd) + len(back), 2 * M * (2 - first - last)
    ticks = (run(s, not first) | run(s + 1, not last)
             | run(2 * S - 2 - s, not last) | run(2 * S - 1 - s, not first))
    return len(ticks), 2 * M * (2 - first - last)


def pp_collectives(schedule, M, S, s):
    """Rank ``s``'s collectives a step: its ``batch_isend_irecv`` calls
    (``p2p``) and staged host copies (``p2p_host``, gloo with CUDA
    tensors) from ``_pp_ticks``; three broadcasts over the line (the
    activation dtype; GPipe: the output and ``dx``; 1F1B: the loss with
    the head's gradients, and ``dx``); one stats all-reduce for the clip's
    norm over the line; no data-line all-reduce on a data line of one."""
    p2p, host = _pp_ticks(schedule, M, S, s)
    return {"p2p": p2p, "p2p_host": host, "broadcast": 3,
            "stats_all_reduce": 1, "all_reduce": 0}


def pp_per_step(schedule, s, S=PP_STAGES, M=PP_MICRO, L=PP_LAYERS):
    """Each training kernel's launches a step on rank ``s`` (GPT-2: 16
    leaves a layer).  A stage forwards each microbatch once (GPipe; 1F1B's
    last stage, in its backward sub-tick) or twice (1F1B's other stages:
    forward and recompute); LayerNorm 2 a layer a forward, plus ``ln_f``
    once on the whole batch (GPipe, every rank) or once a microbatch
    (1F1B's last stage); Adam on the stage's leaves and the embeddings'
    and ``ln_f``'s."""
    per = L // S
    forwards = M if schedule == "gpipe" or s == S - 1 else 2 * M
    ln_f = 1 if schedule == "gpipe" else (M if s == S - 1 else 0)
    return {"flash_forward": per * forwards, "flash_backward_dkv": per * M,
            "flash_backward_dq": per * M,
            "layernorm": 2 * per * forwards + ln_f,
            "fused_adam": 16 * per + 4}


def _pp_counts(torch):
    from distributed_tensorflow_tpu_torch.parallel import pipeline
    counts = _tp_counts(torch)
    counts.update(pipeline.LAUNCHES)
    return counts


def _pp_model(torch, np, seed, mesh):
    """(model, params, batch) of (a): GPT-2 small from ``seed``'s weights,
    pipelined over ``mesh`` (None: the plain model)."""
    from distributed_tensorflow_tpu_torch import GPT, gpt_small
    kw = {} if mesh is None else dict(pipeline_stages=PP_STAGES,
                                      pipeline_microbatches=PP_MICRO)
    config = gpt_small(dtype=torch.bfloat16, dropout_rate=0.0, **kw)
    model = GPT(config, device="cuda", mesh=mesh,
                generator=torch.Generator("cuda").manual_seed(seed))
    batch = _train_batch(torch, np, seed, TRAIN_BATCH, TRAIN_SEQ,
                         config.vocab_size, "cuda")
    return model, dict(model.named_parameters()), batch


def _pp_arm(torch, np, seed, schedule, mesh, keep_start=False):
    """One arm of (a): (record, its parameters after the steps, with
    ``keep_start`` every PP_SAMPLE-th row of them before the steps).  The
    record's peak memory is the arm's own (less what was allocated before
    it began and the sample)."""
    from distributed_tensorflow_tpu_torch import (TrainState, adamw,
                                                  make_custom_train_step,
                                                  train)
    base = torch.cuda.memory_allocated()
    model, params, batch = _pp_model(torch, np, seed, mesh)
    start = ({k: _tp_sample(p, PP_SAMPLE) for k, p in params.items()}
             if keep_start else None)
    opt = adamw(TRAIN_LR)
    state = TrainState.create(params, opt.init(params))
    if mesh is None:
        step = make_custom_train_step(model.lm_loss_fn(), opt, seed=seed,
                                      grad_clip_norm=1.0)
    else:
        state = train.shard_train_state(state, mesh,
                                        model.partition_rules())
        step = (train.make_1f1b_train_step(model, opt, seed=seed,
                                           grad_clip_norm=1.0)
                if schedule == "1f1b" else
                make_custom_train_step(model.lm_loss_fn(), opt, seed=seed,
                                       mesh=mesh, grad_clip_norm=1.0))
    (losses, grad_norm, wall, peak), _, counts = _driven(
        torch, lambda: _sp_steps(torch, np, step, state, batch, PP_WARMUP,
                                 PP_STEPS), _pp_counts)
    step_ms = wall / PP_STEPS * 1e3
    rec = {"losses": losses, "grad_norm": grad_norm, "step_ms": step_ms,
           "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / (step_ms / 1e3),
           "peak_memory_gb": peak - base / 1e9, "launches": counts}
    del state, step, batch, model
    return rec, params, start


def pp_rank_main(args) -> int:
    """One rank of (a), a process of this script: GPipe, then 1F1B on
    ``{"pipe": 2}`` over gloo; results to PP_DIR (``rank<r>.json``,
    ``rank<r>_<arm>.pt``: every PP_SAMPLE-th row of each leaf it holds)."""
    import datetime

    import numpy as np
    import torch
    import torch.distributed as dist

    from distributed_tensorflow_tpu_torch import parallel
    r = args.rank
    torch.cuda.set_device(0)
    dist.init_process_group(
        "gloo", init_method=f"tcp://localhost:{args.rank_port}",
        world_size=2, rank=r,
        timeout=datetime.timedelta(seconds=PP_RANK_TIMEOUT_S))
    try:
        mesh = parallel.make_mesh({"pipe": PP_STAGES})
        out = {}
        for schedule in ("gpipe", "1f1b"):
            gc.collect()
            torch.cuda.empty_cache()
            rec, params, _ = _pp_arm(torch, np, args.seed, schedule, mesh)
            torch.save({k: _tp_sample(p, PP_SAMPLE)
                        for k, p in params.items()},
                       PP_DIR / f"rank{r}_{schedule}.pt")
            out[schedule] = rec
            del params
        (PP_DIR / f"rank{r}.json").write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()
    return 0


def _pp_gap(torch, ranks, final, start):
    """The 2-norm of the sampled elements' gap to ``final`` over that of
    ``final``'s movement from ``start`` (both whole-model samples, the
    ranks' leaves joined), and the largest element gap."""
    gap = move = worst = 0.0
    for samples in ranks:
        for k, got in samples.items():
            want, was = final[k], start[k]
            d = got.to(want.device).double() - want.double()
            gap += float((d ** 2).sum())
            move += float(((want.double() - was.double()) ** 2).sum())
            worst = max(worst, float(d.abs().max()))
    return math.sqrt(gap / move), worst


def _pp_entry_check(name, outs, log_dir, resumed=None):
    """(b)'s checks of one two-rank run of ``train_gpt``: the mesh line,
    eval losses below ln 256 (live and EMA), ``generated:``, a complete
    sharded checkpoint of both processes, and with ``resumed`` the restore
    line.  Returns (live, ema) eval losses of rank 0."""
    from distributed_tensorflow_tpu_torch.train import sharded_checkpoint
    evals = []
    for out, err in outs:
        line = [x for x in out.splitlines() if x.startswith("eval loss:")]
        if len(line) != 1 or "generated:" not in out \
                or "mesh={'pipe': 2, 'data': 1}" not in err:
            raise AssertionError(f"pp (b) {name}: missing lines\n{out}\n"
                                 f"{err[-2000:]}")
        live = float(line[0].split("live=")[1].split()[0])
        ema = float(line[0].split("ema=")[1].split()[0])
        evals.append((live, ema))
        if resumed is not None and (f"Restored checkpoint ckpt-"
                                    f"{resumed:010d}") not in out:
            raise AssertionError(f"pp (b) {name}: not restored from step "
                                 f"{resumed}\n{out}")
    uniform = math.log(256)
    path = sharded_checkpoint.all_sharded_checkpoints(str(log_dir))
    ok = bool(path) and sharded_checkpoint.verify_sharded(path[-1]) == (
        True, "") and json.loads((Path(path[-1]) / "manifest.json")
                                 .read_text())["process_count"] == 2
    if not ok or not all(x < uniform and y < uniform for x, y in evals) \
            or evals[0] != evals[1]:
        raise AssertionError(f"pp (b) {name}: evals {evals}, checkpoint "
                             f"{path}")
    return evals[0], Path(path[-1]).name


def check_pp(torch, np, args, smi):
    """Phase 28, pipeline parallelism: returns (the kernels' launches over
    (a)'s ranks, the flash timing rows at a microbatch's shape)."""
    from distributed_tensorflow_tpu_torch.ops.kernels import \
        flash_attention as fa
    t_phase = time.perf_counter()
    shutil.rmtree(PP_DIR, ignore_errors=True)
    PP_DIR.mkdir(parents=True)
    mb = TRAIN_BATCH // PP_MICRO
    label = f"gpt2 pp microbatch {mb}x{TRAIN_SEQ}"
    rows = {label: _zoo_flash_case(
        torch, fa, torch.Generator("cuda").manual_seed(args.seed), label,
        mb, TRAIN_SEQ, 12, 64, torch.bfloat16, None, args.iters,
        causal=True)}
    for recs in rows.values():
        for rec in recs.values():
            rec["card"] = smi
    gc.collect()
    torch.cuda.empty_cache()
    plain, params, start = _pp_arm(torch, np, args.seed, "plain", None,
                                   keep_start=True)
    final = {k: _tp_sample(p, PP_SAMPLE) for k, p in params.items()}
    del params
    gc.collect()
    torch.cuda.empty_cache()
    _zoo_expect("pp plain arm", plain["launches"],
                {"flash_forward": 12 * (PP_WARMUP + PP_STEPS)})
    log({"pp": "(a) plain gpt2-small", "steps": PP_STEPS,
         **{k: plain[k] for k in ("losses", "grad_norm", "step_ms",
                                  "tokens_per_s", "peak_memory_gb")},
         "card": smi})

    t0 = time.perf_counter()
    ranks = _start_ranks(args, _free_port(), phase="pp")
    env = {"DTTPU_DIST_BACKEND": "gloo"}
    module = "distributed_tensorflow_tpu_torch.examples.train_gpt"
    first, second = PP_ENTRY_STEPS
    entries = {}
    for name, extra in (("gpipe", ["--pp_schedule=gpipe"]),
                        ("1f1b", ["--pp_schedule=1f1b"]),
                        ("llama", ["--family=llama"])):
        log_dir = PP_DIR / f"entry_{name}"
        argv = [f"--log_dir={log_dir}", f"--steps={first}",
                "--pipeline_stages=2", *extra]
        entries[name] = (log_dir, argv, _start_ranks(
            args, _free_port(), env_extra=env, module=module, argv=argv))
    launches = collections.Counter()
    try:
        _tp_wait(ranks, "pp (a) ranks")
        ranks_s = time.perf_counter() - t0
        results = [json.loads((PP_DIR / f"rank{r}.json").read_text())
                   for r in range(2)]
        n_steps = PP_WARMUP + PP_STEPS
        peaks = {}
        for schedule in ("gpipe", "1f1b"):
            per_rank = [res[schedule] for res in results]
            for r, rec in enumerate(per_rank):
                want = {k: n * n_steps for k, n in
                        pp_per_step(schedule, r).items()}
                want.update({k: n * n_steps for k, n in pp_collectives(
                    schedule, PP_MICRO, PP_STAGES, r).items()})
                _zoo_expect(f"pp (a) {schedule} rank {r}", rec["launches"],
                            want)
                launches.update({k: v for k, v in rec["launches"].items()
                                 if k in pp_per_step(schedule, r)})
            samples = [torch.load(PP_DIR / f"rank{r}_{schedule}.pt")
                       for r in range(2)]
            param_err, param_max = _pp_gap(torch, samples, final, start)
            losses = per_rank[0]["losses"]
            loss_err = max(abs(x - y) for x, y in zip(losses,
                                                      plain["losses"]))
            grad_err = (abs(per_rank[0]["grad_norm"] - plain["grad_norm"])
                        / plain["grad_norm"])
            peaks[schedule] = [rec["peak_memory_gb"] for rec in per_rank]
            check = {"pp": f"(a) {schedule}", "ranks": PP_STAGES,
                     "microbatches": PP_MICRO,
                     "losses": [rec["losses"] for rec in per_rank],
                     "plain_losses": plain["losses"],
                     "loss_err": loss_err, "loss_tol": PP_LOSS_TOL,
                     "grad_norm_rel_err": grad_err, "grad_tol": PP_GRAD_TOL,
                     "param_gap_over_move": param_err,
                     "param_tol": PP_PARAM_TOL,
                     "param_max_abs_err": param_max,
                     "peak_memory_gb": peaks[schedule],
                     "plain_peak_memory_gb": plain["peak_memory_gb"],
                     "step_ms": [rec["step_ms"] for rec in per_rank],
                     "plain_step_ms": plain["step_ms"],
                     "collectives_a_step": [
                         {k: rec["launches"].get(k, 0) // n_steps
                          for k in pp_collectives(schedule, PP_MICRO,
                                                  PP_STAGES, r)}
                         for r, rec in enumerate(per_rank)],
                     "launches": [rec["launches"] for rec in per_rank],
                     "card": smi}
            log(check)
            if not (per_rank[0]["losses"] == per_rank[1]["losses"]
                    and loss_err <= PP_LOSS_TOL and grad_err <= PP_GRAD_TOL
                    and param_err <= PP_PARAM_TOL):
                raise AssertionError(f"pp (a) {schedule}: two stages "
                                     f"disagree with the plain step: {check}")
        g, f = (results[0]["gpipe"], results[0]["1f1b"])
        sched_loss = max(abs(x - y) for x, y in zip(g["losses"],
                                                    f["losses"]))
        gs = [torch.load(PP_DIR / f"rank{r}_gpipe.pt") for r in range(2)]
        fs = [torch.load(PP_DIR / f"rank{r}_1f1b.pt") for r in range(2)]
        joined = {k: v for part in gs for k, v in part.items()}
        sched_gap, _ = _pp_gap(torch, fs, joined, start)
        ratio = [b / a for a, b in zip(peaks["gpipe"], peaks["1f1b"])]
        log({"pp": "(a) gpipe vs 1f1b", "loss_max_abs_diff": sched_loss,
             "param_gap_over_move": sched_gap, "tol": PP_SCHED_TOL,
             "peak_1f1b_over_gpipe": ratio,
             "grad_norm": [g["grad_norm"], f["grad_norm"]],
             "stashed_inputs_at_most": min(PP_MICRO, 2 * PP_STAGES - 1),
             "card": smi})
        if not (sched_loss <= PP_SCHED_TOL and sched_gap <= PP_SCHED_TOL
                and all(x < 1.0 for x in ratio)):
            raise AssertionError(f"pp (a): 1F1B against GPipe: loss "
                                 f"{sched_loss}, gap {sched_gap}, peak "
                                 f"ratio {ratio}")
        ran = {}
        for name, (log_dir, argv, procs) in entries.items():
            outs = _tp_wait(procs, f"pp (b) train_gpt {name}")
            ran[name] = _pp_entry_check(name, outs, log_dir)
        log_dir, argv, _ = entries["gpipe"]
        again = [a if not a.startswith("--steps=") else f"--steps={second}"
                 for a in argv]
        outs = _tp_wait(_start_ranks(args, _free_port(), env_extra=env,
                                     module=module, argv=again),
                        "pp (b) train_gpt resume")
        ran["gpipe resumed"] = _pp_entry_check("resume", outs, log_dir,
                                               resumed=first)
        entry_s = time.perf_counter() - t0
    finally:
        for procs in [ranks] + [e[2] for e in entries.values()]:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    log({"pp": "(b) train_gpt --pipeline_stages=2 on two ranks",
         "runs": {k: {"eval_live_ema": v[0], "checkpoint": v[1]}
                  for k, v in ran.items()},
         "uniform": math.log(256), "steps": list(PP_ENTRY_STEPS),
         "ranks_seconds": ranks_s, "seconds_with_a": entry_s, "card": smi})
    shutil.rmtree(PP_DIR, ignore_errors=True)
    log({"phase": "pp", "seconds": time.perf_counter() - t_phase,
         "launches": dict(launches)})
    return dict(launches), rows


# -- phase 29: the expert axis and the vision zoo on a mesh -------------------
# (c) first, on a quiet card: the flash kernels at ViT-B/16's rank heads
# ([64, 197, 6 of 12 heads, 64] bf16, bidirectional), forward and whole
# backward against their plain versions, timed beside them, SDPA and the
# bound (a ``tp_shapes`` row).  Then two ranks of this script
# (``--ranks-for=ep``) start on the one card over gloo with CUDA tensors
# (NCCL refuses two ranks on one device) and run (b) while this process
# runs (a), the one-rank arms (b) is held to.  (a) A line of one at full
# width: bench_gpt_moe's MoE GPT (phase 23 (b)'s config: GPT-2 small, 8
# experts, top-2, remat "full") in f32 ("moe") and in the row's bf16
# ("moe_bf16") on ``{"expert": 1}`` at EP_MOE_BATCH rows of FAM_SEQ,
# ViT-B/16 at 224 on ``{"tensor": 1}`` at EP_VIT_BATCH images (bf16,
# ``adamw(1e-4)``, clip 1.0), and ResNet-50 at 224 without a mesh at
# EP_RESNET_BATCH images (phase 22 (f)'s ``momentum(0.1, 0.9)``, clip
# 1.0, in f32 with TF32 off), EP_WARMUP + EP_STEPS steps an arm from
# ``--seed``'s weights on one batch, the MoE's router jitter on: the
# launches a step exactly phase 23 (b)'s and phase 22 (d)'s
# (``moe_per_step``, ``vit_per_step``), no collective.  (a)'s step times
# share the card with (b)'s ranks.  (b) The same models from the same
# weights and batches on two ranks: the MoE GPTs on ``{"expert": 2}`` (4
# experts a rank), ViT-B/16 and ResNet-50 on ``{"tensor": 2}``.  Neither
# mesh has more than one replica, so the step folds no replica into its
# generator and the ranks draw (a)'s jitter.  Both ranks' losses equal at
# every step; within the arm's EP_LIMITS of (a)'s: the first ``losses``
# losses, the first gradient norm (relative) and the parameters' gap
# after the first step over their movement (2-norms over every
# EP_SAMPLE-th element of the blocks a rank holds; phase 27's measure;
# None: logged, not held); each rank's kernel launches and the lines'
# collectives exact a step (``ep_collectives``).
#
# Why the first step: the ranks sum in another order than one card (an
# expert line adds its ranks' partial outputs; a cuDNN convolution's
# order changes with its output channel count), and the steps after the
# first amplify that rounding by the model's own sensitivity, not by the
# cut: a token whose top-2 choice sits within it routes elsewhere, and
# the capacity's drops follow; 53 convolutions and norms at momentum 0.1
# magnify it.  Adam's first step moves an element by about lr whatever
# its gradient, so one whose gradient rounds across zero moves the other
# way: that sets the gap after one step.  The bf16 MoE's partial outputs
# round to bf16 before the line's f32 sum, where one card sums its
# experts' bf16 products in one einsum: a token's routing flips already
# in the first forward (``moe_aux`` apart by 1.9e-5 to 2.4e-4 at the
# first step), so its arm holds the first loss and gradient norm, and
# logs the gap (0.53 to 0.57 of the movement).  ``--ep-seeds 0,1,2,3``
# read at these batches (H100 80GB HBM3, 700 W; PERF.md, PR 22), the
# largest of the four seeds: MoE f32 loss 2.9e-6, gradient norm 3.5e-7,
# gap 1.35e-5 (its third loss, unchecked, once 1.75e-3 apart where
# ``moe_aux`` moved by 1.6e-4: a flip); MoE bf16 first loss 5.7e-3,
# gradient norm 0.0125; ViT 1.2e-4, 6.2e-5, 0.041; ResNet-50 4.6e-3,
# 5.5e-4, 0.027.  The limits are about 10x those, the gaps' 11x, 2.4x
# and 3.7x (ViT: Adam's first step moves a flipped element by 2 lr;
# ResNet-50 under momentum: on the CPU a 1e-7 change of the plain
# ``resnet_cifar``'s input moves its first step about as far as the cut
# does, so the gap reads the model's sensitivity).
# The batches are cut from the bench rows' (48 x 256, 64 and 256
# images); the widths are not cut.  Files under EP_DIR, removed at the
# phase's end.  The ranks' step times measure gloo's copies through the
# host, not a parallel speed.
EP_MOE_BATCH, EP_VIT_BATCH, EP_RESNET_BATCH = 4, 8, 8
EP_WARMUP, EP_STEPS = 1, 2
# each arm's limits: losses checked, loss (absolute), gradient norm
# (relative), parameter gap over movement
EP_LIMITS = {
    "moe": {"losses": 2, "loss": 3e-5, "grad": 4e-6, "param": 1.5e-4},
    "moe_bf16": {"losses": 1, "loss": 6e-2, "grad": 0.13, "param": None},
    "vit": {"losses": 2, "loss": 1.2e-3, "grad": 6e-4, "param": 0.1},
    "resnet": {"losses": 2, "loss": 5e-2, "grad": 5e-3, "param": 0.1}}
EP_SAMPLE = {"moe": 16, "moe_bf16": 16, "vit": 8, "resnet": 4}
# (b)'s arms: (name, kind, mesh axes)
EP_ARMS = (("moe", "moe", {"expert": 2}),
           ("moe_bf16", "moe_bf16", {"expert": 2}),
           ("vit", "vit", {"tensor": 2}),
           ("resnet", "resnet", {"tensor": 2}))
EP_RANK_TIMEOUT_S = 600
EP_DIR = Path("build") / "ep"


def ep_collectives(kind):
    """The collectives of one training step of (b)'s arm ``kind`` on a
    line of 2 (no data line, so no gradient all-reduce and no sum of a
    batch statistic, ``batch_all_reduce``: a data line of D adds 1 a MoE
    layer forward, 1 again in its recomputation and 1 backward, 2 a
    ResNet norm; the clip's norm one stats all-reduce).  MoE on the expert line: per layer the output's
    sum forward, again in the recomputation, and the tokens' and gates'
    gradient sum backward.  ViT on the tensor line: forward the patch
    embedding's gather, the attention output's and the FFN's sums a
    layer, the cross entropy's two all-reduces and the argmax's gather;
    backward the column-parallel inputs' gradient sums (2 a layer, the
    patch convolution's and the head's).  ResNet-50 on the tensor line:
    a gather of each of its 53 convolutions' outputs and one of their
    norms' moving moments, one of the logits; a gradient sum of each
    convolution's input (with its norm's gamma and beta) and the
    head's."""
    none = {"all_reduce": 0, "batch_all_reduce": 0}
    if kind.startswith("moe"):
        return {"ep_all_reduce": 3 * 12, "stats_all_reduce": 1,
                "tp_all_reduce": 0, "tp_all_gather": 0, **none}
    if kind == "vit":
        L = 12
        return {"tp_all_reduce": 2 * L + 2 + 2 * L + 2,
                "tp_all_gather": 2, "stats_all_reduce": 1,
                "ep_all_reduce": 0, **none}
    convs = 1 + 16 * 3 + 4
    return {"tp_all_gather": 2 * convs + 1, "tp_all_reduce": convs + 1,
            "stats_all_reduce": 1, "ep_all_reduce": 0, **none}


def _ep_per_step(kind):
    """(a)'s and (b)'s training kernels a step (every rank's the same)."""
    if kind.startswith("moe"):
        return moe_per_step(12)
    if kind == "vit":
        return vit_per_step(12)
    # ResNet-50: cuDNN's convolutions and the momentum update, no kernel
    return dict.fromkeys(("flash_forward", "flash_backward_dkv",
                          "flash_backward_dq", "layernorm", "fused_adam"),
                         0)


def _ep_counts(torch):
    from distributed_tensorflow_tpu_torch.parallel import data_parallel
    counts = _train_counts(torch)
    counts.update(data_parallel.LAUNCHES)
    return counts


def _ep_build(torch, np, seed, kind, mesh):
    """(params, state, step, batch) of one arm of (a) or (b) from
    ``seed``'s weights and batch, on ``mesh`` (None: no mesh); under a
    mesh the state placed by ``shard_train_state``."""
    from distributed_tensorflow_tpu_torch import (GPT, TrainState, adamw,
                                                  make_custom_train_step,
                                                  optim, train)
    from distributed_tensorflow_tpu_torch.models import resnet, vit
    gen = torch.Generator("cuda").manual_seed(seed)
    rng = np.random.default_rng(seed)
    model_state = ()
    if kind.startswith("moe"):
        config = moe_config(torch)
        if kind == "moe":
            config = dataclasses.replace(config, dtype=torch.float32)
        model = GPT(config, device="cuda", generator=gen, mesh=mesh)
        params = dict(model.named_parameters())
        opt, rules = adamw(TRAIN_LR), model.partition_rules()
        step = make_custom_train_step(model.lm_loss_fn(), opt, seed=seed,
                                      mesh=mesh, grad_clip_norm=1.0)
        batch = _train_batch(torch, np, seed, EP_MOE_BATCH, FAM_SEQ,
                             config.vocab_size, "cuda")
    elif kind == "vit":
        model = vit.ViT(vit.ViTConfig(dtype=torch.bfloat16), mesh)
        params = model.init(gen)
        opt, rules = adamw(ZOO_LR, mask=model.decay_mask), \
            model.partition_rules()
        step = make_custom_train_step(model.loss_fn(), opt, seed=seed,
                                      mesh=mesh, grad_clip_norm=1.0)
        b = EP_VIT_BATCH
        batch = (torch.from_numpy(rng.random((b, 224, 224, 3), np.float32))
                 .cuda(), torch.from_numpy(rng.integers(0, 1000, b)).cuda())
    else:
        model = resnet.resnet50(num_classes=1000, mesh=mesh)
        params, model_state = model.init(gen, (224, 224, 3))
        opt, rules = optim.momentum(0.1, beta=0.9), \
            resnet.ResNet.partition_rules()
        step = train.make_train_step(
            model, "sparse_categorical_crossentropy", opt, seed=seed,
            mesh=mesh, grad_clip_norm=1.0)
        b = EP_RESNET_BATCH
        batch = (torch.from_numpy(rng.random((b, 224, 224, 3), np.float32))
                 .cuda(), torch.from_numpy(rng.integers(0, 1000, b)).cuda())
    state = TrainState.create(params, opt.init(params), model_state)
    if mesh is not None:
        state = train.shard_train_state(state, mesh, rules)
    return params, state, step, batch


@contextlib.contextmanager
def _no_tf32(torch):
    """cuDNN's convolutions and cuBLAS's f32 products in full f32 within
    the block."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def _ep_arm(torch, np, seed, kind, mesh, first, start=None):
    """One arm's run: its record (with the MoE's ``moe_aux`` a step,
    which moves by about E (P_a - P_b) / tokens when a token's first
    choice flips from expert b to a, and by rounding otherwise).
    ``first(params)`` runs on the parameters after the first step;
    ``start``, when given, is filled with a copy of them before it.
    ResNet's convolutions run without TF32."""
    params, state, step, batch = _ep_build(torch, np, seed, kind, mesh)
    if start is not None:
        start.update({k: p.detach().clone() for k, p in params.items()})
    aux = []

    def stepped(state, batch):
        state, m = step(state, batch)
        if "moe_aux" in m:
            aux.append(m["moe_aux"])
        return state, m
    with (_no_tf32(torch) if kind == "resnet"
          else contextlib.nullcontext()):
        (losses, grad_norm, wall, peak), _, counts = _driven(
            torch, lambda: _sp_steps(torch, np, stepped, state, batch,
                                     EP_WARMUP, EP_STEPS,
                                     lambda: first(params)), _ep_counts)
    n_steps = EP_WARMUP + EP_STEPS
    rec = {"losses": losses, "grad_norm": grad_norm,
           "moe_aux": [float(a) for a in aux],
           "step_ms": wall / EP_STEPS * 1e3, "peak_memory_gb": peak,
           "batch": (batch["input_ids"] if kind.startswith("moe")
                     else batch[0]).shape[0],
           "launches": counts,
           "launches_expected": {k: n * n_steps for k, n in
                                 _ep_per_step(kind).items()}}
    del params, state, step, batch
    return rec


def _ep_sample(t, box, n):
    """Every n-th element of ``t``'s block ``box`` ((start, length) a
    dim; None: ``t`` is the block), flat, on the card."""
    t = t.detach()
    if box is not None:
        for d, (lo, length) in enumerate(box):
            t = t.narrow(d, lo, length)
    return t.contiguous().reshape(-1)[::n].float()


def ep_rank_main(args) -> int:
    """One rank of (b), a process of this script: the arms of EP_ARMS
    over gloo, results to EP_DIR (``rank<r>.json``,
    ``rank<r>_<arm>.pt``: each leaf's box and its sample)."""
    import datetime

    import numpy as np
    import torch
    import torch.distributed as dist

    from distributed_tensorflow_tpu_torch import parallel
    from distributed_tensorflow_tpu_torch.parallel import sharding
    r = args.rank
    torch.cuda.set_device(0)
    dist.init_process_group(
        "gloo", init_method=f"tcp://localhost:{args.rank_port}",
        world_size=2, rank=r,
        timeout=datetime.timedelta(seconds=EP_RANK_TIMEOUT_S))
    try:
        out = {}
        for name, kind, axes in EP_ARMS:
            gc.collect()
            torch.cuda.empty_cache()
            mesh = parallel.make_mesh(axes)
            samples = {}

            def first(params, kind=kind, samples=samples):
                for k, p in params.items():
                    s = sharding.marked_shard(p)
                    box = [(0, n) for n in p.shape]
                    for part in (() if s is None else s.parts):
                        box[part.dim] = (part.start, part.length)
                    samples[k] = (box, _ep_sample(p, None, EP_SAMPLE[kind])
                                  .to("cpu", copy=True))
            out[name] = _ep_arm(torch, np, args.seed, kind, mesh, first)
            torch.save(samples, EP_DIR / f"rank{r}_{name}.pt")
        (EP_DIR / f"rank{r}.json").write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()
    return 0


def _ep_gap(n, ranks, start, final):
    """(b)'s parameter check of one arm: the 2-norm of every sampled
    element (every ``n``-th of a block) gap to (a)'s parameters after the
    first step over that of their movement from the start, and the
    largest element gap."""
    gap = move = worst = 0.0
    for samples in ranks:
        for k, (box, got) in samples.items():
            want = _ep_sample(final[k], box, n).double()
            was = _ep_sample(start[k], box, n).double()
            d = got.to(want.device).double() - want
            gap += float((d ** 2).sum())
            move += float(((want - was) ** 2).sum())
            worst = max(worst, float(d.abs().max()))
    return math.sqrt(gap / move), worst


def _ep_flash_rows(torch, args, smi):
    """(c): the flash kernels at ViT-B/16's rank heads."""
    from distributed_tensorflow_tpu_torch.ops.kernels import \
        flash_attention as fa
    label = "vit_b16 tp2"
    rows = {label: _zoo_flash_case(
        torch, fa, torch.Generator("cuda").manual_seed(args.seed), label,
        ZOO_VIT_BATCH, 197, 6, 64, torch.bfloat16, None, args.iters)}
    for recs in rows.values():
        for rec in recs.values():
            rec["card"] = smi
    return rows


def check_ep(torch, np, args, smi, flash=True):
    """Phase 29, the expert axis and the vision zoo on a mesh: returns
    (the kernels' launches over (a)'s arms and (b)'s ranks, the flash
    timing rows at ViT-B/16's rank heads; none without ``flash``)."""
    from distributed_tensorflow_tpu_torch import parallel
    t_phase = time.perf_counter()
    shutil.rmtree(EP_DIR, ignore_errors=True)
    EP_DIR.mkdir(parents=True)
    rows = _ep_flash_rows(torch, args, smi) if flash else {}
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = _start_ranks(args, _free_port(), phase="ep")
    launches = collections.Counter()
    try:
        refs = {}
        for name, kind, axes in EP_ARMS:
            gc.collect()
            torch.cuda.empty_cache()
            one = {a: 1 for a in axes}
            mesh = None if kind == "resnet" else parallel.make_mesh(one)
            start, after = {}, {}

            def first(params, after=after):
                after.update({k: p.detach().clone()
                              for k, p in params.items()})
            rec = _ep_arm(torch, np, args.seed, kind, mesh, first, start)
            log({"ep": f"(a) {name}", "mesh": one if mesh else None,
                 "steps": EP_STEPS, **rec, "card": smi})
            _zoo_expect(f"ep (a) {name}", rec["launches"],
                        rec["launches_expected"])
            extra = {k: v for k, v in rec["launches"].items()
                     if k not in rec["launches_expected"] and v}
            if extra:
                raise AssertionError(f"ep (a) {name}: collectives on a "
                                     f"line of one: {extra}")
            launches.update({k: v for k, v in rec["launches"].items()
                             if k in rec["launches_expected"]})
            refs[name] = (rec, start, after)
        _tp_wait(ranks, "ep (b) ranks")
        ranks_s = time.perf_counter() - t0
        results = [json.loads((EP_DIR / f"rank{r}.json").read_text())
                   for r in range(2)]
        n_steps = EP_WARMUP + EP_STEPS
        failed = []
        for name, kind, axes in EP_ARMS:
            plain, start, final = refs[name]
            per_rank = [res[name] for res in results]
            want = {k: n * n_steps for k, n in ep_collectives(kind).items()}
            want.update(per_rank[0]["launches_expected"])
            for r, rec in enumerate(per_rank):
                _zoo_expect(f"ep (b) {name} rank {r}", rec["launches"], want)
                launches.update({k: v for k, v in rec["launches"].items()
                                 if k in _ep_per_step(kind)})
            samples = [torch.load(EP_DIR / f"rank{r}_{name}.pt")
                       for r in range(2)]
            param_err, param_max = _ep_gap(EP_SAMPLE[kind], samples, start,
                                           final)
            lim = EP_LIMITS[kind]
            # the first losses: each reads at most one update
            loss_err = max(abs(x - y) for x, y in
                           zip(per_rank[0]["losses"][:lim["losses"]],
                               plain["losses"]))
            grad_err = (abs(per_rank[0]["grad_norm"] - plain["grad_norm"])
                        / plain["grad_norm"])
            check = {"ep": f"(b) {name}", "mesh": axes, "ranks": 2,
                     "batch": plain["batch"],
                     "losses": [rec["losses"] for rec in per_rank],
                     "plain_losses": plain["losses"],
                     "moe_aux": [rec["moe_aux"] for rec in per_rank],
                     "plain_moe_aux": plain["moe_aux"],
                     "losses_checked": lim["losses"],
                     "loss_err": loss_err, "loss_tol": lim["loss"],
                     "grad_norm_rel_err": grad_err, "grad_tol": lim["grad"],
                     "param_gap_over_move": param_err,
                     "param_tol": lim["param"],
                     "param_max_abs_err": param_max,
                     "peak_memory_gb": [rec["peak_memory_gb"]
                                        for rec in per_rank],
                     "plain_peak_memory_gb": plain["peak_memory_gb"],
                     "step_ms": [rec["step_ms"] for rec in per_rank],
                     "plain_step_ms": plain["step_ms"],
                     "collectives_a_step": {
                         k: per_rank[0]["launches"].get(k, 0) // n_steps
                         for k in ep_collectives(kind)},
                     "launches": per_rank[0]["launches"], "card": smi}
            log(check)
            if not (per_rank[0]["losses"] == per_rank[1]["losses"]
                    and loss_err <= lim["loss"] and grad_err <= lim["grad"]
                    and (lim["param"] is None
                         or param_err <= lim["param"])):
                failed.append(name)
        # every arm checked and logged before the first failure raises
        if failed:
            raise AssertionError(f"ep (b) {failed}: two ranks disagree "
                                 f"with the one-rank model (logged above)")
    finally:
        for p in ranks:
            if p.poll() is None:
                p.kill()
                p.wait()
    del refs
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(EP_DIR, ignore_errors=True)
    log({"phase": "ep", "seconds": time.perf_counter() - t_phase,
         "ranks_seconds": ranks_s, "launches": dict(launches)})
    return dict(launches), rows


def ep_spread(torch, np, args, smi) -> int:
    """``--ep-seeds``: phase 29's (a) and (b) once for each seed, every
    arm's check logged, a seed that fails a limit logged and passed over
    (the spread EP_LIMITS are set from); 1 when any seed failed."""
    failed = []
    for seed in [int(x) for x in args.ep_seeds.split(",")]:
        args.seed = seed
        try:
            check_ep(torch, np, args, smi, flash=False)
        except AssertionError as e:
            failed.append(seed)
            log({"ep_seed": seed, "failed": str(e)[:2000]})
    log({"phase": "ep spread", "seeds": args.ep_seeds, "failed": failed})
    return 1 if failed else 0


# -- phase 30: seq2seq under tensor parallelism, tensor beside fsdp -----------
# The kernels first, on a quiet card, at the shapes a rank of (b) gives
# them: Adam at the word embedding's fsdp part of its tensor block
# ([32128 / 2, 512 / 2] f32) beside ``AdamW(fused=True)``, LayerNorm at a
# rank's rows (16 rows of 128 tokens: [2048, 512] f32, eps 1e-6) beside
# ``F.layer_norm``, each against its plain version, with the bound.  Then
# four ranks of this script (``--ranks-for=tpf``) start on the one card
# over gloo with CUDA tensors and run (b) to (d) while this process runs
# (a) and (b)'s reference.  (a) A line of one at full width:
# ``Seq2SeqConfig()`` (vocab 32128, d 512, 6 + 6 layers, 8 heads, FFN 2048)
# in bf16 on ``{"data": 1, "fsdp": 1, "tensor": 1}`` under
# ``partition_rules(fsdp=True)``, zoo (g)'s batch (ZOO_S2S_BATCH x
# ZOO_S2S_LEN source and target tokens), ``adamw(1e-4)``, clip 1.0,
# against the plain model from the same weights on the same batch, the
# arms in turns (line, plain, plain, line), TPF_WARMUP + TPF_STEPS steps
# each: a line of one runs the plain code, so the losses, the gradient
# norm and every parameter are equal to the bit; LayerNorm 32 and Adam
# 259 launches a step (``s2s_per_step``), no collective.  Step ms,
# tokens/s and peak memory are logged; they share the card with (b)'s
# ranks.  (b) The same model from the same weights and batch in f32 with
# TF32 off on ``{"fsdp": 2, "tensor": 2}`` (each rank 16 rows, 4 of the 8
# heads, the fsdp part of each tensor block), held to a plain f32 run of
# this process: every rank's losses equal; within TPF_LIMITS the first
# ``losses`` losses, the first gradient norm (relative) and the
# parameters' gap after the first step over their movement (2-norms over
# every TPF_SAMPLE-th element of the blocks a rank holds; phase 29's
# measure); each rank's kernel launches and the lines' collectives exact
# a step (``tpf_collectives``); each rank's peak memory below (a)'s.
# (c) The ranks save a sharded checkpoint of (b)'s state; it restores
# bit-equal onto the same layout (on the ranks) and onto a whole f32
# model here (every TPF_SAMPLE-th element of every block), and
# ``verify_sharded`` passes (each box written once).  (d) Greedy
# ``generate`` of ZOO_S2S_GEN tokens on zoo (g)'s 2 + 2-layer f32 copy
# (weights 5x, so the tokens vary) on the ranks' mesh: every rank's
# tokens are the card's plain model's.  Files under TPF_DIR, removed at
# the phase's end.  The ranks' step times measure gloo's copies through
# the host, not a parallel speed.  ``--tpf-seeds 0,1,2`` read (H100 80GB
# HBM3, 700 W; PERF.md), the largest of the three seeds: first
# two losses 9.5e-7 apart (one f32 ulp at 10.4), gradient norm 2.5e-7,
# gap 2.5e-5 of the movement; TPF_LIMITS are about 10x those.
TPF_WARMUP, TPF_STEPS = 1, 2
TPF_AXES = {"fsdp": 2, "tensor": 2}
TPF_RANKS = 4
# losses checked, loss (absolute), gradient norm (relative), parameter gap
# over movement
TPF_LIMITS = {"losses": 2, "loss": 1e-5, "grad": 2.5e-6, "param": 2.5e-4}
TPF_SAMPLE = 16
TPF_ADAM_SHAPE = (32128 // TPF_AXES["tensor"], 512 // TPF_AXES["fsdp"])
TPF_LN_ROWS = ZOO_S2S_BATCH // TPF_AXES["fsdp"] * ZOO_S2S_LEN
TPF_RANK_TIMEOUT_S = 600
TPF_DIR = Path("build") / "tpf"


def tpf_collectives(c):
    """The collectives of one training step of seq2seq ``c`` on
    TPF_AXES.  The tensor line: forward the two embeddings' sums, 2
    row-parallel sums an encoder layer and 3 a decoder layer, the cross
    entropy's 2 all-reduces and the argmax's gather; backward 2
    column-parallel gradient sums an encoder layer and 3 a decoder layer,
    the memory's one (it comes onto the line once a decode) and the
    head's.  The fsdp line: one all-gather of the parameters' parts, one
    reduce-scatter of the gradients; the clip's norm one stats all-reduce
    a line; no data line, so no gradient all-reduce."""
    e, d = c.num_encoder_layers, c.num_decoder_layers
    return {"tp_all_reduce": 2 * (2 * e + 3 * d) + 6, "tp_all_gather": 1,
            "all_gather": 1, "reduce_scatter": 1, "stats_all_reduce": 2,
            "all_reduce": 0, "batch_all_reduce": 0, "ep_all_reduce": 0}


def _tpf_batch(torch, np, seed, vocab, mesh=None):
    """Zoo (g)'s batch from ``seed`` (this rank's rows under ``mesh``)."""
    rng = np.random.default_rng(seed)
    b, n = ZOO_S2S_BATCH, ZOO_S2S_LEN
    data = {"src_ids": rng.integers(2, vocab, (b, n)),
            "tgt_ids": rng.integers(2, vocab, (b, n + 1))}
    if mesh is not None:
        from distributed_tensorflow_tpu_torch.parallel import data_shards
        k = b // data_shards(mesh)
        data = {key: v[mesh.data_index * k:(mesh.data_index + 1) * k]
                for key, v in data.items()}
    return {key: torch.from_numpy(np.ascontiguousarray(v)).cuda()
            for key, v in data.items()}


def _tpf_build(torch, np, seed, mesh, dtype):
    """(config, state, step, batch) of an arm: ``Seq2SeqConfig()`` in
    ``dtype`` from ``seed``'s weights, on ``mesh`` (None: the plain
    model) placed by ``partition_rules(fsdp=True)``."""
    from distributed_tensorflow_tpu_torch import (TrainState, adamw,
                                                  make_custom_train_step,
                                                  train)
    from distributed_tensorflow_tpu_torch.models import seq2seq
    c = seq2seq.Seq2SeqConfig(dtype=dtype, dropout_rate=0.0)
    model = seq2seq.Seq2Seq(c, mesh)
    params = model.init(torch.Generator("cuda").manual_seed(seed))
    opt = adamw(ZOO_LR, mask=model.decay_mask)
    state = TrainState.create(params, opt.init(params))
    if mesh is not None:
        state = train.shard_train_state(state, mesh,
                                        model.partition_rules(fsdp=True))
    step = make_custom_train_step(model.seq2seq_loss_fn(), opt, seed=seed,
                                  mesh=mesh, grad_clip_norm=1.0)
    return c, state, step, _tpf_batch(torch, np, seed, c.vocab_size, mesh)


def _tpf_arm(torch, np, seed, mesh, dtype, first=None, start=None):
    """One arm's run: (its record, its state after the steps).
    ``first(state)`` runs after the first step; ``start``, when given, is
    filled with a copy of the parameters before it."""
    c, state, step, batch = _tpf_build(torch, np, seed, mesh, dtype)
    if start is not None:
        start.update({k: p.detach().clone() for k, p in state.params.items()})
    last = [state]

    def stepped(state, batch):
        last[0], m = step(state, batch)
        return last[0], m
    (losses, grad_norm, wall, peak), _, counts = _driven(
        torch, lambda: _sp_steps(
            torch, np, stepped, state, batch, TPF_WARMUP, TPF_STEPS,
            None if first is None else lambda: first(last[0])), _ep_counts)
    rows = batch["src_ids"].shape[0]
    step_s = wall / TPF_STEPS
    rec = {"losses": losses, "grad_norm": grad_norm,
           "step_ms": step_s * 1e3,
           "tokens_per_s": rows * ZOO_S2S_LEN / step_s,
           "peak_memory_gb": peak, "batch": rows, "launches": counts,
           "launches_expected": {k: n * (TPF_WARMUP + TPF_STEPS)
                                 for k, n in s2s_per_step(c).items()}}
    return rec, last[0]


def _tpf_boxes(state):
    """{name: (its box in the whole leaf, its block)} of a state's
    parameters (a plain state's: the whole leaves)."""
    layout = getattr(state.params, "layout", {})
    out = {}
    for k, t in state.params.items():
        box = [(0, n) for n in t.shape]
        s = layout.get(k)
        for part in (() if s is None else s.parts):
            box[part.dim] = (part.start, part.length)
        out[k] = (box, t)
    return out


def _tpf_samples(state):
    """{name: (box, every TPF_SAMPLE-th element of the block, on the
    host)}."""
    return {k: (box, _ep_sample(t, None, TPF_SAMPLE).to("cpu", copy=True))
            for k, (box, t) in _tpf_boxes(state).items()}


def _tpf_generate(torch, np, seed, mesh):
    """(d): greedy tokens of zoo (g)'s 2 + 2-layer f32 copy (seed 1's
    weights, 5x) over ``mesh`` (None: the plain model), on the card."""
    from distributed_tensorflow_tpu_torch.models import seq2seq
    small = seq2seq.Seq2Seq(seq2seq.Seq2SeqConfig(
        num_encoder_layers=2, num_decoder_layers=2, dropout_rate=0.0), mesh)
    init = small.init(torch.Generator().manual_seed(1))
    with torch.no_grad():
        params = {k: (v * 5.0 if v.dim() > 1 else v).detach().cuda()
                  for k, v in init.items()}
    rng = np.random.default_rng(seed + 1)
    src = torch.from_numpy(rng.integers(2, small.config.vocab_size,
                                        (2, 24))).cuda()
    valid = torch.ones((2, 24), dtype=torch.int32, device="cuda")
    valid[1, 15:] = 0
    return small.generate(params, src, ZOO_S2S_GEN,
                          src_valid=valid).cpu().tolist()


def tpf_rank_main(args) -> int:
    """One rank of (b) to (d), a process of this script: results to
    TPF_DIR (``rank<r>.json``; ``rank<r>_first.pt`` and
    ``rank<r>_final.pt``: each block's box and its sample after the first
    step and after the last)."""
    import datetime

    import numpy as np
    import torch
    import torch.distributed as dist

    from distributed_tensorflow_tpu_torch import parallel
    from distributed_tensorflow_tpu_torch.train import sharded_checkpoint
    r = args.rank
    torch.cuda.set_device(0)
    dist.init_process_group(
        "gloo", init_method=f"tcp://localhost:{args.rank_port}",
        world_size=TPF_RANKS, rank=r,
        timeout=datetime.timedelta(seconds=TPF_RANK_TIMEOUT_S))
    try:
        mesh = parallel.make_mesh(TPF_AXES)
        first = {}
        with _no_tf32(torch):
            rec, state = _tpf_arm(
                torch, np, args.seed, mesh, torch.float32,
                lambda st: first.update(_tpf_samples(st)))
            torch.save(first, TPF_DIR / f"rank{r}_first.pt")
            torch.save(_tpf_samples(state), TPF_DIR / f"rank{r}_final.pt")
            # (c) the sharded checkpoint, restored onto a fresh placement
            ckpt = TPF_DIR / "ckpt"
            t0 = time.perf_counter()
            sharded_checkpoint.save_sharded(str(ckpt), int(state.step),
                                            state)
            dist.barrier()
            rec["save_s"] = time.perf_counter() - t0
            fresh = _tpf_build(torch, np, args.seed, mesh, torch.float32)[1]
            t0 = time.perf_counter()
            restored = sharded_checkpoint.restore_sharded(
                fresh, sharded_checkpoint.all_sharded_checkpoints(
                    str(ckpt))[-1])
            rec["restore_s"] = time.perf_counter() - t0
            inner = state.opt_state.inner
            rec["restored_equal"] = all(
                torch.equal(restored.params[k], state.params[k])
                and torch.equal(restored.opt_state.inner["m"][k],
                                inner["m"][k])
                and torch.equal(restored.opt_state.inner["v"][k],
                                inner["v"][k]) for k in state.params)
            rec["restored_step"] = int(restored.step)
            del fresh, restored, state
            gc.collect()
            torch.cuda.empty_cache()
            # (d)
            rec["tokens"] = _tpf_generate(torch, np, args.seed, mesh)
        (TPF_DIR / f"rank{r}.json").write_text(json.dumps(rec))
    finally:
        dist.destroy_process_group()
    return 0


def _tpf_kernel_rows(torch, args, smi):
    """The kernels at a rank's shapes: {kernel: {case: record}}."""
    shape = list(TPF_ADAM_SHAPE)
    adam = _zero_adam_shard(torch, args, smi, TPF_ADAM_SHAPE,
                            ("tpf", f"fused_adam at {shape} f32"))
    rows, d = TPF_LN_ROWS, 512
    ln = _ln_row(torch, args, smi, rows, d, 1e-6, "tpf")
    adam["card"] = smi
    return {"fused_adam": {f"adam {shape} f32": adam},
            "layernorm": {f"layernorm [{rows}, {d}] f32": ln}}


def _tpf_line_of_one(torch, np, args, smi):
    """(a): returns (the launches over its arms, its largest peak GB)."""
    from distributed_tensorflow_tpu_torch import parallel
    one = parallel.make_mesh({"data": 1, "fsdp": 1, "tensor": 1})
    launches = collections.Counter()
    peak, prev = 0.0, None
    for arm in ("line", "plain", "plain", "line"):
        gc.collect()
        torch.cuda.empty_cache()
        rec, state = _tpf_arm(torch, np, args.seed,
                              one if arm == "line" else None, torch.bfloat16)
        log({"tpf": f"(a) {arm}", "mesh": dict(one.shape) if arm == "line"
             else None, "steps": TPF_STEPS, **rec, "card": smi})
        _zoo_expect(f"tpf (a) {arm}", rec["launches"],
                    rec["launches_expected"])
        extra = {k: v for k, v in rec["launches"].items()
                 if k not in rec["launches_expected"] and v}
        if extra:
            raise AssertionError(f"tpf (a) {arm}: collectives on a line of "
                                 f"one: {extra}")
        launches.update({k: v for k, v in rec["launches"].items()
                         if k in rec["launches_expected"]})
        peak = max(peak, rec["peak_memory_gb"])
        now = (rec["losses"], rec["grad_norm"],
               {k: p.detach().clone() for k, p in state.params.items()})
        del state
        if prev is not None and prev[0] is not None:
            same = (prev[0] == now[0] and prev[1] == now[1] and all(
                torch.equal(prev[2][k], now[2][k]) for k in now[2]))
            log({"tpf": "(a) line against plain", "bit_equal": same})
            if not same:
                raise AssertionError("tpf (a): a line of one differs from "
                                     "the plain model")
            now = (None,)
        prev = now
    return launches, peak


def check_tpf(torch, np, args, smi, timings=True):
    """Phase 30, seq2seq under tensor parallelism and tensor beside fsdp:
    returns (the kernels' launches over (a)'s arms, (b)'s reference and
    its ranks, the kernel rows at a rank's shapes; none without
    ``timings``)."""
    from distributed_tensorflow_tpu_torch.train import sharded_checkpoint
    t_phase = time.perf_counter()
    shutil.rmtree(TPF_DIR, ignore_errors=True)
    TPF_DIR.mkdir(parents=True)
    rows = _tpf_kernel_rows(torch, args, smi) if timings else {}
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = _start_ranks(args, _free_port(), phase="tpf", world=TPF_RANKS)
    try:
        launches, line_peak = _tpf_line_of_one(torch, np, args, smi)
        gc.collect()
        torch.cuda.empty_cache()
        start, after = {}, {}
        with _no_tf32(torch):
            plain, _ = _tpf_arm(
                torch, np, args.seed, None, torch.float32,
                lambda st: after.update({k: p.detach().clone() for k, p in
                                         st.params.items()}), start)
        log({"tpf": "(b) plain f32 reference", "steps": TPF_STEPS,
             **plain, "card": smi})
        _zoo_expect("tpf (b) plain f32 reference", plain["launches"],
                    plain["launches_expected"])
        launches.update({k: v for k, v in plain["launches"].items()
                         if k in plain["launches_expected"]})
        _tp_wait(ranks, "tpf (b) ranks")
        ranks_s = time.perf_counter() - t0
        results = [json.loads((TPF_DIR / f"rank{r}.json").read_text())
                   for r in range(TPF_RANKS)]
        from distributed_tensorflow_tpu_torch.models.seq2seq import \
            Seq2SeqConfig
        c = Seq2SeqConfig()
        n_steps = TPF_WARMUP + TPF_STEPS
        want = {k: n * n_steps for k, n in tpf_collectives(c).items()}
        want.update(results[0]["launches_expected"])
        for r, rec in enumerate(results):
            _zoo_expect(f"tpf (b) rank {r}", rec["launches"], want)
            launches.update({k: v for k, v in rec["launches"].items()
                             if k in s2s_per_step(c)})
        firsts = [torch.load(TPF_DIR / f"rank{r}_first.pt")
                  for r in range(TPF_RANKS)]
        param_err, param_max = _ep_gap(TPF_SAMPLE, firsts, start, after)
        del start, after
        lim = TPF_LIMITS
        loss_err = max(abs(x - y) for x, y in
                       zip(results[0]["losses"][:lim["losses"]],
                           plain["losses"]))
        grad_err = (abs(results[0]["grad_norm"] - plain["grad_norm"])
                    / plain["grad_norm"])
        peaks = [rec["peak_memory_gb"] for rec in results]
        check = {"tpf": "(b) fsdp 2 x tensor 2", "mesh": TPF_AXES,
                 "ranks": TPF_RANKS, "batch": plain["batch"],
                 "losses": [rec["losses"] for rec in results],
                 "plain_losses": plain["losses"],
                 "losses_checked": lim["losses"], "loss_err": loss_err,
                 "loss_tol": lim["loss"], "grad_norm_rel_err": grad_err,
                 "grad_tol": lim["grad"], "param_gap_over_move": param_err,
                 "param_tol": lim["param"], "param_max_abs_err": param_max,
                 "peak_memory_gb": peaks, "line_of_one_peak_gb": line_peak,
                 "step_ms": [rec["step_ms"] for rec in results],
                 "plain_step_ms": plain["step_ms"],
                 "collectives_a_step": {
                     k: results[0]["launches"].get(k, 0) // n_steps
                     for k in tpf_collectives(c)},
                 "launches": results[0]["launches"], "card": smi}
        log(check)
        if not (all(rec["losses"] == results[0]["losses"]
                    for rec in results)
                and loss_err <= lim["loss"] and grad_err <= lim["grad"]
                and param_err <= lim["param"]
                and all(p < line_peak for p in peaks)):
            raise AssertionError("tpf (b): four ranks disagree with the "
                                 "one-rank model (logged above)")
        # (c) the checkpoint onto a whole model in this process
        path = sharded_checkpoint.all_sharded_checkpoints(
            str(TPF_DIR / "ckpt"))[-1]
        ok, why = sharded_checkpoint.verify_sharded(path)
        whole = _tpf_build(torch, np, args.seed, None, torch.float32)[1]
        whole = sharded_checkpoint.restore_sharded(whole, path)
        boxes = _tpf_boxes(whole)
        equal = True
        for r in range(TPF_RANKS):
            for k, (box, got) in torch.load(
                    TPF_DIR / f"rank{r}_final.pt").items():
                want_s = _ep_sample(boxes[k][1], box, TPF_SAMPLE).cpu()
                equal = equal and torch.equal(got, want_s)
        del whole, boxes
        log({"tpf": "(c) sharded checkpoint", "verify": [ok, why],
             "ranks_restored_equal": [rec["restored_equal"]
                                      for rec in results],
             "restored_step": [rec["restored_step"] for rec in results],
             "whole_restore_equal": equal,
             "save_s": [rec["save_s"] for rec in results],
             "restore_s": [rec["restore_s"] for rec in results]})
        if not (ok and equal and all(rec["restored_equal"]
                                     and rec["restored_step"] == n_steps
                                     for rec in results)):
            raise AssertionError("tpf (c): the sharded checkpoint does not "
                                 "round-trip (logged above)")
        # (d)
        plain_tokens = _tpf_generate(torch, np, args.seed, None)
        same = [rec["tokens"] == plain_tokens for rec in results]
        log({"tpf": "(d) greedy generate, ranks against the card's plain "
             "model", "tokens_equal": same,
             "distinct_tokens": len({t for row in plain_tokens
                                     for t in row})})
        if not all(same):
            raise AssertionError("tpf (d): the ranks' tokens differ")
    finally:
        for p in ranks:
            if p.poll() is None:
                p.kill()
                p.wait()
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(TPF_DIR, ignore_errors=True)
    log({"phase": "tpf", "seconds": time.perf_counter() - t_phase,
         "ranks_seconds": ranks_s, "launches": dict(launches)})
    return dict(launches), rows


def tpf_spread(torch, np, args, smi) -> int:
    """``--tpf-seeds``: phase 30 once for each seed without the kernel
    rows, its checks logged; a seed that fails is logged and passed over
    (the spread TPF_LIMITS are set from); 1 when any seed failed."""
    failed = []
    for seed in [int(x) for x in args.tpf_seeds.split(",")]:
        args.seed = seed
        try:
            check_tpf(torch, np, args, smi, timings=False)
        except AssertionError as e:
            failed.append(seed)
            log({"tpf_seed": seed, "failed": str(e)[:2000]})
    log({"phase": "tpf spread", "seeds": args.tpf_seeds, "failed": failed})
    return 1 if failed else 0


# -- phase 31: tensor beside seq ----------------------------------------------
# The JAX package's multi-chip BERT mesh, ``{"seq": 2, "tensor": 2}``: a
# rank's Megatron blocks on its shard of the sequence, ring-flash over its
# seq line on its heads.  (a) The kernels at a rank's shapes, timed in this
# process before the ranks start: the ring-flash block routes on a virtual
# ring of 2 (phase 25's ``_sp_ring_case``: the forward, and dQ + dK/dV
# from the global lse and D, beside their plain versions, SDPA on the same
# block and its autograd backward replayed from a graph at the end of the
# run, and the bound) at BERT-base's rank heads (block [16, 256, 6, 64]
# bf16, full route, the key plane) and at the Llama recipe's (Llama-3-8B
# widths: block [2, 1024, 16 q / 4 kv, 128] bf16, full and diag routes),
# and LayerNorm at a rank's rows of (c) ([4096, 768] f32, eps 1e-12)
# beside ``F.layer_norm``.  (d)'s plain reference runs next (Llama-3-8B
# widths cut to TSP_LLAMA_LAYERS layers, batch TSP_LLAMA_BATCH x
# TSP_LLAMA_LEN, bf16: its loss kept on the host, the model freed), then
# four ranks of this script (``--ranks-for=tsp``) start on the one card
# over gloo with CUDA tensors and run (c) and (d) while this process runs
# (b) and (c)'s reference.  (b) BERT-base MLM at full width on a line of
# one, ``{"seq": 1, "tensor": 1}`` with ``seq_axis``, TSP_BERT_BATCH x
# TSP_BERT_LEN with key padding, bf16, adamw(1e-4), clip 1.0, against the
# same model on ``{"seq": 1}`` (no tensor axis), the arms in turns (line,
# plain, plain, line), TSP_WARMUP + TSP_STEPS steps each: a line of one
# runs the same code, so the losses, the gradient norm and every parameter
# are equal to the bit; the kernels' launches exact.  (c) The same model
# from the same weights and batch in f32 with TF32 off on ``{"seq": 2,
# "tensor": 2}`` (each rank 256 positions of the 16 rows and 6 of the 12
# heads; the rows whose keys on rank 1's block are all padding give that
# block no weight), held to a plain f32 run of this process (the model
# without ``seq_axis``): every rank's losses equal; within TSP_LIMITS the
# first ``losses`` losses, the first gradient norm (relative) and the
# parameters' gap after the first step over their movement (phase 29's
# measure over every TSP_SAMPLE-th element of the blocks a rank holds);
# each rank's kernel launches and the lines' collectives exact a step
# (``tsp_collectives``); each rank's peak memory logged beside (b)'s.
# (d) The Llama recipe's forward and loss (``shard_kv=True``: a rank's 16
# of the 32 query heads and 4 of the 8 kv heads, its 1024 positions) on
# the ranks' mesh against the plain model's loss: every rank's equal,
# within TSP_LLAMA_TOL of the plain one.  Why forward only: a training
# step here would all-reduce about 3 GB of f32 gradients a rank through
# host memory over gloo (tens of seconds a step, ~12 GB of state a rank);
# the four-rank Llama step waits for a four-card cell (ROADMAP).  Files
# under TSP_DIR, removed at the phase's end.  The ranks' step times
# measure gloo's copies through the host, not a parallel speed.
# ``--tsp-seeds 0,1,2`` read (H100 80GB HBM3, 700 W; PERF.md), the largest
# of the three seeds: first two losses 9.5e-7 apart (one f32 ulp at
# 10.4), gradient norm 9.7e-8, gap 1.6e-5 of the movement, (d)'s loss
# 2.8e-4 from the plain model's; TSP_LIMITS and TSP_LLAMA_TOL are about
# 10x those.
TSP_WARMUP, TSP_STEPS = 1, 2
TSP_AXES = {"seq": 2, "tensor": 2}
TSP_RANKS = 4
TSP_BERT_BATCH, TSP_BERT_LEN = 16, 512
TSP_LLAMA_LAYERS, TSP_LLAMA_BATCH, TSP_LLAMA_LEN = 2, 2, 2048
# losses checked, loss (absolute), gradient norm (relative), parameter gap
# over movement
TSP_LIMITS = {"losses": 2, "loss": 1e-5, "grad": 1e-6, "param": 1.6e-4}
TSP_LLAMA_TOL = 2.8e-3
TSP_SAMPLE = 16
TSP_RANK_TIMEOUT_S = 600
TSP_DIR = Path("build") / "tsp"


def tsp_collectives(layers):
    """The collectives of one training step of BERT (``layers`` layers)
    on TSP_AXES.  The tensor line: forward the embedding's sum, 2
    row-parallel sums a layer, the cross entropy's 2 all-reduces and the
    MLM transform's and the argmax's gathers; backward 2 column-parallel
    gradient sums a layer, the MLM transform's and the head's.  The seq
    line: the ring's rotations (one a layer forward, two backward: the
    blocks' one and the accumulators' way home), each rotated tensor
    staged through host memory on its way out and in (gloo: forward K, V
    and the key plane; backward those and the dK/dV accumulators, then the
    accumulators home: 20 copies a layer) and the loss's sum; the
    gradient mean over the seq line (``data_parallel.replicas``) and the
    clip's norm over the tensor line.  No data line."""
    return {"tp_all_reduce": 4 * layers + 5, "tp_all_gather": 2,
            "seq_p2p": 3 * layers, "seq_p2p_host": 20 * layers,
            "seq_all_reduce": 1,
            "seq_all_gather": 0, "all_reduce": 1, "stats_all_reduce": 1,
            "batch_all_reduce": 0, "ep_all_reduce": 0}


def _tsp_counts(torch):
    """The kernels' launches by ring route (phase 25's reader), RMSNorm's,
    and the collectives: ``parallel.data_parallel``'s and the seq line's
    (``parallel.ring``'s, as ``seq_<kind>``)."""
    from distributed_tensorflow_tpu_torch.parallel import data_parallel, ring
    counts = _sp_counts(torch)
    counts.update(data_parallel.LAUNCHES)
    counts.update({f"seq_{k}": n for k, n in ring.LAUNCHES.items()})
    return counts


def _tsp_bert_per_step(ring):
    """BERT-base's kernel launches a step on a rank of a seq ring of
    ``ring`` ranks (0: the model without ``seq_axis``, no ring): flash
    forward, dK/dV and dQ once a layer and block (bidirectional: every
    block full, ``ring`` a layer), LayerNorm the embeddings', 2 a layer
    and the MLM head's, Adam once a leaf (phase 22's 204)."""
    L = 12
    flash = max(ring, 1) * L
    return {"flash_forward": flash, "flash_backward_dkv": flash,
            "flash_backward_dq": flash, "layernorm": 2 * L + 2,
            "rmsnorm": 0, "fused_adam": 204, "ring_forward_full": ring * L,
            "ring_dq_full": ring * L, "ring_dkv_full": ring * L,
            "ring_forward_diag": 0, "ring_dq_diag": 0, "ring_dkv_diag": 0}


def _tsp_bert_build(torch, np, seed, mesh, dtype):
    """(config, state, step, batch) of a BERT-base MLM arm from ``seed``'s
    weights: with ``seq_axis`` on ``mesh`` (the state placed by the
    model's rules), or without it and a mesh (None); the batch has
    ragged key padding, its first row's keys all in the first quarter,
    and a 15% MLM mask on the real tokens."""
    from distributed_tensorflow_tpu_torch import (TrainState, adamw,
                                                  make_custom_train_step,
                                                  train)
    from distributed_tensorflow_tpu_torch.models.bert import Bert, BertConfig
    c = BertConfig(dtype=dtype, dropout_rate=0.0,
                   seq_axis=None if mesh is None else "seq")
    model = Bert(c, mesh)
    params = model.init(torch.Generator("cuda").manual_seed(seed))
    opt = adamw(TRAIN_LR, mask=model.decay_mask)
    state = TrainState.create(params, opt.init(params))
    if mesh is not None:
        state = train.shard_train_state(state, mesh, model.partition_rules())
    step = make_custom_train_step(model.mlm_loss_fn(), opt, seed=seed,
                                  mesh=mesh, grad_clip_norm=1.0)
    rng = np.random.default_rng(seed)
    b, s = TSP_BERT_BATCH, TSP_BERT_LEN
    lengths = rng.integers(s // 4, s + 1, b)
    lengths[0] = s // 4 + 3
    real = np.arange(s)[None] < lengths[:, None]
    batch = {"input_ids": rng.integers(0, c.vocab_size, (b, s)),
             "labels": rng.integers(0, c.vocab_size, (b, s)),
             "mlm_mask": (rng.random((b, s)) < 0.15) & real,
             "attention_mask": real}
    batch = {k: torch.from_numpy(v.astype(np.int32)).cuda()
             for k, v in batch.items()}
    return c, state, step, batch


def _tsp_bert_arm(torch, np, seed, mesh, dtype, first=None, start=None):
    """One BERT arm's run: (its record, its state after the steps).
    ``first(state)`` runs after the first step; ``start``, when given, is
    filled with a copy of the parameters before it."""
    c, state, step, batch = _tsp_bert_build(torch, np, seed, mesh, dtype)
    if start is not None:
        start.update({k: p.detach().clone() for k, p in state.params.items()})
    last = [state]

    def stepped(state, batch):
        last[0], m = step(state, batch)
        return last[0], m
    (losses, grad_norm, wall, peak), _, counts = _driven(
        torch, lambda: _sp_steps(
            torch, np, stepped, state, batch, TSP_WARMUP, TSP_STEPS,
            None if first is None else lambda: first(last[0])), _tsp_counts)
    n_steps = TSP_WARMUP + TSP_STEPS
    ring = 0 if mesh is None else mesh.axis_size("seq")
    step_s = wall / TSP_STEPS
    rec = {"losses": losses, "grad_norm": grad_norm,
           "step_ms": step_s * 1e3,
           "tokens_per_s": TSP_BERT_BATCH * TSP_BERT_LEN / step_s,
           "peak_memory_gb": peak, "batch": TSP_BERT_BATCH,
           "launches": counts,
           "launches_expected": {k: n * n_steps for k, n in
                                 _tsp_bert_per_step(ring).items()}}
    return rec, last[0]


def _tsp_llama(torch, np, seed, mesh):
    """(d): (the loss of the Llama recipe's forward, its launches, peak
    GB) at Llama-3-8B's widths cut to TSP_LLAMA_LAYERS layers, bf16,
    ``shard_kv=True``, on ``mesh`` with ``seq_axis`` (None: the plain
    model), weights from ``seed``; the model is freed before it
    returns."""
    from distributed_tensorflow_tpu_torch import GPT, llama3_8b
    config = llama3_8b(dtype=torch.bfloat16, num_layers=TSP_LLAMA_LAYERS,
                       max_position=TSP_LLAMA_LEN)
    if mesh is not None:
        config = dataclasses.replace(config, seq_axis="seq")
    model = GPT(config, device="cuda", mesh=mesh, shard_kv=True,
                generator=torch.Generator("cuda").manual_seed(seed))
    rng = np.random.default_rng(seed + 2)
    ids = torch.from_numpy(rng.integers(
        0, config.vocab_size, (TSP_LLAMA_BATCH, TSP_LLAMA_LEN + 1))).cuda()
    params = dict(model.named_parameters())
    loss_fn = model.lm_loss_fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        (loss, _), _, counts = _driven(
            torch, lambda: loss_fn(params, (), {"input_ids": ids}, None,
                                   False), _tsp_counts)
    out = float(loss)
    peak = torch.cuda.max_memory_allocated() / 1e9
    del model, params, loss_fn
    gc.collect()
    torch.cuda.empty_cache()
    return out, counts, peak


def _tsp_llama_expected(seq_index):
    """(d)'s kernel launches and collectives on the rank at ``seq_index``
    of a causal ring of 2 (None: the plain model): rank 0 of the line
    holds its own block only (diag), rank 1 rank 0's too (full); RMSNorm
    2 a layer and ``ln_f``.  The tensor line: the embedding's sum, 2
    row-parallel sums a layer, the cross entropy's 2 all-reduces and the
    argmax's gather; the seq line: one rotation a layer (K and V staged
    through host memory out and in) and the loss's sum."""
    L = TSP_LLAMA_LAYERS
    full = 0 if seq_index is None else seq_index * L
    want = {"flash_forward": L + full, "ring_forward_full": full,
            "ring_forward_diag": 0 if seq_index is None else L,
            "rmsnorm": 2 * L + 1, "layernorm": 0, "fused_adam": 0,
            "flash_backward_dq": 0, "flash_backward_dkv": 0}
    if seq_index is not None:
        want.update({"tp_all_reduce": 2 * L + 3, "tp_all_gather": 1,
                     "seq_p2p": L, "seq_p2p_host": 4 * L,
                     "seq_all_reduce": 1, "all_reduce": 0})
    return want


def tsp_rank_main(args) -> int:
    """One rank of (c) and (d), a process of this script: results to
    TSP_DIR (``rank<r>.json``; ``rank<r>_first.pt``: each block's box and
    its sample after (c)'s first step)."""
    import datetime

    import numpy as np
    import torch
    import torch.distributed as dist

    from distributed_tensorflow_tpu_torch import parallel
    r = args.rank
    torch.cuda.set_device(0)
    dist.init_process_group(
        "gloo", init_method=f"tcp://localhost:{args.rank_port}",
        world_size=TSP_RANKS, rank=r,
        timeout=datetime.timedelta(seconds=TSP_RANK_TIMEOUT_S))
    try:
        mesh = parallel.make_mesh(TSP_AXES)
        first = {}
        with _no_tf32(torch):
            rec, state = _tsp_bert_arm(
                torch, np, args.seed, mesh, torch.float32,
                lambda st: first.update(_tpf_samples(st)))
        torch.save(first, TSP_DIR / f"rank{r}_first.pt")
        rec["coords"] = [mesh.axis_index("seq"), mesh.axis_index("tensor")]
        del state
        gc.collect()
        torch.cuda.empty_cache()
        dist.barrier()
        loss, counts, peak = _tsp_llama(torch, np, args.seed, mesh)
        rec["llama"] = {"loss": loss, "launches": counts,
                        "peak_memory_gb": peak}
        (TSP_DIR / f"rank{r}.json").write_text(json.dumps(rec))
    finally:
        dist.destroy_process_group()
    return 0


def _ln_row(torch, args, smi, rows, d, eps, phase):
    """LayerNorm at ``[rows, d]`` f32 against its plain version: its ms
    and graph ms beside the plain version's, ``F.layer_norm``'s and the
    bound; logged under ``phase``."""
    import torch.nn.functional as F

    from distributed_tensorflow_tpu_torch.ops.kernels import fused
    gen = torch.Generator("cuda").manual_seed(args.seed)
    x = torch.randn(rows, d, generator=gen, device="cuda") * 2 + 0.5
    gamma = 1 + 0.1 * torch.randn(d, generator=gen, device="cuda")
    beta = 0.1 * torch.randn(d, generator=gen, device="cuda")
    err = (fused.fused_layernorm(x, gamma, beta, eps)
           - fused.layernorm_plain(x, gamma, beta, eps)).abs().max().item()
    if not err <= F32_TOL:
        raise AssertionError(f"layernorm at [{rows}, {d}] f32: {err}")

    def kern():
        return fused.fused_layernorm(x, gamma, beta, eps)

    def lib():
        return F.layer_norm(x, (d,), gamma, beta, eps)
    b_ms, b_by = bound_ms(2 * x.numel() * 4 + 2 * d * 4, 8.0 * x.numel(),
                          F32_FLOPS_PER_S)
    ln = {"shape": [rows, d], "max_abs_err": err,
          "ms": time_ms(torch, kern, args.iters),
          "graph_ms": graph_ms(torch, kern, args.iters),
          "plain_ms": time_ms(torch, lambda: fused.layernorm_plain(
              x, gamma, beta, eps), max(5, args.iters // 10)),
          "library_ms": time_ms(torch, lib, args.iters),
          "library_graph_ms": graph_ms(torch, lib, args.iters),
          "library": "F.layer_norm", "bound_ms": b_ms, "bound_by": b_by,
          "card": smi}
    log({phase: f"layernorm at [{rows}, {d}] f32", **ln})
    return ln


def _tsp_kernel_rows(torch, args, smi):
    """(a): ({case: the ring routes' records}, the LayerNorm record)."""
    from distributed_tensorflow_tpu_torch import llama3_8b
    ll = llama3_8b()
    t = TSP_AXES["tensor"]
    routes = {
        "bert_base tsp": _sp_ring_case(
            torch, args, smi, "bert_base tsp", TSP_BERT_BATCH, TSP_BERT_LEN,
            12 // t, 12 // t, 64, False, ring=TSP_AXES["seq"]),
        "llama3_8b tsp": _sp_ring_case(
            torch, args, smi, "llama3_8b tsp", TSP_LLAMA_BATCH,
            TSP_LLAMA_LEN, ll.num_heads // t, ll.kv_heads // t, ll.head_dim,
            True, ring=TSP_AXES["seq"])}
    rows = TSP_BERT_BATCH * TSP_BERT_LEN // TSP_AXES["seq"]
    ln = _ln_row(torch, args, smi, rows, 768, 1e-12, "tsp")
    return routes, ln


def _tsp_line_of_one(torch, np, args, smi):
    """(b): returns (the launches over its arms, its largest peak GB)."""
    from distributed_tensorflow_tpu_torch import parallel
    meshes = {"line": parallel.make_mesh({"seq": 1, "tensor": 1}),
              "plain": parallel.make_mesh({"seq": 1})}
    launches = collections.Counter()
    peak, prev = 0.0, None
    for arm in ("line", "plain", "plain", "line"):
        gc.collect()
        torch.cuda.empty_cache()
        rec, state = _tsp_bert_arm(torch, np, args.seed, meshes[arm],
                                   torch.bfloat16)
        log({"tsp": f"(b) {arm}", "mesh": meshes[arm].shape,
             "steps": TSP_STEPS, **rec, "card": smi})
        _zoo_expect(f"tsp (b) {arm}", rec["launches"],
                    rec["launches_expected"])
        extra = {k: v for k, v in rec["launches"].items()
                 if k not in rec["launches_expected"] and v}
        if extra:
            raise AssertionError(f"tsp (b) {arm}: collectives on a line of "
                                 f"one: {extra}")
        launches.update({k: v for k, v in rec["launches"].items()
                         if k in rec["launches_expected"]})
        peak = max(peak, rec["peak_memory_gb"])
        now = (rec["losses"], rec["grad_norm"],
               {k: p.detach().clone() for k, p in state.params.items()})
        del state
        if prev is not None and prev[0] is not None:
            same = (prev[0] == now[0] and prev[1] == now[1] and all(
                torch.equal(prev[2][k], now[2][k]) for k in now[2]))
            log({"tsp": "(b) line against plain", "bit_equal": same})
            if not same:
                raise AssertionError("tsp (b): a line of one differs from "
                                     "the model without a tensor axis")
            now = (None,)
        prev = now
    return launches, peak


def check_tsp(torch, np, args, smi, timings=True):
    """Phase 31, tensor beside seq: returns (the kernels' launches over
    (b)'s arms, (c)'s reference and ranks and (d)'s ranks, the ring
    routes' records by case and LayerNorm's record of (a); none without
    ``timings``)."""
    t_phase = time.perf_counter()
    shutil.rmtree(TSP_DIR, ignore_errors=True)
    TSP_DIR.mkdir(parents=True)
    routes, ln = _tsp_kernel_rows(torch, args, smi) if timings else ({},
                                                                     None)
    torch.cuda.empty_cache()
    plain_llama, counts, llama_peak = _tsp_llama(torch, np, args.seed, None)
    _zoo_expect("tsp (d) plain", counts, _tsp_llama_expected(None))
    launches = collections.Counter({k: v for k, v in counts.items()
                                    if not k.startswith("ring_")})
    t0 = time.perf_counter()
    ranks = _start_ranks(args, _free_port(), phase="tsp", world=TSP_RANKS)
    try:
        line_launches, line_peak = _tsp_line_of_one(torch, np, args, smi)
        launches.update(line_launches)
        gc.collect()
        torch.cuda.empty_cache()
        start, after = {}, {}
        with _no_tf32(torch):
            plain, _ = _tsp_bert_arm(
                torch, np, args.seed, None, torch.float32,
                lambda st: after.update({k: p.detach().clone() for k, p in
                                         st.params.items()}), start)
        log({"tsp": "(c) plain f32 reference", "steps": TSP_STEPS,
             **plain, "card": smi})
        _zoo_expect("tsp (c) plain f32 reference", plain["launches"],
                    plain["launches_expected"])
        launches.update({k: v for k, v in plain["launches"].items()
                         if k in plain["launches_expected"]})
        _tp_wait(ranks, "tsp (c) ranks")
        ranks_s = time.perf_counter() - t0
        results = [json.loads((TSP_DIR / f"rank{r}.json").read_text())
                   for r in range(TSP_RANKS)]
        n_steps = TSP_WARMUP + TSP_STEPS
        want = {k: n * n_steps for k, n in tsp_collectives(12).items()}
        want.update(results[0]["launches_expected"])
        for r, rec in enumerate(results):
            _zoo_expect(f"tsp (c) rank {r}", rec["launches"], want)
            launches.update({k: v for k, v in rec["launches"].items()
                             if k in rec["launches_expected"]})
        firsts = [torch.load(TSP_DIR / f"rank{r}_first.pt")
                  for r in range(TSP_RANKS)]
        param_err, param_max = _ep_gap(TSP_SAMPLE, firsts, start, after)
        del start, after
        lim = TSP_LIMITS
        loss_err = max(abs(x - y) for x, y in
                       zip(results[0]["losses"][:lim["losses"]],
                           plain["losses"]))
        grad_err = (abs(results[0]["grad_norm"] - plain["grad_norm"])
                    / plain["grad_norm"])
        check = {"tsp": "(c) seq 2 x tensor 2", "mesh": TSP_AXES,
                 "ranks": TSP_RANKS, "batch": plain["batch"],
                 "losses": [rec["losses"] for rec in results],
                 "plain_losses": plain["losses"],
                 "losses_checked": lim["losses"], "loss_err": loss_err,
                 "loss_tol": lim["loss"], "grad_norm_rel_err": grad_err,
                 "grad_tol": lim["grad"], "param_gap_over_move": param_err,
                 "param_tol": lim["param"], "param_max_abs_err": param_max,
                 "peak_memory_gb": [rec["peak_memory_gb"]
                                    for rec in results],
                 "line_of_one_peak_gb": line_peak,
                 "step_ms": [rec["step_ms"] for rec in results],
                 "plain_step_ms": plain["step_ms"],
                 "collectives_a_step": {
                     k: results[0]["launches"].get(k, 0) // n_steps
                     for k in tsp_collectives(12)},
                 "launches": results[0]["launches"], "card": smi}
        log(check)
        if not (all(rec["losses"] == results[0]["losses"]
                    for rec in results)
                and loss_err <= lim["loss"] and grad_err <= lim["grad"]
                and param_err <= lim["param"]):
            raise AssertionError("tsp (c): four ranks disagree with the "
                                 "one-rank model (logged above)")
        # (d)
        losses = [rec["llama"]["loss"] for rec in results]
        for r, rec in enumerate(results):
            got = rec["llama"]["launches"]
            _zoo_expect(f"tsp (d) rank {r}", got,
                        _tsp_llama_expected(rec["coords"][0]))
            launches.update({k: v for k, v in got.items()
                             if k in _tsp_llama_expected(0)
                             and not k.startswith("ring_")})
        llama_err = max(abs(x - plain_llama) for x in losses)
        log({"tsp": "(d) llama recipe forward, seq 2 x tensor 2, shard_kv",
             "layers": TSP_LLAMA_LAYERS,
             "batch": [TSP_LLAMA_BATCH, TSP_LLAMA_LEN], "losses": losses,
             "plain_loss": plain_llama, "loss_err": llama_err,
             "loss_tol": TSP_LLAMA_TOL,
             "peak_memory_gb": [rec["llama"]["peak_memory_gb"]
                                for rec in results],
             "plain_peak_memory_gb": llama_peak, "card": smi})
        if not (len(set(losses)) == 1 and llama_err <= TSP_LLAMA_TOL):
            raise AssertionError("tsp (d): the ranks' Llama loss disagrees "
                                 "with the plain model's (logged above)")
    finally:
        for p in ranks:
            if p.poll() is None:
                p.kill()
                p.wait()
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(TSP_DIR, ignore_errors=True)
    launches = {k: v for k, v in launches.items()
                if k in _FAMILY_KERNELS}
    log({"phase": "tsp", "seconds": time.perf_counter() - t_phase,
         "ranks_seconds": ranks_s, "launches": launches})
    return launches, routes, ln


def tsp_spread(torch, np, args, smi) -> int:
    """``--tsp-seeds``: phase 31 once for each seed without the kernel
    rows, its checks logged; a seed that fails is logged and passed over
    (the spread TSP_LIMITS are set from); 1 when any seed failed."""
    failed = []
    for seed in [int(x) for x in args.tsp_seeds.split(",")]:
        args.seed = seed
        try:
            check_tsp(torch, np, args, smi, timings=False)
        except AssertionError as e:
            failed.append(seed)
            log({"tsp_seed": seed, "failed": str(e)[:2000]})
    log({"phase": "tsp spread", "seeds": args.tsp_seeds, "failed": failed})
    return 1 if failed else 0


# the fleet's host tools (phase 32).  (a) the simulator held to phase 4's
# engine on the card: one replica behind the router, the decode tick
# (all FT_SLOTS slots decoding) and the prefill window (one prompt of
# FT_WINDOW_CHUNKS windows alone) each the least of up to FT_SAMPLES
# steps, calibrated; a burst of FT_REQUESTS requests of 3 to 2 chunks + 1
# tokens and FT_BUDGET new tokens replayed FT_REPLAYS times through the
# real router (fresh tokens each time: the sim's trace shares no prefix)
# and once through FleetSim; its tokens/s and TTFT p50 within FT_LIMIT of
# the real ones (the reference's bound, bench.py's _fleet_sim_validate).
# (b) FT_SCALE_N synthesized requests over FT_SCALE_S virtual seconds on
# FT_SCALE_REPLICAS replicas under the autoscaler (floor FT_SCALE_REPLICAS,
# ceiling FT_SCALE_MAX: the bursts need about 30), then two runs of
# FT_DET_N.  (c) the launcher's entry point, two hosts on the card.
# (d) one supervised host training the XOR MLP for FT_CHAOS_EPOCHS
# epochs (8 read 0.9469 on an H100 80GB HBM3; phase 18 (c)'s entry
# point read 0.976 at its 10th), a checkpoint every FT_CHAOS_EVERY
# steps, killed through kill_host once one past step 0 is on disk; the
# launcher's heartbeat deadline FT_HB_TIMEOUT_S; final val accuracy at
# least XOR_ACC; each child FT_CHILD_TIMEOUT_S at most
FT_SLOTS, FT_CHUNK, FT_TICK_STEPS = 8, 32, 8
FT_REQUESTS, FT_BUDGET, FT_REPLAYS, FT_SAMPLES = 48, 10, 3, 12
FT_WINDOW_CHUNKS, FT_LIMIT = 6, 0.25
FT_SCALE_N, FT_SCALE_S, FT_SCALE_REPLICAS, FT_SCALE_MAX = (100_000, 1800.0,
                                                          4, 32)
FT_DET_N = 10_000
FT_CHAOS_EPOCHS, FT_CHAOS_EVERY, FT_CHAOS_PRINT = 10, 600, 100
FT_HB_TIMEOUT_S, FT_CHILD_TIMEOUT_S = 30.0, 240.0
FT_DIR = Path("build") / "fleet_tools"


def _tools_engine_times(torch, np, eng, rng, vocab):
    """(a)'s two measured points on ``eng``: the least step time with
    every slot decoding, and the least pure-window step of one long
    prompt alone (its first step, the admission, untimed)."""
    for _ in range(FT_SLOTS):
        eng.submit(rng.integers(0, vocab, 4, dtype=np.int32), 64)
    while eng.stats().active < FT_SLOTS:
        eng.step()
    tick = []
    while eng.stats().active == FT_SLOTS and len(tick) < FT_SAMPLES:
        t0 = time.perf_counter()
        eng.step()
        tick.append(time.perf_counter() - t0)
    eng.drain()
    eng.submit(rng.integers(0, vocab, FT_WINDOW_CHUNKS * FT_CHUNK,
                            dtype=np.int32), 1)
    eng.step()
    window = []
    while eng.stats().prefilling and len(window) < FT_SAMPLES:
        t0 = time.perf_counter()
        eng.step()
        window.append(time.perf_counter() - t0)
    eng.drain()
    torch.cuda.synchronize()
    return min(tick), (min(window) if window else min(tick)), tick, window


def _tools_sim_replay(sim_lib, workload, np, cm, lens, quantum_s):
    """The burst's shape through FleetSim: one replica at the engine's
    geometry; (tokens/s, TTFT p50 s, report)."""
    n = len(lens)
    tr = workload.Trace(
        arrival_s=np.zeros(n, dtype=np.float64),
        plen=np.asarray(lens, dtype=np.int32),
        new_tokens=np.full(n, FT_BUDGET, dtype=np.int32),
        tenant=np.zeros(n, dtype=np.int16),
        prefix_id=np.zeros(n, dtype=np.int32),
        prefix_len=np.zeros(n, dtype=np.int32),
        adapter=np.full(n, -1, dtype=np.int16),
        tenants=(("default", 1.0),), events=(), horizon_s=0.0, seed=0)
    fs = sim_lib.FleetSim(
        tr, cm, replicas=1,
        engine=dict(num_slots=FT_SLOTS, prefill_chunk=FT_CHUNK,
                    tick_steps=FT_TICK_STEPS),
        quantum_s=quantum_s, inflight_cap_per_replica=n, seed=0)
    rep = fs.run()
    return (rep["tokens_generated"] / rep["virtual_time_s"],
            rep["ttft_p50_ms"] / 1e3, rep)


def _tools_validate(torch, np, args, smi, model):
    """Phase 32 (a).  Returns the calibrated ``CostModel`` and the paged
    and LayerNorm launches over the real replays."""
    from distributed_tensorflow_tpu_torch import fleet
    from distributed_tensorflow_tpu_torch.fleet import sim as sim_lib
    from distributed_tensorflow_tpu_torch.fleet import workload
    from distributed_tensorflow_tpu_torch.obs import Registry
    from distributed_tensorflow_tpu_torch.ops.kernels import fused
    from distributed_tensorflow_tpu_torch.ops.kernels import \
        paged_attention as pa

    vocab = model.config.vocab_size
    L = model.config.num_layers
    rng = np.random.default_rng(args.seed + 32)
    lens = [int(n) for n in rng.integers(3, 2 * FT_CHUNK + 2, FT_REQUESTS)]

    def draw():
        return [rng.integers(0, vocab, n, dtype=np.int32) for n in lens]

    reg = Registry()
    eng = _serve_engine(model, registry=reg)
    router = fleet.Router([eng], registry=reg)
    for _ in range(2):                       # warm every entry
        router.submit(draw()[0], 2)
        router.submit(rng.integers(0, vocab, FT_CHUNK + 3, dtype=np.int32),
                      2)
    router.drain()
    tick_s, window_s, ticks, windows = _tools_engine_times(
        torch, np, eng, rng, vocab)
    n_params = float(sum(p.numel() for p in model.state_dict().values()))
    dtype_bytes = torch.finfo(model.config.dtype).bits // 8
    window_cost = sim_lib.Cost(flops=2.0 * n_params * FT_CHUNK,
                               bytes=n_params * dtype_bytes, peak_bytes=0.0)
    tick_cost = sim_lib.Cost(
        flops=2.0 * n_params * FT_SLOTS * FT_TICK_STEPS,
        bytes=n_params * dtype_bytes * FT_TICK_STEPS, peak_bytes=0.0)
    cm = sim_lib.CostModel.calibrate(window_cost, tick_cost, window_s,
                                     tick_s)

    skipped0 = eng.stats().prefill_windows_skipped_total
    _reset_counts()
    replays = []
    for _ in range(FT_REPLAYS):
        hs = [router.submit(p, FT_BUDGET) for p in draw()]
        t0 = time.perf_counter()
        while router.busy:
            router.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        for h in hs:
            if h.status != "ok" or len(h.tokens) != FT_BUDGET:
                raise AssertionError(f"(a) request {h.rid}: {h.status}, "
                                     f"{len(h.tokens)} tokens")
        ttfts = sorted(h.ttft_s for h in hs)
        replays.append((wall, ttfts[len(ttfts) // 2],
                        sum(len(h.tokens) for h in hs)))
    torch.cuda.synchronize()
    launches = {"paged_decode_attention": pa.LAUNCHES["paged_decode"],
                "paged_window_attention": pa.LAUNCHES["paged_window"],
                "layernorm": fused.LAUNCHES["layernorm"]}
    n = FT_REPLAYS * FT_REQUESTS
    want_windows = L * FT_REPLAYS * sum(-(-k // FT_CHUNK) for k in lens)
    steps = launches["paged_decode_attention"]
    want_norms = (2 * L + 1) * steps // L + 2 * want_windows + n
    if eng.stats().prefill_windows_skipped_total != skipped0 \
            or launches["paged_window_attention"] != want_windows \
            or steps <= 0 or steps % L \
            or launches["layernorm"] != want_norms:
        raise AssertionError(
            f"(a) replay launches {launches}: expected {want_windows} "
            f"windows, decode a multiple of {L} and {want_norms} "
            f"layernorms, no window skipped")
    real_wall = min(r[0] for r in replays)
    real_ttft = min(r[1] for r in replays)
    real_tps = replays[0][2] / real_wall

    sim_tps, sim_ttft, rep = _tools_sim_replay(sim_lib, workload, np, cm,
                                               lens, tick_s)
    got = dict(sim_tokens_per_s=sim_tps, sim_ttft_p50_s=sim_ttft,
               tokens_per_s_ratio=sim_tps / real_tps,
               ttft_p50_ratio=sim_ttft / real_ttft,
               virtual_time_s=rep["virtual_time_s"])
    log({"fleet_tools": "(a) sim against the engine", "requests": n,
         "measured_tick_s": tick_s, "measured_window_s": window_s,
         "tick_samples_s": ticks, "window_samples_s": windows,
         "n_params": n_params, "provenance": cm.provenance,
         "calibrated": {"prefill_window_s": cm.prefill_window_s,
                        "decode_tick_s": cm.decode_tick_s,
                        "overhead_s": cm.overhead_s},
         "real_walls_s": [r[0] for r in replays],
         "real_ttft_p50s_s": [r[1] for r in replays],
         "real_tokens_per_s": real_tps, "real_ttft_p50_s": real_ttft,
         "sim": got, "limit": FT_LIMIT, "launches": launches, "card": smi})
    for key in ("tokens_per_s_ratio", "ttft_p50_ratio"):
        if abs(got[key] - 1.0) > FT_LIMIT:
            raise AssertionError(f"(a) sim {key} {got[key]:.4f} beyond "
                                 f"{FT_LIMIT} (real {real_tps:.1f} "
                                 f"tokens/s, TTFT p50 {real_ttft:.4f} s)")
    del router, eng
    return cm, launches


def _tools_scale(np, args, cm):
    """Phase 32 (b): FT_SCALE_N requests through FleetSim on
    FT_SCALE_REPLICAS replicas and the autoscaler, priced by (a)'s model;
    every request accounted for, and two runs of FT_DET_N equal."""
    from distributed_tensorflow_tpu_torch import fleet
    from distributed_tensorflow_tpu_torch.fleet import sim as sim_lib

    def run(n):
        trace = fleet.synthesize(n, seed=args.seed,
                                 horizon_s=FT_SCALE_S * n / FT_SCALE_N,
                                 plen_max=512, new_tokens_max=256)
        fs = sim_lib.FleetSim(
            trace, cm, replicas=FT_SCALE_REPLICAS,
            slo=fleet.SLO(ttft_s=2.0, itl_s=0.02),
            engine=dict(num_slots=FT_SLOTS, prefill_chunk=FT_CHUNK,
                        tick_steps=FT_TICK_STEPS),
            autoscaler=dict(min_replicas=FT_SCALE_REPLICAS,
                            max_replicas=FT_SCALE_MAX,
                            eval_interval_s=15.0, cooldown_s=60.0),
            seed=args.seed)
        t0 = time.perf_counter()
        rep = fs.run()
        return rep, time.perf_counter() - t0, len(trace)

    rep, wall, n = run(FT_SCALE_N)
    if rep["completed"] + rep["deadline_exceeded"] + rep["lost"] \
            != rep["simulated_requests"] or rep["simulated_requests"] != n:
        raise AssertionError(f"(b) accounting: {rep}")
    a, wall_a, _ = run(FT_DET_N)
    b, wall_b, _ = run(FT_DET_N)
    if a != b:
        raise AssertionError(f"(b) same seeds, different reports: {a} {b}")
    log({"fleet_tools": "(b) sim at scale", "requests": n,
         "wall_s": wall, "requests_per_s_host": n / wall,
         "host": "the host CPU running this script, one thread",
         "ttft_p50_ms": rep["ttft_p50_ms"], "ttft_p95_ms": rep["ttft_p95_ms"],
         "slo_attainment": rep["slo_attainment"],
         "attainment_ttft": rep["attainment_ttft"],
         "attainment_itl": rep["attainment_itl"],
         "scale_outs": rep["scale_outs"], "scale_ins": rep["scale_ins"],
         "replica_seconds": rep["replica_seconds"], "lost": rep["lost"],
         "virtual_time_s": rep["virtual_time_s"],
         "determinism_walls_s": [wall_a, wall_b]})


def _tools_launch_start():
    """Phase 32 (c) started: the entry point in parent mode, two hosts on
    the card (its children over gloo: they share it)."""
    root = Path(__file__).resolve().parent
    return time.perf_counter(), subprocess.Popen(
        [sys.executable, "-m",
         "distributed_tensorflow_tpu_torch.examples.launch_multihost_smoke"],
        cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _tools_launch_check(run, smi):
    """Phase 32 (c) checked: exit 0, every host done with no restart,
    host 0 the chief, the all-reduce's sum exact on each."""
    t0, p = run
    try:
        out, err = p.communicate(timeout=4 * FT_CHILD_TIMEOUT_S)
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
    wall = time.perf_counter() - t0
    lines = out.splitlines()
    if p.returncode != 0 or not lines:
        raise AssertionError(f"(c) rc {p.returncode}\n{out[-2000:]}\n"
                             f"{err[-3000:]}")
    rep = json.loads(lines[-1])
    smoke = sorted(line.split() for line in lines
                   if line.startswith("SMOKE "))
    want = [["SMOKE", "proc=0", "chief=True", "sum=3.0"],
            ["SMOKE", "proc=1", "chief=False", "sum=3.0"]]
    hosts = {k: v for k, v in rep["report"].items() if k != "-1"}
    if not rep["succeeded"] or rep["chief_at_start"] != 0 \
            or sorted(hosts) != ["0", "1"] \
            or any(h["status"] != "done" or h["restarts"] != 0
                   for h in hosts.values()) \
            or [s[:4] for s in smoke] != want:
        raise AssertionError(f"(c) report {rep}, lines {smoke}")
    log({"fleet_tools": "(c) launcher bring-up", "wall_s": wall,
         "attempt": rep["attempt"], "backend": rep["backend"],
         "smoke": [" ".join(s) for s in smoke], "report": rep["report"],
         "card": smi})


def _tools_chaos(torch, np, args, smi, meanwhile):
    """Phase 32 (d): the launcher supervises one host (``--ranks-for=
    chaos``) training the XOR MLP; once a checkpoint past step 0 is on
    disk, kill_host on the host's next poll.  ``meanwhile()`` runs once
    the respawn is up (the launcher needs no poll while it trains).
    Returns Adam's launches over both incarnations."""
    import os

    from distributed_tensorflow_tpu_torch import fleet
    from distributed_tensorflow_tpu_torch.obs import Registry
    from distributed_tensorflow_tpu_torch.resilience import faults
    from distributed_tensorflow_tpu_torch.train import checkpoint

    root = Path(__file__).resolve().parent
    d = root / FT_DIR / "chaos"
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    logs, outs = [], []

    def popen(spec):
        logs.append(d / f"incarnation{len(logs)}.log")
        outs.append(logs[-1].open("w"))
        env = dict(os.environ)
        env.update(spec.env)
        return subprocess.Popen(list(spec.argv), cwd=root, env=env,
                                stdout=outs[-1], stderr=subprocess.STDOUT)

    spec = fleet.HostSpec(host_id=0, argv=(
        sys.executable, str(root / "chip_smoke.py"), "--ranks-for=chaos",
        f"--seed={args.seed}"), env={
            "DTTPU_LAUNCHER": "1",
            "DTTPU_HEARTBEAT_FILE": str(d / "host0.hb"),
            "DTTPU_CHAOS_DIR": str(d / "ckpt")})
    lc = fleet.Launcher([spec], registry=Registry(), max_restarts=1,
                        heartbeat_timeout_s=FT_HB_TIMEOUT_S,
                        heartbeat_grace_s=FT_HB_TIMEOUT_S,
                        poll_interval_s=0.05, seed=args.seed, popen=popen)
    plan = restored = killed_at = None
    t0 = time.perf_counter()
    lc.start()
    try:
        while lc.poll():
            host = lc.report()[0]
            if plan is None and (checkpoint.latest_step(
                    str(d / "ckpt")) or 0) > 0:
                # kill_host on the host's next poll
                plan = faults.activate(faults.FaultPlan(
                    [{"kind": "kill_host", "at": 0, "replica": 0}],
                    registry=Registry()))
            elif plan is not None and killed_at is None \
                    and host["restarts"]:
                killed_at = time.time()
                restored = checkpoint.latest_step(str(d / "ckpt"))
                faults.deactivate(plan)
            elif meanwhile is not None and killed_at is not None \
                    and host["status"] == "running":
                meanwhile()        # the respawn trains; it needs no poll
                meanwhile = None
            if time.perf_counter() - t0 > FT_CHILD_TIMEOUT_S:
                raise AssertionError(f"(d) no end in {FT_CHILD_TIMEOUT_S} "
                                     f"s: {lc.report()}")
            time.sleep(lc.poll_interval_s)
    finally:
        if plan is not None:
            faults.deactivate(plan)
        lc.stop()
        for f in outs:
            f.close()
    if meanwhile is not None:
        meanwhile()
    wall = time.perf_counter() - t0
    rep = lc.report()
    lines = [[json.loads(x) for x in p.read_text().splitlines()
              if x.startswith('{"chaos"')] for p in logs]
    tails = "\n".join(p.read_text()[-1500:] for p in logs)
    if len(lines) != 2 or rep[0]["status"] != "done" \
            or rep[0]["restarts"] != 1 or rep[0]["exit_history"] != [-9, 0] \
            or plan is None or plan.log != [
                {"kind": "kill_host", "at": 0, "host": 0, "poll": 0}]:
        raise AssertionError(f"(d) report {rep}, plan "
                             f"{None if plan is None else plan.log}\n{tails}")
    first, second = lines
    start = [x for x in second if x["chaos"] == "start"]
    done = [x for x in second if x["chaos"] == "done"]
    resumed = [x for x in second if x["chaos"] == "first_step"]
    adam = [max([x["adam"] for x in inc if "adam" in x] or [0])
            for inc in lines]
    if not restored or not start or start[0]["step"] != restored \
            or not resumed or resumed[0]["step"] != restored \
            or not done or min(adam) <= 0 \
            or done[0]["val_accuracy"] < XOR_ACC:
        raise AssertionError(f"(d) restored {restored}, second "
                             f"incarnation {second}, Adam {adam}\n{tails}")
    recover = resumed[0]["wall"] - killed_at
    log({"fleet_tools": "(d) kill_host chaos", "wall_s_with_b": wall,
         "restored_step": restored, "killed_at_step": max(
             [x["step"] for x in first if "step" in x] or [0]),
         "first_step_after_restore": resumed[0]["step"],
         "time_to_recover_s": recover, "val_accuracy":
         done[0]["val_accuracy"], "final_step": done[0]["step"],
         "adam_launches": adam, "report": rep, "card": smi})
    shutil.rmtree(root / FT_DIR, ignore_errors=True)
    return sum(adam)


def chaos_rank_main(args) -> int:
    """Phase 32 (d)'s supervised host, a process of this script: the XOR
    MLP of the port's ``example.py`` (its model, step and Adam kernel)
    through ``TrainSession`` with ``CheckpointHook(every_steps=
    FT_CHAOS_EVERY)``, restoring the latest checkpoint of
    ``DTTPU_CHAOS_DIR``; ``launcher.heartbeat()`` every step; JSON lines
    with the start step, the first step's end, Adam's launches every
    FT_CHAOS_PRINT steps, and the final val accuracy."""
    import os

    from distributed_tensorflow_tpu_torch.fleet import launcher
    launcher.heartbeat()

    import torch

    from distributed_tensorflow_tpu_torch import (data, ops, optim, parallel,
                                                  train)
    from distributed_tensorflow_tpu_torch._launch import start
    from distributed_tensorflow_tpu_torch.ops.kernels import fused
    from distributed_tensorflow_tpu_torch.parallel import cluster

    def say(**kw):
        print(json.dumps(dict(chaos=kw.pop("what"), **kw)), flush=True)

    device = start("cuda", cluster.cluster_from_env())
    mesh = parallel.data_parallel_mesh()
    model = ops.serial(
        ops.Dense(128, activation="relu"), ops.Dropout(0.3),
        ops.Dense(128, activation="relu"), ops.Dropout(0.3),
        ops.Dense(32, activation="sigmoid"))
    optimizer = optim.adam()
    (x_train, y_train), (x_val, y_val) = data.xor_data(30000, 1000,
                                                       seed=args.seed)
    dataset = data.Dataset([x_train, y_train], XOR_BATCH, seed=args.seed,
                           process_index=mesh.rank, process_count=mesh.size)
    metric_fns = {"accuracy": "bitwise_accuracy"}
    step_fn = train.make_train_step(model, "mse", optimizer,
                                    metric_fns=metric_fns, mesh=mesh,
                                    seed=args.seed)
    eval_step = train.make_eval_step(model, "mse", metric_fns=metric_fns,
                                     mesh=mesh)
    state = train.init_train_state(
        model, optimizer, torch.Generator(device).manual_seed(args.seed),
        (64,))
    hooks = [train.StopAtStepHook(last_step=FT_CHAOS_EPOCHS * len(dataset)),
             train.CheckpointHook(every_steps=FT_CHAOS_EVERY,
                                  every_secs=None)]
    fused.LAUNCHES.clear()
    with train.TrainSession(state, step_fn, hooks=hooks, is_chief=True,
                            checkpoint_dir=os.environ["DTTPU_CHAOS_DIR"]
                            ) as sess:
        say(what="start", step=sess.step, wall=time.time())
        first = True
        while not sess.should_stop():
            for batch in data.prefetch_to_device(iter(dataset),
                                                 device=device):
                if sess.should_stop():
                    break
                step = sess.step
                sess.run_step(batch)
                launcher.heartbeat()
                if first:
                    torch.cuda.synchronize()
                    say(what="first_step", step=step, wall=time.time())
                    first = False
                if sess.step % FT_CHAOS_PRINT == 0:
                    say(what="steps", step=sess.step,
                        adam=fused.LAUNCHES["adam"])
        val = eval_step(sess.state, (torch.from_numpy(x_val).to(device),
                                     torch.from_numpy(y_val).to(device)))
        say(what="done", step=sess.step, adam=fused.LAUNCHES["adam"],
            val_accuracy=float(val["accuracy"]))
    return 0


def check_fleet_tools(torch, np, args, smi, model=None):
    """Phase 32: the simulator against phase 4's engine (``model``; GPT-2
    small from ``--seed`` when None), at scale, the launcher's bring-up
    and its kill_host restart.  Returns the serving kernels' launches over
    (a)'s real replays, and Adam's over (d)'s two incarnations."""
    t_phase = time.perf_counter()
    if model is None:
        from distributed_tensorflow_tpu_torch import GPT, gpt_small
        model = GPT(gpt_small(dtype=torch.bfloat16), device="cuda",
                    generator=torch.Generator("cuda").manual_seed(args.seed))
    cm, launches = _tools_validate(torch, np, args, smi, model)
    launch = _tools_launch_start()          # (c) runs beside (d) and (b)
    try:
        chaos = {"fused_adam": _tools_chaos(
            torch, np, args, smi, lambda: _tools_scale(np, args, cm))}
    finally:
        _tools_launch_check(launch, smi)
    log({"phase": "fleet tools", "seconds": time.perf_counter() - t_phase})
    return launches, chaos


def _kernel_rows(prof):
    """(kernel name, device us, count) rows of a profile, largest first:
    kernels only, since an operator's row repeats its kernels' time."""
    def dev_us(e):
        t = getattr(e, "self_device_time_total", None)
        return t if t is not None else e.self_cuda_time_total
    return sorted(((e.key, dev_us(e), e.count) for e in prof.key_averages()
                   if str(getattr(e, "device_type", "")).endswith("CUDA")
                   and dev_us(e) > 0), key=lambda r: -r[1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--profile", metavar="DIR",
                    help="also profile the engine and training phases; "
                    "tables to DIR")
    ap.add_argument("--ep-seeds", metavar="S,S,...",
                    help="run only phase 29's (a) and (b), once a seed, "
                    "and log each arm's readings (no result line)")
    ap.add_argument("--tpf-seeds", metavar="S,S,...",
                    help="run only phase 30 without its kernel rows, once "
                    "a seed, and log its readings (no result line)")
    ap.add_argument("--tsp-seeds", metavar="S,S,...",
                    help="run only phase 31 without its kernel rows, once "
                    "a seed, and log its readings (no result line)")
    ap.add_argument("--fleet-tools", action="store_true",
                    help="run only phase 32 (on a GPT-2 small of its own) "
                    "and log its readings (no result line)")
    # a rank of phase 27, 28, 29, 30 or 31, or phase 32's supervised host
    # (``--ranks-for=tp|pp|ep|tpf|tsp|chaos``), started by the phase
    ap.add_argument("--ranks-for",
                    choices=("tp", "pp", "ep", "tpf", "tsp", "chaos"),
                    default=None, help=argparse.SUPPRESS)
    ap.add_argument("--rank", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--rank-port", type=int, default=None,
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if args.ranks_for is not None:
        return {"tp": tp_rank_main, "pp": pp_rank_main, "ep": ep_rank_main,
                "tpf": tpf_rank_main, "tsp": tsp_rank_main,
                "chaos": chaos_rank_main}[args.ranks_for](args)
    import numpy as np

    from distributed_tensorflow_tpu_torch.ops.kernels import _build

    t_start = time.perf_counter()
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = smi_line()
    log({"phase": "device", "name": name, "count": count, "nvidia_smi": smi,
         "torch": torch.__version__, "cuda": torch.version.cuda})

    secs = _build.build()
    log({"phase": "build", "seconds": secs, "dir": str(_build.BUILD_DIR)})
    if args.ep_seeds:
        return ep_spread(torch, np, args, smi)
    if args.tpf_seeds:
        return tpf_spread(torch, np, args, smi)
    if args.tsp_seeds:
        return tsp_spread(torch, np, args, smi)
    if args.fleet_tools:
        check_fleet_tools(torch, np, args, smi)
        return 0
    log_backward_resources(_build)
    records = check_kernels(torch, args)
    records.update(check_llama_kernels(torch, args))
    records.update(check_train_kernels(torch, args))
    launches, paged_run = check_engine(torch, np, args, smi)
    phase4 = {"launches": dict(launches),
              "tokens_per_s": paged_run["tokens_per_s"],
              "ttft_p50_s": paged_run["ttft_p50_s"]}
    decode_launches = collections.Counter(
        check_decode(torch, np, args, smi, paged_run["model"]))
    decode_launches.update(check_contiguous_engine(torch, np, args, smi,
                                                   paged_run))
    check_serve_surface(torch, np, args, smi, paged_run, dict(launches))
    obs_launches = collections.Counter(
        check_obs_engine(torch, np, args, smi, paged_run))
    fleet_launches = check_fleet(torch, np, args, smi, paged_run)
    sim_launches, chaos_launches = check_fleet_tools(
        torch, np, args, smi, paged_run["model"])
    if args.profile:
        profile_generate(torch, np, args, smi, paged_run["model"],
                         "profile_generate", GEN_BATCH, GEN_PROMPT, GEN_NEW)
    del paged_run
    check_reference(torch, np)
    check_decode_reference(torch, np)
    check_serve_reference(torch, np)
    train_launches, model, phase6 = check_training(torch, np, args, smi)
    launches.update((k, v) for k, v in train_launches.items()
                    if k != "layernorm")     # its record: serving shapes
    check_train_reference(torch, np)
    check_train_then_serve(torch, np, model)
    del model
    torch.cuda.empty_cache()
    session_launches = check_train_session(torch, np, args, smi, phase6)
    obs_launches.update(check_obs_session(torch, np, args, smi))
    t0 = time.perf_counter()
    model = _llama_model(torch, args)
    torch.cuda.synchronize()
    log({"phase": "llama init", "seconds": time.perf_counter() - t0})
    launches.update(check_llama_engine(torch, np, args, smi, model))
    check_llama_migration(torch, np, args, smi, model)
    decode_launches.update(check_llama_generate(torch, np, args, smi, model))
    if args.profile:
        profile_generate(torch, np, args, smi, model,
                         "profile_llama_generate", LLAMA_GEN_BATCH,
                         LLAMA_GEN_PROMPT, LLAMA_GEN_NEW)
    if args.profile:
        profile_engine(torch, np, args, smi, model, max_len=LLAMA_MAX_LEN,
                       name="profile_llama", parts=_LLAMA_PARTS)
        profile_paged_splits(torch, np, args, model)
    del model
    torch.cuda.empty_cache()
    check_llama_reference(torch, np)
    xor_launches = check_xor(torch, np, args, smi)
    seq_launches = check_sequential(torch, np, args, smi)
    zoo_launches = check_zoo(torch, np, args, smi)
    family_launches = check_gpt_family(torch, np, args, smi, phase4)
    hf_launches = check_hf(torch, np, args, smi)
    sp_routes, sp_launches = check_sp(torch, np, args, smi)
    zero_launches, zero_shard = check_zero(torch, np, args, smi)
    tp_launches, tp_rows = check_tp(torch, np, args, smi)
    pp_launches, pp_rows = check_pp(torch, np, args, smi)
    ep_launches, ep_rows = check_ep(torch, np, args, smi)
    tp_rows.update(ep_rows)
    tpf_launches, tpf_rows = check_tpf(torch, np, args, smi)
    for k, rows in tpf_rows.items():
        records[k]["tpf_shapes"] = rows
    tsp_launches, tsp_routes, tsp_ln = check_tsp(torch, np, args, smi)
    records["layernorm"]["tsp_shapes"] = {
        f"layernorm {tsp_ln['shape']} f32": tsp_ln}
    if args.profile:
        from distributed_tensorflow_tpu_torch import GPT, gpt_small
        profile_engine(torch, np, args, smi, GPT(
            gpt_small(dtype=torch.bfloat16), device="cuda",
            generator=torch.Generator("cuda").manual_seed(args.seed)))
        profile_training(torch, np, args, smi)
    # the last work on the card (see _LIB_BACKWARDS)
    lib_backwards = time_library_backwards(torch, args, smi)
    for case, recs in list(sp_routes.items()) + list(tsp_routes.items()):
        for route, rec in recs.items():
            if route.startswith("backward"):
                rec["library_graph_ms"] = lib_backwards.get(
                    f"ring {route.split('_')[1]} backward {case}")
    for case, recs in list(tp_rows.items()) + list(pp_rows.items()):
        recs["flash_backward"]["library_graph_ms"] = lib_backwards.get(
            f"whole backward {case}")
    for kernel, part in (("flash_forward", "forward"),
                         ("flash_backward_dq", "backward"),
                         ("flash_backward_dkv", "backward")):
        for key, case_routes in (("sp_routes", sp_routes),
                                 ("tsp_shapes", tsp_routes)):
            records[kernel][key] = {
                f"{case} {route}": rec for case, recs in case_routes.items()
                for route, rec in recs.items() if route.startswith(part)}
        for key, shape_rows in (("tp_shapes", tp_rows),
                                ("pp_shapes", pp_rows)):
            records[kernel][key] = {
                case: recs["flash_forward" if part == "forward"
                           else "flash_backward"]
                for case, recs in shape_rows.items()}

    kernels = [dict(name=k, route="cuda", source=r["source"],
                    replaces=r["replaces"], launches=launches[k],
                    max_abs_err=r["max_abs_err"], ms=r["ms"],
                    plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                    bound_by=r["bound_by"], library_ms=r["library_ms"],
                    graph_ms=r["graph_ms"],
                    library_graph_ms=r["library_graph_ms"],
                    **({"graph_note": r["graph_note"]}
                       if "graph_note" in r else {}),
                    **({"decode_launches": decode_launches[k]}
                       if k in decode_launches else {}),
                    **({"session_launches": session_launches[k]}
                       if k in session_launches else {}),
                    **({"xor_launches": xor_launches}
                       if k == "fused_adam" else {}),
                    **({"seq_launches": seq_launches[k]}
                       if k in seq_launches else {}),
                    **({"obs_launches": obs_launches[k]}
                       if k in obs_launches else {}),
                    **({"fleet_launches": fleet_launches[k]}
                       if k in fleet_launches else {}),
                    **({"sim_launches": sim_launches[k]}
                       if k in sim_launches else {}),
                    **({"chaos_launches": chaos_launches[k]}
                       if k in chaos_launches else {}),
                    **({"zoo_launches": zoo_launches[k]}
                       if k in zoo_launches else {}),
                    **({"gpt_family_launches": family_launches[k]}
                       if k in family_launches else {}),
                    **({"hf_launches": hf_launches[k]}
                       if k in hf_launches else {}),
                    **({"sp_launches": sp_launches[k]}
                       if k in sp_launches else {}),
                    **({"sp_routes": r["sp_routes"]}
                       if "sp_routes" in r else {}),
                    **({"zero_launches": zero_launches[k]}
                       if k in zero_launches else {}),
                    **({"zero_shard": zero_shard}
                       if k == "fused_adam" else {}),
                    tp_launches=tp_launches.get(k, 0),
                    **({"tp_shapes": r["tp_shapes"]}
                       if "tp_shapes" in r else {}),
                    pp_launches=pp_launches.get(k, 0),
                    **({"pp_shapes": r["pp_shapes"]}
                       if "pp_shapes" in r else {}),
                    ep_launches=ep_launches.get(k, 0),
                    tpf_launches=tpf_launches.get(k, 0),
                    **({"tpf_shapes": r["tpf_shapes"]}
                       if "tpf_shapes" in r else {}),
                    tsp_launches=tsp_launches.get(k, 0),
                    **({"tsp_shapes": r["tsp_shapes"]}
                       if "tsp_shapes" in r else {}))
               for k, r in records.items()]
    log({"total_s": time.perf_counter() - t_start})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

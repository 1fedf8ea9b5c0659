"""Smoke run of the PyTorch port on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py``.  It needs one CUDA
card, ``nvcc`` and the repository's ``src/repro_torch``; without a card it
exits non-zero and prints no result.

Phases, each of which fails the run:

1. the card's name and power limit, the torch and CUDA versions, and the
   build of every kernel source in the checkout (one nvcc per source, all
   started together; timed);
2. every kernel against its plain PyTorch version on the card: the
   serving kernel over the cases the serving path can give it (f32 and
   bf16, head_dim 64/128/256, GQA factors 1/2/4, blk_q 128 and 1, window
   and softcap, a dead block, a request at kv_len 0, padded rows; every
   bf16 case repeated and bitwise equal to its first call, which holds
   the split-kv merge to its order), the
   CA-server forward (out, lse) and backward (dq, dk, dv) over f32/bf16,
   head_dim 64/128/192/256, blocks 64/128, GQA factors 1/3/4, ragged and
   overlapping kv ranges, a zero-length task, padded rows, jmax < N, and
   causal / sliding-window+sink / dilated / softcap masks, every bf16
   backward repeated and bitwise equal to its first call; in every CA
   case the forward over kv-block ranges of 1, 2, 3 and 4 blocks with
   the carry threaded (``ca_server_fwd_range``) against its plain version
   and bitwise equal to the unstreamed kernel, and the backward with an lse cotangent (``g_lse``)
   against its plain version, a bf16 one repeated bitwise; the flash
   forward and backward over f32/bf16, head_dim 64/128/192, GQA 1/4,
   ragged documents with padding, causal / non-causal / window /
   window+sink / dilated masks, softcap 0/50, every bf16 backward repeated
   and bitwise equal to its first call (the worst bf16 error of each
   kernel reported beside f32's); the SSD intra-chunk forward (y, states)
   and backward (dC, dB, dx, ddt, dcsum) over chunk 64/128/256, N
   32/64/128, P 32/64, head-group factors 1/4/32 (G = H and G < H), no
   reset, a reset at the chunk start, resets mid-chunk, a reset at every
   position, and csums below -80, each case with f32 C, B, x (the FMA
   kernels) and with them rounded to bf16 (the tensor-core kernels, the
   bf16 backward repeated bitwise); the flash kernels at head_dim 256
   (f32/bf16, rep 1 and 16 over 1 kv head, causal, window 64 on ragged
   documents and window 2048 over 4096 tokens); the lru_scan forward (h)
   and backward (da, db) over f32/bf16, S 40 to 4097 (under one 64-step
   stage, one stage minus and plus one, 1000 and 4097 no multiple of any
   tile), W 20 to 4096 (under 32, no multiple of 32: through the TMA ring
   or, where a row is no multiple of 16 bytes, the direct variant), B 1
   to 3, inputs off 16-byte alignment (the direct variant), a = 0 at the
   start, mid-sequence and everywhere, and a = 0.999, every output
   bitwise equal, every case run twice and the runs bitwise equal;
3. the serving slice at full width: llama3-8b in bf16 from a seeded
   generator, behind ``launch/serve.py``'s HTTP daemon, answering eight
   requests, with the launch counts read around that run, the kernel held
   against its plain version on captured q and cache tensors, and fused
   prefill against the per-token loop (checked on an f32 copy of the
   weights, reported in bf16);
4. times at the serving path's shapes (llama3-8b's, and gemma2-2b's
   head_dim 256 on a local layer): the kernel, its plain version, one
   PyTorch library call for the same work and the least time the card
   could take; prefill tokens per second, decode time per step, peak
   memory; then phase 10's serving trace and phase 15;
5. the CAD training step at full width: llama3-8b (depth cut to 8 layers)
   in bf16 through ``trainer.train`` with a ``CADSession`` (4 simulated
   attention servers, 4 x 4096 tokens of ``prolong`` documents, policy
   ``balanced``, prefetch 2), 3 steps with the loss, step time, tokens per
   second, peak memory and the CA-server launch counts of each step,
   checked against servers x layers x forwards per layer; the step-0 loss
   under ``identity`` bitwise equal to ``balanced``'s; the kernels held
   against their plain versions on the server batches captured at layers
   0 and 7; the dispatch's backward repeated bitwise;
6. the CA-server kernels timed at the captured shapes against their
   bound, their plain versions and ``scaled_dot_product_attention`` with
   the equivalent mask (fwd and fwd+bwd), and beside them the flash
   kernels on the same layer's q/k/v (the same live pairs attended in
   place) as the yardstick; then phase 16;
7. colocated training (``attn_impl="pallas"``: each layer attends where
   it is, through the flash kernels) on phase 5's exact configuration,
   3 steps with the launch counts of each step checked against layers x
   {2 forwards, 1 dq, 1 dk/dv}, the step-0 loss bitwise equal to CAD's
   (both routes' bf16 forwards run the same tile arithmetic in the same
   order) while controls with a fault put in (documents merged, no causal
   mask; those of CO_REQUIRED_CONTROLS) fall outside CO_LOSS_LIMIT of it,
   the flash kernels
   held against their plain versions on the q/k/v captured at layers 0
   and 7, their backward repeated bitwise, and the ``xla`` route against
   the kernel; then the same configuration in f32 with 2 layers, one step
   of CAD and one colocated, whose step-0 losses must be bitwise equal
   (both routes' f32 kernels share their arithmetic and tile order);
8. the flash kernels timed at layer 0's shape against their bound, their
   plain versions and ``scaled_dot_product_attention`` with the dense
   boolean mask (fwd, bwd, fwd+bwd), with the SM clock nvidia-smi reads
   while the kernels run, the document prune ``flash_tile_ranges`` beside
   them; then the same at head_dim 192 on layer 0's documents with seeded
   q/k/v;
9. the ``xla`` route (the training launcher's default without --cad) on
   CUDA tensors: one step at llama3-8b width with 2 layers, and the
   launcher itself on a reduced model;
10. serving traced, right after phase 4 while the llama3-8b engine is
   loaded: one 512-row prefill chunk and one decode step, each a device
   call traced with ``torch.profiler`` (device ms by kernel family, the
   ragged kernel's share, the device's idle share of the call); and,
   after phases 11-14, one step each of CAD and colocated training
   (phases 5 and 7's configuration), of mamba2 training (phase 11's) and
   of recurrentgemma training (phase 13's), the second step of a fresh
   2-step run, traced with ``torch.profiler``: device time by kernel
   family (SSD, flash, LRU, CA and ragged kernels, cuBLAS matmuls,
   copies, the rest by name), the CA kernels' share of the busy time, each
   hand-written kernel's launches, busy time, the device's idle share
   inside the step and the SM clock through it; and in each traced window
   (the serving calls too) device ms by bucket: attention, attention_bwd,
   moe_experts, unembed, dispatch, bwd_other, fwd_other, each kernel
   taking its launching op's (``launch/breakdown.py``, which holds the
   kernel families and ``device_breakdown``).  It runs after phases
   11-14, before phase 13's xla-route check;
11. mamba2-370m at full width and depth (48 layers, bf16, seeded weights)
   through ``trainer.train`` with ``attn_impl="pallas"`` and remat, 3
   steps on 4 x 4096 ``prolong`` tokens: loss, grad norm, step time,
   tokens per second, peak memory and the SSD launch counts of each step,
   checked against layers x {2 forwards, 1 head-part kernel, 1 fold
   kernel} of the bf16 tensor-core kernels and no other kernel; those
   kernels held against their plain versions on the bf16 inputs captured
   at layers 0 and 47, the backward repeated bitwise; then the routes
   against each other at mamba2-370m's widths with the depth cut to
   MAMBA_CHECK_LAYERS, one step each of the kernel route and the einsum
   route (``attn_impl="xla"``): in bf16 the step-0 losses within
   MAMBA_LOSS_LIMIT, as three more honest gaps must be, while the
   controls of MAMBA_REQUIRED_CONTROLS (faults put into the kernel
   route's intra-chunk step) fall outside; in f32 (the FMA kernels)
   bitwise equal; then, at full depth in bf16 (forward only), every
   layer's intra-chunk step held against the plain version on the same
   inputs, and both routes' losses beside witnesses (the plain version in
   f64, in f32 summing j in 16-row blocks, with TF32 C·Bᵀ) and a fault:
   the kernel route's gap within MAMBA_DEPTH_FACTOR x the unbiased
   witnesses' largest;
12. the SSD kernels timed at layer 0's captured shape, bf16 (the
   tensor-core kernels) and the same values in f32 (the FMA kernels),
   against their bound (at the tensor-core rate of the inputs, bf16 or
   TF32, with the f32 FMA-pipe figure beside it), their plain versions
   and the SM clock; the backward's ``ms`` times its kernel launches
   alone, its ``wrapper_ms`` the wrapper, which ends at its kernels;
13. recurrentgemma-9b at full width (d_model 4096, lru_width 4096, 16 q
   heads over 1 kv head of 256, d_ff 12288, vocab 256000, window 2048),
   depth cut to 6 layers (the pattern rglru, rglru, local twice), bf16,
   seeded weights, through ``trainer.train`` with ``attn_impl="pallas"``
   and remat, 3 steps on 2 x 4096 ``prolong`` tokens: loss, grad norm,
   step time, tokens per second, peak memory and the launch counts of
   each step, checked against rglru layers x {2 lru_scan forwards, 1
   backward} and local layers x {2 flash forwards, 1 dq, 1 dk/dv}; the
   lru_scan kernels held bitwise against their plain versions on the a
   and bterm captured at the first and last rglru layers, the flash
   kernels against theirs on the first local layer's q/k/v, both
   backwards repeated bitwise; last (after phase 10), one step of the
   ``xla`` route on the same weights and batch, its step-0 loss within
   RG_LOSS_LIMIT of the kernel route's, and controls with a fault put in
   (the scan's inputs in bf16, the scan's resets dropped, documents
   merged, no window), those of RG_REQUIRED_CONTROLS outside the limit;
14. lru_scan timed at the first rglru layer's captured shape against its
   bound (bytes), its plain version and the SM clock (no PyTorch call
   computes a linear recurrence: no library time), one launch and back
   to back, its GB/s beside the card's own copy rate on the same bytes,
   each kernel's registers (ptxas and the card), shared memory and CTAs
   an SM; the flash kernels at
   head_dim 256 timed at the first local layer's shape as phase 8 times
   them, SDPA with the boolean window mask beside them;
15. (run after phase 4) gemma2-2b served at full width and depth (26
   layers, head_dim 256, 8 q over 4 kv heads, window 4096, softcaps 50
   and 30, vocab 256000; bf16, seeded weights, 4 slots x 6144 positions)
   through ``Engine.serve``: 4 prompts of 4500-5000 tokens and 16 new
   tokens each, launches = 26 x device calls, every token in the
   vocabulary, the kernel against its plain version on the inputs of the
   first local and global layers, prefill tokens per second and decode
   ms per step;
16. (run after phase 6) a CAD training step of gemma2-2b at full width
   (8 q over 4 kv heads of 256, softcaps 50 and 30, vocab 256000), depth
   cut to 4 layers (local, global, local, global), bf16, 4 x 2048
   ``prolong`` tokens on 4 simulated servers, 2 steps: the global layers
   through ``ca_server`` at head_dim 256 with the softcap, the local
   layers on the dispatch's windowed fallback; launches = servers x 2
   global layers x {2, 1, 1} a step and no other kernel, the step-0 loss
   bitwise equal under ``identity`` and ``balanced``, the kernels held
   against their plain versions on the first global layer's server
   batches (backward repeated bitwise) and timed there;
17. (run after phase 6) the decomposed dispatch and the ring baseline at
   llama3-8b width, on phase 5's captured layer-0 q/k/v, segment ids and
   plan (4 servers, jmax 32), with the launch counts read around it:
   ``build_server_inputs`` -> ``serve_task_batch`` ->
   ``assemble_step_outputs`` bitwise equal to ``_global_sim``; server 1
   dropped, re-served and merged (``merge_recovered``) bitwise equal to
   the fault-free output; streamed serves in ranges of 1, 4, 7 and 32 kv
   blocks bitwise equal to unstreamed; ``ring_attention`` bitwise equal
   to ``ring_global_sim``, forward and gradients, and within
   RING_GAP_LIMIT of CAD (its gradients within RING_GRAD_GAP_LIMIT) while
   the control of RING_REQUIRED_CONTROLS (a ring pass dropped) falls
   outside both; the range forward at 4 kv blocks a range and the
   ``g_lse`` backward on phase 6's batches held against their plain
   versions (the latter repeated bitwise); then CAD's per-server serves
   timed against the ring's passes and merges (fwd, fwd+bwd; the ring
   is an unfused baseline, its eager f32 merges over every task slot,
   so its times are an upper bound), one ring forward traced by kernel
   family, the streamed forward at each range size against the
   unstreamed one (the bound counting the carries), and the ``g_lse``
   backward timed;
18. (run after phase 17) phase 5's configuration with ``calibrate=True``
   and ``calibrate_every=1``, 3 steps: each step's plan probed in bf16
   on the card after the step (``probe_plan_times``) and fed to the
   calibrator; the step-0 loss bitwise equal to phase 5's, launches =
   phase 5's + the probe's 5 forwards, later plans carrying their
   ``calib_version``; the fitted grid cells logged beside the analytic
   model's prediction, and the per-server speeds.  Then the witness for
   its later losses: the steps whose calibrated plan differs from the
   uncalibrated planner's on the same batch are listed, and the
   calibrated run's batches and plans replayed through an uncalibrated
   session (no calibrator, no probe) must give its losses bitwise: the
   plans alone decide them;
19. (run after phase 17, and after phase 18) the elastic runtime: the
   ``ElasticExecutor`` on phase 5's captured layer-0 q/k/v and segment
   ids (4 servers, ``balanced``, bf16), with the launch counts read
   around each step: fault-free bitwise equal to ``_global_sim``;
   ELASTIC_KILL over 3 steps bitwise equal to the fault-free output and,
   at steps 1 and 2, to an executor whose pool lacks server 2;
   ELASTIC_FLAP rejoining at step 2; ELASTIC_SLOW with speculation
   speculating server 3; the kill streamed in ranges of
   ELASTIC_STREAM_CHUNK kv blocks and traced, each bitwise; the trace
   report naming the killed and the speculated server; CA-forward
   launches = served + recovery servers (x ranges streamed); no
   serve-error; the kill under the ``wall`` timer, each server's
   synchronized serve and recovery ms beside the model's.  Then phase
   5's run under TRAIN_KILL (step-0 loss bitwise phase 5's, a later
   epoch and 3 active servers after it, no later plan giving server 1 a
   task, launches as phase 5's), and CKPT_ARCH at full width and depth
   in bf16 trained 2 CAD steps with a calibrator and ``ckpt_every=1``:
   the checkpoint restored into a fresh model and ``AdamWState`` on the
   card bitwise, dtypes kept, the calibration equal; its size and the
   save and restore seconds;
20. (last, with 21-23) nemotron-4-340b served at every width, depth cut
   to NEMOTRON_LAYERS of 96 (head_dim 192, 96 q over 8 kv heads, relu²
   MLP, vocab 256000; bf16, seed 0), 4 slots x 2048, 4 prompts of
   1500-1900 tokens in 512-token chunks, 16 new tokens: launches =
   layers x device calls, the kernel on layer 0's captured first prefill
   chunk and decode step against its plain version, prefill tokens/s,
   decode ms a step, one decode step traced (host against busy ms), peak
   memory, and the kernel timed at this head_dim as phase 4 times it;
21. mamba2-370m served at full width and depth (48 ssd layers), 4 slots,
   prompts of 100-300 tokens prefilled a token a step, 32 new tokens: no
   kernel launch (its SSD layers decode in torch ops, as the
   reference's), the concurrent run's tokens equal to those of its SOLO
   shortest prompts served alone (which idled through the others'
   prefill steps), rates at the middle of its prompt lengths (4 x 200),
   one decode step traced, peak memory; then an f32 copy of 2 layers:
   per-token serve logits against ``Transformer.forward``'s within
   SERVE_FWD_REL_BOUND, the controls SERVE_FWD_CONTROLS outside it (TF32
   matmuls, the state reset at every token), a third (the recurrent
   state stored in bf16) recorded;
22. recurrentgemma-9b served at full width and depth (38 layers, 12 of
   them local), as phase 21 with prompts of 50-200 tokens (rates at 4 x
   125) and 16 new: the ragged kernel once a local layer a device call,
   held against its plain version on a captured decode step of layer 2,
   and timed as phase 4 times it at the local layers' decode shape with
   kv 3000, past the window; the f32 check at 3 layers (rglru, rglru,
   local);
23. llama3-34b (the paper's 34B) trained under CAD at every width, depth
   cut to LLAMA34_LAYERS of 48, 4 simulated servers, 4 x LLAMA34_SEQ
   ``prolong`` tokens, ``balanced``, 3 steps: launches = servers x
   layers x {2, 1, 1}, finite losses, the step-0 loss bitwise equal
   under ``identity``,
   the CA kernels on layer 0's captured server batches against their
   plain versions, step ms, tokens/s, peak memory;
24. (after 28, before 29) CAD across ranks and the fabric, on phase 5's
   captured layer 0: (a) this process joins an NCCL group of world size
   1 on cuda:0 and trains phase 5's configuration with a 1-server plan
   and ping-pong on (RANKS_STEPS steps), once over the group and once
   through ``_global_sim`` on the same batches and weights: the step-0
   losses bitwise equal, launches = 2 nano-batches x layers x {2, 1, 1}
   a step in both; one layer-0 forward of the group run traced
   (nano-batch 1's send starts before nano-batch 0's CA forward ends,
   the overlap logged) and its backward (the exchanges' overlap with the
   CA backward kernels logged); (b) RANKS_GLOO processes on the one card
   joined under gloo, each taking its rows of the captured q/k/v through
   the group's ``cad_attention``, forward and backward: out, dq, dk and
   dv bitwise equal to ``_global_sim``'s on the card (a gloo whose
   ``all_to_all`` refuses CUDA tensors, GLOO_REFUSAL, is recorded and (b)
   dropped; any other error fails the phase); (c) ``FabricExecutor``
   with requests of FABRIC_PROMPTS tokens and FABRIC_NEW decode steps at
   llama3-8b's heads, until all complete: every step's training output
   bitwise phase 19's fault-free output, CA-forward launches = train and
   recovery serves + serve batches, FABRIC_KILL (a server lost
   mid-decode) giving the fault-free digests; serve ms (wall timer) and
   the admitted and deferred counts logged.

Phase 2 also runs the ragged kernel over long caches (LONG_RAGGED):
head_dim 192 with windows 0 and 4096 past 4096 slots, and
recurrentgemma's rep 16 over one kv head of 256 with window 2048.

Kernels timed twice (the forward kernels, before and after the library
call) report the first median as ``ms`` and the second as ``ms_repeat``.
The ragged kernel, whose launches last about as long as the wrapper's
host time, is timed three ways: ``ms`` for calls back to back (what the
card sustains), ``device_ms`` from the profiler (the kernel alone) and
``ms_single`` for a lone call between two events (how every other kernel
is timed).

25. (after phase 23, before 24) qwen2-moe-a2.7b (MHA: 16 q over 16 kv
   heads, rep 1; 60 routed experts top-4 and 4 shared) trained at every
   width, depth cut to MOE_LAYERS of 24, bf16, 4 x MOE_SEQ ``prolong``
   tokens: under CAD on 4 simulated servers the step-0 loss bitwise equal
   under ``identity`` and ``balanced``, the same forward and backward run
   twice bitwise (loss, aux losses, every gradient), MOE_STEPS steps with
   launches = servers x layers x {2, 1, 1} and finite loss, ``moe_lb``
   and ``moe_z``; the CA kernels on layer 0's captured server batches
   against their plain versions and timed beside flash on the same
   layer (phase 6's way); then colocated (``pallas``) on the same weights
   and batches, launches layers x {2, 1, 1} and 3 prunes a layer, the
   step-0 loss bitwise CAD's with phase 7's controls outside
   CO_LOSS_LIMIT, the flash kernels on the captured q/k/v; step ms,
   tokens/s, peak memory;
26. (after 25) the MoE archs served through ``launch/serve.py``'s engine
   at every width, a token a step (MOE_SERVE): qwen2-moe-a2.7b at 12 of
   24 layers, 4 slots, prompts of 100-300 tokens, 16 new: launches = layers
   x device calls, the kernel on a captured decode step, the concurrent
   run's tokens equal to its SOLO shortest prompts' served alone, rates
   and one decode step traced; an f32 copy of MOE_FWD_LAYERS layers:
   per-token serve logits within SERVE_FWD_REL_BOUND of
   ``Transformer.forward``'s (at a capacity factor that drops nothing;
   the drops the config's own factor would make logged), the TF32
   control outside; llama4-maverick-400b-a17b at 1 of 48 layers (128
   experts top-1 and a shared one, the kernel at rep 5) the same way
   without the solo and f32 checks; then the ragged kernel timed at both
   archs' decode shapes as phase 4 times it;
27. (after 26, before 24) whisper-large-v3 at full size (32 encoder and
   32 decoder ``cross`` layers, d_model 1280, 20 heads of 64, vocab
   51866), bf16 from seed 0, every ``xgate`` at CROSS_GATE (the
   reference's 0 would make cross-attention add nothing), the memory
   seeded [4, 1500, 1280]: (a) CAD on 4 simulated servers, 4 x CROSS_SEQ
   ``prolong`` tokens, ``balanced``, CROSS_STEPS steps through
   ``make_train_step`` with the memory added to each batch: CA launches
   servers x 32 x {2, 1, 1} a step and no other kernel (cross-attention
   and the encoder take the ``xla`` route), step 1 traced by family (CA,
   cuBLAS, the ``xla`` route, other), the step-0 loss bitwise equal under
   ``identity`` and on a repeat and moved by the memory rows rotated
   across the batch, the CA kernels on layer 0's captured server batches
   against their plain versions and timed beside flash (phase 6's way);
   (b) served at full depth through ``Engine(memory=...)``'s legacy
   branch (a dense 4 x 128 prompt batch, 16 new tokens, a token a step,
   no kernel launched): build and encode ms, prefill tokens/s, decode
   ms a step, one decode step traced, peak memory; the prompts and
   memory rows permuted together give the tokens permuted, bitwise; an
   f32 copy at WHISPER_FWD_LAYERS: per-token decode logits within
   SERVE_FWD_REL_BOUND of ``Transformer.forward``'s, the TF32 and
   rotated-memory controls outside;
28. (after 27) llama-3.2-vision-11b the same way: (a) at every width
   with 5 of 40 layers (4 ``global`` + 1 ``cross``; the full config has
   no encoder), memory [4, 6404, 4096], CA launches servers x 5 x {2, 1,
   1}; (b) served at all 40 layers; the f32 copy has 5 layers.
29. (after 24: it spawns, and no traced window may follow it)
   pipeline parallelism with CAD across stages: PIPE_STAGES processes on
   the one card joined under gloo, each one stage of llama3-8b at every
   width (one layer a stage, seed 0), PIPE_MICRO microbatches of [1,
   PIPE_SEQ] ``prolong`` tokens in bf16 under ``cad`` with remat, one
   plan a tick (``tick_schedules``): one forward and backward of the
   pipelined loss, computed on PIPE_LOSS_RANK alone, then an f32 copy's
   forward.  Each tick's moves and loads (max/mean before and after
   scheduling) logged, tick 0 moving tasks and every idle stage of the
   warm-up and drain ticks serving others' tasks; CA launches a rank a
   tick (1 forward; 1 remat forward, 1 dq, 1 dk/dv backward); the
   outputs replicated bitwise on every rank and, with the losses and
   every gradient, bitwise equal to the one-process tick simulation's
   on the card; each microbatch's logits and loss bitwise equal to
   ``Transformer.forward`` on that microbatch alone (one server, its
   identity plan); the f32 copy's logits within PIPE_F32_REL_BOUND of
   its unpipelined forward's; per-rank peak memory and seconds (gloo
   stages CUDA tensors through the host: not speed figures).  No error
   of a rank is caught.
30. (after 29: it spawns too) the per-rank runtime: RT_RANKS
   processes on the one card joined under gloo, each a CAD rank of
   smollm-360m at every width (RT_LAYERS of 32 layers, seed 0), a [1,
   RT_SEQ] ``prolong`` row a rank in bf16, ``balanced``, prefetch 2:
   RT_STEPS steps of ``trainer.train`` with ``calibrate=True``,
   ``calibrate_every=1`` and RT_FAULTS, then an f32 copy the same way.
   In each, every step's plan digest,
   calibration version and pool stats equal on every rank; the
   calibrator's state equal on every rank after every probe; each rank's
   probe launches the CA forward 1 + 1 times (a warm-up, its own
   server), the one-process probe 1 + RT_RANKS; from the kill on, no
   live task on the killed server at pool epoch 1 with 3 active; CA
   launches a rank a step RT_LAYERS x {2, 1, 1}; the parameters bitwise
   equal across the ranks after every step; the one-process trainer on
   the card, replaying the gathered observations, builds the same plans;
   the bf16 step-0 loss bitwise its, the f32 copy's losses within
   RT_LOSS_RTOL (the bf16 gaps logged).  Probe seconds by server and
   step, peaks and times logged (not speed figures).
31. (last, after 30: it spawns too) the sharding rules on a data 2 x
   model 2 grid (``launch.mesh.join_grid``): GRID_RANKS processes on the
   one card under gloo, each model index's data ranks a CAD group, every
   tensor stored as its placement says (FSDP: split over the data ranks
   on its dmodel dim, gathered where a layer reads it), bf16, seed 0:
   (a) llama3-8b and (b) smollm-360m (15 heads padded to 16: 8 MHA heads
   of 64 a rank) at every width with 2 layers, a [1, 4096] row a data
   rank, and (c) qwen2-moe-a2.7b with expert parallelism (30 experts a
   data rank, the expert width split over the model ranks), 2 layers,
   [1, 2048] a data rank, 2 ``cad`` steps each; (e) mamba2-370m (2
   layers, the SSD kernels at full width on every model rank) and (f)
   recurrentgemma-9b (rglru, rglru, local: lru_scan on 2048 channels a
   rank, flash on 8 heads of 256) at every width, [1, 4096] a data rank,
   2 steps on the ``pallas`` route of a sessionless grid; (g)
   whisper-large-v3 at every width, 2 encoder and 2 decoder layers, a
   memory of 1500 frames, [1, 4096] a data rank, 2 ``cad`` steps; each
   then an f32 copy's step; (a) also on the colocated ``pallas`` route;
   (d) llama4-maverick at every width, 1 layer, one ``cad`` forward (64
   experts, 8 GB, a rank); (h) smollm-360m, 4 layers, 4 ``cad`` steps
   with a probe a step, server 1 killed before step 2 and a checkpoint
   after it.  Against the one-process runs on the same weights and
   batches (run before the spawn, maverick's 32 GB of experts first):
   the f32 step-0 loss and grad norm within GRID_F32_LIMIT (a fault
   control outside), the bf16 gaps logged, expert-parallel routing
   equal but at near-ties, the tensors every data rank holds bitwise
   across them, plan digests equal on every rank, each path's
   launches a rank a step, the stored parameter and moment bytes the
   placements' shard sizes; (h)'s plans, calibrator states and pool
   epochs equal on every rank, the one-process trainer replaying its
   observations pulling its plans, its checkpoint loading into one
   process bitwise; then the CA kernels on (a)'s, (b)'s and (g)'s
   captured server batches at the per-rank shapes, against their plain
   versions and timed (PERF.md rows 4g/5g, 4p/5p, 4h/5h), and the SSD,
   lru_scan and flash kernels on (e)'s and (f)'s captured inputs.
32. (after 28, before 24: it traces) the launch tooling
   (``repro_torch.launch``): (a) started right after phase 1, two host
   processes dry-run LAUNCH_ARCH x LAUNCH_SHAPE on the reference's 16 x 16
   grid, plain and with CAD (``launch.dryrun``: rank 0's step on the meta
   device over a fake process group of 256 ranks, under the op counter),
   read back here: trace seconds, per-rank argument, temp and peak bytes,
   FLOPs, collective bytes and the roofline row on the H100's rates;
   (b) LAUNCH_ARCH at LAUNCH_LAYERS layers, one rank, LAUNCH_ROWS x 4096
   tokens, ``xla`` route with remat, through ``launch.perf.measure``: the
   dry run's argument bytes equal the card's parameters, AdamW moments and
   batch exactly, the op counter's FLOPs of the step on the card equal
   its meta trace's exactly, the predicted peak beside
   ``max_memory_allocated`` (reported); (c) the same step traced: device
   ms by bucket beside each bucket's compute and memory terms.

The line before the card line lists every ported kernel as JSON; the last
line is ``{"ok": true, "device": {...}}``.  ``--only kernels`` stops after
phase 2: the short first call for a new kernel; ``--only ranks`` runs
phases 1, 5 and 24; ``--only moe`` phases 1, 25 and 26; ``--only
cross`` phases 1, 27 and 28; ``--only pipeline`` phases 1 and 29;
``--only rank_runtime`` phases 1 and 30; ``--only grid`` phases 1 and
31; ``--only launch`` phases 1 and 32.  Every traced
or profiled window opens with LEAD_IN_KERNELS spin kernels
(TRACE_LEAD_IN_CYCLES in all, ~2 ms), not counted.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM data-sheet peaks (dense): the bounds below divide by these
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
TF32_FLOPS = 495e12        # f32 operands on the tensor cores
F32_FMA_FLOPS = 67e12      # f32 outside the tensor cores

# every phase runs on the card; the constant names the device once
DEVICE = "cuda"

F32_ATOL = 1e-5
# bf16 outputs are rounded to 8 significant bits: one rounding step of a
# value near 1 is 2**-8 ~ 4e-3, and the two versions may round a
# different f32 sum
BF16_ATOL = BF16_RTOL = 2e-2
# fused and per-token prefill of one prompt through the 32 layers, on an
# f32 copy of the weights: the two paths sum in other orders (512-row vs
# 4-row matmuls, blk_q 128 vs 1 kernel launches), each f32 rounding
# ~1e-7 relative; bound on max |logit difference| / std(logits).  In bf16
# each matmul output may round one bf16 step apart (2**-8), which 32
# layers carry to ~0.1 of std: reported, not checked.
PREFILL_REL_BOUND = 1e-3


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters=20, warmup=3):
    """Median of per-launch CUDA-event times, in ms."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def cuda_ms_back_to_back(fn, n=100, reps=5, warmup=3):
    """Median over ``reps`` runs of the CUDA-event time of ``n`` calls
    issued back to back, divided by ``n``, in ms: what the card sustains
    while the host keeps ahead of it (host-bound calls show the host's
    time instead)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    times.sort()
    return times[reps // 2]


# torch.profiler windows a timing may take: in one card run of the 20
# calls of a 0.05 ms kernel, a window came back with no device event at
# all (its cause is not known; every other window of that run and of the
# runs before and after had them), so an empty window is profiled again.
# In two later runs all three windows of phase 22's timing came back
# empty: that device time is then not measured (None), and the run goes
# on with the same call's CUDA-event times beside it.  Every run logs how
# many windows came back empty and how many timings got none
# (kernel_times).
PROFILE_WINDOWS = 3
# [empty windows, windows profiled, timings with no device time]
EMPTY_PROFILE_WINDOWS = [0, 0, 0]
# a traced window's opening spin (GPU cycles in all, ~2 ms at 1.98 GHz),
# in LEAD_IN_KERNELS launches, and the name of the kernel
# ``torch.cuda._sleep`` launches for it.  Late in a run the profiler drops
# a window's first device events, the same count in every window of a
# phase: one 1 ms spin absorbed that until phases 27-28 ran before phase
# 24, whose windows then each lost the spin and their first 4 NCCL
# events (NVIDIA H100 80GB HBM3); 64 launches absorb 64.
TRACE_LEAD_IN_CYCLES = 4_000_000
LEAD_IN_KERNELS = 64
SPIN_KERNEL = "spin_kernel"


def trace_lead_in(torch):
    """Open a traced window: LEAD_IN_KERNELS spin kernels, not counted."""
    for _ in range(LEAD_IN_KERNELS):
        torch.cuda._sleep(TRACE_LEAD_IN_CYCLES // LEAD_IN_KERNELS)


def profiled_device_ms(fn, n=20):
    """Device time a call from ``torch.profiler``: the durations of the
    kernels ``n`` calls launched, summed and divided by ``n``, in ms (the
    host's time between launches is not in it).  A window in which the
    profiler delivered no device event is profiled again, up to
    PROFILE_WINDOWS windows, and counted in EMPTY_PROFILE_WINDOWS; when
    none has device time the result is None: not measured."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import breakdown
    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_WINDOWS):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            # the window opens with spin kernels, not counted: late in a
            # run the profiler has dropped a window's first events
            trace_lead_in(torch)
            torch.cuda.synchronize()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        us = sum(e.time_range.end - e.time_range.start for e in prof.events()
                 if breakdown.is_kernel(e) and SPIN_KERNEL not in e.name)
        EMPTY_PROFILE_WINDOWS[1] += 1
        if us:
            return us / 1e3 / n
        EMPTY_PROFILE_WINDOWS[0] += 1
    EMPTY_PROFILE_WINDOWS[2] += 1
    log(f"  the profiler recorded no device time in {PROFILE_WINDOWS} "
        f"windows: device time not measured")
    return None


def _ms4(x) -> str:
    return "not measured" if x is None else f"{x:.4f}"


# ------------------------------------------------------------ phase 2
def _decode_case(torch, gen, *, dtype, dh, rep, blk_q, window, softcap,
                 hkv=2, R=4, S=1024):
    """Kernel inputs with a dead block, a request at kv_len 0, padded rows
    and ragged lengths, on the card."""
    dev = "cuda"
    hq = hkv * rep
    k = torch.randn(R, S, hkv, dh, generator=gen, device=dev).to(dtype)
    v = torch.randn(R, S, hkv, dh, generator=gen, device=dev).to(dtype)
    kv_len = torch.tensor([1000, 300, 0, 777], dtype=torch.int32,
                          device=dev)
    if blk_q == 1:
        block_req = torch.tensor([0, 1, -1, 2, 3], dtype=torch.int32,
                                 device=dev)
        pos = torch.tensor([999, 299, -1, 0, 776], dtype=torch.int32,
                           device=dev)
    else:
        block_req = torch.tensor([0, 1, -1, 2, 3], dtype=torch.int32,
                                 device=dev)
        rows = [torch.arange(872, 1000), torch.arange(172, 300),
                -torch.ones(128, dtype=torch.long), torch.arange(0, 128),
                torch.arange(649, 777)]
        rows[1][100:] = -1                     # padded rows inside a block
        pos = torch.cat(rows).to(device=dev, dtype=torch.int32)
    t = block_req.shape[0] * blk_q
    q = torch.randn(t, hq, dh, generator=gen, device=dev).to(dtype)
    return dict(q=q, k_cache=k, v_cache=v, block_req=block_req, q_pos=pos,
                kv_len=kv_len, window=window, softcap=softcap)


def _max_err(torch, out, ref, dtype):
    err = (out.float() - ref.float()).abs()
    if dtype == torch.float32:
        ok = bool((err <= F32_ATOL).all())
    else:
        ok = bool((err <= BF16_ATOL + BF16_RTOL * ref.float().abs()).all())
    return float(err.max()), ok


def check_ragged_decode_cases(torch, ops):
    """Phase 2: the kernel against ragged_decode_reference on the card.
    Every bf16 case runs twice: the split-kv merge takes the parts in
    order, so the repeat must be bitwise equal."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    n = 0
    for dtype in (torch.float32, torch.bfloat16):
        for dh in ops.RAGGED_HEAD_DIMS:
            for rep in (1, 2, 4):
                for blk_q in (128, 1):
                    for window, softcap in ((0, 0.0), (256, 0.0),
                                            (0, 50.0), (256, 50.0)):
                        case = _decode_case(torch, gen, dtype=dtype, dh=dh,
                                            rep=rep, blk_q=blk_q,
                                            window=window, softcap=softcap)
                        out = ops.ragged_decode_attention(**case)
                        again = ops.ragged_decode_attention(**case) \
                            if dtype == torch.bfloat16 else out
                        torch.cuda.synchronize()
                        ref = ops.ragged_decode_reference(**case)
                        torch.cuda.synchronize()
                        err, ok = _max_err(torch, out, ref, dtype)
                        dead = out.reshape(5, blk_q, -1)[2]
                        if not ok or bool(dead.ne(0).any()) \
                                or not torch.equal(out, again):
                            raise SystemExit(
                                f"ragged_decode disagrees: dtype={dtype} "
                                f"dh={dh} rep={rep} blk_q={blk_q} "
                                f"window={window} softcap={softcap} "
                                f"max_err={err} repeat bitwise "
                                f"{torch.equal(out, again)}")
                        worst[dtype] = max(worst[dtype], err)
                        n += 1
    log(f"phase 2: ragged_decode kernel == plain version in {n} cases "
        f"(head_dim {ops.RAGGED_HEAD_DIMS}, rep 1/2/4, blk_q 128/1; f32 "
        f"max |err| {worst[torch.float32]:.3e} <= {F32_ATOL}; bf16 max "
        f"|err| {worst[torch.bfloat16]:.3e} within atol=rtol={BF16_ATOL}, "
        f"every bf16 repeat bitwise equal)")
    return worst[torch.float32]


# phase 2's long-cache cases: (name, dh, hq, hkv, windows, softcaps, S,
# kv_len per request).  nemotron-4-340b's head_dim 192 with the windows 0
# and 4096 (past 4096 slots, so the window binds) and softcaps 0 and 50;
# recurrentgemma-9b's local layers: 16 q heads over one kv head of 256,
# window 2048, kv lengths past it.  The bf16 decode cases are cut in
# split-kv parts (10 CTAs in 24 parts at dh 192, 5 in 12 at rep 16), and
# so is the dh-192 prefill (80 CTAs in 3 parts; rep 16's 160 are not).
LONG_RAGGED = (
    ("dh 192", 192, 8, 2, (0, 4096), (0.0, 50.0), 6144,
     (5000, 4300, 0, 4200)),
    ("rep 16 / hkv 1 / dh 256", 256, 16, 1, (2048,), (0.0,), 3072,
     (3000, 2049, 0, 2500)),
)


def _long_case(torch, gen, *, dtype, dh, hq, hkv, blk_q, window, softcap, S,
               kv):
    """A dead block, a request at kv_len 0, padded rows inside a block,
    and the others' rows at the end of kv lengths past the window."""
    dev = "cuda"
    R = len(kv)
    k = torch.randn(R, S, hkv, dh, generator=gen, device=dev).to(dtype)
    v = torch.randn(R, S, hkv, dh, generator=gen, device=dev).to(dtype)
    kv_len = torch.tensor(kv, dtype=torch.int32, device=dev)
    block_req = torch.tensor([0, 1, -1, 2, 3], dtype=torch.int32,
                             device=dev)
    if blk_q == 1:
        pos = torch.tensor([kv[0] - 1, kv[1] - 1, -1, 0, kv[3] - 1],
                           dtype=torch.int32, device=dev)
    else:
        rows = [torch.arange(n - 128, n) for n in (kv[0], kv[1])]
        rows[1][100:] = -1                     # padded rows inside a block
        rows += [-torch.ones(128, dtype=torch.long), torch.arange(0, 128),
                 torch.arange(kv[3] - 128, kv[3])]
        pos = torch.cat(rows).to(device=dev, dtype=torch.int32)
    t = block_req.shape[0] * blk_q
    q = torch.randn(t, hq, dh, generator=gen, device=dev).to(dtype)
    return dict(q=q, k_cache=k, v_cache=v, block_req=block_req, q_pos=pos,
                kv_len=kv_len, window=window, softcap=softcap)


def check_ragged_long_cases(torch, ops):
    """Phase 2: the kernel against ragged_decode_reference on long caches
    at the shapes of nemotron-4-340b (head_dim 192) and recurrentgemma-9b
    (rep 16 over one kv head); bf16 repeats bitwise, dead blocks zero.
    Returns the worst error by case name and dtype."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    worst = {}
    n = 0
    for name, dh, hq, hkv, windows, softcaps, S, kv in LONG_RAGGED:
        for dtype in (torch.float32, torch.bfloat16):
            for blk_q in (128, 1):
                for window in windows:
                    for softcap in softcaps:
                        case = _long_case(torch, gen, dtype=dtype, dh=dh,
                                          hq=hq, hkv=hkv, blk_q=blk_q,
                                          window=window, softcap=softcap,
                                          S=S, kv=kv)
                        out = ops.ragged_decode_attention(**case)
                        again = ops.ragged_decode_attention(**case) \
                            if dtype == torch.bfloat16 else out
                        torch.cuda.synchronize()
                        ref = ops.ragged_decode_reference(**case)
                        torch.cuda.synchronize()
                        err, ok = _max_err(torch, out, ref, dtype)
                        dead = out.reshape(5, blk_q, -1)[2]
                        if not ok or bool(dead.ne(0).any()) \
                                or not torch.equal(out, again):
                            raise SystemExit(
                                f"ragged_decode disagrees ({name}): dtype="
                                f"{dtype} blk_q={blk_q} window={window} "
                                f"softcap={softcap} max_err={err} repeat "
                                f"bitwise {torch.equal(out, again)}")
                        key = f"{name} {str(dtype).split('.')[-1]}"
                        worst[key] = max(worst.get(key, 0.0), err)
                        n += 1
    log(f"phase 2: ragged_decode kernel == plain version in {n} long-cache "
        f"cases ({', '.join(c[0] for c in LONG_RAGGED)}; blk_q 128/1, kv "
        f"past the window, split-kv; every bf16 repeat bitwise equal): "
        + ", ".join(f"{k} max |err| {v:.3e}" for k, v in worst.items()))
    return worst


# ------------------------------------------------------------ phase 3
def _post(url, body, timeout=600):
    req = urllib.request.Request(url, data=json.dumps(body).encode())
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.read().decode()


def _get(url, timeout=60):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read().decode())


def fused_vs_loop(torch, engine, prompt):
    """max |dlogit| / std(logit), argmax agreement and bitwise equality of
    the teacher-forced logits of fused and per-token prefill."""
    _, fused = engine.prefill(prompt, mode="fused", return_logits=True)
    _, loop = engine.prefill(prompt, mode="loop", return_logits=True)
    rel = float((fused - loop).abs().max() / fused.std())
    agree = float((fused.argmax(-1) == loop.argmax(-1)).float().mean())
    return rel, agree, bool(torch.equal(fused, loop))


def serve_full_width(torch, np, ops, launch):
    """Phase 3: llama3-8b at full width behind the HTTP daemon."""
    from repro_torch.models.model import Transformer
    from repro_torch.serve import Engine, ServeConfig
    args = launch.parse_args([
        "--arch", "llama3-8b", "--no-reduced", "--device", "cuda",
        "--slots", "4", "--max-seq", "2048", "--chunk-tokens", "512",
        "--max-new", "16", "--seed", "0"])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = launch.build_engine(args)
    torch.cuda.synchronize()
    cfg = engine.cfg
    n_params = sum(p.numel() for p in engine.model.parameters())
    log(f"phase 3: built {cfg.arch_id} ({n_params / 1e9:.3f} B params, "
        f"{cfg.n_layers} layers, d_model {cfg.d_model}, heads "
        f"{cfg.n_heads}/{cfg.n_kv_heads}, head_dim {cfg.head_dim}, "
        f"{engine.model.embed.dtype}) in {time.perf_counter() - t0:.1f} s")

    last = cfg.n_layers - 1
    captured = {}

    def capture(layer, inputs):
        if layer not in (0, last):
            return
        blk_q = inputs["q"].shape[0] // inputs["block_req"].shape[0]
        key = ("prefill" if blk_q > 1 else "decode", layer)
        if key not in captured:
            captured[key] = {k: v.clone() if torch.is_tensor(v) else v
                             for k, v in inputs.items()}

    engine.model.attn_hook = capture
    daemon = launch.EngineDaemon(engine)
    srv = launch.make_server(daemon, "127.0.0.1", 0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{srv.server_port}"
    rng = np.random.default_rng(0)
    lens = rng.integers(64, 1901, 8)
    prompts = [rng.integers(1, cfg.vocab_size, int(n)).tolist()
               for n in lens]
    results = [None] * len(prompts)
    errors = []

    def client(i):
        try:
            body = {"prompt": prompts[i], "max_new_tokens": 16}
            if i == 0:
                body["stream"] = True
                lines = [json.loads(x) for x in
                         _post(url + "/generate", body).splitlines()]
                if not lines[-1].get("done"):
                    raise RuntimeError(f"stream did not close: {lines[-1]}")
                results[i] = lines[-1]["tokens"]
            else:
                results[i] = json.loads(_post(url + "/generate",
                                              body))["tokens"]
        except Exception as e:         # reported below; fails the run
            errors.append(f"request {i}: {e!r}")

    try:
        ops.reset_launches()
        engine.n_chunk_calls = 0
        t0 = time.perf_counter()
        clients = [threading.Thread(target=client, args=(i,))
                   for i in range(len(prompts))]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=900)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ops.launches["ragged_decode"]
        calls = engine.n_chunk_calls
        _post(url + "/drain", {})
        health = _get(url + "/health")
    finally:
        srv.shutdown()
        srv.server_close()
        daemon.stop()
        engine.model.attn_hook = None
    if errors or any(c.is_alive() for c in clients):
        raise SystemExit(f"phase 3: requests failed: {errors}")
    for i, toks in enumerate(results):
        if len(toks) != 16 or not all(0 <= t < cfg.vocab_size
                                      for t in toks):
            raise SystemExit(f"phase 3: request {i} returned {toks}")
    if health["status"] != "drained":
        raise SystemExit(f"phase 3: /health after /drain: {health}")
    if launches != cfg.n_layers * calls or calls == 0:
        raise SystemExit(f"phase 3: {launches} kernel launches for {calls} "
                         f"device calls of {cfg.n_layers} layers")
    n_prompt = int(lens.sum())
    log(f"phase 3: served {len(prompts)} HTTP requests (prompts "
        f"{sorted(int(n) for n in lens)}, {n_prompt} prompt tokens, 16 new "
        f"each, one streamed) in {wall:.2f} s; {calls} device calls, "
        f"ragged_decode launches {launches} = {cfg.n_layers} x {calls}; "
        f"/health after /drain: {health['status']}")

    # the kernel against its plain version on the captured real tensors
    worst = 0.0
    for key in sorted(captured):
        inputs = captured[key]
        out = ops.ragged_decode_attention(**inputs)
        ref = ops.ragged_decode_reference(**inputs)
        torch.cuda.synchronize()
        err, ok = _max_err(torch, out, ref, out.dtype)
        log(f"  captured {key[0]} layer {key[1]}: q {tuple(inputs['q'].shape)}"
            f" cache {tuple(inputs['k_cache'].shape)} max |err| {err:.3e}")
        if not ok:
            raise SystemExit(f"phase 3: kernel disagrees on captured {key}")
        worst = max(worst, err)
    if len(captured) != 4:
        raise SystemExit(f"phase 3: captured {sorted(captured)}")

    # fused prefill against the per-token loop on one short prompt, in
    # bf16 (reported) and on an f32 copy of the same weights (checked)
    prompt = rng.integers(1, cfg.vocab_size, (engine.batch_size, 40))
    rel, agree, bitwise = fused_vs_loop(torch, engine, prompt)
    log(f"  fused vs loop prefill, bf16 (40 tokens x {engine.batch_size}): "
        f"max |dlogit| / std(logit) = {rel:.4f}; argmax agreement "
        f"{agree:.4f}; bitwise {bitwise}")
    model32 = Transformer(dataclasses.replace(
        cfg, param_dtype="float32", compute_dtype="float32"), device="meta")
    model32.to_empty(device=engine.device)
    model32.load_state_dict(engine.model.state_dict())
    engine32 = Engine(model32,
                      ServeConfig(max_seq=128, chunk_tokens=512),
                      batch_size=engine.batch_size, device=engine.device)
    rel32, agree32, bitwise32 = fused_vs_loop(torch, engine32, prompt)
    log(f"  fused vs loop prefill, f32 copy: max |dlogit| / std(logit) = "
        f"{rel32:.3e} (bound {PREFILL_REL_BOUND}); argmax agreement "
        f"{agree32:.4f}; bitwise {bitwise32}")
    del engine32, model32
    torch.cuda.empty_cache()
    if not rel32 <= PREFILL_REL_BOUND:
        raise SystemExit("phase 3: fused and loop prefill disagree")
    return engine, launches, worst


# ------------------------------------------------------------ phase 4
def _attn_work(torch, q, kv_len, block_req, pos, hkv, dtype_bytes,
               window=0):
    """Bytes and FLOPs this call's data needs: q read and out written once,
    each referenced request's K/V rows that some row sees read once (with
    a window, the span from the oldest row's window to the newest row);
    4 FLOPs per (row, visible slot, q head, dh)."""
    t, hq, dh = q.shape
    blk_q = t // block_req.shape[0]
    req = block_req.long().repeat_interleave(blk_q)
    rows = (pos >= 0) & (req >= 0)
    lens = kv_len.long()[req.clamp(min=0)]
    hi = torch.minimum(pos.long() + 1, lens)
    lo = (pos.long() - window + 1).clamp(min=0) if window > 0 \
        else torch.zeros_like(hi)
    visible = (hi - lo).clamp(min=0)[rows]
    kv_rows = 0
    for r in torch.unique(req[rows]).tolist():
        mine = rows & (req == r)
        kv_rows += max(0, int(hi[mine].max()) - int(lo[mine].min()))
    nbytes = 2 * t * hq * dh * dtype_bytes + 2 * kv_rows * hkv * dh \
        * dtype_bytes
    flops = 4.0 * float(visible.sum()) * hq * dh
    return nbytes, flops


# phase 4a's shapes: (R, S, hq, hkv, dh, window, softcap, positions of a
# request's prefill chunk, decode position, kv_len)
RAGGED_SHAPES = {
    # llama3-8b: one 512-token prefill chunk, request b's positions
    # 1920..2047 against its kv 0..2047; a 4-request decode step at kv 2000
    "llama3-8b": dict(R=4, S=2048, hq=32, hkv=8, dh=128, window=0,
                      softcap=0.0, prefill=(1920, 2048), decode=1999,
                      kv=(2048, 2000)),
    # gemma2-2b (head_dim 256, 8 q over 4 kv heads, softcap 50): a chunk
    # at positions 4480..4607 of a local layer (window 4096 binds) and a
    # decode step at kv 4608
    "gemma2-2b local": dict(R=4, S=6144, hq=8, hkv=4, dh=256, window=4096,
                            softcap=50.0, prefill=(4480, 4608), decode=4607,
                            kv=(4608, 4608)),
    # nemotron-4-340b (head_dim 192, 96 q over 8 kv heads; phase 20):
    # llama3-8b's positions, for a like-for-like row
    "nemotron-4-340b": dict(R=4, S=2048, hq=96, hkv=8, dh=192, window=0,
                            softcap=0.0, prefill=(1920, 2048), decode=1999,
                            kv=(2048, 2000)),
    # recurrentgemma-9b's local layers (phase 22): 16 q heads over one kv
    # head of 256, window 2048; decode rows only (its prompts are
    # prefilled a token a step), a 4-request step at kv 3000, past the
    # window as in phase 2's LONG_RAGGED
    "recurrentgemma-9b local": dict(R=4, S=3072, hq=16, hkv=1, dh=256,
                                    window=2048, softcap=0.0, prefill=None,
                                    decode=2999, kv=(None, 3000)),
    # the MoE archs (phase 26), decode rows only (their prompts are
    # prefilled a token a step) at llama3-8b's decode kv: qwen2-moe's 16 q
    # over 16 kv heads of 128 (rep 1), llama4-maverick's 40 over 8 (rep 5)
    "qwen2-moe-a2.7b": dict(R=4, S=2048, hq=16, hkv=16, dh=128, window=0,
                            softcap=0.0, prefill=None, decode=1999,
                            kv=(None, 2000)),
    "llama4-maverick-400b-a17b": dict(R=4, S=2048, hq=40, hkv=8, dh=128,
                                      window=0, softcap=0.0, prefill=None,
                                      decode=1999, kv=(None, 2000)),
}


TIMED_KEYS = ("ms", "ms_repeat", "device_ms", "ms_single", "plain_ms",
              "bound_ms", "bound_by", "library_ms", "library_device_ms",
              "library_ms_single")


def kernel_times(torch, ops, card, arch="llama3-8b", phase=4):
    """Phase 4a: the kernel at the main path's shapes, with its bound, the
    plain version and scaled_dot_product_attention as a yardstick (with a
    boolean mask for the causal window; SDPA has no softcap), each timed
    back to back, on the device (profiler) and as a lone call."""
    import torch.nn.functional as F
    sh = RAGGED_SHAPES[arch]
    gen = torch.Generator(device="cuda").manual_seed(1)
    dev, dt = "cuda", torch.bfloat16
    R, S, hq, hkv, dh = (sh[k] for k in ("R", "S", "hq", "hkv", "dh"))
    window, softcap = sh["window"], sh["softcap"]
    k = torch.randn(R, S, hkv, dh, generator=gen, device=dev).to(dt)
    v = torch.randn(R, S, hkv, dh, generator=gen, device=dev).to(dt)
    shapes = {}
    if sh["prefill"]:
        p0, p1 = sh["prefill"]
        shapes["prefill"] = (torch.arange(R, dtype=torch.int32),
                             torch.arange(p0, p1).repeat(R),
                             torch.full((R,), sh["kv"][0]))
    shapes["decode"] = (torch.arange(R, dtype=torch.int32),
                        torch.full((R,), sh["decode"]),
                        torch.full((R,), sh["kv"][1]))
    out = {}
    for name, (block_req, pos, kv_len) in shapes.items():
        block_req = block_req.to(dev)
        pos = pos.to(dev, torch.int32)
        kv_len = kv_len.to(dev, torch.int32)
        q = torch.randn(pos.shape[0], hq, dh, generator=gen,
                        device=dev).to(dt)
        args = dict(q=q, k_cache=k, v_cache=v, block_req=block_req,
                    q_pos=pos, kv_len=kv_len, window=window, softcap=softcap)
        nbytes, flops = _attn_work(torch, q, kv_len, block_req, pos, hkv, 2,
                                   window)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
        bound_ms = 1e3 * max(t_bytes, t_ops)
        bound_by = "bytes" if t_bytes >= t_ops else "operations"
        # the yardstick's inputs in its own layout, made before timing
        nq, blk_q = block_req.shape[0], q.shape[0] // block_req.shape[0]
        kl = int(kv_len[0])
        qs = q.reshape(nq, blk_q, hq, dh).transpose(1, 2).contiguous()
        ks = k[:, :kl].transpose(1, 2).contiguous()
        vs = v[:, :kl].transpose(1, 2).contiguous()
        qpos = pos.reshape(nq, blk_q)[0]
        slots = torch.arange(kl, device=dev)[None, :]
        mask = slots <= qpos[:, None]
        if window:
            mask &= qpos[:, None] - slots < window
        mask = mask[None, None]
        def kernel():
            return ops.ragged_decode_attention(**args)

        def sdpa():
            return F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask,
                                                  enable_gqa=True)
        # ms: calls back to back; device_ms: the profiler's kernel time;
        # ms_single: one call between two events, as cuda_ms times the rest
        ms = cuda_ms_back_to_back(kernel)
        dev_ms = profiled_device_ms(kernel)
        single_ms = cuda_ms(kernel)
        plain_ms = cuda_ms(lambda: ops.ragged_decode_reference(**args),
                           iters=10)
        lib_ms = cuda_ms_back_to_back(sdpa)
        lib_dev_ms = profiled_device_ms(sdpa)
        lib_single_ms = cuda_ms(sdpa)
        ms2 = cuda_ms_back_to_back(kernel)
        out[name] = dict(ms=ms, ms_repeat=ms2, device_ms=dev_ms,
                         ms_single=single_ms, plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by=bound_by,
                         library_ms=lib_ms, library_device_ms=lib_dev_ms,
                         library_ms_single=lib_single_ms, bytes=nbytes,
                         flops=flops)
        log(f"phase {phase}: ragged_decode {arch} {name} (q "
            f"{tuple(q.shape)}, "
            f"cache {tuple(k.shape)} bf16, kv {kl}, window {window}, "
            f"softcap {softcap}): kernel {ms:.4f} / {ms2:.4f} ms back to "
            f"back, {_ms4(dev_ms)} ms on the device, {single_ms:.4f} ms a "
            f"lone call; plain {plain_ms:.4f} ms; sdpa {lib_ms:.4f} / "
            f"{_ms4(lib_dev_ms)} / {lib_single_ms:.4f} ms; bound "
            f"{bound_ms:.4f} ms ({bound_by}: {nbytes / 1e6:.2f} MB, "
            f"{flops / 1e9:.3f} GFLOP) [{card}]")
    log(f"phase 4: profiler windows with no device time: "
        f"{EMPTY_PROFILE_WINDOWS[0]} of {EMPTY_PROFILE_WINDOWS[1]} "
        f"(each profiled again, up to {PROFILE_WINDOWS} windows); timings "
        f"left with none: {EMPTY_PROFILE_WINDOWS[2]}")
    return out


def engine_times(torch, np, engine, card):
    """Phase 4b: prefill tokens/s, decode ms per step, peak memory."""
    cfg = engine.cfg
    b = engine.batch_size
    torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng(2)
    prompt = rng.integers(1, cfg.vocab_size, (b, 1900))
    engine.prefill(prompt)                              # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.prefill(prompt)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    short = prompt[:, :1900 - 16]
    t0 = time.perf_counter()
    engine.prefill(short)
    torch.cuda.synchronize()
    t_short = time.perf_counter() - t0
    t0 = time.perf_counter()
    engine.generate(short)
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    steps = engine.scfg.max_new_tokens - 1
    decode_ms = 1e3 * (t_gen - t_short) / steps
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"phase 4: prefill {b} x 1900 tokens in {t_prefill:.3f} s = "
        f"{b * 1900 / t_prefill:.0f} tokens/s; decode {decode_ms:.2f} ms "
        f"per step at batch {b}, kv ~1900 ({steps} steps); peak memory "
        f"{peak:.2f} GiB [{card}]")
    return dict(prefill_tokens_per_s=b * 1900 / t_prefill,
                decode_ms=decode_ms, peak_gib=peak)


# ---------------------------------------------------- phase 10 (serving)
def _trace_chunk_call(torch, engine, fn, nth):
    """Run ``fn`` and trace the ``nth`` device call of ``engine`` (1-based)
    with ``torch.profiler``: that call's device breakdown, its host ms
    (ended by a synchronize) and its rows."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import breakdown
    orig, seen, res = engine._chunk, [0], {}

    def traced(*a):
        seen[0] += 1
        if seen[0] != nth:
            return orig(*a)
        torch.cuda.synchronize()
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        prof.start()
        t0 = time.perf_counter()
        lg = orig(*a)
        torch.cuda.synchronize()
        res["host_ms"] = 1e3 * (time.perf_counter() - t0)
        prof.stop()
        res["bd"] = breakdown.device_breakdown(prof.events())
        res["rows"] = int(a[1].shape[0])
        return lg
    engine._chunk = traced
    try:
        fn()
    finally:
        engine._chunk = orig
    if "bd" not in res:
        raise SystemExit(f"phase 10: device call {nth} never came")
    return res


def traced_serving(torch, np, engine, card):
    """Phase 10, serving (run right after phase 4, while the llama3-8b
    engine is loaded): a full 512-row prefill chunk deep in a 4 x 1900
    prefill, and a decode step at batch 4 and kv ~1890, each one device
    call traced: device ms by kernel family, the ragged kernel's share of
    the busy time, and the device's idle share of the call's host time."""
    cfg, b = engine.cfg, engine.batch_size
    rng = np.random.default_rng(3)
    prompt = rng.integers(1, cfg.vocab_size, (b, 1900))
    short = prompt[:, :1884]
    c0 = engine.n_chunk_calls
    engine.prefill(short)
    n_pf = engine.n_chunk_calls - c0
    runs = {"prefill chunk": _trace_chunk_call(
                torch, engine, lambda: engine.prefill(prompt), n_pf - 1),
            "decode step": _trace_chunk_call(
                torch, engine, lambda: engine.generate(short), n_pf + 6)}
    out = {}
    for name, r in runs.items():
        bd = r["bd"]
        ragged = bd["families"]["ragged_decode kernels"]
        fams = ", ".join(f"{f} {ms:.3f}" for f, ms in bd["families"].items()
                         if ms)
        out[name] = dict(host_ms=r["host_ms"], busy_ms=bd["busy_ms"],
                         span_ms=bd["span_ms"], ragged_ms=ragged,
                         ragged_share=ragged / bd["busy_ms"],
                         idle=1 - bd["busy_ms"] / r["host_ms"],
                         families=bd["families"])
        log(f"phase 10: llama3-8b serving, one {name} traced ({r['rows']} "
            f"rows, {bd['kernels']} device events): host {r['host_ms']:.3f}"
            f" ms, device span {bd['span_ms']:.3f} ms, busy "
            f"{bd['busy_ms']:.3f} ms (idle {out[name]['idle']:.4f} of the "
            f"host time); ragged_decode {ragged:.3f} ms = "
            f"{out[name]['ragged_share']:.4f} of busy; ms by family: {fams} "
            f"[{card}]")
        log(f"  ms by bucket: {_bucket_ms(bd, 3)} [{card}]")
        for fam in ("CA-server kernels", "SSD kernels"):
            ms = bd["families"][fam]
            if ms:
                log(f"  {fam}: {ms:.1f} ms, {ms / bd['busy_ms']:.4f} of the "
                    f"busy time")
        for kname, times in sorted(bd["attention"].items()):
            times.sort()
            log(f"  {kname}: {len(times)} launches, {sum(times):.3f} ms, "
                f"per launch {times[0]:.4f} / {times[len(times) // 2]:.4f} / "
                f"{times[-1]:.4f} ms (min / median / max)")
        for kname, ms in bd["top_other"][:5]:
            log(f"  other: {ms:9.3f} ms  {kname[:100]}")
    return out


# ----------------------------------------------------------- phase 15
GEMMA_PROMPTS = (4500, 5001)   # prompt lengths: the 4096 window binds
GEMMA_TIMED = 4800             # the timed prefill's prompt length


def serve_gemma2(torch, np, ops, launch, card):
    """Phase 15 (run after phase 4): gemma2-2b at full width and depth
    (26 layers, local / global alternating, head_dim 256, 8 q over 4 kv
    heads, window 4096, softcaps 50 and 30, vocab 256000) in bf16 from a
    seeded generator, 4 cache slots x 6144 positions, through
    ``Engine.serve``: 4 prompts of 4500-5000 tokens and 16 new tokens
    each.  Launches must be 26 x device calls, every token in the
    vocabulary; the kernel is held against its plain version on the
    inputs captured at the first local and global layers (a prefill chunk
    past the window, a decode step); prefill tokens/s and decode ms a step
    as phase 4 takes them.  The CPU oracle of this configuration is the
    reference's serving path (``tests/test_torch_model_serve.py`` holds
    gemma2-2b-reduced against it within tolerance)."""
    args = launch.parse_args([
        "--arch", "gemma2-2b", "--no-reduced", "--device", "cuda",
        "--slots", "4", "--max-seq", "6144", "--chunk-tokens", "512",
        "--max-new", "16", "--seed", "0"])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = launch.build_engine(args)
    torch.cuda.synchronize()
    cfg = engine.cfg
    n_params = sum(p.numel() for p in engine.model.parameters())
    log(f"phase 15: built {cfg.arch_id} ({n_params / 1e9:.3f} B params, "
        f"{cfg.n_layers} layers {cfg.layer_pattern}, d_model {cfg.d_model}, "
        f"heads {cfg.n_heads}/{cfg.n_kv_heads}, head_dim {cfg.head_dim}, "
        f"window {cfg.window}, {engine.model.embed.dtype}; cache 4 x "
        f"{engine.scfg.max_seq}) in {time.perf_counter() - t0:.1f} s")
    layers = {kind: cfg.layer_pattern.index(kind)
              for kind in ("local", "global")}
    captured = {}

    def capture(layer, inputs):
        if layer not in layers.values():
            return
        blk_q = inputs["q"].shape[0] // inputs["block_req"].shape[0]
        key = ("prefill" if blk_q > 1 else "decode", layer)
        if key in captured or (blk_q > 1 and int(inputs["q_pos"].max())
                               < cfg.window + 128):
            return
        captured[key] = {k: v.clone() if torch.is_tensor(v) else v
                         for k, v in inputs.items()}

    rng = np.random.default_rng(4)
    lens = rng.integers(*GEMMA_PROMPTS, 4)
    prompts = [rng.integers(1, cfg.vocab_size, int(n)) for n in lens]
    engine.model.attn_hook = capture
    try:
        ops.reset_launches()
        engine.n_chunk_calls = 0
        t0 = time.perf_counter()
        res = engine.serve(prompts, max_new_tokens=16)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ops.launches["ragged_decode"]
        calls = engine.n_chunk_calls
    finally:
        engine.model.attn_hook = None
    toks = [res.get(i, np.zeros(0, np.int32)) for i in range(len(prompts))]
    if any(len(t) != 16 or not ((t >= 0) & (t < cfg.vocab_size)).all()
           for t in toks):
        raise SystemExit(f"phase 15: generated {toks}")
    if launches != cfg.n_layers * calls or calls == 0:
        raise SystemExit(f"phase 15: {launches} kernel launches for {calls} "
                         f"device calls of {cfg.n_layers} layers")
    log(f"phase 15: served {len(prompts)} requests (prompts "
        f"{sorted(int(n) for n in lens)}, {int(lens.sum())} prompt tokens, "
        f"16 new each) in {wall:.2f} s; {calls} device calls, ragged_decode "
        f"launches {launches} = {cfg.n_layers} x {calls}")
    worst = 0.0
    for key in sorted(captured):
        inputs = captured[key]
        out = ops.ragged_decode_attention(**inputs)
        ref = ops.ragged_decode_reference(**inputs)
        torch.cuda.synchronize()
        err, ok = _max_err(torch, out, ref, out.dtype)
        log(f"  captured {key[0]} layer {key[1]} "
            f"({cfg.layer_pattern[key[1] % len(cfg.layer_pattern)]}, window "
            f"{inputs['window']}): q {tuple(inputs['q'].shape)} positions "
            f"up to {int(inputs['q_pos'].max())}, max |err| {err:.3e}")
        if not ok:
            raise SystemExit(f"phase 15: kernel disagrees on captured {key}")
        worst = max(worst, err)
    if len(captured) != 4:
        raise SystemExit(f"phase 15: captured {sorted(captured)}")
    del captured
    # prefill tokens/s and decode ms a step, as phase 4 takes them
    b, n = engine.batch_size, GEMMA_TIMED
    prompt = rng.integers(1, cfg.vocab_size, (b, n))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.prefill(prompt)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    short = prompt[:, :n - 16]
    t0 = time.perf_counter()
    engine.prefill(short)
    torch.cuda.synchronize()
    t_short = time.perf_counter() - t0
    t0 = time.perf_counter()
    engine.generate(short)
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    steps = engine.scfg.max_new_tokens - 1
    decode_ms = 1e3 * (t_gen - t_short) / steps
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"phase 15: prefill {b} x {n} tokens in {t_prefill:.3f} s = "
        f"{b * n / t_prefill:.0f} tokens/s; decode {decode_ms:.2f} ms per "
        f"step at batch {b}, kv ~{n - 16} ({steps} steps); peak memory "
        f"{peak:.2f} GiB [{card}]")
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return dict(launches=launches, calls=calls, captured_max_abs_err=worst,
                prefill_tokens_per_s=b * n / t_prefill, decode_ms=decode_ms,
                peak_gib=peak, serve_s=wall)


# ------------------------------------------------------------ phase 2 (CA)
# CA-server gradients: max |err| over the tensor's largest magnitude
CA_GRAD_RTOL = 1e-4
CA_MASKS = {"causal": dict(),
            "sliding+sink": dict(window="1.5blk", sink=8),
            "dilated": dict(rate=2),
            "softcap": dict(softcap=30.0)}
CA_JMAX = 4            # below N, and below some tasks' kv_len
# kv blocks a range of the range/carry forward in phase 2: every range
# size up to jmax (CA_JMAX: one finalizing range)
CA_CHUNKS = (1, 2, 3, CA_JMAX)


def _ca_case(torch, np, seed, *, dtype, dh, blk, rep, mask, hkv=2, T=7,
             N=10):
    """CA-server inputs on the card: ragged, overlapping kv ranges, a
    zero-length task, padded q rows and kv slots, jmax < N."""
    rng = np.random.default_rng(seed)
    hq = hkv * rep
    kv_start = np.zeros(T, np.int32)
    kv_len = np.zeros(T, np.int32)
    q_pos = np.zeros((T, blk), np.int32)
    kv_pos = np.tile(np.arange(blk, dtype=np.int32), (N, 1))
    for t in range(T):
        ln = int(rng.integers(1, 6))
        st = int(rng.integers(0, N - ln + 1))
        kv_start[t], kv_len[t] = st, ln
        q_pos[t] = np.arange((ln - 1) * blk, ln * blk)
        for jj in range(ln):
            kv_pos[st + jj] = np.arange(jj * blk, (jj + 1) * blk)
    kv_len[-1] = 0                      # zero-length task
    q_pos[-1] = -1
    q_pos[0, blk // 2:] = -1            # padded rows of a live task
    kv_pos[int(kv_start[1]), blk - 5:] = -1   # padded kv slots
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    dev = DEVICE

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    opts = {"window": 0, "sink": 0, "rate": 1, "softcap": 0.0,
            **CA_MASKS[mask]}
    if opts["window"] == "1.5blk":
        opts["window"] = blk + blk // 2
    args = dict(q_tasks=rnd(T, blk, hq, dh), k_buf=rnd(N, blk, hkv, dh),
                v_buf=rnd(N, blk, hkv, dh),
                kv_start=torch.tensor(kv_start, device=dev),
                kv_len=torch.tensor(kv_len, device=dev),
                q_pos=torch.tensor(q_pos, device=dev),
                kv_pos=torch.tensor(kv_pos, device=dev))
    return args, dict(jmax=CA_JMAX, **opts), rnd(T, blk, hq, dh)


def _grad_err(torch, got, ref, dtype):
    err = (got.float() - ref.float()).abs()
    if dtype == torch.float32:
        scale = max(1.0, float(ref.float().abs().max()))
        return float(err.max()), bool(err.max() <= CA_GRAD_RTOL * scale)
    return float(err.max()), bool(
        (err <= BF16_ATOL + BF16_RTOL * ref.float().abs()).all())


def check_ca_pair(torch, ops, args, opts, do):
    """Kernel fwd (out, lse) and bwd (dq, dk, dv) against the plain
    versions on the same inputs; the backward of both starts from the
    plain version's (out, lse); zero-length tasks must come out dead; a
    bf16 backward runs twice and must repeat bitwise (dk/dv sums each kv
    slot's covering tasks in one order, with no float atomics).  Returns
    (fwd err, grad err, ok)."""
    dtype = args["q_tasks"].dtype
    out, lse = ops.ca_server_fwd(**args, **opts)
    ref_out, ref_lse = ops.ca_server_fwd_reference(**args, **opts)
    torch.cuda.synchronize()
    e_out, ok_out = _max_err(torch, out, ref_out, dtype)
    e_lse, ok_lse = _max_err(torch, lse, ref_lse.float(), dtype)
    bwd_in = (args["q_tasks"], args["k_buf"], args["v_buf"], ref_out,
              ref_lse.float().contiguous(), do, args["kv_start"],
              args["kv_len"], args["q_pos"], args["kv_pos"])
    got = ops.ca_server_bwd(*bwd_in, **opts)
    want = ops.ca_server_bwd_reference(*bwd_in, **opts)
    again = (all(torch.equal(a, b) for a, b in
                 zip(got, ops.ca_server_bwd(*bwd_in, **opts)))
             if dtype == torch.bfloat16 else True)
    torch.cuda.synchronize()
    g_errs = [_grad_err(torch, a, b, dtype) for a, b in zip(got, want)]
    dead = args["kv_len"] == 0
    dead_ok = bool((out[dead] == 0).all()) and bool(
        (lse[dead] == ops.LSE_DEAD).all())
    ok = ok_out and ok_lse and dead_ok and again \
        and all(o for _, o in g_errs)
    return max(e_out, e_lse), max(e for e, _ in g_errs), ok


def same_bits(torch, a, b) -> bool:
    """Bitwise equality of two tensors (-0.0 and 0.0 differ)."""
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


def check_ca_range_glse(torch, ops, args, opts, do, gen):
    """The two extensions of this slice on one case: the range/carry
    forward at every chunk of CA_CHUNKS, held against its plain version
    (the plain ranges at the same chunk) at the forward tolerances and
    required to give the unstreamed kernel's out and lse bitwise; the
    backward with an lse cotangent (``g_lse``, a ring partial's) against
    its plain version at the gradient tolerances, a bf16 one repeated
    bitwise.  Returns (range fwd err, grad err, ok, range/carry forward
    bitwise)."""
    dtype = args["q_tasks"].dtype
    kw = dict(args, **opts)
    want = ops.ca_server_fwd(**kw)
    bitwise, f_errs = True, []
    for chunk in CA_CHUNKS:
        got = ops.ca_server_fwd_chunked(**kw, chunk_blocks=chunk)
        plain = ops.ca_server_fwd_chunked(
            **kw, chunk_blocks=chunk,
            fwd_range=ops.ca_server_fwd_range_reference)
        bitwise = bitwise and all(same_bits(torch, a, b)
                                  for a, b in zip(got, want))
        f_errs += [_max_err(torch, got[0], plain[0], dtype),
                   _max_err(torch, got[1], plain[1].float(), dtype)]
    ref_out, ref_lse = ops.ca_server_fwd_reference(**kw)
    t, blk, hq, _ = args["q_tasks"].shape
    g_lse = torch.randn((t, hq, blk), generator=gen, device=DEVICE)
    bwd_in = (args["q_tasks"], args["k_buf"], args["v_buf"], ref_out,
              ref_lse.float().contiguous(), do, args["kv_start"],
              args["kv_len"], args["q_pos"], args["kv_pos"])
    got = ops.ca_server_bwd(*bwd_in, **opts, g_lse=g_lse)
    ref = ops.ca_server_bwd_reference(*bwd_in, **opts, g_lse=g_lse)
    again = (all(same_bits(torch, a, b) for a, b in zip(
        got, ops.ca_server_bwd(*bwd_in, **opts, g_lse=g_lse)))
        if dtype == torch.bfloat16 else True)
    torch.cuda.synchronize()
    g_errs = [_grad_err(torch, a, b, dtype) for a, b in zip(got, ref)]
    ok = bitwise and again and all(o for _, o in f_errs + g_errs)
    return (max(e for e, _ in f_errs), max(e for e, _ in g_errs), ok,
            bitwise)


def check_ca_server_cases(torch, np, ops):
    """Phase 2: the CA-server kernels against their plain versions: f32
    and bf16, head_dim 64, 128, 192 and 256, blocks 64 and 128, GQA 1, 3
    and 4, the four masks; in each case also the range/carry forward
    (against its plain version, and bitwise against the unstreamed
    kernel) and the ``g_lse`` backward.  Returns the worst (fwd, grad,
    g_lse grad, range fwd) errors by dtype name, and under
    ``range_bitwise`` the cases whose range forward was bitwise equal to
    the unstreamed kernel's beside the cases run."""
    worst = {"float32": [0.0] * 4, "bfloat16": [0.0] * 4}
    n_bitwise = 0
    gen = torch.Generator(device=DEVICE).manual_seed(6)
    n = 0
    for dtype in (torch.float32, torch.bfloat16):
        for dh in ops.CA_HEAD_DIMS:
            for blk in (64, 128):
                for rep in (1, 3, 4):
                    for mask in CA_MASKS:
                        args, opts, do = _ca_case(torch, np, n, dtype=dtype,
                                                  dh=dh, blk=blk, rep=rep,
                                                  mask=mask)
                        e_f, e_b, ok = check_ca_pair(torch, ops, args, opts,
                                                     do)
                        e_r, e_g, ok_g, bitwise = check_ca_range_glse(
                            torch, ops, args, opts, do, gen)
                        if not (ok and ok_g):
                            raise SystemExit(
                                f"ca_server disagrees: dtype={dtype} dh={dh}"
                                f" blk={blk} rep={rep} mask={mask} fwd err "
                                f"{e_f} grad err {e_b} range fwd err {e_r} "
                                f"g_lse grad err {e_g} range/carry forward "
                                f"bitwise {bitwise}")
                        w = worst[str(dtype).split(".")[-1]]
                        for i, e in enumerate((e_f, e_b, e_g, e_r)):
                            w[i] = max(w[i], e)
                        n += 1
                        n_bitwise += bitwise
    f32, bf = worst["float32"], worst["bfloat16"]
    log(f"phase 2: ca_server fwd + bwd kernels == plain versions in {n} "
        f"cases, head_dim {'/'.join(map(str, ops.CA_HEAD_DIMS))} (f32 max "
        f"|err| out/lse {f32[0]:.3e} <= {F32_ATOL}, grads {f32[1]:.3e} <= "
        f"{CA_GRAD_RTOL} x max(1, max |grad|); bf16 max |err| out/lse "
        f"{bf[0]:.3e}, grads {bf[1]:.3e}, within atol=rtol={BF16_ATOL}; "
        f"bf16 backward repeated bitwise)")
    log(f"phase 2: ca_server_fwd_range in ranges of {CA_CHUNKS} kv blocks "
        f"== plain version (f32 max |err| out/lse {f32[3]:.3e}, bf16 "
        f"{bf[3]:.3e}, same tolerances) and == the unstreamed kernel "
        f"bitwise (out and lse) in all {n} cases; the g_lse backward == "
        f"plain version (f32 grads {f32[2]:.3e}, bf16 {bf[2]:.3e}, same "
        f"tolerances; bf16 repeated bitwise)")
    worst["range_bitwise"] = [n_bitwise, n]
    return worst


# --------------------------------------------------------- phase 2 (flash)
FLASH_MASKS = {"causal": dict(),
               "non-causal": dict(causal=False),
               "window": dict(window=48),
               "window+sink": dict(window=48, sink=8),
               "dilated": dict(rate=2)}
FLASH_SEQ = 256


def _flash_case(torch, np, seed, *, dtype, dh, rep, hkv=2, B=2,
                S=FLASH_SEQ, docs=(2, 5)):
    """Flash inputs on the card: per batch row ``docs`` (a range: 2-4)
    ragged documents that are not block-aligned, then padding (segment 0),
    in-document positions."""
    rng = np.random.default_rng(seed)
    seg = np.zeros((B, S), np.int32)
    pos = np.zeros((B, S), np.int32)
    for b in range(B):
        end = S - int(rng.integers(1, 40))
        n_docs = int(rng.integers(*docs))
        cuts = np.sort(rng.choice(np.arange(1, end), n_docs - 1,
                                  replace=False))
        bounds = np.concatenate([[0], cuts, [end]])
        for d in range(n_docs):
            lo, hi = bounds[d], bounds[d + 1]
            seg[b, lo:hi] = d + 1
            pos[b, lo:hi] = np.arange(hi - lo)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=DEVICE).to(dtype)
    ids = [torch.tensor(x, device=DEVICE) for x in (seg, pos, seg, pos)]
    args = [rnd(B, S, hkv * rep, dh), rnd(B, S, hkv, dh), rnd(B, S, hkv, dh),
            *ids]
    return args, rnd(B, S, hkv * rep, dh)


def check_flash_pair(torch, ops, args, opts, do):
    """Kernel fwd (out, lse) and bwd (dq, dk, dv) against the plain
    versions on the same inputs; the backward of both starts from the
    plain version's (out, lse); padding rows must come out dead; a bf16
    backward runs twice and must repeat bitwise (the dk/dv head split
    sums its parts in order); the document prune ``flash_tile_ranges``
    must equal its plain version.  Returns (fwd err, grad err, ok)."""
    dtype = args[0].dtype
    out, lse = ops.flash_fwd(*args, **opts)
    ref_out, ref_lse = ops.flash_fwd_reference(*args, **opts)
    torch.cuda.synchronize()
    e_out, ok_out = _max_err(torch, out, ref_out, dtype)
    e_lse, ok_lse = _max_err(torch, lse, ref_lse.float(), dtype)
    bwd_in = (*args[:3], ref_out, ref_lse.float().contiguous(), do,
              *args[3:])
    got = ops.flash_bwd(*bwd_in, **opts)
    want = ops.flash_bwd_reference(*bwd_in, **opts)
    again = (all(torch.equal(a, b) for a, b in
                 zip(got, ops.flash_bwd(*bwd_in, **opts)))
             if dtype == torch.bfloat16 else True)
    mask = {k: opts[k] for k in ("causal", "window", "sink") if k in opts}
    ranges = all(torch.equal(a, b) for a, b in zip(
        ops.flash_tile_ranges(*args[3:], **mask),
        ops.flash_tile_ranges_reference(*args[3:], **mask)))
    torch.cuda.synchronize()
    g_errs = [_grad_err(torch, a, b, dtype) for a, b in zip(got, want)]
    dead = args[3] == 0
    dead_ok = bool((out[dead] == 0).all()) and bool(
        (lse.transpose(1, 2)[dead] == ops.LSE_DEAD).all())
    ok = ok_out and ok_lse and dead_ok and again and ranges \
        and all(o for _, o in g_errs)
    return max(e_out, e_lse), max(e for e, _ in g_errs), ok


def _flash_log(where, n, worst):
    """Phase 2's summary line of a set of flash cases: the worst error of
    each kernel in each dtype."""
    f32, bf = worst["float32"], worst["bfloat16"]
    log(f"phase 2: flash fwd + bwd kernels{where} == plain versions in {n} "
        f"cases (f32 max |err| out/lse {f32[0]:.3e} <= {F32_ATOL}, grads "
        f"{f32[1]:.3e} <= {CA_GRAD_RTOL} x max(1, max |grad|); bf16 max "
        f"|err| out/lse {bf[0]:.3e}, grads {bf[1]:.3e}, within atol=rtol="
        f"{BF16_ATOL}; bf16 backward repeated bitwise; flash_tile_ranges "
        f"== its plain version)")


def check_flash_cases(torch, np, ops):
    """Phase 2: the flash kernels against their plain versions: f32 and
    bf16, head_dim 64, 128 and 192, GQA 1 (blocks of 128, the main path's)
    and 4 (blocks of 64), every mask family, softcap 0 and 50.  Returns
    the worst (fwd, grad) errors by dtype name."""
    worst = {"float32": [0.0, 0.0], "bfloat16": [0.0, 0.0]}
    n = 0
    for dtype in (torch.float32, torch.bfloat16):
        for dh in (64, 128, 192):
            for rep in (1, 4):
                blk = 128 if rep == 1 else 64
                for mask in FLASH_MASKS:
                    for softcap in (0.0, 50.0):
                        args, do = _flash_case(torch, np, n, dtype=dtype,
                                               dh=dh, rep=rep)
                        opts = dict(FLASH_MASKS[mask], softcap=softcap,
                                    blk_q=blk, blk_k=blk)
                        e_f, e_b, ok = check_flash_pair(torch, ops, args,
                                                        opts, do)
                        if not ok:
                            raise SystemExit(
                                f"flash disagrees: dtype={dtype} dh={dh} "
                                f"rep={rep} blk={blk} mask={mask} softcap="
                                f"{softcap} fwd err {e_f} grad err {e_b}")
                        w = worst[str(dtype).split(".")[-1]]
                        w[0], w[1] = max(w[0], e_f), max(w[1], e_b)
                        n += 1
    _flash_log("", n, worst)
    return worst


# recurrentgemma's local layers: head_dim 256, MQA (rep 16 over 1 kv head)
# or rep 1, window 2048 over 4096 tokens of 1-2 documents (so documents
# outrun the window), and causal / window 64 on short ragged documents
FLASH256_CASES = (("causal", dict(), 256, (2, 5)),
                  ("window 64", dict(window=64), 256, (2, 5)),
                  ("window 2048", dict(window=2048), 4096, (1, 3)))


def check_flash256_cases(torch, np, ops):
    """Phase 2: the flash kernels at head_dim 256 against their plain
    versions: f32 and bf16, rep 1 (2 kv heads) and 16 (1 kv head, the bf16
    dk/dv head split), blocks of 128 (the main path's), causal, window 64
    and window 2048, softcap 0 and (short cases) 50.  Returns the worst
    (fwd, grad) errors by dtype name."""
    worst = {"float32": [0.0, 0.0], "bfloat16": [0.0, 0.0]}
    n = 0
    for dtype in (torch.float32, torch.bfloat16):
        for rep, hkv in ((1, 2), (16, 1)):
            for mask, opts, S, docs in FLASH256_CASES:
                for softcap in ((0.0, 50.0) if S <= FLASH_SEQ else (0.0,)):
                    args, do = _flash_case(torch, np, 500 + n, dtype=dtype,
                                           dh=256, rep=rep, hkv=hkv, S=S,
                                           docs=docs)
                    e_f, e_b, ok = check_flash_pair(
                        torch, ops, args, dict(opts, softcap=softcap), do)
                    if not ok:
                        raise SystemExit(
                            f"flash dh 256 disagrees: dtype={dtype} rep={rep}"
                            f" mask={mask} S={S} softcap={softcap} fwd err "
                            f"{e_f} grad err {e_b}")
                    w = worst[str(dtype).split(".")[-1]]
                    w[0], w[1] = max(w[0], e_f), max(w[1], e_b)
                    n += 1
    _flash_log(" at head_dim 256", n, worst)
    return worst


# ---------------------------------------------------------- phase 2 (LRU)
# (B, S, W): a length that is no multiple of the ring's 64-step stage or
# the TPU's tiles (1000, 4097), the layer shape [2, 4096, 4096], narrow
# and wide channels; then the ring's edges: S under one stage (40), one
# stage minus and plus one (63, 65), W not a multiple of 32 (100: f32
# rows of 400 bytes through the ring with a partial last chain, bf16
# rows of 200 bytes through the direct variant; 72: bf16 through the
# ring, a partial chain), W under 32 (20: f32 ring, bf16 direct; 24: both
# through the ring), B 3
LRU_SHAPES = ((2, 128, 128), (1, 1000, 256), (3, 4097, 384),
              (2, 4096, 4096), (3, 40, 256), (1, 63, 128), (2, 65, 128),
              (3, 1000, 100), (2, 300, 20), (3, 129, 72), (3, 100, 24))
LRU_RESETS = ("none", "a = 0 at the start", "a = 0 mid-sequence",
              "a = 0 everywhere", "a = 0.999")


def _lru_case(torch, seed, *, dtype, shape, reset, offset=0):
    """a in (0.5, 1) (or as ``reset`` says), b and the cotangent g
    standard normal, on the card in ``dtype``; with ``offset``, each a
    contiguous view that starts ``offset`` values into its storage."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    a = 0.5 + 0.5 * torch.rand(shape, generator=gen, device=DEVICE)
    b = torch.randn(shape, generator=gen, device=DEVICE)
    g = torch.randn(shape, generator=gen, device=DEVICE)
    if reset == "a = 0 at the start":
        a[:, 0] = 0.0
    elif reset == "a = 0 mid-sequence":
        a[torch.rand(shape[:2], generator=gen, device=DEVICE) < 0.01] = 0.0
    elif reset == "a = 0 everywhere":
        a.zero_()
    elif reset == "a = 0.999":
        a.fill_(0.999)
    if offset:
        return tuple(torch.empty(x.numel() + offset, device=DEVICE,
                                 dtype=dtype)[offset:].view(shape).copy_(x)
                     for x in (a, b, g))
    return a.to(dtype), b.to(dtype), g.to(dtype)


def lru_variant(x) -> str:
    """Which kernel lru_scan.cu runs on inputs like ``x``: the TMA ring
    takes rows of a multiple of 16 bytes at 16-byte aligned addresses,
    the direct variant the rest."""
    ring = x.shape[-1] * x.element_size() % 16 == 0 and \
        x.data_ptr() % 16 == 0
    return "ring" if ring else "direct"


def check_lru_pair(torch, rg, a, b, g):
    """Kernel fwd (h) and bwd (da, db) against the plain versions on the
    same inputs; the backward of both starts from the plain h.  Returns
    (fwd err, grad err, bitwise, ok)."""
    dtype = a.dtype
    h = rg.lru_scan_fwd(a, b)
    ref_h = rg.lru_scan_fwd_reference(a, b)
    got = rg.lru_scan_bwd(a, ref_h, g)
    want = rg.lru_scan_bwd_reference(a, ref_h, g)
    torch.cuda.synchronize()
    e_h = float((h.float() - ref_h.float()).abs().max())
    scale = max(1.0, float(ref_h.float().abs().max()))
    ok_h = e_h <= F32_ATOL * scale if dtype == torch.float32 else \
        _max_err(torch, h, ref_h, dtype)[1]
    g_errs = [_grad_err(torch, x, y, dtype) for x, y in zip(got, want)]
    bitwise = torch.equal(h, ref_h) and all(
        torch.equal(x, y) for x, y in zip(got, want))
    return e_h, max(e for e, _ in g_errs), bitwise, \
        ok_h and all(o for _, o in g_errs)


def check_lru_cases(torch, rg):
    """Phase 2: the lru_scan kernels against their plain versions: f32 and
    bf16, every shape of LRU_SHAPES, every reset pattern of LRU_RESETS,
    and each dtype once more on inputs one value off 16-byte alignment
    (the direct variant).  f32 h within 1e-5 x max(1, max |h|), gradients
    as the other kernels', and every output bitwise equal: both versions
    take the same steps, each a product and a sum rounded separately.
    Every case runs the kernels twice, and the two runs must be bitwise
    equal."""
    worst_fwd = worst_bwd = 0.0
    n = n_bitwise = n_again = 0
    variants = {"ring": 0, "direct": 0}
    cases = [(dtype, shape, reset, 0)
             for dtype in (torch.float32, torch.bfloat16)
             for shape in LRU_SHAPES for reset in LRU_RESETS]
    cases += [(dtype, (3, 1000, 256), "a = 0 mid-sequence", 1)
              for dtype in (torch.float32, torch.bfloat16)]
    for dtype, shape, reset, offset in cases:
        a, b, g = _lru_case(torch, 900 + n, dtype=dtype, shape=shape,
                            reset=reset, offset=offset)
        e_f, e_b, bitwise, ok = check_lru_pair(torch, rg, a, b, g)
        if not ok:
            raise SystemExit(
                f"lru_scan disagrees: dtype={dtype} shape={shape} "
                f"reset={reset} offset={offset} fwd err {e_f} grad err "
                f"{e_b}")
        runs = []
        for _ in range(2):
            h = rg.lru_scan_fwd(a, b)
            runs.append((h, *rg.lru_scan_bwd(a, h, g)))
        again = all(torch.equal(x, y) for x, y in zip(*runs))
        if dtype == torch.float32:
            worst_fwd = max(worst_fwd, e_f)
            worst_bwd = max(worst_bwd, e_b)
        n += 1
        n_bitwise += bitwise
        n_again += again
        variants[lru_variant(a)] += 1
    log(f"phase 2: lru_scan fwd + bwd kernels == plain versions in {n} "
        f"cases ({variants['ring']} through the TMA ring, "
        f"{variants['direct']} through the direct variant; f32 max |err| h "
        f"{worst_fwd:.3e}, grads {worst_bwd:.3e}); bitwise equal (h, da, "
        f"db) in {n_bitwise} of {n}, repeats bitwise equal in {n_again} of "
        f"{n} (required: all)")
    if n_bitwise != n:
        raise SystemExit("lru_scan: the kernels and the plain versions take "
                         "the same rounded steps, yet their bits differ")
    if n_again != n:
        raise SystemExit("lru_scan: a repeated run changed its bits")
    return worst_fwd, worst_bwd, True


# ----------------------------------------------------------- phase 2 (SSD)
SSD_RESETS = ("none", "chunk start", "mid-chunk", "every position",
              "csum below -80")
# (G, H) per head-group factor rep = H / G
SSD_GROUPS = {1: (2, 2), 4: (2, 8), 32: (1, 32)}


def _ssd_case(torch, np, seed, *, c, N, P, rep, reset, Bt=2, K=2):
    """SSD intra-chunk inputs on the card, f32.  C and B are scaled by
    N**-0.5 so that the scores C·B are O(1), as a q·k logit is, and the
    f32 atol speaks of outputs of order 1.  ``reset`` picks the reset
    counts nr and the decay: none (nr constant 0), a reset at the chunk
    start (nr constant 1), sorted random resets mid-chunk with some
    zero decays (equal csums off the diagonal), a reset at every
    position, or no reset with decays steep enough that csum spans well
    below -80 within the chunk."""
    rng = np.random.default_rng(seed)
    G, H = SSD_GROUPS[rep]

    def softplus(v):
        return np.log1p(np.exp(v))
    C = rng.standard_normal((Bt, K, c, G, N)) * N ** -0.5
    B = rng.standard_normal((Bt, K, c, G, N)) * N ** -0.5
    x = rng.standard_normal((Bt, K, c, H, P))
    dt = softplus(rng.standard_normal((Bt, K, c, H)))
    la = -softplus(rng.standard_normal((Bt, K, c, H)))
    if reset == "none":
        nr = np.zeros((Bt, K, c))
    elif reset == "chunk start":
        nr = np.ones((Bt, K, c))
    elif reset == "mid-chunk":
        nr = np.sort(rng.integers(0, 4, (Bt, K, c)), axis=-1)
        la[rng.random(la.shape) < 0.2] = 0.0
    elif reset == "every position":
        nr = np.broadcast_to(np.arange(c), (Bt, K, c))
    else:
        nr = np.zeros((Bt, K, c))
        la = la * 8.0
    csum = np.cumsum(la, axis=2)
    dy = rng.standard_normal((Bt, K, c, H, P))
    dstate = rng.standard_normal((Bt, K, H, N, P))

    def dev(a, dtype=torch.float32):
        return torch.tensor(np.ascontiguousarray(a), dtype=dtype,
                            device=DEVICE)
    args = [dev(C), dev(B), dev(x), dev(dt), dev(csum),
            dev(nr, torch.int32)]
    return args, dev(dy), dev(dstate)


# the bf16 kernels' gradients against the plain version's on the same
# bf16 values: dy, dstate, W and dS̄ enter their products rounded to bf16
# (2**-9 relative), each gradient a sum of up to two chunks of such terms
SSD_BF16_GRAD_RTOL = BF16_RTOL


def check_ssd_pair(torch, ssd, args, dy, dstate, scaled=False):
    """Kernel forward (y, states) and backward (dC, dB, dx, ddt, dcsum)
    against the plain versions on the same inputs.  Forward: max |err| <=
    F32_ATOL, times max(1, max |ref|) when ``scaled`` (for inputs whose
    outputs are not of order 1), in both dtypes: the bf16 kernels form
    every product at f32 precision (W and B·u as three bf16 terms), so y
    and the states meet the f32 rule.  Gradients: <= CA_GRAD_RTOL (f32)
    or SSD_BF16_GRAD_RTOL (bf16 C, B, x: the tensor-core kernels round dy,
    dstate, W and dS̄ to bf16 for their products) x max(1, max |grad|);
    a bf16 backward must also repeat bitwise (the head parts are summed
    in one order).  Returns a dict: fwd (max |err| of y and the states),
    fwd_ref (their max |ref|), grad (max |err| of the gradients), ratio
    (the worst gradient's (err / max(1, max |grad|), err, max(1, max
    |grad|))) and ok."""
    bf16 = args[2].dtype == torch.bfloat16
    got = ssd.ssd_chunk_fwd(*args)
    want = ssd.ssd_chunk_fwd_reference(*args)
    torch.cuda.synchronize()
    f_errs = []
    for a, b in zip(got, want):
        err, ref = float((a - b).abs().max()), float(b.abs().max())
        lim = F32_ATOL * (max(1.0, ref) if scaled else 1.0)
        f_errs.append((err, err <= lim, ref))
    g_got = ssd.ssd_chunk_bwd(*args, dy, dstate)
    g_want = ssd.ssd_chunk_bwd_reference(*args, dy, dstate)
    again = True
    if bf16:
        again = all(torch.equal(a, b) for a, b in
                    zip(g_got, ssd.ssd_chunk_bwd(*args, dy, dstate)))
    torch.cuda.synchronize()
    rtol = SSD_BF16_GRAD_RTOL if bf16 else CA_GRAD_RTOL
    g_errs = []
    for a, b in zip(g_got, g_want):
        err = float((a - b).abs().max())
        scale = max(1.0, float(b.abs().max()))
        g_errs.append((err / scale, err, scale))
    worst = max(g_errs)
    return dict(fwd=max(e for e, _, _ in f_errs),
                fwd_ref=max(r for _, _, r in f_errs),
                grad=max(e for _, e, _ in g_errs), ratio=worst,
                ok=again and all(o for _, o, _ in f_errs) and worst[0] <= rtol)


def check_ssd_cases(torch, np, ssd):
    """Phase 2: the SSD kernels against their plain versions: chunk
    64/128/256 x N 32/64/128 x P 32/64 x rep 1/4/32 (G = H and G < H),
    the reset patterns cycling over the cases so that each meets each
    rep, Bt x K = 4 chunks; each case in f32 (the FMA kernels) and with
    C, B and x rounded to bf16 (the tensor-core kernels, the plain version
    on the same rounded values), the bf16 forward held at the scaled
    f32 rule.  Returns by dtype name the worst fwd err, the worst grad
    err, and (ratio, grad err, max(1, max |grad|)) of the case with the
    largest ratio."""
    worst = {"float32": [0.0, 0.0, (0.0, 0.0, 1.0)],
             "bfloat16": [0.0, 0.0, (0.0, 0.0, 1.0)]}
    n = 0
    for c in (64, 128, 256):
        for N in (32, 64, 128):
            for P in (32, 64):
                for rep in SSD_GROUPS:
                    reset = SSD_RESETS[n % len(SSD_RESETS)]
                    args, dy, dstate = _ssd_case(torch, np, n, c=c, N=N, P=P,
                                                 rep=rep, reset=reset)
                    for dtype in (torch.float32, torch.bfloat16):
                        cast = [a.to(dtype) if k < 3 else a
                                for k, a in enumerate(args)]
                        r = check_ssd_pair(torch, ssd, cast, dy, dstate,
                                           scaled=dtype == torch.bfloat16)
                        if not r["ok"]:
                            raise SystemExit(
                                f"ssd_chunk disagrees: {dtype} c={c} N={N} "
                                f"P={P} rep={rep} reset={reset}: {r}")
                        w = worst[str(dtype).split(".")[-1]]
                        w[0], w[1] = max(w[0], r["fwd"]), max(w[1], r["grad"])
                        w[2] = max(w[2], r["ratio"])
                    n += 1
    f32, bf = worst["float32"], worst["bfloat16"]
    log(f"phase 2: ssd_chunk fwd + bwd kernels == plain versions in {n} "
        f"cases x {{f32, bf16}} (f32 max |err| y/states {f32[0]:.3e} <= "
        f"{F32_ATOL}, grads {f32[1]:.3e}, worst err / max(1, max |grad|) "
        f"{f32[2][1]:.3e} / {f32[2][2]:.3e} = {f32[2][0]:.3e} <= "
        f"{CA_GRAD_RTOL}; bf16 max |err| y/states {bf[0]:.3e} <= "
        f"{F32_ATOL} x max(1, max |ref|), grads {bf[1]:.3e}, worst err / "
        f"max(1, max |grad|) {bf[2][1]:.3e} / {bf[2][2]:.3e} = "
        f"{bf[2][0]:.3e} <= {SSD_BF16_GRAD_RTOL}; bf16 backward repeated "
        f"bitwise)")
    for N, P in ((128, 64), (32, 32)):
        log(f"  bf16 kernels' dynamic shared memory at N {N}, P {P}, chunk "
            f"256 (bytes, one CTA an SM): {ssd.bf16_smem_bytes(N, P, 256)}")
    return worst


# ------------------------------------------------------------ phase 5
TRAIN_LAYERS = 8          # of llama3-8b's 32: what one card's memory holds
TRAIN_STEPS = 3


def _train_setup():
    from repro_torch.cad import CADSession
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import PipelineConfig
    from repro_torch.train.trainer import TrainConfig
    cfg = dataclasses.replace(get_config("llama3-8b"),
                              n_layers=TRAIN_LAYERS)
    pipe = PipelineConfig(distribution="prolong", max_doc_len=4096,
                          seq_len=4096, global_batch=4, n_ranks=4,
                          vocab_size=cfg.vocab_size, seed=0)
    tc = TrainConfig(steps=TRAIN_STEPS, peak_lr=3e-4, warmup=1,
                     log_every=1, seed=0)

    def session(policy):
        return CADSession.for_pipeline(cfg, pipe, plan_policy=policy,
                                       prefetch=2)
    return cfg, pipe, tc, session


def train_full_width(torch, ops, card):
    """Phase 5: the CAD training step at llama3-8b width on the card."""
    from repro_torch.models.model import Transformer
    from repro_torch.train.trainer import train
    cfg, pipe, tc, session = _train_setup()
    n_servers = pipe.n_ranks
    tokens = pipe.global_batch * pipe.seq_len

    # the step-0 loss under the identity plan (a fresh model, same seed)
    res = train(cfg, pipe, dataclasses.replace(tc, steps=1),
                session=session("identity"), device=DEVICE)
    loss_identity = res["history"][0]["loss"]
    del res
    gc.collect()
    torch.cuda.empty_cache()

    model = Transformer(cfg, device=DEVICE, seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    captured = {}

    def capture(layer, inputs):
        if layer in (0, cfg.n_layers - 1) and layer not in captured:
            captured[layer] = {k: v.detach().clone() if torch.is_tensor(v)
                               else v for k, v in inputs.items()}

    expect = {"ca_server_fwd": n_servers * cfg.n_layers * 2,   # + remat
              "ca_server_bwd_dq": n_servers * cfg.n_layers,
              "ca_server_bwd_dkv": n_servers * cfg.n_layers}
    steps = []

    def on_step(step, m):
        counts = {k: ops.launches[k] for k in expect}
        mem = torch.cuda.max_memory_allocated() / 2 ** 30
        ops.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        model.attn_hook = None              # capture step 0 only
        steps.append(dict(m, counts=counts, peak_gib=mem))
        log(f"phase 5: step {step} loss {m['loss']:.6f} gnorm "
            f"{m['grad_norm']:.4f} step {1e3 * m['step_s']:.1f} ms "
            f"{tokens / m['step_s']:.0f} tokens/s peak "
            f"{mem:.2f} GiB launches {counts} plan max/mean "
            f"{m.get('sched_load_max_over_mean', float('nan')):.3f} "
            f"[{card}]")

    log(f"phase 5: llama3-8b width, {cfg.n_layers} of 32 layers "
        f"({n_params / 1e9:.3f} B params, bf16), {n_servers} attention "
        f"servers, {pipe.global_batch} x {pipe.seq_len} tokens "
        f"({pipe.distribution}), step-0 identity loss {loss_identity!r}")
    model.attn_hook = capture
    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    res = train(cfg, pipe, tc, model=model, session=session("balanced"),
                device=DEVICE, on_step=on_step)
    del res, model
    gc.collect()
    torch.cuda.empty_cache()
    for s in steps:
        if s["counts"] != expect:
            raise SystemExit(f"phase 5: step {s['step']} launches "
                             f"{s['counts']} != {expect}")
        if not math.isfinite(s["loss"]):
            raise SystemExit(f"phase 5: step {s['step']} loss {s['loss']}")
    if steps[0]["loss"] != loss_identity:
        raise SystemExit(f"phase 5: step-0 loss {steps[0]['loss']!r} under "
                         f"balanced != {loss_identity!r} under identity")
    if sorted(captured) != [0, cfg.n_layers - 1]:
        raise SystemExit(f"phase 5: captured layers {sorted(captured)}")
    log(f"phase 5: launches per step = {expect} (servers x layers x "
        f"{{2 forwards with remat, 1 backward}}); step-0 loss bitwise equal "
        f"under identity and balanced")
    total = {k: sum(s["counts"][k] for s in steps) for k in expect}
    return steps, captured, total


def captured_batches(torch, captured):
    """The per-server kernel inputs of each captured layer."""
    from repro_torch.core import dispatch
    out = {}
    for layer, inp in sorted(captured.items()):
        pos = torch.where(inp["segment_ids"] > 0, inp["positions"], -1) \
            .to(torch.int32)
        cad = inp["ctx"].cad
        out[layer] = [dict(b, layer=layer) for b in dispatch.server_batches(
            inp["q"], inp["k"], inp["v"], pos, cad.plan, cad)]
    return out


def check_captured(torch, ops, captured, batches, softcap=0.0, phase=5):
    """Phase 5 (and 16, with gemma2's attention softcap): the kernels
    against the plain versions on the captured server batches (bf16), and
    the dispatch's backward repeated bitwise on the first captured
    layer."""
    from repro_torch.core import dispatch
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    worst = 0.0
    for layer, per_server in batches.items():
        for s, b in enumerate(per_server):
            args = {k: b[k] for k in ("q_tasks", "k_buf", "v_buf",
                                      "kv_start", "kv_len", "q_pos",
                                      "kv_pos")}
            opts = {k: b[k] for k in ("jmax", "window", "sink", "rate")}
            opts["softcap"] = softcap
            do = torch.randn(b["q_tasks"].shape, generator=gen,
                             device=DEVICE).to(b["q_tasks"].dtype)
            e_f, e_b, ok = check_ca_pair(torch, ops, args, opts, do)
            log(f"  captured layer {layer} server {s}: q_tasks "
                f"{tuple(b['q_tasks'].shape)} k_buf "
                f"{tuple(b['k_buf'].shape)} jmax {b['jmax']}: fwd max "
                f"|err| {e_f:.3e}, grads {e_b:.3e}")
            if not ok:
                raise SystemExit(f"phase {phase}: kernels disagree on "
                                 f"captured layer {layer} server {s}")
            worst = max(worst, e_f)
    # the gather/scatter around the kernels: autograd's backward of the
    # index gathers is index_put(accumulate=True); repeated runs must
    # give the same bits
    first = min(captured)
    inp = captured[first]
    cad = inp["ctx"].cad
    pos = torch.where(inp["segment_ids"] > 0, inp["positions"], -1) \
        .to(torch.int32)
    g = torch.randn(inp["q"].shape, generator=gen, device=DEVICE) \
        .to(inp["q"].dtype)
    runs = []
    for _ in range(2):
        q, k, v = (inp[n].clone().requires_grad_() for n in "qkv")
        out = dispatch._global_sim(q, k, v, pos, cad.plan, cad, softcap,
                                   None)
        runs.append((out, *torch.autograd.grad(out, (q, k, v), g)))
    bitwise = all(torch.equal(a, b) for a, b in zip(*runs))
    log(f"phase {phase}: dispatch fwd+bwd on layer {first}'s q/k/v "
        f"repeated: bitwise {bitwise} (deterministic algorithms "
        f"{torch.are_deterministic_algorithms_enabled()})")
    if not bitwise:
        raise SystemExit(f"phase {phase}: the dispatch backward is not "
                         f"deterministic")
    return worst


# ------------------------------------------------------------ phase 6
def _ca_work(torch, b):
    """The live (q, kv) pairs of one server batch as a boolean
    [T*blk, N*blk] mask, and the bytes each function must move: the
    inputs only on the q rows and kv slots that some live pair reads
    (empty task slots, padded rows and kv blocks no task covers need none
    of theirs), the outputs whole, since the function returns them whole
    (out 0 and lse LSE_DEAD on dead rows, zero gradients where no pair
    reaches).  Returns (vis, pairs, (fwd bytes, fwd FLOPs), (bwd bytes,
    bwd FLOPs), bytes breakdown)."""
    q, k = b["q_tasks"], b["k_buf"]
    T, blk, hq, dh = q.shape
    N, _, hkv, _ = k.shape
    dev = q.device
    n_blk = torch.clamp(b["kv_len"].long(), max=b["jmax"])
    start = b["kv_start"].long()
    row_task = torch.arange(T * blk, device=dev) // blk
    col_blk = torch.arange(N * blk, device=dev) // blk
    in_range = (col_blk[None] >= start[row_task][:, None]) \
        & (col_blk[None] < (start + n_blk)[row_task][:, None])
    pq = b["q_pos"].reshape(-1).long()[:, None]
    pk = b["kv_pos"].reshape(-1).long()[None]
    vis = in_range & (pq >= pk) & (pq >= 0) & (pk >= 0)
    del in_range
    pairs = int(vis.sum())
    q_rows = int(vis.any(1).sum())          # q rows some pair reads
    kv_rows = int(vis.any(0).sum())         # kv slots some pair reads
    el = q.element_size()
    q_row, kv_row = hq * dh * el, hkv * dh * el      # one row, one tensor
    lse_row = hq * 4
    meta = sum(b[n].numel() * 4 for n in ("kv_start", "kv_len", "q_pos",
                                          "kv_pos"))
    # fwd reads q, k, v and writes out, lse
    fwd_in = q_rows * q_row + kv_rows * 2 * kv_row + meta
    fwd_out = T * blk * (q_row + lse_row)
    # bwd reads q, k, v, out, lse, do and writes dq, dk, dv
    bwd_in = q_rows * (3 * q_row + lse_row) + kv_rows * 2 * kv_row + meta
    bwd_out = q.numel() * el + 2 * k.numel() * el
    info = dict(live_tasks=int((b["kv_len"] > 0).sum()), q_rows=q_rows,
                kv_rows=kv_rows, fwd_in=fwd_in,
                fwd_out=fwd_out, bwd_in=bwd_in, bwd_out=bwd_out)
    return vis, pairs, (fwd_in + fwd_out, 4.0 * pairs * hq * dh), \
        (bwd_in + bwd_out, 10.0 * pairs * hq * dh), info


def _bound(nbytes, flops, peak_flops=BF16_FLOPS):
    t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / peak_flops
    return 1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations"


def ca_kernel_times(torch, ops, per_server, inp, card, softcap=0.0,
                    phase=6):
    """Phase 6 (and 16, with gemma2's softcap): the CA-server kernels at a
    captured layer's shapes (its servers' batches ``per_server``, summed):
    kernel, plain version, scaled_dot_product_attention with the
    equivalent boolean mask (the memory-efficient backend, which has no
    softcap; the port never calls it) and the bound; and as the
    yardstick, the flash kernels on the same layer's q/k/v (``inp``, the
    same live pairs attended in place)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    gen = torch.Generator(device=DEVICE).manual_seed(4)
    layer = per_server[0]["layer"]
    tot = {k: 0.0 for k in ("fwd", "fwd_repeat", "bwd", "plain_fwd",
                            "plain_bwd",
                            "sdpa_fwd", "sdpa_fwd_bwd", "fwd_bytes",
                            "fwd_flops", "bwd_bytes", "bwd_flops",
                            "pairs", "live_tasks", "q_rows", "kv_rows",
                            "fwd_in", "fwd_out", "bwd_in", "bwd_out")}
    for s, b in enumerate(per_server):
        args = {k: b[k] for k in ("q_tasks", "k_buf", "v_buf", "kv_start",
                                  "kv_len", "q_pos", "kv_pos")}
        opts = {k: b[k] for k in ("jmax", "window", "sink", "rate")}
        opts["softcap"] = softcap
        q, k, v = args["q_tasks"], args["k_buf"], args["v_buf"]
        T, blk, hq, dh = q.shape
        N, _, hkv, _ = k.shape
        do = torch.randn(q.shape, generator=gen, device=DEVICE).to(q.dtype)
        out, lse = ops.ca_server_fwd(**args, **opts)
        bwd_in = (q, k, v, out, lse, do, args["kv_start"], args["kv_len"],
                  args["q_pos"], args["kv_pos"])
        vis, pairs, fwd_w, bwd_w, info = _ca_work(torch, b)
        t = {"fwd": cuda_ms(lambda: ops.ca_server_fwd(**args, **opts),
                            iters=10),
             "bwd": cuda_ms(lambda: ops.ca_server_bwd(*bwd_in, **opts),
                            iters=10),
             "plain_fwd": cuda_ms(lambda: ops.ca_server_fwd_reference(
                 **args, **opts), iters=2, warmup=1),
             "plain_bwd": cuda_ms(lambda: ops.ca_server_bwd_reference(
                 *bwd_in, **opts), iters=2, warmup=1)}
        # the yardstick's inputs in its own layout, made before timing
        qs = q.reshape(T * blk, hq, dh).transpose(0, 1)[None].contiguous()
        ks, vs = (x.reshape(N * blk, hkv, dh).repeat_interleave(
            hq // hkv, dim=1).transpose(0, 1)[None].contiguous()
            for x in (k, v))
        dos = do.reshape(T * blk, hq, dh).transpose(0, 1)[None] \
            .contiguous()
        mask = vis[None, None]
        qg, kg, vg = (x.clone().requires_grad_() for x in (qs, ks, vs))

        def sdpa_fwd_bwd():
            o = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask)
            return torch.autograd.grad(o, (qg, kg, vg), dos)

        with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
            t["sdpa_fwd"] = cuda_ms(lambda: F.scaled_dot_product_attention(
                qs, ks, vs, attn_mask=mask), iters=5)
            t["sdpa_fwd_bwd"] = cuda_ms(sdpa_fwd_bwd, iters=5)
        t["fwd_repeat"] = cuda_ms(
            lambda: ops.ca_server_fwd(**args, **opts), iters=10)
        del vis, mask, qs, ks, vs, dos, qg, kg, vg
        torch.cuda.empty_cache()
        f_bound = _bound(*fwd_w)
        b_bound = _bound(*bwd_w)
        log(f"phase {phase}: layer {layer} server {s}: T {T} x blk {blk} "
            f"({info['live_tasks']} live tasks, {info['q_rows']} q rows "
            f"read), kv buffer {N} blocks ({info['kv_rows']} slots read), "
            f"{pairs} live pairs; "
            f"fwd reads {info['fwd_in'] / 1e6:.1f} MB, writes "
            f"{info['fwd_out'] / 1e6:.1f} MB; bwd reads "
            f"{info['bwd_in'] / 1e6:.1f} MB, writes "
            f"{info['bwd_out'] / 1e6:.1f} MB; fwd kernel {t['fwd']:.3f} / "
            f"{t['fwd_repeat']:.3f} ms (bound {f_bound[0]:.4f} "
            f"{f_bound[1]}), plain {t['plain_fwd']:.3f}, sdpa "
            f"{t['sdpa_fwd']:.3f}; bwd kernel "
            f"{t['bwd']:.3f} ms (bound {b_bound[0]:.4f} {b_bound[1]}), "
            f"plain {t['plain_bwd']:.3f}, sdpa fwd+bwd "
            f"{t['sdpa_fwd_bwd']:.3f} [{card}]")
        for key, val in t.items():
            tot[key] += val
        tot["fwd_bytes"] += fwd_w[0]
        tot["fwd_flops"] += fwd_w[1]
        tot["bwd_bytes"] += bwd_w[0]
        tot["bwd_flops"] += bwd_w[1]
        tot["pairs"] += pairs
        for key, val in info.items():
            tot[key] += val
    f_bound = _bound(tot["fwd_bytes"], tot["fwd_flops"])
    b_bound = _bound(tot["bwd_bytes"], tot["bwd_flops"])
    args = flash_inputs(torch, inp)
    fl = dict(softcap=softcap)
    do = torch.randn(args[0].shape, generator=gen, device=DEVICE) \
        .to(args[0].dtype)
    out, lse = ops.flash_fwd(*args, **fl)
    tot["flash_fwd"] = cuda_ms(lambda: ops.flash_fwd(*args, **fl), iters=10)
    tot["flash_bwd"] = cuda_ms(lambda: ops.flash_bwd(
        *args[:3], out, lse, do, *args[3:], **fl), iters=5)
    del out, lse, do
    log(f"phase {phase}: yardstick, the flash kernels on the same layer "
        f"{layer} q/k/v {tuple(args[0].shape)} (the same live pairs, "
        f"attended in place): fwd {tot['flash_fwd']:.3f} ms, bwd "
        f"{tot['flash_bwd']:.3f} ms; CA / flash "
        f"{tot['fwd'] / tot['flash_fwd']:.2f}x fwd, "
        f"{tot['bwd'] / tot['flash_bwd']:.2f}x bwd [{card}]")
    log(f"phase {phase}: one layer's CA work ({len(per_server)} servers, "
        f"{int(tot['live_tasks'])} "
        f"live tasks, {int(tot['q_rows'])} q rows and {int(tot['kv_rows'])} "
        f"kv slots read, {int(tot['pairs'])} live pairs): fwd "
        f"{tot['fwd']:.3f} / {tot['fwd_repeat']:.3f} ms = "
        f"{tot['fwd_flops'] / tot['fwd'] / 1e9:.2f} TFLOP/s (bound "
        f"{f_bound[0]:.4f} ms, {f_bound[1]}: {tot['fwd_bytes'] / 1e6:.1f} "
        f"MB, {tot['fwd_flops'] / 1e9:.1f} GFLOP), bwd {tot['bwd']:.3f} ms "
        f"= {tot['bwd_flops'] / tot['bwd'] / 1e9:.2f} TFLOP/s (bound "
        f"{b_bound[0]:.4f} ms, {b_bound[1]}: {tot['bwd_bytes'] / 1e6:.1f} "
        f"MB, {tot['bwd_flops'] / 1e9:.1f} GFLOP) [{card}]")
    return tot, f_bound, b_bound


# ----------------------------------------------------------- phase 17
# The streamed serve's range sizes at llama3-8b's jmax 32 (and jmax
# itself: one finalizing range); STREAM_MAIN_CHUNK is the one whose time
# the kernels line reports.
STREAM_CHUNKS = (1, 4, 7)
STREAM_MAIN_CHUNK = 4
# The ring against CAD on layer 0 in bf16: both serve the same pairs, but
# the ring rounds each pass's partial output to bf16 before the merge, so
# the two differ by a few bf16 steps of the output.  The gap is max |ring
# - CAD| / max |CAD| over the layer's output: 1.016e-3 on an H100 80GB
# HBM3 (700 W) (the kernels are deterministic and the batch seeded); the
# limit is 1.5x that.  A fault control (the ring with its second pass
# dropped: the kv of that shard never attended; 1.199 there) must fall
# outside it.  The gradients' gaps, max |ring - CAD| / max |CAD| of dq,
# dk and dv, were 1.786e-3, 4.878e-3 and 5.291e-3 in the same runs; their
# limit is 1.5x the largest, with the same control required outside it.
RING_GAP_LIMIT = 1.5e-3
RING_GRAD_GAP_LIMIT = 8e-3
RING_REQUIRED_CONTROLS = ("a ring pass dropped",)


def _server_lost_blocks(np, dispatch, cfg, plan, server):
    """[D, NB] boolean: the q blocks whose task runs on ``server``."""
    plan_np = dispatch._plan_numpy(plan)
    lost = np.zeros(cfg.n_servers * cfg.nb, bool)
    for slot in range(plan_np["task_kv_len"].shape[1]):
        g = dispatch._plan_task_q_block(cfg, plan_np, server, slot)
        if g is not None:
            lost[g] = True
    return lost.reshape(cfg.n_servers, cfg.nb)


def _traced_breakdown(fn):
    """``device_breakdown`` of one call of ``fn`` traced with
    ``torch.profiler``, after an untraced warm-up call; a window with no
    device event is traced again (PROFILE_WINDOWS)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import breakdown
    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_WINDOWS):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = prof.events()
        if any(breakdown.is_kernel(e) for e in events):
            return breakdown.device_breakdown(events)
    raise SystemExit(f"phase 17: the profiler recorded no device time in "
                     f"{PROFILE_WINDOWS} windows")


def _carry_bytes(torch, b, chunk, jmax):
    """Bytes a streamed serve must move for its carries at ``chunk``: at
    each range boundary inside a task's kv range, the online-softmax
    state of its live q rows (m, l and dh accumulators in f32 per q head)
    stored once and loaded once."""
    kvl = torch.clamp(b["kv_len"].long(), max=jmax)
    crossings = torch.clamp((kvl + chunk - 1) // chunk - 1, min=0)
    live_rows = (b["q_pos"] >= 0).sum(1)
    _, _, hq, dh = b["q_tasks"].shape
    return int((crossings * live_rows).sum()) * hq * (dh + 2) * 4 * 2


def dispatch_and_ring(torch, np, ops, inp, per_server, card):
    """Phase 17: this slice's path at llama3-8b width, on phase 5's
    captured layer-0 q/k/v, segment ids and plan (4 servers, jmax 32),
    through the entry points a user calls: the decomposed dispatch
    (``build_server_inputs`` -> ``serve_task_batch`` ->
    ``assemble_step_outputs``) bitwise equal to ``_global_sim``; one
    server dropped, re-served and merged (``merge_recovered``) bitwise
    equal to the fault-free output; streamed serves (``stream_chunk``
    1/4/7 and the explicit call at 32) bitwise equal to unstreamed;
    ``ring_attention`` bitwise equal to ``ring_global_sim``, forward and
    gradients, and within RING_GAP_LIMIT of CAD with its control
    outside.  The launch counts are read around that run.  Then the
    times: CAD's per-server serves against the ring's passes and merges
    (fwd, fwd+bwd), the streamed forward at each chunk against the
    unstreamed one, and the g_lse backward on phase 6's server batches."""
    from repro_torch.core import dispatch as D
    cad = inp["ctx"].cad
    plan, cfg = cad.plan, cad.cfg
    d, jmax = cfg.n_servers, cad.jmax or cfg.nkv
    pos = torch.where(inp["segment_ids"] > 0, inp["positions"], -1) \
        .to(torch.int32)
    segs = inp["segment_ids"].cpu().numpy().reshape(d, -1)
    q, k, v = (inp[n].detach() for n in "qkv")
    gen = torch.Generator(device=DEVICE).manual_seed(7)
    g = torch.randn(q.shape, generator=gen, device=DEVICE).to(q.dtype)
    checks = {}

    def with_grads(fn):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        out = fn(*leaves)
        return out, torch.autograd.grad(out, leaves, g)

    ops.reset_launches()
    with torch.no_grad():
        inputs, plans_r = D.build_server_inputs(cad, plan, q, k, v, pos)
        outs = {s: D.serve_task_batch(cad, inputs[s], plans_r[s])
                for s in range(d)}
        dec = D.assemble_step_outputs(cfg, plan, outs, q.shape, q.dtype)
        sim = D._global_sim(q, k, v, pos, plan, cad, 0.0, None)
        checks["decomposed == _global_sim"] = same_bits(torch, dec, sim)
        lost = _server_lost_blocks(np, D, cfg, plan, 1)
        base = D.assemble_step_outputs(
            cfg, plan, {s: o for s, o in outs.items() if s != 1}, q.shape,
            q.dtype)
        again = D.serve_task_batch(cad, inputs[1], plans_r[1])
        rec = D.assemble_step_outputs(cfg, plan, {1: again}, q.shape,
                                      q.dtype)
        checks["merge_recovered (server 1 dropped) == fault-free"] = \
            same_bits(torch, D.merge_recovered(cfg, base, rec, lost), dec) \
            and not same_bits(torch, base, dec)
        for chunk in STREAM_CHUNKS + (jmax,):
            streamed = {s: (D.serve_task_batch(cad, inputs[s], plans_r[s],
                                               stream_chunk=chunk)
                            if chunk < jmax else
                            D.stream_task_batch(cad, inputs[s], plans_r[s],
                                                chunk_blocks=chunk))
                        for s in range(d)}
            checks[f"streamed at chunk {chunk} == unstreamed"] = all(
                same_bits(torch, streamed[s], outs[s]) for s in range(d))
    pass_plans = D.ring_pass_geometry(cfg, segs, plan, mask=cad.mask)
    ring, ring_g = with_grads(lambda a, b, c: D.ring_attention(
        cad, plan, segs, a, b, c, pos, pass_plans=pass_plans))
    rsim, rsim_g = with_grads(lambda a, b, c: D.ring_global_sim(
        a, b, c, pos, plan, cad, segs, pass_plans=pass_plans))
    torch.cuda.synchronize()
    counts = {n: ops.launches[n] for n in ("ca_server_fwd",
                                           "ca_server_fwd_range",
                                           "ca_server_bwd_dq",
                                           "ca_server_bwd_glse",
                                           "ca_server_bwd_dkv")}
    checks["ring_attention == ring_global_sim (fwd)"] = same_bits(
        torch, ring, rsim)
    checks["ring_attention == ring_global_sim (grads)"] = all(
        same_bits(torch, a, b) for a, b in zip(ring_g, rsim_g))
    cad_out, cad_g = with_grads(lambda a, b, c: D._global_sim(
        a, b, c, pos, plan, cad, 0.0, None))
    scale = float(cad_out.detach().float().abs().max())
    gap = float((ring.detach().float()
                 - cad_out.detach().float()).abs().max()) / scale
    grad_gaps = [float((a.float() - b.float()).abs().max())
                 / float(b.float().abs().max()) for a, b in zip(ring_g,
                                                                cad_g)]
    dropped = [dict(pp) for pp in pass_plans]
    dropped[1] = dict(dropped[1], task_kv_len=np.zeros_like(
        dropped[1]["task_kv_len"]), jmax=0)
    ctrl, ctrl_g = with_grads(lambda a, b, c: D.ring_attention(
        cad, plan, segs, a, b, c, pos, pass_plans=dropped))
    controls = {"a ring pass dropped": float(
        (ctrl.detach().float() - cad_out.detach().float()).abs().max())
        / scale}
    grad_controls = {"a ring pass dropped": min(
        float((a.float() - b.float()).abs().max())
        / float(b.float().abs().max()) for a, b in zip(ctrl_g, cad_g))}
    del ctrl, ctrl_g, rsim, rsim_g, cad_g
    log(f"phase 17: layer 0 at llama3-8b width, {d} servers, jmax {jmax}, "
        f"{len(pass_plans)} ring passes (live: "
        f"{sum(pp['jmax'] > 0 for pp in pass_plans)}): launches {counts}; "
        + "; ".join(f"{k_} {v_}" for k_, v_ in checks.items()))
    log(f"phase 17: ring vs CAD in bf16: max |out diff| / max |out| "
        f"{gap:.3e} (limit {RING_GAP_LIMIT}), grads dq/dk/dv "
        f"{', '.join(f'{x:.3e}' for x in grad_gaps)} (limit "
        f"{RING_GRAD_GAP_LIMIT}); controls {controls}, on the grads (the "
        f"least of dq/dk/dv) {grad_controls} [{card}]")
    for name, ok in checks.items():
        if not ok:
            raise SystemExit(f"phase 17: {name} failed")
    if counts["ca_server_fwd_range"] == 0 or counts["ca_server_bwd_glse"] \
            == 0:
        raise SystemExit(f"phase 17: a kernel of the path was not launched: "
                         f"{counts}")
    if not gap <= RING_GAP_LIMIT:
        raise SystemExit(f"phase 17: ring vs CAD gap {gap} > "
                         f"{RING_GAP_LIMIT}")
    if not max(grad_gaps) <= RING_GRAD_GAP_LIMIT:
        raise SystemExit(f"phase 17: ring vs CAD gradient gaps {grad_gaps}"
                         f" > {RING_GRAD_GAP_LIMIT}")
    for name in RING_REQUIRED_CONTROLS:
        if not (controls[name] > RING_GAP_LIMIT
                and grad_controls[name] > RING_GRAD_GAP_LIMIT):
            raise SystemExit(f"phase 17: control '{name}' "
                             f"{controls[name]} / {grad_controls[name]} "
                             f"inside a limit")

    # times, on the same simulated servers and batches
    t = {}
    with torch.no_grad():
        t["cad_fwd"] = cuda_ms(lambda: [D.serve_task_batch(
            cad, inputs[s], plans_r[s]) for s in range(d)], iters=10)
        t["ring_fwd"] = cuda_ms(lambda: [D._ring_serve_merge(
            cad, inputs[s], pass_plans, s) for s in range(d)], iters=10)
        for chunk in STREAM_CHUNKS + (jmax,):
            t[f"stream_{chunk}"] = cuda_ms(lambda c=chunk: [
                D.stream_task_batch(cad, inputs[s], plans_r[s],
                                    chunk_blocks=c) for s in range(d)],
                iters=10)
        kws = [D._server_kwargs(cad, inputs[s], plans_r[s])
               for s in range(d)]
        t["plain_stream"] = cuda_ms(lambda: [ops.ca_server_fwd_chunked(
            **kw, chunk_blocks=STREAM_MAIN_CHUNK,
            fwd_range=ops.ca_server_fwd_range_reference) for kw in kws],
            iters=2, warmup=1)
        # the range forward against its plain version at these shapes
        range_errs = []
        for kw in kws:
            got = ops.ca_server_fwd_chunked(**kw,
                                            chunk_blocks=STREAM_MAIN_CHUNK)
            plain = ops.ca_server_fwd_chunked(
                **kw, chunk_blocks=STREAM_MAIN_CHUNK,
                fwd_range=ops.ca_server_fwd_range_reference)
            range_errs += [_max_err(torch, got[0], plain[0], q.dtype),
                           _max_err(torch, got[1], plain[1].float(),
                                    q.dtype)]
            del got, plain
        # where the ring forward's device time goes: one traced call
        ring_bd = _traced_breakdown(lambda: [D._ring_serve_merge(
            cad, inputs[s], pass_plans, s) for s in range(d)])
    dos = [torch.randn(inputs[s][0].shape, generator=gen,
                       device=DEVICE).to(q.dtype) for s in range(d)]
    leaves = [[x.detach().clone().requires_grad_() for x in
               (inputs[s][0], inputs[s][2], inputs[s][3])]
              for s in range(d)]

    def grads(serve):
        for s in range(d):
            qt, kb, vb = leaves[s]
            ins = (qt, inputs[s][1], kb, vb, inputs[s][4])
            torch.autograd.grad(serve(ins, s), leaves[s], dos[s])

    t["cad_fwd_bwd"] = cuda_ms(lambda: grads(
        lambda ins, s: D.serve_task_batch(cad, ins, plans_r[s])), iters=5)
    t["ring_fwd_bwd"] = cuda_ms(lambda: grads(
        lambda ins, s: D._ring_serve_merge(cad, ins, pass_plans, s)),
        iters=5)
    # the g_lse backward on phase 6's server batches (row 5's shapes)
    bytes_b = flops_b = bytes_r = flops_r = 0.0
    t["glse_bwd"] = t["plain_glse_bwd"] = 0.0
    glse_errs, glse_repeats = [], True
    for b in per_server:
        args = {n: b[n] for n in ("q_tasks", "k_buf", "v_buf", "kv_start",
                                  "kv_len", "q_pos", "kv_pos")}
        opts = {n: b[n] for n in ("jmax", "window", "sink", "rate")}
        T, blk, hq, _ = b["q_tasks"].shape
        out, lse = ops.ca_server_fwd(**args, **opts)
        do = torch.randn(out.shape, generator=gen, device=DEVICE) \
            .to(out.dtype)
        g_lse = torch.randn((T, hq, blk), generator=gen, device=DEVICE)
        bwd_in = (args["q_tasks"], args["k_buf"], args["v_buf"], out, lse,
                  do, args["kv_start"], args["kv_len"], args["q_pos"],
                  args["kv_pos"])
        t["glse_bwd"] += cuda_ms(lambda: ops.ca_server_bwd(
            *bwd_in, **opts, g_lse=g_lse), iters=10)
        t["plain_glse_bwd"] += cuda_ms(lambda: ops.ca_server_bwd_reference(
            *bwd_in, **opts, g_lse=g_lse), iters=2, warmup=1)
        # the g_lse backward against its plain version at these shapes,
        # and repeated bitwise
        got = ops.ca_server_bwd(*bwd_in, **opts, g_lse=g_lse)
        ref = ops.ca_server_bwd_reference(*bwd_in, **opts, g_lse=g_lse)
        glse_repeats &= all(same_bits(torch, a, c) for a, c in zip(
            got, ops.ca_server_bwd(*bwd_in, **opts, g_lse=g_lse)))
        glse_errs += [_grad_err(torch, a, c, out.dtype)
                      for a, c in zip(got, ref)]
        del got, ref
        vis, _, fwd_w, bwd_w, _ = _ca_work(torch, b)
        del vis
        bytes_b += bwd_w[0] + g_lse.numel() * 4
        flops_b += bwd_w[1]
        bytes_r += fwd_w[0] + _carry_bytes(torch, b, STREAM_MAIN_CHUNK,
                                           b["jmax"])
        flops_r += fwd_w[1]
    torch.cuda.empty_cache()
    range_err = max(e for e, _ in range_errs)
    glse_err = max(e for e, _ in glse_errs)
    log(f"phase 17: on layer 0's server batches, ca_server_fwd_range at "
        f"chunk {STREAM_MAIN_CHUNK} == plain version (max |err| out/lse "
        f"{range_err:.3e}, within atol=rtol={BF16_ATOL}); the g_lse "
        f"backward on phase 6's == plain version (grads {glse_err:.3e}, "
        f"same tolerance), repeated bitwise {glse_repeats} [{card}]")
    if not all(ok for _, ok in range_errs + glse_errs) or not glse_repeats:
        raise SystemExit("phase 17: a kernel disagrees with its plain "
                         "version at llama3-8b width")
    r_bound = _bound(bytes_r, flops_r)
    g_bound = _bound(bytes_b, flops_b)
    log(f"phase 17: layer 0, {d} servers summed: CAD serves fwd "
        f"{t['cad_fwd']:.3f} ms, fwd+bwd {t['cad_fwd_bwd']:.3f}; ring "
        f"({len(pass_plans)} passes + merges) fwd {t['ring_fwd']:.3f}, "
        f"fwd+bwd {t['ring_fwd_bwd']:.3f} [{card}]")
    fams = {f: ms for f, ms in ring_bd["families"].items() if ms}
    log(f"phase 17: one ring forward traced: {ring_bd['kernels']} device "
        f"events, busy {ring_bd['busy_ms']:.3f} ms of a "
        f"{ring_bd['span_ms']:.3f} ms span; ms by family "
        + ", ".join(f"{f} {ms:.3f} ({ms / ring_bd['busy_ms']:.4f})"
                    for f, ms in fams.items()) + f" [{card}]")
    for kname, ms in ring_bd["top_other"]:
        log(f"  other: {ms:9.3f} ms  {kname[:100]}")
    log(f"phase 17: streamed forward (4 servers) by chunk: "
        + ", ".join(f"{c}: {t[f'stream_{c}']:.3f} ms"
                    for c in STREAM_CHUNKS + (jmax,))
        + f"; unstreamed serve {t['cad_fwd']:.3f}; plain at chunk "
        f"{STREAM_MAIN_CHUNK} {t['plain_stream']:.1f}; bound at chunk "
        f"{STREAM_MAIN_CHUNK} {r_bound[0]:.4f} ms ({r_bound[1]}: "
        f"{bytes_r / 1e6:.1f} MB with the carries, {flops_r / 1e9:.1f} "
        f"GFLOP) [{card}]")
    log(f"phase 17: g_lse backward on phase 6's batches: {t['glse_bwd']:.3f}"
        f" ms (bound {g_bound[0]:.4f} {g_bound[1]}: {bytes_b / 1e6:.1f} MB, "
        f"{flops_b / 1e9:.1f} GFLOP), plain {t['plain_glse_bwd']:.1f} "
        f"[{card}]")
    return dict(counts=counts, checks=checks, gap=gap, grad_gaps=grad_gaps,
                controls=controls, grad_controls=grad_controls, times=t,
                range_bound=r_bound, glse_bound=g_bound,
                range_err=range_err, glse_err=glse_err,
                ring_trace=dict(busy_ms=ring_bd["busy_ms"],
                                span_ms=ring_bd["span_ms"],
                                families=fams))


# ----------------------------------------------------------- phase 18
def train_calibrated(torch, np, ops, card, cad_steps):
    """Phase 18: phase 5's configuration with ``calibrate=True`` and
    ``calibrate_every=1`` for 3 steps: the probe times each server's batch
    of the step's plan in bf16 on the card after each step and feeds the
    calibrator.  Step-0 loss bitwise equal to phase 5's (it is made before
    any backward, and a forward gives the same loss under any plan);
    launches = phase 5's + the probe's forwards (a warm-up and one a
    server); the fitted grid cells logged beside the analytic model's
    prediction.  Then the steps whose plan calibration moved, and the
    replay of its batches and plans without calibrator or probe, which
    must give its losses bitwise: the witness that the plans alone, and
    not the probes, set its later bf16 losses."""
    from repro_torch.cad import CADSession
    from repro_torch.core.plan import PLAN_FIELDS
    from repro_torch.models.model import Transformer
    from repro_torch.train.trainer import train
    cfg, pipe, tc, uncalibrated = _train_setup()
    n_servers = pipe.n_ranks
    session = CADSession.for_pipeline(cfg, pipe, plan_policy="balanced",
                                      prefetch=2, calibrate=True)
    # each step's batch as the trainer takes it, plan attached (the
    # session is a frozen dataclass: the hook is set on the instance)
    taken = []

    def recording(batches, attach=session.attach_plans):
        gen = attach(batches)
        try:
            for b in gen:
                taken.append(dict(b))
                yield b
        finally:
            gen.close()         # stops the plan-prefetch worker
    object.__setattr__(session, "attach_plans", recording)
    tc = dataclasses.replace(tc, calibrate_every=1)
    probe_fwd = 1 + n_servers
    expect = {"ca_server_fwd": n_servers * cfg.n_layers * 2 + probe_fwd,
              "ca_server_bwd_dq": n_servers * cfg.n_layers,
              "ca_server_bwd_dkv": n_servers * cfg.n_layers}
    steps = []

    def on_step(step, m):
        counts = {k: ops.launches[k] for k in expect}
        ops.reset_launches()
        steps.append(dict(m, counts=counts))
        speeds = [round(m.get(f"sched_calib_speed_{s}", float("nan")), 4)
                  for s in range(n_servers)]
        log(f"phase 18: step {step} loss {m['loss']:.6f} step "
            f"{1e3 * m['step_s']:.1f} ms launches {counts} calib_version "
            f"{m.get('sched_calib_version')} speeds {speeds} [{card}]")

    model = Transformer(cfg, device=DEVICE, seed=0)
    ops.reset_launches()
    res = train(cfg, pipe, tc, model=model, session=session, device=DEVICE,
                on_step=on_step)
    del res, model
    gc.collect()
    torch.cuda.empty_cache()
    cal = session.calibrator
    for s in steps:
        if s["counts"] != expect:
            raise SystemExit(f"phase 18: step {s['step']} launches "
                             f"{s['counts']} != {expect}")
    if steps[0]["loss"] != cad_steps[0]["loss"]:
        raise SystemExit(f"phase 18: step-0 loss {steps[0]['loss']!r} != "
                         f"phase 5's {cad_steps[0]['loss']!r}")
    if cal.n_observations == 0 or cal.version == 0:
        raise SystemExit("phase 18: the calibrator was never fed")
    if any("sched_calib_version" not in s for s in steps[1:]):
        raise SystemExit("phase 18: a later plan carries no calib_version")
    state = cal.state_dict()
    cells = np.asarray(state["cells"])
    grid = []
    for qi, ki in zip(*np.nonzero(~np.isnan(cells))):
        qg, kvg = float(cal.q_grid[qi]), float(cal.kv_grid[ki])
        grid.append(dict(q_tokens=qg, kv_tokens=kvg,
                         measured_s=float(cells[qi, ki]),
                         analytic_s=float(cal.base.predict(qg, kvg))))
    speeds = [float(x) for x in cal.speeds()]
    log(f"phase 18: calibrator version {cal.version}, "
        f"{cal.n_observations} observations; per-server speeds {speeds} "
        f"(4 simulated servers on one card: near 1 expected) [{card}]")
    for c in grid:
        log(f"  cell q {c['q_tokens']:.0f} x kv {c['kv_tokens']:.0f}: "
            f"measured {1e6 * c['measured_s']:.2f} us, analytic "
            f"{1e6 * c['analytic_s']:.2f} us "
            f"({c['measured_s'] / c['analytic_s']:.2f}x)")
    log(f"phase 18: launches per step = {expect} (phase 5's + {probe_fwd} "
        f"probe forwards); step-0 loss bitwise equal to phase 5's")

    # the witness: which plans calibration moved, and that those plans
    # alone give the calibrated losses (replayed with no calibrator and
    # no probe, on a fresh model of the same seed)
    plain = uncalibrated("balanced")
    moved = [i for i, b in enumerate(taken) if not all(
        np.array_equal(np.asarray(b["plan"][f]), np.asarray(
            plain.plan_batch({k: v for k, v in b.items() if k not in (
                "plan", "schedule_stats")})["plan"][f]))
        for f in PLAN_FIELDS)]
    replay = uncalibrated("balanced")
    object.__setattr__(replay, "attach_plans",
                       lambda batches: (dict(b) for b in taken))
    replayed = []
    model = Transformer(cfg, device=DEVICE, seed=0)
    train(cfg, pipe, dataclasses.replace(tc, calibrate_every=0),
          model=model, session=replay, device=DEVICE,
          on_step=lambda step, m: replayed.append(m["loss"]))
    del model
    gc.collect()
    torch.cuda.empty_cache()
    losses = [s["loss"] for s in steps]
    log(f"phase 18: steps whose calibrated plan differs from the "
        f"uncalibrated planner's on the same batch: {moved}; the calibrated "
        f"batches and plans replayed without calibrator or probe: losses "
        f"{replayed} (calibrated {losses}, phase 5 "
        f"{[s['loss'] for s in cad_steps]}), bitwise "
        f"{replayed == losses} [{card}]")
    if replayed != losses:
        raise SystemExit("phase 18: the replayed plans do not give the "
                         "calibrated losses")
    return dict(loss=[s["loss"] for s in steps],
                calib_version=[s.get("sched_calib_version") for s in steps],
                version=cal.version, n_obs=cal.n_observations,
                speeds=speeds, grid=grid, plans_moved_at_steps=moved,
                replayed_loss_bitwise=replayed == losses)


# ----------------------------------------------------------- phase 19
# Phase 19's fault schedules on phase 5's captured layer 0 (4 servers):
# the kill and its reduced-pool witness, a flap, a straggler the executor
# speculates, and the streamed kill's range size.
ELASTIC_KILL = "kill:2@1"
ELASTIC_FLAP = "flap:1@0+2"
ELASTIC_SLOW = "slow:3x4@0"
ELASTIC_SPECULATE_PCT = 0.9
ELASTIC_STREAM_CHUNK = 4
ELASTIC_STEPS = 3
# phase 19(b): the fused trainer under a kill
TRAIN_KILL = "kill:1@1"
# phase 19(c): smollm-360m checkpointed in bf16
CKPT_ARCH = "smollm-360m"


def _fwd_launches(ops):
    return {n: ops.launches[n] for n in ("ca_server_fwd",
                                         "ca_server_fwd_range")}


def elastic_runtime(torch, np, ops, inp, card):
    """Phase 19(a): the elastic executor at llama3-8b width on phase 5's
    captured layer-0 q/k/v, segment ids and plan (4 servers, balanced),
    with the launch counts read around each step.  Bitwise: fault-free ==
    ``_global_sim``; ELASTIC_KILL's step 1 == the fault-free output and
    == a fresh executor whose pool lacks server 2, at steps 1 and 2;
    ELASTIC_FLAP rejoins at step 2 with the fault-free bits;
    ELASTIC_SLOW with speculation speculates server 3 with the fault-free
    bits; the kill streamed in ranges of ELASTIC_STREAM_CHUNK kv blocks
    gives the kill's bits; traced == untraced, and ``trace_report``
    attributes the kill and the speculation to their servers.  Every
    step's CA-forward launches = its served plus its recovery servers
    (x ranges when streamed); a step reporting a serve-error fails the
    run (none is injected).  Then the kill under the ``wall`` timer: each
    server's synchronized serve and recovery ms beside the model's
    prediction, the outputs again bitwise."""
    from repro_torch.core import dispatch as D
    from repro_torch.launch import trace_report
    from repro_torch.obs import MetricsRegistry, TraceRecorder
    from repro_torch.runtime import ElasticExecutor, FaultSchedule, \
        ServerPool
    cad = inp["ctx"].cad
    cfg = cad.cfg
    d, jmax = cfg.n_servers, cad.jmax or cfg.nkv
    pos = torch.where(inp["segment_ids"] > 0, inp["positions"], -1) \
        .to(torch.int32)
    segs = inp["segment_ids"].cpu().numpy().reshape(d, -1)
    q, k, v = (inp[n].detach() for n in "qkv")
    base = dataclasses.replace(_train_setup()[3]("balanced"), prefetch=0)
    checks, launches, bad_counts, serve_errors = {}, {}, [], []

    def executor(spec="", pool=None, stream_chunk=0, **kw):
        sess = base if not stream_chunk else dataclasses.replace(
            base, cfg=dataclasses.replace(cfg, stream_chunk=stream_chunk))
        return ElasticExecutor(sess.with_pool(pool or ServerPool(d)),
                               faults=FaultSchedule.parse(spec), **kw)

    def run(name, ex, steps, ranges=1):
        outs, reps = [], []
        for step in steps:
            ops.reset_launches()
            out, rep = ex.run_step(step, q, k, v, pos, segs)
            torch.cuda.synchronize()
            counts = _fwd_launches(ops)
            served = len(rep.server_seconds) + len(rep.recovery_seconds)
            want = ({"ca_server_fwd": served, "ca_server_fwd_range": 0}
                    if ranges == 1 else
                    {"ca_server_fwd": 0, "ca_server_fwd_range":
                     served * ranges})
            if counts != want:
                bad_counts.append((name, step, counts, want))
            serve_errors.extend(e for e in rep.events if "serve-error" in e)
            launches[f"{name} step {step}"] = counts
            outs.append(out)
            reps.append(rep)
        return outs, reps

    t0 = time.perf_counter()
    (free,), (free_rep,) = run("fault-free", executor(), [0])
    plan, _ = base.plan(segs)
    sim = D._global_sim(q, k, v, pos, plan.to(DEVICE),
                        D.CADContext(cfg=cfg, jmax=jmax), 0.0, None)
    checks["fault-free == _global_sim"] = same_bits(torch, free, sim)
    free_digest = _bits_digest(torch, free)
    del sim
    kill, kill_reps = run("kill", executor(ELASTIC_KILL),
                          range(ELASTIC_STEPS))
    reduced = ServerPool(d)
    reduced.remove(2)
    red, _ = run("reduced pool", executor(pool=reduced), [1, 2])
    checks["kill: step 1 failed server 2, blocks recovered"] = \
        kill_reps[1].failed == (2,) and kill_reps[1].recovered_blocks > 0
    checks["kill == fault-free (steps 0-2)"] = all(
        same_bits(torch, o, free) for o in kill)
    checks["kill == reduced pool (steps 1, 2)"] = all(
        same_bits(torch, a, b) for a, b in zip(kill[1:], red))
    flap, flap_reps = run("flap", executor(ELASTIC_FLAP),
                          range(ELASTIC_STEPS))
    checks["flap: servers served 3, 3, 4 (rejoin at step 2)"] = \
        [len(r.server_seconds) for r in flap_reps] == [3, 3, 4] \
        and flap_reps[0].failed == (1,) \
        and flap_reps[1].epoch < flap_reps[2].epoch
    checks["flap == fault-free"] = all(same_bits(torch, o, free)
                                       for o in flap)
    spec_rec = TraceRecorder(capacity=4096)
    (slow,), (slow_rep,) = run("slow + speculation", executor(
        ELASTIC_SLOW, speculate_pct=ELASTIC_SPECULATE_PCT,
        recorder=spec_rec, metrics=MetricsRegistry()), [0])
    checks["slow: server 3 speculated"] = slow_rep.speculated == (3,)
    checks["speculated == fault-free"] = same_bits(torch, slow, free)
    ranges = -(-jmax // ELASTIC_STREAM_CHUNK)
    streamed, _ = run("kill streamed", executor(
        ELASTIC_KILL, stream_chunk=ELASTIC_STREAM_CHUNK),
        range(ELASTIC_STEPS), ranges=ranges)
    checks[f"kill streamed at {ELASTIC_STREAM_CHUNK} == unstreamed"] = all(
        same_bits(torch, a, b) for a, b in zip(streamed, kill))
    rec = TraceRecorder(capacity=4096)
    traced, _ = run("kill traced", executor(
        ELASTIC_KILL, recorder=rec, metrics=MetricsRegistry()),
        range(ELASTIC_STEPS))
    checks["traced == untraced"] = all(
        same_bits(torch, a, b) for a, b in zip(traced, kill))
    kill_at = trace_report.attribute_step(
        trace_report.load_steps(rec.to_chrome_trace())[1])
    spec_at = trace_report.load_steps(spec_rec.to_chrome_trace())[0]
    checks["trace_report: kill on server 2 at step 1"] = \
        "kill" in kill_at["events"] and [
            e.track for e in rec.events() if e.name == "kill"] \
        == ["server/2"]
    checks["trace_report: speculation on server 3 at step 0"] = \
        spec_at.get(3, {}).get("events") == ["speculate"]
    del streamed, traced, flap, red
    model_s = time.perf_counter() - t0

    # the wall timer: each serve timed between two synchronizes
    wall, wall_reps = run("kill wall", executor(ELASTIC_KILL, timer="wall"),
                          range(ELASTIC_STEPS))
    checks["wall timer: the same bits"] = all(
        same_bits(torch, a, b) for a, b in zip(wall, kill))
    del wall, kill
    for step, (w, m) in enumerate(zip(wall_reps, kill_reps)):
        serve = {s: (round(1e3 * w.server_seconds[s], 4),
                     round(1e3 * m.server_seconds[s], 4))
                 for s in sorted(w.server_seconds)}
        recov = {s: (round(1e3 * w.recovery_seconds[s], 4),
                     round(1e3 * m.recovery_seconds[s], 4))
                 for s in sorted(w.recovery_seconds)}
        log(f"phase 19: wall step {step}: serve ms (measured, model) "
            f"{serve}; recovery ms {recov}; step {1e3 * w.step_seconds:.3f}"
            f" ms (model {1e3 * m.step_seconds:.3f}); launches "
            f"{launches[f'kill wall step {step}']} [{card}]")
    log(f"phase 19: layer 0 at llama3-8b width, {d} servers, jmax {jmax}: "
        f"kill recovered {kill_reps[1].recovered_blocks} blocks on "
        f"{sorted(kill_reps[1].recovery_seconds)}; speculated "
        f"{slow_rep.speculated} (deadline {1e3 * slow_rep.deadline:.3f} "
        f"model ms); model-timer runs {model_s:.2f} s; launches {launches}")
    for name, ok in checks.items():
        log(f"  {name}: {ok}")
    failed = [n for n, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"phase 19: failed: {failed}")
    if bad_counts:
        raise SystemExit(f"phase 19: CA-forward launches != served + "
                         f"recovery servers: {bad_counts}")
    if serve_errors:
        raise SystemExit(f"phase 19: serve errors nobody injected: "
                         f"{serve_errors}")
    def ms(reps):
        return [{f"{kind} {s}": 1e3 * sec
                 for kind, secs in (("server", r.server_seconds),
                                    ("recovery", r.recovery_seconds))
                 for s, sec in sorted(secs.items())} for r in reps]
    return dict(checks=checks, launches=launches,
                free_digest=free_digest,
                fwd_launches=sum(c["ca_server_fwd"]
                                 for c in launches.values()),
                range_launches=sum(c["ca_server_fwd_range"]
                                   for c in launches.values()),
                recovered_blocks=kill_reps[1].recovered_blocks,
                wall_ms=ms(wall_reps), model_ms=ms(kill_reps))


def train_with_faults(torch, np, ops, card, cad_steps):
    """Phase 19(b): phase 5's configuration under TRAIN_KILL for 3 steps
    on the fused path.  The step-0 loss is bitwise phase 5's; steps 1-2
    carry a higher ``pool_epoch`` and ``pool_active`` 3, and their plans
    give server 1 no task: the batches the worker had prefetched under
    epoch 0 were re-planned at pull.  Launches as phase 5's: the fused
    dispatch serves every server slot, server 1's with no live task."""
    from repro_torch.models.model import Transformer
    from repro_torch.runtime import ServerPool
    from repro_torch.train.trainer import train
    cfg, pipe, tc, session = _train_setup()
    n_servers = pipe.n_ranks
    # the trainer attaches a pool when the session has none; one given
    # here lets the plans be recorded on this instance
    sess = session("balanced").with_pool(ServerPool(n_servers))
    taken = []

    def recording(batches, attach=sess.attach_plans):
        gen = attach(batches)
        try:
            for b in gen:
                taken.append(b["plan"])
                yield b
        finally:
            gen.close()
    object.__setattr__(sess, "attach_plans", recording)
    expect = {"ca_server_fwd": n_servers * cfg.n_layers * 2,
              "ca_server_bwd_dq": n_servers * cfg.n_layers,
              "ca_server_bwd_dkv": n_servers * cfg.n_layers}
    steps = []

    def on_step(step, m):
        counts = {k: ops.launches[k] for k in expect}
        ops.reset_launches()
        steps.append(dict(m, counts=counts))
        log(f"phase 19: fused step {step} loss {m['loss']:.6f} step "
            f"{1e3 * m['step_s']:.1f} ms launches {counts} pool epoch "
            f"{m.get('sched_pool_epoch')} active "
            f"{m.get('sched_pool_active')} events "
            f"{m.get('pool_events', '-')} (phase 5: loss "
            f"{cad_steps[step]['loss']:.6f}, step "
            f"{1e3 * cad_steps[step]['step_s']:.1f} ms) [{card}]")

    model = Transformer(cfg, device=DEVICE, seed=0)
    ops.reset_launches()
    train(cfg, pipe, dataclasses.replace(tc, fault_schedule=TRAIN_KILL),
          model=model, session=sess, device=DEVICE, on_step=on_step)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    dead = [int(np.asarray(p["task_kv_len"])[1].sum()) for p in taken]
    checks = {
        "step-0 loss bitwise phase 5's": steps[0]["loss"]
        == cad_steps[0]["loss"],
        "finite losses": all(math.isfinite(s["loss"]) for s in steps),
        "epoch bumps at step 1": all(
            s["sched_pool_epoch"] > steps[0]["sched_pool_epoch"]
            for s in steps[1:]),
        "3 active servers after the kill": all(
            s["sched_pool_active"] == n_servers - 1 for s in steps[1:]),
        "no plan after the kill gives server 1 a task": dead[1:]
        == [0] * (len(dead) - 1) and dead[0] > 0,
        "launches as phase 5's": all(s["counts"] == expect
                                     for s in steps),
    }
    for name, ok in checks.items():
        log(f"  {name}: {ok}")
    failed = [n for n, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"phase 19: fused trainer under {TRAIN_KILL}: "
                         f"failed {failed}")
    return dict(loss=[s["loss"] for s in steps],
                step_s=[s["step_s"] for s in steps],
                pool_epoch=[s["sched_pool_epoch"] for s in steps],
                launches=steps[1]["counts"], checks=checks)


def checkpoint_roundtrip(torch, np, card):
    """Phase 19(c): smollm-360m at full width and depth in bf16, CAD with
    a calibrator (a probe every step), 2 steps with ``ckpt_every=1`` into
    a temporary directory deleted afterwards; the step-1 checkpoint
    restored into a fresh model and a fresh ``AdamWState`` on the card:
    every tensor bitwise equal in its dtype, the calibrator's state
    equal.  Logs the file size and the save and restore seconds."""
    import tempfile
    from repro_torch.cad import CADSession
    from repro_torch.checkpoint import ckpt
    from repro_torch.configs import get_config
    from repro_torch.core.cost_model import GridCalibrator
    from repro_torch.data.pipeline import PipelineConfig
    from repro_torch.models.model import Transformer
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train.trainer import TrainConfig, train
    cfg = get_config(CKPT_ARCH)
    pipe = PipelineConfig(distribution="prolong", max_doc_len=4096,
                          seq_len=4096, global_batch=4, n_ranks=4,
                          vocab_size=cfg.vocab_size, seed=0)
    sess = CADSession.for_pipeline(cfg, pipe, calibrate=True, prefetch=2)
    saves = []
    save = ckpt.save

    def timed_save(*args, **kw):        # the trainer's save, timed
        t0 = time.perf_counter()
        out = save(*args, **kw)
        saves.append(time.perf_counter() - t0)
        return out
    ckpt.save = timed_save
    with tempfile.TemporaryDirectory() as tmp:
        tc = TrainConfig(steps=2, peak_lr=3e-4, warmup=1, log_every=1,
                         ckpt_every=1, ckpt_dir=tmp, calibrate_every=1)
        try:
            res = train(cfg, pipe, tc, session=sess, device=DEVICE)
        finally:
            ckpt.save = save
        save_s = saves[0]
        step = ckpt.latest_step(tmp)
        size = Path(f"{tmp}/ckpt_{step:08d}.npz").stat().st_size
        want = res["model"].state_dict()
        state = res["opt_state"]
        model = Transformer(cfg, device=DEVICE, seed=1)
        opt = AdamW().init(list(model.parameters()))
        t0 = time.perf_counter()
        got = ckpt.restore(tmp, step, {"params": model.state_dict(),
                                       "opt_state": opt})
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        calib = GridCalibrator(sess.calibrator.base, pipe.n_ranks)
        restored_calib = ckpt.restore_calibration(tmp, step, calib)
    model.load_state_dict(got["params"])
    have = model.state_dict()
    params_ok = all(have[k].dtype == want[k].dtype
                    and have[k].device == want[k].device
                    and same_bits(torch, have[k], want[k]) for k in want)
    opt_ok = got["opt_state"].step == state.step and all(
        a.dtype == b.dtype and a.device == b.device and same_bits(torch, a, b)
        for a, b in zip(got["opt_state"].mu + got["opt_state"].nu,
                        state.mu + state.nu))
    a, b = calib.state_dict(), sess.calibrator.state_dict()
    calib_ok = restored_calib and a.keys() == b.keys() and all(
        np.array_equal(np.asarray(a[x], float), np.asarray(b[x], float),
                       equal_nan=True) if isinstance(a[x], list)
        else a[x] == b[x] for x in a)
    n_params = sum(t.numel() for t in want.values())
    dtypes = sorted({str(t.dtype) for t in want.values()})
    log(f"phase 19: {CKPT_ARCH} ({n_params / 1e6:.1f} M params, {dtypes}, "
        f"{cfg.n_layers} layers), 2 CAD steps with a calibrator, losses "
        f"{[m['loss'] for m in res['history']]}; checkpoint of step {step}: "
        f"{size / 2 ** 20:.1f} MiB, save {save_s:.3f} s, restore "
        f"{restore_s:.3f} s; params bitwise {params_ok}, AdamWState "
        f"bitwise {opt_ok}, calibration {calib_ok} (n_obs "
        f"{b['n_obs']}) [{card}]")
    del res, model, got, want, state
    gc.collect()
    torch.cuda.empty_cache()
    if not (step == 1 and len(saves) == 1 and params_ok and opt_ok
            and calib_ok):
        raise SystemExit(f"phase 19: checkpoint round trip: step {step}, "
                         f"params {params_ok}, optimizer {opt_ok}, "
                         f"calibration {calib_ok}")
    return dict(arch=CKPT_ARCH, params=n_params, mib=size / 2 ** 20,
                save_s=save_s, restore_s=restore_s)


# ------------------------------------------------------------ phase 7
# The colocated step-0 loss against CAD's, on the same weights and batch.
# While ca_server's bf16 path ran FMA kernels on f32-staged tiles, the
# two bf16 routes ran different attention arithmetic and differed by
# 1.287e-4 on an H100 80GB HBM3 (700 W) in every run (both routes'
# kernels are deterministic); the limit is 1.5x that.
# At random init the loss moves only ~4e-3 over three steps, so a limit
# alone could hide a wrong attention: the controls, the colocated loss
# with one fault put in, must fall outside it (on the batch used here:
# documents merged 8.9e-4 to 1.02e-3, no causal mask 1.31e-3 to 1.44e-3).
# Since the tensor-core CA kernels the two bf16 forwards are bitwise
# equal, and the check requires it as well: both run the same tile
# pieces (csrc/tiles.cuh: mma_abt, softmax_step, mma_pb) on the same
# operands.  A CTA's rows are 16 q rows x the 4 q heads of one kv head,
# q row major, in both (a CA task's q block is a 128-token block of the
# packed sequence, so its 16-row groups are flash's), and both walk the
# packed sequence's 64-slot kv tiles in ascending order (a task's kv
# range is its document's blocks in order).  A tile one route visits and
# the other skips holds no visible pair: an exact no-op.  The masks agree
# pair by pair, as the f32 run's bitwise check shows on these batches.
CO_LOSS_LIMIT = 1.93e-4
CO_REQUIRED_CONTROLS = ("documents merged", "no causal mask")
# the exact check: an f32 run of the same configuration, depth cut to
# CO_F32_LAYERS, where both routes' attention kernels keep exact f32 FMA
# arithmetic in the same tile order, so the step-0 losses are bitwise equal
CO_F32_LAYERS = 2


def _step0_loss(torch, model, ctx, batch):
    """The loss of one forward of ``model`` on ``batch`` (no update)."""
    from repro_torch.train.loss import lm_loss
    with torch.no_grad():
        logits, _ = model(batch, ctx)
        return float(lm_loss(logits, batch["labels"],
                             batch["segment_ids"])[0])


def colocated_controls(torch, ops, cad_loss, setup=None):
    """Phase 7 (and 25, with ``setup=_moe_setup``): the colocated forward
    loss on phase 5's first batch and weights, plain and with one fault
    put in each time (each row's documents merged into one; attention
    without the causal mask), against CAD's step-0 loss.  Returns {name:
    loss}."""
    from repro_torch.data.pipeline import raw_batches
    from repro_torch.models.model import Transformer
    from repro_torch.parallel import ParallelContext
    from repro_torch.train.step import batch_to_device
    cfg, pipe, tc, _ = (setup or _train_setup)()
    ctx = ParallelContext(attn_impl="pallas", remat=True)
    model = Transformer(cfg, device=DEVICE, seed=tc.seed)
    gen = raw_batches(pipe)
    batch = batch_to_device(next(gen), DEVICE)
    gen.close()
    orig = ops.packed_flash_attention
    losses = {"none (forward only)": _step0_loss(torch, model, ctx, batch),
              "documents merged": _step0_loss(torch, model, ctx, dict(
                  batch, segment_ids=(batch["segment_ids"] > 0)
                  .to(torch.int32)))}
    ops.packed_flash_attention = \
        lambda *a, **kw: orig(*a, **dict(kw, causal=False))
    try:
        losses["no causal mask"] = _step0_loss(torch, model, ctx, batch)
    finally:
        ops.packed_flash_attention = orig
    del model, batch
    gc.collect()
    torch.cuda.empty_cache()
    ops.reset_launches()
    for k, v in losses.items():
        need = k in CO_REQUIRED_CONTROLS
        log(f"  control, {k}: colocated loss {v!r}, |diff| to CAD's "
            f"{abs(v - cad_loss):.3e}"
            + (" (must exceed the limit)" if need else " (recorded)"))
    return losses


def exact_f32_step0(torch, ops, card):
    """Phase 7: phases 5 and 7's configuration in f32 (weights and compute;
    depth cut to CO_F32_LAYERS; same batch and seed), one step of CAD
    (4 simulated servers, ``ca_server``'s f32 kernels) and one colocated
    (``packed_flash_attention``'s f32 kernels): the step-0 losses must be
    bitwise equal, each route's kernels launched and no other's."""
    from repro_torch.parallel import ParallelContext
    from repro_torch.train.trainer import train
    cfg, pipe, tc, _ = _train_setup()
    cfg = dataclasses.replace(cfg, n_layers=CO_F32_LAYERS,
                              param_dtype="float32", compute_dtype="float32")
    tc = dataclasses.replace(tc, steps=1)
    cad_names = ("ca_server_fwd", "ca_server_bwd_dq", "ca_server_bwd_dkv")
    runs = {}
    for route in ("cad", "colocated"):
        ops.reset_launches()
        if route == "cad":
            from repro_torch.cad import CADSession
            res = train(cfg, pipe, tc, device=DEVICE,
                        session=CADSession.for_pipeline(
                            cfg, pipe, plan_policy="balanced", prefetch=2))
        else:
            res = train(cfg, pipe, tc, device=DEVICE,
                        ctx=ParallelContext(attn_impl="pallas", remat=True))
        mine = sum(v for k, v in ops.launches.items()
                   if (k in cad_names) == (route == "cad"))
        others = sum(ops.launches.values()) - mine
        runs[route] = (res["history"][0]["loss"], mine, others,
                       res["history"][0]["step_s"])
        del res
        gc.collect()
        torch.cuda.empty_cache()
    ops.reset_launches()
    (l_cad, n_cad, o_cad, t_cad), (l_co, n_co, o_co, t_co) = \
        runs["cad"], runs["colocated"]
    log(f"phase 7: f32 run, {cfg.n_layers} layers at llama3-8b width, one "
        f"step each: CAD step-0 loss {l_cad!r} ({n_cad} CA-server "
        f"launches, {1e3 * t_cad:.1f} ms) vs colocated {l_co!r} ({n_co} "
        f"flash launches, {1e3 * t_co:.1f} ms) (must be bitwise equal) "
        f"[{card}]")
    if l_cad != l_co or not (n_cad and n_co) or o_cad or o_co:
        raise SystemExit("phase 7: the f32 colocated and CAD step-0 losses "
                         "differ, or a route ran the other's kernels")
    return l_cad


def train_colocated(torch, ops, card, cad_steps):
    """Phase 7: colocated training (``attn_impl="pallas"``, every layer
    attends where it is through the flash kernels) on phase 5's exact
    configuration, weights and batches."""
    from repro_torch.models.model import Transformer
    from repro_torch.parallel import ParallelContext
    from repro_torch.train.trainer import train
    cfg, pipe, tc, _ = _train_setup()
    tokens = pipe.global_batch * pipe.seq_len
    model = Transformer(cfg, device=DEVICE, seed=0)
    captured = {}

    def capture(layer, inputs):
        if layer in (0, cfg.n_layers - 1) and layer not in captured:
            captured[layer] = {k: v.detach().clone() if torch.is_tensor(v)
                               else v for k, v in inputs.items()}

    expect = {"flash_fwd": cfg.n_layers * 2,           # + remat
              "flash_bwd_dq": cfg.n_layers, "flash_bwd_dkv": cfg.n_layers,
              "flash_tile_ranges": cfg.n_layers * 3}    # a fwd or bwd each
    steps = []

    def on_step(step, m):
        counts = {k: ops.launches[k] for k in expect}
        others = sum(n for k, n in ops.launches.items() if k not in expect)
        mem = torch.cuda.max_memory_allocated() / 2 ** 30
        ops.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        model.attn_hook = None              # capture step 0 only
        steps.append(dict(m, counts=counts, others=others, peak_gib=mem))
        cad = cad_steps[step]
        log(f"phase 7: step {step} loss {m['loss']:.6f} gnorm "
            f"{m['grad_norm']:.4f} step {1e3 * m['step_s']:.1f} ms "
            f"{tokens / m['step_s']:.0f} tokens/s peak {mem:.2f} GiB "
            f"launches {counts} | CAD (phase 5): loss {cad['loss']:.6f} "
            f"step {1e3 * cad['step_s']:.1f} ms "
            f"{tokens / cad['step_s']:.0f} tokens/s peak "
            f"{cad['peak_gib']:.2f} GiB [{card}]")

    log(f"phase 7: colocated training, attn_impl='pallas': llama3-8b "
        f"width, {cfg.n_layers} of 32 layers, bf16, {pipe.global_batch} x "
        f"{pipe.seq_len} tokens ({pipe.distribution}), seed 0.  The 4 CAD "
        f"servers of phase 5 share this one card, so the two step times "
        f"are not the paper's comparison")
    model.attn_hook = capture
    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    res = train(cfg, pipe, tc, ctx=ParallelContext(attn_impl="pallas",
                                                   remat=True),
                model=model, device=DEVICE, on_step=on_step)
    del res, model
    gc.collect()
    torch.cuda.empty_cache()
    for s in steps:
        if s["counts"] != expect or s["others"]:
            raise SystemExit(f"phase 7: step {s['step']} launches "
                             f"{s['counts']} (+{s['others']} of other "
                             f"kernels) != {expect}")
        if not math.isfinite(s["loss"]):
            raise SystemExit(f"phase 7: step {s['step']} loss {s['loss']}")
    # the step-0 loss against CAD's (phase 5, same weights and batch):
    # bitwise equal (and so within CO_LOSS_LIMIT), and every required
    # control outside the limit (the f32 run, exact_f32_step0, holds the
    # two routes' f32 kernels bitwise equal too)
    co, cad = steps[0]["loss"], cad_steps[0]["loss"]
    gap = abs(co - cad)
    log(f"phase 7: launches per step = {expect} (layers x {{2 forwards "
        f"with remat, 1 backward}}); step-0 loss {co!r} vs CAD's {cad!r}: "
        f"|diff| {gap:.3e} (limit {CO_LOSS_LIMIT:.1e}; bitwise equal "
        f"{co == cad})")
    controls = colocated_controls(torch, ops, cad)
    c_diff = {k: abs(v - cad) for k, v in controls.items()}
    if co != cad or gap > CO_LOSS_LIMIT \
            or not all(c_diff[k] > CO_LOSS_LIMIT
                       for k in CO_REQUIRED_CONTROLS):
        raise SystemExit("phase 7: the colocated step-0 loss is not bitwise "
                         "equal to CAD's, or a required control is within "
                         "the limit")
    if sorted(captured) != [0, cfg.n_layers - 1]:
        raise SystemExit(f"phase 7: captured layers {sorted(captured)}")
    total = {k: sum(s["counts"][k] for s in steps) for k in expect}
    return steps, captured, total, dict(gap=gap, limit=CO_LOSS_LIMIT,
                                        controls=controls,
                                        control_diffs=c_diff)


def flash_inputs(torch, inp):
    """The flash kernels' arguments of one captured layer."""
    seg = inp["segment_ids"].to(torch.int32).contiguous()
    pos = inp["positions"].to(torch.int32).contiguous()
    return [inp["q"].contiguous(), inp["k"].contiguous(),
            inp["v"].contiguous(), seg, pos, seg, pos]


def check_captured_flash(torch, ops, captured, phase=7):
    """Phase 7 (and 25): the flash kernels against their plain versions on
    the q/k/v captured at layers 0 and 7 (bf16), the dk/dv kernel repeated
    bitwise, and the blockwise ``xla`` route against the kernel on layer
    0."""
    from repro_torch.core.attention import xla_flash_attention
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    worst = 0.0
    for layer, inp in sorted(captured.items()):
        args = flash_inputs(torch, inp)
        do = torch.randn(args[0].shape, generator=gen,
                         device=DEVICE).to(args[0].dtype)
        e_f, e_b, ok = check_flash_pair(torch, ops, args, {}, do)
        log(f"  captured layer {layer}: q {tuple(args[0].shape)} k "
            f"{tuple(args[1].shape)} {args[0].dtype}: fwd max |err| "
            f"{e_f:.3e}, grads {e_b:.3e}")
        if not ok:
            raise SystemExit(f"phase {phase}: flash kernels disagree on captured "
                             f"layer {layer}")
        worst = max(worst, e_f)
    args = flash_inputs(torch, captured[0])
    do = torch.randn(args[0].shape, generator=gen,
                     device=DEVICE).to(args[0].dtype)
    out, lse = ops.flash_fwd(*args)
    runs = [ops.flash_bwd(*args[:3], out, lse, do, *args[3:])
            for _ in range(2)]
    bitwise = all(torch.equal(a, b) for a, b in zip(*runs))
    xla = xla_flash_attention(*args)
    torch.cuda.synchronize()
    e_xla, ok_xla = _max_err(torch, out, xla, out.dtype)
    log(f"phase {phase}: flash backward on layer 0 repeated: bitwise {bitwise}; "
        f"the xla route vs the flash kernel on layer 0: max |err| "
        f"{e_xla:.3e}")
    if not bitwise or not ok_xla:
        raise SystemExit(f"phase {phase}: the flash backward is not "
                         f"deterministic or the xla route disagrees")
    return worst


# ------------------------------------------------------------ phase 8
def head_dim_192_inputs(torch, inp):
    """Phase 8's head_dim-192 case: a captured layer's documents (segment
    ids, positions) with seeded bf16 q [B, S, 32, 192] and k, v [B, S, 8,
    192] (llama3-8b's heads at nemotron-4's head_dim)."""
    gen = torch.Generator(device=DEVICE).manual_seed(192)
    b, s = inp["segment_ids"].shape

    def rnd(h):
        return torch.randn(b, s, h, 192, generator=gen,
                           device=DEVICE).to(torch.bfloat16)
    return dict(q=rnd(32), k=rnd(8), v=rnd(8),
                segment_ids=inp["segment_ids"], positions=inp["positions"])


def _flash_work(torch, args, window=0):
    """Live (q, kv) pairs the token mask allows, and the bytes each
    function moves: every input read once, every output written once."""
    from repro_torch.core.attention import mask_fn
    q, k = args[0], args[1]
    b, s, hq, dh = q.shape
    seg, pos = args[3], args[4]
    vis = mask_fn(seg, pos, seg, pos, causal=True,
                  window=window)                          # [B, S, S]
    pairs = int(vis.sum())
    el = q.element_size()
    ids = 4 * seg.numel() * 4
    lse = b * hq * s * 4
    fwd_bytes = (q.numel() + 2 * k.numel()) * el + ids + q.numel() * el + lse
    bwd_bytes = (3 * q.numel() + 2 * k.numel()) * el + lse + ids \
        + (q.numel() + 2 * k.numel()) * el
    return vis, pairs, (fwd_bytes, 4.0 * pairs * hq * dh), \
        (bwd_bytes, 10.0 * pairs * hq * dh)


def flash_kernel_times(torch, ops, inp, card, window=0, where="phase 8: "
                       "flash at layer 0's shape"):
    """Phase 8 (and 14, with recurrentgemma's window): the flash kernels
    at a captured layer's shape: kernel, plain version,
    ``scaled_dot_product_attention`` with the dense boolean mask
    [B, 1, S, S] (the memory-efficient backend; the port never calls it)
    and the bound."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    gen = torch.Generator(device=DEVICE).manual_seed(6)
    args = flash_inputs(torch, inp)
    q, k, v = args[:3]
    b, s, hq, dh = q.shape
    hkv = k.shape[2]
    opts = dict(window=window)
    do = torch.randn(q.shape, generator=gen, device=DEVICE).to(q.dtype)
    out, lse = ops.flash_fwd(*args, **opts)
    bwd_in = (q, k, v, out, lse, do, *args[3:])
    vis, pairs, fwd_w, bwd_w = _flash_work(torch, args, window)

    def fwd_bwd():
        o, l_ = ops.flash_fwd(*args, **opts)
        return ops.flash_bwd(q, k, v, o, l_, do, *args[3:], **opts)
    sampler = sm_clocks_start()
    try:
        t = {"fwd": cuda_ms(lambda: ops.flash_fwd(*args, **opts), iters=10),
             "bwd": cuda_ms(lambda: ops.flash_bwd(*bwd_in, **opts),
                            iters=5),
             "fwd_bwd": cuda_ms(fwd_bwd, iters=5)}
    except BaseException:
        sampler.kill()
        raise
    clocks = sm_clocks_stop(sampler)
    t["plain_fwd"] = cuda_ms(lambda: ops.flash_fwd_reference(*args, **opts),
                             iters=2, warmup=1)
    t["plain_bwd"] = cuda_ms(lambda: ops.flash_bwd_reference(*bwd_in,
                                                             **opts),
                             iters=2, warmup=1)
    # the yardstick's inputs in its own layout, made before timing
    qs = q.transpose(1, 2).contiguous()
    ks, vs = (x.repeat_interleave(hq // hkv, dim=2).transpose(1, 2)
              .contiguous() for x in (k, v))
    dos = do.transpose(1, 2).contiguous()
    mask = vis[:, None]
    qg, kg, vg = (x.clone().requires_grad_() for x in (qs, ks, vs))
    with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
        t["sdpa_fwd"] = cuda_ms(lambda: F.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=mask), iters=5)

        def sdpa_fwd_bwd():
            o = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask)
            return torch.autograd.grad(o, (qg, kg, vg), dos)
        t["sdpa_fwd_bwd"] = cuda_ms(sdpa_fwd_bwd, iters=5)
        o = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask)
        t["sdpa_bwd"] = cuda_ms(lambda: torch.autograd.grad(
            o, (qg, kg, vg), dos, retain_graph=True), iters=5)
    t["fwd_repeat"] = cuda_ms(lambda: ops.flash_fwd(*args, **opts),
                              iters=10)
    ids = args[3:]
    t["ranges"] = cuda_ms(lambda: ops.flash_tile_ranges(*ids, **opts),
                          iters=10)
    t["plain_ranges"] = cuda_ms(
        lambda: ops.flash_tile_ranges_reference(*ids, **opts), iters=3,
        warmup=1)
    # the prune reads the four id arrays and writes the two ranges
    t["ranges_bound"] = _bound(
        sum(x.numel() for x in ids) * 4 + b * (2 * s // 64) * 2 * 4, 0.0)
    del vis, mask, qs, ks, vs, dos, qg, kg, vg, o
    torch.cuda.empty_cache()
    f_bound, b_bound = _bound(*fwd_w), _bound(*bwd_w)
    log(f"{where} (q {tuple(q.shape)}, k "
        f"{tuple(k.shape)} {q.dtype}, {pairs} live pairs per head = "
        f"{pairs / (b * s * s):.4f} of all): fwd kernel {t['fwd']:.3f} / "
        f"{t['fwd_repeat']:.3f} ms = {fwd_w[1] / t['fwd'] / 1e9:.2f} "
        f"TFLOP/s (bound {f_bound[0]:.4f} ms {f_bound[1]}: "
        f"{fwd_w[0] / 1e6:.1f} MB, {fwd_w[1] / 1e9:.1f} GFLOP), plain "
        f"{t['plain_fwd']:.3f}, sdpa {t['sdpa_fwd']:.3f}; bwd "
        f"kernels {t['bwd']:.3f} ms = {bwd_w[1] / t['bwd'] / 1e9:.2f} "
        f"TFLOP/s (bound {b_bound[0]:.4f} ms {b_bound[1]}: "
        f"{bwd_w[0] / 1e6:.1f} MB, {bwd_w[1] / 1e9:.1f} GFLOP), plain "
        f"{t['plain_bwd']:.3f}, sdpa bwd {t['sdpa_bwd']:.3f}; fwd+bwd "
        f"kernels {t['fwd_bwd']:.3f} ms, sdpa {t['sdpa_fwd_bwd']:.3f}; "
        f"flash_tile_ranges {t['ranges']:.4f} ms (bound "
        f"{t['ranges_bound'][0]:.4f} ms bytes), plain "
        f"{t['plain_ranges']:.3f}; SM "
        f"clock while the kernels were timed {clocks[0]:.0f} / "
        f"{clocks[1]:.0f} / {clocks[2]:.0f} MHz (min / median / max), "
        f"power draw up to {clocks[3]:.1f} W [{card}]")
    return t, f_bound, b_bound, pairs


# ------------------------------------------------------------ phase 9
def xla_route_on_card(torch, ops, card):
    """Phase 9: the colocated ``xla`` route (blockwise attention in plain
    torch ops, the launcher's default without --cad) trains on CUDA
    tensors: ``train()`` at llama3-8b width with 2 layers for one step,
    then the launcher itself on a reduced model."""
    from repro_torch.launch.train import main as train_main
    from repro_torch.models.model import Transformer
    from repro_torch.parallel import ParallelContext
    from repro_torch.train.trainer import train
    cfg, pipe, tc, _ = _train_setup()
    cfg = dataclasses.replace(cfg, n_layers=2)
    model = Transformer(cfg, device=DEVICE, seed=0)
    devices = set()
    model.attn_hook = lambda layer, inp: devices.add(inp["q"].device.type)
    ops.reset_launches()
    res = train(cfg, pipe, dataclasses.replace(tc, steps=1),
                ctx=ParallelContext(attn_impl="xla", remat=True),
                model=model, device=DEVICE)
    m = res["history"][0]
    del res, model
    kernels = sum(ops.launches.values())
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 9: xla route, llama3-8b width, 2 layers, 1 step: loss "
        f"{m['loss']:.6f} step {1e3 * m['step_s']:.1f} ms, attention on "
        f"{sorted(devices)}, {kernels} kernel launches [{card}]")
    if not math.isfinite(m["loss"]) or devices != {"cuda"} or kernels:
        raise SystemExit("phase 9: the xla route did not train on the card")
    res = train_main(["--arch", "smollm-360m-reduced", "--steps", "2",
                      "--seq", "4096", "--batch", "4", "--ranks", "4"])
    losses = [h["loss"] for h in res["history"]]
    device = res["model"].device
    del res
    gc.collect()
    torch.cuda.empty_cache()
    if not all(math.isfinite(x) for x in losses) or device.type != "cuda":
        raise SystemExit(f"phase 9: launcher losses {losses} on {device}")
    log(f"phase 9: launcher without --cad (smollm-360m-reduced, 4 x 4096 "
        f"tokens, 2 steps) on {device}: losses {losses}")


# ----------------------------------------------------------- phase 10
# device ms by kernel family and by bucket: launch/breakdown.py's
# KERNEL_FAMILIES and device_breakdown
def _bucket_ms(bd, digits=1) -> str:
    """A traced window's device ms by bucket (those with any), as text."""
    return ", ".join(f"{b} {ms:.{digits}f}" for b, ms in bd["buckets"].items()
                     if ms)


def sm_clocks_start():
    """nvidia-smi sampling the SM clock and power draw every 100 ms,
    returned once its first sample is in (up to 30 s), so that a window
    shorter than nvidia-smi's start-up is still sampled: the samples run
    from just before the window to its end."""
    import select
    proc = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    ready, _, _ = select.select([proc.stdout], [], [], 30)
    proc.first_sample = proc.stdout.readline() if ready else ""
    return proc


def sm_clocks_stop(proc):
    """Stop the sampler; (min, median, max) SM MHz and the largest power
    draw in W over its samples."""
    proc.terminate()
    out, _ = proc.communicate(timeout=30)
    rows = []
    for line in [proc.first_sample, *out.splitlines()]:
        try:
            mhz, watts = (float(x) for x in line.split(","))
        except ValueError:              # a partial or "[N/A]" sample
            continue
        rows.append((mhz, watts))
    if not rows:
        raise SystemExit("phase 10: nvidia-smi gave no clock samples")
    mhz = sorted(r[0] for r in rows)
    return mhz[0], mhz[len(mhz) // 2], mhz[-1], max(r[1] for r in rows)


def traced_steps(torch, card, cad_steps, co_steps, mamba_steps, rg_steps):
    """Phase 10: one CAD and one colocated step on phases 5 and 7's
    configuration, one mamba2 step on phase 11's and one recurrentgemma
    step on phase 13's, traced with
    ``torch.profiler`` while nvidia-smi samples the SM clock: the second
    step of a fresh 2-step run (the first warms the allocator and
    cuBLAS), beside the live pairs of both attention batches."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.attention import mask_fn
    from repro_torch.data.pipeline import raw_batches
    from repro_torch.launch import breakdown
    from repro_torch.parallel import ParallelContext
    from repro_torch.train.trainer import train
    cfg, pipe, tc, session = _train_setup()
    # the attention kernels' work depends on the batch: phases 6 and 8
    # time them on step 0's, the trace below is of step 1's
    gen, pairs = raw_batches(pipe), []
    for _ in range(2):
        b = next(gen)
        seg, pos = (torch.as_tensor(b[k], dtype=torch.int32, device=DEVICE)
                    for k in ("segment_ids", "positions"))
        pairs.append(int(mask_fn(seg, pos, seg, pos, causal=True,
                                 window=0).sum()))
    gen.close()
    log(f"phase 10: live (q, kv) pairs per head: {pairs[0]} in step 0's "
        f"batch (timed in phases 6 and 8), {pairs[1]} in step 1's (traced "
        f"below), {pairs[1] / pairs[0]:.4f}x")
    pallas = ParallelContext(attn_impl="pallas", remat=True)
    m_cfg, m_pipe, m_tc = _mamba_setup()
    r_cfg_, r_pipe_, r_tc_ = _rg_setup()
    runs = {"CAD": (cfg, pipe, tc, dict(session=session("balanced")),
                    cad_steps, 5),
            "colocated": (cfg, pipe, tc, dict(ctx=pallas), co_steps, 7),
            "mamba2": (m_cfg, m_pipe, m_tc, dict(ctx=pallas), mamba_steps,
                       11),
            "recurrentgemma": (r_cfg_, r_pipe_, r_tc_, dict(ctx=pallas),
                               rg_steps, 13)}
    for name, (r_cfg, r_pipe, r_tc, kw, untraced, phase) in runs.items():
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        traced = {}

        def on_step(step, m):
            if step == 0:
                traced["sampler"] = sm_clocks_start()
                prof.start()
            else:
                prof.stop()
                traced.update(m, clocks=sm_clocks_stop(traced["sampler"]))
        try:
            train(r_cfg, r_pipe, dataclasses.replace(r_tc, steps=2),
                  device=DEVICE, on_step=on_step, **kw)
        except BaseException:
            if "sampler" in traced:
                traced["sampler"].kill()
            raise
        gc.collect()
        torch.cuda.empty_cache()
        bd = breakdown.device_breakdown(prof.events())
        del prof
        host_ms, ref_ms = 1e3 * traced["step_s"], 1e3 * untraced[1]["step_s"]
        fams = ", ".join(f"{f} {ms:.1f}" for f, ms in bd["families"].items())
        lo, med, hi, watts = traced["clocks"]
        log(f"phase 10: {name} step 1 traced: {bd['kernels']} device "
            f"events; host {host_ms:.1f} ms with the profiler on "
            f"({ref_ms:.1f} ms untraced, phase {phase});"
            f" device span {bd['span_ms']:.1f} ms, busy {bd['busy_ms']:.1f} "
            f"ms (idle {1 - bd['busy_ms'] / bd['span_ms']:.4f} of the span, "
            f"{1 - bd['busy_ms'] / ref_ms:.4f} of the untraced step); ms by "
            f"family: {fams}; SM clock {lo:.0f} / {med:.0f} / {hi:.0f} MHz "
            f"(min / median / max), power draw up to {watts:.1f} W [{card}]")
        log(f"  ms by bucket: {_bucket_ms(bd)} [{card}]")
        for fam in ("CA-server kernels", "SSD kernels"):
            ms = bd["families"][fam]
            if ms:
                log(f"  {fam}: {ms:.1f} ms, {ms / bd['busy_ms']:.4f} of the "
                    f"busy time")
        for kname, times in sorted(bd["attention"].items()):
            times.sort()
            log(f"  {kname}: {len(times)} launches, {sum(times):.1f} ms, "
                f"per launch {times[0]:.3f} / {times[len(times) // 2]:.3f} / "
                f"{times[-1]:.3f} ms (min / median / max)")
        for kname, ms in bd["top_other"]:
            log(f"  other: {ms:9.2f} ms  {kname[:100]}")


# ----------------------------------------------------------- phase 11
MAMBA_STEPS = 3


def _mamba_setup():
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import PipelineConfig
    from repro_torch.train.trainer import TrainConfig
    cfg = get_config("mamba2-370m")
    pipe = PipelineConfig(distribution="prolong", max_doc_len=4096,
                          seq_len=4096, global_batch=4, n_ranks=4,
                          vocab_size=cfg.vocab_size, seed=0)
    tc = TrainConfig(steps=MAMBA_STEPS, peak_lr=3e-4, warmup=1,
                     log_every=1, seed=0)
    return cfg, pipe, tc


def train_mamba2(torch, ops, ssd, card):
    """Phase 11: mamba2-370m at full width and depth on the card, bf16,
    through ``trainer.train`` with ``attn_impl="pallas"`` and remat: every
    layer's intra-chunk step in the SSD kernels."""
    from repro_torch.models.model import Transformer
    from repro_torch.parallel import ParallelContext
    from repro_torch.train.trainer import train
    cfg, pipe, tc = _mamba_setup()
    tokens = pipe.global_batch * pipe.seq_len
    model = Transformer(cfg, device=DEVICE, seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    captured = {}

    def capture(layer, inputs):
        if layer in (0, cfg.n_layers - 1) and layer not in captured:
            captured[layer] = {k: v.detach().clone() for k, v in
                               inputs.items()}

    expect = {"ssd_fwd_mma": cfg.n_layers * 2,            # + remat
              "ssd_bwd_part": cfg.n_layers,
              "ssd_bwd_fold": cfg.n_layers}
    steps = []

    def on_step(step, m):
        counts = {k: ssd.launches[k] for k in expect}
        others = sum(ops.launches.values()) + sum(
            v for k, v in ssd.launches.items() if k not in expect)
        mem = torch.cuda.max_memory_allocated() / 2 ** 30
        ssd.reset_launches()
        ops.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        model.attn_hook = None              # capture step 0 only
        steps.append(dict(m, counts=counts, others=others, peak_gib=mem))
        log(f"phase 11: step {step} loss {m['loss']:.6f} gnorm "
            f"{m['grad_norm']:.4f} step {1e3 * m['step_s']:.1f} ms "
            f"{tokens / m['step_s']:.0f} tokens/s peak {mem:.2f} GiB "
            f"launches {counts} [{card}]")

    log(f"phase 11: mamba2-370m at full width and depth ({cfg.n_layers} "
        f"layers, {n_params / 1e6:.1f} M params, bf16), attn_impl='pallas' "
        f"with remat, {pipe.global_batch} x {pipe.seq_len} tokens "
        f"({pipe.distribution}), seed 0")
    model.attn_hook = capture
    ssd.reset_launches()
    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    train(cfg, pipe, tc, ctx=ParallelContext(attn_impl="pallas", remat=True),
          model=model, device=DEVICE, on_step=on_step)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    for s in steps:
        if s["counts"] != expect or s["others"]:
            raise SystemExit(f"phase 11: step {s['step']} launches "
                             f"{s['counts']} (+{s['others']} of other "
                             f"kernels) != {expect}")
        if not math.isfinite(s["loss"]):
            raise SystemExit(f"phase 11: step {s['step']} loss {s['loss']}")
    if sorted(captured) != [0, cfg.n_layers - 1]:
        raise SystemExit(f"phase 11: captured layers {sorted(captured)}")
    log(f"phase 11: launches per step = {expect} (layers x {{2 forwards "
        f"with remat, 1 head-part and 1 fold kernel}}; no f32 SSD kernel)")
    total = {k: sum(s["counts"][k] for s in steps) for k in expect}
    return steps, captured, total, n_params


def _ssd_args(torch, inp, seed):
    """The SSD kernels' arguments of one captured layer, and a seeded
    cotangent (dy, dstate)."""
    args = [inp[k].contiguous() for k in ("C", "B", "x", "dt", "csum", "nr")]
    Bt, K, c, H, P = args[2].shape
    N = args[0].shape[-1]
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    dy = torch.randn(args[2].shape, generator=gen, device=DEVICE)
    dstate = torch.randn((Bt, K, H, N, P), generator=gen, device=DEVICE)
    return args, dy, dstate


def check_captured_ssd(torch, ssd, captured):
    """Phase 11: the SSD kernels against their plain versions on the
    inputs captured at layers 0 and 47 (bf16 C, B and x: the tensor-core
    kernels; the forward at F32_ATOL x max(1, max |ref|), the gradients
    at phase 2's bf16 rule), and the backward repeated bitwise on layer
    0's.  Returns the worst fwd err and grad err."""
    worst_f = worst_b = 0.0
    for layer, inp in sorted(captured.items()):
        args, dy, dstate = _ssd_args(torch, inp, 7 + layer)
        r = check_ssd_pair(torch, ssd, args, dy, dstate, scaled=True)
        nr = args[5]
        ratio, g_err, g_scale = r["ratio"]
        log(f"  captured layer {layer}: C {tuple(args[0].shape)}, x "
            f"{tuple(args[2].shape)} {args[2].dtype}, a reset in "
            f"{int((nr[..., -1] > nr[..., 0]).sum())} of "
            f"{nr.shape[0] * nr.shape[1]} chunks: y/states max |err| "
            f"{r['fwd']:.3e} <= {F32_ATOL} x max(1, max |ref| "
            f"{r['fwd_ref']:.3e}); grads max |err| {r['grad']:.3e}, worst "
            f"{g_err:.3e} / max(1, max |grad|) {g_scale:.3e} = {ratio:.3e} "
            f"<= {SSD_BF16_GRAD_RTOL}")
        if not r["ok"]:
            raise SystemExit(f"phase 11: SSD kernels disagree on captured "
                             f"layer {layer}")
        worst_f, worst_b = max(worst_f, r["fwd"]), max(worst_b, r["grad"])
    args, dy, dstate = _ssd_args(torch, captured[0], 7)
    runs = [ssd.ssd_chunk_bwd(*args, dy, dstate) for _ in range(2)]
    bitwise = all(torch.equal(a, b) for a, b in zip(*runs))
    log(f"phase 11: SSD backward on layer 0 repeated: bitwise {bitwise}")
    if not bitwise:
        raise SystemExit("phase 11: the SSD backward is not deterministic")
    return worst_f, worst_b


# The bf16 einsum and kernel routes' step-0 losses.  The tensor-core
# kernels form y and the states at f32 precision (W and B·u as three bf16
# terms), but their f32 sums are the tensor cores', which come out biased
# toward zero: at every layer of mamba2's first batch y comes out 1.5e-7 to
# 2.1e-7 smaller, relatively, than the plain version in f64 (the plain
# version with cuBLAS's TF32 C·Bᵀ 1.6e-7 to 3.0e-7; the f32 plain version
# within 2.6e-9).  Every layer's output is rounded to bf16, so any change
# of its f32 arithmetic moves some elements one bf16 step, and at random
# init each following layer spreads that: at 48 layers the f64 plain
# version and the f32 one summing j in 16-row blocks, both unbiased, move
# the loss 1.012e-3 and 9.07e-4, the kernel route 2.275e-3 and the fault
# "documents merged" 1.895e-3, and 93-99% of layer 47's block outputs
# differ from the einsum route's under each (NVIDIA H100 80GB HBM3, 700
# W).  A loss limit there cannot tell a fault from rounding:
# mamba2_full_depth holds each of the 48 layers' intra-chunk steps
# against the plain version on the same inputs, and requires the
# route's 48-layer gap to stay within MAMBA_DEPTH_FACTOR x the unbiased
# witnesses' largest, the cause above, measured in every run.
#
# The loss check runs at MAMBA_CHECK_LAYERS (mamba2_route_checks), where
# the honest gaps stay near f32 rounding and the faults stand far above
# them: kernel vs einsum route 5.722e-6 at step 0 and 4.768e-6 on the next
# batch, the witnesses 8.583e-6 (f64) and 9.54e-7 (16-row blocks); the
# faults 2.060e-4 (documents merged), 9.165e-3 (no decay), 1.688e-4 (no
# end state), 6.611e-3 (a reset at every row).  The limit, set at 4x the
# kernel route's largest gap, is 3.5x the largest honest gap; the nearest
# required fault lies 6.9x above it.
MAMBA_LOSS_LIMIT = 3e-5
MAMBA_CHECK_LAYERS = 2
# the controls that must fall outside the limit (mamba2_route_checks)
MAMBA_REQUIRED_CONTROLS = ("documents merged", "no decay")
MAMBA_DEPTH_FACTOR = 4.0


def _mamba_step0_loss(torch, ssd, cfg, pipe, tc, patch=None, impl="pallas",
                      index=0, model=None):
    """The forward loss of the route ``impl`` on batch ``index`` of phase
    11's data and its step-0 weights at ``cfg`` (or ``model``'s), with
    ``ssd.ssd_chunk`` replaced by ``patch(original)`` if given."""
    from repro_torch.data.pipeline import raw_batches
    from repro_torch.models.model import Transformer
    from repro_torch.parallel import ParallelContext
    from repro_torch.train.step import batch_to_device
    own = model is None
    if own:
        model = Transformer(cfg, device=DEVICE, seed=tc.seed)
    gen = raw_batches(pipe)
    for _ in range(index):
        next(gen)
    batch = batch_to_device(next(gen), DEVICE)
    gen.close()
    orig = ssd.ssd_chunk
    if patch is not None:
        ssd.ssd_chunk = patch(orig)
    try:
        return _step0_loss(torch, model, ParallelContext(
            attn_impl=impl, remat=True), batch)
    finally:
        ssd.ssd_chunk = orig
        del batch
        if own:
            del model
        gc.collect()
        torch.cuda.empty_cache()


def _plain64(torch, ssd, C, B, x, dt, csum, nr):
    """``ssd_chunk``'s forward as the plain version computes it, in f64
    (returned in f32): the same function, more exactly."""
    rep = x.shape[3] // C.shape[3]
    C, B, x, dt, csum = (t.double() for t in (C, B, x, dt, csum))
    S = torch.einsum("bkign,bkjgn->bkijg", C, B).repeat_interleave(rep, -1)
    iota = torch.arange(x.shape[2], device=x.device)
    live = ((iota[:, None] >= iota[None, :])
            & (nr[:, :, :, None] == nr[:, :, None, :]))[..., None]
    d = csum[:, :, :, None, :] - csum[:, :, None, :, :]
    dec = torch.where(live, torch.exp(d.clamp(ssd.CLIP_LO, 0.0)), 0.0)
    y = torch.einsum("bkijh,bkjhp->bkihp", S * dec * dt[:, :, None], x)
    e = torch.where((nr == nr[:, :, -1:])[..., None], torch.exp(
        (csum[:, :, -1:] - csum).clamp(ssd.CLIP_LO, 0.0)), 0.0)
    sB = B.repeat_interleave(rep, dim=3) * (e * dt)[..., None]
    st = torch.einsum("bkjhn,bkjhp->bkhnp", sB, x)
    return y.float(), st.float()


def _plain_split(torch, ssd, C, B, x, dt, csum, nr, rows=0, tf32=False):
    """``ssd_chunk``'s forward as the plain version computes it in f32,
    with the sums over j (y and the end state) taken ``rows`` rows at a
    time and added in order (another summation order, rounded to
    nearest), or with S = C·Bᵀ from cuBLAS's TF32 tensor-core products
    (``tf32``: exact products of the bf16 values, the tensor cores' sums)."""
    rep = x.shape[3] // C.shape[3]
    xf = x.float()
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        S, _, dec = ssd._tile_terms(C, B, csum, nr, rep)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    w = S * dec * dt[:, :, None, :, :]
    e, _ = ssd._end_terms(csum, nr)
    sB = B.float().repeat_interleave(rep, dim=3) * (e * dt)[..., None]
    rows = rows or x.shape[2]
    y = st = 0.0
    for j0 in range(0, x.shape[2], rows):
        p = slice(j0, j0 + rows)
        y = y + torch.einsum("bkijh,bkjhp->bkihp", w[:, :, :, p],
                             xf[:, :, p])
        st = st + torch.einsum("bkjhn,bkjhp->bkhnp", sB[:, :, p],
                               xf[:, :, p])
    return y, st


def _ssd_plain64(torch, ssd):
    """A patch of ``ssd_chunk``: the plain version in f64."""
    return lambda f: lambda **a: _plain64(torch, ssd, **a)


def _ssd_blocks(torch, ssd):
    """A patch of ``ssd_chunk``: the plain version in f32 summing j in
    16-row blocks."""
    return lambda f: lambda **a: _plain_split(torch, ssd, rows=16, **a)


def _faulty(**changes):
    """A patch of ``ssd_chunk`` that changes some of its arguments."""
    return lambda f: lambda **a: f(**dict(a, **{
        k: fn(a[k]) for k, fn in changes.items()}))


def _route_steps(torch, ssd, cfg, pipe, tc):
    """One training step of each route (kernel, einsum) at ``cfg``: {impl:
    (step-0 loss, step s, SSD launches)}."""
    from repro_torch.parallel import ParallelContext
    from repro_torch.train.trainer import train
    runs = {}
    for impl in ("pallas", "xla"):
        ssd.reset_launches()
        res = train(cfg, pipe, dataclasses.replace(tc, steps=1),
                    device=DEVICE,
                    ctx=ParallelContext(attn_impl=impl, remat=True))
        runs[impl] = (res["history"][0]["loss"], res["history"][0]["step_s"],
                      dict(ssd.launches))
        del res
        gc.collect()
        torch.cuda.empty_cache()
    ssd.reset_launches()
    return runs


def mamba2_route_checks(torch, ssd, card):
    """Phase 11: the einsum route (``attn_impl="xla"``) against the kernel
    route at mamba2-370m's widths, depth cut to MAMBA_CHECK_LAYERS, the
    same batch and seed, one step each.

    bf16: the kernel route through the tensor-core kernels; its step-0
    loss must lie within MAMBA_LOSS_LIMIT of the einsum route's, and so
    must three more honest gaps: both routes' forward losses on the next
    batch, and the einsum route's against the plain version in f64 and in
    f32 summing over j in 16-row blocks.  Controls, each the kernel
    route's forward loss with one fault put in the intra-chunk step: the
    reset counts nr all 0
    (documents merged inside each chunk), csum all 0 (no decay), the
    chunk-end states zeroed (no state carried between chunks), a reset at
    every row (no token sees another).  Those of MAMBA_REQUIRED_CONTROLS
    must fall outside the limit, or it could not tell a wrong SSD path
    from a right one; all are recorded.

    f32 (weights and compute): the kernel route through the FMA kernels,
    whose forward sums C·Bᵀ, the weighted x and the end state in the order
    cuBLAS's f32 products do for the einsum route (phase 2's f32 forward
    errors are 0), everything around the intra-chunk step shared: the
    step-0 losses must be bitwise equal.

    Each run's kernel route must launch its dtype's kernels and no others;
    the einsum route none."""
    cfg, pipe, tc = _mamba_setup()
    L = MAMBA_CHECK_LAYERS
    fma = {"ssd_chunk_fwd": 2 * L, "ssd_chunk_bwd_dc": L,
           "ssd_chunk_bwd_dbx": L, "ssd_chunk_bwd_dcsum": L}
    mma = {"ssd_fwd_mma": 2 * L, "ssd_bwd_part": L, "ssd_bwd_fold": L}
    out = {}
    for dtype, want in (("bfloat16", mma), ("float32", fma)):
        c = dataclasses.replace(cfg, n_layers=L, param_dtype=dtype,
                                compute_dtype=dtype)
        runs = _route_steps(torch, ssd, c, pipe, tc)
        (l_k, t_k, n_k), (l_x, t_x, n_x) = runs["pallas"], runs["xla"]
        mine = {k: n_k[k] for k in want}
        launched_ok = mine == want and sum(n_k.values()) == sum(
            want.values()) and not sum(n_x.values())
        log(f"phase 11: {dtype} run, {L} layers at mamba2-370m's widths, one "
            f"step each: kernel route step-0 loss {l_k!r} ({1e3 * t_k:.1f} "
            f"ms, launches {mine}) vs einsum route {l_x!r} ({1e3 * t_x:.1f} "
            f"ms): |diff| {abs(l_k - l_x):.3e} ("
            + ("limit " f"{MAMBA_LOSS_LIMIT:.1e}" if dtype == "bfloat16"
               else "must be bitwise equal") + f") [{card}]")
        if not launched_ok or not (math.isfinite(l_k) and math.isfinite(l_x)):
            raise SystemExit(f"phase 11: the {dtype} routes ran the wrong "
                             f"kernels, or a loss is not finite")
        if dtype == "float32":
            if l_k != l_x:
                raise SystemExit("phase 11: the f32 kernel and einsum step-0 "
                                 "losses differ")
            out[dtype] = dict(loss=l_k, launches=mine, step_s=t_k,
                              xla_step_s=t_x)
            continue

        def loss(patch=None, **kw):
            return _mamba_step0_loss(torch, ssd, c, pipe, tc, patch, **kw)

        faulty = _faulty

        def every_row(nr):
            return torch.arange(nr.shape[-1], device=nr.device,
                                dtype=nr.dtype).expand_as(nr).contiguous()
        honest = {
            "kernel vs einsum route, step 0": abs(l_k - l_x),
            "kernel vs einsum route, next batch": abs(
                loss(index=1) - loss(impl="xla", index=1)),
            "plain version in f64": abs(
                loss(_ssd_plain64(torch, ssd)) - l_x),
            "plain version, j in 16-row blocks": abs(
                loss(_ssd_blocks(torch, ssd)) - l_x)}
        controls = {
            "documents merged": loss(faulty(nr=torch.zeros_like)),
            "no decay": loss(faulty(csum=torch.zeros_like)),
            "no end state": loss(lambda f: lambda **a: (
                f(**a)[0], torch.zeros_like(f(**a)[1]))),
            "a reset at every row": loss(faulty(nr=every_row))}
        ssd.reset_launches()
        c_diff = {k: abs(v - l_x) for k, v in controls.items()}
        for k, v in honest.items():
            log(f"  honest gap, {k}: {v:.3e} (must lie within the limit)")
        for k, v in controls.items():
            log(f"  control, {k}: kernel-route loss {v!r}, |diff| to the "
                f"einsum route's {c_diff[k]:.3e}"
                + (" (must exceed the limit)" if k in MAMBA_REQUIRED_CONTROLS
                   else " (recorded)"))
        if max(honest.values()) > MAMBA_LOSS_LIMIT or not all(
                c_diff[k] > MAMBA_LOSS_LIMIT for k in MAMBA_REQUIRED_CONTROLS):
            raise SystemExit("phase 11: an honest bf16 gap exceeds "
                             "MAMBA_LOSS_LIMIT, or a required control does "
                             "not")
        out[dtype] = dict(loss=l_k, xla_loss=l_x, launches=mine, step_s=t_k,
                          xla_step_s=t_x, honest_gaps=honest,
                          controls=controls, control_diffs=c_diff,
                          limit=MAMBA_LOSS_LIMIT)
    return out


def mamba2_full_depth(torch, ssd, card):
    """Phase 11: mamba2-370m at full width and depth (48 layers), bf16,
    the step-0 weights and phase 11's first batch, forward only.

    The kernel route, each layer's intra-chunk step held against the plain
    version on the same inputs: y and the states within F32_ATOL x max(1,
    max |ref|), as on the captured layers, each layer's relative error
    (Frobenius) and relative bias (sum (got - ref)·ref / sum ref²)
    recorded.  Then the einsum route, and the kernel route with its
    intra-chunk step replaced by two witnesses, unbiased changes of the
    einsum route's arithmetic (the plain version in f64, and in f32
    summing j in 16-row blocks), by the plain version with S = C·Bᵀ from
    cuBLAS's TF32 products (exact products, the tensor cores' sums: biased
    as the kernel is), and by the fault "documents merged": each one's
    loss gap to the einsum route, and the share of layer 47's block
    outputs that differ from the einsum route's, recorded.  The
    kernel route's gap must lie within MAMBA_DEPTH_FACTOR x the
    witnesses' largest: rounding alone moves the loss that far at this
    depth (the comment above MAMBA_LOSS_LIMIT)."""
    from repro_torch.models import layers as model_layers
    from repro_torch.models.model import Transformer
    cfg, pipe, tc = _mamba_setup()
    model = Transformer(cfg, device=DEVICE, seed=tc.seed)
    per_layer, last = [], {}

    def compare(f):
        def run(**a):
            got = f(**a)
            want = ssd.ssd_chunk_fwd_reference(**a)
            row = {}
            for name, g, w in zip(("y", "states"), got, want):
                g, w = g.double(), w.double()
                ref, err = float(w.abs().max()), float((g - w).abs().max())
                row[name] = dict(
                    err=err, ref=ref, ok=err <= F32_ATOL * max(1.0, ref),
                    rel=float((g - w).norm() / w.norm()),
                    bias=float(((g - w) * w).sum() / (w * w).sum()))
            exact = _plain64(torch, ssd, **a)[0].double()
            tf32 = _plain_split(torch, ssd, tf32=True, **a)[0]
            for name, v in (("kernel", got[0]), ("plain", want[0]),
                            ("tf32 S", tf32)):
                d = v.double() - exact
                row["bias64 " + name] = float((d * exact).sum()
                                              / (exact * exact).sum())
            per_layer.append(row)
            return got
        return run

    apply = model_layers.ssd_apply

    def keep_last(*a, **k):
        out = apply(*a, **k)
        last["out"] = out
        return out

    def loss(patch=None, impl="pallas"):
        model_layers.ssd_apply = keep_last
        try:
            v = _mamba_step0_loss(torch, ssd, cfg, pipe, tc, patch,
                                  impl=impl, model=model)
        finally:
            model_layers.ssd_apply = apply
        return v, last.pop("out")

    l_k, o_k = loss(compare)
    l_x, o_x = loss(impl="xla")
    runs = {"kernel route": (l_k, o_k),
            "plain version in f64": loss(_ssd_plain64(torch, ssd)),
            "plain version, j in 16-row blocks": loss(_ssd_blocks(torch,
                                                                  ssd)),
            "plain version, S from TF32 products": loss(
                lambda f: lambda **a: _plain_split(torch, ssd, tf32=True,
                                                   **a)),
            "documents merged (a fault)": loss(_faulty(nr=torch.zeros_like))}
    ssd.reset_launches()
    del model
    gc.collect()
    torch.cuda.empty_cache()
    ok = len(per_layer) == cfg.n_layers and all(
        r[k]["ok"] for r in per_layer for k in ("y", "states"))
    bias64 = {k: (min(r["bias64 " + k] for r in per_layer),
                  max(r["bias64 " + k] for r in per_layer))
              for k in ("kernel", "plain", "tf32 S")}
    worst = {k: max(per_layer, key=lambda r: r[k]["err"] / max(
        1.0, r[k]["ref"]))[k] for k in ("y", "states")}
    log(f"phase 11: full depth ({cfg.n_layers} layers, bf16, step-0 "
        f"weights, forward): each layer's intra-chunk step, kernel vs plain "
        f"version on the same inputs: " + "; ".join(
            f"{k} worst max |err| {w['err']:.3e} at max |ref| {w['ref']:.3e} "
            f"(<= {F32_ATOL} x max(1, max |ref|)), relative error "
            f"{min(r[k]['rel'] for r in per_layer):.2e} to "
            f"{max(r[k]['rel'] for r in per_layer):.2e}, relative bias "
            f"{min(r[k]['bias'] for r in per_layer):+.2e} to "
            f"{max(r[k]['bias'] for r in per_layer):+.2e}"
            for k, w in worst.items()) + f" [{card}]")
    log("  y's relative bias against the plain version in f64, over the "
        "layers: " + "; ".join(f"{k} {lo:+.2e} to {hi:+.2e}" for k, (lo, hi)
                               in bias64.items())
        + " (tf32 S: the plain version with C·Bᵀ from cuBLAS's TF32 "
          "tensor-core products, recorded)")
    gaps = {k: abs(v - l_x) for k, (v, _) in runs.items()}
    differ = {k: float((o != o_x).float().mean()) for k, (_, o) in
              runs.items()}
    log(f"phase 11: full depth, einsum route step-0 loss {l_x!r}")
    for k, (v, _) in runs.items():
        log(f"  {k}: loss {v!r}, gap {gaps[k]:.3e}, layer "
            f"{cfg.n_layers - 1}'s block outputs differing "
            f"{100 * differ[k]:.1f}%")
    witness = max(gaps["plain version in f64"],
                  gaps["plain version, j in 16-row blocks"])
    log(f"phase 11: full depth, kernel route's gap {gaps['kernel route']:.3e}"
        f" (must lie within {MAMBA_DEPTH_FACTOR} x the witnesses' largest, "
        f"{witness:.3e})")
    if not ok:
        raise SystemExit("phase 11: a layer's SSD kernel output disagrees "
                         "with the plain version at full depth")
    if gaps["kernel route"] > MAMBA_DEPTH_FACTOR * witness:
        raise SystemExit("phase 11: the full-depth kernel route's loss gap "
                         "exceeds what the unbiased witnesses show")
    return dict(layers=cfg.n_layers, loss=l_k, xla_loss=l_x, gaps=gaps,
                differing_last_layer=differ, witness_factor=MAMBA_DEPTH_FACTOR,
                worst=worst, y_bias64=bias64)


# ----------------------------------------------------------- phase 12
def _ssd_work(torch, args):
    """What the intra-chunk step needs on these inputs: the live (i, j)
    pairs (j <= i in one document of the chunk) and the rows with no
    reset after them, from nr; operations counted on those, with C·Bᵀ,
    dC and dB once per group (B and C are per group: dC_i = sum_j (sum
    over the group's heads of dS_ijh) B_j, the heads' sum an add per
    pair and head); bytes: each input read once and each output written
    once, each at its own element size (C, B and x bf16 or f32; dt, csum,
    dy, dstate and every output f32; nr int32)."""
    C, B, x, dt, csum, nr = args
    Bt, K, c, H, P = x.shape
    G, N = C.shape[3], C.shape[4]
    same = nr[:, :, :, None] == nr[:, :, None, :]
    tri = torch.ones(c, c, dtype=torch.bool, device=nr.device).tril()
    pairs = int((same & tri).sum())
    live_end = int((nr == nr[:, :, -1:]).sum())
    state = 2.0 * live_end * N * P * H
    fwd_flops = 2.0 * pairs * (N * G + P * H) + state
    bwd_flops = 2.0 * pairs * (3 * N * G + 2 * P * H) \
        + pairs * (H - G) + 2 * state

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)
    ins = nbytes(C, B, x, dt, csum, nr)
    f32 = 4
    states = Bt * K * H * N * P * f32
    fwd_bytes = ins + x.numel() * f32 + states             # + y, states
    bwd_bytes = ins + x.numel() * f32 + states \
        + (C.numel() + B.numel() + x.numel() + 2 * dt.numel()) * f32
    return pairs, live_end, (fwd_bytes, fwd_flops), (bwd_bytes, bwd_flops)


def ssd_kernel_times(torch, ssd, inp, card):
    """Phase 12: the SSD kernels at layer 0's captured shape, on its bf16
    C, B and x (the tensor-core kernels, the main path's) and on the same
    values in f32 (the FMA kernels, whose earlier times stay comparable):
    kernel (CUDA event medians, the SM clock sampled meanwhile; the
    backward's launches alone into buffers made beforehand, and the whole
    wrapper, which now ends at its kernels), plain version and the bound
    at the tensor-core rate of the inputs (bf16 989, TF32 495 TFLOP/s),
    with the f32 FMA-pipe figure beside the f32 one.  No single PyTorch
    call computes this function, so there is no library time.  Returns
    {dtype name: times and bounds}."""
    args16, dy, dstate = _ssd_args(torch, inp, 8)
    args32 = [a.float() if k < 3 else a for k, a in enumerate(args16)]
    res = {}
    for name, args in (("bfloat16", args16), ("float32", args32)):
        pairs, live_end, fwd_w, bwd_w = _ssd_work(torch, args)
        out = ssd.ssd_chunk_bwd_buffers(*args[:4])
        sampler = sm_clocks_start()
        try:
            t = {"fwd": cuda_ms(lambda: ssd.ssd_chunk_fwd(*args), iters=10),
                 "bwd": cuda_ms(lambda: ssd.ssd_chunk_bwd_kernels(
                     *args, dy, dstate, out), iters=10),
                 "bwd_wrapper": cuda_ms(lambda: ssd.ssd_chunk_bwd(
                     *args, dy, dstate), iters=10)}
        except BaseException:
            sampler.kill()
            raise
        clocks = sm_clocks_stop(sampler)
        t["plain_fwd"] = cuda_ms(lambda: ssd.ssd_chunk_fwd_reference(*args),
                                 iters=3, warmup=1)
        t["plain_bwd"] = cuda_ms(lambda: ssd.ssd_chunk_bwd_reference(
            *args, dy, dstate), iters=3, warmup=1)
        t["fwd_repeat"] = cuda_ms(lambda: ssd.ssd_chunk_fwd(*args), iters=10)
        del out
        torch.cuda.empty_cache()
        rate, rate_name = ((BF16_FLOPS, "bf16 tensor-core")
                           if name == "bfloat16" else (TF32_FLOPS, "TF32"))
        t.update(f_bound=_bound(*fwd_w, peak_flops=rate),
                 b_bound=_bound(*bwd_w, peak_flops=rate),
                 f_fma=_bound(*fwd_w, peak_flops=F32_FMA_FLOPS),
                 b_fma=_bound(*bwd_w, peak_flops=F32_FMA_FLOPS),
                 pairs=pairs, rate=f"{rate_name} {rate / 1e12:.0f} TFLOP/s")
        fma = (f"; {t['f_fma'][0]:.4f} / {t['b_fma'][0]:.4f} ms on the FMA "
               f"pipes" if name == "float32" else "")
        C, x = args[0], args[2]
        log(f"phase 12: SSD at layer 0's shape, {name} C/B/x (C/B "
            f"{tuple(C.shape)}, x {tuple(x.shape)}, {pairs} live (i, j) "
            f"pairs, {live_end} rows reach the end state): fwd kernel "
            f"{t['fwd']:.3f} / {t['fwd_repeat']:.3f} ms = "
            f"{fwd_w[1] / t['fwd'] / 1e9:.2f} TFLOP/s (bound "
            f"{t['f_bound'][0]:.4f} ms {t['f_bound'][1]} at the {rate_name} "
            f"rate: {fwd_w[0] / 1e6:.1f} MB, {fwd_w[1] / 1e9:.2f} GFLOP), "
            f"plain {t['plain_fwd']:.3f}; bwd kernels {t['bwd']:.3f} ms = "
            f"{bwd_w[1] / t['bwd'] / 1e9:.2f} TFLOP/s, the wrapper "
            f"{t['bwd_wrapper']:.3f} ms (bound {t['b_bound'][0]:.4f} ms "
            f"{t['b_bound'][1]}: {bwd_w[0] / 1e6:.1f} MB, "
            f"{bwd_w[1] / 1e9:.2f} GFLOP{fma}), plain {t['plain_bwd']:.3f}; "
            f"SM clock {clocks[0]:.0f} / {clocks[1]:.0f} / {clocks[2]:.0f} "
            f"MHz (min / median / max), power draw up to {clocks[3]:.1f} W "
            f"[{card}]")
        res[name] = t
    return res


# ----------------------------------------------------------- phase 13
RG_STEPS = 3
# recurrentgemma-9b's widths with its depth cut from 38 layers to the
# Griffin triple twice: 4 rglru and 2 local layers (2.361 B params)
RG_PATTERN = ("rglru", "rglru", "local")
RG_LAYERS = 6
# the data seed: the first batch of seed 1 holds documents of 2788 and 3267
# tokens, so the 2048-token window binds at step 0, where the kernels'
# inputs are captured and the routes compared (seed 0's first batch has
# none longer than 1556)
RG_DATA_SEED = 1
# the xla route's step-0 loss against the kernel route's: they share every
# op but the scan (bitwise equal, phase 2) and attention (flash kernel vs
# blockwise torch ops, equal to rounding), so they differ by what bf16
# rounding of two local layers' outputs carries to the loss.  Recorded
# gaps on an H100: 3.357e-4 (data seed 0) and 1.564e-4 (data seed 1)
# with a first dh-256 flash design, 1.297e-4 (seed 1) with the f32-staged
# FMA design after it; the limit is 1.5x the largest of those.  The
# tensor-core design rounds P to bf16 for P.V (as the TPU kernel does;
# the xla route keeps P and V in f32): 4.425e-4 on seed 1, inside it.  At random init the loss hardly sees the
# scan: dropping its resets moved it 1.9-2.2e-4 and bf16 inputs 6.8-7.1e-4,
# so the scan is held by the bitwise kernel checks, and the loss check by
# the controls that fall outside the limit (3.0e-2 and 1.0e-3 on seed 1)
RG_LOSS_LIMIT = 5e-4
# the controls that must fall outside the limit (rg_xla_route)
RG_REQUIRED_CONTROLS = ("documents merged", "no window")


def _rg_setup():
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import PipelineConfig
    from repro_torch.train.trainer import TrainConfig
    cfg = dataclasses.replace(get_config("recurrentgemma-9b"),
                              layer_pattern=RG_PATTERN, n_layers=RG_LAYERS)
    pipe = PipelineConfig(distribution="prolong", max_doc_len=4096,
                          seq_len=4096, global_batch=2, n_ranks=2,
                          vocab_size=cfg.vocab_size, seed=RG_DATA_SEED)
    tc = TrainConfig(steps=RG_STEPS, peak_lr=3e-4, warmup=1, log_every=1,
                     seed=0)
    return cfg, pipe, tc


_FLASH_NAMES = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                "flash_tile_ranges")


def _rg_counts(ops, rg, ssd):
    """(the recurrentgemma path's kernel launches, launches of every
    other kernel), then every count back to 0."""
    counts = dict(rg.launches, **{k: ops.launches[k] for k in _FLASH_NAMES})
    others = sum(v for k, v in ops.launches.items()
                 if k not in _FLASH_NAMES) + sum(ssd.launches.values())
    for m in (ops, rg, ssd):
        m.reset_launches()
    return counts, others


def train_recurrentgemma(torch, ops, rg, ssd, card):
    """Phase 13: recurrentgemma-9b at full width (depth cut to 6 layers)
    on the card, bf16, through ``trainer.train`` with
    ``attn_impl="pallas"`` and remat: every rglru layer's recurrence in
    the lru_scan kernels, every local layer's attention in the flash
    kernels at head_dim 256."""
    from repro_torch.models.model import Transformer
    from repro_torch.parallel import ParallelContext
    from repro_torch.train.trainer import train
    cfg, pipe, tc = _rg_setup()
    tokens = pipe.global_batch * pipe.seq_len
    model = Transformer(cfg, device=DEVICE, seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    kinds = [cfg.layer_pattern[i % cfg.period] for i in range(cfg.n_layers)]
    rglru = [i for i, k in enumerate(kinds) if k == "rglru"]
    local = [i for i, k in enumerate(kinds) if k == "local"]
    want = (rglru[0], rglru[-1], local[0])
    captured = {}

    def capture(layer, inputs):
        if layer in want and layer not in captured:
            captured[layer] = {k: v.detach().clone() for k, v in
                               inputs.items() if torch.is_tensor(v)}

    expect = {"lru_scan_fwd": 2 * len(rglru),             # + remat
              "lru_scan_bwd": len(rglru),
              "flash_fwd": 2 * len(local), "flash_bwd_dq": len(local),
              "flash_bwd_dkv": len(local),
              "flash_tile_ranges": 3 * len(local)}
    steps = []

    def on_step(step, m):
        counts, others = _rg_counts(ops, rg, ssd)
        mem = torch.cuda.max_memory_allocated() / 2 ** 30
        torch.cuda.reset_peak_memory_stats()
        model.attn_hook = None              # capture step 0 only
        steps.append(dict(m, counts=counts, others=others, peak_gib=mem))
        log(f"phase 13: step {step} loss {m['loss']:.6f} gnorm "
            f"{m['grad_norm']:.4f} step {1e3 * m['step_s']:.1f} ms "
            f"{tokens / m['step_s']:.0f} tokens/s peak {mem:.2f} GiB "
            f"launches {counts} [{card}]")

    log(f"phase 13: recurrentgemma-9b at full width, depth cut to "
        f"{cfg.n_layers} of 38 layers ({kinds}; {n_params / 1e9:.3f} B "
        f"params, bf16), attn_impl='pallas' with remat, "
        f"{pipe.global_batch} x {pipe.seq_len} tokens ({pipe.distribution})"
        f", window {cfg.window}, weights seed {tc.seed}, data seed "
        f"{pipe.seed}")
    model.attn_hook = capture
    _rg_counts(ops, rg, ssd)
    torch.cuda.reset_peak_memory_stats()
    train(cfg, pipe, tc, ctx=ParallelContext(attn_impl="pallas", remat=True),
          model=model, device=DEVICE, on_step=on_step)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    for s in steps:
        if s["counts"] != expect or s["others"]:
            raise SystemExit(f"phase 13: step {s['step']} launches "
                             f"{s['counts']} (+{s['others']} of other "
                             f"kernels) != {expect}")
        if not math.isfinite(s["loss"]):
            raise SystemExit(f"phase 13: step {s['step']} loss {s['loss']}")
    if sorted(captured) != sorted(want):
        raise SystemExit(f"phase 13: captured layers {sorted(captured)}")
    log(f"phase 13: launches per step = {expect} ({len(rglru)} rglru "
        f"layers x {{2 forwards with remat, 1 backward}}, {len(local)} local "
        f"layers x {{2 forwards, 1 dq, 1 dk/dv}})")
    total = {k: sum(s["counts"][k] for s in steps) for k in expect}
    return steps, captured, total, n_params, cfg


def check_captured_rg(torch, ops, rg, captured, cfg):
    """Phase 13: lru_scan against its plain versions (bitwise, as in phase
    2) on the a and bterm captured at the first and last rglru layers,
    with a seeded cotangent; the flash kernels against theirs on the
    q/k/v captured at the first local layer (window 2048), and the
    blockwise ``xla`` route against the flash forward; both backwards
    repeated bitwise."""
    from repro_torch.core.attention import xla_flash_attention
    gen = torch.Generator(device=DEVICE).manual_seed(13)
    errs = {}
    for layer, inp in sorted(captured.items()):
        if "a" in inp:
            a, b = inp["a"].contiguous(), inp["bterm"].contiguous()
            g = torch.randn(a.shape, generator=gen, device=DEVICE)
            e_f, e_b, bitwise, ok = check_lru_pair(torch, rg, a, b, g)
            runs = [rg.lru_scan_bwd(a, rg.lru_scan_fwd(a, b), g)
                    for _ in range(2)]
            again = all(torch.equal(x, y) for x, y in zip(*runs))
            log(f"  captured rglru layer {layer}: a/bterm {tuple(a.shape)} "
                f"f32, a = 0 at {int((a[..., 0] == 0).sum())} positions: h "
                f"max |err| {e_f:.3e}, grads {e_b:.3e}, bitwise {bitwise}; "
                f"backward repeated bitwise {again}")
            if not (ok and bitwise and again):
                raise SystemExit(f"phase 13: lru_scan disagrees on captured "
                                 f"layer {layer}")
            errs.setdefault("lru", []).append((e_f, e_b))
            continue
        args = flash_inputs(torch, inp)
        opts = dict(window=cfg.window)
        do = torch.randn(args[0].shape, generator=gen,
                         device=DEVICE).to(args[0].dtype)
        e_f, e_b, ok = check_flash_pair(torch, ops, args, opts, do)
        out, lse = ops.flash_fwd(*args, **opts)
        runs = [ops.flash_bwd(*args[:3], out, lse, do, *args[3:], **opts)
                for _ in range(2)]
        again = all(torch.equal(x, y) for x, y in zip(*runs))
        xla = xla_flash_attention(*args, **opts)
        torch.cuda.synchronize()
        e_xla, ok_xla = _max_err(torch, out, xla, out.dtype)
        log(f"  captured local layer {layer}: q {tuple(args[0].shape)} k "
            f"{tuple(args[1].shape)} {args[0].dtype}, window {cfg.window}: "
            f"fwd max |err| {e_f:.3e}, grads {e_b:.3e}; backward repeated "
            f"bitwise {again}; the xla route vs the flash kernel: max |err| "
            f"{e_xla:.3e}")
        if not (ok and again and ok_xla):
            raise SystemExit(f"phase 13: flash kernels disagree on captured "
                             f"layer {layer}")
        errs["flash"] = (e_f, e_b)
    return errs


def rg_xla_route(torch, rg, ops, ssd, card, kernel_steps):
    """Phase 13: one step of the ``xla`` route (the plain scan under
    autograd, blockwise attention) at full width on the same weights and
    batch; its step-0 loss must lie within RG_LOSS_LIMIT of the kernel
    route's.  Controls, each the step-0 loss of the same route with one
    fault put in: the scan's a and bterm rounded to bf16 first (a scan
    that lost f32), the scan's document resets dropped (state leaks
    across documents), the documents of each row merged into one (resets
    and document masks lost) and the local layers' window dropped.
    Those in RG_REQUIRED_CONTROLS must fall outside the limit, or it
    could not tell a wrong model from a right one; all are recorded."""
    from repro_torch.data.pipeline import raw_batches
    from repro_torch.models import layers as L
    from repro_torch.models.model import Transformer
    from repro_torch.parallel import ParallelContext
    from repro_torch.train.loss import lm_loss
    from repro_torch.train.step import batch_to_device
    from repro_torch.train.trainer import train
    cfg, pipe, tc = _rg_setup()
    xla = ParallelContext(attn_impl="xla", remat=True)
    _rg_counts(ops, rg, ssd)
    torch.cuda.reset_peak_memory_stats()
    res = train(cfg, pipe, dataclasses.replace(tc, steps=1), ctx=xla,
                device=DEVICE)
    m = res["history"][0]
    counts, others = _rg_counts(ops, rg, ssd)
    mem = torch.cuda.max_memory_allocated() / 2 ** 30
    del res
    gc.collect()
    torch.cuda.empty_cache()
    model = Transformer(cfg, device=DEVICE, seed=tc.seed)
    gen = raw_batches(pipe)
    batch = batch_to_device(next(gen), DEVICE)
    gen.close()

    def loss_of(b):
        with torch.no_grad():
            logits, _ = model(b, xla)
            return float(lm_loss(logits, b["labels"], b["segment_ids"])[0])

    def patched(mod, name, fn):
        """loss_of(batch) with mod.name replaced by fn(original)."""
        orig = getattr(mod, name)
        setattr(mod, name, fn(orig))
        try:
            return loss_of(batch)
        finally:
            setattr(mod, name, orig)
    controls = {
        "bf16 scan inputs": patched(
            L.rglru_ops, "lru_scan_fwd_reference",
            lambda f: lambda a, b: f(a.bfloat16().float(),
                                     b.bfloat16().float())),
        "scan resets dropped": patched(
            L, "_rglru_scan",
            lambda f: lambda p, x, first, **kw: f(
                p, x, torch.zeros_like(first).index_fill_(1, torch.tensor(
                    [0], device=first.device), True), **kw)),
        "documents merged": loss_of(dict(
            batch, segment_ids=(batch["segment_ids"] > 0).to(torch.int32)))}
    model.cfg = dataclasses.replace(cfg, window=0)
    controls["no window"] = loss_of(batch)
    del model, batch
    gc.collect()
    torch.cuda.empty_cache()
    base = kernel_steps[0]["loss"]
    diff = abs(m["loss"] - base)
    c_diff = {k: abs(v - base) for k, v in controls.items()}
    log(f"phase 13: xla route (attn_impl='xla'), 1 step: loss "
        f"{m['loss']!r} vs the kernel route's {base!r}: |diff| {diff:.3e} "
        f"(limit {RG_LOSS_LIMIT:.1e}); step {1e3 * m['step_s']:.1f} ms, "
        f"peak {mem:.2f} GiB, launches {counts} (+{others}) [{card}]")
    for k, v in controls.items():
        log(f"  control, {k}: loss {v!r}, |diff| {c_diff[k]:.3e}"
            + (" (must exceed the limit)" if k in RG_REQUIRED_CONTROLS
               else " (recorded)"))
    if any(counts.values()) or others or not math.isfinite(m["loss"]) \
            or diff > RG_LOSS_LIMIT \
            or not all(c_diff[k] > RG_LOSS_LIMIT
                       for k in RG_REQUIRED_CONTROLS):
        raise SystemExit("phase 13: the xla route disagrees with the kernel "
                         "route, or a required control does not")
    return m, diff, controls, c_diff


# ----------------------------------------------------------- phase 14
def lru_build_report(torch, build, rg, dtype):
    """Each lru_scan kernel in ``dtype``: ptxas's registers and spills (the
    build's report) and, on the card, its registers, shared memory a CTA
    (the ring's included) and CTAs resident an SM."""
    import re
    info = rg.kernel_info(dtype)
    report = build.build_info["lru_scan"][1].splitlines()
    tag = "f" if dtype == torch.float32 else "13__nv_bfloat16"
    for name in info:
        for i, line in enumerate(report):
            if re.search(rf"\d{name}I{tag}E", line):
                used = next((x for x in report[i + 1:i + 4]
                             if "registers" in x), "")
                spill = next((x for x in report[i + 1:i + 4]
                              if "spill" in x), "")
                info[name]["ptxas"] = " ".join(
                    re.sub(r"ptxas info\s*:", "", x).strip()
                    for x in (used, spill) if x)
    return info


def lru_kernel_times(torch, rg, inp, card, build):
    """Phase 14: the lru_scan kernels at the first rglru layer's captured
    shape: kernel (CUDA-event medians, the SM clock sampled meanwhile),
    plain version and the bound (bytes: every input read once, every
    output written once), the achieved rate beside the card's own
    device-to-device copy rate on the same bytes
    (``torch.empty_like(a).copy_(a)``: what the card attains, under the
    data sheet's 3.35 TB/s), each kernel's registers and shared memory.
    No single PyTorch call computes a first-order linear recurrence, so
    there is no library time."""
    a, b = inp["a"].contiguous(), inp["bterm"].contiguous()
    gen = torch.Generator(device=DEVICE).manual_seed(14)
    g = torch.randn(a.shape, generator=gen, device=DEVICE)
    h = rg.lru_scan_fwd(a, b)
    sampler = sm_clocks_start()
    try:
        # ~0.2 ms a launch: 1000 launches keep the card busy long enough
        # for the sampler's 100 ms samples
        t = {"fwd": cuda_ms(lambda: rg.lru_scan_fwd(a, b), iters=1000),
             "bwd": cuda_ms(lambda: rg.lru_scan_bwd(a, h, g), iters=1000),
             "copy": cuda_ms(lambda: torch.empty_like(a).copy_(a),
                             iters=1000)}
    except BaseException:
        sampler.kill()
        raise
    clocks = sm_clocks_stop(sampler)
    t["plain_fwd"] = cuda_ms(lambda: rg.lru_scan_fwd_reference(a, b),
                             iters=3, warmup=1)
    t["plain_bwd"] = cuda_ms(lambda: rg.lru_scan_bwd_reference(a, h, g),
                             iters=3, warmup=1)
    t["fwd_repeat"] = cuda_ms(lambda: rg.lru_scan_fwd(a, b))
    # the card's own time, without the wrapper's host time between two
    # events around one launch
    t["fwd_b2b"] = cuda_ms_back_to_back(lambda: rg.lru_scan_fwd(a, b))
    t["bwd_b2b"] = cuda_ms_back_to_back(lambda: rg.lru_scan_bwd(a, h, g))
    t["copy_b2b"] = cuda_ms_back_to_back(
        lambda: torch.empty_like(a).copy_(a))
    el = a.element_size()
    fwd_w = (3 * a.numel() * el, 2.0 * a.numel())
    bwd_w = (5 * a.numel() * el, 3.0 * a.numel())
    f_bound = _bound(*fwd_w, peak_flops=F32_FMA_FLOPS)
    b_bound = _bound(*bwd_w, peak_flops=F32_FMA_FLOPS)
    # GB/s = bytes / ms / 1e6, of one launch and back to back
    copy_w = 2 * a.numel() * el
    for k, nbytes in (("fwd", fwd_w[0]), ("bwd", bwd_w[0]),
                      ("copy", copy_w)):
        t[k + "_gbs"] = nbytes / t[k] / 1e6
        t[k + "_b2b_gbs"] = nbytes / t[k + "_b2b"] / 1e6
    t["info"] = lru_build_report(torch, build, rg, a.dtype)
    log(f"phase 14: lru_scan at rglru layer 0's shape (a/b {tuple(a.shape)} "
        f"{a.dtype}): fwd kernel {t['fwd']:.4f} / {t['fwd_repeat']:.4f} ms "
        f"(back to back {t['fwd_b2b']:.4f}) = {t['fwd_gbs']:.1f} GB/s "
        f"({t['fwd_b2b_gbs']:.1f} back to back) "
        f"(bound {f_bound[0]:.4f} ms "
        f"{f_bound[1]}: {fwd_w[0] / 1e6:.1f} MB; share "
        f"{f_bound[0] / t['fwd']:.3f}), plain {t['plain_fwd']:.3f}; bwd "
        f"kernel {t['bwd']:.4f} ms (back to back {t['bwd_b2b']:.4f}) = "
        f"{t['bwd_gbs']:.1f} GB/s ({t['bwd_b2b_gbs']:.1f} back to back) "
        f"(bound "
        f"{b_bound[0]:.4f} ms {b_bound[1]}: {bwd_w[0] / 1e6:.1f} MB; share "
        f"{b_bound[0] / t['bwd']:.3f}), plain {t['plain_bwd']:.3f}; the "
        f"card's copy of a ({copy_w / 1e6:.1f} MB moved) {t['copy']:.4f} ms"
        f" (back to back {t['copy_b2b']:.4f}) = {t['copy_gbs']:.1f} GB/s "
        f"({t['copy_b2b_gbs']:.1f} back to back) against the data "
        f"sheet's {HBM_BYTES_PER_S / 1e9:.0f}; library: none; SM clock "
        f"{clocks[0]:.0f} / {clocks[1]:.0f} / {clocks[2]:.0f} MHz (min / "
        f"median / max), power draw up to {clocks[3]:.1f} W [{card}]")
    for name, k in t["info"].items():
        log(f"  {name}: {k['registers']} registers, {k['smem_bytes']} B "
            f"shared a CTA, {k['ctas_per_sm']} CTAs an SM; ptxas: "
            f"{k.get('ptxas', 'not in the report')}")
    return t, f_bound, b_bound


# ----------------------------------------------------------- phase 16
# gemma2-2b's widths (8 q over 4 kv heads of 256, attention softcap 50,
# final softcap 30, vocab 256000) with its depth cut from 26 layers to the
# (local, global) pair twice, on 4 x 2048 ``prolong`` tokens: the f32
# logits over 256000 words bound the tokens one card holds beside phase
# 5's allocator state
GEMMA_CAD_LAYERS = 4
GEMMA_CAD_STEPS = 2
GEMMA_CAD_SEQ = 2048


def _gemma_cad_setup():
    from repro_torch.cad import CADSession
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import PipelineConfig
    from repro_torch.train.trainer import TrainConfig
    cfg = dataclasses.replace(get_config("gemma2-2b"),
                              n_layers=GEMMA_CAD_LAYERS)
    pipe = PipelineConfig(distribution="prolong", max_doc_len=GEMMA_CAD_SEQ,
                          seq_len=GEMMA_CAD_SEQ, global_batch=4, n_ranks=4,
                          vocab_size=cfg.vocab_size, seed=0)
    tc = TrainConfig(steps=GEMMA_CAD_STEPS, peak_lr=3e-4, warmup=1,
                     log_every=1, seed=0)

    def session(policy):
        return CADSession.for_pipeline(cfg, pipe, plan_policy=policy,
                                       prefetch=2)
    return cfg, pipe, tc, session


def train_gemma2_cad(torch, ops, card):
    """Phase 16: a CAD training step of gemma2-2b at full width on the
    card: the global layers through ``ca_server`` at head_dim 256 with the
    attention softcap, the local (windowed) layers on the dispatch's
    blockwise fallback.  Launches each step = servers x global layers x
    {2 forwards with remat, 1 dq, 1 dk/dv}, and no other kernel; the
    step-0 loss bitwise equal under ``identity`` and ``balanced``; the
    kernels held against their plain versions on the server batches
    captured at the first global layer, and timed there."""
    from repro_torch.models.model import Transformer
    from repro_torch.train.trainer import train
    cfg, pipe, tc, session = _gemma_cad_setup()
    n_servers = pipe.n_ranks
    tokens = pipe.global_batch * pipe.seq_len
    kinds = [cfg.layer_pattern[i % cfg.period] for i in range(cfg.n_layers)]
    glob = [i for i, k in enumerate(kinds) if k == "global"]
    ops.reset_launches()
    res = train(cfg, pipe, dataclasses.replace(tc, steps=1),
                session=session("identity"), device=DEVICE)
    loss_identity = res["history"][0]["loss"]
    del res
    gc.collect()
    torch.cuda.empty_cache()

    model = Transformer(cfg, device=DEVICE, seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    captured = {}

    def capture(layer, inputs):
        if layer == glob[0] and layer not in captured:
            captured[layer] = {k: v.detach().clone() if torch.is_tensor(v)
                               else v for k, v in inputs.items()}

    expect = {"ca_server_fwd": n_servers * len(glob) * 2,       # + remat
              "ca_server_bwd_dq": n_servers * len(glob),
              "ca_server_bwd_dkv": n_servers * len(glob)}
    steps = []

    def on_step(step, m):
        counts = {k: ops.launches[k] for k in expect}
        others = sum(n for k, n in ops.launches.items() if k not in expect)
        mem = torch.cuda.max_memory_allocated() / 2 ** 30
        ops.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        model.attn_hook = None              # capture step 0 only
        steps.append(dict(m, counts=counts, others=others, peak_gib=mem))
        log(f"phase 16: step {step} loss {m['loss']:.6f} gnorm "
            f"{m['grad_norm']:.4f} step {1e3 * m['step_s']:.1f} ms "
            f"{tokens / m['step_s']:.0f} tokens/s peak {mem:.2f} GiB "
            f"launches {counts} [{card}]")

    log(f"phase 16: gemma2-2b at full width, depth cut to {cfg.n_layers} of "
        f"26 layers ({kinds}; {n_params / 1e9:.3f} B params, bf16), CAD on "
        f"{n_servers} simulated servers, {pipe.global_batch} x "
        f"{pipe.seq_len} tokens ({pipe.distribution}), head_dim "
        f"{cfg.head_dim}, softcap {cfg.attn_logit_softcap}, window "
        f"{cfg.window} on the local layers; step-0 identity loss "
        f"{loss_identity!r}")
    model.attn_hook = capture
    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    train(cfg, pipe, tc, model=model, session=session("balanced"),
          device=DEVICE, on_step=on_step)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    for st in steps:
        if st["counts"] != expect or st["others"]:
            raise SystemExit(f"phase 16: step {st['step']} launches "
                             f"{st['counts']} (+{st['others']} of other "
                             f"kernels) != {expect}")
        if not math.isfinite(st["loss"]):
            raise SystemExit(f"phase 16: step {st['step']} loss "
                             f"{st['loss']}")
    if steps[0]["loss"] != loss_identity:
        raise SystemExit(f"phase 16: step-0 loss {steps[0]['loss']!r} under "
                         f"balanced != {loss_identity!r} under identity")
    if sorted(captured) != glob[:1]:
        raise SystemExit(f"phase 16: captured layers {sorted(captured)}")
    log(f"phase 16: launches per step = {expect} (servers x {len(glob)} "
        f"global layers x {{2 forwards with remat, 1 backward}}, none on "
        f"the local layers); step-0 loss bitwise equal under identity and "
        f"balanced")
    batches = captured_batches(torch, captured)
    if any(b["q_tasks"].shape[-1] != 256 for b in batches[glob[0]]):
        raise SystemExit("phase 16: the server batches are not head_dim 256")
    err = check_captured(torch, ops, captured, batches,
                         softcap=cfg.attn_logit_softcap, phase=16)
    tot, f_bound, b_bound = ca_kernel_times(
        torch, ops, batches[glob[0]], captured[glob[0]], card,
        softcap=cfg.attn_logit_softcap, phase=16)
    b0 = batches[glob[0]][0]
    shape = (f"global layer {glob[0]}: q_tasks {tuple(b0['q_tasks'].shape)},"
             f" k_buf {tuple(b0['k_buf'].shape)}, softcap "
             f"{cfg.attn_logit_softcap}, {n_servers} servers summed")
    del batches, captured, b0
    gc.collect()
    torch.cuda.empty_cache()
    ops.reset_launches()
    return dict(launches=expect, loss=[st["loss"] for st in steps],
                step_s=[st["step_s"] for st in steps],
                peak_gib=[st["peak_gib"] for st in steps],
                params=n_params, captured_max_abs_err=err, times=tot,
                bounds=(f_bound, b_bound), shape=shape)


# ------------------------------------------------------- phases 20-23
def _engine_rates(torch, np, engine, card, phase, n_prefill, n_ctx):
    """Prefill tokens/s of a [slots, n_prefill] batch; decode ms a step,
    the median of the decode device calls (the last max_new - 1) of a
    generate from an n_ctx-token prompt, each timed on the host from a
    synchronize to a synchronize (a prefill's time, a token a step on
    recurrent archs, would drown the difference of two generate
    timings); and one more decode step, at kv n_ctx + max_new, traced:
    host ms against the device's busy ms."""
    cfg, b = engine.cfg, engine.batch_size
    rng = np.random.default_rng(phase)
    prompt = rng.integers(1, cfg.vocab_size, (b, n_prefill))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.prefill(prompt)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    short = prompt[:, :n_ctx]
    orig, calls = engine._chunk, []

    def timed(*a):
        torch.cuda.synchronize()
        t = time.perf_counter()
        lg = orig(*a)
        torch.cuda.synchronize()
        calls.append(time.perf_counter() - t)
        return lg
    engine._chunk = timed
    try:
        gen = engine.generate(short)
    finally:
        engine._chunk = orig
    steps = engine.scfg.max_new_tokens - 1
    decode = sorted(calls[-steps:])
    decode_ms = 1e3 * decode[steps // 2]
    at = n_ctx + steps
    tr = _trace_chunk_call(torch, engine, lambda: engine._chunk_call(
        gen[:, -1].cpu().numpy(), np.full(b, at, np.int32),
        np.arange(b, dtype=np.int32), np.full(b, at + 1, np.int32)), 1)
    bd = tr["bd"]
    out = dict(prefill_tokens_per_s=b * n_prefill / t_prefill,
               prefill_shape=f"{b} x {n_prefill}",
               decode_ms=decode_ms, decode_kv=n_ctx,
               traced_decode_kv=at + 1, traced_decode_host_ms=tr["host_ms"],
               traced_decode_busy_ms=bd["busy_ms"],
               traced_decode_idle=1 - bd["busy_ms"] / tr["host_ms"],
               traced_decode_families={k: v for k, v in
                                       bd["families"].items() if v})
    log(f"phase {phase}: prefill {b} x {n_prefill} tokens in "
        f"{t_prefill:.3f} s = {out['prefill_tokens_per_s']:.0f} tokens/s "
        f"({'fused chunks' if engine.fused_ok else 'a token a step'}); "
        f"decode {decode_ms:.2f} ms per step at batch {b}, kv ~{n_ctx} "
        f"(median of {steps} steps, {1e3 * decode[0]:.2f}-"
        f"{1e3 * decode[-1]:.2f}); one decode step at kv {at + 1} traced: "
        f"host {tr['host_ms']:.3f} ms, device busy {bd['busy_ms']:.3f} ms (idle "
        f"{out['traced_decode_idle']:.4f}), {bd['kernels']} device events, "
        f"ms by family {out['traced_decode_families']} [{card}]")
    return out


def _check_captured_ragged(torch, ops, captured, phase):
    """The kernel against its plain version on each captured input."""
    worst = 0.0
    for key in sorted(captured):
        inputs = captured[key]
        out = ops.ragged_decode_attention(**inputs)
        ref = ops.ragged_decode_reference(**inputs)
        torch.cuda.synchronize()
        err, ok = _max_err(torch, out, ref, out.dtype)
        log(f"  captured {key}: q {tuple(inputs['q'].shape)}, cache "
            f"{tuple(inputs['k_cache'].shape)}, window {inputs['window']}, "
            f"positions up to {int(inputs['q_pos'].max())}, max |err| "
            f"{err:.3e}")
        if not ok:
            raise SystemExit(f"phase {phase}: kernel disagrees on captured "
                             f"{key}")
        worst = max(worst, err)
    return worst


NEMOTRON_LAYERS = 4            # of 96: 46.4 GB of bf16 weights on one card
NEMOTRON_PROMPTS = (1500, 1901)


def serve_nemotron(torch, np, ops, launch, card):
    """Phase 20: nemotron-4-340b at every width (d_model 18432, 96 q over
    8 kv heads of 192, relu² MLP of 73728, vocab 256000), depth cut to 4 of
    96 layers, bf16 from seed 0, through ``launch/serve.py``'s engine: 4
    slots x 2048, 4 prompts of 1500-1900 tokens in 512-token chunks, 16
    new tokens each.  Launches = layers x device calls; the kernel on
    layer 0's captured first prefill chunk and first decode step against
    its plain version; prefill tokens/s, decode ms a step, peak memory;
    then the kernel timed at this shape (row 3c)."""
    t_phase = time.perf_counter()
    args = launch.parse_args([
        "--arch", "nemotron-4-340b", "--no-reduced", "--device", "cuda",
        "--slots", "4", "--max-seq", "2048", "--chunk-tokens", "512",
        "--max-new", "16", "--seed", "0"])
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config("nemotron-4-340b"),
                              n_layers=NEMOTRON_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = launch.build_engine(args, cfg)
    torch.cuda.synchronize()
    cfg = engine.cfg
    n_params = sum(p.numel() for p in engine.model.parameters())
    log(f"phase 20: built {cfg.arch_id} ({n_params / 1e9:.3f} B params, "
        f"{cfg.n_layers} of 96 layers, d_model {cfg.d_model}, heads "
        f"{cfg.n_heads}/{cfg.n_kv_heads}, head_dim {cfg.head_dim}, d_ff "
        f"{cfg.d_ff} ({cfg.activation}, gated {cfg.gated_mlp}), vocab "
        f"{cfg.vocab_size}, {engine.model.embed.dtype}; cache 4 x "
        f"{engine.scfg.max_seq}) in {time.perf_counter() - t0:.1f} s")
    captured = {}

    def capture(layer, inputs):
        blk_q = inputs["q"].shape[0] // inputs["block_req"].shape[0]
        key = ("prefill" if blk_q > 1 else "decode", layer)
        if layer == 0 and key not in captured:
            captured[key] = {k: v.clone() if torch.is_tensor(v) else v
                             for k, v in inputs.items()}

    rng = np.random.default_rng(20)
    lens = rng.integers(*NEMOTRON_PROMPTS, 4)
    prompts = [rng.integers(1, cfg.vocab_size, int(n)) for n in lens]
    engine.model.attn_hook = capture
    try:
        ops.reset_launches()
        engine.n_chunk_calls = 0
        t0 = time.perf_counter()
        res = engine.serve(prompts, max_new_tokens=16)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ops.launches["ragged_decode"]
        calls = engine.n_chunk_calls
    finally:
        engine.model.attn_hook = None
    toks = [res.get(i, np.zeros(0, np.int32)) for i in range(len(prompts))]
    if any(len(t) != 16 or not ((t >= 0) & (t < cfg.vocab_size)).all()
           for t in toks):
        raise SystemExit(f"phase 20: generated {toks}")
    if launches != cfg.n_layers * calls or calls == 0:
        raise SystemExit(f"phase 20: {launches} kernel launches for {calls} "
                         f"device calls of {cfg.n_layers} layers")
    log(f"phase 20: served {len(prompts)} requests (prompts "
        f"{sorted(int(n) for n in lens)}, {int(lens.sum())} prompt tokens, "
        f"16 new each) in {wall:.2f} s; {calls} device calls, ragged_decode "
        f"launches {launches} = {cfg.n_layers} x {calls}")
    if sorted(captured) != [("decode", 0), ("prefill", 0)]:
        raise SystemExit(f"phase 20: captured {sorted(captured)}")
    err = _check_captured_ragged(torch, ops, captured, 20)
    del captured
    rates = _engine_rates(torch, np, engine, card, 20, 1900, 1884)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    times = kernel_times(torch, ops, card, "nemotron-4-340b", phase=20)
    seconds = time.perf_counter() - t_phase
    log(f"phase 20: peak memory {peak:.2f} GiB; {seconds:.1f} s in all "
        f"[{card}]")
    return dict(launches=launches, calls=calls, params=n_params,
                captured_max_abs_err=err, serve_s=wall, peak_gib=peak,
                seconds=seconds, times=times, **rates)


# the f32 check of phases 21-22: per-token serve logits against
# Transformer.forward's on the same 2 x 512 tokens, as max |logit diff| /
# std(logits) (PREFILL_REL_BOUND's measure).  The two sum in other orders
# (one token a step against chunked scans and blockwise attention), each
# f32 rounding ~6e-8 relative.  Most positions' logit vectors differ by
# ~6e-6 relative (mamba2's 2 layers on the CPU, seed 121's prompt); the
# worst positions' by ~8e-5, where the gated out norm divides a y that
# cancelled to a tenth of its usual size (errors scale with the summed
# terms, not with y); and the max over 2 x 512 x 50k logits is ~5 of the
# worst vector's rms: 4.2e-4 there, 2.4e-4 / 1.4e-4 on the H100.  The
# bound sits between the largest of those readings and the nearest
# control that must land outside it (SERVE_FWD_CONTROLS): the serve path
# with TF32 matmuls (10-bit mantissas), 2.0e-2 / 3.5e-3 on the H100, and
# every slot's state reset before every token.  A third control, the
# recurrent state stored in bf16, is recorded, not required: an rglru
# state decays and is gated, and recurrentgemma's landed at 7.9e-4 on
# the CPU (3 layers at full width, the vocabulary cut to 32000, 256
# tokens) and 1.7e-3 on the H100 (mamba2's 2.3e-2).
SERVE_FWD_REL_BOUND = 1e-3
SERVE_FWD_CONTROLS = ("TF32 matmuls", "state reset every token")
SERVE_FWD_TOKENS = 512


def _serve_vs_forward(torch, np, cfg, phase):
    """An f32 copy of ``cfg`` on the card: per-token serve logits (the
    engine's prefill) and the controls' against the training forward's.
    Returns (gap, {control: gap})."""
    from repro_torch.models.model import Transformer
    from repro_torch.parallel import ParallelContext
    from repro_torch.serve import Engine, ServeConfig
    cfg = dataclasses.replace(cfg, param_dtype="float32",
                              compute_dtype="float32")
    model = Transformer(cfg, device=DEVICE, seed=0)
    engine = Engine(model, ServeConfig(max_seq=SERVE_FWD_TOKENS),
                    batch_size=2, device=DEVICE)
    rng = np.random.default_rng(100 + phase)
    prompt = rng.integers(1, cfg.vocab_size, (2, SERVE_FWD_TOKENS))
    _, served = engine.prefill(prompt, return_logits=True)
    controls = {}
    # every slot's recurrent state zeroed before each token
    block_req = np.arange(2, dtype=np.int32)
    reset = []
    for t in range(SERVE_FWD_TOKENS):
        engine._reset(np.ones(2, bool))
        reset.append(engine._chunk_call(
            prompt[:, t], np.full(2, t, np.int32), block_req,
            np.full(2, t + 1, np.int32)))
    controls["state reset every token"] = torch.stack(reset, 1)
    del reset
    # the serve path's matmuls in TF32
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        controls["TF32 matmuls"] = engine.prefill(prompt,
                                                  return_logits=True)[1]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    # the recurrent state (ssd ``state``, rglru ``h``) stored in bf16
    for slot in engine.cache["slots"]:
        for name in ("state", "h"):
            if name in slot:
                slot[name] = slot[name].to(torch.bfloat16)
    controls["bf16 recurrent state"] = engine.prefill(
        prompt, return_logits=True)[1]
    dev = model.device
    batch = {"tokens": torch.tensor(prompt, dtype=torch.int32, device=dev),
             "segment_ids": torch.ones(prompt.shape, dtype=torch.int32,
                                       device=dev),
             "positions": torch.arange(SERVE_FWD_TOKENS, dtype=torch.int32,
                                       device=dev).expand(2, -1)
             .contiguous()}
    with torch.no_grad():
        logits, _ = model(batch, ParallelContext(attn_impl="xla",
                                                 remat=False))
    scale = float(logits.std())
    gap = float((served - logits).abs().max()) / scale
    ctrl = {k: float((c - logits).abs().max()) / scale
            for k, c in controls.items()}
    del model, engine, served, controls, logits
    gc.collect()
    torch.cuda.empty_cache()
    return gap, ctrl


SOLO = 2          # prompts of phases 21-22 served alone again
RECURRENT_SERVE = {
    # phase: (arch, prompt lengths, new tokens, max_seq, the f32 check's
    #         layer pattern and depth).  The prompts were twice as long
    #         until phases 27-28 came: on a slow host the whole run then
    #         took 1222 s, past its 1200 s limit, and these a-token-a-step
    #         phases (21, 22, 26) took 607 s of it
    21: ("mamba2-370m", (100, 301), 32, 640, ("ssd",), 2),
    22: ("recurrentgemma-9b", (50, 201), 16, 512,
         ("rglru", "rglru", "local"), 3),
}


def serve_recurrent(torch, np, ops, launch, card, phase):
    """Phases 21-22: mamba2-370m / recurrentgemma-9b at full width and
    depth, bf16 from seed 0, through ``launch/serve.py``'s engine: 4
    slots, 4 prompts prefilled a token a step (decode-mode chunks), greedy.
    Launches: the ragged kernel once a local layer a device call (none in
    mamba2; its SSD layers decode in torch ops, as the reference's
    ``ssd_decode``); recurrentgemma's kernel on a captured decode step of
    its first local layer against its plain version.  Concurrent serving
    equals solo serving token for token at the same slot count for the
    SOLO shortest prompts (the device shapes are the same: every step is
    one row a slot).  Rates,
    one decode step traced, peak memory; then the f32 serve-vs-forward
    check at a cut depth with its control."""
    from repro_torch.configs import get_config
    arch, plens, new, max_seq, pattern, depth = RECURRENT_SERVE[phase]
    t_phase = time.perf_counter()
    args = launch.parse_args([
        "--arch", arch, "--no-reduced", "--device", "cuda", "--slots", "4",
        "--max-seq", str(max_seq), "--max-new", str(new), "--seed", "0"])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = launch.build_engine(args)
    torch.cuda.synchronize()
    cfg = engine.cfg
    n_params = sum(p.numel() for p in engine.model.parameters())
    kinds = [cfg.layer_pattern[i % cfg.period] for i in range(cfg.n_layers)]
    local = [i for i, k in enumerate(kinds) if k in ("local", "global")]
    log(f"phase {phase}: built {cfg.arch_id} ({n_params / 1e9:.3f} B "
        f"params, {cfg.n_layers} layers: {kinds.count('ssd')} ssd, "
        f"{kinds.count('rglru')} rglru, {len(local)} local; d_model "
        f"{cfg.d_model}, {engine.model.embed.dtype}; cache 4 x {max_seq}) in "
        f"{time.perf_counter() - t0:.1f} s; fused prefill "
        f"{engine.fused_ok}")
    captured = {}

    def capture(layer, inputs):
        if local and layer == local[0] and not captured \
                and int((inputs["q_pos"] >= 0).sum()) == 4 \
                and int(inputs["q_pos"].min()) >= 40:
            captured[("decode", layer)] = {
                k: v.clone() if torch.is_tensor(v) else v
                for k, v in inputs.items()}

    rng = np.random.default_rng(phase)
    lens = rng.integers(*plens, 4)
    prompts = [rng.integers(1, cfg.vocab_size, int(n)) for n in lens]
    engine.model.attn_hook = capture
    try:
        ops.reset_launches()
        engine.n_chunk_calls = 0
        t0 = time.perf_counter()
        together = engine.serve(prompts, max_new_tokens=new)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(ops.launches)
        calls = engine.n_chunk_calls
    finally:
        engine.model.attn_hook = None
    toks = [together.get(i, np.zeros(0, np.int32))
            for i in range(len(prompts))]
    if any(len(t) != new or not ((t >= 0) & (t < cfg.vocab_size)).all()
           for t in toks):
        raise SystemExit(f"phase {phase}: generated {toks}")
    others = {k: n for k, n in launches.items()
              if n and k != "ragged_decode"}
    if launches["ragged_decode"] != len(local) * calls or calls == 0 \
            or others:
        raise SystemExit(f"phase {phase}: launches {launches} for {calls} "
                         f"device calls of {len(local)} local layers")
    log(f"phase {phase}: served {len(prompts)} requests (prompts "
        f"{sorted(int(n) for n in lens)}, {int(lens.sum())} prompt tokens "
        f"a token a step, {new} new each) in {wall:.2f} s; {calls} device "
        f"calls, ragged_decode launches {launches['ragged_decode']} = "
        f"{len(local)} x {calls}")
    # the two shortest prompts alone: each spent prefill steps of the
    # others idle in the concurrent run (a step took 46-88 ms of host time
    # at these depths on the H100 host, so all four would double the
    # phase)
    t0 = time.perf_counter()
    alone = sorted(range(len(prompts)), key=lambda i: lens[i])[:SOLO]
    solo = {i: engine.serve([prompts[i]], max_new_tokens=new)[0]
            for i in alone}
    t_solo = time.perf_counter() - t0
    same = {i: bool(np.array_equal(solo[i], toks[i])) for i in alone}
    log(f"phase {phase}: prompts {[int(lens[i]) for i in alone]} each "
        f"served alone through the 4 slots ({t_solo:.1f} s): tokens equal "
        f"to the concurrent run's: {same}")
    if not all(same.values()):
        raise SystemExit(f"phase {phase}: concurrent != solo: {toks} vs "
                         f"{solo}")
    err = None
    if local:
        if sorted(captured) != [("decode", local[0])]:
            raise SystemExit(f"phase {phase}: captured {sorted(captured)}")
        err = _check_captured_ragged(torch, ops, captured, phase)
    del captured
    # the rates at the middle of the phase's prompt lengths
    n_prefill = (plens[0] + plens[1] - 1) // 2
    rates = _engine_rates(torch, np, engine, card, phase, n_prefill,
                          n_prefill - 16)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    times = kernel_times(torch, ops, card, f"{arch} local", phase=phase) \
        if local else None
    small = dataclasses.replace(get_config(arch), layer_pattern=pattern,
                                n_layers=depth)
    gap, ctrl = _serve_vs_forward(torch, np, small, phase)
    seconds = time.perf_counter() - t_phase
    log(f"phase {phase}: f32 copy at {depth} layers {pattern}: per-token "
        f"serve logits against Transformer.forward's on 2 x "
        f"{SERVE_FWD_TOKENS} tokens: max |diff| / std {gap:.3e} (bound "
        f"{SERVE_FWD_REL_BOUND}); controls "
        + ", ".join(f"'{k}' {v:.3e}" for k, v in ctrl.items())
        + f"; peak memory {peak:.2f} GiB; {seconds:.1f} s in all [{card}]")
    if not gap <= SERVE_FWD_REL_BOUND < min(ctrl[k]
                                            for k in SERVE_FWD_CONTROLS):
        raise SystemExit(f"phase {phase}: serve vs forward gap {gap} / "
                         f"controls {ctrl} against {SERVE_FWD_REL_BOUND}")
    return dict(params=n_params, launches=launches["ragged_decode"],
                calls=calls, serve_s=wall, solo_equal=same,
                captured_max_abs_err=err, peak_gib=peak, times=times,
                serve_vs_forward=dict(gap=gap, controls=ctrl,
                                      bound=SERVE_FWD_REL_BOUND,
                                      layers=list(pattern)),
                seconds=seconds, **rates)


LLAMA34_LAYERS = 2             # of 48: ~42 GB of bf16 weights and f32
LLAMA34_STEPS = 3              # AdamW moments on one card
# 4 x 4096 tokens peaked at 74.11 GiB in step 0 and ran out of the card's
# memory in step 1's backward (the f32 logits over 128256 words are 8.4 GB
# a copy); 2 x 4096 rows cannot be split over 4 servers (a rank holds
# whole rows), so the cut keeps 4 rows: 4 x 2048, the same 8192 tokens
LLAMA34_SEQ = 2048


def train_llama34_cad(torch, ops, card):
    """Phase 23: the paper's llama3-34b at every width (d_model 8192, 64 q
    over 16 kv heads of 128, d_ff 22016, vocab 128256), depth cut to 2 of
    48, CAD on 4 simulated servers, 4 x LLAMA34_SEQ ``prolong`` tokens,
    ``balanced``, 3 steps.  Launches each step = servers x layers x {2
    forwards with remat, 1 dq, 1 dk/dv}; finite losses; the step-0 loss
    bitwise equal under ``identity`` and ``balanced``; the kernels on
    layer 0's captured server batches against their plain versions."""
    from repro_torch.cad import CADSession
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import PipelineConfig
    from repro_torch.models.model import Transformer
    from repro_torch.train.trainer import TrainConfig, train
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config("llama3-34b"),
                              n_layers=LLAMA34_LAYERS)
    pipe = PipelineConfig(distribution="prolong", max_doc_len=LLAMA34_SEQ,
                          seq_len=LLAMA34_SEQ, global_batch=4, n_ranks=4,
                          vocab_size=cfg.vocab_size, seed=0)
    tc = TrainConfig(steps=LLAMA34_STEPS, peak_lr=3e-4, warmup=1,
                     log_every=1, seed=0)

    def session(policy):
        return CADSession.for_pipeline(cfg, pipe, plan_policy=policy,
                                       prefetch=2)
    n_servers = pipe.n_ranks
    tokens = pipe.global_batch * pipe.seq_len
    res = train(cfg, pipe, dataclasses.replace(tc, steps=1),
                session=session("identity"), device=DEVICE)
    loss_identity = res["history"][0]["loss"]
    del res
    gc.collect()
    torch.cuda.empty_cache()
    model = Transformer(cfg, device=DEVICE, seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    captured = {}

    def capture(layer, inputs):
        if layer == 0 and layer not in captured:
            captured[layer] = {k: v.detach().clone() if torch.is_tensor(v)
                               else v for k, v in inputs.items()}

    expect = {"ca_server_fwd": n_servers * cfg.n_layers * 2,   # + remat
              "ca_server_bwd_dq": n_servers * cfg.n_layers,
              "ca_server_bwd_dkv": n_servers * cfg.n_layers}
    steps = []

    def on_step(step, m):
        counts = {k: ops.launches[k] for k in expect}
        others = sum(n for k, n in ops.launches.items() if k not in expect)
        mem = torch.cuda.max_memory_allocated() / 2 ** 30
        ops.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        model.attn_hook = None              # capture step 0 only
        steps.append(dict(m, counts=counts, others=others, peak_gib=mem))
        log(f"phase 23: step {step} loss {m['loss']:.6f} gnorm "
            f"{m['grad_norm']:.4f} step {1e3 * m['step_s']:.1f} ms "
            f"{tokens / m['step_s']:.0f} tokens/s peak {mem:.2f} GiB "
            f"launches {counts} [{card}]")

    log(f"phase 23: llama3-34b at every width, {cfg.n_layers} of 48 layers "
        f"({n_params / 1e9:.3f} B params, bf16, f32 AdamW moments), CAD on "
        f"{n_servers} simulated servers, {pipe.global_batch} x "
        f"{pipe.seq_len} tokens ({pipe.distribution}); step-0 identity "
        f"loss {loss_identity!r}")
    model.attn_hook = capture
    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    train(cfg, pipe, tc, model=model, session=session("balanced"),
          device=DEVICE, on_step=on_step)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    for st in steps:
        if st["counts"] != expect or st["others"]:
            raise SystemExit(f"phase 23: step {st['step']} launches "
                             f"{st['counts']} (+{st['others']} of other "
                             f"kernels) != {expect}")
        if not math.isfinite(st["loss"]):
            raise SystemExit(f"phase 23: step {st['step']} loss "
                             f"{st['loss']}")
    if steps[0]["loss"] != loss_identity:
        raise SystemExit(f"phase 23: step-0 loss {steps[0]['loss']!r} under "
                         f"balanced != {loss_identity!r} under identity")
    if sorted(captured) != [0]:
        raise SystemExit(f"phase 23: captured layers {sorted(captured)}")
    batches = captured_batches(torch, captured)
    err = check_captured(torch, ops, captured, batches, phase=23)
    del batches, captured
    gc.collect()
    torch.cuda.empty_cache()
    ops.reset_launches()
    seconds = time.perf_counter() - t_phase
    log(f"phase 23: launches per step = {expect} (servers x layers x {{2 "
        f"forwards with remat, 1 backward}}); step-0 loss bitwise equal "
        f"under identity and balanced; {seconds:.1f} s in all")
    return dict(launches=steps[0]["counts"], params=n_params,
                loss=[st["loss"] for st in steps],
                step_s=[st["step_s"] for st in steps],
                tokens_per_s=[tokens / st["step_s"] for st in steps],
                peak_gib=[st["peak_gib"] for st in steps],
                captured_max_abs_err=err, seconds=seconds,
                shape=f"{pipe.global_batch} x {pipe.seq_len} tokens, "
                      f"{n_servers} servers, {cfg.n_layers} of 48 layers")


# ------------------------------------------------------- phases 25-26
MOE_ARCH = "qwen2-moe-a2.7b"
MOE_LAYERS = 4            # of 24: ~2.9 B params, their f32 AdamW moments
MOE_STEPS = 2             # and f32 logits over 151936 words on one card
# 4 x 4096 tokens peaked at 74.30 GiB in step 0 and ran out of the card's
# memory in step 1's backward (9.27 GiB asked for, 4.22 free, 9.19
# reserved and unallocated); as phase 23, the cut keeps 4 rows: 4 x 2048
MOE_SEQ = 2048


def _moe_setup():
    from repro_torch.cad import CADSession
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import PipelineConfig
    from repro_torch.train.trainer import TrainConfig
    cfg = dataclasses.replace(get_config(MOE_ARCH), n_layers=MOE_LAYERS)
    pipe = PipelineConfig(distribution="prolong", max_doc_len=MOE_SEQ,
                          seq_len=MOE_SEQ, global_batch=4, n_ranks=4,
                          vocab_size=cfg.vocab_size, seed=0)
    tc = TrainConfig(steps=MOE_STEPS, peak_lr=3e-4, warmup=1, log_every=1,
                     seed=0)

    def session(policy):
        return CADSession.for_pipeline(cfg, pipe, plan_policy=policy,
                                       prefetch=2)
    return cfg, pipe, tc, session


def _moe_step_twice(torch, cfg, pipe, session):
    """One CAD forward and backward (lm loss + aux) of a fresh seed-0
    model on the first batch and its ``balanced`` plan, run twice: the
    loss, the aux losses and every gradient must repeat bit for bit (an
    atomic add in the MoE dispatch or combine would break it).  Returns
    (bitwise, the first run's aux losses)."""
    from repro_torch.data.pipeline import raw_batches
    from repro_torch.models.model import Transformer
    from repro_torch.train.loss import lm_loss
    from repro_torch.train.step import batch_to_device
    model = Transformer(cfg, device=DEVICE, seed=0)
    sess = session("balanced")
    gen = sess.attach_plans(raw_batches(pipe))
    batch = next(gen)
    gen.close()
    b = batch_to_device(batch, DEVICE)
    ctx = sess.context()
    ctx = ctx.cad.bind_plan(ctx, b["plan"])
    params = list(model.parameters())
    first, same = None, True
    for _ in range(2):
        logits, aux = model(b, ctx)
        loss, _ = lm_loss(logits, b["labels"], b["segment_ids"])
        del logits
        total = loss + aux["moe_lb"] + aux["moe_z"]
        grads = torch.autograd.grad(total, params)
        got = [total.detach(), aux["moe_lb"].detach(),
               aux["moe_z"].detach(), *grads]
        del grads
        if first is None:
            first = got
        else:
            same = all(torch.equal(a, c) for a, c in zip(first, got))
        del got
    out = {k: float(v) for k, v in zip(("total", "moe_lb", "moe_z"),
                                       first)}
    del first, model, b, batch
    gc.collect()
    torch.cuda.empty_cache()
    return same, out


def train_moe(torch, ops, card):
    """Phase 25: qwen2-moe-a2.7b at every width (d_model 2048, 16 q over
    16 kv heads of 128: MHA, rep 1; 60 routed experts top-4 of 1408 and 4
    shared; vocab 151936), depth cut to MOE_LAYERS of 24, bf16, 4 x
    MOE_SEQ ``prolong`` tokens.  CAD on 4 simulated servers: the step-0
    loss under ``identity``, the same step run twice bitwise, MOE_STEPS
    steps under ``balanced`` (launches servers x layers x {2, 1, 1},
    finite losses and aux losses, the step-0 loss bitwise the identity
    one), the CA kernels on layer 0's captured server batches, CA timed
    beside flash on that layer; then colocated (``pallas``) on the same
    weights and batches: launches layers x {2, 1, 1} and 3 prunes a
    layer, the step-0 loss bitwise CAD's with phase 7's controls outside
    CO_LOSS_LIMIT, the flash kernels on captured q/k/v."""
    from repro_torch.models.model import Transformer
    from repro_torch.parallel import ParallelContext
    from repro_torch.train.trainer import train
    t_phase = time.perf_counter()
    cfg, pipe, tc, session = _moe_setup()
    n_servers = pipe.n_ranks
    tokens = pipe.global_batch * pipe.seq_len
    res = train(cfg, pipe, dataclasses.replace(tc, steps=1),
                session=session("identity"), device=DEVICE)
    loss_identity = res["history"][0]["loss"]
    del res
    gc.collect()
    torch.cuda.empty_cache()
    repeat, aux0 = _moe_step_twice(torch, cfg, pipe, session)
    log(f"phase 25: one CAD forward and backward of step 0 run twice: loss,"
        f" aux losses and every gradient bitwise {repeat} (total "
        f"{aux0['total']!r}, moe_lb {aux0['moe_lb']!r}, moe_z "
        f"{aux0['moe_z']!r})")

    def run(ctx, sess, expect, tag):
        model = Transformer(cfg, device=DEVICE, seed=0)
        n_params = sum(p.numel() for p in model.parameters())
        captured, steps = {}, []

        def capture(layer, inputs):
            if layer == 0 and layer not in captured:
                captured[layer] = {k: v.detach().clone()
                                   if torch.is_tensor(v) else v
                                   for k, v in inputs.items()}

        def on_step(step, m):
            counts = {k: ops.launches[k] for k in expect}
            others = sum(n for k, n in ops.launches.items()
                         if k not in expect)
            mem = torch.cuda.max_memory_allocated() / 2 ** 30
            ops.reset_launches()
            torch.cuda.reset_peak_memory_stats()
            model.attn_hook = None          # capture step 0 only
            steps.append(dict(m, counts=counts, others=others,
                              peak_gib=mem))
            log(f"phase 25: {tag} step {step} loss {m['loss']:.6f} moe_lb "
                f"{m['moe_lb']:.6e} moe_z {m['moe_z']:.6e} gnorm "
                f"{m['grad_norm']:.4f} step {1e3 * m['step_s']:.1f} ms "
                f"{tokens / m['step_s']:.0f} tokens/s peak {mem:.2f} GiB "
                f"launches {counts} [{card}]")
        model.attn_hook = capture
        ops.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        train(cfg, pipe, tc, model=model, ctx=ctx, session=sess,
              device=DEVICE, on_step=on_step)
        del model
        gc.collect()
        torch.cuda.empty_cache()
        for st in steps:
            if st["counts"] != expect or st["others"]:
                raise SystemExit(f"phase 25: {tag} step {st['step']} "
                                 f"launches {st['counts']} (+{st['others']} "
                                 f"of other kernels) != {expect}")
            if not all(math.isfinite(st[k]) for k in ("loss", "moe_lb",
                                                      "moe_z")):
                raise SystemExit(f"phase 25: {tag} step {st['step']}: "
                                 f"{st}")
        if sorted(captured) != [0]:
            raise SystemExit(f"phase 25: {tag} captured {sorted(captured)}")
        return steps, captured, n_params

    log(f"phase 25: {MOE_ARCH} at every width, {cfg.n_layers} of 24 layers"
        f" (d_model {cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads} of "
        f"{cfg.head_dim}, {cfg.moe.n_experts} experts top-"
        f"{cfg.moe.top_k} of {cfg.moe.d_ff_expert} + "
        f"{cfg.moe.n_shared_experts} shared, capacity factor "
        f"{cfg.moe.capacity_factor}, vocab {cfg.vocab_size}; bf16), CAD on "
        f"{n_servers} simulated servers, {pipe.global_batch} x "
        f"{pipe.seq_len} tokens ({pipe.distribution}); step-0 identity loss "
        f"{loss_identity!r}")
    cad_expect = {"ca_server_fwd": n_servers * cfg.n_layers * 2,  # + remat
                  "ca_server_bwd_dq": n_servers * cfg.n_layers,
                  "ca_server_bwd_dkv": n_servers * cfg.n_layers}
    steps, captured, n_params = run(None, session("balanced"), cad_expect,
                                    "CAD")
    if steps[0]["loss"] != loss_identity:
        raise SystemExit(f"phase 25: step-0 loss {steps[0]['loss']!r} under "
                         f"balanced != {loss_identity!r} under identity")
    if not repeat:
        raise SystemExit("phase 25: the same CAD step run twice gave other "
                         "bits")
    batches = captured_batches(torch, captured)
    ca_err = check_captured(torch, ops, captured, batches, phase=25)
    tot, f_bound, b_bound = ca_kernel_times(torch, ops, batches[0],
                                            captured[0], card, phase=25)
    del batches, captured
    gc.collect()
    torch.cuda.empty_cache()
    co_expect = {"flash_fwd": cfg.n_layers * 2,            # + remat
                 "flash_bwd_dq": cfg.n_layers,
                 "flash_bwd_dkv": cfg.n_layers,
                 "flash_tile_ranges": cfg.n_layers * 3}
    co_steps, co_captured, _ = run(
        ParallelContext(attn_impl="pallas", remat=True), None, co_expect,
        "colocated")
    co, cad = co_steps[0]["loss"], steps[0]["loss"]
    gap = abs(co - cad)
    controls = colocated_controls(torch, ops, cad, setup=_moe_setup)
    c_diff = {k: abs(v - cad) for k, v in controls.items()}
    log(f"phase 25: colocated step-0 loss {co!r} vs CAD's {cad!r}: |diff| "
        f"{gap:.3e} (bitwise equal {co == cad}; controls "
        + ", ".join(f"'{k}' {v:.3e}" for k, v in c_diff.items())
        + f" against CO_LOSS_LIMIT {CO_LOSS_LIMIT:.2e})")
    if co != cad or not all(c_diff[k] > CO_LOSS_LIMIT
                            for k in CO_REQUIRED_CONTROLS):
        raise SystemExit("phase 25: the colocated step-0 loss is not bitwise "
                         "equal to CAD's, or a required control is within "
                         "the limit")
    fl_err = check_captured_flash(torch, ops, co_captured, phase=25)
    del co_captured
    gc.collect()
    torch.cuda.empty_cache()
    ops.reset_launches()
    seconds = time.perf_counter() - t_phase
    log(f"phase 25: launches per step: CAD {cad_expect}, colocated "
        f"{co_expect}; {seconds:.1f} s in all [{card}]")

    def rec(st):
        return {k: [s[k] for s in st] for k in
                ("loss", "moe_lb", "moe_z", "step_s", "peak_gib")} | {
            "tokens_per_s": [tokens / s["step_s"] for s in st]}
    return dict(params=n_params, ca_launches=steps[0]["counts"],
                flash_launches=co_steps[0]["counts"], times=tot,
                bounds=(f_bound, b_bound), ca_captured_max_abs_err=ca_err,
                flash_captured_max_abs_err=fl_err, cad=rec(steps),
                colocated=rec(co_steps), step0_repeat_bitwise=repeat,
                colocated_vs_cad=dict(gap=gap, controls=controls,
                                      control_diffs=c_diff,
                                      limit=CO_LOSS_LIMIT),
                seconds=seconds,
                shape=f"{pipe.global_batch} x {pipe.seq_len} tokens, "
                      f"{n_servers} servers, {cfg.n_layers} of 24 layers")


# phase 26: (arch, depth, prompt lengths, new tokens, max_seq); qwen2-moe
# at 12 of 24 layers since phase 31 grew (its 24 took 91 s of the script's
# 1200 s limit, a token a step through the host-bound loop)
MOE_SERVE = {"qwen2-moe-a2.7b": (12, (100, 301), 16, 640),
             # 1 of 48 layers: 18.4 B params, 36.8 GB of bf16 weights (one
             # layer's 128 experts are 32 GB); two would not leave room
             "llama4-maverick-400b-a17b": (1, (64, 161), 16, 192)}
MOE_FWD_LAYERS = 2        # the f32 serve-vs-forward copy's depth
MOE_FWD_CONTROLS = ("TF32 matmuls",)


def _moe_serve_vs_forward(torch, np, cfg):
    """An f32 copy of ``cfg`` at MOE_FWD_LAYERS layers on the card: the
    per-token serve logits (no drops) and the TF32 control's against
    ``Transformer.forward``'s on 2 x SERVE_FWD_TOKENS tokens.  The forward
    drops nothing only with ``capacity_factor >= E / top_k`` (cap >= the
    token count): the copy takes twice that, a choice of test data; how
    many (token, choice) pairs the config's own factor would have dropped
    is counted on the forward's MoE inputs.  Returns (gap, {control:
    gap}, dropped at the config's factor)."""
    from repro_torch.models import layers as L
    from repro_torch.models.model import Transformer
    from repro_torch.parallel import ParallelContext
    from repro_torch.serve import Engine, ServeConfig
    e = cfg.moe
    cfg = dataclasses.replace(
        cfg, n_layers=MOE_FWD_LAYERS, param_dtype="float32",
        compute_dtype="float32",
        moe=dataclasses.replace(e, capacity_factor=2.0 * e.n_experts
                                / e.top_k))
    model = Transformer(cfg, device=DEVICE, seed=0)
    engine = Engine(model, ServeConfig(max_seq=SERVE_FWD_TOKENS),
                    batch_size=2, device=DEVICE)
    rng = np.random.default_rng(126)
    prompt = rng.integers(1, cfg.vocab_size, (2, SERVE_FWD_TOKENS))
    _, served = engine.prefill(prompt, return_logits=True)
    controls = {}
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        controls["TF32 matmuls"] = engine.prefill(prompt,
                                                  return_logits=True)[1]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    dev = model.device
    batch = {"tokens": torch.tensor(prompt, dtype=torch.int32, device=dev),
             "segment_ids": torch.ones(prompt.shape, dtype=torch.int32,
                                       device=dev),
             "positions": torch.arange(SERVE_FWD_TOKENS, dtype=torch.int32,
                                       device=dev).expand(2, -1)
             .contiguous()}
    dropped, moe_apply = [], L.moe_apply

    def count(p, h, c, **kw):
        # the config's own capacity on these inputs
        n_tok = h.shape[0] * h.shape[1]
        idx = L._top_k(torch.softmax((h.reshape(n_tok, -1) @ p["router"])
                                     .float(), -1), e.top_k)[1]
        cap = max(1, int(n_tok * e.top_k / e.n_experts * e.capacity_factor))
        n = torch.bincount(idx.reshape(-1), minlength=e.n_experts)
        dropped.append(int((n - cap).clamp(min=0).sum()))
        return moe_apply(p, h, c, **kw)
    L.moe_apply = count
    try:
        with torch.no_grad():
            logits, _ = model(batch, ParallelContext(attn_impl="xla",
                                                     remat=False))
    finally:
        L.moe_apply = moe_apply
    scale = float(logits.std())
    gap = float((served - logits).abs().max()) / scale
    ctrl = {k: float((c - logits).abs().max()) / scale
            for k, c in controls.items()}
    del model, engine, served, controls, logits
    gc.collect()
    torch.cuda.empty_cache()
    return gap, ctrl, dropped


def serve_moe(torch, np, ops, launch, card, arch):
    """Phase 26: an MoE arch at every width through ``launch/serve.py``'s
    engine (``--no-reduced``), bf16 from seed 0, depth as MOE_SERVE says,
    4 slots, 4 prompts prefilled a token a step (decode-mode chunks, as
    the reference's engine gates MoE archs), greedy: ragged_decode
    launches = layers x device calls and no other kernel, the kernel on
    layer 0's captured decode step against its plain version, rates and
    one decode step traced, peak memory.  qwen2-moe also: the concurrent
    run's tokens equal to its SOLO shortest prompts' served alone, and
    the f32 serve-vs-forward check at MOE_FWD_LAYERS layers."""
    from repro_torch.configs import get_config
    depth, plens, new, max_seq = MOE_SERVE[arch]
    t_phase = time.perf_counter()
    args = launch.parse_args([
        "--arch", arch, "--no-reduced", "--device", "cuda", "--slots", "4",
        "--max-seq", str(max_seq), "--max-new", str(new), "--seed", "0"])
    full = get_config(arch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = launch.build_engine(args, dataclasses.replace(full,
                                                           n_layers=depth))
    torch.cuda.synchronize()
    cfg = engine.cfg
    n_params = sum(p.numel() for p in engine.model.parameters())
    log(f"phase 26: built {arch} ({n_params / 1e9:.3f} B params, "
        f"{cfg.n_layers} of {full.n_layers} layers, d_model {cfg.d_model}, "
        f"heads {cfg.n_heads}/{cfg.n_kv_heads} of {cfg.head_dim}, "
        f"{cfg.moe.n_experts} experts top-{cfg.moe.top_k} of "
        f"{cfg.moe.d_ff_expert} + {cfg.moe.n_shared_experts} shared, vocab "
        f"{cfg.vocab_size}, {engine.model.embed.dtype}; cache 4 x "
        f"{max_seq}) in {time.perf_counter() - t0:.1f} s; fused prefill "
        f"{engine.fused_ok}")
    captured = {}

    def capture(layer, inputs):
        if layer == 0 and not captured \
                and int((inputs["q_pos"] >= 0).sum()) == 4 \
                and int(inputs["q_pos"].min()) >= 60:
            captured[("decode", layer)] = {
                k: v.clone() if torch.is_tensor(v) else v
                for k, v in inputs.items()}

    rng = np.random.default_rng(26)
    lens = rng.integers(*plens, 4)
    prompts = [rng.integers(1, cfg.vocab_size, int(n)) for n in lens]
    engine.model.attn_hook = capture
    try:
        ops.reset_launches()
        engine.n_chunk_calls = 0
        t0 = time.perf_counter()
        together = engine.serve(prompts, max_new_tokens=new)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(ops.launches)
        calls = engine.n_chunk_calls
    finally:
        engine.model.attn_hook = None
    toks = [together.get(i, np.zeros(0, np.int32))
            for i in range(len(prompts))]
    if any(len(t) != new or not ((t >= 0) & (t < cfg.vocab_size)).all()
           for t in toks):
        raise SystemExit(f"phase 26: {arch} generated {toks}")
    others = {k: n for k, n in launches.items()
              if n and k != "ragged_decode"}
    if launches["ragged_decode"] != cfg.n_layers * calls or calls == 0 \
            or others:
        raise SystemExit(f"phase 26: {arch} launches {launches} for "
                         f"{calls} device calls of {cfg.n_layers} layers")
    log(f"phase 26: {arch} served {len(prompts)} requests (prompts "
        f"{sorted(int(n) for n in lens)}, {int(lens.sum())} prompt tokens "
        f"a token a step, {new} new each) in {wall:.2f} s; {calls} device "
        f"calls, ragged_decode launches {launches['ragged_decode']} = "
        f"{cfg.n_layers} x {calls}")
    same = None
    if arch == MOE_ARCH:
        t0 = time.perf_counter()
        alone = sorted(range(len(prompts)), key=lambda i: lens[i])[:SOLO]
        solo = {i: engine.serve([prompts[i]], max_new_tokens=new)[0]
                for i in alone}
        same = {i: bool(np.array_equal(solo[i], toks[i])) for i in alone}
        log(f"phase 26: prompts {[int(lens[i]) for i in alone]} each "
            f"served alone through the 4 slots "
            f"({time.perf_counter() - t0:.1f} s): tokens equal to the "
            f"concurrent run's: {same}")
        if not all(same.values()):
            raise SystemExit(f"phase 26: concurrent != solo: {toks} vs "
                             f"{solo}")
    if sorted(captured) != [("decode", 0)]:
        raise SystemExit(f"phase 26: captured {sorted(captured)}")
    err = _check_captured_ragged(torch, ops, captured, 26)
    del captured
    n_prefill = (plens[0] + plens[1] - 1) // 2
    rates = _engine_rates(torch, np, engine, card, 26, n_prefill,
                          n_prefill - 16)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    out = dict(params=n_params, layers=cfg.n_layers,
               launches=launches["ragged_decode"], calls=calls,
               serve_s=wall, solo_equal=same, captured_max_abs_err=err,
               peak_gib=peak, **rates)
    if arch == MOE_ARCH:
        gap, ctrl, dropped = _moe_serve_vs_forward(torch, np, full)
        log(f"phase 26: f32 copy at {MOE_FWD_LAYERS} layers: per-token "
            f"serve logits against Transformer.forward's (capacity factor "
            f"2 E / top_k, nothing dropped) on 2 x {SERVE_FWD_TOKENS} "
            f"tokens: max |diff| / std {gap:.3e} (bound "
            f"{SERVE_FWD_REL_BOUND}); controls "
            + ", ".join(f"'{k}' {v:.3e}" for k, v in ctrl.items())
            + f"; at the config's factor {full.moe.capacity_factor} the "
            f"forward's layers would have dropped {dropped} (token, choice) "
            f"pairs of {2 * SERVE_FWD_TOKENS * full.moe.top_k}")
        if not gap <= SERVE_FWD_REL_BOUND < min(ctrl[k]
                                                for k in MOE_FWD_CONTROLS):
            raise SystemExit(f"phase 26: serve vs forward gap {gap} / "
                             f"controls {ctrl} against "
                             f"{SERVE_FWD_REL_BOUND}")
        out["serve_vs_forward"] = dict(gap=gap, controls=ctrl,
                                       bound=SERVE_FWD_REL_BOUND,
                                       layers=MOE_FWD_LAYERS,
                                       dropped_at_default_factor=dropped)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 26: {arch}: peak memory {peak:.2f} GiB; "
        f"{out['seconds']:.1f} s in all [{card}]")
    return out


def moe_phases(torch, np, ops, launch, card):
    """Phases 25 and 26, then the ragged kernel timed at the two MoE
    archs' decode shapes (phase 4's way)."""
    train = train_moe(torch, ops, card)
    serving = {arch: serve_moe(torch, np, ops, launch, card, arch)
               for arch in MOE_SERVE}
    times = {arch: kernel_times(torch, ops, card, arch, phase=26)["decode"]
             for arch in MOE_SERVE}
    return train, serving, times


# ------------------------------------------------------- phases 27-28
# Every cross layer's tanh gate after seeding.  The reference initialises
# ``xgate`` to 0, so at init cross-attention adds exactly nothing and its
# weights get no gradient: no check at init could see it broken.
CROSS_GATE = 0.5
CROSS_STEPS = 3
CROSS_SEQ = 4096
CROSS_ROWS = 4
# the f32 serve-vs-forward copy's (encoder, decoder) layers
WHISPER_FWD_LAYERS = (2, 2)
# arch -> phase, training depth (None: every layer), the f32 copy's depth
CROSS_ARCHS = {
    "whisper-large-v3": dict(phase=27, train_layers=None,
                             fwd_layers=WHISPER_FWD_LAYERS),
    # 5 of 40 layers, one pattern group: 4 global + 1 cross; the full
    # config has no encoder, so this run has none
    "llama-3.2-vision-11b": dict(phase=28, train_layers=5,
                                 fwd_layers=(0, 5))}
# serving: rows, prompt tokens, new tokens
CROSS_SERVE = (4, 128, 16)
CROSS_FWD_CONTROLS = ("TF32 matmuls", "memory rows rotated")
# the f32 copies' tokens a row, a token a decode step (3 passes each);
# 512 took vision's copy ~20 s
CROSS_FWD_TOKENS = 256
CROSS_FAMILIES = ("CA-server kernels", "matmuls (cuBLAS)",
                  "xla route (encoder and cross-attention)", "other")


def _cross_memory(torch, cfg, rows, seed):
    """Seeded memory [rows, n_ctx, d_model] f32 from an explicit generator
    on the card (stub audio frames or patch embeddings): 0.02 x (a normal
    vector each row's frames share + a normal vector per frame).  With
    the per-frame draws alone, a random init's near-uniform attention
    over 6404 rows averages them away: on an H100 (80GB HBM3) the f32
    vision copy's rotated-memory control then moved the logits by 5.8e-4
    of their std, inside SERVE_FWD_REL_BOUND."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    shared = torch.randn((rows, 1, cfg.d_model), generator=gen,
                         device=DEVICE)
    frames = torch.randn((rows, cfg.encoder.n_ctx, cfg.d_model),
                         generator=gen, device=DEVICE)
    return (shared + frames) * 0.02


def _open_gates(torch, model):
    with torch.no_grad():
        n = 0
        for blk in model.layers:
            if blk.kind == "cross":
                blk.attn["xgate"].fill_(CROSS_GATE)
                n += 1
    if not n:
        raise SystemExit(f"{model.cfg.arch_id}: no cross layer to open")
    return model


def _cross_setup(arch):
    from repro_torch.cad import CADSession
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import PipelineConfig
    spec = CROSS_ARCHS[arch]
    cfg = get_config(arch)
    if spec["train_layers"]:
        cfg = dataclasses.replace(cfg, n_layers=spec["train_layers"])
    pipe = PipelineConfig(distribution="prolong", max_doc_len=CROSS_SEQ,
                          seq_len=CROSS_SEQ, global_batch=CROSS_ROWS,
                          n_ranks=4, vocab_size=cfg.vocab_size, seed=0)

    def session(policy):
        return CADSession.for_pipeline(cfg, pipe, plan_policy=policy,
                                       prefetch=2)
    return spec["phase"], cfg, pipe, session


def _cross_train(torch, cfg, pipe, sess, memory, steps, model=None,
                 on_step=None):
    """``steps`` CAD steps of a fresh seed-0 model (gates opened) through
    ``make_train_step``: plans from ``sess``, ``memory`` added to every
    batch, AdamW as the trainer sets it up.  Returns the metrics of each
    step (floats, with ``step_s`` from a synchronize to a synchronize)."""
    from repro_torch.data.pipeline import raw_batches
    from repro_torch.models.convert import decay_mask
    from repro_torch.models.model import Transformer
    from repro_torch.optim.adamw import AdamW, cosine_schedule
    from repro_torch.train.step import make_train_step
    if model is None:
        model = _open_gates(torch, Transformer(cfg, device=DEVICE, seed=0))
    opt = AdamW(lr=cosine_schedule(3e-4, 1, steps), weight_decay=0.1)
    state = opt.init(list(model.parameters()))
    step_fn = make_train_step(model, sess.context(), opt, decay_mask(model))
    gen = sess.attach_plans(raw_batches(pipe))
    out = []
    try:
        for step in range(steps):
            batch = next(gen)
            batch.pop("schedule_stats", None)
            batch["memory"] = memory
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step_fn(state, batch)
            torch.cuda.synchronize()
            m = {k: float(v) for k, v in m.items()}
            m.update(step=step, step_s=time.perf_counter() - t0)
            out.append(m)
            if on_step is not None:
                on_step(step, m)
    finally:
        gen.close()
    del model, state, step_fn
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _mark_xla_route(torch):
    """Bracket every forward and backward of the blockwise ``xla`` route
    (``core.attention._XlaFlash``) with a one-cycle spin kernel, so that
    a CUDA-only trace can tell that route's kernels from the rest: the
    device runs one stream in order, and the route's calls do not nest.
    Returns (the undo, a one-element list counting the calls)."""
    from repro_torch.core import attention as A
    fwd, bwd = A._XlaFlash.forward, A._XlaFlash.backward
    calls = [0]

    def forward(ctx, *a):
        calls[0] += 1
        torch.cuda._sleep(1)
        out = fwd(ctx, *a)
        torch.cuda._sleep(1)
        return out

    def backward(ctx, *g):
        calls[0] += 1
        torch.cuda._sleep(1)
        out = bwd(ctx, *g)
        torch.cuda._sleep(1)
        return out
    A._XlaFlash.forward = staticmethod(forward)
    A._XlaFlash.backward = staticmethod(backward)

    def undo():
        A._XlaFlash.forward = staticmethod(fwd)
        A._XlaFlash.backward = staticmethod(bwd)
    return undo, calls


# a marking spin kernel of one cycle runs for a few microseconds; each of
# the window's lead-in spins (~30 us) is longer than this
MARK_MAX_NS = 20_000


def _cross_breakdown(prof, phase, n_calls):
    """Device ms of one CUDA-only traced window by family: the CA-server
    kernels, cuBLAS matmuls outside the ``xla`` route, the ``xla`` route's
    kernels (every kernel between a pair of ``_mark_xla_route`` spin
    kernels), and the rest; with busy ms (the union of the kernels'
    intervals) and the span.  The window's lead-in spin is left out.
    Reads kineto's raw events (no per-event Python objects: a whisper step
    has ~10^5 kernels).  Returns None when the trace does not hold two
    marks for each of the window's ``n_calls`` route calls: the profiler
    has lost device events (as late in a run it has), and the families
    are then not measured."""
    import re
    from torch.autograd import DeviceType
    from repro_torch.launch import breakdown
    kernels = []
    for e in prof.profiler.kineto_results.events():
        # a region's range repeated on the card's timeline is no kernel
        if e.device_type() != DeviceType.CUDA \
                or e.name() in breakdown.REGIONS:
            continue
        start = e.start_ns() if hasattr(e, "start_ns") \
            else 1e3 * e.start_us()
        dur = e.duration_ns() if hasattr(e, "duration_ns") \
            else 1e3 * e.duration_us()
        kernels.append((start, start + dur, e.name()))
    kernels.sort()
    if not kernels:
        raise SystemExit(f"phase {phase}: the profiler recorded no device "
                         f"time")
    fams = dict.fromkeys(CROSS_FAMILIES, 0.0)
    families = dict(breakdown.KERNEL_FAMILIES)
    ca = re.compile(families["CA-server kernels"], re.I)
    mm = re.compile(families["matmuls (cuBLAS)"], re.I)
    inside, marks, n = False, 0, 0
    busy, end, first = 0.0, -math.inf, None
    for a, b, name in kernels:
        if SPIN_KERNEL in name:
            if b - a < MARK_MAX_NS:
                inside, marks = not inside, marks + 1
            continue
        n += 1
        first = a if first is None else first
        ms = (b - a) / 1e6
        busy += max(0.0, b - max(a, end)) / 1e6
        end = max(end, b)
        if inside:
            fams["xla route (encoder and cross-attention)"] += ms
        elif ca.search(name):
            fams["CA-server kernels"] += ms
        elif mm.search(name):
            fams["matmuls (cuBLAS)"] += ms
        else:
            fams["other"] += ms
    if marks != 2 * n_calls:
        log(f"phase {phase}: {marks} xla-route marks in the trace for "
            f"{n_calls} calls: device events lost, families not measured")
        return None
    return dict(kernels=n, xla_calls=marks // 2, busy_ms=busy,
                span_ms=(end - first) / 1e6, families=fams)


def train_cross(torch, ops, card, arch):
    """Phase 27 (whisper-large-v3 at full size: 32 encoder + 32 decoder
    layers) or 28 (llama-3.2-vision-11b at every width, 5 of 40 layers: 4
    global + 1 cross) in bf16 from seed 0, gates at CROSS_GATE, the memory
    seeded [4, n_ctx, d_model] and added to every batch.  CAD on 4
    simulated servers, 4 x CROSS_SEQ ``prolong`` tokens, through
    ``make_train_step``: the step-0 loss under ``identity``; CROSS_STEPS
    steps under ``balanced`` (launches servers x causal self-attention
    layers x {2, 1, 1} and nothing else: cross-attention and the encoder
    take the ``xla`` route), step 1 traced by family; the step-0 loss
    bitwise equal under identity and on a repeat, and moved by the memory
    rows rotated across the batch; the CA kernels on layer 0's captured
    server batches against their plain versions and timed (phase 6's
    way), flash beside them on that layer's q/k/v."""
    from torch.profiler import ProfilerActivity, profile
    t_phase = time.perf_counter()
    phase, cfg, pipe, session = _cross_setup(arch)
    n_servers = pipe.n_ranks
    tokens = pipe.global_batch * pipe.seq_len
    memory = _cross_memory(torch, cfg, pipe.global_batch, seed=0)
    n_enc = cfg.encoder.n_layers if cfg.encoder else 0
    loss_identity = _cross_train(torch, cfg, pipe, session("identity"),
                                 memory, 1)[0]["loss"]
    from repro_torch.models.model import Transformer
    model = _open_gates(torch, Transformer(cfg, device=DEVICE, seed=0))
    n_params = sum(p.numel() for p in model.parameters())
    log(f"phase {phase}: {arch}, {cfg.n_layers} decoder layers "
        f"({[blk.kind for blk in model.layers].count('cross')} cross) and "
        f"{n_enc} encoder layers, d_model {cfg.d_model}, heads "
        f"{cfg.n_heads}/{cfg.n_kv_heads} of {cfg.head_dim}, vocab "
        f"{cfg.vocab_size}, {n_params / 1e9:.3f} B params, "
        f"{cfg.param_dtype}, xgate "
        f"{CROSS_GATE}; memory {tuple(memory.shape)}; CAD on {n_servers} "
        f"simulated servers, {pipe.global_batch} x {pipe.seq_len} tokens "
        f"({pipe.distribution}); step-0 identity loss {loss_identity!r}")
    expect = {"ca_server_fwd": n_servers * cfg.n_layers * 2,   # + remat
              "ca_server_bwd_dq": n_servers * cfg.n_layers,
              "ca_server_bwd_dkv": n_servers * cfg.n_layers}
    captured, steps = {}, []

    def capture(layer, inputs):
        if layer == 0 and layer not in captured:
            captured[layer] = {k: v.detach().clone() if torch.is_tensor(v)
                               else v for k, v in inputs.items()}

    prof = profile(activities=[ProfilerActivity.CUDA])
    undo, calls = _mark_xla_route(torch)
    traced = {}

    def on_step(step, m):
        if step == 1:
            prof.stop()
            traced["calls"] = calls[0]
        counts = {k: ops.launches[k] for k in expect}
        others = sum(n for k, n in ops.launches.items() if k not in expect)
        mem = torch.cuda.max_memory_allocated() / 2 ** 30
        ops.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        model.attn_hook = None              # capture step 0 only
        steps.append(dict(m, counts=counts, others=others, peak_gib=mem))
        log(f"phase {phase}: step {step} loss {m['loss']:.6f} gnorm "
            f"{m['grad_norm']:.4f} step {1e3 * m['step_s']:.1f} ms "
            f"{tokens / m['step_s']:.0f} tokens/s peak {mem:.2f} GiB "
            f"launches {counts}{' (traced)' if step == 1 else ''} [{card}]")
        if step == 0:
            prof.start()
            trace_lead_in(torch)
            calls[0] = 0
    model.attn_hook = capture
    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    try:
        _cross_train(torch, cfg, pipe, session("balanced"), memory,
                     CROSS_STEPS, model=model, on_step=on_step)
    finally:
        undo()
    del model
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    bd = _cross_breakdown(prof, phase, traced["calls"])
    del prof
    host_ms = 1e3 * steps[1]["step_s"]
    if bd is not None:
        fams = ", ".join(f"{f} {ms:.1f}" for f, ms in
                         bd["families"].items())
        log(f"phase {phase}: step 1 traced (CUDA activity only, read in "
            f"{time.perf_counter() - t0:.1f} s): {bd['kernels']} kernels, "
            f"{bd['xla_calls']} xla-route calls; host {host_ms:.1f} ms, "
            f"device span {bd['span_ms']:.1f} ms, busy "
            f"{bd['busy_ms']:.1f} ms (idle "
            f"{1 - bd['busy_ms'] / host_ms:.4f} of the step); ms by family:"
            f" {fams} [{card}]")
    for st in steps:
        if st["counts"] != expect or st["others"]:
            raise SystemExit(f"phase {phase}: step {st['step']} launches "
                             f"{st['counts']} (+{st['others']} of other "
                             f"kernels) != {expect}")
        if not math.isfinite(st["loss"]):
            raise SystemExit(f"phase {phase}: step {st['step']} loss "
                             f"{st['loss']}")
    if sorted(captured) != [0]:
        raise SystemExit(f"phase {phase}: captured layers {sorted(captured)}")
    repeat = _cross_train(torch, cfg, pipe, session("balanced"), memory,
                          1)[0]["loss"]
    rotated = _cross_train(torch, cfg, pipe, session("balanced"),
                           memory.roll(1, 0), 1)[0]["loss"]
    loss0 = steps[0]["loss"]
    log(f"phase {phase}: step-0 loss {loss0!r} under balanced, "
        f"{loss_identity!r} under identity, {repeat!r} on a repeat; with "
        f"the memory rows rotated across the batch {rotated!r} (|diff| "
        f"{abs(rotated - loss0):.3e})")
    if not loss0 == loss_identity == repeat or rotated == loss0:
        raise SystemExit(f"phase {phase}: step-0 losses: balanced {loss0!r}, "
                         f"identity {loss_identity!r}, repeat {repeat!r}, "
                         f"rotated memory {rotated!r}")
    batches = captured_batches(torch, captured)
    err = check_captured(torch, ops, captured, batches, phase=phase)
    tot, f_bound, b_bound = ca_kernel_times(torch, ops, batches[0],
                                            captured[0], card, phase=phase)
    del batches, captured, memory
    gc.collect()
    torch.cuda.empty_cache()
    ops.reset_launches()
    seconds = time.perf_counter() - t_phase
    log(f"phase {phase}: launches per step = {expect}; {seconds:.1f} s in "
        f"all [{card}]")
    return dict(params=n_params, ca_launches=steps[0]["counts"], times=tot,
                bounds=(f_bound, b_bound), ca_captured_max_abs_err=err,
                loss=[st["loss"] for st in steps],
                step_s=[st["step_s"] for st in steps],
                tokens_per_s=[tokens / st["step_s"] for st in steps],
                peak_gib=[st["peak_gib"] for st in steps],
                step0=dict(identity=loss_identity, repeat=repeat,
                           rotated_memory=rotated),
                traced_step1=dict(host_ms=host_ms, **(bd or dict(
                    families="not measured: device events lost"))),
                seconds=seconds,
                shape=f"{pipe.global_batch} x {pipe.seq_len} tokens, "
                      f"{n_servers} servers, {cfg.n_layers} decoder and "
                      f"{n_enc} encoder layers, memory "
                      f"{cfg.encoder.n_ctx} rows")


def _cross_serve_vs_forward(torch, np, cfg, layers, phase):
    """An f32 copy of ``cfg`` at ``layers`` = (encoder, decoder) layers,
    gates open: the per-token logits of the legacy decode path
    (``make_serve_step`` on a ``layout="decode"`` cache, a token a step)
    against ``Transformer.forward``'s on 2 x CROSS_FWD_TOKENS tokens with
    the same memory, as max |diff| / std; and the controls': the decode
    path with TF32 matmuls, and with the memory rows rotated across the
    batch.  Returns (gap, {control: gap})."""
    from repro_torch.models.model import Transformer
    from repro_torch.parallel import ParallelContext
    from repro_torch.train.step import make_serve_step
    n_enc, n_dec = layers
    enc = cfg.encoder
    if enc is not None and enc.n_layers:
        enc = dataclasses.replace(enc, n_layers=n_enc)
    cfg = dataclasses.replace(cfg, n_layers=n_dec, encoder=enc,
                              param_dtype="float32", compute_dtype="float32")
    model = _open_gates(torch, Transformer(cfg, device=DEVICE, seed=0))
    memory = _cross_memory(torch, cfg, 2, seed=100 + phase)
    rng = np.random.default_rng(100 + phase)
    prompt = torch.tensor(rng.integers(1, cfg.vocab_size,
                                       (2, CROSS_FWD_TOKENS)),
                          dtype=torch.int32, device=DEVICE)
    step = make_serve_step(model)

    def per_token(mem):
        cache = model.init_cache(2, CROSS_FWD_TOKENS, layout="decode",
                                 memory=mem)
        rows = []
        for t in range(CROSS_FWD_TOKENS):
            rows.append(step(cache, prompt[:, t:t + 1],
                             torch.full((2,), t, dtype=torch.int32,
                                        device=DEVICE))[1][:, 0])
        del cache
        return torch.stack(rows, 1)
    served = per_token(memory)
    controls = {}
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        controls["TF32 matmuls"] = per_token(memory)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    controls["memory rows rotated"] = per_token(memory.roll(1, 0))
    batch = {"tokens": prompt,
             "segment_ids": torch.ones(prompt.shape, dtype=torch.int32,
                                       device=DEVICE),
             "positions": torch.arange(CROSS_FWD_TOKENS, dtype=torch.int32,
                                       device=DEVICE).expand(2, -1)
             .contiguous(),
             "memory": memory}
    with torch.no_grad():
        logits, _ = model(batch, ParallelContext(attn_impl="xla",
                                                 remat=False))
    scale = float(logits.std())
    gap = float((served - logits).abs().max()) / scale
    ctrl = {k: float((c - logits).abs().max()) / scale
            for k, c in controls.items()}
    del model, served, controls, logits, memory
    gc.collect()
    torch.cuda.empty_cache()
    return gap, ctrl


def serve_cross(torch, np, ops, card, arch):
    """Phase 27(b) / 28(b): the arch at full size and depth (whisper's 32
    + 32 layers, vision's 40) in bf16 from seed 0, gates open, served
    through the legacy branch of ``Engine`` (``Engine(memory=...)``):
    CROSS_SERVE's dense prompt batch, greedy ``generate``, a token a step;
    no kernel of the port launches (no ragged call: the reference's
    legacy path attends in plain ops).  Records the engine's build (the
    encoder, each cross layer's xk/xv), encode ms alone, prefill tokens/s,
    decode ms a step, one decode step traced (host against busy), peak
    memory; the prompts and memory rows permuted together give the tokens
    permuted, bitwise; then the f32 serve-vs-forward check."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.launch import breakdown
    from repro_torch.models.model import Transformer
    from repro_torch.parallel import ParallelContext
    from repro_torch.serve import Engine, ServeConfig
    spec = CROSS_ARCHS[arch]
    phase = spec["phase"]
    t_phase = time.perf_counter()
    cfg = get_config(arch)
    rows, plen, new = CROSS_SERVE
    torch.cuda.reset_peak_memory_stats()
    model = _open_gates(torch, Transformer(cfg, device=DEVICE, seed=0))
    n_params = sum(p.numel() for p in model.parameters())
    memory = _cross_memory(torch, cfg, rows, seed=1)
    encode_ms = None
    if cfg.encoder and cfg.encoder.n_layers:
        ctx = ParallelContext(attn_impl="xla", remat=False)
        with torch.inference_mode():
            model.encode(memory, ctx)               # warm
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.encode(memory, ctx)
            torch.cuda.synchronize()
        encode_ms = 1e3 * (time.perf_counter() - t0)
    scfg = ServeConfig(max_seq=plen + new, max_new_tokens=new)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine = Engine(model, scfg, batch_size=rows, device=DEVICE,
                    memory=memory)
    torch.cuda.synchronize()
    build_ms = 1e3 * (time.perf_counter() - t0)
    if engine.serve_layout or engine.fused_ok:
        raise SystemExit(f"phase {phase}: {arch} is not on the legacy branch")
    rng = np.random.default_rng(phase)
    prompt = rng.integers(1, cfg.vocab_size, (rows, plen)).astype(np.int32)
    orig, calls = engine._step, []

    def timed(*a):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = orig(*a)
        torch.cuda.synchronize()
        calls.append(time.perf_counter() - t)
        return out
    ops.reset_launches()
    engine._step = timed
    try:
        t0 = time.perf_counter()
        toks = engine.generate(prompt)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        engine._step = orig
    launched = {k: n for k, n in ops.launches.items() if n}
    toks = toks.cpu().numpy()
    if toks.shape != (rows, new) or not ((toks >= 0)
                                         & (toks < cfg.vocab_size)).all():
        raise SystemExit(f"phase {phase}: {arch} generated {toks}")
    if launched or len(calls) != plen + new - 1:
        raise SystemExit(f"phase {phase}: {len(calls)} steps, launches "
                         f"{launched} (none expected)")
    prefill_tps = rows * plen / sum(calls[:plen])
    decode = sorted(calls[plen:])
    decode_ms = 1e3 * decode[len(decode) // 2]
    # one more decode step at the next position, traced
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    nxt = torch.tensor(toks[:, -1], device=DEVICE)
    torch.cuda.synchronize()
    prof.start()
    t0 = time.perf_counter()
    engine._legacy_step(nxt, plen + new - 1)
    torch.cuda.synchronize()
    host_ms = 1e3 * (time.perf_counter() - t0)
    prof.stop()
    bd = breakdown.device_breakdown(prof.events())
    del prof
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"phase {phase}: {arch} served at full depth ({cfg.n_layers} "
        f"decoder layers, {cfg.encoder.n_layers} encoder layers, "
        f"{n_params / 1e9:.3f} B params, {cfg.param_dtype}): engine built "
        f"in "
        f"{build_ms:.1f} ms (encoder and each cross layer's xk/xv"
        + (f"; encode alone {encode_ms:.1f} ms" if encode_ms else "")
        + f"); {rows} x {plen} prompt tokens + {new} new in {wall:.2f} s: "
        f"prefill {prefill_tps:.0f} tokens/s (a token a step), decode "
        f"{decode_ms:.2f} ms a step (median of {len(decode)}, "
        f"{1e3 * decode[0]:.2f}-{1e3 * decode[-1]:.2f}); kernel launches "
        f"{launched or 0}; one decode step traced: host {host_ms:.2f} ms, "
        f"device busy {bd['busy_ms']:.2f} ms (idle "
        f"{1 - bd['busy_ms'] / host_ms:.4f}), {bd['kernels']} device "
        f"events, ms by family "
        f"{ {k: round(v, 3) for k, v in bd['families'].items() if v} }; "
        f"peak {peak:.2f} GiB [{card}]")
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    perm = np.array([2, 0, 3, 1])
    engine = Engine(model, scfg, batch_size=rows, device=DEVICE,
                    memory=memory[torch.as_tensor(perm, device=DEVICE)])
    permuted = engine.generate(prompt[perm]).cpu().numpy()
    same = bool(np.array_equal(permuted, toks[perm]))
    log(f"phase {phase}: prompts and memory rows permuted {perm.tolist()}: "
        f"tokens permuted bitwise {same}")
    if not same:
        raise SystemExit(f"phase {phase}: permuted tokens {permuted} != "
                         f"{toks[perm]}")
    del engine, model, memory
    gc.collect()
    torch.cuda.empty_cache()
    gap, ctrl = _cross_serve_vs_forward(torch, np, cfg, spec["fwd_layers"],
                                        phase)
    log(f"phase {phase}: f32 copy at {spec['fwd_layers']} (encoder, "
        f"decoder) layers: per-token decode logits against "
        f"Transformer.forward's on 2 x {CROSS_FWD_TOKENS} tokens: max "
        f"|diff| / std {gap:.3e} (bound {SERVE_FWD_REL_BOUND}); controls "
        + ", ".join(f"'{k}' {v:.3e}" for k, v in ctrl.items()))
    if not gap <= SERVE_FWD_REL_BOUND < min(ctrl[k]
                                            for k in CROSS_FWD_CONTROLS):
        raise SystemExit(f"phase {phase}: serve vs forward gap {gap} / "
                         f"controls {ctrl} against {SERVE_FWD_REL_BOUND}")
    seconds = time.perf_counter() - t_phase
    log(f"phase {phase}: serving {seconds:.1f} s in all [{card}]")
    return dict(params=n_params, layers=cfg.n_layers,
                encoder_layers=cfg.encoder.n_layers, build_ms=build_ms,
                encode_ms=encode_ms, prefill_tokens_per_s=prefill_tps,
                prefill_shape=f"{rows} x {plen}, a token a step",
                decode_ms=decode_ms, new_tokens=new, serve_s=wall,
                traced_decode_host_ms=host_ms,
                traced_decode_busy_ms=bd["busy_ms"],
                traced_decode_idle=1 - bd["busy_ms"] / host_ms,
                traced_decode_families={k: v for k, v in
                                        bd["families"].items() if v},
                kernel_launches=0, permuted_bitwise=same, peak_gib=peak,
                serve_vs_forward=dict(gap=gap, controls=ctrl,
                                      bound=SERVE_FWD_REL_BOUND,
                                      layers=spec["fwd_layers"]),
                seconds=seconds)


def cross_phases(torch, np, ops, card):
    """Phases 27 and 28: each cross-attention arch trained under CAD, then
    served."""
    return {arch: (train_cross(torch, ops, card, arch),
                   serve_cross(torch, np, ops, card, arch))
            for arch in CROSS_ARCHS}


def _record_cross(ca_fwd, ca_bwd, cross):
    """Phases 27-28's numbers into the kernels' JSON entries (rows 4w-5w
    and 4v-5v)."""
    heads = {"whisper-large-v3": ("whisper", "20 q over 20 kv heads of 64: "
                                             "rep 1"),
             "llama-3.2-vision-11b": ("vision", "32 q over 8 kv heads of "
                                                "128: rep 4")}
    for arch, (train, serving) in cross.items():
        key, head = heads[arch]
        t, (f_bound, b_bound) = train["times"], train["bounds"]
        shape = (f"{arch} layer 0 of step 0 ({head}), 4 server batches "
                 f"summed; " + train["shape"])
        ca_fwd[key] = dict(
            launches=train["ca_launches"]["ca_server_fwd"], ms=t["fwd"],
            ms_repeat=t["fwd_repeat"], plain_ms=t["plain_fwd"],
            bound_ms=f_bound[0], bound_by=f_bound[1],
            library_ms=t["sdpa_fwd"],
            library_call="sdpa fwd, efficient attention, boolean mask",
            flash_yardstick_ms=t["flash_fwd"], shape=shape,
            captured_max_abs_err=train["ca_captured_max_abs_err"],
            train={k: train[k] for k in (
                "loss", "step_s", "tokens_per_s", "peak_gib", "params",
                "step0", "traced_step1", "seconds")},
            serving=serving)
        ca_bwd[key] = dict(
            launches=train["ca_launches"]["ca_server_bwd_dq"],
            launches_dkv=train["ca_launches"]["ca_server_bwd_dkv"],
            ms=t["bwd"], plain_ms=t["plain_bwd"], bound_ms=b_bound[0],
            bound_by=b_bound[1], library_ms=t["sdpa_fwd_bwd"],
            library_call="sdpa fwd+bwd, efficient attention, boolean mask",
            flash_yardstick_ms=t["flash_bwd"], shape=shape)


# ---------------------------------------------------------------- main
def _kernel_symbol(mangled: str) -> str:
    """``name<args>`` of a mangled kernel symbol: the first
    length-prefixed name of its nested name (``_ZN<len><name>...``) that
    ends in ``_kernel``, with its template arguments as mangled
    (``ILi192ELi4ELi64E``: 192, 4, 64)."""
    import re
    pos = 3 if mangled.startswith("_ZN") else 2
    while m := re.match(r"\d+", mangled[pos:]):
        start = pos + m.end()
        name = mangled[start:start + int(m.group())]
        pos = start + len(name)
        if name.endswith("_kernel"):
            rest = mangled[pos:]
            return name + (rest[:rest.find("EE") + 1]
                           if rest.startswith("I") else "")
    return mangled


# ----------------------------------------------------------- phase 24
# (a): NCCL at world size 1 in this process, phase 5's configuration with a
# 1-server plan and ping-pong on; (b): RANKS_GLOO processes on the one card
# under gloo; (c): the fabric on phase 5's captured layer 0.
RANKS_STEPS = 2
RANKS_GLOO = 4
# what ProcessGroupGloo::alltoall_base raises for a device it has no
# all_to_all for: the one error that drops (b)
GLOO_REFUSAL = "ProcessGroupGloo::alltoall_base: unsupported device type"
FABRIC_PROMPTS = (256, 512, 768, 1024, 1280, 1536, 1792, 2048)
FABRIC_NEW = 16
FABRIC_SLOTS = 8
# mid-decode: the 768- to 2048-token prompts prefill in 6-16 steps and
# decode 16 steps after, so six requests are decoding at step 20
FABRIC_KILL = "kill:1@20"
FABRIC_INTERVAL = 5e-3      # s: a step's cadence, ~30x a server's load
FABRIC_MAX_STEPS = 64


def _bits_digest(torch, t) -> str:
    import hashlib
    return hashlib.sha1(t.detach().contiguous().view(torch.uint8).cpu()
                        .numpy().tobytes()).hexdigest()


def _exchanges(ev, n):
    """The ``n`` exchanges of a ping-pong layer in issue order: NCCL's
    own kernels if the trace has them a multiple of ``n`` times, else the
    profiler's ``nccl:...`` spans of the collectives on the
    communicator's stream.  Returns (every NCCL event, the exchanges,
    events an exchange), or None when neither count is a multiple of
    ``n``."""
    nccl = [e for e in ev if "nccl" in e[0].lower()]
    kern = [e for e in nccl if not e[0].startswith("nccl:")]
    xch = kern if kern and len(kern) % n == 0 else \
        [e for e in nccl if e[0].startswith("nccl:")]
    if not xch or len(xch) % n:
        return None
    return nccl, xch, len(xch) // n


def _traced_exchanges(torch, fn, n, ca_names, n_ca):
    """One call of ``fn`` traced with ``torch.profiler`` after an
    untraced warm-up call: (its device events as (name, start us, end us)
    in start order, ``_exchanges(events, n)``, the ``n_ca`` CA kernels,
    named by one of ``ca_names``).  A window that lost events (a count
    of exchanges or CA kernels off) is traced again, up to
    PROFILE_WINDOWS: late in a run the profiler has dropped device events
    (section 7 of PERF.md), in one run the same first ones of every
    window, so each window opens with spin kernels (``trace_lead_in``)
    before ``fn``.  Returns (None, what each window held) when none was
    whole."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import breakdown
    fn()
    torch.cuda.synchronize()
    held = []
    for _ in range(PROFILE_WINDOWS):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            trace_lead_in(torch)
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
        ev = sorted(((e.name, e.time_range.start, e.time_range.end)
                     for e in prof.events() if breakdown.is_kernel(e)),
                    key=lambda x: x[1])
        xch = _exchanges(ev, n)
        ca = [e for e in ev if any(c in e[0] for c in ca_names)]
        if xch is not None and len(ca) == n_ca:
            return ev, xch, ca
        held.append(dict(
            events=len(ev), first=[e[0][:40] for e in ev[:4]],
            nccl_events=sum("nccl" in e[0].lower() for e in ev),
            ca=len(ca)))
    return None, held


def _overlap_us(spans, others) -> float:
    return sum(max(0.0, min(e, f) - max(s, t))
               for _, s, e in spans for _, t, f in others)


def _pingpong_trace(torch, inp):
    """One layer-0 forward of the ping-pong dispatch over the group, and
    then its backward, each traced.  Forward: the exchanges in issue
    order (5 sends of nano-batch 0, 5 of nano-batch 1, then the two
    returns) against the CA forward kernels: whether nano-batch 1's first
    send started before nano-batch 0's CA forward ended, and the overlap
    of 1's sends with that forward in ms.  Backward: the overlap of its
    (synchronous) exchanges with the CA backward kernels."""
    from repro_torch.core import dispatch as D
    q, k, v = (inp[n].detach() for n in "qkv")
    seg, pos = inp["segment_ids"], inp["positions"]

    def fwd():
        with torch.no_grad():
            D.cad_attention(q, k, v, seg, pos, seg, pos, ctx=inp["ctx"])
    # a nano-batch's 5 sends (q, its positions, k, v, theirs) and return
    got = _traced_exchanges(torch, fwd, 12, ("ca_fwd",), 2)
    if got[0] is None:
        raise SystemExit(f"phase 24: no traced ping-pong forward held 12 "
                         f"exchanges and 2 CA forwards: {got[1]}")
    ev, (nccl, xch, per), ca = got
    sends1 = xch[5 * per:10 * per]
    # device events within the exchanges' spans: NCCL's copies, and
    # kernels of the compute stream running meanwhile
    inner = sorted({e[0][:60] for e in ev if e not in nccl and any(
        s <= e[1] and e[2] <= t for _, s, t in xch)})
    compute = [e for e in ev if e not in nccl and "Memcpy" not in e[0]]
    s0, e0 = ca[0][1], ca[0][2]

    qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    g = torch.randn(q.shape, generator=gen, device=DEVICE).to(q.dtype)
    out = D.cad_attention(qg, kg, vg, seg, pos, seg, pos, ctx=inp["ctx"])
    # the positions carry no gradient: 3 sends and a return a nano-batch;
    # a dq and a dk/dv kernel a nano-batch
    got_b = _traced_exchanges(torch, lambda: torch.autograd.grad(
        out, (qg, kg, vg), g, retain_graph=True), 8, ("ca_dq", "ca_dkv"), 4)
    del out
    if got_b[0] is None:
        # logged only: no check reads the backward's trace
        log(f"phase 24(a): no traced backward held 8 exchanges and 4 CA "
            f"kernels ({got_b[1]}): its overlap not measured")
        bwd = dict(bwd_exchanges=None, bwd_exchange_ms=None,
                   bwd_ca_kernels=None, bwd_overlap_ms=None)
    else:
        _, (_, xch_b, _), ca_b = got_b
        bwd = dict(bwd_exchanges=len(xch_b),
                   bwd_exchange_ms=sum(e - s for _, s, e in xch_b) / 1e3,
                   bwd_ca_kernels=len(ca_b),
                   bwd_overlap_ms=_overlap_us(xch_b, ca_b) / 1e3)
    return dict(nano1_send_starts_before_ca0_ends=sends1[0][1] < e0,
                overlap_ms=_overlap_us(sends1, [ca[0]]) / 1e3,
                overlap_compute_ms=_overlap_us(sends1, compute) / 1e3,
                ca0_ms=(e0 - s0) / 1e3,
                nano1_sends_ms=[(e - s) / 1e3 for _, s, e in sends1],
                nano1_first_send_to_ca0_end_ms=(e0 - sends1[0][1]) / 1e3,
                exchange_kernel=xch[0][0][:80], exchange_kernels=len(xch),
                nccl_names=sorted({e[0][:80] for e in nccl}),
                within_exchanges=inner, ca_kernel=ca[0][0][:60], **bwd)


def ranks_nccl_world1(torch, ops, card):
    """Phase 24(a): the rank path under NCCL at world size 1, in this
    process on cuda:0: phase 5's llama3-8b width and depth, 4 x 4096
    tokens, a 1-server plan (``n_ranks=1``) with ping-pong on,
    RANKS_STEPS steps through ``trainer.train`` with a group session,
    and the same run through ``_global_sim`` (no group) on the same
    batches and weights: the step-0 losses bitwise equal, the later ones
    reported, launches = 2 nano-batches x layers x {2, 1, 1} a step in
    both; then one layer-0 forward of the group run traced
    (``_pingpong_trace``)."""
    import os
    import shutil
    import tempfile
    from repro_torch.cad import CADSession
    from repro_torch.launch import mesh
    from repro_torch.models.model import Transformer
    from repro_torch.train.trainer import train
    cfg, pipe5, tc5, _ = _train_setup()
    pipe = dataclasses.replace(pipe5, n_ranks=1)
    tc = dataclasses.replace(tc5, steps=RANKS_STEPS)
    tokens = pipe.global_batch * pipe.seq_len
    expect = {"ca_server_fwd": 2 * cfg.n_layers * 2,
              "ca_server_bwd_dq": 2 * cfg.n_layers,
              "ca_server_bwd_dkv": 2 * cfg.n_layers}
    # one process on one host: NCCL's bootstrap stays on the loopback,
    # and the group meets in a file store
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    t0 = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_nccl_"))
    info = mesh.join_group("cuda", backend="nccl", rank=0, world=1,
                           local_rank=0,
                           init_method=f"file://{tmp / 'store'}")
    runs, captured = {}, {}
    try:
        for name, group in (("_global_sim", None), ("nccl", info.group)):
            model = Transformer(cfg, device=DEVICE, seed=0)
            if group is not None:
                model.attn_hook = lambda layer, inp: captured.setdefault(
                    layer, {k: v.detach().clone() if torch.is_tensor(v)
                            else v for k, v in inp.items()}) \
                    if layer == 0 else None
            steps = []

            def on_step(step, m, name=name, model=model):
                counts = {k: ops.launches[k] for k in expect}
                ops.reset_launches()
                model.attn_hook = None
                steps.append(dict(m, counts=counts))
                log(f"phase 24(a): {name} step {step} loss {m['loss']!r} "
                    f"step {1e3 * m['step_s']:.1f} ms "
                    f"{tokens / m['step_s']:.0f} tokens/s launches {counts}"
                    f" [{card}]")
            session = CADSession.for_pipeline(cfg, pipe, pingpong=True,
                                              plan_policy="balanced",
                                              prefetch=2, group=group)
            ops.reset_launches()
            train(cfg, pipe, tc, model=model, session=session,
                  device=DEVICE, on_step=on_step)
            runs[name] = steps
            del model, session
            gc.collect()
            torch.cuda.empty_cache()
        trace = _pingpong_trace(torch, captured[0])
    finally:
        captured.clear()
        mesh.leave_group()
        shutil.rmtree(tmp, ignore_errors=True)
    sim, grp = runs["_global_sim"], runs["nccl"]
    checks = {
        "step-0 loss bitwise": grp[0]["loss"] == sim[0]["loss"],
        "finite losses": all(math.isfinite(s["loss"]) for s in sim + grp),
        f"launches {expect} a step": all(s["counts"] == expect
                                          for s in sim + grp),
        "nano-batch 1's send starts before nano-batch 0's CA forward ends":
            trace["nano1_send_starts_before_ca0_ends"],
    }
    seconds = time.perf_counter() - t0
    log(f"phase 24(a): NCCL world 1, llama3-8b width, {cfg.n_layers} "
        f"layers, 1 server, ping-pong: losses {[s['loss'] for s in grp]} "
        f"(_global_sim {[s['loss'] for s in sim]}); traced layer-0 "
        f"forward: exchange kernel {trace['exchange_kernel']!r} x "
        f"{trace['exchange_kernels']} (NCCL events {trace['nccl_names']}, "
        f"device events within them {trace['within_exchanges']}), "
        f"CA forward of nano-batch 0 "
        f"{trace['ca0_ms']:.4f} ms, nano-batch 1's sends "
        f"{[round(x, 4) for x in trace['nano1_sends_ms']]} ms, first send "
        f"starts {trace['nano1_first_send_to_ca0_end_ms']:.4f} ms before "
        f"that forward ends, overlap {trace['overlap_ms']:.4f} ms with it, "
        f"{trace['overlap_compute_ms']:.4f} ms with any compute kernel; its "
        f"backward: {trace['bwd_exchanges']} exchanges "
        f"({_ms4(trace['bwd_exchange_ms'])} ms), {trace['bwd_ca_kernels']} "
        f"CA backward kernels, overlap {_ms4(trace['bwd_overlap_ms'])} ms; "
        f"{seconds:.1f} s [{card}]")
    for name, ok in checks.items():
        log(f"  {name}: {ok}")
    failed = [n for n, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"phase 24(a): failed: {failed}")
    return dict(losses=[s["loss"] for s in grp],
                global_sim_losses=[s["loss"] for s in sim],
                step_s=[s["step_s"] for s in grp],
                global_sim_step_s=[s["step_s"] for s in sim],
                launches=grp[0]["counts"], checks=checks, trace=trace,
                seconds=seconds)


def _gloo_refusal(torch, dist, group, device):
    """Probe ``dist.all_to_all_single`` on ``device`` over ``group``:
    None when it runs, the error's text when gloo refuses the device
    (GLOO_REFUSAL).  Any other error (a transport fault, a timeout) is
    raised."""
    probe = torch.arange(RANKS_GLOO * 2, device=device).to(torch.bfloat16)
    got = torch.empty_like(probe)
    try:
        dist.all_to_all_single(got, probe, group=group)
    except RuntimeError as e:
        if GLOO_REFUSAL not in str(e):
            raise
        return repr(e)
    return None


def _gloo_rank(rank, tmp):
    """Phase 24(b)'s rank ``rank`` (a process of its own, on cuda:0): its
    rows of the captured layer 0 through ``cad_attention`` over a gloo
    group, forward and backward; writes out, dq, dk and dv (or gloo's
    refusal of CUDA tensors, ``_gloo_refusal``) under ``tmp``."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import dispatch as D
    from repro_torch.launch import mesh
    from repro_torch.parallel import ParallelContext
    tmp = Path(tmp)
    torch.backends.cuda.matmul.allow_tf32 = False
    info = mesh.join_group(DEVICE, backend="gloo", rank=rank,
                           world=RANKS_GLOO, local_rank=0,
                           init_method=f"file://{tmp / 'store'}",
                           timeout_s=300)
    try:
        refused = _gloo_refusal(torch, dist, info.group, info.device)
        if refused is not None:
            torch.save({"refused": refused}, tmp / f"rank{rank}.pt")
            return
        data = torch.load(tmp / "inputs.pt", weights_only=False)
        rows = data["q"].shape[0] // RANKS_GLOO
        sl = slice(rank * rows, (rank + 1) * rows)
        q, k, v = (data[n][sl].to(info.device).requires_grad_()
                   for n in "qkv")
        seg, pos, g = (data[n][sl].to(info.device)
                       for n in ("seg", "positions", "g"))
        cad = D.CADContext(cfg=data["cfg"], plan=data["plan"].to(
            info.device), jmax=data["jmax"])
        out = D.cad_attention(q, k, v, seg, pos, seg, pos,
                              ctx=ParallelContext(attn_impl="cad", cad=cad,
                                                  group=info.group))
        dq, dk, dv = torch.autograd.grad(out, (q, k, v), g)
        torch.save({n: t.detach().cpu() for n, t in
                    (("out", out), ("dq", dq), ("dk", dk), ("dv", dv))},
                   tmp / f"rank{rank}.pt")
        dist.barrier()
    finally:
        mesh.leave_group()


def ranks_gloo_on_card(torch, inp, card):
    """Phase 24(b): RANKS_GLOO processes on the one card, joined under
    gloo (whose ``all_to_all`` stages CUDA tensors through the host, so
    its times mean nothing), each taking its rows of phase 5's captured
    layer-0 q/k/v, segment ids and 4-server plan through the group's
    ``cad_attention``, forward and backward with a seeded cotangent.
    Gathered here and held against ``_global_sim`` on the card: out, dq,
    dk and dv bitwise (each kv block sums its sends in ``_global_sim``'s
    order).  A rank's error other than gloo's refusal of CUDA tensors
    ends the spawn, and the phase, with it.  The kernel libraries are
    built once, in this process, before the spawn: the ranks load them."""
    import shutil
    import tempfile
    import torch.multiprocessing as mp
    from repro_torch.core import dispatch as D
    from repro_torch.core.plan import StepPlan
    cad = inp["ctx"].cad
    if cad.cfg.n_servers != RANKS_GLOO:
        raise SystemExit(f"phase 24(b): the captured plan has "
                         f"{cad.cfg.n_servers} servers")
    q, k, v = (inp[n].detach() for n in "qkv")
    seg = inp["segment_ids"]
    pos = torch.where(seg > 0, inp["positions"], -1).to(torch.int32)
    gen = torch.Generator(device=DEVICE).manual_seed(24)
    g = torch.randn(q.shape, generator=gen, device=DEVICE).to(q.dtype)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_ranks_"))
    t0 = time.perf_counter()
    try:
        torch.save(dict(q=q.cpu(), k=k.cpu(), v=v.cpu(), seg=seg.cpu(),
                        positions=inp["positions"].cpu(), g=g.cpu(),
                        plan=StepPlan.from_dict({
                            k: v.cpu() for k, v in cad.plan.items()}),
                        cfg=cad.cfg,
                        jmax=cad.jmax), tmp / "inputs.pt")
        mp.spawn(_gloo_rank, args=(str(tmp),),
                 nprocs=RANKS_GLOO, join=True)
        parts = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
                 for r in range(RANKS_GLOO)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    seconds = time.perf_counter() - t0
    if any("refused" in p for p in parts):
        why = next(p["refused"] for p in parts if "refused" in p)
        log(f"phase 24(b): gloo refuses CUDA tensors in all_to_all on this "
            f"torch ({why}); dropped")
        return dict(refused=why, seconds=seconds)
    qq, kk, vv = (x.clone().requires_grad_() for x in (q, k, v))
    ref = D._global_sim(qq, kk, vv, pos, cad.plan, cad, 0.0, None)
    grads = torch.autograd.grad(ref, (qq, kk, vv), g)
    got = {n: torch.cat([p[n] for p in parts]).to(DEVICE)
           for n in ("out", "dq", "dk", "dv")}
    want = dict(zip(("out", "dq", "dk", "dv"), (ref.detach(), *grads)))
    bitwise = {n: same_bits(torch, got[n], want[n]) for n in got}
    diff = {n: float((got[n].float() - want[n].float()).abs().max())
            for n in got}
    checks = {f"{n} bitwise": bitwise[n] for n in got}
    log(f"phase 24(b): {RANKS_GLOO} gloo ranks on the card, layer 0 of "
        f"phase 5 (q {tuple(q.shape)} {q.dtype}): bitwise {bitwise}, max "
        f"|diff| {diff}; {seconds:.1f} s with the spawn [{card}]")
    for name, ok in checks.items():
        log(f"  {name}: {ok}")
    failed = [n for n, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"phase 24(b): failed: {failed}")
    return dict(bitwise=bitwise, max_abs_diff=diff, checks=checks,
                seconds=seconds)


def fabric_on_card(torch, np, ops, inp, card, free_digest=None):
    """Phase 24(c): ``FabricExecutor`` on phase 5's captured layer 0 (4
    servers, ``balanced``, bf16) with the serve tenant's requests of
    FABRIC_PROMPTS tokens and FABRIC_NEW decode steps each at llama3-8b's
    heads (32 q over 8 kv heads of 128, bf16), one mixed step at a time
    until every request completes, at FABRIC_INTERVAL: every step's
    training output bitwise equal to phase 19's fault-free executor
    output (``free_digest``; recomputed here either way), CA-forward
    launches = train serves + recovery serves + serve batches, and the
    run under FABRIC_KILL (a server lost mid-decode, its serve tasks
    re-admitted the same step) giving every request the digests of the
    fault-free run.  The fault-free run times each serve between two
    synchronizes (the ``wall`` timer): serve ms and the admitted and
    deferred counts are logged."""
    from repro_torch.fabric import FabricExecutor, ServeWorkload
    from repro_torch.runtime import ElasticExecutor, FaultSchedule, \
        ServerPool
    cad = inp["ctx"].cad
    cfg = cad.cfg
    d = cfg.n_servers
    pos = torch.where(inp["segment_ids"] > 0, inp["positions"], -1) \
        .to(torch.int32)
    segs = inp["segment_ids"].cpu().numpy().reshape(d, -1)
    q, k, v = (inp[n].detach() for n in "qkv")
    base = dataclasses.replace(_train_setup()[3]("balanced"), prefetch=0)
    t0 = time.perf_counter()
    free, _ = ElasticExecutor(base.with_pool(ServerPool(d))).run_step(
        0, q, k, v, pos, segs)
    free_here = _bits_digest(torch, free)
    arrivals = [(0, p, FABRIC_NEW) for p in FABRIC_PROMPTS]

    def run(spec, timer):
        wl = ServeWorkload(arrivals, n_heads=32, n_kv_heads=8, head_dim=128,
                           blk=cfg.blk, slots=FABRIC_SLOTS, seed=0,
                           dtype=torch.bfloat16)
        batches = [0]
        build = wl.build_batch

        def counted(tasks, device="cuda"):
            batches[0] += 1
            return build(tasks, device=device)
        wl.build_batch = counted
        ex = FabricExecutor(base.with_pool(ServerPool(d)), wl,
                            faults=FaultSchedule.parse(spec), timer=timer)
        reps, same, step = [], True, 0
        ops.reset_launches()
        while not wl.all_done() and step < FABRIC_MAX_STEPS:
            out, rep = ex.run_mixed_step(step, q, k, v, pos, segs,
                                         interval=FABRIC_INTERVAL)
            same = same and same_bits(torch, out, free)
            reps.append(rep)
            step += 1
        torch.cuda.synchronize()
        served = sum(len(r.train.server_seconds)
                     + len(r.train.recovery_seconds) for r in reps)
        return dict(wl=wl, reps=reps, same=same,
                    fwd=ops.launches["ca_server_fwd"],
                    want_fwd=served + batches[0], batches=batches[0])

    clean = run("", "wall")
    kill = run(FABRIC_KILL, "model")
    at = int(FABRIC_KILL.split("@")[1])
    krep = kill["reps"][at] if len(kill["reps"]) > at else None
    serve_ms = [1e3 * sum(r.serve_seconds.values()) for r in clean["reps"]]
    checks = {
        "fault-free executor == phase 19's": free_digest is None
        or free_here == free_digest,
        "train outputs == fault-free executor (every step)": clean["same"],
        "killed run's train outputs == fault-free (every step)":
            kill["same"],
        "every request completes": clean["wl"].all_done()
        and kill["wl"].all_done(),
        f"{FABRIC_KILL}: server lost, its serve tasks re-admitted":
            krep is not None and krep.train.failed == (1,)
            and krep.lost_serve > 0
            and krep.readmitted == krep.lost_serve,
        "kill mid-decode: the fault-free digests":
            kill["wl"].digest_map() == clean["wl"].digest_map(),
        "CA-forward launches = train + recovery serves + serve batches":
            clean["fwd"] == clean["want_fwd"]
            and kill["fwd"] == kill["want_fwd"],
    }
    seconds = time.perf_counter() - t0
    adm = [r.admitted for r in clean["reps"]]
    dfr = [r.deferred for r in clean["reps"]]
    log(f"phase 24(c): fabric on layer 0 ({d} servers) with "
        f"{len(arrivals)} requests (prompts {FABRIC_PROMPTS[0]}-"
        f"{FABRIC_PROMPTS[-1]}, {FABRIC_NEW} new, 32/8/128 heads, bf16): "
        f"{len(clean['reps'])} steps fault-free, {len(kill['reps'])} under "
        f"{FABRIC_KILL} (lost {krep.lost_serve if krep else '-'}, "
        f"readmitted {krep.readmitted if krep else '-'}); admitted {adm}; "
        f"deferred {dfr}; serve ms a step (wall) "
        f"{[round(x, 4) for x in serve_ms]}; CA-forward launches "
        f"{clean['fwd']} / {kill['fwd']} ({clean['batches']} / "
        f"{kill['batches']} serve batches); {seconds:.1f} s [{card}]")
    for name, ok in checks.items():
        log(f"  {name}: {ok}")
    failed = [n for n, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"phase 24(c): failed: {failed}")
    return dict(checks=checks, steps=len(clean["reps"]),
                kill_steps=len(kill["reps"]), admitted=adm, deferred=dfr,
                serve_ms=serve_ms, launches=clean["fwd"],
                kill_launches=kill["fwd"],
                lost=krep.lost_serve, readmitted=krep.readmitted,
                seconds=seconds)


def ranks_phase(torch, np, ops, layer0, card, free_digest):
    """Phase 24: (a), (b) and (c) on phase 5's captured layer 0."""
    t0 = time.perf_counter()
    out = dict(nccl_world1=ranks_nccl_world1(torch, ops, card),
               gloo_on_card=ranks_gloo_on_card(torch, layer0, card),
               fabric=fabric_on_card(torch, np, ops, layer0, card,
                                     free_digest))
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 24: {out['seconds']:.1f} s in all")
    return out


# ----------------------------------------------------------- phase 29
# pipeline parallelism with CAD across stages: PIPE_STAGES gloo processes
# on the one card, one llama3-8b layer a stage, one CAD plan a tick
PIPE_STAGES = 4
PIPE_MICRO = 4
PIPE_SEQ = 4096
# the loss is computed on this rank alone: stage 0, not the last stage, so
# the gradient reaches the last stage through the replication's backward
PIPE_LOSS_RANK = 0
PIPE_CA = ("ca_server_fwd", "ca_server_bwd_dq", "ca_server_bwd_dkv")
# an f32 copy's pipelined logits against its unpipelined forward:
# max |diff| / max |logit|
PIPE_F32_REL_BOUND = 1e-5


def _pipe_setup():
    """llama3-8b at every width, one layer a stage; PIPE_MICRO microbatches
    of [1, PIPE_SEQ] ``prolong`` documents (the data pipeline's seed 0);
    the pool sized as ``CADSession.for_pipeline`` sizes it, PIPE_STAGES
    servers."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core.cost_model import CommModel
    from repro_torch.core.plan import CADConfig
    from repro_torch.data.pipeline import PipelineConfig, raw_batches
    cfg = dataclasses.replace(get_config("llama3-8b"), n_layers=PIPE_STAGES)
    pipe = PipelineConfig(distribution="prolong", max_doc_len=PIPE_SEQ,
                          seq_len=PIPE_SEQ, global_batch=PIPE_MICRO,
                          vocab_size=cfg.vocab_size, seed=0)
    b = next(raw_batches(pipe))
    data = {k: np.ascontiguousarray(b[k][:, None]) for k in
            ("tokens", "labels", "segment_ids", "positions")}
    cadcfg = CADConfig.default(PIPE_STAGES, PIPE_SEQ,
                               max_doc_tokens=PIPE_SEQ)
    comm = CommModel(cfg.n_heads, cfg.head_dim, cfg.n_kv_heads)
    return cfg, data, cadcfg, comm, max(1, PIPE_SEQ // cadcfg.blk)


def _pipe_loss(torch, model, h, data, dev):
    """The summed LM loss of the outputs ``h`` [M, 1, S, D], a microbatch
    at a time (its f32 logits freed before the next); gradients go into
    ``h.grad`` and the final norm and unembedding.  Returns the losses."""
    from repro_torch.models import layers as L
    from repro_torch.train.loss import lm_loss
    losses = []
    for m in range(h.shape[0]):
        logits = model._unembed(L.norm_apply(model.final_norm, h[m],
                                             model.cfg.norm))
        loss = lm_loss(logits, torch.as_tensor(data["labels"][m], device=dev),
                       torch.as_tensor(data["segment_ids"][m], device=dev))[0]
        if h.requires_grad:
            loss.backward()
        losses.append(loss.item())
        del logits, loss
    return losses


def _pipe_rank_run(torch, cfg, data, plans, cad, info, grad):
    """One stage's run: the pipelined forward (and, with ``grad``, the
    loss on PIPE_LOSS_RANK and the backward, the shared parameters'
    gradients summed over the stages), the CA launches of each tick."""
    from repro_torch.kernels.packed_flash import ops
    from repro_torch.models.model import Transformer
    from repro_torch.parallel import ParallelContext
    from repro_torch.pipeline_par import (model_stage_fn, pipeline_apply,
                                          split_stages,
                                          sum_grads_over_stages)
    dev, rank, group = info.device, info.rank, info.group
    model = Transformer(cfg, device=dev, seed=0)
    stage = split_stages(model.layers, PIPE_STAGES)[rank]
    ctx = ParallelContext(attn_impl="cad", cad=cad, remat=True, group=group)
    segs, poss = (torch.as_tensor(data[k], device=dev)
                  for k in ("segment_ids", "positions"))
    fn = model_stage_fn(model, stage, ctx, segs, poss)
    fwd, marks = [], []

    def snap():
        return {k: ops.launches[k] for k in PIPE_CA}

    def counted(h, m, tick_plan):
        before = snap()
        out = fn(h, m, tick_plan)
        fwd.append({k: v - before[k] for k, v in snap().items()})
        if h.requires_grad:
            # the gradient of the tick's input is whole once the tick's
            # layer (recompute and CA backward included) is done
            h.register_hook(lambda g: marks.append(snap()))
        return out

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with torch.set_grad_enabled(grad):
        h_mb = torch.stack([model._embed(torch.as_tensor(x, device=dev))
                            for x in data["tokens"]])
        outs = pipeline_apply(h_mb, counted, n_stages=PIPE_STAGES,
                              group=group, plans=plans)
    torch.cuda.synchronize()
    res = dict(fwd_counts=fwd, fwd_s=time.perf_counter() - t0,
               outs_digest=_bits_digest(torch, outs))
    if rank == PIPE_LOSS_RANK:
        res["outs"] = outs.detach().cpu()
    if not grad:
        return res
    t0 = time.perf_counter()
    g = torch.zeros_like(outs)
    if rank == PIPE_LOSS_RANK:
        h = outs.detach().requires_grad_()
        res["losses"] = _pipe_loss(torch, model, h, data, dev)
        g = h.grad
    start = snap()
    torch.autograd.backward(outs, g)
    shared = [p for n, p in model.named_parameters()
              if not n.startswith("layers.")]
    sum_grads_over_stages(shared, group)
    torch.cuda.synchronize()
    res["bwd_s"] = time.perf_counter() - t0
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    # marks come in reverse tick order: tick t's backward launches lie
    # between the marks of ticks t + 1 and t
    seq = [start] + marks
    bwd = [{k: b[k] - a[k] for k in PIPE_CA} for a, b in zip(seq, seq[1:])]
    res["bwd_counts"] = bwd[::-1]
    first = rank * len(stage)
    res["grads"] = {n: p.grad.cpu() for n, p in model.named_parameters()
                    if n.startswith(tuple(f"layers.{first + i}."
                                          for i in range(len(stage))))}
    res["shared_digests"] = {n: _bits_digest(torch, p.grad)
                             for n, p in model.named_parameters()
                             if not n.startswith("layers.")}
    if rank == 0:
        res["shared"] = {n: p.grad.cpu() for n, p in
                         model.named_parameters()
                         if not n.startswith("layers.")}
    return res


def _pipeline_rank(rank, tmp):
    """Phase 29's rank ``rank`` (a process of its own, on cuda:0): stage
    ``rank`` of the pipeline over a gloo group, the bf16 forward and
    backward, then an f32 copy's forward; writes its results under
    ``tmp``.  Any error ends the spawn, and the run."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import dispatch as D
    from repro_torch.launch import mesh
    tmp = Path(tmp)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    info = mesh.join_group(DEVICE, backend="gloo", rank=rank,
                           world=PIPE_STAGES, local_rank=0,
                           init_method=f"file://{tmp / 'store'}",
                           timeout_s=300)
    try:
        cfg, data, cadcfg, _, jmax = _pipe_setup()
        plans = {k: torch.as_tensor(v, device=info.device)
                 for k, v in torch.load(tmp / "plans.pt",
                                        weights_only=False).items()}
        cad = D.CADContext(cfg=cadcfg, jmax=jmax)
        res = _pipe_rank_run(torch, cfg, data, plans, cad, info, True)
        gc.collect()
        torch.cuda.empty_cache()
        cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                    compute_dtype="float32")
        res["f32"] = _pipe_rank_run(torch, cfg32, data, plans, cad, info,
                                    False)
        torch.save(res, tmp / f"rank{rank}.pt")
        dist.barrier()
    finally:
        mesh.leave_group()


def _pipe_home_loads(data, cadcfg):
    """Each microbatch's CA load at home (the scheduler's cost units): a
    stage's load before scheduling, in the tick it holds the microbatch."""
    from repro_torch.core.scheduler import block_costs, layout_from_segments
    out = []
    for seg in data["segment_ids"][:, 0]:
        _, doc_of, bi_of = layout_from_segments(seg[None], cadcfg.blk, 1)
        out.append(float(block_costs(doc_of, bi_of, cadcfg.blk).sum()))
    return out


def _pipe_tick_report(np, stats, plans, home):
    """Per tick: loads max/mean before (at home) and after scheduling, and
    the idle stages that serve: an inactive stage with load after
    scheduling that receives q blocks of another stage."""
    n, m_total = PIPE_STAGES, len(home)
    rows, idle_serving = [], True
    for st in stats:
        t = st["tick"]
        before = np.array([home[t - s] if 0 <= t - s < m_total else 0.0
                           for s in range(n)])
        after = st["loads"]
        idle = [s for s in range(n) if not 0 <= t - s < m_total]
        recv = [int((plans["q_send_idx"][t][:, s] >= 0).sum())
                for s in range(n)]
        serving = all(after[s] > 0 and recv[s] > 0 for s in idle)
        idle_serving = idle_serving and serving
        rows.append(dict(
            tick=t, moves=st["moves"], comm_bytes=st["comm_bytes"],
            before=before.tolist(), after=after.tolist(),
            before_max_over_mean=float(before.max() / before.mean()),
            after_max_over_mean=float(after.max() / after.mean()),
            idle=idle, q_blocks_received=recv, idle_serving=serving))
    return rows, idle_serving


def _pipe_oracle(torch, cfg, data, plans, cad):
    """The one-process tick simulation on the card: every stage in this
    process, the same ticks, masks and plans, each tick's exchange through
    ``_global_sim``; the loss and backward as the group computes them.
    Returns (model with gradients, outs, losses)."""
    from repro_torch.models.model import Transformer
    from repro_torch.parallel import ParallelContext
    from repro_torch.pipeline_par import split_stages
    from repro_torch.pipeline_par.pipeline import (_lockstep_tick_fn,
                                                   _tick_sim)
    model = Transformer(cfg, device=DEVICE, seed=0)
    ctx = ParallelContext(attn_impl="cad", cad=cad, remat=False)
    segs, poss = (torch.as_tensor(data[k], device=DEVICE)
                  for k in ("segment_ids", "positions"))
    h_mb = torch.stack([model._embed(torch.as_tensor(x, device=DEVICE))
                        for x in data["tokens"]])
    outs = _tick_sim(h_mb, _lockstep_tick_fn(
        model, split_stages(model.layers, PIPE_STAGES), ctx, segs, poss),
        n_stages=PIPE_STAGES, plans=plans)
    h = outs.detach().requires_grad_()
    losses = _pipe_loss(torch, model, h, data, DEVICE)
    outs.backward(h.grad)
    return model, outs.detach(), losses


def _pipe_vs_unpipelined(torch, model, outs, data, jmax):
    """Each microbatch's logits from the pipeline's outputs ``outs`` (the
    head on them) against ``Transformer.forward`` under ``cad`` on that
    microbatch alone (one server, its identity plan): bitwise, max
    |diff|, max |logit|, and the unpipelined losses."""
    from repro_torch.core import dispatch as D
    from repro_torch.core.plan import CADConfig, identity_plan
    from repro_torch.models import layers as L
    from repro_torch.parallel import ParallelContext
    from repro_torch.train.loss import lm_loss
    cfg1 = CADConfig.default(1, PIPE_SEQ, max_doc_tokens=PIPE_SEQ)
    same, diff, top, losses = True, 0.0, 0.0, []
    for m in range(PIPE_MICRO):
        batch = {k: torch.as_tensor(data[k][m], device=DEVICE)
                 for k in ("tokens", "labels", "segment_ids", "positions")}
        plan = identity_plan(cfg1, data["segment_ids"][m]).to(DEVICE)
        ctx = ParallelContext(attn_impl="cad", remat=False, cad=D.CADContext(
            cfg=cfg1, plan=plan, jmax=jmax))
        with torch.no_grad():
            want = model(batch, ctx)[0]
            losses.append(lm_loss(want, batch["labels"],
                                  batch["segment_ids"])[0].item())
            got = model._unembed(L.norm_apply(model.final_norm,
                                              outs[m].to(DEVICE),
                                              model.cfg.norm))
        same = same and same_bits(torch, got, want)
        diff = max(diff, float((got - want).abs().max()))
        top = max(top, float(want.abs().max()))
        del got, want
    return same, diff, top, losses


def pipeline_phase(torch, np, card):
    """Phase 29: pipeline parallelism with CAD across stages
    (``repro_torch.pipeline_par``) on PIPE_STAGES gloo processes on the
    one card (gloo stages CUDA tensors through the host, so its exchange
    and step times are not speed figures), each one stage of llama3-8b at
    every width (one layer a stage), PIPE_MICRO microbatches of [1,
    PIPE_SEQ] in bf16 under ``cad``, one plan a tick (``tick_schedules``):
    one forward and backward of the pipelined loss, computed on
    PIPE_LOSS_RANK alone.  Checked: tick 0 moves tasks and every idle
    stage of the warm-up and drain ticks serves others' tasks; each rank
    launches the CA kernels once a tick forward and {1 forward (remat), 1
    dq, 1 dk/dv} a tick backward; the replicated outputs, the losses and
    every gradient bitwise equal to the one-process tick simulation's on
    the card; each microbatch's logits and loss bitwise equal to
    ``Transformer.forward`` on that microbatch alone (one server, its
    identity plan); an f32 copy's within PIPE_F32_REL_BOUND.  The kernel
    libraries are built before the spawn: the ranks load them."""
    import shutil
    import tempfile
    import torch.multiprocessing as mp
    from repro_torch.core import dispatch as D
    from repro_torch.pipeline_par import tick_schedules
    t_phase = time.perf_counter()
    cfg, data, cadcfg, comm, jmax = _pipe_setup()
    t0 = time.perf_counter()
    plans, stats = tick_schedules(data["segment_ids"][:, 0], PIPE_STAGES,
                                  cadcfg, comm)
    plan_s = time.perf_counter() - t0
    ticks, idle_serving = _pipe_tick_report(
        np, stats, plans, _pipe_home_loads(data, cadcfg))
    log(f"phase 29: llama3-8b width, {PIPE_STAGES} stages of 1 layer, "
        f"{PIPE_MICRO} microbatches of [1, {PIPE_SEQ}] (bf16, cad, remat), "
        f"{len(stats)} ticks planned in {plan_s:.2f} s")
    for r in ticks:
        log(f"  tick {r['tick']}: moves {r['moves']}, "
            f"{r['comm_bytes'] / 2 ** 20:.1f} MiB, loads max/mean "
            f"{r['before_max_over_mean']:.3f} -> "
            f"{r['after_max_over_mean']:.3f} (before {r['before']}, after "
            f"{r['after']}), idle stages {r['idle']} serving "
            f"{r['idle_serving']}, q blocks received by stage "
            f"{r['q_blocks_received']}")
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_pipeline_"))
    t0 = time.perf_counter()
    try:
        torch.save(plans, tmp / "plans.pt")
        mp.spawn(_pipeline_rank, args=(str(tmp),), nprocs=PIPE_STAGES,
                 join=True)
        parts = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
                 for r in range(PIPE_STAGES)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    spawn_s = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()

    # the oracle, then the unpipelined forward, on this process's card
    plans_dev = {k: torch.as_tensor(v, device=DEVICE)
                 for k, v in plans.items()}
    t0 = time.perf_counter()
    model, outs_sim, losses_sim = _pipe_oracle(
        torch, cfg, data, plans_dev, D.CADContext(cfg=cadcfg, jmax=jmax))
    oracle_s = time.perf_counter() - t0
    params = dict(model.named_parameters())
    got = parts[PIPE_LOSS_RANK]
    grad_gaps = {}            # max |diff| / max |grad| where not bitwise
    for n, g in [kv for p in parts for kv in p["grads"].items()] \
            + list(parts[0]["shared"].items()):
        g, want = g.to(DEVICE), params[n].grad
        if not same_bits(torch, g, want):
            grad_gaps[n] = float((g.float() - want.float()).abs().max()) \
                / float(want.float().abs().max())
    n_grads = sum(len(p["grads"]) for p in parts) + len(parts[0]["shared"])
    outs_same = same_bits(torch, got["outs"].to(DEVICE), outs_sim)
    model.zero_grad(set_to_none=True)
    del outs_sim, params
    vs, vs_diff, vs_top, u_losses = _pipe_vs_unpipelined(
        torch, model, got["outs"], data, jmax)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    from repro_torch.models.model import Transformer
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                compute_dtype="float32")
    model32 = Transformer(cfg32, device=DEVICE, seed=0)
    _, diff32, top32, _ = _pipe_vs_unpipelined(
        torch, model32, got["f32"]["outs"], data, jmax)
    del model32
    gc.collect()
    torch.cuda.empty_cache()

    n_ticks = len(stats)
    want_fwd = [{"ca_server_fwd": 1, "ca_server_bwd_dq": 0,
                 "ca_server_bwd_dkv": 0}] * n_ticks
    want_bwd = [{k: 1 for k in PIPE_CA}] * n_ticks
    counts = [dict(fwd=p["fwd_counts"], bwd=p["bwd_counts"],
                   f32_fwd=p["f32"]["fwd_counts"]) for p in parts]
    rel32 = diff32 / top32
    checks = {
        "tick 0 moves tasks": stats[0]["moves"] > 0,
        "every idle stage of warm-up and drain serves others' tasks":
            idle_serving,
        "CA launches a rank a tick: forward 1; backward 1 + 1 + 1": all(
            c["fwd"] == want_fwd and c["bwd"] == want_bwd
            and c["f32_fwd"] == want_fwd for c in counts),
        "outputs replicated bitwise on every rank":
            len({p["outs_digest"] for p in parts}) == 1
            and len({p["f32"]["outs_digest"] for p in parts}) == 1,
        "shared gradients equal on every rank":
            len({json.dumps(p["shared_digests"], sort_keys=True)
                 for p in parts}) == 1,
        "outputs bitwise the tick simulation's": outs_same,
        "losses bitwise the tick simulation's": got["losses"] == losses_sim,
        f"every gradient ({n_grads} tensors) bitwise the tick "
        f"simulation's": not grad_gaps,
        "logits bitwise the unpipelined forward's": vs,
        "losses bitwise the unpipelined forward's": got["losses"] == u_losses,
        f"f32 copy: logits within {PIPE_F32_REL_BOUND} of the unpipelined "
        f"forward's": rel32 <= PIPE_F32_REL_BOUND,
    }
    seconds = time.perf_counter() - t_phase
    timing = {r: {k: round(p[k], 3) for k in ("fwd_s", "bwd_s")}
              for r, p in enumerate(parts)}
    peaks = [round(p["peak_gib"], 3) for p in parts]
    log(f"phase 29: losses {got['losses']} (sum {sum(got['losses'])!r}), "
        f"tick simulation {losses_sim}, unpipelined {u_losses}; logits vs "
        f"unpipelined: bitwise {vs}, max |diff| {vs_diff} (max |logit| "
        f"{vs_top}); f32 copy: max |diff| / max |logit| {rel32}; gradients "
        f"off the simulation's bits: {grad_gaps or 'none'}")
    for r, c in enumerate(counts):
        log(f"  rank {r}: CA launches a tick, forward "
            f"{[x['ca_server_fwd'] for x in c['fwd']]}, backward "
            f"{[[x[k] for k in PIPE_CA] for x in c['bwd']]} (fwd, dq, dkv), "
            f"f32 forward {[x['ca_server_fwd'] for x in c['f32_fwd']]}; "
            f"peak {peaks[r]} GiB; forward {timing[r]['fwd_s']} s, backward "
            f"{timing[r]['bwd_s']} s")
    log(f"phase 29: plans {plan_s:.2f} s, spawn and the ranks' runs "
        f"{spawn_s:.1f} s, tick simulation {oracle_s:.1f} s, phase "
        f"{seconds:.1f} s (gloo stages CUDA tensors through the host: these "
        f"times are not speed figures) [{card}]")
    for name, ok in checks.items():
        log(f"  {name}: {ok}")
    failed = [n for n, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"phase 29: failed: {failed}")
    return dict(checks=checks, ticks=ticks, launches_per_rank_tick=counts,
                losses=got["losses"], logits_max_abs_diff=vs_diff,
                f32_rel_gap=rel32, grad_gaps=grad_gaps, peak_gib=peaks,
                rank_seconds=timing, spawn_s=spawn_s, seconds=seconds,
                note="gloo stages CUDA tensors through the host: times are "
                     "not speed figures")


# ----------------------------------------------------------- phase 30
# the per-rank runtime: RT_RANKS gloo processes on the one card, each a
# CAD rank of smollm-360m at every width, calibrating every step under a
# fault schedule
RT_ARCH = "smollm-360m"
# of its 32 layers: gloo stages every exchange through the host (~50 MB/s
# in phase 29), so 32 layers would take ~40 s a step
RT_LAYERS = 4
RT_RANKS = 4
RT_SEQ = 4096
RT_STEPS = 4
RT_FAULTS = "kill:1@2"
RT_KILLED, RT_KILL_STEP = 1, 2
# the training run in bf16, then an f32 copy for the loss bound
RT_DTYPES = ("bfloat16", "float32")
# the f32 copy's losses against the one-process trainer's: the group sums
# its rows' losses and gradients in another order (tests/test_torch_ranks.py
# holds 1e-5 on the CPU).  In bf16 each rank's weight gradient is rounded
# to bf16 before the ranks' sum, one process's once, and the bf16 weights
# then round a few updates apart: 3.7e-6 and 1.15e-5 in two runs of the
# same code (PERF.md, PR 28), so bf16 holds the step-0 loss bitwise and
# logs the later gaps
RT_LOSS_RTOL = 1e-5


def _rt_setup(dtype):
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import PipelineConfig
    from repro_torch.train.trainer import TrainConfig
    cfg = dataclasses.replace(get_config(RT_ARCH), n_layers=RT_LAYERS,
                              param_dtype=dtype, compute_dtype=dtype)
    pipe = PipelineConfig(distribution="prolong", max_doc_len=RT_SEQ,
                          seq_len=RT_SEQ, global_batch=RT_RANKS,
                          n_ranks=RT_RANKS, vocab_size=cfg.vocab_size,
                          seed=0)
    tc = TrainConfig(steps=RT_STEPS, peak_lr=3e-4, warmup=1, log_every=1,
                     seed=0, calibrate_every=1, fault_schedule=RT_FAULTS)
    return cfg, pipe, tc


def _rt_session(cfg, pipe, group=None, prefetch=2):
    """The calibrated session with its pool attached (so the trainer keeps
    this instance, and the hooks set on it)."""
    from repro_torch.cad import CADSession
    from repro_torch.runtime import ServerPool
    sess = CADSession.for_pipeline(cfg, pipe, group=group, calibrate=True,
                                   prefetch=prefetch)
    return sess.with_pool(ServerPool(RT_RANKS, calibrator=sess.calibrator))


def _rt_record_pulls(sess, pulls):
    """Hook ``sess.attach_plans``: each pulled plan's digest, calibration
    version, pool stats and the servers with a live task."""
    from repro_torch.cad.session import plan_digest
    from repro_torch.core.dispatch import iter_plan_tasks
    attach = sess.attach_plans

    def recording(batches):
        gen = attach(batches)
        try:
            for b in gen:
                st = b["schedule_stats"]
                pulls.append(dict(
                    digest=plan_digest(b["plan"]),
                    calib_version=st["calib_version"],
                    pool_epoch=st["pool_epoch"],
                    pool_active=st["pool_active"],
                    servers=sorted({s for s, *_ in iter_plan_tasks(
                        sess.cfg, b["plan"])})))
                yield b
        finally:
            gen.close()
    object.__setattr__(sess, "attach_plans", recording)   # frozen


def _rt_rank_run(torch, ops, info, dtype):
    """One rank's training run in ``dtype``: records each pulled plan,
    each probe's launches, gathered triples and calibrator state, each
    step's loss, parameter digest and CA launches, and the peak."""
    from repro_torch.models.model import Transformer
    from repro_torch.train.trainer import train
    cfg, pipe, tc = _rt_setup(dtype)
    sess = _rt_session(cfg, pipe, group=info.group)
    cal = sess.calibrator
    rec = dict(pulls=[], probes=[], snaps=[], probe_launches=[],
               probe_s=[], steps=[])
    fed = []
    observe_tasks = cal.observe_tasks

    def feeding(tasks, seconds, server=None):
        fed.append((list(tasks), seconds, server))
        return observe_tasks(tasks, seconds, server=server)
    cal.observe_tasks = feeding
    observe_probe = sess.observe_probe

    def probing(plan, **kw):
        before, n0 = dict(ops.launches), len(fed)
        t0 = time.perf_counter()
        observe_probe(plan, **kw)
        rec["probe_s"].append(time.perf_counter() - t0)
        rec["probe_launches"].append(
            {k: ops.launches[k] - before[k] for k in PIPE_CA})
        rec["probes"].append(fed[n0:])
        rec["snaps"].append(json.dumps(cal.state_dict(), sort_keys=True))
    object.__setattr__(sess, "observe_probe", probing)
    _rt_record_pulls(sess, rec["pulls"])
    model = Transformer(cfg, device=info.device, seed=0)
    last = dict(ops.launches)

    def on_step(step, m):
        nonlocal last
        now = dict(ops.launches)
        probe = rec["probe_launches"][step]
        rec["steps"].append(dict(
            loss=m["loss"], step_s=m["step_s"],
            launches={k: now[k] - last[k] - probe[k] for k in PIPE_CA},
            params=_bits_digest(torch, torch.cat([
                p.detach().reshape(-1).float()
                for p in model.parameters()]))))
        last = now
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    train(cfg, pipe, tc, model=model, session=sess, device=info.device,
          on_step=on_step)
    rec["train_s"] = time.perf_counter() - t0
    rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    return rec


def _rank_runtime_rank(rank, tmp):
    """Phase 30's rank ``rank`` (a process of its own, on cuda:0): the
    training run over a gloo CAD group in each of RT_DTYPES, one after
    the other.  Any error ends the spawn, and the run."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.packed_flash import ops
    from repro_torch.launch import mesh
    tmp = Path(tmp)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    info = mesh.join_group(DEVICE, backend="gloo", rank=rank,
                           world=RT_RANKS, local_rank=0,
                           init_method=f"file://{tmp / 'store'}",
                           timeout_s=300)
    try:
        recs = {}
        for dtype in RT_DTYPES:
            recs[dtype] = _rt_rank_run(torch, ops, info, dtype)
            gc.collect()
            torch.cuda.empty_cache()
        torch.save(recs, tmp / f"rank{rank}.pt")
        dist.barrier()
    finally:
        mesh.leave_group()


def _rt_oracle(torch, cfg, pipe, tc, probes):
    """The one-process trainer on the card on the same weights and
    batches, at prefetch 0, its ``observe_probe`` replaying the group's
    gathered observations in order; returns (losses, pulls)."""
    from repro_torch.models.model import Transformer
    from repro_torch.train.trainer import train
    sess = _rt_session(cfg, pipe, prefetch=0)
    replay = iter(probes)

    def replaying(plan, **kw):
        for tasks, seconds, server in next(replay):
            sess.calibrator.observe_tasks(tasks, seconds, server=server)
    object.__setattr__(sess, "observe_probe", replaying)
    pulls = []
    _rt_record_pulls(sess, pulls)
    res = train(cfg, pipe, tc, model=Transformer(cfg, device=DEVICE,
                                                 seed=0),
                session=sess, device=DEVICE)
    return [h["loss"] for h in res["history"]], pulls


def _rt_one_process_probe(torch, ops, cfg, pipe):
    """The one-process probe's CA forward launches on the step-0 plan: a
    warm-up and one a server."""
    from repro_torch.core import dispatch as D
    from repro_torch.data.pipeline import raw_batches
    sess = _rt_session(cfg, pipe, prefetch=0)
    plan = sess.plan(next(raw_batches(pipe))["segment_ids"]
                     .reshape(RT_RANKS, -1))[0]
    before = ops.launches["ca_server_fwd"]
    D.probe_plan_times(D.CADContext(cfg=sess.cfg, jmax=sess.jmax), plan,
                       n_heads=cfg.n_heads, head_dim=cfg.head_dim,
                       n_kv_heads=cfg.n_kv_heads, dtype=cfg.cdtype,
                       device=DEVICE)
    return ops.launches["ca_server_fwd"] - before


def _rt_checks(torch, parts, dtype, card):
    """One dtype's run against the one-process trainer replaying its
    observations: the checks and the numbers logged."""
    cfg, pipe, tc = _rt_setup(dtype)
    t0 = time.perf_counter()
    losses_1p, pulls_1p = _rt_oracle(torch, cfg, pipe, tc,
                                     parts[0]["probes"])
    oracle_s = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    tag = "bf16" if dtype == "bfloat16" else "f32"

    def same(key):
        return all(p[key] == parts[0][key] for p in parts)
    first = parts[0]
    losses = [x["loss"] for x in first["steps"]]
    gaps = [abs(a - b) / abs(b) for a, b in zip(losses, losses_1p)]
    want_step = {"ca_server_fwd": 2 * RT_LAYERS,
                 "ca_server_bwd_dq": RT_LAYERS,
                 "ca_server_bwd_dkv": RT_LAYERS}
    want_probe = {"ca_server_fwd": 2, "ca_server_bwd_dq": 0,
                  "ca_server_bwd_dkv": 0}
    checks = {
        f"{tag}: plan digests, calibration versions and pool stats equal "
        f"on every rank at every step": same("pulls")
        and len(first["pulls"]) == RT_STEPS,
        f"{tag}: calibrator state equal on every rank after every probe":
            same("snaps") and len(first["snaps"]) == RT_STEPS,
        f"{tag}: each rank's probe launches the CA forward 1 + 1 times":
            all(x == want_probe for p in parts
                for x in p["probe_launches"]),
        f"{tag}: from step {RT_KILL_STEP} server {RT_KILLED} serves no "
        f"task, pool epoch 1, 3 active": all(
            RT_KILLED not in x["servers"] and x["pool_epoch"] == 1
            and x["pool_active"] == RT_RANKS - 1
            for x in first["pulls"][RT_KILL_STEP:])
        and all(RT_KILLED in x["servers"]
                for x in first["pulls"][:RT_KILL_STEP]),
        f"{tag}: CA launches a rank a step {RT_LAYERS} x {{2, 1, 1}}": all(
            x["launches"] == want_step for p in parts for x in p["steps"]),
        f"{tag}: parameters bitwise equal across the ranks after every "
        f"step": len({tuple(x["params"] for x in p["steps"])
                      for p in parts}) == 1,
        f"{tag}: the one-process trainer's plan digests equal the "
        f"group's": [x["digest"] for x in pulls_1p]
        == [x["digest"] for x in first["pulls"]],
    }
    if dtype == "float32":
        checks[f"{tag}: losses within {RT_LOSS_RTOL} relative of the "
               f"one-process trainer's"] = max(gaps) <= RT_LOSS_RTOL
    else:
        checks[f"{tag}: step-0 loss bitwise the one-process trainer's"] = \
            losses[0] == losses_1p[0]
    for k in range(RT_STEPS):
        per_server = {srv: sec for _, sec, srv in first["probes"][k]}
        log(f"  {tag} step {k}: loss {losses[k]!r} (one process "
            f"{losses_1p[k]!r}, relative gap {gaps[k]!r}), calib_version "
            f"{first['pulls'][k]['calib_version']}, pool epoch "
            f"{first['pulls'][k]['pool_epoch']}, servers with tasks "
            f"{first['pulls'][k]['servers']}, probe seconds by server "
            f"{per_server}, step s by rank "
            f"{[round(p['steps'][k]['step_s'], 3) for p in parts]}, probe "
            f"s by rank {[round(p['probe_s'][k], 3) for p in parts]}")
    peaks = [round(p["peak_gib"], 3) for p in parts]
    log(f"phase 30 {tag}: peaks {peaks} GiB; train "
        f"{[round(p['train_s'], 1) for p in parts]} s by rank; one-process "
        f"trainer {oracle_s:.1f} s [{card}]")
    return checks, dict(
        losses=losses, losses_one_process=losses_1p, loss_rel_gaps=gaps,
        peak_gib=peaks, oracle_s=oracle_s,
        probe_seconds=[{srv: sec for _, sec, srv in pr}
                       for pr in first["probes"]],
        launches_per_rank_step=[[x["launches"] for x in p["steps"]]
                                for p in parts],
        probe_launches_per_rank=[p["probe_launches"] for p in parts])


def rank_runtime_phase(torch, np, ops, card):
    """Phase 30: the per-rank runtime (calibration probes and fault
    schedules under a CAD process group) on RT_RANKS gloo processes on
    the one card (gloo stages CUDA tensors through the host: its times
    are not speed figures), each a CAD rank of smollm-360m at every width
    with RT_LAYERS layers, one [1, RT_SEQ] ``prolong`` row a rank,
    ``cad``, ``balanced``, prefetch 2: RT_STEPS steps of
    ``trainer.train`` with ``calibrate=True``, ``calibrate_every=1`` and
    RT_FAULTS, in bf16 and then as an f32 copy.  Checked in each: every
    step's plan digest and calibration version equal on every rank; the
    calibrator's state equal on every rank after every probe; each
    rank's probe launches the CA forward twice (a warm-up and its own
    server's batch), the one-process probe 1 + servers times; from the
    kill on server RT_KILLED has no live task in any rank's plan, at
    pool epoch 1 with 3 active; CA launches a rank a step RT_LAYERS x {2,
    1, 1}; the parameters bitwise equal across the ranks after every
    step; the one-process trainer on the card, replaying the gathered
    observations, builds the same plan at every step; the bf16 step-0
    loss bitwise its, the f32 copy's losses within RT_LOSS_RTOL of its
    (the bf16 gaps logged).  The kernel libraries are built before the spawn: the ranks
    load them."""
    import shutil
    import tempfile
    import torch.multiprocessing as mp
    t_phase = time.perf_counter()
    log(f"phase 30: {RT_ARCH} at every width, {RT_LAYERS} of 32 layers, "
        f"{RT_RANKS} gloo ranks on the card, a [1, {RT_SEQ}] row each "
        f"(cad, balanced, prefetch 2), {RT_STEPS} steps, calibrate_every "
        f"1, {RT_FAULTS}, in {' and '.join(RT_DTYPES)}")
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_rank_runtime_"))
    t0 = time.perf_counter()
    try:
        mp.spawn(_rank_runtime_rank, args=(str(tmp),), nprocs=RT_RANKS,
                 join=True)
        parts = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
                 for r in range(RT_RANKS)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    spawn_s = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    checks, runs = {}, {}
    for dtype in RT_DTYPES:
        c, runs[dtype] = _rt_checks(torch, [p[dtype] for p in parts], dtype,
                                    card)
        checks.update(c)
    probe_1p = _rt_one_process_probe(torch, ops, *_rt_setup(RT_DTYPES[0])[:2])
    checks[f"the one-process probe launches the CA forward 1 + {RT_RANKS} "
           f"times"] = probe_1p == 1 + RT_RANKS
    seconds = time.perf_counter() - t_phase
    log(f"phase 30: spawn and the ranks' runs {spawn_s:.1f} s, phase "
        f"{seconds:.1f} s (gloo stages CUDA tensors through the host: these "
        f"times are not speed figures) [{card}]")
    for name, ok in checks.items():
        log(f"  {name}: {ok}")
    failed = [n for n, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"phase 30: failed: {failed}")
    return dict(checks=checks, runs=runs,
                one_process_probe_launches=probe_1p, spawn_s=spawn_s,
                seconds=seconds,
                note="gloo stages CUDA tensors through the host: times "
                     "are not speed figures")

# ------------------------------------------------------------ phase 31
# The sharding rules on a data x model grid: GRID_RANKS gloo processes on
# the one card as data 2 x model 2 (NCCL refuses two ranks on one
# device), each model index's data ranks a CAD group.
GRID = {"data": 2, "model": 2}
GRID_RANKS = GRID["data"] * GRID["model"]
# path: (arch, layers, tokens a data rank, bf16 steps, expert parallel);
# every width, depth cut.  (d) is a forward only: maverick's 128 experts
# of [5120, 8192] are 32 GB in bf16, 8 GB a rank, and training would need
# ~48 GB a rank for weights, gradients and f32 AdamW moments
GRID_PATHS = {
    "a": ("llama3-8b", 2, 4096, 2, False),
    "b": ("smollm-360m", 2, 4096, 2, False),
    "c": ("qwen2-moe-a2.7b", 2, 2048, 2, True),
    "d": ("llama4-maverick-400b-a17b", 1, 2048, 0, True),
    # the other layer kinds: the SSD mixer whole on every model rank, the
    # RG-LRU width split over them (rglru, rglru, local), whisper's
    # encoder and cross-attention (GRID_ENC_LAYERS encoder layers)
    "e": ("mamba2-370m", 2, 4096, 2, False),
    "f": ("recurrentgemma-9b", 3, 4096, 2, False),
    "g": ("whisper-large-v3", 2, 4096, 2, False),
    # the runtime on the grid: GRID_RUNTIME's calibration, kill and
    # checkpoints, bf16 only
    "h": ("smollm-360m", 4, 4096, 4, False),
}
GRID_TRAIN = ("a", "b", "c", "e", "f", "g")
# the paths on the colocated ``pallas`` route, a sessionless grid: mamba2
# has no attention for CAD to serve, and CAD routes none of
# recurrentgemma's layers through the CA kernels (its attention layers are
# all local: the dispatch's blockwise fallback), while ``pallas`` runs
# lru_scan and the flash kernels
GRID_PALLAS = ("e", "f")
# a path's layer kinds where the config's pattern is cut: recurrentgemma's
# first three layers; the f32 copies' depth where it is not the bf16
# run's: (f) at 2 layers (rglru, rglru)
GRID_PATTERNS = {"f": ("rglru", "rglru", "local")}
GRID_F32_LAYERS = {"f": 2}
GRID_ENC_LAYERS = 2
GRID_MEMORY_SEED = 1
GRID_RUNTIME = dict(calibrate_every=1, fault_schedule="kill:1@2",
                    ckpt_every=2)
# whose layer-0 CA batches (the last model rank's heads, both data ranks'
# servers) are timed: PERF.md rows 4g/5g, 4p/5p and 4h/5h
GRID_TIMED = {"a": "4g/5g", "b": "4p/5p", "g": "4h/5h"}
GRID_DTYPES = ("bfloat16", "float32")
# the f32 copy's step-0 loss and gradient norm against the one-process
# trainer's on the same weights and batch, relative.  The grid sums each
# partial product (heads, FFN columns, vocab shards, expert width) over
# the model ranks, another order than one process's.  Measured on one
# H100 (NVIDIA H100 80GB HBM3, 700 W), FSDP storage: the worst gap 1.81e-7
# ((f)'s grad norm; (c)'s loss 7.65e-8, (e)'s grad norm 1.22e-7, the rest
# 0); the required controls' smallest 5.22e-6 ((e)'s resets dropped;
# (g)'s documents merged 2.55e-5, (f)'s resets dropped 4.29e-5)
GRID_F32_LIMIT = 1e-6
# the control each path's f32 step-0 loss must lie outside GRID_F32_LIMIT
# of: the one-process forward with its fault put in.  "documents merged"
# moves no recurrent mixer: the pipeline's documents are separated by
# padding (segment 0), whose edges reset the state all the same
GRID_RESETS_DROPPED = "document resets dropped"
GRID_REQUIRED_CONTROLS = {"a": "no causal mask", "b": "no causal mask",
                          "c": "no causal mask", "e": GRID_RESETS_DROPPED,
                          "f": GRID_RESETS_DROPPED, "g": "documents merged"}
# tokens of each rank's logits (its vocab shard) held against the
# one-process forward's in (d)
GRID_LOGIT_TOKENS = 64
# (d) in bf16 against the one-process forward on the same weights and
# batch: the loss's relative gap, and each rank's logit slice's max |diff|
# over the one-process slices' max |logit|.  Each control breaks the
# expert-parallel layer on every rank; the required one must fall outside.
# Measured on one H100 (NVIDIA H100 80GB HBM3, 700 W): loss 1.03e-4,
# logits <= 8.2e-3 (0.046875 of 5.75: 1.5 bf16 steps); the control
# "return exchange reversed" 5.34e-4 and >= 0.838
GRID_D_LOSS_LIMIT = 1.5e-4
GRID_D_LOGIT_LIMIT = 1e-2
GRID_D_CONTROLS = ("return exchange reversed", "shared expert dropped")
GRID_D_REQUIRED = ("return exchange reversed",)
# The expert-parallel routing against one process's: the router's inputs
# differ in their last bits (the matmuls run at other shapes, and past
# layer 0 the model ranks' partial sums add in another order), so a
# choice may flip where two experts' probabilities are within rounding of
# each other.  Every choice must be equal but at such a near-tie: the
# one-process probabilities of the two experts within this fraction of
# the larger.  Set just above the worst flipped pair measured on one H100
# (NVIDIA H100 80GB HBM3, 700 W): f32 3.0e-7 ((c), layer 1); bf16 at
# layer 0 1.5504e-2 ((c)) and 1.5504e-2 ((d)), under the rounding
# estimate (bf16 logits keep 8 significant bits: 2 steps of 2**-7 move a
# pair's gap by up to 2**-6 of the logit, ~1.6e-2 of the probability)
GRID_NEAR_TIE = {"float32": 5e-7, "bfloat16": 2e-2}
GRID_CA = ("ca_server_fwd", "ca_server_bwd_dq", "ca_server_bwd_dkv")
# the ranks' caching-allocator setting (set for the spawn alone)
GRID_ALLOC_ENV = "PYTORCH_CUDA_ALLOC_CONF"
GRID_FLASH = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
              "flash_tile_ranges")


def _grid_setup(path, dtype="bfloat16"):
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import PipelineConfig
    from repro_torch.models.model import has_encoder
    from repro_torch.train.trainer import TrainConfig
    arch, layers, seq, steps, ep = GRID_PATHS[path]
    if dtype == "float32":
        layers = GRID_F32_LAYERS.get(path, layers)
    cfg = get_config(arch)
    moe = cfg.moe and dataclasses.replace(cfg.moe, expert_parallel=ep)
    enc = cfg.encoder
    if has_encoder(cfg):
        enc = dataclasses.replace(enc, n_layers=GRID_ENC_LAYERS)
    pattern = GRID_PATTERNS.get(path, cfg.layer_pattern)[:layers]
    cfg = dataclasses.replace(cfg, n_layers=layers, moe=moe, encoder=enc,
                              layer_pattern=pattern, param_dtype=dtype,
                              compute_dtype=dtype)
    pipe = PipelineConfig(distribution="prolong", max_doc_len=seq,
                          seq_len=seq, global_batch=GRID["data"],
                          n_ranks=GRID["data"], vocab_size=cfg.vocab_size,
                          seed=0)
    tc = TrainConfig(steps=steps if dtype == "bfloat16" else 1,
                     peak_lr=3e-4, warmup=1, log_every=1, seed=0)
    return cfg, pipe, tc


def _grid_fill(torch, model, seed, coords=None):
    """Fill ``model``'s parameters (whole, or a grid rank's shards after
    ``shard_model``) with seeded values that do not depend on the grid:
    a tensor is the shard of one drawn whole from a generator seeded by
    (seed, its name), an expert tensor's expert e of one drawn from (seed,
    its name, e), each times fan_in**-0.5 as ``dense_init`` draws; norm
    scales are ones.  A rank draws at most one non-expert tensor or one
    expert's matrix whole at a time, so maverick's ranks never hold its
    32 GB of experts."""
    import zlib
    from repro_torch.models.convert import shard_params
    placed = getattr(model, "grid_placements", {})
    gen = torch.Generator(device=model.device)

    def draw(name, key, shape, dtype, axes):
        gen.manual_seed(seed * 1_000_003 + key)
        fan = shape[-1] if name.endswith("embed") else shape[-2]
        w = torch.randn(shape, generator=gen, dtype=dtype,
                        device=model.device).mul_(fan ** -0.5)
        return shard_params({"w": w}, {"w": axes}, coords, GRID)["w"]

    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(".scale"):
                p.fill_(1)
                continue
            axes = placed.get(name, (None,) * p.dim())
            shape = [n * (GRID[a] if a else 1) for n, a in
                     zip(p.shape, (a if not isinstance(a, tuple) else
                                   a[0] for a in axes))]
            key = zlib.crc32(name.encode())
            if ".experts_" not in name:
                p.copy_(draw(name, key, shape, p.dtype, axes))
                continue
            lo = coords["data"] * p.shape[0] if axes[0] else 0
            for j in range(p.shape[0]):
                p[j].copy_(draw(name, key + 7919 * (lo + j), shape[1:],
                                p.dtype, axes[1:]))


def _grid_replicated_digest(torch, model):
    """One digest of the tensors every data rank holds, for the bitwise
    check across data ranks: all but the FSDP shards and the
    expert-parallel experts, which are held once (gathered over the data
    ranks, a shard is the same tensor on each by construction)."""
    import hashlib
    from repro_torch.parallel import sharded_over
    h = hashlib.sha1()
    for n, p in model.named_parameters():
        if "data" not in sharded_over(model.grid_placements[n]):
            h.update(_bits_digest(torch, p.reshape(-1)).encode())
    return h.hexdigest()


def _grid_storage(torch, model, opt_state=None):
    """This rank's stored parameter (and AdamW moment) bytes, and what the
    placements' shard sizes of the whole model's tensors add up to."""
    from repro_torch.models.convert import shard_shape
    from repro_torch.models.model import Transformer
    full = {n: p.shape for n, p in
            Transformer(model.cfg, device="meta").named_parameters()}
    shards = {n: math.prod(shard_shape(full[n], model.grid_placements[n],
                                       GRID)) for n in full}
    out = dict(
        param_bytes=sum(p.numel() * p.element_size()
                        for p in model.parameters()),
        param_bytes_placed=sum(shards[n] * p.element_size()
                               for n, p in model.named_parameters()))
    if opt_state is not None:
        out.update(moment_bytes=sum(t.numel() * t.element_size() for t in
                                    list(opt_state.mu) + list(opt_state.nu)),
                   moment_bytes_placed=2 * 4 * sum(shards.values()))
    return out


def _grid_counts(ops, ssd, rg):
    """Every kernel's launch count, by name."""
    return dict(ops.launches, **ssd.launches, **rg.launches)


def _grid_record_routing(L, rec, n_layers, probs_too=False):
    """Wrap the MoE's top-k and slot table so that the first ``n_layers``
    calls of each (step 0's forward) land in ``rec``: under "routing" the
    expert ids of this rank's tokens (with ``probs_too`` the router's
    probabilities too), under "slots" the expert ids the slot table was
    derived from (under expert parallelism every data rank's, gathered)
    and the capacity; returns the undo."""
    top_k, slot_table = L._top_k, L._slot_table
    rec.update(routing=[], slots=[])

    def recording(probs, k):
        vals, idx = top_k(probs, k)
        if len(rec["routing"]) < n_layers:
            # detached: a copy that kept its autograd graph would keep the
            # whole model's weights alive
            rec["routing"].append((idx.cpu(), probs.detach().float().cpu()
                                   if probs_too else None))
        return vals, idx

    def recording_slots(flat_e, n_e, cap):
        if len(rec["slots"]) < n_layers:
            rec["slots"].append((flat_e.cpu(), cap))
        return slot_table(flat_e, n_e, cap)
    L._top_k, L._slot_table = recording, recording_slots

    def undo():
        L._top_k, L._slot_table = top_k, slot_table
    return undo


def _grid_colocated(torch, ops, grid, model, cfg, pipe):
    """Path (a)'s colocated ``pallas`` route on the grid at the step-0
    weights: one forward and backward of the loss on the step-0 batch,
    every rank's flash kernels on its heads; returns (the global loss,
    this rank's flash launches)."""
    import torch.distributed as dist
    from repro_torch.data.pipeline import (global_token_count, raw_batches,
                                           rank_rows)
    from repro_torch.parallel import ParallelContext, make_rules
    from repro_torch.train.loss import grid_nll_sum
    from repro_torch.train.step import batch_to_device
    gen = raw_batches(pipe)
    raw = next(gen)
    gen.close()
    b = batch_to_device(rank_rows(raw, grid.data_index, GRID["data"]),
                        grid.device)
    ctx = ParallelContext(attn_impl="pallas", remat=True,
                          group=grid.data_group,
                          model_group=grid.model_group,
                          rules=make_rules(grid.sizes, cfg))
    before = dict(ops.launches)
    logits, aux = model(b, ctx)
    loss = grid_nll_sum(logits, b["labels"], b["segment_ids"], ctx) \
        / torch.as_tensor(global_token_count(raw), device=grid.device)
    del logits
    torch.autograd.grad(loss + sum(aux.values(), torch.zeros_like(loss)),
                        list(model.parameters()))
    loss = loss.detach()
    dist.all_reduce(loss)
    return float(loss), {k: ops.launches[k] - before[k] for k in GRID_FLASH}


def _grid_capture_rank(path, grid):
    """Whether this rank keeps step 0's kernel inputs of ``path``: for the
    CA timings both data ranks' servers on the last model rank; for the
    SSD, lru_scan and flash checks one rank."""
    last = grid.model_index == GRID["model"] - 1
    return last and (path in GRID_TIMED
                     or (path in GRID_PALLAS and grid.data_index == 0))


def _grid_rank_train(torch, ops, ssd, rg, grid, path, dtype, tmp):
    """One rank's training run of ``path`` in ``dtype`` on the grid:
    each step's loss, grad norm, kernel launches, step seconds and digest
    of the tensors every data rank holds, each pulled plan's digest (CAD
    paths), step 0's routing, the stored bytes and peak
    memory; path (a) in bf16 also runs the colocated route first, and in
    bf16 the capturing ranks save their layer-0 kernel inputs (the local
    layer's too on (f))."""
    from repro_torch.cad import CADSession
    from repro_torch.models import layers as L
    from repro_torch.models.convert import shard_model
    from repro_torch.models.model import Transformer, needs_memory
    from repro_torch.parallel import ParallelContext
    from repro_torch.train.trainer import train
    cfg, pipe, tc = _grid_setup(path, dtype)
    sess = None
    rec = dict(plan_digests=[], steps=[])
    if path not in GRID_PALLAS:
        sess = CADSession.for_pipeline(cfg, pipe, grid=grid, prefetch=2)
        attach = sess.attach_plans

        def recording(batches):
            gen = attach(batches)
            try:
                for b in gen:
                    rec["plan_digests"].append(b["plan_digest"])
                    yield b
            finally:
                gen.close()
        object.__setattr__(sess, "attach_plans", recording)    # frozen
    model = Transformer(cfg, device=grid.device, seed=0)
    memory = None
    if needs_memory(cfg):
        _open_gates(torch, model)
        memory = _cross_memory(torch, cfg, GRID["data"], GRID_MEMORY_SEED)
    shard_model(model, grid.sizes, {"data": grid.data_index,
                                    "model": grid.model_index})
    if path == "a" and dtype == "bfloat16":
        rec["colocated"] = _grid_colocated(torch, ops, grid, model, cfg,
                                           pipe)
    captured = {}
    if dtype == "bfloat16" and _grid_capture_rank(path, grid):
        local = [i for i in range(cfg.n_layers)
                 if cfg.layer_pattern[i % cfg.period] == "local"]
        want = [0] + local[:1]

        def capture(layer, inputs):
            if layer not in want or layer in captured:
                return
            if "ctx" in inputs and inputs["ctx"].cad is not None:
                cad = inputs["ctx"].cad
                plan = type(cad.plan)(**{k: v.cpu()
                                         for k, v in cad.plan.items()})
                captured[layer] = dict(
                    {k: inputs[k].detach().cpu() for k in
                     ("q", "k", "v", "segment_ids", "positions")},
                    cad=dataclasses.replace(cad, plan=plan))
            else:
                captured[layer] = {k: v.detach().cpu() for k, v in
                                   inputs.items() if torch.is_tensor(v)}
        model.attn_hook = capture
    undo = _grid_record_routing(L, rec, cfg.n_layers)
    last = _grid_counts(ops, ssd, rg)

    def on_step(step, m):
        now = _grid_counts(ops, ssd, rg)
        rec["steps"].append(dict(
            loss=m["loss"], total=m["total_loss"], gnorm=m["grad_norm"],
            step_s=m["step_s"],
            launches={k: now[k] - last[k] for k in now if now[k] > last[k]},
            params=_grid_replicated_digest(torch, model)))
        last.update(now)
        model.attn_hook = None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ctx = ParallelContext(attn_impl="pallas", remat=True) \
        if sess is None else None
    try:
        res = train(cfg, pipe, tc, model=model, session=sess, ctx=ctx,
                    grid=grid if sess is None else None, memory=memory,
                    device=grid.device, on_step=on_step)
    finally:
        undo()
    rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    rec["storage"] = _grid_storage(torch, model, res["opt_state"])
    if captured:
        torch.save(captured, tmp / f"capture_{path}_d{grid.data_index}.pt")
    return rec


def _grid_rank_forward(torch, ops, grid):
    """Path (d) on one rank: maverick's layer built as this rank's shards
    (``_grid_fill``) and one ``cad`` forward of the step-0 batch: the
    global loss, the layer's routing on this rank's tokens, its logits on
    the first GRID_LOGIT_TOKENS tokens (its vocab shard), CA launches,
    seconds and peak memory."""
    import torch.distributed as dist
    from repro_torch.cad import CADSession
    from repro_torch.data.pipeline import raw_batches
    from repro_torch.models import layers as L
    from repro_torch.models.convert import shard_model
    from repro_torch.models.model import Transformer
    from repro_torch.train.loss import grid_nll_sum
    from repro_torch.train.step import batch_to_device
    cfg, pipe, _ = _grid_setup("d")
    coords = {"data": grid.data_index, "model": grid.model_index}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Transformer(cfg, device="meta")
    shard_model(model, grid.sizes, coords)
    model.to_empty(device=grid.device)
    _grid_fill(torch, model, 0, coords)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    sess = CADSession.for_pipeline(cfg, pipe, grid=grid, prefetch=0)
    gen = sess.attach_plans(raw_batches(pipe))
    batch = next(gen)
    gen.close()
    b = batch_to_device(batch, grid.device)
    ctx = sess.context(remat=False)
    ctx = ctx.cad.bind_plan(ctx, b["plan"])
    rec = dict(plan_digest=batch["plan_digest"], build_s=build_s)
    def forward():
        with torch.no_grad():
            logits, _ = model(b, ctx)
            nll = grid_nll_sum(logits, b["labels"], b["segment_ids"], ctx)
            dist.all_reduce(nll)
        return (float(nll) / int(batch["n_tokens_global"]),
                logits[0, :GRID_LOGIT_TOKENS].cpu())

    undo = _grid_record_routing(L, rec, cfg.n_layers)
    before = dict(ops.launches)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        loss, logits = forward()
    finally:
        undo()
    torch.cuda.synchronize()
    rec.update(forward_s=time.perf_counter() - t0,
               launches={k: ops.launches[k] - before[k] for k in GRID_CA},
               loss=loss, logits=logits,
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               storage=_grid_storage(torch, model), controls={})
    for name in GRID_D_CONTROLS:
        undo = _grid_d_control(torch, L, name)
        try:
            rec["controls"][name] = forward()
        finally:
            undo()
    return rec


def _grid_d_control(torch, L, name):
    """Break the expert-parallel MoE layer as control ``name`` says: the
    rows that come back from the experts' ranks reversed (each token
    combines other tokens' expert outputs), or the shared expert's output
    zero.  Returns the undo."""
    if name == "return exchange reversed":
        S, orig = L.S, L.S.exchange_rows
        calls = [0]

        def exchange(x, send, recv, group):
            out = orig(x, send, recv, group)
            calls[0] += 1
            return out.flip(0) if calls[0] % 2 == 0 else out
        S.exchange_rows = exchange
        return lambda: setattr(S, "exchange_rows", orig)
    assert name == "shared expert dropped", name
    mlp = L._mlp
    L._mlp = lambda p, x, act: torch.zeros_like(x)
    return lambda: setattr(L, "_mlp", mlp)


def _grid_rank_runtime(torch, ops, grid, tmp):
    """Path (h) on one rank: GRID_RUNTIME's calibration, kill and
    checkpoints under a grid session (prefetch 2, a pool attached first):
    each pulled plan's digest, the observations fed to the calibrator by
    probe and a digest of its state after each, the pool epoch, loss and
    CA launches by step, the parameters gathered whole after the
    checkpointed step (rank 0 saves them), the stored bytes and the
    peak."""
    import hashlib
    from repro_torch.cad import CADSession
    from repro_torch.models.convert import gather_shard
    from repro_torch.models.model import Transformer
    from repro_torch.runtime import ServerPool
    from repro_torch.train.trainer import train
    cfg, pipe, tc = _grid_setup("h")
    tc = dataclasses.replace(tc, ckpt_dir=str(tmp / "ckpt"), **GRID_RUNTIME)
    sess = CADSession.for_pipeline(cfg, pipe, grid=grid, calibrate=True,
                                   prefetch=2)
    sess = sess.with_pool(ServerPool(GRID["data"],
                                     calibrator=sess.calibrator))
    cal = sess.calibrator
    rec = dict(plan_digests=[], probes=[], states=[], steps=[])
    fed = []
    observe_tasks = cal.observe_tasks

    def feeding(tasks, seconds, server=None):
        fed.append(([tuple(t) for t in tasks], seconds, server))
        return observe_tasks(tasks, seconds, server=server)
    cal.observe_tasks = feeding
    observe_probe = sess.observe_probe

    def probing(plan, **kw):
        n0 = len(fed)
        observe_probe(plan, **kw)
        rec["probes"].append(fed[n0:])
        rec["states"].append(hashlib.sha1(json.dumps(
            cal.state_dict(), sort_keys=True).encode()).hexdigest())
    attach = sess.attach_plans

    def recording(batches):
        gen = attach(batches)
        try:
            for b in gen:
                rec["plan_digests"].append(b["plan_digest"])
                yield b
        finally:
            gen.close()
    object.__setattr__(sess, "observe_probe", probing)      # frozen
    object.__setattr__(sess, "attach_plans", recording)
    model = Transformer(cfg, device=grid.device, seed=0)
    last = dict(ops.launches)

    def on_step(step, m):
        now = dict(ops.launches)
        rec["steps"].append(dict(
            loss=m["loss"], epoch=m["sched_pool_epoch"],
            active=m["sched_pool_active"],
            launches={k: now[k] - last[k] for k in GRID_CA}))
        last.update(now)
        if step == GRID_RUNTIME["ckpt_every"]:
            groups = {"data": grid.data_group, "model": grid.model_group}
            whole = {n: gather_shard(p.detach(), model.grid_placements[n],
                                     groups).cpu()
                     for n, p in model.named_parameters()}
            if grid.rank == 0:
                torch.save(whole, tmp / "h_params.pt")
            del whole
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    res = train(cfg, pipe, tc, model=model, session=sess,
                device=grid.device, on_step=on_step)
    rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    rec["storage"] = _grid_storage(torch, model, res["opt_state"])
    return rec


def _grid_rank(rank, tmp):
    """Phase 31's rank ``rank`` (a process of its own, on cuda:0): the
    training paths in each of GRID_DTYPES, the maverick forward, then the
    runtime path (h), on a data x model grid over gloo.  Any error ends
    the spawn, and the run."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.packed_flash import ops
    from repro_torch.kernels.rglru import ops as rg
    from repro_torch.kernels.ssd import ops as ssd
    from repro_torch.launch import mesh
    tmp = Path(tmp)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    grid = mesh.join_grid(GRID["data"], GRID["model"], DEVICE,
                          backend="gloo", rank=rank, world=GRID_RANKS,
                          local_rank=0, init_method=f"file://{tmp / 'store'}",
                          timeout_s=300)
    try:
        recs = {}
        for path in GRID_TRAIN:
            for dtype in GRID_DTYPES:
                t0 = time.perf_counter()
                recs[path, dtype] = _grid_rank_train(
                    torch, ops, ssd, rg, grid, path, dtype, tmp)
                recs[path, dtype]["seconds"] = time.perf_counter() - t0
                gc.collect()
                torch.cuda.empty_cache()
        recs["d"] = _grid_rank_forward(torch, ops, grid)
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        recs["h"] = _grid_rank_runtime(torch, ops, grid, tmp)
        recs["h"]["seconds"] = time.perf_counter() - t0
        torch.save(recs, tmp / f"rank{rank}.pt")
        dist.barrier()
    finally:
        mesh.leave_group()


def _grid_one_process(torch, ops, path, dtype):
    """The one-process trainer on the card on the same weights and batches
    (2 simulated servers, or the ``pallas`` route for GRID_PALLAS): each
    step's loss and grad norm, step 0's routing; in f32 also the
    controls' step-0 losses on the same weights (plan-free forwards: the
    ``pallas`` route, ``xla`` where a memory is read; the plain forward,
    documents merged into one a row, for (e)-(g) the layers given one
    document a row (no document resets; the loss keeps its mask), and
    for the attention paths attention without the causal mask)."""
    from repro_torch.cad import CADSession
    from repro_torch.data.pipeline import raw_batches
    from repro_torch.models import layers as L
    from repro_torch.models.model import Transformer, needs_memory
    from repro_torch.parallel import ParallelContext
    from repro_torch.train.loss import lm_loss
    from repro_torch.train.step import batch_to_device
    from repro_torch.train.trainer import train
    cfg, pipe, tc = _grid_setup(path, dtype)
    model = Transformer(cfg, device=DEVICE, seed=0)
    memory = None
    if needs_memory(cfg):
        _open_gates(torch, model)
        memory = _cross_memory(torch, cfg, GRID["data"], GRID_MEMORY_SEED)
    rec = dict(controls={})
    if dtype == "float32":
        gen = raw_batches(pipe)
        batch = batch_to_device(dict(next(gen), memory=memory), DEVICE)
        gen.close()
        impl = "xla" if memory is not None else "pallas"
        ctx = ParallelContext(attn_impl=impl, remat=False)
        rec["controls"] = {
            f"none (forward only, {impl})": _step0_loss(torch, model, ctx,
                                                        batch),
            "documents merged": _step0_loss(torch, model, ctx, dict(
                batch, segment_ids=(batch["segment_ids"] > 0)
                .to(torch.int32)))}
        if path in ("e", "f", "g"):
            # the layers see one document a row, the loss the real mask
            with torch.no_grad():
                logits, _ = model(dict(batch, segment_ids=torch.ones_like(
                    batch["segment_ids"])), ctx)
                rec["controls"][GRID_RESETS_DROPPED] = float(lm_loss(
                    logits, batch["labels"], batch["segment_ids"])[0])
            del logits
        if GRID_REQUIRED_CONTROLS[path] == "no causal mask":
            orig = ops.packed_flash_attention
            ops.packed_flash_attention = \
                lambda *a, **kw: orig(*a, **dict(kw, causal=False))
            try:
                rec["controls"]["no causal mask"] = _step0_loss(
                    torch, model, ctx, batch)
            finally:
                ops.packed_flash_attention = orig
    undo = _grid_record_routing(L, rec, cfg.n_layers, probs_too=True)
    sess = ctx = None
    if path in GRID_PALLAS:
        ctx = ParallelContext(attn_impl="pallas", remat=True)
    else:
        sess = CADSession.for_pipeline(cfg, pipe, prefetch=2)
    try:
        res = train(cfg, pipe, tc, model=model, device=DEVICE, ctx=ctx,
                    session=sess, memory=memory)
    finally:
        undo()
    rec["steps"] = [dict(loss=h["loss"], total=h["total_loss"],
                         gnorm=h["grad_norm"], step_s=h["step_s"])
                    for h in res["history"]]
    del res, model
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def _grid_one_process_forward(torch, ops):
    """Path (d) in one process: maverick's layer whole (32 GB of
    experts), the same seeded values as the ranks' shards, one ``cad``
    forward over 2 simulated servers: the loss, the routing, and each
    rank's logit slice (its rows' first GRID_LOGIT_TOKENS tokens, its
    vocab shard)."""
    from repro_torch.cad import CADSession
    from repro_torch.data.pipeline import raw_batches
    from repro_torch.models import layers as L
    from repro_torch.models.model import Transformer
    from repro_torch.train.loss import lm_loss
    from repro_torch.train.step import batch_to_device
    cfg, pipe, _ = _grid_setup("d")
    t0 = time.perf_counter()
    model = Transformer(cfg, device="meta")
    model.to_empty(device=DEVICE)
    _grid_fill(torch, model, 0)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    sess = CADSession.for_pipeline(cfg, pipe, prefetch=0)
    gen = sess.attach_plans(raw_batches(pipe))
    batch = next(gen)
    gen.close()
    b = batch_to_device(batch, DEVICE)
    ctx = sess.context(remat=False)
    ctx = ctx.cad.bind_plan(ctx, b["plan"])
    rec = dict(build_s=build_s)
    undo = _grid_record_routing(L, rec, cfg.n_layers, probs_too=True)
    before = dict(ops.launches)
    try:
        with torch.no_grad():
            logits, _ = model(b, ctx)
            loss = lm_loss(logits, b["labels"], b["segment_ids"])[0]
    finally:
        undo()
    v = cfg.vocab_size // GRID["model"]
    rec.update(loss=float(loss),
               launches={k: ops.launches[k] - before[k] for k in GRID_CA},
               logits={(d, m): logits[d, :GRID_LOGIT_TOKENS,
                                      m * v:(m + 1) * v].cpu()
                       for d in range(GRID["data"])
                       for m in range(GRID["model"])})
    del model, logits, b, ctx
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def _grid_rank_tokens(x, d, m):
    """Rank (d, m)'s tokens of a one-process ``[rows * S, ...]`` array:
    data rank d's row, model rank m's sequence shard."""
    rows = x.reshape((GRID["data"], -1) + tuple(x.shape[1:]))[d]
    n = rows.shape[0] // GRID["model"]
    return rows[m * n:(m + 1) * n]


def _grid_routing_equal(torch, parts, want, near_tie):
    """Each rank's step-0 expert ids against the one-process run's on its
    tokens, layer by layer: every choice equal but where the one-process
    probabilities of its expert and the rank's are within ``near_tie`` of
    the larger.  Returns (so, differing choices by layer, differing ones
    not at a near-tie, the largest relative gap of a differing pair by
    layer)."""
    differ = [0] * len(want)
    worst = [0.0] * len(want)
    far = 0
    for r, part in enumerate(parts):
        d, m = divmod(r, GRID["model"])
        for li, ((got, _), (w_idx, w_probs)) in enumerate(zip(part, want)):
            w_idx = _grid_rank_tokens(w_idx, d, m)
            w_probs = _grid_rank_tokens(w_probs, d, m)
            tok, j = torch.nonzero(got != w_idx, as_tuple=True)
            differ[li] += int(tok.numel())
            if not tok.numel():
                continue
            pa = w_probs[tok, w_idx[tok, j]]
            pb = w_probs[tok, got[tok, j]]
            gap = (pa - pb).abs() / torch.maximum(pa, pb)
            far += int((gap > near_tie).sum())
            worst[li] = max(worst[li], float(gap.max()))
    n = len(want)
    ok = all(len(p) == n for p in parts) and far == 0
    return ok, differ, far, worst


def _grid_slots_global(recs, one, differ):
    """Every rank derived its slot tables from the global token order and
    capacity: at each layer the same capacity as one process, the same
    number of expert ids, equal to one process's but at the choices that
    flipped on some rank (``differ``, counted over all the ranks)."""
    return all(
        len(r["slots"]) == len(one["slots"]) and all(
            cap == w_cap and ids.shape == w_ids.shape
            and int((ids != w_ids).sum()) == n
            for (ids, cap), (w_ids, w_cap), n in zip(
                r["slots"], one["slots"], differ))
        for r in recs)


def _grid_capture(torch, path):
    """The captured layer-0 attention inputs of both data ranks (the last
    model rank's heads), rows put together, as ``captured_batches``
    takes them."""
    from repro_torch.parallel import ParallelContext
    caps = [torch.load(path.parent / f"{path.name}_d{d}.pt",
                       weights_only=False)[0] for d in range(GRID["data"])]
    inp = {k: torch.cat([c[k] for c in caps]).to(DEVICE)
           for k in ("q", "k", "v", "segment_ids", "positions")}
    cad = caps[0]["cad"]
    inp["ctx"] = ParallelContext(attn_impl="cad", cad=dataclasses.replace(
        cad, plan=cad.plan.to(DEVICE)))
    return inp


def _grid_pallas_kernels(torch, ops, ssd, rg, tmp, card):
    """The kernels of the ``pallas`` paths on the inputs one rank (data 0,
    the last model rank) captured at step 0: (e)'s SSD kernels at full
    width on layer 0 (bf16, phase 11's rules, the backward repeated
    bitwise), (f)'s lru_scan on layer 0's a and bterm (this rank's
    channels; bitwise, as in phase 2) and its flash kernels on the local
    layer's q/k/v (this rank's heads, window 2048).  Returns the checks
    and the numbers."""
    from repro_torch.configs import get_config
    checks, out = {}, {}
    cap = {path: {k: {n: v.to(DEVICE) for n, v in layer.items()}
                  for k, layer in torch.load(
                      tmp / f"capture_{path}_d0.pt", weights_only=False)
                  .items()} for path in GRID_PALLAS}
    args, dy, dstate = _ssd_args(torch, cap["e"][0], 31)
    r = check_ssd_pair(torch, ssd, args, dy, dstate, scaled=True)
    runs = [ssd.ssd_chunk_bwd(*args, dy, dstate) for _ in range(2)]
    again = all(torch.equal(a, b) for a, b in zip(*runs))
    checks["(e) SSD kernels against their plain versions on a rank's "
           "layer-0 inputs (full width), backward bitwise on repeat"] = \
        r["ok"] and again
    out["e"] = dict(fwd=r["fwd"], grad=r["grad"], ratio=r["ratio"],
                    shape=f"C {tuple(args[0].shape)}, x "
                          f"{tuple(args[2].shape)} {args[2].dtype}")
    log(f"  (e) captured layer 0: {out['e']['shape']}: y/states max |err| "
        f"{r['fwd']:.3e}, grads {r['grad']:.3e} (worst ratio "
        f"{r['ratio'][0]:.3e}), backward repeated bitwise {again}")
    a = cap["f"][0]["a"].contiguous()
    b = cap["f"][0]["bterm"].contiguous()
    g = torch.randn(a.shape, generator=torch.Generator(
        device=DEVICE).manual_seed(31), device=DEVICE)
    e_f, e_b, bitwise, ok = check_lru_pair(torch, rg, a, b, g)
    checks[f"(f) lru_scan against its plain versions on a rank's layer-0 "
           f"a/bterm ({a.shape[-1]} channels), bitwise"] = ok and bitwise \
        and a.shape[-1] == get_config("recurrentgemma-9b").rglru.lru_width \
        // GRID["model"]
    out["f_lru"] = dict(fwd=e_f, grad=e_b, bitwise=bitwise,
                        shape=f"a/bterm {tuple(a.shape)} f32")
    log(f"  (f) captured rglru layer 0: a/bterm {tuple(a.shape)}: h max "
        f"|err| {e_f:.3e}, grads {e_b:.3e}, bitwise {bitwise}")
    (layer, inp), = [(k, v) for k, v in cap["f"].items() if k]
    fargs = flash_inputs(torch, inp)
    opts = dict(window=get_config("recurrentgemma-9b").window)
    do = torch.randn(fargs[0].shape, generator=torch.Generator(
        device=DEVICE).manual_seed(32), device=DEVICE).to(fargs[0].dtype)
    e_f, e_b, ok = check_flash_pair(torch, ops, fargs, opts, do)
    checks["(f) flash kernels against their plain versions on a rank's "
           "local-layer q/k/v"] = ok
    out["f_flash"] = dict(fwd=e_f, grad=e_b,
                          shape=f"layer {layer}: q {tuple(fargs[0].shape)}, "
                                f"k/v {tuple(fargs[1].shape)} "
                                f"{fargs[0].dtype}, window {opts['window']}")
    log(f"  (f) captured local {out['f_flash']['shape']}: fwd max |err| "
        f"{e_f:.3e}, grads {e_b:.3e} [{card}]")
    return checks, out


def _grid_runtime_checks(torch, parts, tmp, card):
    """Path (h): plan digests, calibrator states, probe observations and
    pool epochs equal on every rank at every step; the one-process
    trainer on the card under the same schedule, its probes replaced by
    the grid's gathered observations in order, pulls the grid's plans;
    rank 0's checkpoint restores into a one-process ``Transformer`` and
    its AdamW state, the parameters bitwise the grid's gathered ones."""
    from repro_torch.cad import CADSession
    from repro_torch.cad.session import plan_digest
    from repro_torch.checkpoint import ckpt
    from repro_torch.models.model import Transformer
    from repro_torch.optim.adamw import AdamW
    from repro_torch.runtime import ServerPool
    from repro_torch.train.trainer import train
    recs = [p["h"] for p in parts]
    cfg, pipe, tc = _grid_setup("h")
    steps = tc.steps
    checks = {}
    for key in ("plan_digests", "states", "probes"):
        checks[f"(h) {key.replace('_', ' ')} equal on all {GRID_RANKS} "
               f"ranks at every step"] = len(recs[0][key]) == steps and all(
            r[key] == recs[0][key] for r in recs)
    kill = int(GRID_RUNTIME["fault_schedule"].rsplit("@", 1)[1])
    checks["(h) stored parameter and moment bytes a rank the placements' "
           "shard sizes"] = all(_grid_stored_as_placed(r["storage"])
                                for r in recs)
    checks[f"(h) every rank at pool epoch 1 with 1 active server from step "
           f"{kill} on"] = all(
        [(s["epoch"], s["active"]) for s in r["steps"]]
        == [(0.0, 2.0)] * kill + [(1.0, 1.0)] * (steps - kill)
        for r in recs)
    n = cfg.n_layers
    for r_i, r in enumerate(recs):
        probe = 2 if r_i % GRID["model"] == 0 else 0
        want = {"ca_server_fwd": 2 * n + probe, "ca_server_bwd_dq": n,
                "ca_server_bwd_dkv": n}
        checks.setdefault(f"(h) CA launches a rank a step {n} x {{2, 1, 1}}"
                          f", and 2 probe forwards on model index 0", True)
        if any(s["launches"] != want for s in r["steps"]):
            checks[f"(h) CA launches a rank a step {n} x {{2, 1, 1}}, and "
                   f"2 probe forwards on model index 0"] = False
    sess = CADSession.for_pipeline(cfg, pipe, calibrate=True, prefetch=0)
    sess = sess.with_pool(ServerPool(GRID["data"],
                                     calibrator=sess.calibrator))
    replay = iter(recs[0]["probes"])

    def replaying(plan, **kw):
        for tasks, seconds, server in next(replay):
            sess.calibrator.observe_tasks(tasks, seconds, server=server)
    pulls = []
    attach = sess.attach_plans

    def recording(batches):
        gen = attach(batches)
        try:
            for b in gen:
                pulls.append(plan_digest(b["plan"]))
                yield b
        finally:
            gen.close()
    object.__setattr__(sess, "observe_probe", replaying)     # frozen
    object.__setattr__(sess, "attach_plans", recording)
    one = train(cfg, pipe, dataclasses.replace(
        tc, calibrate_every=GRID_RUNTIME["calibrate_every"],
        fault_schedule=GRID_RUNTIME["fault_schedule"]),
        model=Transformer(cfg, device=DEVICE, seed=0), session=sess,
        device=DEVICE)
    checks["(h) the one-process trainer replaying the observations under "
           "the same schedule pulls the grid's plans"] = \
        pulls == recs[0]["plan_digests"]
    losses = [h["loss"] for h in one["history"]]
    del one
    step = GRID_RUNTIME["ckpt_every"]
    model = Transformer(cfg, device=DEVICE, seed=1)
    got = ckpt.restore(str(tmp / "ckpt"), step, {
        "params": model.state_dict(),
        "opt_state": AdamW().init(list(model.parameters()))})
    model.load_state_dict(got["params"])
    whole = torch.load(tmp / "h_params.pt", weights_only=False)
    bitwise = sorted(whole) == sorted(model.state_dict()) and all(
        torch.equal(p.cpu(), whole[k]) for k, p in model.state_dict().items())
    checks[f"(h) the step-{step} checkpoint loads into a one-process model, "
           f"bitwise the grid's parameters gathered whole"] = bitwise \
        and got["opt_state"].step == step + 1
    log(f"  (h) smollm-360m {n} layers, {GRID_RUNTIME}: losses "
        f"{[s['loss'] for s in recs[0]['steps']]!r} (one process replaying "
        f"{losses!r}), probes a step {[len(p) for p in recs[0]['probes']]} "
        f"observations, peaks {[round(r['peak_gib'], 2) for r in recs]} GiB "
        f"a rank, {recs[0]['seconds']:.1f} s [{card}]")
    del model, got, whole
    gc.collect()
    torch.cuda.empty_cache()
    return checks, dict(
        losses=[s["loss"] for s in recs[0]["steps"]],
        losses_one_process=losses,
        launches_per_rank_step=[[s["launches"] for s in r["steps"]]
                                for r in recs],
        peak_gib=[r["peak_gib"] for r in recs],
        storage=[r["storage"] for r in recs])


def _grid_launches(cfg, path, dtype):
    """A rank's kernel launches a step on ``path``: a CA layer's 2
    forwards (one the remat recompute) and its 2 backwards; an SSD
    layer's 2 forwards and its backward's kernels (bf16: the head-part
    and fold kernels; f32: dC, dB/dx and dcsum); an rglru layer's 2 scans
    and 1 reverse scan; a local layer's 2 flash forwards, dq and dk/dv
    kernels and 3 tile-range prunes."""
    kinds = [cfg.layer_pattern[i % cfg.period] for i in range(cfg.n_layers)]
    n = {k: kinds.count(k) for k in set(kinds)}
    if path in GRID_PALLAS:
        want = {}
        if "ssd" in n:
            bwd = ("ssd_bwd_part", "ssd_bwd_fold") if dtype == "bfloat16" \
                else ("ssd_chunk_bwd_dc", "ssd_chunk_bwd_dbx",
                      "ssd_chunk_bwd_dcsum")
            fwd = "ssd_fwd_mma" if dtype == "bfloat16" else "ssd_chunk_fwd"
            want.update({fwd: 2 * n["ssd"]}, **{k: n["ssd"] for k in bwd})
        if "rglru" in n:
            want.update(lru_scan_fwd=2 * n["rglru"],
                        lru_scan_bwd=n["rglru"])
        if "local" in n:
            want.update(flash_fwd=2 * n["local"], flash_bwd_dq=n["local"],
                        flash_bwd_dkv=n["local"],
                        flash_tile_ranges=3 * n["local"])
        return want
    return {"ca_server_fwd": 2 * cfg.n_layers,
            "ca_server_bwd_dq": cfg.n_layers,
            "ca_server_bwd_dkv": cfg.n_layers}


def _grid_stored_as_placed(storage):
    return all(storage[k] == storage[k + "_placed"]
               for k in ("param_bytes", "moment_bytes") if k in storage)


def _grid_checks(torch, np, parts, oracles, fwd_1p, card):
    """Phase 31's checks over the ranks' records; logs the numbers."""
    checks, runs = {}, {}
    data_pairs = [(r, r + GRID["model"]) for r in range(GRID["model"])]
    for path in GRID_TRAIN:
        for dtype in GRID_DTYPES:
            cfg, _, _ = _grid_setup(path, dtype)
            want = _grid_launches(cfg, path, dtype)
            tag = f"({path}) {GRID_PATHS[path][0]} {dtype}"
            recs = [p[path, dtype] for p in parts]
            one = oracles[path, dtype]
            steps = recs[0]["steps"]
            gaps = [abs(s["loss"] - o["loss"]) / abs(o["loss"])
                    for s, o in zip(steps, one["steps"])]
            ggaps = [abs(s["gnorm"] - o["gnorm"]) / abs(o["gnorm"])
                     for s, o in zip(steps, one["steps"])]
            checks[f"{tag}: every rank reports the same losses"] = all(
                [s["loss"] for s in r["steps"]]
                == [s["loss"] for s in steps] for r in recs)
            if path not in GRID_PALLAS:
                checks[f"{tag}: plan digests equal on all {GRID_RANKS} "
                       f"ranks at every step"] = len(
                    {tuple(r["plan_digests"]) for r in recs}) == 1 \
                    and len(steps) == len(recs[0]["plan_digests"])
            checks[f"{tag}: the tensors every data rank holds bitwise "
                   f"equal across the data ranks after every step"] = all(
                [s["params"] for s in recs[a]["steps"]]
                == [s["params"] for s in recs[b]["steps"]]
                for a, b in data_pairs)
            checks[f"{tag}: launches a rank a step {want}"] = \
                all(s["launches"] == want for r in recs for s in r["steps"])
            checks[f"{tag}: stored parameter and moment bytes a rank the "
                   f"placements' shard sizes"] = all(
                _grid_stored_as_placed(r["storage"]) for r in recs)
            routing = None
            if cfg.moe:
                # in bf16 the model ranks' partial sums round apart from
                # one process's past layer 0, so only layer 0 is held
                tie = GRID_NEAR_TIE[dtype]
                held = None if dtype == "float32" else 1
                ok = _grid_routing_equal(
                    torch, [r["routing"][:held] for r in recs],
                    one["routing"][:held], tie)[0]
                _, differ, far, worst = _grid_routing_equal(
                    torch, [r["routing"] for r in recs], one["routing"],
                    tie)
                routing = dict(differ_by_layer=differ, far=far,
                               worst_gap_by_layer=worst, limit=tie,
                               held_layers=held)
                checks[f"{tag}: step-0 routing (expert-parallel, global) "
                       f"equal to the one-process routing but at near-ties "
                       f"(within {tie}), "
                       + ("every layer" if held is None else "layer 0")] = ok
                checks[f"{tag}: every rank's slot tables from the global "
                       f"capacity and token order"] = _grid_slots_global(
                    recs, one, differ)
                log(f"  {tag}: step-0 routing choices differing from one "
                    f"process by layer {differ} of {GRID_RANKS} x "
                    f"{recs[0]['routing'][0][0].numel()} a layer, {far} not "
                    f"at a near-tie, largest relative probability gap of a "
                    f"differing pair by layer {worst!r} (limit {tie!r}, held "
                    + ("at every layer)" if held is None else "at layer 0)"))
            if dtype == "float32":
                checks[f"{tag}: step-0 loss within {GRID_F32_LIMIT} of the "
                       f"one-process trainer's"] = gaps[0] <= GRID_F32_LIMIT
                checks[f"{tag}: step-0 grad norm within {GRID_F32_LIMIT} of "
                       f"the one-process trainer's"] = \
                    ggaps[0] <= GRID_F32_LIMIT
                for name, loss in one["controls"].items():
                    gap = abs(loss - steps[0]["loss"]) / abs(steps[0]["loss"])
                    need = name == GRID_REQUIRED_CONTROLS[path]
                    log(f"  {tag} control, {name}: loss {loss!r}, relative "
                        f"gap to the grid's {gap!r}"
                        + (" (must exceed the limit)" if need else
                           " (recorded)"))
                    if need:
                        checks[f"{tag}: control '{name}' outside "
                               f"{GRID_F32_LIMIT}"] = gap > GRID_F32_LIMIT
            for k, s in enumerate(steps):
                ms = [round(1e3 * r["steps"][k]["step_s"], 1) for r in recs]
                log(f"  {tag} step {k}: loss {s['loss']!r} (one process "
                    f"{one['steps'][k]['loss']!r}, relative gap "
                    f"{gaps[k]!r}), grad norm {s['gnorm']!r} (gap "
                    f"{ggaps[k]!r}), step ms by rank {ms} (one process "
                    f"{1e3 * one['steps'][k]['step_s']:.1f})")
            log(f"  {tag}: peaks {[round(r['peak_gib'], 2) for r in recs]} "
                f"GiB a rank, stored {recs[0]['storage']} bytes (rank 0), "
                f"{recs[0]['seconds']:.1f} s [{card}]")
            runs[path, dtype] = dict(
                losses=[s["loss"] for s in steps],
                losses_one_process=[s["loss"] for s in one["steps"]],
                loss_rel_gaps=gaps, grad_norm_rel_gaps=ggaps,
                step_ms=[[1e3 * s["step_s"] for s in r["steps"]]
                         for r in recs],
                peak_gib=[r["peak_gib"] for r in recs],
                storage=[r["storage"] for r in recs],
                launches_per_rank_step=[[s["launches"] for s in r["steps"]]
                                        for r in recs],
                controls=one["controls"], routing=routing)
    col = [p["a", "bfloat16"]["colocated"] for p in parts]
    n = GRID_PATHS["a"][1]
    want_fl = {"flash_fwd": 2 * n, "flash_bwd_dq": n, "flash_bwd_dkv": n,
               "flash_tile_ranges": 3 * n}
    cad0 = parts[0]["a", "bfloat16"]["steps"][0]["loss"]
    checks[f"(a) colocated pallas on the grid: flash launches a rank "
           f"{n} x {{2, 1, 1, 3}}"] = all(c[1] == want_fl for c in col)
    checks["(a) colocated pallas on the grid: step-0 loss bitwise the "
           "grid's CAD step-0 loss"] = all(c[0] == cad0 for c in col)
    log(f"  (a) colocated pallas on the grid: loss {col[0][0]!r} (CAD "
        f"{cad0!r}), flash launches {col[0][1]}")
    fwd = [p["d"] for p in parts]
    ok, differ, far, worst = _grid_routing_equal(
        torch, [r["routing"] for r in fwd], fwd_1p["routing"],
        GRID_NEAR_TIE["bfloat16"])
    logit_max = max(float(x.abs().max()) for x in fwd_1p["logits"].values())

    def d_gaps(loss, logits):
        """The loss's relative gap and each rank's logit gap over
        logit_max, against the one-process forward."""
        return (abs(loss - fwd_1p["loss"]) / abs(fwd_1p["loss"]),
                [float((x - fwd_1p["logits"][divmod(i, GRID["model"])])
                       .abs().max()) / logit_max
                 for i, x in enumerate(logits)])
    gap, logit_gaps = d_gaps(fwd[0]["loss"], [r["logits"] for r in fwd])
    checks[f"(d) maverick forward: loss within {GRID_D_LOSS_LIMIT} of the "
           f"one-process forward's"] = gap <= GRID_D_LOSS_LIMIT
    checks[f"(d) maverick forward: every rank's logits (its vocab shard, "
           f"first {GRID_LOGIT_TOKENS} tokens) within {GRID_D_LOGIT_LIMIT} "
           f"of max |logit| of the one-process forward's"] = \
        max(logit_gaps) <= GRID_D_LOGIT_LIMIT
    controls = {}
    for name in GRID_D_CONTROLS:
        c_gap, c_logits = d_gaps(fwd[0]["controls"][name][0],
                                 [r["controls"][name][1] for r in fwd])
        outside = c_gap > GRID_D_LOSS_LIMIT \
            or max(c_logits) > GRID_D_LOGIT_LIMIT
        need = name in GRID_D_REQUIRED
        controls[name] = dict(loss_rel_gap=c_gap, logit_rel_gaps=c_logits)
        log(f"  (d) control, {name}: loss relative gap {c_gap!r}, logit "
            f"gaps by rank {c_logits!r}, outside the limits: {outside}"
            + (" (must be)" if need else " (recorded)"))
        if need:
            checks[f"(d) control '{name}' outside the limits"] = outside
    checks["(d) maverick forward: CA launches a rank 1"] = all(
        r["launches"] == {"ca_server_fwd": 1, "ca_server_bwd_dq": 0,
                          "ca_server_bwd_dkv": 0} for r in fwd)
    checks["(d) maverick forward: every rank's slot tables from the global "
           "capacity and token order"] = _grid_slots_global(fwd, fwd_1p,
                                                            differ)
    checks["(d) maverick forward: plan digests equal on all ranks"] = \
        len({r["plan_digest"] for r in fwd}) == 1
    checks["(d) maverick forward: stored parameter bytes a rank the "
           "placements' shard sizes"] = all(
        _grid_stored_as_placed(r["storage"]) for r in fwd)
    checks[f"(d) maverick forward: routing (expert-parallel, global) equal "
           f"to the one-process routing but at near-ties (within "
           f"{GRID_NEAR_TIE['bfloat16']})"] = ok
    checks["(d) maverick forward: every rank reports the same finite "
           "loss"] = len({r["loss"] for r in fwd}) == 1 \
        and math.isfinite(fwd[0]["loss"])
    log(f"  (d) maverick forward: loss {fwd[0]['loss']!r} (one process "
        f"{fwd_1p['loss']!r}, relative gap {gap!r}), routing choices "
        f"differing {differ} ({far} not at a near-tie, largest relative "
        f"probability gap {worst!r}), logits max |diff| over max |logit| "
        f"{logit_max!r} by rank {logit_gaps!r} on the first "
        f"{GRID_LOGIT_TOKENS} tokens, build "
        f"{[round(r['build_s'], 2) for r in fwd]} s, forward ms "
        f"{[round(1e3 * r['forward_s'], 1) for r in fwd]}, peaks "
        f"{[round(r['peak_gib'], 2) for r in fwd]} GiB a rank, stored "
        f"{fwd[0]['storage']} bytes (rank 0) (one process build "
        f"{fwd_1p['build_s']:.2f} s) [{card}]")
    runs["d"] = dict(storage=[r["storage"] for r in fwd],
                     loss=fwd[0]["loss"], loss_one_process=fwd_1p["loss"],
                     loss_rel_gap=gap, routing_differ=differ,
                     routing_worst_gap=worst, logit_rel_gaps=logit_gaps,
                     logit_max=logit_max, controls=controls,
                     forward_ms=[1e3 * r["forward_s"] for r in fwd],
                     peak_gib=[r["peak_gib"] for r in fwd],
                     launches=[r["launches"] for r in fwd])
    return checks, runs


def grid_phase(torch, np, ops, ssd, rg, card):
    """Phase 31: the sharding rules on a data 2 x model 2 grid of
    GRID_RANKS gloo processes on the one card (gloo stages CUDA tensors
    through the host: its times are not speed figures), bf16, seed 0,
    each model index's data ranks a CAD group, every tensor stored as
    its placement says (FSDP: split over the data ranks on its dmodel
    dim, gathered where a layer reads it): (a) llama3-8b and (b)
    smollm-360m (15 heads padded to 16, 8 MHA heads a rank) at every
    width, 2 layers, a [1, 4096] ``prolong`` row a data rank, 2 steps of
    ``trainer.train`` under ``cad`` with remat; (c) qwen2-moe-a2.7b with
    ``expert_parallel`` (30 experts a data rank, ``d_ff_expert`` split
    over the model ranks), 2 layers, [1, 2048] a data rank, 2 steps; (e)
    mamba2-370m at every width, 2 layers, and (f) recurrentgemma-9b at
    every width, 3 layers (rglru, rglru, local), [1, 4096] a data rank,
    2 steps each on the ``pallas`` route of a sessionless grid (the SSD
    kernels at full width on every model rank; lru_scan on this rank's
    2048 channels, flash on its 8 heads of 256); (g) whisper-large-v3 at
    every width, 2 encoder and 2 decoder layers, a memory of 1500 frames,
    [1, 4096] a data rank, 2 ``cad`` steps; each then as an f32 copy, one
    step ((f) at 2 layers); (a) also on the colocated ``pallas`` route at
    the step-0 weights; (d) llama4-maverick at every width, 1 layer, a
    ``cad`` forward of [1, 2048] a data rank (64 experts a data rank, 8
    GB a rank in bf16); (h) smollm-360m, 4 layers, 4 ``cad`` steps under
    GRID_RUNTIME (a probe a step, server 1 killed before step 2, a
    checkpoint after it).  Each against the one-process trainer (or
    forward) on the card on the same weights and batches, run before the
    spawn and freed (maverick's 32 GB first).  Checked: the f32 copies'
    step-0 loss and grad norm within GRID_F32_LIMIT (each path's
    GRID_REQUIRED_CONTROLS outside it), the bf16 gaps logged; (d)'s loss
    and every rank's logit slice within GRID_D_LOSS_LIMIT and
    GRID_D_LOGIT_LIMIT (the "return exchange reversed" control outside
    them); the expert-parallel routing equal to the one-process routing
    but at near-ties (GRID_NEAR_TIE); the tensors every data rank holds
    bitwise equal across them after every step; plan digests
    equal on all ranks; each path's launches a rank a step; each rank's
    stored parameter and moment bytes the placements' shard sizes; (h)'s
    plans, calibrator states and pool epochs equal on every rank, the
    one-process trainer replaying its observations pulling its plans, its
    checkpoint loading into one process bitwise; then the CA kernels
    against their plain versions on (a)'s, (b)'s and (g)'s captured
    server batches at the grid's per-rank shapes, timed beside SDPA and
    their bound, and the SSD, lru_scan and flash kernels on (e)'s and
    (f)'s captured inputs.  The kernel libraries are built before the
    spawn: the ranks load them."""
    import shutil
    import tempfile
    import torch.multiprocessing as mp
    t_phase = time.perf_counter()
    log(f"phase 31: a data {GRID['data']} x model {GRID['model']} grid of "
        f"gloo ranks on the card, FSDP storage: (a) llama3-8b, (b) "
        f"smollm-360m, (c) qwen2-moe-a2.7b (expert parallel), (e) "
        f"mamba2-370m, (f) recurrentgemma-9b, (g) whisper-large-v3 "
        f"trained, (d) llama4-maverick-400b-a17b forward, (h) smollm-360m "
        f"under {GRID_RUNTIME}")
    t0 = time.perf_counter()
    fwd_1p = _grid_one_process_forward(torch, ops)
    oracles = {(path, dtype): _grid_one_process(torch, ops, path, dtype)
               for path in GRID_TRAIN for dtype in GRID_DTYPES}
    oracle_s = time.perf_counter() - t0
    for m in (ops, ssd, rg):
        m.reset_launches()
    gc.collect()
    torch.cuda.empty_cache()
    live = sorted(((o.untyped_storage().nbytes(), tuple(o.shape))
                   for o in gc.get_objects()
                   if torch.is_tensor(o) and o.is_cuda), reverse=True)
    log(f"phase 31: this process holds "
        f"{torch.cuda.memory_reserved() / 2 ** 30:.2f} GiB reserved, "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated at the "
        f"spawn; the largest CUDA tensors it references: "
        f"{[(round(n / 2 ** 30, 3), shape) for n, shape in live[:5]]}")
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_grid_"))
    t0 = time.perf_counter()
    # the 4 ranks share the card: segments that grow in place keep each
    # rank's cached-but-unused memory small (without it one H100 ran out of
    # its 79 GiB in (a)'s f32 update with 1.78 GiB so cached a rank)
    alloc = os.environ.get(GRID_ALLOC_ENV)
    os.environ[GRID_ALLOC_ENV] = "expandable_segments:True"
    try:
        mp.spawn(_grid_rank, args=(str(tmp),), nprocs=GRID_RANKS, join=True)
        spawn_s = time.perf_counter() - t0
        parts = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
                 for r in range(GRID_RANKS)]
        captured = {path: _grid_capture(torch, tmp / f"capture_{path}")
                    for path in GRID_TIMED}
        pallas_checks, pallas = _grid_pallas_kernels(torch, ops, ssd, rg,
                                                     tmp, card)
        rt_checks, runtime = _grid_runtime_checks(torch, parts, tmp, card)
    finally:
        if alloc is None:
            os.environ.pop(GRID_ALLOC_ENV)
        else:
            os.environ[GRID_ALLOC_ENV] = alloc
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    checks, runs = _grid_checks(torch, np, parts, oracles, fwd_1p, card)
    checks.update(pallas_checks)
    checks.update(rt_checks)
    runs["h"] = runtime
    timed = {}
    for path, rows in GRID_TIMED.items():
        batches = captured_batches(torch, {0: captured[path]})
        checks[f"({path}) CA kernels against their plain versions on the "
               f"captured server batches"] = check_captured(
            torch, ops, {0: captured[path]}, batches, phase=31) >= 0
        tot, f_bound, b_bound = ca_kernel_times(
            torch, ops, batches[0], captured[path], card, phase=31)
        q, k = captured[path]["q"], captured[path]["k"]
        timed[path] = dict(
            rows=rows, times=tot, bounds=(f_bound, b_bound),
            shape=f"{GRID_PATHS[path][0]} layer 0 of step 0 on model rank "
                  f"{GRID['model'] - 1}: q {tuple(q.shape)}, k/v "
                  f"{tuple(k.shape)} {str(q.dtype)[6:]}, "
                  f"{GRID['data']} server batches summed")
        del batches
        gc.collect()
        torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_phase
    log(f"phase 31: one-process runs {oracle_s:.1f} s, spawn and the ranks' "
        f"runs {spawn_s:.1f} s, phase {seconds:.1f} s (gloo stages CUDA "
        f"tensors through the host: these times are not speed figures) "
        f"[{card}]")
    for name, ok in checks.items():
        log(f"  {name}: {ok}")
    failed = [n for n, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"phase 31: failed: {failed}")
    return dict(checks=checks, runs=runs, timed=timed, pallas=pallas,
                colocated=[p["a", "bfloat16"]["colocated"] for p in parts],
                oracle_s=oracle_s, spawn_s=spawn_s, seconds=seconds,
                note="gloo stages CUDA tensors through the host: times "
                     "are not speed figures")


def _record_grid(ca_fwd, ca_bwd, fl_fwd, fl_bwd, ssd_fm, ssd_bm, ssd_f,
                 ssd_b, lru_f, lru_b, res):
    """Phase 31's launches, checks and per-rank-shape kernel times and
    errors into the kernels' JSON entries."""
    runs = {"_".join(k) if isinstance(k, tuple) else k: v
            for k, v in res["runs"].items()}
    common = {k: res[k] for k in ("checks", "oracle_s", "spawn_s",
                                  "seconds", "note")}

    def per_rank_step(*names):
        """{run: [[the named kernels' launches a step] a rank]} over the
        runs that launch them."""
        return {k: [[sum(s.get(n, 0) for n in names) for s in r]
                    for r in v["launches_per_rank_step"]]
                for k, v in runs.items() if "launches_per_rank_step" in v
                and any(n in s for r in v["launches_per_rank_step"]
                        for s in r for n in names)}
    ca_fwd["grid_phase31"] = dict(
        launches_per_rank_step=per_rank_step("ca_server_fwd"),
        launches_maverick_forward=[x["ca_server_fwd"]
                                   for x in runs["d"]["launches"]],
        runs=runs, **common)
    ca_bwd["grid_phase31"] = dict(
        launches_dq_per_rank_step=per_rank_step("ca_server_bwd_dq"),
        launches_dkv_per_rank_step=per_rank_step("ca_server_bwd_dkv"))
    pallas = res["pallas"]
    ssd_fm["grid_phase31"] = dict(
        launches_per_rank_step=per_rank_step("ssd_fwd_mma"),
        captured_max_abs_err=pallas["e"]["fwd"], shape=pallas["e"]["shape"])
    ssd_bm["grid_phase31"] = dict(
        launches_per_rank_step=per_rank_step("ssd_bwd_part",
                                             "ssd_bwd_fold"),
        captured_max_abs_err=pallas["e"]["grad"])
    ssd_f["grid_phase31"] = dict(
        launches_per_rank_step=per_rank_step("ssd_chunk_fwd"))
    ssd_b["grid_phase31"] = dict(
        launches_per_rank_step=per_rank_step(
            "ssd_chunk_bwd_dc", "ssd_chunk_bwd_dbx", "ssd_chunk_bwd_dcsum"))
    lru_f["grid_phase31"] = dict(
        launches_per_rank_step=per_rank_step("lru_scan_fwd"),
        captured_max_abs_err=pallas["f_lru"]["fwd"],
        bitwise=pallas["f_lru"]["bitwise"], shape=pallas["f_lru"]["shape"])
    lru_b["grid_phase31"] = dict(
        launches_per_rank_step=per_rank_step("lru_scan_bwd"),
        captured_max_abs_err=pallas["f_lru"]["grad"])
    fl_fwd["grid_recurrentgemma_local"] = dict(
        launches_per_rank_step=per_rank_step("flash_fwd"),
        captured_max_abs_err=pallas["f_flash"]["fwd"],
        shape=pallas["f_flash"]["shape"])
    fl_bwd["grid_recurrentgemma_local"] = dict(
        launches_per_rank_step=per_rank_step("flash_bwd_dq",
                                             "flash_bwd_dkv"),
        captured_max_abs_err=pallas["f_flash"]["grad"])
    for path, t in res["timed"].items():
        tot, (f_bound, b_bound) = t["times"], t["bounds"]
        key = f"grid_{GRID_PATHS[path][0].replace('-', '_')}"
        ca_fwd[key] = dict(
            perf_rows=t["rows"], launches=2 * GRID_PATHS[path][1],
            launches_note="a rank a step (forward and remat recompute)",
            ms=tot["fwd"], ms_repeat=tot["fwd_repeat"],
            plain_ms=tot["plain_fwd"], bound_ms=f_bound[0],
            bound_by=f_bound[1], library_ms=tot["sdpa_fwd"],
            library_call="sdpa fwd, efficient attention, boolean mask",
            flash_yardstick_ms=tot["flash_fwd"], shape=t["shape"])
        ca_bwd[key] = dict(
            perf_rows=t["rows"], launches=GRID_PATHS[path][1],
            launches_note="dq and dk/dv kernels each, a rank a step",
            ms=tot["bwd"], plain_ms=tot["plain_bwd"], bound_ms=b_bound[0],
            bound_by=b_bound[1], library_ms=tot["sdpa_fwd_bwd"],
            library_call="sdpa fwd+bwd, efficient attention, boolean mask",
            flash_yardstick_ms=tot["flash_bwd"], shape=t["shape"])
    fl_fwd["grid_phase31"] = dict(
        launches_per_rank=[c[1]["flash_fwd"] for c in res["colocated"]],
        route="colocated pallas on a rank's heads, (a) at the step-0 "
              "weights, one forward and backward",
        loss=[c[0] for c in res["colocated"]])
    fl_bwd["grid_phase31"] = dict(
        launches_dq_per_rank=[c[1]["flash_bwd_dq"]
                              for c in res["colocated"]],
        launches_dkv_per_rank=[c[1]["flash_bwd_dkv"]
                               for c in res["colocated"]])


def _record_moe(kernel, ca_fwd, ca_bwd, fl_fwd, fl_bwd, moe):
    """Phases 25-26's numbers into the kernels' JSON entries."""
    train, serving, times = moe
    t, (f_bound, b_bound) = train["times"], train["bounds"]
    shape = ("qwen2-moe-a2.7b layer 0 of step 0 (16 q over 16 kv heads of "
             "128: rep 1), 4 server batches summed; " + train["shape"])
    ca_fwd["qwen2_moe"] = dict(
        launches=train["ca_launches"]["ca_server_fwd"], ms=t["fwd"],
        ms_repeat=t["fwd_repeat"], plain_ms=t["plain_fwd"],
        bound_ms=f_bound[0], bound_by=f_bound[1], library_ms=t["sdpa_fwd"],
        library_call="sdpa fwd, efficient attention, boolean mask",
        flash_yardstick_ms=t["flash_fwd"], shape=shape,
        captured_max_abs_err=train["ca_captured_max_abs_err"],
        train=dict(train["cad"], params=train["params"],
                   step0_repeat_bitwise=train["step0_repeat_bitwise"],
                   seconds=train["seconds"]))
    ca_bwd["qwen2_moe"] = dict(
        launches=train["ca_launches"]["ca_server_bwd_dq"],
        launches_dkv=train["ca_launches"]["ca_server_bwd_dkv"],
        ms=t["bwd"], plain_ms=t["plain_bwd"], bound_ms=b_bound[0],
        bound_by=b_bound[1], library_ms=t["sdpa_fwd_bwd"],
        library_call="sdpa fwd+bwd, efficient attention, boolean mask",
        flash_yardstick_ms=t["flash_bwd"], shape=shape)
    fl_fwd["qwen2_moe"] = dict(
        launches=train["flash_launches"]["flash_fwd"],
        ms_on_ca_layer=t["flash_fwd"],
        captured_max_abs_err=train["flash_captured_max_abs_err"],
        train=dict(train["colocated"], vs_cad=train["colocated_vs_cad"]),
        shape=f"qwen2-moe-a2.7b layer 0, q/k/v [4, {MOE_SEQ}, 16, 128] "
              f"bf16")
    fl_bwd["qwen2_moe"] = dict(
        launches=train["flash_launches"]["flash_bwd_dq"],
        launches_dkv=train["flash_launches"]["flash_bwd_dkv"],
        ms_on_ca_layer=t["flash_bwd"])
    names = {MOE_ARCH: ("qwen2_moe", "16 q over 16 kv heads of 128 (rep 1)"),
             "llama4-maverick-400b-a17b": (
                 "llama4_maverick", "40 q over 8 kv heads of 128 (rep 5)")}
    for arch, (key, heads) in names.items():
        kernel[key] = dict(
            launches=serving[arch]["launches"],
            decode=dict({k: times[arch][k] for k in TIMED_KEYS},
                        shape=f"{arch} decode: 4 rows, {heads}, kv 2000"),
            serving=serving[arch])


def _record_pipeline(ca_fwd, ca_bwd, res):
    """Phase 29's launches (per rank and tick) and checks into the CA
    kernels' JSON entries."""
    counts = res["launches_per_rank_tick"]
    ca_fwd["pipeline_phase29"] = dict(
        launches_per_rank_tick=[[x["ca_server_fwd"] for x in c["fwd"]]
                                for c in counts],
        launches_remat_per_rank_tick=[[x["ca_server_fwd"] for x in c["bwd"]]
                                      for c in counts],
        launches_f32_per_rank_tick=[[x["ca_server_fwd"] for x in c["f32_fwd"]]
                                    for c in counts],
        **{k: res[k] for k in ("checks", "losses", "logits_max_abs_diff",
                               "f32_rel_gap", "grad_gaps", "peak_gib",
                               "rank_seconds", "spawn_s", "seconds",
                               "note")},
        ticks=[{k: r[k] for k in ("tick", "moves", "before_max_over_mean",
                                  "after_max_over_mean", "idle_serving")}
               for r in res["ticks"]])
    ca_bwd["pipeline_phase29"] = dict(
        launches_dq_per_rank_tick=[[x["ca_server_bwd_dq"] for x in c["bwd"]]
                                   for c in counts],
        launches_dkv_per_rank_tick=[[x["ca_server_bwd_dkv"]
                                     for x in c["bwd"]] for c in counts])


def _record_rank_runtime(ca_fwd, ca_bwd, res):
    """Phase 30's launches (per rank and step, and per probe) and checks
    into the CA kernels' JSON entries."""
    def runs(key, fn):
        return {d: fn(r[key]) for d, r in res["runs"].items()}

    def per_rank(kernel):
        return lambda x: [[s[kernel] for s in r] for r in x]
    ca_fwd["rank_runtime_phase30"] = dict(
        launches_per_rank_step=runs("launches_per_rank_step",
                                    per_rank("ca_server_fwd")),
        probe_launches_per_rank=runs("probe_launches_per_rank",
                                     per_rank("ca_server_fwd")),
        **{k: runs(k, lambda x: x) for k in (
            "losses", "losses_one_process", "loss_rel_gaps",
            "probe_seconds", "peak_gib", "oracle_s")},
        **{k: res[k] for k in ("one_process_probe_launches", "checks",
                               "spawn_s", "seconds", "note")})
    ca_bwd["rank_runtime_phase30"] = dict(
        launches_dq_per_rank_step=runs("launches_per_rank_step",
                                       per_rank("ca_server_bwd_dq")),
        launches_dkv_per_rank_step=runs("launches_per_rank_step",
                                        per_rank("ca_server_bwd_dkv")))


# ----------------------------------------------------------- phase 32
LAUNCH_ARCH = "llama3-8b"
LAUNCH_SHAPE = "train_4k"
LAUNCH_LAYERS = 2          # phase 32(b): the step on the card, one rank
LAUNCH_ROWS = 1
DRYRUN_TIMEOUT_S = 600     # phase 32(a)'s dry runs, from their start


def start_dry_runs(tmp):
    """Phase 32(a), started after phase 1 and read in phase 32: the dry run
    of LAUNCH_ARCH x LAUNCH_SHAPE on the reference's 16 x 16 grid, plain and
    with CAD (``python -m repro_torch.launch.dryrun``), each a process of
    its own on the host (meta tensors over a fake process group, no card:
    the card is hidden from it) beside the card's phases.  Returns {name:
    (process, its JSONL file)}."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    runs = {}
    for name, extra in (("plain", []), ("cad", ["--cad"])):
        out = Path(tmp) / f"dryrun_{name}.jsonl"
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               LAUNCH_ARCH, "--shape", LAUNCH_SHAPE, "--out", str(out),
               *extra]
        runs[name] = (subprocess.Popen(cmd, env=env, cwd=str(ROOT),
                                       stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      out)
    return runs


def stop_dry_runs(runs, tmp) -> None:
    """Kill any dry run still going and remove their files (the run is
    ending)."""
    import shutil
    for proc, _ in runs.values():
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    shutil.rmtree(tmp, ignore_errors=True)


def launch_phase(torch, card, runs, started):
    """Phase 32: the launch tooling.  (a) phase 32(a)'s dry runs read back:
    trace seconds, per-rank bytes, FLOPs, collective bytes and the
    roofline row.  (b) LAUNCH_ARCH at LAUNCH_LAYERS layers, one rank,
    LAUNCH_ROWS x 4096 tokens on the ``xla`` route with remat (the dry
    run's route) through ``perf.measure``: the dry run's argument bytes
    equal the card's parameters, moments and batch, exactly; the op
    counter's FLOPs of the step on the card equal the meta trace's,
    exactly (the meta trace is the program that runs); the predicted peak
    beside ``max_memory_allocated`` (reported, not checked).  (c) the same
    step traced: device ms by bucket beside each bucket's compute and
    memory terms."""
    from repro_torch.launch.perf import format_measure, measure
    from repro_torch.launch.roofline import roofline_row
    t0 = time.perf_counter()
    out = {}
    for name, (proc, path) in runs.items():
        left = max(1.0, DRYRUN_TIMEOUT_S - (time.perf_counter() - started))
        text, _ = proc.communicate(timeout=left)
        if proc.returncode:
            raise SystemExit(f"phase 32(a): the {name} dry run failed "
                             f"(exit {proc.returncode}):\n{text[-4000:]}")
        rec = json.loads(path.read_text().splitlines()[-1])
        row = roofline_row(rec)
        gib = 2 ** 30
        log(f"phase 32(a): dry run of {LAUNCH_ARCH} x {LAUNCH_SHAPE} on the "
            f"{'x'.join(map(str, rec['mesh']))} grid ({name}): traced in "
            f"{rec['trace_s']} s ({rec['n_ops']} ops, built in "
            f"{rec['build_s']} s; host seconds, beside the card's phases); "
            f"per rank: params {rec['param_bytes'] / gib:.3f} + moments "
            f"{rec['moment_bytes'] / gib:.3f} + batch "
            f"{rec['batch_bytes'] / gib:.4f} = arguments "
            f"{rec['argument_bytes'] / gib:.3f} GiB, temp "
            f"{rec['temp_bytes'] / gib:.3f} GiB, peak "
            f"{rec['peak_bytes'] / gib:.3f} GiB; flops "
            f"{rec['hlo_flops_per_device']:.4e}, op bytes "
            f"{rec['hlo_bytes_per_device']:.4e}, collective bytes "
            f"{rec['collective_bytes_per_device']:.4e} "
            f"{json.dumps(rec['collective_breakdown'])}; flops by bucket "
            f"{json.dumps({k: float(f'{v:.4e}') for k, v in rec['flops_by_bucket'].items()})}")
        log(f"  roofline (H100 data-sheet rates): compute "
            f"{row['compute_s']:.4f} s, memory {row['memory_s']:.4f} s, "
            f"collective {row['collective_s']:.4f} s, dominant "
            f"{row['dominant']}, useful {row['useful_ratio']:.4f}, peak "
            f"{row['peak_gib_per_dev']:.3f} GiB/rank, fits "
            f"{row['fits_hbm']} [{card}]")
        out[name] = dict(rec=rec, row=row)
    res = measure(LAUNCH_ARCH, LAUNCH_SHAPE, layers=LAUNCH_LAYERS,
                  rows=LAUNCH_ROWS, device=DEVICE,
                  lead_in=lambda: trace_lead_in(torch), skip=SPIN_KERNEL)
    for line in format_measure(res).splitlines():
        log(f"phase 32(b,c): {line}")
    log(f"phase 32(b,c): [{card}]")
    p, m = res["predicted"], res["measured"]
    parts = ("param_bytes", "moment_bytes", "batch_bytes", "argument_bytes")
    if any(p[k] != m[k] for k in parts):
        raise SystemExit(f"phase 32(b): the dry run's argument bytes "
                         f"{[p[k] for k in parts]} differ from the card's "
                         f"{[m[k] for k in parts]}")
    if p["flops"] != m["flops"]:
        raise SystemExit(f"phase 32(b): the step on the card counts "
                         f"{m['flops']!r} flops, its meta trace "
                         f"{p['flops']!r}")
    if not math.isfinite(res["loss"]):
        raise SystemExit(f"phase 32(b): loss {res['loss']}")
    secs = time.perf_counter() - t0
    log(f"phase 32: {secs:.1f} s (the dry runs of (a) ran beside the "
        f"earlier phases)")
    out["measure"] = dict(res, breakdown=None)
    out["seconds"] = secs
    return out


def build_kernels(build, ops, ssd, rg):
    """Phase 1: build every kernel source, one nvcc each, all at once."""
    loaders = {"ragged_decode": ops.load_library,
               "ca_server": ops.load_ca_server_library,
               "flash": ops.load_flash_library,
               "ssd_chunk": ssd.load_library,
               "lru_scan": rg.load_library}
    errors = []

    def run(fn):
        try:
            fn()
        except Exception as e:          # reported below; fails the run
            errors.append(repr(e))

    t0 = time.perf_counter()
    threads = [threading.Thread(target=run, args=(fn,))
               for fn in loaders.values()]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errors:
        raise SystemExit("phase 1: kernel build failed: " + "; ".join(errors))
    log(f"phase 1: built {len(loaders)} kernel sources in "
        f"{time.perf_counter() - t0:.2f} s")
    import re
    for name in loaders:
        seconds, report = build.build_info[name]
        log(f"  {name}.cu: nvcc {seconds:.2f} s")
        # one line a kernel instantiation: its name and template
        # arguments from the mangled symbol, registers and spills
        entry = spill = None
        for line in report.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                entry = _kernel_symbol(m.group(1))
            m = re.search(r"(\d+) bytes spill stores", line)
            if m:
                spill = m.group(1)
            m = re.search(r"Used (\d+) registers", line)
            if m and entry:
                log(f"  ptxas: {entry}: {m.group(1)} registers, {spill} "
                    f"bytes spill stores")
                entry = spill = None


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--only", choices=("kernels", "ranks", "moe", "cross",
                                      "pipeline", "rank_runtime", "grid",
                                      "launch"),
                   default=None,
                   help="'kernels': stop after the kernel checks (phases "
                        "1-2); 'ranks': phases 1, 5 and 24 alone; 'moe': "
                        "phases 1, 25 and 26; 'cross': phases 1, 27 and 28; "
                        "'pipeline': phases 1 and 29; 'rank_runtime': "
                        "phases 1 and 30; 'grid': phases 1 and 31; "
                        "'launch': phases 1 and 32")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels.packed_flash import ops
    from repro_torch.kernels.rglru import ops as rg
    from repro_torch.kernels.ssd import ops as ssd
    from repro_torch.launch import serve as launch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    build_kernels(build, ops, ssd, rg)
    dry_runs = {}
    if args.only in (None, "launch"):
        import atexit
        import tempfile
        dry_started = time.perf_counter()
        dry_tmp = tempfile.mkdtemp(prefix="chip_smoke_dry_")
        dry_runs = start_dry_runs(dry_tmp)
        atexit.register(stop_dry_runs, dry_runs, dry_tmp)

    f32_err = check_ragged_decode_cases(torch, ops)
    long_worst = check_ragged_long_cases(torch, ops)
    ca_worst = check_ca_server_cases(torch, np, ops)
    fl_worst = check_flash_cases(torch, np, ops)
    ssd_worst = check_ssd_cases(torch, np, ssd)
    fl256_worst = check_flash256_cases(torch, np, ops)
    lru_fwd_err, lru_bwd_err, lru_bitwise = check_lru_cases(torch, rg)
    src = "src/repro_torch/kernels/packed_flash/csrc/"
    kernel = {"name": "ragged_decode", "route": "cuda",
              "source": src + "ragged_decode.cu",
              "replaces": "src/repro/kernels/packed_flash/kernel.py:457",
              "max_abs_err": f32_err, "long_cache_phase2": long_worst}
    ca_fwd = {"name": "ca_server_fwd", "route": "cuda",
              "source": src + "ca_server.cu",
              "replaces": "src/repro/kernels/packed_flash/kernel.py:610",
              "max_abs_err": ca_worst["float32"][0],
              "max_abs_err_bf16": ca_worst["bfloat16"][0]}
    ca_bwd = {"name": "ca_server_bwd", "route": "cuda",
              "source": src + "ca_server.cu",
              "replaces": "src/repro/kernels/packed_flash/kernel.py:763",
              "max_abs_err": ca_worst["float32"][1],
              "max_abs_err_bf16": ca_worst["bfloat16"][1]}
    ca_rng = {"name": "ca_server_fwd_range", "route": "cuda",
              "source": src + "ca_server.cu",
              "replaces": "src/repro/kernels/packed_flash/kernel.py:610 "
                          "(as the chunked serve of src/repro/core/"
                          "dispatch.py:531 runs it: a kv-block range with "
                          "a carry)",
              "max_abs_err": ca_worst["float32"][3],
              "max_abs_err_bf16": ca_worst["bfloat16"][3],
              "bitwise_vs_unstreamed_phase2": "{}/{} cases".format(
                  *ca_worst["range_bitwise"])}
    ca_glse = {"name": "ca_server_bwd_glse", "route": "cuda",
               "source": src + "ca_server.cu",
               "replaces": "src/repro/kernels/packed_flash/kernel.py:763 "
                           "(with the lse cotangent of src/repro/core/"
                           "dispatch.py:273-276, the ring partial's "
                           "backward)",
               "max_abs_err": ca_worst["float32"][2],
               "max_abs_err_bf16": ca_worst["bfloat16"][2]}
    fl_fwd = {"name": "flash_fwd", "route": "cuda", "source": src + "flash.cu",
              "replaces": "src/repro/kernels/packed_flash/kernel.py:140",
              "max_abs_err": fl_worst["float32"][0],
              "max_abs_err_bf16": fl_worst["bfloat16"][0],
              "max_abs_err_dh256": fl256_worst["float32"][0],
              "max_abs_err_dh256_bf16": fl256_worst["bfloat16"][0]}
    fl_bwd = {"name": "flash_bwd", "route": "cuda", "source": src + "flash.cu",
              "replaces": "src/repro/kernels/packed_flash/kernel.py:310",
              "max_abs_err": fl_worst["float32"][1],
              "max_abs_err_bf16": fl_worst["bfloat16"][1],
              "max_abs_err_dh256": fl256_worst["float32"][1],
              "max_abs_err_dh256_bf16": fl256_worst["bfloat16"][1]}
    fl_rng = {"name": "flash_tile_ranges", "route": "cuda",
              "source": src + "flash.cu",
              "replaces": "src/repro/kernels/packed_flash/kernel.py:140 "
                          "(the kv-block liveness that flash_fwd, and "
                          "flash_bwd at :310, test inside their grids)",
              "max_abs_err": 0.0}      # integers, equal in every case
    no_prune_call = ("no single PyTorch call computes per-tile document "
                     "ranges")
    ssd_src = "src/repro_torch/kernels/ssd/csrc/ssd_chunk.cu"
    ssd_bwd_replaces = ("src/repro/kernels/ssd/kernel.py:57 (its gradient: "
                        "the TPU kernel has no backward, no Pallas "
                        "counterpart)")
    ssd_f = {"name": "ssd_chunk_fwd", "route": "cuda", "source": ssd_src,
             "replaces": "src/repro/kernels/ssd/kernel.py:57",
             "max_abs_err": ssd_worst["float32"][0]}
    ssd_b = {"name": "ssd_chunk_bwd", "route": "cuda", "source": ssd_src,
             "replaces": ssd_bwd_replaces,
             "max_abs_err": ssd_worst["float32"][1]}
    ssd_fm = {"name": "ssd_chunk_fwd_bf16", "route": "cuda",
              "source": ssd_src,
              "replaces": "src/repro/kernels/ssd/kernel.py:57",
              "max_abs_err": ssd_worst["bfloat16"][0]}
    ssd_bm = {"name": "ssd_chunk_bwd_bf16", "route": "cuda",
              "source": ssd_src, "replaces": ssd_bwd_replaces,
              "max_abs_err": ssd_worst["bfloat16"][1]}
    lru_src = "src/repro_torch/kernels/rglru/csrc/lru_scan.cu"
    lru_f = {"name": "lru_scan_fwd", "route": "cuda", "source": lru_src,
             "replaces": "src/repro/kernels/rglru/kernel.py:56",
             "max_abs_err": lru_fwd_err, "bitwise_phase2": lru_bitwise}
    lru_b = {"name": "lru_scan_bwd", "route": "cuda", "source": lru_src,
             "replaces": "src/repro/kernels/rglru/kernel.py:56 (its VJP, "
                         "src/repro/kernels/rglru/ops.py:32-44, reruns the "
                         "kernel on reversed inputs)",
             "max_abs_err": lru_bwd_err, "bitwise_phase2": lru_bitwise}
    if args.only == "ranks":
        _steps, captured, _ = train_full_width(torch, ops, card)
        ca_fwd["ranks_phase24"] = ranks_phase(torch, np, ops, captured[0],
                                              card, None)
    elif args.only == "moe":
        _record_moe(kernel, ca_fwd, ca_bwd, fl_fwd, fl_bwd,
                    moe_phases(torch, np, ops, launch, card))
    elif args.only == "cross":
        _record_cross(ca_fwd, ca_bwd, cross_phases(torch, np, ops, card))
    elif args.only == "pipeline":
        _record_pipeline(ca_fwd, ca_bwd, pipeline_phase(torch, np, card))
    elif args.only == "rank_runtime":
        _record_rank_runtime(ca_fwd, ca_bwd,
                             rank_runtime_phase(torch, np, ops, card))
    elif args.only == "launch":
        launch_phase(torch, card, dry_runs, dry_started)
    elif args.only == "grid":
        _record_grid(ca_fwd, ca_bwd, fl_fwd, fl_bwd, ssd_fm, ssd_bm, ssd_f,
                     ssd_b, lru_f, lru_b,
                     grid_phase(torch, np, ops, ssd, rg, card))
    elif args.only != "kernels":
        engine, launches, captured_err = serve_full_width(torch, np, ops,
                                                          launch)
        times = kernel_times(torch, ops, card)
        times256 = kernel_times(torch, ops, card, "gemma2-2b local")
        serving = engine_times(torch, np, engine, card)
        serve_trace = traced_serving(torch, np, engine, card)
        del engine
        gc.collect()
        torch.cuda.empty_cache()
        gemma = serve_gemma2(torch, np, ops, launch, card)
        prefill = times["prefill"]
        kernel.update(launches=launches, ms=prefill["ms"],
                      ms_repeat=prefill["ms_repeat"],
                      plain_ms=prefill["plain_ms"],
                      bound_ms=prefill["bound_ms"],
                      bound_by=prefill["bound_by"],
                      library_ms=prefill["library_ms"],
                      captured_max_abs_err=captured_err,
                      device_ms=prefill["device_ms"],
                      ms_single=prefill["ms_single"],
                      library_device_ms=prefill["library_device_ms"],
                      library_ms_single=prefill["library_ms_single"],
                      decode={k: times["decode"][k] for k in TIMED_KEYS},
                      dh256={name: {k: times256[name][k]
                                    for k in TIMED_KEYS}
                             for name in ("prefill", "decode")},
                      library_call="sdpa with a boolean causal (and window) "
                                   "mask; no softcap at dh 256",
                      serving=dict(serving, trace={
                          k: {f: v[f] for f in ("host_ms", "busy_ms",
                                                "ragged_ms", "ragged_share",
                                                "idle")}
                          for k, v in serve_trace.items()}),
                      launches_gemma2=gemma.pop("launches"), gemma2=gemma)
        steps, captured, ca_launches = train_full_width(torch, ops, card)
        batches = captured_batches(torch, captured)
        ca_captured_err = check_captured(torch, ops, captured, batches)
        tot, f_bound, b_bound = ca_kernel_times(torch, ops, batches[0],
                                                captured[0], card)
        ca_fwd.update(launches=ca_launches["ca_server_fwd"], ms=tot["fwd"],
                      ms_repeat=tot["fwd_repeat"],
                      plain_ms=tot["plain_fwd"], bound_ms=f_bound[0],
                      bound_by=f_bound[1], library_ms=tot["sdpa_fwd"],
                      captured_max_abs_err=ca_captured_err,
                      shape="layer 0 of step 0, 4 server batches summed",
                      flash_yardstick_ms=tot["flash_fwd"])
        ca_bwd.update(launches=ca_launches["ca_server_bwd_dq"],
                      launches_dkv=ca_launches["ca_server_bwd_dkv"],
                      ms=tot["bwd"], plain_ms=tot["plain_bwd"],
                      bound_ms=b_bound[0], bound_by=b_bound[1],
                      library_ms=tot["sdpa_fwd_bwd"],
                      library_call="sdpa fwd+bwd, efficient attention, "
                                   "boolean mask",
                      flash_yardstick_ms=tot["flash_bwd"],
                      train={k: [s[k] for s in steps] for k in
                             ("loss", "step_s", "peak_gib")})
        ring = dispatch_and_ring(torch, np, ops, captured[0], batches[0],
                                 card)
        t19 = time.perf_counter()
        elastic = elastic_runtime(torch, np, ops, captured[0], card)
        t19 = time.perf_counter() - t19
        layer0 = captured[0]           # phase 24's
        del batches, captured
        gc.collect()
        torch.cuda.empty_cache()
        calib = train_calibrated(torch, np, ops, card, steps)
        t19b = time.perf_counter()
        faulted = train_with_faults(torch, np, ops, card, steps)
        ckpt_run = checkpoint_roundtrip(torch, np, card)
        t19 += time.perf_counter() - t19b
        log(f"phase 19: {t19:.1f} s in all")
        rt = ring["times"]
        jmax = max(int(c.split("_")[1]) for c in rt if c.startswith(
            "stream_"))
        ca_rng.update(launches=ring["counts"]["ca_server_fwd_range"],
                      ms=rt[f"stream_{STREAM_MAIN_CHUNK}"],
                      plain_ms=rt["plain_stream"],
                      bound_ms=ring["range_bound"][0],
                      bound_by=ring["range_bound"][1],
                      library_ms=tot["sdpa_fwd"],
                      library_call="sdpa fwd (the same attention, "
                                   "unstreamed), efficient backend, boolean "
                                   "mask, from phase 6",
                      shape=f"layer 0 of step 0, 4 server batches summed, "
                            f"ranges of {STREAM_MAIN_CHUNK} kv blocks of "
                            f"jmax {jmax}; bound counts the carries",
                      ms_by_chunk={c.split("_")[1]: v for c, v in rt.items()
                                   if c.startswith("stream_")},
                      unstreamed_ms=rt["cad_fwd"],
                      captured_max_abs_err=ring["range_err"],
                      checks_phase17=ring["checks"])
        ca_glse.update(launches=ring["counts"]["ca_server_bwd_glse"],
                       launches_dkv_in_phase17=ring["counts"][
                           "ca_server_bwd_dkv"],
                       ms=rt["glse_bwd"], plain_ms=rt["plain_glse_bwd"],
                       bound_ms=ring["glse_bound"][0],
                       bound_by=ring["glse_bound"][1], library_ms=None,
                       library_note="no PyTorch call computes attention's "
                                    "backward with an lse cotangent",
                       shape="phase 6's layer-0 server batches (full kv "
                             "ranges) with a seeded g_lse",
                       captured_max_abs_err=ring["glse_err"],
                       ring_vs_cad=dict(
                           gap=ring["gap"], limit=RING_GAP_LIMIT,
                           grad_gaps=ring["grad_gaps"],
                           grad_limit=RING_GRAD_GAP_LIMIT,
                           controls=ring["controls"],
                           grad_controls=ring["grad_controls"],
                           cad_fwd_ms=rt["cad_fwd"],
                           ring_fwd_ms=rt["ring_fwd"],
                           cad_fwd_bwd_ms=rt["cad_fwd_bwd"],
                           ring_fwd_bwd_ms=rt["ring_fwd_bwd"],
                           ring_note="the ring's times are an upper bound "
                                     "from an unfused baseline (eager f32 "
                                     "merges over every task slot), not a "
                                     "comparison of the two designs",
                           ring_fwd_trace=ring["ring_trace"]))
        ca_fwd["calibrated_run"] = calib
        ca_fwd["elastic_phase19"] = dict(
            launches=elastic["fwd_launches"],
            range_launches=elastic["range_launches"],
            launches_by_run=elastic["launches"],
            checks=elastic["checks"],
            recovered_blocks=elastic["recovered_blocks"],
            wall_ms=elastic["wall_ms"], model_ms=elastic["model_ms"],
            checkpoint=ckpt_run, seconds=t19)
        ca_bwd["fused_under_kill_phase19"] = faulted
        gemma_cad = train_gemma2_cad(torch, ops, card)
        g_t, (g_fb, g_bb) = gemma_cad["times"], gemma_cad["bounds"]
        ca_fwd["gemma2_dh256"] = dict(
            launches=gemma_cad["launches"]["ca_server_fwd"], ms=g_t["fwd"],
            ms_repeat=g_t["fwd_repeat"], plain_ms=g_t["plain_fwd"],
            bound_ms=g_fb[0], bound_by=g_fb[1], library_ms=g_t["sdpa_fwd"],
            library_call="sdpa fwd without softcap, boolean mask",
            flash_yardstick_ms=g_t["flash_fwd"], shape=gemma_cad["shape"],
            captured_max_abs_err=gemma_cad["captured_max_abs_err"])
        ca_bwd["gemma2_dh256"] = dict(
            launches=gemma_cad["launches"]["ca_server_bwd_dq"],
            ms=g_t["bwd"], plain_ms=g_t["plain_bwd"], bound_ms=g_bb[0],
            bound_by=g_bb[1], library_ms=g_t["sdpa_fwd_bwd"],
            library_call="sdpa fwd+bwd without softcap, boolean mask",
            flash_yardstick_ms=g_t["flash_bwd"], shape=gemma_cad["shape"],
            train={k: gemma_cad[k] for k in ("loss", "step_s", "peak_gib",
                                             "params")})

        co_steps, co_captured, fl_launches, co_check = train_colocated(
            torch, ops, card, steps)
        fl_captured_err = check_captured_flash(torch, ops, co_captured)
        co_check["f32_step0_loss"] = exact_f32_step0(torch, ops, card)
        t, f_bound, b_bound, pairs = flash_kernel_times(
            torch, ops, co_captured[0], card)
        t3, f3_bound, b3_bound, _ = flash_kernel_times(
            torch, ops, head_dim_192_inputs(torch, co_captured[0]), card,
            where="phase 8: flash at head_dim 192 on layer 0's documents")
        del co_captured
        gc.collect()
        torch.cuda.empty_cache()
        shape = (f"layer 0 of step 0: q [4, 4096, 32, 128], k/v [4, 4096, "
                 f"8, 128] bf16, {pairs} live pairs per head")
        shape192 = ("layer 0's documents, seeded q [4, 4096, 32, 192], k/v "
                    "[4, 4096, 8, 192] bf16; no model of the main path has "
                    "head_dim 192, so no launches")
        fl_fwd["dh192"] = dict(
            launches=0, ms=t3["fwd"], ms_repeat=t3["fwd_repeat"],
            plain_ms=t3["plain_fwd"], bound_ms=f3_bound[0],
            bound_by=f3_bound[1], library_ms=t3["sdpa_fwd"],
            shape=shape192)
        fl_bwd["dh192"] = dict(
            launches=0, ms=t3["bwd"], plain_ms=t3["plain_bwd"],
            bound_ms=b3_bound[0], bound_by=b3_bound[1],
            library_ms=t3["sdpa_bwd"], fwd_bwd_ms=t3["fwd_bwd"],
            library_fwd_bwd_ms=t3["sdpa_fwd_bwd"], shape=shape192)
        fl_fwd.update(launches=fl_launches["flash_fwd"], ms=t["fwd"],
                      ms_repeat=t["fwd_repeat"],
                      plain_ms=t["plain_fwd"], bound_ms=f_bound[0],
                      bound_by=f_bound[1], library_ms=t["sdpa_fwd"],
                      captured_max_abs_err=fl_captured_err, shape=shape,
                      library_call="sdpa fwd, efficient attention, boolean "
                                   "mask [B, 1, S, S]")
        fl_bwd.update(launches=fl_launches["flash_bwd_dq"],
                      launches_dkv=fl_launches["flash_bwd_dkv"],
                      ms=t["bwd"], plain_ms=t["plain_bwd"],
                      bound_ms=b_bound[0], bound_by=b_bound[1],
                      library_ms=t["sdpa_bwd"],
                      library_call="sdpa bwd alone, efficient attention, "
                                   "boolean mask [B, 1, S, S]",
                      fwd_bwd_ms=t["fwd_bwd"],
                      library_fwd_bwd_ms=t["sdpa_fwd_bwd"],
                      train=dict({k: [s[k] for s in co_steps] for k in
                                  ("loss", "step_s", "peak_gib")},
                                 vs_cad=co_check))
        fl_rng.update(launches=fl_launches["flash_tile_ranges"],
                      ms=t["ranges"], plain_ms=t["plain_ranges"],
                      bound_ms=t["ranges_bound"][0],
                      bound_by=t["ranges_bound"][1], library_ms=None,
                      library_note=no_prune_call, shape=shape)
        xla_route_on_card(torch, ops, card)

        m_steps, m_captured, ssd_launches, m_params = train_mamba2(
            torch, ops, ssd, card)
        ssd_cap_f, ssd_cap_b = check_captured_ssd(torch, ssd, m_captured)
        checks = mamba2_route_checks(torch, ssd, card)
        depth = mamba2_full_depth(torch, ssd, card)
        st = ssd_kernel_times(torch, ssd, m_captured[0], card)
        del m_captured
        gc.collect()
        torch.cuda.empty_cache()
        shape = (f"layer 0 of step 0: C/B [4, 16, 256, 1, 128], x [4, 16, "
                 f"256, 32, 64], {st['bfloat16']['pairs']} live (i, j) pairs")
        no_library = ("no single PyTorch call computes the SSD intra-chunk "
                      "step (decay-masked C·Bᵀ, times x, and the end state)")
        train_rec = {k: [s[k] for s in m_steps]
                     for k in ("loss", "step_s", "peak_gib")}
        for (f_ent, b_ent), name, note in (
                ((ssd_fm, ssd_bm), "bfloat16",
                 "bf16 C/B/x, the training path"),
                ((ssd_f, ssd_b), "float32",
                 "f32 C/B/x: the same values cast, timed for comparison")):
            t = st[name]
            fma = ({} if name == "bfloat16" else
                   dict(bound_ms_fma_rate=t["f_fma"][0]))
            f_ent.update(ms=t["fwd"], ms_repeat=t["fwd_repeat"],
                         plain_ms=t["plain_fwd"], bound_ms=t["f_bound"][0],
                         bound_by=t["f_bound"][1], bound_rate=t["rate"],
                         library_ms=None, library_note=no_library,
                         shape=f"{shape}; {note}", **fma)
            b_ent.update(ms=t["bwd"], wrapper_ms=t["bwd_wrapper"],
                         plain_ms=t["plain_bwd"], bound_ms=t["b_bound"][0],
                         bound_by=t["b_bound"][1], bound_rate=t["rate"],
                         library_ms=None, library_note=no_library,
                         shape=f"{shape}; {note}",
                         **({} if name == "bfloat16" else
                            dict(bound_ms_fma_rate=t["b_fma"][0])))
        ssd_fm.update(launches=ssd_launches["ssd_fwd_mma"],
                      captured_max_abs_err=ssd_cap_f)
        ssd_bm.update(launches=ssd_launches["ssd_bwd_part"],
                      launches_fold=ssd_launches["ssd_bwd_fold"],
                      captured_max_abs_err=ssd_cap_b,
                      train=dict(train_rec, params=m_params),
                      einsum_check=dict(layers=MAMBA_CHECK_LAYERS,
                                        **checks["bfloat16"]),
                      full_depth=depth)
        # the f32 FMA kernels' launches are those of phase 11's f32 run
        exact = checks["float32"]
        f32_run = f"phase 11's f32 run ({MAMBA_CHECK_LAYERS} layers, 1 step)"
        ssd_f.update(launches=exact["launches"]["ssd_chunk_fwd"],
                     launches_from=f32_run)
        ssd_b.update(launches=exact["launches"]["ssd_chunk_bwd_dc"],
                     launches_dbx=exact["launches"]["ssd_chunk_bwd_dbx"],
                     launches_dcsum=exact["launches"]["ssd_chunk_bwd_dcsum"],
                     launches_from=f32_run,
                     f32_step0_loss_bitwise=exact["loss"])
        rg_steps, rg_captured, lru_launches, rg_params, rg_cfg = \
            train_recurrentgemma(torch, ops, rg, ssd, card)
        rg_errs = check_captured_rg(torch, ops, rg, rg_captured, rg_cfg)
        t, f_bound, b_bound = lru_kernel_times(torch, rg, rg_captured[0],
                                               card, build)
        local0 = min(k for k, v in rg_captured.items() if "q" in v)
        t2, f2_bound, b2_bound, pairs = flash_kernel_times(
            torch, ops, rg_captured[local0], card, window=rg_cfg.window,
            where=f"phase 14: flash at head_dim 256, local layer {local0}'s"
                  f" shape, window {rg_cfg.window}")
        del rg_captured
        gc.collect()
        torch.cuda.empty_cache()
        traced_steps(torch, card, steps, co_steps, m_steps, rg_steps)
        xla_rg, rg_diff, controls, control_diff = rg_xla_route(
            torch, rg, ops, ssd, card, rg_steps)
        no_library = ("no single PyTorch call computes a first-order linear "
                      "recurrence")
        shape = "rglru layer 0 of step 0: a, bterm [2, 4096, 4096] f32"
        copy = dict(ms=t["copy"], gb_per_s=t["copy_gbs"],
                    ms_back_to_back=t["copy_b2b"],
                    gb_per_s_back_to_back=t["copy_b2b_gbs"])
        lru_f.update(launches=lru_launches["lru_scan_fwd"], ms=t["fwd"],
                     ms_repeat=t["fwd_repeat"], plain_ms=t["plain_fwd"],
                     bound_ms=f_bound[0], bound_by=f_bound[1],
                     library_ms=None, library_note=no_library, shape=shape,
                     gb_per_s=t["fwd_gbs"], ms_back_to_back=t["fwd_b2b"],
                     card_copy=copy,
                     kernel_info=t["info"]["lru_scan_fwd_kernel"],
                     captured_max_abs_err=max(e for e, _ in rg_errs["lru"]))
        lru_b.update(launches=lru_launches["lru_scan_bwd"], ms=t["bwd"],
                     plain_ms=t["plain_bwd"], bound_ms=b_bound[0],
                     bound_by=b_bound[1], library_ms=None,
                     library_note=no_library, shape=shape,
                     gb_per_s=t["bwd_gbs"], ms_back_to_back=t["bwd_b2b"],
                     card_copy=copy,
                     kernel_info=t["info"]["lru_scan_bwd_kernel"],
                     captured_max_abs_err=max(e for _, e in rg_errs["lru"]),
                     train=dict({k: [s[k] for s in rg_steps]
                                 for k in ("loss", "step_s", "peak_gib")},
                                params=rg_params,
                                xla_step0_loss=xla_rg["loss"],
                                xla_step_s=xla_rg["step_s"],
                                step0_loss_diff=rg_diff,
                                step0_loss_limit=RG_LOSS_LIMIT,
                                controls=controls,
                                control_diffs=control_diff))
        shape = (f"local layer {local0} of step 0: q [2, 4096, 16, 256], k/v "
                 f"[2, 4096, 1, 256] bf16, window {rg_cfg.window}, {pairs} "
                 f"live pairs per head")
        fl_fwd["dh256"] = dict(
            launches=lru_launches["flash_fwd"], ms=t2["fwd"],
            ms_repeat=t2["fwd_repeat"], plain_ms=t2["plain_fwd"],
            bound_ms=f2_bound[0], bound_by=f2_bound[1],
            library_ms=t2["sdpa_fwd"], shape=shape,
            captured_max_abs_err=rg_errs["flash"][0])
        fl_rng["dh256"] = dict(
            launches=lru_launches["flash_tile_ranges"], ms=t2["ranges"],
            plain_ms=t2["plain_ranges"], bound_ms=t2["ranges_bound"][0],
            bound_by=t2["ranges_bound"][1], shape=shape)
        fl_bwd["dh256"] = dict(
            launches=lru_launches["flash_bwd_dq"],
            launches_dkv=lru_launches["flash_bwd_dkv"], ms=t2["bwd"],
            plain_ms=t2["plain_bwd"], bound_ms=b2_bound[0],
            bound_by=b2_bound[1], library_ms=t2["sdpa_bwd"],
            fwd_bwd_ms=t2["fwd_bwd"], library_fwd_bwd_ms=t2["sdpa_fwd_bwd"],
            shape=shape, captured_max_abs_err=rg_errs["flash"][1])

        # phases 20-23: nemotron-4-340b served at head_dim 192, mamba2 and
        # recurrentgemma served, llama3-34b's CAD step
        nemo = serve_nemotron(torch, np, ops, launch, card)
        m_serve = serve_recurrent(torch, np, ops, launch, card, 21)
        rg_serve = serve_recurrent(torch, np, ops, launch, card, 22)
        big = train_llama34_cad(torch, ops, card)
        nt = nemo.pop("times")
        m_serve.pop("times")
        rt = rg_serve.pop("times")
        kernel.update(
            launches_nemotron=nemo["launches"],
            launches_recurrentgemma=rg_serve["launches"],
            dh192={name: dict({k: nt[name][k] for k in TIMED_KEYS},
                              shape=f"nemotron-4-340b {name}: 96 q over 8 "
                                    f"kv heads of 192, phase 4's positions")
                   for name in ("prefill", "decode")},
            rep16=dict({k: rt["decode"][k] for k in TIMED_KEYS},
                       shape="recurrentgemma-9b local decode: 4 rows, 16 q "
                             "over 1 kv head of 256, window 2048, kv 3000"),
            nemotron=nemo, mamba2_serving=m_serve,
            recurrentgemma_serving=rg_serve)
        ca_fwd["llama3_34b"] = dict(
            launches=big["launches"]["ca_server_fwd"],
            captured_max_abs_err=big["captured_max_abs_err"],
            train={k: big[k] for k in ("loss", "step_s", "tokens_per_s",
                                       "peak_gib", "params", "shape",
                                       "seconds")})
        ca_bwd["llama3_34b"] = dict(
            launches=big["launches"]["ca_server_bwd_dq"],
            launches_dkv=big["launches"]["ca_server_bwd_dkv"])
        # phases 25-26: the MoE archs
        _record_moe(kernel, ca_fwd, ca_bwd, fl_fwd, fl_bwd,
                    moe_phases(torch, np, ops, launch, card))
        # phases 27-28: the cross-attention archs
        _record_cross(ca_fwd, ca_bwd, cross_phases(torch, np, ops, card))
        # phase 32: the launch tooling (its dry runs started after phase 1)
        launch_phase(torch, card, dry_runs, dry_started)
        gc.collect()
        torch.cuda.empty_cache()
        # last: the phases that join a process group and spawn; no traced
        # window comes after them
        ca_fwd["ranks_phase24"] = ranks_phase(
            torch, np, ops, layer0, card, elastic["free_digest"])
        del layer0
        gc.collect()
        torch.cuda.empty_cache()
        _record_pipeline(ca_fwd, ca_bwd, pipeline_phase(torch, np, card))
        gc.collect()
        torch.cuda.empty_cache()
        _record_rank_runtime(ca_fwd, ca_bwd,
                             rank_runtime_phase(torch, np, ops, card))
        gc.collect()
        torch.cuda.empty_cache()
        _record_grid(ca_fwd, ca_bwd, fl_fwd, fl_bwd, ssd_fm, ssd_bm, ssd_f,
                     ssd_b, lru_f, lru_b,
                     grid_phase(torch, np, ops, ssd, rg, card))
    log(json.dumps({"kernels": [kernel, ca_fwd, ca_bwd, ca_rng, ca_glse,
                                fl_fwd, fl_bwd, fl_rng, ssd_fm, ssd_bm,
                                ssd_f, ssd_b, lru_f, lru_b]}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""On-GPU smoke test of the PyTorch/CUDA port (``flexflow_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU (built
for Hopper, sm_90a)::

    python3 chip_smoke.py

Thirty-two phases, in order; any failure raises and exits non-zero:

1. **Kernels.**  Builds every CUDA kernel of the port from
   ``flexflow_torch/csrc`` and holds the serving kernels against their
   plain PyTorch versions on the card (f32: ``o`` within 1e-4; bf16:
   ``o`` within 2e-2, the bf16 rounding of ``p`` and of the output;
   ``lse`` within 1e-3; and ``o`` element by element, see ``TOL_ELEM``),
   with each kernel's median device time over 20 runs beside its plain
   version's and ``F.scaled_dot_product_attention``'s (a yardstick the
   port never calls).  K1f also at the head dims its bf16 wgmma kernel
   pads (8, 24, 72, 128) at t = 1, 80, 130, causal and not, f32 and
   bf16; the registers, spills and shared memory of the bf16 K1f/K1b
   kernels at each tile width; the host side of one K1f call at the
   serve shape (bf16, which encodes three tensor maps, and f32).  K6
   (split-K decode) at ``DECODE_CASES``, f32 and bf16: every element by
   K1f's rule (``_decode_close``) and bit-identical across two launches,
   at the serve and long-cache shapes timed with its split count beside
   SDPA's masked call.
2. **Training kernels.**  K1b (flash backward) against its plain
   backward with non-zero ``o`` and ``lse`` cotangents, at the training
   shape (16, 8, 2048, 64) bf16 causal, at non-causal, ragged (t = 80,
   1, 130) and f32 shapes, and at hd 8, 24, 72 and 128 x t = 1, 80, 130,
   causal and not, f32 and bf16: every element of every gradient within
   ``TOL_ELEM`` of the plain one (bf16 ``stream_bwd``, f32 ``bwd``), and
   bit-identical across two launches.  K3 (fused cross-entropy) forward and
   backward, in each of its two forms (row groups, a CTA per row;
   ``XENT_FORMS``), against its plain version at (32768, 32768) bf16, at a
   ragged V (32771) and on an f32 case with planted argmax ties, labels
   over the whole vocabulary (0, V-1 and chunk edges included); then at
   ``xent_cases`` (V of 2, 10, 1000, 1001, the forms' crossover plus and
   minus 8, 32768 and 32771, f32 and bf16) with ties planted at every
   place a form splits a row (``_xent_tie_cols``), labels at 0, V-1 and
   the last vector and one out of range, which must give a NaN nll:
   ``nll``/``lse`` within 1e-4, every element of ``dlogits`` within
   ``TOL_XENT_BWD`` of the plain one, ``pred`` exactly.  Times: median
   device time beside the plain version, the bound and SDPA's backward /
   ``F.cross_entropy`` as yardsticks; K1f again at the training shape.
3. **Serve.**  Runs the full-width bf16 LM (vocab 32768, d_model 512,
   8 heads, 6 layers, max_seq 128, 8 slots, buckets 64/128, 16 requests
   of 4-32 prompt tokens and 32 new tokens, decode K=8) through
   ``flexflow_torch.apps.serve.main`` and checks that every request
   completes and that the kernels' launch counters equal ``layers x
   prefills`` (flash prefill) and ``2 x layers x K`` (flash decode: the
   decode supersteps are one CUDA graph, counted at the first call's
   eager steps and at its capture, never at a replay), and that no
   training kernel ran.
4. **Parity.**  Serves the same requests in f32 with the decode kernel
   and with the plain einsum decode: the greedy tokens must be identical.
5. **Train.**  Trains the full-width bf16 LM (batch 16, seq 2048, 6
   layers, vocab 32768, Adam lr 1e-4; ``bench.py``'s LM shape) through
   ``flexflow_torch.apps.transformer.main`` for 1 warmup and 5 timed
   steps: the loss is finite at every step and falls from the first to
   the last, and the launch counts are exact (K1f = K1b = 6 x steps,
   K3 forward = backward = steps, no decode).  Prints tokens/s, ms/step,
   MFU against 989 TFLOP/s and the share of the step in K1f, K1b and K3.
6. **Train parity.**  One f32 Adam step of a 2-layer LM at vocab 32768
   (batch 2, seq 256, TF32 off) from the same params and batch on the
   card (kernels) and on the CPU (plain versions): loss, every gradient
   and every updated parameter agree within the stated tolerances.
7. **Profile.**  One warm train step of the phase 5 model under
   ``torch.profiler``: the device busy share and device time by kernel.
8. **DLRM kernels.**  K4 (row gather, one table and three through
   ``gather_rows_multi``) and K5 (row scatter-add) against
   their plain versions bit for bit, and K5 against itself across two
   launches, at the main-path shape ((8 x 10^6, 64) f32, 2048 uniform
   ids), at the DLRM step's own ids (8 stacked tables x 256 ids in {0,
   1}: 16 rows named 128 times each), with zipf(1.2) ids, all ids equal,
   4096 ids of one row (the single-launch cap), 8192 ids (K5's two-launch
   route) uniform and all equal, int32 ids with
   negative and >= R ones, n = 0 and 1, D = 16, 65 and 512, and the LM's
   token table (32768 ids into (32768, 512)); rows the ids do not name
   never change.  Times beside the byte bound, the plain version and
   ``F.embedding`` / ``index_add_``; at the main-path shape K4, its
   three-table launch and ``F.embedding`` each timed three ways (one
   launch, the chain slope, the chain slope over cold rows:
   ``_gather_times``) beside the launch floor.
9. **DLRM train.**  ``bench.py``'s DLRM leg (8 x 10^6 x 64 tables, MLPs
   64-512-512-64 and 576-1024-1024-1024-1, batch 256, bf16) through
   ``flexflow_torch.apps.dlrm.main`` for 1 warmup and 10 timed steps:
   plain SGD and lazy Adam on the row-sparse path (K4 = K5 = steps;
   K4 = 2 x steps, one of them the three-table launch, and K5 = 3 x
   steps), momentum SGD on the dense path
   (no K4/K5): finite losses, exact launch counts, no attention or
   cross-entropy launch, only the batch's rows changed.  Prints
   samples/s, ms/step, MFU and peak memory.
10. **DLRM parity.**  One f32 step at 8 x 100,000 x 64 (ids over the
    whole vocabulary with planted duplicates) on the card and on the CPU
    for plain SGD, lazy momentum and lazy Adam: the loss, every
    parameter's step and the optimizer state agree within the stated
    tolerances, and untouched rows stay bit-identical on both sides.
11. **DLRM profile.**  One warm plain-SGD DLRM step under
    ``torch.profiler``.
12. **Stream kernels.**  K1s and K1sb (in bf16 K1f's wgmma kernel of
    ``csrc/flash_fwd.cu`` and K1b's wgmma pair of ``csrc/flash_bwd.cu``;
    in f32 the FMA kernels of ``csrc/flash_stream.cu``) against their
    plain versions (K1f's and K1b's) element by element with
    ``TOL_ELEM``, non-zero ``o`` and ``lse`` cotangents, at the shapes of
    phases 1-2, at (1, 8, 8192, 64), ragged t (1, 80, 130), causal and
    not, f32 and bf16, hd 32/64/128, the plain versions run one head at a
    time; at every bf16 case, at the main-path shape (4, 8, 8192, 64) and
    at (1, 8, 32768, 64) the bf16 K1s and K1sb bit-identical to K1f and
    K1b (``_stream_is_k1``); K1f/K1b themselves against the plain
    versions at 8k and 32k, and the chunked form (chunk 8192) against
    K1f at 32k.  Registers, spills and shared memory of each streamed
    kernel.  Device times, bf16 causal, at the serve (t = 64, 128), 2k,
    8k and 32k shapes: K1f beside K1s and K1b beside K1sb timed in turns
    in this warm process, each with its share of 989 TFLOP/s, SDPA and
    the bound (the plain versions at 8k and 32k).
13. **Long-context train.**  ``bench.py``'s 8k and 32k legs (vocab 32768,
    d_model 512, 8 heads, 6 layers, Adam lr 1e-4, bf16) through
    ``apps.transformer.main``: 8k streamed (1 + 5 steps; K1s = K1sb = 6
    x steps, no K1f/K1b), 8k default dispatch (1 + 2 steps; K1f = K1b =
    6 x steps, no K1s/K1sb), 32k streamed (1 + 2 steps); K3 forward =
    backward = steps; finite, falling losses; ms/step, tokens/s, MFU,
    peak memory and the kernels' shares; then one warm 8k step of each
    dispatch under ``torch.profiler``.  The dispatch is chosen by setting
    ``kernels._STREAMED`` in this process.
14. **Long-context parity.**  Phase 6's f32 step under the streamed
    dispatch: K1s/K1sb on the card against the plain versions on the CPU.
15. **Probe kernels.**  The kernels of the P1/P2 race (v2, v3, v4, b2: in
    bf16 all on ``wgmma``, v2 on K1f's kernel of ``csrc/flash_fwd.cu``, v3
    and v4 on the two-pass kernel of ``csrc/flash_probe.cu``, b2 on K1b's
    pair of ``csrc/flash_bwd.cu``; in f32 the FMA kernels of
    ``csrc/flash_probe.cu`` and ``csrc/flash_probe_bwd.cu``) against their
    plain versions element by
    element with ``TOL_ELEM`` (the forward variants by K1f's rule, b2 by
    ``stream_bwd``) at every block they instantiate: (16, 8, 2048, 64)
    bf16 causal, non-causal, f32, hd 128, ragged t (1, 80, 130, 200) and
    two shapes whose key tiles wrap the two-pass kernels' ring across its
    passes (``PROBE_WRAP``); v3 and v4 bit-identical across two launches;
    at (4, 8, 8192, 64) against the plain versions run one batch row at a
    time and against K1f/K1b (twice ``TOL_ELEM``); v4 issues every
    product and v3 stops at the diagonal (``_probe_poison``); at every
    bf16 shape v2 at block 128 gives K1f's ``o`` and b2 at block 64, from
    the delta K1b's dq pass wrote, K1b's gradients bit for bit
    (``_row_state_bits``); exact launch counts.  Registers, spills (none
    allowed at the race's hd 64) and shared memory of the bf16 v2, v3, v4
    and b2.
    Device times at the race's shapes beside the bound of the causal
    function and of the products each variant does, the plain version and
    SDPA.  Then the path
    that runs them: ``flexflow_torch.tools.probe_flash_variants`` and
    ``probe_flash_bwd_variants`` in-process at (16, 8, 2048, 64) and (4,
    8, 8192, 64); every variant prints a finite positive time and an
    error within ``TOL_RACE``, the launch counts equal the races' calls,
    and the races' chain slopes for K1f, K1s, K1b and K1sb are printed
    beside phase 12's device times.
16. **AlexNet kernels.**  K3 forward and backward at AlexNet's loss
    shape, (2048, 1000) bf16 (V a multiple of 8: the 16-byte-load path),
    in each form, labels over every class and one out of range, planted
    argmax ties, against the plain version (``nll``/``lse`` within 1e-4,
    every ``dlogits`` element within ``TOL_XENT_BWD``, ``pred`` exactly);
    each form's one launch (``_device_ms``, in turns with
    ``F.cross_entropy``) and chain slope (``_chain_ms``) beside the bound,
    the plain version, ``F.cross_entropy`` and the launch floor.
17. **AlexNet train.**  ``bench.py``'s AlexNet leg (batch 2048, 229 x 229
    x 3, 1000 classes, bf16, SGD lr 0.01 momentum 0.9 wd 1e-4, 3 warmup +
    20 timed steps) through the bench entry's
    ``flexflow_torch.bench.bench_alexnet``: a finite loss at every step,
    exact launch counts (K3 forward = backward = steps, no other kernel);
    images/s, ms/step, MFU and peak memory.  Then one warm step under
    ``torch.profiler`` (busy share, time by kernel and by kernel group),
    the SGD update's device time by CUDA events.
18. **AlexNet parity.**  One f32 SGD step of AlexNet at its full widths
    at image 67 (batch 8, 1000 classes, TF32 off) on the card (cuDNN,
    cuBLAS, K3) and on the CPU (plain versions) from the same params and
    batch, the CPU taking the card's branch at each ReLU and max-pool
    window where its own differs only within rounding of the kink
    (``_CardBranches``): loss, every gradient and every updated parameter
    within the stated tolerances.
19. **Superstep.**  K train steps as one CUDA graph
    (``Executor.build_superstep``) at bench.py's widths, each run held
    bit for bit (every step's loss, every parameter, Adam's moments and
    ``t``) against the same number of eager steps, after two eager runs
    are held against each other: (a) phase 5's LM through
    ``Trainer.fit(steps_per_call=4)``, 4 + 4 steps (K1f, K1b, K3 in the
    graph); (b) phase 9's DLRM, plain SGD on the row-sparse path, at
    ``steps_per_call=8``, 8 + 16 steps (K4, K5 in the graph); (c) the LM
    through ``apps.transformer`` with ``--accum-steps 2 --remat
    --steps-per-call 2``, 2 + 3 steps, the last a tail superstep captured
    before the timed calls, finite falling losses.  The launch counters
    advance at capture and not at replay: each run's rise is exact, a new
    capture of (a) and (b) rises by k x the per-step count, and one
    profiled replay runs each kernel k x per step by kernel name; a call
    with a clone of one captured tensor raises.  Prints ms/step eager (k
    = 1) and as a graph, each replay's device busy share, and the LM
    step's peak memory with and without ``--remat``, beside the card's
    name and power limit.
20. **Serve features.**  ROADMAP item 4 at phase 3's widths
    (``SERVE_FEATURES``), each arm through ``apps.serve.main`` or
    ``Server``: (a) paged KV, 16-token blocks in a pool of 40 (64 for
    the worst case) with 96 new tokens so that admission waits, bf16
    tokens bit-equal to the padded run with both on the einsum decode
    (``--no-decode-kernel``) and f32 tokens equal to the padded run on
    K6, with the capacity columns; (b) the prefix cache in f32, 16
    requests of which 12 share one 64-token prefix with 1-30 tokens of
    their own and 4 are that prefix: tokens equal to an unshared paged
    run, hits, full hits (no prefill) and saved tokens above 0; (c)
    speculation at d = 4, a full self-draft (acceptance exactly 1.0) and
    a 2-layer draft (below 1.0), padded on K6 and paged on the einsum:
    bf16 tokens bit-equal to plain decode's; (d) keyed sampling (T 0.8,
    top-k 50, seed 3): two runs, K = 4 and 8, one request alone and the
    speculative run give the same tokens; (e) padded, paged, sampled and
    speculative Servers as CUDA graphs against their eager form (two
    runs each): tokens and caches bit for bit (scratch block 0 left
    out), a call with a clone of ``pos`` raises, a fresh capture rises
    by L x K K6 launches and one profiled replay runs K6 L x K times by
    kernel name; (f) every run's K1f and K6 launches exact
    (``_serve_launches``: none on the paged main-model decode, K1f for an
    offset prefill as for a fresh one, none for a full hit) and no
    training kernel.  Prints
    decode ms/step eager and as a graph, tokens/s, acceptance and tokens
    per round, the prefix hit rate and saved tokens, beside the card's
    name and power limit.
21. **Serve resilience.**  ROADMAP item 4's failure model at phase 3's
    widths (``RESILIENCE``), each Server run with exact K1f/K6 launches
    (``_serve_launches``): (a) bf16, padded and paged (16-token blocks),
    eager and as graphs, two runs of a Server each: unfaulted, and with
    a NaN'd cache row or first block before superstep 1 and a raise
    before superstep 3 (both slot 0): request 0 and one other error out,
    the same ones on both layouts, every survivor keeps the unfaulted
    tokens, graph = eager bit for bit; (b) f32, padded and paged, eager
    and as graphs: SIGTERM before superstep 1 on a journaled Server
    drains it with no error and work left, a fresh Server on the journal
    serves the rest, and the merged output equals the undrained run (in
    bf16 the count of differing requests is printed, not held: the
    re-prefill and the decode round the carried tokens' K/V apart); (c)
    the fault matrix of (a) under speculation (d = 4, full self-draft):
    clean tokens equal plain decode's, survivors too, graph = eager; (d)
    ``apps.serve`` at hd 4, 12 and 256 (d_model 64 / 16 heads, 96 / 8,
    2048 / 8; 2 layers), also speculating (d = 2): every request
    completes with no K6 or K1f launch; at hd 64 K6 counts 2 x L x K.
    Prints decode ms/step of each run.
22. **NMT.**  ROADMAP item 5's NMT at ``bench.py``'s shape (``NMT``):
    K3 at (1280, 20480) bf16 in both forms (planted ties, an
    out-of-range label) by phase 2's rules and K4/K5 at the embeddings'
    (20480, 2048) f32 with the step's ids and uniform ones, bit for bit,
    each timed beside its plain version, ``F.cross_entropy`` /
    ``F.embedding`` / ``index_add_`` and the bound; Dropout's masks
    (64, 20, 2048) card against CPU bit for bit; an f32 SGD step at batch
    4, hidden 64, vocab 512 card against CPU (loss within 1e-5, each
    parameter's step within ``TOL_NMT_STEP``, the advanced keys equal);
    the bench leg (2 + 10 steps), ``apps.nmt`` per step (1 + 10) and at
    ``--steps-per-call 5``: finite losses, K3 forward = backward = steps
    and K4 = K5 = 2 x steps (the embeddings' row-sparse path), nothing
    else; pairs/s, ms/step, ``time = %.4fs``, peak memory; one warm step
    under ``torch.profiler`` by kernel group, one LSTM's 20 recurrence
    products and the dense SGD update by CUDA events.

23. **Item 5's rest** (``item5``).  K3 at the catalog's loss shape (64,
    1000) bf16 in both forms by phase 2's rules, one launch and chain
    slope beside ``F.cross_entropy`` and the bound; VGG-16, Inception-v3,
    DenseNet-121 and ResNet-101 through ``apps.cnn.main`` (``CNN``: batch
    64, bf16, SGD, 1 + 5 steps): finite losses, DenseNet's falling, K3 1 +
    1 a step and nothing else, DenseNet's 234 running statistics finite
    and moved; ms/step, images/s, peak memory; an f32 DenseNet-121 SGD step
    at batch 4, image 64, card against CPU (``_CardBranches``, BatchNorm's
    ReLUs too): loss, gradients and updated parameters as phase 18 holds
    them, the running statistics within ``TOL_CNN_STATS``; DenseNet with
    cuDNN deterministic as graphs of 2 and under ``--remat`` bit for bit
    against its eager steps, statistics included; one profiled DenseNet
    step; Candle-Uno through ``apps.candle_uno.main`` (batch 512, bf16,
    SGD, 1 + 10; falling loss, no kernel launch) and the bench leg
    ``bench_candle`` (2 + 10); the MoE LM (phase 5's shape, ``--experts
    8``, top-1, cf 1.25, 1 + 5 steps) through ``apps.transformer.main``:
    falling loss, K1f = K1b = 6 and K3 1 + 1 a step, each layer's drops
    and aux loss finite; tokens/s, ms/step, peak memory and the share of
    989 TFLOP/s of the work the port does (``cost_model``'s one-hot
    dispatch and combine left out); as graphs of 2 bit for bit against
    the eager steps; one profiled MoE-LM step.
24. **Item 7's training side** (``item7``, ``ITEM7``: phase 5's LM).
    (a) ``ResilientTrainer`` at ``steps_per_call=4`` (graphs), a save
    every 4 (async), 12 steps, with a NaN loss at step 6, a raised fault
    at 9 and a NaN batch at 10 (inert: the LM's inputs are integer):
    losses, params and Adam's m, v and t bit-identical to the unfaulted
    run; rollbacks, batches drawn again, ms a rollback, the snapshot's
    bytes and ms a save (sync; async blocking + flush); (f)
    ``ServingExecutor.restore`` of (a)'s last snapshot serves bench.py's
    16 requests (max_seq = the training seq): greedy tokens equal to the
    in-memory params', K1f and K6 launched; (b) ``apps.transformer
    --resilient --sync-ckpt`` in a subprocess, SIGTERM once step 4 is
    saved, exit 0, the rerun on the same ``--ckpt-dir`` ends at 12 bit
    for bit with the uninterrupted run; (c) ``--telemetry``: the same
    fences with it and without, every event in the catalog, exit
    ``clean``, the index row, ``overhead_pct`` (on, off, on, off) and the
    watchdog (0.5 s deadline, a 1.5 s host stall: one ``stall`` event,
    one SIGUSR1 to a child waiting for it); (d) ``--trace``: the run's
    ``trace_summary`` names K1f's, K1b's and cuBLAS's kernels with their
    device ms; (e) ``--profiling``'s per-op table; (g) the chaos matrix
    through ``tools.chaos_smoke``: every ported scenario passes, the
    rest print ``NOT PORTED`` with their item.
25. **Item 7's rest and item 8's scheduler** (``serve-sched``, ``SCHED``:
    phase 3's widths, bf16, over the serving leg's bursty workload of 2 x
    16 requests).  (a) the plain ``Server`` at K = 8, telemetry on and
    off: the same tokens and fences, one start and one end event per
    request, 1/8 program a step, ``python -m flexflow_torch.obs report``
    on the log, telemetry's host time per dispatch (and by kind) and
    ``overhead_pct``; (b) ``ScheduledServer`` slo and fifo on the card: the bench columns,
    tokens equal to the plain Server's, decisions and dispatches equal
    to the simulated run's, exact K1f and K6 launches (K6 at each k's
    capture), wall ms per superstep by k beside the plain graph's and
    each k's capture ms and bytes; (c) one retry and one engine restart
    (``bench.SCHED_FAULTS``): counters and decisions equal to the
    simulated run's, untouched requests' tokens equal (b)'s, K6 captured
    again after the restart, no degraded rung, ms a restart; (d) every
    timeline of (b)'s log reconciles to the microsecond, the autopsy of
    the stats is the one the reader folds from the log, ``obs request
    LOG --id N``; (e) the prefix workload on the paged pool (kv_block 16)
    with the prefix cache against the pool without it: the same hits in
    bf16 and f32, tokens equal in both (an offset prefill attends on K1f
    over its bucket's span, as a fresh one does; K1f's launches count
    both), and per bucket the tail K/V elements of one sharer's offset
    prefill that differ from a fresh prefill's, by layer; speculation d =
    4, tokens equal to plain decode; (f) (b)'s slo run
    under the latency model fitted on (a)'s log, both sets of virtual-ms
    columns labelled.
26. **Item 8's rest** (``fleet``, ``FLEET``: phase 25's widths and
    workload on 2 replicas, each with its own executor, caches and decode
    graphs).  (a) bf16, least-loaded: the router's and each replica's
    decisions and the dispatches equal the simulated fleet's, the tokens
    of every request no re-prefill touched equal the single-replica slo
    run's, exact K1f and K6 launches; (b) replica 0 lost before its decode
    superstep 1 (restart budget 0), in f32 and bf16: decisions equal the
    simulated fleet's, the dead engine released, f32 tokens all equal the
    unfaulted single replica's, bf16 the untouched ones (how many
    redistributed ones differ is printed), the wall ms from the death to
    the survivor's first resumed token; (c) ``apps.serve --serve-auto
    --replicas 2``: the chosen config runs the predicted dispatches; (d)
    wall ms a fleet run, first-call ms and bytes per replica per k, the
    bench's fleet columns.
27. **The mesh** (``mesh``, ``MESH``: phase 5's command line through
    ``apps.transformer.main`` on ``parallel/``'s worlds,
    ``flexflow_torch/tools/mesh_smoke.py::chip_app`` the rank body).  (a)
    The app in this process (the plain ``Executor``), then on a world of
    1 (``-ll:gpu 1``): its 1 + 5 steps' losses and every parameter after
    them bit for bit the plain run's.  (b) The app with ``-ll:gpu 2``
    inside a world of 2 under ``--dp 2``, ``--tp 2``, ``--dp 2
    --zero-opt`` (one rank per card over NCCL with two or more cards; on
    one card both ranks share it over gloo, passed explicitly, and run
    only ``--dp 2`` and the fault: ``--tp 2`` and ``--zero-opt`` over gloo
    took 3.3 and 2.0 s a step there, and every multi-card run repeats
    them over NCCL), 1 + 5
    steps each: the losses within ``TOL_MESH_LOSS`` of (a)'s, the trained
    parameters within ``TOL_MESH_DIST`` of (a)'s over the size of their
    change, equal bit for bit on every rank, exact launch counts on each
    rank (K1f = K1b = 6 x steps, K3 forward = backward = steps), the
    shapes each rank ran them at (dp 2: attention (8, 8, 2048, 64), K3
    (16384, 32768); tp 2: (16, 8, 2048, 64), (32768, 32768)), K1f, K1b
    and K3 held on each rank at those shapes against their plain versions
    (phase 2's rules), one report counting the global batch, ZeRO's
    lm_head moments split, the app's ms a step per rank and the share of
    one more step in collectives (each synchronised alone), labelled with
    the backend.  A planted fault, dp 2 without the gradient all-reduce,
    must fail a bar.  With four or more cards also dp 2 x tp 2 on a world
    of 4 over NCCL; with two or more, ``-ll:gpu 2 --dp 2`` from this
    process, the app spawning its own world.  K1f, K1b and K3 timed at dp
    2's local shapes.  (c) The small CNN of
    ``tests/test_sharding_equivalence.py`` in f32 under DP 4, TP, spatial
    and hybrid tables on 4 ranks of CUDA tensors against one rank, at the
    CPU tests' tolerance.
28. **The DLRM on a mesh** (``mesh-dlrm``, ``MESH_DLRM``: phase 9's
    command line through ``apps.dlrm.main`` on worlds of ranks,
    ``flexflow_torch/tools/mesh_smoke.py::dlrm_app`` the rank body; every
    run of a world from one draw of the tables).  (a) A world of 1
    (``-ll:gpu 1``): plain SGD's losses, dense parameters and the batch's
    table rows bit for bit phase 9's, no other row moved; lazy Adam and
    momentum SGD beside it as the references of (b).  (b) Worlds of 2
    (NCCL a card a rank with two cards, gloo on one), the tables set by a
    ``-s`` table: ``embeddings`` replicated (n=2 c=1) and row-sharded
    (c=2, ``dlrm_strategy(2)``'s: 4 of the 8 tables a rank), under plain
    SGD, lazy Adam and momentum SGD.  Per rank: exit code, local table
    shape, exact K4 / ``gather_rows_multi`` / K5 counts, only the batch's
    rows moved (lazy Adam: and its moments).  The sharded tables equal
    the replicated ones bit for bit under SGD and lazy Adam (the dense
    arm within ``TOL_MESH_DLRM_ULP``: its table gradient is summed in
    another order), the dense parameters equal on every rank, the losses
    within ``TOL_MESH_LOSS`` of (a)'s and the parameters within
    ``TOL_MESH_DIST`` of them over their change.  (c) Planted faults on
    rank 1 (its gather keeps its window's rows instead of the
    all-reduce; it scatters without its window) must fail the bars.  (d)
    With four cards the tables at c=4 on a world of 4, held bit for bit
    against the replicated tables (n=4) on the same world, and the first
    fault at c=4 failing that equality; with two the app spawning its own
    world (``-ll:gpu 2``), its losses bit for bit (b)'s c=2 SGD run's and
    within ``TOL_MESH_LOSS`` of (a)'s.  Windowed K4, K4 over
    three tables and K5 held bit for bit against their plain versions at
    a c=2 rank's shapes and timed beside ``F.embedding`` with the mask and
    ``index_add_`` on the window; ms a step, the collective share and
    peak memory a rank.
29. **Sharded serving** (``mesh-serve``, ``MESH_SERVE``: phase 3's LM and
    16 requests, K = 8, through ``ServingExecutor(shard=(n, c))`` on
    worlds of ranks, ``flexflow_torch/tools/mesh_smoke.py::serve_cases``
    the rank body).  (a) ``apps.serve`` on a world of 1 without a shard:
    phase 3's tokens bit for bit.  (b) Worlds of 2 ((2, 1), (1, 2)) and 4
    ((2, 2)), NCCL a card a rank with enough cards, else gloo with every
    rank on the one card; each shard padded and paged (16-token blocks),
    f32 and bf16, every rank asserting ``ex.shard == (n, c)``: f32 tokens
    (and the teacher-forced first token) equal the one-engine run's, bf16
    teacher-forced decode logits within ``TOL_MESH_SERVE_BF16`` of the
    one-engine run's (the requests whose tokens differ are counted), every
    rank's tokens the same, K1f launched on every rank at its (1, h/c,
    bucket, hd) heads and K6 on its (B/n, S, h/c, hd) block (padded; none
    on the paged pool), no other kernel.  In the world of 4 each rank
    also runs ``apps.serve --shard 2,2`` (f32): exit 0, shard [2, 2] and
    one engine's tokens on every rank, K1f and K6 launched on each.  For
    each bf16 arm whose tokens differ: the first differing step and the
    one engine's top-2 logit margin there.  (c) The planted faults of
    ``mesh_smoke.SERVE_FAULTS`` on rank 1 (it keeps its own partial
    product instead of the ``c`` all-reduce; it concatenates the gathered
    tokens in reverse order) must change tokens (f32), and the first,
    run in bf16, must put the teacher logits past the bf16 bar.  (d) With four cards
    (two) ``apps.serve --shard 2,2`` (``2,1``) spawning its own NCCL
    world.  (e) K6 and K1f at every rank-local shape, f32 and bf16,
    against their plain versions by phase 1's rules, timed beside them,
    SDPA (masked for K6) and the bound.  Per arm: ms a decode superstep,
    tokens/s, the share of the run's wall in collectives (host clock,
    each collective synchronised alone) and peak memory, by rank.
30. **The model strategies** (``mesh-seq``, ``MESH_SEQ``: the apps on a
    world of four ranks, ``flexflow_torch/tools/mesh_smoke.py::seq_app``
    the rank body; gloo with every rank on one card, NCCL a card a rank
    with four; each run held against the same app on one rank in this
    process).  (a) The f32 arm on a world of 1: one rank's losses and
    parameters bit for bit.  (b) The LM at full width, 4 x 8192 bf16,
    1 + 2 Adam steps, at ``--sp 2``, ``--sp 4`` and ``--dp 2 --sp 2``
    (ring attention), and with four cards 1 x 32768 streamed at ``--sp
    4``: losses within ``TOL_MESH_SEQ_LOSS`` and parameters within
    ``TOL_MESH_SEQ_DIST`` of one rank's, every rank's parameters equal,
    K1f and K1b (K1s and K1sb streamed) ``layers x steps x (1 + s_idx)``
    times on rank ``s_idx`` at its ``(b/dp, h, t/sp, hd)`` chunk, K3 once a
    step each way at its rows; the f32 arm (1 x 2048, two layers) at
    ``--sp 4`` within ``TOL_MESH_SEQ_F32``.  (c) The MoE LM of phase 23 at
    ``--tp 2`` and ``--dp 2 --tp 2``: the first step's drops equal one
    rank's exactly, the losses within the bar.  (d) NMT at phase 22's
    widths under ``nmt_strategy(2)`` and ``(4)`` (bf16), and at 4 in f32;
    K3, K4 and K5 counted.  (e) Candle-Uno at batch 512 under
    ``candle_uno_strategy(2)`` and ``(4)``.  (f) ``mesh_smoke.SEQ_FAULTS``
    on every rank must break a bar: ``ring_attend_future`` and
    ``ring_reverse`` at the f32 arm, ``ep_local_capacity`` at ``--dp 2
    --tp 2`` (the drops), ``lstm_no_carry`` at NMT f32.  (g) K1f causal
    and non-causal and K1b (causal and not, a nonzero lse cotangent) at
    each local chunk shape the ring ran, against their plain versions by
    phase 2's element rules, timed beside them, SDPA and the bound.  Per
    LM arm: ms a step a rank and, for one more step, the collectives by
    name (host clock, each synchronised alone).
31. **The training machinery on a mesh** (``mesh-train``,
    ``MESH_TRAIN``: phase 5's 2k LM at full width, bf16;
    ``flexflow_torch/tools/mesh_train.py`` the rank bodies).  A world of
    two ranks (gloo with both on one card, NCCL a card a rank with two or
    more) runs ``apps.transformer -ll:gpu 2 --dp 2`` with (a)
    ``--steps-per-call 4 --accum-steps 2 --telemetry DIR``: losses within
    ``TOL_MESH_LOSS`` and parameters within ``TOL_MESH_DIST`` of the same
    flags on one rank in this process, the ranks' parameters equal, one
    ``-p<rank>`` run file a rank; (b) the same with ``--remat``; (c)
    ``--resilient --save-every 4 --steps-per-call 4`` with a raised fault
    before step 6 on every rank: the trajectory and parameters bit for
    bit the unfaulted world's, one restart, and its last snapshot
    restored on one rank in this process equal to the world's gathered
    parameters bit for bit.  K1f, K1b and K3 launched on every rank, held
    against their plain versions at the shapes the ranks ran them at
    (phase 27's holds).  With four cards (NCCL), a world of four: (d)
    the LM at ``--dp 2 --tp 2`` through ``Trainer.fit``, two eager fits
    and one of k = 4 supersteps, each rank's superstep one CUDA graph
    with its collectives, bit for bit; launches at capture and, by kernel
    name, in a profiled replay (K1f, K1b, K3); ms a step eagerly and as a
    graph; a gathered snapshot saved and restored on the world and
    restored (and saved again) on one rank, timed, bit for bit; (e)
    phase 9's DLRM under ``dlrm_strategy(4)`` (its tables a quarter a
    rank), the same with K4 and K5; (f) the chaos scenarios at ``n2c2``,
    k = 8 graphs, each recovering bit for bit.
32. **The layer-wise pipeline** (``mesh-pipeline``, ``MESH_PIPE``:
    ``runtime/pipeline.py``'s ``PipelineExecutor`` through the apps on a
    world of four, ``flexflow_torch/tools/mesh_pipeline.py::chip_apps``
    the rank body; gloo with every rank on one card, NCCL a card a rank
    with four).  (a) ``apps.alexnet -s strategies/alexnet_readme_4dev.json
    --microbatches 4`` (the reference README's table: six stages, GPU 0
    in five of them, ``[0, 2, 1, 3]`` one of its own) at image 229 and
    1000 classes in f32, batch 64 over gloo on one card (256 over NCCL),
    1 + 2 SGD steps under 1f1b and under gpipe: losses within
    ``TOL_MESH_LOSS`` and parameters within ``TOL_MESH_DIST`` of the same
    app on one rank in this process (the plain Executor, same seed and
    batch), every rank's losses the same, K3 once each way a microbatch
    on the last stage's rank and nowhere else, gpipe and 1f1b bit for bit.
    (b) ``apps.nmt --pipeline`` at bench.py's widths in bf16 (encoder on
    ranks {0, 1}, decoder on {2, 3}), plain SGD so the word embeddings
    take the row path: at ``--microbatches 1`` held against the app on
    one rank (Dropout's masks are one rank's only at m = 1), at 2 under
    1f1b and gpipe bit for bit; K3 on the decoder ranks, K4 a
    microbatch's backward and K5 once a step on every rank (each holds an
    embedding).  (c) The loss seeded with 1 instead of ``1/m``
    (``mesh_pipeline.FAULTS["seed_one"]``) must break a bar.  (d) The
    AlexNet 1f1b run and the NMT m = 1 run time one more step with every
    hand-off synchronised alone: ms a step a rank and the hand-offs'
    share.  K3 at the last stages' microbatch shapes (AlexNet (16, 1000)
    f32, NMT (320, 20480) bf16) and K4 at an embedding stage's 320 ids,
    held against their plain versions, timed beside them, the library
    call and the bound.  (e) The chunked and the compiled pipeline in
    the same world: AlexNet with ``--pipeline-chunk 2`` and NMT with
    ``--pipeline-chunk 2`` (= m), each bit for bit its 1f1b arm; NMT
    with ``--pipeline-compiled --steps-per-call 3`` (the gloo loop on
    one card, one CUDA graph a rank with its NCCL hand-offs on four) bit
    for bit a host-driven run of the same six steps; K3/K4/K5 by rank in each, and on four cards
    the compiled graph's launches at capture and by kernel name in a
    profiled replay; ms a step by rank host-driven, chunked and
    compiled; ``runtime/chaos.py``'s ``pipeline_superstep_nan`` on the
    world (two stages of two), recovering bit for bit.

Then it prints a ``kernels`` JSON line (``launches``: the serve, train,
DLRM, long-context, race, AlexNet, superstep, serve-features,
serve-resilience, NMT, CNN, Candle, MoE, item-7, scheduled and fleet
runs together, and phases 27's, 28's, 29's, 30's, 31's and 32's ranks
(``mesh_pipeline_*``), split in ``launches_by_path``; K3's and K4's
``mesh_pipeline_*_shape`` rows at phase 32's microbatch shapes; K1f's
and K6's ``mesh_serve_shapes`` rows at phase 29's rank-local shapes,
K1f's and K1b's ``mesh_seq_shapes`` at phase 30's ring chunks; the
superstep, serve-features, serve-resilience and item-7 paths count what
their graph runs launched eagerly or captured; K3's entries name the
form each main-path shape takes, and K3's, K4's and K5's carry the NMT
shape, K3's the CNN catalog's), the card's name and power limit from
``nvidia-smi``, and as its last line the JSON object ``{"ok": true,
"device": {...}}``. Without a CUDA device it exits 2 and prints no
result.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

#: H100 SXM published peaks (NVIDIA data sheet, dense): HBM bytes/s and
#: FLOP/s by operand type (f32 outside the tensor cores).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

#: The serving configuration of phase 2 and 3 (the shapes bench.py's
#: serving leg uses for this model).
SERVE = dict(vocab=32768, d_model=512, heads=8, layers=6, max_seq=128,
             max_batch=8, buckets=(64, 128), requests=16, prompt=(4, 32),
             max_new=32, decode_steps=8, seed=0)

TOL_O = {"float32": 1e-4, "bfloat16": 2e-2}
TOL_LSE = 1e-3
#: Phase 1's K6 cases: cache shapes (B, S, h, hd) and each slot's length.
#: The serve shape and a long cache (timed, ``DECODE_TIMED``), one slot of
#: one key in 4096 (every split but the first empty), an S that is not a
#: multiple of the chunk length (33 keys), the head dims 8, 24, 72 and 128,
#: and B h of 264 and 528 (two splits, one).
DECODE_CASES = (
    ((8, 128, 8, 64), (5, 128, 1, 33, 47, 64, 99, 20)),
    ((4, 4096, 8, 64), (1, 4096, 1023, 2049)),
    ((1, 4096, 8, 64), (1,)),
    ((2, 1000, 4, 64), (1000, 517)),
    ((3, 300, 4, 8), (300, 1, 177)),
    ((3, 300, 4, 24), (13, 300, 64)),
    ((3, 300, 4, 72), (299, 2, 150)),
    ((3, 300, 4, 128), (300, 100, 33)),
    ((33, 256, 8, 64), tuple(256 - (37 * i) % 256 for i in range(33))),
    ((66, 64, 8, 64), tuple(64 - (7 * i) % 64 for i in range(66))),
)
DECODE_TIMED = ((8, 128, 8, 64), (4, 4096, 8, 64))
#: Flash attention (K1f's o, K1b's dq/dk/dv) against the plain versions,
#: element by element: ``|got - want| <= rtol |want| + arel * mass``,
#: where ``mass`` is the sum of the absolute terms the element adds up
#: (``_flash_fwd_close``, ``_flash_bwd_mass``).  f32: sums taken in
#: another order.  bf16: the output one ulp apart (2^-7 of itself), and
#: the terms' operands rounded to bf16 on each side: K1f rounds ``p``
#: against its running row maximum, so every term seen before the row's
#: maximum may move by 2^-8 of itself; K1b rounds ``p`` and ``ds`` from
#: the same lse and delta as the plain version, so only the rare values
#: that straddle a rounding boundary move.
#: The bf16 K1b, K1sb and b2 (``stream_bwd``) are held to the bounds of
#: ``bwd`` plus one bf16 ulp of the element's largest term (``atop *
#: top``, ``_flash_bwd_top``): their scores come from the tensor cores and
#: their exponent from ex2 of one FFMA, so a ``p`` or ``ds`` that
#: straddles a rounding boundary rounds the other way more often than in
#: the f32 FMA kernels; it moves its term by one ulp, at most 2^-7 of the
#: term, and in a sum of a few terms that cancel one such move is more
#: than 2^-11 of the mass.  ``bwd`` holds the f32 K1b (the same numbers as
#: ``stream_bwd``'s f32 row).
TOL_ELEM = {
    "fwd": {"float32": (0.0, 2.0 ** -18), "bfloat16": (2.0 ** -7, 2.0 ** -8)},
    "bwd": {"float32": (0.0, 2.0 ** -18), "bfloat16": (2.0 ** -7, 2.0 ** -11)},
    "stream_bwd": {"float32": (0.0, 2.0 ** -18, 0.0),
                   "bfloat16": (2.0 ** -7, 2.0 ** -11, 2.0 ** -7)},
}
#: K3's dlogits against the plain version, element by element: both
#: sides compute one f32 value from the same lse and round it once, so
#: ``rtol |want|`` (f32: expf against torch.exp; bf16: one ulp), plus
#: 1e-5 |g_nll| at the label, where ``p g - g_nll`` may cancel.
TOL_XENT_BWD = {"float32": 1e-5, "bfloat16": 2.0 ** -7}
#: K3's per-row nll and lse: f32 sums of up to 32771 exponentials.
TOL_XENT = 1e-4

#: The training configuration of phase 5 (bench.py's LM leg,
#: ``_bench_lm(batch=16, seq=2048, layers=6)``).
TRAIN = dict(batch=16, seq=2048, layers=6, vocab=32768, d_model=512,
             heads=8, lr=1e-4, iters=5, warmup=1, seed=1234)
#: The f32 parity step of phase 6, and its tolerances: loss absolute;
#: gradients relative to each tensor's largest magnitude plus an
#: absolute floor (the key biases' gradient is zero in exact arithmetic
#: and rounding noise on both sides); Adam's first step is about
#: lr * sign(g), so updated params are compared within 1e-3 * lr where
#: |g| >= max(1e-4 * max|g|, 1e-6) and within 2 * lr elsewhere.
PARITY_TRAIN = dict(batch=2, seq=256, layers=2, vocab=32768, d_model=512,
                    heads=8, lr=1e-4, seed=0)
TOL_TRAIN_LOSS = 1e-4
TOL_TRAIN_GRAD = (1e-4, 1e-7)

#: The DLRM configuration of phases 9 and 11: bench.py's DLRM leg on one
#: chip (``bench.py:205-235``: ``dlrm_random_benchmark_config(8)``, batch
#: 256, bf16, ``SGDOptimizer(lr=0.01)``) through ``apps.dlrm.main``, 1
#: warmup + 10 timed steps.  ``--momentum 0 --wd 0`` make the flags'
#: optimizer the leg's: FFConfig's defaults (momentum 0.9, wd 1e-4) would
#: take the dense path.
DLRM = dict(batch=256, tables=8, vocab=1_000_000, dim=64,
            bot=(64, 512, 512, 64), top=(576, 1024, 1024, 1024, 1), lr=0.01,
            iters=10, warmup=1, seed=1234)
#: The f32 step of phase 10: 8 x 100,000 x 64 tables, batch 256.
DLRM_PARITY = dict(batch=256, vocab=100_000, seed=0)
#: Phase 10's tolerances: the loss absolute; each parameter's step
#: ``p1 - p0`` within ``rtol`` of the tensor's largest step plus two f32
#: ulps of its largest value (``p1`` is rounded to f32 on each side); each
#: optimizer state tensor within ``rtol`` of its largest magnitude plus
#: ``atol`` (f32 sums in another order on the two sides).  Lazy Adam's
#: first step is about lr * sign(g), so its params are held as in phase 6.
TOL_DLRM_LOSS = 1e-5
TOL_DLRM_STEP = (1e-4, 1e-9)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def _zero_counts() -> None:
    """Sets the launch count of every kernel wrapper of the port to 0."""
    from flexflow_torch.ops import probe_kernels

    for fn in probe_kernels.KERNELS:
        fn.launches = 0


def _counts() -> dict:
    """{wrapper name: launches} for every kernel wrapper of the port."""
    from flexflow_torch.ops import probe_kernels

    return {fn.__name__: fn.launches for fn in probe_kernels.KERNELS}


def _device_ms(fn, reps: int = 20) -> float:
    """Median device time of ``fn()`` over ``reps`` runs, by CUDA
    events.  Each run first parks the GPU in a ~1 ms spin so that the
    host has enqueued the whole call before the first event fires: the
    events then bracket device work only, not host launch overhead."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _pair_ms(a, b, reps: int = 20):
    """Device ms of ``a()`` and ``b()`` timed in turns (a, b, b, a) in one
    warm process, each the mean of its two medians (``_device_ms``)."""
    ta = _device_ms(a, reps)
    tb = _device_ms(b, reps)
    tb = (tb + _device_ms(b, reps)) / 2
    return (ta + _device_ms(a, reps)) / 2, tb


def _bound_ms(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else
                                       "operations")


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


def phase_kernels(torch, kernels, F):
    """Build, check and time both kernels; returns per-kernel rows for
    the main-path shapes (bf16 prefill at bucket 64, bf16 decode)."""
    t0 = time.perf_counter()
    built = kernels.build()
    print(f"[kernels] built {sorted(built) or 'nothing (cached)'} in "
          f"{time.perf_counter() - t0:.1f}s")
    g = torch.Generator(device="cuda").manual_seed(0)
    rows = {}

    def randn(shape, dt):
        return torch.randn(shape, generator=g, device="cuda").to(dt)

    # -- K1f: flash-attention forward --
    for shape in ((1, 8, 64, 64), (1, 8, 128, 64), (2, 8, 2048, 64),
                  (1, 8, 80, 64)):
        for causal in (True, False):
            for dt in (torch.float32, torch.bfloat16):
                q, k, v = (randn(shape, dt) for _ in range(3))
                o, lse = kernels.flash_attention_lse(q, k, v, causal)
                po, plse = kernels.flash_attention_lse_plain(q, k, v, causal)
                torch.cuda.synchronize()
                err_o = (o.float() - po.float()).abs().max().item()
                err_lse = (lse - plse).abs().max().item()
                elem = _flash_fwd_close(kernels, q, k, v, causal, o, po)
                name = _dtype_name(dt)
                _check(math.isfinite(err_o) and err_o <= TOL_O[name]
                       and err_lse <= TOL_LSE and elem <= 1.0,
                       f"flash_attention_lse {shape} causal={causal} {name}: "
                       f"|o| err {err_o} ({elem:.3g} of the element "
                       f"tolerance), |lse| err {err_lse}")
                ms = _device_ms(lambda: kernels.flash_attention_lse(q, k, v, causal))
                plain_ms = _device_ms(
                    lambda: kernels.flash_attention_lse_plain(q, k, v, causal))
                lib_ms = _device_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=causal))
                b, h, t, hd = shape
                pairs = t * (t + 1) // 2 if causal else t * t
                itemsize = q.element_size()
                nbytes = 4 * b * h * t * hd * itemsize + b * h * t * 4
                bound, by = _bound_ms(nbytes, 4 * b * h * hd * pairs, name)
                print(f"[kernels] flash_attention_lse {shape} causal={causal} "
                      f"{name}: err o {err_o:.3g} ({elem:.3g} of the element "
                      f"tolerance) lse {err_lse:.3g}; "
                      f"{ms:.4f} ms (plain {plain_ms:.4f}, sdpa {lib_ms:.4f}, "
                      f"bound {bound:.5f} by {by})")
                if shape == (1, 8, 64, 64) and causal and dt == torch.bfloat16:
                    rows["flash_attention_lse"] = dict(
                        max_abs_err=err_o, ms=ms, plain_ms=plain_ms,
                        bound_ms=bound, bound_by=by, library_ms=lib_ms)
    # The head dims the bf16 kernel pads to a tile width of 32, 64 or 128,
    # at ragged lengths (checked, not timed).
    worst, n = 0.0, 0
    for hd in (8, 24, 72, 128):
        for t in (1, 80, 130):
            for causal in (True, False):
                for dt in (torch.float32, torch.bfloat16):
                    q, k, v = (randn((1, 2, t, hd), dt) for _ in range(3))
                    o, lse = kernels.flash_attention_lse(q, k, v, causal)
                    po, plse = kernels.flash_attention_lse_plain(q, k, v,
                                                                 causal)
                    torch.cuda.synchronize()
                    elem = _flash_fwd_close(kernels, q, k, v, causal, o, po)
                    err_lse = (lse - plse).abs().max().item()
                    _check(elem <= 1.0 and err_lse <= TOL_LSE,
                           f"flash_attention_lse (1, 2, {t}, {hd}) causal="
                           f"{causal} {_dtype_name(dt)}: {elem} of the "
                           f"element tolerance, |lse| err {err_lse}")
                    worst, n = max(worst, elem), n + 1
    print(f"[kernels] flash_attention_lse at hd 8/24/72/128 x t 1/80/130, "
          f"causal and not, f32 and bf16 ({n} cases): worst element "
          f"{worst:.3g} of its tolerance")
    for width in (32, 64, 128):
        print(f"[kernels] bf16 K1f/K1b at tile width {width}: " + ", ".join(
            f"{k} {r} registers, {sp} spilled bytes, {sm} B shared"
            for k, (r, sp, sm) in kernels.flash_attrs(width).items()))
    # The host side of one K1f call at the serve shape: the bf16 wrapper
    # encodes three tensor maps per call, the f32 one none.
    host = {}
    for dt in (torch.float32, torch.bfloat16):
        q, k, v = (randn((1, 8, 64, 64), dt) for _ in range(3))
        with torch.no_grad():
            kernels.flash_attention_lse(q, k, v, True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(200):
                kernels.flash_attention_lse(q, k, v, True)
            host[_dtype_name(dt)] = (time.perf_counter() - t0) / 200 * 1e6
            torch.cuda.synchronize()
    print(f"[kernels] host side of one flash_attention_lse call at (1, 8, "
          f"64, 64), mean of 200 unsynchronised calls: bf16 "
          f"{host['bfloat16']:.2f} us, f32 {host['float32']:.2f} us")

    # -- K6: flash decode (split-K), every element and two launches --
    worst = 0.0
    for (B, S, h, hd), lens in DECODE_CASES:
        for dt in (torch.float32, torch.bfloat16):
            q = randn((B, h, hd), dt)
            ck, cv = randn((B, S, h, hd), dt), randn((B, S, h, hd), dt)
            lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
            o = kernels.flash_decode(q, ck, cv, lengths)
            again = kernels.flash_decode(q, ck, cv, lengths)
            po = kernels.flash_decode_plain(q, ck, cv, lengths)
            torch.cuda.synchronize()
            err_o = (o.float() - po.float()).abs().max().item()
            elem = _decode_close(kernels, q, ck, cv, lengths, o, po)
            splits = kernels.decode_splits(B, S, h)
            name = _dtype_name(dt)
            _check(math.isfinite(err_o) and err_o <= TOL_O[name]
                   and elem <= 1.0 and torch.equal(o, again),
                   f"flash_decode {(B, S, h, hd)} ({splits} splits) {name}: "
                   f"|o| err {err_o} ({elem:.3g} of the element tolerance), "
                   f"two launches equal: {torch.equal(o, again)}")
            worst = max(worst, elem)
            if (B, S, h, hd) not in DECODE_TIMED:
                continue
            ms = _device_ms(lambda: kernels.flash_decode(q, ck, cv, lengths))
            plain_ms = _device_ms(
                lambda: kernels.flash_decode_plain(q, ck, cv, lengths))
            qs = q[:, :, None]
            ks, vs = ck.transpose(1, 2), cv.transpose(1, 2)
            mask = (torch.arange(S, device="cuda")[None, :]
                    < lengths[:, None])[:, None, None, :]
            lib_ms = _device_ms(lambda: F.scaled_dot_product_attention(
                qs, ks, vs, attn_mask=mask))
            keys = sum(lens)
            itemsize = q.element_size()
            nbytes = (2 * keys * h * hd * itemsize + 2 * B * h * hd * itemsize
                      + 4 * B)
            bound, by = _bound_ms(nbytes, 4 * h * hd * keys, name)
            print(f"[kernels] flash_decode {(B, S, h, hd)} lengths {list(lens)} "
                  f"{name}: err o {err_o:.3g} ({elem:.3g} of the element "
                  f"tolerance); {splits} splits, {ms:.4f} ms (plain "
                  f"{plain_ms:.4f}, sdpa masked {lib_ms:.4f}, bound "
                  f"{bound:.5f} by {by})")
            if dt == torch.bfloat16:
                key = ("flash_decode" if (B, S, h, hd) == DECODE_TIMED[0]
                       else f"flash_decode@{(B, S, h, hd)}")
                rows[key] = dict(
                    max_abs_err=err_o, ms=ms, plain_ms=plain_ms,
                    bound_ms=bound, bound_by=by, library_ms=lib_ms,
                    splits=splits)
    print(f"[kernels] flash_decode at {len(DECODE_CASES)} shapes (splits "
          f"{sorted({kernels.decode_splits(*c[0][:3]) for c in DECODE_CASES})}"
          f", hd 8/24/64/72/128, f32 and bf16): worst element {worst:.3g} "
          f"of its tolerance, every pair of launches bit-identical")
    return rows


def _close(got, want, mass, rtol: float, arel: float, top=None,
           atop: float = 0.0) -> float:
    """The worst ``|got - want| / (rtol |want| + arel mass + atop top)``
    over every element (above 1 fails); where that tolerance is 0 the two
    must be equal, and a non-finite ``got`` gives ``inf``."""
    got, want = got.float(), want.float()
    if not bool(got.isfinite().all()):
        return math.inf
    err = (got - want).abs()
    tol = rtol * want.abs() + arel * mass.float()
    if top is not None:
        tol = tol + atop * top.float()
    ratio = (err / tol).nan_to_num(nan=0.0)  # 0/0: equal where tol is 0
    return ratio.max().item()


def _flash_bwd_mass(q, k, v, o, lse, do, g_lse, causal, rows: int = 4096):
    """Per element of ``(dq, dk, dv)``, the sum of the absolute terms
    the backward adds up, in f32, one head and ``rows`` query rows at a
    time: ``p^T |do|`` for dv, and ``scale |ds| |k|`` / ``scale |ds|^T |q|``
    for dq / dk with ``|ds|`` taken as ``p (|do| |v|^T + rowsum |o do| +
    |g_lse|)``, since ``dp - delta`` may cancel down to the rounding of
    its terms."""
    import torch

    b, h, t, hd = q.shape
    scale = 1.0 / math.sqrt(hd)
    out = tuple(torch.empty((b, h, t, hd), device=q.device) for _ in range(3))
    cols = torch.arange(t, device=q.device)
    for i in range(b):
        for j in range(h):
            qi, ki, vi, oi, doi = (x[i, j].float() for x in (q, k, v, o, do))
            mk = torch.zeros((t, hd), device=q.device)
            mv = torch.zeros((t, hd), device=q.device)
            for r in range(0, t, rows):
                sl = slice(r, min(t, r + rows))
                s = qi[sl] @ ki.transpose(0, 1) * scale
                if causal:
                    s = s.masked_fill(cols[None, :] > cols[sl, None], -math.inf)
                p = torch.exp(s - lse[i, j, sl, None])
                delta = (oi[sl] * doi[sl]).abs().sum(-1) + g_lse[i, j, sl].abs()
                ds = p * (doi[sl].abs() @ vi.abs().transpose(0, 1)
                          + delta[:, None])
                out[0][i, j, sl] = scale * ds @ ki.abs()
                mk += scale * ds.transpose(0, 1) @ qi[sl].abs()
                mv += p.transpose(0, 1) @ doi[sl].abs()
                del s, p, ds
            out[1][i, j] = mk
            out[2][i, j] = mv
    return out


def _flash_bwd_top(q, k, v, o, lse, do, g_lse, causal):
    """Per element of ``(dq, dk, dv)``, its largest absolute term, in
    f32, one head and a block of query rows at a time: ``scale |ds_ij|
    |k_j|`` over keys j for dq, ``scale |ds_ij| |q_i|`` over queries i for
    dk, ``p_ij |do_i|`` for dv.  One ``p`` or ``ds`` that rounds to the
    other side of a bf16 boundary moves its element by one ulp of its
    term, at most 2^-7 of this."""
    import torch

    b, h, t, hd = q.shape
    scale = 1.0 / math.sqrt(hd)
    out = tuple(torch.empty((b, h, t, hd), device=q.device) for _ in range(3))
    cols = torch.arange(t, device=q.device)
    rows = max(1, (1 << 27) // (t * hd))  # 512 MB per (rows, t, hd) temporary
    for i in range(b):
        for j in range(h):
            qi, ki, vi, oi, doi = (x[i, j].float() for x in (q, k, v, o, do))
            aq, ak, ado = qi.abs(), ki.abs(), doi.abs()
            delta = (oi * doi).sum(-1) - g_lse[i, j].float()
            tk = torch.zeros((t, hd), device=q.device)
            tv = torch.zeros((t, hd), device=q.device)
            for r in range(0, t, rows):
                sl = slice(r, min(t, r + rows))
                s = qi[sl] @ ki.transpose(0, 1) * scale
                if causal:
                    s = s.masked_fill(cols[None, :] > cols[sl, None], -math.inf)
                p = torch.exp(s - lse[i, j, sl, None])
                ds = (p * (doi[sl] @ vi.transpose(0, 1) - delta[sl, None])).abs()
                out[0][i, j, sl] = (ds[:, :, None] * ak[None]).amax(1) * scale
                tk = torch.maximum(
                    tk, (ds[:, :, None] * aq[sl, None]).amax(0) * scale)
                tv = torch.maximum(tv, (p[:, :, None] * ado[sl, None]).amax(0))
                del s, p, ds
            out[1][i, j] = tk
            out[2][i, j] = tv
    return out


def _flash_fwd_close(kernels, q, k, v, causal, o, po) -> float:
    """K1f's ``o`` against the plain ``po`` by ``_close``: the mass of
    ``o = sum_j p_j v_j / l`` is the plain forward over ``|v|``."""
    mass = kernels.flash_attention_lse_plain(q, k, v.abs(), causal)[0]
    return _close(o, po, mass, *TOL_ELEM["fwd"][_dtype_name(q.dtype)])


def _decode_close(kernels, q, ck, cv, lengths, o, po) -> float:
    """K6's ``o`` against the plain ``po`` by ``_close`` with K1f's rule
    (``TOL_ELEM["fwd"]``): the mass of ``o = sum_j p_j v_j / l`` is the
    plain decode over ``|v|``.  K6 rounds ``p`` against the running
    maximum of its key group, as the reference rounds it against the
    running maximum of its key block, and merges the splits in f32."""
    mass = kernels.flash_decode_plain(q, ck, cv.abs(), lengths)
    return _close(o, po, mass, *TOL_ELEM["fwd"][_dtype_name(q.dtype)])


def _xent_bwd_close(d, pd, labels, g_nll, rtol, rows=4096) -> float:
    """K3's dlogits against the plain ``pd`` by ``_close``, ``rows`` rows
    at a time: ``rtol |pd|``, plus ``1e-5 |g_nll|`` at each label."""
    import torch

    worst = 0.0
    for r in range(0, d.shape[0], rows):
        sl = slice(r, r + rows)
        mass = torch.zeros(pd[sl].shape, device=pd.device)
        mass[torch.arange(mass.shape[0], device=pd.device),
             labels[sl].long()] = g_nll[sl].abs()
        worst = max(worst, _close(d[sl], pd[sl], mass, rtol, 1e-5))
    return worst


#: K3's two forms (``kernels._xent_form``): row groups, a CTA per row.
XENT_FORMS = ("rows", "cta")


def xent_cases(kernels):
    """K3's (N, V, dtype) cases of phase 2 beyond the timed shapes, each
    held in both forms: 2 and 10 classes (8 lanes a row, scalar loads),
    1000 and 1001 (a warp a row, 16-byte and scalar loads), the forms'
    crossover plus and minus 8, the LM's 32768 and a ragged 32771; 300
    rows, which fill no whole CTA of row groups."""
    cross = kernels._XENT_ROWS_MAX_V
    return [(300, v, name)
            for v in (2, 10, 1000, 1001, cross - 8, cross + 8, 32768, 32771)
            for name in ("float32", "bfloat16")]


def _xent_tie_cols(v: int):
    """Column sets of planted equal maxima, a row each, where K3's forms
    split a row into vectors of 8 (bf16 16-byte loads, the CTA per row's
    f32 pairs), 4 (f32 16-byte loads) or 1 element (scalar loads): inside
    one vector (3, 5; 1, 2); across two lanes of one warp (vectors 1 and
    2); across a lane's two vectors at each stride of the forms (groups of
    8, 16 and 32 lanes, a CTA of 256 threads); at the row's two ends; and
    three at once.  Sets with fewer than two columns in the row drop out;
    the first index of each set is the expected ``pred``."""
    sets = [(3, 5), (1, 2)]
    for width in (8, 4, 1):
        sets.append((width, 2 * width))
        sets += [(width, width + width * lanes) for lanes in (8, 16, 32, 256)]
    sets += [(v - 1, 0), (100, 7, v - 2)]
    out = []
    for cols in sets:
        cols = tuple(dict.fromkeys(c for c in cols if 0 <= c < v))
        if len(cols) >= 2 and cols not in out:
            out.append(cols)
    return out


def _xent_inputs(torch, g, n: int, v: int, name: str):
    """Logits (3 randn, in dtype ``name``) with the planted ties of
    :func:`_xent_tie_cols` in the first rows, and int32 labels over every
    class with some at 0, V - 1, the first and last element of the last
    8-element vector, a warp lane's second vector (bf16 16-byte: 8 x 32 +
    3; f32 16-byte: 4 x 32 + 3; scalar: 32 + 3), and the last row's out of
    range (V).  Returns (x, labels, the tie column sets)."""
    x = 3.0 * torch.randn((n, v), generator=g, device="cuda")
    tie_cols = _xent_tie_cols(v)
    top = x.max() + 1.0
    for r, cols in enumerate(tie_cols):
        x[r, list(cols)] = top
    labels = torch.randint(0, v, (n,), generator=g, device="cuda",
                           dtype=torch.int32)
    planted = [0, v - 1, (v - 1) // 8 * 8, max(v - 2, 0), 259 % v, 131 % v,
               35 % v]
    labels[n - 1 - len(planted):n - 1] = torch.tensor(
        planted, device="cuda", dtype=torch.int32)
    labels[n - 1] = v
    return x.to(getattr(torch, name)), labels, tie_cols


def _xent_hold(torch, kernels, x, labels, g_nll, g_lse, form=None):
    """K3's forward and backward in ``form`` ("rows", "cta"; None: the
    chooser's) against the plain versions on the same inputs.  A label
    outside [0, V) must give a NaN nll; its row is held on lse, pred and
    dlogits, with g_nll 0 on both sides and label 0 on the plain side.
    Returns ({"nll", "lse": absolute errors of the other rows (inf if a
    NaN is missing), "dlogits": the worst element's share of
    ``TOL_XENT_BWD``, "dlogits_abs": its largest absolute error, "pred":
    mismatches}, (nll, lse, pred, dlogits, plain dlogits))."""
    v = x.shape[1]
    bad = (labels < 0) | (labels >= v)
    g_nll = g_nll.masked_fill(bad, 0.0)
    safe = labels.masked_fill(bad, 0)
    nll, lse, pred = kernels._xent_fwd(x, labels, form)
    d = kernels._xent_bwd(x, labels, lse, g_nll, g_lse, form)
    pn, pl, pp = kernels.softmax_xent_plain(x, safe)
    # The kernel's lse on both sides: the backward alone is compared.
    pd = kernels.softmax_xent_bwd_plain(x, safe, lse, g_nll, g_lse)
    torch.cuda.synchronize()
    good = ~bad
    e_nll = ((nll[good] - pn[good]).abs().max().item() if bool(good.any())
             else 0.0)
    if not bool(nll[bad].isnan().all()):
        e_nll = math.inf
    errs = dict(nll=e_nll, lse=(lse - pl).abs().max().item(),
                dlogits=_xent_bwd_close(d, pd, safe, g_nll,
                                        TOL_XENT_BWD[_dtype_name(x.dtype)]),
                pred=int((pred != pp).sum().item()),
                dlogits_abs=max((d[r:r + 4096].float() - pd[r:r + 4096].float())
                                .abs().max().item()
                                for r in range(0, d.shape[0], 4096)))
    return errs, (nll, lse, pred, d, pd)


def _xent_held(errs: dict, what: str) -> None:
    """Fails unless :func:`_xent_hold`'s errors are within ``TOL_XENT``
    (nll, lse), ``TOL_XENT_BWD``'s element rule and exact (pred)."""
    _check(errs["nll"] <= TOL_XENT and errs["lse"] <= TOL_XENT
           and errs["dlogits"] <= 1.0 and errs["pred"] == 0,
           f"{what}: nll err {errs['nll']}, lse err {errs['lse']}, dlogits "
           f"error {errs['dlogits']} of the element tolerance, "
           f"{errs['pred']} pred mismatches")


def _form_name(f) -> str:
    """A line's words for a ``kernels.XentForm``."""
    rows = "a row" if f.rows_per_cta == 1 else f"{f.rows_per_cta} rows"
    return (f"{f.form}: {f.lanes_per_row} threads a row, {rows} a CTA, "
            f"{f.loads} loads")


def phase_train_kernels(torch, kernels, F):
    """Check and time K1b and K3 (and K1f at the training shape);
    returns per-kernel rows for the training path's shapes."""
    g = torch.Generator(device="cuda").manual_seed(1)
    rows = {}

    def randn(shape, dt, scale=1.0):
        return (scale * torch.randn(shape, generator=g, device="cuda")).to(dt)

    # -- K1b: flash-attention backward --
    train_shape = (TRAIN["batch"], TRAIN["heads"], TRAIN["seq"],
                   TRAIN["d_model"] // TRAIN["heads"])
    # The timed training shape, the shapes of earlier slices, then the
    # head dims the bf16 kernels pad (8, 24, 72, 128) at ragged lengths.
    cases = [(train_shape, True, torch.bfloat16),
             ((2, 8, 80, 64), False, torch.float32),
             ((2, 8, 80, 64), True, torch.bfloat16),
             ((1, 8, 1, 64), True, torch.float32),
             ((1, 2, 130, 128), False, torch.bfloat16),
             ((2, 4, 256, 32), True, torch.float32)]
    n_named = len(cases)
    cases += [((1, 2, t, hd), causal, dt) for hd in (8, 24, 72, 128)
              for t in (1, 80, 130) for causal in (True, False)
              for dt in (torch.bfloat16, torch.float32)]
    worst_small = 0.0
    for i_case, (shape, causal, dt) in enumerate(cases):
        name = _dtype_name(dt)
        q, k, v = (randn(shape, dt) for _ in range(3))
        o, lse = kernels.flash_attention_lse_plain(q, k, v, causal)
        do, g_lse = randn(shape, dt), randn(shape[:3], torch.float32)
        got = kernels.flash_attention_lse_bwd(q, k, v, o, lse, do, g_lse,
                                              causal)
        again = kernels.flash_attention_lse_bwd(q, k, v, o, lse, do, g_lse,
                                                causal)
        want = kernels.flash_attention_lse_bwd_plain(q, k, v, o, lse, do,
                                                     g_lse, causal)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        # bf16 K1b runs on the tensor cores (stream_bwd), f32 on FMA (bwd).
        rtol, arel, atop = (TOL_ELEM["stream_bwd"][name] if name == "bfloat16"
                            else TOL_ELEM["bwd"][name] + (0.0,))
        mass = _flash_bwd_mass(q, k, v, o, lse, do, g_lse, causal)
        tops = (_flash_bwd_top(q, k, v, o, lse, do, g_lse, causal) if atop
                else (None,) * 3)
        err = max(_close(a, w, m, rtol, arel, tp, atop)
                  for a, w, m, tp in zip(got, want, mass, tops))
        _check(err <= 1.0 and same,
               f"flash_attention_lse_bwd {shape} causal={causal} {name}: "
               f"gradient error {err} of the element tolerance, two "
               f"launches bit-identical: {same}")
        if i_case >= n_named:
            worst_small = max(worst_small, err)
        else:
            print(f"[train-kernels] flash_attention_lse_bwd {shape} "
                  f"causal={causal} {name}: worst element {err:.3g} of its "
                  f"tolerance, two launches bit-identical")
        del mass, tops, again
        if shape != train_shape:
            continue
        b, h, t, hd = shape
        pairs = t * (t + 1) // 2 if causal else t * t
        isz = q.element_size()
        ms = _device_ms(lambda: kernels.flash_attention_lse_bwd(
            q, k, v, o, lse, do, g_lse, causal))
        plain_ms = _device_ms(lambda: kernels.flash_attention_lse_bwd_plain(
            q, k, v, o, lse, do, g_lse, causal))
        qs, ks, vs = (x.detach().clone().requires_grad_(True) for x in (q, k, v))
        out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal)
        lib_ms = _device_ms(lambda: torch.autograd.grad(
            out, (qs, ks, vs), do, retain_graph=True))
        # Five t x t x hd products (s, dp, dv, dq, dk) over the causal
        # pairs; q, k, v, o, do, lse, g_lse read once, dq, dk, dv written.
        bound, by = _bound_ms(8 * b * h * t * hd * isz + 2 * b * h * t * 4,
                              10 * b * h * hd * pairs, name)
        print(f"[train-kernels] flash_attention_lse_bwd {shape} {name}: "
              f"{ms:.4f} ms (plain {plain_ms:.4f}, sdpa backward "
              f"{lib_ms:.4f}, bound {bound:.5f} by {by})")
        rows["flash_attention_lse_bwd"] = dict(
            max_abs_err=max((a.float() - w.float()).abs().max().item()
                            for a, w in zip(got, want)),
            ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
            library_ms=lib_ms)
        # K1f at the training shape (a row of its own in PERF.md).
        fo, flse = kernels.flash_attention_lse(q, k, v, causal)
        torch.cuda.synchronize()
        f_err = (fo.float() - o.float()).abs().max().item()
        f_elem = _flash_fwd_close(kernels, q, k, v, causal, fo, o)
        _check(f_err <= TOL_O[name] and f_elem <= 1.0
               and (flse - lse).abs().max().item() <= TOL_LSE,
               f"flash_attention_lse {shape}: |o| err {f_err} ({f_elem} of "
               f"the element tolerance)")
        with torch.no_grad():
            f_ms = _device_ms(lambda: kernels.flash_attention_lse(q, k, v,
                                                                  causal))
        f_plain = _device_ms(lambda: kernels.flash_attention_lse_plain(
            q, k, v, causal))
        f_lib = _device_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal))
        f_bound, f_by = _bound_ms(4 * b * h * t * hd * isz + b * h * t * 4,
                                  4 * b * h * hd * pairs, name)
        print(f"[train-kernels] flash_attention_lse {shape} causal {name}: "
              f"worst element {f_elem:.3g} of its tolerance; {f_ms:.4f} ms (plain {f_plain:.4f}, sdpa {f_lib:.4f}, bound "
              f"{f_bound:.5f} by {f_by})")
        rows["flash_attention_lse@train"] = dict(
            max_abs_err=f_err, ms=f_ms, plain_ms=f_plain, bound_ms=f_bound,
            bound_by=f_by, library_ms=f_lib)
        del q, k, v, o, lse, do, got, want, qs, ks, vs, out, fo

    print(f"[train-kernels] flash_attention_lse_bwd at hd 8/24/72/128 x t "
          f"1/80/130, causal and not, bf16 and f32: worst element "
          f"{worst_small:.3g} of its tolerance, every case bit-identical "
          f"across two launches")

    # -- K3: fused softmax cross-entropy, forward and backward --
    n_main = TRAIN["batch"] * TRAIN["seq"]
    for n, v, dt, ties in ((n_main, TRAIN["vocab"], torch.bfloat16, False),
                           (1000, 32771, torch.bfloat16, False),
                           (1000, 32771, torch.float32, False),
                           (512, 32768, torch.float32, True)):
        name = _dtype_name(dt)
        x = randn((n, v), torch.float32, 3.0)
        labels = torch.randint(0, v, (n,), generator=g, device="cuda",
                               dtype=torch.int32)
        labels[:4] = torch.tensor([0, v - 1, 8 * 256 - 1, 8 * 256],
                                  device="cuda", dtype=torch.int32)
        if ties:
            # Equal maxima inside one 8-element chunk, across the chunks
            # of one thread, across threads and at the row's two ends.
            top = x.max() + 1.0
            for r, cols in enumerate(((3, 5), (9, 2048 + 9), (2047, 2048),
                                      (v - 1, 0), (100, 7, 30000))):
                x[r, list(cols)] = top
        x = x.to(dt)
        gn = torch.full((n,), 1.0 / n, device="cuda")
        gl = randn((n,), torch.float32)
        held = {}
        for form in XENT_FORMS:
            held[form] = _xent_hold(torch, kernels, x, labels, gn, gl, form)
            errs, (nll, lse, pred, d, pd) = held[form]
            _xent_held(errs, f"softmax_xent ({n}, {v}) {name} {form}")
            if ties:
                _check([int(pred[r]) for r in range(5)] == [3, 9, 2047, 0, 7],
                       f"softmax_xent {form} ties: pred {pred[:5].tolist()}")
            print(f"[train-kernels] softmax_xent ({n}, {v}) {name}"
                  f"{' ties' if ties else ''}, {form} form: nll err "
                  f"{errs['nll']:.3g} lse err {errs['lse']:.3g}, dlogits worst "
                  f"element {errs['dlogits']:.3g} of its tolerance, pred exact")
        if n != n_main:
            del held
            continue
        # The timed shape in the form the chooser gives it.
        form = kernels._xent_form(v).form
        errs, (nll, lse, pred, d, pd) = held.pop(form)
        del held
        isz = x.element_size()
        ms = _device_ms(lambda: kernels.softmax_xent(x, labels))
        plain_ms = _device_ms(lambda: kernels.softmax_xent_plain(x, labels))
        lab64 = labels.long()
        lib_ms = _device_ms(lambda: F.cross_entropy(x, lab64,
                                                    reduction="none"))
        # Logits read once, labels read, nll/lse/pred written; about four
        # f32 operations per logit (max, subtract, exp, sum).
        bound, by = _bound_ms(n * v * isz + 16 * n, 4 * n * v, "float32")
        print(f"[train-kernels] softmax_xent ({n}, {v}) {name}, {form} form: "
              f"{ms:.4f} ms (plain {plain_ms:.4f}, F.cross_entropy "
              f"{lib_ms:.4f}, bound {bound:.5f} by {by})")
        rows["softmax_xent"] = dict(
            max_abs_err=max(errs["nll"], errs["lse"]), ms=ms,
            plain_ms=plain_ms, bound_ms=bound, bound_by=by,
            library_ms=lib_ms, form=_form_name(kernels._xent_form(v)))
        b_ms = _device_ms(lambda: kernels.softmax_xent_bwd(x, labels, lse,
                                                           gn, gl))
        b_plain = _device_ms(lambda: kernels.softmax_xent_bwd_plain(
            x, labels, lse, gn, gl))
        xr = x.detach().clone().requires_grad_(True)
        ce = F.cross_entropy(xr, lab64, reduction="none")
        gce = gn.to(ce.dtype)
        b_lib = _device_ms(lambda: torch.autograd.grad(ce, xr, gce,
                                                       retain_graph=True))
        # Logits read and dlogits written once, rows' scalars read; about
        # four f32 operations per logit (subtract, exp, multiply, select).
        b_bound, b_by = _bound_ms(2 * n * v * isz + 16 * n, 4 * n * v,
                                  "float32")
        print(f"[train-kernels] softmax_xent_bwd ({n}, {v}) {name}, {form} "
              f"form: {b_ms:.4f} ms (plain {b_plain:.4f}, F.cross_entropy "
              f"backward {b_lib:.4f}, bound {b_bound:.5f} by {b_by})")
        rows["softmax_xent_bwd"] = dict(
            max_abs_err=(d.float() - pd.float()).abs().max().item(),
            ms=b_ms, plain_ms=b_plain, bound_ms=b_bound, bound_by=b_by,
            library_ms=b_lib, form=rows["softmax_xent"]["form"])
        del xr, ce, gce, pd, d, nll, lse, pred
    worst = dict(nll=0.0, lse=0.0, dlogits=0.0)
    for n, v, name in xent_cases(kernels):
        x, labels, tie_cols = _xent_inputs(torch, g, n, v, name)
        gn = torch.full((n,), 1.0 / n, device="cuda")
        gl = randn((n,), torch.float32)
        for form in XENT_FORMS:
            errs, (nll, lse, pred, d, pd) = _xent_hold(torch, kernels, x,
                                                       labels, gn, gl, form)
            what = f"softmax_xent ({n}, {v}) {name} {form}"
            _xent_held(errs, what)
            got = [int(pred[r]) for r in range(len(tie_cols))]
            _check(got == [min(c) for c in tie_cols],
                   f"{what}: planted ties {tie_cols} gave pred {got}")
            worst = {k: max(worst[k], errs[k]) for k in worst}
    print(f"[train-kernels] softmax_xent at V "
          f"{sorted({v for _, v, _ in xent_cases(kernels)})}, f32 and bf16, "
          f"both forms, planted ties, labels at 0, V - 1 and the last vector, "
          f"an out-of-range label giving a NaN nll: worst nll err "
          f"{worst['nll']:.3g}, lse err {worst['lse']:.3g}, dlogits "
          f"{worst['dlogits']:.3g} of its tolerance, pred exact")
    return rows


def _serve_argv(dtype: str, c=SERVE):
    return ["--vocab", str(c["vocab"]), "--d-model", str(c["d_model"]),
            "--heads", str(c["heads"]), "--layers", str(c["layers"]),
            "--max-seq", str(c["max_seq"]), "--max-batch", str(c["max_batch"]),
            "--buckets", ",".join(map(str, c["buckets"])),
            "--requests", str(c["requests"]),
            "--prompt-len", f"{c['prompt'][0]}:{c['prompt'][1]}",
            "--max-new", str(c["max_new"]),
            "--decode-steps", str(c["decode_steps"]),
            "--dtype", dtype, "--seed", str(c["seed"])]


#: Phase 3's tokens by request id (phase 29 (a) holds a world of 1 to
#: them).
SERVE_TOKENS: dict = {}


def phase_serve(torch, kernels):
    """The app at SERVE widths in bf16.  The decode supersteps are one
    CUDA graph: the counters rise at the first call's eager steps and at
    its capture (2 x L x K for K6), never at a replay; phase 20 counts
    K6 by kernel name in a profiled replay.  Returns the launches."""
    from flexflow_torch.apps import serve

    stats = {}
    _zero_counts()
    rc = serve.main(_serve_argv("bfloat16"), device="cuda", stats_out=stats)
    torch.cuda.synchronize()
    launches = _counts()
    _check(rc == 0, f"serve exited {rc}")
    SERVE_TOKENS.update({rid: r.tokens for rid, r in
                         stats["results"].items()})
    _check(stats["completed"] == SERVE["requests"] and stats["failed"] == 0,
           f"serve completed {stats['completed']} of {SERVE['requests']}, "
           f"failed {stats['failed']}")
    L, K = SERVE["layers"], SERVE["decode_steps"]
    want = {"flash_attention_lse": L * stats["prefills"],
            "flash_decode": 2 * L * K}
    _check(stats["decode_supersteps"] > 1 and
           all(launches[n] == want[n] > 0 for n in want),
           f"launch counts {launches}, expected {want}")
    _check(all(c == 0 for n, c in launches.items() if n not in want),
           f"serving launched a training kernel: {launches}")
    steps = K * stats["decode_supersteps"]
    print(f"[serve] tokens/s {stats['tokens_per_s']:.1f}; decode "
          f"{stats['decode_s'] * 1e3 / steps:.3f} ms/step "
          f"({stats['decode_s'] * 1e3 / stats['decode_tokens']:.3f} ms/token "
          f"over {stats['decode_tokens']} tokens, the first superstep's "
          f"eager steps and capture included); latency p50 "
          f"{stats['request_latency_ms_p50']:.1f} ms p95 "
          f"{stats['request_latency_ms_p95']:.1f} ms; prefills "
          f"{stats['prefills']}, supersteps {stats['decode_supersteps']} (one "
          f"graph replay each after the first); launches {launches}")
    return launches


def phase_parity(torch):
    from flexflow_torch.config import FFConfig
    from flexflow_torch.models.transformer import build_transformer_lm
    from flexflow_torch.runtime.serving import (
        Server, ServingExecutor, synthetic_requests)

    c = SERVE
    cfg = FFConfig(compute_dtype="float32", seed=c["seed"])
    ff = build_transformer_lm(
        batch_size=c["max_batch"], seq_len=c["max_seq"],
        vocab_size=c["vocab"], d_model=c["d_model"], num_heads=c["heads"],
        num_layers=c["layers"], config=cfg)
    tokens = {}
    params = state = None
    for decode_kernel in (None, False):
        sex = ServingExecutor(ff, cfg, max_batch=c["max_batch"],
                              max_seq=c["max_seq"], buckets=c["buckets"],
                              decode_kernel=decode_kernel, device="cuda")
        if params is None:
            params, state = sex.init(c["seed"])
        reqs = synthetic_requests(c["requests"], c["vocab"],
                                  prompt_len=c["prompt"],
                                  max_new_tokens=c["max_new"], seed=c["seed"])
        results, stats = Server(sex, params, state,
                                decode_steps=c["decode_steps"]).run(reqs)
        _check(stats["failed"] == 0, f"f32 serve (decode_kernel="
               f"{decode_kernel}) failed {stats['failed']} requests")
        tokens[decode_kernel] = {rid: r.tokens for rid, r in results.items()}
    diff = [rid for rid in tokens[None] if tokens[None][rid] != tokens[False][rid]]
    _check(not diff, f"f32 greedy tokens differ between the decode kernel "
           f"and the plain decode for requests {diff}")
    n = sum(len(t) for t in tokens[None].values())
    print(f"[parity] f32 greedy tokens identical, kernel vs plain decode: "
          f"{len(tokens[None])} requests, {n} tokens")


def _train_argv(c):
    return ["-b", str(c["batch"]), "--seq", str(c["seq"]),
            "--layers", str(c["layers"]), "--vocab", str(c["vocab"]),
            "--d-model", str(c["d_model"]), "--heads", str(c["heads"]),
            "--optimizer", "adam", "--lr", str(c["lr"]),
            "--dtype", "bfloat16", "-i", str(c["iters"]),
            "--seed", str(c["seed"])]


def train_flops(c) -> float:
    """FLOPs of one train step of the LM configuration ``c``: 3 x the
    forward, the forward ``L (24 b s d^2 + 4 b s^2 d) + 2 b s d V``
    (bench.py's ``_train_flops`` over ``search/cost_model.py::op_cost``;
    the full ``s^2`` even when causal)."""
    b, s, d, L, V = c["batch"], c["seq"], c["d_model"], c["layers"], c["vocab"]
    return 3.0 * (L * (24 * b * s * d * d + 4 * b * s * s * d)
                  + 2 * b * s * d * V)


def phase_train(torch, kernels, rows):
    """The full-width bf16 LM trained through the app; returns the
    launch counts of this run."""
    from flexflow_torch.apps import transformer

    stats = {}
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    rc = transformer.main(_train_argv(TRAIN), device="cuda", stats_out=stats)
    torch.cuda.synchronize()
    launches = _counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    _check(rc == 0, f"transformer exited {rc}")
    losses = stats["step_losses"]
    steps = TRAIN["warmup"] + TRAIN["iters"]
    _check(len(losses) == steps and all(math.isfinite(x) for x in losses),
           f"step losses {losses}")
    _check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    L = TRAIN["layers"]
    want = {n: 0 for n in launches}
    want.update(flash_attention_lse=L * steps,
                flash_attention_lse_bwd=L * steps, softmax_xent=steps,
                softmax_xent_bwd=steps)
    _check(launches == want, f"launch counts {launches}, expected {want}")
    ms_step = stats["elapsed_s"] * 1e3 / stats["iterations"]
    tokens_s = stats["samples_per_s"] * TRAIN["seq"]
    mfu = train_flops(TRAIN) / (ms_step * 1e-3) / PEAK_FLOPS["bfloat16"]
    shares = {
        "K1f": L * rows["flash_attention_lse@train"]["ms"],
        "K1b": L * rows["flash_attention_lse_bwd"]["ms"],
        "K3": rows["softmax_xent"]["ms"] + rows["softmax_xent_bwd"]["ms"],
    }
    share_s = ", ".join(f"{k} {v:.3f} ms ({100 * v / ms_step:.1f}%)"
                        for k, v in shares.items())
    print(f"[train] losses {[round(x, 5) for x in losses]}; {ms_step:.3f} "
          f"ms/step, tokens/s {tokens_s:.1f}, MFU {100 * mfu:.2f}% of 989 "
          f"TFLOP/s ({train_flops(TRAIN):.4g} FLOP/step); from the kernels' "
          f"measured times: {share_s}; peak memory {peak_gb:.2f} GB; "
          f"launches {launches}")
    return launches


def _profile_step(torch, tag: str, step, what: str = "one train step"):
    """``step()`` once under torch.profiler: the device busy share of its
    wall time and device time by kernel name.  Returns the device events
    as ``(us, name, count)``, longest first.  One step runs first in the
    profiler's warmup, unrecorded: a window's first kernels were lost
    from a trace that had no warmup (AlexNet's conv1, ~9 ms)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        step()
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # Device-side events only (kernels, copies): host ops would count
    # their kernels' time a second time, and so would the schedule's
    # device-side step annotation.
    dev = sorted(((e.self_device_time_total, e.key, e.count)
                  for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and not e.key.startswith("ProfilerStep")), reverse=True)
    busy_ms = sum(us for us, _, _ in dev) / 1e3
    print(f"[{tag}] {what}: wall {wall_ms:.3f} ms, device busy "
          f"{busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}%, idle "
          f"{100 - 100 * busy_ms / wall_ms:.1f}%), {sum(n for _, _, n in dev)} "
          f"device events")
    for us, key, count in dev[:20]:
        print(f"[{tag}] {us / 1e3:10.3f} ms ({100 * us / 1e3 / wall_ms:5.1f}%)"
              f" x{count:<4d} {key[:80]}")
    return dev


def phase_profile(torch, c=None, tag: str = "profile"):
    """One warm train step of the LM configuration ``c`` (phase 5's by
    default) under torch.profiler: device time by kernel name and the
    step's device busy share."""
    from flexflow_torch.apps.common import make_optimizer
    from flexflow_torch.config import FFConfig
    from flexflow_torch.models.transformer import build_transformer_lm
    from flexflow_torch.runtime.executor import Executor
    from flexflow_torch.runtime.trainer import Trainer

    c = c or TRAIN
    cfg = FFConfig(batch_size=c["batch"], compute_dtype="bfloat16",
                   optimizer="adam", learning_rate=c["lr"], seed=c["seed"])
    ff = build_transformer_lm(batch_size=c["batch"], seq_len=c["seq"],
                              vocab_size=c["vocab"], d_model=c["d_model"],
                              num_heads=c["heads"], num_layers=c["layers"],
                              config=cfg)
    ex = Executor(ff, cfg, optimizer=make_optimizer(cfg), device="cuda")
    state = list(ex.init())
    batch = Trainer(ex).synthetic_batch()

    def step():
        state[:3] = ex.train_step(*state, batch)[:3]

    for _ in range(2):
        step()
    _profile_step(torch, tag, step)


def phase_train_parity(torch, kernels, streamed: bool = False):
    """One f32 Adam step on the card (kernels) and on the CPU (plain
    versions) from the same params and batch; with ``streamed``, under
    the streamed dispatch (``kernels._STREAMED`` set in this process),
    so the card runs K1s/K1sb."""
    import numpy as np

    from flexflow_torch.config import FFConfig
    from flexflow_torch.data.loader import synthetic_host_batch
    from flexflow_torch.models.transformer import build_transformer_lm
    from flexflow_torch.optim import AdamOptimizer
    from flexflow_torch.runtime.executor import Executor

    c = PARITY_TRAIN
    cfg = FFConfig(batch_size=c["batch"], compute_dtype="float32",
                   seed=c["seed"])
    ff = build_transformer_lm(
        batch_size=c["batch"], seq_len=c["seq"], vocab_size=c["vocab"],
        d_model=c["d_model"], num_heads=c["heads"], num_layers=c["layers"],
        config=cfg)
    params0 = Executor(ff, cfg, device="cpu").init_params()
    batch = synthetic_host_batch(ff, np.random.default_rng(c["seed"]),
                                 {"tokens": c["vocab"], "label": c["vocab"]})
    out = {}
    bwd = (kernels.flash_attention_lse_streamed_bwd if streamed
           else kernels.flash_attention_lse_bwd)
    tag = "longctx-parity" if streamed else "train-parity"
    for dev in ("cuda", "cpu"):
        ex = Executor(ff, cfg, optimizer=AdamOptimizer(lr=c["lr"]), device=dev)
        params = {op: {k: p.detach().clone().to(ex.device)
                       for k, p in g.items()}
                  for op, g in params0.items()}
        before = bwd.launches
        # The two halves of Executor.train_step (no --clip-norm here).
        saved, kernels._STREAMED = kernels._STREAMED, streamed
        try:
            loss, _, _, grads = ex.loss_and_grads(params, {}, batch)
        finally:
            kernels._STREAMED = saved
        grads_cpu = {op: {k: v.detach().cpu() for k, v in g.items()}
                     for op, g in grads.items()}
        ex.optimizer.update(params, ex.optimizer.init(params), grads)
        if dev == "cuda":
            torch.cuda.synchronize()
            _check(bwd.launches - before == c["layers"],
                   f"the f32 parity step did not run {bwd.__name__}")
        out[dev] = (float(loss), grads_cpu,
                    {op: {k: v.detach().cpu() for k, v in g.items()}
                     for op, g in params.items()})
    (lc, gc, pc), (lp, gp, pp) = out["cuda"], out["cpu"]
    _check(abs(lc - lp) <= TOL_TRAIN_LOSS,
           f"f32 step loss: card {lc}, CPU {lp}")
    rtol, atol = TOL_TRAIN_GRAD
    worst_g = worst_p = 0.0
    for op in gp:
        for k in gp[op]:
            want, got = gp[op][k], gc[op][k]
            scale = want.abs().max().item()
            err = (got - want).abs().max().item()
            _check(err <= rtol * scale + atol,
                   f"f32 grad {op}.{k}: err {err} at scale {scale}")
            worst_g = max(worst_g, err / (rtol * scale + atol))
            g = want.abs()
            big = g >= max(1e-4 * g.max().item(), 1e-6)
            diff = (pc[op][k] - pp[op][k]).abs()
            d_big = diff[big].max().item() if big.any() else 0.0
            _check(d_big <= 1e-3 * c["lr"] and diff.max().item() <= 2 * c["lr"],
                   f"f32 updated {op}.{k}: err {d_big} where |g| is not "
                   f"noise, {diff.max().item()} overall")
            worst_p = max(worst_p, d_big)
    print(f"[{tag}] f32 step card vs CPU: loss {lc:.7f} vs {lp:.7f}; "
          f"worst grad err {worst_g:.3g} of its tolerance; worst "
          f"updated-param err {worst_p:.3g} (lr {c['lr']})")


def _dlrm_model(batch: int, vocab: int, dtype: str, seed: int, c=None,
                **cfg_kw):
    """The DLRM graph of the DLRM phases (``apps.dlrm``'s for the same
    flags) and its config."""
    from flexflow_torch.config import FFConfig
    from flexflow_torch.models.dlrm import DLRMConfig, build_dlrm

    c = c or DLRM
    cfg = FFConfig(batch_size=batch, compute_dtype=dtype, seed=seed, **cfg_kw)
    spec = DLRMConfig(sparse_feature_size=c["dim"],
                      embedding_size=[vocab] * c["tables"],
                      mlp_bot=list(c["bot"]), mlp_top=list(c["top"]))
    return build_dlrm(batch, spec, cfg), cfg


def _dlrm_argv(optimizer: str = "sgd", extra=(), iters=None, c=None):
    c = c or DLRM

    def dash(xs):
        return "-".join(str(x) for x in xs)

    return ["-b", str(c["batch"]), "-i", str(iters or c["iters"]),
            "--dtype", "bfloat16",
            "--optimizer", optimizer, "--lr", str(c["lr"]), "--momentum", "0",
            "--wd", "0", "--seed", str(c["seed"]),
            "--arch-sparse-feature-size", str(c["dim"]),
            "--arch-embedding-size", dash([c["vocab"]] * c["tables"]),
            "--arch-mlp-bot", dash(c["bot"]), "--arch-mlp-top", dash(c["top"]),
            *extra]


def dlrm_flops(ff) -> float:
    """FLOPs of one train step: 3 x the forward's ``2 B in out`` of every
    linear layer (``bench.py::_train_flops`` for these ops)."""
    from flexflow_torch.ops import Linear

    b = ff.input_tensors[0].shape[0]
    return 3.0 * sum(2 * b * op.in_dim * op.attrs["out_dim"]
                     for op in ff.layers if isinstance(op, Linear))


def _touched(torch, ids, shape):
    """(T, V) bool on the card: the rows of each table that a (B, T) id
    batch addresses."""
    mask = torch.zeros(shape, dtype=torch.bool, device="cuda")
    for t in range(shape[0]):
        mask[t, torch.as_tensor(ids[:, t], device="cuda").long()] = True
    return mask


def _chain_ms(fn, n1: int = 16, n2: int = 80, reps: int = 5) -> float:
    """Device ms per call of ``fn(i)`` from the slope of chains of ``n1``
    and ``n2`` calls in a row, the best of ``reps`` runs each.  Each run
    first parks the card in a spin longer than the host takes to enqueue
    the chain, so the events bracket back-to-back device work only; the
    slope cancels what a chain pays once (the events, the first launch's
    ramp).  Unlike ``_device_ms``, which brackets one launch, it reads a
    kernel of a few microseconds."""
    import torch

    for i in range(n2):
        fn(i)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n2):
        fn(i)
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    spin = int(4e9 * host_s) + 2_000_000  # _sleep's cycles: 2x at ~2 GHz

    def best(n):
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(spin)
            start.record()
            for i in range(n):
                fn(i)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return min(times)

    return (best(n2) - best(n1)) / (n2 - n1)


#: K4's cold-row chain: distinct id vectors a chain cycles through, so that
#: the rows it reads (GATHER_COLD x 2048 x 256 bytes = 128 MB at the DLRM
#: shape) are more than the 50 MB L2 holds, as a real DLRM batch finds them.
GATHER_COLD = 256


def _gather_times(torch, fn, table, ids, cold_ids):
    """``fn(table, ids)`` timed three ways (ms): one launch between events
    (``_device_ms``), the chain slope on the same ids (warm L2), and the
    chain slope through ``cold_ids`` (a new id vector at every call,
    cycling: rows from HBM)."""
    turn = [0]

    def cold(_):
        turn[0] += 1
        return fn(table, cold_ids[turn[0] % len(cold_ids)])

    return (_device_ms(lambda: fn(table, ids)),
            _chain_ms(lambda _: fn(table, ids)), _chain_ms(cold))


def _gather_exact(torch, kernels, name, table, ids):
    """K4 and its three-table entry against the plain versions bit for bit
    (NaN rows included); the third table differs from the first so that a
    row of the wrong table shows.  Returns K4's one-table rows and the
    plain ones."""
    want = kernels.gather_rows_plain(table, ids)
    tables = (table, table.neg(), table * 0.5)
    wants = kernels.gather_rows_multi_plain(tables, ids)
    got = kernels.gather_rows(table, ids)
    multi = kernels.gather_rows_multi(tables, ids)
    torch.cuda.synchronize()
    same = torch.equal(got.view(torch.int32), want.view(torch.int32))
    same_multi = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                     for a, b in zip(multi, wants))
    _check(same and same_multi and len(multi) == 3,
           f"gather_rows {name}: one table exact {same}, three tables "
           f"exact {same_multi}")
    return got, want


def phase_dlrm_kernels(torch, kernels, F):
    """K4 (one and three tables) and K5 against their plain versions on the
    card, bit for bit, and K5 against itself across two launches; device
    times beside the byte bound, the plain version and ``F.embedding`` /
    ``index_add_``, and K4 at the main-path shape three ways
    (``_gather_times``) beside the launch floor.  Returns the rows of the
    main-path shape."""
    import numpy as np

    g = torch.Generator(device="cuda").manual_seed(3)
    c = DLRM
    main_rows = c["tables"] * c["vocab"]
    main_n = c["batch"] * c["tables"]
    binned = 2 * kernels._SCATTER_CAP  # K5's two-launch route
    cases = (
        ("main", main_rows, c["dim"], main_n, "uniform"),
        ("step", main_rows, c["dim"], main_n, "step"),
        ("zipf", main_rows, c["dim"], main_n, "zipf"),
        ("equal", main_rows, c["dim"], main_n, "equal"),
        ("cap equal", main_rows, c["dim"], kernels._SCATTER_CAP, "equal"),
        ("binned", main_rows, c["dim"], binned, "uniform"),
        ("binned equal", main_rows, c["dim"], binned, "equal"),
        ("out of range", 100_000, c["dim"], main_n, "range"),
        ("n=0", 100_000, c["dim"], 0, "uniform"),
        ("n=1", 100_000, c["dim"], 1, "uniform"),
        ("D=16", 100_000, 16, main_n, "uniform"),
        ("D=65", 100_000, 65, main_n, "zipf"),
        ("D=512", 100_000, 512, main_n, "zipf"),
        ("wte", 32768, 512, 32768, "uniform"),
    )
    out = {}
    for name, R, D, n, kind in cases:
        table = torch.randn((R, D), generator=g, device="cuda")
        if kind == "uniform":
            ids = torch.randint(0, R, (n,), generator=g, device="cuda")
        elif kind == "step":  # the DLRM step's stacked ids: {0, 1} per table
            ids = (torch.randint(0, 2, (c["batch"], c["tables"]), generator=g,
                                 device="cuda")
                   + torch.arange(c["tables"], device="cuda") * c["vocab"]
                   ).reshape(-1)
        elif kind == "zipf":  # data/trace.py's skew
            z = np.minimum(np.random.default_rng(5).zipf(1.2, n), R) - 1
            ids = torch.as_tensor(z, device="cuda")
        elif kind == "range":  # negative and >= R among valid ones
            ids = torch.randint(-R // 8, R + R // 8, (n,), generator=g,
                                device="cuda")
        else:
            ids = torch.full((n,), R // 2, device="cuda", dtype=torch.int64)
        if name in ("wte", "out of range"):
            ids = ids.to(torch.int32)  # the LM's token ids
        upd = torch.randn((n, D), generator=g, device="cuda")
        rows, want = _gather_exact(torch, kernels, name, table, ids)
        t1, t2, t3 = table.clone(), table.clone(), table.clone()
        kernels.scatter_add_rows(t1, ids, upd)
        kernels.scatter_add_rows(t2, ids, upd)
        kernels.scatter_add_rows_plain(t3, ids, upd)
        torch.cuda.synchronize()
        valid = ids[(ids >= 0) & (ids < R)].long()
        hit = torch.zeros((R,), dtype=torch.bool, device="cuda")
        hit[valid] = True
        stray = bool(((t1 != table).any(1) & ~hit).any())
        _check(torch.equal(t1, t3) and torch.equal(t1, t2) and not stray,
               f"row kernels {name} ({R}, {D}) n={n}: scatter exact "
               f"{torch.equal(t1, t3)}, repeat exact {torch.equal(t1, t2)}, "
               f"rows outside the ids changed {stray}")
        if kind == "range":
            _check(bool(rows[(ids < 0) | (ids >= R)].isnan().all()),
                   "gather_rows: an out-of-range id did not give a NaN row")
        err_g = (rows - want).nan_to_num().abs().max().item() if n else 0.0
        err_s = (t1 - t3).abs().max().item() if n else 0.0
        del t2, t3
        uniq = int(torch.unique(valid).numel())
        line = (f"[dlrm-kernels] {name}: table ({R}, {D}) f32, {n} "
                f"{str(ids.dtype)[6:]} ids ({kind}, {valid.numel()} in range, "
                f"{uniq} distinct; K5 in {kernels.scatter_plan(n)[0]} "
                f"launches): gather (one and three tables) and "
                f"scatter bit-exact against the plain versions, scatter "
                f"bit-identical across two launches")
        if n == 0:
            _check(torch.equal(t1, table), "scatter with n = 0 changed the table")
        if n == 0 or kind == "range":  # the library calls refuse such ids
            print(line)
            continue
        isz = ids.element_size()
        ms_g = _device_ms(lambda: kernels.gather_rows(table, ids))
        plain_g = _device_ms(lambda: kernels.gather_rows_plain(table, ids))
        lib_g = _device_ms(lambda: F.embedding(ids, table))
        bound_g, by_g = _bound_ms(n * isz + uniq * D * 4 + n * D * 4, 0.0,
                                  "float32")
        ms_s = _device_ms(lambda: kernels.scatter_add_rows(t1, ids, upd))
        plain_s = _device_ms(lambda: kernels.scatter_add_rows_plain(t1, ids, upd))
        lib_s = _device_ms(lambda: t1.index_add_(0, ids, upd))
        bound_s, by_s = _bound_ms(n * isz + n * D * 4 + 2 * uniq * D * 4,
                                  n * D, "float32")
        print(f"{line}; gather {ms_g:.6f} ms (plain {plain_g:.6f}, "
              f"F.embedding {lib_g:.6f}, bound {bound_g:.6f} by {by_g}); "
              f"scatter {ms_s:.6f} ms (plain {plain_s:.6f}, index_add_ "
              f"{lib_s:.6f}, bound {bound_s:.6f} by {by_s})")
        row_s = dict(max_abs_err=err_s, ms=ms_s, plain_ms=plain_s,
                     bound_ms=bound_s, bound_by=by_s, library_ms=lib_s)
        if name == "main":
            ways, out["gather_rows_multi"] = _gather_main(torch, kernels, F,
                                                          table, ids, g)
            out["gather_rows"] = dict(max_abs_err=err_g, ms=ms_g, plain_ms=plain_g,
                                      bound_ms=bound_g, bound_by=by_g,
                                      library_ms=lib_g, **ways)
            out["scatter_add_rows"] = row_s
        elif name in ("step", "wte"):
            out["scatter_add_rows"][f"{name}_shape"] = row_s
        del table, t1, rows, want, upd, hit
    return out


def _gather_main(torch, kernels, F, table, ids, g):
    """K4 at the main-path shape: K4 and ``F.embedding`` three ways
    (``_gather_times``) beside the launch floor (the chain slope of
    ``torch.cuda._sleep(0)``), and the three-table launch against three
    one-table launches and its plain version.  Returns the keys it adds to
    the ``gather_rows`` row and ``gather_rows_multi``'s row."""
    R, D = table.shape
    n = ids.shape[0]
    cold = [torch.randint(0, R, (n,), generator=g, device="cuda")
            for _ in range(GATHER_COLD)]
    floor = _chain_ms(lambda _: torch.cuda._sleep(0))
    lib = _gather_times(torch, lambda t, i: F.embedding(i, t), table, ids,
                        cold)
    one = _gather_times(torch, kernels.gather_rows, table, ids, cold)
    tables = (table, table.neg(), table * 0.5)
    multi = _gather_times(
        torch, lambda t, i: kernels.gather_rows_multi(tables, i), table, ids,
        cold)
    three = _gather_times(
        torch, lambda t, i: [kernels.gather_rows(x, i) for x in tables],
        table, ids, cold)
    plain_m = _device_ms(lambda: kernels.gather_rows_multi_plain(tables, ids))
    err_m = max((a - b).abs().max().item() for a, b in zip(
        kernels.gather_rows_multi(tables, ids),
        kernels.gather_rows_multi_plain(tables, ids)))
    uniq = int(torch.unique(ids).numel())
    bound_m, by_m = _bound_ms(n * ids.element_size() + 3 * (uniq + n) * D * 4,
                              0.0, "float32")
    fmt = lambda t: " / ".join(f"{x:.6f}" for x in t)
    print(f"[dlrm-kernels] gather_rows main: {fmt(one)} ms (single launch / "
          f"chain slope / cold-row chain slope); F.embedding {fmt(lib)} ms; "
          f"launch floor (chain slope of torch.cuda._sleep(0)) {floor:.6f} "
          f"ms")
    print(f"[dlrm-kernels] gather_rows_multi main, 3 tables: {fmt(multi)} "
          f"ms; three gather_rows launches {fmt(three)} ms; plain "
          f"{plain_m:.6f} ms; bound {bound_m:.6f} by {by_m}; err {err_m}")
    ways = dict(chain_ms=one[1], cold_ms=one[2], floor_ms=floor,
                library_chain_ms=lib[1], library_cold_ms=lib[2])
    return ways, dict(max_abs_err=err_m, ms=multi[0], plain_ms=plain_m,
                      bound_ms=bound_m, bound_by=by_m, library_ms=None,
                      chain_ms=multi[1], cold_ms=multi[2],
                      three_launches=dict(ms=three[0], chain_ms=three[1],
                                          cold_ms=three[2]))


def phase_dlrm_train(torch, kernels):
    """The full-width DLRM through ``apps.dlrm.main``: plain SGD and lazy
    Adam on the row-sparse path, momentum SGD on the dense path.  Returns
    the launch counts by run and the SGD run's trained params and
    losses."""
    import numpy as np

    from flexflow_torch.apps import dlrm
    from flexflow_torch.data.loader import synthetic_host_batch
    from flexflow_torch.runtime.executor import Executor

    c = DLRM
    ff, cfg = _dlrm_model(c["batch"], c["vocab"], "bfloat16", c["seed"])
    t0 = time.perf_counter()
    table0 = Executor(ff, cfg, device="cuda").init_params()["embeddings"]["tables"]
    init_s = time.perf_counter() - t0
    # The app's fixed synthetic batch: ids in {0, 1} (Trainer.synthetic_batch).
    ids = synthetic_host_batch(ff, np.random.default_rng(0))["sparse_input"]
    touched = _touched(torch, ids, table0.shape[:2])
    flops = dlrm_flops(ff)
    steps = c["warmup"] + c["iters"]
    runs = (("sgd", _dlrm_argv("sgd"), 1, 1),
            # Lazy Adam gathers the batch's rows, then the unique rows of
            # the table, m and v in one launch (gather_rows_multi); it
            # scatters into the table, m and v.
            ("lazy_adam", _dlrm_argv("adam", ["--lazy-sparse-opt"]), 2, 3),
            ("dense", _dlrm_argv("sgd", ["--momentum", "0.9"]), 0, 0))
    by_run, sgd_params, sgd_losses = {}, None, None
    for name, argv, k4, k5 in runs:
        stats = {}
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        _zero_counts()
        rc = dlrm.main(argv, device="cuda", stats_out=stats)
        torch.cuda.synchronize()
        launches = _counts()
        # The run's own peak, above what this script already holds.
        peak_gb = (torch.cuda.max_memory_allocated() - held) / 1e9
        _check(rc == 0, f"dlrm {name} exited {rc}")
        losses = stats["step_losses"]
        _check(len(losses) == steps and all(math.isfinite(x) for x in losses),
               f"dlrm {name} step losses {losses}")
        want = {n: 0 for n in launches}
        # Every K4 launch past the batch's gathers the state's rows too.
        want.update(gather_rows=k4 * steps, scatter_add_rows=k5 * steps,
                    gather_rows_multi=max(k4 - 1, 0) * steps)
        _check(launches == want, f"dlrm {name} launch counts {launches}, "
               f"expected {want}")
        params, opt_state, _ = stats.pop("final")
        table = params["embeddings"]["tables"]
        changed = (table != table0).any(-1)
        _check(not bool((changed & ~touched).any()) and bool(changed[touched].all()),
               f"dlrm {name}: rows outside the batch changed, or a batch row "
               f"did not")
        if name == "lazy_adam":
            m = opt_state["m"]["embeddings"]["tables"]
            _check(not bool(((m != 0).any(-1) & ~touched).any()),
                   "lazy Adam moved the moments of untouched rows")
        ms_step = stats["elapsed_s"] * 1e3 / stats["iterations"]
        mfu = flops / (ms_step * 1e-3) / PEAK_FLOPS["bfloat16"]
        print(f"[dlrm-train] {name}: losses {[round(x, 6) for x in losses]}; "
              f"{ms_step:.4f} ms/step, samples/s {stats['samples_per_s']:.1f}, "
              f"MFU {100 * mfu:.4f}% of 989 TFLOP/s ({flops:.4g} FLOP/step); "
              f"peak memory {peak_gb:.2f} GB; {int(touched.sum())} touched "
              f"rows changed, the other rows bit-identical; launches {launches}")
        by_run[name] = launches
        if name == "sgd":
            sgd_params, sgd_losses = params, losses
        del stats, params, opt_state, table, changed
    print(f"[dlrm-train] table init (CPU draw of 8 x 10^6 x 64 f32, then "
          f"copied to the card) {init_s:.1f}s")
    return by_run, sgd_params, sgd_losses


def phase_dlrm_parity(torch, kernels):
    """One f32 step at 8 x 100,000 x 64 on the card (kernels) and on the
    CPU (plain versions) from the same params and batch, for plain SGD,
    lazy momentum and lazy Adam."""
    import numpy as np

    from flexflow_torch.data.loader import synthetic_host_batch
    from flexflow_torch.optim import AdamOptimizer, SGDOptimizer
    from flexflow_torch.runtime.executor import Executor

    c = DLRM_PARITY
    ff, cfg = _dlrm_model(c["batch"], c["vocab"], "float32", c["seed"])
    params0 = Executor(ff, cfg, device="cpu").init_params()
    batch = synthetic_host_batch(ff, np.random.default_rng(c["seed"]),
                                 {"sparse_input": c["vocab"]})
    ids = batch["sparse_input"]
    ids[1:9] = ids[0]                      # duplicates at distances 1 to 8
    ids[200] = ids[20]                     # and at distance 180
    ids[:, 3] = np.minimum(ids[:, 3], 5)   # table 3: six rows, 256 ids
    touched = _touched(torch, ids, params0["embeddings"]["tables"].shape[:2]).cpu()
    b1 = 0.9
    opts = {
        "sgd": (lambda: SGDOptimizer(lr=0.1), 1, 1),
        "lazy_momentum": (lambda: SGDOptimizer(lr=0.1, momentum=0.9,
                                               weight_decay=1e-4,
                                               lazy_sparse=True), 2, 2),
        "lazy_adam": (lambda: AdamOptimizer(lr=1e-3, b1=b1,
                                            lazy_sparse=True), 2, 3),
    }
    rtol, atol = TOL_DLRM_STEP
    for name, (make, k4, k5) in opts.items():
        out = {}
        for dev in ("cuda", "cpu"):
            opt = make()
            ex = Executor(ff, cfg, optimizer=opt, device=dev)
            _check([op.name for op in ex._sparse_ops] == ["embeddings"],
                   f"dlrm parity {name}: the tables are not on the sparse path")
            params = {op: {k: p.clone().to(ex.device) for k, p in g.items()}
                      for op, g in params0.items()}
            before = (kernels.gather_rows.launches,
                      kernels.scatter_add_rows.launches,
                      kernels.gather_rows_multi.launches)
            params, state, _, m = ex.train_step(params, opt.init(params), {},
                                                ex.shard_batch(batch))
            if dev == "cuda":
                torch.cuda.synchronize()
                _check((kernels.gather_rows.launches - before[0],
                        kernels.scatter_add_rows.launches - before[1],
                        kernels.gather_rows_multi.launches - before[2])
                       == (k4, k5, k4 - 1),
                       f"dlrm parity {name}: not one launch set of K4/K5 "
                       f"(the state's rows in one K4 launch)")
            cpu = {op: {k: v.detach().cpu() for k, v in g.items()}
                   for op, g in params.items()}
            if isinstance(state, dict) and "t" in state:
                state = {"m": state["m"], "v": state["v"]}
            elif state is not None:
                state = {"v": state}
            state = {s: {op: {k: v.cpu() for k, v in g.items()}
                         for op, g in tree.items()}
                     for s, tree in (state or {}).items()}
            out[dev] = (float(m["train_loss"]), cpu, state)
        (lc, pc, sc), (lp, pp, sp) = out["cuda"], out["cpu"]
        _check(abs(lc - lp) <= TOL_DLRM_LOSS,
               f"dlrm parity {name}: loss card {lc}, CPU {lp}")
        worst = 0.0
        for op in pp:
            for k in pp[op]:
                p0 = params0[op][k]
                dc, dp = pc[op][k] - p0, pp[op][k] - p0
                if name == "lazy_adam":
                    g = (sp["m"][op][k] / (1 - b1)).abs()
                    big = g >= max(1e-4 * g.max().item(), 1e-6)
                    diff = (dc - dp).abs()
                    lr = 1e-3
                    err = diff[big].max().item() if big.any() else 0.0
                    _check(err <= 1e-3 * lr and diff.max().item() <= 2 * lr,
                           f"dlrm parity {name} {op}.{k}: step err {err}")
                    worst = max(worst, err / (1e-3 * lr))
                else:
                    tol = (rtol * dp.abs().max().item()
                           + 2.0 ** -22 * p0.abs().max().item())
                    err = (dc - dp).abs().max().item()
                    _check(err <= tol, f"dlrm parity {name} {op}.{k}: step "
                           f"err {err} against {tol}")
                    worst = max(worst, err / tol)
                if op == "embeddings":
                    cold = ~touched
                    _check(torch.equal(pc[op][k][cold], p0[cold])
                           and torch.equal(pp[op][k][cold], p0[cold]),
                           f"dlrm parity {name}: untouched rows moved")
        for s in sp:
            for op in sp[s]:
                for k in sp[s][op]:
                    want, got = sp[s][op][k], sc[s][op][k]
                    tol = rtol * want.abs().max().item() + atol
                    err = (got - want).abs().max().item()
                    _check(err <= tol, f"dlrm parity {name} state {s} {op}.{k}: "
                           f"err {err} against {tol}")
                    worst = max(worst, err / tol)
        print(f"[dlrm-parity] {name}: loss card {lc:.8f} CPU {lp:.8f}; worst "
              f"param step / state error {worst:.3g} of its tolerance; "
              f"{int(touched.sum())} touched rows, every other row "
              f"bit-identical to its initial value on both sides")


def phase_dlrm_profile(torch, params) -> None:
    """One warm full-width plain-SGD DLRM step (the sparse path) under
    torch.profiler, from the dlrm-train SGD run's params."""
    from flexflow_torch.apps.common import make_optimizer
    from flexflow_torch.runtime.executor import Executor
    from flexflow_torch.runtime.trainer import Trainer

    c = DLRM
    ff, cfg = _dlrm_model(c["batch"], c["vocab"], "bfloat16", c["seed"],
                          optimizer="sgd", learning_rate=c["lr"],
                          momentum=0.0, weight_decay=0.0)
    ex = Executor(ff, cfg, optimizer=make_optimizer(cfg), device="cuda")
    _check(bool(ex._sparse_ops), "the profiled DLRM step is not sparse")
    batch = Trainer(ex).synthetic_batch()

    def step():
        ex.train_step(params, None, {}, batch)

    for _ in range(2):
        step()
    _profile_step(torch, "dlrm-profile", step)


#: The long-context legs of phase 13 (``bench.py:287-308``,
#: ``bench_transformer_longctx`` and ``bench_transformer_32k``): the
#: phase 5 model at seq 8192 (batch 4) and 32768 (batch 1).
LONGCTX_8K = dict(TRAIN, batch=4, seq=8192, iters=5)
LONGCTX_32K = dict(TRAIN, batch=1, seq=32768, iters=2)


def _per_row(fn, *xs, heads: bool = False):
    """``fn`` over the leading batch dim one row at a time (``heads``:
    one head of one row at a time), outputs concatenated: the plain
    versions at long t, whose f32 t x t temporaries for the whole batch
    would not fit the card (at 32k one is 4.3 GB per head)."""
    import torch

    def part(x, i, j):
        if x is None:
            return None
        return x[i:i + 1] if j is None else x[i:i + 1, j:j + 1]

    cols = range(xs[0].shape[1]) if heads else (None,)
    rows = []
    for i in range(xs[0].shape[0]):
        outs = [fn(*(part(x, i, j) for x in xs)) for j in cols]
        rows.append(tuple(torch.cat(parts, 1) for parts in zip(*outs)))
    return tuple(torch.cat(parts) for parts in zip(*rows))


def _flash_parts(torch, kernels, q, k, v, do, g_lse, causal,
                 pair: str = "stream"):
    """The forward's ``o``/``lse`` and the backward's gradients of a kernel
    pair, ``stream`` (K1s/K1sb, through ``flash_attention_lse_streamed``)
    or ``k1`` (K1f/K1b), against the plain versions, one head at a time,
    within ``TOL_ELEM``'s ``fwd`` and ``stream_bwd``.  The backward takes
    the plain forward's ``o`` and ``lse``.  Returns ({"o", "lse", "dq",
    "dk", "dv": worst element ratio, above 1 fails}, {"fwd", "bwd": worst
    absolute error}); lse is held within ``TOL_LSE``."""
    name = _dtype_name(q.dtype)
    if pair == "stream":
        fwd_t = kernels.flash_attention_lse_streamed
        bwd_t = kernels.flash_attention_lse_streamed_bwd
    else:
        fwd_t, bwd_t = kernels.flash_attention_lse, kernels.flash_attention_lse_bwd
    fwd = lambda a, b, c: _per_row(
        lambda x, y, z: kernels.flash_attention_lse_plain(x, y, z, causal),
        a, b, c, heads=True)
    bwd = lambda *a: _per_row(
        lambda *x: kernels.flash_attention_lse_bwd_plain(*x, causal), *a,
        heads=True)
    with torch.no_grad():
        o, lse = fwd_t(q, k, v, causal)
        po, plse = fwd(q, k, v)
        mass = fwd(q, k, v.abs())[0]
    e_lse = (lse - plse).abs().max().item()
    parts = {"o": _close(o, po, mass, *TOL_ELEM["fwd"][name]),
             "lse": e_lse / TOL_LSE if math.isfinite(e_lse) else math.inf}
    errs = {"fwd": max((o.float() - po.float()).abs().max().item(), e_lse)}
    del o, lse, mass
    got = bwd_t(q, k, v, po, plse, do, g_lse, causal)
    want = bwd(q, k, v, po, plse, do, g_lse)
    rtol, arel, atop = TOL_ELEM["stream_bwd"][name]
    masses = _flash_bwd_mass(q, k, v, po, plse, do, g_lse, causal)
    tops = (_flash_bwd_top(q, k, v, po, plse, do, g_lse, causal) if atop
            else (None,) * 3)
    errs["bwd"] = 0.0
    for key, a, w, m, tp in zip(("dq", "dk", "dv"), got, want, masses, tops):
        parts[key] = _close(a, w, m, rtol, arel, tp, atop)
        errs["bwd"] = max(errs["bwd"], (a.float() - w.float()).abs().max().item())
    return parts, errs


def _hold_stream(torch, kernels, q, k, v, do, g_lse, causal,
                 pair: str = "stream"):
    """:func:`_flash_parts` of K1s/K1sb (or, with ``pair="k1"``, of
    K1f/K1b), failing the run above the tolerance.  Returns (worst element
    ratio, {"fwd", "bwd": worst absolute error})."""
    parts, errs = _flash_parts(torch, kernels, q, k, v, do, g_lse, causal,
                               pair)
    worst = max(parts.values())
    _check(worst <= 1.0, f"{pair} kernels {tuple(q.shape)} causal={causal} "
           f"{_dtype_name(q.dtype)} against plain: " + ", ".join(
               f"{k} {v:.3g}" for k, v in parts.items())
           + " of the element tolerance")
    return worst, errs


def _stream_is_k1(torch, kernels, q, k, v, do, g_lse, causal) -> None:
    """The bf16 K1s and K1sb launch K1f's wgmma kernel and K1b's wgmma
    pair (``kernels.fwd_entry``, ``bwd_entry``): the same bits as K1f and
    K1b, and each wrapper counts its own launch."""
    fns = (kernels.flash_attention_lse, kernels.flash_attention_lse_streamed,
           kernels.flash_attention_lse_bwd,
           kernels.flash_attention_lse_streamed_bwd)
    before = [f.launches for f in fns]
    with torch.no_grad():
        o, lse = kernels.flash_attention_lse(q, k, v, causal)
        fwd = all(torch.equal(a, b) for a, b in zip(
            kernels.flash_attention_lse_streamed(q, k, v, causal), (o, lse)))
    bwd = all(torch.equal(a, b) for a, b in zip(
        kernels.flash_attention_lse_streamed_bwd(q, k, v, o, lse, do, g_lse,
                                                 causal),
        kernels.flash_attention_lse_bwd(q, k, v, o, lse, do, g_lse, causal)))
    torch.cuda.synchronize()
    counts = [f.launches - n for f, n in zip(fns, before)]
    _check(fwd and bwd and counts == [1, 1, 1, 1],
           f"{tuple(q.shape)} causal={causal}: K1s equals K1f {fwd}, K1sb "
           f"equals K1b {bwd}, launches {counts}")


def phase_stream_kernels(torch, kernels, F):
    """K1s and K1sb against their plain versions on the card, element by
    element, and against K1f/K1b at the long-context shapes; device times
    at the main-path shape.  Returns per-kernel rows."""
    g = torch.Generator(device="cuda").manual_seed(4)
    rows = {}

    def randn(shape, dt):
        return torch.randn(shape, generator=g, device="cuda").to(dt)

    for hd in kernels._STREAM_HEAD_DIMS:
        for dt in (torch.float32, torch.bfloat16):
            a = kernels.flash_stream_attrs(hd, dt)
            print(f"[stream-kernels] hd {hd} {_dtype_name(dt)}: "
                  + ", ".join(f"{k} {r} registers, {sp} spilled bytes, "
                              f"{sm} B shared" for k, (r, sp, sm) in a.items()))
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [(shape, causal, dt)
             for shape in ((1, 8, 64, 64), (1, 8, 128, 64), (2, 8, 2048, 64),
                           (1, 8, 80, 64))
             for causal in (True, False) for dt in (f32, bf16)]
    cases += [((16, 8, 2048, 64), True, bf16), ((2, 8, 80, 64), False, f32),
              ((2, 8, 80, 64), True, bf16), ((1, 8, 1, 64), True, f32),
              ((1, 2, 130, 128), False, bf16), ((2, 4, 256, 32), True, f32),
              ((1, 8, 130, 64), True, bf16), ((1, 2, 130, 32), True, bf16),
              ((1, 2, 200, 128), True, f32), ((1, 8, 8192, 64), True, bf16)]
    worst = 0.0
    for shape, causal, dt in cases:
        q, k, v, do = (randn(shape, dt) for _ in range(4))
        g_lse = randn(shape[:3], f32)
        ratio, _ = _hold_stream(torch, kernels, q, k, v, do, g_lse, causal)
        if dt == bf16:
            _stream_is_k1(torch, kernels, q, k, v, do, g_lse, causal)
        torch.cuda.synchronize()
        _check(ratio <= 1.0, f"streamed kernels {shape} causal={causal} "
               f"{_dtype_name(dt)}: {ratio} of the element tolerance")
        worst = max(worst, ratio)
        del q, k, v, do, g_lse
    print(f"[stream-kernels] {len(cases)} shapes against the plain versions "
          f"(o, lse, dq, dk, dv; causal and not, f32 and bf16, t = 1 to "
          f"8192, hd 32/64/128): worst element {worst:.3g} of its tolerance")

    # -- the main-path shape: against plain and K1f/K1b --
    main = (LONGCTX_8K["batch"], LONGCTX_8K["heads"], LONGCTX_8K["seq"],
            LONGCTX_8K["d_model"] // LONGCTX_8K["heads"])
    q, k, v, do = (randn(main, bf16) for _ in range(4))
    g_lse = randn(main[:3], f32)
    r_plain, err = _hold_stream(torch, kernels, q, k, v, do, g_lse, True)
    # K1f/K1b themselves at the 8k default arm's shape (phase 13), element
    # by element against the plain versions
    r_k1_plain, err_k1 = _hold_stream(torch, kernels, q, k, v, do, g_lse,
                                      True, pair="k1")
    _stream_is_k1(torch, kernels, q, k, v, do, g_lse, True)
    print(f"[stream-kernels] {main}: K1s/K1sb worst element {r_plain:.3g} "
          f"(plain) of its tolerance; K1f/K1b worst element {r_k1_plain:.3g} "
          f"(plain), max abs err fwd {err_k1['fwd']:.3g}, bwd "
          f"{err_k1['bwd']:.3g}; the bf16 K1s/K1sb bit-identical to K1f/K1b")
    del q, k, v, do, g_lse

    # -- 32k: K1s/K1sb and K1f/K1b against the plain versions, one head
    # at a time, and the chunked form against K1f --
    big = (1, 8, 32768, 64)
    q, k, v, do = (randn(big, bf16) for _ in range(4))
    g_lse = randn(big[:3], f32)
    r_big, err_big = _hold_stream(torch, kernels, q, k, v, do, g_lse, True)
    r_big_k1, err_big_k1 = _hold_stream(torch, kernels, q, k, v, do, g_lse,
                                        True, pair="k1")
    _stream_is_k1(torch, kernels, q, k, v, do, g_lse, True)
    torch.cuda.empty_cache()
    with torch.no_grad():
        o, lse = kernels.flash_attention_lse(q, k, v, True)
        co, clse = kernels.flash_attention_lse_chunked(q, k, v, True,
                                                       chunk=8192)
        mass = kernels.flash_attention_lse(q, k, v.abs(), True)[0]
    # Each chunk's o is rounded to bf16 before the f32 merge (2^-8 of its
    # own mass) and each side rounds p against its own running maximum
    # (2^-8 each): 3 x 2^-8 < 2^-6 of the mass, plus one output ulp.
    r_chunk = _close(co, o, mass, 2.0 ** -7, 2.0 ** -6)
    e_clse = (clse - lse).abs().max().item()
    torch.cuda.synchronize()
    _check(r_big <= 1.0 and r_chunk <= 1.0 and e_clse <= TOL_LSE,
           f"32k: streamed {r_big}, chunked {r_chunk} of the element "
           f"tolerance, chunked lse err {e_clse}")
    print(f"[stream-kernels] {big} bf16 causal against the plain versions "
          f"one head at a time: K1s/K1sb worst element {r_big:.3g} of its "
          f"tolerance (max abs err fwd {err_big['fwd']:.3g}, bwd "
          f"{err_big['bwd']:.3g}), K1f/K1b {r_big_k1:.3g} (fwd "
          f"{err_big_k1['fwd']:.3g}, bwd {err_big_k1['bwd']:.3g}), the bf16 "
          f"K1s/K1sb bit-identical to K1f/K1b; chunked "
          f"(chunk 8192) {r_chunk:.3g} of its tolerance against K1f, lse err "
          f"{e_clse:.3g}")
    del q, k, v, do, g_lse, o, lse, co, clse, mass
    torch.cuda.empty_cache()

    # -- device times, bf16 causal: K1f beside K1s and K1b beside K1sb in
    # turns (_pair_ms), at the serve, 2k, 8k and 32k shapes, with SDPA and
    # the bound (the plain versions at 8k one batch row at a time, at 32k
    # one head at a time; at 2k and the serve shape phases 1 and 2 time
    # them)
    for shape in ((1, 8, 64, 64), (1, 8, 128, 64), (16, 8, 2048, 64), main,
                  big):
        b, h, t, hd = shape
        reps = 5 if t >= 32768 else 20
        q, k, v, do = (randn(shape, bf16) for _ in range(4))
        g_lse = randn(shape[:3], f32)
        with torch.no_grad():
            o, lse = kernels.flash_attention_lse(q, k, v, True)
            t_f, t_s = _pair_ms(
                lambda: kernels.flash_attention_lse(q, k, v, True),
                lambda: kernels.flash_attention_lse_streamed(q, k, v, True),
                reps)
            t_lf = _device_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True), reps)
        t_b, t_sb = _pair_ms(
            lambda: kernels.flash_attention_lse_bwd(q, k, v, o, lse, do,
                                                    g_lse, True),
            lambda: kernels.flash_attention_lse_streamed_bwd(
                q, k, v, o, lse, do, g_lse, True), reps)
        qs, ks, vs = (x.detach().clone().requires_grad_(True)
                      for x in (q, k, v))
        out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
        t_lb = _device_ms(lambda: torch.autograd.grad(
            out, (qs, ks, vs), do, retain_graph=True), reps)
        del qs, ks, vs, out
        t_pf = t_pb = None
        if shape in (main, big):
            heads, preps = shape == big, 3 if shape == big else 20
            with torch.no_grad():
                t_pf = _device_ms(lambda: _per_row(
                    lambda *x: kernels.flash_attention_lse_plain(*x, True),
                    q, k, v, heads=heads), preps)
            t_pb = _device_ms(lambda: _per_row(
                lambda *x: kernels.flash_attention_lse_bwd_plain(*x, True),
                q, k, v, o, lse, do, g_lse, heads=heads), preps)
        pairs = t * (t + 1) // 2
        f_flops, b_flops = 4 * b * h * hd * pairs, 10 * b * h * hd * pairs
        fb, fby = _bound_ms(4 * b * h * t * hd * 2 + b * h * t * 4, f_flops,
                            "bfloat16")
        bb, bby = _bound_ms(8 * b * h * t * hd * 2 + 2 * b * h * t * 4,
                            b_flops, "bfloat16")

        def pct(flops, ms):
            return 100 * flops / (ms * 1e-3) / PEAK_FLOPS["bfloat16"]

        print(f"[stream-kernels] {shape} bf16 causal: K1f {t_f:.4f} ms "
              f"({pct(f_flops, t_f):.1f}% of 989 TFLOP/s), K1s {t_s:.4f} "
              f"({pct(f_flops, t_s):.1f}%), sdpa {t_lf:.4f} "
              f"({pct(f_flops, t_lf):.1f}%), bound {fb:.5f} by {fby}; K1b "
              f"{t_b:.4f} ({pct(b_flops, t_b):.1f}%), K1sb {t_sb:.4f} "
              f"({pct(b_flops, t_sb):.1f}%), sdpa backward {t_lb:.4f} "
              f"({pct(b_flops, t_lb):.1f}%), bound {bb:.5f} by {bby}"
              + ("" if t_pf is None else f"; plain {t_pf:.4f} / {t_pb:.4f} "
                 f"(one {'head' if heads else 'batch row'} at a time)"))
        rows[f"stream@{shape}"] = dict(K1f=t_f, K1s=t_s, K1b=t_b, K1sb=t_sb)
        fwd = dict(ms=t_f, plain_ms=t_pf, bound_ms=fb, bound_by=fby,
                   library_ms=t_lf)
        bwd = dict(ms=t_b, plain_ms=t_pb, bound_ms=bb, bound_by=bby,
                   library_ms=t_lb)
        if shape == main:
            rows["flash_attention_lse_streamed"] = dict(
                fwd, ms=t_s, max_abs_err=err["fwd"])
            rows["flash_attention_lse_streamed_bwd"] = dict(
                bwd, ms=t_sb, max_abs_err=err["bwd"])
            rows["flash_attention_lse@8k"] = dict(
                fwd, max_abs_err=err_k1["fwd"])
            rows["flash_attention_lse_bwd@8k"] = dict(
                bwd, max_abs_err=err_k1["bwd"])
        elif shape == big:
            rows["stream@32k"] = dict(fwd_ms=t_s, bwd_ms=t_sb)
            rows["flash_attention_lse@32k"] = dict(
                fwd, max_abs_err=err_big_k1["fwd"])
            rows["flash_attention_lse_bwd@32k"] = dict(
                bwd, max_abs_err=err_big_k1["bwd"])
            rows["flash_attention_lse_streamed@32k"] = dict(
                fwd, ms=t_s, max_abs_err=err_big["fwd"])
            rows["flash_attention_lse_streamed_bwd@32k"] = dict(
                bwd, ms=t_sb, max_abs_err=err_big["bwd"])
        del q, k, v, do, g_lse, o, lse
        torch.cuda.empty_cache()
    return rows


def phase_longctx_train(torch, kernels, rows):
    """``bench.py``'s long-context legs through ``apps.transformer.main``
    at full width: 8k with the streamed dispatch and with the default
    one, 32k streamed.  The dispatch is chosen by setting
    ``kernels._STREAMED`` in this process, as ``tests/test_pallas.py``
    sets ``pallas_kernels._STREAMED``.  Then one warm 8k step of each
    dispatch under torch.profiler.  Returns launch counts by leg."""
    from flexflow_torch.apps import transformer

    legs = (("longctx_8k_streamed", LONGCTX_8K, True),
            ("longctx_8k_default", dict(LONGCTX_8K, iters=2), False),
            ("longctx_32k", LONGCTX_32K, True))
    by_leg = {}
    for name, c, streamed in legs:
        stats = {}
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        _zero_counts()
        saved, kernels._STREAMED = kernels._STREAMED, streamed
        try:
            rc = transformer.main(_train_argv(c), device="cuda",
                                  stats_out=stats)
            torch.cuda.synchronize()
        finally:
            kernels._STREAMED = saved
        launches = _counts()
        peak_gb = (torch.cuda.max_memory_allocated() - held) / 1e9
        _check(rc == 0, f"{name} exited {rc}")
        losses = stats["step_losses"]
        steps = c["warmup"] + c["iters"]
        _check(len(losses) == steps and all(math.isfinite(x) for x in losses),
               f"{name} step losses {losses}")
        _check(losses[-1] < losses[0], f"{name}: loss did not fall: {losses}")
        L = c["layers"]
        fwd, bwd = (("flash_attention_lse_streamed",
                     "flash_attention_lse_streamed_bwd") if streamed else
                    ("flash_attention_lse", "flash_attention_lse_bwd"))
        want = {n: 0 for n in launches}
        want.update({fwd: L * steps, bwd: L * steps, "softmax_xent": steps,
                     "softmax_xent_bwd": steps})
        _check(launches == want, f"{name} launch counts {launches}, "
               f"expected {want}")
        ms_step = stats["elapsed_s"] * 1e3 / stats["iterations"]
        tokens_s = stats["samples_per_s"] * c["seq"]
        flops = train_flops(c)
        mfu = flops / (ms_step * 1e-3) / PEAK_FLOPS["bfloat16"]
        if c["seq"] == 32768:
            a_f, a_b = rows["stream@32k"]["fwd_ms"], rows["stream@32k"]["bwd_ms"]
        elif streamed:
            a_f = rows["flash_attention_lse_streamed"]["ms"]
            a_b = rows["flash_attention_lse_streamed_bwd"]["ms"]
        else:
            a_f = rows["flash_attention_lse@8k"]["ms"]
            a_b = rows["flash_attention_lse_bwd@8k"]["ms"]
        names = ("K1s", "K1sb") if streamed else ("K1f", "K1b")
        shares = {names[0]: L * a_f, names[1]: L * a_b,
                  "K3": rows["softmax_xent"]["ms"] + rows["softmax_xent_bwd"]["ms"]}
        share_s = ", ".join(f"{k} {v:.3f} ms ({100 * v / ms_step:.1f}%)"
                            for k, v in shares.items())
        print(f"[longctx-train] {name} (batch {c['batch']} x seq {c['seq']}, "
              f"{c['warmup']} + {c['iters']} steps): losses "
              f"{[round(x, 5) for x in losses]}; {ms_step:.3f} ms/step, "
              f"tokens/s {tokens_s:.1f}, MFU {100 * mfu:.2f}% of 989 TFLOP/s "
              f"({flops:.4g} FLOP/step); from the kernels' measured times: "
              f"{share_s}; peak memory {peak_gb:.2f} GB; launches {launches}")
        by_leg[name] = launches
    for streamed, tag in ((True, "longctx-profile"),
                          (False, "longctx-profile-default")):
        saved, kernels._STREAMED = kernels._STREAMED, streamed
        try:
            phase_profile(torch, LONGCTX_8K, tag)
        finally:
            kernels._STREAMED = saved
    return by_leg


#: Phase 15's race shapes: the LM's attention at the 2k training shape and
#: at the 8k long-context shape (phases 5 and 13), bf16 causal.
PROBE_RACE = ((16, 8, 2048, 64), (4, 8, 8192, 64))
#: The races' printed error (against K1f / K1b, the first 64 rows of the
#: first head) within this share of that slice's largest magnitude: four
#: bf16 ulps.  It checks that a race times the function it names; the race
#: kernels are held element by element before it.
TOL_RACE = 2.0 ** -5
#: Shapes whose key tiles wrap the bf16 two-pass kernels' ring (depth 3)
#: across their two passes, with (shape, causal): 2 to 10 key tiles per
#: CTA at blocks 64 and 128, most not a multiple of the depth.
PROBE_WRAP = (((1, 2, 640, 128), True), ((1, 2, 450, 64), False))
def race_products(name: str, t: int) -> float:
    """The products the race kernel ``name`` does at length ``t``, in units
    of the causal function's (``t (t + 1) / 2`` score pairs, two products
    each): v3 recomputes Q K^T in its second pass (1.5), v4 runs both
    passes over every key (``3 t^2 / t (t + 1)``, about 3); 1 for the
    others."""
    pairs = t * (t + 1) / 2
    return {"flash_fwd_two_pass": 1.5,
            "flash_fwd_full_row": 1.5 * t * t / pairs}.get(name, 1.0)


#: The kernel wrapper each race variant launches (None: the yardstick).
RACE_WRAPPERS = {
    "v1_base": "flash_attention_lse", "v2_lanes": "flash_fwd_row_state",
    "v3_twopass": "flash_fwd_two_pass", "v4_fullrow": "flash_fwd_full_row",
    "v5_sdpa": None, "v6_stream": "flash_attention_lse_streamed",
    "b1_prod": "flash_attention_lse_bwd", "b2_lanes": "flash_bwd_row_state",
    "b3_stream": "flash_attention_lse_streamed_bwd", "b4_sdpa": None,
}


def _probe_hold(torch, kernels, probe, q, k, v, do, g_lse, causal, block,
                ref: str, calls):
    """The race kernels v2, v3, v4 and b2 at ``block`` against ``ref``:
    ``plain`` (the plain versions, one batch row at a time; the forward
    variants within ``TOL_ELEM["fwd"]``, K1f's rule, and b2 within
    ``TOL_ELEM["stream_bwd"]``, since its products round as K1sb's) or
    ``k1`` (K1f and K1b, within twice those).  b2 takes ``delta =
    rowsum(o do) - g_lse`` and ``lse`` from the reference forward.  Adds
    the wrappers' calls to ``calls``; fails the run above the tolerance.
    Returns (worst element ratio, {wrapper: worst absolute error})."""
    name = _dtype_name(q.dtype)
    if ref == "plain":
        fwd = lambda a, b, c: _per_row(
            lambda x, y, z: kernels.flash_attention_lse_plain(x, y, z, causal),
            a, b, c, heads=True)
        bwd = lambda *a: _per_row(
            lambda *x: kernels.flash_attention_lse_bwd_plain(*x, causal), *a,
            heads=True)
        factor = 1.0
    else:
        fwd = lambda a, b, c: kernels.flash_attention_lse(a, b, c, causal)
        bwd = lambda *a: kernels.flash_attention_lse_bwd(*a, causal)
        factor = 2.0
    with torch.no_grad():
        po, plse = fwd(q, k, v)
        mass = fwd(q, k, v.abs())[0]
    rtol, arel = TOL_ELEM["fwd"][name]
    parts, errs = {}, {}
    for fn in (probe.flash_fwd_row_state, probe.flash_fwd_two_pass,
               probe.flash_fwd_full_row):
        o = fn(q, k, v, causal, block)
        calls[fn.__name__] += 1
        parts[fn.__name__] = _close(o, po, mass, factor * rtol,
                                    factor * arel)
        errs[fn.__name__] = (o.float() - po.float()).abs().max().item()
        if fn is not probe.flash_fwd_row_state:
            again = fn(q, k, v, causal, block)
            calls[fn.__name__] += 1
            _check(torch.equal(o, again), f"{fn.__name__} {tuple(q.shape)} "
                   f"block {block}: two launches differ")
            del again
        del o
    del mass
    delta = (po.float() * do.float()).sum(dim=-1) - g_lse
    got = probe.flash_bwd_row_state(q, k, v, do, plse, delta, causal, block)
    calls["flash_bwd_row_state"] += 1
    want = bwd(q, k, v, po, plse, do, g_lse)
    rtol, arel, atop = TOL_ELEM["stream_bwd"][name]
    masses = _flash_bwd_mass(q, k, v, po, plse, do, g_lse, causal)
    tops = (_flash_bwd_top(q, k, v, po, plse, do, g_lse, causal) if atop
            else (None,) * 3)
    errs["flash_bwd_row_state"] = 0.0
    for key, a, w, m, tp in zip(("dq", "dk", "dv"), got, want, masses, tops):
        parts[f"b2 {key}"] = _close(a, w, m, factor * rtol, factor * arel, tp,
                                    factor * atop)
        errs["flash_bwd_row_state"] = max(
            errs["flash_bwd_row_state"],
            (a.float() - w.float()).abs().max().item())
    worst = max(parts.values())
    _check(worst <= 1.0, f"race kernels {tuple(q.shape)} causal={causal} "
           f"{name} block {block} against {ref}: " + ", ".join(
               f"{k} {v:.3g}" for k, v in parts.items())
           + " of the element tolerance")
    return worst, errs


def _row_state_bits(torch, kernels, probe, q, k, v, do, g_lse, causal,
                    calls) -> None:
    """The bf16 v2 and b2 on K1f's kernel and K1b's pair, bit for bit: v2
    at block 128 is K1f's instantiation less the lse store, so its ``o``
    must be K1f's; b2 at block 64 is K1b's tiling, so given the delta that
    K1b's dq pass wrote it must give K1b's ``dq``, ``dk``, ``dv``.  Adds
    the race wrappers' calls to ``calls``; fails the run otherwise."""
    shape = tuple(q.shape)
    with torch.no_grad():
        o, lse = kernels.flash_attention_lse(q, k, v, causal)
        o2 = probe.flash_fwd_row_state(q, k, v, causal, 128)
        calls["flash_fwd_row_state"] += 1
        _check(torch.equal(o2, o), f"v2 {shape} causal={causal} block 128: "
               f"o is not K1f's bit for bit")
        delta = torch.empty(lse.shape, dtype=torch.float32, device=q.device)
        want = kernels._launch_bwd("K1b", False, q, k, v, o, lse, do, g_lse,
                                   causal, delta=delta)
        got = probe.flash_bwd_row_state(q, k, v, do, lse, delta, causal, 64)
        calls["flash_bwd_row_state"] += 1
        _check(all(torch.equal(a, w) for a, w in zip(got, want)),
               f"b2 {shape} causal={causal} block 64 from K1b's delta: "
               f"dq, dk, dv not K1b's bit for bit")


def _probe_poison(torch, kernels, probe, q, k, v, block, calls,
                  plain: bool = False):
    """The formulations' key ranges, causal, with a NaN at the last key of
    ``v``: v4 multiplies every key tile's ``v`` by its ``p`` (an exact 0
    above the diagonal), so every row of its ``o`` is NaN, as in
    ``_v4_kernel``'s one product over the row and in the plain version's
    (checked with ``plain``); v3 stops each 64-row warpgroup at its
    diagonal, so its rows before the last key's tile stay finite and its
    last row is NaN.  Returns {"v3", "v4"(, "plain"): 0.0 if the NaN rows
    are as they must be, else inf}."""
    t = q.shape[-2]
    vp = v.clone()
    vp[..., t - 1, :] = float("nan")
    k0 = (t - 1) // block * block  # the first key of the last key tile
    parts = {}
    with torch.no_grad():
        nan4 = probe.flash_fwd_full_row(q, k, vp, True, block).isnan().any(-1)
        nan3 = probe.flash_fwd_two_pass(q, k, vp, True, block).isnan().any(-1)
        calls["flash_fwd_full_row"] += 1
        calls["flash_fwd_two_pass"] += 1
        parts["v4"] = 0.0 if bool(nan4.all()) else math.inf
        parts["v3"] = 0.0 if bool(nan3[..., t - 1].all()) and not bool(
            nan3[..., :k0].any()) else math.inf
        if plain:
            po = _per_row(lambda x, y, z: kernels.flash_attention_lse_plain(
                x, y, z, True), q, k, vp, heads=True)[0]
            parts["plain"] = 0.0 if bool(po.isnan().any(-1).all()) else \
                math.inf
    return parts


def phase_probe_kernels(torch, kernels, F, rows):
    """The kernels of the P1/P2 race (v2, v3, v4 and b2: in bf16 K1f's
    kernel, the two-pass kernel of ``csrc/flash_probe.cu`` and K1b's pair;
    in f32 the FMA kernels of ``csrc/flash_probe.cu`` and
    ``csrc/flash_probe_bwd.cu``) against their plain versions element by
    element, the bf16 v2 and b2 also against K1f and K1b bit for bit, then
    timed at the race's shapes; then the path that runs them: both races
    (``flexflow_torch.tools.probe_flash_variants`` and
    ``probe_flash_bwd_variants``) at the 2k and 8k shapes, in-process, with
    exact launch counts.  Returns (per-kernel rows, the races' launch
    counts)."""
    from flexflow_torch.ops import probe_kernels as probe
    from flexflow_torch.tools import (probe_flash_bwd_variants,
                                      probe_flash_variants)

    g = torch.Generator(device="cuda").manual_seed(5)
    f32, bf16 = torch.float32, torch.bfloat16
    blocks = probe.PROBE_BLOCKS
    out = {}

    def randn(shape, dt):
        return torch.randn(shape, generator=g, device="cuda").to(dt)

    # -- element by element against the plain versions --
    calls = {fn.__name__: 0 for fn in probe.PROBE_KERNELS}
    _zero_counts()
    train, long = PROBE_RACE
    cases = [(train, True, bf16), ((2, 8, 1024, 64), False, bf16),
             ((2, 8, 1024, 64), True, f32), ((2, 8, 1024, 128), True, bf16),
             ((1, 4, 256, 128), False, f32), ((1, 8, 80, 64), True, bf16),
             ((1, 8, 1, 64), True, f32), ((1, 2, 130, 128), False, bf16),
             ((1, 2, 200, 64), False, f32), ((1, 2, 200, 128), True, f32)]
    cases += [(shape, causal, bf16) for shape, causal in PROBE_WRAP]
    worst, err_train = 0.0, {}
    for shape, causal, dt in cases:
        q, k, v, do = (randn(shape, dt) for _ in range(4))
        g_lse = randn(shape[:3], f32)
        for block in blocks:
            ratio, errs = _probe_hold(torch, kernels, probe, q, k, v, do,
                                      g_lse, causal, block, "plain", calls)
            worst = max(worst, ratio)
            if shape == train and block == blocks[0]:
                err_train = errs
        if dt == bf16:
            _row_state_bits(torch, kernels, probe, q, k, v, do, g_lse,
                            causal, calls)
        del q, k, v, do, g_lse
    torch.cuda.synchronize()
    print(f"[probe-kernels] {len(cases)} shapes x blocks {blocks} against "
          f"the plain versions (v2, v3, v4: o; b2: dq, dk, dv; causal and "
          f"not, f32 and bf16, hd 64/128, t = 1 to 2048, the ring-wrapping "
          f"{[s for s, _ in PROBE_WRAP]}): worst element {worst:.3g} of its "
          f"tolerance; v3 and v4 bit-identical across two launches; bf16 v2 "
          f"at block 128 K1f's o and b2 at block 64 from K1b's delta K1b's "
          f"dq, dk, dv, bit for bit, at every bf16 shape")
    for shape, plain in ((train, False), (PROBE_WRAP[0][0], True)):
        q, k, v = (randn(shape, bf16) for _ in range(3))
        for block in blocks:
            parts = _probe_poison(torch, kernels, probe, q, k, v, block, calls,
                                  plain)
            _check(max(parts.values()) == 0.0, f"{shape} block {block}, a "
                   f"NaN at the last key: {parts} (v4 must reach every "
                   f"row, v3 stop at the diagonal)")
        del q, k, v
    print(f"[probe-kernels] a NaN at the last key of v, causal: every row of "
          f"v4 NaN, v3's rows before the last key tile finite, at "
          f"{train} and {PROBE_WRAP[0][0]}, blocks {blocks}")
    for name in ("v2", "v3", "v4", "b2 dq", "b2 dkv"):
        attrs = {(hd, blk): probe.probe_attrs(name, hd, blk)
                 for hd in probe.PROBE_HEAD_DIMS for blk in blocks}
        print(f"[probe-kernels] {name} bf16 registers, spill bytes, shared "
              f"memory by (hd, block): {attrs}")
        _check(all(a[1] == 0 for (hd, _), a in attrs.items() if hd == 64),
               f"{name} bf16 spills at the race's head dim 64: {attrs}")
    q, k, v, do = (randn(long, bf16) for _ in range(4))
    g_lse = randn(long[:3], f32)
    _row_state_bits(torch, kernels, probe, q, k, v, do, g_lse, True, calls)
    for block in blocks:
        r_plain, _ = _probe_hold(torch, kernels, probe, q, k, v, do, g_lse,
                                 True, block, "plain", calls)
        r_k1, _ = _probe_hold(torch, kernels, probe, q, k, v, do, g_lse, True,
                              block, "k1", calls)
        print(f"[probe-kernels] {long} bf16 causal block {block}: worst "
              f"element {r_plain:.3g} (plain, row by row), {r_k1:.3g} "
              f"(K1f/K1b, twice the tolerance) of its tolerance")
    del q, k, v, do, g_lse
    torch.cuda.synchronize()
    got = _counts()
    _check(all(got[n] == c > 0 for n, c in calls.items()),
           f"race kernel launches {got} against the calls made {calls}")

    # -- device times at the race's shapes --
    for shape in PROBE_RACE:
        b, h, t, hd = shape
        q, k, v, do = (randn(shape, bf16) for _ in range(4))
        with torch.no_grad():
            o, lse = kernels.flash_attention_lse(q, k, v, True)
        delta = (o.float() * do.float()).sum(dim=-1)
        full = t <= 2048  # the plain versions' f32 t x t temporaries fit
        pairs = t * (t + 1) // 2
        # The causal function's work (v3 computes 1.5x its products, v4
        # 3x): q, k, v read and o written; q, k, v, do, lse, delta read
        # and dq, dk, dv written.
        fb, fby = _bound_ms(4 * b * h * t * hd * 2, 4 * b * h * hd * pairs,
                            "bfloat16")
        bb, bby = _bound_ms(7 * b * h * t * hd * 2 + 2 * b * h * t * 4,
                            10 * b * h * hd * pairs, "bfloat16")
        plain_f = lambda *x: probe.flash_fwd_row_state_plain(*x, True)
        plain_b = lambda *x: probe.flash_bwd_row_state_plain(*x, True)
        with torch.no_grad():
            pf = _device_ms(lambda: plain_f(q, k, v) if full else _per_row(
                lambda *x: (plain_f(*x),), q, k, v), 5)
            lf = _device_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True))
        pb = _device_ms(lambda: plain_b(q, k, v, do, lse, delta) if full
                        else _per_row(plain_b, q, k, v, do, lse, delta), 5)
        qs, ks, vs = (x.detach().clone().requires_grad_(True)
                      for x in (q, k, v))
        sd = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
        lb = _device_ms(lambda: torch.autograd.grad(sd, (qs, ks, vs), do,
                                                    retain_graph=True))
        del qs, ks, vs, sd
        leg = "train" if shape == train else "longctx"
        for fn in probe.PROBE_KERNELS:
            bwd = fn is probe.flash_bwd_row_state
            with torch.no_grad():
                ms = {block: _device_ms(
                    (lambda: fn(q, k, v, do, lse, delta, True, block)) if bwd
                    else (lambda: fn(q, k, v, True, block)))
                    for block in blocks}
            bound, by = (bb, bby) if bwd else (fb, fby)
            plain, lib = (pb, lb) if bwd else (pf, lf)
            extra = {}
            if fn.__name__ in ("flash_fwd_two_pass", "flash_fwd_full_row"):
                extra["bound_done_ms"], _ = _bound_ms(
                    4 * b * h * t * hd * 2,
                    race_products(fn.__name__, t) * 4 * b * h * hd * pairs,
                    "bfloat16")
            print(f"[probe-kernels] {fn.__name__} {shape} bf16 causal: "
                  + ", ".join(f"block {blk} {m:.6f} ms" for blk, m in
                              ms.items())
                  + f" ({min(ms.values()) / bound:.1f}x its bound {bound:.6f} "
                  f"by {by}"
                  + (f", {min(ms.values()) / extra['bound_done_ms']:.2f}x the "
                     f"bound {extra['bound_done_ms']:.6f} of the products it "
                     f"does" if extra else "")
                  + f"; plain {plain:.6f}"
                  f"{'' if full else ', one batch row at a time'}; sdpa "
                  f"{'backward' if bwd else 'forward'} {lib:.6f})")
            row = dict(ms=ms[blocks[0]], ms_by_block=ms, plain_ms=plain,
                       bound_ms=bound, bound_by=by, library_ms=lib, **extra)
            if leg == "train":
                out[fn.__name__] = dict(max_abs_err=err_train[fn.__name__],
                                        **row)
            else:
                out[fn.__name__]["longctx_shape"] = row
        del q, k, v, do, o, lse, delta
        torch.cuda.empty_cache()

    # -- the path: both races at the 2k and 8k shapes --
    _zero_counts()
    race = []
    for shape in PROBE_RACE:
        argv = [str(x) for x in shape]
        for tool in (probe_flash_variants, probe_flash_bwd_variants):
            _check(tool.main(argv, rows_out=race) == 0,
                   f"{tool.__name__} {argv} failed")
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    launches = _counts()
    want = {n: 0 for n in launches}
    for r in race:
        if RACE_WRAPPERS[r["name"]] is not None:
            want[RACE_WRAPPERS[r["name"]]] += r["calls"]
    # The backward race's K1f forward, for o and lse, once per run.
    want["flash_attention_lse"] += len(PROBE_RACE)
    _check(launches == want and all(
        launches[fn.__name__] > 0 for fn in probe.PROBE_KERNELS),
        f"race launch counts {launches}, expected {want}")
    for r in race:
        _check(r["unsupported"] is None and r["ms"] is not None
               and math.isfinite(r["ms"]) and r["ms"] > 0
               and r["err"] <= TOL_RACE * r["scale"],
               f"race row {r}: no finite positive time, or its error beyond "
               f"{TOL_RACE} of {r['scale']}")
    # The race's timer against the kernel table's (_device_ms, phase 12).
    table = {(train, "v1_base"): rows[f"stream@{train}"]["K1f"],
             (train, "v6_stream"): rows[f"stream@{train}"]["K1s"],
             (train, "b1_prod"): rows[f"stream@{train}"]["K1b"],
             (train, "b3_stream"): rows[f"stream@{train}"]["K1sb"],
             (long, "v1_base"): rows["flash_attention_lse@8k"]["ms"],
             (long, "v6_stream"): rows["flash_attention_lse_streamed"]["ms"],
             (long, "b1_prod"): rows["flash_attention_lse_bwd@8k"]["ms"],
             (long, "b3_stream"):
                 rows["flash_attention_lse_streamed_bwd"]["ms"]}
    pairs = [(r, table[r["shape"], r["name"]]) for r in race
             if (r["shape"], r["name"]) in table]
    print("[probe-kernels] race slope / phase 12 device time: " + ", ".join(
        f"{r['name']} {r['shape']} {r['ms']:.4f} / {ms:.4f} = "
        f"{r['ms'] / ms:.3f}" for r, ms in pairs))
    print(f"[probe-kernels] races at {PROBE_RACE}: {len(race)} rows, every "
          f"error within {TOL_RACE} of its slice; launches {launches}")
    return out, launches


#: The AlexNet configuration of phases 16-18: bench.py's AlexNet leg
#: (``bench.py:180-202``: batch 2048, 229 x 229 x 3 NHWC, 1000 classes,
#: bf16, SGD lr 0.01 momentum 0.9 wd 1e-4, 3 warmup + 20 timed steps)
#: through the port's bench entry, ``flexflow_torch.bench.bench_alexnet``.
ALEXNET = dict(batch=2048, image=229, classes=1000, iters=20, warmup=3)
#: Phase 18's f32 step: the full widths at image 67 (flat 256), batch 8,
#: 1000 classes, held as phase 6's step is (``TOL_TRAIN_LOSS``,
#: ``TOL_TRAIN_GRAD``); the updated params within ``lr`` times the
#: gradient bound plus two f32 ulps of the tensor's largest value.
ALEXNET_PARITY = dict(batch=8, image=67, classes=1000, seed=0)
SGD_ALEXNET = dict(lr=0.01, momentum=0.9, weight_decay=1e-4)


def phase_alexnet_kernels(torch, kernels, F):
    """K3 at AlexNet's loss shape, (2048, 1000) bf16, in each form against
    its plain version (labels over every class and an out-of-range one,
    planted argmax ties), timed by ``_device_ms`` and by chain slope
    beside the bound and ``F.cross_entropy``.  Returns the rows of both K3
    kernels at this shape, in the form the chooser takes, with each
    form's times."""
    g = torch.Generator(device="cuda").manual_seed(16)
    n, v = ALEXNET["batch"], ALEXNET["classes"]
    x = 3.0 * torch.randn((n, v), generator=g, device="cuda")
    labels = torch.randint(0, v, (n,), generator=g, device="cuda",
                           dtype=torch.int32)
    labels[:3] = torch.tensor([0, v - 1, 8], device="cuda", dtype=torch.int32)
    # Equal maxima inside one 8-element chunk, across chunks, at the
    # row's two ends and three in a row; then every place where a form
    # splits a row (``_xent_tie_cols``).
    tie_cols = [(3, 5), (7, 8), (v - 1, 0), (100, 7, v - 2)]
    tie_cols += _xent_tie_cols(v)
    top = x.max() + 1.0
    for r, cols in enumerate(tie_cols):
        x[r, list(cols)] = top
    x = x.to(torch.bfloat16)
    gn = torch.full((n,), 1.0 / n, device="cuda")
    gl = torch.randn((n,), generator=g, device="cuda")
    # The held labels: the last row's out of range, which must give a NaN
    # nll (the timed calls take ``labels``, which F.cross_entropy takes).
    held_labels = labels.clone()
    held_labels[-1] = v
    errs = {}
    for form in XENT_FORMS:
        errs[form], (nll, lse, pred, d, pd) = _xent_hold(
            torch, kernels, x, held_labels, gn, gl, form)
        _xent_held(errs[form], f"softmax_xent ({n}, {v}) bf16 {form}")
        got = [int(pred[r]) for r in range(len(tie_cols))]
        _check(got == [min(c) for c in tie_cols],
               f"softmax_xent {form} ties: pred {got}")
        print(f"[alexnet-kernels] softmax_xent ({n}, {v}) bf16, {form} form, "
              f"with {len(tie_cols)} rows of planted ties and an "
              f"out-of-range label: nll err {errs[form]['nll']:.3g} lse err "
              f"{errs[form]['lse']:.3g}, dlogits worst element "
              f"{errs[form]['dlogits']:.3g} of its tolerance, pred exact")
    chosen = kernels._xent_form(v)
    lse = kernels._xent_fwd(x, labels, chosen.form)[1]
    lab64 = labels.long()
    xr = x.detach().clone().requires_grad_(True)
    ce = F.cross_entropy(xr, lab64, reduction="none")
    gce = gn.to(ce.dtype)
    fns = {
        "fwd": (lambda form: kernels._xent_fwd(x, labels, form),
                lambda: kernels.softmax_xent_plain(x, labels),
                lambda: F.cross_entropy(x, lab64, reduction="none")),
        "bwd": (lambda form: kernels._xent_bwd(x, labels, lse, gn, gl, form),
                lambda: kernels.softmax_xent_bwd_plain(x, labels, lse, gn, gl),
                lambda: torch.autograd.grad(ce, xr, gce, retain_graph=True)),
    }
    # Logits read (and, backward, dlogits written) once, the rows'
    # scalars moved; about four f32 operations per logit.
    bounds = {"fwd": _bound_ms(n * v * 2 + 16 * n, 4 * n * v, "float32"),
              "bwd": _bound_ms(2 * n * v * 2 + 16 * n, 4 * n * v, "float32")}
    floor = _chain_ms(lambda i: torch.cuda._sleep(0))
    rows = {}
    for part, (kern, plain, lib) in fns.items():
        lib_chain = _chain_ms(lambda i: lib())
        plain_ms = _device_ms(plain)
        bound, by = bounds[part]
        name = "softmax_xent" if part == "fwd" else "softmax_xent_bwd"
        forms = {}
        for form in XENT_FORMS:
            ms, lib_ms = _pair_ms(lambda: kern(form), lib)
            chain = _chain_ms(lambda i: kern(form))
            forms[form] = dict(ms=ms, chain_ms=chain)
            print(f"[alexnet-kernels] {name} ({n}, {v}) bf16, {form} form: "
                  f"one launch {ms:.6f} ms, chain slope {chain:.6f} (plain "
                  f"{plain_ms:.6f}; F.cross_entropy"
                  f"{' backward' if part == 'bwd' else ''} {lib_ms:.6f}, "
                  f"slope {lib_chain:.6f}; bound {bound:.6f} by {by}; launch "
                  f"floor {floor:.6f})")
        err = max(errs[f][k] for f in XENT_FORMS for k in (
            ("nll", "lse") if part == "fwd" else ("dlogits_abs",)))
        rows[f"{name}@alexnet"] = dict(
            max_abs_err=err, **forms[chosen.form], plain_ms=plain_ms,
            bound_ms=bound, bound_by=by, library_ms=lib_ms,
            library_chain_ms=lib_chain, launch_floor_ms=floor,
            form=_form_name(chosen), forms=forms)
    return rows


def phase_alexnet_train(torch, kernels):
    """bench.py's AlexNet leg through the port's bench entry at its full
    shape; returns the launch counts of this run."""
    from flexflow_torch import bench
    from flexflow_torch.models.alexnet import build_alexnet
    from flexflow_torch.search.cost_model import train_flops

    c = ALEXNET
    stats = {}
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    _zero_counts()
    sps, mfu, batch = bench.bench_alexnet(
        device="cuda", batch_size=c["batch"], image_size=c["image"],
        num_classes=c["classes"], iters=c["iters"], warmup=c["warmup"],
        stats_out=stats)
    torch.cuda.synchronize()
    launches = _counts()
    peak_gb = (torch.cuda.max_memory_allocated() - held) / 1e9
    losses = stats["step_losses"]
    steps = c["warmup"] + c["iters"]
    _check(batch == c["batch"] and len(losses) == steps
           and all(math.isfinite(x) for x in losses),
           f"alexnet step losses {losses}")
    want = {n: 0 for n in launches}
    want.update(softmax_xent=steps, softmax_xent_bwd=steps)
    _check(launches == want, f"alexnet launch counts {launches}, expected "
           f"{want}")
    ms_step = stats["elapsed_s"] * 1e3 / stats["iterations"]
    flops = train_flops(build_alexnet(batch_size=c["batch"],
                                      image_size=c["image"],
                                      num_classes=c["classes"]))
    print(f"[alexnet-train] losses {[round(x, 5) for x in losses]}; "
          f"{ms_step:.3f} ms/step, images/s {sps:.1f}, MFU "
          f"{100 * mfu:.2f}% of 989 TFLOP/s ({flops:.5g} FLOP/step); peak "
          f"memory {peak_gb:.2f} GB; launches {launches}")
    return launches


#: Kernel-name groups of phase 17's profile, first match wins (the pools'
#: kernels name their layout, ``nhwc``, as cuDNN's do).
ALEXNET_GROUPS = (
    ("K3", ("xent",)),
    ("pool", ("pool",)),
    ("conv (cuDNN)", ("conv", "cudnn", "implicit", "fprop", "dgrad", "wgrad",
                      "winograd", "fft", "nhwc", "nchw")),
    ("GEMM (cuBLAS)", ("gemm", "cublas", "cutlass", "nvjet", "splitk")),
    ("copy", ("memcpy", "memset", "copy")),
    ("elementwise, reductions", ("",)),
)


def phase_alexnet_profile(torch):
    """One warm step of phase 17's model under torch.profiler: the busy
    share, time by kernel and by kernel group; the optimizer's share by
    CUDA events around ``optimizer.update``.  (conv1's layouts and the
    step with cuDNN's plans timed or not are
    ``flexflow_torch/tools/alexnet_conv.py``'s.)"""
    from flexflow_torch.config import FFConfig
    from flexflow_torch.models.alexnet import build_alexnet
    from flexflow_torch.optim import SGDOptimizer
    from flexflow_torch.runtime.executor import Executor
    from flexflow_torch.runtime.trainer import Trainer

    c = ALEXNET
    cfg = FFConfig(batch_size=c["batch"], compute_dtype="bfloat16")
    ff = build_alexnet(batch_size=c["batch"], image_size=c["image"],
                       num_classes=c["classes"], config=cfg)
    ex = Executor(ff, cfg, optimizer=SGDOptimizer(**SGD_ALEXNET),
                  device="cuda")
    state = list(ex.init())
    batch = Trainer(ex).synthetic_batch()

    def step():
        state[:3] = ex.train_step(*state, batch)[:3]

    for _ in range(3):
        step()
    groups = {name: 0.0 for name, _ in ALEXNET_GROUPS}
    for us, key, _ in _profile_step(torch, "alexnet-profile", step):
        name = next(n for n, subs in ALEXNET_GROUPS
                    if any(s in key.lower() for s in subs))
        groups[name] += us / 1e3
    busy = sum(groups.values())
    print("[alexnet-profile] device ms by kernel group: " + ", ".join(
        f"{n} {ms:.3f} ({100 * ms / busy:.1f}%)" for n, ms in groups.items()))

    # The optimizer's device time: events around optimizer.update on one
    # warm step, with the host enqueueing ahead behind a spin.
    params, opt_state, st = state
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)
    ev[0].record()
    _, _, _, grads = ex.loss_and_grads(params, st, batch)
    ev[1].record()
    params, opt_state = ex.optimizer.update(params, opt_state, grads)
    ev[2].record()
    ev[2].synchronize()
    state[:2] = params, opt_state
    fb, upd = ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])
    print(f"[alexnet-profile] forward+backward {fb:.3f} ms, SGD update "
          f"{upd:.3f} ms (CUDA events); the profile's busy {busy:.3f} ms is "
          f"{100 * busy / (fb + upd):.1f}% of their sum")


class _CardBranches:
    """A CNN's kinks taken the card's way on the CPU: each ReLU's mask
    (convolutions', linears' and BatchNorms' fused ReLUs)
    and each max pool's choice of window element, recorded in call order
    on the card's step (``replay`` False) and taken by the CPU's step
    (``replay`` True).  An input within rounding of a kink (a ReLU input
    at zero, two maxima of a pool window) may take the other branch on
    the card, and the two gradients then differ by that branch's whole
    term, not by rounding: one ReLU input of linear2 did so at phase 18's
    step with cuDNN's plans timed and untimed alike, while every
    convolution kept within a few f32 epsilons of its absolute terms
    (``python3 -m flexflow_torch.tools.alexnet_conv plans``).  Each place
    where the CPU's own branch differs must be a kink to within ``rtol``
    of its tensor's largest magnitude; ``moved`` counts them."""

    def __init__(self, torch, rtol: float):
        import flexflow_torch.ops.conv as conv
        import flexflow_torch.ops.linear as linear
        import flexflow_torch.ops.norm as norm

        self.torch, self.rtol, self.replay = torch, rtol, False
        self.conv, self.linear, self.norm = conv, linear, norm
        self.act, self.F = conv.apply_activation, conv.F
        self.log, self.at, self.moved = [], 0, {"relu": 0, "pool": 0}

    def __enter__(self):
        owner = self

        class _F:
            """``torch.nn.functional`` with ``max_pool2d`` through the
            log."""

            def __getattr__(self, name):
                return getattr(owner.F, name)

            def max_pool2d(self, x, kernel, stride):
                return owner._pool(x, kernel, stride)

        self.at = 0
        for mod in (self.conv, self.linear, self.norm):
            mod.apply_activation = self._act
        self.conv.F = _F()
        return self

    def __exit__(self, *exc):
        for mod in (self.conv, self.linear, self.norm):
            mod.apply_activation = self.act
        self.conv.F = self.F
        _check(exc[0] is not None or not self.replay
               or self.at == len(self.log),
               f"the CPU's step took {self.at} of the card's {len(self.log)} "
               f"branch records")

    def _next(self, own, what: str):
        if not self.replay:
            self.log.append((what, own.cpu()))
            return None
        kind, card = self.log[self.at]
        self.at += 1
        _check(kind == what and card.shape == own.shape,
               f"branch record {self.at}: the card's {kind} {card.shape}, "
               f"the CPU's {what} {own.shape}")
        return card

    def _act(self, y, activation):
        if activation != "relu":
            return self.act(y, activation)
        own = y.detach() > 0
        card = self._next(own, "relu")
        if card is None:
            return self.act(y, activation)
        diff = own != card
        if diff.any():
            a = y.detach().abs()
            _check(a[diff].max() <= self.rtol * a.max(),
                   f"a ReLU input {a[diff].max().item()} away from zero "
                   f"took the other branch on the card")
            self.moved["relu"] += int(diff.sum())
        return self.torch.where(card, y, self.torch.zeros((), dtype=y.dtype))

    def _pool(self, x, kernel, stride):
        y, idx = self.F.max_pool2d(x, kernel, stride, return_indices=True)
        card = self._next(idx, "pool")
        if card is None:
            return y
        picked = x.flatten(2).gather(2, card.flatten(2)).view_as(y)
        gap = (y - picked).detach()
        if (idx != card).any():
            _check(gap.max() <= self.rtol * x.detach().abs().max(),
                   f"a max-pool window whose maxima are {gap.max().item()} "
                   f"apart took the other element on the card")
            self.moved["pool"] += int((gap > 0).sum())
        return picked


def phase_alexnet_parity(torch, kernels):
    """One f32 SGD step of AlexNet at image 67 on the card (cuDNN, cuBLAS,
    K3; TF32 off) and on the CPU (plain versions) from the same params
    and batch, the CPU taking the card's branch at every kink
    (``_CardBranches``)."""
    import numpy as np

    from flexflow_torch.config import FFConfig
    from flexflow_torch.data.loader import synthetic_host_batch
    from flexflow_torch.models.alexnet import build_alexnet
    from flexflow_torch.optim import SGDOptimizer
    from flexflow_torch.runtime.executor import Executor

    c = ALEXNET_PARITY
    cfg = FFConfig(batch_size=c["batch"], compute_dtype="float32",
                   seed=c["seed"])
    ff = build_alexnet(batch_size=c["batch"], image_size=c["image"],
                       num_classes=c["classes"], config=cfg)
    params0 = Executor(ff, cfg, device="cpu").init_params()
    batch = synthetic_host_batch(ff, np.random.default_rng(c["seed"]),
                                 {"label": c["classes"]})
    out = {}
    branches = _CardBranches(torch, TOL_TRAIN_GRAD[0])
    for dev in ("cuda", "cpu"):
        ex = Executor(ff, cfg, optimizer=SGDOptimizer(**SGD_ALEXNET),
                      device=dev)
        params = {op: {k: p.detach().clone().to(ex.device)
                       for k, p in g.items()}
                  for op, g in params0.items()}
        _zero_counts()
        branches.replay = dev == "cpu"
        with branches:
            loss, _, _, grads = ex.loss_and_grads(params, {}, batch)
        grads_cpu = {op: {k: v.detach().cpu() for k, v in g.items()}
                     for op, g in grads.items()}
        ex.optimizer.update(params, ex.optimizer.init(params), grads)
        if dev == "cuda":
            torch.cuda.synchronize()
            n = _counts()
            _check(n["softmax_xent"] == n["softmax_xent_bwd"] == 1,
                   f"the f32 AlexNet step launched K3 {n['softmax_xent']} / "
                   f"{n['softmax_xent_bwd']} times")
        out[dev] = (float(loss), grads_cpu,
                    {op: {k: v.detach().cpu() for k, v in g.items()}
                     for op, g in params.items()})
    (lc, gc, pc), (lp, gp, pp) = out["cuda"], out["cpu"]
    _check(abs(lc - lp) <= TOL_TRAIN_LOSS,
           f"f32 AlexNet step loss: card {lc}, CPU {lp}")
    rtol, atol = TOL_TRAIN_GRAD
    lr = SGD_ALEXNET["lr"]
    worst_g = worst_p = 0.0
    for op in gp:
        for k in gp[op]:
            want, got = gp[op][k], gc[op][k]
            scale = want.abs().max().item()
            tol = rtol * scale + atol
            err = (got - want).abs().max().item()
            _check(err <= tol, f"f32 AlexNet grad {op}.{k}: err {err} at "
                   f"scale {scale}")
            worst_g = max(worst_g, err / tol)
            ulp = 2 * float(np.spacing(np.float32(pp[op][k].abs().max())))
            d = (pc[op][k] - pp[op][k]).abs().max().item()
            _check(d <= lr * tol + ulp, f"f32 AlexNet updated {op}.{k}: err "
                   f"{d}, bound {lr * tol + ulp}")
            worst_p = max(worst_p, d / (lr * tol + ulp))
    print(f"[alexnet-parity] f32 SGD step card vs CPU: loss {lc:.7f} vs "
          f"{lp:.7f}; worst grad err {worst_g:.3g} of its tolerance, worst "
          f"updated-param err {worst_p:.3g} of its tolerance; cuDNN's plans "
          f"{'timed' if torch.backends.cudnn.benchmark else 'untimed'}; "
          f"the CPU took the card's branch where its own differed at "
          f"{branches.moved['relu']} ReLU inputs and "
          f"{branches.moved['pool']} pool windows, each within "
          f"{TOL_TRAIN_GRAD[0]:g} of its tensor's largest magnitude of a "
          f"kink")


#: Phase 19 (``superstep``): the LM of phase 5 and the DLRM of phase 9
#: at their full widths, each as a superstep of ``k`` steps (one CUDA
#: graph a call) against the same steps run eagerly; the LM again through
#: ``apps.transformer`` with accumulation and remat.  Steps: ``k`` warmup
#: (the first call: eager, then captured) plus ``iters`` replayed (the
#: app's ``iters % k`` as a tail superstep, captured before its timed
#: calls); the eager runs take ``warmup`` + the rest, the same number.
SUPERSTEP_LM = dict(k=4, iters=4, eager_warmup=2)
SUPERSTEP_DLRM = dict(k=8, iters=16, eager_warmup=2)
SUPERSTEP_APP = dict(k=2, iters=3, accum=2)
#: A kernel wrapper's kernels by name in a profile: each launch of the
#: wrapper runs one kernel whose name holds each substring.
KERNEL_NAMES = {
    "flash_attention_lse": ("wg_fwd_kernel",),
    "flash_attention_lse_bwd": ("wg_dkv_kernel",),
    "softmax_xent": ("xent", "fwd_kernel"),
    "softmax_xent_bwd": ("xent", "bwd_kernel"),
    "gather_rows": ("gather_regs_kernel",),
    "scatter_add_rows": ("scatter_add_rows_kernel",),
    "flash_decode": ("decode_split_kernel",),
}


def _bits(t):
    """``t`` as integers of its width: equal bits, equal integers."""
    ints = {1: "uint8", 2: "int16", 4: "int32", 8: "int64"}
    import torch

    t = t.detach().contiguous()
    return t.view(getattr(torch, ints[t.element_size()]))


def _named_leaves(tree, prefix=""):
    import torch

    if isinstance(tree, torch.Tensor):
        yield prefix, tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _named_leaves(tree[k], f"{prefix}.{k}" if prefix else k)


def _leaf_paths(tree, path=()):
    """``(key path, tensor)`` of every tensor of a tree of dicts."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaf_paths(tree[k], path + (k,))
    elif hasattr(tree, "numel"):
        yield path, tree


def _with_clone(tree, path):
    """A copy of the dicts along ``path`` with the tensor there cloned
    (every other tensor the same object)."""
    if not path:
        return tree.clone()
    return {**tree, path[0]: _with_clone(tree[path[0]], path[1:])}


def _bit_diff(torch, a, b) -> list:
    """The leaves where two trees of tensors differ in any bit."""
    la, lb = dict(_named_leaves(a)), dict(_named_leaves(b))
    _check(sorted(la) == sorted(lb), f"trees differ in keys: {sorted(la)} "
           f"vs {sorted(lb)}")
    return [n for n in la if not torch.equal(_bits(la[n]), _bits(lb[n]))]


def _fit_quiet(trainer, **kw):
    """``trainer.fit(**kw)`` with its report lines swallowed; returns the
    stats and the trained ``(params, opt_state, state)``."""
    import contextlib
    import io

    with contextlib.redirect_stdout(io.StringIO()):
        stats = trainer.fit(**kw)
    return stats, trainer.final


def _same_run(torch, what, a, b) -> None:
    """Two runs' ``(stats, (params, opt_state, state))``, bit for bit:
    every step's loss, every parameter and every optimizer state
    tensor (Adam's moments and ``t``)."""
    (sa, (pa, oa, _)), (sb, (pb, ob, _)) = a, b
    _check(sa["step_losses"] == sb["step_losses"],
           f"{what}: step losses {sa['step_losses']} vs {sb['step_losses']}")
    diff = _bit_diff(torch, pa, pb) + _bit_diff(torch, oa or {}, ob or {})
    _check(not diff, f"{what}: tensors differ in bits: {diff}")


PROFILE_TRIES = 3


def _replay_counts(torch, tag, fn, carry, stacked, per_step) -> float:
    """Capture ``fn`` (a superstep of ``fn.k`` steps, already warmed in
    this process) on ``carry``: the launch counters must rise by exactly
    ``k`` x ``per_step`` while capturing.  Then profile one replay: each
    kernel of ``per_step`` must run ``k`` x its count, by kernel name
    (never more; fewer only from a lossy trace, so a replay is profiled
    again, at most ``PROFILE_TRIES`` times).
    A call with another tensor than a captured one must raise.  Returns
    the replay's device busy time in microseconds."""
    k = fn.k
    _zero_counts()
    fn.capture(*carry, stacked)
    counts = _counts()
    want = {n: k * per_step.get(n, 0) for n in counts}
    _check(counts == want, f"{tag}: launches at capture {counts}, expected "
           f"{want}")
    params = carry[0]
    path = min(_leaf_paths(params), key=lambda p: p[1].numel())[0]
    other = _with_clone(params, path)
    try:
        fn(other, *carry[1:], stacked)
    except ValueError as e:
        _check("captured on other tensors" in str(e), f"{tag}: {e}")
    else:
        raise RuntimeError(f"chip_smoke: {tag}: a call with a clone of "
                           f"{'.'.join(map(str, path))} replayed the graph")
    replays = []

    def replay():
        replays.append(fn(*carry, stacked)[-1])

    # The trace can lose a kernel record of a long replay (one
    # flash_attention_lse record of the LM's four-step replay was
    # missing once on an H100): a count below the expected one profiles a fresh replay, at
    # most PROFILE_TRIES in all; a count above it fails at once.
    for attempt in range(1, PROFILE_TRIES + 1):
        dev = _profile_step(torch, tag, replay, f"one replay of {k} steps")
        _check(_counts() == want, f"{tag}: a replay moved the launch "
               f"counters")
        seen = {name: sum(c for _, key, c in dev
                          if all(s in key for s in KERNEL_NAMES[name]))
                for name in per_step}
        more = {n: v for n, v in seen.items() if v > k * per_step[n]}
        _check(not more, f"{tag}: kernels ran more often in one replay by "
               f"the profile than the graph launches them: {more}, "
               f"expected {k} x {per_step}")
        short = {n: v for n, v in seen.items() if v < k * per_step[n]}
        if not short:
            break
        print(f"[{tag}] profile {attempt} of {PROFILE_TRIES} lost kernel "
              f"records: {short}, expected {k} x {per_step}")
    _check(not short, f"{tag}: {short} ran fewer times in one replay by "
           f"the profile than {k} x {per_step}, in each of "
           f"{PROFILE_TRIES} profiled replays")
    return sum(us for us, _, _ in dev)


def phase_superstep(torch, kernels):
    """The port's supersteps on the card at bench.py's widths: (a) the
    LM of phase 5 through ``Trainer.fit(steps_per_call=4)``, (b) the
    plain-SGD DLRM of phase 9 at ``steps_per_call=8``, (c) the LM through
    ``apps.transformer`` with ``--accum-steps 2 --remat
    --steps-per-call 2``.  Each is held bit for bit against the same
    steps run eagerly, after two eager runs are held against each other.
    Launches inside a graph: the counters at capture and the profile of
    one replay.  Returns the launch counts of the three graph runs."""
    import numpy as np

    from flexflow_torch.apps import transformer
    from flexflow_torch.apps.common import make_optimizer
    from flexflow_torch.config import FFConfig
    from flexflow_torch.data.loader import synthetic_host_batch
    from flexflow_torch.models.transformer import build_transformer_lm
    from flexflow_torch.runtime.executor import Executor
    from flexflow_torch.runtime.trainer import MAX_STEPS_PER_CALL, Trainer

    card = _card()
    total = {}

    def add(counts):
        for n, v in counts.items():
            total[n] = total.get(n, 0) + v

    # -- (a) the LM, bench.py's 2k leg --
    c, s = TRAIN, SUPERSTEP_LM
    k = min(s["k"], MAX_STEPS_PER_CALL)

    def lm_executor(remat=False):
        cfg = FFConfig(batch_size=c["batch"], compute_dtype="bfloat16",
                       optimizer="adam", learning_rate=c["lr"],
                       seed=c["seed"], remat=remat)
        ff = build_transformer_lm(
            batch_size=c["batch"], seq_len=c["seq"], vocab_size=c["vocab"],
            d_model=c["d_model"], num_heads=c["heads"],
            num_layers=c["layers"], config=cfg)
        return Executor(ff, cfg, optimizer=make_optimizer(cfg), device="cuda")

    steps = k + s["iters"]
    eager = [_fit_quiet(Trainer(lm_executor()), iterations=steps
                        - s["eager_warmup"], warmup=s["eager_warmup"])
             for _ in range(2)]
    _same_run(torch, "LM, two eager runs", *eager)
    ex = lm_executor()
    _zero_counts()
    graph = _fit_quiet(Trainer(ex), iterations=s["iters"], warmup=k,
                       steps_per_call=k)
    counts = _counts()
    add(counts)
    _same_run(torch, f"LM, superstep k={k} vs eager", graph, eager[0])
    L = c["layers"]
    per_step = {"flash_attention_lse": L, "flash_attention_lse_bwd": L,
                "softmax_xent": 1, "softmax_xent_bwd": 1}
    # The first call ran k steps eagerly and captured k more; the
    # replays counted nothing.
    want = {n: 2 * k * per_step.get(n, 0) for n in counts}
    _check(counts == want, f"LM superstep launches {counts}, expected {want}")
    lm_ms = {1: eager[0][0]["elapsed_s"] * 1e3 / eager[0][0]["iterations"],
             k: graph[0]["elapsed_s"] * 1e3 / graph[0]["iterations"]}
    host = synthetic_host_batch(ex.model, np.random.default_rng(0))
    fn = ex.build_superstep(k)
    lm_busy = _replay_counts(torch, "superstep-lm", fn, graph[1],
                             ex.stack_steps([host] * k), per_step)
    del eager, graph, fn, ex

    # Peak memory of one step, without and with --remat.
    peaks = {}
    for remat in (False, True):
        ex = lm_executor(remat)
        p, o, st = ex.init()
        batch = Trainer(ex).synthetic_batch()
        ex.train_step(p, o, st, batch)  # warm: plans and workspaces
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ex.train_step(p, o, st, batch)
        torch.cuda.synchronize()
        peaks[remat] = (torch.cuda.max_memory_allocated() - held) / 1e9
        del ex, p, o, st, batch
    print(f"[superstep] LM (batch {c['batch']} x seq {c['seq']}, {L} layers, "
          f"bf16, Adam): {steps} steps, superstep k={k} bit-identical to the "
          f"eager steps (losses, params, Adam m, v and t; two eager runs "
          f"bit-identical first); {lm_ms[1]:.3f} ms/step eager (k=1), "
          f"{lm_ms[k]:.3f} ms/step as a graph (k={k}); one replay's device "
          f"busy {lm_busy / 1e3:.3f} ms; peak memory of a step above the "
          f"params and state: {peaks[False]:.2f} GB, {peaks[True]:.2f} GB "
          f"with --remat; {card}")

    # -- (b) the DLRM, bench.py's leg, plain SGD, row-sparse --
    d, s = DLRM, SUPERSTEP_DLRM
    k = min(s["k"], MAX_STEPS_PER_CALL)
    ff, cfg = _dlrm_model(d["batch"], d["vocab"], "bfloat16", d["seed"],
                          optimizer="sgd", learning_rate=d["lr"],
                          momentum=0.0, weight_decay=0.0)
    ex = Executor(ff, cfg, optimizer=make_optimizer(cfg), device="cuda")
    _check(bool(ex._sparse_ops), "the superstep DLRM is not sparse")
    params0 = ex.init_params()

    def init(seed=None):
        p = {op: {n: v.clone() for n, v in g.items()}
             for op, g in params0.items()}
        return p, ex.optimizer.init(p), {}

    ex.init = init  # one draw of the 2 GB of tables, copied per run
    steps = k + s["iters"]
    eager = [_fit_quiet(Trainer(ex), iterations=steps - s["eager_warmup"],
                        warmup=s["eager_warmup"]) for _ in range(2)]
    _same_run(torch, "DLRM, two eager runs", *eager)
    _zero_counts()
    graph = _fit_quiet(Trainer(ex), iterations=s["iters"], warmup=k,
                       steps_per_call=k)
    counts = _counts()
    add(counts)
    _same_run(torch, f"DLRM, superstep k={k} vs eager", graph, eager[0])
    per_step = {"gather_rows": 1, "scatter_add_rows": 1}
    want = {n: 2 * k * per_step.get(n, 0) for n in counts}
    _check(counts == want, f"DLRM superstep launches {counts}, expected "
           f"{want}")
    dlrm_ms = {1: eager[0][0]["elapsed_s"] * 1e3 / eager[0][0]["iterations"],
               k: graph[0]["elapsed_s"] * 1e3 / graph[0]["iterations"]}
    host = synthetic_host_batch(ff, np.random.default_rng(0))
    fn = ex.build_superstep(k)
    dlrm_busy = _replay_counts(torch, "superstep-dlrm", fn, graph[1],
                               ex.stack_steps([host] * k), per_step)
    del eager, graph, fn, params0, ex
    print(f"[superstep] DLRM (8 x 10^6 x 64 f32 tables, batch {d['batch']}, "
          f"bf16, plain SGD, row-sparse): {steps} steps, superstep k={k} "
          f"bit-identical to the eager steps (every table and dense "
          f"parameter; two eager runs bit-identical first); "
          f"{dlrm_ms[1]:.4f} ms/step eager (k=1), {dlrm_ms[k]:.4f} ms/step "
          f"as a graph (k={k}, {dlrm_ms[1] / dlrm_ms[k]:.2f}x); one replay's "
          f"device busy {dlrm_busy / 1e3:.3f} ms for {k} steps; {card}")

    # -- (c) the LM app with accumulation, remat and supersteps --
    s = SUPERSTEP_APP
    k = min(s["k"], MAX_STEPS_PER_CALL)
    flags = ["--accum-steps", str(s["accum"]), "--remat"]
    steps = k + s["iters"]  # one warmup step rounds up to one superstep
    tail = s["iters"] % k

    def app(argv):
        stats = {}
        import contextlib
        import io

        with contextlib.redirect_stdout(io.StringIO()):
            rc = transformer.main(argv, device="cuda", stats_out=stats)
        _check(rc == 0, f"transformer {argv} exited {rc}")
        return stats, stats.pop("final")

    eager_argv = _train_argv(dict(TRAIN, iters=steps - 1)) + flags
    eager = [app(eager_argv) for _ in range(2)]
    _same_run(torch, "LM app with accumulation and remat, two eager runs",
              *eager)
    _zero_counts()
    graph = app(_train_argv(dict(TRAIN, iters=s["iters"])) + flags
                + ["--steps-per-call", str(k)])
    counts = _counts()
    add(counts)
    losses = graph[0]["step_losses"]
    _check(len(losses) == steps and all(math.isfinite(x) for x in losses)
           and losses[-1] < losses[0], f"app superstep losses {losses}")
    _same_run(torch, "LM app superstep vs eager", graph, eager[0])
    a = s["accum"]
    # Per step: each microbatch runs K1f twice a layer (forward, then the
    # recompute in the backward), K1b once, K3 once each way.
    per_step = {"flash_attention_lse": 2 * a * L,
                "flash_attention_lse_bwd": a * L, "softmax_xent": a,
                "softmax_xent_bwd": a}
    # The first call's k eager steps, then the k-step graph and the tail's
    # graph captured.
    want = {n: (2 * k + tail) * per_step.get(n, 0) for n in counts}
    _check(counts == want, f"app superstep launches {counts}, expected "
           f"{want}")
    print(f"[superstep] LM app --accum-steps {a} --remat --steps-per-call "
          f"{k}: {steps} steps ({graph[0]['supersteps']} timed supersteps, "
          f"the last a tail of {tail}), losses "
          f"{[round(x, 5) for x in losses]}, bit-identical to the eager app "
          f"run (two eager runs bit-identical first); launches {counts}")
    print(f"[superstep] launches of the three graph runs {total}")
    return total


#: Phase 20's arms at SERVE widths: (a) paged with a pool of 40 blocks
#: (64 for the worst case) and 96 new tokens, so the first eight
#: reservations exceed the pool and admission waits; (b) the prefix cache
#: over 16 requests, 12 sharing one 64-token prefix (4 blocks) with 1-30
#: tail tokens of their own, 4 that prefix alone; (c) speculation at d = 4,
#: a full self-draft and a 2-layer one; (d) keyed sampling.
SERVE_FEATURES = dict(kv_block=16, kv_blocks=41, paged_max_new=96,
                      prefix_len=64, tails=(1, 30), speculate=4,
                      draft_layers=2, temperature=0.8, top_k=50,
                      sample_seed=3)


def _serve_runs(torch, ex, params, reqs, runs=1, **kw):
    """``runs`` runs of one Server (on the card its graph is captured in
    the first); returns the Server, each run's (tokens by request, stats)
    and the launches of all of them."""
    from flexflow_torch.runtime.serving import Server

    srv = Server(ex, params, {}, **kw)
    _zero_counts()
    outs = []
    for _ in range(runs):
        res, stats = srv.run(reqs)
        _check(stats["failed"] == 0, f"serve {kw} failed: "
               f"{[r.error for r in res.values() if r.error]}")
        outs.append(({rid: r.tokens for rid, r in res.items()}, stats))
    torch.cuda.synchronize()
    return srv, outs, _counts()


def _serve_launches(ex, srv, outs) -> dict:
    """The K1f and K6 launches a Server's runs must count: K1f L per
    prefill, from row 0 or an offset one (a full prefix hit runs none),
    and the draft's kept layers per draft prefill; K6 L per padded decode step
    (none on the paged main-model decode or with ``decode_kernel=False``)
    and the kept layers per draft step, counted at each step of an eager
    call and, for a graph, at its first call's eager steps and capture."""
    L = SERVE["layers"]
    Ld = len(ex._draft_cache_specs)
    d, K = srv.speculate, srv.decode_steps
    prefills = sum(st["prefills"] for _, st in outs)
    calls = sum(st["decode_supersteps"] for _, st in outs)
    kernel = ex.decode_kernel is not False
    main = L if kernel and not ex.paged else 0
    per_call = (d + 1) * (main + (Ld if kernel else 0)) if d else K * main
    graph = srv.engine[0].graph is not None
    return {"flash_attention_lse": L * prefills + (Ld * prefills if d else 0),
            "flash_decode": 2 * per_call if graph else per_call * calls}


def _held_launches(tag, counts, want) -> None:
    _check(all(counts[n] == v for n, v in want.items()) and
           all(c == 0 for n, c in counts.items() if n not in want),
           f"{tag}: launches {counts}, expected {want} and nothing else")


def _ms_per_step(srv, stats) -> float:
    steps = stats["decode_supersteps"] * (1 if srv.speculate else
                                          srv.decode_steps)
    return stats["decode_s"] * 1e3 / steps


def _pool_diff(torch, a, b, paged: bool) -> list:
    """The cache tensors where two Servers' caches differ in any bit,
    scratch block 0 of a pool left out."""
    rows = slice(1, None) if paged else slice(None)
    return [f"{n}.{kv}" for n in a for kv in ("k", "v")
            if not torch.equal(_bits(a[n][kv][rows]), _bits(b[n][kv][rows]))]


def phase_serve_features(torch, kernels):
    """ROADMAP item 4's serving features at SERVE widths: (a) paged KV,
    (b) the prefix cache, (c) speculation, (d) keyed sampling, (e) the
    decode superstep and the speculative round as CUDA graphs against
    their eager form, (f) exact K1f and K6 launches in every arm.
    Returns the launches of every run together."""
    import numpy as np

    from flexflow_torch.apps import serve
    from flexflow_torch.config import FFConfig
    from flexflow_torch.models.transformer import build_transformer_lm
    from flexflow_torch.runtime.serving import (
        KVBlockLedger, Request, ServingExecutor, synthetic_requests)

    c, f = SERVE, SERVE_FEATURES
    L, K, B = c["layers"], c["decode_steps"], c["max_batch"]
    card = _card()
    total = {}

    def add(counts):
        for n, v in counts.items():
            total[n] = total.get(n, 0) + v

    def app(dtype, extra, cfg=c):
        stats = {}
        _zero_counts()
        import contextlib
        import io

        with contextlib.redirect_stdout(io.StringIO()):
            rc = serve.main(_serve_argv(dtype, cfg) + extra, device="cuda",
                            stats_out=stats)
        torch.cuda.synchronize()
        counts = _counts()
        add(counts)
        _check(rc == 0 and stats["failed"] == 0, f"serve {extra} failed")
        return {rid: r.tokens for rid, r in stats.pop("results").items()}, \
            stats, counts

    # -- (a) paged: bit for bit against padded on the same decode ---------
    ca = dict(c, max_new=f["paged_max_new"])
    reqs = synthetic_requests(c["requests"], c["vocab"], prompt_len=c["prompt"],
                              max_new_tokens=ca["max_new"], seed=c["seed"])
    led = KVBlockLedger(f["kv_blocks"], f["kv_block"], c["max_seq"])
    first = sum(led.blocks_for(len(r.prompt), r.max_new_tokens)
                for r in reqs[:B])
    _check(first > led.capacity_blocks, f"the first {B} requests reserve "
           f"{first} blocks, the pool holds {led.capacity_blocks}: no wait")
    paged = ["--kv-block", str(f["kv_block"]), "--kv-blocks",
             str(f["kv_blocks"])]
    runs = {}
    for dtype, extra in (("bfloat16", ["--no-decode-kernel"]),
                         ("float32", [])):
        for layout, flags in (("padded", []), ("paged", paged)):
            toks, st, counts = app(dtype, flags + extra, ca)
            want = {"flash_attention_lse": L * st["prefills"],
                    "flash_decode": 2 * L * K if layout == "padded" and
                    not extra else 0}
            _held_launches(f"paged arm {dtype} {layout}", counts, want)
            runs[dtype, layout] = (toks, st)
    for dtype, how in (("bfloat16", "bit for bit, both on the einsum"),
                       ("float32", "padded on K6, paged on the einsum")):
        a, b = runs[dtype, "padded"][0], runs[dtype, "paged"][0]
        diff = [r for r in a if a[r] != b[r]]
        _check(not diff, f"paged tokens differ from padded ({dtype}, {how}) "
               f"for requests {diff}")
    st = runs["bfloat16", "paged"][1]
    cfg = FFConfig(compute_dtype="bfloat16", seed=c["seed"])
    ff = build_transformer_lm(
        batch_size=B, seq_len=c["max_seq"], vocab_size=c["vocab"],
        d_model=c["d_model"], num_heads=c["heads"], num_layers=L, config=cfg)
    pad_ex = ServingExecutor(ff, cfg, max_batch=B, max_seq=c["max_seq"],
                             buckets=c["buckets"], device="cuda")
    pg_ex = ServingExecutor(ff, cfg, max_batch=B, max_seq=c["max_seq"],
                            buckets=c["buckets"], device="cuda",
                            kv_block=f["kv_block"], kv_blocks=f["kv_blocks"])
    budget = pad_ex.cache_total_bytes()
    print(f"[serve-features] (a) paged {st['kv_blocks']} x {st['kv_block']}-"
          f"token blocks (the first {B} requests reserve {first} of "
          f"{led.capacity_blocks}: admission waited), {c['requests']} "
          f"requests of {ca['max_new']} new tokens: bf16 tokens bit-equal to "
          f"padded (both --no-decode-kernel), f32 tokens equal to padded on "
          f"K6; supersteps padded {runs['bfloat16', 'padded'][1]['decode_supersteps']}"
          f", paged {st['decode_supersteps']}; HBM per slot padded "
          f"{pad_ex.hbm_per_slot_bytes()} B, paged (4-token prompt, "
          f"{c['max_new']} new) {pg_ex.hbm_per_slot_bytes(4, c['max_new'])} B;"
          f" the padded cache's {budget} B admit {pad_ex.max_admissible_batch(budget, 4, c['max_new'])}"
          f" padded / {pg_ex.max_admissible_batch(budget, 4, c['max_new'])} "
          f"paged slots; pool {pg_ex.cache_total_bytes()} B")

    # -- (b) the prefix cache, f32: tokens equal to an unshared run ------
    cfg32 = FFConfig(compute_dtype="float32", seed=c["seed"])
    ff32 = build_transformer_lm(
        batch_size=B, seq_len=c["max_seq"], vocab_size=c["vocab"],
        d_model=c["d_model"], num_heads=c["heads"], num_layers=L,
        config=cfg32)
    rng = np.random.default_rng(c["seed"])
    prefix = rng.integers(0, c["vocab"], size=f["prefix_len"])
    order = "BSSSSSSBSSSSSSBB"
    preqs = []
    for i, kind in enumerate(order):
        tail = rng.integers(0, c["vocab"], size=int(rng.integers(
            f["tails"][0], f["tails"][1] + 1)) if kind == "S" else 0)
        preqs.append(Request(i, np.concatenate([prefix, tail]).astype(
            np.int32), c["max_new"]))
    outs = {}
    for cache in (False, True):
        ex = ServingExecutor(ff32, cfg32, max_batch=B, max_seq=c["max_seq"],
                             buckets=c["buckets"], device="cuda",
                             kv_block=f["kv_block"], prefix_cache=cache)
        params32 = ex.init(c["seed"])[0]
        srv, o, counts = _serve_runs(torch, ex, params32, preqs)
        add(counts)
        st = o[0][1]
        full = st["requests"] - st["prefills"]
        _held_launches(f"prefix arm (cache {cache})", counts,
                       _serve_launches(ex, srv, o))
        outs[cache] = (o[0][0], st, full, st.get("prefix_hits", 0) - full)
        del params32
    diff = [r for r in outs[False][0] if outs[False][0][r] != outs[True][0][r]]
    _check(not diff, f"shared-prefix f32 tokens differ from unshared for "
           f"requests {diff}")
    _, st, full, offset = outs[True]
    _check(st["prefix_hits"] > 0 and full > 0 and
           st["prefill_tokens_saved"] > 0, f"prefix arm: hits "
           f"{st['prefix_hits']}, full hits {full}, saved "
           f"{st['prefill_tokens_saved']}")
    print(f"[serve-features] (b) prefix cache, f32, {len(preqs)} requests: "
          f"tokens equal to the unshared paged run; prefix hits "
          f"{st['prefix_hits']} ({full} full, no prefill), hit rate "
          f"{st['prefix_hit_rate']}, prefill tokens saved "
          f"{st['prefill_tokens_saved']}, CoW blocks {st['kv_cows']}; "
          f"prefills {st['prefills']} ({offset} from an offset), K1f = {L} "
          f"x {st['prefills']}")
    del ff32

    # -- (c), (d), (e): speculation, sampling, graph against eager -------
    params = pad_ex.init(c["seed"])[0]
    reqs = synthetic_requests(c["requests"], c["vocab"], prompt_len=c["prompt"],
                              max_new_tokens=c["max_new"], seed=c["seed"])
    pgnk_ex = ServingExecutor(ff, cfg, max_batch=B, max_seq=c["max_seq"],
                              buckets=c["buckets"], device="cuda",
                              kv_block=f["kv_block"], decode_kernel=False)
    sample = dict(temperature=f["temperature"], top_k=f["top_k"],
                  sample_seed=f["sample_seed"])
    times, toks = {}, {}
    for name, ex, kw in (("padded on K6", pad_ex, {}),
                         ("paged", pgnk_ex, {}),
                         ("sampled", pad_ex, sample),
                         ("speculative", pad_ex, dict(speculate=f["speculate"]))):
        got = {}
        for graph in (False, True):
            srv, o, counts = _serve_runs(torch, ex, params, reqs, runs=2,
                                         decode_steps=K, graph=graph, **kw)
            add(counts)
            _held_launches(f"{name} graph={graph}", counts,
                           _serve_launches(ex, srv, o))
            _check(o[0][0] == o[1][0], f"{name} graph={graph}: two runs "
                   f"gave other tokens")
            got[graph] = (srv, o[1])
        (se, (te, ste)), (sg, (tg, stg)) = got[False], got[True]
        _check(te == tg, f"{name}: graph tokens differ from eager")
        diff = _pool_diff(torch, se.engine[1], sg.engine[1], ex.paged)
        if se.engine[2] is not None:
            diff += _pool_diff(torch, se.engine[2], sg.engine[2], False)
        _check(not diff, f"{name}: graph caches differ from eager in {diff}")
        times[name] = (_ms_per_step(se, ste), _ms_per_step(sg, stg),
                       ste["tokens_per_s"], stg["tokens_per_s"])
        toks[name] = tg
        if name == "padded on K6":
            fn, caches, _dc, dev = sg.engine
            try:
                fn(params, {}, caches, dev["pos"].clone(), dev["tok"])
            except ValueError as e:
                _check("captured on other tensors" in str(e), f"{e}")
            else:
                raise RuntimeError("chip_smoke: a decode call with a clone of "
                                   "pos replayed the graph")
    _check(toks["speculative"] == toks["padded on K6"], "speculative tokens "
           "differ from plain decode's")
    print("[serve-features] (e) graph against eager, tokens and caches bit "
          "for bit (block 0 left out), two runs each equal: " + "; ".join(
              f"{n} {e:.4f} ms/step eager, {g:.4f} as a graph "
              f"({e / g:.2f}x), {te:.1f} / {tg:.1f} tokens/s"
              for n, (e, g, te, tg) in times.items()) +
          f" (speculative: ms per round of {f['speculate'] + 1} verify "
          f"steps); a call with a clone of pos raises; {card}")

    # K6 by kernel name in one profiled replay of a fresh capture.
    fn = pad_ex.build_decode_superstep(K)
    with torch.inference_mode():
        caches = pad_ex.init_cache()
        pos = torch.full((B,), 40, dtype=torch.int32, device=pad_ex.device)
        tok = torch.zeros((B,), dtype=torch.int32, device=pad_ex.device)
        busy = _replay_counts(torch, "serve-graph", fn.graph,
                              (params, {}, caches, None, pos, tok, None), {},
                              {"flash_decode": L})
    print(f"[serve-features] a replay of the K={K} decode graph runs K6 "
          f"{K * L} times by name; device busy {busy / 1e3:.3f} ms")

    # (c) speculation, padded on K6 and paged on the einsum
    plain = {"padded": toks["padded on K6"], "paged": toks["paged"]}
    for layout, ex0 in (("padded", pad_ex), ("paged", pgnk_ex)):
        for dl in (0, f["draft_layers"]):
            ex = ex0 if not dl else ServingExecutor(
                ff, cfg, max_batch=B, max_seq=c["max_seq"], buckets=c["buckets"],
                device="cuda", kv_block=ex0.kv_block,
                decode_kernel=ex0.decode_kernel, draft_layers=dl)
            srv, o, counts = _serve_runs(torch, ex, params, reqs,
                                         decode_steps=K, speculate=f["speculate"])
            add(counts)
            _held_launches(f"spec {layout} draft_layers={dl}", counts,
                           _serve_launches(ex, srv, o))
            t, st = o[0]
            _check(t == plain[layout], f"spec {layout} draft_layers={dl}: "
                   f"tokens differ from plain decode's")
            acc = st["spec_acceptance_rate"]
            _check(acc == 1.0 if not dl else acc < 1.0,
                   f"spec {layout} draft_layers={dl}: acceptance {acc}")
            print(f"[serve-features] (c) speculate {f['speculate']} {layout}"
                  f" draft_layers={dl}: bf16 tokens bit-equal to plain decode"
                  f", acceptance {acc}, {st['spec_tokens_per_dispatch']} "
                  f"tokens per round ({st['decode_supersteps']} rounds), "
                  f"{st['tokens_per_s']:.1f} tokens/s; launches {counts}")

    # (d) sampling: K, batch composition, speculation
    for what, rq, kw in (("K=4", reqs, dict(decode_steps=4)),
                         ("alone", [reqs[5]], dict(decode_steps=K)),
                         ("speculative", reqs, dict(decode_steps=K,
                                                    speculate=f["speculate"]))):
        srv, o, counts = _serve_runs(torch, pad_ex, params, rq, **kw, **sample)
        add(counts)
        _held_launches(f"sampled {what}", counts,
                       _serve_launches(pad_ex, srv, o))
        diff = [r for r in o[0][0] if o[0][0][r] != toks["sampled"][r]]
        _check(not diff, f"sampled {what}: tokens differ for {diff}")
    _check(toks["sampled"] != toks["padded on K6"], "sampled = greedy")
    print(f"[serve-features] (d) sampled (T {f['temperature']}, top-k "
          f"{f['top_k']}, seed {f['sample_seed']}): two runs, K=4 and K={K}, "
          f"request 5 alone, and the speculative run give the same tokens")
    print(f"[serve-features] launches of every run {total}")
    return total


#: Phase 21: the fault matrix of JAX's ``scenario_serving_decode_fault``
#: (a NaN'd cache row before superstep 1, a raise before superstep 3, both
#: in slot 0), the drain of ``scenario_serving_sigterm_drain`` (SIGTERM
#: before superstep 1), speculation at d = 4, and the decode route's head
#: dims: (d_model, heads) of hd 4, 12 and 256, which K6 does not take, and
#: hd 64, which it does, at 2 layers.
RESILIENCE = dict(nan_cache_at={1: 0}, raise_at={3: 0}, preempt_at=(1,),
                  speculate=4, kv_block=16,
                  route=((64, 16), (96, 8), (2048, 8), (512, 8)),
                  route_layers=2, route_speculate=2)


def _runs_of(torch, ex, params, reqs, runs=2, inject=None, **kw):
    """``runs`` runs of one Server (on the card its graph is captured in
    the first and replayed after), a fresh injector from ``inject()``
    before each; returns (each run's results, each run's stats, the
    launches of all of them, the Server)."""
    from flexflow_torch.runtime.serving import Server

    srv = Server(ex, params, {}, decode_steps=SERVE["decode_steps"], **kw)
    _zero_counts()
    res, stats = [], []
    for _ in range(runs):
        srv.injector = inject() if inject is not None else None
        r, st = srv.run(reqs)
        res.append(r)
        stats.append(st)
    torch.cuda.synchronize()
    return res, stats, _counts(), srv


def _toks(results) -> dict:
    return {rid: list(r.tokens) for rid, r in results.items()}


def _errors(results) -> dict:
    return {rid: r.error for rid, r in results.items() if r.error}


def _faulted(tag, res, base, inj) -> list:
    """The faulted run of phase 21's matrix: the NaN errors request 0 out
    (it sits in slot 0 at superstep 1), the raise one other request, and
    every other request keeps ``base``'s tokens.  Returns the failed
    ids."""
    errs = _errors(res)
    _check({m for m, _, _ in inj.fired} == {"nan_cache", "raise"},
           f"{tag}: the injector fired {inj.fired}")
    _check(len(errs) == 2 and errs.get(0) == "non-finite logits in decode"
           and sum(e.startswith("raised fault") for e in errs.values()) == 1,
           f"{tag}: errors {errs}")
    diff = [r for r in base if r not in errs and res[r].tokens != base[r]]
    _check(not diff, f"{tag}: survivors {diff} differ from the unfaulted run")
    return sorted(errs)


def phase_serve_resilience(torch, kernels):
    """ROADMAP item 4's failure model at SERVE widths: (a) the fault
    matrix on the padded and paged layouts, eager and as graphs; (b) the
    drain on SIGTERM and the journal's resume (f32); (c) the fault matrix
    under speculation; (d) the decode route at head dims K6 does not take.
    Returns the launches of every run together."""
    import contextlib
    import io
    import os
    import shutil
    import tempfile

    from flexflow_torch.apps import serve
    from flexflow_torch.config import FFConfig
    from flexflow_torch.models.transformer import build_transformer_lm
    from flexflow_torch.runtime.serving import (
        ServingExecutor, ServingFaultInjector, synthetic_requests)
    from flexflow_torch.serving.journal import RequestJournal

    c, f = SERVE, RESILIENCE
    L, K, B = c["layers"], c["decode_steps"], c["max_batch"]
    card = _card()
    total = {}

    def add(counts):
        for n, v in counts.items():
            total[n] = total.get(n, 0) + v

    def inject():
        return ServingFaultInjector(nan_cache_at=f["nan_cache_at"],
                                    raise_at=f["raise_at"])

    def stack(dtype, layouts=("padded", "paged")):
        cfg = FFConfig(compute_dtype=dtype, seed=c["seed"])
        ff = build_transformer_lm(
            batch_size=B, seq_len=c["max_seq"], vocab_size=c["vocab"],
            d_model=c["d_model"], num_heads=c["heads"], num_layers=L,
            config=cfg)
        exs = {lay: ServingExecutor(
            ff, cfg, max_batch=B, max_seq=c["max_seq"], buckets=c["buckets"],
            device="cuda", kv_block=f["kv_block"] if lay == "paged" else 0)
            for lay in layouts}
        return exs, exs[layouts[0]].init(c["seed"])[0]

    reqs = synthetic_requests(c["requests"], c["vocab"], prompt_len=c["prompt"],
                              max_new_tokens=c["max_new"], seed=c["seed"])
    exs, params = stack("bfloat16")

    # -- (a) the fault matrix, padded and paged, eager and as a graph --
    base, times, failed = {}, {}, {}
    for lay, ex in exs.items():
        got = {}
        for graph in (False, True):
            for faulted in (False, True):
                res, sts, counts, srv = _runs_of(
                    torch, ex, params, reqs, graph=graph,
                    inject=inject if faulted else None)
                add(counts)
                outs = [(None, st) for st in sts]
                _held_launches(f"(a) {lay} graph={graph} faulted={faulted}",
                               counts, _serve_launches(ex, srv, outs))
                _check(_toks(res[0]) == _toks(res[1]) and
                       _errors(res[0]) == _errors(res[1]),
                       f"(a) {lay} graph={graph} faulted={faulted}: two runs "
                       f"differ")
                if not faulted:
                    _check(not _errors(res[1]), f"(a) {lay} graph={graph}: "
                           f"unfaulted errors {_errors(res[1])}")
                    base[lay, graph] = _toks(res[1])
                else:
                    _faulted(f"(a) {lay} graph={graph}", res[1],
                             base[lay, graph], srv.injector)
                got[graph, faulted] = (_toks(res[1]), _errors(res[1]))
                times[lay, graph, faulted] = _ms_per_step(srv, sts[1])
        for faulted in (False, True):
            _check(got[False, faulted] == got[True, faulted],
                   f"(a) {lay} faulted={faulted}: the graph run differs from "
                   f"the eager run")
        failed[lay] = sorted(got[True, True][1])
        print(f"[serve-resilience] (a) {lay}, bf16: faults at supersteps 1 "
              f"(NaN, slot 0) and 3 (raise, slot 0) failed requests "
              f"{failed[lay]}; every survivor's tokens equal "
              f"the unfaulted run's, the graph run equals the eager run bit "
              f"for bit; decode ms/step (second run of a Server) eager "
              f"{times[lay, False, False]:.4f} plain / "
              f"{times[lay, False, True]:.4f} faulted, graph "
              f"{times[lay, True, False]:.4f} plain / "
              f"{times[lay, True, True]:.4f} faulted; {card}")
    _check(failed["padded"] == failed["paged"],
           f"(a) the padded and paged runs failed other requests: {failed}")

    # -- (b) the drain on SIGTERM and the journal's resume, f32 --
    exs32, params32 = stack("float32")
    # Journals inside the checkout's build directory, removed at the end.
    tmp = tempfile.mkdtemp(prefix="journals-", dir=kernels._BUILD_DIR)
    for lay, ex in exs32.items():
        res, sts, counts, _srv = _runs_of(torch, ex, params32, reqs, runs=1,
                                          graph=True)
        add(counts)
        want = _toks(res[0])
        for graph in (False, True):
            path = os.path.join(tmp, f"{lay}-{graph}.jsonl")

            def preempt():
                return ServingFaultInjector(preempt_at=f["preempt_at"])

            res_d, st_d, cd, sd = _runs_of(
                torch, ex, params32, reqs, runs=1, graph=graph,
                inject=preempt, journal=RequestJournal(path))
            add(cd)
            _held_launches(f"(b) {lay} graph={graph} drained", cd,
                           _serve_launches(ex, sd, [(None, st_d[0])]))
            _check(st_d[0]["drained"] is True and not _errors(res_d[0])
                   and len(res_d[0]) < len(reqs),
                   f"(b) {lay} graph={graph}: drained {st_d[0]['drained']}, "
                   f"{len(res_d[0])} results, errors {_errors(res_d[0])}")
            res_r, st_r, cr, sr = _runs_of(
                torch, ex, params32, reqs, runs=1, graph=graph,
                journal=RequestJournal(path))
            add(cr)
            _held_launches(f"(b) {lay} graph={graph} resumed", cr,
                           _serve_launches(ex, sr, [(None, st_r[0])]))
            _check(st_r[0]["drained"] is False and _toks(res_r[0]) == want,
                   f"(b) {lay} graph={graph}: the resumed output differs "
                   f"from the undrained run for requests "
                   f"{[r for r in want if res_r[0][r].tokens != want[r]]}")
            print(f"[serve-resilience] (b) {lay}, f32, graph={graph}: SIGTERM "
                  f"before superstep 1 drained the run after "
                  f"{st_d[0]['decode_supersteps']} supersteps with "
                  f"{len(res_d[0])} requests done and "
                  f"{len(reqs) - len(res_d[0])} left in the journal; a fresh "
                  f"Server served them "
                  f"({st_r[0]['prefills']} prefills over prompt and carried "
                  f"tokens, {st_r[0]['decode_supersteps']} supersteps): "
                  f"merged output equals the undrained run; decode ms/step "
                  f"drained {_ms_per_step(sd, st_d[0]):.4f}, resumed "
                  f"{_ms_per_step(sr, st_r[0]):.4f} (each a first run: its "
                  f"graph warmed and captured)")
    # bf16 for the record, not held: the resume's re-prefill computes the
    # carried tokens' K/V with the flash prefill, the undrained run with
    # decode steps, and bf16 rounds the two paths apart.
    path = os.path.join(tmp, "bf16.jsonl")
    for inj in (lambda: ServingFaultInjector(preempt_at=f["preempt_at"]),
                None):
        res, _sts, counts, _srv = _runs_of(
            torch, exs["padded"], params, reqs, runs=1, graph=True,
            inject=inj, journal=RequestJournal(path))
        add(counts)
    res_r = res[0]
    want = base["padded", True]
    diff = [r for r in want if res_r[r].tokens != want[r]]
    print(f"[serve-resilience] (b) bf16 padded drain and resume, not held: "
          f"{len(diff)} of {len(want)} requests differ from the undrained "
          f"run {diff}")

    # -- (c) the fault matrix under speculation, d = 4 --
    for lay, ex in exs.items():
        got = {}
        for graph in (False, True):
            for faulted in (False, True):
                res, sts, counts, srv = _runs_of(
                    torch, ex, params, reqs, runs=1, graph=graph,
                    speculate=f["speculate"],
                    inject=inject if faulted else None)
                add(counts)
                _held_launches(f"(c) {lay} graph={graph} faulted={faulted}",
                               counts, _serve_launches(
                                   ex, srv, [(None, sts[0])]))
                if not faulted:
                    _check(_toks(res[0]) == base[lay, True],
                           f"(c) {lay} graph={graph}: clean speculation "
                           f"differs from plain decode")
                else:
                    _faulted(f"(c) {lay} graph={graph}", res[0],
                             base[lay, True], srv.injector)
                got[graph, faulted] = (_toks(res[0]), _errors(res[0]),
                                       _ms_per_step(srv, sts[0]))
        for faulted in (False, True):
            _check(got[False, faulted][:2] == got[True, faulted][:2],
                   f"(c) {lay} faulted={faulted}: graph differs from eager")
        print(f"[serve-resilience] (c) {lay}, speculate {f['speculate']}: "
              f"clean tokens equal plain decode's; faulted failed "
              f"{sorted(got[True, True][1])} at the verify fence, survivors "
              f"equal plain decode's, graph = eager; ms per round eager "
              f"{got[False, False][2]:.4f} / {got[False, True][2]:.4f} "
              f"faulted, graph {got[True, False][2]:.4f} / "
              f"{got[True, True][2]:.4f} (first runs)")
    del exs32, params32

    # -- (d) the decode route: head dims K6 does not take --
    for dm, heads in f["route"]:
        hd = dm // heads
        cfg_d = dict(c, d_model=dm, heads=heads, layers=f["route_layers"])
        for spec in (0, f["route_speculate"]):
            if spec and hd == 64:
                continue
            stats = {}
            _zero_counts()
            extra = ["--speculate", str(spec)] if spec else []
            with contextlib.redirect_stdout(io.StringIO()):
                rc = serve.main(_serve_argv("bfloat16", cfg_d) + extra,
                                device="cuda", stats_out=stats)
            torch.cuda.synchronize()
            counts = _counts()
            add(counts)
            _check(rc == 0 and stats["completed"] == c["requests"],
                   f"(d) hd {hd} speculate {spec}: rc {rc}, completed "
                   f"{stats['completed']}")
            Ld = f["route_layers"]
            kerneled = kernels.flash_decode_supported(
                (B, c["max_seq"], heads, hd), torch.bfloat16)
            _check(kerneled == (hd == 64), f"(d) K6's gate at hd {hd}")
            want = {"flash_attention_lse": Ld * stats["prefills"]
                    if kerneled else 0,
                    "flash_decode": 2 * Ld * K if kerneled else 0}
            _held_launches(f"(d) hd {hd} speculate {spec}", counts, want)
            steps = stats["decode_supersteps"] * (1 if spec else K)
            print(f"[serve-resilience] (d) d_model {dm}, {heads} heads (hd "
                  f"{hd}){f', speculate {spec}' if spec else ''}: "
                  f"{stats['completed']} requests complete, "
                  f"{stats['decode_s'] * 1e3 / steps:.4f} ms per "
                  f"{'round' if spec else 'decode step'} (first run), "
                  f"launches {counts}")
    shutil.rmtree(tmp)
    print(f"[serve-resilience] launches of every run {total}")
    return total


#: Phase 22: bench.py's NMT leg (``bench.py:311-336``): batch 64, 2
#: layers, hidden = embed = 2048, vocab 20480, seq 20, bf16, dropout 0.2,
#: SGD lr 0.01 (momentum 0, wd 0: the embeddings train row-sparse), 2 + 10
#: steps; the app at ``--steps-per-call`` 5 and per step; the f32 parity
#: step at batch 4, hidden 64, vocab 512.
NMT = dict(batch=64, seq=20, hidden=2048, vocab=20480, layers=2, lr=0.01,
           warmup=2, iters=10, steps_per_call=5, dropout=0.2)
NMT_PARITY = dict(batch=4, seq=20, hidden=64, vocab=512, layers=2, lr=0.01,
                  seed=0)
TOL_NMT_LOSS = 1e-5
#: The parity step's bar, as DLRM's: each parameter's step within rtol of
#: the CPU step's largest element plus 2^-22 of the parameter's largest.
TOL_NMT_STEP = 1e-4
#: Kernel-name groups of phase 22's profile, first match wins.
NMT_GROUPS = (
    ("K3", ("xent",)),
    ("K4/K5", ("gather_regs", "scatter_add_rows", "count_owned")),
    ("GEMM (cuBLAS)", ("gemm", "cublas", "cutlass", "nvjet", "splitk",
                       "xmma")),
    ("copy", ("memcpy", "memset", "copy")),
    ("elementwise, reductions", ("",)),
)


def _nmt_argv(c, extra=()):
    return ["-b", str(c["batch"]), "--src-len", str(c["seq"]), "--tgt-len",
            str(c["seq"]), "--hidden", str(c["hidden"]), "--vocab",
            str(c["vocab"]), "--layers", str(c["layers"]), "--dropout",
            str(c["dropout"]), "--dtype", "bfloat16", "--optimizer", "sgd",
            "--lr", str(c["lr"]), "--momentum", "0", "--wd", "0", *extra]


def _nmt_per_step() -> dict:
    """The kernels one NMT train step launches: K3 once each way, and K4
    and K5 once per word embedding (the row-sparse path)."""
    return dict(softmax_xent=1, softmax_xent_bwd=1, gather_rows=2,
                scatter_add_rows=2)


def _nmt_model(c, dtype: str, seed: int = 0):
    from flexflow_torch.config import FFConfig
    from flexflow_torch.models.nmt import build_nmt

    cfg = FFConfig(batch_size=c["batch"], compute_dtype=dtype, seed=seed)
    return build_nmt(batch_size=c["batch"], src_len=c["seq"],
                     tgt_len=c["seq"], vocab_size=c["vocab"],
                     embed_dim=c["hidden"], hidden_size=c["hidden"],
                     num_layers=c["layers"], dropout=NMT["dropout"],
                     config=cfg), cfg


def _xent_at(torch, kernels, F, g, n: int, v: int, tag: str, form: str,
             chain: bool = False) -> dict:
    """K3 at a main path's loss shape ``(n, v)`` bf16: both forms held
    against the plain version (``_xent_hold``: planted ties, an
    out-of-range label), the chooser's form checked to be ``form``, then
    the forward and backward timed (one launch in turns with
    ``F.cross_entropy``, the plain version, with ``chain`` the chain
    slope too) beside the bound.  Returns ``{"<name>@<tag>": row}``."""
    x, labels, tie_cols = _xent_inputs(torch, g, n, v, "bfloat16")
    gn = torch.full((n,), 1.0 / n, device="cuda")
    gl = torch.randn((n,), generator=g, device="cuda")
    errs = {}
    for f in XENT_FORMS:
        errs[f], (_nll, _lse, pred, _d, _pd) = _xent_hold(
            torch, kernels, x, labels, gn, gl, f)
        _xent_held(errs[f], f"softmax_xent ({n}, {v}) bf16 {f}")
        got = [int(pred[r]) for r in range(len(tie_cols))]
        _check(got == [min(t) for t in tie_cols],
               f"softmax_xent ({n}, {v}) {f} ties: pred {got}")
    chosen = kernels._xent_form(v)
    _check(chosen.form == form, f"K3 at V = {v} takes {chosen.form}")
    lab = labels.clone()
    lab[-1] = 0
    lab64 = lab.long()
    lse = kernels._xent_fwd(x, lab)[1]
    xr = x.detach().clone().requires_grad_(True)
    ce = F.cross_entropy(xr, lab64, reduction="none")
    gce = gn.to(ce.dtype)
    fns = {
        "softmax_xent": (lambda: kernels._xent_fwd(x, lab),
                         lambda: kernels.softmax_xent_plain(x, lab),
                         lambda: F.cross_entropy(x, lab64, reduction="none"),
                         _bound_ms(n * v * 2 + 16 * n, 4 * n * v, "float32"),
                         ("nll", "lse")),
        "softmax_xent_bwd": (
            lambda: kernels._xent_bwd(x, lab, lse, gn, gl),
            lambda: kernels.softmax_xent_bwd_plain(x, lab, lse, gn, gl),
            lambda: torch.autograd.grad(ce, xr, gce, retain_graph=True),
            _bound_ms(2 * n * v * 2 + 16 * n, 4 * n * v, "float32"),
            ("dlogits_abs",)),
    }
    rows = {}
    for name, (kern, plain, lib, (bound, by), keys) in fns.items():
        ms, lib_ms = _pair_ms(kern, lib)
        plain_ms = _device_ms(plain)
        err = max(errs[f][k] for f in XENT_FORMS for k in keys)
        row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                   bound_by=by, library_ms=lib_ms, form=_form_name(chosen))
        slope = ""
        if chain:
            row["chain_ms"] = _chain_ms(lambda _i: kern())
            slope = f", chain slope {row['chain_ms']:.6f}"
        rows[f"{name}@{tag}"] = row
        print(f"[{tag}] {name} ({n}, {v}) bf16, {_form_name(chosen)}: held in "
              f"both forms (ties, an out-of-range label), max abs err "
              f"{err:.3g}; one launch {ms:.6f} ms{slope} (plain "
              f"{plain_ms:.6f}, F.cross_entropy"
              f"{' backward' if name.endswith('bwd') else ''} {lib_ms:.6f}, "
              f"bound {bound:.3e} by {by}: {100 * bound / ms:.1f}% of it); "
              f"{_card()}")
    return rows


def phase_nmt(torch, kernels, F):
    """ROADMAP item 5's NMT at bench.py's shape: K3 at (1280, 20480) bf16
    in both forms and K4/K5 at the embeddings' shape against their plain
    versions; Dropout's masks card against CPU; an f32 SGD step card
    against CPU; the bench leg (2 + 10), the app per step and at
    ``--steps-per-call``; one profiled step.  Returns (rows, launches)."""
    import contextlib
    import io

    import numpy as np

    from flexflow_torch import bench
    from flexflow_torch.apps import nmt as nmt_app
    from flexflow_torch.data.loader import synthetic_host_batch
    from flexflow_torch.optim import SGDOptimizer
    from flexflow_torch.runtime import keyed_random
    from flexflow_torch.runtime.executor import Executor
    from flexflow_torch.runtime.trainer import Trainer

    c = NMT
    card = _card()
    g = torch.Generator(device="cuda").manual_seed(22)
    rows = {}

    # -- K3 at the loss's shape, (batch x seq, vocab) bf16, both forms --
    n, v = c["batch"] * c["seq"], c["vocab"]
    rows.update(_xent_at(torch, kernels, F, g, n, v, "nmt", "cta"))

    # -- K4 / K5 at the embeddings' shape: the step's ids and uniform --
    ff, cfg = _nmt_model(c, "bfloat16")
    host = synthetic_host_batch(ff, np.random.default_rng(0))
    table = torch.randn((v, c["hidden"]), generator=g, device="cuda")
    main_ids = torch.from_numpy(host["src"].reshape(-1)).cuda()
    uni_ids = torch.randint(0, v, (n,), generator=g, device="cuda",
                            dtype=torch.int32)
    upd = torch.randn((n, c["hidden"]), generator=g, device="cuda")
    for what, ids in (("the step's ids", main_ids), ("uniform ids", uni_ids)):
        _gather_exact(torch, kernels, f"nmt {what}", table, ids)
        a, b = table.clone(), table.clone()
        kernels.scatter_add_rows(a, ids, upd)
        kernels.scatter_add_rows_plain(b, ids, upd)
        torch.cuda.synchronize()
        _check(torch.equal(a.view(torch.int32), b.view(torch.int32)),
               f"scatter_add_rows nmt {what}: not bit-identical to plain")
        del a, b
    uniq = int(torch.unique(main_ids).numel())
    d = c["hidden"]
    work = table.clone()
    lib_idx = main_ids.long()
    k45 = {
        "gather_rows": (lambda: kernels.gather_rows(table, main_ids),
                        lambda: kernels.gather_rows_plain(table, main_ids),
                        lambda: F.embedding(lib_idx, table),
                        _bound_ms(uniq * d * 4 + n * d * 4 + 4 * n, 0,
                                  "float32")),
        "scatter_add_rows": (
            lambda: kernels.scatter_add_rows(work, main_ids, upd),
            lambda: kernels.scatter_add_rows_plain(work, main_ids, upd),
            lambda: work.index_add_(0, lib_idx, upd),
            _bound_ms(n * d * 4 + 2 * uniq * d * 4 + 4 * n, n * d,
                      "float32")),
    }
    uni_idx = uni_ids.long()
    uniform = {
        "gather_rows": (lambda: kernels.gather_rows(table, uni_ids),
                        lambda: F.embedding(uni_idx, table)),
        "scatter_add_rows": (
            lambda: kernels.scatter_add_rows(work, uni_ids, upd),
            lambda: work.index_add_(0, uni_idx, upd)),
    }
    for name, (kern, plain, lib, (bound, by)) in k45.items():
        ms, lib_ms = _pair_ms(kern, lib)
        plain_ms = _device_ms(plain)
        uni_ms, uni_lib = _pair_ms(*uniform[name])
        rows[f"{name}@nmt"] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                                   bound_ms=bound, bound_by=by,
                                   library_ms=lib_ms, uniform_ids_ms=uni_ms,
                                   uniform_ids_library_ms=uni_lib)
        print(f"[nmt] {name} ({v}, {d}) f32, {n} ids of the step "
              f"({uniq} rows): bit for bit against plain (and at {n} "
              f"uniform ids); {ms:.6f} ms (plain {plain_ms:.6f}, "
              f"{'F.embedding' if name == 'gather_rows' else 'index_add_'} "
              f"{lib_ms:.6f}, bound {bound:.6f} by {by}); at the uniform "
              f"ids {uni_ms:.6f} ms, the library {uni_lib:.6f}")
    del table, work, upd

    # -- Dropout's masks: the card's bits are the CPU's --
    shape = (c["batch"], c["seq"], c["hidden"])
    key = torch.tensor([7, 123456789], dtype=torch.int64)
    m_card = keyed_random.bernoulli(key.cuda(), 1.0 - c["dropout"], shape)
    m_cpu = keyed_random.bernoulli(key, 1.0 - c["dropout"], shape)
    _check(torch.equal(m_card.cpu(), m_cpu), "dropout masks differ card/CPU")
    drop = next(op for op in ff.layers if op.name == "enc_drop0")
    xd = torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)
    (yc,), sc = drop.forward({}, [xd], {"rng": key.cuda()}, True)
    (yp,), sp = drop.forward({}, [xd.cpu()], {"rng": key}, True)
    _check(torch.equal((yc != 0).cpu(), yp != 0) and
           torch.equal(sc["rng"].cpu(), sp["rng"]),
           "Dropout's mask or advanced key differs card/CPU")
    ulp = ((yc.cpu().float() - yp.float()).abs()
           <= yp.float().abs() * 2.0 ** -8).all()
    _check(bool(ulp), "Dropout's values differ card/CPU by more than 1 ulp")
    print(f"[nmt] Dropout masks at {shape} (rate {c['dropout']}): the card's "
          f"bits equal the CPU's, keep share "
          f"{m_card.float().mean().item():.5f}; the op's output bit-equal "
          f"card/CPU: {torch.equal(yc.cpu(), yp)}")
    del xd, yc, m_card

    # -- an f32 SGD step, card against CPU --
    pc = NMT_PARITY
    pff, pcfg = _nmt_model(pc, "float32", pc["seed"])
    params0, state0 = Executor(pff, pcfg,
                               device="cpu").init_params_and_state()
    pbatch = synthetic_host_batch(pff, np.random.default_rng(pc["seed"]), {
        "src": pc["vocab"], "tgt": pc["vocab"], "label": pc["vocab"]})
    out = {}
    for dev in ("cuda", "cpu"):
        ex = Executor(pff, pcfg, optimizer=SGDOptimizer(lr=pc["lr"]),
                      device=dev)
        _check({op.name for op in ex._sparse_ops} == {"src_embed",
                                                      "tgt_embed"},
               "nmt parity: the embeddings are not on the row-sparse path")
        params = {op: {k: p.clone().to(dev) for k, p in grp.items()}
                  for op, grp in params0.items()}
        state = {op: {k: t.clone().to(dev) for k, t in grp.items()}
                 for op, grp in state0.items()}
        params, _o, state, m = ex.train_step(params, ex.optimizer.init(params),
                                             state, ex.shard_batch(pbatch))
        out[dev] = (float(m["train_loss"]),
                    {op: {k: t.detach().cpu() for k, t in grp.items()}
                     for op, grp in params.items()},
                    {op: grp["rng"].cpu() for op, grp in state.items()})
    (lc, pcard, kc), (lp, pcpu, kp) = out["cuda"], out["cpu"]
    _check(abs(lc - lp) <= TOL_NMT_LOSS, f"nmt parity: loss card {lc}, CPU "
           f"{lp}")
    _check(all(torch.equal(kc[op], kp[op]) for op in kp),
           "nmt parity: the advanced Dropout keys differ")
    worst = 0.0
    for op in pcpu:
        for k in pcpu[op]:
            p0 = params0[op][k]
            dc, dp = pcard[op][k] - p0, pcpu[op][k] - p0
            tol = (TOL_NMT_STEP * dp.abs().max().item()
                   + 2.0 ** -22 * p0.abs().max().item())
            err = (dc - dp).abs().max().item()
            _check(err <= tol, f"nmt parity {op}.{k}: step err {err} against "
                   f"{tol}")
            worst = max(worst, err / tol)
    print(f"[nmt] f32 SGD step at batch {pc['batch']}, hidden {pc['hidden']}, "
          f"vocab {pc['vocab']}, seq {pc['seq']}: loss card {lc:.8f} CPU "
          f"{lp:.8f}; worst parameter step error {worst:.3g} of its "
          f"tolerance; the advanced Dropout keys equal")

    # -- the main path: the bench leg, the app per step and as graphs --
    per = _nmt_per_step()
    total = {}

    def held(tag, counts, steps):
        want = {name: k * steps for name, k in per.items()}
        _held_launches(tag, counts, want)
        for name, k in counts.items():
            total[name] = total.get(name, 0) + k

    stats = {}
    torch.cuda.reset_peak_memory_stats()
    held_mem = torch.cuda.memory_allocated()
    _zero_counts()
    with contextlib.redirect_stdout(io.StringIO()):
        elapsed, pairs, iters = bench.bench_nmt(
            device="cuda", batch=c["batch"], hidden=c["hidden"],
            vocab=c["vocab"], seq=c["seq"], iters=c["iters"],
            warmup=c["warmup"], stats_out=stats)
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - held_mem) / 1e9
    losses = stats["step_losses"]
    _check(len(losses) == c["warmup"] + c["iters"] and
           all(math.isfinite(x) for x in losses), f"nmt losses {losses}")
    held("nmt bench leg", _counts(), c["warmup"] + c["iters"])
    ms_step = elapsed * 1e3 / iters
    print(f"[nmt] bench leg (2 + 10 steps): time = {elapsed:.4f}s, "
          f"{pairs:.2f} pairs/s, {ms_step:.3f} ms/step, peak {peak:.2f} GB; "
          f"losses {[round(x, 5) for x in losses]}; {card}")
    app_ms = {}
    for spc in (1, c["steps_per_call"]):
        st = {}
        _zero_counts()
        extra = ["-i", str(c["iters"])]
        if spc > 1:
            extra += ["--steps-per-call", str(spc)]
        with contextlib.redirect_stdout(io.StringIO()):
            rc = nmt_app.main(_nmt_argv(c, extra), device="cuda",
                              stats_out=st)
        torch.cuda.synchronize()
        _check(rc == 0 and all(math.isfinite(x) for x in st["step_losses"]),
               f"nmt app steps_per_call={spc}: rc {rc}, losses "
               f"{st['step_losses']}")
        # A graph counts its first call's eager steps and its capture.
        held(f"nmt app steps_per_call={spc}", _counts(),
             2 * spc if spc > 1 else 1 + c["iters"])
        app_ms[spc] = st["elapsed_s"] * 1e3 / st["iterations"]
    print(f"[nmt] apps.nmt: {app_ms[1]:.3f} ms/step per step, "
          f"{app_ms[c['steps_per_call']]:.3f} as graphs of "
          f"{c['steps_per_call']} ({app_ms[1] / app_ms[c['steps_per_call']]:.2f}"
          f"x); launches {total}")

    # -- one warm step under the profiler; the recurrence and SGD alone --
    ex = Executor(ff, cfg, optimizer=SGDOptimizer(lr=c["lr"]), device="cuda")
    stt = list(ex.init())
    batch = Trainer(ex).synthetic_batch()

    def step():
        stt[:3] = ex.train_step(*stt, batch)[:3]

    for _ in range(2):
        step()
    _group_profile(torch, "nmt-profile", step, NMT_GROUPS)
    wh = stt[0]["enc_lstm0"]["wh"]
    h = torch.randn((c["batch"], c["hidden"]), generator=g,
                    device="cuda").to(wh.dtype)
    rec_ms = _device_ms(lambda: [h @ wh for _ in range(c["seq"])])
    params, _o, state = stt
    dense = {op: grp for op, grp in params.items()
             if op not in ("src_embed", "tgt_embed")}
    _l, _m, _s, grads = ex.loss_and_grads(params, state, batch)
    grads = {op: grads[op] for op in dense}
    sgd_ms = _device_ms(lambda: ex.optimizer.update(dense, None, grads))
    print(f"[nmt-profile] one LSTM's recurrence, {c['seq']} products h @ wh "
          f"({c['batch']} x {c['hidden']} @ {c['hidden']} x "
          f"{4 * c['hidden']}): {rec_ms:.3f} ms of device time (x4 LSTMs "
          f"forward, twice that backward); the SGD update of the dense "
          f"parameters {sgd_ms:.3f} ms; {card}")
    return rows, total


#: Phase 23 (``item5``): the rest of ROADMAP item 5 at bench.py's widths.
#: The CNN catalog through ``apps.cnn`` (batch 64, the models' image
#: sizes, 1000 classes, bf16, SGD lr 0.01 momentum 0 wd 0; 1 warmup + 5
#: timed steps, the app's warmup of one taking cuDNN's plan timing); the
#: f32 DenseNet-121 step card against CPU at batch 4, image 64; DenseNet
#: as graphs of 2 and under --remat (1 + 3 steps each); Candle-Uno through
#: ``apps.candle_uno`` (batch 512, bf16, SGD lr 0.01; 1 + 10) and the
#: bench leg (2 + 10); the MoE LM through ``apps.transformer`` at phase
#: 5's shape with ``--experts 8`` (top-1, capacity factor 1.25; Adam lr
#: 1e-4, bf16, 1 + 5), and as graphs of 2 (2 + 4).
CNN = dict(batch=64, iters=5, lr=0.01,
           models=("vgg16", "inception", "densenet121", "resnet101"))
CNN_PARITY = dict(batch=4, image=64, classes=1000, lr=0.01, seed=0)
CNN_GRAPH = dict(batch=64, iters=3, k=2)
CANDLE = dict(batch=512, iters=10, warmup=2, lr=0.01)
MOE = dict(TRAIN, experts=8, iters=5)
#: The f32 DenseNet step's running statistics, card against CPU: each
#: within rtol of the tensor's largest magnitude plus atol (batch means
#: of activations whose convolutions sum in other orders).
TOL_CNN_STATS = (1e-4, 1e-7)
#: Gradients that are zero in exact arithmetic (a bias straight before a
#: BatchNorm): rounding noise on each side, held below this share of the
#: step's largest gradient.
TOL_ZERO_GRAD = 2.0 ** -10
#: Kernel-name groups of phase 23's profiles, first match wins.
ITEM5_GROUPS = (
    ("K1f/K1b", ("wg_fwd_kernel", "wg_dq_kernel", "wg_dkv_kernel")),
    ("K3", ("xent",)),
    ("convolutions (cuDNN)", ("conv", "cudnn", "implicit", "fprop", "dgrad",
                              "wgrad", "xmma_", "nchw", "nhwc")),
    ("GEMM (cuBLAS)", ("gemm", "cublas", "cutlass", "nvjet", "splitk")),
    ("pools", ("pool",)),
    ("copy", ("memcpy", "memset", "copy", "cat")),
    ("elementwise, reductions", ("",)),
)


def _cnn_argv(model, c, extra=()):
    return ["--model", model, "-b", str(c["batch"]), "-i", str(c["iters"]),
            "--dtype", "bfloat16", "--optimizer", "sgd", "--lr",
            str(CNN["lr"]), "--momentum", "0", "--wd", "0", "--seed", "0",
            *extra]


def _run_app(torch, main, argv):
    """One app run on the card with its report lines swallowed: (stats,
    launches, peak GB above what was held before)."""
    import contextlib
    import io

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    stats = {}
    _zero_counts()
    with contextlib.redirect_stdout(io.StringIO()):
        rc = main(argv, device="cuda", stats_out=stats)
    torch.cuda.synchronize()
    _check(rc == 0, f"{argv}: exit {rc}")
    peak = (torch.cuda.max_memory_allocated() - held) / 1e9
    return stats, _counts(), peak


def _group_profile(torch, tag, step, groups=ITEM5_GROUPS):
    """``step()`` under the profiler (``_profile_step``), device time by
    kernel-name group, the first group whose substring matches."""
    out = {name: [0.0, 0] for name, _ in groups}
    for us, key, cnt in _profile_step(torch, tag, step):
        name = next(nm for nm, subs in groups
                    if any(sub in key.lower() for sub in subs))
        out[name][0] += us / 1e3
        out[name][1] += cnt
    busy = sum(ms for ms, _ in out.values())
    print(f"[{tag}] device ms by kernel group: " + ", ".join(
        f"{nm} {ms:.3f} ({100 * ms / busy:.1f}%, {k} kernels)"
        for nm, (ms, k) in out.items() if k))


def _profile_train(torch, tag, ff, cfg):
    """Two warm train steps of ``ff``, then one under the profiler, by
    kernel group (``_group_profile``)."""
    from flexflow_torch.apps.common import make_optimizer
    from flexflow_torch.runtime.executor import Executor
    from flexflow_torch.runtime.trainer import Trainer

    ex = Executor(ff, cfg, optimizer=make_optimizer(cfg), device="cuda")
    stt = list(ex.init())
    batch = Trainer(ex).synthetic_batch()

    def step():
        stt[:3] = ex.train_step(*stt, batch)[:3]

    for _ in range(2):
        step()
    _group_profile(torch, tag, step)


def _bn_state(state):
    return [(op, k, t) for op, grp in sorted(state.items())
            for k, t in sorted(grp.items())]


def phase_item5(torch, kernels, F):
    """The rest of ROADMAP item 5 on the card: K3 at the catalog's loss
    shape; the CNN catalog, Candle-Uno and the MoE LM through their apps;
    the f32 DenseNet step card against CPU; DenseNet and the MoE LM as
    graphs; the Candle bench leg; one profiled DenseNet and MoE-LM step.
    Returns (rows, launches by path)."""
    import contextlib
    import gc
    import io

    import numpy as np

    from flexflow_torch import bench
    from flexflow_torch.apps import candle_uno as candle_app
    from flexflow_torch.apps import cnn as cnn_app
    from flexflow_torch.apps import transformer as lm_app
    from flexflow_torch.config import FFConfig
    from flexflow_torch.data.loader import synthetic_host_batch
    from flexflow_torch.models.cnn_catalog import build_densenet121
    from flexflow_torch.models.transformer import build_transformer_lm
    from flexflow_torch.optim import SGDOptimizer
    from flexflow_torch.runtime.executor import Executor
    from flexflow_torch.search.cost_model import op_cost, train_flops

    card = _card()
    g = torch.Generator(device="cuda").manual_seed(23)
    rows = {}
    launches = {}

    def add(path, counts):
        tot = launches.setdefault(path, {})
        for name, k in counts.items():
            tot[name] = tot.get(name, 0) + k

    # -- K3 at the catalog's loss shape, (64, 1000) bf16, both forms --
    rows.update(_xent_at(torch, kernels, F, g, CNN["batch"], 1000, "cnn",
                         "rows", chain=True))

    # -- (a) the catalog through apps.cnn --
    per_step = dict(softmax_xent=1, softmax_xent_bwd=1)
    for model in CNN["models"]:
        stats, counts, peak = _run_app(torch, cnn_app.main,
                                       _cnn_argv(model, CNN))
        steps = 1 + CNN["iters"]
        losses = stats["step_losses"]
        _check(len(losses) == steps and all(math.isfinite(y) for y in losses),
               f"{model} losses {losses}")
        _held_launches(f"cnn {model}", counts,
                       {k: m * steps for k, m in per_step.items()})
        add("cnn", counts)
        ms_step = stats["elapsed_s"] * 1e3 / stats["iterations"]
        extra = ""
        if model == "densenet121":
            _check(losses[-1] < losses[0], f"densenet121 loss did not fall: "
                   f"{losses}")
            bn = _bn_state(stats["final"][2])
            _check(len(bn) == 2 * 117, f"densenet121 has {len(bn)} BN stats")
            for op, k, t in bn:
                init = 0.0 if k == "running_mean" else 1.0
                _check(bool(torch.isfinite(t).all()) and
                       bool((t.float() != init).any()),
                       f"densenet121 {op}.{k} not finite or not moved")
            extra = "; all 117 BatchNorms' running statistics finite and moved"
        print(f"[item5] apps.cnn --model {model} (batch {CNN['batch']}, bf16, "
              f"1 + {CNN['iters']} steps): {ms_step:.3f} ms/step, "
              f"{stats['samples_per_s']:.1f} images/s, peak {peak:.2f} GB; "
              f"losses {[round(y, 4) for y in losses]}; K3 1 + 1 a step"
              f"{extra}; {card}")
        del stats
        gc.collect()

    # -- (a) the f32 DenseNet-121 step, card against CPU --
    c = CNN_PARITY
    cfg = FFConfig(batch_size=c["batch"], compute_dtype="float32",
                   seed=c["seed"])
    ff = build_densenet121(batch_size=c["batch"], image_size=c["image"],
                           num_classes=c["classes"], config=cfg)
    params0, state0 = Executor(ff, cfg, device="cpu").init_params_and_state()
    batch = synthetic_host_batch(ff, np.random.default_rng(c["seed"]),
                                 {"label": c["classes"]})
    out = {}
    branches = _CardBranches(torch, TOL_TRAIN_GRAD[0])
    for dev in ("cuda", "cpu"):
        ex = Executor(ff, cfg, optimizer=SGDOptimizer(lr=c["lr"]), device=dev)
        params = {op: {k: p.clone().to(dev) for k, p in grp.items()}
                  for op, grp in params0.items()}
        state = {op: {k: t.clone().to(dev) for k, t in grp.items()}
                 for op, grp in state0.items()}
        _zero_counts()
        branches.replay = dev == "cpu"
        with branches:
            loss, _, state, grads = ex.loss_and_grads(params, state, batch)
        ex.optimizer.update(params, ex.optimizer.init(params), grads)
        if dev == "cuda":
            torch.cuda.synchronize()
            _held_launches("f32 densenet121 step", _counts(), per_step)
        out[dev] = (float(loss),
                    {op: {k: t.detach().cpu() for k, t in grp.items()}
                     for op, grp in grads.items()},
                    {op: {k: t.detach().cpu() for k, t in grp.items()}
                     for op, grp in params.items()},
                    {op: {k: t.cpu() for k, t in grp.items()}
                     for op, grp in state.items()})
    (lc, gc_, pc, sc), (lp, gp, pp, sp) = out["cuda"], out["cpu"]
    _check(abs(lc - lp) <= TOL_TRAIN_LOSS,
           f"f32 densenet121 step loss: card {lc}, CPU {lp}")
    rtol, atol = TOL_TRAIN_GRAD
    worst = {"grad": 0.0, "param": 0.0, "stat": 0.0, "noise": 0.0}
    # A convolution's bias that feeds a BatchNorm directly has a zero
    # gradient in exact arithmetic (the batch mean removes it): both sides
    # hold rounding noise, held below ``TOL_ZERO_GRAD`` of the step's
    # largest gradient, the updated bias within lr times that.
    zero = {op.inputs[0].producer.name for op in ff.layers
            if type(op).__name__ == "BatchNorm"
            and type(op.inputs[0].producer).__name__ == "Conv2D"
            and op.inputs[0].producer.attrs["activation"] is None}
    g_max = max(t.abs().max().item() for grp in gp.values()
                for t in grp.values())
    for op in zero:
        floor = TOL_ZERO_GRAD * g_max
        for side, p in ((gc_, pc), (gp, pp)):
            noise = side[op]["bias"].abs().max().item()
            _check(noise <= floor and
                   p[op]["bias"].abs().max().item() <= c["lr"] * floor,
                   f"f32 densenet121 {op}.bias: gradient {noise} above the "
                   f"noise floor {floor}")
            worst["noise"] = max(worst["noise"], noise / floor)
    for op in gp:
        for k in gp[op]:
            if op in zero and k == "bias":
                continue
            want, got = gp[op][k], gc_[op][k]
            tol = rtol * want.abs().max().item() + atol
            err = (got - want).abs().max().item()
            _check(err <= tol, f"f32 densenet121 grad {op}.{k}: err {err}, "
                   f"tolerance {tol}")
            worst["grad"] = max(worst["grad"], err / tol)
            ulp = 2 * float(np.spacing(np.float32(pp[op][k].abs().max())))
            d = (pc[op][k] - pp[op][k]).abs().max().item()
            bar = c["lr"] * tol + ulp
            _check(d <= bar, f"f32 densenet121 updated {op}.{k}: err {d}, "
                   f"bound {bar}")
            worst["param"] = max(worst["param"], d / bar)
    srtol, satol = TOL_CNN_STATS
    for op, k, want in _bn_state(sp):
        tol = srtol * want.abs().max().item() + satol
        err = (sc[op][k] - want).abs().max().item()
        _check(err <= tol, f"f32 densenet121 {op}.{k}: err {err}, "
               f"tolerance {tol}")
        worst["stat"] = max(worst["stat"], err / tol)
    print(f"[item5] f32 DenseNet-121 SGD step at batch {c['batch']}, image "
          f"{c['image']}, card vs CPU: loss {lc:.7f} vs {lp:.7f}; worst grad "
          f"err {worst['grad']:.3g}, updated param {worst['param']:.3g}, "
          f"running stat {worst['stat']:.3g} of their tolerances, the "
          f"{len(zero)} biases before a BatchNorm (zero gradient in exact "
          f"arithmetic) at {worst['noise']:.3g} of the noise floor; the CPU "
          f"took the card's branch at {branches.moved['relu']} ReLU inputs "
          f"and {branches.moved['pool']} pool windows")
    del out, gc_, gp, pc, pp

    # -- (b) DenseNet as graphs and under --remat: bit for bit --
    cg = CNN_GRAPH
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        eager, _, _ = _run_app(torch, cnn_app.main,
                               _cnn_argv("densenet121", cg))
        graph, counts, _ = _run_app(
            torch, cnn_app.main,
            _cnn_argv("densenet121", dict(cg, iters=cg["iters"] - 1),
                      ["--steps-per-call", str(cg["k"])]))
        _held_launches("densenet121 graphs", counts,
                       {k: m * 2 * cg["k"] for k, m in per_step.items()})
        remat, _, _ = _run_app(torch, cnn_app.main,
                               _cnn_argv("densenet121", cg, ["--remat"]))
    finally:
        torch.backends.cudnn.deterministic = det
    for what, other in (("as graphs of 2", graph), ("--remat", remat)):
        _check(other["step_losses"] == eager["step_losses"],
               f"densenet121 {what}: losses {other['step_losses']} vs "
               f"{eager['step_losses']}")
        (pa, _oa, sa), (pb, _ob, sb) = other["final"], eager["final"]
        diff = _bit_diff(torch, pa, pb) + _bit_diff(torch, sa, sb)
        _check(not diff, f"densenet121 {what}: tensors differ in bits: "
               f"{diff[:5]}")
    g_ms = graph["elapsed_s"] * 1e3 / graph["iterations"]
    e_ms = eager["elapsed_s"] * 1e3 / eager["iterations"]
    print(f"[item5] DenseNet-121 (cuDNN deterministic), 1 + {cg['iters']} "
          f"steps: as graphs of {cg['k']} and under --remat bit for bit equal "
          f"to the eager steps (losses, params, the 234 running statistics); "
          f"{e_ms:.3f} ms/step eager, {g_ms:.3f} as graphs; {card}")
    del eager, graph, remat
    gc.collect()

    # -- one DenseNet-121 step under the profiler --
    cfg = FFConfig(batch_size=CNN["batch"], compute_dtype="bfloat16",
                   optimizer="sgd", learning_rate=CNN["lr"], momentum=0.0,
                   weight_decay=0.0)
    _profile_train(torch, "item5-densenet-profile",
                   build_densenet121(batch_size=CNN["batch"], config=cfg), cfg)
    gc.collect()

    # -- (c) Candle-Uno through its app, (e) the bench leg --
    ca = CANDLE
    argv = ["-b", str(ca["batch"]), "-i", str(ca["iters"]), "--dtype",
            "bfloat16", "--optimizer", "sgd", "--lr", str(ca["lr"]),
            "--momentum", "0", "--wd", "0"]
    stats, counts, peak = _run_app(torch, candle_app.main, argv)
    losses = stats["step_losses"]
    _check(all(math.isfinite(y) for y in losses) and losses[-1] < losses[0],
           f"candle losses {losses}")
    _held_launches("candle", counts, {})
    add("candle", counts)
    ms_step = stats["elapsed_s"] * 1e3 / stats["iterations"]
    bstats = {}
    with contextlib.redirect_stdout(io.StringIO()):
        sps = bench.bench_candle(device="cuda", batch=ca["batch"],
                                 iters=ca["iters"], warmup=ca["warmup"],
                                 stats_out=bstats)
    _check(sps > 0 and all(math.isfinite(y) for y in bstats["step_losses"]),
           f"bench_candle: {sps}, losses {bstats['step_losses']}")
    print(f"[item5] apps.candle_uno (batch {ca['batch']}, bf16, 1 + "
          f"{ca['iters']} steps): {ms_step:.3f} ms/step, "
          f"{stats['samples_per_s']:.1f} samples/s, peak {peak:.2f} GB, "
          f"losses {[round(y, 4) for y in losses]}, no kernel of the port "
          f"(MSE loss); bench leg (2 + {ca['iters']}): candle_samples_per_s "
          f"{sps:.2f}; {card}")

    # -- (d) the MoE LM through apps.transformer, and as graphs of 2 --
    mc = MOE
    argv = _train_argv(mc) + ["--experts", str(mc["experts"])]
    moe, counts, peak = _run_app(torch, lm_app.main, argv)
    steps = 1 + mc["iters"]
    L = mc["layers"]
    per = dict(flash_attention_lse=L, flash_attention_lse_bwd=L,
               softmax_xent=1, softmax_xent_bwd=1)
    losses = moe["step_losses"]
    _check(len(losses) == steps and all(math.isfinite(y) for y in losses)
           and losses[-1] < losses[0], f"MoE LM losses {losses}")
    _held_launches("MoE LM", counts, {k: m * steps for k, m in per.items()})
    add("moe", counts)
    last = moe["last_metrics"]
    drops = [last[f"blk{i}_moe_dropped"] for i in range(L)]
    auxs = [last[f"blk{i}_moe_aux_loss"] for i in range(L)]
    _check(all(math.isfinite(y) for y in drops + auxs) and
           all(y == int(y) >= 0 for y in drops),
           f"MoE LM drops {drops}, aux {auxs}")
    ms_step = moe["elapsed_s"] * 1e3 / moe["iterations"]
    tokens_s = moe["samples_per_s"] * mc["seq"]
    mcfg = FFConfig(batch_size=mc["batch"])
    mff = build_transformer_lm(
        batch_size=mc["batch"], seq_len=mc["seq"], vocab_size=mc["vocab"],
        d_model=mc["d_model"], num_heads=mc["heads"], num_layers=L,
        moe_experts=mc["experts"], config=mcfg)
    moe_op = mff.find_op("blk0_moe")
    s_tok, cap = mc["batch"] * mc["seq"], moe_op.capacity(mc["batch"] * mc["seq"])
    onehot = 3.0 * L * 4.0 * s_tok * mc["experts"] * cap * mc["d_model"]
    work = train_flops(mff) - onehot
    mfu = work / (ms_step * 1e-3) / PEAK_FLOPS["bfloat16"]
    print(f"[item5] apps.transformer --experts {mc['experts']} (batch "
          f"{mc['batch']}, seq {mc['seq']}, {L} layers, top-1, cf 1.25, capacity "
          f"{cap}; Adam, bf16, 1 + {mc['iters']} steps): {ms_step:.3f} ms/step, "
          f"tokens/s {tokens_s:.1f}, peak {peak:.2f} GB; losses "
          f"{[round(y, 5) for y in losses]}; last step's drops {drops}, aux "
          f"losses {[round(y, 4) for y in auxs]}; the flops of the work the "
          f"port does ({work:.4g} a step: router, expert products over "
          f"{mc['experts']} x {cap} slots, the rest of the LM; not "
          f"cost_model's {train_flops(mff):.4g}, whose one-hot dispatch and "
          f"combine the port does not run) at {100 * mfu:.2f}% of 989 "
          f"TFLOP/s; {card}")
    graph, counts, _ = _run_app(
        torch, lm_app.main,
        _train_argv(dict(mc, iters=mc["iters"] - 1))
        + ["--experts", str(mc["experts"]), "--steps-per-call", "2"])
    _held_launches("MoE LM graphs", counts, {k: m * 4 for k, m in per.items()})
    _check(graph["step_losses"] == moe["step_losses"],
           f"MoE LM as graphs: losses {graph['step_losses']} vs {losses}")
    diff = (_bit_diff(torch, graph["final"][0], moe["final"][0]) +
            _bit_diff(torch, graph["final"][1], moe["final"][1]))
    _check(not diff, f"MoE LM as graphs: tensors differ in bits: {diff[:5]}")
    g_ms = graph["elapsed_s"] * 1e3 / graph["iterations"]
    print(f"[item5] MoE LM as graphs of 2 (2 + {graph['iterations']} steps): "
          f"losses, params and Adam's state bit for bit equal to the eager "
          f"steps; {g_ms:.3f} ms/step against {ms_step:.3f} eager")
    del moe, graph
    gc.collect()

    # -- one MoE-LM step under the profiler --
    cfg = FFConfig(batch_size=mc["batch"], compute_dtype="bfloat16",
                   optimizer="adam", learning_rate=mc["lr"], seed=mc["seed"])
    ff = build_transformer_lm(
        batch_size=mc["batch"], seq_len=mc["seq"], vocab_size=mc["vocab"],
        d_model=mc["d_model"], num_heads=mc["heads"], num_layers=L,
        moe_experts=mc["experts"], config=cfg)
    _profile_train(torch, "item5-moe-profile", ff, cfg)
    moe_fwd = sum(op_cost(op).flops for op in ff.layers
                  if op.name.endswith("_moe"))
    print(f"[item5] the MoE ops' cost_model forward flops {moe_fwd:.4g} a "
          f"step, of which the one-hot dispatch and combine "
          f"{onehot / 3.0:.4g}; {card}")
    gc.collect()
    return rows, launches


#: Phase 24 (item 7's training side): the LM of phase 5 at bench.py's
#: widths, 12 resilient steps as graphs of 4 with a save every 4, and the
#: faults of (a) (a NaN batch of an LM is inert: its inputs are integer
#: ids, and the injector NaNs float inputs only, as JAX's does).
ITEM7 = dict(TRAIN, iters=12, k=4, save_every=4, warmup=1)
ITEM7_FAULTS = dict(nan_loss_at=(6,), raise_at=(9,), nan_batch_at=(10,))
#: (f): bench.py's serve requests on the trained model; its max_seq is
#: the training seq (the position table is (seq, d_model)).
ITEM7_SERVE = dict(SERVE, max_seq=TRAIN["seq"])
#: (c): the watchdog's deadline and how long the host stalls.
ITEM7_STALL = (0.5, 1.5)


def _item7_argv(c, ckpt=None, extra=()):
    argv = _train_argv(c)
    if ckpt is not None:
        argv += ["--resilient", "--save-every", str(c["save_every"]),
                 "--steps-per-call", str(c["k"]), "--ckpt-dir", ckpt]
    return argv + list(extra)


def _tree_bytes(*trees) -> int:
    from flexflow_torch.runtime.checkpoint import flatten

    return sum(t.numel() * t.element_size() for tree in trees
               for t in flatten(tree).values())


def _app_lines(main, argv) -> list:
    """One in-process app run on the card; its report lines."""
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv, device="cuda")
    _check(rc == 0, f"{argv}: exit {rc}")
    return out.getvalue().splitlines()


def _counting_fences():
    """Counts the trainer's fences (``telemetry.host_fence``) and the
    serving loop's (``serving._readback``) from here on; returns the
    counter list and a function restoring both."""
    from flexflow_torch.runtime import serving, telemetry

    seen, real = [0], [(m, n, getattr(m, n)) for m, n in
                       ((telemetry, "host_fence"), (serving, "_readback"))]

    def counting(fn):
        def counted(value):
            seen[0] += 1
            return fn(value)
        return counted

    for m, n, fn in real:
        setattr(m, n, counting(fn))
    return seen, lambda: [setattr(m, n, fn) for m, n, fn in real]


def _run_log(tdir):
    """The one run log under ``tdir``: its events."""
    import glob

    paths = glob.glob(f"{tdir}/run-*.jsonl")
    _check(len(paths) == 1, f"{tdir}: run logs {paths}")
    with open(paths[0]) as f:
        return [json.loads(line) for line in f]


def _stall_child_check(tdir) -> str:
    """(c)'s watchdog: a 0.5 s deadline, a host that stalls 1.5 s, and a
    child that waits for SIGUSR1: one ``stall`` event, one signal."""
    from flexflow_torch.runtime.telemetry import Telemetry

    child = subprocess.Popen(
        [sys.executable, "-c",
         "import signal, sys\n"
         "signal.pthread_sigmask(signal.SIG_BLOCK, [signal.SIGUSR1])\n"
         "print('ready', flush=True)\n"
         "got = signal.sigtimedwait([signal.SIGUSR1], 60)\n"
         "sys.exit(0 if got and got.si_signo == signal.SIGUSR1 else 3)\n"],
        stdout=subprocess.PIPE, text=True)
    try:
        _check(child.stdout.readline().strip() == "ready", "stall child")
        deadline, stall = ITEM7_STALL
        with Telemetry(tdir, stall_deadline_s=deadline,
                       notify_pid=child.pid) as tel:
            tel.heartbeat("before the stall")
            time.sleep(stall)  # the stalled host
            tel.heartbeat("after the stall")
        rc = child.wait(timeout=60)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    events = _run_log(tdir)
    stalls = [e for e in events if e["ev"] == "stall"]
    _check(len(stalls) == 1 and stalls[0]["notified_pid"] == child.pid,
           f"watchdog: stall events {stalls}")
    _check(rc == 0, f"watchdog: the child saw no SIGUSR1 (exit {rc})")
    _check(any(e["ev"] == "stall_recovered" for e in events),
           "watchdog: no stall_recovered")
    return (f"one stall event after {stalls[0]['idle_s']} s idle (deadline "
            f"{deadline} s), SIGUSR1 delivered to pid {child.pid}")


def phase_item7(torch, kernels):
    """ROADMAP item 7's training side on the card (phase 24): (a) the
    resilient 2k LM as graphs, faulted, bit for bit against unfaulted;
    save and rollback times; (b) SIGTERM and resume of the app; (c)
    telemetry; (d) ``--trace``; (e) ``--profiling``; (f) the
    train-to-serve handoff; (g) the chaos matrix.  Returns the launch
    counts of (a)'s faulted run and (f)'s served run."""
    import contextlib
    import gc
    import io
    import os
    import shutil
    import signal
    import tempfile

    from flexflow_torch.apps import transformer
    from flexflow_torch.apps.common import (
        make_batch_fn,
        make_optimizer,
        parse_training_args,
    )
    from flexflow_torch.models.transformer import build_transformer_lm
    from flexflow_torch.obs.events import EVENT_CATALOG
    from flexflow_torch.obs.registry import index_path
    from flexflow_torch.runtime.checkpoint import CheckpointManager
    from flexflow_torch.runtime.executor import Executor
    from flexflow_torch.runtime.resilience import (
        FaultInjector,
        ResilientTrainer,
    )
    from flexflow_torch.runtime.serving import (
        Server,
        ServingExecutor,
        synthetic_requests,
    )
    from flexflow_torch.tools import chaos_smoke

    card = _card()
    c = ITEM7
    root = tempfile.mkdtemp(prefix="ff_item7_")
    launches = {}
    try:
        # -- (a) the resilient run, faulted against unfaulted --
        argv = _train_argv(c)
        for flag in ("--seq", "--layers", "--vocab", "--d-model", "--heads"):
            i = argv.index(flag)  # the app's own flags, popped before
            del argv[i:i + 2]     # parse_training_args
        cfg = parse_training_args(argv)
        ff = build_transformer_lm(
            batch_size=c["batch"], seq_len=c["seq"], vocab_size=c["vocab"],
            d_model=c["d_model"], num_heads=c["heads"],
            num_layers=c["layers"], config=cfg)
        drawn = []
        base_fn = make_batch_fn(ff, cfg)

        def batch_fn(step):
            drawn.append(step)
            return base_fn(step)

        def factory():
            return Executor(ff, cfg, optimizer=make_optimizer(cfg),
                            device="cuda")

        def resilient(tag, injector=None, sync=False):
            ck = CheckpointManager(os.path.join(root, tag),
                                   async_save=not sync)
            rt = ResilientTrainer(factory, ck, fault_injector=injector)
            with contextlib.redirect_stdout(io.StringIO()):
                out = rt.fit(iterations=c["iters"], batch_fn=batch_fn,
                             save_every=c["save_every"], seed=cfg.seed,
                             steps_per_call=c["k"])
            ck.close()
            return rt, out

        _, clean = resilient("clean")
        drawn.clear()
        inj = FaultInjector(**ITEM7_FAULTS)
        _zero_counts()
        rt, faulted = resilient("faulted", inj)
        launches["item7_train"] = counts = _counts()
        for name in ("flash_attention_lse", "flash_attention_lse_bwd",
                     "softmax_xent", "softmax_xent_bwd"):
            _check(counts[name] > 0, f"item7 (a): {name} never launched")
        floats = any(t.dtype.is_floating_point for t in ff.input_tensors)
        want_restarts = 2 + floats
        _check(rt.total_restarts == want_restarts,
               f"item7 (a): {rt.total_restarts} rollbacks, expected "
               f"{want_restarts} (fired {inj.fired})")
        _check(sorted(m for m, _ in inj.fired) ==
               ["nan_batch", "nan_loss", "raise"], f"fired {inj.fired}")
        steps = range(c["iters"])
        _check([faulted["losses"][s] for s in steps] ==
               [clean["losses"][s] for s in steps],
               f"item7 (a): losses {faulted['losses']} vs {clean['losses']}")
        diff = _bit_diff(torch, faulted["params"], clean["params"]) + \
            _bit_diff(torch, faulted["opt_state"], clean["opt_state"])
        _check(not diff, f"item7 (a): final tensors differ in bits: {diff}")
        replayed = len(drawn) - len(set(drawn))
        roll_ms = [1e3 * s for s in rt.rollback_s]
        print(f"[item7] (a) {c['iters']} steps as graphs of {c['k']}, a save "
              f"every {c['save_every']}, faults {ITEM7_FAULTS}: "
              f"{rt.total_restarts} rollbacks (the NaN batch is inert on "
              f"an all-integer batch: fired {inj.fired}), {replayed} "
              f"batches drawn again; losses and final params, Adam's m, v "
              f"and t bit-identical to the unfaulted run; ms a rollback "
              f"{', '.join(f'{m:.3f}' for m in roll_ms)}; launches "
              f"{counts}; {card}")
        # Save times of this snapshot, sync and async.
        p, o, s = clean["params"], clean["opt_state"], clean["state"]
        nbytes = _tree_bytes(p, o, s)
        times = {}
        for tag, async_save in (("sync", False), ("async", True)):
            for rep in range(2):
                with CheckpointManager(os.path.join(root, f"save_{tag}"),
                                       async_save=async_save) as ck:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    ck.save(100 + rep, p, o, s)
                    t1 = time.perf_counter()
                    ck.wait_until_finished()
                    t2 = time.perf_counter()
                times[(tag, rep)] = ((t1 - t0) * 1e3, (t2 - t1) * 1e3)
        print(f"[item7] (a) snapshot {nbytes} bytes (params, Adam m, v, t); "
              f"ms a save, first and second: sync "
              f"{times[('sync', 0)][0]:.3f} / {times[('sync', 1)][0]:.3f}; "
              f"async blocking {times[('async', 0)][0]:.3f} / "
              f"{times[('async', 1)][0]:.3f} + flush "
              f"{times[('async', 0)][1]:.3f} / {times[('async', 1)][1]:.3f}"
              f"; {card}")

        # -- (f) the train-to-serve handoff of (a)'s last snapshot --
        sv = ITEM7_SERVE
        sex = ServingExecutor(
            build_transformer_lm(
                batch_size=sv["max_batch"], seq_len=sv["max_seq"],
                vocab_size=sv["vocab"], d_model=sv["d_model"],
                num_heads=sv["heads"], num_layers=sv["layers"], config=cfg),
            cfg, max_batch=sv["max_batch"], max_seq=sv["max_seq"],
            buckets=tuple(sv["buckets"]), device="cuda")
        step, sparams, sstate = sex.restore(os.path.join(root, "faulted"))
        _check(step == c["iters"], f"item7 (f): restored step {step}")

        def reqs():
            return synthetic_requests(
                sv["requests"], sv["vocab"], prompt_len=tuple(sv["prompt"]),
                max_new_tokens=sv["max_new"], seed=0)

        _zero_counts()
        got, gstats = Server(sex, sparams, sstate,
                             decode_steps=sv["decode_steps"]).run(reqs())
        launches["item7_serve"] = scounts = _counts()
        live, _ = Server(sex, faulted["params"], {},
                         decode_steps=sv["decode_steps"]).run(reqs())
        _check(not any(r.error for r in got.values()), "item7 (f): errors")
        _check({r: list(v.tokens) for r, v in got.items()} ==
               {r: list(v.tokens) for r, v in live.items()},
               "item7 (f): restored tokens differ from the in-memory ones")
        for name in ("flash_attention_lse", "flash_decode"):
            _check(scounts[name] > 0, f"item7 (f): {name} never launched")
        print(f"[item7] (f) ServingExecutor.restore of step {step}: "
              f"{gstats['completed']} requests, {gstats['tokens']} greedy "
              f"tokens equal to serving the in-memory params; launches "
              f"{scounts}; {card}")
        del sex, sparams, sstate, got, live, rt, clean, faulted, p, o, s
        gc.collect()
        torch.cuda.empty_cache()

        # -- (b) SIGTERM after the first save, then the same --ckpt-dir --
        ckb = os.path.join(root, "app")
        argv = _item7_argv(c, ckb, ["--sync-ckpt"])
        cmd = [sys.executable, "-m", "flexflow_torch.apps.transformer", *argv]
        env = dict(os.environ, PYTHONPATH=os.path.dirname(
            os.path.abspath(__file__)))
        logs = []
        for run in range(2):
            log = open(os.path.join(root, f"app{run}.log"), "w+")
            proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT,
                                    env=env, cwd=os.path.dirname(
                                        os.path.abspath(__file__)))
            try:
                if run == 0:
                    first = os.path.join(ckb, str(c["save_every"]))
                    t0 = time.perf_counter()
                    while not os.path.isdir(first):
                        _check(proc.poll() is None and
                               time.perf_counter() - t0 < 600,
                               "item7 (b): no first save")
                        time.sleep(0.001)
                    proc.send_signal(signal.SIGTERM)
                rc = proc.wait(timeout=600)
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
            log.seek(0)
            logs.append(log.read())
            log.close()
            _check(rc == 0, f"item7 (b) run {run}: exit {rc}\n{logs[-1]}")
        stopped = [ln for ln in logs[0].splitlines() if "PREEMPTED" in ln]
        _check(len(stopped) == 1, f"item7 (b): not preempted\n{logs[0]}")
        at = int(stopped[0].rsplit(" ", 1)[1])
        _check(at < c["iters"], f"item7 (b): preempted only at step {at}")
        _check("PREEMPTED" not in logs[1] and "restarts = 0" in logs[1],
               f"item7 (b): the resumed run\n{logs[1]}")
        ex = factory()
        with CheckpointManager(ckb) as ck:
            step, pb, ob, _ = ck.restore(templates=ex.init())
        ex2 = factory()
        with CheckpointManager(os.path.join(root, "clean")) as ck:
            _, pc, oc, _ = ck.restore(templates=ex2.init(),
                                      step=c["iters"])
        _check(step == c["iters"], f"item7 (b): last step {step}")
        diff = _bit_diff(torch, pb, pc) + _bit_diff(torch, ob, oc)
        _check(not diff, f"item7 (b): resumed params differ: {diff}")
        print(f"[item7] (b) apps.transformer --resilient --sync-ckpt: "
              f"SIGTERM after the save at step {c['save_every']}, emergency "
              f"save at step {at}, exit 0; the rerun resumed and ended at "
              f"step {step}, params and Adam state bit-identical to the "
              f"uninterrupted run")
        del ex, ex2, pb, ob, pc, oc
        gc.collect()
        torch.cuda.empty_cache()

        # -- (c) telemetry: fences, events, exit, index, overhead --
        argv = _item7_argv(c, extra=["-p", "4"])
        seen, restore = _counting_fences()
        elapsed = {"on": [], "off": []}
        try:
            for pair in range(2):
                for mode in ("on", "off"):
                    tdir = os.path.join(root, f"tel_{pair}")
                    stats = {}
                    extra = ["--telemetry", tdir] if mode == "on" else []
                    before = seen[0]
                    with contextlib.redirect_stdout(io.StringIO()):
                        rc = transformer.main(argv + extra, device="cuda",
                                              stats_out=stats)
                    _check(rc == 0, f"item7 (c): exit {rc}")
                    elapsed[mode].append(stats["elapsed_s"])
                    if pair == 0:
                        fences = seen[0] - before
                        if mode == "on":
                            tel = stats["telemetry"]
                            fences_on = fences
                            _check(tel["fences"] == fences, f"{tel}")
                        else:
                            _check(fences == fences_on,
                                   f"item7 (c): {fences_on} fences with "
                                   f"telemetry, {fences} without")
        finally:
            restore()
        events = _run_log(os.path.join(root, "tel_0"))
        unknown = {e["ev"] for e in events} - EVENT_CATALOG
        _check(not unknown, f"item7 (c): events outside the catalog {unknown}")
        _check(events[-1]["ev"] == "run_end" and
               events[-1]["exit"] == "clean", f"{events[-1]}")
        with open(index_path(os.path.join(root, "tel_0"))) as f:
            rows = [json.loads(line) for line in f]
        _check(len(rows) == 1 and rows[0]["exit"] == "clean" and
               rows[0]["fingerprint"]["platform"] == "gpu", f"index {rows}")
        on_s, off_s = sum(elapsed["on"]), sum(elapsed["off"])
        stall = _stall_child_check(os.path.join(root, "stall"))
        print(f"[item7] (c) {tel['steps']} steps, {tel['fences']} fences "
              f"with telemetry and without ({tel['fences_per_step']} a "
              f"step); step ms p50/p95/max {tel['step_ms_p50']} / "
              f"{tel['step_ms_p95']} / {tel['step_ms_max']}; "
              f"{len(events)} events, all in the catalog; exit clean; "
              f"index row written; overhead_pct "
              f"{100 * (on_s - off_s) / off_s:.3f} (on, off, on, off: "
              f"{', '.join(f'{x:.4f}' for pair in zip(elapsed['on'], elapsed['off']) for x in pair)} s); "
              f"watchdog: {stall}; {card}")

        # -- (d) --trace and (e) --profiling in one run --
        tdir, trdir = os.path.join(root, "tel_trace"), os.path.join(root, "tr")
        lines = _app_lines(transformer.main, _item7_argv(
            dict(c, iters=2), extra=["--telemetry", tdir, "--trace", trdir,
                                     "--profiling"]))
        summary = _run_log(tdir)[-1].get("trace_summary")
        _check(summary is not None and summary["lane"] == "device",
               f"item7 (d): no device-lane trace_summary: {summary}")
        names = [o["op"] for o in summary["top_ops"]]
        for what, keys in (("K1f", ("wg_fwd_kernel",)),
                           ("K1b", ("wg_dq_kernel", "wg_dkv_kernel")),
                           ("a cuBLAS product",
                            ("gemm", "cutlass", "nvjet"))):
            _check(any(k in n for n in names for k in keys),
                   f"item7 (d): top_ops name no {what}: {names}")
        print(f"[item7] (d) --trace: device {summary['device_ms_total']} ms "
              f"in the 2 timed steps, annotations "
              f"{summary['annotations']}; top ops:")
        for o in summary["top_ops"]:
            print(f"[item7]   {o['device_ms']:9.3f} ms x{o['count']:<4d} "
                  f"{o['op'][:90]}")
        table = [ln for ln in lines if " us  -> " in ln or "TOTAL" in ln]
        _check(len(table) == len(ff.layers) + 1,
               f"item7 (e): {len(table)} profile rows for "
               f"{len(ff.layers)} ops")
        print("[item7] (e) --profiling, each op's forward alone (CUDA "
              f"events, mean of 5); {card}:")
        for ln in table:
            print(f"[item7]   {ln}")

        # -- (g) the chaos matrix on the card --
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = chaos_smoke.main([])
        rows = out.getvalue().splitlines()
        for ln in rows:
            print(f"[item7] (g) {ln}")
        _check(rc == 0, "item7 (g): a chaos scenario failed")
        from flexflow_torch.runtime.chaos import PORTED, SCENARIOS

        for name in SCENARIOS:
            want = "PASS" if name in PORTED else "NOT PORTED"
            _check(any(ln.startswith(want) and f" {name} " in ln
                       for ln in rows), f"item7 (g): {name} not {want}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return launches


#: Phase 25: bench.py's serving leg's scheduled workload (``bench.
#: sched_workload``: 2 x 16 requests, prompts of 4-32 tokens, 2-32 new,
#: bursts of 16 2 virtual ms apart, 2 tiers, tier-0 SLO 60 virtual ms,
#: seed 13) at ``SERVE`` widths in bf16; the prefix cache's block and the
#: speculative depth of (e).
SCHED = dict(n_req=16, kv_block=16, speculate=4)


def _tail_diffs(torch, ex, params, state, prompt, offset: int) -> list:
    """Per layer, the elements of the K/V rows ``[offset, len(prompt))``
    that the offset prefill of ``prompt`` over its own resident prefix
    writes otherwise than a fresh prefill of the same bucket."""
    import numpy as np

    n = len(prompt)
    bucket = ex.bucket_for(n)
    padded = np.zeros((1, bucket), np.int32)
    padded[0, :n] = prompt
    fresh, _t, _ok = ex.build_prefill(bucket)(params, state, padded,
                                              np.int32(n))
    pool = ex.init_cache()
    table = np.arange(1, ex.blocks_per_slot + 1, dtype=np.int32)
    ex.install_paged(pool, fresh, table)
    got, _t, _ok = ex.build_prefill_from(bucket, offset)(
        params, state, pool, table[:offset // ex.kv_block], padded,
        np.int32(n))
    return [int(sum((got[name][kv][offset:n] != fresh[name][kv][offset:n])
                    .sum().item() for kv in ("k", "v")))
            for name in fresh]


def _first_calls(torch):
    """Times each real scheduler engine's programs at their first call
    (eager steps and the capture, between two synchronizes) with the
    bytes the CUDA caching allocator reserved for them: ``({engine:
    {("decode" | "spec", n): {"first_call_s", "bytes"}}}, restore)``."""
    import weakref

    from flexflow_torch.serving import scheduler

    # Weak keys: a released engine (a fleet's dead replica) is freed.
    table = weakref.WeakKeyDictionary()
    real = scheduler._RealEngine._program

    def program(self, kind, n):
        fn, key = real(self, kind, n), (kind, n)
        rec = table.setdefault(self, {})
        if key in rec:
            return fn

        def first(*a, **k):
            cuda = torch.cuda.is_available()
            if cuda:
                torch.cuda.synchronize()
            r0 = torch.cuda.memory_reserved() if cuda else 0
            t0 = time.perf_counter()
            out = fn(*a, **k)
            if cuda:
                torch.cuda.synchronize()
            rec[key] = {"first_call_s": time.perf_counter() - t0,
                        "bytes": (torch.cuda.memory_reserved() - r0
                                  if cuda else 0)}
            return out
        return first

    scheduler._RealEngine._program = program
    return table, lambda: setattr(scheduler._RealEngine, "_program", real)


def _timed_telemetry(tel, acc: dict) -> None:
    """Times the host work ``tel`` adds to a run into ``acc["hooks"]``
    (s): every hook of the loop, outermost calls only, and of
    ``tel.fence`` only its wrapper (``acc["wait"]``, the device wait of
    the fence it wraps, is taken back out).  ``acc["by"]`` splits the
    same time by kind: an outermost ``emit`` by its event, every other
    hook by its name (``fence`` without its wait), each as ``[seconds,
    calls]``."""
    from flexflow_torch.runtime import telemetry

    depth = [0]
    by = acc.setdefault("by", {})

    def wrap(fn, name):
        def timed(*a, **k):
            depth[0] += 1
            t0 = time.perf_counter()
            w0 = acc["wait"]
            try:
                return fn(*a, **k)
            finally:
                depth[0] -= 1
                dt = time.perf_counter() - t0
                if name == "wait":
                    acc["wait"] += dt
                elif depth[0] == 0:
                    acc["hooks"] += dt
                    kind = f"emit:{a[0]}" if name == "emit" else name
                    row = by.setdefault(kind, [0.0, 0])
                    row[0] += dt - (acc["wait"] - w0)
                    row[1] += 1
        return timed

    for name in ("emit", "record_step", "add_programs", "program_cost",
                 "note_summary", "fence"):
        setattr(tel, name, wrap(getattr(tel, name), name))
    real = tel.fence

    def fence(value, label="fence", read=None):
        return real(value, label,
                    read=wrap(read or telemetry.host_fence, "wait"))

    tel.fence = fence


def _log_path(tdir) -> str:
    """The one run log under ``tdir``."""
    import glob

    paths = glob.glob(f"{tdir}/run-*.jsonl")
    _check(len(paths) == 1, f"{tdir}: run logs {paths}")
    return paths[0]


def _decode_ks(decisions, since: int = 0) -> list:
    return [d["k"] for d in decisions[since:] if d["d"] == "decode"]


def _reprefilled(*servers) -> set:
    """Requests that a preemption, a retry or an engine restart sent back
    through a re-prefill in any of ``servers``' runs."""
    out = set()
    for srv in servers:
        for e in srv.span_events:
            if e["ev"] in ("request_preempt", "request_retry"):
                out.add(e["id"])
            elif e["ev"] == "engine_restart":
                out.update(e["requeued"])
    return out


def _obs_cli(*argv) -> str:
    """``python -m flexflow_torch.obs ARGV`` in a child process: its
    standard output (exit 0 required)."""
    import os

    env = dict(os.environ, PYTHONPATH=os.path.dirname(
        os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-m", "flexflow_torch.obs",
                          *argv], capture_output=True, text=True, timeout=120,
                         env=env)
    _check(out.returncode == 0, f"obs {argv}: exit {out.returncode}\n"
                                f"{out.stderr[-2000:]}")
    return out.stdout


def phase_serve_sched(torch, kernels, device="cuda"):
    """ROADMAP item 7's rest and item 8's scheduler on the card (phase
    25), at ``SERVE`` widths in bf16 over the serving leg's bursty
    workload (``SCHED``).  (a) the plain ``Server`` at K = 8 with
    telemetry on and off (on, off, on, off after a warm run): the same
    tokens and fences, a start and an end event per request, 1/8 program
    per step, ``python -m flexflow_torch.obs report`` on the log, the
    host time of telemetry per dispatch, by kind, and ``overhead_pct``;
    (b) the
    scheduler, slo (telemetry on) and fifo, on the real engine: the bench
    columns, tokens equal to the plain Server's, the simulated run's
    decisions and dispatches, exact K1f and K6 launches, wall ms per
    superstep by k beside the plain graph's and each k's capture; (c) the
    failure model (``bench.SCHED_FAULTS``, one retry and one restart):
    its counters and decisions equal the simulated run's, the untouched
    requests' tokens equal (b)'s, the restarted engine captures K6 again,
    no degraded rung, ms a restart; (d) every timeline of (b)'s log
    reconciles, the stats' autopsy is the one the reader folds from the
    log, ``obs request LOG --id N``'s waterfall; (e) the prefix workload
    on the paged pool with and without the prefix cache (tokens equal in
    f32 and bf16, K1f launched by every prefill, fresh or offset; per
    bucket, the tail K/V elements of one sharer's offset prefill that
    differ from a fresh prefill's) and speculation d = 4 (tokens equal to
    plain decode); (f) (b)'s slo run under the latency model fitted on
    (a)'s log.  Returns the launches of each run."""
    import os
    import shutil
    import tempfile

    from flexflow_torch import bench
    from flexflow_torch.config import FFConfig
    from flexflow_torch.models.transformer import build_transformer_lm
    from flexflow_torch.obs import spans
    from flexflow_torch.obs.reader import RunLog
    from flexflow_torch.runtime import telemetry
    from flexflow_torch.runtime.serving import (
        Server,
        ServingExecutor,
        ServingFaultInjector,
    )
    from flexflow_torch.serving import (
        ScheduledServer,
        SchedulerPolicy,
        ServingLatencyModel,
        ServingResilience,
        SlotShape,
    )

    card = _card() if device == "cuda" else device
    c, L, n_req = SERVE, SERVE["layers"], SCHED["n_req"]

    def model(dtype):
        return build_transformer_lm(
            batch_size=c["max_batch"], seq_len=c["max_seq"],
            vocab_size=c["vocab"], d_model=c["d_model"],
            num_heads=c["heads"], num_layers=L,
            config=FFConfig(batch_size=c["max_batch"], compute_dtype=dtype))

    ff = model("bfloat16")
    geometry = dict(max_batch=c["max_batch"], max_seq=c["max_seq"],
                    buckets=c["buckets"])

    def executor(lm=None, **kw):
        return ServingExecutor(lm or ff, device=device, **geometry, **kw)

    def workload(shared=0):
        return bench.sched_workload(n_req, c["vocab"], c["max_seq"],
                                    c["max_new"], shared)

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    sex = executor()
    params, state = sex.init(0)
    n = 2 * n_req
    root = tempfile.mkdtemp(prefix="ff_sched_")
    launches = {}

    def counted(tag, fn):
        _zero_counts()
        out = fn()
        sync()
        launches[tag] = _counts()
        return out

    def held(tag, want):
        _held_launches(f"sched {tag}", launches[tag],
                       {k: v for k, v in want.items() if v})
        _check(all(launches[tag][k] > 0 for k in want if want[k]),
               f"sched {tag}: {launches[tag]}")

    def toks(res):
        return {i: r.tokens for i, r in res.items()}

    first_calls, unpatch = _first_calls(torch)
    try:
        # -- (a) telemetry on the plain Server at K = 8 --
        srv = Server(sex, params, state, decode_steps=8)
        seen, restore = _counting_fences()
        acc = {"hooks": 0.0, "wait": 0.0}
        runs = []
        try:
            base, base_st = counted("plain", lambda: srv.run(workload()))
            for pair in range(2):
                for mode in ("on", "off"):
                    before = seen[0]
                    if mode == "on":
                        tel = telemetry.Telemetry(
                            os.path.join(root, f"plain_{pair}"))
                        _timed_telemetry(tel, acc)
                        with tel:
                            res, st = srv.run(workload())
                    else:
                        res, st = srv.run(workload())
                    runs.append((mode, res, st, seen[0] - before))
        finally:
            restore()
        held("plain", {"flash_attention_lse": L * base_st["prefills"],
                       "flash_decode": 2 * L * 8})
        for mode, res, st, fences in runs:
            _check(toks(res) == toks(base) and not st["failed"],
                   f"sched (a): telemetry {mode} changed a token")
            _check(fences == runs[0][3] ==
                   st["prefills"] + st["decode_supersteps"],
                   f"sched (a): {fences} fences with telemetry {mode}, "
                   f"{runs[0][3]} on")
        plain_log = RunLog.load(_log_path(os.path.join(root, "plain_0")))
        _check(len(plain_log.select("request_start")) ==
               len(plain_log.select("request_end")) == n,
               "sched (a): not one start and one end event per request")
        summ = plain_log.summary()
        _check(summ["programs_per_step"] == 0.125 and
               summ["fences"] == runs[0][3],
               f"sched (a): summary {summ}")
        report = _obs_cli("report", plain_log.path)
        _check("programs_per_step: 0.125" in report and
               "program costs (first build):" in report,
               f"sched (a): obs report\n{report}")
        on = [r for r in runs if r[0] == "on"]
        off = [r for r in runs if r[0] == "off"]
        dispatches = sum(st["prefills"] + st["decode_supersteps"]
                         for _m, _r, st, _f in on)
        on_s = sum(st["elapsed_s"] for _m, _r, st, _f in on)
        off_s = sum(st["elapsed_s"] for _m, _r, st, _f in off)
        plain_ms = statistics.median(
            st["decode_s"] * 1e3 / st["decode_supersteps"]
            for _m, _r, st, _f in runs)
        print(f"[sched] (a) plain Server K=8, {n} requests: the same tokens "
              f"and {runs[0][3]} fences ({summ['fences_per_step']} a step) "
              f"with telemetry on and off; {len(plain_log.events)} events, "
              f"programs_per_step {summ['programs_per_step']}; telemetry's "
              f"host time {(acc['hooks'] - acc['wait']) / dispatches * 1e6:.1f}"
              f" us per dispatch ({dispatches} dispatches); overhead_pct "
              f"{100 * (on_s - off_s) / off_s:.3f} (on, off, on, off: "
              f"{', '.join(f'{r[2]['elapsed_s']:.4f}' for r in runs)} s); "
              f"decode {plain_ms:.3f} ms per superstep (graph replay); "
              f"{card}")
        print("[sched] (a) telemetry's host time by kind, us per dispatch "
              "(calls): " + ", ".join(
                  f"{kind} {sec / dispatches * 1e6:.1f} ({calls})"
                  for kind, (sec, calls) in sorted(
                      acc["by"].items(), key=lambda kv: -kv[1][0])))
        print("[sched] (a) obs report: " + "; ".join(
            ln.strip() for ln in report.splitlines()
            if ln.startswith(("exit:", "  prefill:", "  decode_superstep:"))))

        # -- (b) the scheduler, slo and fifo, on the real engine --
        slo_dir = os.path.join(root, "sched_slo")
        servers, out = {}, {}

        def sched(tag, policy, engine=None, tdir=None, reqs=None,
                  weights=None, **kw):
            p, st_ = weights or (params, state)
            s = ScheduledServer(engine or sex, p, st_, decode_steps=8,
                                policy=policy, **kw)
            servers[tag] = s

            def go():
                if tdir is None:
                    return s.run(reqs or workload())
                with telemetry.Telemetry(tdir):
                    return s.run(reqs or workload())

            out[tag] = counted(tag, go)
            return out[tag]

        slo, fifo = SchedulerPolicy(name="slo"), SchedulerPolicy.fifo()
        sched("slo", slo, tdir=slo_dir)
        sched("fifo", fifo)
        shape = SlotShape(**geometry)
        preempted = _reprefilled(servers["slo"], servers["fifo"])
        for tag, pol in (("slo", slo), ("fifo", fifo)):
            res, st = out[tag]
            s = servers[tag]
            ks = _decode_ks(s.decisions)
            held(tag, {"flash_attention_lse": L * st["prefills"],
                       "flash_decode": 2 * L * sum(set(ks))})
            sim = ScheduledServer.simulated(shape, decode_steps=8,
                                            policy=pol)
            _r, sst = sim.run(workload())
            _check(sim.decisions == s.decisions and
                   (sst["prefills"], sst["decode_supersteps"]) ==
                   (st["prefills"], st["decode_supersteps"]),
                   f"sched (b) {tag}: the simulated run decided otherwise")
            _check(st["completed"] + st["request_sheds"] == n and
                   "degraded_rungs" not in st, f"sched (b) {tag}: {st}")
            same = [i for i in res if i not in preempted]
            _check(all(res[i].tokens == base[i].tokens for i in same),
                   f"sched (b) {tag}: tokens differ from the plain Server's")
            moved = [i for i in preempted if res[i].tokens != base[i].tokens]
            print(f"[sched] (b) {tag}: {st['prefills']} prefills, "
                  f"{st['decode_supersteps']} supersteps (k {sorted(set(ks))})"
                  f" = the simulated run's, decisions equal; tokens of "
                  f"{len(same)} requests equal the plain Server's, "
                  f"{len(moved)} of {len(preempted)} re-prefilled ones "
                  f"differ (bf16 re-prefill rounding); launches "
                  f"{ {k: v for k, v in launches[tag].items() if v} }")
        slo_log = RunLog.load(_log_path(slo_dir))
        eng = servers["slo"].engine
        B = c["max_batch"]
        for k in (1, 2, 4, 8, 16):
            # Every adaptive candidate's graph on the finished run's engine
            # (a k the run did not choose is captured here, outside the
            # counted runs), for its first-call time and pool bytes.
            if ("decode", k) not in first_calls[eng]:
                eng.decode([0] * B, [0] * B, k)
        by_k = {}
        for e in slo_log.select("decode_superstep"):
            by_k.setdefault(e["k"], []).append(e["wall_s"] * 1e3)
        for k in (1, 2, 4, 8, 16):
            prog = first_calls[eng][("decode", k)]
            later = by_k.get(k, [])[1:]
            print(f"[sched] (b) k={k}: {len(by_k.get(k, []))} supersteps in "
                  f"the slo run, "
                  f"{statistics.median(later) if later else float('nan'):.3f}"
                  f" ms wall per superstep after the first (plain graph "
                  f"K=8: {plain_ms:.3f} ms); first call (eager + capture) "
                  f"{prog['first_call_s'] * 1e3:.1f} ms, {prog['bytes']} "
                  f"bytes reserved; {card}")

        # -- (c) the failure model --
        builds = []
        rsrv_kw = dict(resilience=ServingResilience(max_retries=1,
                                                    max_restarts=1))
        s = ScheduledServer(sex, params, state, decode_steps=8, policy=slo,
                            fault_injector=ServingFaultInjector(
                                **bench.SCHED_FAULTS), **rsrv_kw)
        real_build = s._build_engine

        def timed_build(initial=False):
            t0 = time.perf_counter()
            e = real_build(initial)
            builds.append(time.perf_counter() - t0)
            return e

        s._build_engine = timed_build
        servers["failure"] = s
        out["failure"] = counted("failure", lambda: s.run(workload()))
        res, st = out["failure"]
        sim = ScheduledServer.simulated(
            shape, decode_steps=8, policy=slo, fault_injector=
            ServingFaultInjector(**bench.SCHED_FAULTS), **rsrv_kw)
        _r, sst = sim.run(workload())
        keys = ("request_retries", "engine_restarts", "request_expiries",
                "prefills", "decode_supersteps")
        _check(sim.decisions == s.decisions and
               all(sst[k] == st[k] for k in keys) and
               st["request_retries"] == st["engine_restarts"] == 1,
               f"sched (c): real {[st[k] for k in keys]}, simulated "
               f"{[sst[k] for k in keys]}")
        _check("degraded_rungs" not in st and sex.decode_kernel is not False,
               f"sched (c): a degraded rung without a kernel fault: {st}")
        cut = next(i for i, d in enumerate(s.decisions)
                   if d["d"] == "engine_restart")
        before, after = _decode_ks(s.decisions[:cut]), \
            _decode_ks(s.decisions, cut)
        held("failure", {"flash_attention_lse": L * st["prefills"],
                         "flash_decode": 2 * L * (sum(set(before)) +
                                                  sum(set(after)))})
        _check(after, "sched (c): no decode after the restart")
        touched = _reprefilled(servers["slo"], s)
        slo_res = out["slo"][0]
        _check(all(res[i].tokens == slo_res[i].tokens for i in res
                   if i not in touched and res[i].error is None),
               "sched (c): an untouched request's tokens differ from (b)'s")
        recapture = sum(p["first_call_s"]
                        for p in first_calls[s.engine].values())
        print(f"[sched] (c) retries {st['request_retries']}, restarts "
              f"{st['engine_restarts']}, expiries {st['request_expiries']} "
              f"= the simulated run's, decisions equal; no degraded rung; "
              f"the restarted engine captured k {sorted(set(after))} again "
              f"(K6 {launches['failure']['flash_decode']}); a restart "
              f"{(builds[0] + recapture) * 1e3:.1f} ms (engine build "
              f"{builds[0] * 1e3:.1f} ms + re-capture "
              f"{recapture * 1e3:.1f} ms); {card}")

        # -- (d) spans --
        tls = spans.timelines_from_run(slo_log)
        bad = [i for i, t in tls.items() if not t.reconciled]
        _check(len(tls) == n and not bad, f"sched (d): {len(tls)} "
                                          f"timelines, unreconciled {bad}")
        autopsy = out["slo"][1].get("slo_autopsy")
        _check(spans.slo_autopsy(tls) == (autopsy or {}) and
               slo_log.reconstruct_summary().get("slo_autopsy") == autopsy
               == slo_log.summary().get("slo_autopsy"),
               f"sched (d): autopsy {autopsy} vs the log's")
        rid = min((i for i, t in tls.items() if t.slo_ok is False),
                  default=0)
        fall = _obs_cli("request", slo_log.path, "--id", str(rid))
        _check(f"request {rid} " in fall and "reconciled=yes" in fall,
               f"sched (d): waterfall\n{fall}")
        _check("serving:" in _obs_cli("report", slo_log.path),
               "sched (d): no serving block")
        print(f"[sched] (d) {len(tls)} timelines reconcile to the "
              f"microsecond; autopsy {autopsy}; obs request --id {rid}:")
        for ln in fall.splitlines():
            print(f"[sched]   {ln}")

        # -- (e) prefix sharing and speculation under the scheduler --
        # The bench's arms in bf16 and in f32.  An offset prefill attends
        # on the fresh prefill's route (K1f over the bucket's span), so
        # the prefix cache's tokens equal those without it in both.
        kvb = SCHED["kv_block"]
        ff32 = model("float32")
        w32 = executor(ff32).init(0)
        for tag, lm, w in (("prefix_off", ff, None), ("prefix_on", ff, None),
                           ("prefix_off_f32", ff32, w32),
                           ("prefix_on_f32", ff32, w32)):
            engine = executor(lm, kv_block=kvb,
                              prefix_cache=tag.startswith("prefix_on"))
            sched(tag, slo, engine, reqs=workload(kvb), weights=w)
            pf = [e for e in servers[tag].span_events if e["ev"] == "prefill"]
            held(tag, {"flash_attention_lse": L * len(pf)})
            if tag == "prefix_on":
                offset_prefills = sum(1 for e in pf if e.get("offset"))
        cols = bench.sched_columns(out)
        f32 = bench.sched_columns(dict(out, prefix_on=out["prefix_on_f32"],
                                       prefix_off=out["prefix_off_f32"]))
        sharers = {e["id"]: e["tokens_saved"]
                   for e in servers["prefix_on"].span_events
                   if e["ev"] == "prefix_hit" and not e["full"]}
        moved = [i for i, r in out["prefix_off"][0].items()
                 if out["prefix_on"][0][i].tokens != r.tokens]
        _check(f32["prefix_match"] is True and cols["prefix_match"] is True
               and not moved and cols["prefix_hits"] > 0 and
               f32["prefix_hits"] == cols["prefix_hits"] and offset_prefills,
               f"sched (e): prefix columns {cols}; f32 {f32}; bf16 tokens "
               f"differ for {moved}, sharers {sorted(sharers)}")
        # One sharer per bucket: its tail's K/V against a fresh prefill of
        # the same prompt (a bucket no sharer reached takes a prompt of
        # bucket - 3 tokens over one shared block).
        paged = executor(ff, kv_block=kvb, prefix_cache=True)
        reqs_e = {r.id: r for r in workload(kvb)}
        tails = {}
        for b in c["buckets"]:
            rid = min((i for i in sharers
                       if paged.bucket_for(len(reqs_e[i].prompt)) == b),
                      default=None)
            if rid is not None:
                prompt, o = list(reqs_e[rid].prompt), sharers[rid]
            else:
                prompt, o = (list(reqs_e[0].prompt) * b)[:b - 3], kvb
            tails[b] = (rid, o, _tail_diffs(torch, paged, params, state,
                                            prompt, o))
        print(f"[sched] (e) prefix cache on the paged pool (kv_block "
              f"{kvb}): {cols['prefix_hits']} hits, "
              f"{cols['prefix_prefills']} prefills ({offset_prefills} of them "
              f"offset prefills on K1f) against "
              f"{cols['prefix_off_prefills']}; tokens equal without it in "
              f"f32 and in bf16 ({len(sharers)} sharers, 0 differ)")
        for b, (rid, o, diffs) in tails.items():
            who = "a synthetic prompt" if rid is None else f"request {rid}"
            print(f"[sched] (e) bucket {b}: {who}, offset {o}: tail K/V "
                  f"elements that differ from a fresh prefill, by layer "
                  f"(bf16): {diffs}")
        d = SCHED["speculate"]
        sched("spec", slo, speculate=d)
        res, st = out["spec"]
        _check(st["spec_acceptance_rate"] == 1.0 and all(
            res[i].tokens == base[i].tokens for i in res
            if i not in _reprefilled(servers["spec"])),
            f"sched (e): speculation d={d} changed a token: {st}")
        held("spec", {"flash_attention_lse": 2 * L * st["prefills"],
                      "flash_decode": 2 * (d + 1) * 2 * L})
        print(f"[sched] (e) speculation "
              f"d={d}: acceptance {st['spec_acceptance_rate']}, "
              f"{st['spec_tokens_per_dispatch']} tokens a dispatch, tokens "
              f"equal plain decode's")
        print("[sched] bench columns (latencies in virtual ms, model "
              "defaults): " + json.dumps(cols))

        # -- (f) the latency model fitted on (a)'s log --
        fitted = ServingLatencyModel.from_run(plain_log)
        _check(fitted.calibrated, f"sched (f): {fitted.describe()}")
        sched("slo_fit", slo, latency_model=fitted)
        held("slo_fit", {"flash_attention_lse": L * out["slo_fit"][1][
            "prefills"], "flash_decode": 2 * L * sum(set(_decode_ks(
                servers["slo_fit"].decisions)))})
        virt = ("queue_wait_ms_p50", "queue_wait_ms_p99", "e2e_ms_p50",
                "e2e_ms_p99", "slo_attainment", "request_preempts",
                "request_sheds", "decode_supersteps")
        for tag, label in (("slo", "model defaults (unitless constants, "
                                   "virtual ms)"),
                           ("slo_fit", f"virtual ms priced by a fit on "
                                       f"{card}: {fitted.describe()}")):
            st, s = out[tag][1], servers[tag]
            used = {("decode", k) for k in _decode_ks(s.decisions)}
            first = sum(first_calls[s.engine][p]["first_call_s"]
                        for p in used)
            replays = st["decode_supersteps"] - len(used)
            print(f"[sched] (f) {label}: "
                  f"{ {k: st.get(k) for k in virt} }; wall "
                  f"{(st['decode_s'] - first) * 1e3 / max(replays, 1):.3f}"
                  f" ms per superstep over {replays} replays (first calls "
                  f"left out); {card}")
    finally:
        unpatch()
        shutil.rmtree(root, ignore_errors=True)
    return launches


#: Phase 26: phase 25's widths and workload on a fleet of
#: ``replicas`` behind the least-loaded router; (b) kills replica 0 before
#: its decode superstep ``death_at`` with a restart budget of 0.
FLEET = dict(replicas=2, death_at=1)


def phase_fleet(torch, kernels, device="cuda"):
    """ROADMAP item 8's rest on the card (phase 26), at ``SERVE`` widths
    over the serving leg's bursty workload (``SCHED``), each replica with
    its own executor, caches and decode graphs, the weights shared.  (a)
    bf16, least-loaded: the router's and every replica's decisions and
    the dispatches equal the simulated fleet's; the tokens of every
    request no re-prefill touched equal the single-replica slo run's;
    exact K1f and K6 launches.  (b) the loss of replica 0, in f32 and in
    bf16: decisions equal the simulated fleet's under the same fault
    plan; the dead replica's engine is released; in f32 every request's
    tokens equal the unfaulted single-replica run's, in bf16 every
    untouched request's (and how many redistributed ones differ is
    printed); the wall ms from the death to the survivor's first resumed
    token.  (c) ``apps.serve --serve-auto --replicas 2`` over the app's
    bursty workload: the chosen config runs and executes the predicted
    dispatches.  (d) wall ms of a fleet run beside the single replica's,
    first-call ms and bytes per replica per k, and the bench's fleet
    columns.  Returns the launches of each run."""
    import contextlib
    import io
    import weakref

    from flexflow_torch import bench
    from flexflow_torch.apps import serve as serve_app
    from flexflow_torch.config import FFConfig
    from flexflow_torch.models.transformer import build_transformer_lm
    from flexflow_torch.runtime.serving import (
        ServingCrashLoop,
        ServingExecutor,
        ServingFaultInjector,
    )
    from flexflow_torch.serving import (
        FleetRouter,
        MemoryJournal,
        ScheduledServer,
        SchedulerPolicy,
        ServingResilience,
        SlotShape,
    )

    card = _card() if device == "cuda" else device
    c, L, n_req, R = SERVE, SERVE["layers"], SCHED["n_req"], FLEET["replicas"]
    n = 2 * n_req
    slo = SchedulerPolicy(name="slo")
    geometry = dict(max_batch=c["max_batch"], max_seq=c["max_seq"],
                    buckets=c["buckets"])
    shape = SlotShape(**geometry)
    budget = ServingResilience(max_restarts=0)

    def model(dtype):
        return build_transformer_lm(
            batch_size=c["max_batch"], seq_len=c["max_seq"],
            vocab_size=c["vocab"], d_model=c["d_model"],
            num_heads=c["heads"], num_layers=L,
            config=FFConfig(batch_size=c["max_batch"], compute_dtype=dtype))

    def executor(lm):
        return ServingExecutor(lm, device=device, **geometry)

    def workload():
        return bench.sched_workload(n_req, c["vocab"], c["max_seq"],
                                    c["max_new"])

    def death():
        return ServingFaultInjector(
            engine_raise_at={FLEET["death_at"]: "injected replica death"})

    def real_fleet(lm, w, dies=False):
        return FleetRouter([ScheduledServer(
            executor(lm), *w, decode_steps=8, policy=slo, resilience=budget,
            journal=MemoryJournal(),
            fault_injector=death() if dies and i == 0 else None)
            for i in range(R)], router="least-loaded")

    def sim_fleet(dies=False):
        return FleetRouter.simulated(
            shape, R, router="least-loaded", decode_steps=8, policy=slo,
            resilience=budget, fault_injectors={0: death()} if dies else None)

    launches, walls = {}, {}

    def counted(tag, fn):
        _zero_counts()
        if device == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        if device == "cuda":
            torch.cuda.synchronize()
        walls[tag] = time.perf_counter() - t0
        launches[tag] = _counts()
        return out

    def held(tag, servers):
        """K1f: L a prefill of any replica, fresh or resumed; K6: 2 L k at
        each k's capture, on each replica's engine."""
        pf = sum(1 for s in servers for e in s.span_events
                 if e["ev"] == "prefill")
        ks = sum(sum(set(_decode_ks(s.decisions))) for s in servers)
        _held_launches(f"fleet {tag}", launches[tag],
                       {"flash_attention_lse": L * pf,
                        "flash_decode": 2 * L * ks})

    def same_as_sim(tag, fl, st, sim):
        _r, sst = sim.run(workload())
        _check(sim.decisions == fl.decisions and
               sim.merged_decisions() == fl.merged_decisions() and
               all(a.decisions == b.decisions
                   for a, b in zip(sim.replicas, fl.replicas)) and
               (sst["prefills"], sst["decode_supersteps"], sim.dead) ==
               (st["prefills"], st["decode_supersteps"], fl.dead),
               f"fleet {tag}: the simulated fleet decided otherwise")

    def toks(res):
        return {i: r.tokens for i, r in res.items()}

    ff = model("bfloat16")
    w16 = executor(ff).init(0)
    first_calls, unpatch = _first_calls(torch)
    try:
        # -- (a) two replicas, least-loaded, against one --
        single = ScheduledServer(executor(ff), *w16, decode_steps=8,
                                 policy=slo)
        base, base_st = counted("single", lambda: single.run(workload()))
        fl = real_fleet(ff, w16)
        res, st = counted("a", lambda: fl.run(workload()))
        held("a", fl.replicas)
        same_as_sim("(a)", fl, st, sim_fleet())
        touched = _reprefilled(single, *fl.replicas)
        same = [i for i in res if i not in touched]
        _check(st["completed"] == n and not st["failed"] and
               all(res[i].tokens == base[i].tokens for i in same),
               f"fleet (a): {st['completed']} of {n} completed, or an "
               f"untouched request's tokens differ from one replica's")
        routed = [d["replica"] for d in fl.decisions if d["d"] == "route"]
        print(f"[fleet] (a) {R} replicas, least-loaded, {n} requests "
              f"(routed {[routed.count(i) for i in range(R)]}): decisions, "
              f"merged decisions and dispatches ({st['prefills']} prefills, "
              f"{st['decode_supersteps']} supersteps) equal the simulated "
              f"fleet's; tokens of {len(same)} requests equal one replica's "
              f"({len(touched)} re-prefilled left out); launches "
              f"{ {k: v for k, v in launches['a'].items() if v} }; "
              f"queue wait p99 {st['queue_wait_ms_p99']} against "
              f"{base_st['queue_wait_ms_p99']}, SLO attainment "
              f"{st['slo_attainment']} against {base_st['slo_attainment']} "
              f"(virtual ms)")

        # -- (b) the loss of replica 0, f32 and bf16 --
        ff32 = model("float32")
        w32 = executor(ff32).init(0)
        single32 = ScheduledServer(executor(ff32), *w32, decode_steps=8,
                                   policy=slo)
        base32, _ = counted("single_f32", lambda: single32.run(workload()))
        losses = {}
        for tag, lm, w, ref, ref_srv in (("loss_f32", ff32, w32, base32,
                                          single32),
                                         ("loss", ff, w16, base, single)):
            fl_l = real_fleet(lm, w, dies=True)
            times = {}
            victim, surv = fl_l.replicas[0], fl_l.replicas[1]
            run0, pf1, release = victim.run, surv.engine.prefill, \
                victim.release

            def run_victim(batch, run0=run0, times=times):
                try:
                    return run0(batch)
                except ServingCrashLoop:
                    times["death"] = time.perf_counter()
                    raise

            def timed_release(release=release, times=times):
                t0 = time.perf_counter()
                release()
                times["release"] = time.perf_counter() - t0

            def resumed_prefill(prompt, *a, fl_l=fl_l, pf1=pf1, times=times,
                                **kw):
                out = pf1(prompt, *a, **kw)
                carried = {d["id"] for d in fl_l.decisions
                           if d["d"] == "redistribute" and d["carried"]}
                if "resumed" not in times and kw.get("rid") in carried:
                    times["resumed"] = time.perf_counter()
                return out

            victim.run, surv.engine.prefill = run_victim, resumed_prefill
            victim.release = timed_release
            engine0 = weakref.ref(victim.engine)
            res_l, st_l = counted(tag, lambda: fl_l.run(workload()))
            held(tag, fl_l.replicas)
            same_as_sim(f"(b) {tag}", fl_l, st_l, sim_fleet(dies=True))
            moved = {d["id"] for d in fl_l.decisions
                     if d["d"] == "redistribute"}
            carried = sum(1 for d in fl_l.decisions
                          if d["d"] == "redistribute" and d["carried"])
            _check(fl_l.dead == [0] and st_l["redistributed"] > 0 and
                   victim.engine is None and engine0() is None and
                   st_l["completed"] == n and "resumed" in times,
                   f"fleet (b) {tag}: dead {fl_l.dead}, stats {st_l}")
            differ = sorted(i for i in res_l
                            if res_l[i].tokens != ref[i].tokens)
            untouched = set(res_l) - _reprefilled(ref_srv, *fl_l.replicas)
            if tag == "loss_f32":
                _check(not differ, f"fleet (b) f32: requests {differ} differ "
                                   f"from the unfaulted single replica's")
            else:
                _check(not untouched & set(differ),
                       f"fleet (b) bf16: untouched requests "
                       f"{sorted(untouched & set(differ))} differ")
            losses[tag] = st_l
            print(f"[fleet] (b) {tag.replace('loss', 'replica loss')}: "
                  f"replica 0 dead before its superstep {FLEET['death_at']},"
                  f" {st_l['redistributed']} requests redistributed "
                  f"({carried} with carried tokens), its engine released "
                  f"(and freed) in {times['release'] * 1e3:.1f} ms; "
                  f"decisions equal the "
                  f"simulated fleet's; {len(differ)} of {len(moved)} "
                  f"redistributed requests differ from the unfaulted single "
                  f"replica (untouched ones: none); death to the survivor's "
                  f"first resumed token "
                  f"{(times['resumed'] - times['death']) * 1e3:.1f} ms "
                  f"(the survivor's own queue runs first); launches "
                  f"{ {k: v for k, v in launches[tag].items() if v} }; {card}")

        # -- (c) --serve-auto at a fleet baseline, through the app --
        argv = ["--vocab", str(c["vocab"]), "--d-model", str(c["d_model"]),
                "--heads", str(c["heads"]), "--layers", str(L),
                "--max-seq", str(c["max_seq"]),
                "--max-batch", str(c["max_batch"]),
                "--buckets", ",".join(map(str, c["buckets"])),
                "--requests", str(n), "--prompt-len", f"4:{c['max_seq'] // 4}",
                "--max-new", str(c["max_new"]), "--decode-steps", "8",
                "--dtype", "bfloat16", "--seed", "13", "--workload-trace",
                "--mean-gap-ms", "2", "--burst", str(n_req),
                "--priorities", "2", "--slo-ms", "60", "--serve-auto",
                "--replicas", str(R)]
        auto, buf = {}, io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = counted("serve_auto", lambda: serve_app.main(
                argv, device=device, stats_out=auto))
        lines = buf.getvalue().splitlines()
        chose = next((ln for ln in lines
                      if ln.startswith("serve-auto: chose ")), "")
        epi = next((ln for ln in lines
                    if ln.startswith("serve-auto: predicted e2e")), "")
        _check(rc == 0 and chose and epi, f"fleet (c): exit {rc}\n"
                                          + "\n".join(lines[-20:]))
        pred = int(epi.split("predicted dispatches ")[1].split(",")[0])
        done = int(epi.rsplit("executed ", 1)[1])
        by_src = {}
        for d in auto.get("merged_decisions", auto["decisions"]):
            if d["d"] == "decode":
                by_src.setdefault(d.get("src"), set()).add(d["k"])
        _held_launches("fleet (c)", launches["serve_auto"], {
            "flash_attention_lse": L * auto["prefills"],
            "flash_decode": 2 * L * sum(sum(ks) for ks in by_src.values())})
        _check(pred == done == auto["prefills"] + auto["decode_supersteps"],
               f"fleet (c): predicted {pred}, executed {done}")
        print(f"[fleet] (c) {chose}")
        print(f"[fleet] (c) {epi}; {card}")

        # -- (d) wall time, first calls, the bench's columns --
        print(f"[fleet] (d) wall: a fleet run {walls['a'] * 1e3:.1f} ms, one "
              f"replica {walls['single'] * 1e3:.1f} ms (replicas run in turn "
              f"on one card), the bf16 loss run {walls['loss'] * 1e3:.1f} ms;"
              f" {card}")
        for i, srv in enumerate(fl.replicas):
            rows = sorted(first_calls.get(srv.engine, {}).items())
            print(f"[fleet] (d) replica {i} first calls (eager + capture): "
                  + ", ".join(f"k={k} {p['first_call_s'] * 1e3:.1f} ms "
                              f"{p['bytes']} bytes"
                              for (_kind, k), p in rows))
        print("[fleet] bench columns (virtual ms, model defaults): "
              + json.dumps(bench.fleet_columns(st, losses["loss"], base_st)))
    finally:
        unpatch()
    return launches


#: Phase 27: the configurations of (b), each a world of 2 on phase 5's
#: command line; ``fault`` drops the gradient all-reduce (a rank trains
#: on its half of the batch), a planted fault the bars must catch.  The
#: bars against the world of 1: the losses, relative, for bf16 gradients
#: summed as two half-batch partial sums (each rounded to bf16 before the
#: all-reduce) where one rank rounds the whole batch's once; the trained
#: parameters' distance from the world of 1's over the size of its change
#: (both L2 over every parameter).  Every rank's parameters must also be
#: equal bit for bit.  On one H100 over gloo, sound runs read loss gaps
#: of 1.97e-5 to 2.24e-5 and distances of 0.0092 to 0.0164, the fault
#: 6.24e-5 and 0.0934: the loss bar alone does not catch it, the
#: distance bar and the ranks' disagreement do (PERF.md, the mesh).
#: ``gloo_skip``: the configurations a one-card run leaves out (a run on
#: two or more cards holds them over NCCL).
MESH = dict(gloo_skip=("tp2", "zero"),
            configs=[dict(name="dp2", dp=2, tp=1),
                     dict(name="tp2", dp=1, tp=2),
                     dict(name="zero", dp=2, tp=1, zero=True),
                     dict(name="fault", dp=2, tp=1, fault=True)],
            cnn_tables={"dp": {},
                        "tp": {"fc1": dict(n=2, c=2), "fc2": dict(n=2, c=2)},
                        "spatial": {"conv1": dict(h=2, w=2),
                                    "pool1": dict(n=2, h=2)},
                        "hybrid": {"conv1": dict(n=2, c=2), "fc1": dict(c=4),
                                   "fc2": dict(n=4)}})
TOL_MESH_LOSS = 1e-4
TOL_MESH_DIST = 0.04
#: (c)'s bar, the CPU tests' (tests/test_torch_sharding.py).
TOL_MESH_CNN = (2e-4, 1e-5)


def mesh_attention_hold(torch, kernels, shape, causal: bool = True,
                        dtype: str = "bfloat16") -> dict:
    """K1f and K1b (with a nonzero lse cotangent) at ``shape`` against
    their plain versions by phase 2's element rules; raises on a miss.
    Returns the worst elements' shares of their tolerances."""
    g = torch.Generator(device="cuda").manual_seed(27)
    dt = getattr(torch, dtype)
    q, k, v, do = (torch.randn(shape, generator=g, device="cuda").to(dt)
                   for _ in range(4))
    g_lse = torch.randn(shape[:3], generator=g, device="cuda")
    o, lse = kernels.flash_attention_lse(q, k, v, causal)
    po, plse = kernels.flash_attention_lse_plain(q, k, v, causal)
    fwd = _flash_fwd_close(kernels, q, k, v, causal, o, po)
    got = kernels.flash_attention_lse_bwd(q, k, v, po, plse, do, g_lse,
                                          causal)
    want = kernels.flash_attention_lse_bwd_plain(q, k, v, po, plse, do,
                                                 g_lse, causal)
    rtol, arel, atop = TOL_ELEM["stream_bwd"][dtype]
    mass = _flash_bwd_mass(q, k, v, po, plse, do, g_lse, causal)
    tops = _flash_bwd_top(q, k, v, po, plse, do, g_lse, causal)
    bwd = max(_close(a, w, m, rtol, arel, tp, atop)
              for a, w, m, tp in zip(got, want, mass, tops))
    lse_err = (lse - plse).abs().max().item()
    _check(fwd <= 1.0 and bwd <= 1.0 and lse_err <= TOL_LSE,
           f"mesh: K1f/K1b at {shape} {dtype} causal={causal}: forward "
           f"{fwd}, backward {bwd} of the element tolerance, lse err "
           f"{lse_err}")
    return dict(k1f=fwd, k1b=bwd, lse=lse_err)


def mesh_xent_hold(torch, kernels, n: int, v: int) -> dict:
    """K3 forward and backward (bf16, the chooser's form) at ``(n, v)``
    against the plain versions by phase 2's rules; raises on a miss."""
    g = torch.Generator(device="cuda").manual_seed(28)
    x, labels, _ = _xent_inputs(torch, g, n, v, "bfloat16")
    gn = torch.full((n,), 1.0 / n, device="cuda")
    gl = torch.randn((n,), generator=g, device="cuda")
    errs, _ = _xent_hold(torch, kernels, x, labels, gn, gl)
    _xent_held(errs, f"mesh: softmax_xent ({n}, {v})")
    return {k: errs[k] for k in ("nll", "lse", "dlogits", "pred")}


def _mesh_times(torch, kernels, F, attn, n: int, v: int) -> dict:
    """K1f, K1b and K3 (forward and backward) timed at a rank's local
    shapes beside their plain versions, one library call and the bound."""
    g = torch.Generator(device="cuda").manual_seed(29)
    q, k, vv, do = (torch.randn(attn, generator=g, device="cuda")
                    .to(torch.bfloat16) for _ in range(4))
    g_lse = torch.randn(attn[:3], generator=g, device="cuda")
    o, lse = kernels.flash_attention_lse(q, k, vv, True)
    b, h, t, hd = attn
    pairs = t * (t + 1) // 2
    rows = {}
    rows["flash_attention_lse"] = dict(
        ms=_device_ms(lambda: kernels.flash_attention_lse(q, k, vv, True)),
        plain_ms=_device_ms(lambda: kernels.flash_attention_lse_plain(
            q, k, vv, True)),
        library_ms=_device_ms(lambda: F.scaled_dot_product_attention(
            q, k, vv, is_causal=True)))
    rows["flash_attention_lse"].update(zip(("bound_ms", "bound_by"), _bound_ms(
        4 * b * h * t * hd * 2 + b * h * t * 4, 4 * b * h * hd * pairs,
        "bfloat16")))
    qs, ks, vs = (x.detach().clone().requires_grad_(True) for x in (q, k, vv))
    out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
    rows["flash_attention_lse_bwd"] = dict(
        ms=_device_ms(lambda: kernels.flash_attention_lse_bwd(
            q, k, vv, o, lse, do, g_lse, True)),
        plain_ms=_device_ms(lambda: kernels.flash_attention_lse_bwd_plain(
            q, k, vv, o, lse, do, g_lse, True)),
        library_ms=_device_ms(lambda: torch.autograd.grad(
            out, (qs, ks, vs), do, retain_graph=True)))
    rows["flash_attention_lse_bwd"].update(zip(
        ("bound_ms", "bound_by"), _bound_ms(
            8 * b * h * t * hd * 2 + 2 * b * h * t * 4,
            10 * b * h * hd * pairs, "bfloat16")))
    del q, k, vv, do, o, qs, ks, vs, out
    x = (3.0 * torch.randn((n, v), generator=g, device="cuda")).to(
        torch.bfloat16)
    labels = torch.randint(0, v, (n,), generator=g, device="cuda",
                           dtype=torch.int32)
    gn = torch.full((n,), 1.0 / n, device="cuda")
    gl = torch.randn((n,), generator=g, device="cuda")
    _, xlse, _ = kernels.softmax_xent(x, labels)
    lab64 = labels.long()
    rows["softmax_xent"] = dict(
        ms=_device_ms(lambda: kernels.softmax_xent(x, labels)),
        plain_ms=_device_ms(lambda: kernels.softmax_xent_plain(x, labels)),
        library_ms=_device_ms(lambda: F.cross_entropy(x, lab64,
                                                      reduction="none")))
    rows["softmax_xent"].update(zip(("bound_ms", "bound_by"), _bound_ms(
        n * v * 2 + 16 * n, 4 * n * v, "float32")))
    xr = x.detach().clone().requires_grad_(True)
    ce = F.cross_entropy(xr, lab64, reduction="none")
    rows["softmax_xent_bwd"] = dict(
        ms=_device_ms(lambda: kernels.softmax_xent_bwd(x, labels, xlse, gn,
                                                       gl)),
        plain_ms=_device_ms(lambda: kernels.softmax_xent_bwd_plain(
            x, labels, xlse, gn, gl)),
        library_ms=_device_ms(lambda: torch.autograd.grad(
            ce, xr, gn.to(ce.dtype), retain_graph=True)))
    rows["softmax_xent_bwd"].update(zip(("bound_ms", "bound_by"), _bound_ms(
        2 * n * v * 2 + 16 * n, 4 * n * v, "float32")))
    for name, r in rows.items():
        print(f"[mesh] {name} at the dp 2 rank's shape "
              f"{attn if 'flash' in name else (n, v)} bf16: {r['ms']:.4f} ms "
              f"(plain {r['plain_ms']:.4f}, library {r['library_ms']:.4f}, "
              f"bound {r['bound_ms']:.5f} by {r['bound_by']})")
    return rows


def _mesh_lm_world(configs, nprocs: int, cards: int, one, ref_path) -> dict:
    """Phase 27 (b): phase 5's command line through ``apps.transformer``
    under each of ``configs`` on a world of ``nprocs`` ranks (NCCL, a card
    each, when there are as many cards; else gloo on shared cards), held
    rank by rank against the world of 1 ``one``; returns ``{path:
    launches summed over the ranks}``.  A ``fault`` configuration must
    fail the bars."""
    from flexflow_torch.parallel import launch

    backend = "nccl" if cards >= nprocs else "gloo"
    ranks = launch.run("flexflow_torch.tools.mesh_smoke:chip_app",
                       (configs, _train_argv(TRAIN), ref_path),
                       nprocs=nprocs, device="cuda",
                       backend=None if backend == "nccl" else "gloo",
                       timeout_s=900)
    L, steps = TRAIN["layers"], TRAIN["warmup"] + TRAIN["iters"]
    want_counts = dict(flash_attention_lse=L * steps,
                       flash_attention_lse_bwd=L * steps,
                       softmax_xent=steps, softmax_xent_bwd=steps)
    b, t, h = TRAIN["batch"], TRAIN["seq"], TRAIN["heads"]
    hd, v = TRAIN["d_model"] // h, TRAIN["vocab"]
    launches = {}
    for i, c in enumerate(configs):
        bl = b // c["dp"]
        want_shapes = {"flash_attention_lse_auto": [(bl, h, t, hd)],
                       "softmax_xent": [(bl * t, v)]}
        what = f"mesh (b) {c['name']} on {nprocs} ranks"
        res = [r[i] for r in ranks]
        gaps = [max(abs(a - w) / abs(w) for a, w in zip(got["losses"],
                                                         one["losses"]))
                for got in res]
        agree = all(got["digest"] == res[0]["digest"] for got in res)
        dist_ = max(got["distance"] for got in res)
        caught = [name for name, on in (
            ("loss", max(gaps) > TOL_MESH_LOSS),
            ("distance", dist_ > TOL_MESH_DIST),
            ("ranks disagree", not agree)) if on]
        print(f"[mesh] (b) {c['name']} ({backend}): loss gap to the world of "
              f"1 {max(gaps):.3g} (bar {TOL_MESH_LOSS}), parameter distance "
              f"{dist_:.3g} of the change (bar {TOL_MESH_DIST}), ranks' "
              f"parameters {'equal' if agree else 'differ'}")
        if c.get("fault"):
            _check("distance" in caught and "ranks disagree" in caught,
                   f"{what}: the planted fault (no gradient all-reduce) is "
                   f"caught by {caught} only")
            print(f"[mesh] (b) {c['name']}: the planted fault is caught by "
                  f"{', '.join(caught)}")
            continue
        _check(not caught, f"{what}: {', '.join(caught)} (losses "
               f"{[got['losses'] for got in res]} vs {one['losses']})")
        path = launches.setdefault(f"mesh_{c['name']}", {})
        for r, got in enumerate(res):
            what = f"mesh (b) {c['name']} rank {r} of {nprocs}"
            _check(got["code"] == 0 and got["backend"] == backend
                   and not got["jax_imported"],
                   f"{what}: exit {got['code']}, backend {got['backend']}, "
                   f"jax imported {got['jax_imported']}")
            _check(got["counts"] == want_counts,
                   f"{what}: launch counts {got['counts']}, expected "
                   f"{want_counts}")
            _check(got["shapes"] == want_shapes,
                   f"{what}: kernel shapes {got['shapes']}, expected "
                   f"{want_shapes}")
            _check(got["losses"][-1] < got["losses"][0]
                   and got["report"].count("THROUGHPUT = ") == 1
                   and got["report"].count("tokens/s = ") == 1
                   and abs(got["samples"] - b * TRAIN["iters"]) < 1e-6 * b,
                   f"{what}: losses {got['losses']}, {got['samples']} "
                   f"samples counted, report {got['report']!r}")
            if c.get("zero"):
                _check(got["lm_head_moments"]["kernel"] == (v // 2,
                                                            TRAIN["d_model"]),
                       f"{what}: lm_head moments {got['lm_head_moments']}")
            share = got["comm_ms"] / got["one_step_ms"]
            print(f"[mesh] (b) {c['name']} rank {r} of {nprocs} ({backend}, "
                  f"cuda:{got['device']}): losses "
                  f"{[round(x, 5) for x in got['losses']]}, "
                  f"{got['ms_step']:.3f} ms/step (the app's), collectives "
                  f"{got['comm_ms']:.3f} of {got['one_step_ms']:.3f} ms in a "
                  f"step with each one synchronised alone "
                  f"({100 * share:.1f}%); holds "
                  + "; ".join(f"{k}: " + ", ".join(
                      f"{n} {x:.3g}" for n, x in e.items())
                      for k, e in got["holds"].items()))
            for k, n in got["counts"].items():
                path[k] = path.get(k, 0) + n
        print(f"[mesh] (b) {c['name']}: launches per rank {want_counts}")
    return launches


def phase_mesh(torch, kernels, F):
    """Phase 27 (module docstring).  Returns ``(rows, launches)``: the
    kernels' rows at dp 2's local shapes and ``{path: counts}`` summed
    over each world's ranks."""
    import os
    import shutil
    import tempfile

    import numpy as np

    from flexflow_torch.apps import transformer
    from flexflow_torch.parallel import launch
    from flexflow_torch.tools import mesh_smoke as ms

    torch.cuda.empty_cache()
    cards = torch.cuda.device_count()
    tmp = tempfile.mkdtemp(prefix="ff_mesh_")
    ref_path = os.path.join(tmp, "ref.pt")
    try:
        # (a) the app in this process (the plain Executor), its parameters
        # the reference of every world; then the app on a world of 1.
        plain = {}
        _check(transformer.main(_train_argv(TRAIN), device="cuda",
                                stats_out=plain) == 0, "mesh (a): the app")
        ex = plain.pop("executor")
        full = {"trained": plain.pop("final")[0], "init": ex.init()[0]}
        torch.save({n: {op: {k: v.detach().float().cpu()
                             for k, v in g.items()} for op, g in tr.items()}
                    for n, tr in full.items()}, ref_path)
        want = ms.digest(full["trained"])
        del ex, full
        torch.cuda.empty_cache()
        one = launch.run("flexflow_torch.tools.mesh_smoke:chip_app",
                         ([dict(name="one", dp=1, tp=1)], _train_argv(TRAIN),
                          ref_path), nprocs=1, device="cuda",
                         timeout_s=600)[0][0]
        diff = sorted(k for k in want if want[k] != one["digest"].get(k))
        _check(one["code"] == 0 and one["losses"] == plain["step_losses"]
               and not diff and one["distance"] == 0.0,
               f"mesh (a): the app on a world of 1 differs from the plain "
               f"Executor: losses {one['losses']} vs {plain['step_losses']},"
               f" parameters {diff[:5]}")
        print(f"[mesh] (a) apps.transformer on a world of 1 ({one['backend']}"
              f"): {len(one['losses'])} steps' losses "
              f"{[round(x, 5) for x in one['losses']]} and all {len(want)} "
              f"parameters bit for bit the plain Executor's")
        # (b) worlds of 2; with four cards also dp 2 x tp 2 on a world of
        # 4; with two, the app's own world (-ll:gpu 2 from this process).
        configs = [c for c in MESH["configs"]
                   if cards >= 2 or c["name"] not in MESH["gloo_skip"]]
        launches = _mesh_lm_world(configs, 2, cards, one, ref_path)
        if cards >= 4:
            launches.update(_mesh_lm_world([dict(name="dp2tp2", dp=2, tp=2)],
                                           4, cards, one, ref_path))
        if cards >= 2:
            st = {}
            rc = transformer.main(_train_argv(TRAIN) + [
                "-ll:gpu", "2", "--dp", "2"], device="cuda", stats_out=st)
            gap = max(abs(a - w) / abs(w) for a, w in zip(st["step_losses"],
                                                           one["losses"]))
            _check(rc == 0 and gap <= TOL_MESH_LOSS,
                   f"mesh (b): apps.transformer -ll:gpu 2 --dp 2 exit {rc}, "
                   f"losses {st['step_losses']} vs {one['losses']}")
            print(f"[mesh] (b) apps.transformer -ll:gpu 2 --dp 2 spawning its"
                  f" own NCCL world: losses "
                  f"{[round(x, 5) for x in st['step_losses']]}, gap "
                  f"{gap:.3g}, {st['samples_per_s'] * TRAIN['seq']:.0f} "
                  f"tokens/s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    b, t, h = TRAIN["batch"], TRAIN["seq"], TRAIN["heads"]
    hd, v = TRAIN["d_model"] // h, TRAIN["vocab"]
    rows = _mesh_times(torch, kernels, F, (b // 2, h, t, hd), b // 2 * t, v)
    # (c) the small CNN's tables in f32 on 4 ranks of CUDA tensors.
    rng = np.random.default_rng(42)
    batches = [{"x": rng.standard_normal((8, 8, 8, 4)).astype(np.float32),
                "lbl": rng.integers(0, 4, size=(8,)).astype(np.int32)}
               for _ in range(3)]
    p0 = ms._numpy(ms.executor_for({"model": "small_cnn",
                                    "device": "cuda"})[1].init()[0])
    cases = [dict(model="small_cnn", table=tb, batches=batches, params=p0,
                  device="cuda") for tb in MESH["cnn_tables"].values()]
    want = ms.train_case(dict(cases[0], table={}))
    got = launch.run("flexflow_torch.tools.mesh_smoke:run_cases", (cases,),
                     nprocs=4, device="cuda",
                     backend=None if cards >= 4 else "gloo", timeout_s=600)
    rtol, atol = TOL_MESH_CNN
    for name, res in zip(MESH["cnn_tables"], got[0]):
        np.testing.assert_allclose(res["losses"], want["losses"], rtol=rtol,
                                   atol=atol, err_msg=f"mesh (c) {name}")
        err = 0.0
        for op, gr in want["params"].items():
            for k, w in gr.items():
                np.testing.assert_allclose(res["params"][op][k], w,
                                           rtol=rtol, atol=atol,
                                           err_msg=f"mesh (c) {name} {op}.{k}")
                err = max(err, float(np.abs(res["params"][op][k] - w).max()))
        print(f"[mesh] (c) small CNN f32, {name} table on 4 ranks "
              f"({'nccl' if cards >= 4 else 'gloo'}): losses "
              f"{[round(x, 6) for x in res['losses']]}, worst parameter "
              f"difference from one rank {err:.3g} (bar rtol {rtol}, atol "
              f"{atol})")
    return rows, launches


#: Phase 28: the DLRM of phase 9 on worlds of ranks.  ``arms``: (name,
#: optimizer flags, timed iterations, K4 / ``gather_rows_multi`` / K5
#: launches a step); the dense arm all-reduces the replicated tables'
#: 2 GB gradient every step (on one card over gloo, through the host), so
#: it runs fewer steps.  ``tables``: the ``-s`` tables of (b).
MESH_DLRM = dict(
    arms=(("sgd", ("sgd", ()), None, (1, 0, 1)),
          ("lazy", ("adam", ("--lazy-sparse-opt",)), None, (2, 1, 3)),
          ("dense", ("sgd", ("--momentum", "0.9")), 2, (0, 0, 0))),
    tables={"rep": {"embeddings": {"n": 2}},
            "shard": {"embeddings": {"c": 2}},
            "rep4": {"embeddings": {"n": 4}},
            "shard4": {"embeddings": {"c": 4}}},
    faults=("no_all_reduce", "no_window"))
#: The dense arm's sharded tables against the replicated ones, in units in
#: the last place (the JAX package's own bar for its sharded tables): the
#: replicated tables' gradient is two ranks' partial sums all-reduced, the
#: sharded tables' one masked backward over the whole batch (their op is
#: not split on ``n``), so the f32 sums differ in order.  The row-sparse
#: arms sum each row's updates in batch order either way: bit for bit.
TOL_MESH_DLRM_ULP = 4


def dlrm_reference(torch, params, losses, c=None) -> dict:
    """Phase 9's plain SGD run as phase 28 (a) reads it: its losses, its
    dense parameters and the batch's rows of its tables (the app's fixed
    synthetic batch, ids in {0, 1})."""
    import numpy as np

    from flexflow_torch.data.loader import synthetic_host_batch

    c = c or DLRM
    ff, _ = _dlrm_model(c["batch"], c["vocab"], "bfloat16", c["seed"], c)
    ids = synthetic_host_batch(ff, np.random.default_rng(0))["sparse_input"]
    rows = np.unique(np.arange(c["tables"])[None, :] * c["vocab"] + ids)
    flat = params["embeddings"]["tables"].reshape(-1, c["dim"])
    return dict(losses=list(losses), rows=rows.tolist(),
                trained_rows=flat[torch.as_tensor(rows, device=flat.device)]
                .detach().cpu().numpy(),
                dense={op: {k: v.detach().float().cpu().numpy()
                            for k, v in g.items()}
                       for op, g in params.items() if op != "embeddings"})


def _ulps(a, b) -> int:
    """The most units in the last place between two f32 arrays."""
    import numpy as np

    def key(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(2 ** 31) - i, i)

    d = np.abs(key(a) - key(b))
    return int(d.max()) if d.size else 0


def _world_rows(res) -> dict:
    """``{flat row: trained row}`` of the batch's rows, from each rank's
    window."""
    out = {}
    for r in res:
        out.update(zip(r["rows"], r["trained_rows"]))
    return out


def _mesh_dlrm_gap(res, one) -> tuple:
    """(the worst loss gap to ``one`` over the ranks, the parameters'
    distance from ``one``'s over ``one``'s change): dense parameters and
    the batch's table rows, the only rows that move."""
    import numpy as np

    gap = max(max(abs(a - w) / abs(w) for a, w in zip(r["losses"],
                                                      one["losses"]))
              for r in res)
    got, want = _world_rows(res), dict(zip(one["rows"], one["trained_rows"]))
    init = dict(zip(one["rows"], one["init_rows"]))
    num = sum(float(np.square(got[k].astype(np.float64) - want[k]).sum())
              for k in want)
    den = sum(float(np.square(want[k].astype(np.float64) - init[k]).sum())
              for k in want)
    for op, g in one["dense"].items():
        for k, w in g.items():
            num += float(np.square(res[0]["dense"][op][k].astype(np.float64)
                                   - w).sum())
            den += float(np.square(w.astype(np.float64)
                                   - one["init_dense"][op][k]).sum())
    return gap, (num / den) ** 0.5


def _mesh_dlrm_world(nprocs: int, configs, device: str, backend):
    """``mesh_smoke.dlrm_app`` under ``configs`` on a world of
    ``nprocs``: ``{name: [rank results]}``."""
    from flexflow_torch.parallel import launch

    ranks = launch.run("flexflow_torch.tools.mesh_smoke:dlrm_app",
                       (configs, [], device), nprocs=nprocs, device=device,
                       backend=backend, timeout_s=900)
    return {cfg["name"]: [r[i] for r in ranks]
            for i, cfg in enumerate(configs)}


def _held_rank(what, got, shape, want_counts, backend) -> None:
    _check(got["code"] == 0 and not got["jax_imported"]
           and got["backend"] == backend and got["local_shape"] == shape
           and got["counts"] == want_counts and got["only_batch_rows"]
           and got["batch_rows_moved"]
           and got["moments_only_batch"] in (None, True)
           and got["report"].count("THROUGHPUT = ") == 1,
           f"{what}: exit {got['code']}, backend {got['backend']}, local "
           f"table {got['local_shape']} (want {shape}), launches "
           f"{got['counts']} (want {want_counts}), only the batch's rows "
           f"moved {got['only_batch_rows']}, all of them "
           f"{got['batch_rows_moved']}, moments {got['moments_only_batch']}")


def _dlrm_window_kernels(torch, kernels, F, c, launches) -> dict:
    """Windowed K4, K4 over three tables and K5 at a c=2 rank's shapes
    (rank 1: rows [T/2 V, T V) of the flat tables, the step's 2048 ids):
    each held bit for bit against its plain version and timed beside it,
    ``F.embedding`` with the mask (K4's) or ``index_add_`` on the window
    (K5's), and the bound of the bytes this run's ids need."""
    import numpy as np

    from flexflow_torch.data.loader import synthetic_host_batch

    g = torch.Generator(device="cuda").manual_seed(28)
    T, V, D = c["tables"], c["vocab"], c["dim"]
    R, start = T // 2 * V, T // 2 * V
    ff, _ = _dlrm_model(c["batch"], V, "bfloat16", c["seed"], c)
    host = synthetic_host_batch(ff, np.random.default_rng(0))["sparse_input"]
    ids = (torch.arange(T, device="cuda")[None, :] * V
           + torch.as_tensor(host, device="cuda").long()).reshape(-1)
    n = ids.shape[0]
    table = torch.randn((R, D), generator=g, device="cuda")
    loc = ids - start
    ok = (loc >= 0) & (loc < R)
    m_in = int(ok.sum())
    uniq = torch.unique(ids)
    safe = torch.cat([uniq, uniq.new_zeros(n - uniq.numel())])
    u_in = int(((uniq >= start) & (uniq < start + R)).sum())
    rows = {}

    def exact(what, got, want):
        same = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                   for a, b in zip(got, want))
        _check(same, f"mesh-dlrm: windowed {what} differs from its plain "
               f"version")
        return max(float((a - b).abs().max()) for a, b in zip(got, want))

    err = exact("gather_rows", [kernels.gather_rows(table, ids, start)],
                [kernels.gather_rows_plain(table, ids, start)])

    def masked_embedding():
        r = F.embedding(torch.where(ok, loc, 0), table)
        return torch.where(ok[:, None], r, 0.0)

    rows["gather_rows"] = dict(
        max_abs_err=err,
        ms=_device_ms(lambda: kernels.gather_rows(table, ids, start)),
        plain_ms=_device_ms(lambda: kernels.gather_rows_plain(table, ids,
                                                              start)),
        library_ms=_device_ms(masked_embedding))
    rows["gather_rows"].update(zip(("bound_ms", "bound_by"), _bound_ms(
        n * 8 + (u_in + n) * D * 4, 0.0, "float32")))
    three = (table, table.neg(), table * 0.5)
    err = exact("gather_rows_multi",
                kernels.gather_rows_multi(three, safe, start),
                kernels.gather_rows_multi_plain(three, safe, start))
    rows["gather_rows_multi"] = dict(
        max_abs_err=err,
        ms=_device_ms(lambda: kernels.gather_rows_multi(three, safe, start)),
        plain_ms=_device_ms(lambda: kernels.gather_rows_multi_plain(
            three, safe, start)), library_ms=None)
    in_slots = int(((safe >= start) & (safe < start + R)).sum())
    rows["gather_rows_multi"].update(zip(("bound_ms", "bound_by"), _bound_ms(
        n * 8 + 3 * (in_slots + n) * D * 4, 0.0, "float32")))
    del three
    upd = torch.randn((n, D), generator=g, device="cuda")
    a, b = table.clone(), table.clone()
    kernels.scatter_add_rows(a, ids, upd, start)
    kernels.scatter_add_rows_plain(b, ids, upd, start)
    err = exact("scatter_add_rows", [a], [b])
    del a, b
    work = table.clone()
    loc_in, upd_in = loc[ok], upd[ok]
    rows["scatter_add_rows"] = dict(
        max_abs_err=err,
        ms=_device_ms(lambda: kernels.scatter_add_rows(work, ids, upd,
                                                       start)),
        plain_ms=_device_ms(lambda: kernels.scatter_add_rows_plain(
            work, ids, upd, start)),
        library_ms=_device_ms(lambda: work.index_add_(0, loc_in, upd_in)))
    rows["scatter_add_rows"].update(zip(("bound_ms", "bound_by"), _bound_ms(
        n * 8 + m_in * D * 4 + 2 * u_in * D * 4, 0.0, "float32")))
    del work, table
    torch.cuda.empty_cache()
    card = _card()
    reads = {"gather_rows": f"the step's; {m_in} in the window, {u_in} "
                            f"distinct rows",
             "gather_rows_multi": f"the lazy step's {uniq.numel()} unique "
                                  f"rows padded; {in_slots} in the window",
             "scatter_add_rows": f"the step's, with their updates; {m_in} "
                                 f"in the window onto {u_in} distinct rows"}
    for name, r in rows.items():
        r["launches"] = sum(counts.get(name, 0) for counts in
                            launches.values())
        r["shape"] = (f"a c=2 rank's window: ({R}, {D}) f32, rows "
                      f"[{start}, {start + R}), {n} int64 ids "
                      f"({reads[name]})")
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.6f}"
        print(f"[mesh-dlrm] windowed {name} at {r['shape']}: {r['ms']:.6f} "
              f"ms (plain {r['plain_ms']:.6f}, library {lib}, bound "
              f"{r['bound_ms']:.3e} by {r['bound_by']}), {r['launches']} "
              f"launches on the mesh runs, bit for bit its plain version; "
              f"{card}")
    return rows


def phase_mesh_dlrm(torch, kernels, F, ref=None, c=None, device="cuda"):
    """Phase 28 (module docstring).  ``ref`` is phase 9's plain SGD run
    (:func:`dlrm_reference`; None: the app runs it here).  Returns
    ``(rows, launches)``: the windowed kernels' rows and ``{path: counts}``
    summed over each world's ranks.  ``c`` and ``device="cpu"`` rehearse
    it at a smaller width on CPU ranks (no kernel rows then)."""
    import numpy as np

    from flexflow_torch.apps import dlrm

    c = c or DLRM
    cuda = device == "cuda"
    if cuda:
        torch.cuda.empty_cache()
    cards = torch.cuda.device_count() if cuda else 0
    card = _card() if cuda else "cpu"
    T, V, D = c["tables"], c["vocab"], c["dim"]
    arms = {name: (_dlrm_argv(opt, extra, iters, c), (iters or c["iters"])
                   + c["warmup"], per) for name, (opt, extra), iters, per
            in MESH_DLRM["arms"]}

    def want_counts(name):
        k4, multi, k5 = arms[name][2]
        steps = arms[name][1]
        return {k: v for k, v in (("gather_rows", k4 * steps),
                                  ("gather_rows_multi", multi * steps),
                                  ("scatter_add_rows", k5 * steps)) if v} \
            if cuda else {}

    if ref is None:
        st = {}
        _check(dlrm.main(arms["sgd"][0], device=device, stats_out=st) == 0,
               "mesh-dlrm: the plain app")
        ref = dlrm_reference(torch, st.pop("final")[0], st["step_losses"], c)
        del st
    # (a) a world of 1, every arm from one draw.
    one = _mesh_dlrm_world(1, [dict(name=n, table=None, extra=a[0])
                               for n, a in arms.items()], device,
                           None if cuda else "gloo")
    launches = {}
    sgd = one["sgd"][0]
    diff = [k for k, v in zip(ref["rows"], ref["trained_rows"])
            if not np.array_equal(_world_rows([sgd]).get(k), v)]
    diff += [f"{op}.{k}" for op, g in ref["dense"].items()
             for k, v in g.items() if not np.array_equal(sgd["dense"][op][k],
                                                         v)]
    _check(sgd["losses"] == ref["losses"] and not diff
           and sgd["only_batch_rows"],
           f"mesh-dlrm (a): the app on a world of 1 differs from phase 9's "
           f"plain run: losses {sgd['losses']} vs {ref['losses']}, "
           f"parameters {diff[:5]}")
    for name, res in one.items():
        _held_rank(f"mesh-dlrm (a) {name}", res[0], (T, V, D),
                   want_counts(name), res[0]["backend"])
        launches[f"mesh_dlrm_one_{name}"] = res[0]["counts"]
    print(f"[mesh-dlrm] (a) apps.dlrm -ll:gpu 1: plain SGD's "
          f"{len(sgd['losses'])} losses, dense parameters and the batch's "
          f"{len(ref['rows'])} table rows bit for bit phase 9's, no other "
          f"row moved; {card}")
    # (b) worlds of 2 under each table, (c) the planted faults.
    backend = "nccl" if cards >= 2 else "gloo"
    configs = [dict(name=f"{arm}_{tab}", table=MESH_DLRM["tables"][tab],
                    extra=arms[arm][0])
               for arm in arms for tab in ("rep", "shard")]
    configs += [dict(name=f, table=MESH_DLRM["tables"]["shard"],
                     extra=arms["sgd"][0], fault=f)
                for f in MESH_DLRM["faults"]]
    two = _mesh_dlrm_world(2, configs, device,
                           None if backend == "nccl" else "gloo")
    for arm in arms:
        rep, shard = two[f"{arm}_rep"], two[f"{arm}_shard"]
        ulp = max(_ulps(_world_rows(rep)[k], v)
                  for k, v in _world_rows(shard).items())
        ulp_dense = max(_ulps(rep[0]["dense"][op][k], v)
                        for op, g in shard[0]["dense"].items()
                        for k, v in g.items())
        bar = 0 if arm != "dense" else TOL_MESH_DLRM_ULP
        _check(_world_rows(rep).keys() == _world_rows(shard).keys()
               and ulp <= bar and ulp_dense <= bar,
               f"mesh-dlrm (b) {arm}: the sharded tables differ from the "
               f"replicated ones by {ulp} ULP, the dense parameters by "
               f"{ulp_dense} (bar {bar})")
        for tab, res in (("rep", rep), ("shard", shard)):
            what = f"mesh-dlrm (b) {arm} {tab}"
            shape = (T, V, D) if tab == "rep" else (T // 2, V, D)
            for r, got in enumerate(res):
                _held_rank(f"{what} rank {r}", got, shape, want_counts(arm),
                           backend)
            _check(all(got["dense_digest"] == res[0]["dense_digest"]
                       for got in res)
                   and (tab == "shard" or all(
                       np.array_equal(a, b) for a, b in zip(
                           res[0]["trained_rows"], res[1]["trained_rows"]))),
                   f"{what}: the ranks' replicated parameters differ")
            gap, dist_ = _mesh_dlrm_gap(res, one[arm][0])
            _check(gap <= TOL_MESH_LOSS and dist_ <= TOL_MESH_DIST,
                   f"{what}: loss gap {gap:.3g} (bar {TOL_MESH_LOSS}), "
                   f"distance {dist_:.3g} (bar {TOL_MESH_DIST}) from (a)")
            launches[f"mesh_dlrm_{arm}_{tab}"] = {
                k: sum(got["counts"].get(k, 0) for got in res)
                for k in ("gather_rows", "gather_rows_multi",
                          "scatter_add_rows")}
            for r, got in enumerate(res):
                print(f"[mesh-dlrm] (b) {arm} {tab} rank {r} of 2 "
                      f"({backend}): losses "
                      f"{[round(x, 6) for x in got['losses']]}, table "
                      f"{got['local_shape']} rows [{got['window'][0]}, "
                      f"{sum(got['window'])}), {got['ms_step']:.3f} ms/step "
                      f"(the app's), collectives {got['comm_ms']:.3f} of "
                      f"{got['one_step_ms']:.3f} ms in one more step "
                      f"({100 * got['comm_ms'] / got['one_step_ms']:.1f}%),"
                      f" peak memory {got['peak_gb']} GB, launches "
                      f"{got['counts']}; {card}")
            print(f"[mesh-dlrm] (b) {arm} {tab}: loss gap to (a) {gap:.3g}, "
                  f"parameter distance {dist_:.3g} of the change")
        print(f"[mesh-dlrm] (b) {arm}: the sharded tables {ulp} ULP from "
              f"the replicated ones (bar {bar}), the dense parameters "
              f"{ulp_dense}")
    for fault in MESH_DLRM["faults"]:
        res, rep = two[fault], two["sgd_rep"]
        gap, dist_ = _mesh_dlrm_gap(res, one["sgd"][0])
        got, want = _world_rows(res), _world_rows(rep)
        caught = [name for name, on in (
            ("table", got.keys() != want.keys() or any(
                not np.array_equal(got[k], want[k]) for k in want)),
            ("loss", gap > TOL_MESH_LOSS), ("distance", dist_ > TOL_MESH_DIST),
            ("ranks disagree", res[0]["dense_digest"]
             != res[1]["dense_digest"])) if on]
        _check("table" in caught, f"mesh-dlrm (c) {fault}: the planted fault "
               f"is caught by {caught} only")
        print(f"[mesh-dlrm] (c) {fault} on rank 1: caught by "
              f"{', '.join(caught)} (loss gap {gap:.3g}, distance "
              f"{dist_:.3g})")
    # (d) four cards: c=4 against the replicated tables on the same world,
    # and the no_all_reduce fault at c=4; two: the app's own world from
    # this process (CPU rehearsals run both over gloo).
    wide = "nccl" if cuda else "gloo"
    if cards >= 4 or not cuda:
        four = _mesh_dlrm_world(4, [
            dict(name=name, table=MESH_DLRM["tables"][tab],
                 extra=arms["sgd"][0], fault=fault)
            for name, tab, fault in (("sgd_c4", "shard4", None),
                                     ("sgd_rep4", "rep4", None),
                                     ("no_all_reduce_c4", "shard4",
                                      "no_all_reduce"))],
            device, None if cuda else "gloo")
        shard, rep = four["sgd_c4"], four["sgd_rep4"]
        gap, dist_ = _mesh_dlrm_gap(shard, one["sgd"][0])
        ulp = max(_ulps(_world_rows(rep)[k], v)
                  for k, v in _world_rows(shard).items())
        ulp_dense = max(_ulps(rep[0]["dense"][op][k], v)
                        for op, g in shard[0]["dense"].items()
                        for k, v in g.items())
        for tab, res in (("c=4", shard), ("n=4", rep)):
            for r, got in enumerate(res):
                _held_rank(f"mesh-dlrm (d) {tab} rank {r}", got,
                           (T // 4 if tab == "c=4" else T, V, D),
                           want_counts("sgd"), wide)
                print(f"[mesh-dlrm] (d) sgd {tab} rank {r} of 4 ({wide}): "
                      f"{got['ms_step']:.3f} ms/step, collectives "
                      f"{got['comm_ms']:.3f} of {got['one_step_ms']:.3f} ms, "
                      f"peak memory {got['peak_gb']} GB; {card}")
            _check(all(got["dense_digest"] == res[0]["dense_digest"]
                       for got in res)
                   and (tab == "c=4" or all(
                       np.array_equal(a, b) for got in res[1:] for a, b in
                       zip(res[0]["trained_rows"], got["trained_rows"]))),
                   f"mesh-dlrm (d) {tab}: the ranks' replicated parameters "
                   f"differ")
        _check(_world_rows(rep).keys() == _world_rows(shard).keys()
               and ulp == 0 and ulp_dense == 0
               and gap <= TOL_MESH_LOSS and dist_ <= TOL_MESH_DIST,
               f"mesh-dlrm (d) c=4: the sharded tables {ulp} ULP from the "
               f"replicated ones, the dense parameters {ulp_dense} (bar 0); "
               f"loss gap {gap:.3g}, distance {dist_:.3g}")
        got, want = _world_rows(four["no_all_reduce_c4"]), _world_rows(rep)
        _check(got.keys() != want.keys() or any(
            not np.array_equal(got[k], want[k]) for k in want),
            "mesh-dlrm (d): the no_all_reduce fault at c=4 is not caught by "
            "the table's equality")
        fgap, fdist = _mesh_dlrm_gap(four["no_all_reduce_c4"], one["sgd"][0])
        print(f"[mesh-dlrm] (d) sgd c=4: the sharded tables and the dense "
              f"parameters bit for bit n=4's; loss gap to (a) {gap:.3g}, "
              f"distance {dist_:.3g}; no_all_reduce at c=4 caught by the "
              f"table (loss gap {fgap:.3g}, distance {fdist:.3g})")
        for name in ("sgd_c4", "sgd_rep4"):
            launches[f"mesh_dlrm_{name}"] = {
                k: sum(got["counts"].get(k, 0) for got in four[name])
                for k in ("gather_rows", "scatter_add_rows")}
    if cards >= 2 or not cuda:
        st = {}
        rc = dlrm.main(arms["sgd"][0] + ["-ll:gpu", "2"], device=device,
                       stats_out=st)
        gap = max(abs(a - w) / abs(w) for a, w in zip(st["step_losses"],
                                                       ref["losses"]))
        _check(rc == 0 and gap <= TOL_MESH_LOSS
               and st["step_losses"] == two["sgd_shard"][0]["losses"],
               f"mesh-dlrm (d): apps.dlrm -ll:gpu 2 exit {rc}, losses "
               f"{st['step_losses']}: (a)'s {ref['losses']}, (b) sgd "
               f"shard's {two['sgd_shard'][0]['losses']}")
        print(f"[mesh-dlrm] (d) apps.dlrm -ll:gpu 2 spawning its own "
              f"{wide} world (dlrm_strategy: c=2): losses bit for bit (b) sgd "
              f"shard's, loss gap to (a) {gap:.3g}, "
              f"{st['samples_per_s']:.1f} samples/s")
    rows = _dlrm_window_kernels(torch, kernels, F, c, launches) if cuda \
        else {}
    return rows, launches


#: Phase 29 (``mesh-serve``): phase 3's LM and requests on worlds of
#: ranks, ``ServingExecutor(shard=(n, c))`` through
#: ``tools/mesh_smoke.py::serve_cases``, every shard padded and paged
#: (16-token blocks) in f32 and in bf16; ``teacher_steps``: the
#: teacher-forced decode steps (to max_seq, after a prefill in the
#: largest bucket) whose logits every arm returns; ``faults``: the
#: planted faults run f32 padded, ``bf16_fault`` the one also run bf16
#: padded with the teacher (its logits must fail the bf16 bar); ``app``:
#: the shard of ``apps.serve --shard`` run by each rank of the world of
#: its size, f32 padded.
MESH_SERVE = dict(shards=((2, 1), (1, 2), (2, 2)), kv_block=16,
                  teacher_steps=16, faults=(("skip_c_all_reduce", (1, 2)),
                          ("gather_order", (2, 1))),
                  bf16_fault=("skip_c_all_reduce", (1, 2)), app=(2, 2))
#: bf16 bar of phase 29 (b): the teacher-forced decode logits of a sharded
#: engine against the one-engine run's, max |difference| over max |logit|
#: (the row-parallel ``wo`` sums its c partial products in another order
#: before the bf16 rounding, and the difference grows through 6 layers).
TOL_MESH_SERVE_BF16 = 2.0 ** -4


def _mesh_serve_kw(c):
    return dict(batch_size=c["max_batch"], seq_len=c["max_seq"],
                vocab_size=c["vocab"], d_model=c["d_model"],
                num_heads=c["heads"], num_layers=c["layers"], seed=c["seed"])


def _mesh_serve_cases(c, shards, tag_of, teacher):
    """Every arm of (b): per shard, padded and paged, f32 and bf16."""
    from flexflow_torch.runtime.serving import synthetic_requests

    reqs = [(r.id, r.prompt.tolist(), r.max_new_tokens) for r in
            synthetic_requests(c["requests"], c["vocab"],
                               prompt_len=c["prompt"],
                               max_new_tokens=c["max_new"], seed=c["seed"])]
    out = []
    for shard in shards:
        for layout in ("padded", "paged"):
            for dtype in ("float32", "bfloat16"):
                out.append(dict(
                    name=f"{layout}-{dtype}-{tag_of(shard)}", shard=shard,
                    dtype=dtype, requests=reqs, teacher=teacher,
                    timed=shard is not None,
                    ex=dict(max_seq=c["max_seq"], buckets=c["buckets"],
                            kv_block=MESH_SERVE["kv_block"]
                            if layout == "paged" else 0),
                    server_kw=dict(decode_steps=c["decode_steps"])))
    return out


def _mesh_serve_world(nprocs: int, model_kw, cases, device: str, backend):
    """``mesh_smoke.serve_cases`` on a world of ``nprocs``: ``{name: [rank
    results]}``."""
    from flexflow_torch.parallel import launch

    ranks = launch.run("flexflow_torch.tools.mesh_smoke:serve_cases",
                       (model_kw, None, cases, device), nprocs=nprocs,
                       device=device, backend=backend, timeout_s=900)
    return {cs["name"]: [r[i] for r in ranks] for i, cs in enumerate(cases)}


def _mesh_serve_hold(torch, kernels, F, k6, k1f) -> dict:
    """K6 at each rank-local cache shape ``(b, S, h, hd)`` (slot lengths
    drawn over ``[1, S]``) and K1f at each local prefill shape ``(1, h, t,
    hd)`` (causal), f32 and bf16: every element by phase 1's rules and
    each timed beside its plain version, SDPA (masked for K6) and the
    bound.  Returns ``{kernel: {shape: bf16 row}}``."""
    g = torch.Generator(device="cuda").manual_seed(29)
    rows = {"flash_decode": {}, "flash_attention_lse": {}}
    for shape in k6:
        B, S, h, hd = shape
        for dt in (torch.float32, torch.bfloat16):
            q = torch.randn((B, h, hd), generator=g, device="cuda").to(dt)
            ck, cv = (torch.randn(shape, generator=g, device="cuda").to(dt)
                      for _ in range(2))
            lengths = torch.randint(1, S + 1, (B,), generator=g,
                                    device="cuda", dtype=torch.int32)
            o = kernels.flash_decode(q, ck, cv, lengths)
            po = kernels.flash_decode_plain(q, ck, cv, lengths)
            err = (o.float() - po.float()).abs().max().item()
            elem = _decode_close(kernels, q, ck, cv, lengths, o, po)
            name = _dtype_name(dt)
            _check(elem <= 1.0 and err <= TOL_O[name],
                   f"mesh-serve (e): flash_decode {shape} {name}: |o| err "
                   f"{err} ({elem} of the element tolerance)")
            qs = q[:, :, None]
            ks, vs = ck.transpose(1, 2), cv.transpose(1, 2)
            mask = (torch.arange(S, device="cuda")[None, :]
                    < lengths[:, None])[:, None, None, :]
            ms, plain = _pair_ms(
                lambda: kernels.flash_decode(q, ck, cv, lengths),
                lambda: kernels.flash_decode_plain(q, ck, cv, lengths))
            lib = _device_ms(lambda: F.scaled_dot_product_attention(
                qs, ks, vs, attn_mask=mask))
            keys = int(lengths.sum())
            size = q.element_size()
            bound, by = _bound_ms(2 * keys * h * hd * size
                                  + 2 * B * h * hd * size + 4 * B,
                                  4 * h * hd * keys, name)
            print(f"[mesh-serve] (e) flash_decode at the rank's {shape} "
                  f"{name}: err o {err:.3g} ({elem:.3g} of the element "
                  f"tolerance); {ms:.4f} ms (plain {plain:.4f}, sdpa masked "
                  f"{lib:.4f}, bound {bound:.5f} by {by})")
            if dt == torch.bfloat16:
                rows["flash_decode"][str(shape)] = dict(
                    max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bound,
                    bound_by=by, library_ms=lib)
    for shape in k1f:
        b, h, t, hd = shape
        for dt in (torch.float32, torch.bfloat16):
            q, k, v = (torch.randn(shape, generator=g, device="cuda").to(dt)
                       for _ in range(3))
            o, lse = kernels.flash_attention_lse(q, k, v, True)
            po, plse = kernels.flash_attention_lse_plain(q, k, v, True)
            err = (o.float() - po.float()).abs().max().item()
            elem = _flash_fwd_close(kernels, q, k, v, True, o, po)
            err_lse = (lse - plse).abs().max().item()
            name = _dtype_name(dt)
            _check(elem <= 1.0 and err <= TOL_O[name] and err_lse <= TOL_LSE,
                   f"mesh-serve (e): flash_attention_lse {shape} {name}: |o| "
                   f"err {err} ({elem} of the element tolerance), |lse| err "
                   f"{err_lse}")
            ms, plain = _pair_ms(
                lambda: kernels.flash_attention_lse(q, k, v, True),
                lambda: kernels.flash_attention_lse_plain(q, k, v, True))
            lib = _device_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True))
            bound, by = _bound_ms(4 * b * h * t * hd * q.element_size()
                                  + b * h * t * 4,
                                  4 * b * h * hd * t * (t + 1) // 2, name)
            print(f"[mesh-serve] (e) flash_attention_lse at the rank's "
                  f"{shape} causal {name}: err o {err:.3g} ({elem:.3g} of "
                  f"the element tolerance) lse {err_lse:.3g}; {ms:.4f} ms "
                  f"(plain {plain:.4f}, sdpa {lib:.4f}, bound {bound:.5f} by "
                  f"{by})")
            if dt == torch.bfloat16:
                rows["flash_attention_lse"][str(shape)] = dict(
                    max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bound,
                    bound_by=by, library_ms=lib)
    return rows


def _rel_logits(got, want) -> float:
    return float(abs(got - want).max() / max(abs(want).max(), 1e-30))


def _first_difference(want: dict, got: dict):
    """``(request id, step)`` of the first token of ``got`` that differs
    from ``want``'s, taking requests in id order, with step >= 1 (step 0
    comes from the prefill, whose logits the teacher does not return);
    None when there is none."""
    for rid in sorted(want):
        j = next((i for i, (a, b) in enumerate(zip(want[rid], got[rid]))
                  if a != b), None)
        if j:
            return rid, j
    return None


def _mesh_serve_margins(kw, c, one, diffs, device):
    """Per bf16 arm in ``diffs`` (``{arm: (rid, step, its token)}``): the
    one engine teacher-forced along its own tokens of that request to the
    first differing step, in one engine run.  Returns ``{arm: (margin,
    above, own)}``: the one engine's top-2 logit margin at that step, how
    many of its logits there lie above the sharded engine's token (0: a
    tie for the top) and whether its top token is the one it served."""
    import numpy as np

    from flexflow_torch.runtime.serving import synthetic_requests
    from flexflow_torch.tools import mesh_smoke

    prompts = {r.id: r.prompt for r in synthetic_requests(
        c["requests"], c["vocab"], prompt_len=c["prompt"],
        max_new_tokens=c["max_new"], seed=c["seed"])}
    cases = []
    for arm, (rid, j, _tok) in diffs.items():
        layout = arm.split("-")[0]
        p = prompts[rid]
        seq = np.zeros(c["max_seq"], np.int32)
        seq[:len(p)] = p
        mine = one[f"{layout}-bfloat16"]["tokens"][rid]
        seq[len(p):len(p) + len(mine)] = mine
        cases.append(dict(
            name=arm, shard=None, dtype="bfloat16", requests=[],
            teacher=(seq, len(p), min(b for b in c["buckets"]
                                      if b >= len(p)), j),
            ex=dict(max_seq=c["max_seq"], buckets=c["buckets"],
                    kv_block=MESH_SERVE["kv_block"]
                    if layout == "paged" else 0)))
    out = {}
    for res, (arm, (rid, j, tok)) in zip(
            mesh_smoke.serve_cases(kw, None, cases, device), diffs.items()):
        row = res["teacher"][1][j - 1]
        top = np.sort(row)[::-1]
        mine = one[f"{arm.split('-')[0]}-bfloat16"]["tokens"][rid][j]
        out[arm] = (float(top[0] - top[1]), int((row > row[tok]).sum()),
                    int(row.argmax()) == mine)
    return out


def phase_mesh_serve(torch, kernels, F, c=None, device="cuda"):
    """Phase 29 (module docstring).  Returns ``(rows, launches)``: K6's and
    K1f's rows at the ranks' local shapes and ``{path: counts}`` summed
    over each arm's ranks.  ``c`` and ``device="cpu"`` rehearse it at a
    smaller width on CPU ranks (no launch counts or kernel rows then)."""
    import numpy as np

    from flexflow_torch.apps import serve
    from flexflow_torch.parallel import launch
    from flexflow_torch.tools import mesh_smoke

    c = c or SERVE
    cuda = device == "cuda"
    cards = torch.cuda.device_count() if cuda else 0
    card = _card() if cuda else "cpu"
    L, hd, S = c["layers"], c["d_model"] // c["heads"], c["max_seq"]
    kw = _mesh_serve_kw(c)
    # (a) a world of 1 without a shard: phase 3's tokens bit for bit.
    if not SERVE_TOKENS:
        st = {}
        _check(serve.main(_serve_argv("bfloat16", c), device=device,
                          stats_out=st) == 0, "mesh-serve (a): the app")
        SERVE_TOKENS.update({rid: r.tokens for rid, r in
                             st["results"].items()})
    (code, st), = launch.run(
        "flexflow_torch.apps.common:rank_app",
        ("flexflow_torch.apps.serve:main", _serve_argv("bfloat16", c),
         device), nprocs=1, device=device, timeout_s=900)
    got = {rid: r.tokens for rid, r in st["results"].items()}
    _check(code == 0 and st["shard"] is None and got == SERVE_TOKENS,
           f"mesh-serve (a): apps.serve on a world of 1 exit {code}, shard "
           f"{st['shard']}, tokens equal phase 3's: {got == SERVE_TOKENS}")
    print(f"[mesh-serve] (a) apps.serve (bf16) on a world of 1, no shard: "
          f"{len(got)} requests' tokens bit for bit phase 3's")
    # The one-engine references, in this process.
    rng = np.random.default_rng(0)
    prefix = max(S - MESH_SERVE["teacher_steps"], S // 2)
    teacher = (rng.integers(0, c["vocab"], size=S).astype(np.int32), prefix,
               min(b for b in c["buckets"] if b >= prefix))
    one = {r["name"][:-4]: r for r in mesh_smoke.serve_cases(
        kw, None, _mesh_serve_cases(c, [None], lambda s: "one", teacher),
        device)}
    tag = "{0[0]}x{0[1]}".format
    worlds = {2: [s for s in MESH_SERVE["shards"] if s[0] * s[1] == 2],
              4: [s for s in MESH_SERVE["shards"] if s[0] * s[1] == 4]}
    launches, k6, k1f, bf16_diffs = {}, set(), set(), {}
    for nprocs, shards in worlds.items():
        backend = None if cuda and cards >= nprocs else "gloo"
        cases = _mesh_serve_cases(c, shards, tag, teacher)
        if nprocs == 2:
            # (c) the planted faults, f32 padded, and one bf16 padded with
            # the teacher.
            cases += [dict(next(a for a in cases if a["name"] ==
                                f"padded-float32-{tag(shard)}"),
                           name=f"fault-{fault}", fault=fault, timed=False,
                           teacher=None)
                      for fault, shard in MESH_SERVE["faults"]]
            fault, shard = MESH_SERVE["bf16_fault"]
            cases.append(dict(next(a for a in cases if a["name"] ==
                                   f"padded-bfloat16-{tag(shard)}"),
                              name=f"fault-bf16-{fault}", fault=fault,
                              timed=False))
        app = MESH_SERVE["app"]
        if app[0] * app[1] == nprocs:
            # apps.serve --shard in each rank of this world, f32 padded.
            cases.append(dict(name=f"app-{tag(app)}", app=_serve_argv(
                "float32", c) + ["--shard", f"{app[0]},{app[1]}"]))
        t0 = time.perf_counter()
        res = _mesh_serve_world(nprocs, kw, cases, device, backend)
        wall = time.perf_counter() - t0
        used = "nccl" if backend is None else "gloo"
        print(f"[mesh-serve] (b) a world of {nprocs} over {used} "
              f"({cards} cards): {len(cases)} runs in {wall:.1f} s; {card}")
        for name, ranks in res.items():
            if name.startswith(("fault-", "app-")):
                continue
            layout, dtype, sh = name.split("-")
            shard = next(s for s in shards if tag(s) == sh)
            n, cc = shard
            ref = one[f"{layout}-{dtype}"]
            for r, got in enumerate(ranks):
                want_k6 = [(c["max_batch"] // n, c["heads"] // cc, hd)] \
                    if layout == "padded" else []
                _check(got["shard"] == shard and got["stats"]["failed"] == 0
                       and got["stats"]["shard"] == list(shard)
                       and not got["jax_imported"]
                       and got["shapes"].get("flash_decode", []) == want_k6
                       and {t[:2] for t in
                            got["shapes"]["flash_attention_lse_auto"]}
                       == {(1, c["heads"] // cc)},
                       f"mesh-serve (b) {name} rank {r}: shard "
                       f"{got['shard']}, failed {got['stats']['failed']}, "
                       f"K6 shapes {got['shapes'].get('flash_decode')} (want "
                       f"{want_k6}), dispatcher shapes "
                       f"{got['shapes']['flash_attention_lse_auto']}")
                if cuda:
                    want = {"flash_attention_lse"} | (
                        {"flash_decode"} if layout == "padded" else set())
                    _check(set(got["counts"]) == want
                           and all(v > 0 for v in got["counts"].values()),
                           f"mesh-serve (b) {name} rank {r}: launches "
                           f"{got['counts']}, want {sorted(want)} above 0")
                k6.update((b, S, h, d) for b, h, d in
                          got["shapes"].get("flash_decode", []))
                # The served prefills' shapes and the teacher's bucket.
                k1f.update(got["shapes"]["flash_attention_lse_auto"])
                k1f.add((1, c["heads"] // cc, teacher[2], hd))
            launches[f"mesh_serve_{name}"] = {
                k: sum(g["counts"].get(k, 0) for g in ranks)
                for k in ("flash_attention_lse", "flash_decode")}
            tok0 = ranks[0]["teacher"][0]
            rel = max(_rel_logits(g["teacher"][1], ref["teacher"][1])
                      for g in ranks)
            diff = sum(ranks[0]["tokens"][rid] != t
                       for rid, t in ref["tokens"].items())
            first = _first_difference(ref["tokens"], ranks[0]["tokens"])
            if dtype == "bfloat16" and first:
                rid, j = first
                bf16_diffs[name] = (rid, j, ranks[0]["tokens"][rid][j])
            if dtype == "float32":
                _check(all(g["tokens"] == ref["tokens"] for g in ranks)
                       and tok0 == ref["teacher"][0],
                       f"mesh-serve (b) {name}: f32 tokens differ from the "
                       f"one-engine run's in {diff} requests (first token "
                       f"{tok0} vs {ref['teacher'][0]}; logits {rel:.3g} of "
                       f"their max)")
            else:
                _check(rel <= TOL_MESH_SERVE_BF16
                       and all(g["tokens"] == ranks[0]["tokens"]
                               for g in ranks),
                       f"mesh-serve (b) {name}: bf16 logits {rel:.3g} of "
                       f"their max from the one-engine run's (bar "
                       f"{TOL_MESH_SERVE_BF16}), or the ranks' tokens differ")
            st0 = ranks[0]["stats"]
            share = ", ".join(
                f"{g['comm_ms'] / g['timed_ms'] * 100:.1f}%" for g in ranks)
            peak = ", ".join(f"{g['peak_gb']:.3f}" if g["peak_gb"] is not None
                             else "-" for g in ranks)
            absd = max(float(abs(g["teacher"][1] - ref["teacher"][1]).max())
                       for g in ranks)
            print(f"[mesh-serve] (b) {name} over {used}: "
                  f"{ranks[0]['ms_superstep']:.3f} ms a decode superstep "
                  f"(K={c['decode_steps']}, eager, each collective "
                  f"synchronised alone), {st0['tokens_per_s']:.1f} "
                  f"tokens/s, {st0['decode_supersteps']} supersteps; "
                  f"collectives {share} of the run's wall by rank; peak "
                  f"memory {peak} GB by rank; teacher logits {rel:.3g} of "
                  f"their max ({absd:.4g} absolute) from one engine's; "
                  f"first differing (request, step) {first}; requests "
                  f"whose tokens "
                  f"differ from one engine's {diff} of {len(ref['tokens'])}; "
                  f"launches {launches[f'mesh_serve_{name}']}")
        for fault, shard in MESH_SERVE["faults"]:
            if f"fault-{fault}" not in res:
                continue
            want = one["padded-float32"]["tokens"]
            got = [g["tokens"] for g in res[f"fault-{fault}"]]
            bad = [sum(g[rid] != t for rid, t in want.items()) for g in got]
            _check(any(bad),
                   f"mesh-serve (c): the planted fault {fault} at "
                   f"{tag(shard)} left every rank's tokens equal")
            print(f"[mesh-serve] (c) planted {fault} on rank 1 at "
                  f"{tag(shard)} (f32 padded): requests whose tokens differ "
                  f"from one engine's by rank {bad}")
        fault, shard = MESH_SERVE["bf16_fault"]
        if f"fault-bf16-{fault}" in res:
            ref = one["padded-bfloat16"]
            ranks = res[f"fault-bf16-{fault}"]
            rel = max(_rel_logits(g["teacher"][1], ref["teacher"][1])
                      for g in ranks)
            bad = [sum(g["tokens"][rid] != t
                       for rid, t in ref["tokens"].items()) for g in ranks]
            _check(rel > TOL_MESH_SERVE_BF16,
                   f"mesh-serve (c): the planted fault {fault} at "
                   f"{tag(shard)} (bf16 padded) left the teacher logits "
                   f"{rel:.3g} of their max, within the bf16 bar "
                   f"{TOL_MESH_SERVE_BF16}")
            print(f"[mesh-serve] (c) planted {fault} on rank 1 at "
                  f"{tag(shard)} (bf16 padded): teacher logits {rel:.4g} of "
                  f"their max from one engine's (bar {TOL_MESH_SERVE_BF16}); "
                  f"requests whose tokens differ by rank {bad}")
        app = f"app-{tag(MESH_SERVE['app'])}"
        if app in res:
            n, cc = MESH_SERVE["app"]
            want_k6 = [(c["max_batch"] // n, c["heads"] // cc, hd)]
            for r, got in enumerate(res[app]):
                _check(got["code"] == 0
                       and got["stats"]["shard"] == [n, cc]
                       and got["stats"]["failed"] == 0
                       and not got["jax_imported"]
                       and got["tokens"] == one["padded-float32"]["tokens"]
                       and got["shapes"].get("flash_decode") == want_k6
                       and {t[:2] for t in
                            got["shapes"]["flash_attention_lse_auto"]}
                       == {(1, c["heads"] // cc)}
                       and (not cuda or (
                           got["counts"].get("flash_decode", 0) > 0
                           and got["counts"].get("flash_attention_lse", 0)
                           > 0)),
                       f"mesh-serve (b) {app} rank {r}: exit {got['code']}, "
                       f"shard {got['stats'].get('shard')}, tokens equal one "
                       f"engine's f32: {got['tokens'] == one['padded-float32']['tokens']}, "
                       f"K6 shapes {got['shapes'].get('flash_decode')} (want "
                       f"{want_k6}), launches {got['counts']}")
            line = f"mesh shard = batch n={n} x heads c={cc}"
            _check(line in res[app][0]["report"],
                   f"mesh-serve (b) {app}: rank 0's report lacks {line!r}")
            launches[f"mesh_serve_{app}"] = {
                k: sum(g["counts"].get(k, 0) for g in res[app])
                for k in ("flash_attention_lse", "flash_decode")}
            st0 = res[app][0]["stats"]
            print(f"[mesh-serve] (b) apps.serve --shard {n},{cc} (f32) in "
                  f"each rank of this world over {used}: exit 0 on every "
                  f"rank, '{line}', {st0['completed']} requests' tokens "
                  f"bit for bit one engine's, {st0['tokens_per_s']:.1f} "
                  f"tokens/s, {st0['decode_s'] * 1e3 / max(st0['decode_supersteps'], 1):.3f} "
                  f"ms a decode superstep (untimed collectives), launches "
                  f"{launches[f'mesh_serve_{app}']}")
    if bf16_diffs:
        for arm, (margin, above, own) in _mesh_serve_margins(
                kw, c, one, bf16_diffs, device).items():
            rid, j, _tok = bf16_diffs[arm]
            print(f"[mesh-serve] (b) {arm}: first differing token of "
                  f"request {rid} at step {j}; the one engine's top-2 logit "
                  f"margin there {margin:.4g} (teacher-forced along its own "
                  f"tokens; its top token there is the one it served: "
                  f"{own}); the one engine's logits above the sharded "
                  f"engine's token there: {above} (0: tied for the top)")
    # (d) the app's own world where the machine has a card a rank.
    for shard in ((2, 2), (2, 1)):
        if cuda and cards >= shard[0] * shard[1]:
            st = {}
            rc = serve.main(_serve_argv("bfloat16", c)
                            + ["--shard", f"{shard[0]},{shard[1]}"],
                            device=device, stats_out=st)
            diff = sum(st["results"][rid].tokens != t
                       for rid, t in one["padded-bfloat16"]["tokens"].items())
            _check(rc == 0 and st["shard"] == list(shard)
                   and st["completed"] == c["requests"],
                   f"mesh-serve (d): apps.serve --shard {tag(shard)} exit "
                   f"{rc}, shard {st['shard']}, completed {st['completed']}")
            print(f"[mesh-serve] (d) apps.serve --shard {tag(shard)} "
                  f"spawning its own NCCL world (bf16): {st['completed']} "
                  f"requests, {st['tokens_per_s']:.1f} tokens/s, "
                  f"{diff} requests' tokens differ from one engine's")
            break
    rows = _mesh_serve_hold(torch, kernels, F, sorted(k6), sorted(k1f)) \
        if cuda else {}
    return rows, launches


#: Phase 30: the model families' own strategies on a world of four ranks
#: (gloo, every rank on one card; NCCL a card a rank with four cards),
#: through the apps, each held against the same app on one rank in this
#: process.  The LM at full width (``lm``: 4 x 8192, bf16, 1 + 2 Adam
#: steps) under ``lm_tables`` (name, dp, sp); on four cards also
#: ``lm32k`` (1 x 32768, streamed) at sp 4.  The f32 arm (``f32``, two
#: layers at 1 x 2048) at sp 4, also with the ring's planted faults.  The
#: MoE LM of phase 23 (``moe``) under ``moe_tables`` (name, dp, tp), also
#: with ``ep_local_capacity``.  NMT (phase 22's widths) under
#: ``nmt_strategy(2)`` and ``(4)`` in bf16 and at 4 in f32, also with
#: ``lstm_no_carry``; Candle-Uno at batch 512 in f32 under
#: ``candle_uno_strategy(2)`` and ``(4)``, SGD lr 1e-3 (in bf16 two SGD
#: steps moved its MSE by 2e-3 between splits; at phase 23's lr 0.01 its
#: loss climbs 1.10, 1.46, 2.68 and each step multiplies an f32 rounding
#: difference about 20 times).  A planted fault's run takes 1 + 1 steps.
#: On one card only the LM's ``dp2sp2`` runs of ``lm_tables``, the MoE's
#: ``tp2`` and ``nmt_strategy(2)`` do not, and no step is timed alone:
#: over gloo on one card a step of the LM's tables takes seconds, most of
#: it in the all-gather of the logits' cotangent that JAX's table implies
#: (``lm_head`` runs the whole sequence, the loss its rows; the MoE's
#: ``tp`` gathers the logits' vocabulary), and the script must end inside
#: its limit.  Four cards run every arm.
MESH_SEQ = dict(
    lm=dict(TRAIN, batch=4, seq=8192, iters=2),
    lm32k=dict(TRAIN, batch=1, seq=32768, iters=2),
    f32=dict(TRAIN, batch=1, seq=2048, layers=2, iters=2),
    moe=dict(MOE, iters=2),
    nmt=dict(NMT, iters=2),
    candle=dict(CANDLE, iters=2, lr=1e-3),
    lm_tables=(("sp2", 1, 2), ("sp4", 1, 4), ("dp2sp2", 2, 2)),
    moe_tables=(("tp2", 1, 2), ("dp2tp2", 2, 2)))
#: Phase 30's bars against one rank: bf16 losses within
#: ``TOL_MESH_SEQ_LOSS`` relative (each ring chunk's ``o`` rounds to bf16
#: before the f32 merge, where one rank's K1f rounds once) and the trained
#: parameters within ``TOL_MESH_SEQ_DIST`` of the one-rank run's change
#: (``mesh_smoke._distance``); f32 losses within ``TOL_MESH_SEQ_F32``
#: relative.  The MoE drops of the first step (the routing of the initial
#: parameters) equal one rank's exactly; later steps route after a bf16
#: update whose bits the split changes, and are printed.  Each planted
#: fault must break a bar.
TOL_MESH_SEQ_LOSS = 2e-3
TOL_MESH_SEQ_DIST = 0.1
TOL_MESH_SEQ_F32 = 1e-5


def _seq_argv(c, dtype="bfloat16", extra=()):
    argv = _train_argv(c)
    argv[argv.index("--dtype") + 1] = dtype
    return argv + list(extra)


def _candle_argv(c):
    return ["-b", str(c["batch"]), "-i", str(c["iters"]), "--dtype",
            "float32", "--optimizer", "sgd", "--lr", str(c["lr"]),
            "--momentum", "0", "--wd", "0", "--seed", "0"]


def _seq_runs(cards: int):
    """Phase 30's runs on the world of four: ``(runs, refs_wanted)``; each
    run names its one-rank reference (``base``) and, for the parameter
    bar, the reference file (``ref``)."""
    c = MESH_SEQ
    runs = []
    for name, dp, sp in c["lm_tables"]:
        if name != "dp2sp2" and cards < 4:
            continue
        runs.append(dict(name=f"lm_{name}", app="transformer", base="lm",
                         ref="lm", timed=cards >= 4, dp=dp, sp=sp,
                         argv=_seq_argv(c["lm"], extra=(
                             "--dp", str(dp), "--sp", str(sp)))))
    if cards >= 4:
        runs.append(dict(name="lm32k_sp4", app="transformer", base="lm32k",
                         ref="lm32k", timed=True, dp=1, sp=4, streamed=True,
                         argv=_seq_argv(c["lm32k"], extra=("--sp", "4"))))
    for fault in (None, "ring_attend_future", "ring_reverse"):
        runs.append(dict(name=f"f32_sp4{'_' + fault if fault else ''}",
                         app="transformer", base="f32", ref="f32", dp=1,
                         sp=4, fault=fault, f32=True,
                         argv=_seq_argv(c["f32"], "float32", ("--sp", "4"))))
    # The candle and NMT f32 runs and the faults' reference parameters.
    for name, dp, tp in c["moe_tables"]:
        if dp == 1 and cards < 4:
            continue
        for fault in (None, "ep_local_capacity") if dp > 1 else (None,):
            runs.append(dict(
                name=f"moe_{name}{'_' + fault if fault else ''}",
                app="transformer", base="moe", dp=dp, sp=1, fault=fault,
                argv=_seq_argv(c["moe"], extra=(
                    "--experts", str(c["moe"]["experts"]), "--dp", str(dp),
                    "--tp", str(tp)))))
    nmt = _nmt_argv(c["nmt"], ("-i", str(c["nmt"]["iters"]), "--seed", "0"))
    for n in (2, 4) if cards >= 4 else (4,):
        runs.append(dict(name=f"nmt_{n}", app="nmt", base="nmt", nmt=n,
                         argv=nmt))
    f32 = list(nmt)
    f32[f32.index("--dtype") + 1] = "float32"
    for fault in (None, "lstm_no_carry"):
        runs.append(dict(name=f"nmt_f32_4{'_' + fault if fault else ''}",
                         app="nmt", base="nmt_f32", ref="nmt_f32", nmt=4,
                         fault=fault, f32=True, argv=f32))
    for n in (2, 4):
        runs.append(dict(name=f"candle_{n}", app="candle_uno",
                         base="candle", ref="candle", candle=n, f32=True,
                         argv=_candle_argv(c["candle"])))
    for run in runs:
        if run.get("fault"):
            argv = run["argv"] = list(run["argv"])
            argv[argv.index("-i") + 1] = "1"
    return runs


def _seq_refs(torch, tmp, cards: int) -> dict:
    """The one-rank runs in this process: ``{base: (stats, counts)}``, the
    trained parameters of ``lm``, ``lm32k``, ``f32``, ``nmt_f32`` and
    ``candle`` with the squared norm of their change from the initial
    draw saved (``{"trained", "change"}``) under ``tmp`` for the ranks'
    distance bar, and the f32 run's digest."""
    import os

    from flexflow_torch.apps import candle_uno, nmt, transformer
    from flexflow_torch.ops import kernels
    from flexflow_torch.tools import mesh_smoke as ms

    c = MESH_SEQ
    nmt_argv = _nmt_argv(c["nmt"], ("-i", str(c["nmt"]["iters"]), "--seed",
                                    "0"))
    nmt_f32 = list(nmt_argv)
    nmt_f32[nmt_f32.index("--dtype") + 1] = "float32"
    from flexflow_torch.tools.mesh_smoke import step_drops

    todo = {"lm": (transformer.main, _seq_argv(c["lm"])),
            "f32": (transformer.main, _seq_argv(c["f32"], "float32")),
            "moe": (transformer.main, _seq_argv(c["moe"], extra=(
                "--experts", str(c["moe"]["experts"])))),
            "nmt": (nmt.main, nmt_argv), "nmt_f32": (nmt.main, nmt_f32),
            "candle": (candle_uno.main, _candle_argv(c["candle"]))}
    if cards >= 4:
        todo["lm32k"] = (transformer.main, _seq_argv(c["lm32k"]))
    out, paths = {}, {}
    for base, (main, argv) in todo.items():
        kernels._STREAMED = base == "lm32k"
        try:
            with step_drops() as drops, ms._InitOnce() as once:
                stats, counts, _ = _run_app(torch, main, argv)
        finally:
            kernels._STREAMED = False
        stats["drops"] = drops
        stats.pop("executor")
        trained = stats.pop("final")[0]
        if base in ("lm", "lm32k", "f32", "nmt_f32", "candle"):
            paths[base] = os.path.join(tmp, f"{base}.pt")
            init = once.full[0]
            torch.save({"trained": {op: {k: v.detach().cpu() for k, v in
                                         g.items()}
                                    for op, g in trained.items()},
                        "change": sum(float((v.detach().float() - init[op][
                            k].to(v.device).float()).square().sum())
                            for op, g in trained.items()
                            for k, v in g.items())}, paths[base])
        if base == "f32":
            stats["digest"] = ms.digest(trained)
        del trained, once
        torch.cuda.empty_cache()
        out[base] = (stats, counts)
    return out, paths


def _seq_gap(got, want) -> float:
    """The largest relative loss gap over the steps both ran."""
    return max(abs(a - w) / abs(w) for a, w in zip(got, want))


def _seq_held(run, res, refs, plan, cards) -> list:
    """Phase 30's checks of one run on every rank: the names of the bars
    it breaks (a planted fault must break one; a sound run none)."""
    from flexflow_torch.parallel.strategy import ParallelConfig

    stats, _ = refs[run["base"]]
    want = stats["step_losses"]
    bar = TOL_MESH_SEQ_F32 if run.get("f32") else TOL_MESH_SEQ_LOSS
    gap = max(_seq_gap(r["losses"], want) for r in res)
    broken = [n for n, on in (
        ("loss", gap > bar),
        ("distance", max(r.get("distance", 0.0) for r in res)
         > TOL_MESH_SEQ_DIST),
        ("ranks disagree", any(r["digest"] != res[0]["digest"]
                               for r in res)),
        ("drops", any(r["dropped"][:1] != stats["drops"][:1]
                      for r in res))) if on]
    if run.get("fault"):
        return broken
    backend = "nccl" if cards >= 4 else "gloo"
    for r in res:
        _check(r["code"] == 0 and r["backend"] == backend
               and not r["jax_imported"],
               f"mesh-seq {run['name']} rank {r['rank']}: exit {r['code']}, "
               f"backend {r['backend']}, jax {r['jax_imported']}")
    if run["app"] != "transformer":
        # NMT: K3 once a step each way, K4 and K5 once a word embedding a
        # step (the row-sparse path); Candle-Uno launches no kernel.
        steps = 1 + MESH_SEQ[run["app"].split("_")[0]]["iters"]
        want_counts = dict(softmax_xent=steps, softmax_xent_bwd=steps,
                           gather_rows=2 * steps,
                           scatter_add_rows=2 * steps) \
            if run["app"] == "nmt" else {}
        for r in res:
            _check(r["counts"] == want_counts,
                   f"mesh-seq {run['name']} rank {r['rank']}: launches "
                   f"{r['counts']}, expected {want_counts}")
        return broken
    # Launches: K1f and K1b once a layer a step for each chunk a rank
    # attends (its own and every earlier rank's under the causal mask),
    # K3 once a step each way; the shapes at the rank's block.
    c = MESH_SEQ["moe" if "moe" in run["name"] else run["base"]]
    steps, L = 1 + c["iters"], c["layers"]
    dp, sp = run["dp"], run["sp"]
    s_axes = plan.assign(ParallelConfig(n=dp, s=sp))["s"]
    hd = c["d_model"] // c["heads"]
    fwd, bwd = (("flash_attention_lse_streamed",
                 "flash_attention_lse_streamed_bwd") if run.get("streamed")
                else ("flash_attention_lse", "flash_attention_lse_bwd"))
    for r in res:
        chunks = 1 + plan.block_index(s_axes, r["rank"])
        want_counts = {fwd: L * steps * chunks, bwd: L * steps * chunks,
                       "softmax_xent": steps, "softmax_xent_bwd": steps}
        _check(r["counts"] == want_counts,
               f"mesh-seq {run['name']} rank {r['rank']}: launches "
               f"{r['counts']}, expected {want_counts}")
        rows = c["batch"] // dp * c["seq"] // sp
        want_shapes = {"flash_attention_lse_auto": [(
            c["batch"] // dp, c["heads"], c["seq"] // sp, hd)],
            "softmax_xent": [(rows, c["vocab"])]}
        _check(r["shapes"] == want_shapes,
               f"mesh-seq {run['name']} rank {r['rank']}: shapes "
               f"{r['shapes']}, expected {want_shapes}")
    return broken


def _ring_kernel_rows(torch, kernels, F, shapes) -> dict:
    """(g): K1f causal and not, and K1b with a nonzero lse cotangent,
    causal and not, at each local shape the ring ran (bf16; f32 for the
    f32 arm's), held against the plain versions and timed beside them,
    SDPA and the bound.  Returns ``{"flash_attention_lse": [...],
    "flash_attention_lse_bwd": [...]}``, a row a shape and mask."""
    rows = {"flash_attention_lse": [], "flash_attention_lse_bwd": []}
    for shape, dtype in shapes:
        dt = getattr(torch, dtype)
        g = torch.Generator(device="cuda").manual_seed(30)
        q, k, v, do = (torch.randn(shape, generator=g, device="cuda").to(dt)
                       for _ in range(4))
        g_lse = torch.randn(shape[:3], generator=g, device="cuda")
        b, h, t, hd = shape
        for causal in (True, False):
            held = mesh_attention_hold(torch, kernels, shape, causal, dtype)
            o, lse = kernels.flash_attention_lse(q, k, v, causal)
            pairs = t * (t + 1) // 2 if causal else t * t
            fwd = dict(shape=list(shape), dtype=dtype, causal=causal,
                       held=held["k1f"],
                       ms=_device_ms(lambda: kernels.flash_attention_lse(
                           q, k, v, causal)),
                       plain_ms=_device_ms(
                           lambda: kernels.flash_attention_lse_plain(
                               q, k, v, causal), 5),
                       library_ms=_device_ms(
                           lambda: F.scaled_dot_product_attention(
                               q, k, v, is_causal=causal)))
            fwd.update(zip(("bound_ms", "bound_by"), _bound_ms(
                4 * b * h * t * hd * q.element_size() + b * h * t * 4,
                4 * b * h * hd * pairs, dtype)))
            qs, ks, vs = (x.detach().clone().requires_grad_(True)
                          for x in (q, k, v))
            ref = F.scaled_dot_product_attention(qs, ks, vs,
                                                 is_causal=causal)
            bwd = dict(shape=list(shape), dtype=dtype, causal=causal,
                       held=held["k1b"],
                       ms=_device_ms(lambda: kernels.flash_attention_lse_bwd(
                           q, k, v, o, lse, do, g_lse, causal)),
                       plain_ms=_device_ms(
                           lambda: kernels.flash_attention_lse_bwd_plain(
                               q, k, v, o, lse, do, g_lse, causal), 5),
                       library_ms=_device_ms(lambda: torch.autograd.grad(
                           ref, (qs, ks, vs), do, retain_graph=True)))
            bwd.update(zip(("bound_ms", "bound_by"), _bound_ms(
                8 * b * h * t * hd * q.element_size() + 2 * b * h * t * 4,
                10 * b * h * hd * pairs, dtype)))
            rows["flash_attention_lse"].append(fwd)
            rows["flash_attention_lse_bwd"].append(bwd)
            for name, r in (("K1f", fwd), ("K1b", bwd)):
                print(f"[mesh-seq] (g) {name} {tuple(shape)} {dtype} "
                      f"{'causal' if causal else 'non-causal'}"
                      f"{' (g_lse != 0)' if name == 'K1b' else ''}: held "
                      f"{r['held']:.3g} of the element bar, {r['ms']:.4f} ms "
                      f"(plain {r['plain_ms']:.4f}, SDPA "
                      f"{r['library_ms']:.4f}, bound {r['bound_ms']:.5f} by "
                      f"{r['bound_by']})")
            del ref, qs, ks, vs, o, lse
        del q, k, v, do, g_lse
        torch.cuda.empty_cache()
    return rows


def phase_mesh_seq(torch, kernels, F):
    """Phase 30 (module docstring).  Returns ``(rows, launches)``: K1f's
    and K1b's rows at the ring's local shapes and ``{path: launches
    summed over the ranks}``."""
    import json
    import os
    import shutil
    import tempfile

    from flexflow_torch.parallel import launch
    from flexflow_torch.parallel.mesh import build_mesh_plan

    torch.cuda.empty_cache()
    cards = torch.cuda.device_count()
    backend = "nccl" if cards >= 4 else "gloo"
    card = _card().splitlines()[0]
    tmp = tempfile.mkdtemp(prefix="ff_mesh_seq_")
    t = [time.perf_counter()]
    try:
        refs, paths = _seq_refs(torch, tmp, cards)
        torch.cuda.empty_cache()
        t.append(time.perf_counter())
        # (a) the f32 arm's app on a world of 1: the one-rank run's losses
        # and parameters bit for bit.
        one, = launch.run("flexflow_torch.tools.mesh_smoke:seq_app",
                          ([dict(name="one", app="transformer",
                                 argv=_seq_argv(MESH_SEQ["f32"],
                                                "float32"))], paths),
                          nprocs=1, device="cuda", timeout_s=600)
        one = one[0]
        want = refs["f32"][0]
        _check(one["code"] == 0 and one["losses"] == want["step_losses"]
               and one["digest"] == want["digest"],
               f"mesh-seq (a): a world of 1 differs from one rank: losses "
               f"{one['losses']} vs {want['step_losses']}")
        print(f"[mesh-seq] (a) the f32 arm on a world of 1 "
              f"({one['backend']}): losses {one['losses']} and all "
              f"{len(one['digest'])} parameters bit for bit one rank's")
        t.append(time.perf_counter())
        runs = _seq_runs(cards)
        for run in runs:
            for key, fn in (("nmt", "nmt_strategy"),
                            ("candle", "candle_uno_strategy")):
                if run.get(key):
                    from flexflow_torch.models import candle_uno, nmt

                    mod = nmt if key == "nmt" else candle_uno
                    table = getattr(mod, fn)(run[key])
                    path = os.path.join(tmp, f"{run['name']}.json")
                    with open(path, "w") as f:
                        json.dump({"version": 1, "num_devices": 4,
                                   "ops": {k: v.to_json() for k, v in
                                           table.table.items()}}, f)
                    run["argv"] = list(run["argv"]) + ["-s", path]
        ranks = launch.run("flexflow_torch.tools.mesh_smoke:seq_app",
                           (runs, paths), nprocs=4, device="cuda",
                           backend=None if cards >= 4 else "gloo",
                           timeout_s=900)
        t.append(time.perf_counter())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    plan = build_mesh_plan(4)
    launches, shapes = {}, set()
    for i, run in enumerate(runs):
        res = [r[i] for r in ranks]
        broken = _seq_held(run, res, refs, plan, cards)
        gap = max(_seq_gap(r["losses"], refs[run["base"]][0]["step_losses"])
                  for r in res)
        dist_ = max(r.get("distance", 0.0) for r in res)
        if run.get("fault"):
            _check(bool(broken), f"mesh-seq {run['name']}: the planted fault "
                   f"breaks no bar (loss gap {gap:.3g}, distance {dist_:.3g})")
            print(f"[mesh-seq] (f) {run['name']}: caught by "
                  f"{', '.join(broken)} (loss gap {gap:.3g}, distance "
                  f"{dist_:.3g})")
            continue
        _check(not broken, f"mesh-seq {run['name']} ({backend}): "
               f"{', '.join(broken)}: losses {[r['losses'] for r in res]} "
               f"vs one rank {refs[run['base']][0]['step_losses']}, "
               f"distance {dist_:.3g}, drops "
               f"{[r['dropped'] for r in res]}")
        path = launches.setdefault(f"mesh_seq_{run['name']}", {})
        for r in res:
            for k, n in r["counts"].items():
                path[k] = path.get(k, 0) + n
            for shape in r["shapes"].get("flash_attention_lse_auto", []):
                if run.get("sp", 1) > 1:
                    shapes.add((tuple(shape),
                                "float32" if run.get("f32") else "bfloat16"))
        steps = ", ".join(
            f"r{r['rank']} {r['ms_step']:.1f}" + (
                f" (one step {r['one_step_ms']:.1f}: collectives "
                f"{r['comm_ms']:.1f}: " + ", ".join(
                    f"{k} {v:.1f}" for k, v in sorted(r["comm_by"].items()))
                + ")" if "one_step_ms" in r else "")
            for r in res)
        drops = ""
        if res[0]["dropped"] and res[0]["dropped"][0]:
            want = refs[run["base"]][0]["drops"]
            drops = (f", drops a step (first layer) "
                     f"{[next(iter(d.values())) for d in res[0]['dropped']]}"
                     f" vs one rank {[next(iter(d.values())) for d in want]}")
        print(f"[mesh-seq] {run['name']} ({backend}, {card}): loss gap "
              f"{gap:.3g}, distance {dist_:.3g}{drops}, launches of rank 0 "
              f"{res[0]['counts'] or '-'}, K1f by rank "
              f"{[sum(n for k, n in r['counts'].items() if k.startswith('flash_attention_lse') and not k.endswith('bwd')) for r in res]}"
              f", peak GB {max(r['peak_gb'] for r in res):.2f}; ms a step "
              f"{steps}")
    rows = _ring_kernel_rows(torch, kernels, F, sorted(shapes))
    t.append(time.perf_counter())
    print("[mesh-seq] " + ", ".join(
        f"{n} {b - a:.1f} s" for n, a, b in zip(
            ("one-rank references", "the world of 1",
             f"the world of 4 ({len(runs)} runs)", "(g)"), t, t[1:])))
    return rows, launches


#: Phase 31: phase 5's LM on a world of two (``app``: the flags of (a),
#: (b), (c); the fault of (c) before step ``fault``), and with four cards
#: the NCCL arms: the LM at dp 2 x tp 2 and the DLRM as k-step graphs
#: (``k``, ``iters`` timed steps after a superstep of warmup), the chaos
#: scenarios at n2c2.
MESH_TRAIN = dict(
    app=dict(iters=4, k=4, accum=2, save_every=4, resilient_iters=8,
             fault=6),
    lm=dict(TRAIN, dp=2, tp=2, k=4, iters=4),
    dlrm=dict(DLRM, k=4, iters=4),
    chaos=("raised_fault", "nan_batch", "nan_loss", "sigterm",
           "corrupt_checkpoint", "force_save_kill"))


def _mesh_train_refs(torch, argv, ref_path, device="cuda") -> dict:
    """(a)'s flags on one rank in this process: its losses, and its
    initial and trained parameters saved whole to ``ref_path``."""
    import contextlib
    import io

    from flexflow_torch.apps import transformer

    st = {}
    with contextlib.redirect_stdout(io.StringIO()):
        _check(transformer.main(argv, device=device, stats_out=st) == 0,
               "mesh-train: the one-rank reference")
    ex = st.pop("executor")
    full = {"trained": st.pop("final")[0], "init": ex.init()[0]}
    torch.save({n: {op: {k: v.detach().float().cpu() for k, v in g.items()}
                    for op, g in tr.items()} for n, tr in full.items()},
               ref_path)
    del ex, full
    return st


def _one_rank_snapshot(torch, d, c, want: dict, tag: str,
                       device="cuda") -> tuple:
    """Restore the snapshot under ``d`` on one rank (this process, the
    plain executor at ``c``'s widths), hold its parameters against the
    world's digest ``want``, and save it again on one rank: the restore's
    and the save's seconds."""
    import os

    from flexflow_torch.apps.common import make_optimizer
    from flexflow_torch.config import FFConfig
    from flexflow_torch.models.transformer import build_transformer_lm
    from flexflow_torch.runtime.checkpoint import CheckpointManager
    from flexflow_torch.runtime.executor import Executor
    from flexflow_torch.tools import mesh_smoke as ms

    cfg = FFConfig(batch_size=c["batch"], compute_dtype="bfloat16",
                   optimizer="adam", learning_rate=c["lr"], seed=c["seed"])
    ff = build_transformer_lm(
        batch_size=c["batch"], seq_len=c["seq"], vocab_size=c["vocab"],
        d_model=c["d_model"], num_heads=c["heads"], num_layers=c["layers"],
        config=cfg)
    ex = Executor(ff, cfg, optimizer=make_optimizer(cfg), device=device)
    templates = ex.init()
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    with CheckpointManager(d, read_only=True) as ck:
        sync()
        t0 = time.perf_counter()
        step, params, opt_state, state = ck.restore(templates=templates)
        sync()
        restore_s = time.perf_counter() - t0
    got = ms.digest(params)
    diff = sorted(k for k in want if want[k] != got.get(k))
    _check(not diff, f"mesh-train {tag}: the snapshot restored on one rank "
           f"differs from the world's gathered parameters: {diff[:5]}")
    with CheckpointManager(d + "-one") as ck:
        t0 = time.perf_counter()
        ck.save(step, params, opt_state, state)
        save_s = time.perf_counter() - t0
    del ex, templates, params, opt_state, state
    return restore_s, save_s


def phase_mesh_train(torch, kernels, F, c=None, device="cuda"):
    """Phase 31 (module docstring); ``c`` other widths than ``TRAIN``'s
    and ``device="cpu"`` rehearse it on the CPU (no holds, no card).
    Returns ``{path: launches summed over the ranks}``."""
    import glob
    import os
    import shutil
    import tempfile

    from flexflow_torch.parallel import launch
    from flexflow_torch.tools import mesh_train as mt

    t = [time.perf_counter()]
    lmc = c or TRAIN
    cuda = device == "cuda"
    cards = torch.cuda.device_count() if cuda else 0
    card = _card() if cuda else "the CPU"
    c = MESH_TRAIN["app"]
    tmp = tempfile.mkdtemp(prefix="ff_mesh_train_")
    launches = {}
    try:
        argv = _train_argv(dict(lmc, iters=c["iters"])) + [
            "--steps-per-call", str(c["k"]), "--accum-steps", str(c["accum"])]
        ref_path = os.path.join(tmp, "ref.pt")
        one = _mesh_train_refs(torch, argv, ref_path, device)
        t.append(time.perf_counter())
        tel = os.path.join(tmp, "tel")
        res_argv = _train_argv(dict(lmc, iters=c["resilient_iters"])) + [
            "--resilient", "--save-every", str(c["save_every"]),
            "--steps-per-call", str(c["k"])]
        runs = [dict(name="accum", argv=argv + ["--dp", "2", "--telemetry",
                                                tel], distance=True),
                dict(name="remat", argv=argv + ["--dp", "2", "--remat"],
                     distance=True),
                dict(name="clean", argv=res_argv + [
                    "--dp", "2", "--ckpt-dir", os.path.join(tmp, "clean")]),
                dict(name="faulted", fault=c["fault"], argv=res_argv + [
                    "--dp", "2", "--ckpt-dir", os.path.join(tmp, "faulted")])]
        nccl = cards >= 2
        ranks = launch.run("flexflow_torch.tools.mesh_train:chip_world",
                           (runs, ref_path, device), nprocs=2, device=device,
                           backend=None if nccl or not cuda else "gloo",
                           timeout_s=600)
        t.append(time.perf_counter())
        backend = "nccl" if nccl else "gloo"
        b, h = lmc["batch"], lmc["heads"]
        hd, v, seq = lmc["d_model"] // h, lmc["vocab"], lmc["seq"]
        mb = b // 2 // c["accum"]  # a rank's microbatch
        want_shapes = {"flash_attention_lse_auto": [(mb, h, seq, hd)],
                       "softmax_xent": [(mb * seq, v)]}
        for i, run in enumerate(runs):
            res = [r[i] for r in ranks]
            what = f"mesh-train ({run['name']}, {backend})"
            for r, got in enumerate(res):
                _check(got["code"] == 0 and got["backend"] == backend
                       and not got["jax_imported"]
                       and all(math.isfinite(x) for x in got["losses"]),
                       f"{what} rank {r}: exit {got['code']}, backend "
                       f"{got['backend']}, losses {got['losses']}")
                _check(got["graph"] in (None, nccl), f"{what}: superstep "
                       f"graph {got['graph']} over {backend}")
                for name in ("flash_attention_lse", "flash_attention_lse_bwd",
                             "softmax_xent", "softmax_xent_bwd"):
                    _check(got["counts"].get(name, 0) > 0 or not cuda,
                           f"{what} rank {r}: {name} never launched")
                _check(got["shapes"] == want_shapes if run["name"] in (
                    "accum", "remat") else True, f"{what} rank {r}: kernel "
                    f"shapes {got['shapes']}, expected {want_shapes}")
                path = launches.setdefault(f"mesh_train_{run['name']}", {})
                for k, n in got["counts"].items():
                    path[k] = path.get(k, 0) + n
            _check(all(got["digest"] == res[0]["digest"] for got in res),
                   f"{what}: the ranks' parameters differ")
            _check(res[0]["losses"] == res[1]["losses"],
                   f"{what}: the ranks' losses differ")
            if run.get("distance"):
                gap = max(abs(a - w) / abs(w) for a, w in
                          zip(res[0]["losses"], one["step_losses"]))
                dist_ = max(got["distance"] for got in res)
                _check(len(res[0]["losses"]) == len(one["step_losses"])
                       and gap <= TOL_MESH_LOSS and dist_ <= TOL_MESH_DIST,
                       f"{what}: loss gap {gap} (bar {TOL_MESH_LOSS}), "
                       f"distance {dist_} (bar {TOL_MESH_DIST}); losses "
                       f"{res[0]['losses']} vs {one['step_losses']}")
                print(f"[mesh-train] ({run['name']}) -ll:gpu 2 --dp 2 "
                      f"--steps-per-call {c['k']} --accum-steps {c['accum']}"
                      f"{' --remat' if run['name'] == 'remat' else ''} "
                      f"({backend}): {len(res[0]['losses'])} steps, loss gap "
                      f"to one rank {gap:.3g} (bar {TOL_MESH_LOSS}), "
                      f"parameter distance {dist_:.3g} (bar "
                      f"{TOL_MESH_DIST}), launches a rank "
                      f"{res[0]['counts']}")
        runs_by = {run["name"]: [r[i] for r in ranks]
                   for i, run in enumerate(runs)}
        files = sorted(glob.glob(os.path.join(tel, "run-*-p*.jsonl")))
        _check([f[-9:] for f in files] == ["-p0.jsonl", "-p1.jsonl"],
               f"mesh-train (a): telemetry run files {files}")
        clean, faulted = runs_by["clean"][0], runs_by["faulted"][0]
        _check(faulted["restarts"] == 1 and clean["restarts"] == 0
               and faulted["losses"] == clean["losses"]
               and faulted["digest"] == clean["digest"],
               f"mesh-train (c): faulted {faulted['losses']} (restarts "
               f"{faulted['restarts']}) vs clean {clean['losses']}")
        restore_s, save_s = _one_rank_snapshot(
            torch, os.path.join(tmp, "faulted"), lmc, faulted["digest"],
            "(c)", device)
        print(f"[mesh-train] (c) --resilient --save-every {c['save_every']} "
              f"--steps-per-call {c['k']}, a raised fault before step "
              f"{c['fault']} on both ranks ({backend}): one restart, "
              f"{len(clean['losses'])} losses and every parameter bit for "
              f"bit the unfaulted world's; the last snapshot restored on one "
              f"rank in {restore_s:.3f} s equals the world's gathered "
              f"parameters bit for bit; (a) wrote {len(files)} run files")
        t.append(time.perf_counter())
        shapes = {s for r in ranks for got in r
                  for s in got["shapes"].get("flash_attention_lse_auto", [])}
        if not cuda:
            shapes = set()
        holds = [f"K1f/K1b {sh}: " + ", ".join(
            f"{k} {x:.3g}" for k, x in mesh_attention_hold(
                torch, kernels, sh).items()) for sh in sorted(shapes)]
        for n, vv in sorted({s for r in ranks for got in r
                             for s in got["shapes"].get("softmax_xent", [])}
                            if cuda else ()):
            holds.append(f"K3 ({n}, {vv}): " + ", ".join(
                f"{k} {x:.3g}" for k, x in mesh_xent_hold(
                    torch, kernels, n, vv).items()))
        print("[mesh-train] holds at the ranks' shapes: " + "; ".join(holds))
        t.append(time.perf_counter())
        if cards >= 4:
            spec = dict(root=os.path.join(tmp, "graphs"),
                        lm=MESH_TRAIN["lm"], dlrm=MESH_TRAIN["dlrm"],
                        chaos=list(MESH_TRAIN["chaos"]))
            worlds = launch.run("flexflow_torch.tools.mesh_train:chip_graphs",
                                (spec,), nprocs=4, device="cuda",
                                timeout_s=900)
            lm = [w["lm"] for w in worlds]
            _check(all(x["digest"] == lm[0]["digest"] for x in lm),
                   "mesh-train (d): the ranks' parameters differ")
            for arm in ("lm", "dlrm"):
                for r, w in enumerate(worlds):
                    path = launches.setdefault(f"mesh_train_graph_{arm}", {})
                    for k, n in w[arm]["counts"].items():
                        path[k] = path.get(k, 0) + n
            for r, w in enumerate(worlds):
                for name, got in w["chaos"].items():
                    if name == "baseline":
                        continue
                    _check(got[0], f"mesh-train (f) rank {r}: {got[1]}")
            restore1, save1 = _one_rank_snapshot(
                torch, lm[0]["snapshot"], MESH_TRAIN["lm"], lm[0]["digest"],
                "(d)")
            for arm, tag in (("lm", "(d) the LM at dp 2 x tp 2"),
                             ("dlrm", "(e) the DLRM under dlrm_strategy(4)")):
                ms_ = [w[arm] for w in worlds]
                print(f"[mesh-train] {tag} (NCCL, four cards): a k="
                      f"{MESH_TRAIN[arm]['k']} superstep a CUDA graph on "
                      f"every rank, bit for bit two eager fits; ms a step "
                      f"eager (k=1) {[round(x['eager_ms'], 3) for x in ms_]}"
                      f", as a graph {[round(x['graph_ms'], 3) for x in ms_]}"
                      f"; one replay's device busy "
                      f"{[round(x['replay_busy_ms'], 3) for x in ms_]} ms; "
                      f"launches a rank {ms_[0]['counts']}")
            print(f"[mesh-train] (d) snapshot of the 2k LM with Adam's "
                  f"state, gathered: saved on the world in "
                  f"{[round(x['save_s'], 3) for x in lm]} s, restored on it "
                  f"in {[round(x['restore_s'], 3) for x in lm]} s; on one "
                  f"rank restored in {restore1:.3f} s, saved in {save1:.3f} "
                  f"s; bit for bit")
            print(f"[mesh-train] (e) DLRM table block a rank "
                  f"{worlds[0]['dlrm']['table_block']}; (f) chaos at n2c2, "
                  f"k=8 graphs: {sorted(k for k in worlds[0]['chaos'] if k != 'baseline')} "
                  f"recovered bit for bit on every rank in "
                  f"{worlds[0]['chaos_s']:.1f} s")
        t.append(time.perf_counter())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print("[mesh-train] " + ", ".join(
        f"{n} {b_ - a:.1f} s" for n, a, b_ in zip(
            ("one-rank reference", "the world of 2", "(c) one rank",
             "holds", "the NCCL world of 4"), t, t[1:])) + f"; {card}")
    return launches


#: Phase 32: the layer-wise pipeline on a world of four.  AlexNet at the
#: app's widths in f32 under the reference README's table (batch 64 over
#: gloo on one card, 256 over NCCL on four), NMT at bench.py's widths in
#: bf16 under ``--pipeline``; each held against the same app on one rank.
#: NMT's dropout draws each microbatch's masks from the key the previous
#: one left, so only m = 1 draws the one rank's masks: its held run is at
#: m = 1 and its schedules are compared at m = 2.
MESH_PIPE = dict(
    alexnet=dict(batch=64, batch4=256, image=229, classes=1000, m=4,
                 iters=2, lr=0.01, c=2),
    nmt=dict(NMT, iters=2, m=2, k=3),
    table="strategies/alexnet_readme_4dev.json")


def _pipe_alex_argv(c, batch):
    return ["-b", str(batch), "--image-size", str(c["image"]), "-i",
            str(c["iters"]), "--optimizer", "sgd", "--lr", str(c["lr"]),
            "--dtype", "float32", "--seed", "0"]


def _pipe_refs(torch, tmp, alex, nmt_argv, device="cuda") -> dict:
    """Phase 32's one-rank runs in this process (the plain Executor):
    ``{name: (losses, ref file, launches)}``, the trained parameters and
    the squared norm of their change from the initial draw saved for
    the ranks' distance bar."""
    import os

    from flexflow_torch.apps import alexnet, nmt
    from flexflow_torch.tools import mesh_smoke as ms

    out = {}
    for name, main, argv in (("alexnet", alexnet.main, alex),
                             ("nmt", nmt.main, nmt_argv)):
        with ms._InitOnce() as once:
            if device == "cuda":
                stats, counts, _ = _run_app(torch, main, argv)
            else:
                stats, counts = {}, {}
                _check(main(argv, device=device, stats_out=stats) == 0, name)
        stats.pop("executor")
        trained = stats.pop("final")[0]
        init = once.full[0]
        path = os.path.join(tmp, f"{name}.pt")
        torch.save({"trained": {op: {k: v.detach().float().cpu()
                                     for k, v in g.items()}
                                for op, g in trained.items()},
                    "change": sum(float((v.detach().float() - init[op][k]
                                         .to(v.device).float()).square()
                                        .sum())
                                  for op, g in trained.items()
                                  for k, v in g.items())}, path)
        out[name] = (stats["step_losses"], path, counts)
        del trained, once, stats
        if device == "cuda":
            torch.cuda.empty_cache()
    return out


def _pipe_kernel_rows(torch, kernels, F, alex_rows: int, nmt_n: int,
                      nmt_ids: int) -> dict:
    """K3 at the pipeline's last stages' microbatch shapes (AlexNet f32,
    NMT bf16) and K4 at an NMT embedding stage's microbatch ids, held
    against the plain versions (K3 by phase 2's rules, K4 bit for bit),
    timed beside them, the library call and the bound."""
    c, g = MESH_PIPE, torch.Generator(device="cuda").manual_seed(32)
    rows = {}
    for tag, n, v, dt in (("alexnet", alex_rows, c["alexnet"]["classes"],
                           "float32"),
                          ("nmt", nmt_n, c["nmt"]["vocab"], "bfloat16")):
        x, labels, _ = _xent_inputs(torch, g, n, v, dt)
        gn = torch.full((n,), 1.0 / n, device="cuda")
        gl = torch.randn((n,), generator=g, device="cuda")
        errs, _ = _xent_hold(torch, kernels, x, labels, gn, gl)
        _xent_held(errs, f"mesh-pipeline: softmax_xent ({n}, {v}) {dt}")
        lab = labels.clone()
        lab[-1] = 0
        lab64 = lab.long()
        lse = kernels.softmax_xent(x, lab)[1]
        xr = x.detach().clone().requires_grad_(True)
        ce = F.cross_entropy(xr, lab64, reduction="none")
        esz = 4 if dt == "float32" else 2
        for name, kern, plain, lib, nbytes, keys in (
                ("softmax_xent", lambda: kernels.softmax_xent(x, lab),
                 lambda: kernels.softmax_xent_plain(x, lab),
                 lambda: F.cross_entropy(x, lab64, reduction="none"),
                 n * v * esz + 16 * n, ("nll", "lse")),
                ("softmax_xent_bwd",
                 lambda: kernels.softmax_xent_bwd(x, lab, lse, gn, gl),
                 lambda: kernels.softmax_xent_bwd_plain(x, lab, lse, gn, gl),
                 lambda: torch.autograd.grad(ce, xr, gn.to(ce.dtype),
                                             retain_graph=True),
                 2 * n * v * esz + 16 * n, ("dlogits_abs",))):
            ms, lib_ms = _pair_ms(kern, lib)
            bound, by = _bound_ms(nbytes, 4 * n * v, "float32")
            rows[f"{name}@pipeline_{tag}"] = dict(
                shape=[n, v], dtype=dt, ms=ms, plain_ms=_device_ms(plain),
                library_ms=lib_ms, bound_ms=bound, bound_by=by,
                max_abs_err=max(errs[k] for k in keys))
        del x, xr, ce
    v, d = c["nmt"]["vocab"], c["nmt"]["hidden"]
    table = torch.randn((v, d), generator=g, device="cuda")
    ids = torch.randint(0, 2, (nmt_ids,), generator=g, device="cuda",
                        dtype=torch.int32)
    got = kernels.gather_rows(table, ids)
    _check(torch.equal(got, kernels.gather_rows_plain(table, ids)),
           "mesh-pipeline: gather_rows at the stage's ids differs from plain")
    lib_idx = ids.long()
    ms, lib_ms = _pair_ms(lambda: kernels.gather_rows(table, ids),
                          lambda: F.embedding(lib_idx, table))
    uniq = int(torch.unique(ids).numel())
    bound, by = _bound_ms(uniq * d * 4 + nmt_ids * d * 4 + 4 * nmt_ids, 0,
                          "float32")
    rows["gather_rows@pipeline_nmt"] = dict(
        shape=[v, d, nmt_ids], dtype="float32", ms=ms,
        plain_ms=_device_ms(lambda: kernels.gather_rows_plain(table, ids)),
        library_ms=lib_ms, bound_ms=bound, bound_by=by, max_abs_err=0.0)
    for name, r in rows.items():
        print(f"[mesh-pipeline] {name} {r['shape']} {r['dtype']}: held "
              f"(max abs err {r['max_abs_err']:.3g}); {r['ms']:.6f} ms "
              f"(plain {r['plain_ms']:.6f}, library {r['library_ms']:.6f}, "
              f"bound {r['bound_ms']:.3e} by {r['bound_by']})")
    return rows


def phase_mesh_pipeline(torch, kernels, F, c=None, device="cuda"):
    """Phase 32 (module docstring).  Returns ``(rows, launches)``: the
    kernels' rows at the pipeline's microbatch shapes and ``{path:
    launches summed over the ranks}``.  ``c`` (other widths than
    ``MESH_PIPE``'s) and ``device="cpu"`` rehearse it on CPU ranks (no
    launch counts, no kernel rows)."""
    import os
    import shutil
    import tempfile

    from flexflow_torch.parallel import launch

    t = [time.perf_counter()]
    cuda = device == "cuda"
    if cuda:
        torch.cuda.empty_cache()
    # The f32 references in full f32, as the ranks run (no TF32).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cards = torch.cuda.device_count() if cuda else 0
    nccl = cards >= 4
    backend = "nccl" if nccl else "gloo"
    card = _card() if cuda else "the CPU"
    c = c or MESH_PIPE
    ca, cn = c["alexnet"], c["nmt"]
    batch = ca["batch4"] if nccl else ca["batch"]
    alex = _pipe_alex_argv(ca, batch)
    table = ["-s", c["table"], "--microbatches", str(ca["m"])]
    nmt1 = _nmt_argv(cn, ("-i", str(cn["iters"]), "--seed", "0"))
    kc = cn["k"]
    # The compiled arm: one superstep of warmup, then k timed steps; the
    # host-driven run it is held against takes the same 2 k steps.
    nmt_host = _nmt_argv(cn, ("-i", str(2 * kc - 1), "--seed", "0"))
    nmt_comp = _nmt_argv(cn, ("-i", str(kc), "--seed", "0"))
    tmp = tempfile.mkdtemp(prefix="ff_mesh_pipe_")
    try:
        refs = _pipe_refs(torch, tmp, alex, nmt1, device)
        t.append(time.perf_counter())
        pipe = ["--pipeline", "--microbatches"]
        runs = [dict(name="alex_1f1b", app="alexnet", ref="alexnet",
                     argv=alex + table, timed=True),
                dict(name="alex_gpipe", app="alexnet", ref="alexnet",
                     argv=alex + table + ["--pipeline-schedule", "gpipe"]),
                dict(name="alex_seed_one", app="alexnet", ref="alexnet",
                     argv=alex + table, fault="seed_one"),
                dict(name="nmt_m1", app="nmt", ref="nmt",
                     argv=nmt1 + pipe + ["1"], timed=True),
                dict(name="nmt_1f1b", app="nmt",
                     argv=nmt1 + pipe + [str(cn["m"])]),
                dict(name="nmt_gpipe", app="nmt",
                     argv=nmt1 + pipe + [str(cn["m"]), "--pipeline-schedule",
                                         "gpipe"]),
                # (e) chunked, compiled, and the rollback of a fused
                # pipeline superstep.
                dict(name="chunk_alex", app="alexnet", ref="alexnet",
                     argv=alex + table + ["--pipeline-chunk", str(ca["c"])]),
                dict(name="chunk_nmt", app="nmt",
                     argv=nmt1 + pipe + [str(cn["m"]), "--pipeline-chunk",
                                         str(cn["m"])]),
                dict(name="nmt_host", app="nmt",
                     argv=nmt_host + pipe + [str(cn["m"])]),
                dict(name="compiled_nmt", app="nmt",
                     argv=nmt_comp + pipe + [str(cn["m"]),
                                             "--pipeline-compiled",
                                             "--steps-per-call", str(kc)],
                     replay={"every": {"gather_rows": cn["m"],
                                       "scatter_add_rows": 1},
                             "last_stage": {"softmax_xent": cn["m"],
                                            "softmax_xent_bwd": cn["m"]}}),
                dict(name="chaos_pipe", chaos=True)]
        ranks = launch.run(
            "flexflow_torch.tools.mesh_pipeline:chip_apps",
            (runs, {k: v[1] for k, v in refs.items()}, device), nprocs=4,
            device=device, backend=None if nccl or not cuda else "gloo",
            timeout_s=600)
        t.append(time.perf_counter())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    res = {run["name"]: [r[i] for r in ranks] for i, run in enumerate(runs)}
    launches = {}
    for run in runs:
        name, got = run["name"], res[run["name"]]
        what = f"mesh-pipeline {name}"
        if run.get("chaos"):
            for r, g in enumerate(got):
                _check(g["ok"] and g["backend"] == backend
                       and not g["jax_imported"],
                       f"{what} rank {r}: {g['detail']} ({g['backend']})")
            print(f"[mesh-pipeline] (e) pipeline_superstep_nan on the "
                  f"compiled pipeline ({backend}, k = 8, "
                  f"{'a CUDA graph a rank' if nccl else 'a loop'}): "
                  f"{got[0]['detail']}; {max(g['s'] for g in got):.1f} s")
            continue
        want = refs[run["app"]][0] if run.get("ref") else None
        for r, g in enumerate(got):
            _check(g["code"] == 0 and g["kind"] == "PipelineExecutor"
                   and g["backend"] == backend and not g["jax_imported"],
                   f"{what} rank {r}: exit {g['code']}, {g['kind']}, "
                   f"{g['backend']}, jax imported {g['jax_imported']}")
            _check(g["losses"] == got[0]["losses"]
                   and all(math.isfinite(x) for x in g["losses"]),
                   f"{what} rank {r}: losses {g['losses']} vs rank 0's "
                   f"{got[0]['losses']}")
        gap = max(abs(a - w) / abs(w) for a, w in
                  zip(got[0]["losses"], want)) if want else 0.0
        dist_ = got[0].get("distance", 0.0)
        caught = [n for n, on in (("loss", gap > TOL_MESH_LOSS),
                                  ("distance", dist_ > TOL_MESH_DIST)) if on]
        if run.get("fault"):
            _check(bool(caught), f"{what}: the planted fault ({run['fault']})"
                   f" passes every bar (loss gap {gap:.3g}, distance "
                   f"{dist_:.3g})")
            print(f"[mesh-pipeline] (c) planted {run['fault']}: caught by "
                  f"{', '.join(caught)} (loss gap {gap:.3g}, distance "
                  f"{dist_:.3g})")
            continue
        _check(not caught, f"{what}: {caught} (loss gap {gap:.3g}, distance "
               f"{dist_:.3g}; losses {got[0]['losses']} vs {want})")
        path = launches.setdefault(f"mesh_pipeline_{name}", {})
        by_rank = []
        for g in got:
            by_rank.append(g["counts"])
            for k, n in g["counts"].items():
                path[k] = path.get(k, 0) + n
        steps = len(got[0]["losses"])
        if not cuda:  # the counters count CUDA launches only
            pass
        elif run["app"] == "alexnet":
            # K3 once each way a microbatch, on the last stage's one rank.
            want_k3 = [ca["m"] * steps if r in got[0]["stages"][-1] else 0
                       for r in range(4)]
            _check([g["counts"].get("softmax_xent", 0) for g in got]
                   == want_k3 and [g["counts"].get("softmax_xent_bwd", 0)
                                   for g in got] == want_k3,
                   f"{what}: K3 launches by rank {by_rank}, want {want_k3}")
        else:
            m = 1 if name == "nmt_m1" else cn["m"]
            dec = got[0]["stages"][-1]
            # A compiled superstep on NCCL counts at its eager first call
            # and its capture (2 k steps), its replays not at all; its
            # 2 k steps make the same counts a step.
            want_k3 = [m * steps if r in dec else 0 for r in range(4)]
            # K4 a microbatch's backward, K5 once a step, on each
            # embedding's own stage (every rank holds one embedding).
            want_k4 = [m * steps] * 4
            _check([g["counts"].get("softmax_xent", 0) for g in got]
                   == want_k3
                   and [g["counts"].get("gather_rows", 0) for g in got]
                   == want_k4
                   and [g["counts"].get("scatter_add_rows", 0) for g in got]
                   == [steps] * 4,
                   f"{what}: launches by rank {by_rank}")
        print(f"[mesh-pipeline] {name} ({backend}, {len(got[0]['stages'])} "
              f"stages {got[0]['stages']}): losses "
              f"{[round(x, 6) for x in got[0]['losses']]}, loss gap to one "
              f"rank {gap:.3g} (bar {TOL_MESH_LOSS}), distance "
              f"{dist_:.3g} (bar {TOL_MESH_DIST}), {got[0]['schedule_len']} "
              f"events a step, ms a step by rank "
              f"{[round(g['ms_step'], 3) for g in got]}, launches by rank "
              f"{by_rank}; {card}")
        if run.get("timed"):
            shares = ", ".join(
                f"{g['one_step_ms']:.3f} ms of which hand-offs "
                f"{g['handoff_ms']:.3f} "
                f"({100 * g['handoff_ms'] / g['one_step_ms']:.1f}%)"
                for g in got)
            print(f"[mesh-pipeline] (d) {name}: one step with each hand-off "
                  f"synchronised alone, by rank: {shares} ({backend}); "
                  f"{card}")
    for a, b in (("alex_gpipe", "alex_1f1b"), ("nmt_gpipe", "nmt_1f1b"),
                 ("chunk_alex", "alex_1f1b"), ("chunk_nmt", "nmt_1f1b"),
                 ("compiled_nmt", "nmt_host")):
        _check(res[a][0]["losses"] == res[b][0]["losses"]
               and res[a][0]["digest"] == res[b][0]["digest"],
               f"mesh-pipeline: {a} differs from {b}")
    _check(res["nmt_host"][0]["losses"][:len(res["nmt_1f1b"][0]["losses"])]
           == res["nmt_1f1b"][0]["losses"],
           "mesh-pipeline: nmt_host's first steps differ from nmt_1f1b's")
    comp = res["compiled_nmt"]
    _check(all(g["compiled"] and g["graphed"] is nccl for g in comp)
           and not any(g["compiled"] for g in res["chunk_nmt"]),
           f"mesh-pipeline: compiled_nmt took compiled "
           f"{[g['compiled'] for g in comp]}, graphs "
           f"{[g['graphed'] for g in comp]} ({backend})")
    print(f"[mesh-pipeline] gpipe and 1f1b bit for bit (losses and every "
          f"parameter) for AlexNet at m = {ca['m']} and NMT at m = {cn['m']}; "
          f"(e) --pipeline-chunk {ca['c']} (AlexNet) and {cn['m']} (NMT) bit "
          f"for bit 1f1b; NMT --pipeline-compiled --steps-per-call {kc} "
          f"({'one CUDA graph a rank, its NCCL hand-offs inside' if nccl else 'the gloo loop'}) "
          f"bit for bit the host-driven {2 * kc} steps; ms a step by rank: "
          f"host-driven {[round(g['ms_step'], 3) for g in res['nmt_1f1b']]}, "
          f"chunk = m {[round(g['ms_step'], 3) for g in res['chunk_nmt']]}, "
          f"compiled {[round(g['ms_step'], 3) for g in comp]}; {card}")
    if nccl:
        print(f"[mesh-pipeline] (e) compiled_nmt's graph of {kc} steps by "
              f"rank: launches a step {[g['replay_per_step'] for g in comp]} "
              f"at capture and by kernel name in a profiled replay, device "
              f"busy {[round(g['replay_busy_ms'], 3) for g in comp]} ms a "
              f"replay; {card}")
    stages = res["alex_1f1b"][0]["stages"]
    rows = _pipe_kernel_rows(
        torch, kernels, F, batch // ca["m"] // len(stages[-1]),
        cn["batch"] // cn["m"] // 2 * cn["seq"],
        cn["batch"] // cn["m"] // 2 * cn["seq"]) if cuda else {}
    t.append(time.perf_counter())
    print("[mesh-pipeline] " + ", ".join(
        f"{n} {b_ - a:.1f} s" for n, a, b_ in zip(
            ("one-rank references", f"the world of 4 ({backend})",
             "kernel holds"), t, t[1:])) + f"; AlexNet batch {batch}"
          f"{' (smaller over gloo on one card)' if not nccl else ''}; "
          f"{card}")
    return rows, launches


def _card() -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return smi.stdout.strip()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on a "
              "GPU", file=sys.stderr)
        return 2
    import torch.nn.functional as F

    from flexflow_torch.ops import kernels

    # f32 references in full f32: no TF32 in matmuls or convolutions.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t = [time.perf_counter()]
    rows = phase_kernels(torch, kernels, F)
    t.append(time.perf_counter())
    rows.update(phase_train_kernels(torch, kernels, F))
    t.append(time.perf_counter())
    serve_launches = phase_serve(torch, kernels)
    t.append(time.perf_counter())
    phase_parity(torch)
    t.append(time.perf_counter())
    train_launches = phase_train(torch, kernels, rows)
    t.append(time.perf_counter())
    phase_train_parity(torch, kernels)
    t.append(time.perf_counter())
    phase_profile(torch)
    t.append(time.perf_counter())
    rows.update(phase_dlrm_kernels(torch, kernels, F))
    t.append(time.perf_counter())
    dlrm_launches, dlrm_params, dlrm_losses = phase_dlrm_train(torch, kernels)
    dlrm_ref = dlrm_reference(torch, dlrm_params, dlrm_losses)
    t.append(time.perf_counter())
    phase_dlrm_parity(torch, kernels)
    t.append(time.perf_counter())
    phase_dlrm_profile(torch, dlrm_params)
    del dlrm_params
    t.append(time.perf_counter())
    rows.update(phase_stream_kernels(torch, kernels, F))
    t.append(time.perf_counter())
    longctx_launches = phase_longctx_train(torch, kernels, rows)
    t.append(time.perf_counter())
    phase_train_parity(torch, kernels, streamed=True)
    t.append(time.perf_counter())
    probe_rows, probe_launches = phase_probe_kernels(torch, kernels, F, rows)
    rows.update(probe_rows)
    t.append(time.perf_counter())
    rows.update(phase_alexnet_kernels(torch, kernels, F))
    t.append(time.perf_counter())
    alexnet_launches = phase_alexnet_train(torch, kernels)
    phase_alexnet_profile(torch)
    t.append(time.perf_counter())
    phase_alexnet_parity(torch, kernels)
    t.append(time.perf_counter())
    superstep_launches = phase_superstep(torch, kernels)
    t.append(time.perf_counter())
    features_launches = phase_serve_features(torch, kernels)
    t.append(time.perf_counter())
    resilience_launches = phase_serve_resilience(torch, kernels)
    t.append(time.perf_counter())
    nmt_rows, nmt_launches = phase_nmt(torch, kernels, F)
    rows.update(nmt_rows)
    t.append(time.perf_counter())
    item5_rows, item5_launches = phase_item5(torch, kernels, F)
    rows.update(item5_rows)
    t.append(time.perf_counter())
    item7_launches = phase_item7(torch, kernels)
    t.append(time.perf_counter())
    sched_launches = phase_serve_sched(torch, kernels)
    t.append(time.perf_counter())
    fleet_launches = phase_fleet(torch, kernels)
    t.append(time.perf_counter())
    mesh_rows, mesh_launches = phase_mesh(torch, kernels, F)
    t.append(time.perf_counter())
    dlrm_mesh_rows, dlrm_mesh_launches = phase_mesh_dlrm(torch, kernels, F,
                                                         dlrm_ref)
    t.append(time.perf_counter())
    serve_mesh_rows, serve_mesh_launches = phase_mesh_serve(torch, kernels, F)
    t.append(time.perf_counter())
    seq_rows, seq_launches = phase_mesh_seq(torch, kernels, F)
    t.append(time.perf_counter())
    train_mesh_launches = phase_mesh_train(torch, kernels, F)
    t.append(time.perf_counter())
    pipe_rows, pipe_launches = phase_mesh_pipeline(torch, kernels, F)
    t.append(time.perf_counter())
    names = ("kernels", "train-kernels", "serve", "parity", "train",
             "train-parity", "profile", "dlrm-kernels", "dlrm-train",
             "dlrm-parity", "dlrm-profile", "stream-kernels", "longctx-train",
             "longctx-parity", "probe-kernels", "alexnet-kernels",
             "alexnet-train", "alexnet-parity", "superstep", "serve-features",
             "serve-resilience", "nmt", "item5", "item7", "serve-sched",
             "fleet", "mesh", "mesh-dlrm", "mesh-serve", "mesh-seq",
             "mesh-train", "mesh-pipeline")
    print("[phases] " + ", ".join(f"{n} {b - a:.1f}s"
                                  for n, a, b in zip(names, t, t[1:])))

    src, pk = "flexflow_torch/csrc/", "flexflow_tpu/ops/pallas_kernels.py"
    meta = {
        "flash_attention_lse": (src + "flash_fwd.cu", pk + ":147"),
        "flash_decode": (src + "flash_decode.cu", pk + ":1085"),
        "flash_attention_lse_bwd": (src + "flash_bwd.cu", pk + ":719"),
        "softmax_xent": (src + "softmax_xent.cu", pk + ":1187"),
        "softmax_xent_bwd": (src + "softmax_xent.cu", pk + ":1227"),
        "gather_rows": (src + "embedding_rows.cu", pk + ":1379"),
        "gather_rows_multi": (src + "embedding_rows.cu", pk + ":1379"),
        "scatter_add_rows": (src + "embedding_rows.cu", pk + ":1412"),
        "flash_attention_lse_streamed": (src + "flash_fwd.cu", pk + ":361"),
        "flash_attention_lse_streamed_bwd": (src + "flash_bwd.cu",
                                             pk + ":664"),
        "flash_fwd_row_state": (src + "flash_fwd.cu",
                                "tools/probe_flash_variants.py:46"),
        "flash_fwd_two_pass": (src + "flash_probe.cu",
                               "tools/probe_flash_variants.py:103"),
        "flash_fwd_full_row": (src + "flash_probe.cu",
                               "tools/probe_flash_variants.py:174"),
        "flash_bwd_row_state": (src + "flash_bwd.cu",
                                "tools/probe_flash_bwd_variants.py:155"),
    }
    entries = []
    for name, (source, replaces) in meta.items():
        by_path = {"serve": serve_launches[name],
                   "train": train_launches[name],
                   **{f"dlrm_{run}": counts[name]
                      for run, counts in dlrm_launches.items()},
                   **{leg: counts[name]
                      for leg, counts in longctx_launches.items()},
                   "probe": probe_launches[name],
                   "alexnet": alexnet_launches[name],
                   "superstep": superstep_launches[name],
                   "serve_features": features_launches[name],
                   "serve_resilience": resilience_launches.get(name, 0),
                   "nmt": nmt_launches.get(name, 0),
                   **{path: counts.get(name, 0)
                      for path, counts in item5_launches.items()},
                   **{path: counts.get(name, 0)
                      for path, counts in item7_launches.items()},
                   **{f"sched_{run}": counts.get(name, 0)
                      for run, counts in sched_launches.items()},
                   **{f"fleet_{run}": counts.get(name, 0)
                      for run, counts in fleet_launches.items()},
                   **{path: counts.get(name, 0)
                      for path, counts in mesh_launches.items()},
                   **{path: counts.get(name, 0)
                      for path, counts in dlrm_mesh_launches.items()},
                   **{path: counts.get(name, 0)
                      for path, counts in serve_mesh_launches.items()},
                   **{path: counts.get(name, 0)
                      for path, counts in seq_launches.items()},
                   **{path: counts.get(name, 0)
                      for path, counts in train_mesh_launches.items()},
                   **{path: counts.get(name, 0)
                      for path, counts in pipe_launches.items()}}
        entry = dict(name=name, route="cuda", source=source,
                     replaces=replaces, launches=sum(by_path.values()),
                     launches_by_path=by_path, **rows[name])
        if name in mesh_rows:
            entry["mesh_dp2_shape"] = mesh_rows[name]
        if name in dlrm_mesh_rows:
            entry["mesh_dlrm_shape"] = dlrm_mesh_rows[name]
        if name in serve_mesh_rows:
            entry["mesh_serve_shapes"] = serve_mesh_rows[name]
        if name in seq_rows:
            entry["mesh_seq_shapes"] = seq_rows[name]
        for tag in ("alexnet", "nmt"):
            if f"{name}@pipeline_{tag}" in pipe_rows:
                entry[f"mesh_pipeline_{tag}_shape"] = pipe_rows[
                    f"{name}@pipeline_{tag}"]
        if name == "flash_attention_lse":
            entry["train_shape"] = rows["flash_attention_lse@train"]
            entry["longctx_shape"] = rows["flash_attention_lse@8k"]
            entry["longctx_32k_shape"] = rows["flash_attention_lse@32k"]
        if name == "flash_attention_lse_bwd":
            entry["longctx_shape"] = rows["flash_attention_lse_bwd@8k"]
            entry["longctx_32k_shape"] = rows["flash_attention_lse_bwd@32k"]
        if name == "flash_attention_lse_streamed":
            entry["f32_source"] = src + "flash_stream.cu"
            entry["longctx_32k_shape"] = rows["flash_attention_lse_streamed@32k"]
        if name in ("softmax_xent", "softmax_xent_bwd"):
            entry["alexnet_shape"] = rows[f"{name}@alexnet"]
            entry["cnn_shape"] = rows[f"{name}@cnn"]
        if name in ("softmax_xent", "softmax_xent_bwd", "gather_rows",
                    "scatter_add_rows"):
            entry["nmt_shape"] = rows[f"{name}@nmt"]
        if name == "flash_decode":
            entry["long_cache_shape"] = rows[
                f"flash_decode@{DECODE_TIMED[1]}"]
        if name == "flash_attention_lse_streamed_bwd":
            entry["f32_source"] = src + "flash_stream.cu"
            entry["longctx_32k_shape"] = rows[
                "flash_attention_lse_streamed_bwd@32k"]
        if name in ("flash_fwd_two_pass", "flash_fwd_full_row"):
            entry["bf16_kernel"] = ("wg_two_pass_kernel: wgmma from TMA-fed "
                                    "shared memory (csrc/wgmma_tile.cuh, "
                                    "csrc/flash_wg.cuh)")
            entry["f32_kernel"] = "two_pass_kernel: FMA (csrc/mma_tile.cuh)"
        if name == "flash_fwd_row_state":
            entry["f32_source"] = src + "flash_probe.cu"
            entry["bf16_kernel"] = ("wg_fwd_kernel, K1f's, at the race's key "
                                    "tile without the lse: wgmma from "
                                    "TMA-fed shared memory "
                                    "(csrc/wgmma_tile.cuh, csrc/flash_wg.cuh)")
            entry["f32_kernel"] = "row_state_kernel: FMA (csrc/mma_tile.cuh)"
        if name == "flash_bwd_row_state":
            entry["f32_source"] = src + "flash_probe_bwd.cu"
            entry["bf16_kernel"] = ("wg_dq_kernel (the caller's delta) and "
                                    "wg_dkv_kernel, K1b's pair: wgmma from "
                                    "TMA-fed shared memory "
                                    "(csrc/wgmma_tile.cuh)")
            entry["f32_kernel"] = ("row_state_dq_kernel, row_state_dkv_kernel:"
                                   " FMA (csrc/mma_tile.cuh)")
        entries.append(entry)
    print(json.dumps({"kernels": entries}))
    print(_card())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

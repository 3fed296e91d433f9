"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

Run from the repository root on a machine with a CUDA card and the CUDA
toolkit (``nvcc``)::

    python3 chip_smoke.py

Each phase prints one JSON line and raises on failure (nothing is
caught):

1. ``env``: torch, the card, its power limit.
2. ``build``: compiles every kernel source under
   ``tensorflowonspark_tpu_torch/csrc/`` with ``nvcc`` (one process per
   source, all started together), and fails unless ``cuobjdump -sass``
   shows ``HGMMA`` and ``UTMALDG`` in the bf16 Hopper kernels
   (:data:`WGMMA_KERNELS`) and ``-Xptxas=-v`` reports no spills for
   them, nor for the paged-decode kernels (:data:`SPILL_FREE_KERNELS`).
3. ``kernel_case``: the paged-decode kernels (split, combine) against
   their plain PyTorch version on the card, case by case
   (:data:`KERNEL_CASES`: bf16 flagship geometry on bf16 and on int8
   pools, f32 GQA, sliding windows, int8 pools with scales, a length-1
   slot, one long GQA request, more splits than live pages, narrow
   head-dim rows, two chunks of query heads, D=256); bf16 outputs held
   element by element to the row-relative rule of ``flash_case``.
   ``paged_repeat``: two runs of the bf16 kernel give bit-identical
   outputs.
4. ``kernel_timing``: the kernel, its plain version and a library
   yardstick (gather + ``scaled_dot_product_attention``) beside the byte
   bound, at the flagship decode shape, a full 2048-token serving bank
   (B=32) and one long request under GQA (:data:`PAGED_TIMING_SHAPES`).
5. ``slice_flagship``: ``serving_builder`` + ``predict_rows(schedule=
   "continuous")`` at the flagship's full width (L16 H8 Dh128 Dm1024,
   bf16, paged KV) with random weights made from a seed; the kernel's
   launch count over that run must be 16 per decode step.
6. ``slice_kernel_vs_gather``: the same path in f32 at two layers with
   ``paged_impl="kernel"`` and ``"gather"``, on float pools and on the
   int8 KV cache's pools; greedy tokens must agree.
   ``static_serve_flagship`` (phase 7 in the code's comments): the
   reference's default serving paths at the flagship's width on the same
   16 requests, 8 rows a batch.  (1) Static generate (contiguous KV, dot
   attention): tokens/s, latency p50/p99, each batch's prefill and decode
   ms, the share of requests equal to ``slice_flagship``'s paged
   continuous tokens; in f32 every request must equal the contiguous
   continuous schedule's or differ first at a near tie (a top-2 logit
   gap under :data:`NEAR_TIE` of the step's logit spread).  (2) Logits
   serving on 8 x 2048 tokens against the flagship model's own bf16
   forward on the same weights (the :data:`FLASH_TOL` bf16 row rule,
   ``next_token`` equal), rows/s; in f32 on two rows against the f32
   flash forward (K2), to :data:`LOGITS_F32_ROW_REL`; the bf16 flash
   forward's distance printed.  (3) int8 weights, int4 weights (groups
   of 64) and the int8 KV cache, each static and paged continuous:
   tokens/s, decode step ms beside bf16's, the bytes of weights,
   dequantized copies and KV a decode step reads, agreement with bf16;
   K1 16 launches per decode step in every paged run (on int8 pools in
   the int8 KV one), on the first :data:`QUANT_REQUESTS` requests.  In
   f32 each variant's static tokens must equal its contiguous continuous
   schedule's, and int4's paged tokens its contiguous ones, near ties
   apart (the int8 KV cache's on rows of one bucket, to
   :data:`NEAR_TIE_INT8_KV`).  Prints each part's seconds.  (4) The MoE
   flagship (``MOE_FLAGSHIP``) through static generate and logits
   serving, K5 counted exactly (3 per layer per forward).  (5)
   ``TFModel.transform`` at its default schedule and the CLI with
   ``--schedule static`` on an export of the same weights: tokens equal
   to (1)'s.
7. ``flash_case``: the flash kernels (forward, dQ, dK/dV) against their
   plain versions on the card (bf16 flagship geometry, bf16 D=64 GQA, and
   in both types a window across tiles, non-causal, a ragged S=1000 with
   GQA); bf16 outputs are held row by row (:data:`FLASH_TOL`).
   ``flash_repeat``: two runs of the bf16 dQ and dK/dV kernels on the
   flagship case give bit-identical outputs.
8. ``flash_timing``: the three kernels, their plain versions and
   ``scaled_dot_product_attention`` as a yardstick at the flagship
   training shape (B=8, S=2048, H=8, D=128, bf16, causal), beside the
   operation bound; then the kernels and the yardstick under GQA at the
   flagship width (Hkv=2) and at S=8192 (B=2), each checked against the
   plain versions.
   ``flash_offset_case``: the three kernels at a query offset (ring
   attention's chunk at ring distance m: ``q_offset = m * S_local``)
   against their plain versions (:data:`FLASH_OFFSET_CASES`: causal with
   and without a window, GQA and MHA, both types, ragged S, chunks whose
   rows partly see nothing, K2's f32 O from bf16 inputs); the rows and
   keys that see nothing must get exact zeros from K3 and K4.
   ``flash_offset_timing``: the flagship ring's hop-1 chunk (B=2,
   S_local=2048, H=8, Hkv=2, window 512 at q_offset 2048) beside its bound
   over the visible pairs and SDPA with the chunk's boolean mask.
   ``ring_flagship``: the flagship's attention at S=8192 as a ring of 4
   virtual ranks on one card, composed from the port's per-hop ring
   functions, against one full-sequence flash pass (O, lse, dQ, dK, dV),
   windowed and plainly causal, with one launch of each kernel per hop
   of each branch kind (:data:`RING_HOPS`).
9. ``train_flagship``: ``SyncTrainer(loss_fn(model), adamw(1e-4))`` on
   the flagship at full width (f32 master weights, bf16 compute, flash
   attention), one warm-up and two timed ``multi_step`` of K=4 on a
   [4, 8, 2048] batch; losses finite and falling, 16 launches of each
   flash kernel per step, tokens/s, mfu, peak memory.
10. ``train_kernel_vs_dot``: three SGD steps in f32 at two layers with
    ``attention_impl="flash"`` and ``"dot"``; losses agree, and every
    weight leaf agrees to a fraction of how far the steps moved it.
11. ``train_to_serve``: the trained weights through ``serving_builder``
    and ``predict_rows(schedule="continuous")``.
12. ``optimizer_timing``: one update of the port's AdamW beside
    ``torch.optim.AdamW(fused=True)`` over the flagship's parameters.
13. ``gmm_case``: the grouped-matmul kernels (K5 forward, K6 dX, K7 dW)
    against their plain versions on the card, on dropless layouts from
    a skewed router (one heavy expert, one absent): bf16 at the MoE
    flagship's shapes in both directions (D=1024 -> F=4096 and back),
    and both types with ragged counts and edges (:data:`GMM_TOL`); then
    the same with the layout's counts passed to K5 and K6 (and a
    four-token decode layout), whose rows past each expert's count must
    be exactly 0.
14. ``gmm_timing``: the three kernels, their plain versions and a
    library yardstick at the MoE flagship's training shape, beside the
    operation bound; K5 and K6 with and without the counts in both
    geometries on the balanced and the skewed layouts, K7 on the skewed
    layout, and K5 at a four-request decode step.
15. ``moe_train_flagship``: the JAX package's MoE bench model (L4 H8
    Dh128 Dm1024 Dff4096 V32000, 8 experts top-2, dropless, remat
    ``block``, flash attention, bf16 compute over f32 masters) under
    ``SyncTrainer(moe_loss_fn(model), adamw(1e-4), has_aux=True)``, one
    warm-up and two timed ``multi_step`` of K=4 on a [4, 4, 2048] batch;
    losses finite and falling, 24/12/12 launches of K5/K6/K7 and 8/4/4
    of K2/K3/K4 per step, tokens/s, active-parameter mfu, peak memory.
16. ``moe_train_dropless_vs_gather``: three SGD steps in f32 at the MoE
    flagship's widths (two layers, S=512, B=2) with ``dropless`` (the
    kernels) and ``gather`` at capacity factor E/k (plain PyTorch, where
    nothing can drop); losses agree, and every weight leaf agrees to a
    fraction of how far the steps moved it.
17. ``moe_train_to_serve``: the trained MoE weights through
    ``serving_builder`` and ``predict_rows(schedule="continuous")`` (K5
    in every prefill and decode step, K1 in every decode step).
18. ``feed_train_flagship``: the executor-fleet feed path.
    ``cluster.run(LocalEngine(1), feed_train_fn, num_chips_per_node=1,
    input_mode=InputMode.SPARK)`` spawns the compute process on the card
    that ``cluster/gpu_info`` chose; ``TPUCluster.train`` feeds the
    ``train_flagship`` tokens as 32 rows ``{"tokens": int32[2048]}`` for
    3 epochs through the node's queue, and the compute process trains
    the flagship with ``SyncTrainer.train_on_feed`` (columnar, K=4): a
    warm-up call of 4 steps, a timed call of 8, then ``feed.terminate()``
    timed apart (what ``terminate_on_max_steps`` adds).  Its 12 losses must
    equal ``train_flagship``'s within :data:`FEED_LOSS_RTOL` (1e-6)
    relative, K2-K4 must launch 16 x 12 times there, its card's UUID
    must be the one ``gpu_info`` chose, and a second tiny cluster whose
    fn raises at once must fail the driver with an error naming the
    executor.  The fleet observability plane is on (:class:`FleetPlane`):
    ``cluster.run(profile_dir=, profile_steps=4)`` has the compute process
    capture the warm-up call with ``torch.profiler``, whose trace must
    name K2-K4 in 64 kernel events each; ``start_health_plane(port=0)``
    with :data:`FLEET_SLO` runs through ``train``, after which
    ``/metrics`` (strict-parsed) and ``cluster.metrics()`` must count the
    phase's 12 steps, 96 rows and 3 records, ``step-fast`` alone must
    have fired, ``/healthz`` be 200 with the ``ledger`` provider in
    ``/status``, and executor 0 have a fresh snapshot and a clock sample
    (:func:`check_fleet_plane`).  The timed steps' ``train.step_sec``
    (host dispatch) is printed beside their wall.
19. ``feed_ring_train_flagship``: the same training fed through the
    node's shared-memory ring (``TFOS_SHM_FEED=1`` in the executor's
    env): the rows narrowed on the driver to ``uint16`` by
    ``columnar.WireSpec`` (4096 B a row, which meets the default ring
    policy), widened to int32 on the card by ``SyncTrainer(
    device_preprocess={"columns": ["tokens"], "dtype": "int32"})``.  The
    12 losses must equal ``train_flagship``'s within
    :data:`FEED_LOSS_RTOL`, K2-K4 must launch 16 x 12 times, the feed's
    source must be the ring, its wire bytes must equal the columnar
    codec's totals for the three records fed, and no ``tfos_*`` segment
    may be left in ``/dev/shm`` after the engine stops.
20. ``feed_inference_flagship``: batch inference.  64 Examples
    ``{"tokens": int64[2048]}`` written to a TFRecord file with the
    port's ``tfrecord``/``example`` and read back with
    ``columnar.load_tfrecords_columnar`` as ``uint16`` (the native codecs
    must be the ones loaded), scored by ``TPUCluster.inference`` (two
    partitions, ``TFOS_SHM_FEED=1``) in a compute process that runs the
    flagship (bf16) over ``prefetch_to_device(feed.batches(8,
    pad_to_batch=True), host_prefetch=True)`` widening to int32 on the
    card; each row's mean next-token cross-entropy must come back in
    row order within :data:`INFER_RTOL` of the driver's own scores of
    the same batches, with 128 K2 launches and none of K3/K4, on the
    card ``gpu_info`` chose.
21. ``checkpoint_resume_serve``: restartable training and the export.
    Run 1: a one-executor cluster (as ``feed_train_flagship``) trains the
    flagship from the seed-0 tree on the rows of batches 1-6 through
    ``train_on_feed(checkpointer=Checkpointer(d, max_to_keep=2),
    checkpoint_every=6, max_steps=6)`` (K=3), and its compute process
    exits.  Run 2: a new cluster, fed batches 7-12, resumes at step 6
    from the checkpoint, trains to step 12, publishes the weights with
    ``publish_for_serving`` (``model_ref`` naming the JAX package's
    builder) and serves 16 requests from them in memory.  The driver
    then loads the export with ``serving.load_predictor`` and serves the
    same requests.  Checks: ``all_steps() == [6, 12]``; both runs'
    losses within :data:`FEED_LOSS_RTOL` of ``train_flagship``'s steps
    1-6 and 7-12; 96 launches of each of K2-K4 in run 2; the export
    listed as step 12; greedy tokens from the export equal to the
    in-memory ones, with K1 launched on every decode step.  Prints the
    save, restore, export and load seconds and GB/s, bytes on disk, the
    disk's free bytes before the phase and run 2's tokens/s.
22. ``elastic_flagship``: elastic supervision.  ``cluster.run(
    LocalEngine(1), elastic_flagship_fn, elastic=True, max_restarts=1,
    heartbeat_interval=0.5, num_chips_per_node=1)`` trains the flagship
    (f32 masters, ``adamw(1e-4)``, flash) on ``feed_train_flagship``'s 32
    rows, one batch of 8 per partition, for three epochs, through
    ``train_on_feed(checkpointer=Checkpointer(d, max_to_keep=2),
    checkpoint_every=4)``; a ``ChaosPlan().kill_worker(0, at_step=6)``
    SIGKILLs the compute process before step 7.  Checks: the node reaches
    generation 1 with one restart and the run completes; the reborn
    process restored step 4; every partition id is committed in the
    node's ledger and none is pending; the batches trained on the
    surviving trajectory cover every batch of every epoch and their
    repeats are of requeued partitions (uncommitted at the kill),
    covering the dead incarnation's steps 5-6; the reborn losses equal,
    to the bit, those of a ``SyncTrainer`` in this process that restores
    the same checkpoint and takes the same logged batches in order; both
    incarnations run on the card ``gpu_info`` chose; K2-K4 launch 16
    times per step each incarnation took.  From the fleet telemetry
    (:func:`elastic_incident`, :func:`check_incident`):
    ``cluster.metrics()["restart_events"]`` is 1, the generation 1, and
    ``cluster.journal()`` holds the incident in order on the driver's
    clock (the killed incarnation's event, the node's ``restart``, the
    driver's ``executor_restart``, the reborn incarnation's with a new
    pid, a driver's ``executor_dead`` after the kill), nothing twice.
    Prints the recovery's parts in seconds (kill, the monitor's sight of
    the death, REBIRTH, the re-registration after the queue resets, the
    barrier and spawn, the process start, model and restore, the first
    reborn step), the incident's timeline and the saves' seconds.

23. ``pipeline_flagship``: the ML Pipeline API.  ``feed_train_flagship``'s
    96 rows (its three epochs) written as four Example shards by
    ``interchange.save_as_tfrecords(schema="struct<tokens:array<int>>")``
    and read back equal by ``load_tfrecords``.  ``TFEstimator(
    pipeline_train_fn).setInputMapping({"tokens": "tokens"})
    .setClusterSize(1).setBatchSize(8).fit(rows)`` on its default
    ``LocalEngine(1)``: the compute process, on the card ``gpu_info``
    chose, trains as ``feed_train_flagship`` does from the feed of
    sorted-column tuples and exports with ``save_for_serving`` (the
    port's ``model_ref``, the generation ``model_config``, the schema of
    ``serving.infer_output_schema``).  Checks: the 12 losses within
    :data:`FEED_LOSS_RTOL` of ``feed_train_flagship``'s, 192 launches of
    each of K2-K4.  The returned ``TFModel``, continuous schedule on 8
    slots, transforms ``slice_flagship``'s 16 requests on a
    ``LocalEngine(1)``: its greedy tokens must equal the export served in
    the driver (``load_predictor`` -> ``predict_rows``), K1 must launch
    16 times per decode step in the executor, and its columns and types
    must be the export's ``output_schema``.  ``python -m
    tensorflowonspark_tpu_torch.serving`` on the requests written with
    ``interchange`` must write the transform's tokens.  Last,
    ``Dataset.from_tfrecords(shards).batch(8).prefetch(sharding=card)``
    feeds the flagship trainer in the driver for 12 steps, whose losses
    must be within :data:`FEED_LOSS_RTOL` of the fit's.  Prints the
    interchange's seconds and bytes, the fed tokens/s beside
    ``feed_train_flagship``'s and the feed wait, and the transform split
    into the executor's start, the predictor's load and the serving.
24. ``mnist_spark_flagship``: ``examples/mnist/mnist_spark.py``'s flow on
    the port.  ``cluster.run(LocalEngine(1), mnist_spark_fn,
    num_chips_per_node=1, input_mode=InputMode.SPARK)`` and
    ``TPUCluster.train`` of 4096 ``synthetic_mnist`` rows ``(image[784],
    label)`` (the example's data, copied here: its module imports the JAX
    package); the compute process trains ``MNISTNet`` under
    ``adam(1e-3)`` with ``has_aux=True`` through ``train_on_feed(
    columnar=True)`` at batch 64 (64 steps, dropout from a seeded
    generator), exports with ``save_for_serving`` (the JAX package's
    ``model_ref``) and predicts 256 test rows in memory; the driver
    serves them from the export through ``serving.load_predictor``.
    Checks: the mean loss of the last 8 steps under half the first 8's,
    the served predictions equal to the in-memory ones, the fn in
    another process.  Prints steps/s and rows/s (from the second step
    on), the cluster's start and the served accuracy.
25. ``resnet_train_flagship``: bench.py's two ResNet workloads, ResNet56
    on 32 px and ResNet50 (``conv7`` stem) on 224 px, batch 128, bf16
    over f32 masters, seeded weights and the example's synthetic batch,
    under ``SyncTrainer(resnet.loss_fn(model), sgd(
    piecewise_constant_schedule(0.1, {91 epochs: 0.1, 136 epochs: 0.1}),
    momentum=0.9), has_model_state=True)`` as in
    ``examples/resnet/resnet_cifar_tpu.py``: 3 warm-up and 10 timed
    steps.  Checks: losses finite and the last below the first, the
    running statistics moved, the export (``{"params",
    "batch_stats"}``) served through ``load_predictor`` agreeing with
    the in-memory eval forward on 32 images off near ties
    (:data:`VISION_NEAR_TIE`), and ResNet56's f32 eval forward on the
    card within :data:`RESNET_F32_ROW_REL` row-relative of the same
    weights' f32 forward on the CPU, TF32 off.  Prints images/s and mfu
    against 12.3e9 (ResNet50) and 0.357e9 (ResNet56) FLOPs per image
    over :data:`BF16_FLOPS_PER_SEC`, and the peak memory.
26. ``segmentation_flagship``: ``UNet(num_classes=3)`` at its 128x128x3
    input, batch 16, ``adam(1e-3)``, on ``synthetic_shapes`` (copied from
    ``examples/segmentation/segmentation_tpu.py``), 3 warm-up and 20
    timed steps through the example's loop.  Checks: the mean loss of
    the last 3 steps below the first 3's, and the served ``mask`` equal
    to the in-memory argmax off near ties.  Prints images/s.
27. ``prefix_serve_flagship``: the radix prefix cache on the paged
    flagship (:data:`SERVING`, ``prefix_cache`` with the page as block):
    32 requests in 2 families, each a 256-token header and a tail of
    16-160 tokens (:func:`family_requests`).  In f32, TF32 off, the
    first 8 requests' tokens with the cache equal those without it on
    both layouts, near ties apart.  In bf16 a cold job, then a warm one through the same
    memoized predictor: K1 launches = layers x decode steps, every warm
    request hits at least the header, ``prefix_tokens_saved`` = the sum
    of the admits' matched blocks, and after ``reset()`` the pool's
    refcount census is the radix's pages at 1.  Prints tokens/s, TTFT
    p50/p99, prefill wall, cold beside warm, and the pool's shared pages.
28. ``serve_recovery_flagship``: the paged f32 engine with a 3 s
    ``watchdog_timeout`` and a chaos plan's ``wedge_dispatch`` on chunk
    2 (6 s): tokens equal an unwedged run's (near ties apart),
    ``watchdog_fires`` 1, ``recovered`` = the requests in flight at the
    fire, and every K1 launch belongs to a resolved chunk (the abandoned
    one launched none, counted after its worker woke).  Prints the
    seconds from the fire to the next resolved chunk.
29. ``hot_swap_flagship``: steps 1 and 2 (seeds 0 and 1, bf16) published
    with ``publish_for_serving``, and a step 3 with a NaN final norm.
    The f32 paged engine serves 16 requests: with step 3 published its
    canary fails and rolls back (step 1's tokens exactly, the step
    quarantined ``canary_failed``); then step 2 is published at the chunk
    a chaos plan names (``swap_chunk_from_plan``) and ingested onto the
    card by the watcher's thread: requests done before the swap carry
    step 1's tokens, requeued ones step 1's committed prefix, and the
    rest a fresh engine's on step 2 (near ties apart).  Prints the ingest
    s, the swap ms and the requests requeued.
30. ``fused_qkv_flagship``: the flagship with ``fused_qkv``, its weights
    stacked from the seed tree: f32 logits within
    :data:`FUSED_F32_ROW_REL` row-relative of the unfused model's (TF32
    off), three bf16 flash training steps with 16 launches of each of
    K2-K4 a step and finite losses, and the fused export served through
    the paged prefix-cache engine with the unfused f32 model's tokens
    (near ties apart).
31. ``telemetry_serve_flagship``: the serving telemetry plane on the
    paged bf16 flagship with the radix cache: 8 greedy requests of three
    tenants, each with a ``trace_id``, sharing a 256-token system prompt
    (:data:`TELEMETRY_TENANTS`).  After one warm-up job with the plane on
    and one with it off, :data:`TELEMETRY_PAIRS` pairs of jobs run, on
    then off, off then on: tokens equal token for token across all but the
    cold warm-up; in the first measured job with
    the plane on, the ledger's per-request ``chip_sec`` sums to the
    engine's ``decode_wall_sec`` (1e-9 relative), the per-tenant tokens
    in and out to the engine's totals, every request holds page-seconds,
    ``prefix_tokens_saved`` equals the ``prefix_cache.tokens_saved``
    delta, ``serving.completed`` moved by 8, the latency and TTFT
    histograms by 8 each, the Chrome trace parses and each request's
    trace holds ``admission``, ``prefill`` and a ``decode_chunk``, and K1
    ran layers x decode steps.  A job with ``profile_dir`` and
    ``profile_steps=3`` writes a ``torch.profiler`` trace that names K1's
    ``paged_decode_split``.  Prints decode tokens/s with the plane on and
    off (and each pair's ratio, and each job's garbage collections) beside
    the card's name and power limit, and latency and TTFT p50/p99 from the
    histograms.  ``serve_recovery_flagship`` also holds
    the flight recorder: its watchdog fire leaves exactly one bundle,
    whose events hold the ``watchdog_fire`` and whose spans the recent
    ``decode_chunk``s.
32. ``disagg_serve_flagship``: prefill/decode disaggregation on the
    paged bf16 flagship, ``slice_flagship``'s 16 requests on 8 slots (the
    pool with one slot's span of spare pages).  One predictor serves them
    unified, split (``ServingEngine(disaggregate=True)``: each admit a
    ``PrefillWorker`` prefill into the shared pool under a handoff lease,
    then ``SlotDecoder.adopt``), and split, on the first 8, under a chaos
    plan that leaks a one-page lease (0.5 s deadline) and kills the
    worker at the same prefill, with a 30 s prefill watchdog.  Gates:
    the split's and the faulted job's tokens equal the unified one's
    request by request; K1
    = layers x decode steps in every job; one adopt per request, each
    leaving every pool's ``data_ptr`` and version alone; one more adopt
    alone dispatches exactly the state writes the decoder counts
    (``last_adopt_dispatches``), and the device ops ``torch.profiler``
    saw are printed beside them (not gated: this late in the process the
    profiler records no memory copies, and the writes are copies);
    no page, handoff or lease left after a job; one worker death and both
    leases reaped; ``forensics.explain`` over the job's journal export and
    the flight recorder's bundles (and the module's CLI) name
    ``kill_prefill``, triggered by ``prefill_worker_dead``.  Prints TTFT
    p50/p99 and decode tokens/s of each job.  ``wedge_prefill`` is held
    on the CPU only (its hang is its cost).
33. ``spec_serve_flagship``: speculative decoding.  The first 8 of the 16
    requests, 32 new tokens, paged, continuous (chunks of 8 steps or
    rounds): without a draft and with
    a 2-layer draft cut from the flagship's seed tree (its embedding,
    first two blocks, final norm and head; ``draft_len`` 4), in f32 (the
    speculative tokens must equal the plain ones, near ties apart) and in
    bf16 (reported): accepted/proposed, rounds, tokens/s and TTFT beside
    the plain run's.  In f32 also with the whole model as its own draft,
    which must accept drafts (the accepted path on the card).  In bf16
    the plain job runs once more through the gather path
    (``paged_impl="gather"``, the verify's path): the speculative tokens'
    agreement with it, and the top-2 gap over the spread at each first
    difference from the plain (K1) run, say whether the two paths'
    rounding is what parts them.  K1 runs layers x decode steps in the
    plain job and never in the others (the verify blocks take the
    gather path).  Then static ``generate_speculative`` on 8 rows of a
    32-token seeded motif repeated 8 times, 32 new tokens, in f32 against
    static greedy ``generate`` (near ties apart), by prompt lookup
    (``speculative=True``, ``ngram`` 2) and with the model as its own
    draft, which must accept drafts: rounds and tokens per round.
34. ``ps_mnist_flagship``: ``examples/mnist/mnist_ps.py``'s flow on the
    port with an evaluator and the managed TensorBoard in one cluster:
    ``cluster.run(LocalEngine(4), num_ps=1, eval_node=True,
    tensorboard=True, log_dir=, InputMode.TENSORFLOW)``, four processes
    on the card (``num_chips_per_node=None``).  ps:0 runs
    ``parallel.ps.run_server``; each worker 60 steps of ``MNISTNet(128)``
    on its own ``synthetic_mnist(2048)`` rows under
    ``AsyncTrainer(adam(1e-3))``; the evaluator pulls the PS's params and
    scores 256 held-out rows until both workers stopped, then once more.
    TensorBoard is a stub on the executors' ``PATH`` (the card's machine
    has none).  Gates: the roles; each worker's loss falls; the evaluator
    scored at least twice and its last loss equals the driver's on the
    PS's params (1e-6); the TensorBoard URL answers 200 and its pid is
    gone after ``shutdown``; the ps process holds no CUDA context; both
    service nodes stopped.  Prints steps/s, push-pull ms p50/p99 and
    bytes a step each way per worker, the startup, and
    ``mnist_spark_flagship``'s steps/s.
35. ``ps_lm_flagship``: ``bench.py``'s ``ps_tpu_bench`` at the flagship's
    width (2 layers, B=4, S=2048, ``sgd(0.01)``): ``AsyncTrainer``
    here against two shards in spawned CPU processes, pipelined,
    unpipelined and compressed (overlap, int8 pushes, int8 delta
    replies), then ``SyncTrainer``.  Gates: K2-K4 = 2 x 7 launches in
    each variant, the unpipelined loss falls, the compressed pushes at
    most 0.27 of the dense bytes a step, and one overlapped step's
    pushed gradients equal a blocking readback bit for bit.  Prints
    steps/s and KB a step each way per variant, readback ms, the reply's
    copy onto the card (ms), round trip p50/p99 and ``async_vs_sync``.

Phases 27-33 (``prefix_serve_flagship`` through ``spec_serve_flagship``)
and ``elastic_flagship`` run the flagship cut to :data:`CUT_LAYERS`
layers (its first blocks) in :func:`main`.

Then a ``kernels`` summary line, the ``nvidia-smi`` name/power-limit
line, and as the last line ``{"ok": true, "device": {...}}``.  Without a
CUDA device the script exits non-zero before printing any result.
``phase_train_profile`` (not run by :func:`main`) breaks a training step
down by kernel class for the dense or the MoE flagship, and
``phase_serve_profile`` (not run by it either) a serving decode step;
``phase_register_probe`` (not run by it either) builds a minimal kernel
in five variants of its roles and waits and reports ptxas's registers
and spills; ``phase_feed_global_stop(4)`` (not run by it either; four
cards) holds the feed path's global stop across four executors with a
card each, over NCCL with a ``gloo`` flag group, and their weights equal
after training; ``phase_sp_train_flagship(4)`` (not run by it either;
four cards) trains the flagship sequence-parallel at S=8192 (ring with
and without a window, Ulysses, and a data x seq mesh) through
``cluster.run`` and ``SyncTrainer(mesh=)``, and holds the ranks' losses
and weights equal and the losses to one card's full-sequence run;
``phase_elastic_dp(4)`` (not run by it either; four cards) kills rank 1
of four NCCL ranks mid-training under ``elastic=True`` and holds every
rank to one generation, equal weights, committed partitions and its
card in both generations.  NCCL
refuses two ranks on one card, so :func:`main` holds the ring's per-hop
arithmetic on one card instead (``ring_flagship``).
"""

import json
import logging
import os
import re
import shutil
import subprocess
import sys
import threading
import time

import numpy as np
import torch

#: H100 SXM memory rate and f32 (non-tensor-core) peak, NVIDIA data sheet
HBM_BYTES_PER_SEC = 3.35e12
F32_FLOPS_PER_SEC = 67e12

FLAGSHIP = dict(
    vocab_size=32000, num_layers=16, num_heads=8, head_dim=128,
    embed_dim=1024, mlp_dim=4096, max_seq_len=2048, dtype="bfloat16",
)
SERVING = dict(
    mode="generate", kv_layout="paged", kv_page_tokens=16,
    max_new_tokens=64, chunk_size=16, pad_multiple=64, max_prompt_len=448,
)
SLOTS = 8
REQUESTS = 16


def emit(phase, **fields):
    print(json.dumps(dict(phase=phase, **fields)), flush=True)


def nvidia_smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def phase_env():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if not os.environ.get("TFOS_BLACKBOX_DIR"):
        # the flight recorder's bundles go to a directory of this run
        import atexit
        import tempfile

        d = tempfile.mkdtemp(prefix="chip_smoke_blackbox_")
        os.environ["TFOS_BLACKBOX_DIR"] = d
        atexit.register(shutil.rmtree, d, ignore_errors=True)
    emit("env", torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0),
         capability=list(torch.cuda.get_device_capability(0)),
         nvidia_smi=nvidia_smi())


#: library -> the Hopper kernels built in it whose SASS must hold every
#: instruction of :data:`SASS_MUST_HOLD`, with no spills in ``-Xptxas=-v``
#: (each name matched as a substring of the mangled names, so no name may
#: be a substring of another's)
WGMMA_KERNELS = {"flash_attention": ["flash_fwd_wgmma", "flash_dq_wgmma",
                                     "flash_dkv_wgmma"],
                 "gmm": ["tgmm_wgmma", "gmm_rows_wgmma"]}
#: warpgroup MMA (``wgmma``) and TMA tile loads (``cp.async.bulk.tensor``)
SASS_MUST_HOLD = ("HGMMA", "UTMALDG")
#: library -> kernels of it that must spill nothing in ``-Xptxas=-v``
#: (no instruction required of their SASS); names as for WGMMA_KERNELS
SPILL_FREE_KERNELS = {"paged_attention": ["paged_decode_split",
                                          "paged_combine"]}


def cuda_tool(name):
    """A CUDA toolkit program: ``PATH``, then ``$CUDA_HOME/bin``."""
    return shutil.which(name) or os.path.join(
        os.environ.get("CUDA_HOME") or "/usr/local/cuda", "bin", name)


def sass_functions(library):
    """``{mangled function name: SASS text}`` of a built library, from
    ``cuobjdump -sass``."""
    text = subprocess.run(
        [cuda_tool("cuobjdump"), "-sass", library], check=True,
        capture_output=True, text=True, timeout=300).stdout
    funcs, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
        elif name is not None:
            funcs[name].append(line)
    return {n: "\n".join(lines) for n, lines in funcs.items()}


def ptxas_functions(report):
    """``{mangled function name: {registers, stack, spill_stores,
    spill_loads}}`` from an ``-Xptxas=-v`` report."""
    funcs, name = {}, None
    for line in report.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = {}
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name is not None:
            funcs[name].update(stack=int(m.group(1)),
                               spill_stores=int(m.group(2)),
                               spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name is not None:
            funcs[name]["registers"] = int(m.group(1))
    return funcs


def wgmma_sass_check(library, kernel, report, must_hold=SASS_MUST_HOLD):
    """What the SASS and the compiler report say of one Hopper kernel:
    each of its instantiations must hold every instruction of
    ``must_hold`` and spill nothing."""
    sass = {n: t for n, t in sass_functions(library).items() if kernel in n}
    ptxas = {n: f for n, f in ptxas_functions(report).items() if kernel in n}
    found = {n: {op: op in t for op in must_hold}
             for n, t in sass.items()}
    warnings = [line.strip() for line in report.splitlines()
                if "warning" in line.lower()]
    ok = (bool(sass) and set(sass) == set(ptxas)
          and all(all(v.values()) for v in found.values())
          and all(f.get("spill_stores", 1) == 0 and f.get("spill_loads", 1)
                  == 0 for f in ptxas.values()))
    return dict(kernel=kernel, instructions=found, ptxas=ptxas,
                ptxas_warnings=warnings, ok=ok)


def phase_build():
    from tensorflowonspark_tpu_torch.ops import _build

    t0 = time.perf_counter()
    secs = _build.build()
    reports = {name: _build.build_report(name) for name in secs}
    checks = {name: [wgmma_sass_check(_build.library_path(name), kernel,
                                      reports[name]) for kernel in kernels]
              for name, kernels in WGMMA_KERNELS.items()}
    checks.update({
        name: [wgmma_sass_check(_build.library_path(name), kernel,
                                reports[name], must_hold=())
               for kernel in kernels]
        for name, kernels in SPILL_FREE_KERNELS.items()})
    emit("build", seconds=time.perf_counter() - t0, per_library=secs,
         ptxas=reports, sass_check=checks)
    bad = [c for cs in checks.values() for c in cs if not c["ok"]]
    if bad:
        raise AssertionError(
            "Hopper kernels without {0} in their SASS (WGMMA_KERNELS), or "
            "spilling: {1}".format("/".join(SASS_MUST_HOLD), bad))


def make_paged_case(gen, *, b, h, hkv, d, t, nb, lengths, dtype,
                    pool_dtype=None, idle=()):
    """Pools with a private page run per live slot (page 0 is the trash
    page), idle slots' tables all on page 0, random q/K/V."""
    dev = "cuda"
    pool_dtype = pool_dtype or dtype
    p = b * nb + 1
    shape = (p, t, hkv, d)
    if pool_dtype == torch.int8:
        k = torch.randint(-127, 128, shape, generator=gen, device=dev,
                          dtype=torch.int8)
        v = torch.randint(-127, 128, shape, generator=gen, device=dev,
                          dtype=torch.int8)
        ks = torch.rand(shape[:3] + (1,), generator=gen, device=dev) / 64
        vs = torch.rand(shape[:3] + (1,), generator=gen, device=dev) / 64
    else:
        k = torch.randn(shape, generator=gen, device=dev).to(pool_dtype)
        v = torch.randn(shape, generator=gen, device=dev).to(pool_dtype)
        ks = vs = None
    q = torch.randn((b, h, d), generator=gen, device=dev).to(dtype)
    perm = torch.randperm(p - 1, generator=gen, device=dev) + 1
    tables = perm[:b * nb].reshape(b, nb).to(torch.int32)
    for i in idle:
        tables[i] = 0
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return dict(q=q, k_pool=k, v_pool=v, block_tables=tables, lengths=lens,
                k_scale_pool=ks, v_scale_pool=vs)


#: the paged-decode kernel against its plain version: f32 to 1e-5
#: absolute (the same f32 products summed in another order, the splits
#: combined); bf16 every element to ``FLASH_TOL["bf16_row_rel"]`` of
#: |ref| + the RMS of its row of D values (:func:`row_relative_error`),
#: which holds a dropped page at long lengths far more tightly than a
#: max-abs rule
PAGED_F32_TOL = 1e-5

#: (name, make_paged_case spec, window); the split counts are the
#: wrapper's (``ops/paged_attention.num_splits`` on 132 SMs: 9 for the
#: two flagship cases, 128 for the long request, 16 and 8 for the two
#: cases with more splits than some slots' live pages)
KERNEL_CASES = [
    ("flagship_bf16_mha", dict(
        b=8, h=8, hkv=8, d=128, t=16, nb=32, dtype=torch.bfloat16,
        lengths=[1, 17, 100, 255, 256, 257, 511, 512], idle=(0,),
    ), 0),
    # the int8 KV cache's pools at the flagship's serving shapes
    ("flagship_bf16_int8_pools", dict(
        b=8, h=8, hkv=8, d=128, t=16, nb=32, dtype=torch.bfloat16,
        pool_dtype=torch.int8,
        lengths=[1, 17, 100, 255, 256, 257, 511, 512], idle=(0,),
    ), 0),
    ("f32_gqa", dict(
        b=4, h=8, hkv=2, d=128, t=16, nb=8, dtype=torch.float32,
        lengths=[5, 16, 33, 128],
    ), 0),
    ("f32_window_across_pages", dict(
        b=4, h=8, hkv=4, d=64, t=16, nb=8, dtype=torch.float32,
        lengths=[10, 40, 77, 128],
    ), 37),
    ("int8_pools_with_scales", dict(
        b=4, h=8, hkv=2, d=128, t=16, nb=8, dtype=torch.float32,
        pool_dtype=torch.int8, lengths=[3, 31, 64, 100],
    ), 0),
    ("bf16_int8_pools", dict(
        b=2, h=8, hkv=8, d=128, t=16, nb=4, dtype=torch.bfloat16,
        pool_dtype=torch.int8, lengths=[20, 64],
    ), 0),
    ("length_one_slot", dict(
        b=3, h=8, hkv=8, d=128, t=16, nb=4, dtype=torch.float32,
        lengths=[1, 1, 49], idle=(1,),
    ), 0),
    # S3 of kernel_timing: one long request under GQA, 128 splits
    ("bf16_long_gqa_request", dict(
        b=1, h=8, hkv=2, d=128, t=16, nb=128, dtype=torch.bfloat16,
        lengths=[2048],
    ), 0),
    # 16 splits: three slots have fewer live pages (empty splits)
    ("bf16_splits_past_live_pages", dict(
        b=4, h=8, hkv=2, d=128, t=16, nb=16, dtype=torch.bfloat16,
        lengths=[1, 20, 100, 256],
    ), 0),
    # the window's first position falls inside a page of a split; 8
    # splits over 7 live pages
    ("bf16_window_edge_inside_split", dict(
        b=2, h=8, hkv=4, d=64, t=16, nb=16, dtype=torch.bfloat16,
        lengths=[200, 250],
    ), 100),
    # 72-byte rows: 8-byte copies
    ("bf16_d36_narrow_rows", dict(
        b=3, h=4, hkv=2, d=36, t=16, nb=8, dtype=torch.bfloat16,
        lengths=[5, 64, 127],
    ), 0),
    # 66-byte rows: element copies
    ("bf16_d33_element_copies", dict(
        b=2, h=4, hkv=4, d=33, t=8, nb=6, dtype=torch.bfloat16,
        lengths=[7, 48],
    ), 0),
    # 36-byte int8 rows (4-byte copies) with scales and a window
    ("f32_int8_d36_window", dict(
        b=2, h=4, hkv=1, d=36, t=8, nb=10, dtype=torch.float32,
        pool_dtype=torch.int8, lengths=[30, 77],
    ), 20),
    # G=16: two chunks of 8 query heads
    ("f32_mqa_two_head_chunks", dict(
        b=2, h=16, hkv=1, d=64, t=16, nb=8, dtype=torch.float32,
        lengths=[50, 128],
    ), 0),
    # D=256: 8 elements a lane, 8 query heads in registers
    ("bf16_d256_gqa8", dict(
        b=2, h=16, hkv=2, d=256, t=16, nb=8, dtype=torch.bfloat16,
        lengths=[33, 128],
    ), 0),
]


def paged_error(out, ref):
    """``(max abs err, checked err, tolerance)`` of a paged-decode output
    against its plain version: the max abs error in f32, the
    row-relative error in bf16."""
    got, want = out.float(), ref.float()
    err = (got - want).abs().max().item()
    if ref.dtype == torch.bfloat16:
        checked, tol = row_relative_error(got, want), FLASH_TOL["bf16_row_rel"]
    else:
        checked, tol = err, PAGED_F32_TOL
    if not torch.isfinite(got).all().item():
        err = checked = float("inf")
    return err, checked, tol


def paged_args(case, window=0):
    args = [case[k] for k in ("q", "k_pool", "v_pool", "block_tables",
                              "lengths")]
    kw = dict(window=window, k_scale_pool=case["k_scale_pool"],
              v_scale_pool=case["v_scale_pool"])
    return args, kw


def paged_case_results():
    """``(name, dtype, (max abs err, checked err, tol))`` for each of
    :data:`KERNEL_CASES`, inputs drawn on the card from one seed."""
    from tensorflowonspark_tpu_torch.ops.paged_attention import (
        paged_attention, paged_attention_reference,
    )

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    for name, spec, window in KERNEL_CASES:
        case = make_paged_case(gen, **spec)
        args, kw = paged_args(case, window)
        out = paged_attention(*args, **kw)
        torch.cuda.synchronize()
        ref = paged_attention_reference(*args, **kw)
        yield name, spec["dtype"], paged_error(out, ref)


def phase_kernel_cases():
    for name, dtype, (err, checked, tol) in paged_case_results():
        ok = checked <= tol
        emit("kernel_case", case=name, dtype=str(dtype), max_abs_err=err,
             checked_err=checked, tol=tol, ok=ok)
        if not ok:
            raise AssertionError(
                "kernel case {0}: checked err {1} > {2}".format(
                    name, checked, tol))


def phase_paged_repeat():
    """Two runs of the bf16 kernel on the flagship case of
    :data:`KERNEL_CASES` (several splits, so the combine runs) must give
    bit-identical outputs."""
    from tensorflowonspark_tpu_torch.ops.paged_attention import (
        paged_attention,
    )

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    _, spec, window = KERNEL_CASES[0]
    args, kw = paged_args(make_paged_case(gen, **spec), window)
    runs = [paged_attention(*args, **kw) for _ in range(2)]
    torch.cuda.synchronize()
    same = torch.equal(runs[0], runs[1])
    emit("paged_repeat", case=KERNEL_CASES[0][0], bit_identical=same,
         ok=same)
    if not same:
        raise AssertionError("bf16 paged kernel differs between two runs")


def bytes_and_flops(case, t):
    """Least bytes the decode attention must move (each live page of
    each kv head read once, q read, out written, tables and lengths
    read) and its f32 operations."""
    q, k = case["q"], case["k_pool"]
    b, h, d = q.shape
    hkv = k.shape[2]
    lens = case["lengths"].cpu().numpy().astype(np.int64)
    live = int((-(-lens // t) * t).sum())
    nbytes = live * hkv * d * 2 * k.element_size()
    if case["k_scale_pool"] is not None:
        nbytes += live * hkv * 2 * 4
    nbytes += 2 * q.numel() * q.element_size()
    nbytes += case["block_tables"].numel() * 4 + b * 4
    flops = 4 * h * d * int(lens.sum())
    return nbytes, flops


def time_ms(fn, inputs, reps=200, warmup=20):
    """Median per-call device time over ``reps`` calls, cycling through
    ``inputs`` (enough copies of the pools to exceed the L2 cache, so
    each call reads its KV cold, as the decode path does between
    layers)."""
    for i in range(warmup):
        fn(inputs[i % len(inputs)])
    torch.cuda.synchronize()
    samples = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(reps):
            fn(inputs[i % len(inputs)])
        end.record()
        torch.cuda.synchronize()
        samples.append(start.elapsed_time(end) / reps)
    return float(np.median(samples))


def device_ms(fn, inputs, reps=50, warmup=5):
    """Mean device time per call of ``fn`` (every CUDA kernel it runs),
    from ``torch.profiler`` over ``reps`` calls cycling through
    ``inputs``: for calls shorter than their host-side cost, where CUDA
    events around back-to-back calls would time the host instead."""
    from torch.profiler import ProfilerActivity, profile

    for i in range(warmup):
        fn(inputs[i % len(inputs)])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(reps):
            fn(inputs[i % len(inputs)])
        torch.cuda.synchronize()
    us = sum(float(getattr(e, "self_device_time_total", 0.0)
                   or getattr(e, "self_cuda_time_total", 0.0))
             for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    return us / 1e3 / reps


def graph_ms(fn, inputs, reps=50):
    """Device time per call of ``fn`` with no host in the way: ``reps``
    calls cycling through ``inputs`` captured in one CUDA graph, the
    median over five timed replays (CUDA events) divided by ``reps``.
    Each call's kernels and the gaps between them count; the host's
    dispatch does not."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(3):
            fn(inputs[i % len(inputs)])
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            fn(inputs[i % len(inputs)])
    graph.replay()
    torch.cuda.synchronize()
    samples = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        samples.append(start.elapsed_time(end) / reps)
    del graph
    return float(np.median(samples))


#: the shapes ``kernel_timing`` times (bf16, T=16, D=128): the flagship
#: decode step, which the ``kernels`` line reports; a full serving bank
#: at the flagship's max_seq_len; one long request under GQA.  Lengths
#: are drawn from ``np.random.default_rng(seed)`` in [lo, hi].
PAGED_TIMING_SHAPES = [
    ("s1_flagship", dict(b=8, h=8, hkv=8, nb=32, lo=32, hi=500, seed=1)),
    ("s2_full_bank", dict(b=32, h=8, hkv=8, nb=128, lo=1024, hi=2048,
                          seed=2)),
    ("s3_long_gqa", dict(b=1, h=8, hkv=2, nb=128, lo=2048, hi=2048,
                         seed=3)),
]
#: bytes of pools the timed calls cycle through: three times the L2
TIMING_POOL_BYTES = 150e6


def paged_timing_at(gen, *, b, h, hkv, nb, lo, hi, seed, d=128, t=16):
    """The kernel, its plain version and gather + SDPA at one bf16 decode
    shape, beside the byte bound; the kernel checked against the plain
    version first.  Each call reads its pools cold: the calls cycle
    through copies of the pools worth :data:`TIMING_POOL_BYTES`.
    Needs only the wrapper's public functions."""
    from tensorflowonspark_tpu_torch.ops.paged_attention import (
        gather_pool, paged_attention, paged_attention_reference,
    )

    rng = np.random.default_rng(seed)
    lengths = sorted(int(x) for x in rng.integers(lo, hi + 1, size=b))
    spec = dict(b=b, h=h, hkv=hkv, d=d, t=t, nb=nb, dtype=torch.bfloat16,
                lengths=lengths)
    pool_bytes = 2 * (b * nb + 1) * t * hkv * d * 2
    n_copies = max(2, int(np.ceil(TIMING_POOL_BYTES / pool_bytes)))
    copies = [make_paged_case(gen, **spec) for _ in range(n_copies)]
    case = copies[0]
    span = torch.arange(nb * t, device="cuda")
    for c in copies:
        c["mask"] = (span[None, :] < c["lengths"][:, None].long())[
            :, None, None, :]

    def run(c):
        return paged_attention(c["q"], c["k_pool"], c["v_pool"],
                               c["block_tables"], c["lengths"])

    def plain(c):
        return paged_attention_reference(c["q"], c["k_pool"], c["v_pool"],
                                         c["block_tables"], c["lengths"])

    def library(c):
        kk = gather_pool(c["k_pool"], c["block_tables"]).transpose(1, 2)
        vv = gather_pool(c["v_pool"], c["block_tables"]).transpose(1, 2)
        return torch.nn.functional.scaled_dot_product_attention(
            c["q"][:, :, None], kk, vv, attn_mask=c["mask"],
            enable_gqa=hkv != h,
        )[:, :, 0]

    out = run(case)
    ref = plain(case)
    lib = library(case)
    torch.cuda.synchronize()
    err, checked, tol = paged_error(out, ref)
    lib_err = (lib.float() - ref.float()).abs().max().item()
    del out, ref, lib
    if not checked <= tol:
        raise AssertionError("kernel at B={0} H={1} Hkv={2} NB={3}: checked "
                             "err {4} > {5}".format(b, h, hkv, nb, checked,
                                                    tol))
    nbytes, flops = bytes_and_flops(case, t)
    bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_SEC
    ops_ms = 1e3 * flops / F32_FLOPS_PER_SEC
    kernel_ms = graph_ms(run, copies)
    heavy = nb * b > 1024
    return dict(
        shape=dict(B=b, H=h, Hkv=hkv, D=d, T=t, NB=nb, lengths=lengths,
                   dtype="bfloat16"),
        pool_copies=n_copies,
        kernel_ms=kernel_ms,
        kernel_device_ms=device_ms(run, copies),
        kernel_eager_ms=time_ms(run, copies),
        plain_ms=time_ms(plain, copies, reps=5 if heavy else 50,
                         warmup=2),
        library_ms=graph_ms(library, copies, reps=4 if heavy else 20),
        library_eager_ms=time_ms(library, copies, reps=10 if heavy else 50,
                                 warmup=2),
        bound_ms=max(bytes_ms, ops_ms),
        bound_by="bytes" if bytes_ms >= ops_ms else "operations",
        bound_share=max(bytes_ms, ops_ms) / kernel_ms,
        bytes=nbytes, flops=flops, max_abs_err=err, checked_err=checked,
        tol=tol, library_max_abs_err=lib_err,
        note="kernel_ms and library_ms: CUDA-graph replays (device only); "
             "*_eager_ms: back-to-back calls timed by CUDA events, the "
             "host's dispatch included; kernel_device_ms: the profiler's "
             "sum of kernel times per call",
    )


def phase_kernel_timing():
    """:func:`paged_timing_at` over :data:`PAGED_TIMING_SHAPES`, one line
    each; returns the flagship shape's timings."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    out = {}
    for name, shape in PAGED_TIMING_SHAPES:
        res = paged_timing_at(gen, **shape)
        emit("kernel_timing", case=name, **res)
        out[name] = res
        torch.cuda.empty_cache()
    return out["s1_flagship"]


def make_requests(rng, n, vocab, lo, hi):
    return [
        {"tokens": rng.integers(0, vocab, size=int(m)).astype(np.int32)}
        for m in rng.integers(lo, hi + 1, size=n)
    ]


def serve(model_cfg, serving_cfg, params, rows):
    from tensorflowonspark_tpu_torch.models.transformer import (
        serving_builder,
    )

    return serve_rows(serving_builder(params, dict(model_cfg, **serving_cfg)),
                      rows)


def serve_rows(predict, rows):
    """``(outputs, stats, wall seconds, K1 launches)`` of ``predict`` over
    ``rows`` on :data:`SLOTS` slots, continuous schedule."""
    from tensorflowonspark_tpu_torch import serving
    from tensorflowonspark_tpu_torch.ops.paged_attention import (
        paged_attention,
    )

    stats = {}
    paged_attention.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = list(serving.predict_rows(
        predict, rows, {"tokens": "tokens"}, batch_size=SLOTS,
        schedule="continuous", stats=stats,
    ))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return out, stats, wall, paged_attention.launches


def pct(values, q):
    return float(np.percentile(np.asarray(list(values), np.float64), q))


def phase_slice_flagship(params, init_s):
    from tensorflowonspark_tpu_torch.models.transformer import (
        TransformerConfig,
    )

    cfg = TransformerConfig(**FLAGSHIP)
    rows = make_requests(np.random.default_rng(2), REQUESTS,
                         cfg.vocab_size, 16, SERVING["max_prompt_len"])
    out, stats, wall, launches = serve(FLAGSHIP, SERVING, params, rows)
    max_new = SERVING["max_new_tokens"]
    for r in out:
        g = np.asarray(r["generated"])
        if g.shape != (max_new,) or g.min() < 0 or g.max() >= cfg.vocab_size:
            raise AssertionError("bad generated row {0}".format(g))
    steps = stats["chunks"] * SERVING["chunk_size"]
    if stats["admitted"] != REQUESTS or len(out) != REQUESTS:
        raise AssertionError("admitted {0} of {1}".format(
            stats["admitted"], REQUESTS))
    if not (steps > 0 and launches == cfg.num_layers * steps):
        raise AssertionError(
            "paged_attention launches {0} != {1} layers x {2} decode "
            "steps".format(launches, cfg.num_layers, steps))
    res = dict(
        model="L16 H8 Dh128 Dm1024 bf16", requests=REQUESTS, slots=SLOTS,
        prompt_lens=[int(len(r["tokens"])) for r in rows],
        params_init_sec=init_s, wall_sec=wall,
        tokens_out=stats["tokens_out"], tokens_per_sec=stats["tokens_out"]
        / wall, decode_steps=steps, chunks=stats["chunks"],
        decode_wall_sec=stats["decode_wall_sec"],
        prefill_wall_sec=stats["prefill_wall_sec"],
        decode_step_ms=1e3 * stats["decode_wall_sec"] / steps,
        paged_attention_launches=launches,
        latency_p50_ms=1e3 * pct(stats["latency_sec"].values(), 50),
        latency_p99_ms=1e3 * pct(stats["latency_sec"].values(), 99),
        ttft_p50_ms=1e3 * pct(stats["ttft_sec"].values(), 50),
        ttft_p99_ms=1e3 * pct(stats["ttft_sec"].values(), 99),
        pool_pages=stats.get("pool_pages"),
        device=torch.cuda.get_device_name(0),
    )
    emit("slice_flagship", **res)
    res["tokens"] = tokens_of(out)
    return res


def phase_kernel_vs_gather():
    """Greedy tokens of the paged schedule through K1 and through the
    plain gather, on the float pools and on the int8 KV cache's pools
    (int8 codes scattered with their scale pools, read by K1)."""
    from tensorflowonspark_tpu_torch import convert
    from tensorflowonspark_tpu_torch.models.transformer import (
        TransformerConfig,
    )

    model_cfg = dict(FLAGSHIP, dtype="float32", num_layers=2)
    params = convert.init_params_tree(TransformerConfig(**model_cfg), seed=3)
    rows = make_requests(np.random.default_rng(4), REQUESTS,
                         model_cfg["vocab_size"], 16,
                         SERVING["max_prompt_len"])
    for cache in ({}, {"cache_dtype": "int8"}):
        runs = {}
        for impl in ("kernel", "gather"):
            out, stats, wall, launches = serve(
                dict(model_cfg, **cache), dict(SERVING, paged_impl=impl),
                params, rows)
            runs[impl] = (np.stack([r["generated"] for r in out]), launches,
                          wall)
        same = bool(np.array_equal(runs["kernel"][0], runs["gather"][0]))
        emit("slice_kernel_vs_gather", model="L2 H8 Dh128 Dm1024 f32",
             cache_dtype=cache.get("cache_dtype", "float32"),
             identical_tokens=same,
             kernel_launches=runs["kernel"][1],
             gather_launches=runs["gather"][1],
             kernel_wall_sec=runs["kernel"][2],
             gather_wall_sec=runs["gather"][2])
        if not same:
            rows_diff = np.nonzero(
                (runs["kernel"][0] != runs["gather"][0]).any(axis=1))[0]
            raise AssertionError(
                "greedy tokens differ between paged_impl kernel and gather "
                "({0}) for requests {1}".format(cache, rows_diff.tolist()))
        if runs["kernel"][1] == 0 or runs["gather"][1] != 0:
            raise AssertionError("launch counts {0}/{1} ({2})".format(
                runs["kernel"][1], runs["gather"][1], cache))


#: flash kernels against their plain versions.  f32 O to 1e-5 and f32
#: dQ/dK/dV to 1e-4 absolute (the same f32 products summed in another
#: order over up to S keys).  lse is f32 in both types: 1e-5 absolute
#: (about ten f32 ulps at |lse| <= 16).  bf16 O/dQ/dK/dV: every element
#: to 2^-5 of |ref| + the RMS of its row of D values
#: (:func:`row_relative_error`; bf16 output
#: rounding, up to 2^-7 of |ref|, plus p and ds rounded to bf16 on
#: either side of a rounding boundary).  The row's own RMS holds the
#: late rows, whose values are ~50x smaller than the first rows', as
#: tightly as the first: a kernel that skips a key tile fails.
FLASH_TOL = {"f32_out": 1e-5, "f32_grad": 1e-4, "lse": 1e-5,
             "bf16_row_rel": 2 ** -5}
FLASH_CASES = [
    ("flagship_bf16_causal", dict(b=2, s=2048, h=8, hkv=8, d=128,
                                  dtype=torch.bfloat16, causal=True)),
    ("f32_gqa", dict(b=2, s=512, h=8, hkv=2, d=128, dtype=torch.float32,
                     causal=True)),
    ("f32_window_300", dict(b=1, s=1024, h=4, hkv=4, d=128,
                            dtype=torch.float32, causal=True, window=300)),
    ("f32_non_causal", dict(b=2, s=256, h=4, hkv=4, d=128,
                            dtype=torch.float32, causal=False)),
    ("f32_ragged_s1000", dict(b=1, s=1000, h=4, hkv=2, d=128,
                              dtype=torch.float32, causal=True)),
    ("bf16_d64_gqa", dict(b=2, s=1024, h=8, hkv=4, d=64,
                          dtype=torch.bfloat16, causal=True)),
    ("bf16_window_300", dict(b=1, s=1024, h=4, hkv=4, d=128,
                             dtype=torch.bfloat16, causal=True, window=300)),
    ("bf16_non_causal", dict(b=2, s=256, h=4, hkv=4, d=128,
                             dtype=torch.bfloat16, causal=False)),
    ("bf16_ragged_s1000_gqa", dict(b=1, s=1000, h=4, hkv=2, d=128,
                                   dtype=torch.bfloat16, causal=True)),
]
#: H100 SXM dense bf16 tensor-core peak, NVIDIA data sheet
BF16_FLOPS_PER_SEC = 989e12


def make_flash_case(gen, *, b, s, h, hkv, d, dtype, causal, window=0):
    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    return dict(q=rnd(b, s, h, d), k=rnd(b, s, hkv, d), v=rnd(b, s, hkv, d),
                dout=rnd(b, s, h, d), scale=d ** -0.5, causal=causal,
                window=window)


def flash_outputs(c):
    """Each kernel's outputs and its plain version's on one case; the
    backward of both takes the plain forward's O and lse."""
    from tensorflowonspark_tpu_torch.ops import flash_attention as fa

    q, k, v, dout = c["q"], c["k"], c["v"], c["dout"]
    kw = dict(scale=c["scale"], causal=c["causal"], window=c["window"])
    ref_out, ref_lse = fa.flash_forward_reference(q, k, v, **kw)
    delta = fa._delta(ref_out, dout)
    args = (q, k, v, dout, ref_lse, delta)
    pos = (kw["scale"], kw["causal"], kw["window"])
    got = dict(zip(("out", "lse"), fa._launch_fwd(q, k, v, *pos)))
    got["dq"] = fa._launch_dq(*args, *pos)
    got["dk"], got["dv"] = fa._launch_dkv(*args, *pos)
    torch.cuda.synchronize()
    ref = dict(out=ref_out, lse=ref_lse,
               dq=fa.flash_dq_reference(*args, **kw))
    ref["dk"], ref["dv"] = fa.flash_dkv_reference(*args, **kw)
    return got, ref


def row_relative_error(got, ref):
    """Largest ``|got - ref| / (|ref| + RMS of ref's row + 2^-6 RMS of
    ref)`` over the elements, a row being the last dimension.  The last
    term holds a row whose exact value cancels to 0 (causal row 0's dQ:
    p = 1 there, so dP equals delta) to the f32 rounding noise of the
    cancellation rather than to nothing."""
    rms = ref.square().mean(dim=-1, keepdim=True).sqrt()
    floor = 2 ** -6 * ref.square().mean().sqrt()
    return ((got - ref).abs() / (ref.abs() + rms + floor).clamp_min(1e-30)) \
        .max().item()


def flash_errors(got, ref, dtype):
    """``{output: (max abs err, checked err, tolerance)}``: the checked
    error is the max abs error for f32 outputs and lse, and
    :func:`row_relative_error` for bf16 O/dQ/dK/dV."""
    out = {}
    for name in ("out", "out_f32", "lse", "dq", "dk", "dv"):
        if name not in got:
            continue
        g, r = got[name].float(), ref[name].float()
        err = (g - r).abs().max().item()
        if name == "lse":
            checked, tol = err, FLASH_TOL["lse"]
        elif dtype == torch.bfloat16:
            checked = row_relative_error(g, r)
            tol = FLASH_TOL["bf16_row_rel"]
        else:
            checked = err
            tol = FLASH_TOL["f32_out" if name == "out" else "f32_grad"]
        if not torch.isfinite(g).all().item():
            err = checked = float("inf")
        out[name] = (err, checked, tol)
    return out


def flash_ok(errs):
    return all(c <= t for _, c, t in errs.values())


def flash_case_errors():
    """``(name, dtype, errors, plain outputs)`` for each of
    :data:`FLASH_CASES`, inputs drawn on the card from one seed."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    for name, spec in FLASH_CASES:
        got, ref = flash_outputs(make_flash_case(gen, **spec))
        yield name, spec["dtype"], flash_errors(got, ref, spec["dtype"]), ref


def phase_flash_cases():
    for name, dtype, errs, _ in flash_case_errors():
        ok = flash_ok(errs)
        emit("flash_case", case=name, dtype=str(dtype),
             max_abs_err={n: e for n, (e, _, _) in errs.items()},
             checked_err={n: c for n, (_, c, _) in errs.items()},
             tol={n: t for n, (_, _, t) in errs.items()}, ok=ok)
        if not ok:
            raise AssertionError("flash case {0}: {1}".format(name, errs))


def phase_flash_repeat():
    """Two runs of the bf16 K3 and K4 on the inputs of the flagship case
    of :data:`FLASH_CASES` must give bit-identical outputs."""
    from tensorflowonspark_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    c = make_flash_case(gen, **dict(FLASH_CASES)["flagship_bf16_causal"])
    q, k, v, dout = c["q"], c["k"], c["v"], c["dout"]
    pos = (c["scale"], c["causal"], c["window"])
    out, lse = fa.flash_forward_reference(q, k, v, scale=pos[0],
                                          causal=pos[1], window=pos[2])
    args = (q, k, v, dout, lse, fa._delta(out, dout))
    runs = [(fa._launch_dq(*args, *pos),) + fa._launch_dkv(*args, *pos)
            for _ in range(2)]
    torch.cuda.synchronize()
    same = {n: torch.equal(x, y)
            for n, x, y in zip(("dq", "dk", "dv"), *runs)}
    emit("flash_repeat", case="flagship_bf16_causal", bit_identical=same,
         ok=all(same.values()))
    if not all(same.values()):
        raise AssertionError("bf16 K3/K4 differ between two runs: "
                             "{0}".format(same))


def flash_bounds(b, s, h, hkv, d, itemsize, causal=True, pairs=None,
                 out_itemsize=None, rows_seen=None, keys_seen=None):
    """Least bytes (each input read once, each output written once) and
    tensor-core flop of K2, K3 and K4 at one shape: one product over the
    visible (query, key) pairs of every query head is 2 * D flop per
    pair.  ``pairs``: the visible pairs of one head where the mask is not
    plain causal (an offset chunk); ``out_itemsize``: K2's O type;
    ``rows_seen`` / ``keys_seen``: the query rows that see a key and the
    keys that a row sees (default S), the only ones whose inputs must be
    read (q, dO, lse, delta per row; k, v per key); every output is
    written in full."""
    if pairs is None:
        pairs = s * (s + 1) // 2 if causal else s * s
    product = 2 * d * b * h * pairs
    rows_seen = s if rows_seen is None else rows_seen
    keys_seen = s if keys_seen is None else keys_seen
    t = b * s * h * d * itemsize  # one [B, S, H, D] tensor
    t_in = b * rows_seen * h * d * itemsize  # its rows that see a key
    tk = b * s * hkv * d * itemsize  # one [B, S, Hkv, D] tensor
    tk_in = b * keys_seen * hkv * d * itemsize  # its keys that are seen
    rows = b * h * s * 4  # one f32 [B, H, S] tensor
    rows_in = b * h * rows_seen * 4
    o = t * (out_itemsize or itemsize) // itemsize
    return {
        # q, k, v -> o, lse
        "fwd": (t_in + 2 * tk_in + o + rows, 2 * product),
        # q, k, v, dO, lse, delta -> dq
        "dq": (2 * t_in + 2 * tk_in + 2 * rows_in + t, 3 * product),
        # ... -> dk, dv
        "dkv": (2 * t_in + 2 * tk_in + 2 * rows_in + 2 * tk, 4 * product),
    }


#: the shapes ``flash_timing`` times (bf16, causal): the flagship training
#: shape, which the ``kernels`` line reports, then GQA at the flagship
#: width and a long sequence
FLASH_TIMING_SHAPES = [
    ("flagship", dict(b=8, s=2048, h=8, hkv=8, d=128)),
    ("gqa_hkv2", dict(b=8, s=2048, h=8, hkv=2, d=128)),
    ("s8192", dict(b=2, s=8192, h=8, hkv=8, d=128)),
]


def flash_timing_at(gen, *, b, s, h, hkv, d, plain=True):
    """K2, K3 and K4 at one bf16 causal shape, checked against their
    plain versions, beside the bound and scaled_dot_product_attention as
    a yardstick (``plain``: the plain versions timed too)."""
    from tensorflowonspark_tpu_torch.ops import flash_attention as fa

    c = make_flash_case(gen, b=b, s=s, h=h, hkv=hkv, d=d,
                        dtype=torch.bfloat16, causal=True)
    got, ref = flash_outputs(c)
    errs = flash_errors(got, ref, torch.bfloat16)
    if not flash_ok(errs):
        raise AssertionError("flash kernels at B={0} S={1} H={2} Hkv={3}: "
                             "{4}".format(b, s, h, hkv, errs))
    q, k, v, dout = c["q"], c["k"], c["v"], c["dout"]
    lse, delta = ref["lse"], fa._delta(ref["out"], dout)
    del got, ref
    pos = (c["scale"], True, 0)
    kw = dict(scale=c["scale"], causal=True, window=0)
    args = (q, k, v, dout, lse, delta)
    runs = {
        "fwd": (lambda _: fa._launch_fwd(q, k, v, *pos),
                lambda _: fa.flash_forward_reference(q, k, v, **kw)),
        "dq": (lambda _: fa._launch_dq(*args, *pos),
               lambda _: fa.flash_dq_reference(*args, **kw)),
        "dkv": (lambda _: fa._launch_dkv(*args, *pos),
                lambda _: fa.flash_dkv_reference(*args, **kw)),
    }
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                  for x in (q, k, v))
    dot_ = dout.transpose(1, 2)
    gqa = dict(enable_gqa=True) if hkv != h else {}

    def lib_fwd(_):
        with torch.no_grad():
            return sdpa(qt, kt, vt, is_causal=True, **gqa)

    def lib_fwd_bwd(_):
        return torch.autograd.grad(sdpa(qt, kt, vt, is_causal=True, **gqa),
                                   (qt, kt, vt), dot_)

    lib_fwd_ms = time_ms(lib_fwd, [None], reps=20, warmup=3)
    lib_bwd_ms = time_ms(lib_fwd_bwd, [None], reps=20, warmup=3) - lib_fwd_ms
    # SDPA's backward is one call for dQ, dK and dV: its time stands on
    # the dq row alone
    library = {
        "fwd": (lib_fwd_ms, "scaled_dot_product_attention(is_causal=True) "
                "forward"),
        "dq": (lib_bwd_ms, "SDPA's backward (forward+backward minus "
               "forward), one call computing dQ, dK and dV: compare with "
               "flash_dq + flash_dkv"),
        "dkv": (None, "SDPA's backward covers dK and dV; its time stands "
                "on flash_dq"),
    }
    bounds = flash_bounds(b, s, h, hkv, d, 2)
    err_of = {"fwd": max(errs["out"][0], errs["lse"][0]),
              "dq": errs["dq"][0], "dkv": max(errs["dk"][0], errs["dv"][0])}
    res = {}
    for name, (kernel, plain_fn) in runs.items():
        nbytes, flops = bounds[name]
        bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_SEC
        ops_ms = 1e3 * flops / BF16_FLOPS_PER_SEC
        res[name] = dict(
            ms=time_ms(kernel, [None], reps=20, warmup=3),
            plain_ms=(time_ms(plain_fn, [None], reps=3, warmup=1)
                      if plain else None),
            bound_ms=max(bytes_ms, ops_ms),
            bound_by="bytes" if bytes_ms >= ops_ms else "operations",
            bytes=nbytes, flops=flops, max_abs_err=err_of[name],
            library_ms=library[name][0], library_note=library[name][1],
        )
        res[name]["tflops"] = flops / res[name]["ms"] / 1e9
    return res


def phase_flash_timing():
    """:func:`flash_timing_at` over :data:`FLASH_TIMING_SHAPES`, one line
    each; returns the flagship shape's timings."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(6)
    out = {}
    for name, shape in FLASH_TIMING_SHAPES:
        res = flash_timing_at(gen, plain=name == "flagship", **shape)
        emit("flash_timing", case=name, shape=dict(
            B=shape["b"], S=shape["s"], H=shape["h"], Hkv=shape["hkv"],
            D=shape["d"], dtype="bfloat16", causal=True), **res)
        out[name] = res
    return out["flagship"]


#: K2-K4 at a query offset against their plain versions (ring attention's
#: chunk at ring distance m runs at q_offset = m * S_local): causal with
#: and without a window, GQA and MHA, both types, ragged S; the first is
#: the flagship ring's hop 1 (B=2, S_local=2048, H=8, Hkv=2, window 512 at
#: q_offset 2048), where rows 511.. see no key and keys ..1536 no row.
#: The next three are the flagship ring's other hop kinds at q_offset 0,
#: K2 taking its f32 O from bf16 inputs as the ring does: a past chunk in
#: full (non-causal) and a rank's own chunk, windowed and plainly causal.
#: Held by ``flash_case``'s rule (:data:`FLASH_TOL`), O over the rows that
#: see a key (elsewhere it must be finite; lse is -1e30 in both), and the
#: rows and keys that see nothing must get exact zeros from K3 and K4.
FLASH_OFFSET_CASES = [
    ("bf16_ring_hop1_gqa_window512", dict(
        b=2, s=2048, h=8, hkv=2, d=128, dtype=torch.bfloat16, causal=True,
        window=512, q_offset=2048)),
    ("bf16_ring_full_hop_gqa", dict(
        b=2, s=2048, h=8, hkv=2, d=128, dtype=torch.bfloat16, causal=False,
        q_offset=0)),
    ("bf16_ring_diag_hop_gqa_window512", dict(
        b=2, s=2048, h=8, hkv=2, d=128, dtype=torch.bfloat16, causal=True,
        window=512, q_offset=0)),
    ("bf16_ring_diag_hop_gqa", dict(
        b=2, s=2048, h=8, hkv=2, d=128, dtype=torch.bfloat16, causal=True,
        q_offset=0)),
    ("bf16_mha_causal_offset200", dict(
        b=1, s=1024, h=4, hkv=4, d=128, dtype=torch.bfloat16, causal=True,
        q_offset=200)),
    ("bf16_d64_gqa_window300_offset700", dict(
        b=1, s=1024, h=8, hkv=2, d=64, dtype=torch.bfloat16, causal=True,
        window=300, q_offset=700)),
    ("bf16_ragged_s1000_mha_window300_offset500", dict(
        b=1, s=1000, h=4, hkv=4, d=128, dtype=torch.bfloat16, causal=True,
        window=300, q_offset=500)),
    ("f32_gqa_window512_offset1024", dict(
        b=1, s=1024, h=4, hkv=2, d=128, dtype=torch.float32, causal=True,
        window=512, q_offset=1024)),
    ("f32_mha_causal_offset200", dict(
        b=1, s=512, h=4, hkv=4, d=128, dtype=torch.float32, causal=True,
        q_offset=200)),
    ("f32_ragged_s1000_gqa_window300_offset700", dict(
        b=1, s=1000, h=4, hkv=2, d=128, dtype=torch.float32, causal=True,
        window=300, q_offset=700)),
]


def offset_mask(s, q_offset, causal=True, window=0):
    """``[S, S]`` bool on the card: which key each local row of a chunk at
    ``q_offset`` sees."""
    qpos = q_offset + torch.arange(s, device="cuda")[:, None]
    kpos = torch.arange(s, device="cuda")[None, :]
    vis = qpos >= kpos if causal else torch.ones_like(qpos >= kpos)
    if window:
        vis &= kpos > qpos - window
    return vis


def flash_offset_outputs(c):
    """Each kernel's outputs at ``c["q_offset"]`` and its plain version's;
    in bf16 K2 also with an f32 O.  The backward of both takes the lse a
    ring hands it (this chunk's merged with another's, here a constant
    log S) and delta of the plain forward's f32 O."""
    import math

    from tensorflowonspark_tpu_torch.ops import flash_attention as fa

    q, k, v, dout = c["q"], c["k"], c["v"], c["dout"]
    kw = dict(scale=c["scale"], causal=c["causal"], window=c["window"],
              q_offset=c["q_offset"])
    pos = (kw["scale"], kw["causal"], kw["window"], kw["q_offset"])
    ref = dict(zip(("out", "lse"), fa.flash_forward_reference(q, k, v,
                                                              **kw)))
    ref_out32, _ = fa.flash_forward_reference(q, k, v, out_dtype=torch.float32,
                                              **kw)
    got = dict(zip(("out", "lse"), fa._launch_fwd(q, k, v, *pos)))
    if q.dtype == torch.bfloat16:
        ref["out_f32"] = ref_out32
        got["out_f32"], _ = fa._launch_fwd(q, k, v, *pos,
                                           out_dtype=torch.float32)
    lse = torch.logaddexp(ref["lse"], torch.full_like(
        ref["lse"], math.log(q.shape[1])))
    delta = fa._delta(ref_out32, dout)
    args = (q, k, v, dout, lse, delta)
    got["dq"] = fa._launch_dq(*args, *pos)
    got["dk"], got["dv"] = fa._launch_dkv(*args, *pos)
    torch.cuda.synchronize()
    ref["dq"] = fa.flash_dq_reference(*args, **kw)
    ref["dk"], ref["dv"] = fa.flash_dkv_reference(*args, **kw)
    return got, ref


def flash_offset_errors(got, ref, c, dtype):
    """:func:`flash_errors` with O over the rows that see a key, plus
    ``unseen``: the largest |dQ| of a row and |dK|, |dV| of a key that see
    nothing (must be 0), inf when O is not finite everywhere."""
    vis = offset_mask(c["q"].shape[1], c["q_offset"], c["causal"],
                      c["window"])
    rows, keys = vis.any(dim=1), vis.any(dim=0)
    sub = {n: x[:, rows] if n.startswith("out") else x
           for n, x in got.items()}
    errs = flash_errors(sub, {n: x[:, rows] if n.startswith("out") else x
                              for n, x in ref.items()}, dtype)
    zero = max([got["dq"][:, ~rows].abs().max().item() if (~rows).any()
                else 0.0] + [got[n][:, ~keys].abs().max().item()
                             if (~keys).any() else 0.0 for n in ("dk", "dv")])
    if not all(torch.isfinite(got[n]).all().item() for n in got):
        zero = float("inf")
    errs["unseen"] = (zero, zero, 0.0)
    return errs


def make_offset_case(gen, q_offset=0, **spec):
    c = make_flash_case(gen, **spec)
    c["q_offset"] = q_offset
    return c


def flash_offset_case_errors():
    """``(name, dtype, errors)`` for each of :data:`FLASH_OFFSET_CASES`,
    inputs drawn on the card from one seed."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(8)
    for name, spec in FLASH_OFFSET_CASES:
        c = make_offset_case(gen, **spec)
        got, ref = flash_offset_outputs(c)
        yield name, spec["dtype"], flash_offset_errors(got, ref, c,
                                                       spec["dtype"])


def phase_flash_offset_cases():
    for name, dtype, errs in flash_offset_case_errors():
        ok = flash_ok(errs)
        emit("flash_offset_case", case=name, dtype=str(dtype),
             q_offset=dict(FLASH_OFFSET_CASES)[name]["q_offset"],
             max_abs_err={n: e for n, (e, _, _) in errs.items()},
             checked_err={n: x for n, (_, x, _) in errs.items()},
             tol={n: t for n, (_, _, t) in errs.items()}, ok=ok)
        if not ok:
            raise AssertionError("flash offset case {0}: {1}".format(name,
                                                                    errs))


def phase_flash_offset_timing():
    """K2 (f32 O, as the ring takes it), K3 and K4 on the flagship ring's
    hop-1 chunk (:data:`FLASH_OFFSET_CASES`' first) beside their plain
    versions, the bound over this chunk's visible pairs, and SDPA with
    the same boolean mask as the yardstick."""
    import math

    from tensorflowonspark_tpu_torch.ops import flash_attention as fa

    name, spec = FLASH_OFFSET_CASES[0]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(9)
    c = make_offset_case(gen, **spec)
    got, ref = flash_offset_outputs(c)
    errs = flash_offset_errors(got, ref, c, spec["dtype"])
    if not flash_ok(errs):
        raise AssertionError("flash offset timing case: {0}".format(errs))
    q, k, v, dout = c["q"], c["k"], c["v"], c["dout"]
    b, s, h, d = q.shape
    hkv = k.shape[2]
    pos = (c["scale"], True, spec["window"], spec["q_offset"])
    kw = dict(scale=c["scale"], causal=True, window=spec["window"],
              q_offset=spec["q_offset"])
    lse = torch.logaddexp(ref["lse"], torch.full_like(ref["lse"], math.log(s)))
    delta = fa._delta(ref["out_f32"], dout)
    args = (q, k, v, dout, lse, delta)
    f32 = torch.float32
    runs = {
        "fwd": (lambda _: fa._launch_fwd(q, k, v, *pos, out_dtype=f32),
                lambda _: fa.flash_forward_reference(q, k, v, out_dtype=f32,
                                                     **kw)),
        "dq": (lambda _: fa._launch_dq(*args, *pos),
               lambda _: fa.flash_dq_reference(*args, **kw)),
        "dkv": (lambda _: fa._launch_dkv(*args, *pos),
                lambda _: fa.flash_dkv_reference(*args, **kw)),
    }
    vis = offset_mask(s, spec["q_offset"], True, spec["window"])
    pairs = int(vis.sum().item())
    rows_seen = int(vis.any(dim=1).sum().item())
    keys_seen = int(vis.any(dim=0).sum().item())
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                  for x in (q, k, v))

    def lib_fwd(_):
        with torch.no_grad():
            return sdpa(qt, kt, vt, attn_mask=vis, enable_gqa=True)

    def lib_fwd_bwd(_):
        return torch.autograd.grad(
            sdpa(qt, kt, vt, attn_mask=vis, enable_gqa=True), (qt, kt, vt),
            dout.transpose(1, 2))

    lib_fwd_ms = time_ms(lib_fwd, [None], reps=20, warmup=3)
    lib_bwd_ms = time_ms(lib_fwd_bwd, [None], reps=20, warmup=3) - lib_fwd_ms
    library = {"fwd": lib_fwd_ms, "dq": lib_bwd_ms, "dkv": None}
    bounds = flash_bounds(b, s, h, hkv, d, 2, pairs=pairs, out_itemsize=4,
                          rows_seen=rows_seen, keys_seen=keys_seen)
    err_of = {"fwd": max(errs["out_f32"][0], errs["lse"][0]),
              "dq": errs["dq"][0], "dkv": max(errs["dk"][0], errs["dv"][0])}
    res = {}
    for kname, (kernel, plain_fn) in runs.items():
        nbytes, flops = bounds[kname]
        bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_SEC
        ops_ms = 1e3 * flops / BF16_FLOPS_PER_SEC
        res[kname] = dict(
            ms=time_ms(kernel, [None], reps=50, warmup=5),
            plain_ms=time_ms(plain_fn, [None], reps=3, warmup=1),
            bound_ms=max(bytes_ms, ops_ms),
            bound_by="bytes" if bytes_ms >= ops_ms else "operations",
            bytes=nbytes, flops=flops, max_abs_err=err_of[kname],
            library_ms=library[kname],
        )
    emit("flash_offset_timing", case=name, shape=dict(
        B=b, S=s, H=h, Hkv=hkv, D=d, dtype="bfloat16", causal=True,
        window=spec["window"], q_offset=spec["q_offset"]),
         visible_pairs_per_head=pairs,
         rows_seeing_a_key=rows_seen, keys_seen=keys_seen,
         library_note="scaled_dot_product_attention(attn_mask=the chunk's "
                      "boolean mask, enable_gqa=True): forward on fwd, "
                      "forward+backward minus forward on dq", **res)
    return res


#: the flagship's attention at full width as a ring of 4 ranks on one
#: card (sequence-parallel training's shape on four cards); the composed
#: ring is held against one full-sequence pass (both K2-K4, bf16) by
#: flash_case's rule (:data:`FLASH_TOL`: the same logits, merged per chunk
#: in f32 instead of in one online softmax)
RING_FLAGSHIP = dict(b=2, s=8192, h=8, hkv=2, d=128, p=4, window=512)
#: hops of each branch kind over the 4 x 4 (rank, hop) pairs: under the
#: 512 window (reach 1) each rank's own chunk and, for ranks 1-3, the one
#: before at q_offset 2048; plainly causal, each rank's own, the r earlier
#: ones in full, the later ones skipped
RING_HOPS = {512: {"diag": 4, "offset": 3, "skip": 9},
             0: {"diag": 4, "full": 6, "skip": 6}}


def branch_kind(branch):
    if branch is None:
        return "skip"
    causal, q_offset = branch
    return "offset" if q_offset else ("diag" if causal else "full")


def ring_compose(q, k, v, dout, p, causal, window, scale):
    """The ring of ``p`` ranks composed on one card from the port's
    per-hop pieces (``hop_branch``, ``chunk_forward``, ``merge_partial``,
    ``chunk_grads``): rank ``r`` holds rows ``r*S/p..`` and at hop ``t``
    sees the chunk of rank ``(r - t) % p``; the dK/dV of a chunk add up
    over the hops that visit it.  Returns ``(out, lse, dq, dk, dv)``
    over the whole sequence and, per branch kind, the hops taken and the
    kernel launches they made."""
    from tensorflowonspark_tpu_torch.ops import flash_attention as fa
    from tensorflowonspark_tpu_torch.ops import ring_attention as ra

    sl = q.shape[1] // p

    def parts(x):
        return [x[:, i * sl:(i + 1) * sl] for i in range(p)]

    qs, ks, vs, dos = (parts(x) for x in (q, k, v, dout))
    tally = {}

    def hop(kind, fn, forward=True):
        before = dict(fa.flash_attention.launches)
        out = fn()
        rec = tally.setdefault(kind, {"hops": 0, "fwd": 0, "dq": 0,
                                      "dkv": 0})
        rec["hops"] += forward
        for n, x in fa.flash_attention.launches.items():
            rec[n] += x - before[n]
        return out

    outs, lses = [], []
    for r in range(p):
        o = torch.zeros(qs[r].shape, dtype=torch.float32, device=q.device)
        lse = torch.full((q.shape[0], q.shape[2], sl), -1e30,
                         dtype=torch.float32, device=q.device)
        for t in range(p):
            br = ra.hop_branch(r, t, p, causal, window, sl)
            src = (r - t) % p
            if br is None:
                hop("skip", lambda: None)
                continue
            o_c, lse_c = hop(branch_kind(br), lambda: ra.chunk_forward(
                qs[r], ks[src], vs[src], scale, br, window))
            o, lse = ra.merge_partial(o, lse, o_c, lse_c)
        outs.append(o.to(q.dtype))
        lses.append(lse)
    dq = [torch.zeros(x.shape, dtype=torch.float32, device=q.device)
          for x in qs]
    dk = [torch.zeros(x.shape, dtype=torch.float32, device=q.device)
          for x in ks]
    dv = [torch.zeros_like(x) for x in dk]
    for r in range(p):
        delta = fa._delta(outs[r], dos[r])
        for t in range(p):
            br = ra.hop_branch(r, t, p, causal, window, sl)
            src = (r - t) % p
            if br is None:
                continue
            dq_c, dk_c, dv_c = hop(branch_kind(br), lambda: ra.chunk_grads(
                qs[r], ks[src], vs[src], dos[r], lses[r], delta, scale, br,
                window), forward=False)
            dq[r] += dq_c
            dk[src] += dk_c
            dv[src] += dv_c
    cat = torch.cat
    return (cat(outs, 1), cat(lses, 2), cat(dq, 1).to(q.dtype),
            cat(dk, 1).to(k.dtype), cat(dv, 1).to(v.dtype)), tally


def phase_ring_flagship():
    """Ring attention at the flagship's attention width on one card:
    :data:`RING_FLAGSHIP` split into ``p`` virtual ranks, every (rank,
    hop) pair composed from the port's per-hop ring functions, held
    against one full-sequence flash forward and backward (K2-K4 at
    q_offset 0); windowed (diag and offset hops) and plain causal (skip,
    diag and full hops).  Each hop's kernels must have launched once, and
    the flash ring and Ulysses must refuse a shard that their tiling rule
    refuses (:func:`ring_refusals`).  Returns the windowed ring's
    launches and both timings."""
    from tensorflowonspark_tpu_torch.ops import flash_attention as fa

    g = RING_FLAGSHIP
    gen = torch.Generator(device="cuda")
    gen.manual_seed(10)
    out = {}
    for window in (g["window"], 0):
        c = make_flash_case(gen, b=g["b"], s=g["s"], h=g["h"], hkv=g["hkv"],
                            d=g["d"], dtype=torch.bfloat16, causal=True,
                            window=window)
        q, k, v, dout, scale = c["q"], c["k"], c["v"], c["dout"], c["scale"]
        fa.flash_attention.launches = {"fwd": 0, "dq": 0, "dkv": 0}
        got, tally = ring_compose(q, k, v, dout, g["p"], True, window, scale)
        launches = dict(fa.flash_attention.launches)
        o, lse = fa._fwd_core(q, k, v, scale, True, window=window)
        want = (o, lse) + fa._bwd_core(q, k, v, dout, lse, fa._delta(o, dout),
                                       scale, True, window)
        torch.cuda.synchronize()
        names = ("out", "lse", "dq", "dk", "dv")
        errs = flash_errors(dict(zip(names, got)), dict(zip(names, want)),
                            torch.bfloat16)
        # every hop of a kind launched each kernel once, a skip none
        expect = RING_HOPS[window]
        launches_ok = set(tally) == set(expect) and all(
            tally[kind]["hops"] == n and all(
                tally[kind][k] == (0 if kind == "skip" else n)
                for k in ("fwd", "dq", "dkv"))
            for kind, n in expect.items())
        del got, want

        def ring(_):
            ring_compose(q, k, v, dout, g["p"], True, window, scale)

        def full(_):
            o, lse = fa._fwd_core(q, k, v, scale, True, window=window)
            fa._bwd_core(q, k, v, dout, lse, fa._delta(o, dout), scale, True,
                         window)

        res = dict(
            window=window, launches=launches, hops_expected=expect,
            launches_by_branch=tally,
            max_abs_err={n: e for n, (e, _, _) in errs.items()},
            checked_err={n: x for n, (_, x, _) in errs.items()},
            tol={n: t for n, (_, _, t) in errs.items()},
            ring_fwd_bwd_ms=time_ms(ring, [None], reps=3, warmup=1),
            full_fwd_bwd_ms=time_ms(full, [None], reps=3, warmup=1),
        )
        ok = flash_ok(errs) and launches_ok
        emit("ring_flagship", shape=dict(B=g["b"], S=g["s"], H=g["h"],
                                         Hkv=g["hkv"], D=g["d"], P=g["p"],
                                         dtype="bfloat16", causal=True),
             ok=ok, **res)
        if not ok:
            raise AssertionError("ring flagship (window {0}): {1}".format(
                window, res))
        out[window] = res
    refused = ring_refusals(c["q"][:, :1100])
    emit("ring_refusal", shard_len=1100, refused=refused)
    if not all(refused.values()):
        raise AssertionError("the flash ring or Ulysses took a shard its "
                             "tiling rule refuses: {0}".format(refused))
    return out


def ring_refusals(x):
    """Whether ring and Ulysses attention raise on card tensors whose
    sequence the flash tiling rule refuses, instead of taking the plain
    step: ``{"ring": bool, "ulysses": bool}``."""
    from tensorflowonspark_tpu_torch.ops.ring_attention import ring_attention
    from tensorflowonspark_tpu_torch.ops.ulysses import ulysses_attention

    refused = {}
    for name, fn in (("ring", ring_attention), ("ulysses", ulysses_attention)):
        try:
            fn(x, x, x)
            refused[name] = False
        except ValueError as e:
            refused[name] = "refuses" in str(e)
    return refused


#: :func:`phase_flash_timing_trees`'s process: K2-K4 at the flagship
#: training shape from the package of the tree in argv[1]
FLASH_TIMING_TREE = r"""
import importlib.util, json, os, sys
tree = os.path.abspath(sys.argv[1])
sys.path.insert(0, tree)
import torch
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[2])
c = importlib.util.module_from_spec(spec)
sys.modules["chip_smoke"] = c
spec.loader.exec_module(c)
import tensorflowonspark_tpu_torch as pkg
assert pkg.__file__.startswith(tree), pkg.__file__
gen = torch.Generator(device="cuda")
gen.manual_seed(6)
runs = [c.flash_timing_at(gen, plain=False, **dict(c.FLASH_TIMING_SHAPES)[
    "flagship"]) for _ in range(3)]
c.emit("flash_timing_tree", tree=sys.argv[1], ms=[
    {k: r[k]["ms"] for k in ("fwd", "dq", "dkv")} for r in runs])
"""


def phase_flash_timing_trees(trees):
    """Not run by :func:`main`: K2-K4 at the flagship training shape,
    three times each, from the package of each tree in ``trees`` in turn
    (one process each, this file's phases; e.g. a parent commit unpacked
    in a gitignored directory and ``"."``, as parent, change, change,
    parent), to compare two commits on one card in one call."""
    for tree in trees:
        subprocess.run([sys.executable, "-c", FLASH_TIMING_TREE, tree,
                        os.path.abspath(__file__)], check=True)


TRAIN_K, TRAIN_B, TRAIN_S = 4, 8, 2048
#: f32 flash vs dot training after three SGD steps: losses to rtol 1e-4;
#: in every parameter leaf, what max|theta_flash - theta_dot| exceeds
#: one f32 ulp of the weight by, under 1e-3 of how far the dot run
#: moved that leaf (max|theta_dot - theta_0|), so a wrong gradient
#: fails however small the leaf's steps are (the same f32 gradients
#: summed in another order differ by far less; a weight whose exact
#: update falls on the other side of a rounding boundary differs by
#: one ulp)
TRAIN_VS_DOT_TOL = {"loss_rtol": 1e-4, "param_rel_to_move": 1e-3}


def flagship_tree():
    """``(tree, seconds)``: the flagship's random Flax-layout weights from
    seed 0 (the serving and training phases share one) and the time it
    took to make them."""
    from tensorflowonspark_tpu_torch import convert
    from tensorflowonspark_tpu_torch.models import transformer

    t0 = time.perf_counter()
    tree = convert.init_params_tree(transformer.TransformerConfig(**FLAGSHIP),
                                    seed=0)
    return tree, time.perf_counter() - t0


def flagship_trainer(tree):
    """The bench flagship for training at full width: f32 master weights,
    bf16 compute, flash attention, ``SyncTrainer(loss_fn(model),
    adamw(1e-4))``, and one stacked [4, 8, 2048] token batch on the card."""
    from tensorflowonspark_tpu_torch import convert, optim
    from tensorflowonspark_tpu_torch.models import transformer
    from tensorflowonspark_tpu_torch.parallel import dp

    cfg = transformer.TransformerConfig(**dict(FLAGSHIP,
                                               attention_impl="flash"))
    model = convert.params_from_flax(tree, cfg, param_dtype=torch.float32)
    trainer = dp.SyncTrainer(transformer.loss_fn(model), optim.adamw(1e-4))
    state = trainer.create_state(dict(model.named_parameters()))
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, cfg.vocab_size, (TRAIN_K, TRAIN_B, TRAIN_S))
    stacked = {"tokens": torch.from_numpy(tokens.astype(np.int32)).to(
        trainer.batch_sharding())}
    return cfg, model, trainer, state, stacked


def phase_train_flagship(tree, flash_timing):
    """One warm-up and two timed ``multi_step`` of K=4 of
    :func:`flagship_trainer` on its stacked batch."""
    from tensorflowonspark_tpu_torch.ops.flash_attention import (
        flash_attention,
    )

    cfg, model, trainer, state, stacked = flagship_trainer(tree)
    n_params = sum(p.numel() for p in model.parameters())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash_attention.launches = {"fwd": 0, "dq": 0, "dkv": 0}
    losses, walls = [], []
    for _ in range(3):  # warm-up, then two timed groups
        t0 = time.perf_counter()
        state, metrics = trainer.multi_step_on_device(state, stacked)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        losses.append(metrics["loss"])
    launches = dict(flash_attention.launches)
    losses = torch.cat(losses).float().cpu().numpy()
    steps = len(losses)
    peak = torch.cuda.max_memory_allocated()
    dtypes = sorted({str(p.dtype) for p in model.parameters()})
    best = min(walls[1:])
    step_ms = 1e3 * best / TRAIN_K
    tokens_per_sec = TRAIN_K * TRAIN_B * TRAIN_S / best
    flops_per_token = 6.0 * n_params + 12.0 * cfg.num_layers * \
        cfg.num_heads * cfg.head_dim * TRAIN_S
    res = dict(
        model="L16 H8 Dh128 Dm1024 V32000 bf16 compute, f32 masters",
        params=n_params, batch=[TRAIN_K, TRAIN_B, TRAIN_S], steps=steps,
        losses=losses.tolist(), warmup_sec=walls[0], timed_sec=walls[1:],
        step_ms=step_ms, tokens_per_sec=tokens_per_sec,
        mfu=tokens_per_sec * flops_per_token / BF16_FLOPS_PER_SEC,
        flops_per_token=flops_per_token, peak_memory_bytes=peak,
        launches=launches, param_dtypes=dtypes,
        kernel_share_of_step={
            name: cfg.num_layers * flash_timing[name]["ms"] / step_ms
            for name in ("fwd", "dq", "dkv")},
        device=torch.cuda.get_device_name(0),
    )
    emit("train_flagship", **res)
    if not np.isfinite(losses).all():
        raise AssertionError("non-finite loss: {0}".format(losses))
    if not losses[-1] < losses[0]:
        raise AssertionError("loss did not fall: {0}".format(losses))
    for name, n in launches.items():
        if n != cfg.num_layers * steps:
            raise AssertionError(
                "flash {0} launches {1} != {2} layers x {3} steps".format(
                    name, n, cfg.num_layers, steps))
    if dtypes != ["torch.float32"]:
        raise AssertionError("master parameters are {0}".format(dtypes))
    return res, model


def phase_train_kernel_vs_dot():
    """The flagship width in f32 at two layers, S=512, B=4: three SGD
    steps from the same weights with flash (the kernels) and dot
    attention (plain PyTorch), both on the card."""
    from tensorflowonspark_tpu_torch import convert, optim
    from tensorflowonspark_tpu_torch.models import transformer
    from tensorflowonspark_tpu_torch.ops.flash_attention import (
        flash_attention,
    )
    from tensorflowonspark_tpu_torch.parallel import dp

    base = dict(FLAGSHIP, dtype="float32", num_layers=2, max_seq_len=512)
    tree = convert.init_params_tree(transformer.TransformerConfig(**base),
                                    seed=8)
    tokens = np.random.default_rng(9).integers(
        0, base["vocab_size"], (3, 4, 512)).astype(np.int32)
    runs = {}
    for impl in ("flash", "dot"):
        cfg = transformer.TransformerConfig(**dict(base, attention_impl=impl))
        model = convert.params_from_flax(tree, cfg,
                                         param_dtype=torch.float32)
        trainer = dp.SyncTrainer(transformer.loss_fn(model),
                                 optim.sgd(0.01, momentum=0.9))
        state = trainer.create_state(dict(model.named_parameters()))
        flash_attention.launches = {"fwd": 0, "dq": 0, "dkv": 0}
        state, metrics = trainer.multi_step(state, {"tokens": tokens})
        runs[impl] = (metrics["loss"].cpu().numpy(),
                      convert._flatten(convert.tree_from_model(model)),
                      dict(flash_attention.launches))
        del model, trainer, state
    loss_f, params_f, launches_f = runs["flash"]
    loss_d, params_d, launches_d = runs["dot"]
    loss_rel = float(np.max(np.abs(loss_f - loss_d) / np.abs(loss_d)))
    moved, diff, rel = leaf_agreement(convert._flatten(tree), params_f,
                                      params_d)
    worst = max(rel, key=rel.get)
    ok = (loss_rel <= TRAIN_VS_DOT_TOL["loss_rtol"]
          and rel[worst] <= TRAIN_VS_DOT_TOL["param_rel_to_move"]
          and min(launches_f.values()) > 0 and max(launches_d.values()) == 0)
    emit("train_kernel_vs_dot", model="L2 H8 Dh128 Dm1024 f32 S512 B4",
         losses_flash=loss_f.tolist(), losses_dot=loss_d.tolist(),
         loss_max_rel_diff=loss_rel, param_max_abs_diff=max(diff.values()),
         param_moved_by_leaf=moved, param_diff_rel_to_move=rel,
         worst_leaf=worst, tol=TRAIN_VS_DOT_TOL, launches_flash=launches_f,
         launches_dot=launches_d, ok=ok)
    if not ok:
        raise AssertionError("flash vs dot training disagree")


def leaf_agreement(init, got, want):
    """``(moved, diff, rel)`` per leaf of two trained trees from the same
    ``init``: how far ``want`` moved each leaf, the largest gap between
    the two, and what that gap exceeds one f32 rounding of the weight by,
    as a fraction of the move."""
    moved, diff, rel = {}, {}, {}
    for p in want:
        d = want[p]
        moved[p] = float(np.max(np.abs(d.astype(np.float64) - init[p])))
        gap = np.abs(got[p].astype(np.float64) - d)
        diff[p] = float(np.max(gap))
        # what exceeds one f32 rounding of the weight itself
        excess = float(np.max(np.maximum(gap - np.spacing(np.abs(d)), 0)))
        rel[p] = excess / moved[p] if moved[p] else \
            (0.0 if excess == 0 else float("inf"))
    return moved, diff, rel


def phase_train_to_serve(model):
    """The trained flagship weights through slice 1's serving path."""
    from tensorflowonspark_tpu_torch import convert

    tree = convert.tree_from_model(model)
    serving_cfg = dict(SERVING, max_new_tokens=16, max_prompt_len=64)
    rows = make_requests(np.random.default_rng(10), 4, FLAGSHIP["vocab_size"],
                         16, 64)
    out, stats, wall, launches = serve(FLAGSHIP, serving_cfg, tree, rows)
    gen = [np.asarray(r["generated"]) for r in out]
    ok = (len(gen) == 4 and all(
        g.shape == (16,) and g.min() >= 0 and g.max() < FLAGSHIP["vocab_size"]
        for g in gen) and launches > 0)
    emit("train_to_serve", requests=len(gen), tokens_out=stats["tokens_out"],
         wall_sec=wall, paged_attention_launches=launches,
         first_tokens=[g[:4].tolist() for g in gen], ok=ok)
    if not ok:
        raise AssertionError("trained weights did not serve: {0}".format(gen))


def phase_optimizer_timing(model):
    """One AdamW update over parameters of the flagship's shapes (f32):
    the port's ``optim.adamw``, which follows optax's op order and
    rounding, beside ``torch.optim.AdamW(fused=True)`` with the same
    hyperparameters, a one-pass yardstick the port does not call (its
    update equals optax's up to a few ulp).  The bound reads p, g, m, v
    and writes p, m, v once.  Gates nothing."""
    from tensorflowonspark_tpu_torch import optim

    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    shapes = {n: p.shape for n, p in model.named_parameters()}

    def rnd():
        return {n: torch.randn(s, generator=gen, device="cuda") * 0.02
                for n, s in shapes.items()}

    params, grads = rnd(), list(rnd().values())
    port = optim.adamw(1e-4)
    state = port.init(params)
    port_ms = time_ms(lambda _: port.update(state, params, grads), [None],
                      reps=5, warmup=2)
    del state
    fused = torch.optim.AdamW(list(params.values()), lr=1e-4,
                              betas=(0.9, 0.999), eps=1e-8,
                              weight_decay=1e-4, fused=True)
    for p, g in zip(params.values(), grads):
        p.grad = g
    fused_ms = time_ms(lambda _: fused.step(), [None], reps=5, warmup=2)
    n = sum(p.numel() for p in params.values())
    emit("optimizer_timing", params=n, port_adamw_ms=port_ms,
         fused_adamw_ms=fused_ms,
         bound_ms=1e3 * 7 * 4 * n / HBM_BYTES_PER_SEC, bound_by="bytes",
         device=torch.cuda.get_device_name(0))


#: A minimal kernel shaped like the bf16 K4 consumer's loop at D = 128
#: (dK and dV sums of 64 registers each, S^T and dP^T tiles of 32, the
#: packed P^T and dS^T fragments), built in five variants to see
#: which one ptxas lets hold them without spilling: 0, 384 threads with
#: the role index threadIdx.x / 128 and setmaxnreg 24/240, the producer
#: returning at once; 1, the same with the index read from lane 0
#: (warp-uniform); 2, 288 threads (two consumer warpgroups and one
#: producer warp), no setmaxnreg; 3, as 0 but with the consumer in the
#: else branch of the role test, so both roles reach the kernel's end; 4,
#: as 0 but the consumer's barrier wait has the watchdog (a __trap after
#: 4 s) that the others' lacks.
REGISTER_PROBE = r"""
#include <cuda_bf16.h>

#include "hopper.cuh"
constexpr int kThreads = VARIANT == 2 ? 288 : 384;
__global__ void __launch_bounds__(kThreads, 1)
    register_probe(float* out, int n, float scale) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t base = (hopper::smem_u32(smem) + 1023u) & ~1023u;
  const float* col = reinterpret_cast<const float*>(smem);
#if VARIANT == 1
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
#else
  const int wg = threadIdx.x / 128;
#endif
  const bool producer = VARIANT == 2 ? wg == 2 : wg == 0;
  if (producer) {
#if VARIANT != 2
    hopper::reg_dealloc<24>();
#endif
    if (threadIdx.x % 128 == 0) out[0] = 0.f;
#if VARIANT != 3
    return;
  }
#else
  } else {
#endif
#if VARIANT != 2
  hopper::reg_alloc<240>();
#endif
  const int t = threadIdx.x & 3;
  float dk[64], dv[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dk[i] = dv[i] = 0.f;
  for (int it = 0; it < n; ++it) {
    float s[32], dp[32];
    const uint32_t st = base + (it & 1) * 32768;
#if VARIANT == 4
    hopper::mbar_wait(base + 65536, it & 1);
#else
    hopper::mbar_wait_spin(base + 65536, it & 1);
#endif
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const uint32_t a0 = base + (kk >> 2) * 16384 + (kk & 3) * 32;
      const uint32_t b0 = st + (kk >> 2) * 16384 + (kk & 3) * 32;
      hopper::wgmma_m64n64_ss<0, 0>(s, hopper::desc_sw128(a0, 16, 1024),
                                    hopper::desc_sw128(b0, 16, 1024), kk > 0);
      hopper::wgmma_m64n64_ss<0, 0>(dp, hopper::desc_sw128(a0 + 8192, 16, 1024),
                                    hopper::desc_sw128(b0 + 8192, 16, 1024),
                                    kk > 0);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(s);
    hopper::fence_regs(dp);
    uint32_t pp[16], dsp[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int c = 8 * (i >> 1) + 2 * t;
      float p0 = exp2f(fmaf(s[2 * i], scale, -col[c]));
      float p1 = exp2f(fmaf(s[2 * i + 1], scale, -col[c + 1]));
      if (c > it) p0 = p1 = 0.f;
      const float d0 = p0 * (dp[2 * i] - col[64 + c]) * scale;
      const float d1 = p1 * (dp[2 * i + 1] - col[65 + c]) * scale;
      __nv_bfloat162 x = __floats2bfloat162_rn(p0, p1);
      __nv_bfloat162 y = __floats2bfloat162_rn(d0, d1);
      pp[i] = *reinterpret_cast<uint32_t*>(&x);
      dsp[i] = *reinterpret_cast<uint32_t*>(&y);
    }
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t b0 = st + kk * 2048;
      hopper::wgmma_m64n128_rs<1>(
          dv, pp + 4 * kk, hopper::desc_sw128(b0 + 16384, 8192, 1024), 1);
      hopper::wgmma_m64n128_rs<1>(
          dk, dsp + 4 * kk, hopper::desc_sw128(b0, 8192, 1024), 1);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dk);
    hopper::fence_regs(dv);
    hopper::fence_regs(pp);
    hopper::fence_regs(dsp);
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    out[threadIdx.x * 128 + i] = dk[i];
    out[threadIdx.x * 128 + 64 + i] = dv[i];
  }
#if VARIANT == 3
  }
#endif
}
"""


def phase_register_probe():
    """Build :data:`REGISTER_PROBE` in its five variants (one
    ``nvcc`` each, all started together) and report what ``-Xptxas=-v``
    says of each: registers, stack, spills.  Not run by :func:`main`:
    ``python3 -c "import chip_smoke as c; c.phase_env();
    c.phase_register_probe()"``."""
    from tensorflowonspark_tpu_torch.ops import _build

    out_dir = os.path.join(_build.BUILD_DIR, "register_probe")
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(out_dir, "register_probe.cu")
    with open(src, "w") as f:
        f.write(REGISTER_PROBE)
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-shared",
                                                       "-Xcompiler",
                                                       "-fPIC")]
    procs = {v: subprocess.Popen(
        [_build.nvcc_path(), *flags, "-cubin", "-DVARIANT={0}".format(v),
         "-I", _build.CSRC_DIR, "-o",
         os.path.join(out_dir, "probe{0}.cubin".format(v)), src],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for v in (0, 1, 2, 3, 4)}
    layouts = {0: "384 threads, threadIdx.x / 128, setmaxnreg 24/240",
               1: "384 threads, warp-uniform index, setmaxnreg 24/240",
               2: "288 threads, no setmaxnreg",
               3: "384 threads, setmaxnreg 24/240, roles joined at the end",
               4: "as 0, the consumer's wait with the trapping watchdog"}
    res = {}
    for v, proc in procs.items():
        report = proc.communicate()[0]
        res[layouts[v]] = dict(rc=proc.returncode,
                               ptxas=ptxas_functions(report),
                               report=report[-2000:])
    emit("register_probe", **res)
    return res


#: lower-case kernel-name fragments -> class, first match wins, for the
#: profile of a training step
KERNEL_CLASSES = (
    ("paged_", "paged attention (K1)"),
    ("flash_", "flash attention (K2-K4)"),
    ("gmm_kernel", "grouped matmul (K5-K7)"),
    ("gmm_rows_wgmma", "grouped matmul (K5-K7)"),
    ("tgmm_wgmma", "grouped matmul (K5-K7)"),
    ("gemm", "matmul"), ("xmma", "matmul"), ("cutlass", "matmul"),
    ("nvjet", "matmul"), ("cublas", "matmul"),
    ("multi_tensor", "optimizer"), ("foreach", "optimizer"),
    ("softmax", "cross-entropy"), ("nll_loss", "cross-entropy"),
    ("reduce", "reductions"), ("copy", "casts and copies"),
    ("memcpy", "casts and copies"), ("memset", "casts and copies"),
    ("elementwise", "elementwise"),
)


def phase_train_profile(moe=False):
    """Device time of the flagship's training step by kernel class, from
    ``torch.profiler`` over one ``multi_step`` of K=4 after a warm-up;
    ``moe=True`` profiles the MoE flagship (:func:`moe_trainer`).  Not
    run by :func:`main`; run it alone with ``python3 -c "import
    chip_smoke as c; c.phase_env(); c.phase_build();
    c.phase_train_profile()"`` (or ``phase_train_profile(moe=True)``)."""
    if moe:
        _, _, trainer, state, stacked = moe_trainer(moe_tree())
    else:
        _, _, trainer, state, stacked = flagship_trainer(flagship_tree()[0])
    state, _ = trainer.multi_step_on_device(state, stacked)
    torch.cuda.synchronize()

    def steps():
        trainer.multi_step_on_device(state, stacked)

    emit("train_profile", model="moe" if moe else "dense",
         **profile_steps(steps, TRAIN_K))


def profile_steps(run, steps):
    """Device time of ``run()`` (which must do ``steps`` steps) by
    kernel class, from ``torch.profiler``, beside its wall (host clock,
    ending in a synchronize), per step.  ``run()`` goes once without
    the profiler first: the busy share is the device time over that
    wall (``device_busy_share``) and over the profiled one."""
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    classes, kernels = {}, []
    for e in prof.key_averages():
        # device-side ranges of user annotations (the optimizer's step)
        # span kernels counted on their own
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or getattr(e, "is_user_annotation", False)
                or e.key.startswith("Optimizer.")):
            continue
        us = float(getattr(e, "self_device_time_total", 0.0)
                   or getattr(e, "self_cuda_time_total", 0.0))
        name = e.key.lower()
        kind = next((c for frag, c in KERNEL_CLASSES if frag in name),
                    "other")
        classes[kind] = classes.get(kind, 0.0) + us
        kernels.append((us, e.count, e.key[:120]))
    device_ms = sum(classes.values()) / 1e3
    per_step = {k: v / 1e3 / steps for k, v in sorted(
        classes.items(), key=lambda kv: -kv[1])}
    return dict(
        steps=steps, wall_ms_per_step=1e3 * plain_wall / steps,
        profiled_wall_ms_per_step=1e3 * wall / steps,
        device_ms_per_step=device_ms / steps,
        device_busy_share=device_ms / (1e3 * plain_wall),
        device_busy_share_profiled=device_ms / (1e3 * wall),
        device_ms_per_step_by_class=per_step,
        top_kernels=[dict(ms_per_step=us / 1e3 / steps,
                          calls_per_step=n / steps, name=name)
                     for us, n, name in sorted(kernels, reverse=True)[:25]],
        note="profiled_wall includes the profiler's own overhead",
        device=torch.cuda.get_device_name(0))


def phase_serve_profile(chunks=3):
    """Device time of the flagship's serving decode step by kernel class
    (K1's share included) and the device's busy share of the wall, from
    ``torch.profiler`` over ``chunks`` decode chunks of 16 steps on 8
    slots (after the prompts' prefill, one warm-up chunk and ``chunks``
    unprofiled ones, :func:`profile_steps`).  Random
    weights as in ``slice_flagship``.  Not run by :func:`main`; run it
    alone with ``python3 -c "import chip_smoke as c; c.phase_env();
    c.phase_build(); c.phase_serve_profile()"``.  Needs only the
    serving entry points, so it also profiles another tree's package."""
    from tensorflowonspark_tpu_torch.models.transformer import (
        serving_builder,
    )

    serving_cfg = dict(SERVING, max_new_tokens=(2 * chunks + 1)
                       * SERVING["chunk_size"])
    predict = serving_builder(flagship_tree()[0],
                              dict(FLAGSHIP, **serving_cfg))
    dec = predict.make_slot_decoder(SLOTS)
    rows = make_requests(np.random.default_rng(2), SLOTS,
                         FLAGSHIP["vocab_size"], 16, SERVING["max_prompt_len"])
    for slot, row in enumerate(rows):
        dec.admit(slot, row["tokens"])
    dec.step_chunk()
    torch.cuda.synchronize()

    def run():
        for _ in range(chunks):
            dec.step_chunk()

    res = profile_steps(run, chunks * SERVING["chunk_size"])
    k1 = res["device_ms_per_step_by_class"].get("paged attention (K1)", 0.0)
    emit("serve_profile", model="L16 H8 Dh128 Dm1024 bf16, 8 slots",
         prompt_lens=[int(len(r["tokens"])) for r in rows],
         k1_share_of_device=k1 / res["device_ms_per_step"], **res)


#: the JAX package's MoE bench model (``python bench.py moe``, its
#: "dropless" row): 485M parameters, 183M active per token
MOE_FLAGSHIP = dict(
    vocab_size=32000, num_layers=4, num_heads=8, head_dim=128,
    embed_dim=1024, mlp_dim=4096, max_seq_len=2048, dtype="bfloat16",
    num_experts=8, expert_k=2, expert_dispatch="dropless",
)
MOE_TRAIN_B = 4
#: kernel launches per layer and training step under remat "block":
#: each block's forward runs twice (K5 for wi, wg, wo; K2) and its
#: backward once (K6 and K7 for each projection; K3, K4)
MOE_LAUNCHES_PER_LAYER = {"gmm": 6, "gmm_dxt": 3, "tgmm": 3,
                          "fwd": 2, "dq": 1, "dkv": 1}
GMM_SRC = "tensorflowonspark_tpu_torch/csrc/gmm.cu"
#: grouped-matmul kernels against their plain versions.  f32: max abs
#: error within 1e-5 of the output's max |ref| (the same f32 products
#: summed in another order, over up to a few thousand rows for dW).
#: bf16: every element within 2^-6 of |ref| + the RMS of its row
#: (:func:`row_relative_error`): both sides sum in f32 and round once,
#: so they differ by at most one bf16 ulp (2^-7 of |ref|).  An absent
#: expert's dW must be exactly 0.  The ``*_counts`` cases pass the
#: layout's ``group_sizes`` to K5 and K6 and make the pad rows of x and dy
#: random instead of zero, so that a kernel that ignored the counts would
#: show: the rows past each expert's count must be exactly 0 in y and dx,
#: and the live rows are held as above.  (Their absent expert is not the
#: last one, which owns the layout's tail tiles and so their random rows.)
GMM_TOL = {"f32_rel": 1e-5, "bf16_row_rel": 2 ** -6}
GMM_CASES = [
    ("flagship_bf16_d1024_f4096", dict(
        g=8192, k=2, e=8, d=1024, f=4096, bm=256, dtype=torch.bfloat16,
        heavy=0, absent=7)),
    ("flagship_bf16_f4096_d1024", dict(
        g=8192, k=2, e=8, d=4096, f=1024, bm=256, dtype=torch.bfloat16,
        heavy=3, absent=5)),
    ("f32_ragged_absent_bm256", dict(
        g=1000, k=2, e=6, d=200, f=392, bm=256, dtype=torch.float32,
        heavy=1, absent=2)),
    ("bf16_ragged_absent_bm256", dict(
        g=1000, k=2, e=6, d=200, f=392, bm=256, dtype=torch.bfloat16,
        heavy=1, absent=2)),
    ("flagship_bf16_d1024_f4096_counts", dict(
        g=8192, k=2, e=8, d=1024, f=4096, bm=256, dtype=torch.bfloat16,
        heavy=0, absent=6, counts=True)),
    ("flagship_bf16_f4096_d1024_counts", dict(
        g=8192, k=2, e=8, d=4096, f=1024, bm=256, dtype=torch.bfloat16,
        heavy=3, absent=5, counts=True)),
    ("bf16_ragged_absent_bm128_counts", dict(
        g=1000, k=2, e=6, d=200, f=392, bm=128, dtype=torch.bfloat16,
        heavy=1, absent=2, counts=True)),
    ("f32_ragged_absent_bm256_counts", dict(
        g=1000, k=2, e=6, d=200, f=392, bm=256, dtype=torch.float32,
        heavy=1, absent=2, counts=True)),
    ("bf16_decode_g4_counts", dict(
        g=4, k=2, e=8, d=1024, f=4096, bm=256, dtype=torch.bfloat16,
        heavy=0, absent=6, counts=True)),
]
GMM_KERNELS = ("gmm", "gmm_dxt", "tgmm")


def make_gmm_case(gen, *, g, k, e, d, f, bm, dtype, heavy=0, absent=None,
                  skew=2.0, counts=False):
    """A dropless layout from a router that favours expert ``heavy`` and
    never picks ``absent``; tokens ``[G, D]`` gathered into it, expert
    weights ``[E, D, F]``, and an upstream gradient ``[NP, F]`` that is 0
    on pad rows, as the backward hands it over.  ``sizes`` holds each
    expert's routed rows.  With ``counts``, K5 and K6 get them as
    ``group_sizes``, and the pad rows of x and dy are random."""
    from tensorflowonspark_tpu_torch.ops import moe

    logits = torch.randn((g, e), generator=gen, device="cuda")
    logits[:, heavy] += skew
    if absent is not None:
        logits[:, absent] = -1e4
    experts, _, _ = moe.dropless_topk(logits, k=k)
    layout = moe.dropless_layout(experts, e, bm=bm)
    tokens = torch.randn((g, d), generator=gen, device="cuda").to(dtype)
    x = moe.dispatch_sorted(tokens, layout)
    live = (layout.slot_token < g)[:, None].float()
    dy = torch.randn((x.shape[0], f), generator=gen, device="cuda")
    if not counts:
        dy = dy * live
    w = torch.randn((e, d, f), generator=gen, device="cuda") * d ** -0.5
    if counts:
        x = x + (torch.randn(x.shape, generator=gen, device="cuda")
                 * (1 - live)).to(dtype)
    sizes = moe.expert_counts(experts, e).to(torch.int32)
    return dict(x=x, w=w.to(dtype), dy=dy.to(dtype), te=layout.tile_expert,
                bm=bm, e=e, routed=g * k, absent=absent, sizes=sizes,
                group_sizes=sizes if counts else None)


def gmm_outputs(c):
    """Each kernel's output and its plain version's on one case."""
    from tensorflowonspark_tpu_torch.ops import gmm

    x, w, dy, te, bm, e, gs = (c[n] for n in ("x", "w", "dy", "te", "bm", "e",
                                               "group_sizes"))
    got = dict(gmm=gmm.gmm_call(x, w, te, bm=bm, group_sizes=gs),
               gmm_dxt=gmm.gmm_dxt_call(dy, w, te, bm=bm, group_sizes=gs),
               tgmm=gmm.tgmm_call(x, dy, te, e, bm=bm))
    torch.cuda.synchronize()
    ref = dict(gmm=gmm.gmm_plain(x, w, te, bm=bm, group_sizes=gs),
               gmm_dxt=gmm.gmm_dxt_plain(dy, w, te, bm=bm, group_sizes=gs),
               tgmm=gmm.tgmm_plain(x, dy, te, e, bm=bm))
    return got, ref


def gmm_dead_rows(c, got):
    """Largest ``|y|`` and ``|dx|`` over the rows past their expert's
    count when the case passes ``group_sizes`` (0.0 when it does not):
    the kernels must write those rows as exact zeros."""
    from tensorflowonspark_tpu_torch.ops import gmm

    if c["group_sizes"] is None:
        return 0.0
    dead = ~gmm.live_row_mask(c["te"], c["group_sizes"], c["bm"])[:, 0]
    return max(got[n][dead].float().abs().max().item()
               for n in ("gmm", "gmm_dxt"))


def gmm_errors(got, ref, dtype):
    """``{kernel: (max abs err, checked err, tolerance)}``."""
    out = {}
    for name in GMM_KERNELS:
        g, r = got[name].float(), ref[name].float()
        err = (g - r).abs().max().item()
        if dtype == torch.bfloat16:
            checked, tol = row_relative_error(g, r), GMM_TOL["bf16_row_rel"]
        else:
            checked = err / max(r.abs().max().item(), 1e-30)
            tol = GMM_TOL["f32_rel"]
        if not torch.isfinite(g).all().item():
            err = checked = float("inf")
        out[name] = (err, checked, tol)
    return out


def gmm_case_results():
    """``(name, dtype, errors, absent expert's max |dW|, max |y|, |dx| on
    the rows past the counts)`` for each of :data:`GMM_CASES`, inputs
    drawn on the card from one seed."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(12)
    for name, spec in GMM_CASES:
        c = make_gmm_case(gen, **spec)
        got, ref = gmm_outputs(c)
        absent = got["tgmm"][c["absent"]].float().abs().max().item()
        yield (name, spec["dtype"], gmm_errors(got, ref, spec["dtype"]),
               absent, gmm_dead_rows(c, got))


def gmm_case_ok(errs, absent_dw, dead_rows):
    return (all(c <= t for _, c, t in errs.values()) and absent_dw == 0.0
            and dead_rows == 0.0)


def phase_gmm_cases():
    for name, dtype, errs, absent_dw, dead_rows in gmm_case_results():
        ok = gmm_case_ok(errs, absent_dw, dead_rows)
        emit("gmm_case", case=name, dtype=str(dtype),
             max_abs_err={n: e for n, (e, _, _) in errs.items()},
             checked_err={n: c for n, (_, c, _) in errs.items()},
             tol={n: t for n, (_, _, t) in errs.items()},
             absent_expert_max_abs_dw=absent_dw,
             rows_past_counts_max_abs=dead_rows, ok=ok)
        if not ok:
            raise AssertionError(
                "gmm case {0}: {1}, absent expert dW {2}, rows past the "
                "counts {3}".format(name, errs, absent_dw, dead_rows))


def gmm_library(c):
    """One PyTorch call per kernel over the same expert runs (the
    yardstick; the port never calls it): ``torch._grouped_mm`` where this
    PyTorch has it, else a loop of ``torch.matmul`` over the experts.
    The runs' offsets are read from ``tile_expert`` here, outside any
    timed region."""
    x, w, dy, te, bm, e = (c[n] for n in ("x", "w", "dy", "te", "bm", "e"))
    rows = torch.bincount(te.long(), minlength=e) * bm
    if hasattr(torch, "_grouped_mm"):
        offs = torch.cumsum(rows, 0).to(torch.int32)
        gm = torch._grouped_mm
        return {
            "gmm": lambda _: gm(x, w, offs=offs),
            "gmm_dxt": lambda _: gm(dy, w.transpose(-2, -1), offs=offs),
            "tgmm": lambda _: gm(x.t(), dy, offs=offs),
        }, "torch._grouped_mm over the layout's expert runs"
    ends = torch.cumsum(rows, 0).tolist()
    runs = [(end - n, end) for n, end in zip(rows.tolist(), ends)]

    def fwd(_):
        return [x[a:b] @ w[i] for i, (a, b) in enumerate(runs)]

    def dxt(_):
        return [dy[a:b] @ w[i].t() for i, (a, b) in enumerate(runs)]

    def tg(_):
        return [x[a:b].t() @ dy[a:b] for i, (a, b) in enumerate(runs)]

    return {"gmm": fwd, "gmm_dxt": dxt, "tgmm": tg}, \
        "a loop of torch.matmul over the experts' runs"


#: the bf16 K5/K6 timing geometries, ``w [E, D, F]``: the MoE flagship's
#: ``wi``/``wg`` (D=1024 -> F=4096) and ``wo`` (4096 -> 1024)
GMM_GEOMETRIES = {"wi": (1024, 4096), "wo": (4096, 1024)}
#: the bf16 kernel each grouped-matmul entry runs
GMM_WGMMA = {"gmm": "gmm_rows_wgmma<kFwd>", "gmm_dxt": "gmm_rows_wgmma<kDxt>",
             "tgmm": "tgmm_wgmma"}


def gmm_bound(c):
    """``(bound ms, bound_by, bytes, flops)`` of one grouped-matmul call on
    case ``c``: the routed rows only (NP adds each run's padding and the
    tail tiles), each operand read once, each output written once, the
    weights of the experts that got a row."""
    d, f = c["w"].shape[1:]
    routed = c["routed"]
    present = int((c["sizes"] > 0).sum().item())
    flops = 2 * routed * d * f
    nbytes = c["w"].element_size() * (routed * d + present * d * f
                                      + routed * f)
    bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_SEC
    ops_ms = 1e3 * flops / BF16_FLOPS_PER_SEC
    return (max(bytes_ms, ops_ms),
            "bytes" if bytes_ms >= ops_ms else "operations", nbytes, flops)


def phase_gmm_timing():
    """K5, K6 and K7 at the MoE flagship's training shape (8192 tokens,
    top-2 of 8 experts, D=1024, F=4096, bf16) as its training step calls
    them (K5 and K6 with the layout's counts), beside their plain
    versions, the bound over the routed rows and the library yardstick;
    then K5 and K6 with and without the counts in both geometries on the
    balanced and the skewed layouts (:func:`rows_wgmma_timing`), K7 on the
    skewed layout, and K5 at a decode step (:func:`gmm_decode_timing`)."""
    from tensorflowonspark_tpu_torch.ops import gmm

    gen = torch.Generator(device="cuda")
    gen.manual_seed(13)
    c = make_gmm_case(gen, g=8192, k=2, e=8, d=1024, f=4096, bm=256,
                      dtype=torch.bfloat16, skew=0.0)
    c["group_sizes"] = c["sizes"]
    got, ref = gmm_outputs(c)
    errs = gmm_errors(got, ref, torch.bfloat16)
    if not all(x <= t for _, x, t in errs.values()):
        raise AssertionError("gmm kernels at the flagship shape: {0}".format(
            errs))
    x, w, dy, te, bm, e, gs = (c[n] for n in ("x", "w", "dy", "te", "bm",
                                              "e", "group_sizes"))
    runs = {
        "gmm": (lambda _: gmm.gmm_call(x, w, te, bm=bm, group_sizes=gs),
                lambda _: gmm.gmm_plain(x, w, te, bm=bm, group_sizes=gs)),
        "gmm_dxt": (lambda _: gmm.gmm_dxt_call(dy, w, te, bm=bm,
                                               group_sizes=gs),
                    lambda _: gmm.gmm_dxt_plain(dy, w, te, bm=bm,
                                                group_sizes=gs)),
        "tgmm": (lambda _: gmm.tgmm_call(x, dy, te, e, bm=bm),
                 lambda _: gmm.tgmm_plain(x, dy, te, e, bm=bm)),
    }
    library, note = gmm_library(c)
    n_rows, d = x.shape
    f = w.shape[2]
    bound_ms, bound_by, nbytes, flops = gmm_bound(c)
    routed = c["routed"]
    res = {}
    for name, (kernel, plain) in runs.items():
        ms = time_ms(kernel, [None], reps=20, warmup=3)
        res[name] = dict(
            ms=ms, plain_ms=time_ms(plain, [None], reps=3, warmup=1),
            library_ms=time_ms(library[name], [None], reps=20, warmup=3),
            library_note=note, bound_ms=bound_ms, bound_by=bound_by,
            bytes=nbytes, flops=flops, flops_over_np=2 * n_rows * d * f,
            tflops=flops / ms / 1e9, max_abs_err=errs[name][0],
            kernel=GMM_WGMMA[name], group_sizes=name != "tgmm",
        )
    del c, got, ref, x, w, dy, runs, library
    res["rows_wgmma"] = rows_wgmma_timing(gen)
    res["tgmm_skewed"] = tgmm_skewed_timing(gen)
    res["gmm_decode"] = gmm_decode_timing(gen)
    emit("gmm_timing", shape=dict(tokens=8192, k=2, E=8, D=d, F=f, bm=bm,
                                  routed_rows=routed, NP=n_rows,
                                  dtype="bfloat16"), **res)
    return res


def rows_wgmma_timing(gen):
    """K5 and K6 (``gmm_rows_wgmma``) at the training shape with and
    without the counts, in both :data:`GMM_GEOMETRIES`, on the balanced
    layout and on the skewed one (expert 0's logits raised by 2), each
    beside its library call and its bound; every output is held to the
    plain version under :data:`GMM_TOL`."""
    from tensorflowonspark_tpu_torch.ops import gmm

    out = {}
    for layout, skew in (("balanced", 0.0), ("skewed", 2.0)):
        for geo, (d, f) in GMM_GEOMETRIES.items():
            c = make_gmm_case(gen, g=8192, k=2, e=8, d=d, f=f, bm=256,
                              dtype=torch.bfloat16, skew=skew)
            x, w, dy, te, bm, gs = (c[n] for n in ("x", "w", "dy", "te",
                                                   "bm", "sizes"))
            library, _ = gmm_library(c)
            bound_ms, bound_by, _, flops = gmm_bound(c)
            calls = {
                "gmm": (lambda s: gmm.gmm_call(x, w, te, bm=bm,
                                               group_sizes=s),
                        lambda: gmm.gmm_plain(x, w, te, bm=bm)),
                "gmm_dxt": (lambda s: gmm.gmm_dxt_call(dy, w, te, bm=bm,
                                                       group_sizes=s),
                            lambda: gmm.gmm_dxt_plain(dy, w, te, bm=bm)),
            }
            for name, (call, plain) in calls.items():
                ref = plain().float()
                checked = max(row_relative_error(call(s).float(), ref)
                              for s in (gs, None))
                if not checked <= GMM_TOL["bf16_row_rel"]:
                    raise AssertionError("{0} {1} {2}: {3}".format(
                        name, geo, layout, checked))
                ms = time_ms(lambda _: call(gs), [None], reps=20, warmup=3)
                ms_all = time_ms(lambda _: call(None), [None], reps=20,
                                 warmup=3)
                out["{0}_{1}_{2}".format(name, geo, layout)] = dict(
                    ms=ms, ms_all_rows=ms_all,
                    library_ms=time_ms(library[name], [None], reps=20,
                                       warmup=3),
                    bound_ms=bound_ms, bound_by=bound_by,
                    tflops=flops / ms / 1e9,
                    tflops_all_rows=flops / ms_all / 1e9,
                    checked_err=checked, D=d, F=f, skew=skew,
                    expert_rows=c["sizes"].tolist())
            del c, x, w, dy, calls, library
    return out


def gmm_decode_timing(gen):
    """K5 at a decode step of ``moe_train_to_serve``: 4 tokens, top-2 of 8
    experts, 8 routed rows in NP = 2,304, D=1024 -> F=4096, bf16, with and
    without the counts, beside ``torch._grouped_mm`` and the bound.  The
    calls alternate between two copies of the weights (128 MB, more than
    the L2 cache), so each reads them cold, as a layer does in a decode
    step.  ``ms`` is CUDA events around back-to-back calls (what the
    eager decode loop pays, host included), ``device_ms`` the profiler's
    kernel time."""
    from tensorflowonspark_tpu_torch.ops import gmm

    c = make_gmm_case(gen, g=4, k=2, e=8, d=1024, f=4096, bm=256,
                      dtype=torch.bfloat16, skew=0.0)
    x, w, te, bm, gs = (c[n] for n in ("x", "w", "te", "bm", "sizes"))
    ref = gmm.gmm_plain(x, w, te, bm=bm).float()
    checked = max(row_relative_error(
        gmm.gmm_call(x, w, te, bm=bm, group_sizes=s).float(), ref)
        for s in (gs, None))
    if not checked <= GMM_TOL["bf16_row_rel"]:
        raise AssertionError("gmm at the decode shape: {0}".format(checked))
    ws = [w, w.clone()]
    ms = time_ms(lambda ww: gmm.gmm_call(x, ww, te, bm=bm, group_sizes=gs),
                 ws, reps=50, warmup=6)
    ms_all = time_ms(lambda ww: gmm.gmm_call(x, ww, te, bm=bm), ws, reps=50,
                     warmup=6)
    dev = device_ms(lambda ww: gmm.gmm_call(x, ww, te, bm=bm,
                                            group_sizes=gs), ws)
    dev_all = device_ms(lambda ww: gmm.gmm_call(x, ww, te, bm=bm), ws)
    library_ms = library_device_ms = None
    if hasattr(torch, "_grouped_mm"):
        offs = torch.cumsum(torch.bincount(te.long(), minlength=c["e"])
                            * bm, 0).to(torch.int32)
        library_ms = time_ms(
            lambda ww: torch._grouped_mm(x, ww, offs=offs), ws, reps=50,
            warmup=6)
        library_device_ms = device_ms(
            lambda ww: torch._grouped_mm(x, ww, offs=offs), ws)
    bound_ms, bound_by, nbytes, flops = gmm_bound(c)
    return dict(ms=ms, ms_all_rows=ms_all, device_ms=dev,
                device_ms_all_rows=dev_all,
                library_device_ms=library_device_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
                flops=flops, NP=x.shape[0], routed_rows=c["routed"],
                expert_rows=c["sizes"].tolist(), checked_err=checked)


def tgmm_skewed_timing(gen):
    """K7 and its library call at the same shape on a skewed layout: the
    ``gmm_case`` router with expert 0's logits raised by 2, so the runs
    differ several-fold in length."""
    from tensorflowonspark_tpu_torch.ops import gmm

    c = make_gmm_case(gen, g=8192, k=2, e=8, d=1024, f=4096, bm=256,
                      dtype=torch.bfloat16, skew=2.0)
    x, dy, te, bm, e = (c[n] for n in ("x", "dy", "te", "bm", "e"))
    got = gmm.tgmm_call(x, dy, te, e, bm=bm)
    torch.cuda.synchronize()
    ref = gmm.tgmm_plain(x, dy, te, e, bm=bm)
    checked = row_relative_error(got.float(), ref.float())
    if not checked <= GMM_TOL["bf16_row_rel"]:
        raise AssertionError("tgmm on the skewed layout: {0}".format(checked))
    d, f = x.shape[1], dy.shape[1]
    rows = (torch.bincount(te.long(), minlength=e) * bm).tolist()
    flops = 2 * c["routed"] * d * f
    present = sum(1 for r in rows if r)
    nbytes = 2 * (c["routed"] * d + present * d * f + c["routed"] * f)
    bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_SEC
    ops_ms = 1e3 * flops / BF16_FLOPS_PER_SEC
    ms = time_ms(lambda _: gmm.tgmm_call(x, dy, te, e, bm=bm), [None],
                 reps=20, warmup=3)
    library, _ = gmm_library(c)
    return dict(
        ms=ms, library_ms=time_ms(library["tgmm"], [None], reps=20,
                                  warmup=3),
        bound_ms=max(bytes_ms, ops_ms),
        bound_by="bytes" if bytes_ms >= ops_ms else "operations",
        tflops=flops / ms / 1e9, expert_rows=rows,
        max_abs_err=(got.float() - ref.float()).abs().max().item(),
        checked_err=checked, skew=2.0,
    )


def moe_tree():
    """The MoE flagship's random Flax-layout weights from seed 14."""
    from tensorflowonspark_tpu_torch import convert
    from tensorflowonspark_tpu_torch.models import transformer

    return convert.init_params_tree(
        transformer.TransformerConfig(**MOE_FLAGSHIP), seed=14)


def moe_trainer(tree):
    """The MoE bench model for training as the JAX package's bench runs
    it: f32 master weights, bf16 compute, flash attention, remat
    ``block``, ``SyncTrainer(moe_loss_fn(model), adamw(1e-4),
    has_aux=True)``, and one stacked [4, 4, 2048] token batch on the
    card."""
    from tensorflowonspark_tpu_torch import convert, optim
    from tensorflowonspark_tpu_torch.models import moe, transformer
    from tensorflowonspark_tpu_torch.parallel import dp

    cfg = transformer.TransformerConfig(**dict(
        MOE_FLAGSHIP, attention_impl="flash", remat=True,
        remat_policy="block"))
    model = convert.params_from_flax(tree, cfg, param_dtype=torch.float32)
    trainer = dp.SyncTrainer(moe.moe_loss_fn(model), optim.adamw(1e-4),
                             has_aux=True)
    state = trainer.create_state(dict(model.named_parameters()))
    tokens = np.random.default_rng(15).integers(
        0, cfg.vocab_size, (TRAIN_K, MOE_TRAIN_B, TRAIN_S))
    stacked = {"tokens": torch.from_numpy(tokens.astype(np.int32)).to(
        trainer.batch_sharding())}
    return cfg, model, trainer, state, stacked


def reset_launches():
    """Every kernel launch count of the port to 0."""
    from tensorflowonspark_tpu_torch.ops import flash_attention, gmm

    flash_attention.flash_attention.launches = {"fwd": 0, "dq": 0, "dkv": 0}
    gmm.grouped_matmul.launches = {n: 0 for n in GMM_KERNELS}


def read_launches():
    from tensorflowonspark_tpu_torch.ops import flash_attention, gmm

    return dict(gmm.grouped_matmul.launches,
                **flash_attention.flash_attention.launches)


def phase_moe_train_flagship(gmm_timing, flash_timing):
    """One warm-up and two timed ``multi_step`` of K=4 of
    :func:`moe_trainer` on its stacked batch."""
    cfg, model, trainer, state, stacked = moe_trainer(moe_tree())
    n_params = sum(p.numel() for p in model.parameters())
    expert = sum(p.numel() for n, p in model.named_parameters()
                 if ".moe." in n and not n.endswith(".router"))
    n_active = n_params - expert + expert * cfg.expert_k // cfg.num_experts
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    metrics, walls = [], []
    for _ in range(3):  # warm-up, then two timed groups
        t0 = time.perf_counter()
        state, m = trainer.multi_step_on_device(state, stacked)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        metrics.append(m)
    launches = read_launches()
    per_step = {k: torch.cat([m[k] for m in metrics]).float().cpu().numpy()
                for k in ("loss", "ce", "moe_aux")}
    losses = per_step["loss"]
    steps = len(losses)
    peak = torch.cuda.max_memory_allocated()
    best = min(walls[1:])
    step_ms = 1e3 * best / TRAIN_K
    tokens_per_sec = TRAIN_K * MOE_TRAIN_B * TRAIN_S / best
    flops_per_token = 6.0 * n_active + 12.0 * cfg.num_layers * \
        cfg.num_heads * cfg.head_dim * TRAIN_S
    # per-step device time of each kernel at the timing phases' shapes
    # (the flash timing ran at B=8; this batch is B=4)
    per_launch_ms = {n: gmm_timing[n]["ms"] for n in GMM_KERNELS}
    per_launch_ms.update({n: flash_timing[n]["ms"] * MOE_TRAIN_B / TRAIN_B
                          for n in ("fwd", "dq", "dkv")})
    want = {n: c * cfg.num_layers * steps
            for n, c in MOE_LAUNCHES_PER_LAYER.items()}
    res = dict(
        model="L4 H8 Dh128 Dm1024 Dff4096 V32000 E8 top-2 dropless, remat "
              "block, flash, bf16 compute, f32 masters",
        params=n_params, active_params=n_active,
        batch=[TRAIN_K, MOE_TRAIN_B, TRAIN_S], steps=steps,
        losses=losses.tolist(), ce=per_step["ce"].tolist(),
        moe_aux=per_step["moe_aux"].tolist(), warmup_sec=walls[0],
        timed_sec=walls[1:], step_ms=step_ms, tokens_per_sec=tokens_per_sec,
        mfu_active=tokens_per_sec * flops_per_token / BF16_FLOPS_PER_SEC,
        flops_per_token=flops_per_token, peak_memory_bytes=peak,
        launches=launches, launches_expected=want,
        launches_per_step={n: v / steps for n, v in launches.items()},
        kernel_share_of_step_est={
            n: launches[n] / steps * ms / step_ms
            for n, ms in per_launch_ms.items()},
        device=torch.cuda.get_device_name(0),
    )
    emit("moe_train_flagship", **res)
    if not np.isfinite(losses).all():
        raise AssertionError("non-finite loss: {0}".format(losses))
    if not losses[-1] < losses[0]:
        raise AssertionError("loss did not fall: {0}".format(losses))
    if launches != want:
        raise AssertionError("launches {0} != {1}".format(launches, want))
    return res, model


def phase_moe_dropless_vs_gather():
    """The MoE flagship's widths in f32 at two layers, S=512, B=2: three
    SGD steps from the same weights with ``dropless`` (the kernels) and
    with ``gather`` at capacity factor E/k (plain PyTorch, nothing
    dropped), both on the card (dot attention in both), held to
    :data:`TRAIN_VS_DOT_TOL` (the same f32 products in another order)."""
    from tensorflowonspark_tpu_torch import convert, optim
    from tensorflowonspark_tpu_torch.models import moe, transformer
    from tensorflowonspark_tpu_torch.parallel import dp

    base = dict(MOE_FLAGSHIP, dtype="float32", num_layers=2,
                max_seq_len=512, capacity_factor=MOE_FLAGSHIP["num_experts"]
                / MOE_FLAGSHIP["expert_k"])
    tree = convert.init_params_tree(transformer.TransformerConfig(**base),
                                    seed=16)
    tokens = np.random.default_rng(17).integers(
        0, base["vocab_size"], (3, 2, 512)).astype(np.int32)
    runs = {}
    for dispatch in ("dropless", "gather"):
        cfg = transformer.TransformerConfig(**dict(base,
                                                   expert_dispatch=dispatch))
        model = convert.params_from_flax(tree, cfg,
                                         param_dtype=torch.float32)
        trainer = dp.SyncTrainer(moe.moe_loss_fn(model),
                                 optim.sgd(0.01, momentum=0.9), has_aux=True)
        state = trainer.create_state(dict(model.named_parameters()))
        reset_launches()
        state, metrics = trainer.multi_step(state, {"tokens": tokens})
        runs[dispatch] = (metrics["loss"].cpu().numpy(),
                          convert._flatten(convert.tree_from_model(model)),
                          {n: read_launches()[n] for n in GMM_KERNELS})
        del model, trainer, state
    loss_k, params_k, launches_k = runs["dropless"]
    loss_g, params_g, launches_g = runs["gather"]
    loss_rel = float(np.max(np.abs(loss_k - loss_g) / np.abs(loss_g)))
    moved, diff, rel = leaf_agreement(convert._flatten(tree), params_k,
                                      params_g)
    worst = max(rel, key=rel.get)
    ok = (loss_rel <= TRAIN_VS_DOT_TOL["loss_rtol"]
          and rel[worst] <= TRAIN_VS_DOT_TOL["param_rel_to_move"]
          and min(launches_k.values()) > 0 and max(launches_g.values()) == 0)
    emit("moe_train_dropless_vs_gather",
         model="L2 H8 Dh128 Dm1024 Dff4096 E8 top-2 f32 S512 B2",
         capacity_factor=base["capacity_factor"],
         losses_dropless=loss_k.tolist(), losses_gather=loss_g.tolist(),
         loss_max_rel_diff=loss_rel, param_max_abs_diff=max(diff.values()),
         param_moved_by_leaf=moved, param_diff_rel_to_move=rel,
         worst_leaf=worst, tol=TRAIN_VS_DOT_TOL,
         launches_dropless=launches_k, launches_gather=launches_g, ok=ok)
    if not ok:
        raise AssertionError("dropless vs gather MoE training disagree")


def phase_moe_train_to_serve(model):
    """The trained MoE weights through slice 1's serving path: K5 in
    every prefill and decode forward of every layer, K1 in every decode
    step."""
    from tensorflowonspark_tpu_torch import convert

    tree = convert.tree_from_model(model)
    serving_cfg = dict(SERVING, max_new_tokens=16, max_prompt_len=64)
    rows = make_requests(np.random.default_rng(18), 4,
                         MOE_FLAGSHIP["vocab_size"], 16, 64)
    reset_launches()
    out, stats, wall, paged = serve(MOE_FLAGSHIP, serving_cfg, tree, rows)
    launches = {n: read_launches()[n] for n in GMM_KERNELS}
    layers = MOE_FLAGSHIP["num_layers"]
    steps = stats["chunks"] * serving_cfg["chunk_size"]
    want = {"gmm": 3 * layers * (stats["admitted"] + steps), "gmm_dxt": 0,
            "tgmm": 0}
    gen = [np.asarray(r["generated"]) for r in out]
    vocab = MOE_FLAGSHIP["vocab_size"]
    ok = (len(gen) == 4 and all(g.shape == (16,) and g.min() >= 0
                                and g.max() < vocab for g in gen)
          and launches == want and paged == layers * steps)
    emit("moe_train_to_serve", requests=len(gen),
         tokens_out=stats["tokens_out"], wall_sec=wall, decode_steps=steps,
         prefills=stats["admitted"], gmm_launches=launches,
         gmm_launches_expected=want, paged_attention_launches=paged,
         first_tokens=[g[:4].tolist() for g in gen], ok=ok)
    if not ok:
        raise AssertionError("trained MoE weights did not serve: {0} "
                             "{1}".format(launches, gen))


#: the fed losses against ``train_flagship``'s, relative: the same
#: weights, kernels and batches run in the same order, so they agree to
#: the bit (0 in every run so far); within the first epoch the losses of
#: different batches differ by ~1e-3, so a feeder that swapped or
#: repeated rows or batches fails this
FEED_LOSS_RTOL = 1e-6


def card_uuid(device=0):
    """The UUID of a CUDA device as ``nvidia-smi`` prints it, lower-case
    and without the ``GPU-`` prefix."""
    return _bare_uuid(str(torch.cuda.get_device_properties(device).uuid))


def _bare_uuid(uuid):
    uuid = uuid.lower()
    return uuid[4:] if uuid.startswith("gpu-") else uuid


def gpu_choice():
    """``(ids, uuid)``: the card ``gpu_info`` gives a one-GPU node of
    host-local rank 0, and its UUID as :func:`card_uuid` prints it."""
    from tensorflowonspark_tpu_torch.cluster import gpu_info

    chosen = gpu_info.get_gpus(1, worker_index=0)
    return chosen, [_bare_uuid(g["uuid"]) for g in gpu_info.allocatable_gpus()
                    if g["id"] == chosen[0]][0]


def max_rel_diff(got, want):
    """The largest relative difference of two equal-shaped arrays
    (``inf`` when the shapes differ)."""
    if got.shape != want.shape:
        return float("inf")
    return (np.abs(got - want) / np.abs(want)).max()


def feed_train_fn(args, ctx):
    """The user fn of ``feed_train_flagship`` and
    ``feed_ring_train_flagship``, run in the compute process:
    :func:`train_from_feed` on the node's feed; writes ``args["out"]``."""
    result, _ = train_from_feed(args, ctx, ctx.get_data_feed())
    with open(args["out"], "w") as f:
        json.dump(result, f)


def train_from_feed(args, ctx, feed):
    """The flagship from the seed-0 tree, trained from ``feed`` by two
    ``train_on_feed`` calls of ``args["k"]`` and ``2 * args["k"]`` steps
    of ``args["batch"]`` rows (with ``args["preprocess"]`` as the
    trainer's ``device_preprocess`` when given).  Returns ``(result,
    model)``: the losses, launches and timings as a JSON-able dict, and
    the trained model.

    Neither callback synchronises: a host timestamp in each measures
    the feed wait between groups.  When the cluster asked for a profile
    capture (``cluster.run(profile_dir=)``), its session is live from
    before the model is built; the result says where its trace went and
    how long the stop took.  ``timed_step_sec_sum`` is the process
    registry's ``train.step_sec`` sum over the timed call (host
    dispatch: no step synchronises)."""
    t_start = time.perf_counter()
    from tensorflowonspark_tpu_torch import compat, convert, optim
    from tensorflowonspark_tpu_torch import telemetry, tensorboard

    session = tensorboard.active_session()
    from tensorflowonspark_tpu_torch.models import transformer
    from tensorflowonspark_tpu_torch.ops import _build
    from tensorflowonspark_tpu_torch.ops.flash_attention import (
        flash_attention,
    )
    from tensorflowonspark_tpu_torch.parallel import dp

    device = compat.resolve_device()
    build_s = _build.build(["flash_attention"])["flash_attention"]
    ctx.initialize_distributed()
    tree = convert.init_params_tree(
        transformer.TransformerConfig(**FLAGSHIP), seed=0)  # as flagship_tree
    cfg = transformer.TransformerConfig(**dict(FLAGSHIP,
                                               attention_impl="flash"))
    model = convert.params_from_flax(tree, cfg, device=device,
                                     param_dtype=torch.float32)
    del tree
    trainer = dp.SyncTrainer(transformer.loss_fn(model), optim.adamw(1e-4),
                             device_preprocess=args.get("preprocess"))
    state = trainer.create_state(dict(model.named_parameters()))
    losses, marks = [], []
    multi = trainer.multi_step_on_device

    def multi_step_on_device(*a):
        out = multi(*a)
        losses.append(out[1]["loss"])  # a device tensor: no sync
        return out

    trainer.multi_step_on_device = multi_step_on_device
    k, b = args["k"], args["batch"]
    calls = dict(batch_size=b, columnar=True, steps_per_execution=k,
                 step_callback=lambda step: marks.append(
                     ("step", time.perf_counter())),
                 metrics_callback=lambda step, m: marks.append(
                     ("metrics", time.perf_counter())))
    flash_attention.launches = {"fwd": 0, "dq": 0, "dkv": 0}
    state = trainer.train_on_feed(state, feed, max_steps=k,
                                  terminate_on_max_steps=False, **calls)
    torch.cuda.synchronize()
    first_step = marks[0][1]
    del marks[:]
    before = telemetry.get_registry().snapshot()
    t0 = time.perf_counter()
    state = trainer.train_on_feed(state, feed, max_steps=2 * k,
                                  terminate_on_max_steps=False, **calls)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    timed = telemetry.snapshot_delta(telemetry.get_registry().snapshot(),
                                     before)["histograms"]["train.step_sec"]
    # the feed's source and ring before terminate() drains and closes it
    hot_source = feed._hot_source
    ring = None if feed._ring is None else feed._ring.name
    # what terminate_on_max_steps would add at the cap, timed apart: the
    # drain waits out its quiet gap even when nothing is in flight
    t1 = time.perf_counter()
    feed.terminate()
    terminate_sec = time.perf_counter() - t1
    waits, prev = [], t0
    for kind, t in marks:
        if kind == "step":
            waits.append(t - prev)
        else:
            prev = t
    result = dict(
        losses=torch.cat(losses).float().cpu().numpy().tolist(),
        launches=dict(flash_attention.launches), steps=int(state.step),
        timed_steps=2 * k, wall_sec=wall, feed_wait_sec=waits,
        terminate_sec=terminate_sec,
        startup_sec=first_step - t_start, flash_build_sec=build_s,
        cuda_visible_devices=os.environ.get("CUDA_VISIBLE_DEVICES"),
        device=torch.cuda.get_device_name(device), uuid=card_uuid(device),
        pid=os.getpid(), wire=feed.wire_stats(), hot_source=hot_source,
        ring=ring, peak_memory_bytes=torch.cuda.max_memory_allocated(device),
        timed_step_sec_sum=timed["sum"], timed_step_sec_count=timed["count"],
        profile=None if session is None else dict(
            log_dir=session.log_dir, trace_path=session.trace_path,
            stop_sec=session.stop_sec, steps_left=session.remaining),
    )
    return result, model


def feed_fail_fn(args, ctx):
    """A user fn that raises at once (the failure check of
    ``feed_train_flagship``)."""
    raise RuntimeError("injected failure in the user fn")


def feed_cluster(fn, args, rows, epochs, env=None, plane=None, **run_kw):
    """``cluster.run`` over a one-executor ``LocalEngine`` (with ``env``
    set in the executor) with one GPU, ``train`` of ``rows`` as one
    partition, ``shutdown``; the engine is stopped whatever happens.
    With ``plane`` (a :class:`FleetPlane`) the health plane starts before
    ``train`` and is read after it, before ``shutdown``; ``run_kw`` goes
    to ``cluster.run``.  Returns ``(startup_sec, train_sec, error)``,
    where ``error`` is the ``RuntimeError`` that ``train`` or
    ``shutdown`` raised (``None`` when neither did)."""
    from tensorflowonspark_tpu_torch.cluster import cluster
    from tensorflowonspark_tpu_torch.engine import LocalEngine

    engine = LocalEngine(1, env=env)
    try:
        t0 = time.perf_counter()
        c = cluster.run(engine, fn, args, num_executors=1,
                        num_chips_per_node=1,
                        input_mode=cluster.InputMode.SPARK,
                        reservation_timeout=120, **run_kw)
        t1 = time.perf_counter()
        if plane is not None:
            plane.start(c)
        error = None
        try:
            c.train([rows], num_epochs=epochs, feed_timeout=600)
        except RuntimeError as e:
            error = e
        t2 = time.perf_counter()
        try:
            if plane is not None and error is None:
                plane.read(c)
        finally:
            try:
                c.shutdown(timeout=600)
            except RuntimeError as e:
                error = error or e
        return t1 - t0, t2 - t1, error
    finally:
        engine.stop()


#: The health plane's rules in ``feed_train_flagship``: the same p99 of
#: the fed step (host dispatch time) held to 50 ms, which the flagship's
#: ~160 ms step breaks, and to 5 s, which it keeps.
FLEET_SLO = [
    {"name": "step-fast", "metric": "train.step_sec", "stat": "p99",
     "op": "<", "threshold": 0.05, "window": 60, "severity": "warn"},
    {"name": "step-bounded", "metric": "train.step_sec", "stat": "p99",
     "op": "<", "threshold": 5.0, "window": 60, "severity": "warn"},
]
FLEET_SCRAPE_SEC = 0.5
FLEET_COUNTERS = ("train.steps", "feed.wire_rows", "feed.wire_records")


def _http_get(url):
    """``(status, body)`` of a GET; an error status is a result, a
    failed connection raises."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, r.read().decode("utf-8")
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode("utf-8")


class FleetPlane(object):
    """The fleet observability plane of one ``feed_cluster`` run:
    ``start`` starts the cluster's health plane with :data:`FLEET_SLO`
    and its HTTP surface; ``read`` (after ``train``, before
    ``shutdown``) waits until the fleet view holds ``want_steps`` steps,
    then reads ``cluster.metrics()``, ``cluster.journal()``, the alert
    history and the five routes into ``self.result``.  Nothing is
    caught: a failed scrape or RPC fails the phase."""

    def __init__(self, want_steps, timeout=30.0):
        self.want_steps = want_steps
        self.timeout = timeout
        self.result = {}
        self.plane = None

    def start(self, c):
        t0 = time.perf_counter()
        self.plane = c.start_health_plane(port=0, interval=FLEET_SCRAPE_SEC,
                                          slo=FLEET_SLO)
        self.result["start_sec"] = time.perf_counter() - t0

    def read(self, c):
        from tensorflowonspark_tpu_torch import telemetry

        t0 = time.perf_counter()
        deadline = t0 + self.timeout
        url = self.plane.exposition.url
        own = telemetry.get_registry()
        while True:
            view = c.metrics()
            journal = c.journal()
            history = view["fleet"].get("alert_history", [])
            status, body = _http_get(url + "/metrics")
            fams = telemetry.parse_openmetrics(body)
            om = {n: fams[n.replace(".", "_")]["samples"][0][2]
                  for n in FLEET_COUNTERS
                  if n.replace(".", "_") in fams}
            # /metrics merges the driver's own registry in
            own_c = own.snapshot()["counters"]
            om_fleet = {n: v - own_c.get(n, 0) for n, v in om.items()}
            if (view["fleet"]["counters"].get("train.steps")
                    == self.want_steps
                    and om_fleet.get("train.steps") == self.want_steps
                    and any(a["rule"] == "step-fast" for a in history)
                    and "0" in journal["clocks"]):
                break
            if time.perf_counter() > deadline:
                raise AssertionError(
                    "the fleet view did not settle within {0} s: fleet "
                    "{1}, /metrics {2}, alerts {3}, clocks {4}".format(
                        self.timeout, view["fleet"]["counters"], om_fleet,
                        history, journal["clocks"]))
            time.sleep(0.25)
        hz_code, hz = _http_get(url + "/healthz")
        st_code, st = _http_get(url + "/status")
        us_code, _ = _http_get(url + "/usage")
        jr_code, jr = _http_get(url + "/journal")
        ex = view["executors"][0]
        self.result.update(
            read_sec=time.perf_counter() - t0, metrics_status=status,
            fleet={n: view["fleet"]["counters"].get(n)
                   for n in FLEET_COUNTERS},
            openmetrics=om_fleet, openmetrics_families=len(fams),
            healthz_status=hz_code, healthz=json.loads(hz),
            status_status=st_code,
            status_providers=sorted(json.loads(st)["providers"]),
            usage_status=us_code, journal_status=jr_code,
            journal_events=len(json.loads(jr)["events"]),
            alert_history=[(a["rule"], a["state"], a["value"])
                           for a in history],
            metrics_age=ex.get("metrics_age"),
            heartbeat_interval=c.server.liveness.interval,
            clock=journal["clocks"].get("0"),
            fleet_step_sec_sum=view["fleet"]["histograms"]
            ["train.step_sec"]["sum"],
            scrapes=self.plane.store.scrapes)


def trace_kernel_counts(trace_path, names):
    """``{name: kernel events whose name contains it}`` in a
    ``torch.profiler`` Chrome trace, with the file's bytes."""
    with open(trace_path) as f:
        text = f.read()
    events = json.loads(text)["traceEvents"]
    kernels = [str(e.get("name", "")) for e in events
               if e.get("cat") == "kernel"]
    return {n: sum(1 for k in kernels if n in k) for n in names}, len(text)


def phase_feed_train_flagship(train):
    """The feed path: see the module docstring, phase 18.  ``train`` is
    :func:`phase_train_flagship`'s result."""
    import gc
    import importlib
    import tempfile

    gc.collect()
    torch.cuda.empty_cache()
    free_bytes, total_bytes = torch.cuda.mem_get_info()
    print("feed_train_flagship: {0} of {1} bytes free on the card before "
          "the compute process starts".format(free_bytes, total_bytes),
          flush=True)
    chosen, chosen_uuid = gpu_choice()
    # the fns by module name, not as __main__'s: the spawned processes
    # import this module under its own name
    smoke = importlib.import_module("chip_smoke")
    rng = np.random.default_rng(7)  # flagship_trainer's tokens, as rows
    tokens = rng.integers(0, FLAGSHIP["vocab_size"],
                          (TRAIN_K, TRAIN_B, TRAIN_S)).astype(np.int32)
    rows = [{"tokens": t} for t in tokens.reshape(-1, TRAIN_S)]
    tmp = tempfile.mkdtemp(prefix="feed_train_")
    out = os.path.join(tmp, "result.json")
    profile_dir = os.path.join(tmp, "profile")
    plane = FleetPlane(want_steps=3 * TRAIN_K)
    try:
        startup, train_sec, error = feed_cluster(
            smoke.feed_train_fn, {"out": out, "k": TRAIN_K,
                                  "batch": TRAIN_B},
            rows, epochs=3, plane=plane,
            env={"TFOS_TELEMETRY_PUBLISH_INTERVAL": str(FLEET_SCRAPE_SEC)},
            profile_dir=profile_dir, profile_steps=TRAIN_K)
        if error is not None:
            raise error
        if not os.path.exists(out):
            raise AssertionError("the compute process wrote no result")
        with open(out) as f:
            res = json.load(f)
        # the capture the cluster asked for: its trace under <dir>/<pid>
        t_trace = time.perf_counter()
        pdir = os.path.join(profile_dir, str(res["pid"]))
        traces = sorted(os.listdir(pdir)) if os.path.isdir(pdir) else []
        if len(traces) != 1 or res["profile"] is None \
                or res["profile"]["trace_path"] != os.path.join(pdir,
                                                               traces[0]):
            raise AssertionError("the capture the cluster asked for left "
                                 "{0} in {1} (session {2})".format(
                                     traces, pdir, res["profile"]))
        trace_counts, trace_bytes = trace_kernel_counts(
            os.path.join(pdir, traces[0]), WGMMA_KERNELS["flash_attention"])
        trace_read_sec = time.perf_counter() - t_trace
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    # the failure path: a fn that raises at once fails the driver
    _, _, failure = feed_cluster(smoke.feed_fail_fn, None, rows[:TRAIN_B],
                                 epochs=1)
    got = np.asarray(res["losses"])
    want = np.asarray(train["losses"])
    rel = max_rel_diff(got, want)
    steps = res["timed_steps"]
    tokens_per_sec = steps * TRAIN_B * TRAIN_S / res["wall_sec"]
    wait_ms = [1e3 * w for w in res["feed_wait_sec"]]
    line = dict(
        model=train["model"], rows=len(rows), epochs=3,
        steps=len(res["losses"]), timed_steps=steps,
        tokens_per_sec=tokens_per_sec,
        step_ms=1e3 * res["wall_sec"] / steps,
        train_flagship_tokens_per_sec=train["tokens_per_sec"],
        fed_over_stacked=tokens_per_sec / train["tokens_per_sec"],
        feed_wait_ms=wait_ms,
        feed_wait_share=sum(res["feed_wait_sec"]) / res["wall_sec"],
        terminate_sec=res["terminate_sec"],
        startup_sec=res["startup_sec"], cluster_startup_sec=startup,
        train_call_sec=train_sec, flash_build_sec=res["flash_build_sec"],
        losses=res["losses"], max_rel_loss_diff=rel,
        launches=res["launches"], compute_pid=res["pid"],
        driver_pid=os.getpid(),
        cuda_visible_devices=res["cuda_visible_devices"],
        chosen_gpus=chosen, chosen_uuid=chosen_uuid,
        compute_device=res["device"], compute_uuid=res["uuid"],
        peak_memory_bytes=res["peak_memory_bytes"], wire=res["wire"],
        free_bytes_before=free_bytes,
        plane=plane.result,
        profile=dict(res["profile"], kernel_events=trace_counts,
                     trace_bytes=trace_bytes, read_sec=trace_read_sec),
        # train.step_sec holds one value a group, the group's host time
        # over its steps; every timed group holds TRAIN_K steps
        timed_step_sec_total=res["timed_step_sec_sum"] * TRAIN_K,
        timed_step_sec_groups=res["timed_step_sec_count"],
        timed_wall_sec=res["wall_sec"],
        timed_dispatch_share=res["timed_step_sec_sum"] * TRAIN_K
        / res["wall_sec"],
        new_work_sec=dict(plane_start=plane.result["start_sec"],
                          plane_read=plane.result["read_sec"],
                          trace_stop=res["profile"]["stop_sec"],
                          trace_read=trace_read_sec),
        failure=None if failure is None else next(
            (ln for ln in str(failure).splitlines()
             if re.search(r"executor \d", ln)), str(failure).splitlines()[0]),
        nvidia_smi=nvidia_smi(),
    )
    emit("feed_train_flagship", **line)
    if not rel <= FEED_LOSS_RTOL:
        raise AssertionError("fed losses differ from train_flagship's by "
                             "{0} relative".format(rel))
    want_launches = FLAGSHIP["num_layers"] * len(want)
    if res["launches"] != {n: want_launches for n in ("fwd", "dq", "dkv")}:
        raise AssertionError("fed flash launches {0}, want {1} each".format(
            res["launches"], want_launches))
    if res["pid"] == os.getpid():
        raise AssertionError("the fn ran in the driver process")
    if (res["cuda_visible_devices"] != ",".join(map(str, chosen))
            or res["uuid"] != chosen_uuid):
        raise AssertionError("compute process on {0} (visible {1}), "
                             "gpu_info chose {2} ({3})".format(
                                 res["uuid"], res["cuda_visible_devices"],
                                 chosen, chosen_uuid))
    if failure is None or "executor 0" not in str(failure) \
            or "injected failure" not in str(failure):
        raise AssertionError("a raising user fn did not fail the driver "
                             "naming the executor: {0!r}".format(failure))
    check_fleet_plane(plane.result, res)
    # the capture covered the warm-up call: K2-K4 once a layer a step
    want_events = FLAGSHIP["num_layers"] * TRAIN_K
    if trace_counts != {n: want_events for n in trace_counts} \
            or res["profile"]["steps_left"] != 0:
        raise AssertionError("the cluster's capture holds {0} kernel events "
                             "({1} steps left), want {2} each".format(
                                 trace_counts, res["profile"]["steps_left"],
                                 want_events))
    return line


def check_fleet_plane(got, res):
    """The plane's readings of ``feed_train_flagship`` against the
    phase's own: the fleet's and ``/metrics``' counters equal the
    compute process's steps and wire readout, ``step-fast`` fired and
    ``step-bounded`` did not, ``/healthz`` 200, the ``ledger`` provider
    in ``/status``, a fresh snapshot and a clock sample of executor 0."""
    problems = []
    want = {"train.steps": len(res["losses"]),
            "feed.wire_rows": res["wire"]["rows"],
            "feed.wire_records": res["wire"]["records"]}
    if got["fleet"] != want or got["openmetrics"] != want:
        problems.append("counters: fleet {0}, /metrics {1}, the phase's "
                        "{2}".format(got["fleet"], got["openmetrics"], want))
    fired = {rule for rule, state, _ in got["alert_history"]
             if state == "firing"}
    if fired != {"step-fast"}:
        problems.append("alerts fired: {0}".format(got["alert_history"]))
    if got["healthz_status"] != 200 or not got["healthz"]["healthy"]:
        problems.append("/healthz {0}: {1}".format(got["healthz_status"],
                                                   got["healthz"]))
    if got["status_status"] != 200 or "ledger" not in \
            got["status_providers"]:
        problems.append("/status {0}: providers {1}".format(
            got["status_status"], got["status_providers"]))
    if got["usage_status"] != 200 or got["journal_status"] != 200 \
            or got["metrics_status"] != 200:
        problems.append("/usage {0}, /journal {1}, /metrics {2}".format(
            got["usage_status"], got["journal_status"],
            got["metrics_status"]))
    if not got["metrics_age"] < 3 * got["heartbeat_interval"]:
        problems.append("executor 0's snapshot is {0} s old".format(
            got["metrics_age"]))
    if not (got["clock"] and got["clock"]["rtt"] > 0):
        problems.append("no clock sample of executor 0: {0}".format(
            got["clock"]))
    if problems:
        raise AssertionError("fleet plane: " + "; ".join(problems))


def shm_segments():
    """The feed rings' segments in ``/dev/shm`` (``tfos_*``)."""
    return sorted(f for f in os.listdir("/dev/shm") if f.startswith("tfos_"))


def phase_feed_ring_train_flagship(train):
    """The shm ring and ``device_preprocess``: see the module docstring,
    phase 19.  ``train`` is :func:`phase_train_flagship`'s result."""
    import gc
    import importlib
    import tempfile

    from tensorflowonspark_tpu_torch.cluster.marker import (
        encode_columnar_parts, pack_columnar,
    )
    from tensorflowonspark_tpu_torch.data.columnar import WireSpec

    gc.collect()
    torch.cuda.empty_cache()
    st = os.statvfs("/dev/shm")
    shm_free = st.f_bavail * st.f_frsize
    print("feed_ring_train_flagship: {0} bytes free in /dev/shm".format(
        shm_free), flush=True)
    chosen, chosen_uuid = gpu_choice()
    smoke = importlib.import_module("chip_smoke")
    rng = np.random.default_rng(7)  # feed_train_flagship's rows, narrowed
    tokens = rng.integers(0, FLAGSHIP["vocab_size"],
                          (TRAIN_K, TRAIN_B, TRAIN_S)).astype(np.int32)
    rows = WireSpec({"tokens": "uint16"}).narrow_rows(
        [{"tokens": t} for t in tokens.reshape(-1, TRAIN_S)])
    # every epoch ships its 32 rows as one columnar wire record
    header, bufs = encode_columnar_parts(pack_columnar(rows))
    epochs = 3
    want_wire = epochs * (len(header) + sum(b.nbytes for b in bufs))
    out = os.path.join(tempfile.mkdtemp(prefix="feed_ring_"), "result.json")
    before = shm_segments()
    startup, train_sec, error = feed_cluster(
        smoke.feed_train_fn,
        {"out": out, "k": TRAIN_K, "batch": TRAIN_B,
         "preprocess": {"columns": ["tokens"], "dtype": "int32"}},
        rows, epochs=epochs, env={"TFOS_SHM_FEED": "1"})
    left = [f for f in shm_segments() if f not in before]
    if error is not None:
        raise error
    with open(out) as f:
        res = json.load(f)
    got = np.asarray(res["losses"])
    want = np.asarray(train["losses"])
    rel = max_rel_diff(got, want)
    steps = res["timed_steps"]
    tokens_per_sec = steps * TRAIN_B * TRAIN_S / res["wall_sec"]
    line = dict(
        model=train["model"], rows=len(rows), epochs=epochs,
        wire_dtype=str(rows[0]["tokens"].dtype), steps=len(res["losses"]),
        timed_steps=steps, tokens_per_sec=tokens_per_sec,
        step_ms=1e3 * res["wall_sec"] / steps,
        train_flagship_tokens_per_sec=train["tokens_per_sec"],
        fed_over_stacked=tokens_per_sec / train["tokens_per_sec"],
        feed_wait_ms=[1e3 * w for w in res["feed_wait_sec"]],
        feed_wait_share=sum(res["feed_wait_sec"]) / res["wall_sec"],
        terminate_sec=res["terminate_sec"], startup_sec=res["startup_sec"],
        cluster_startup_sec=startup, train_call_sec=train_sec,
        losses=res["losses"], max_rel_loss_diff=rel,
        launches=res["launches"], hot_source=res["hot_source"],
        ring=res["ring"], wire=res["wire"], want_wire_bytes=want_wire,
        wire_bytes_per_row=res["wire"]["bytes_per_row"],
        record_header_bytes=len(header), shm_free_bytes=shm_free,
        shm_left=left, compute_uuid=res["uuid"], chosen_uuid=chosen_uuid,
        peak_memory_bytes=res["peak_memory_bytes"], nvidia_smi=nvidia_smi(),
    )
    emit("feed_ring_train_flagship", **line)
    if not rel <= FEED_LOSS_RTOL:
        raise AssertionError("ring-fed losses differ from train_flagship's "
                             "by {0} relative".format(rel))
    want_launches = FLAGSHIP["num_layers"] * len(want)
    if res["launches"] != {n: want_launches for n in ("fwd", "dq", "dkv")}:
        raise AssertionError("ring-fed flash launches {0}, want {1} "
                             "each".format(res["launches"], want_launches))
    if res["hot_source"] != "ring" or not res["ring"]:
        raise AssertionError("the feed did not come from the ring: "
                             "{0}".format(res["hot_source"]))
    if res["wire"]["wire_bytes"] != want_wire \
            or res["wire"]["rows"] != epochs * len(rows):
        raise AssertionError("ring wire {0}, want {1} bytes".format(
            res["wire"], want_wire))
    if left or res["ring"] in shm_segments():
        raise AssertionError("shm segments left after engine.stop(): "
                             "{0}".format(left or [res["ring"]]))
    if res["uuid"] != chosen_uuid:
        raise AssertionError("compute process on {0}, gpu_info chose "
                             "{1}".format(res["uuid"], chosen_uuid))
    return line


INFER_ROWS, INFER_BATCH = 64, 8
INFER_RTOL = 1e-6


def inference_model(device):
    """The flagship for scoring: the seed-0 tree, bf16, flash attention."""
    from tensorflowonspark_tpu_torch import convert
    from tensorflowonspark_tpu_torch.models import transformer

    tree = convert.init_params_tree(
        transformer.TransformerConfig(**FLAGSHIP), seed=0)  # as flagship_tree
    cfg = transformer.TransformerConfig(**dict(FLAGSHIP,
                                               attention_impl="flash"))
    return convert.params_from_flax(tree, cfg, device=device)


def score_rows(model, tokens):
    """Each row's mean next-token cross-entropy, in f32 from the model's
    bf16 logits."""
    import torch.nn.functional as F

    tokens = tokens.to(torch.int64)
    logits = model(tokens)[:, :-1].float()
    ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                         tokens[:, 1:].reshape(-1), reduction="none")
    return ce.view(tokens.shape[0], -1).mean(1)


def feed_inference_fn(args, ctx):
    """The user fn of ``feed_inference_flagship``, run in the compute
    process: scores the fed rows with the flagship, batches of 8 through
    ``prefetch_to_device``; writes ``args["out"]``."""
    t_start = time.perf_counter()
    from tensorflowonspark_tpu_torch import compat
    from tensorflowonspark_tpu_torch.data.feed import prefetch_to_device
    from tensorflowonspark_tpu_torch.ops import _build
    from tensorflowonspark_tpu_torch.ops.flash_attention import (
        flash_attention,
    )

    device = compat.resolve_device()
    _build.build(["flash_attention"])
    feed = ctx.get_data_feed(train_mode=False,
                             input_mapping={"tokens": "tokens"})
    model = inference_model(device)
    flash_attention.launches = {"fwd": 0, "dq": 0, "dkv": 0}
    batches = prefetch_to_device(
        feed.batches(INFER_BATCH, pad_to_batch=True), size=2,
        preprocess={"columns": ["tokens"], "dtype": "int32"},
        host_prefetch=True)
    waits, scoring, dtypes = [], [], set()
    t0 = time.perf_counter()
    with torch.no_grad():
        while True:
            t = time.perf_counter()
            try:
                batch, n = next(batches)
            except StopIteration:
                break
            t1 = time.perf_counter()
            waits.append(t1 - t)
            dtypes.add(str(batch["tokens"].dtype))
            scores = score_rows(model, batch["tokens"])[:n].cpu()
            feed.batch_results(scores.tolist())
            scoring.append(time.perf_counter() - t1)
    result = dict(
        launches=dict(flash_attention.launches), wait_sec=waits,
        scoring_sec=scoring, loop_sec=time.perf_counter() - t0,
        startup_sec=t0 - t_start, batch_dtypes=sorted(dtypes),
        wire=feed.wire_stats(), hot_source=feed._hot_source,
        cuda_visible_devices=os.environ.get("CUDA_VISIBLE_DEVICES"),
        device=torch.cuda.get_device_name(device), uuid=card_uuid(device),
        pid=os.getpid(),
    )
    with open(args["out"], "w") as f:
        json.dump(result, f)


def phase_feed_inference_flagship():
    """Batch inference: see the module docstring, phase 20."""
    import gc
    import importlib
    import tempfile

    from tensorflowonspark_tpu_torch import compat
    from tensorflowonspark_tpu_torch.cluster import cluster
    from tensorflowonspark_tpu_torch.data import (
        _native, columnar, example, tfrecord,
    )
    from tensorflowonspark_tpu_torch.engine import LocalEngine

    gc.collect()
    torch.cuda.empty_cache()
    chosen, chosen_uuid = gpu_choice()
    smoke = importlib.import_module("chip_smoke")
    tokens = np.random.default_rng(11).integers(
        0, FLAGSHIP["vocab_size"], (INFER_ROWS, TRAIN_S))
    tmp = tempfile.mkdtemp(prefix="feed_infer_")
    path = os.path.join(tmp, "tokens.tfrecord")
    t0 = time.perf_counter()
    tfrecord.write_records(path, (example.encode_example({"tokens": row})
                                  for row in tokens))
    t1 = time.perf_counter()
    cols = columnar.load_tfrecords_columnar(
        path, {"tokens": ("uint16", TRAIN_S)})
    t2 = time.perf_counter()
    codecs = _native.loaded()
    if "libexample_codec.so" not in codecs \
            or "libtfrecord_codec.so" not in codecs:
        raise AssertionError("the native codecs did not load: {0}".format(
            codecs))
    if cols["tokens"].dtype != np.uint16 \
            or not (cols["tokens"] == tokens).all():
        raise AssertionError("the TFRecord rows did not decode to the "
                             "written tokens as uint16")
    rows = [(r,) for r in cols["tokens"]]
    half = INFER_ROWS // 2
    out = os.path.join(tmp, "result.json")
    engine = LocalEngine(1, env={"TFOS_SHM_FEED": "1"})
    try:
        t3 = time.perf_counter()
        c = cluster.run(engine, smoke.feed_inference_fn, {"out": out},
                        num_executors=1, num_chips_per_node=1,
                        input_mode=cluster.InputMode.SPARK,
                        reservation_timeout=120)
        t4 = time.perf_counter()
        got = c.inference([rows[:half], rows[half:]], feed_timeout=600)
        t5 = time.perf_counter()
        c.shutdown(timeout=600)
    finally:
        engine.stop()
    with open(out) as f:
        res = json.load(f)
    # the driver's own scores, same model and batches of 8 on this card
    model = inference_model(compat.resolve_device())
    want = []
    with torch.no_grad():
        for i in range(0, INFER_ROWS, INFER_BATCH):
            batch = torch.from_numpy(
                cols["tokens"][i:i + INFER_BATCH].astype(np.int32)).cuda()
            want.extend(score_rows(model, batch).cpu().tolist())
    del model
    got, want = np.asarray(got), np.asarray(want)
    rel = max_rel_diff(got, want)
    n_tokens = INFER_ROWS * TRAIN_S
    line = dict(
        model="L16 H8 Dh128 Dm1024 V32000 bf16, flash attention",
        rows=INFER_ROWS, batch=INFER_BATCH, results=len(got),
        max_rel_score_diff=rel, scores_first=got[:4].tolist(),
        tokens_per_sec_call=n_tokens / (t5 - t4),
        tokens_per_sec_scoring=n_tokens / sum(res["scoring_sec"]),
        inference_call_sec=t5 - t4, cluster_startup_sec=t4 - t3,
        scoring_ms=[1e3 * x for x in res["scoring_sec"]],
        prefetch_wait_ms=[1e3 * x for x in res["wait_sec"]],
        loop_sec=res["loop_sec"], fn_startup_sec=res["startup_sec"],
        tfrecord_write_sec=t1 - t0, tfrecord_decode_sec=t2 - t1,
        native_codecs=sorted(codecs), batch_dtypes=res["batch_dtypes"],
        launches=res["launches"], wire=res["wire"],
        hot_source=res["hot_source"], compute_uuid=res["uuid"],
        chosen_uuid=chosen_uuid,
        cuda_visible_devices=res["cuda_visible_devices"],
        nvidia_smi=nvidia_smi(),
    )
    emit("feed_inference_flagship", **line)
    if not rel <= INFER_RTOL:
        raise AssertionError("inference scores differ from the driver's by "
                             "{0} relative".format(rel))
    want_launches = {"fwd": FLAGSHIP["num_layers"] * INFER_ROWS //
                     INFER_BATCH, "dq": 0, "dkv": 0}
    if res["launches"] != want_launches:
        raise AssertionError("inference flash launches {0}, want {1}".format(
            res["launches"], want_launches))
    if res["batch_dtypes"] != ["torch.int32"]:
        raise AssertionError("batches reached the model as {0}".format(
            res["batch_dtypes"]))
    if res["uuid"] != chosen_uuid or res["pid"] == os.getpid():
        raise AssertionError("compute process on {0}, gpu_info chose "
                             "{1}".format(res["uuid"], chosen_uuid))
    return line


#: phase ``checkpoint_resume_serve``: the step spacing of the saves, the
#: steps of run 1 and of the whole run, the steps of one group, and the
#: reference's builder named in the export (resolved to the port's)
CKPT_EVERY, CKPT_RUN1_STEPS, CKPT_STEPS, CKPT_K = 6, 6, 12, 3
CKPT_MODEL_REF = "tensorflowonspark_tpu.models.transformer:serving_builder"


def tree_bytes(path):
    """The bytes of every file under ``path``."""
    return sum(os.path.getsize(os.path.join(root, f))
               for root, _, files in os.walk(path) for f in files)


def ckpt_train_fn(args, ctx):
    """The user fn of ``checkpoint_resume_serve``, run in the compute
    process: the flagship from the seed-0 tree (f32 masters, adamw(1e-4),
    flash), trained from the node's feed by ``train_on_feed`` with a
    ``Checkpointer`` (restoring its latest step first, when it holds one)
    up to ``args["max_steps"]``.  With ``args["export"]`` it then
    publishes the trained weights for serving and serves
    ``args["requests"]`` from them in memory.  Writes ``args["out"]``,
    with host-clock marks of its stages."""
    marks = [("start", time.perf_counter())]
    from tensorflowonspark_tpu_torch import checkpoint, compat, convert, optim
    from tensorflowonspark_tpu_torch.models import transformer
    from tensorflowonspark_tpu_torch.ops import _build
    from tensorflowonspark_tpu_torch.ops.flash_attention import (
        flash_attention,
    )
    from tensorflowonspark_tpu_torch.parallel import dp

    device = compat.resolve_device()
    _build.build(["flash_attention"])
    ctx.initialize_distributed()
    feed = ctx.get_data_feed()
    tree = convert.init_params_tree(
        transformer.TransformerConfig(**FLAGSHIP), seed=0)  # as flagship_tree
    cfg = transformer.TransformerConfig(**dict(FLAGSHIP,
                                               attention_impl="flash"))
    model = convert.params_from_flax(tree, cfg, device=device,
                                     param_dtype=torch.float32)
    del tree
    trainer = dp.SyncTrainer(transformer.loss_fn(model), optim.adamw(1e-4))
    state = trainer.create_state(dict(model.named_parameters()))
    ckptr = checkpoint.Checkpointer(args["dir"], max_to_keep=2)
    timed = {"save": [], "save_copy": [], "restore": []}
    save, restore = ckptr.save, ckptr.restore

    def timed_save(step, state, wait=False):
        # save(wait=True) as save(wait=False) + wait: the copy to the host
        # timed apart from the writes
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        saved = save(step, state, wait=False)
        t1 = time.perf_counter()
        if wait:
            ckptr.wait_until_finished()
        timed["save_copy"].append(t1 - t0)
        timed["save"].append(time.perf_counter() - t0)
        return saved

    def timed_restore(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = restore(*a, **kw)
        torch.cuda.synchronize()
        timed["restore"].append(time.perf_counter() - t0)
        return out

    ckptr.save, ckptr.restore = timed_save, timed_restore
    marks.append(("model_ready", time.perf_counter()))
    losses, groups = [], []
    multi = trainer.multi_step_on_device

    def multi_step_on_device(*a):
        out = multi(*a)
        losses.append(out[1]["loss"])  # a device tensor: no sync
        return out

    def group_start(step):
        torch.cuda.synchronize()
        groups.append([step, time.perf_counter()])

    def group_end(step, metrics):
        torch.cuda.synchronize()
        groups[-1] += [step, time.perf_counter()]

    trainer.multi_step_on_device = multi_step_on_device
    flash_attention.launches = {"fwd": 0, "dq": 0, "dkv": 0}
    t0 = time.perf_counter()
    state = trainer.train_on_feed(
        state, feed, batch_size=args["batch"], columnar=True,
        steps_per_execution=CKPT_K, max_steps=args["max_steps"],
        checkpointer=ckptr, checkpoint_every=CKPT_EVERY,
        step_callback=group_start, metrics_callback=group_end)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    marks.append(("trained", time.perf_counter()))
    launches = dict(flash_attention.launches)
    ckptr.close()
    n_state = sum(a.numel() * a.element_size() for a in
                  [p for p in state.params.values()]
                  + [t for st in state.opt_state.state.values()
                     for t in st.values() if isinstance(t, torch.Tensor)])
    result = dict(
        losses=torch.cat(losses).float().cpu().numpy().tolist(),
        launches=launches, steps=int(state.step), wall_sec=wall,
        groups=groups, save_sec=timed["save"],
        save_copy_sec=timed["save_copy"], restore_sec=timed["restore"],
        state_bytes=n_state, all_steps=ckptr.all_steps(),
        device=torch.cuda.get_device_name(device), pid=os.getpid(),
    )
    if args.get("export"):
        del state, trainer
        t1 = time.perf_counter()
        tree = convert.tree_from_model(model)
        t2 = time.perf_counter()
        checkpoint.publish_for_serving(
            args["export"], int(result["steps"]), tree, extra_metadata={
                "model_ref": CKPT_MODEL_REF,
                "model_config": dict(FLAGSHIP, **SERVING)})
        t3 = time.perf_counter()
        marks.append(("exported", t3))
        del model
        gc_collect()
        out, _, _, _ = serve(FLAGSHIP, SERVING, tree, args["requests"])
        marks.append(("served", time.perf_counter()))
        result.update(
            tree_from_model_sec=t2 - t1, export_sec=t3 - t2,
            export_bytes=int(sum(a.nbytes for a in
                                 convert._flatten(tree).values())),
            memory_tokens=[np.asarray(r["generated"]).tolist() for r in out])
    marks.append(("end", time.perf_counter()))
    result["stage_sec"] = {name: t - prev for (_, prev), (name, t)
                           in zip(marks, marks[1:])}
    with open(args["out"], "w") as f:
        json.dump(result, f)


def gc_collect():
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def phase_checkpoint_resume_serve(train):
    """Checkpoints and serving exports: see the module docstring, phase
    21.  ``train`` is :func:`phase_train_flagship`'s result."""
    import importlib
    import tempfile

    from tensorflowonspark_tpu_torch import checkpoint, serving
    from tensorflowonspark_tpu_torch.ops.paged_attention import (
        paged_attention,
    )

    t_phase = time.perf_counter()
    gc_collect()
    smoke = importlib.import_module("chip_smoke")
    tmp = tempfile.mkdtemp(prefix="ckpt_resume_")
    try:
        free_before = shutil.disk_usage(tmp).free
        ckpt_dir = os.path.join(tmp, "ckpt")
        root = os.path.join(tmp, "export")
        rng = np.random.default_rng(7)  # flagship_trainer's tokens, as rows
        tokens = rng.integers(0, FLAGSHIP["vocab_size"],
                              (TRAIN_K, TRAIN_B, TRAIN_S)).astype(np.int32)
        batches = [tokens[i % TRAIN_K] for i in range(CKPT_STEPS)]
        requests = make_requests(np.random.default_rng(2), REQUESTS,
                                 FLAGSHIP["vocab_size"], 16,
                                 SERVING["max_prompt_len"])
        runs = []
        for first, last, export in ((0, CKPT_RUN1_STEPS, None),
                                    (CKPT_RUN1_STEPS, CKPT_STEPS, root)):
            out = os.path.join(tmp, "result-{0}.json".format(last))
            rows = [{"tokens": r} for b in batches[first:last] for r in b]
            args = {"out": out, "dir": ckpt_dir, "batch": TRAIN_B,
                    "max_steps": last, "export": export,
                    "requests": requests}
            t_run = time.perf_counter()
            startup, call_sec, error = feed_cluster(
                smoke.ckpt_train_fn, args, rows, epochs=1)
            if error is not None:
                raise error
            with open(out) as f:
                runs.append(dict(json.load(f), cluster_startup_sec=startup,
                                 train_call_sec=call_sec,
                                 run_sec=time.perf_counter() - t_run))
        run1, run2 = runs
        on_disk = checkpoint.Checkpointer(ckpt_dir, max_to_keep=2)
        ckpt_bytes = tree_bytes(ckpt_dir)
        export_steps = checkpoint.list_serving_steps(root)
        t0 = time.perf_counter()
        predict = serving.load_predictor(os.path.join(root, "12"))
        load_sec = time.perf_counter() - t0
        export_disk_bytes = tree_bytes(root)
        got, stats, serve_wall, k1 = serve_rows(
            predict, [dict(r) for r in requests])
        del predict
        gc_collect()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    want = np.asarray(train["losses"])
    rel1 = max_rel_diff(np.asarray(run1["losses"]), want[:CKPT_RUN1_STEPS])
    rel2 = max_rel_diff(np.asarray(run2["losses"]),
                        want[CKPT_RUN1_STEPS:CKPT_STEPS])
    got_tokens = [np.asarray(r["generated"]).tolist() for r in got]
    decode_steps = stats["chunks"] * SERVING["chunk_size"]
    steady = run2["groups"][-1]  # the last group: no warm-up, no save
    steady_tokens = (steady[2] - steady[0]) * TRAIN_B * TRAIN_S
    line = dict(
        model=train["model"], steps=[CKPT_RUN1_STEPS, CKPT_STEPS],
        checkpoint_every=CKPT_EVERY, steps_per_execution=CKPT_K,
        latest_step=on_disk.latest_step(), all_steps=on_disk.all_steps(),
        resumed_losses=run2["losses"], max_rel_loss_diff=rel2,
        losses_equal_to_the_bit=run2["losses"] == train["losses"][
            CKPT_RUN1_STEPS:CKPT_STEPS],
        run1_max_rel_loss_diff=rel1, resume_launches=run2["launches"],
        run1_launches=run1["launches"], run2_steps=run2["steps"],
        state_bytes=run2["state_bytes"],
        save_sec=run1["save_sec"] + run2["save_sec"],
        save_copy_sec=run1["save_copy_sec"] + run2["save_copy_sec"],
        save_gb_per_sec=[run2["state_bytes"] / s / 1e9
                         for s in run1["save_sec"] + run2["save_sec"]],
        restore_sec=run2["restore_sec"],
        restore_gb_per_sec=[run2["state_bytes"] / s / 1e9
                            for s in run2["restore_sec"]],
        export_bytes=run2["export_bytes"], export_sec=run2["export_sec"],
        export_gb_per_sec=run2["export_bytes"] / run2["export_sec"] / 1e9,
        tree_from_model_sec=run2["tree_from_model_sec"],
        load_predictor_sec=load_sec, checkpoint_disk_bytes=ckpt_bytes,
        export_disk_bytes=export_disk_bytes, free_bytes_before=free_before,
        run2_wall_sec=run2["wall_sec"],
        run2_tokens_per_sec=(CKPT_STEPS - CKPT_RUN1_STEPS) * TRAIN_B
        * TRAIN_S / run2["wall_sec"],
        run2_steady_tokens_per_sec=steady_tokens / (steady[3] - steady[1]),
        train_flagship_tokens_per_sec=train["tokens_per_sec"],
        cluster_startup_sec=[r["cluster_startup_sec"] for r in runs],
        train_call_sec=[r["train_call_sec"] for r in runs],
        run_sec=[r["run_sec"] for r in runs],
        fn_stage_sec=[r["stage_sec"] for r in runs],
        phase_sec=time.perf_counter() - t_phase,
        export_steps=export_steps, requests=len(got),
        tokens_out=stats["tokens_out"], serve_wall_sec=serve_wall,
        decode_steps=decode_steps, export_serve_launches=k1,
        tokens_equal_to_memory=got_tokens == run2["memory_tokens"],
        first_tokens=[t[:4] for t in got_tokens[:4]],
        nvidia_smi=nvidia_smi(),
    )
    emit("checkpoint_resume_serve", **line)
    if not rel2 <= FEED_LOSS_RTOL or not rel1 <= FEED_LOSS_RTOL:
        raise AssertionError("losses differ from train_flagship's by {0} "
                             "(run 1) and {1} (resumed)".format(rel1, rel2))
    if run2["steps"] != CKPT_STEPS or line["latest_step"] != CKPT_STEPS \
            or line["all_steps"] != [CKPT_RUN1_STEPS, CKPT_STEPS]:
        raise AssertionError("checkpoint steps {0}, latest {1}, trained to "
                             "{2}".format(line["all_steps"],
                                          line["latest_step"], run2["steps"]))
    want_launches = FLAGSHIP["num_layers"] * (CKPT_STEPS - CKPT_RUN1_STEPS)
    if run2["launches"] != {n: want_launches for n in ("fwd", "dq", "dkv")}:
        raise AssertionError("resumed flash launches {0}, want {1} "
                             "each".format(run2["launches"], want_launches))
    if len(run2["restore_sec"]) != 1 or run1["restore_sec"]:
        raise AssertionError("restores: run 1 {0}, run 2 {1}".format(
            run1["restore_sec"], run2["restore_sec"]))
    if export_steps != [CKPT_STEPS]:
        raise AssertionError("exported steps {0}".format(export_steps))
    if not line["tokens_equal_to_memory"] or len(got) != REQUESTS:
        raise AssertionError("tokens served from the export differ from the "
                             "in-memory hand-off")
    if not (decode_steps > 0
            and k1 == FLAGSHIP["num_layers"] * decode_steps):
        raise AssertionError("paged_attention launches {0} != {1} layers x "
                             "{2} decode steps".format(
                                 k1, FLAGSHIP["num_layers"], decode_steps))
    return line


# ----------------------------------------------------------------------
# elastic supervision (phase 22, and phase_elastic_dp on four cards)
# ----------------------------------------------------------------------

#: the elastic phases' checkpoint spacing, kill step and epochs: saves at
#: steps 4, 8 and 12, the kill before step 7, so the reborn process
#: restores step 4 and the dead one's steps 5 and 6 are trained again
ELASTIC_CKPT_EVERY, ELASTIC_KILL_STEP, ELASTIC_EPOCHS = 4, 6, 3


def token_fp(tokens):
    """sha256 of a token batch's bytes (int32): the id of a batch in the
    elastic fns' step logs."""
    import hashlib

    return hashlib.sha256(
        np.ascontiguousarray(tokens, dtype=np.int32).tobytes()).hexdigest()


class StepLog(object):
    """One JSON line per event, written and flushed at once, with the
    wall clock: what a process leaves behind when it is SIGKILLed."""

    def __init__(self, path):
        self._f = open(path, "a")

    def __call__(self, event, **fields):
        self._f.write(json.dumps(dict(fields, event=event,
                                      t=time.time())) + "\n")
        self._f.flush()


def read_log(path):
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f]


def elastic_model(config, device, seeded=True):
    """The model of the elastic phase (f32 masters, flash attention), its
    ``SyncTrainer(adamw(1e-4))`` and a fresh state: what each incarnation
    trains, from the seed-0 tree, and what the driver replays from a
    checkpoint over torch's own init (``seeded=False``: the restore must
    overwrite every tensor for the replay to agree)."""
    from tensorflowonspark_tpu_torch import convert, optim
    from tensorflowonspark_tpu_torch.models import transformer
    from tensorflowonspark_tpu_torch.parallel import dp

    cfg = transformer.TransformerConfig(**dict(config,
                                               attention_impl="flash"))
    if seeded:
        model = convert.params_from_flax(
            convert.init_params_tree(
                transformer.TransformerConfig(**config), seed=0),
            cfg, device=device, param_dtype=torch.float32)
    else:
        model = transformer.Transformer(cfg, device=device,
                                        param_dtype=torch.float32)
    trainer = dp.SyncTrainer(transformer.loss_fn(model), optim.adamw(1e-4))
    return trainer, trainer.create_state(dict(model.named_parameters()))


def elastic_flagship_fn(args, ctx):
    """The user fn of ``elastic_flagship``, run in the compute process of
    each incarnation: :func:`elastic_model` trained from the node's feed
    by ``train_on_feed`` with a ``Checkpointer`` (every
    :data:`ELASTIC_CKPT_EVERY` steps, two kept) and the chaos plan's kill
    hook.  It logs to ``<log>/gen<g>.jsonl``: ``start`` and ``model``,
    ``restored`` (a process that restored a checkpoint also hard-links
    that step under ``args["keep"]``), ``saved``, ``group`` before each
    step (the kill hook runs right after it), ``step`` after it (the
    batch's fingerprint, the loss read on the host, the flash launch
    counts so far) and ``end``."""
    log = StepLog(os.path.join(args["log"], "gen%d.jsonl" % ctx.generation))
    log("start", pid=os.getpid(),
        cuda_visible_devices=os.environ.get("CUDA_VISIBLE_DEVICES"))
    from tensorflowonspark_tpu_torch import checkpoint, compat, telemetry

    # each incarnation's first journal event (the fleet journal's check)
    telemetry.get_tracer().mark("incarnation", generation=ctx.generation)
    from tensorflowonspark_tpu_torch.ops import _build
    from tensorflowonspark_tpu_torch.ops.flash_attention import (
        flash_attention,
    )
    from tensorflowonspark_tpu_torch.testing import chaos

    device = compat.resolve_device(args["device"])
    if device.type == "cuda":
        _build.build(["flash_attention"])

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    feed = ctx.get_data_feed()
    trainer, state = elastic_model(args["config"], device)
    sync()
    log("model", device=(torch.cuda.get_device_name(device)
                         if device.type == "cuda" else "cpu"),
        uuid=card_uuid(device) if device.type == "cuda" else None)
    ckptr = checkpoint.Checkpointer(args["ckpt"], max_to_keep=2)
    save, restore = ckptr.save, ckptr.restore

    def logged_restore(state_like, step=None):
        step = ckptr.latest_step() if step is None else step
        out = restore(state_like, step=step)
        sync()
        log("restored", step=int(step))
        shutil.copytree(os.path.join(args["ckpt"], str(step)),
                        os.path.join(args["keep"], str(step)),
                        copy_function=os.link)
        return out

    def logged_save(step, state, wait=False):
        sync()
        t0 = time.perf_counter()
        out = save(step, state, wait=wait)
        log("saved", step=int(step), sec=time.perf_counter() - t0)
        return out

    ckptr.save, ckptr.restore = logged_save, logged_restore
    fps = []
    place = trainer._place

    def logged_place(batch):
        fps.append(token_fp(batch["tokens"]))
        return place(batch)

    trainer._place = logged_place
    fault = chaos.step_fault_fn(ctx)

    def before(step):
        log("group", step=step)
        fault(step)

    def after(step, metrics):
        log("step", step=step, fp=fps[-1], loss=float(metrics["loss"]),
            launches=dict(flash_attention.launches))

    flash_attention.launches = {"fwd": 0, "dq": 0, "dkv": 0}
    state = trainer.train_on_feed(
        state, feed, batch_size=args["batch"], columnar=True,
        checkpointer=ckptr, checkpoint_every=ELASTIC_CKPT_EVERY,
        step_callback=before, metrics_callback=after)
    ckptr.close()
    log("end", steps=int(state.step), launches=dict(flash_attention.launches))


class RequeueLog(logging.Handler):
    """The driver's requeue rounds: ``(wall time, partition ids)``."""

    def __init__(self):
        super(RequeueLog, self).__init__(logging.WARNING)
        self.rounds = []

    def emit(self, record):
        if record.msg.startswith("elastic requeue round"):
            self.rounds.append((record.created, list(record.args[2])))


class RecoveryWatch(object):
    """Polls the driver's side of a one-node rebirth every 10 ms and
    keeps the wall time each stage was first seen: ``dead`` (the
    monitor's recovery window opened), ``rebirth`` (the server's
    generation rose: REBIRTH), ``register`` (the node's REG under the new
    generation, after its queue resets) and ``spawn`` (the node's kv
    holds the new generation: the barrier passed, the process started)."""

    def __init__(self, c):
        from tensorflowonspark_tpu_torch.cluster import manager

        self.c = c
        node = c.cluster_info[0]
        self._mgr = manager.connect(tuple(node["addr"]),
                                    bytes.fromhex(node["authkey"]))
        self.marks = {}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def start(self):
        self._thread.start()
        return self

    def _seen(self, name, cond):
        if name not in self.marks and cond():
            self.marks[name] = time.time()

    def _run(self):
        c = self.c
        while not self._stop.wait(0.01):
            self._seen("dead", lambda: bool(c.monitor._first_dead))
            self._seen("rebirth", lambda: c.server.generation >= 1)
            self._seen("register", lambda: any(
                r.get("generation") for r in c.server.reservations.get()))
            self._seen("spawn", lambda: (
                self._mgr.get("generation")._getvalue() or 0) >= 1)

    def stop(self):
        self._stop.set()
        self._thread.join()


def elastic_replay(config, device, keep, step, batches):
    """The reborn incarnation's trajectory in this process: the model
    restored from checkpoint ``step`` under ``keep`` and stepped through
    ``batches`` in order; returns the losses read on the host."""
    from tensorflowonspark_tpu_torch import checkpoint

    trainer, state = elastic_model(config, device, seeded=False)
    state = checkpoint.Checkpointer(keep).restore(state, step=step)
    losses = []
    for tokens in batches:
        state, metrics = trainer.step(state, {"tokens": tokens})
        losses.append(float(metrics["loss"]))
    del trainer, state
    return losses


def phase_elastic_flagship(config=FLAGSHIP, chips=1, device=None):
    """Elastic supervision: see the module docstring, phase 22.  The
    defaults are the phase; ``chips=None, device="cpu"`` with a small
    ``config`` rehearses it on the CPU (where no kernel launches)."""
    import importlib
    import tempfile

    from tensorflowonspark_tpu_torch.cluster import cluster, manager
    from tensorflowonspark_tpu_torch.engine import LocalEngine
    from tensorflowonspark_tpu_torch.testing import chaos

    t_phase = time.perf_counter()
    on_card = device is None
    if on_card:
        gc_collect()
    smoke = importlib.import_module("chip_smoke")
    chosen, chosen_uuid = gpu_choice() if chips else (None, None)
    rng = np.random.default_rng(7)  # flagship_trainer's tokens, as rows
    tokens = rng.integers(0, config["vocab_size"],
                          (TRAIN_K, TRAIN_B, config["max_seq_len"])
                          ).astype(np.int32)
    by_fp = {token_fp(t): t for t in tokens}
    batch_of = {token_fp(t): i for i, t in enumerate(tokens)}
    parts = [[{"tokens": r} for r in t] for t in tokens]
    tmp = tempfile.mkdtemp(prefix="elastic_flagship_")
    requeues = RequeueLog()
    driver_log = logging.getLogger(cluster.__name__)
    try:
        free_before = shutil.disk_usage(tmp).free
        log_dir, keep = os.path.join(tmp, "log"), os.path.join(tmp, "keep")
        os.makedirs(log_dir)
        os.makedirs(keep)
        args = {"log": log_dir, "keep": keep, "ckpt": os.path.join(tmp, "ckpt"),
                "batch": TRAIN_B, "config": config, "device": device}
        plan = chaos.ChaosPlan().kill_worker(0, at_step=ELASTIC_KILL_STEP)
        engine = LocalEngine(1, env=dict(plan.env(plan.save(
            os.path.join(tmp, "plan.json"))),
            TFOS_TELEMETRY_PUBLISH_INTERVAL="0.5"))
        driver_log.addHandler(requeues)
        try:
            t0 = time.perf_counter()
            c = cluster.run(engine, smoke.elastic_flagship_fn, args,
                            num_executors=1, num_chips_per_node=chips,
                            elastic=True, max_restarts=1,
                            heartbeat_interval=0.5, reservation_timeout=120)
            watch = RecoveryWatch(c).start()
            c.train(parts, num_epochs=ELASTIC_EPOCHS, feed_timeout=600)
            t_incident = time.perf_counter()
            incident = elastic_incident(c)
            incident["read_sec"] = time.perf_counter() - t_incident
            c.shutdown(timeout=600)
            watch.stop()
            run_sec = time.perf_counter() - t0
            node = c.cluster_info[0]
            m = manager.connect(tuple(node["addr"]),
                                bytes.fromhex(node["authkey"]))
            ledger = m.ledger("snapshot")._getvalue()
            restarts = m.get("restarts")._getvalue()
            generation = c.server.generation
        finally:
            driver_log.removeHandler(requeues)
            engine.stop()
        gens = [read_log(os.path.join(log_dir, "gen%d.jsonl" % g))
                for g in range(generation + 1)]
        steps = [[r for r in g if r["event"] == "step"] for g in gens]
        restored = [r["step"] for r in gens[-1] if r["event"] == "restored"]
        if on_card:
            gc_collect()
        t1 = time.perf_counter()
        replayed = (elastic_replay(config, device, keep, restored[0],
                                   [by_fp[r["fp"]] for r in steps[1]])
                    if len(gens) == 2 and len(restored) == 1 else None)
        replay_sec = time.perf_counter() - t1
        if on_card:
            gc_collect()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gen0, gen1 = gens[0], gens[-1]
    first = {name: next((r for r in g if r["event"] == name), None)
             for g, name in ((gen1, "start"), (gen1, "model"),
                             (gen1, "restored"))}
    kill = [r for r in gen0 if r["event"] == "group"][-1]
    first_step = steps[-1][0] if steps[-1] else None
    incident_problems = check_incident(incident, kill["t"])
    marks = dict(watch.marks, kill=kill["t"], start=first["start"]["t"],
                 model=first["model"]["t"], restored=first["restored"]["t"],
                 first_step=first_step["t"])
    if requeues.rounds:
        marks["requeue"] = requeues.rounds[0][0]
    # the node's chain is sequential; the monitor's sight of the death
    # and the driver's requeue run beside it
    chain = ("kill", "rebirth", "register", "spawn", "start", "model",
             "restored", "first_step")
    recovery = {"{0}_to_{1}".format(a, b): marks[b] - marks[a]
                for a, b in zip(chain, chain[1:])}
    recovery_at = {k: marks[k] - marks["kill"] for k in sorted(
        marks, key=marks.get)}
    # check 4: the surviving trajectory (the dead incarnation's steps up
    # to the restored checkpoint, then the reborn's) trains every batch
    # of every epoch; its repeats are of requeued partitions, which were
    # uncommitted at the kill, and cover what the dead one trained past
    # the checkpoint
    from collections import Counter

    step0 = restored[0] if restored else 0
    effective = Counter(r["fp"] for r in steps[0][:step0] + steps[-1])
    want = Counter({fp: ELASTIC_EPOCHS for fp in by_fp})
    requeued = Counter(token_fp(tokens[int(pid.split("p")[1])])
                       for _, pids in requeues.rounds for pid in pids)
    lost = Counter(r["fp"] for r in steps[0][step0:])
    pids = {"e{0}p{1}".format(e, i) for e in range(ELASTIC_EPOCHS)
            for i in range(TRAIN_K)}
    layers = config["num_layers"]
    saves = [r for g in gens for r in g if r["event"] == "saved"]
    line = dict(
        model=dict(config), steps_per_incarnation=[len(s) for s in steps],
        kill_step=ELASTIC_KILL_STEP, checkpoint_every=ELASTIC_CKPT_EVERY,
        generation=generation, restarts=restarts, restored_step=restored,
        batches_trained=[[batch_of[r["fp"]] for r in s] for s in steps],
        requeued=[pids for _, pids in requeues.rounds],
        ledger_pending=sorted(p for p, st in ledger.items()
                              if st != "committed"),
        ledger_committed=len([p for p, st in ledger.items()
                              if st == "committed"]),
        reborn_losses=[r["loss"] for r in steps[-1]],
        replay_losses=replayed,
        losses_equal_to_the_bit=replayed == [r["loss"] for r in steps[-1]],
        launches=[s[-1]["launches"] if s else None for s in steps],
        end_launches=[r for r in gen1 if r["event"] == "end"][-1]["launches"]
        if any(r["event"] == "end" for r in gen1) else None,
        cuda_visible_devices=[g[0]["cuda_visible_devices"] for g in gens],
        compute_uuid=[next(r["uuid"] for r in g if r["event"] == "model")
                      for g in gens],
        chosen_gpus=chosen, chosen_uuid=chosen_uuid,
        recovery_sec=recovery, recovery_at_sec=recovery_at,
        incident_timeline=incident["timeline"],
        incident=dict((k, v) for k, v in incident.items()
                      if k not in ("timeline", "events")),
        save_sec=[r["sec"] for r in saves],
        saved_steps=[r["step"] for r in saves], run_sec=run_sec,
        replay_sec=replay_sec, free_bytes_before=free_before,
        phase_sec=time.perf_counter() - t_phase,
        nvidia_smi=nvidia_smi() if on_card else None,
    )
    emit("elastic_flagship", **line)
    if incident_problems:
        raise AssertionError("the incident in the fleet journal: " +
                             "; ".join(incident_problems))
    if generation != 1 or restarts != 1 or not any(
            r["event"] == "end" for r in gen1):
        raise AssertionError("generation {0} after {1} restarts; the reborn "
                             "process did not finish".format(generation,
                                                             restarts))
    if restored != [ELASTIC_CKPT_EVERY] or [r["step"] for r in steps[0]] \
            != list(range(1, ELASTIC_KILL_STEP + 1)):
        raise AssertionError("restored {0}; the dead incarnation took steps "
                             "{1}".format(restored,
                                          [r["step"] for r in steps[0]]))
    if line["ledger_pending"] or set(ledger) != pids:
        raise AssertionError("ledger {0}".format(ledger))
    if want - effective or (effective - want) - requeued \
            or lost - requeued or not requeues.rounds:
        raise AssertionError("batches trained {0}, requeued {1}".format(
            line["batches_trained"], line["requeued"]))
    if not line["losses_equal_to_the_bit"]:
        raise AssertionError("the reborn losses differ from the replay's")
    if chips and (line["cuda_visible_devices"] != [",".join(
            map(str, chosen))] * 2 or line["compute_uuid"]
            != [chosen_uuid] * 2):
        raise AssertionError("incarnations ran on {0} (visible {1}), "
                             "gpu_info chose {2}".format(
                                 line["compute_uuid"],
                                 line["cuda_visible_devices"], chosen))
    want_launches = [{n: layers * len(s) for n in ("fwd", "dq", "dkv")}
                     for s in steps]
    if line["launches"] != want_launches \
            or line["end_launches"] != want_launches[-1]:
        raise AssertionError("flash launches {0}, want {1}".format(
            line["launches"], want_launches))
    return line


#: The journal kinds of an elastic incident, as the driver reads them
INCIDENT_KINDS = ("incarnation", "restart", "executor_dead",
                  "executor_restart")


def elastic_incident(c, timeout=30.0):
    """The incident as the driver's fleet telemetry holds it after the
    rebirth: ``cluster.metrics()``'s ``restart_events`` and generation,
    and ``cluster.journal()``'s incident events (:data:`INCIDENT_KINDS`)
    with each one's time on the driver's clock (its ``ts`` plus its
    executor's ``ClockSync`` offset; the driver's own events, stored
    under executor -1, need none).  Polls until both incarnations'
    events arrived; a failed RPC raises."""
    deadline = time.monotonic() + timeout
    while True:
        view = c.metrics(include_ledger=False)
        journal = c.journal()
        events = journal["events"]
        kinds = [e["kind"] for e in events]
        if kinds.count("incarnation") >= 2 and all(
                k in kinds for k in INCIDENT_KINDS):
            break
        if time.monotonic() > deadline:
            raise AssertionError("the fleet journal holds {0} after the "
                                 "rebirth".format(sorted(set(kinds))))
        time.sleep(0.25)
    offsets = {int(k): v["offset"] for k, v in journal["clocks"].items()}
    timeline = []
    for e in events:
        if e["kind"] not in INCIDENT_KINDS:
            continue
        eid = e.get("executor")
        timeline.append(dict(
            kind=e["kind"], executor=eid, pid=e["pid"],
            driver_ts=e["ts"] + offsets.get(eid, 0.0),
            offset=offsets.get(eid, 0.0), attrs=e.get("attrs", {})))
    timeline.sort(key=lambda r: r["driver_ts"])
    keys = [(e.get("executor"), e["pid"], e["seq"]) for e in events]
    return dict(restart_events=view["restart_events"],
                generation=view["generation"],
                server_generation=c.server.generation,
                timeline=timeline, clocks=journal["clocks"],
                events=len(events), unique_events=len(set(keys)),
                driver_pid=os.getpid())


def check_incident(got, kill_t):
    """What the fleet journal must show of the elastic phase's kill, on
    the driver's clock: the killed incarnation's event, then the node's
    ``restart``, then the driver's ``executor_restart``, then the reborn
    incarnation's, with a driver's ``executor_dead`` between the kill and
    the reborn incarnation; one restart event and generation 1; a new pid
    for the reborn process; nothing stored twice.  (Which of ``executor_dead``
    and ``restart`` comes first is a race: the node's supervisor and the
    driver's monitor see the death independently.)  Returns the
    problems; rewrites each timeline entry's time as seconds after the
    kill."""
    problems = []
    if not got["restart_events"] == 1 == got["generation"] \
            == got["server_generation"]:
        problems.append("restart_events {0}, generation {1}".format(
            got["restart_events"], got["generation"]))
    by = {}
    for r in got["timeline"]:
        by.setdefault(r["kind"], []).append(r)
    inc = sorted(by.get("incarnation", []),
                 key=lambda r: r["attrs"].get("generation"))
    driver = got["driver_pid"]
    one = {k: by.get(k, []) for k in ("restart", "executor_dead",
                                       "executor_restart")}
    if [r["attrs"].get("generation") for r in inc] != [0, 1] \
            or inc[0]["pid"] == inc[1]["pid"]:
        problems.append("incarnations {0}".format(
            [(r["attrs"], r["pid"]) for r in inc]))
    elif len(one["restart"]) != 1 or len(one["executor_restart"]) != 1 \
            or not one["executor_dead"]:
        # the monitor may see the death twice: the REBIRTH frame primes
        # the registry as alive while the node still parks
        problems.append("incident events {0}".format(
            {k: len(v) for k, v in one.items()}))
    else:
        # a death sighting before the kill is a missed beat on a busy
        # host (a window that closed again): the kill's is the first after
        restart, reborn_seen = one["restart"][0], one["executor_restart"][0]
        dead = next((r for r in one["executor_dead"]
                     if r["driver_ts"] >= kill_t), one["executor_dead"][-1])
        if restart["executor"] != 0 or restart["pid"] in (
                driver, inc[0]["pid"], inc[1]["pid"]):
            problems.append("restart from {0}".format(restart))
        for r in (dead, reborn_seen):
            if r["pid"] != driver or r["executor"] != -1 \
                    or r["attrs"].get("executor_id") != 0:
                problems.append("driver event {0}".format(r))
        t = {k: r["driver_ts"] for k, r in (
            ("born", inc[0]), ("restart", restart), ("dead", dead),
            ("restart_seen", reborn_seen), ("reborn", inc[1]))}
        if not (t["born"] < kill_t <= t["restart"] < t["restart_seen"]
                < t["reborn"] and kill_t <= t["dead"] < t["reborn"]):
            problems.append("out of order on the driver clock: {0} "
                            "(kill {1})".format(t, kill_t))
    if got["unique_events"] != got["events"]:
        problems.append("{0} of {1} events stored twice".format(
            got["events"] - got["unique_events"], got["events"]))
    for r in got["timeline"]:
        r["after_kill_sec"] = r.pop("driver_ts") - kill_t
    return problems


def elastic_dp_fn(args, ctx):
    """The user fn of :func:`phase_elastic_dp`: a linear model trained
    from the node's feed under ``torch.distributed`` (NCCL, joined anew in
    every generation) with averaged gradients, a ``Checkpointer`` and the
    chaos plan's kill hook.  Logs to ``<log>/gen<g>.rank<r>.jsonl``:
    ``start`` (rank, backend, card) and, at the end, the step count and
    the digest of the weights."""
    from tensorflowonspark_tpu_torch import checkpoint, compat, optim
    from tensorflowonspark_tpu_torch.parallel import dp
    from tensorflowonspark_tpu_torch.testing import chaos

    dist = ctx.initialize_distributed()
    device = compat.resolve_device()
    log = StepLog(os.path.join(args["log"], "gen{0}.rank{1}.jsonl".format(
        ctx.generation, dist.get_rank())))
    log("start", rank=dist.get_rank(), world=dist.get_world_size(),
        backend=dist.get_backend(), pid=os.getpid(),
        cuda_visible_devices=os.environ.get("CUDA_VISIBLE_DEVICES"),
        uuid=card_uuid(device))
    torch.manual_seed(0)
    model = torch.nn.Linear(4, 1).to(device)

    def loss_fn(params, batch, rng):
        x, y = batch
        return torch.mean((x @ params["weight"].T + params["bias"] - y) ** 2)

    trainer = dp.SyncTrainer(loss_fn, optim.sgd(0.1))
    state = trainer.create_state(dict(model.named_parameters()))
    ckptr = checkpoint.Checkpointer(args["ckpt"], max_to_keep=2)
    state = trainer.train_on_feed(
        state, ctx.get_data_feed(), batch_size=4, columnar=True,
        checkpointer=ckptr, checkpoint_every=ELASTIC_CKPT_EVERY,
        step_callback=chaos.step_fault_fn(ctx))
    ckptr.close()
    log("end", steps=int(state.step), weights=params_digest(
        model.parameters()))
    dist.destroy_process_group()


def phase_elastic_dp(n=4):
    """Not run by :func:`main` (``n`` cards): ``n`` executors with a card
    each under ``elastic=True, max_restarts=1``, :func:`elastic_dp_fn`
    fed four batches per rank and epoch for three epochs, rank 1 killed
    before step 7.  Every rank must reach the same generation (1) within
    its restart budget, the ranks' weights must be equal at the end,
    every partition must be committed, and each rank must hold the card
    that ``gpu_info`` gave its executor in both generations.  Prints each
    node's restarts: a survivor with one spent it on its own death (its
    compute process failed before it parked)."""
    import importlib
    import tempfile

    from tensorflowonspark_tpu_torch.cluster import cluster, gpu_info, manager
    from tensorflowonspark_tpu_torch.engine import LocalEngine
    from tensorflowonspark_tpu_torch.testing import chaos

    smoke = importlib.import_module("chip_smoke")
    pool = {_bare_uuid(g["uuid"]): str(g["id"])
            for g in gpu_info.allocatable_gpus()}
    gen = np.random.default_rng(0)
    parts = [[(gen.standard_normal(4).astype(np.float32),
               gen.standard_normal(1).astype(np.float32))
              for _ in range(4)] for _ in range(4 * n)]
    tmp = tempfile.mkdtemp(prefix="elastic_dp_")
    requeues = RequeueLog()
    driver_log = logging.getLogger(cluster.__name__)
    try:
        log_dir = os.path.join(tmp, "log")
        os.makedirs(log_dir)
        plan = chaos.ChaosPlan().kill_worker(1, at_step=ELASTIC_KILL_STEP)
        engine = LocalEngine(n, env=plan.env(plan.save(
            os.path.join(tmp, "plan.json"))), deterministic=True)
        driver_log.addHandler(requeues)
        try:
            t0 = time.perf_counter()
            c = cluster.run(engine, smoke.elastic_dp_fn,
                            {"log": log_dir, "ckpt": os.path.join(tmp, "c")},
                            num_executors=n, num_chips_per_node=1,
                            elastic=True, max_restarts=1,
                            heartbeat_interval=0.5, reservation_timeout=120)
            c.train(parts, num_epochs=ELASTIC_EPOCHS, feed_timeout=300)
            c.shutdown(timeout=300)
            wall = time.perf_counter() - t0
            nodes = sorted(c.cluster_info, key=lambda x: x["executor_id"])
            mgrs = [manager.connect(tuple(x["addr"]),
                                    bytes.fromhex(x["authkey"]))
                    for x in nodes]
            ledgers = [m.ledger("snapshot")._getvalue() for m in mgrs]
            restarts = [m.get("restarts")._getvalue() for m in mgrs]
            generation = c.server.generation
        finally:
            driver_log.removeHandler(requeues)
            engine.stop()
        logs = {(g, r): read_log(os.path.join(
            log_dir, "gen{0}.rank{1}.jsonl".format(g, r)))
            for g in range(generation + 1) for r in range(n)}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    ends = [[e for e in logs[(generation, r)] if e["event"] == "end"]
            for r in range(n)]
    starts = {k: v[0] for k, v in logs.items() if v}
    committed = set()
    for ledger in ledgers:
        committed |= {p for p, st in ledger.items() if st == "committed"}
    pids = {"e{0}p{1}".format(e, i) for e in range(ELASTIC_EPOCHS)
            for i in range(4 * n)}
    line = dict(
        executors=n, wall_sec=wall, generation=generation,
        restarts=restarts, requeued=[p for _, p in requeues.rounds],
        steps=[e[-1]["steps"] if e else None for e in ends],
        weights=[e[-1]["weights"] if e else None for e in ends],
        committed=len(committed & pids), partitions=len(pids),
        cards={"gen{0}.rank{1}".format(*k): [v["cuda_visible_devices"],
                                             v["uuid"], v["backend"]]
               for k, v in sorted(starts.items())},
        pool=pool, nvidia_smi=nvidia_smi(),
    )
    emit("elastic_dp", **line)
    if generation != 1 or any(not e for e in ends):
        raise AssertionError("generation {0}; ranks that did not finish at "
                             "it: {1}".format(generation, [
                                 r for r in range(n) if not ends[r]]))
    if any(r is None or r > 1 for r in restarts) or restarts[1] != 1:
        raise AssertionError("restarts {0} (budget 1)".format(restarts))
    if len(set(line["weights"])) != 1 or len(set(line["steps"])) != 1:
        raise AssertionError("the ranks' weights or steps differ at the end")
    if committed != pids:
        raise AssertionError("uncommitted partitions: {0}".format(
            sorted(pids - committed)))
    for g in range(generation + 1):
        cards = [starts.get((g, r)) for r in range(n)]
        if any(s is None for s in cards) or len({s["uuid"] for s in cards}) \
                != n or any(pool.get(s["uuid"]) != s["cuda_visible_devices"]
                            for s in cards):
            raise AssertionError("generation {0}: the ranks do not hold one "
                                 "distinct card each, the one gpu_info "
                                 "chose".format(g))
    return line


def global_stop_fn(args, ctx):
    """The user fn of :func:`phase_feed_global_stop`: a linear model
    trained from the node's feed under ``torch.distributed``, then one
    all-reduce over the default group; writes ``rank<r>.json``."""
    from tensorflowonspark_tpu_torch import compat, optim
    from tensorflowonspark_tpu_torch.parallel import dp

    dist = ctx.initialize_distributed()
    device = compat.resolve_device()
    model = torch.nn.Linear(4, 1).to(device)

    def loss_fn(params, batch, rng):
        x, y = batch
        return torch.mean((x @ params["weight"].T + params["bias"] - y) ** 2)

    trainer = dp.SyncTrainer(loss_fn, optim.sgd(0.1))
    state = trainer.create_state(dict(model.named_parameters()))
    state = trainer.train_on_feed(state, ctx.get_data_feed(), batch_size=4,
                                  columnar=True)
    rank = torch.full((1,), float(dist.get_rank() + 1), device=device)
    dist.all_reduce(rank)
    out = dict(rank=dist.get_rank(), world=dist.get_world_size(),
               backend=dist.get_backend(), steps=int(state.step),
               all_reduce=rank.item(),
               weights=params_digest(model.parameters()),
               cuda_visible_devices=os.environ.get("CUDA_VISIBLE_DEVICES"),
               uuid=card_uuid(device))
    dist.destroy_process_group()
    with open(os.path.join(args["out"], "rank%d.json" % out["rank"]),
              "w") as f:
        json.dump(out, f)


def phase_feed_global_stop(n=4):
    """Not run by :func:`main`: ``n`` executors, one GPU each by
    host-local rank, ``initialize_distributed`` (NCCL with a ``gloo``
    flag group), executor ``i`` fed ``3 + i`` batches; every rank must
    stop after 3 steps (the global stop), the all-reduce must sum the
    ranks, the ranks' weights must be equal after the last step (each
    step averages the gradients over the ranks), and each rank must hold
    the card that ``gpu_info`` gave its executor."""
    import importlib
    import tempfile

    from tensorflowonspark_tpu_torch.cluster import cluster, gpu_info
    from tensorflowonspark_tpu_torch.engine import LocalEngine

    smoke = importlib.import_module("chip_smoke")
    pool = {_bare_uuid(g["uuid"]): str(g["id"])
            for g in gpu_info.allocatable_gpus()}
    gen = np.random.default_rng(0)
    parts = [[(gen.standard_normal(4).astype(np.float32),
               gen.standard_normal(1).astype(np.float32))
              for _ in range(4 * (3 + i))] for i in range(n)]
    out = tempfile.mkdtemp(prefix="global_stop_")
    engine = LocalEngine(n, deterministic=True)
    try:
        t0 = time.perf_counter()
        c = cluster.run(engine, smoke.global_stop_fn, {"out": out},
                        num_executors=n, num_chips_per_node=1,
                        reservation_timeout=120)
        c.train(parts, feed_timeout=300)
        c.shutdown(timeout=300)
        wall = time.perf_counter() - t0
    finally:
        engine.stop()
    ranks = []
    for r in range(n):
        with open(os.path.join(out, "rank%d.json" % r)) as f:
            ranks.append(json.load(f))
    emit("feed_global_stop", executors=n, wall_sec=wall, ranks=ranks)
    if [r["steps"] for r in ranks] != [3] * n:
        raise AssertionError("ranks stopped at different steps")
    if {r["all_reduce"] for r in ranks} != {n * (n + 1) / 2.0}:
        raise AssertionError("the all-reduce did not sum the ranks")
    if len({r["weights"] for r in ranks}) != 1:
        raise AssertionError("the ranks' weights differ after training")
    if len({r["uuid"] for r in ranks}) != n or any(
            pool.get(r["uuid"]) != r["cuda_visible_devices"] for r in ranks):
        raise AssertionError("the ranks do not hold one distinct card "
                             "each, the one gpu_info chose: {0}".format(pool))
    return ranks


def params_digest(params):
    """sha256 of the parameters' bytes, in order: equal on two ranks only
    when every weight is bit for bit equal."""
    import hashlib

    h = hashlib.sha256()
    for p in params:
        h.update(p.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


#: sequence-parallel training of the flagship (not run by :func:`main`;
#: four cards): name, mesh axes, config fields beyond :data:`FLAGSHIP`,
#: global batch rows.  The ring configs are the flagship with two kv
#: heads (Hkv=2, GQA); Ulysses needs the head counts to divide by the seq
#: width, so it runs the flagship's own MHA.
SP_TRAIN_CONFIGS = [
    ("ring_seq4_window512_gqa", {"seq": 4},
     dict(attention_impl="ring", num_kv_heads=2, attention_window=512), 2),
    ("ring_seq4_gqa", {"seq": 4},
     dict(attention_impl="ring", num_kv_heads=2), 2),
    ("ulysses_seq4_mha", {"seq": 4}, dict(attention_impl="ulysses"), 2),
    ("ring_data2_seq2_window512_gqa", {"data": 2, "seq": 2},
     dict(attention_impl="ring", num_kv_heads=2, attention_window=512), 4),
]
SP_TRAIN_S, SP_TRAIN_STEPS = 8192, 4  # the first step is the warm-up
#: sequence-parallel losses against one card's full-sequence run of the
#: same model, weights and tokens (K2-K4 at q_offset 0), relative: about
#: 4x the largest of the sound runs (2.6e-5 on four H100s; the two runs
#: round attention and its gradients at other points)
SP_LOSS_RTOL = 1e-4
#: the global L2 norm of each step's reduced gradients against the
#: one-card run's, relative: about 3x the largest of the sound runs
#: (8.8e-4 on four H100s).  AdamW's update hardly depends on the
#: gradients' scale, so the losses alone would pass gradients averaged
#: over ``seq`` where they must be summed (off by 0.75 at seq=4); this
#: check does not
SP_GRAD_RTOL = 3e-3


def sp_tokens(index, rows, vocab, s, steps):
    """The ``[steps, rows, S]`` int32 tokens of config ``index``."""
    rng = np.random.default_rng(20 + index)
    return rng.integers(0, vocab, (steps, rows, s)).astype(np.int32)


class GradNormProbe(object):
    """An optimizer that hands every update on to ``opt`` and keeps the
    global L2 norm of the gradients it is given, one device scalar per
    step (:meth:`read` brings them to the host)."""

    def __init__(self, opt):
        self.opt, self.norms = opt, []

    def init(self, params):
        return self.opt.init(params)

    def update(self, opt_state, params, grads):
        self.norms.append(torch.linalg.vector_norm(torch.stack(
            torch._foreach_norm([g.float() for g in grads]))))
        return self.opt.update(opt_state, params, grads)

    def read(self):
        return [float(x) for x in self.norms]


def sp_train_configs(args, device):
    """This rank's part of each of ``args["configs"]``: the model
    (``args["model"]`` fields) from seed-0 weights, trained with
    ``SyncTrainer(loss_fn(model), adamw(1e-4), mesh=build_mesh(axes),
    data_axes=("data",))`` for ``args["steps"]`` steps on its rows (the
    data coordinate's) of the config's tokens, the reduced gradients'
    norm kept per step (:class:`GradNormProbe`); then the gradient
    all-reduce alone, timed over a flat f32 buffer of every parameter.
    Returns one result dict per config."""
    import gc

    import torch.distributed as dist

    from tensorflowonspark_tpu_torch import convert, optim
    from tensorflowonspark_tpu_torch.models import transformer
    from tensorflowonspark_tpu_torch.ops.flash_attention import (
        flash_attention,
    )
    from tensorflowonspark_tpu_torch.parallel import dp
    from tensorflowonspark_tpu_torch.parallel.mesh import build_mesh

    s, steps = args["s"], args["steps"]
    base = dict(args["model"], max_seq_len=s)
    trees, results = {}, []
    for index, (name, axes, extra, rows) in enumerate(args["configs"]):
        mesh = build_mesh(axes)
        hkv = extra.get("num_kv_heads", 0)
        if hkv not in trees:
            trees[hkv] = convert.init_params_tree(
                transformer.TransformerConfig(**dict(base, num_kv_heads=hkv)),
                seed=0)
        cfg = transformer.TransformerConfig(**dict(base, mesh=mesh, **extra))
        model = convert.params_from_flax(trees[hkv], cfg, device=device,
                                         param_dtype=torch.float32)
        probe = GradNormProbe(optim.adamw(1e-4))
        trainer = dp.SyncTrainer(transformer.loss_fn(model), probe,
                                 mesh=mesh, data_axes=("data",))
        state = trainer.create_state(dict(model.named_parameters()))
        part = rows // mesh.axis_size("data")
        lo = mesh.axis_index("data") * part
        tokens = torch.from_numpy(sp_tokens(index, rows, cfg.vocab_size, s,
                                            steps)[:, lo:lo + part]).to(device)
        flash_attention.launches = {"fwd": 0, "dq": 0, "dkv": 0}
        torch.cuda.reset_peak_memory_stats(device)
        losses, walls = [], []
        for i in range(steps):
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            state, metrics = trainer.step_on_device(state,
                                                    {"tokens": tokens[i]})
            torch.cuda.synchronize(device)
            walls.append(time.perf_counter() - t0)
            losses.append(metrics["loss"])
        launches = dict(flash_attention.launches)
        n_params = sum(p.numel() for p in model.parameters())
        buf = torch.ones(n_params, dtype=torch.float32, device=device)
        dist.all_reduce(buf, group=mesh.world_group)  # warm-up
        reduce_ms = []
        for _ in range(5):
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            dist.all_reduce(buf, group=mesh.world_group)
            torch.cuda.synchronize(device)
            reduce_ms.append(1e3 * (time.perf_counter() - t0))
        results.append(dict(
            name=name, mesh=dict(mesh.shape), coords=mesh.coords,
            losses=[float(x) for x in losses], grad_norms=probe.read(),
            step_sec=walls,
            launches=launches, weights=params_digest(model.parameters()),
            tokens_per_sec_per_card=(rows * s * (steps - 1) / sum(walls[1:])
                                     / mesh.size),
            allreduce_ms=reduce_ms, allreduce_bytes=4 * n_params,
            peak_memory_bytes=torch.cuda.max_memory_allocated(device)))
        del model, trainer, probe, state, tokens, buf
        gc.collect()
        torch.cuda.empty_cache()
    return results


def sp_train_fn(args, ctx):
    """The user fn of :func:`phase_sp_train_flagship`: joins the cluster's
    process group (NCCL), runs :func:`sp_train_configs` on this rank's
    card and writes ``rank<r>.json``."""
    from tensorflowonspark_tpu_torch import compat

    dist = ctx.initialize_distributed()
    device = compat.resolve_device()
    results = sp_train_configs(args, device)
    out = dict(rank=dist.get_rank(), world=dist.get_world_size(),
               backend=dist.get_backend(),
               cuda_visible_devices=os.environ.get("CUDA_VISIBLE_DEVICES"),
               uuid=card_uuid(device), results=results)
    dist.destroy_process_group()
    with open(os.path.join(args["out"], "rank%d.json" % out["rank"]),
              "w") as f:
        json.dump(out, f)


def sp_reference(args, device):
    """Each config's one-card run over the full sequence: the same model,
    weights and tokens with flash attention (K2-K4 at q_offset 0) and the
    default trainer.  Returns ``{name: (losses, gradient norms,
    tokens_per_sec)}``."""
    import gc

    from tensorflowonspark_tpu_torch import convert, optim
    from tensorflowonspark_tpu_torch.models import transformer
    from tensorflowonspark_tpu_torch.parallel import dp

    s, steps = args["s"], args["steps"]
    base = dict(args["model"], max_seq_len=s)
    trees, out = {}, {}
    for index, (name, _, extra, rows) in enumerate(args["configs"]):
        hkv = extra.get("num_kv_heads", 0)
        if hkv not in trees:
            trees[hkv] = convert.init_params_tree(
                transformer.TransformerConfig(**dict(base, num_kv_heads=hkv)),
                seed=0)
        cfg = transformer.TransformerConfig(**dict(
            base, num_kv_heads=hkv, attention_impl="flash",
            attention_window=extra.get("attention_window", 0)))
        model = convert.params_from_flax(trees[hkv], cfg, device=device,
                                         param_dtype=torch.float32)
        probe = GradNormProbe(optim.adamw(1e-4))
        trainer = dp.SyncTrainer(transformer.loss_fn(model), probe)
        state = trainer.create_state(dict(model.named_parameters()))
        tokens = torch.from_numpy(sp_tokens(index, rows, cfg.vocab_size, s,
                                            steps)).to(device)
        losses, walls = [], []
        for i in range(steps):
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            state, metrics = trainer.step_on_device(state,
                                                    {"tokens": tokens[i]})
            torch.cuda.synchronize(device)
            walls.append(time.perf_counter() - t0)
            losses.append(float(metrics["loss"]))
        out[name] = (losses, probe.read(),
                     rows * s * (steps - 1) / sum(walls[1:]))
        del model, trainer, probe, state, tokens
        gc.collect()
        torch.cuda.empty_cache()
    return out


def sp_check(ranks, reference):
    """The checks of :func:`phase_sp_train_flagship` on the ranks' results
    and the one-card reference; returns the summary it emits."""
    summary = {}
    for i, (name, axes, extra, rows) in enumerate(SP_TRAIN_CONFIGS):
        res = [r["results"][i] for r in ranks]
        want, want_norms, ref_tps = reference[name]
        got, norms = res[0]["losses"], res[0]["grad_norms"]
        rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
        grad_rel = max(abs(a - b) / abs(b) for a, b in zip(norms, want_norms))
        summary[name] = dict(
            losses=got, one_card_losses=want, max_rel_diff=rel,
            grad_norms=norms, one_card_grad_norms=want_norms,
            grad_norm_max_rel_diff=grad_rel,
            tokens_per_sec_per_card=[r["tokens_per_sec_per_card"]
                                     for r in res],
            one_card_tokens_per_sec=ref_tps,
            allreduce_ms=[min(r["allreduce_ms"]) for r in res],
            allreduce_bytes=res[0]["allreduce_bytes"],
            launches=[r["launches"] for r in res],
            peak_memory_bytes=[r["peak_memory_bytes"] for r in res])
        if any(r["losses"] != got for r in res):
            raise AssertionError("{0}: the ranks' losses differ: {1}".format(
                name, [r["losses"] for r in res]))
        if len({r["weights"] for r in res}) != 1:
            raise AssertionError("{0}: the ranks' weights differ".format(
                name))
        if not rel <= SP_LOSS_RTOL:
            raise AssertionError("{0}: losses {1} against one card's {2}: "
                                 "{3} > {4}".format(name, got, want, rel,
                                                    SP_LOSS_RTOL))
        if not grad_rel <= SP_GRAD_RTOL:
            raise AssertionError(
                "{0}: gradient norms {1} against one card's {2}: {3} > "
                "{4}".format(name, norms, want_norms, grad_rel,
                             SP_GRAD_RTOL))
        if not all(r["launches"]["fwd"] > 0 and len(set(
                r["launches"].values())) == 1 for r in res):
            raise AssertionError("{0}: K2-K4 launches {1}".format(
                name, [r["launches"] for r in res]))
    return summary


def phase_sp_train_flagship(n=4):
    """Not run by :func:`main`: sequence-parallel training of the
    flagship (L16 H8 Dh128 Dm1024 V32000, bf16 over f32 masters, AdamW)
    over ``n`` cards through ``cluster.run(LocalEngine(n), sp_train_fn)``
    -> ``ctx.initialize_distributed()`` -> ``build_mesh`` ->
    ``SyncTrainer(mesh=)``, for each of :data:`SP_TRAIN_CONFIGS` at
    S=8192.  Per config, every rank's losses must be identical, its
    weights equal to the others' after the last step, and the losses and
    the reduced gradients' norms within :data:`SP_LOSS_RTOL` and
    :data:`SP_GRAD_RTOL` of one card's full-sequence run of the same
    model on the same tokens (run here afterwards, on card 0).
    Reports tokens/s per card beside the one-card run's, and the
    gradient all-reduce's time."""
    import importlib
    import tempfile

    from tensorflowonspark_tpu_torch.cluster import cluster
    from tensorflowonspark_tpu_torch.engine import LocalEngine

    smoke = importlib.import_module("chip_smoke")
    out = tempfile.mkdtemp(prefix="sp_train_")
    args = dict(out=out, model=FLAGSHIP, configs=SP_TRAIN_CONFIGS,
                s=SP_TRAIN_S, steps=SP_TRAIN_STEPS)
    engine = LocalEngine(n, deterministic=True)
    try:
        t0 = time.perf_counter()
        c = cluster.run(engine, smoke.sp_train_fn, args, num_executors=n,
                        num_chips_per_node=1, reservation_timeout=120)
        c.shutdown(grace_secs=1500, timeout=1800)
        wall = time.perf_counter() - t0
    finally:
        engine.stop()
    ranks = []
    for r in range(n):
        with open(os.path.join(out, "rank%d.json" % r)) as f:
            ranks.append(json.load(f))
    if len({r["uuid"] for r in ranks}) != n:
        raise AssertionError("the ranks do not hold one card each")
    t1 = time.perf_counter()
    reference = sp_reference(args, torch.device("cuda", 0))
    summary = sp_check(ranks, reference)
    emit("sp_train_flagship", cards=n, backend=ranks[0]["backend"],
         cluster_wall_sec=wall, reference_wall_sec=time.perf_counter() - t1,
         seq_len=SP_TRAIN_S, steps=SP_TRAIN_STEPS, loss_rtol=SP_LOSS_RTOL,
         grad_rtol=SP_GRAD_RTOL, configs=summary)
    return summary


# ----------------------------------------------------------------------
# the ML Pipeline API (phase 23)
# ----------------------------------------------------------------------

#: phase ``pipeline_flagship``: the port's builder named in its export,
#: the shards of the interchange files, and the input mapping of the
#: serving phases
PIPELINE_MODEL_REF = \
    "tensorflowonspark_tpu_torch.models.transformer:serving_builder"
PIPELINE_SHARDS = 4
PIPELINE_SCHEMA = "struct<tokens:array<int>>"
SERVE_MAPPING = {"tokens": "tokens"}


def pipeline_train_fn(args, ctx):
    """The ``TFEstimator`` train fn of ``pipeline_flagship``, run in the
    compute process: on the card ``gpu_info`` gives worker
    ``ctx.task_index``, :func:`train_from_feed` on the feed of
    sorted-column tuples (``args.input_mapping``), with the merged args'
    batch size; then worker 0 exports the trained weights with
    ``save_for_serving``: the port's ``model_ref``, the flagship's
    generation ``model_config`` and the output schema that
    ``serving.infer_output_schema`` derives from one request.  Writes
    ``args.out``."""
    from tensorflowonspark_tpu_torch import checkpoint, convert, serving
    from tensorflowonspark_tpu_torch.cluster import gpu_info
    from tensorflowonspark_tpu_torch.models import transformer

    gpu_info.set_visible_gpus(gpu_info.get_gpus(
        1, worker_index=ctx.task_index))
    feed = ctx.get_data_feed(input_mapping=args.input_mapping)
    result, model = train_from_feed(
        {"k": args.k, "batch": args.batch_size}, ctx, feed)
    if ctx.job_name == "worker" and ctx.task_index == 0:
        gc_collect()
        t0 = time.perf_counter()
        tree = convert.tree_from_model(model)
        del model
        gc_collect()
        config = dict(FLAGSHIP, **SERVING)
        predict = transformer.serving_builder(tree, config)
        t1 = time.perf_counter()
        schema = serving.infer_output_schema(
            predict, dict(args.sample), SERVE_MAPPING)
        t2 = time.perf_counter()
        del predict
        gc_collect()
        checkpoint.save_for_serving(
            args.export_dir, tree, output_schema=schema, extra_metadata={
                "model_ref": PIPELINE_MODEL_REF, "model_config": config})
        result.update(export_schema=schema, schema_sec=t2 - t1,
                      build_predictor_sec=t1 - t0,
                      export_sec=time.perf_counter() - t2)
    with open(args.out, "w") as f:
        json.dump(result, f)


def pipeline_executor_ready():
    """Run on the transform's executor before the transform: zeroes the
    K1 count there and times every ``serving.load_predictor`` call of
    that process.  Returns the executor's wall clock."""
    from tensorflowonspark_tpu_torch import serving
    from tensorflowonspark_tpu_torch.ops.paged_attention import (
        paged_attention,
    )

    paged_attention.launches = 0
    load = serving.load_predictor
    loads = PIPELINE_EXECUTOR["load_sec"]

    def timed_load(*a, **kw):
        t0 = time.perf_counter()
        out = load(*a, **kw)
        torch.cuda.synchronize()
        loads.append(time.perf_counter() - t0)
        return out

    serving.load_predictor = timed_load
    return time.time()


#: what the transform's executor process measured (see above)
PIPELINE_EXECUTOR = {"load_sec": []}


def pipeline_executor_counts():
    """Run on the transform's executor after it: K1's count, the predictor
    loads' seconds, the process and its card."""
    from tensorflowonspark_tpu_torch.ops.paged_attention import (
        paged_attention,
    )

    return dict(k1=paged_attention.launches,
                load_sec=list(PIPELINE_EXECUTOR["load_sec"]),
                pid=os.getpid(), uuid=card_uuid(torch.cuda.current_device()))


def run_on_executor(engine, fn):
    """``fn()`` (a function of this module) run once as a task of
    ``engine``; returns its result."""
    import functools
    import importlib

    smoke = importlib.import_module("chip_smoke")
    return engine.run_job(functools.partial(smoke._call_ignoring_rows, fn),
                          [[0]], collect=True)[0]


def _call_ignoring_rows(fn, rows):
    list(rows)
    return [fn()]


def phase_pipeline_flagship(fed):
    """The ML Pipeline API at the flagship's width: see the module
    docstring, phase 23.  ``fed`` is :func:`phase_feed_train_flagship`'s
    result."""
    import importlib
    import tempfile

    from tensorflowonspark_tpu_torch import serving
    from tensorflowonspark_tpu_torch.data import interchange
    from tensorflowonspark_tpu_torch.data.dataset import Dataset
    from tensorflowonspark_tpu_torch.engine import LocalEngine
    from tensorflowonspark_tpu_torch.pipeline import (
        TFEstimator,
        TFModel,
        _infer_output_type,
    )

    t_phase = time.perf_counter()
    gc_collect()
    smoke = importlib.import_module("chip_smoke")
    chosen, chosen_uuid = gpu_choice()
    tmp = tempfile.mkdtemp(prefix="pipeline_")
    try:
        # 1. interchange: feed_train_flagship's rows of its three epochs
        # as Example shards, written so that the shards, read in order,
        # give the rows in order
        rng = np.random.default_rng(7)  # flagship_trainer's tokens
        tokens = rng.integers(0, FLAGSHIP["vocab_size"],
                              (TRAIN_K, TRAIN_B, TRAIN_S)).astype(np.int32)
        rows = [{"tokens": t} for t in tokens.reshape(-1, TRAIN_S)] * 3
        per = len(rows) // PIPELINE_SHARDS
        written = [rows[s * per + k] for k in range(per)
                   for s in range(PIPELINE_SHARDS)]
        shards = os.path.join(tmp, "shards")
        t0 = time.perf_counter()
        n_written = interchange.save_as_tfrecords(
            written, shards, schema=PIPELINE_SCHEMA,
            num_shards=PIPELINE_SHARDS)
        t1 = time.perf_counter()
        loaded, schema = interchange.load_tfrecords(shards,
                                                    schema=PIPELINE_SCHEMA)
        t2 = time.perf_counter()
        rows_equal = (len(loaded) == len(rows) and all(
            np.array_equal(a["tokens"], b["tokens"])
            for a, b in zip(loaded, rows)))
        shard_bytes = tree_bytes(shards)
        del loaded

        # 2. fit through the pipeline on LocalEngine(1)
        export = os.path.join(tmp, "export")
        out = os.path.join(tmp, "fit.json")
        requests = make_requests(np.random.default_rng(2), REQUESTS,
                                 FLAGSHIP["vocab_size"], 16,
                                 SERVING["max_prompt_len"])
        est = (TFEstimator(smoke.pipeline_train_fn, {
            "out": out, "k": TRAIN_K, "sample": requests[0]})
            .setInputMapping(SERVE_MAPPING).setClusterSize(1).setEpochs(1)
            .setBatchSize(TRAIN_B).setExportDir(export).setGraceSecs(600)
            .setFeedTimeout(600).setReservationTimeout(120))
        t3 = time.perf_counter()
        model = est.fit(rows)
        fit_sec = time.perf_counter() - t3
        with open(out) as f:
            res = json.load(f)
        with open(os.path.join(export, "metadata.json")) as f:
            meta = json.load(f)

        # 3. transform the export on LocalEngine(1), continuous schedule
        if not isinstance(model, TFModel):
            raise AssertionError("fit returned {0!r}".format(model))
        t4 = time.time()
        engine = LocalEngine(1)
        try:
            ready = run_on_executor(engine, smoke.pipeline_executor_ready)
            model = (model.setInputMapping(SERVE_MAPPING)
                     .setSchedule("continuous").setBatchSize(SLOTS))
            model.engine = engine
            t5 = time.perf_counter()
            transformed = model.transform([dict(r) for r in requests])
            transform_sec = time.perf_counter() - t5
            executor = run_on_executor(engine, smoke.pipeline_executor_counts)
        finally:
            engine.stop()

        # the same export served in the driver
        t6 = time.perf_counter()
        predict = serving.load_predictor(export)
        driver_load_sec = time.perf_counter() - t6
        driven, stats, serve_wall, k1 = serve_rows(
            predict, [dict(r) for r in requests])
        del predict
        gc_collect()

        # 4. the command line, in a subprocess, on prompts from interchange
        cli_in, cli_out = (os.path.join(tmp, "cli-in"),
                           os.path.join(tmp, "cli-out"))
        interchange.save_as_tfrecords(requests, cli_in,
                                      schema=PIPELINE_SCHEMA)
        env = dict(os.environ, PYTHONPATH=os.path.dirname(
            os.path.abspath(smoke.__file__)))
        t7 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "tensorflowonspark_tpu_torch.serving",
             "--export_dir", export, "--input", cli_in,
             "--input_mapping", "tokens=tokens", "--output", cli_out,
             "--batch_size", str(SLOTS), "--schedule", "continuous"],
            env=env, capture_output=True, text=True, timeout=600)
        cli_sec = time.perf_counter() - t7
        if proc.returncode != 0:
            raise AssertionError("serving CLI exited {0}:\n{1}".format(
                proc.returncode, proc.stderr[-4000:]))
        with open(os.path.join(cli_out, "part-00000.jsonl")) as f:
            cli_tokens = [json.loads(line)["generated"] for line in f]

        # 5. Dataset from the shards into the flagship trainer, in the driver
        from tensorflowonspark_tpu_torch.ops.flash_attention import (
            flash_attention,
        )

        tree, _ = flagship_tree()
        _, _, trainer, state, _ = flagship_trainer(tree)
        del tree
        ds = Dataset.from_tfrecords(shards, {"tokens": ("int32", TRAIN_S)})
        flash_attention.launches = {"fwd": 0, "dq": 0, "dkv": 0}
        ds_losses, group = [], []
        torch.cuda.synchronize()
        t8 = time.perf_counter()
        for batch in ds.batch(TRAIN_B).prefetch(
                sharding=trainer.batch_sharding()):
            group.append(batch["tokens"])
            if len(group) == TRAIN_K:
                state, metrics = trainer.multi_step_on_device(
                    state, {"tokens": torch.stack(group)})
                ds_losses.append(metrics["loss"])
                group = []
        torch.cuda.synchronize()
        ds_sec = time.perf_counter() - t8
        ds_launches = dict(flash_attention.launches)
        ds_losses = torch.cat(ds_losses).float().cpu().numpy().tolist()
        ds_rows = ds.num_rows
        del trainer, state, ds
        gc_collect()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    want = np.asarray(fed["losses"])
    rel = max_rel_diff(np.asarray(res["losses"]), want)
    ds_rel = max_rel_diff(np.asarray(ds_losses), np.asarray(res["losses"]))
    steps = res["timed_steps"]
    tokens_per_sec = steps * TRAIN_B * TRAIN_S / res["wall_sec"]
    got_tokens = [np.asarray(r["generated"]).tolist() for r in transformed]
    driven_tokens = [np.asarray(r["generated"]).tolist() for r in driven]
    decode_steps = stats["chunks"] * SERVING["chunk_size"]
    out_schema = [tuple(f) for f in meta.get("output_schema") or []]
    transformed_schema = sorted({tuple(sorted(
        (k, _infer_output_type(v)) for k, v in r.items()))
        for r in transformed})
    line = dict(
        model=fed["model"], rows=len(rows), shards=PIPELINE_SHARDS,
        interchange_write_sec=t1 - t0, interchange_read_sec=t2 - t1,
        interchange_rows=n_written, interchange_bytes=shard_bytes,
        interchange_schema=interchange.format_schema(schema),
        rows_equal=rows_equal,
        fit_sec=fit_sec, fit_losses=res["losses"], max_rel_loss_diff=rel,
        fit_launches=res["launches"], fit_steps=len(res["losses"]),
        timed_steps=steps, tokens_per_sec=tokens_per_sec,
        feed_train_flagship_tokens_per_sec=fed["tokens_per_sec"],
        fed_over_feed_train=tokens_per_sec / fed["tokens_per_sec"],
        feed_wait_ms=[1e3 * w for w in res["feed_wait_sec"]],
        feed_wait_share=sum(res["feed_wait_sec"]) / res["wall_sec"],
        fit_startup_sec=res["startup_sec"],
        export_build_predictor_sec=res.get("build_predictor_sec"),
        export_schema_sec=res.get("schema_sec"),
        export_save_sec=res.get("export_sec"),
        export_schema=out_schema,
        compute_cuda_visible_devices=res["cuda_visible_devices"],
        compute_uuid=res["uuid"], chosen_gpus=chosen,
        chosen_uuid=chosen_uuid,
        transform_sec=transform_sec,
        transform_executor_start_sec=ready - t4,
        transform_load_predictor_sec=executor["load_sec"],
        transform_serving_sec=transform_sec - sum(executor["load_sec"]),
        transform_launches=executor["k1"], transform_uuid=executor["uuid"],
        transformed_schema=[list(s) for s in transformed_schema],
        driver_load_predictor_sec=driver_load_sec,
        driver_serve_wall_sec=serve_wall, driver_launches=k1,
        decode_steps=decode_steps, requests=len(transformed),
        tokens_equal_to_driver=got_tokens == driven_tokens,
        cli_sec=cli_sec, cli_tokens_equal=cli_tokens == got_tokens,
        dataset_rows=ds_rows, dataset_losses=ds_losses,
        dataset_max_rel_loss_diff=ds_rel, dataset_launches=ds_launches,
        dataset_train_sec=ds_sec,
        first_tokens=[t[:4] for t in got_tokens[:4]],
        phase_sec=time.perf_counter() - t_phase, nvidia_smi=nvidia_smi(),
    )
    emit("pipeline_flagship", **line)
    if not rows_equal or n_written != len(rows):
        raise AssertionError("interchange rows differ after a round trip")
    if not rel <= FEED_LOSS_RTOL:
        raise AssertionError("pipeline losses differ from feed_train_"
                             "flagship's by {0} relative".format(rel))
    want_launches = FLAGSHIP["num_layers"] * len(want)
    if res["launches"] != {n: want_launches for n in ("fwd", "dq", "dkv")}:
        raise AssertionError("fit flash launches {0}, want {1} each".format(
            res["launches"], want_launches))
    if (res["cuda_visible_devices"] != ",".join(map(str, chosen))
            or res["uuid"] != chosen_uuid):
        raise AssertionError("fit ran on {0} (visible {1}), gpu_info chose "
                             "{2} ({3})".format(res["uuid"],
                                                res["cuda_visible_devices"],
                                                chosen, chosen_uuid))
    if out_schema != [("generated", "array<int>")] \
            or res.get("export_schema") is None:
        raise AssertionError("export output_schema {0}".format(out_schema))
    if transformed_schema != [tuple(out_schema)]:
        raise AssertionError("transform output columns {0}, export schema "
                             "{1}".format(transformed_schema, out_schema))
    if len(transformed) != REQUESTS or not line["tokens_equal_to_driver"]:
        raise AssertionError("transformed tokens differ from the export "
                             "served in the driver")
    if not (decode_steps > 0
            and k1 == FLAGSHIP["num_layers"] * decode_steps
            and executor["k1"] == k1):
        raise AssertionError("paged_attention launches: transform {0}, "
                             "driver {1}, want {2} layers x {3} decode "
                             "steps".format(executor["k1"], k1,
                                            FLAGSHIP["num_layers"],
                                            decode_steps))
    if not line["cli_tokens_equal"]:
        raise AssertionError("the serving CLI's tokens differ from the "
                             "transform's")
    if not ds_rel <= FEED_LOSS_RTOL or len(ds_losses) != len(want):
        raise AssertionError("Dataset-fed losses {0} differ from the fit's "
                             "by {1} relative".format(ds_losses, ds_rel))
    if ds_launches != {n: want_launches for n in ("fwd", "dq", "dkv")}:
        raise AssertionError("Dataset-fed flash launches {0}".format(
            ds_launches))
    return line


# ----------------------------------------------------------------------
# static generate, logits serving, quantized serving (phase 7)
# ----------------------------------------------------------------------

#: the static schedule's knobs: ``SERVING`` on the contiguous layout
#: (``kv_layout`` unset, the reference's default)
STATIC_SERVING = {k: v for k, v in SERVING.items()
                  if k not in ("kv_layout", "kv_page_tokens")}
#: f32 token checks: tokens of two paths over the same weights must be
#: equal, or differ first at a near tie: a step whose top-2 logit gap
#: (the model's own f32 forward over the prompt and the common tokens)
#: is under this share of the step's logit spread (top-1 minus the
#: median logit), a gap that the paths' different f32 rounding can close
NEAR_TIE = 1e-3
#: the same for the int8 KV cache's paths: their K/V differ in f32
#: rounding before the int8 rounding, and where that moves a value
#: across a rounding boundary its code flips by one step, 1/127 of its
#: row's absolute max; a tie within that share of the spread is one such
#: flip can close
NEAR_TIE_INT8_KV = 1 / 127
#: f32 logits serving (dot attention over 16 layers) against the f32
#: flash forward (K2): every element to this share of |ref| + the RMS of
#: its row of V logits (:func:`row_relative_error`): K2's f32 O agrees
#: to ``FLASH_TOL["f32_out"]`` with its plain version, and each of the
#: 16 layers can add that much through the residual stream
LOGITS_F32_ROW_REL = 16 * FLASH_TOL["f32_out"]
#: requests of the quantized variants' runs (bf16 and the f32 token
#: checks): one static batch, the first 8 of the 16, to keep
#: ``phase_times`` near its 1,000 s budget on the slower hosts
QUANT_REQUESTS = SLOTS
#: quantized variants of ``quantized_serving``: the knobs on top of the
#: bf16 flagship's
QUANT_VARIANTS = {
    "int8_weights": {"weights": "int8"},
    "int4_weights": {"weights": "int4", "int4_group": 64},
    "int8_kv": {"cache_dtype": "int8"},
}
LOGITS_ROWS, LOGITS_S = 8, 2048
#: rows of the f32 logits check (the f32 logits of 8 rows would hold
#: 2 GiB a copy)
LOGITS_F32_ROWS = 2
MOE_STATIC_ROWS, MOE_STATIC_NEW = 8, 16


def serve_static(predict, rows, batch_size=SLOTS):
    """``(outputs, stats, wall seconds, [(prefill_sec, decode_sec)] of
    each batch)`` of ``predict`` over ``rows``, static schedule."""
    from tensorflowonspark_tpu_torch import serving

    timings = []

    def timed(batch):
        out = predict(batch)
        timings.append(predict.last_timing)
        return out

    timed.__dict__.update(predict.__dict__)
    stats = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = list(serving.predict_rows(
        timed, [dict(r) for r in rows], SERVE_MAPPING,
        batch_size=batch_size, stats=stats))
    torch.cuda.synchronize()
    return out, stats, time.perf_counter() - t0, timings


def tokens_of(out):
    return [np.asarray(r["generated"]).tolist() for r in out]


def first_difference(a, b):
    """Index of the first differing token of two rows (None if equal)."""
    for j, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return j
    return None if len(a) == len(b) else min(len(a), len(b))


def agreement(got, want):
    """Share of requests whose tokens equal to the end, and the first
    differing step of each request that does not."""
    firsts = [first_difference(g, w) for g, w in zip(got, want)]
    return (sum(f is None for f in firsts) / len(firsts),
            [f for f in firsts if f is not None])


def near_tie_check(model, rows, got, want, tie=NEAR_TIE):
    """``(ok, ties)``: each request whose tokens differ must differ first
    at a near tie (``tie``), measured on ``model``'s own forward
    over the prompt and the tokens both paths agree on; ``ties`` holds
    each such step's top-2 gap, logit spread and their ratio."""
    ties = []
    for r, g, w in zip(rows, got, want):
        j = first_difference(g, w)
        if j is None:
            continue
        seq = np.concatenate([np.asarray(r["tokens"], np.int64),
                              np.asarray(g[:j], np.int64)])
        with torch.no_grad():
            logits = model(torch.from_numpy(seq[None]).to(
                model.device))[0, -1].float()
        top = torch.topk(logits, 2).values
        gap = float(top[0] - top[1])
        spread = float(top[0] - logits.median())
        ties.append(dict(step=j, gap=gap, spread=spread,
                         relative=gap / spread))
    return all(t["relative"] < tie for t in ties), ties


def decode_bytes(model, batch, context):
    """Bytes one decode step reads: the weights (every parameter but the
    embedding, of which it gathers ``batch`` rows; quantized leaves as
    their codes and scales), the dequantized copies it writes and reads
    back (quantized models), and the KV it attends over (``context``
    tokens for each of ``batch`` rows, with the int8 scales)."""
    cfg = model.cfg
    qw = model.qweights
    qnames = set(qw.names()) if qw is not None else set()
    item = torch.empty((), dtype=cfg.torch_dtype).element_size()
    weights = batch * cfg.embed_dim * item
    temps = 0
    for name, p in model.named_parameters():
        if name == "embedding":
            continue
        if name in qnames:
            temps += 2 * p.numel() * item
        else:
            weights += p.numel() * p.element_size()
    if qw is not None:
        weights += qw.nbytes
    hkv = cfg.num_kv_heads or cfg.num_heads
    per_token = 2 * hkv * (cfg.head_dim * (1 if cfg.cache_dtype == "int8"
                                           else item)
                           + (4 if cfg.cache_dtype == "int8" else 0))
    kv = int(cfg.num_layers * per_token * context)
    return dict(weight_bytes=int(weights), dequant_temp_bytes=int(temps),
                kv_bytes=kv)


def static_bank_tokens(rows, batch_size, predict):
    """Mean over the static run's decode steps of the bank tokens read
    (``rows x bucket + max_new`` per batch)."""
    m, new, cap = predict.pad_multiple, predict.max_new_tokens, \
        predict.pad_cap
    banks = []
    for i in range(0, len(rows), batch_size):
        n = max(len(r["tokens"]) for r in rows[i:i + batch_size])
        bucket = max(n, min(-(-n // m) * m, cap))
        banks.append(batch_size * (bucket + new))
    return float(np.mean(banks))


def paged_live_tokens(rows, new, page_tokens, steps):
    """Page tokens K1 reads per decode step, averaged over the run's
    ``steps``: each request's live pages over its ``new - 1`` decode
    steps (its first token comes from the prefill)."""
    total = 0
    for r in rows:
        n = len(r["tokens"])
        for j in range(1, new):
            total += -(-(n + j) // page_tokens) * page_tokens
    return total / steps


def static_run(tree, config, rows):
    """Build the predictor, serve ``rows`` on the static schedule, and
    return the record and the tokens."""
    from tensorflowonspark_tpu_torch.models.transformer import (
        serving_builder,
    )

    t0 = time.perf_counter()
    predict = serving_builder(tree, config)
    torch.cuda.synchronize()
    build = time.perf_counter() - t0
    out, stats, wall, timings = serve_static(predict, rows)
    toks = tokens_of(out)
    new = predict.max_new_tokens
    decode_ms = [1e3 * d / (new - 1) for _, d in timings]
    rec = dict(
        build_sec=build, wall_sec=wall,
        tokens_per_sec=sum(len(t) for t in toks) / wall,
        latency_p50_ms=1e3 * pct(stats["latency_sec"].values(), 50),
        latency_p99_ms=1e3 * pct(stats["latency_sec"].values(), 99),
        batch_prefill_ms=[1e3 * p for p, _ in timings],
        batch_decode_ms=[1e3 * d for _, d in timings],
        decode_step_ms=float(np.mean(decode_ms)),
    )
    return predict, rec, toks


def continuous_run(tree, config, rows):
    """The same on the continuous schedule: the record (with K1's
    launches), the tokens and the predictor."""
    from tensorflowonspark_tpu_torch.models.transformer import (
        serving_builder,
    )

    predict = serving_builder(tree, config)
    out, stats, wall, k1 = serve_rows(predict, [dict(r) for r in rows])
    steps = stats["chunks"] * config["chunk_size"]
    rec = dict(
        wall_sec=wall, tokens_per_sec=stats["tokens_out"] / wall,
        decode_steps=steps,
        decode_step_ms=1e3 * stats["decode_wall_sec"] / steps,
        latency_p50_ms=1e3 * pct(stats["latency_sec"].values(), 50),
        latency_p99_ms=1e3 * pct(stats["latency_sec"].values(), 99),
        paged_attention_launches=k1,
    )
    return predict, rec, tokens_of(out)


def phase_static_serve_flagship(tree, slice_tokens, slice_step_ms=None):
    """Static generate, logits serving, quantized weights and the int8
    KV cache, MoE static serving, and the pipeline at its default
    schedule: see the module docstring, ``static_serve_flagship``.  ``tree`` is the
    flagship's seed-0 tree, ``slice_tokens`` ``slice_flagship``'s tokens
    (the paged continuous schedule on the same requests), and
    ``slice_step_ms`` its decode step ms (run again here when None)."""
    import importlib
    import tempfile

    from tensorflowonspark_tpu_torch import checkpoint, convert, serving
    from tensorflowonspark_tpu_torch.models import transformer
    from tensorflowonspark_tpu_torch.ops.paged_attention import (
        paged_attention,
    )

    t_phase = time.perf_counter()
    smoke = importlib.import_module("chip_smoke")
    vocab = FLAGSHIP["vocab_size"]
    layers = FLAGSHIP["num_layers"]
    rows = make_requests(np.random.default_rng(2), REQUESTS, vocab, 16,
                         SERVING["max_prompt_len"])
    static_cfg = dict(FLAGSHIP, **STATIC_SERVING)
    line = dict(model="L16 H8 Dh128 Dm1024", requests=REQUESTS,
                batch_size=SLOTS)
    problems = []

    parts = {}

    def part(name, _t=[time.perf_counter()]):
        now = time.perf_counter()
        parts[name] = now - _t[0]
        _t[0] = now

    # 1. static generate, bf16, contiguous; against the paged continuous
    # schedule's tokens; in f32 against the contiguous continuous one
    paged_attention.launches = 0
    predict, bf16, static_tokens = static_run(tree, static_cfg, rows)
    if paged_attention.launches:
        problems.append("the static schedule launched K1")
    bad = [t for t in static_tokens
           if len(t) != SERVING["max_new_tokens"] or min(t) < 0
           or max(t) >= vocab]
    if bad or len(static_tokens) != REQUESTS:
        problems.append("static rows malformed")
    share, firsts = agreement(static_tokens, slice_tokens)
    bf16.update(agree_with_paged_continuous=share,
                first_differing_steps=firsts,
                **decode_bytes(predict.make_slot_decoder(SLOTS).model, SLOTS,
                               static_bank_tokens(rows, SLOTS, predict)))
    line["static_bf16"] = bf16
    del predict
    gc_collect()
    f32_cfg = dict(static_cfg, dtype="float32")
    predict, f32, f32_static = static_run(tree, f32_cfg, rows)
    _, f32_cont, f32_tokens = continuous_run(tree, f32_cfg, rows)
    ok, ties = near_tie_check(predict.make_slot_decoder(SLOTS).model, rows,
                              f32_static, f32_tokens)
    share, firsts = agreement(f32_static, f32_tokens)
    line["static_f32"] = dict(
        f32, agree_with_contiguous_continuous=share,
        first_differing_steps=firsts, near_ties=ties,
        continuous=f32_cont)
    if not ok:
        problems.append("f32 static tokens differ from the contiguous "
                        "continuous schedule's beyond a near tie: "
                        "{0}".format(ties))
    del predict
    gc_collect()
    part("static")

    # 2. logits serving: bf16 against the flagship model's own forward on
    # the same weights (the dot attention serving runs) and, for scale,
    # the flash forward (K2); f32 against the f32 flash forward
    tokens = np.random.default_rng(21).integers(
        0, vocab, (LOGITS_ROWS, LOGITS_S)).astype(np.int32)
    predict = transformer.serving_builder(tree, dict(FLAGSHIP))
    predict({"tokens": tokens[:1, :64]})  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = predict({"tokens": tokens})
    logits_sec = time.perf_counter() - t0
    del predict
    gc_collect()
    predict = transformer.serving_builder(tree, dict(FLAGSHIP,
                                                     dtype="float32"))
    got_f32 = predict({"tokens": tokens[:LOGITS_F32_ROWS]})
    del predict
    gc_collect()
    got_logits = torch.from_numpy(got["logits"]).cuda()
    f32_logits = torch.from_numpy(got_f32["logits"]).cuda()
    batch = torch.from_numpy(tokens.astype(np.int64)).cuda()
    refs = {}
    for name, extra in (("own", {}), ("flash", {"attention_impl": "flash"}),
                        ("f32_flash", {"attention_impl": "flash",
                                       "dtype": "float32"})):
        model = convert.params_from_flax(tree, transformer.TransformerConfig(
            **dict(FLAGSHIP, **extra)))
        with torch.no_grad():
            refs[name] = model(batch[:LOGITS_F32_ROWS]
                               if name == "f32_flash" else batch)
        del model
        gc_collect()
    row_err = row_relative_error(got_logits, refs["own"])
    f32_err = row_relative_error(f32_logits, refs["f32_flash"])
    own_next = refs["own"][:, -1].argmax(dim=-1).cpu().numpy()
    flash_next = refs["flash"][:, -1].argmax(dim=-1).cpu().numpy()
    line["logits"] = dict(
        rows=LOGITS_ROWS, seq=LOGITS_S, wall_sec=logits_sec,
        rows_per_sec=LOGITS_ROWS / logits_sec,
        max_abs_err=(got_logits - refs["own"]).abs().max().item(),
        row_relative_error=row_err, tol=FLASH_TOL["bf16_row_rel"],
        flash_max_abs_err=(got_logits - refs["flash"]).abs().max().item(),
        flash_row_relative_error=row_relative_error(got_logits,
                                                    refs["flash"]),
        next_token_equal_flash=bool((flash_next == got["next_token"]).all()),
        f32_rows=LOGITS_F32_ROWS,
        f32_max_abs_err=(f32_logits - refs["f32_flash"]).abs().max().item(),
        f32_row_relative_error=f32_err, f32_tol=LOGITS_F32_ROW_REL,
        bf16_vs_f32_row_relative_error=row_relative_error(
            got_logits[:LOGITS_F32_ROWS], f32_logits),
        shape=list(got["logits"].shape), dtype=str(got["logits"].dtype))
    if not (row_err <= FLASH_TOL["bf16_row_rel"]
            and got["logits"].shape == (LOGITS_ROWS, LOGITS_S, vocab)
            and got["logits"].dtype == np.float32
            and (own_next == got["next_token"]).all()):
        problems.append("logits serving: row error {0}, next tokens {1} vs "
                        "{2}".format(row_err, got["next_token"], own_next))
    f32_next = refs["f32_flash"][:, -1].argmax(dim=-1).cpu().numpy()
    if not (f32_err <= LOGITS_F32_ROW_REL
            and (f32_next == got_f32["next_token"]).all()):
        problems.append("f32 logits serving against the f32 flash forward: "
                        "row error {0} (tol {1}), next tokens {2} vs "
                        "{3}".format(f32_err, LOGITS_F32_ROW_REL,
                                     got_f32["next_token"], f32_next))
    del got, got_f32, got_logits, f32_logits, refs, batch
    gc_collect()
    part("logits")

    # 3. quantized weights and the int8 KV cache, static and paged
    # continuous, against bf16
    line["quantized"] = {}
    if slice_step_ms is None:
        slice_step_ms = continuous_run(tree, dict(FLAGSHIP, **SERVING),
                                       rows)[1]["decode_step_ms"]
    qrows = rows[:QUANT_REQUESTS]
    for name, knobs in QUANT_VARIANTS.items():
        paged_attention.launches = 0
        predict, rec, toks = static_run(tree, dict(static_cfg, **knobs),
                                        qrows)
        if paged_attention.launches:
            problems.append(name + ": the static schedule launched K1")
        share, _ = agreement(toks, static_tokens[:QUANT_REQUESTS])
        rec.update(agree_with_bf16=share,
                   decode_step_ms_bf16=bf16["decode_step_ms"],
                   **decode_bytes(predict.make_slot_decoder(SLOTS).model,
                                  SLOTS, static_bank_tokens(qrows, SLOTS,
                                                            predict)))
        del predict
        gc_collect()
        predict, cont, ctoks = continuous_run(
            tree, dict(FLAGSHIP, **SERVING, **knobs), qrows)
        share_c, _ = agreement(ctoks, slice_tokens[:QUANT_REQUESTS])
        steps = cont["decode_steps"]
        cont.update(agree_with_bf16=share_c,
                    decode_step_ms_bf16=slice_step_ms,
                    **decode_bytes(predict.make_slot_decoder(SLOTS).model,
                                   SLOTS, paged_live_tokens(
                                       qrows, SERVING["max_new_tokens"],
                                       SERVING["kv_page_tokens"], steps)))
        if cont["paged_attention_launches"] != layers * steps:
            problems.append("{0}: K1 launches {1} != {2} x {3}".format(
                name, cont["paged_attention_launches"], layers, steps))
        if name == "int8_kv":
            cache = predict.make_slot_decoder(SLOTS).cache[0]
            if cache["k"].dtype != torch.int8 or "k_scale" not in cache:
                problems.append("int8_kv: the pools are not int8")
            line["int8_pool_launches"] = cont["paged_attention_launches"]
        del predict
        gc_collect()
        line["quantized"][name] = dict(static=rec, paged_continuous=cont)
    part("quantized")
    # in f32, each variant's static tokens against its contiguous
    # continuous schedule's, and int4's paged tokens against its
    # contiguous ones.  The int8 KV cache quantizes post-rope keys per
    # absolute position, and the two schedules place a ragged row's
    # tokens at different positions (a static batch pads to its longest
    # row, a slot to its own bucket): its rows share one bucket, so both
    # schedules write each token at the same position
    bucket_rows = make_requests(
        np.random.default_rng(22), REQUESTS, vocab,
        SERVING["max_prompt_len"] - SERVING["pad_multiple"] + 1,
        SERVING["max_prompt_len"])[:QUANT_REQUESTS]
    line["quantized_f32"] = {}
    for name, knobs in QUANT_VARIANTS.items():
        vrows = (bucket_rows if name == "int8_kv"
                 else qrows)
        tie = NEAR_TIE_INT8_KV if name == "int8_kv" else NEAR_TIE
        predict, _, q_static = static_run(tree, dict(f32_cfg, **knobs),
                                          vrows)
        _, _, q_contig = continuous_run(tree, dict(f32_cfg, **knobs), vrows)
        ok, ties = near_tie_check(predict.make_slot_decoder(SLOTS).model,
                                  vrows, q_static, q_contig, tie)
        share, firsts = agreement(q_static, q_contig)
        rec = dict(rows="one bucket" if vrows is bucket_rows else "ragged",
                   static_vs_contiguous=share, first_differing_steps=firsts,
                   near_tie=tie, near_ties=ties)
        if not ok:
            problems.append("{0}: f32 static tokens differ from the "
                            "contiguous continuous schedule's beyond a near "
                            "tie: {1}".format(name, ties))
        if name == "int4_weights":
            _, _, i4_paged = continuous_run(
                tree, dict(FLAGSHIP, dtype="float32", **SERVING, **knobs),
                vrows)
            ok, ties = near_tie_check(predict.make_slot_decoder(SLOTS).model,
                                      vrows, i4_paged, q_contig)
            share, firsts = agreement(i4_paged, q_contig)
            rec.update(paged_vs_contiguous=share,
                       paged_first_differing_steps=firsts,
                       paged_near_ties=ties)
            if not ok:
                problems.append("int4 paged tokens differ from contiguous "
                                "beyond a near tie: {0}".format(ties))
        line["quantized_f32"][name] = rec
        del predict
        gc_collect()

    part("quantized_f32")

    # 4. MoE: static generate and logits serving, K5 counted
    from tensorflowonspark_tpu_torch.ops import gmm

    moe = moe_tree()
    moe_rows = make_requests(np.random.default_rng(18), MOE_STATIC_ROWS,
                             MOE_FLAGSHIP["vocab_size"], 16, 64)
    moe_cfg = dict(MOE_FLAGSHIP, **dict(STATIC_SERVING,
                                        max_new_tokens=MOE_STATIC_NEW,
                                        max_prompt_len=64))
    predict = transformer.serving_builder(moe, moe_cfg)
    reset_launches()
    moe_out, _, moe_wall, _ = serve_static(predict, moe_rows)
    static_k5 = dict(gmm.grouped_matmul.launches)
    del predict
    gc_collect()
    mlayers = MOE_FLAGSHIP["num_layers"]
    batches = -(-MOE_STATIC_ROWS // SLOTS)
    # each forward (the prefill and every decode step) runs wi, wg, wo
    want_static = {"gmm": 3 * mlayers * MOE_STATIC_NEW * batches,
                   "gmm_dxt": 0, "tgmm": 0}
    predict = transformer.serving_builder(moe, dict(MOE_FLAGSHIP))
    reset_launches()
    moe_logits = predict({"tokens": tokens[:2, :512]})
    logits_k5 = dict(gmm.grouped_matmul.launches)
    want_logits = {"gmm": 3 * mlayers, "gmm_dxt": 0, "tgmm": 0}
    del predict, moe
    gc_collect()
    moe_tokens = tokens_of(moe_out)
    line["moe"] = dict(
        requests=MOE_STATIC_ROWS, new_tokens=MOE_STATIC_NEW,
        wall_sec=moe_wall,
        tokens_per_sec=MOE_STATIC_ROWS * MOE_STATIC_NEW / moe_wall,
        static_gmm_launches=static_k5, static_gmm_expected=want_static,
        logits_gmm_launches=logits_k5, logits_gmm_expected=want_logits,
        first_tokens=[t[:4] for t in moe_tokens[:4]])
    if static_k5 != want_static or logits_k5 != want_logits:
        problems.append("MoE K5 launches {0} / {1}".format(static_k5,
                                                           logits_k5))
    if not (all(len(t) == MOE_STATIC_NEW and max(t) < MOE_FLAGSHIP[
            "vocab_size"] for t in moe_tokens)
            and np.isfinite(moe_logits["logits"]).all()):
        problems.append("MoE outputs malformed")
    del moe_logits
    gc_collect()
    part("moe")

    # 5. the pipeline at its default schedule, and the CLI's static one
    from tensorflowonspark_tpu_torch.engine import LocalEngine
    from tensorflowonspark_tpu_torch.pipeline import TFModel

    tmp = tempfile.mkdtemp(prefix="static_serve_")
    try:
        export = os.path.join(tmp, "export")
        t0 = time.perf_counter()
        checkpoint.save_for_serving(export, tree, extra_metadata={
            "model_ref": PIPELINE_MODEL_REF, "model_config": static_cfg})
        export_sec = time.perf_counter() - t0
        model = (TFModel().setExportDir(export).setInputMapping(
            SERVE_MAPPING).setBatchSize(SLOTS))
        schedule = model.getSchedule()
        engine = LocalEngine(1)
        try:
            model.engine = engine
            t1 = time.perf_counter()
            transformed = model.transform([dict(r) for r in rows])
            transform_sec = time.perf_counter() - t1
        finally:
            engine.stop()
        from tensorflowonspark_tpu_torch.data import interchange

        cli_in, cli_out = (os.path.join(tmp, "cli-in"),
                           os.path.join(tmp, "cli-out"))
        interchange.save_as_tfrecords(rows, cli_in, schema=PIPELINE_SCHEMA)
        env = dict(os.environ, PYTHONPATH=os.path.dirname(
            os.path.abspath(smoke.__file__)))
        t2 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "tensorflowonspark_tpu_torch.serving",
             "--export_dir", export, "--input", cli_in,
             "--input_mapping", "tokens=tokens", "--output", cli_out,
             "--batch_size", str(SLOTS), "--schedule", "static"],
            env=env, capture_output=True, text=True, timeout=600)
        cli_sec = time.perf_counter() - t2
        if proc.returncode != 0:
            raise AssertionError("serving CLI exited {0}:\n{1}".format(
                proc.returncode, proc.stderr[-4000:]))
        with open(os.path.join(cli_out, "part-00000.jsonl")) as f:
            cli_tokens = [json.loads(line_)["generated"] for line_ in f]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    line["pipeline"] = dict(
        schedule=schedule, export_sec=export_sec,
        transform_sec=transform_sec, cli_sec=cli_sec,
        transform_equal=tokens_of(transformed) == static_tokens,
        cli_equal=cli_tokens == static_tokens)
    if schedule != "static" or not line["pipeline"]["transform_equal"] \
            or not line["pipeline"]["cli_equal"]:
        problems.append("pipeline at its default schedule: {0}".format(
            line["pipeline"]))

    part("pipeline")
    line.update(static_serve_launches=static_k5["gmm"], part_sec=parts,
                quantized_requests=QUANT_REQUESTS,
                phase_sec=time.perf_counter() - t_phase,
                nvidia_smi=nvidia_smi(), ok=not problems,
                problems=problems)
    emit("static_serve_flagship", **line)
    if problems:
        raise AssertionError("static_serve_flagship: " + "; ".join(problems))
    return line


# ----------------------------------------------------------------------
# the LM server's reuse and robustness (phases 27-30)
# ----------------------------------------------------------------------

#: the prefix phase's traffic: requests in families that share a header
#: of this many tokens, each followed by a tail of its own
PREFIX_REQUESTS, PREFIX_FAMILIES, PREFIX_HEADER = 32, 2, 256
#: the first of them, both families, held in f32 with and without a cache
#: (8, one wave of the slots: cut from 16 to keep ``phase_times`` near its
#: 1,000 s budget on the slower hosts)
PREFIX_F32_REQUESTS = SLOTS
PREFIX_TAIL = (16, 160)
#: the serving knobs of a radix prefix cache whose block is the page
PREFIX = dict(prefix_cache=True, prefix_block=SERVING["kv_page_tokens"])
#: the recovery phase's watchdog and its planted wedge (chaos plan)
WATCHDOG_SEC, WEDGE_AT_CHUNK, WEDGE_SEC = 3.0, 2, 6.0
#: the chunk at which the hot-swap phase publishes step 2, and the token
#: budgets of its requests (the first four finish before it)
SWAP_AT_CHUNK = 2
SWAP_BUDGETS = [16] * 4 + [64] * 12
#: f32 logits of the fused-QKV flagship against the unfused model's on
#: the same weights (one product over the stacked kernel against three)
FUSED_F32_ROW_REL = 1e-5
FUSED_TRAIN_STEPS = 3


def family_requests(seed, n, vocab, families=PREFIX_FAMILIES,
                    header=PREFIX_HEADER, tail=PREFIX_TAIL):
    """``n`` requests, request ``i`` in family ``i % families``: the
    family's header followed by a tail of its own."""
    rng = np.random.default_rng(seed)
    heads = [rng.integers(0, vocab, header) for _ in range(families)]
    return [{"tokens": np.concatenate([
        heads[i % families],
        rng.integers(0, vocab, int(rng.integers(tail[0], tail[1] + 1))),
    ]).astype(np.int32)} for i in range(n)]


def tie_gate(model_fn, rows, got, want, tie=NEAR_TIE):
    """:func:`near_tie_check`, building its model (``model_fn()``) only
    when some request's tokens differ."""
    if all(first_difference(g, w) is None for g, w in zip(got, want)):
        return True, []
    return near_tie_check(model_fn(), rows, got, want, tie)


def serve_job(predict, rows, device, mapping=SERVE_MAPPING, **engine_kw):
    """``(outputs, stats, wall seconds, K1 launches, engine)`` of one
    :class:`ServingEngine` job over ``rows`` on :data:`SLOTS` slots."""
    from tensorflowonspark_tpu_torch.ops.paged_attention import (
        paged_attention,
    )
    from tensorflowonspark_tpu_torch.serving_engine import ServingEngine

    stats = {}
    eng = ServingEngine(predict, mapping, num_slots=SLOTS, stats=stats,
                        **engine_kw)
    paged_attention.launches = 0
    sync(device)
    t0 = time.perf_counter()
    out = list(eng.serve([dict(r) for r in rows]))
    sync(device)
    return (out, stats, time.perf_counter() - t0, paged_attention.launches,
            eng)


class AdmitLog(object):
    """Records, on one decoder, each admit's cached prompt tokens and the
    pool's shared pages after it (the harness's view; the engine's stats
    carry only sums)."""

    def __init__(self, dec):
        self.dec, self.cached, self.shared = dec, [], []

        def admit(slot, prompt, _orig=dec.admit):
            first = _orig(slot, prompt)
            self.cached.append(int(dec.last_admit_cached_tokens))
            if dec.page_pool is not None:
                self.shared.append(
                    dec.page_pool.stats()["pool_pages_shared"])
            return first

        dec.admit = admit

    def clear(self):
        self.cached, self.shared = [], []

    def detach(self):
        del self.dec.admit


def job_record(stats, wall, k1, chunk):
    steps = stats["chunks"] * chunk
    return dict(
        wall_sec=wall, tokens_out=stats["tokens_out"],
        tokens_per_sec=stats["tokens_out"] / wall,
        ttft_p50_ms=1e3 * pct(stats["ttft_sec"].values(), 50),
        ttft_p99_ms=1e3 * pct(stats["ttft_sec"].values(), 99),
        latency_p50_ms=1e3 * pct(stats["latency_sec"].values(), 50),
        latency_p99_ms=1e3 * pct(stats["latency_sec"].values(), 99),
        prefill_wall_sec=stats["prefill_wall_sec"],
        decode_wall_sec=stats["decode_wall_sec"], decode_steps=steps,
        decode_step_ms=1e3 * stats["decode_wall_sec"] / max(steps, 1),
        paged_attention_launches=k1)


def phase_prefix_serve_flagship(tree, config=FLAGSHIP, device=None,
                                requests=PREFIX_REQUESTS):
    """The radix prefix cache at the flagship's width: see the module
    docstring, phase 27.  Returns the record, with the rows and the f32
    paged tokens without a cache for :func:`phase_fused_qkv_flagship`."""
    from tensorflowonspark_tpu_torch.models.transformer import (
        serving_builder,
    )

    dev = torch.device(device or "cuda")
    over = {} if device is None else {"device": device}
    layers = config["num_layers"]
    chunk = SERVING["chunk_size"]
    rows = family_requests(31, requests, config["vocab_size"])
    line = dict(requests=requests, families=PREFIX_FAMILIES,
                header_tokens=PREFIX_HEADER,
                prompt_lens=[len(r["tokens"]) for r in rows])
    problems = []
    t_phase = time.perf_counter()

    # 1. f32, TF32 off: the cache's tokens equal the cold path's, in both
    # layouts (near ties apart)
    line["f32"] = {}
    f32_rows = rows[:PREFIX_F32_REQUESTS]
    for layout in ("paged", "contiguous"):
        base = dict(config, **dict(SERVING, kv_layout=layout),
                    dtype="float32", **over)
        toks = {}
        for cached in (False, True):
            predict = serving_builder(tree, dict(base, **(PREFIX if cached
                                                          else {})))
            out, stats, wall, _, _ = serve_job(predict, f32_rows, dev)
            toks[cached] = tokens_of(out)
            if cached:
                hits = stats["prefix_hits"]
            else:
                model = predict.make_slot_decoder(SLOTS).model
                if layout == "paged":
                    line["f32_paged_tokens"] = toks[False]
            del predict
        ok, ties = near_tie_check(model, f32_rows, toks[True], toks[False])
        share, firsts = agreement(toks[True], toks[False])
        line["f32"][layout] = dict(requests=len(f32_rows), equal_share=share,
                                   first_differing_steps=firsts,
                                   near_ties=ties, prefix_hits=hits)
        if not ok or not hits:
            problems.append("f32 {0}: prefix-cache tokens differ beyond a "
                            "near tie ({1}) or no hit ({2})".format(
                                layout, ties, hits))
        del model
        gc_collect()

    # 2. bf16 paged: a cold job, then a warm one through the memoized
    # predictor
    predict = serving_builder(tree, dict(config, **SERVING, **PREFIX,
                                         **over))
    dec = predict.make_slot_decoder(SLOTS)
    log = AdmitLog(dec)
    jobs = {}
    try:
        for name in ("cold", "warm"):
            log.clear()
            out, stats, wall, k1, _ = serve_job(predict, rows, dev)
            rec = job_record(stats, wall, k1, chunk)
            rec.update(
                prefix_hits=stats["prefix_hits"],
                prefix_hit_admits=stats["prefix_hit_admits"],
                prefix_tokens_saved=stats["prefix_tokens_saved"],
                evictions=stats["evictions"],
                cached_tokens=list(log.cached),
                pool_pages=stats.get("pool_pages"),
                pool_pages_used_after=stats.get("pool_pages_used"),
                pool_pages_shared_max=max(log.shared or [0]),
                radix_blocks=len(dec.prefix_cache),
                tokens=tokens_of(out))
            jobs[name] = rec
            if k1 != layers * rec["decode_steps"] or not k1:
                problems.append("{0}: K1 launches {1} != {2} x {3}".format(
                    name, k1, layers, rec["decode_steps"]))
            if sum(log.cached) != stats["prefix_tokens_saved"]:
                problems.append("{0}: prefix_tokens_saved {1} != the "
                                "matched blocks' {2}".format(
                                    name, stats["prefix_tokens_saved"],
                                    sum(log.cached)))
            if len(out) != requests or any("error" in r for r in out):
                problems.append(name + ": a request failed")
        warm = jobs["warm"]["cached_tokens"]
        if len(warm) != requests or min(warm) < PREFIX_HEADER:
            problems.append("warm job: hits below the {0}-token header: "
                            "{1}".format(PREFIX_HEADER, warm))
        dec.reset()
        census = dec.page_pool.refcount_census()
        radix = dec.prefix_cache.page_census()
        line["census_after_reset"] = dict(pool_pages=len(census),
                                          radix_pages=len(radix))
        if census != {p: 1 for p in radix}:
            problems.append("after reset the pool's refcounts are not the "
                            "radix's pages at 1")
    finally:
        log.detach()
    share, _ = agreement(jobs["warm"]["tokens"], jobs["cold"]["tokens"])
    for rec in jobs.values():
        del rec["tokens"]
    line.update(bf16_paged=jobs, warm_equal_cold_share=share,
                launches=jobs["cold"]["paged_attention_launches"]
                + jobs["warm"]["paged_attention_launches"],
                phase_sec=time.perf_counter() - t_phase,
                device=device_name(dev), nvidia_smi=nvidia_smi_or_cpu(dev),
                ok=not problems, problems=problems)
    del predict, dec
    gc_collect()
    emit("prefix_serve_flagship",
         **{k: v for k, v in line.items() if k != "f32_paged_tokens"})
    if problems:
        raise AssertionError("prefix_serve_flagship: " + "; ".join(problems))
    line["rows"] = f32_rows
    return line


def nvidia_smi_or_cpu(device):
    return nvidia_smi() if torch.device(device).type == "cuda" else "cpu"


def phase_serve_recovery_flagship(tree, config=FLAGSHIP, device=None,
                                  requests=REQUESTS, timeout=WATCHDOG_SEC,
                                  hang=WEDGE_SEC):
    """The decode watchdog at the flagship's width: see the module
    docstring, phase 28."""
    import tempfile

    from tensorflowonspark_tpu_torch.models.transformer import (
        serving_builder,
    )
    from tensorflowonspark_tpu_torch.ops.paged_attention import (
        paged_attention,
    )
    from tensorflowonspark_tpu_torch import telemetry
    from tensorflowonspark_tpu_torch.telemetry import blackbox
    from tensorflowonspark_tpu_torch.testing import chaos

    dev = torch.device(device or "cuda")
    over = {} if device is None else {"device": device}
    layers, chunk = config["num_layers"], SERVING["chunk_size"]
    rows = make_requests(np.random.default_rng(2), requests,
                         config["vocab_size"], 16, SERVING["max_prompt_len"])
    predict = serving_builder(tree, dict(config, **SERVING, dtype="float32",
                                         **over))
    t_phase = time.perf_counter()
    ref, ref_stats, ref_wall, ref_k1, _ = serve_job(predict, rows, dev)
    fired, resolved = [], []
    dec = predict.make_slot_decoder(SLOTS)

    def resolve(pending, _orig=dec.resolve_chunk):
        out = _orig(pending)
        resolved.append(time.perf_counter())
        return out

    tmp = tempfile.mkdtemp(prefix="recovery_")
    plan = chaos.ChaosPlan().wedge_dispatch(WEDGE_AT_CHUNK, hang_sec=hang)
    os.environ[chaos.TFOS_CHAOS_PLAN] = plan.save(
        os.path.join(tmp, "plan.json"))
    dec.resolve_chunk = resolve
    # the process's flight recorder dumps into this phase's directory
    recorder = blackbox.install()
    if recorder is None:
        raise AssertionError("serve_recovery_flagship: no flight recorder "
                             "(telemetry off?)")
    dump_dir, recorder.dump_dir = recorder.dump_dir, os.path.join(
        tmp, "blackbox")
    bundle = None
    try:
        from tensorflowonspark_tpu_torch.serving_engine import ServingEngine

        stats = {}
        eng = ServingEngine(predict, SERVE_MAPPING, num_slots=SLOTS,
                            stats=stats, watchdog_timeout=timeout)

        def recover(_orig=eng._recover):
            fired.append((time.perf_counter(), len(eng._slot_req),
                          paged_attention.launches))
            _orig()

        eng._recover = recover
        paged_attention.launches = 0
        sync(dev)
        # the job's start on the tracer's clock (span t0s count from its
        # epoch)
        t_job = time.perf_counter() - telemetry.get_tracer().epoch
        t0 = time.perf_counter()
        out = list(eng.serve([dict(r) for r in rows]))
        sync(dev)
        wall = time.perf_counter() - t0
        # the abandoned worker wakes at fire + (hang - timeout) and must
        # return without touching the decoder
        if fired:
            time.sleep(max(0.0, fired[0][0] + hang - timeout
                           - time.perf_counter()) + 1.0)
        sync(dev)
        k1 = paged_attention.launches
        dumps = sorted(os.listdir(recorder.dump_dir)) if os.path.isdir(
            recorder.dump_dir) else []
        if len(dumps) == 1:
            bundle = blackbox.load_dump(os.path.join(recorder.dump_dir,
                                                     dumps[0]))
    finally:
        recorder.dump_dir = dump_dir
        del os.environ[chaos.TFOS_CHAOS_PLAN]
        del dec.resolve_chunk
        shutil.rmtree(tmp, ignore_errors=True)
    problems = []
    if bundle is None:
        problems.append("flight recorder: {0} bundles after the fire, "
                        "not 1".format(len(dumps)))
    else:
        bundle_chunks = [s for s in bundle["spans"]
                         if s["name"] == "decode_chunk"
                         and s["t0"] >= t_job]
        if (bundle["reason"] != "watchdog_fire"
                or not any(e["kind"] == "watchdog_fire"
                           for e in bundle["events"])
                or not bundle_chunks):
            problems.append("flight recorder: the bundle lacks the "
                            "watchdog_fire event or decode_chunk spans")
    ok, ties = near_tie_check(dec.model, rows, tokens_of(out),
                              tokens_of(ref))
    share, firsts = agreement(tokens_of(out), tokens_of(ref))
    if not ok or len(out) != requests or any("error" in r for r in out):
        problems.append("recovered f32 tokens differ from the unwedged "
                        "run's beyond a near tie: {0}".format(ties))
    if stats["watchdog_fires"] != 1 or not fired \
            or stats["recovered"] != fired[0][1]:
        problems.append("watchdog_fires {0}, recovered {1}, in flight at "
                        "the fire {2}".format(stats["watchdog_fires"],
                                              stats["recovered"],
                                              fired[0][1] if fired else None))
    if k1 != layers * chunk * stats["chunks"]:
        problems.append("K1 launches {0} != {1} x the {2} resolved chunks' "
                        "steps: the abandoned chunk launched".format(
                            k1, layers, stats["chunks"]))
    after = [t for t in resolved if fired and t > fired[0][0]]
    line = dict(
        requests=requests, slots=SLOTS, watchdog_timeout_sec=timeout,
        wedge_at_chunk=WEDGE_AT_CHUNK, wedge_sec=hang,
        watchdog_fires=stats["watchdog_fires"],
        recovered=stats["recovered"],
        in_flight_at_fire=fired[0][1] if fired else None,
        fire_to_next_resolved_sec=(after[0] - fired[0][0]) if after
        else None,
        launches=k1, resolved_chunks=stats["chunks"],
        flight_recorder=None if bundle is None else dict(
            bundles=len(dumps), reason=bundle["reason"],
            events=len(bundle["events"]), spans=len(bundle["spans"]),
            decode_chunk_spans=len(bundle_chunks)),
        unwedged_chunks=ref_stats["chunks"], wall_sec=wall,
        unwedged_wall_sec=ref_wall, equal_share=share,
        first_differing_steps=firsts, near_ties=ties,
        phase_sec=time.perf_counter() - t_phase, device=device_name(dev),
        nvidia_smi=nvidia_smi_or_cpu(dev), ok=not problems,
        problems=problems)
    del predict, dec, eng
    gc_collect()
    emit("serve_recovery_flagship", **line)
    if problems:
        raise AssertionError("serve_recovery_flagship: "
                             + "; ".join(problems))
    return line


#: the telemetry phase's tenants (request i belongs to tenant i % 3), its
#: profiler steps, its on/off pairs, and the radix budget that keeps every
#: job's blocks cached (no eviction, so that every job after the first
#: admits alike)
TELEMETRY_TENANTS = ("acme", "globex", "initech")
TELEMETRY_PROFILE_STEPS = 3
TELEMETRY_PAIRS = 2
#: requests of each telemetry job (8, one wave of the slots: cut from 16
#: for the same budget)
TELEMETRY_REQUESTS = SLOTS
TELEMETRY_PREFIX_MB = 512
TELEMETRY_MAPPING = {"tokens": "tokens", "tenant": "tenant",
                     "trace_id": "trace_id"}


def telemetry_requests(vocab, n=REQUESTS):
    """``n`` requests sharing one 256-token system prompt, of the three
    :data:`TELEMETRY_TENANTS`, each with its trace id."""
    rows = family_requests(37, n, vocab, families=1, header=PREFIX_HEADER,
                           tail=PREFIX_TAIL)
    for i, r in enumerate(rows):
        r["tenant"] = TELEMETRY_TENANTS[i % len(TELEMETRY_TENANTS)]
        r["trace_id"] = "tel-%02d" % i
    return rows


def phase_telemetry_serve_flagship(tree, config=FLAGSHIP, device=None,
                                   requests=TELEMETRY_REQUESTS,
                                   pairs=TELEMETRY_PAIRS):
    """The serving telemetry plane at the flagship's width: see the module
    docstring, phase 31.  ``pairs`` on/off pairs follow the warm-up, the
    side that goes first alternating (:func:`main` runs 2; the plane's cost
    is read from 10 in a call of their own)."""
    import gc
    import glob
    import tempfile

    from tensorflowonspark_tpu_torch import telemetry
    from tensorflowonspark_tpu_torch.models.transformer import (
        serving_builder,
    )
    from tensorflowonspark_tpu_torch.serving_engine import (
        LATENCY_METRIC,
        TTFT_METRIC,
    )

    dev = torch.device(device or "cuda")
    over = {} if device is None else {"device": device}
    layers, chunk = config["num_layers"], SERVING["chunk_size"]
    rows = telemetry_requests(config["vocab_size"], requests)
    rids = [r["trace_id"] for r in rows]
    base_cfg = dict(config, **SERVING, **PREFIX,
                    prefix_mem_mb=TELEMETRY_PREFIX_MB, **over)
    t_phase = time.perf_counter()
    predict = serving_builder(tree, base_cfg)
    tracer = telemetry.get_tracer()
    reg, led = telemetry.get_registry(), telemetry.get_ledger()
    problems = []

    def job(on):
        telemetry.set_enabled(on)
        try:
            base_reg, base_led = reg.snapshot(), led.snapshot()
            t_rel = time.perf_counter() - tracer.epoch
            gc0 = [g["collections"] for g in gc.get_stats()]
            out, stats, wall, k1, _ = serve_job(predict, rows, dev,
                                                mapping=TELEMETRY_MAPPING)
            gcs = [g["collections"] - c
                   for g, c in zip(gc.get_stats(), gc0)]
        finally:
            telemetry.set_enabled(True)
        rec = dict(plane="on" if on else "off", wall_sec=wall,
                   gc_collections=gcs,
                   tokens_out=stats["tokens_out"],
                   tokens_per_sec=stats["tokens_out"] / wall,
                   decode_wall_sec=stats["decode_wall_sec"],
                   decode_tokens_per_sec=stats["tokens_out"]
                   / stats["decode_wall_sec"],
                   chunks=stats["chunks"], paged_attention_launches=k1)
        if k1 != layers * chunk * stats["chunks"] or not k1:
            problems.append("{0} job: K1 launches {1} != {2} x {3} decode "
                            "steps".format(rec["plane"], k1, layers,
                                           chunk * stats["chunks"]))
        if len(out) != requests or any("error" in r for r in out):
            problems.append(rec["plane"] + " job: a request failed")
        # the rows are keyed by trace id: the next job's replace them
        deltas = dict(stats=stats, t_rel=t_rel,
                      rows=[led.row(rid) for rid in rids],
                      reg=telemetry.snapshot_delta(reg.snapshot(), base_reg),
                      ledger=telemetry.ledger.snapshot_delta(led.snapshot(),
                                                             base_led))
        return tokens_of(out), rec, deltas

    # the same warm-up for each setting, then the settings in turns
    order = [True, False]
    for i in range(pairs):
        order += [True, False] if i % 2 == 0 else [False, True]
    runs = [job(on) for on in order]
    toks = [t for t, _, _ in runs]
    for i, t in enumerate(toks[1:], 1):
        if t != toks[1]:
            problems.append("job {0} ({1}): tokens differ from the warm "
                            "plane-off job's".format(
                                i, runs[i][1]["plane"]))
    warm_equal_cold_share, _ = agreement(toks[1], toks[0])
    _, on_rec, d = runs[2]
    stats = d["stats"]
    counters, hists = d["reg"]["counters"], d["reg"]["histograms"]

    # the ledger against the engine
    ledger_rows = d["rows"]
    chip = sum(r["chip_sec"] for r in ledger_rows)
    tenants = d["ledger"]["tenants"]
    tokens_in = sum(len(r["tokens"]) for r in rows)
    saved = sum(t["prefix_tokens_saved"] for t in tenants.values())
    ledger = dict(
        chip_sec=chip, decode_wall_sec=stats["decode_wall_sec"],
        chip_rel_err=abs(chip - stats["decode_wall_sec"])
        / stats["decode_wall_sec"],
        tenants={t: {f: v[f] for f in ("requests", "tokens_in",
                                        "tokens_out", "chip_sec",
                                        "page_sec", "prefix_tokens_saved")}
                 for t, v in sorted(tenants.items())},
        page_sec_min=min(r["page_sec"] for r in ledger_rows),
        prefix_tokens_saved=saved,
        prefix_cache_tokens_saved=counters.get("prefix_cache.tokens_saved"))
    if ledger["chip_rel_err"] > 1e-9:
        problems.append("ledger chip_sec {0} != decode_wall_sec {1}".format(
            chip, stats["decode_wall_sec"]))
    if (sum(t["tokens_in"] for t in tenants.values()) != tokens_in
            or sum(t["tokens_out"] for t in tenants.values())
            != stats["tokens_out"]
            or sorted(tenants) != sorted(TELEMETRY_TENANTS)):
        problems.append("ledger tenant tokens do not sum to the engine's")
    if ledger["page_sec_min"] <= 0:
        problems.append("a request holds no page-seconds")
    if saved != ledger["prefix_cache_tokens_saved"] or not saved:
        problems.append("ledger prefix_tokens_saved {0} != prefix_cache."
                        "tokens_saved {1}".format(
                            saved, ledger["prefix_cache_tokens_saved"]))

    # the registry
    lat = hists.get(LATENCY_METRIC, {})
    ttft = hists.get(TTFT_METRIC, {})
    registry = dict(
        completed=counters.get("serving.completed"),
        latency_count=lat.get("count"), ttft_count=ttft.get("count"),
        latency_p50_ms=1e3 * telemetry.histogram_percentile(lat, 50),
        latency_p99_ms=1e3 * telemetry.histogram_percentile(lat, 99),
        ttft_p50_ms=1e3 * telemetry.histogram_percentile(ttft, 50),
        ttft_p99_ms=1e3 * telemetry.histogram_percentile(ttft, 99),
        chunks=counters.get("serving.chunks"))
    if (registry["completed"] != requests
            or registry["latency_count"] != requests
            or registry["ttft_count"] != requests):
        problems.append("registry: completed {0}, latency {1}, ttft {2} "
                        "!= {3}".format(registry["completed"],
                                        registry["latency_count"],
                                        registry["ttft_count"], requests))

    # the trace
    chrome = json.loads(json.dumps(tracer.export_chrome()))
    missing = []
    for rid in rids:
        names = {sp["name"] for sp in tracer.spans(trace=rid)
                 if sp["t0"] >= d["t_rel"]}
        if not {"admission", "prefill", "decode_chunk"} <= names:
            missing.append(rid)
    if missing:
        problems.append("traces without admission, prefill and a "
                        "decode_chunk: {0}".format(missing))

    # the profiler
    tmp = tempfile.mkdtemp(prefix="telemetry_profile_")
    try:
        predict_p = serving_builder(tree, dict(
            base_cfg, profile_dir=tmp,
            profile_steps=TELEMETRY_PROFILE_STEPS))
        t0 = time.perf_counter()
        _, pstats, _, _, peng = serve_job(predict_p, rows[:SLOTS], dev,
                                          mapping=TELEMETRY_MAPPING)
        files = glob.glob(os.path.join(tmp, "*.pt.trace.json"))
        text = open(files[0]).read() if len(files) == 1 else ""
        events = json.loads(text)["traceEvents"] if text else []
        split = [e for e in events if "paged_decode_split" in str(
            e.get("name", ""))]
        profile = dict(
            trace_files=len(files), trace_bytes=len(text),
            steps=TELEMETRY_PROFILE_STEPS, chunks=pstats["chunks"],
            session_steps_left=None if peng._profile is None
            else peng._profile.remaining,
            paged_decode_split_events=len(split),
            paged_decode_split_kernel_events=sum(
                1 for e in split if e.get("cat") == "kernel"),
            job_sec=time.perf_counter() - t0)
        del predict_p, peng
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if len(files) != 1 or not split:
        problems.append("profiler: {0} trace file(s), {1} "
                        "paged_decode_split event(s)".format(
                            len(files), len(split)))

    on = [r for _, r, _ in runs[2:] if r["plane"] == "on"]
    off = [r for _, r, _ in runs[2:] if r["plane"] == "off"]
    # on / off decode tokens/s of each pair
    ratios = [a["decode_tokens_per_sec"] / b["decode_tokens_per_sec"]
              for a, b in zip(on, off)]
    line = dict(
        requests=requests, slots=SLOTS, tenants=list(TELEMETRY_TENANTS),
        prompt_lens=[len(r["tokens"]) for r in rows],
        warm_up=[r for _, r, _ in runs[:2]], measured=[r for _, r, _ in
                                                      runs[2:]],
        decode_tokens_per_sec_on=[r["decode_tokens_per_sec"] for r in on],
        decode_tokens_per_sec_off=[r["decode_tokens_per_sec"] for r in off],
        tokens_per_sec_on=[r["tokens_per_sec"] for r in on],
        tokens_per_sec_off=[r["tokens_per_sec"] for r in off],
        decode_on_over_off=ratios,
        decode_on_over_off_median=float(np.median(ratios)),
        pairs_on_slower=sum(1 for r in ratios if r < 1.0),
        warm_equal_cold_share=warm_equal_cold_share,
        ledger=ledger, registry=registry,
        trace=dict(events=len(chrome["traceEvents"]),
                   spans_dropped=tracer.dropped_spans),
        profile=profile, launches=on_rec["paged_attention_launches"],
        phase_sec=time.perf_counter() - t_phase, device=device_name(dev),
        nvidia_smi=nvidia_smi_or_cpu(dev), ok=not problems,
        problems=problems)
    del predict
    gc_collect()
    emit("telemetry_serve_flagship", **line)
    if problems:
        raise AssertionError("telemetry_serve_flagship: "
                             + "; ".join(problems))
    return line


def _bf16_tree(tree):
    if isinstance(tree, dict):
        return {k: _bf16_tree(v) for k, v in tree.items()}
    return torch.from_numpy(np.asarray(tree)).to(torch.bfloat16)


def phase_hot_swap_flagship(tree, config=FLAGSHIP, device=None,
                            requests=REQUESTS):
    """Live weight hot swap at the flagship's width: see the module
    docstring, phase 29."""
    import tempfile

    from tensorflowonspark_tpu_torch import checkpoint, convert, hot_swap
    from tensorflowonspark_tpu_torch.models.transformer import (
        TransformerConfig,
        serving_builder,
    )
    from tensorflowonspark_tpu_torch.testing import chaos

    dev = torch.device(device or "cuda")
    over = {} if device is None else {"device": device}
    layers, chunk = config["num_layers"], SERVING["chunk_size"]
    base = dict(config, **SERVING, dtype="float32", **over)
    rows = make_requests(np.random.default_rng(41), requests,
                         config["vocab_size"], 16, SERVING["max_prompt_len"])
    for r, b in zip(rows, SWAP_BUDGETS):
        r["max_new"] = b
    mapping = dict(SERVE_MAPPING, max_new="max_new")
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="hot_swap_")
    root, side = os.path.join(tmp, "steps"), os.path.join(tmp, "side")
    problems, line, launches = [], dict(requests=requests), []
    try:
        # the trainer's side: steps 1 and 2 (seeds 0 and 1) in bf16, and a
        # step 3 whose final norm is NaN (its canary fails)
        step1 = _bf16_tree(tree)
        t0 = time.perf_counter()
        step2 = _bf16_tree(convert.init_params_tree(
            TransformerConfig(**config), seed=1))
        line["seed1_tree_sec"] = time.perf_counter() - t0
        step3 = dict(step1, ln_f={"scale": torch.full_like(
            step1["ln_f"]["scale"], float("nan"))})
        t0 = time.perf_counter()
        checkpoint.publish_for_serving(root, 1, step1)
        line["publish_sec"] = time.perf_counter() - t0
        checkpoint.publish_for_serving(side, 2, step2)
        checkpoint.publish_for_serving(side, 3, step3)
        del step2, step3
        predict = serving_builder(step1, base)
        dec = predict.make_slot_decoder(SLOTS)
        ref1, _, _, k1, _ = serve_job(predict, rows, dev, mapping)
        launches.append(k1)

        # (a) step 3 is there before the job: installed, its canary fails,
        # rolled back; the job serves step 1's tokens exactly
        os.replace(os.path.join(side, "3"), os.path.join(root, "3"))
        watcher = hot_swap.CheckpointWatcher(
            root, poll_interval=0.0, background=False, start_step=1,
            device=dev)
        out_a, stats_a, _, k1, _ = serve_job(predict, rows, dev, mapping,
                                             watcher=watcher)
        launches.append(k1)
        line["canary"] = dict(
            rollbacks=stats_a["rollbacks"], swaps=stats_a["swaps"],
            weight_generation=stats_a["weight_generation"],
            quarantined=[q["kind"] for q in watcher.quarantined],
            step1_tokens_exact=tokens_of(out_a) == tokens_of(ref1))
        if not (stats_a["rollbacks"] == 1 and stats_a["swaps"] == 0
                and stats_a["weight_generation"] == 0
                and line["canary"]["quarantined"] == ["canary_failed"]
                and line["canary"]["step1_tokens_exact"]):
            problems.append("canary rollback: {0}".format(line["canary"]))

        # (b) step 2 published mid-decode, at the chunk the chaos plan
        # names; ingested on the watcher's thread onto the card
        path = os.path.join(tmp, "plan.json")
        chaos.ChaosPlan([{"kind": "swap_at_chunk",
                          "at_chunk": SWAP_AT_CHUNK}]).save(path)
        os.environ[chaos.TFOS_CHAOS_PLAN] = path
        try:
            at = chaos.swap_chunk_from_plan()
        finally:
            del os.environ[chaos.TFOS_CHAOS_PLAN]
        watcher = hot_swap.CheckpointWatcher(
            root, poll_interval=0.02, start_step=1, device=dev)
        marks = {}

        def publish_at(chunk_index):
            if chunk_index == at and "publish" not in marks:
                marks["publish"] = time.monotonic()
                os.replace(os.path.join(side, "2"), os.path.join(root, "2"))
                # hold the loop until the background ingest lands, so
                # that the swap falls on the next pass, mid-decode
                while watcher.stats["ingested"] < 1 \
                        and time.monotonic() - marks["publish"] < 120:
                    time.sleep(0.01)

        def swap_weights(*a, _orig=dec.swap_weights, **kw):
            marks["swap"] = time.monotonic()
            return _orig(*a, **kw)

        dec.swap_weights = swap_weights
        try:
            out_b, stats_b, wall_b, k1, eng = serve_job(
                predict, rows, dev, mapping, watcher=watcher,
                wedge_fn=publish_at)
        finally:
            del dec.swap_weights
            watcher.close()
        launches.append(k1)
        fresh = serving_builder(checkpoint.load_for_serving(
            os.path.join(root, "2"))[0], base)
        ref2, _, _, k1, _ = serve_job(fresh, rows, dev, mapping)
        launches.append(k1)
        got, r1, r2 = tokens_of(out_b), tokens_of(ref1), tokens_of(ref2)
        ev = stats_b["swap_events"][0] if stats_b["swap_events"] else {}
        requeued = ev.get("requeued", {})
        t_swap = marks.get("swap", float("inf")) - eng._t0
        before = [i for i, t in stats_b["done_at"].items() if t < t_swap]
        after = [i for i in range(requests)
                 if i not in before and i not in requeued]
        ok1, ties1 = tie_gate(lambda: fresh.make_slot_decoder(SLOTS).model,
                              [rows[i] for i in after],
                              [got[i] for i in after],
                              [r2[i] for i in after])
        del fresh
        gc_collect()
        # completed before the swap: step 1's tokens; requeued: step 1's
        # committed prefix
        kept = before + sorted(requeued)
        ok0, ties0 = tie_gate(
            lambda: convert.params_from_flax(step1, TransformerConfig(
                **dict(config, dtype="float32")), device=dev),
            [rows[i] for i in kept],
            [got[i][:requeued.get(i, len(got[i]))] for i in kept],
            [r1[i][:requeued.get(i, len(r1[i]))] for i in kept])
        gc_collect()
        line["swap"] = dict(
            swap_at_chunk=at, swaps=stats_b["swaps"],
            swap_requeued=stats_b["swap_requeued"],
            requeued=requeued, completed_before=sorted(before),
            admitted_after=after, rollbacks=stats_b["rollbacks"],
            weight_generation=stats_b["weight_generation"],
            ingest_sec=watcher.stats["ingest_sec"],
            swap_latency_ms=[1e3 * x for x in stats_b["swap_latency_sec"]],
            publish_to_swap_sec=marks.get("swap", 0) - marks.get(
                "publish", 0),
            wall_sec=wall_b, near_ties_step1=ties0, near_ties_step2=ties1,
            errors=sum("error" in r for r in out_b))
        if not (stats_b["swaps"] == 1 and requeued and after and before
                and ok0 and ok1 and stats_b["rollbacks"] == 0
                and line["swap"]["errors"] == 0):
            problems.append("swap mid-decode: {0}".format(line["swap"]))
        if not all(k and k % (layers * chunk) == 0 for k in launches):
            problems.append("K1 launches {0}".format(launches))
        del predict, dec, eng
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        gc_collect()
    line.update(launches=sum(launches), phase_sec=time.perf_counter()
                - t_phase, device=device_name(dev),
                nvidia_smi=nvidia_smi_or_cpu(dev), ok=not problems,
                problems=problems)
    emit("hot_swap_flagship", **line)
    if problems:
        raise AssertionError("hot_swap_flagship: " + "; ".join(problems))
    return line


def fuse_qkv_tree(tree):
    """``tree`` with each block's q, k, v kernels stacked into the fused
    ``attn/qkv/kernel [E, 3, H, D]`` leaf."""
    out = dict(tree)
    for name, blk in tree.items():
        if name.startswith("block_"):
            attn = {k: v for k, v in blk["attn"].items()
                    if k not in ("q", "k", "v")}
            attn["qkv"] = {"kernel": np.stack(
                [blk["attn"][n]["kernel"] for n in ("q", "k", "v")], axis=1)}
            out[name] = dict(blk, attn=attn)
    return out


def phase_fused_qkv_flagship(tree, prefix, config=FLAGSHIP, device=None,
                             serve_requests=REQUESTS, batch=TRAIN_B,
                             seq=TRAIN_S):
    """``fused_qkv`` at the flagship's width: see the module docstring,
    phase 30.  ``prefix`` is :func:`phase_prefix_serve_flagship`'s
    record (its rows and f32 paged tokens without a cache)."""
    import dataclasses
    import tempfile

    from tensorflowonspark_tpu_torch import checkpoint, convert, optim
    from tensorflowonspark_tpu_torch import serving
    from tensorflowonspark_tpu_torch.models import transformer
    from tensorflowonspark_tpu_torch.parallel import dp

    dev = torch.device(device or "cuda")
    over = {} if device is None else {"device": device}
    t_phase = time.perf_counter()
    fused = fuse_qkv_tree(tree)
    problems, line = [], {}
    # 1. f32 logits, TF32 off, against the unfused model on the same
    # weights (flash attention: K2's f32 path in both)
    cfg32 = transformer.TransformerConfig(**dict(
        config, dtype="float32", attention_impl="flash"))
    tokens = torch.from_numpy(np.random.default_rng(51).integers(
        0, config["vocab_size"], (2, 1024))).to(dev)
    with torch.no_grad():
        model = convert.params_from_flax(tree, cfg32, device=dev)
        ref = model(tokens)
        del model
        model = convert.params_from_flax(
            fused, dataclasses.replace(cfg32, fused_qkv=True), device=dev)
        got = model(tokens)
        del model
    err = row_relative_error(got, ref)
    line["f32_logits"] = dict(rows=2, seq=1024, row_relative_error=err,
                              tol=FUSED_F32_ROW_REL,
                              max_abs_err=(got - ref).abs().max().item())
    if not err <= FUSED_F32_ROW_REL:
        problems.append("fused f32 logits {0} row-relative from the "
                        "unfused model's".format(err))
    del got, ref, tokens
    gc_collect()

    # 2. bf16 flash training steps over f32 masters: K2-K4 each layer
    cfg = transformer.TransformerConfig(**dict(
        config, attention_impl="flash", fused_qkv=True))
    model = convert.params_from_flax(fused, cfg, device=dev,
                                     param_dtype=torch.float32)
    trainer = dp.SyncTrainer(transformer.loss_fn(model), optim.adamw(1e-4))
    state = trainer.create_state(dict(model.named_parameters()))
    rng = np.random.default_rng(52)
    losses = []
    reset_launches()
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(FUSED_TRAIN_STEPS):
        state, metrics = trainer.step(state, {"tokens": torch.from_numpy(
            rng.integers(0, cfg.vocab_size, (batch, seq)).astype(
                np.int32)).to(dev)})
        losses.append(metrics["loss"].item())
    sync(dev)
    train_sec = time.perf_counter() - t0
    launches = {k: v for k, v in read_launches().items()
                if k in ("fwd", "dq", "dkv")}
    want = cfg.num_layers * FUSED_TRAIN_STEPS
    line["train"] = dict(steps=FUSED_TRAIN_STEPS, batch=[batch, seq],
                         losses=losses, wall_sec=train_sec,
                         launches=launches, launches_expected=want)
    if launches != {"fwd": want, "dq": want, "dkv": want} \
            or not all(np.isfinite(losses)):
        problems.append("fused training: launches {0} (want {1} each), "
                        "losses {2}".format(launches, want, losses))
    del model, trainer, state, metrics
    gc_collect()

    # 3. the fused export served through the paged prefix-cache engine:
    # the unfused f32 model's greedy tokens (near ties apart)
    rows = prefix["rows"][:serve_requests]
    want_tokens = prefix["f32_paged_tokens"][:serve_requests]
    tmp = tempfile.mkdtemp(prefix="fused_export_")
    try:
        export = os.path.join(tmp, "export")
        t0 = time.perf_counter()
        checkpoint.save_for_serving(export, fused, extra_metadata={
            "model_ref": PIPELINE_MODEL_REF,
            "model_config": dict(config, **SERVING, **PREFIX,
                                 dtype="float32", fused_qkv=True)})
        export_sec = time.perf_counter() - t0
        predict = serving.load_predictor(export, use_cache=False,
                                         config_overrides=over or None)
        out, stats, wall, k1, _ = serve_job(predict, rows, dev)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    ok, ties = tie_gate(lambda: convert.params_from_flax(
        tree, transformer.TransformerConfig(**dict(config, dtype="float32")),
        device=dev), rows, tokens_of(out), want_tokens)
    share, firsts = agreement(tokens_of(out), want_tokens)
    steps = stats["chunks"] * SERVING["chunk_size"]
    line["export_serve"] = dict(
        requests=len(rows), export_sec=export_sec, wall_sec=wall,
        prefix_hits=stats["prefix_hits"], equal_share=share,
        first_differing_steps=firsts, near_ties=ties,
        paged_attention_launches=k1, decode_steps=steps)
    if not ok or k1 != config["num_layers"] * steps:
        problems.append("fused export serving: tokens {0} / ties {1}, K1 "
                        "{2}".format(share, ties, k1))
    del predict
    gc_collect()
    line.update(phase_sec=time.perf_counter() - t_phase,
                device=device_name(dev), nvidia_smi=nvidia_smi_or_cpu(dev),
                ok=not problems, problems=problems)
    emit("fused_qkv_flagship", **line)
    if problems:
        raise AssertionError("fused_qkv_flagship: " + "; ".join(problems))
    return line


# ----------------------------------------------------------------------
# the vision and MNIST workloads (phases 24-26)
# ----------------------------------------------------------------------

#: the JAX package's builders, which the port resolves to its own
MNIST_MODEL_REF = "tensorflowonspark_tpu.models.mlp:serving_builder"
RESNET_MODEL_REF = "tensorflowonspark_tpu.models.resnet:serving_builder"
UNET_MODEL_REF = "tensorflowonspark_tpu.models.unet:serving_builder"
#: rows of ``mnist_spark_flagship`` (the example's synthetic default) and
#: the example's batch
MNIST_ROWS, MNIST_BATCH = 4096, 64
#: bench.py's two ResNet workloads: (name, arch config, input size,
#: classes, FLOPs per image of a training step as bench.py counts them)
RESNET_WORKLOADS = [
    ("resnet56", {"arch": "cifar", "depth": 56, "num_classes": 10}, 32,
     10, 0.357e9),
    ("resnet50", {"arch": "resnet50", "num_classes": 1000}, 224, 1000,
     12.3e9),
]
RESNET_BATCH, RESNET_WARMUP, RESNET_TIMED = 128, 3, 10
#: ResNet56's f32 eval forward on the card against the CPU's (TF32 off)
RESNET_F32_ROW_REL = 1e-4
#: UNet at its documented 128x128x3 input, batch 16
UNET_HW, UNET_BATCH, UNET_WARMUP, UNET_TIMED = 128, 16, 3, 20
#: a top-2 logit gap under this share of the logit spread is a near tie,
#: where two bf16 forwards may disagree
VISION_NEAR_TIE = 1e-3


def sync(device):
    """Wait for ``device`` (a no-op on the CPU, where the vision phases
    are rehearsed with ``device="cpu"``)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def device_name(device):
    device = torch.device(device)
    return torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"


def synthetic_mnist(n, seed=0):
    """Learnable synthetic digits (``examples/mnist/mnist_data_setup.py``'s
    ``synthetic_mnist``): label k lights a 7x4 patch at column block k of
    the 28x28 canvas, plus noise."""
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 10, size=n).astype(np.int64)
    images = rng.uniform(0.0, 0.3, size=(n, 28, 28)).astype(np.float32)
    for i, k in enumerate(labels):
        r, c = divmod(int(k), 5)
        images[i, 7 + r * 10:14 + r * 10, c * 5:c * 5 + 4] += 0.7
    return images.reshape(n, 784), labels


def synthetic_shapes(n, size, seed=0):
    """Learnable synthetic segmentation data
    (``examples/segmentation/segmentation_tpu.py``'s ``synthetic_shapes``):
    a bright rectangle on noise, mask 1 inside, 2 on its border, 0 off."""
    rng = np.random.RandomState(seed)
    images = rng.uniform(0, 0.3, size=(n, size, size, 3)).astype(np.float32)
    masks = np.zeros((n, size, size), np.int32)
    for i in range(n):
        h, w = rng.randint(size // 4, size // 2, size=2)
        r, c = rng.randint(0, size - h), rng.randint(0, size - w)
        images[i, r:r + h, c:c + w] += 0.6
        masks[i, r:r + h, c:c + w] = 1
        masks[i, r, c:c + w] = 2
        masks[i, r + h - 1, c:c + w] = 2
        masks[i, r:r + h, c] = 2
        masks[i, r:r + h, c + w - 1] = 2
    return images, masks


def mnist_spark_fn(args, ctx):
    """``examples/mnist/mnist_spark.py``'s ``main_fun`` on the port, in
    the compute process: ``MNISTNet`` under ``adam(1e-3)`` with
    ``has_aux=True`` through ``train_on_feed(columnar=True)`` (dropout
    from a seeded generator), ``save_for_serving`` of the trained weights,
    and the in-memory model's predictions on ``args["test"]``; writes
    them, the losses and the timings to ``args["out"]``."""
    t_start = time.perf_counter()
    from tensorflowonspark_tpu_torch import compat, optim
    from tensorflowonspark_tpu_torch.checkpoint import save_for_serving
    from tensorflowonspark_tpu_torch.models import mlp
    from tensorflowonspark_tpu_torch.parallel import dp

    device = compat.resolve_device(args.get("device"))
    ctx.initialize_distributed()
    torch.manual_seed(0)
    model = mlp.MNISTNet(device=device)
    trainer = dp.SyncTrainer(mlp.loss_fn(model), optim.adam(1e-3),
                             has_aux=True)
    state = trainer.create_state(dict(model.named_parameters()))

    def preprocess(cols):
        images, labels = cols
        return {"image": np.asarray(images, np.float32),
                "label": np.asarray(labels, np.int64).reshape(-1)}

    losses, marks = [], []
    state = trainer.train_on_feed(
        state, ctx.get_data_feed(train_mode=True), batch_size=args["batch"],
        preprocess=preprocess, columnar=True,
        rng=torch.Generator(device=device).manual_seed(0),
        step_callback=lambda step: marks.append(time.perf_counter()),
        metrics_callback=lambda step, m: losses.append(m["loss"]))
    sync(device)
    t_end = time.perf_counter()
    save_for_serving(args["export"], mlp.tree_from_model(model)["params"],
                     extra_metadata={"model_ref": MNIST_MODEL_REF,
                                     "model_config": {"input_name": "image"}})
    with torch.no_grad():
        logits = model(torch.from_numpy(np.load(args["test"])).to(device))
    with open(args["out"], "w") as f:
        json.dump(dict(
            losses=torch.stack(losses).float().cpu().numpy().tolist(),
            steps=int(state.step), first_step_sec=marks[1] - t_start,
            train_sec=t_end - marks[1], logits=logits.cpu().numpy().tolist(),
            device=device_name(device), pid=os.getpid()), f)


def phase_mnist_spark_flagship(device=None):
    """``mnist_spark.py``'s flow on the port: see the module docstring,
    phase 24.  ``device="cpu"`` rehearses it without a card."""
    import importlib
    import tempfile

    from tensorflowonspark_tpu_torch import serving

    smoke = importlib.import_module("chip_smoke")
    x, y = synthetic_mnist(MNIST_ROWS)
    rows = [(x[i], int(y[i])) for i in range(len(x))]
    test_x, test_y = synthetic_mnist(256, seed=1)
    tmp = tempfile.mkdtemp(prefix="mnist_")
    args = {"batch": MNIST_BATCH, "out": os.path.join(tmp, "result.json"),
            "export": os.path.join(tmp, "export"),
            "test": os.path.join(tmp, "test.npy"), "device": device}
    np.save(args["test"], test_x)
    startup, train_sec, error = feed_cluster(smoke.mnist_spark_fn, args,
                                             rows, epochs=1)
    if error is not None:
        raise error
    with open(args["out"]) as f:
        res = json.load(f)
    t0 = time.perf_counter()
    served = serving.load_predictor(
        args["export"], use_cache=False,
        config_overrides={"device": device} if device else None)(
        {"image": test_x})
    serve_sec = time.perf_counter() - t0
    shutil.rmtree(tmp, ignore_errors=True)
    losses = np.asarray(res["losses"])
    logits = np.asarray(res["logits"], np.float32)
    want = logits.argmax(-1)
    steps = res["steps"]
    line = dict(
        rows=len(rows), batch=MNIST_BATCH, steps=steps,
        steps_per_sec=(steps - 1) / res["train_sec"],
        rows_per_sec=(steps - 1) * MNIST_BATCH / res["train_sec"],
        first_step_sec=res["first_step_sec"], cluster_startup_sec=startup,
        train_call_sec=train_sec, serve_sec=serve_sec,
        loss_first8=float(losses[:8].mean()),
        loss_last8=float(losses[-8:].mean()),
        served_equal_share=float(np.mean(served["prediction"] == want)),
        served_logits_max_abs_diff=float(np.abs(
            served["logits"] - logits).max()),
        served_accuracy=float(np.mean(served["prediction"] == test_y)),
        compute_device=res["device"], compute_pid=res["pid"],
        driver_pid=os.getpid(), nvidia_smi=nvidia_smi())
    emit("mnist_spark_flagship", **line)
    if steps != MNIST_ROWS // MNIST_BATCH or len(losses) != steps:
        raise AssertionError("{0} steps, {1} losses, want {2}".format(
            steps, len(losses), MNIST_ROWS // MNIST_BATCH))
    if not np.isfinite(losses).all() or \
            not losses[-8:].mean() < 0.5 * losses[:8].mean():
        raise AssertionError("the MNIST loss did not fall: {0}".format(
            losses.tolist()))
    if not np.array_equal(served["prediction"], want):
        raise AssertionError("served predictions differ from the in-memory "
                             "model's in {0} of {1} rows".format(
                                 int(np.sum(served["prediction"] != want)),
                                 len(want)))
    if res["pid"] == os.getpid():
        raise AssertionError("the fn ran in the driver process")
    return line


def agree_but_near_ties(got, want, logits):
    """``(share equal, ok)``: ``ok`` when two predictions of ``[..., K]``
    logits agree wherever ``logits``' top-2 gap is at least
    :data:`VISION_NEAR_TIE` of its spread."""
    top = np.sort(logits, axis=-1)
    spread = float(logits.max() - logits.min())
    clear = (top[..., -1] - top[..., -2]) >= VISION_NEAR_TIE * spread
    return float(np.mean(got == want)), bool(
        np.array_equal(got[clear], want[clear]))


def export_and_serve(tree, ref, config, images, device=None):
    """``save_for_serving`` of a Flax tree under ``ref`` and ``config``,
    ``serving.load_predictor`` on the card, and its outputs on
    ``images``: ``(outputs, bytes on disk, export sec, load + serve
    sec)``."""
    import tempfile

    from tensorflowonspark_tpu_torch import checkpoint, serving

    tmp = tempfile.mkdtemp(prefix="vision_export_")
    try:
        t0 = time.perf_counter()
        path = checkpoint.save_for_serving(
            os.path.join(tmp, "export"), tree,
            extra_metadata={"model_ref": ref, "model_config": config})
        t1 = time.perf_counter()
        out = serving.load_predictor(
            path, use_cache=False,
            config_overrides={"device": device} if device else None)(
            {"image": images})
        t2 = time.perf_counter()
        return out, tree_bytes(path), t1 - t0, t2 - t1
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def resnet_f32_card_vs_cpu(model, device):
    """``(row-relative error, rows)``: ResNet56's f32 eval forward of
    ``model``'s weights on the card (TF32 off for it) against the same
    weights' f32 forward on the CPU, on 8 images."""
    from tensorflowonspark_tpu_torch.models import resnet

    tree = resnet.tree_from_model(model)
    x = torch.from_numpy(np.random.default_rng(3).random(
        (8, 32, 32, 3), dtype=np.float32))
    outs = []
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        for dev in (device, "cpu"):
            m = resnet.params_from_flax(tree, resnet.ResNetCIFAR(
                depth=56, dtype="float32", device=dev))
            with torch.no_grad():
                outs.append(m(x.to(dev)).cpu())
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    return row_relative_error(outs[0], outs[1]), x.shape[0]


def resnet_train(name, config, hw, classes, flops, device=None):
    """bench.py's ResNet workload ``name`` on the port: see the module
    docstring, phase 25.  Returns the emitted line."""
    from tensorflowonspark_tpu_torch import compat, optim
    from tensorflowonspark_tpu_torch.models import resnet
    from tensorflowonspark_tpu_torch.parallel import dp

    device = compat.resolve_device(device)
    torch.manual_seed(0)
    if config["arch"] == "resnet50":
        model = resnet.ResNet50(num_classes=classes, device=device)
        dataset_size = 1281167
    else:
        model = resnet.ResNetCIFAR(depth=config["depth"], device=device)
        dataset_size = 50000
    # resnet_cifar_tpu.py's schedule: 0.1, /10 at epochs 91 and 136
    spe = max(1, dataset_size // RESNET_BATCH)
    schedule = optim.piecewise_constant_schedule(
        0.1, {91 * spe: 0.1, 136 * spe: 0.1})
    trainer = dp.SyncTrainer(resnet.loss_fn(model),
                             optim.sgd(schedule, momentum=0.9),
                             has_model_state=True)
    state = trainer.create_state(dict(model.named_parameters()),
                                 {"batch_stats": dict(model.named_buffers())})
    # the example's synthetic batch (common.py's synthetic input mode)
    rng = np.random.RandomState(0)
    x = rng.rand(RESNET_BATCH, hw, hw, 3).astype(np.float32)
    y = (np.arange(RESNET_BATCH) % classes).astype(np.int32)
    batch = (torch.from_numpy(x).to(device), torch.from_numpy(y).to(device))
    before = {k: v.clone() for k, v in model.named_buffers()}
    sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    losses = []
    t0 = time.perf_counter()
    for _ in range(RESNET_WARMUP):
        state, metrics = trainer.step_on_device(state, batch)
        losses.append(metrics["loss"])
    sync(device)
    t1 = time.perf_counter()
    for _ in range(RESNET_TIMED):
        state, metrics = trainer.step_on_device(state, batch)
        losses.append(metrics["loss"])
    sync(device)
    timed = time.perf_counter() - t1
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" \
        else None
    losses = torch.stack(losses).float().cpu().numpy()
    moved = max((v - before[k]).abs().max().item()
                for k, v in model.named_buffers())
    images_per_sec = RESNET_BATCH * RESNET_TIMED / timed
    # the export against the in-memory eval forward, on 32 of the images
    with torch.no_grad():
        logits = model(batch[0][:32]).float().cpu().numpy()
    served, nbytes, export_sec, serve_sec = export_and_serve(
        resnet.tree_from_model(model), RESNET_MODEL_REF, config, x[:32],
        device)
    share, agree = agree_but_near_ties(served["prediction"],
                                       logits.argmax(-1), logits)
    f32_err, f32_rows = (resnet_f32_card_vs_cpu(model, device)
                         if name == "resnet56" else (None, 0))
    line = dict(
        workload=name, batch=RESNET_BATCH, image_size=hw,
        params=sum(p.numel() for p in model.parameters()),
        dtype=str(model.dtype), warmup_steps=RESNET_WARMUP,
        warmup_sec=t1 - t0, timed_steps=RESNET_TIMED, timed_sec=timed,
        step_ms=1e3 * timed / RESNET_TIMED, images_per_sec=images_per_sec,
        flops_per_image=flops, peak_flops=BF16_FLOPS_PER_SEC,
        peak_source="H100 SXM dense bf16, NVIDIA data sheet",
        mfu=images_per_sec * flops / BF16_FLOPS_PER_SEC,
        losses=losses.tolist(), batch_stats_max_move=moved,
        peak_memory_bytes=peak, export_bytes=nbytes, export_sec=export_sec,
        load_and_serve_sec=serve_sec, served_equal_share=share,
        served_logits_max_abs_diff=float(np.abs(
            served["logits"] - logits).max()),
        f32_card_vs_cpu_row_rel=f32_err, f32_rows=f32_rows,
        device=device_name(device), nvidia_smi=nvidia_smi())
    emit("resnet_train_flagship", **line)
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        raise AssertionError("{0} loss did not fall: {1}".format(
            name, losses.tolist()))
    if not moved > 0:
        raise AssertionError("{0}: the running statistics did not "
                             "move".format(name))
    if not agree:
        raise AssertionError("{0}: served predictions differ from the "
                             "in-memory forward off near ties".format(name))
    if f32_err is not None and not f32_err <= RESNET_F32_ROW_REL:
        raise AssertionError("ResNet56 f32 on the card is {0} row-relative "
                             "from the CPU".format(f32_err))
    del model, trainer, state, batch
    gc_collect()
    return line


def phase_resnet_train_flagship(device=None):
    """ResNet56 and ResNet50 at batch 128: see the module docstring,
    phase 25."""
    return {w[0]: resnet_train(*w, device=device) for w in RESNET_WORKLOADS}


def phase_segmentation_flagship(device=None):
    """UNet at 128x128x3, batch 16, ``adam(1e-3)``: see the module
    docstring, phase 26."""
    from tensorflowonspark_tpu_torch import compat, optim
    from tensorflowonspark_tpu_torch.models import unet
    from tensorflowonspark_tpu_torch.parallel import dp

    device = compat.resolve_device(device)
    x, m = synthetic_shapes(512, UNET_HW)
    torch.manual_seed(0)
    model = unet.UNet(num_classes=3, device=device)
    trainer = dp.SyncTrainer(unet.loss_fn(model), optim.adam(1e-3),
                             has_aux=True)
    state = trainer.create_state(dict(model.named_parameters()))
    images = torch.from_numpy(x).to(device)
    masks = torch.from_numpy(m).to(device)
    losses = []

    def step(i):
        # the example's loop over the data
        lo = (i * UNET_BATCH) % max(1, len(x) - UNET_BATCH)
        return trainer.step_on_device(state, {
            "image": images[lo:lo + UNET_BATCH],
            "mask": masks[lo:lo + UNET_BATCH]})

    sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for i in range(UNET_WARMUP):
        state, metrics = step(i)
        losses.append(metrics["loss"])
    sync(device)
    t1 = time.perf_counter()
    for i in range(UNET_WARMUP, UNET_WARMUP + UNET_TIMED):
        state, metrics = step(i)
        losses.append(metrics["loss"])
    sync(device)
    timed = time.perf_counter() - t1
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" \
        else None
    losses = torch.stack(losses).float().cpu().numpy()
    with torch.no_grad():
        logits = model(images[:UNET_BATCH]).float().cpu().numpy()
    served, nbytes, export_sec, serve_sec = export_and_serve(
        unet.tree_from_model(model)["params"], UNET_MODEL_REF,
        {"num_classes": 3}, x[:UNET_BATCH], device)
    share, agree = agree_but_near_ties(served["mask"], logits.argmax(-1),
                                       logits)
    line = dict(
        image_size=UNET_HW, batch=UNET_BATCH,
        params=sum(p.numel() for p in model.parameters()),
        warmup_steps=UNET_WARMUP, warmup_sec=t1 - t0, timed_steps=UNET_TIMED,
        timed_sec=timed, step_ms=1e3 * timed / UNET_TIMED,
        images_per_sec=UNET_BATCH * UNET_TIMED / timed,
        losses=losses.tolist(), peak_memory_bytes=peak, export_bytes=nbytes,
        export_sec=export_sec, load_and_serve_sec=serve_sec,
        served_mask_equal_share=share,
        served_logits_max_abs_diff=float(np.abs(
            served["logits"] - logits).max()),
        device=device_name(device), nvidia_smi=nvidia_smi())
    emit("segmentation_flagship", **line)
    first, last = losses[:UNET_WARMUP].mean(), losses[-UNET_WARMUP:].mean()
    if not np.isfinite(losses).all() or not last < first:
        raise AssertionError("the UNet loss did not fall: {0}".format(
            losses.tolist()))
    if not agree:
        raise AssertionError("the served mask differs from the in-memory "
                             "argmax off near ties")
    del model, trainer, state
    gc_collect()
    return line


# ----------------------------------------------------------------------
# prefill/decode disaggregation and speculation (phases 32 and 33)
# ----------------------------------------------------------------------

#: the split phase's fault job: the chaos plan leaks a one-page handoff
#: lease of this deadline and kills the prefill worker at the same
#: prefill, under a prefill watchdog no prefill comes near; it serves
#: the first slots' worth of the requests (one wave, to keep
#: ``phase_times`` in its budget)
DISAGG_LEAK_DEADLINE, DISAGG_WATCHDOG_SEC = 0.5, 30.0
DISAGG_FAULT_REQUESTS = SLOTS
#: the speculation phase: requests (the first of the 16) and their new
#: tokens, the draft's layers (the flagship's first) and its drafts per
#: round; the static rows, their motif, its repeats and the new tokens
#: (32, cut from 64 to keep ``phase_times`` in its budget)
SPEC_REQUESTS, SPEC_NEW, SPEC_DRAFT_LAYERS, SPEC_DRAFT_LEN = 8, 32, 2, 4
#: its continuous chunks: 8 steps, or 8 speculative rounds (a chunk runs
#: all its rounds, done slots included)
SPEC_CHUNK = 8
SPEC_STATIC_ROWS, SPEC_MOTIF, SPEC_REPEATS, SPEC_STATIC_NEW = 8, 32, 8, 32


class AdoptLog(object):
    """Counts a decoder's adopts, and records each one that touched a
    pool (storage or version)."""

    def __init__(self, dec):
        self.dec, self.adopts, self.moved = dec, 0, []
        pools = [t for layer in dec.cache for t in layer.values()]

        def adopt(slot, handoff, _orig=dec.adopt):
            before = [(t.data_ptr(), t._version) for t in pools]
            first = _orig(slot, handoff)
            self.adopts += 1
            if before != [(t.data_ptr(), t._version) for t in pools]:
                self.moved.append(self.adopts)
            return first

        dec.adopt = adopt

    def detach(self):
        del self.dec.adopt


def adopt_launches(dec, prompt):
    """One adopt of ``prompt``'s handoff into slot 0 of an idle decoder,
    on its own: the ops it dispatched to the device's backend (those
    that are not views), the device ops ``torch.profiler`` saw on a card
    (kernels, copies and fills, by name), the decoder's own count
    (``last_adopt_dispatches``), and whether a pool's storage or version
    moved.  The slot is evicted again after."""
    import contextlib

    from torch.utils._python_dispatch import TorchDispatchMode

    from tensorflowonspark_tpu_torch.serving_disagg import PrefillWorker

    class Dispatched(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not func.is_view:
                self.ops.append(str(func))
            return func(*args, **(kwargs or {}))

    pools = [t for layer in dec.cache for t in layer.values()]
    handoff = PrefillWorker(dec).prefill(prompt)
    sync(dec.device)
    before = [(t.data_ptr(), t._version) for t in pools]
    prof = contextlib.nullcontext()
    if dec.device.type == "cuda":
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CUDA])
    with prof as p, Dispatched() as seen:
        dec.adopt(0, handoff)
        sync(dec.device)
    device_ops = None
    if p is not None:
        device_ops = {}
        for e in p.key_averages():
            if (e.device_type == torch.autograd.DeviceType.CUDA
                    and not getattr(e, "is_user_annotation", False)):
                device_ops[e.key[:80]] = (device_ops.get(e.key[:80], 0)
                                          + e.count)
    moved = before != [(t.data_ptr(), t._version) for t in pools]
    dec.evict(0)
    return dict(
        dispatched=seen.ops, counted=dec.last_adopt_dispatches,
        device_ops=device_ops,
        launches=None if device_ops is None else sum(device_ops.values()),
        pool_moved=moved)


def pool_left(dec):
    """What a quiesced decoder without a radix cache must not hold: live
    pages, pages in flight, leases."""
    st = dec.page_pool.stats()
    return dict(census_pages=len(dec.page_pool.refcount_census()),
                pool_pages_handoff=st["pool_pages_handoff"],
                pool_leases=st["pool_leases"])


def phase_disagg_serve_flagship(tree, config=FLAGSHIP, device=None,
                                requests=REQUESTS,
                                leak_deadline=DISAGG_LEAK_DEADLINE):
    """Prefill/decode disaggregation at the flagship's width: see the
    module docstring, phase 32.  ``leak_deadline`` is the leaked lease's
    (a rehearsal's job may end before the card's does)."""
    import tempfile

    from tensorflowonspark_tpu_torch import forensics
    from tensorflowonspark_tpu_torch import telemetry
    from tensorflowonspark_tpu_torch.models.transformer import (
        serving_builder,
    )
    from tensorflowonspark_tpu_torch.telemetry import blackbox
    from tensorflowonspark_tpu_torch.testing import chaos

    dev = torch.device(device or "cuda")
    over = {} if device is None else {"device": device}
    layers, chunk = config["num_layers"], SERVING["chunk_size"]
    rows = make_requests(np.random.default_rng(2), requests,
                         config["vocab_size"], 16, SERVING["max_prompt_len"])
    t_phase = time.perf_counter()
    # one slot's span of spare pages: without them the leaked page would
    # fail the eighth admit of the first pass, before any reaping
    m = SERVING["pad_multiple"]
    span = -(-min(config["max_seq_len"], -(-SERVING["max_prompt_len"] // m)
                  * m + SERVING["max_new_tokens"])
             // SERVING["kv_page_tokens"])
    predict = serving_builder(tree, dict(config, **SERVING, **over,
                                         kv_pages=(SLOTS + 1) * span + 1))
    dec = predict.make_slot_decoder(SLOTS)
    if dec.page_pool.num_pages != (SLOTS + 1) * dec._blocks_per_slot + 1:
        raise AssertionError("disagg_serve_flagship: pool of {0} pages for "
                             "{1} blocks a slot".format(
                                 dec.page_pool.num_pages,
                                 dec._blocks_per_slot))
    log = AdoptLog(dec)
    problems, jobs = [], {}
    tmp = tempfile.mkdtemp(prefix="disagg_")
    journal = telemetry.get_journal()
    recorder = None
    try:
        for name, kw in (("unified", {}), ("split", {"disaggregate": True}),
                         ("faults", {"disaggregate": True,
                                     "watchdog_timeout":
                                     DISAGG_WATCHDOG_SEC})):
            if name == "faults":
                # this job's events alone, in the export and the bundles
                journal.clear()
                recorder = blackbox.FlightRecorder(
                    journal=journal, tracer=telemetry.get_tracer(),
                    dump_dir=os.path.join(tmp, "blackbox"),
                    min_interval=0.0).start()
                plan = chaos.ChaosPlan().leak_lease(
                    1, deadline_sec=leak_deadline).kill_prefill(1)
                os.environ[chaos.TFOS_CHAOS_PLAN] = plan.save(
                    os.path.join(tmp, "plan.json"))
            adopts0 = log.adopts
            jrows = (rows[:DISAGG_FAULT_REQUESTS] if name == "faults"
                     else rows)
            out, stats, wall, k1, _ = serve_job(predict, jrows, dev, **kw)
            rec = job_record(stats, wall, k1, chunk)
            rec.update(adopts=log.adopts - adopts0,
                       decode_tokens_per_sec=stats["tokens_out"]
                       / stats["decode_wall_sec"],
                       leases_reaped=stats["leases_reaped"],
                       prefill_worker_deaths=stats["prefill_worker_deaths"],
                       prefill_restarts=stats["prefill_restarts"],
                       left=pool_left(dec), tokens=tokens_of(out))
            jobs[name] = rec
            if k1 != layers * rec["decode_steps"] or not k1:
                problems.append("{0}: K1 launches {1} != {2} x {3}".format(
                    name, k1, layers, rec["decode_steps"]))
            if len(out) != len(jrows) or any("error" in r for r in out):
                problems.append(name + ": a request failed")
            if any(rec["left"].values()):
                problems.append("{0}: the pool holds {1} after the "
                                "job".format(name, rec["left"]))
        if jobs["split"]["adopts"] != requests or log.moved:
            problems.append("adopts {0} of {1} requests; adopts that "
                            "moved a pool: {2}".format(
                                jobs["split"]["adopts"], requests,
                                log.moved))
        for name in ("split", "faults"):
            want = jobs["unified"]["tokens"][:len(jobs[name]["tokens"])]
            share, firsts = agreement(jobs[name]["tokens"], want)
            jobs[name]["equal_unified_share"] = share
            if share != 1.0:
                problems.append("{0}: tokens differ from the unified "
                                "engine's at steps {1}".format(name, firsts))
        fj = jobs["faults"]
        if fj["prefill_worker_deaths"] != 1 or fj["leases_reaped"] < 2:
            problems.append("faults: {0} worker deaths, {1} leases "
                            "reaped".format(fj["prefill_worker_deaths"],
                                            fj["leases_reaped"]))
        # forensics over the journal's export and the recorder's bundles
        export = os.path.join(tmp, "journal_export.json")
        with open(export, "w") as f:
            json.dump({"events": [e.to_dict() for e in journal.events()]},
                      f)
        bundles = os.path.join(tmp, "blackbox")
        report = forensics.explain([export, bundles])
        cli = subprocess.run(
            [sys.executable, "-m", "tensorflowonspark_tpu_torch.forensics",
             "explain", export, bundles], capture_output=True, text=True,
            timeout=120)
        incident = report["incident"] or {}
        forensic = dict(
            fault_kind=incident.get("fault_kind"),
            trigger=incident.get("trigger"),
            events_by_kind=report["events_by_kind"],
            bundles=len(recorder.dumps), cli_rc=cli.returncode,
            cli_names_kill_prefill="kill_prefill" in cli.stdout)
        if (forensic["fault_kind"] != "kill_prefill"
                or forensic["trigger"] != "prefill_worker_dead"
                or not forensic["cli_names_kill_prefill"]
                or not recorder.dumps
                or "lease_reaped" not in report["events_by_kind"]):
            problems.append("forensics: {0}".format(forensic))
    finally:
        log.detach()
        os.environ.pop(chaos.TFOS_CHAOS_PLAN, None)
        if recorder is not None:
            recorder.stop()
        shutil.rmtree(tmp, ignore_errors=True)
    # the adopt's device work: the state writes the decoder counts and
    # nothing on a pool
    adopt = adopt_launches(dec, rows[0]["tokens"])
    if (len(adopt["dispatched"]) != adopt["counted"]
            or adopt["pool_moved"] or any(pool_left(dec).values())):
        problems.append("adopt: {0}, the pool holds {1}".format(
            adopt, pool_left(dec)))
    for rec in jobs.values():
        del rec["tokens"]
    line = dict(
        requests=requests, slots=SLOTS, jobs=jobs, forensics=forensic,
        adopt=adopt,
        launches=jobs["split"]["paged_attention_launches"],
        phase_sec=time.perf_counter() - t_phase, device=device_name(dev),
        nvidia_smi=nvidia_smi_or_cpu(dev), ok=not problems,
        problems=problems)
    del predict, dec
    gc_collect()
    emit("disagg_serve_flagship", **line)
    if problems:
        raise AssertionError("disagg_serve_flagship: "
                             + "; ".join(problems))
    return line


def draft_tree(tree, layers):
    """The flagship's embedding, first ``layers`` blocks, final norm and
    head: a draft cut from the model it drafts for."""
    out = {k: tree[k] for k in ("embedding", "ln_f", "lm_head")}
    out.update({"block_%d" % i: tree["block_%d" % i] for i in range(layers)})
    return out


def spec_jobs(tree, base, rows, dev, drafts, plains=None):
    """The continuous schedule over ``rows`` without speculation
    (``"plain"``, and each of ``plains``, ``{name: knobs}``) and with
    each of ``drafts``, ``{name: (draft config, draft tree)}``: each
    job's record and tokens, and the plain predictor."""
    from tensorflowonspark_tpu_torch.models.transformer import (
        serving_builder,
    )

    out = {}
    plain = None
    variants = [("plain", {})] + list((plains or {}).items()) + [
        (name, dict(draft_config=cfg, draft_params=dtree,
                    draft_len=SPEC_DRAFT_LEN))
        for name, (cfg, dtree) in drafts.items()]
    for name, extra in variants:
        predict = serving_builder(tree, dict(base, **extra))
        got, stats, wall, k1, _ = serve_job(predict, rows, dev)
        rec = job_record(stats, wall, k1, base["chunk_size"])
        rec.update(tokens=tokens_of(got),
                   errors=sum("error" in r for r in got))
        if name in drafts:
            rec.update(spec_accepted=stats["spec_accepted"],
                       spec_proposed=stats["spec_proposed"],
                       spec_accept_rate=stats["spec_accept_rate"],
                       rounds=stats["chunks"] * base["chunk_size"])
        if name == "plain":
            plain = predict
        else:
            del predict
        out[name] = rec
    return out, plain


def phase_spec_serve_flagship(tree, config=FLAGSHIP, device=None,
                              requests=SPEC_REQUESTS):
    """Speculative decoding at the flagship's width: see the module
    docstring, phase 33."""
    from tensorflowonspark_tpu_torch import serving
    from tensorflowonspark_tpu_torch.models.transformer import (
        serving_builder,
    )

    dev = torch.device(device or "cuda")
    over = {} if device is None else {"device": device}
    vocab = config["vocab_size"]
    rows = make_requests(np.random.default_rng(2), REQUESTS, vocab, 16,
                         SERVING["max_prompt_len"])[:requests]
    dtree = draft_tree(tree, SPEC_DRAFT_LAYERS)
    problems, line = [], dict(requests=requests, new_tokens=SPEC_NEW,
                              draft_layers=SPEC_DRAFT_LAYERS,
                              draft_len=SPEC_DRAFT_LEN)
    t_phase = time.perf_counter()
    f32_model = None
    layers = config["num_layers"]
    for dtype in ("float32", "bfloat16"):
        base = dict(config, **dict(SERVING, max_new_tokens=SPEC_NEW,
                                   chunk_size=SPEC_CHUNK),
                    dtype=dtype, **over)
        drafts = {"speculative": (dict(config, num_layers=SPEC_DRAFT_LAYERS,
                                       dtype=dtype), dtree)}
        if dtype == "float32":
            # the model as its own draft: the accepted path, compaction
            # and the lookahead pages run on the card
            drafts["self_draft"] = (dict(config, dtype=dtype), tree)
        # bf16: plain decode through the gather path as well, the path
        # the verify blocks take, to tell the two paths' rounding apart
        # from a fault of the speculative path
        plains = ({} if dtype == "float32"
                  else {"plain_gather": {"paged_impl": "gather"}})
        jobs, plain = spec_jobs(tree, base, rows, dev, drafts, plains)
        rec = dict(jobs)
        want = jobs["plain"]["tokens"]
        for name in list(drafts) + list(plains):
            share, firsts = agreement(jobs[name]["tokens"], want)
            rec[name].update(equal_share=share,
                             first_differing_steps=firsts)
        if plains:
            for name in drafts:
                share, firsts = agreement(
                    jobs[name]["tokens"], jobs["plain_gather"]["tokens"])
                rec[name].update(equal_gather_share=share,
                                 first_differing_steps_gather=firsts)
            # the top-2 gap at each first difference from the plain (K1)
            # run, on the bf16 model's own forward
            bf16_model = plain.make_slot_decoder(SLOTS).model
            for name in list(drafts) + list(plains):
                _, ties = near_tie_check(bf16_model, rows,
                                         jobs[name]["tokens"], want)
                rec[name]["gaps_at_first_differences"] = ties
            del bf16_model
        if dtype == "float32":
            f32_model = plain.make_slot_decoder(SLOTS).model
            for name in drafts:
                ok, ties = tie_gate(lambda: f32_model, rows,
                                    jobs[name]["tokens"], want)
                rec[name]["near_ties"] = ties
                if not ok:
                    problems.append("f32 continuous {0}: speculative tokens "
                                    "differ beyond a near tie: {1}".format(
                                        name, ties))
            if not jobs["self_draft"]["spec_accepted"]:
                problems.append("f32 self-draft: nothing accepted")
        del plain
        for name in rec:
            del rec[name]["tokens"]
            if rec[name]["errors"]:
                problems.append("{0} {1}: a request failed".format(dtype,
                                                                   name))
            # the plain decode steps run K1, the verify blocks (several
            # tokens a slot) the gather path
            k1 = rec[name]["paged_attention_launches"]
            if name == "plain" and k1 != layers * rec[name]["decode_steps"] \
                    or name != "plain" and k1:
                problems.append("{0} {1}: K1 launches {2}".format(dtype,
                                                                  name, k1))
            if name in drafts and not rec[name]["spec_proposed"]:
                problems.append("{0} {1}: no draft proposed".format(dtype,
                                                                    name))
        line["continuous_" + dtype] = rec
        gc_collect()

    # static generate_speculative by prompt lookup on repeated motifs
    rng = np.random.default_rng(7)
    motifs = rng.integers(0, vocab, (SPEC_STATIC_ROWS, SPEC_MOTIF))
    srows = [{"tokens": np.tile(m, SPEC_REPEATS).astype(np.int32)}
             for m in motifs]
    base = dict(config, **dict(STATIC_SERVING,
                               max_new_tokens=SPEC_STATIC_NEW),
                dtype="float32", **over)
    static = {}
    for name, extra in (("plain", {}),
                        ("speculative", dict(speculative=True, ngram=2,
                                             draft_len=SPEC_DRAFT_LEN)),
                        # the model as its own draft: the accepted path
                        # (a rewind past one token, several tokens
                        # emitted a round) on the card
                        ("self_draft", dict(
                            speculative=True, draft_len=SPEC_DRAFT_LEN,
                            draft_config=dict(config, dtype="float32"),
                            draft_params=tree))):
        predict = serving_builder(tree, dict(base, **extra))
        sync(dev)
        t0 = time.perf_counter()
        out = list(serving.predict_rows(predict, [dict(r) for r in srows],
                                        SERVE_MAPPING,
                                        batch_size=SPEC_STATIC_ROWS))
        sync(dev)
        static[name] = dict(wall_sec=time.perf_counter() - t0,
                            tokens=tokens_of(out))
        if extra:
            st = predict.last_spec_stats
            static[name].update(st, tokens_per_round=SPEC_STATIC_NEW
                                / max(st["rounds"], 1))
        del predict
    want = static["plain"]["tokens"]
    for name in ("speculative", "self_draft"):
        ok, ties = tie_gate(lambda: f32_model, srows,
                            static[name]["tokens"], want)
        share, firsts = agreement(static[name]["tokens"], want)
        static[name].update(equal_share=share, first_differing_steps=firsts,
                            near_ties=ties)
        if not ok:
            problems.append("f32 static {0}: tokens differ beyond a near "
                            "tie: {1}".format(name, ties))
    if not static["self_draft"]["accepted"]:
        problems.append("f32 static self-draft: nothing accepted")
    for rec in static.values():
        rec["tokens_per_sec"] = sum(len(t) for t in rec.pop("tokens")) \
            / rec["wall_sec"]
    line["static"] = dict(static, rows=SPEC_STATIC_ROWS,
                          prompt_tokens=SPEC_MOTIF * SPEC_REPEATS)
    del f32_model
    gc_collect()
    line.update(phase_sec=time.perf_counter() - t_phase,
                device=device_name(dev), nvidia_smi=nvidia_smi_or_cpu(dev),
                ok=not problems, problems=problems)
    emit("spec_serve_flagship", **line)
    if problems:
        raise AssertionError("spec_serve_flagship: " + "; ".join(problems))
    return line


# ----------------------------------------------------------------------
# slice 20: the source system's own cluster roles (ps, evaluator,
# TensorBoard) and async-PS training
# ----------------------------------------------------------------------

#: ``examples/mnist/mnist_ps.py``'s flow: rows per worker, hidden width,
#: steps of this batch, the held-out rows the evaluator scores, the loss
#: windows compared (first vs last) and the optimizer
PS_MNIST_ROWS, PS_MNIST_HIDDEN, PS_MNIST_STEPS, PS_MNIST_BATCH = \
    2048, 128, 60, 64
PS_MNIST_EVAL_ROWS, PS_MNIST_WINDOW = 256, 10
PS_MNIST_OPT = ("adam", {"learning_rate": 1e-3})
#: a stand-in ``tensorboard`` (the card's machine has none, and nothing
#: may be installed): serves HTTP 200 on the ``--port`` it is given
TB_STUB = '''#!{python}
import http.server, sys
port = int([a for a in sys.argv if a.startswith("--port=")][0][7:])


class H(http.server.BaseHTTPRequestHandler):
    def do_GET(self):
        self.send_response(200)
        self.end_headers()
        self.wfile.write(b"tensorboard stub")

    def log_message(self, *a):
        pass


http.server.HTTPServer(("", port), H).serve_forever()
'''
#: the depth :func:`main` runs the serving engine's phases at
#: (``prefix_serve_flagship`` through ``spec_serve_flagship``: the radix,
#: the watchdog, hot swap, fused QKV, telemetry, the split and
#: speculation) and ``elastic_flagship``, the flagship's first blocks
#: (:func:`draft_tree`): they check the engine and the supervisor, not
#: the model's depth, and were cut from 16 layers to keep
#: ``phase_times`` in its budget when the async-PS phases came
CUT_LAYERS = 4
#: ``bench.py:3020`` ``ps_tpu_bench`` at the flagship's width: depth, the
#: one seeded batch, the optimizer, warm-up and timed steps, the PS
#: shards (spawned CPU processes) and the variants (``bench.py:3088-3106``)
PS_LM_LAYERS, PS_LM_B, PS_LM_S = 2, 4, 2048
PS_LM_OPT = ("sgd", {"learning_rate": 0.01})
PS_LM_TIMED, PS_LM_SHARDS = 6, 2
PS_LM_VARIANTS = {
    "async_pipelined": dict(pipeline=True),
    "async_unpipelined": dict(pipeline=False),
    "async_compressed": dict(overlap=True, codec="int8", reply_codec="same"),
}
#: ``async_compressed``'s pushed bytes per step over ``async_pipelined``'s
PS_LM_PUSH_RATIO = 0.27


def mnist_loss(model, batch, params=None):
    """``mnist_ps.py``'s loss: the mean NLL of ``model``'s logits on
    ``batch["image"]``, with ``params`` swapped in when given."""
    from tensorflowonspark_tpu_torch.models import layers

    logits = (model(batch["image"]) if params is None else
              torch.func.functional_call(model, params, (batch["image"],)))
    return layers.cross_entropy(logits, batch["label"])[0]


def ps_mnist_fn(args, ctx):
    """``examples/mnist/mnist_ps.py``'s ``main_fun`` on the port, with an
    evaluator.  ps: ``run_server`` (a thread writes whether this process
    initialised CUDA); worker: ``AsyncTrainer`` on ``MNISTNet`` over its
    own synthetic rows, then a ``stop`` file; evaluator: pulls the PS's
    params with a ``PSClient`` and scores the held-out rows until both
    workers stopped, then once more."""
    from tensorflowonspark_tpu_torch import compat, telemetry
    from tensorflowonspark_tpu_torch.models import mlp
    from tensorflowonspark_tpu_torch.parallel import ps

    tmp = args["tmp"]
    if ctx.job_name == "ps":
        def report():
            while True:
                with open(os.path.join(tmp, "ps_cuda.json.tmp"), "w") as f:
                    json.dump({"pid": os.getpid(), "cuda_initialized":
                               torch.cuda.is_initialized()}, f)
                os.replace(os.path.join(tmp, "ps_cuda.json.tmp"),
                           os.path.join(tmp, "ps_cuda.json"))
                time.sleep(0.5)

        threading.Thread(target=report, daemon=True).start()
        ps.run_server(ctx)
        return
    device = compat.resolve_device(args.get("device"))
    torch.manual_seed(0)
    model = mlp.MNISTNet(hidden=PS_MNIST_HIDDEN, device=device)
    params = {k: v.detach() for k, v in model.named_parameters()}
    if ctx.job_name == "evaluator":
        held_out = mnist_held_out(device)
        client = ps.PSClient(ctx.cluster_spec["ps"])
        client.init(params, PS_MNIST_OPT)
        stops = [os.path.join(tmp, "stop.%d" % i) for i in range(2)]
        scores = []
        while True:
            done = all(os.path.exists(s) for s in stops)
            with torch.no_grad():
                pulled = client.pull()
                for k, v in pulled.items():
                    model.get_parameter(k).copy_(torch.from_numpy(
                        np.array(v)))
                scores.append(float(mnist_loss(model, held_out)))
            if done:
                break
            time.sleep(0.2)
        client.close()
        with open(os.path.join(tmp, "eval.json"), "w") as f:
            json.dump({"scores": scores, "pid": os.getpid()}, f)
        return
    x, y = synthetic_mnist(PS_MNIST_ROWS, seed=ctx.task_index)
    x, y = torch.from_numpy(x), torch.from_numpy(y)
    steps, batch = args["steps"], PS_MNIST_BATCH
    reg = telemetry.get_registry()
    base = reg.snapshot()
    trainer = ps.AsyncTrainer(
        lambda p, b: mnist_loss(model, b, p), ctx.cluster_spec["ps"],
        optimizer=PS_MNIST_OPT, device=device)
    live = trainer.init(params)
    losses, t_first = [], None
    for i in range(steps):
        lo = (i * batch) % (len(x) - batch)
        b = {"image": x[lo:lo + batch].to(device, non_blocking=True),
             "label": y[lo:lo + batch].to(device, non_blocking=True)}
        live = trainer.step(live, b)
        losses.append(trainer.last_loss)
        if i == 0:
            sync(device)
            t_first = time.perf_counter()
    trainer.drain()
    sync(device)
    train_sec = time.perf_counter() - t_first
    sent, recv = trainer.client.bytes_sent, trainer.client.bytes_recv
    trainer.stop()
    rt = telemetry.snapshot_delta(reg.snapshot(), base)["histograms"].get(
        "ps.round_trip_sec", {})
    with open(os.path.join(tmp, "worker%d.json" % ctx.task_index), "w") as f:
        json.dump({
            "losses": torch.stack(losses).float().cpu().tolist(),
            "steps_per_sec": (steps - 1) / train_sec,
            "round_trip_ms_p50": 1e3 * telemetry.histogram_percentile(rt, 50),
            "round_trip_ms_p99": 1e3 * telemetry.histogram_percentile(rt, 99),
            "round_trips": rt.get("count", 0),
            "sent_bytes_per_step": sent / steps,
            "recv_bytes_per_step": recv / steps, "pid": os.getpid(),
            "device": device_name(device)}, f)
    open(os.path.join(tmp, "stop.%d" % ctx.task_index), "w").close()


def mnist_held_out(device):
    """The rows the evaluator scores, on ``device``."""
    x, y = synthetic_mnist(PS_MNIST_EVAL_ROWS, seed=99)
    return {"image": torch.from_numpy(x).to(device),
            "label": torch.from_numpy(y).to(device)}


def cuda_pids():
    """The pids ``nvidia-smi`` lists as holding a compute context."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return sorted(int(s) for s in out.split() if s.strip().isdigit())


def phase_ps_mnist_flagship(device=None, steps=PS_MNIST_STEPS,
                            spark_line=None):
    """``mnist_ps.py``'s flow with an evaluator and TensorBoard in one
    cluster: ``cluster.run(LocalEngine(4), ps_mnist_fn, num_ps=1,
    eval_node=True, tensorboard=True, log_dir=, InputMode.TENSORFLOW)``
    with ``num_chips_per_node=None`` (four processes share the card).
    The card's machine has no TensorBoard, so a stub ``tensorboard``
    (:data:`TB_STUB`, a few lines serving HTTP 200 on ``--port``) goes
    first on the executors' ``PATH``.  Gates: the roles; each worker's
    loss falls (mean of its last :data:`PS_MNIST_WINDOW` steps under its
    first); the evaluator scored at least twice, its last loss within
    1e-6 of the driver's on params pulled from the PS; the TensorBoard
    URL answers 200 and its pid is gone after ``shutdown``; the ps
    process holds no CUDA context; both service nodes stopped, no error.
    ``device="cpu"`` rehearses it without a card."""
    import importlib
    import tempfile

    from tensorflowonspark_tpu_torch import compat
    from tensorflowonspark_tpu_torch.cluster import cluster, manager, node
    from tensorflowonspark_tpu_torch.engine import LocalEngine
    from tensorflowonspark_tpu_torch.models import mlp
    from tensorflowonspark_tpu_torch.parallel import ps

    t_phase = time.perf_counter()
    on_card = device is None
    dev = compat.resolve_device(device)
    smoke = importlib.import_module("chip_smoke")
    tmp = tempfile.mkdtemp(prefix="ps_mnist_")
    bindir = os.path.join(tmp, "bin")
    os.makedirs(bindir)
    stub = os.path.join(bindir, "tensorboard")
    with open(stub, "w") as f:
        f.write(TB_STUB.format(python=sys.executable))
    os.chmod(stub, 0o755)
    env = {"PATH": bindir + os.pathsep + os.environ.get("PATH", "")}
    args = {"tmp": tmp, "steps": steps, "device": device}
    engine = LocalEngine(4, env=env)
    try:
        t0 = time.perf_counter()
        engine_sec = t0 - t_phase
        c = cluster.run(engine, smoke.ps_mnist_fn, args, num_executors=4,
                        num_ps=1, eval_node=True, tensorboard=True,
                        log_dir=os.path.join(tmp, "logs"),
                        num_chips_per_node=None, reservation_timeout=120,
                        input_mode=cluster.InputMode.TENSORFLOW)
        startup = time.perf_counter() - t0
        roles = sorted(n["job_name"] for n in c.cluster_info)
        url = c.tensorboard_url()
        tb_status, deadline = None, time.time() + 60
        while tb_status is None:
            try:
                tb_status = _http_get(url)[0]
            except OSError:
                if time.time() > deadline:
                    raise
                time.sleep(0.2)
        tb_pid = next(n["tb_pid"] for n in c.cluster_info if n["tb_pid"])
        t_wait = time.perf_counter()
        eval_path = os.path.join(tmp, "eval.json")
        deadline = time.time() + 600
        while not os.path.exists(eval_path):
            if time.time() > deadline:
                raise AssertionError("the evaluator wrote no scores")
            time.sleep(0.2)
        eval_wait = time.perf_counter() - t_wait
        with open(eval_path) as f:
            ev = json.load(f)
        # the driver's loss on the PS's params, on the card
        spec = node.build_cluster_spec(c.cluster_info)[0]
        torch.manual_seed(0)
        model = mlp.MNISTNet(hidden=PS_MNIST_HIDDEN, device=dev)
        client = ps.PSClient(spec["ps"])
        client.init({k: v.detach() for k, v in model.named_parameters()},
                    PS_MNIST_OPT)
        with torch.no_grad():
            for k, v in client.pull().items():
                model.get_parameter(k).copy_(torch.from_numpy(np.array(v)))
            driver_loss = float(mnist_loss(model, mnist_held_out(dev)))
        client.close()
        with open(os.path.join(tmp, "ps_cuda.json")) as f:
            ps_cuda = json.load(f)
        apps = cuda_pids() if on_card else []
        services = [n for n in c.cluster_info
                    if n["job_name"] in node.SERVICE_JOBS]
        t0 = time.perf_counter()
        c.shutdown(timeout=600)
        shutdown_sec = time.perf_counter() - t0
        states = {n["job_name"]: str(manager.connect(
            tuple(n["addr"]), bytes.fromhex(n["authkey"])).get(
                "state")._getvalue()) for n in services}
        deadline = time.time() + 10
        while _pid_alive(tb_pid) and time.time() < deadline:
            time.sleep(0.1)
        tb_gone = not _pid_alive(tb_pid)
    finally:
        engine.stop()
    workers = []
    for i in range(2):
        with open(os.path.join(tmp, "worker%d.json" % i)) as f:
            workers.append(json.load(f))
    shutil.rmtree(tmp, ignore_errors=True)
    k = max(1, min(PS_MNIST_WINDOW, steps // 2))
    line = dict(
        roles=roles, steps=steps, batch=PS_MNIST_BATCH,
        steps_per_sec=[w["steps_per_sec"] for w in workers],
        round_trip_ms_p50=[w["round_trip_ms_p50"] for w in workers],
        round_trip_ms_p99=[w["round_trip_ms_p99"] for w in workers],
        sent_bytes_per_step=[w["sent_bytes_per_step"] for w in workers],
        recv_bytes_per_step=[w["recv_bytes_per_step"] for w in workers],
        loss_first=[float(np.mean(w["losses"][:k])) for w in workers],
        loss_last=[float(np.mean(w["losses"][-k:])) for w in workers],
        eval_scores=len(ev["scores"]), eval_last_loss=ev["scores"][-1],
        driver_loss=driver_loss, cluster_startup_sec=startup,
        shutdown_sec=shutdown_sec, tensorboard_status=tb_status,
        tensorboard_gone=tb_gone, service_states=states,
        ps_pid=ps_cuda["pid"], ps_cuda_initialized=ps_cuda[
            "cuda_initialized"], cuda_pids=apps,
        worker_pids_listed=sorted(set(apps) & {w["pid"] for w in workers}),
        mnist_spark_steps_per_sec=(spark_line or {}).get("steps_per_sec"),
        engine_start_sec=engine_sec, eval_wait_sec=eval_wait,
        phase_sec=time.perf_counter() - t_phase,
        compute_device=workers[0]["device"],
        nvidia_smi=nvidia_smi_or_cpu(dev))
    emit("ps_mnist_flagship", **line)
    if roles != ["evaluator", "ps", "worker", "worker"]:
        raise AssertionError("roles {0}".format(roles))
    for w, first, last in zip(workers, line["loss_first"], line["loss_last"]):
        if not np.isfinite(w["losses"]).all() or not last < first:
            raise AssertionError("a worker's loss did not fall: {0}".format(
                w["losses"]))
    if len(ev["scores"]) < 2:
        raise AssertionError("the evaluator scored {0} times".format(
            len(ev["scores"])))
    if abs(ev["scores"][-1] - driver_loss) > 1e-6:
        raise AssertionError("evaluator loss {0} != driver's {1}".format(
            ev["scores"][-1], driver_loss))
    if tb_status != 200 or not tb_gone:
        raise AssertionError("tensorboard status {0}, pid gone {1}".format(
            tb_status, tb_gone))
    if ps_cuda["cuda_initialized"] or ps_cuda["pid"] in apps:
        raise AssertionError("the ps process holds a CUDA context: "
                             "{0}".format(ps_cuda))
    if states != {"ps": "stopped", "evaluator": "stopped"}:
        raise AssertionError("service nodes {0}".format(states))
    return line


def _pid_alive(pid):
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    return True


#: a PS shard in a CPU process of its own (``bench.py:2781``
#: ``_ps_shard_proc``): it imports the port's ``parallel/ps.py`` (numpy,
#: no ``torch``), prints its port and serves until it is stopped
PS_SHARD_CMD = ("from tensorflowonspark_tpu_torch.parallel import ps; "
                "s = ps.ParamServerShard(); "
                "print(s.start('127.0.0.1', 0)[1], flush=True); s.join()")


def start_ps_shards(n):
    """``n`` shard processes and their ``host:port`` addresses."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p))
    procs = [subprocess.Popen([sys.executable, "-c", PS_SHARD_CMD],
                              stdout=subprocess.PIPE, text=True, cwd=root,
                              env=env) for _ in range(n)]
    return procs, ["127.0.0.1:" + p.stdout.readline().strip() for p in procs]


def ps_lm_model(config, device):
    """The flagship's layout at ``config``'s depth from seed 0: f32 masters
    under bf16 compute with flash attention, its loss, and the seeded
    [B, S] batch every step trains on."""
    from tensorflowonspark_tpu_torch import convert
    from tensorflowonspark_tpu_torch.models import transformer

    cfg = transformer.TransformerConfig(**dict(config,
                                               attention_impl="flash"))
    tree = convert.init_params_tree(transformer.TransformerConfig(**config),
                                    seed=0)
    model = convert.params_from_flax(tree, cfg, device=device,
                                     param_dtype=torch.float32)
    tokens = np.random.default_rng(7).integers(
        0, cfg.vocab_size, (PS_LM_B, min(PS_LM_S, cfg.max_seq_len)))
    batch = {"tokens": torch.from_numpy(tokens.astype(np.int32)).to(device)}
    lossf = transformer.loss_fn(model)
    return model, (lambda p, b: lossf(p, b, None)), batch


def phase_ps_lm_flagship(config=None, device=None, timed=PS_LM_TIMED):
    """``bench.py:3020`` ``ps_tpu_bench`` at the flagship's width, depth cut
    to :data:`PS_LM_LAYERS`: ``AsyncTrainer`` in this process (gradients
    on the card) against :data:`PS_LM_SHARDS` shards in spawned CPU
    processes, each variant of :data:`PS_LM_VARIANTS` on fresh shards (a
    warm-up step and ``drain``, then ``timed`` steps and ``drain``), then
    ``SyncTrainer(sgd)`` on the same model and batch.  Gates: K2-K4
    launches of each variant equal layers x (timed + 1) steps on the card
    (the CPU runs their plain versions: 0); ``async_unpipelined``'s loss
    falls; ``async_compressed`` pushes at most :data:`PS_LM_PUSH_RATIO`
    of ``async_pipelined``'s bytes a step; one extra overlapped step's
    pushed gradients equal a blocking readback of them, bit for bit.
    ``device="cpu"`` with a small ``config`` rehearses it."""
    from tensorflowonspark_tpu_torch import compat, optim, telemetry
    from tensorflowonspark_tpu_torch.ops.flash_attention import (
        flash_attention,
    )
    from tensorflowonspark_tpu_torch.parallel import dp, ps

    config = dict(FLAGSHIP, num_layers=PS_LM_LAYERS) if config is None \
        else config
    on_card = device is None
    dev = compat.resolve_device(device)
    t_phase = time.perf_counter()
    procs, flat = start_ps_shards(PS_LM_SHARDS * len(PS_LM_VARIANTS))
    addrs = {name: flat[i * PS_LM_SHARDS:(i + 1) * PS_LM_SHARDS]
             for i, name in enumerate(PS_LM_VARIANTS)}
    try:
        model, loss, batch = ps_lm_model(config, dev)
        setup_sec = time.perf_counter() - t_phase
        params = {k: v.detach() for k, v in model.named_parameters()}
        n_params = sum(v.numel() for v in params.values())
        want = config["num_layers"] * (timed + 1) if on_card else 0
        reg = telemetry.get_registry()
        res, extra = {}, None
        for name, kw in PS_LM_VARIANTS.items():
            t_variant = time.perf_counter()
            tr = ps.AsyncTrainer(loss, addrs[name], optimizer=PS_LM_OPT,
                                 device=dev, **kw)
            flash_attention.launches = {"fwd": 0, "dq": 0, "dkv": 0}
            live = tr.init(params)
            live = tr.step(live, batch)
            first_loss = float(tr.last_loss)
            live = tr.drain() or live
            sync(dev)
            sent0, recv0 = tr.client.bytes_sent, tr.client.bytes_recv
            nread, nh2d = len(tr.readback_sec), len(tr.h2d_ms())
            base = reg.snapshot()
            t0 = time.perf_counter()
            for _ in range(timed):
                live = tr.step(live, batch)
            live = tr.drain() or live
            sync(dev)
            wall = time.perf_counter() - t0
            launches = dict(flash_attention.launches)
            rt = telemetry.snapshot_delta(reg.snapshot(), base)[
                "histograms"].get("ps.round_trip_sec", {})
            with torch.no_grad():
                final_loss = float(loss(live, batch))
            res[name] = dict(
                steps_per_sec=timed / wall,
                sent_kb_per_step=(tr.client.bytes_sent - sent0) / timed / 1e3,
                recv_kb_per_step=(tr.client.bytes_recv - recv0) / timed / 1e3,
                readback_ms=[1e3 * s for s in tr.readback_sec[nread:]],
                h2d_ms=tr.h2d_ms()[nh2d:],
                round_trip_ms_p50=1e3 * telemetry.histogram_percentile(rt, 50),
                round_trip_ms_p99=1e3 * telemetry.histogram_percentile(rt, 99),
                first_loss=first_loss, final_loss=final_loss,
                launches=launches)
            if name == "async_compressed":
                extra = overlap_readback_check(tr, live, batch)
            tr.stop(stop_servers=True)
            del tr, live
            res[name]["variant_sec"] = time.perf_counter() - t_variant
        # the synchronous trainer on the same model and batch
        t_sync = time.perf_counter()
        sgd = dp.SyncTrainer(lambda p, b, r: loss(p, b),
                             optim.sgd(PS_LM_OPT[1]["learning_rate"]))
        state = sgd.create_state(dict(model.named_parameters()))
        state, _ = sgd.step_on_device(state, batch)
        sync(dev)
        t0 = time.perf_counter()
        for _ in range(timed):
            state, _ = sgd.step_on_device(state, batch)
        sync(dev)
        sync_steps_per_sec = timed / (time.perf_counter() - t0)
        sync_sec = time.perf_counter() - t_sync
    finally:
        for p in procs:
            p.terminate()
            p.wait(timeout=10)
    line = dict(
        model="L{0} H{1} Dh{2} Dm{3} Dff{4} V{5}, {6} over f32 masters, "
              "flash".format(config["num_layers"], config["num_heads"],
                             config["head_dim"], config["embed_dim"],
                             config["mlp_dim"], config["vocab_size"],
                             config["dtype"]),
        params=n_params, batch=[PS_LM_B, int(batch["tokens"].shape[1])],
        shards=PS_LM_SHARDS, timed_steps=timed, variants=res,
        sync_steps_per_sec=sync_steps_per_sec,
        async_vs_sync=res["async_pipelined"]["steps_per_sec"]
        / sync_steps_per_sec,
        push_ratio=res["async_compressed"]["sent_kb_per_step"]
        / res["async_pipelined"]["sent_kb_per_step"],
        overlap_readback=extra, setup_sec=setup_sec, sync_sec=sync_sec,
        phase_sec=time.perf_counter() - t_phase,
        nvidia_smi=nvidia_smi_or_cpu(dev))
    emit("ps_lm_flagship", **line)
    for name, r in res.items():
        if r["launches"] != {"fwd": want, "dq": want, "dkv": want}:
            raise AssertionError("{0}: flash launches {1}, want {2} each"
                                 .format(name, r["launches"], want))
    un = res["async_unpipelined"]
    if not np.isfinite(un["final_loss"]) or \
            not un["final_loss"] < un["first_loss"]:
        raise AssertionError("async_unpipelined's loss did not fall: "
                             "{0}".format(un))
    if not line["push_ratio"] <= PS_LM_PUSH_RATIO:
        raise AssertionError("compressed pushes {0:.3f} of dense".format(
            line["push_ratio"]))
    if not extra["equal"]:
        raise AssertionError("the overlap drain's readback differs from a "
                             "blocking one: {0}".format(extra))
    return line


def overlap_readback_check(tr, live, batch):
    """One extra step through the overlap drain while the next step's
    gradients are already dispatched: the host arrays the drain hands to
    the push must equal a blocking readback of the same device
    gradients, bit for bit."""
    pushed = []
    orig = tr.client.push_pull_async

    def capture(host):
        pushed.append([np.array(h, copy=True) for h in host])
        return orig(host)

    tr.client.push_pull_async = capture
    window = tr._grads(live, batch)
    tr._drain.submit(window)
    tr._grads(live, batch)  # the next step's work queued behind it
    tr.drain()
    tr.client.push_pull_async = orig
    blocking = [w.cpu() for w in window]
    from tensorflowonspark_tpu_torch import compress

    same = len(pushed) == 1 and all(
        compress.to_numpy(b).tobytes() == p.tobytes()
        for b, p in zip(blocking, pushed[0]))
    return {"equal": bool(same), "leaves": len(window),
            "bytes": int(sum(w.numel() * w.element_size() for w in window))}


def kernel_entry(name, kernel, replaces, launches, timing,
                 source="tensorflowonspark_tpu_torch/csrc/flash_attention.cu",
                 **extra):
    """One entry of the ``kernels`` line; ``kernel`` names the CUDA
    function that ran at the timing shape."""
    return dict(
        name=name, kernel=kernel, route="cuda", source=source,
        replaces=replaces, launches=launches,
        max_abs_err=timing["max_abs_err"], ms=timing["ms"],
        plain_ms=timing["plain_ms"], bound_ms=timing["bound_ms"],
        bound_by=timing["bound_by"], library_ms=timing["library_ms"],
        library_note=timing["library_note"], **extra
    )


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 2
    import tensorflowonspark_tpu_torch  # noqa: F401  (fails outside a checkout)

    t_start = time.perf_counter()
    laps = {}

    def lap(name, _t=[t_start]):
        now = time.perf_counter()
        laps[name] = now - _t[0]
        _t[0] = now

    phase_env()
    phase_build()
    lap("build")
    phase_kernel_cases()
    phase_paged_repeat()
    timing = phase_kernel_timing()
    lap("paged_kernel")
    tree, init_s = flagship_tree()
    flagship = phase_slice_flagship(tree, init_s)
    phase_kernel_vs_gather()
    lap("slice_flagship")
    static = phase_static_serve_flagship(tree, flagship["tokens"],
                                         flagship["decode_step_ms"])
    lap("static_serve_flagship")
    # the engine's phases and the elastic one at a cut depth
    cut = dict(FLAGSHIP, num_layers=CUT_LAYERS)
    cut_tree = draft_tree(tree, CUT_LAYERS)
    prefix = phase_prefix_serve_flagship(cut_tree, config=cut)
    lap("prefix_serve_flagship")
    recovery = phase_serve_recovery_flagship(cut_tree, config=cut)
    lap("serve_recovery_flagship")
    swap = phase_hot_swap_flagship(cut_tree, config=cut)
    lap("hot_swap_flagship")
    fused = phase_fused_qkv_flagship(cut_tree, prefix, config=cut)
    del prefix["rows"], prefix["f32_paged_tokens"]
    lap("fused_qkv_flagship")
    tele = phase_telemetry_serve_flagship(cut_tree, config=cut)
    lap("telemetry_serve_flagship")
    disagg = phase_disagg_serve_flagship(cut_tree, config=cut)
    lap("disagg_serve_flagship")
    phase_spec_serve_flagship(cut_tree, config=cut)
    del cut_tree
    lap("spec_serve_flagship")
    phase_flash_cases()
    phase_flash_repeat()
    flash = phase_flash_timing()
    phase_flash_offset_cases()
    offset = phase_flash_offset_timing()
    ring_hops = phase_ring_flagship()[RING_FLAGSHIP["window"]]
    lap("flash")
    train, model = phase_train_flagship(tree, flash)
    del tree
    phase_train_kernel_vs_dot()
    phase_train_to_serve(model)
    phase_optimizer_timing(model)
    del model
    lap("train_flagship")
    phase_gmm_cases()
    gmm_timing = phase_gmm_timing()
    moe, moe_model = phase_moe_train_flagship(gmm_timing, flash)
    phase_moe_dropless_vs_gather()
    phase_moe_train_to_serve(moe_model)
    del moe_model
    lap("moe")
    fed = phase_feed_train_flagship(train)
    lap("feed_train_flagship")
    ring = phase_feed_ring_train_flagship(train)
    lap("feed_ring_train_flagship")
    inference = phase_feed_inference_flagship()
    lap("feed_inference_flagship")
    resumed = phase_checkpoint_resume_serve(train)
    lap("checkpoint_resume_serve")
    elastic = phase_elastic_flagship(config=cut)
    lap("elastic_flagship")
    pipeline = phase_pipeline_flagship(fed)
    lap("pipeline_flagship")
    mnist = phase_mnist_spark_flagship()
    phase_resnet_train_flagship()
    phase_segmentation_flagship()
    lap("vision")
    phase_ps_mnist_flagship(spark_line=mnist)
    lap("ps_mnist_flagship")
    ps_lm = phase_ps_lm_flagship()
    lap("ps_lm_flagship")
    emit("phase_times", total_sec=time.perf_counter() - t_start, **laps)
    jax_flash = "tensorflowonspark_tpu/ops/flash_attention.py:"
    jax_gmm = "tensorflowonspark_tpu/ops/gmm.py:"
    print(json.dumps({"kernels": [dict(
        name="paged_attention", kernel="paged_decode_split+paged_combine",
        route="cuda",
        source="tensorflowonspark_tpu_torch/csrc/paged_attention.cu",
        replaces="tensorflowonspark_tpu/ops/paged_attention.py:143",
        launches=flagship["paged_attention_launches"],
        max_abs_err=timing["max_abs_err"], ms=timing["kernel_ms"],
        plain_ms=timing["plain_ms"], bound_ms=timing["bound_ms"],
        bound_by=timing["bound_by"], library_ms=timing["library_ms"],
        library_note="gather_pool of K and V, then "
                     "scaled_dot_product_attention with the length mask",
        export_serve_launches=resumed["export_serve_launches"],
        pipeline_launches=pipeline["transform_launches"],
        int8_pool_launches=static["int8_pool_launches"],
        prefix_serve_launches=prefix["launches"],
        recovery_launches=recovery["launches"],
        hot_swap_launches=swap["launches"],
        fused_export_launches=fused["export_serve"][
            "paged_attention_launches"],
        telemetry_launches=tele["launches"],
        disagg_launches=disagg["launches"],
    )] + [
        kernel_entry("flash_" + name, kernel, jax_flash + line,
                     train["launches"][name], flash[name],
                     fed_launches=fed["launches"][name],
                     fed_capture_kernel_events=fed["profile"][
                         "kernel_events"][kernel],
                     ring_fed_launches=ring["launches"][name],
                     inference_launches=inference["launches"][name],
                     resume_launches=resumed["resume_launches"][name],
                     elastic_launches=[g[name] for g in elastic["launches"]],
                     ring_attention_launches=ring_hops["launches"][name],
                     pipeline_launches=pipeline["fit_launches"][name],
                     fused_qkv_launches=fused["train"]["launches"][name],
                     ps_lm_launches={v: r["launches"][name] for v, r in
                                     ps_lm["variants"].items()},
                     **{"offset_" + k: offset[name][k] for k in (
                         "ms", "plain_ms", "bound_ms", "bound_by",
                         "library_ms", "max_abs_err")})
        for name, kernel, line in (("fwd", "flash_fwd_wgmma", "132"),
                                   ("dq", "flash_dq_wgmma", "198"),
                                   ("dkv", "flash_dkv_wgmma", "256"))
    ] + [
        kernel_entry(name, GMM_WGMMA[name], jax_gmm + line,
                     moe["launches"][name], gmm_timing[name], source=GMM_SRC,
                     **({"static_serve_launches":
                         static["static_serve_launches"]}
                        if name == "gmm" else {}))
        for name, line in (("gmm", "71"), ("gmm_dxt", "144"),
                           ("tgmm", "219"))
    ]}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Drive smi_tpu_torch's main path once on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card, ``nvcc`` and ``nvidia-smi``; without a card it exits non-zero
and prints no result. ``--earlier PATH`` (repeatable) builds an earlier
copy of a ``smi_tpu_torch/kernels/csrc`` source with the same C entry
points beside the tree's, named by its stem (``ring.cu``,
``flash_fwd.cu``, ``flash_bwd.cu``, ``stencil_temporal.cu``,
``stencil_pipeline.cu``, ``roll_chain.cu``), and times it in turns with
the tree's kernels (earlier, tree, tree, earlier): an earlier
``ring.cu`` in phases 24 and 27 on the tree's launch plan, with outputs
equal bit for bit; an earlier
``flash_fwd.cu`` in phase 11 on the tree's plan, and an earlier
``flash_bwd.cu`` in phase 16 on the plan of the first, ``mma.sync``
backward (``earlier_bwd_plan``: its C entry refuses any other), each
side's outputs held to the plain version's bars (the two round
differently); an earlier ``stencil_temporal.cu`` in phase 6 and an
earlier ``stencil_pipeline.cu`` in phase 19 and an earlier
``roll_chain.cu`` in phase 30, each on its first form's plan
(``earlier_temporal_plan``, ``earlier_pipeline_plan``,
``earlier_roll_plan``), outputs equal bit for bit. The records of those
kernels then carry ``earlier_ms``, else null. The phases:

1. the device, with the card's name and power limit from ``nvidia-smi``;
2. the build of every CUDA kernel of the path from
   ``smi_tpu_torch/kernels/csrc``, each instance's registers and spills
   printed; a spill in ``stencil_temporal`` or ``stencil_pipeline`` fails;
3. the single-sweep kernel against its plain PyTorch version on the card
   (``array_equal``): 8192x8192 with zero halos, and a 4096x2048 block
   with random halos at a nonzero offset inside an 8192x8192 grid;
4. the k-sweep kernel against its plain version, at k=8 and k=16 on the
   same two shapes, with random corner-complete halos on the second; then
   ``TEMPORAL_CASES``: k = 1, 2, 7, 8, 16 and 32 on blocks that are no
   multiple of the plan's stripe and band, inside the grid and holding
   all four global edges, each global edge alone, and a 16x40 block under
   one band, all with random halos;
5. the main path at full width — the 8192x8192 f32 Jacobi stencil on a
   1x1 rank grid through ``make_communicator``, ``pick_temporal_depth``
   and ``make_temporal_stencil_fn`` with 259 sweeps (``MAIN_SWEEPS``), so
   the remainder runs on the single-sweep kernel — held ``array_equal`` to
   the plain
   PyTorch stencil on the card; then the same path on a 4096x2048 grid,
   the reference's per-rank block on its 2x4 grid, with the launch
   counts set to 0 before each run and read after it, and both kernels
   launched in each; then 1024x1024 against the numpy serial reference;
6. each kernel's time at the main path's shapes (CUDA events), beside its
   bound, its plain version's time and a PyTorch yardstick, with the
   plan and the blocks an SM holds at once
   (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``); with an earlier
   ``stencil_temporal.cu`` its time in turns with the tree's; and the
   k-sweep kernel's ms a sweep at k = 8, 16 and 32 on both shapes, the
   depth picker's order, each with its form (level groups, columns a
   thread) and warps an SM; then the form of each depth it ran
   (``stencil_temporal.form``).

Then ring attention's forward (``smi_tpu_torch/kernels/csrc/flash_fwd.cu``,
built in phase 2 with the stencil sources), with TF32 off throughout:

7. the fused flash kernel against its plain version on the card, at the
   widths of the JAX package's attention rows (H=8, D=128): S=8192 causal
   in f32 and bf16, S=4096 non-causal f32, and S=32768 with one K/V head
   and a 4096 window in bf16; then two small ragged shapes at the other
   head dims, in f32 and bf16 (``SMALL_CASES``: S=1000 at D=64 with GQA,
   S=200 at D=256 with a window);
8. the carried flash kernel against its plain version: one rank's steps
   of a 4-rank ring over S=8192 (2048 rows at q_off=6144) from a carry of
   an earlier fold, on a past block, the diagonal block and a future
   block (which must return the carry ``array_equal``), in f32 and bf16,
   and the GQA 8:1 window-4096 case at the window's edge;
9. the main path at full width: ``make_communicator(shape=(1,),
   axis_names=("sp",))`` and ``make_ring_attention_fn`` with ``use_flash``
   at its default, at the four shapes of phase 7, each held to float64
   ``reference_attention_rows`` on 256 rows (the first and the last among
   them), each run making one fused launch and no carried launch;
10. an emulated 4-rank ring over S=8192, causal f32, causal bf16 and GQA
   8:1 window 4096 bf16: one thread per rank runs
   ``make_ring_attention_fn`` on its shards, with ``ring_shift`` stood in
   by a shift that swaps blocks between the threads at a barrier, so the
   ring schedule itself runs; each rank's output equals its rows of the
   fused output, in 16 carried launches per ring;
11. each flash kernel's time at those shapes beside its bound, its plain
   version's time and ``scaled_dot_product_attention``'s, with TFLOP/s
   of live work; a ring's 16 folds also by device time (enqueued behind
   a wait, as the ring kernels are timed, so the host's cost of each
   launch is left out); with an earlier ``flash_fwd.cu`` its time in
   turns with the tree's, its outputs held to the plain version's bars.

Then training (``smi_tpu_torch/kernels/csrc/flash_bwd.cu``, also built in
phase 2):

12. each backward kernel (dq; dk and dv) against its plain version, from
   a fused forward's statistics and a random dout: the four shapes of
   phase 7 and the 4-layer stack's S=32768 window-4096 attention; one
   rank's steps of the 4-rank rings (2048 rows at q_off=6144): past,
   diagonal and future blocks (the future block's gradients must be
   zeros, ``array_equal``) in f32 and bf16, and the GQA window edge;
13. the ring's backward: on the 1-rank ring, autograd through
   ``make_ring_attention_fn``'s default tier (one launch of each kernel)
   against the kernels' plain versions and, up to S=8192, against
   autograd through the plain tier; the three rings of phase 10 with
   ``_flash_forward`` and ``_flash_ring_backward`` run by one thread per
   rank, each rank's gradients equal to its rows of the 1-rank ones, in
   16 launches of each backward kernel per ring; and ``remat_reps``;
14. the main path at full width: ``make_train_step`` on a 1x1 ``(dp,
   sp)`` grid, ``BlockConfig(embed=1024, heads=8, head_dim=128)``, B=1,
   S=8192, causal, 1 layer, bf16 compute (3 steps; the loss falls; 1
   fused, 1 dq and 1 dk/dv launch per step) and f32 compute, each
   parameter's gradient against the plain tier's (``use_flash=False``);
   host wall, tokens/s and the attention kernels' share of the step;
15. the 4-layer stack at S=32768, window 4096, bf16, per-block recompute:
   3 steps, the loss falls, 8 fused, 4 dq and 4 dk/dv launches per
   step, the peak of ``torch.cuda.max_memory_allocated``;
16. each backward kernel's time at the shapes of phases 12-15 beside its
   bound, its plain version's time and the backward of
   ``scaled_dot_product_attention`` (forward plus backward less forward),
   with its blocks a launch (and, where bf16 dk/dv took its 64-key form,
   the 128-key form's time); with an earlier ``flash_bwd.cu`` its time in
   turns with the tree's, its outputs held to the plain version's bars.

Then the explicit-copy stencil pipeline
(``smi_tpu_torch/kernels/csrc/stencil_pipeline.cu``, also built in phase 2):

17. the pipeline kernel against its plain version, ``torch.equal``: the
   8192x8192 extended state with zero halos and the 4096x2048 block at
   ``BLOCK_AT`` with random corner-complete halos, at k = 8, 16 and 32,
   in f32 and bf16, with buffering 1 and 3; then ``PIPE_CASES`` (a ragged
   last band inside the grid and at its edges, a named stripe, the
   generic loop at k = 24) in both dtypes and bufferings;
18. the path at full width: ``make_communicator(shape=(1, 1))`` and
   ``make_pipeline_stencil_fn`` on 8192x8192 with 16*k+3 sweeps at each
   k, f32 and bf16, the launch counts set to 0 before each run and read
   after it (both ``stencil_pipeline`` and ``stencil_sweep`` launched);
   f32 ``torch.equal`` to the plain torch stencil, bf16 to the same path
   on the kernels' plain versions, and bf16's largest difference to f32
   printed; then 1024x1024 at k=16 against the numpy serial reference;
19. one pass's time at 8192x8192, k = 8, 16 and 32, f32 and bf16, beside
   its bound, its plain version's time and the temporal kernel's at the
   same depth (no single PyTorch call does k sweeps), the plan and the
   blocks an SM holds, and buffering 1 against 3 at one window shape:
   the overlap the ring buys; with an earlier ``stencil_pipeline.cu`` its
   time in turns with the tree's.

Then the Streaming Message Interface on the ring tier
(``smi_tpu_torch/kernels/csrc/ring.cu``, also built in phase 2), every
rank a thread of a ``LocalWorld`` on the one card, 8 ranks unless said:

20. each ring kernel ``torch.equal`` to its plain version on every rank,
   every credit domain drained (credits granted = received = consumed;
   with credits, every live block of a stream granted and consumed
   chunks - 2), and unequal to the plain version without rank 1's
   contribution:
   all-reduce of 1,048,576 f32 a rank (ADD) and int32 (MAX), all-gather
   of 512 KiB a rank, reduce-scatter of 8 x 512 KiB a rank, the
   neighbour stream of 512 KiB in 16 chunks in both directions, of 507
   chunks of 2072 elements against the ring's direction (the channel's
   shape in phase 21), and of one-chunk 2048- and 4096-element slabs on
   the ``sx`` and ``sy`` sub-rings of the 2x4 world, every line of an
   axis in one launch, on stream slots 0-3 (the halo's shapes in phase
   23); the four at 2 and 3 ranks at a width-130 payload in f32, bf16 and int8 and at
   1000 elements; and without flow control where nothing can be
   overwritten (2 ranks; a stream of two chunks);
21. the SMI API through ``smi_kernel(world, backend="ring")``: bcast,
   reduce (ADD, MAX), allreduce, scatter and gather at root 5 on
   1,048,576 floats a rank, a transfer 0->5 (three hops the short way
   round) and a stream 5->6 with a summing consumer and ``buffer_size=
   2048``, two collectives on ports of different flag domains back to
   back; each result equal to numpy (f32 ADD within 1e-6 relative),
   zeros off-root, and equal to the same call with ``backend="xla"``
   (exactly, but for f32 ADD: another association); the launch counts
   set to 0 before and held to the calls made;
22. ``make_kmeans_fn`` on 8 ranks (65,536 points, k=8, 2 dims, 10
   iterations, 40 all-reduce launches) against ``reference_kmeans``
   (rtol 1e-3, atol 1e-4) and ``make_gesummv_fn`` on 2 ranks (n=1024,
   alpha 1.5, beta 0.5) against ``reference_gesummv`` (rtol 2e-3;
   ``torch.matmul`` in full f32);
23. the 8192x8192 stencil on the 2x4 world (4096x2048 a rank), 8 sweeps
   with ``backend="ring"``: 32 neighbour-stream launches, each playing
   every line of its axis; ``torch.equal`` to ``backend="xla"`` and to
   the plain stencil on the 1x1 grid;
24. the handshake probe: each ring kernel at one block a rank on 4 KiB
   units (16 chunks for the stream), its time over the n-1 steps (the
   stream's chunks) in us a step, and the all-reduce's on rings of 2 and
   4 ranks, which part a step from the launch's fixed cost; then each
   ring kernel's time at phase 20's first shapes beside its bound (all ranks' inputs read once and outputs written once, over the
   memory rate; the bytes the ring schedule moves on top of that are
   logged with their rate), its plain version's time and one stacked
   PyTorch call that computes the same values and that the port never
   calls. A ring time ``ms`` is the device time of one grid
   (``ring_kernel_ms``: the launch replayed back to back behind a wait,
   CUDA events between the replays, the median), and the library call's
   is timed the same way; ``launch_ms`` beside it is one launch through
   the wrapper on an idle card, by the wrapper's own events (the median
   of a few), so the host's cost of a launch, which a user pays on every
   collective, is in it. The stream is also timed at the channel's shape
   of phase 21 (507 chunks of 2072 f32 a rank), each stream time with its
   us a chunk. Before the times, one launch's host side by part, rows
   5-9 (``launch_split``: the zero fill, the device context, the stream
   handle, the ctypes call, the C entry's queries, the launch, the event
   records and the rest of ``_launch``, on the main thread; the same
   ``_launch`` at the rendezvous; the wrapper's event time in both), and
   the stream's device time at slice floors of 2, 4, 8 and 16 KiB;

Then the chunked ring all-reduce (``smi_ring_all_reduce_chunked`` in
``ring.cu``) and SMI's benchmark suite on the port:

25. the chunked kernel ``torch.equal`` to its plain version and to the
   unchunked kernel on every rank, every chunk's credit domain drained,
   and unequal to the plain version without rank 1's contribution: 8
   ranks at 1,048,576 f32 a rank as (1024, 1024) with chunks 2, 4 and 8
   (ADD), int32 MAX and bf16 ADD at chunks 4, the overlap benchmark's
   1-D 65,536, 16,384 and 4,096 f32 at chunks 4 (its sweep; the last one
   block a rank), 1000 rows at chunks 3 (zero-row padding);
   2 and 3 ranks at width 130 in f32, bf16 and int8; the ``sx`` and
   ``sy`` sub-rings of the 2x4 world, each axis in one launch;
25b. each of the five ring entries launched ``STRESS_LAUNCHES`` times at
   two shapes, phase 20's first (phase 25's for the chunked entry) and
   one block a rank (a chunk) on 4 KiB units, and the stream also at the
   channel's shape, fresh random inputs each
   launch, every launch ``torch.equal`` to its plain version on every
   rank with every credit domain drained: a race shows rarely;
26. every benchmark of ``smi_tpu_torch.benchmarks`` through
   ``run_benchmark`` on an 8-rank world, the micro benchmarks under
   ``xla`` and ``ring``, the application benchmarks under ``xla`` (each
   verifies its result first), at the JAX defaults' widths with fewer
   runs (``SUITE_RUNS``) and a shallower pipeline, ping-pong and message
   chain (``SUITE_CUTS``); the launch counts set to 0 before ``overlap``
   on ``ring`` and read after it (the chunked kernel must have run); per
   ring benchmark the host wall beside its kernels' event time; then
   every distinct ring launch the suite made (kernel, shape, dtype, op,
   direction, axis, stream slot) held again on random inputs against its
   plain version by phase 20's check (the chunked ones by phase 25's),
   since the suite's own inputs are ones, alike on every rank;
27. the chunked kernel's handshake probe (4 KiB a chunk, chunks 4, one
   block a chunk, us a step), then its time at 4 MiB a rank, chunks 2, 4
   and 8 (device time and one launch, as in phase 24), beside the
   unchunked kernel's on the same payload, the schedule traffic's rate,
   its bound (all ranks' inputs and outputs once), its plain version's
   time and ``torch.stack(xs).sum(0)`` (device time).

Then the single-card surface (``smi_tpu_torch/benchmarks/surface.py``)
and its roll-chain kernel (``smi_tpu_torch/kernels/csrc/roll_chain.cu``,
also built in phase 2):

28. the roll-chain kernel against its plain version (``torch.equal``) on
   random f32 inputs: 512x2048 at one and two chains, 256x2048 at two,
   the ragged 7x300 at three, and the longest axis the kernel takes
   (4096: 8x4096, 4096x8), each body (``lane``, ``sublane``, ``add``),
   at lengths 1, 3, 1000 and 4097 (net shifts that are not 0) and the
   timed 1024 and 4096, with the R=1 control unequal to its input; each
   case's plan (registers a line, warps a block, blocks) and
   its instance's registers and spills (``-Xptxas -v``) and SHFL count
   (``cuobjdump -sass``, where the toolkit has it) are printed;
29. the whole surface on the card through ``surface.main`` at the JAX
   package's shapes, with only the harness's depth cut (``SURFACE_RUNS``,
   ``SURFACE_MIN_DELTA``): every record printed, each section's wall
   logged, every value finite and above 0, the names those of the root
   ``PERF.json`` (read, never written); the launch counts set to 0 before
   the run and read after it, and the roll-chain, flash forward and
   backward and both stencil kernels launched;
30. the roll kernel's time at 512x2048, R=4096, one and two chains, each
   body (CUDA events per launch; with an earlier ``roll_chain.cu`` in
   turns), beside its plain version's, one ``torch.roll`` by the same
   net shift (the library time of lane and sublane; add has none), and
   its bounds: device memory (4 MiB in and out once) or operations (the
   add chain at 67 TFLOP/s; adds alone at half of it beside it), the
   shuffle ceiling (an element a step over 32 shuffle results a clock on
   each of 132 SMs at ``nvidia-smi``'s maximum SM clock) and the first
   form's shared-memory term (8 B an element a step over 128 B a
   clock).

Then the rest of SMI's collective surface, on the ``(2, 4)`` world
``("dcn", "ici")`` (8 ranks, 4 MiB a rank: a ``(1024, 1024)`` f32 array):

31. ``all_to_all`` pairwise, Bruck and two-tier in f32, bf16 and int32,
   each ``torch.equal`` to the stacked block transpose; the allreduce
   flat (``rs_ag=False``), by default (the form the plan engine's gates
   name: flat in f32 at 4 MiB by the seeded H100 entry, the cost model's
   two-tier form in int32, which no sweep covers) and
   ``hierarchical=True``, each form's rendezvous checked,
   int32 ``torch.equal`` and f32 within 1e-6 of flat;
   ``precision="bf16" | "int8" | "topk"`` on both tiers, the ring tier
   ``torch.equal`` to quantise-then-``ring_all_reduce_plain``, bf16 and
   int8 within the JAX package's relative-error pins (0.01, 0.02), 8 x
   3.5 summing to 28 exactly; ``transfer_verified`` and
   ``stream_verified`` 5->6 at the channel's 507 chunks of 2072 f32 on
   both tiers, frames verified, and one flipped bit named by chunk. The
   launch counts are set to 0 before these runs and read after them
   (rows 7 and 5 of the kernels line add them). Then each form's times:
   the device time of its rendezvous work (replayed behind a wait), its
   host wall through ``LocalWorld.run``, the all-to-all's byte bound and
   one stacked transpose copy, each beside ``nvidia-smi``'s name and
   power limit.

Then the plan engine (``smi_tpu_torch/tuning``):

32. the engine's detected device kind, which must be the seeded H100
   kind; the collective sweeps timed on the card (``SWEEP_KB``: 64, 256,
   1024 and 4096 KiB a rank, f32, ``SWEEP_RUNS`` runs a point of one
   ``LocalWorld.run``): the allreduce (chunks 1, 2 and 4) on the 8-rank
   world and on the ``(2, 4)`` world, the two-tier sweep, the precision
   sweep on both and the all-to-all on both, over an engine that starts
   empty and takes each routing sweep's winners before the next sweep
   runs; each table printed with the cost model's (v5e) price beside
   every measurement, the winner and the runner-up, and the winners
   beside the seeded entries. Then, with the default engine (the seeded
   cache), an untuned 4 MiB allreduce on each world and an untuned 4 MiB
   all-to-all on each, each with the rendezvous and ``torch.equal`` on
   every rank of the pinned form its seeded H100 entry names; and
   ``SmiContext.explain_plan("all_reduce")`` and ``("all_to_all")`` on
   the ``(2, 4)`` world.

Then the elastic runtime's first tier:

33. the backward on a thread world: ``.backward()`` called by every rank
   of a CUDA ``LocalWorld`` inside ``run`` (autograd runs each rank's
   nodes on its own thread there), ring attention's flash and plain
   tiers at 2 and 4 ranks (``BWD_SHAPE``, f32, causal) and a 4-rank
   ``ring_shift``, each against the one-rank gradients at the f32 bar,
   with the rendezvous timeout cut to ``BWD_RENDEZVOUS_S`` and the thread
   that ran each rank's q node checked; one timed 4-rank flash backward
   at the attention phases' widths (``BWD_TIMED``); a backward called on
   the outputs after ``run`` returned must fail at once. Launches counted
   (the flash rows add them);
34. the elastic path: ``checkpoint.run_jacobi`` at N x N f32 on a 1x1
   communicator and on the 2x4 world, a step raising at iteration
   ``ELASTIC_CRASH_AT`` of ``ELASTIC_ITERS`` (cadence
   ``ELASTIC_CADENCE``), resumed, ``torch.equal`` to the uninterrupted
   run; one 256 MiB checkpoint's save from and restore to the card timed
   (GB/s beside ``nvidia-smi``'s name and power limit); checkpointed
   k-means on 8 ranks (``KMEANS_*``, ring tier); ``recover_communicator``
   dropping rank ``DROPPED`` (heirs, epoch 1, epoch 0 refused); the means
   restored on the 7 survivors and 3 more iterations there on the ring
   tier against ``reference_kmeans`` (its reduce and bcast are ring
   all-reduces), and the neighbour stream on the 7-rank ring
   ``torch.equal`` to its plain version; ``regrow`` to 8 ranks at epoch
   2 and a 4 MiB ring all-reduce ``torch.equal`` to its plain version.
   Launches counted (rows 5 and 7 add them).

Then the fault-simulator tier:

35. on an 8-rank ``LocalWorld``: ``Deadline(0.0)`` on each ring-tier
   family (``bcast``, ``reduce``, ``allreduce``, ``scatter``, ``gather``,
   a channel's ``transfer`` and ``stream``) raises ``WatchdogTimeout``
   on every rank with ``.state`` equal to ``faults.mirror_stall_dump``
   of the family's protocol, and no ring kernel launches; the credit
   simulator's all-reduce with rank ``FAULT_RANK`` crash-stopped raises
   ``DeadlockError``, and ``recover_communicator`` on it shrinks to the 7
   survivors with heir ``FAULT_HEIR``; their 4 MiB f32 ring all-reduce
   and 512 KiB neighbour stream ``torch.equal`` to the plain versions,
   credits drained, each rank's readback under ``run_with_deadline``;
   ``timed(deadline_s=, sink=OnlineTuner)`` records one sample; on the
   host, ``run_with_recovery`` heals a crash-stop on each ring protocol at
   n = 8 and the phi-accrual detector confirms a silent rank into a
   ``MembershipView``. The cells that need ``networkx`` are named and
   left out (``NETWORKX_CELLS``). Launches counted (rows 5 and 7 add
   them).

Then the analysis and observability tiers:

36. the plan engine's stencil sweep on the card: ``sweep_stencil`` at
   N x N f32 (``STENCIL_SWEEP_RUNS`` timed passes a candidate), every
   candidate's us a sweep or the port's reason for refusing it logged;
   the winner's one pass ``torch.equal`` to its plain version (f32
   compute; within 0.05 for bf16), and its kernel's time alone; the same
   sweep over the kernel's own stripes 8 and 16 (``STENCIL_SIDE_STRIPES``,
   below the cost model's grid) logged beside it. On the 8-rank ``LocalWorld`` at 4 MiB
   f32 a rank: one ring all-reduce through ``timed(sink=SampleSink())``
   records one cell, ``torch.equal`` to its plain version, credits
   drained; an expired ``Deadline(0.0, recorder=FlightRecorder())`` on
   ``allreduce(backend="ring")`` raises ``WatchdogTimeout`` on every rank
   with the recorder's tail on the error and in its state, and launches
   nothing. On the host: ``analysis.perf_all()`` and
   ``obs.trace.trace_protocol("all_reduce", 8)``, whose track ends equal
   the simulator's clocks bit for bit, each one's host time logged.
   Last, the default engine's ``stencil_pipeline_plan`` at N x N must be
   a ``[cache]`` hit on the seeded H100 entry, one that the pipeline
   kernel admits. Launches of the sweep and of the timed all-reduce are
   counted (rows 4 and 7 add them).

Then the rest of the serving tier:

37. the KV dataflow on an 8-rank ``LocalWorld``:
   ``serving.inference.traced_kv_dataflow`` at the reference's shape
   (2 requests, 8 KV chunks, 3 decode steps) on both tiers, every rank's
   tokens equal to the float64 closed form; then at full width
   (``KV_REQUESTS`` requests, ``KV_CHUNKS`` chunks, ``KV_GEN`` steps: a
   4 MiB f32 fold a rank, row 7's shape, over 32 MiB of KV a rank) on
   the default tier and on ``backend="ring"``, every rank's tokens within
   ``KV_RTOL`` of the closed form, each call's host wall logged; the
   same row sums folded once through ``allreduce(..., backend="ring")``,
   ``torch.equal`` to the kernel's plain version with credits drained,
   and that fold's device time beside its bound. On the host, with seed
   0 at their defaults, twice each: ``serve_selftest``, ``load_campaign``,
   ``retune_selftest``, ``moe_campaign`` and ``infer_selftest``, every
   gate green and both runs' sorted-JSON digests equal to the JAX
   package's report's (``SERVING_CAMPAIGNS``), each one's host wall
   logged; the campaigns that reach ``networkx`` are named and left
   out (``SERVING_NETWORKX``). Launches counted (row 7 adds them).

Then the command line:

38. ``python -m smi_tpu_torch topology -n 8`` as a subprocess, then in
   the process ``build`` of the CLI's transfer -> reduce(max) -> bcast
   app (manifest -> route -> device -> host) with ``--report``, whose
   per-op kernels must be one stream and two all-reduce launches with
   their ptxas figures; the generated host module's ``SmiInit_app``
   bootstraps the 8 ranks from the written tables (a ``LocalWorld`` of
   the card) and the generated device module's symbols run the app at
   ``SMI_ELEMS`` f32 a rank on both tiers, ``torch.equal`` across tiers
   and to ``max(x, 0)`` on every rank, the ring tier launching row 5
   once and row 7 twice, credits drained; the stream and the all-reduce
   at the app's shapes held to their plain versions, and their device
   times beside the byte bound; ``aot-verify``
   (every source built for sm_90a, every case of the JAX surface at
   v5e:2x4, v5e:4x4 and v5e:2x4*2 fitting the card, each ring kernel's
   blocks an SM from the ptxas figures equal to the runtime's); ``lint
   --combined`` and ``serve --selftest``; each command timed. Launches
   of the app and the report counted (rows 5 and 7 add them).
Then the afmoe training step's attention glue:

39. the fused kernels (``smi_tpu_torch/kernels/csrc/attn_glue.cu``)
   at ``trinity-train-2x8k``'s shape (``GLUE_CELL``: 2 x 8192 tokens, 32
   query and 4 key/value heads of 128), on a windowed layer (rotary
   tables) and a full one: each kernel against its plain version, q and k
   and every output of the epilogue and its backward within one bf16
   step, v bit for bit, ``d qkv`` within 2^-8 and the norm weights'
   gradients within 1e-3 (relative, by norm), each backward twice bit for
   bit, and a control (the plain version with the norm weights swapped,
   or the gate negated) that must land outside the bar; the launch counts
   of the four kernels and of phase 40's two set to 0 before one step of
   a 32-layer afmoe model (``GLUE_STEP_MODEL``: Trinity-Mini's layer
   pattern, two dense layers and 30 expert layers, at a small width,
   heads of 64) and read after it (64, 64, 32, 32; 193, 97); each
   kernel's time (CUDA events, 50 calls back to back; a backward called
   on this thread, held equal to autograd's) beside its byte bound (each
   operand read once and each result written once over the memory rate)
   and its plain version's (``plain_ms`` and ``library_ms``).

Then the afmoe block's residual junctions:

40. the fused kernels (``smi_tpu_torch/kernels/csrc/residual_norm.cu``)
   at ``trinity-train-2x8k``'s shape (``JUNCTION_CELL``: 2 x 8192 tokens
   of 2048), each form through its wrapper (the entry, the middle with
   its yn in bf16 and in f32, the exit) against its plain version: each
   bf16 output within one bf16 step (or 1e-5 where ``h`` cancels), each
   f32 one within 1e-6 (relative, by norm); ``d x`` within 1e-5, ``d
   out`` within 2^-8 (bf16) or 1e-5 (f32), the norm weights' gradients
   within 1e-3; each backward twice bit for bit; and a control (the plain
   version with the norm weights swapped, or the one weight reversed)
   whose every normed output and some gradient must land outside the
   bar. Phase 39's step gives the launches. Then each form's time each
   way (CUDA events, 50 launches back to back after 5, the backward with
   its weight-gradient sum) beside its byte bound and its plain
   version's (forward; autograd's backward), and the junctions' time in
   one step of the cell (each form times its launches in a step of
   Trinity-Mini's layer pattern) against their bound.

Then DeepSeek-V3's latent attention (MLA) on the flash kernels:

41. the split form of the flash kernels (queries and keys 192 wide,
   values 128: ``flash_fwd.cu`` and ``flash_bwd.cu``, bf16) at
   ``moonlight-train-2x8k``'s shape (``MLA_CELL``: S=8192 causal, 2 x 16
   heads folded): each instance's registers and spills from the build
   log; the fused forward, dq and dk/dv against their plain versions at
   the bf16 bars; each one's time (CUDA events) beside its operations
   bound (2 (192 + 128), 4·192 + 2·128 and 4·192 + 4·128 operations a
   live pair and head) and ``scaled_dot_product_attention``'s forward
   and backward at the same shape; then, every flash count set to 0,
   one step of the cell's own model (``MLA_STEP_MODEL``: 27 layers at
   published widths, 8 held experts, 20,480 vocabulary rows, 2 x 8192
   tokens), whose launches must be 54 split forwards, 27 of each split
   backward and no other flash form.

Bars: f32 out/acc/gradients within 2e-5 (``rtol = atol``); m and l within
1e-5 in either dtype (both sides add exact products in f32); bf16
out/acc/gradients by the worst row's relative error ``||got - want|| /
||want||``, within 1e-2, and each bf16 kernel check also reads a control
(the plain version with one live 64-row tile dropped), which must land
above that bar. bf16 gradient rows whose reference norm is at most 1e-3
of the median row's (0 in exact arithmetic) are left out of the reading
and counted. The train step's gradients are held per parameter by
``||g - g'|| / ||g'||``: 1e-2 in bf16, with the plain tier less one key
tile as the control, which must read above it on ``wqkv`` and ``wo``;
2e-5 in f32. Autograd through the plain tier rounds dP to bf16 (the
backward of its cast) where the kernels keep it in f32, so bf16
gradients are held to it per tensor at 1e-2, and to the kernels' plain
versions by rows.

Any failure raises and exits non-zero. The line before the last is the
per-kernel JSON record; the last line is the device JSON.
"""

import contextlib
import dataclasses
import functools
import io
import json
import math
import re
import subprocess
import sys
import time
import types

SEED = 1234
N = 8192                  # the reference's hardware grid (models/stencil.py)
BLOCK = (4096, 2048)      # one rank's block of 8192^2 on the 2x4 grid
BLOCK_AT = (4096, 6144)   # its offset: the bottom-right rank, on two edges
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet, at 700 W
F32_FLOPS = 67e12           # H100 SXM f32 outside the tensor cores
BF16_FLOPS = 989e12         # H100 SXM dense bf16 tensor cores
HEADS, HEAD_DIM = 8, 128    # the JAX package's attention rows (PERF.json)
SEQ, SEQ_LONG, WINDOW = 8192, 32768, 4096
RING = 4                    # the emulated ring's ranks
MAIN_SWEEPS = 259           # the main path's sweeps: 16 passes at k=16, 3 more
TABLE_DEPTH = 16            # the depth of PERF.md's rows 1-2
#: phase 4: (depth, block, its offset, the grid) with random halos
TEMPORAL_CASES = [
    *((k, (1000, 1500), (3000, 2000), (N, N)) for k in (1, 2, 7, 8, 16, 32)),
    *((k, (1000, 1500), (0, 0), (1000, 1500)) for k in (1, 2, 7, 8, 16, 32)),
    (16, (600, 700), (0, 3000), (N, N)),          # the top edge alone
    (16, (600, 700), (3000, 0), (N, N)),          # the left edge
    (32, (600, 700), (N - 600, 3000), (N, N)),    # the bottom edge
    (32, (600, 700), (3000, N - 700), (N, N)),    # the right edge
    (8, (16, 40), (0, 0), (16, 40)),              # under one band
]


def log(msg: str) -> None:
    print(msg, flush=True)


def main(argv=None) -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument(
        "--earlier", metavar="PATH", action="append", default=[],
        help="an earlier copy of a csrc/ source with the same C entry "
             "points, named by its stem (ring.cu: phases 24 and 27; "
             "flash_fwd.cu: phase 11; flash_bwd.cu: phase 16; "
             "stencil_temporal.cu: phase 6; stencil_pipeline.cu: phase "
             "19; roll_chain.cu: phase 30), timed in turns with the tree's "
             "kernels (earlier_ms in the kernels line; null without it); "
             "repeat for several sources")
    args = parser.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1

    import numpy as np
    import torch.nn.functional as F

    import smi_tpu_torch as st
    from smi_tpu_torch.kernels import _build
    from smi_tpu_torch.kernels import stencil as kstencil
    from smi_tpu_torch.kernels import stencil_temporal as ktemporal

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev,
                          dtype=torch.float32)

    # ---- 1. device ---------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    smi_line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "0"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    log(f"[1 device] {kind}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; {torch.cuda.device_count()} card(s)")
    log(smi_line)

    # ---- 2. build ----------------------------------------------------
    t0 = time.perf_counter()
    earlier = {}
    for path in args.earlier:
        source = EarlierSource(path)
        if source.stem in earlier:
            raise SystemExit(f"--earlier: two earlier {source.stem}.cu")
        earlier[source.stem] = source
    _build.build_kernels()
    log(f"[2 build] {_build.SOURCES} built and loaded in "
        f"{time.perf_counter() - t0:.1f} s")
    for source in earlier.values():
        built = source.load()
        log(f"  earlier {source.stem}.cu {source.path} built by "
            f"{time.perf_counter() - t0:.1f} s: " + "; ".join(
                line.strip() for line in built.splitlines()
                if "Used" in line)[:600])
    for name in _build.SOURCES:
        lines = [line.strip() for line in _build.build_log(name).splitlines()
                 if ("registers" in line or "spill" in line
                     or "entry function" in line)]
        entries = sum("entry function" in line for line in lines)
        if entries <= 8:
            for line in lines:
                log(f"  {name}: {line}")
            continue
        # a source of many template instances: the extremes
        found = {key: [int(m) for line in lines
                       for m in re.findall(pattern, line)]
                 for key, pattern in (
                     ("registers", r"Used (\d+) registers"),
                     ("stack", r"(\d+) bytes stack frame"),
                     ("spill stores", r"(\d+) bytes spill stores"),
                     ("spill loads", r"(\d+) bytes spill loads"))}
        log(f"  {name}: {entries} entry functions; registers "
            f"{min(found['registers'])}-{max(found['registers'])}, stack "
            f"frame at most {max(found['stack'])} bytes, spill stores at "
            f"most {max(found['spill stores'])} bytes, spill loads at most "
            f"{max(found['spill loads'])} bytes")
    # the wavefront kernels keep every level in registers: no instance
    # may spill
    for name in ("stencil_temporal", "stencil_pipeline"):
        spilled = [int(m) for m in re.findall(
            r"(\d+) bytes spill (?:stores|loads)", _build.build_log(name))]
        if not spilled or max(spilled):
            raise AssertionError(f"{name}: an instance spills (or no "
                                 f"-Xptxas -v lines): {spilled}")
        log(f"  {name}: {len(spilled) // 2} instances, 0 bytes of spill "
            f"stores and loads")

    max_err = {}   # (kernel, shape, depth) -> max abs err of its check

    def expect_equal(what, key, got, want):
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        max_err[key] = max(max_err.get(key, 0.0), err)
        if not torch.equal(got, want):
            raise AssertionError(f"{what}: kernel != plain, max abs err {err}")
        log(f"  {what}: array_equal (max abs err {err})")

    bh, bw = BLOCK
    r0, c0 = BLOCK_AT

    # ---- 3. single-sweep kernel vs its plain version -----------------
    log("[3 sweep kernel vs plain]")
    x = rand(N, N)
    z_row, z_col = torch.zeros(1, N, device=dev), torch.zeros(N, 1, device=dev)
    args = (x, z_row, z_row, z_col, z_col, 0, 0, N, N)
    expect_equal(f"{N}x{N} zero halos", ("sweep", (N, N), 1),
                 kstencil.fused_sweep(*args), kstencil.fused_sweep_plain(*args))
    xb = rand(bh, bw)
    args_b = (xb, rand(1, bw), rand(1, bw), rand(bh, 1), rand(bh, 1),
              r0, c0, N, N)
    expect_equal(f"{bh}x{bw} at {BLOCK_AT} random halos",
                 ("sweep", BLOCK, 1),
                 kstencil.fused_sweep(*args_b),
                 kstencil.fused_sweep_plain(*args_b))

    # ---- 4. k-sweep kernel vs its plain version ----------------------
    log("[4 k-sweep kernel vs plain]")
    for k in (8, 16):
        zt = torch.zeros(k, N + 2 * k, device=dev)
        zs = torch.zeros(N, k, device=dev)
        args = (x, zt, zt, zs, zs, 0, 0, N, N, k)
        expect_equal(f"{N}x{N} k={k} zero halos, tile "
                     f"{ktemporal._plan(N, N, k)}",
                     ("temporal", (N, N), k),
                     ktemporal.temporal_sweeps(*args),
                     ktemporal.temporal_sweeps_plain(*args))
        args_b = (xb, rand(k, bw + 2 * k), rand(k, bw + 2 * k),
                  rand(bh, k), rand(bh, k), r0, c0, N, N, k)
        expect_equal(f"{bh}x{bw} at {BLOCK_AT} k={k} random halos, tile "
                     f"{ktemporal._plan(bh, bw, k)}",
                     ("temporal", BLOCK, k),
                     ktemporal.temporal_sweeps(*args_b),
                     ktemporal.temporal_sweeps_plain(*args_b))
    # every depth (register instances and the generic loop), blocks that
    # are no multiple of the plan's stripe and band, a block under one
    # band, random halos inside the grid and at each global edge
    for k, (h, w), at, grid in TEMPORAL_CASES:
        args_c = (rand(h, w), rand(k, w + 2 * k), rand(k, w + 2 * k),
                  rand(h, k), rand(h, k), *at, *grid, k)
        expect_equal(f"{h}x{w} at {at} in {grid} k={k} random halos, plan "
                     f"{ktemporal._plan(h, w, k)}",
                     ("temporal", (h, w), k),
                     ktemporal.temporal_sweeps(*args_c),
                     ktemporal.temporal_sweeps_plain(*args_c))
    del x, xb, args, args_b, args_c

    # ---- 5. the main path at full width ------------------------------
    log("[5 main path]")
    comm = st.make_communicator(shape=(1, 1), axis_names=("sx", "sy"))
    iters = MAIN_SWEEPS
    depth = st.pick_temporal_depth(N, N, torch.float32, iters)
    if depth is None:
        raise AssertionError(f"no temporal depth for {N}x{N}")
    if iters % depth == 0:
        raise AssertionError(f"{iters} sweeps at depth {depth} leave no "
                             f"remainder for the single-sweep kernel")

    def drive(h, w):
        """The main path on an (h, w) grid: the launches it made."""
        g = st.initial_grid(h, w)
        g[:, -1] = 2.0
        block = st.block_from_numpy(g, comm)
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        out = st.make_temporal_stencil_fn(comm, iters, h, w,
                                          depth=depth)(block)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        log(f"  {h}x{w} on {comm.device} grid {comm.shape}, depth {depth}, "
            f"{iters} sweeps: {wall * 1e3:.3f} ms host wall, "
            f"launches {launches}")
        if tuple(out.shape) != (h, w) or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"main path output is not a finite "
                                 f"{(h, w)} grid")
        for name in ("stencil_sweep", "stencil_temporal"):
            n = launches[name]
            if n <= 0:
                raise AssertionError(f"kernel {name} was not launched on "
                                     f"the {h}x{w} main path")
        plain = st.make_stencil_fn(comm, iters)(block)
        torch.cuda.synchronize()
        if not torch.equal(out, plain):
            err = (out - plain).abs().max().item()
            raise AssertionError(f"{h}x{w} main path != plain stencil, max "
                                 f"abs err {err}")
        log(f"  {h}x{w}: array_equal to the plain torch stencil on the card")
        return launches

    launches = {(N, N): drive(N, N), BLOCK: drive(bh, bw)}
    small = st.initial_grid(1024, 1024)
    small[:, -1] = 2.0
    out_s = st.make_temporal_stencil_fn(comm, iters, 1024, 1024,
                                        depth=depth)(
        st.block_from_numpy(small, comm))
    if not np.array_equal(st.grid_to_numpy(out_s, comm),
                          st.reference_stencil(small, iters)):
        raise AssertionError("1024x1024 main path != numpy reference_stencil")
    log(f"  1024x1024: array_equal to the numpy reference_stencil")
    del out_s

    # ---- 6. times ----------------------------------------------------
    log("[6 times]")

    def bound(h, w, k, halo_elems):
        nbytes = 4 * (2 * h * w + halo_elems)
        ops = 4 * h * w * k
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / F32_FLOPS * 1e3
        return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                     else "operations")

    torch.backends.cudnn.allow_tf32 = False
    cross = torch.tensor([[0.0, 0.25, 0.0], [0.25, 0.0, 0.25],
                          [0.0, 0.25, 0.0]], device=dev).view(1, 1, 3, 3)

    records = []
    x = rand(N, N)
    args = (x, z_row, z_row, z_col, z_col, 0, 0, N, N)
    ms = time_ms(lambda: kstencil.fused_sweep(*args), 50)
    plain_ms = time_ms(lambda: kstencil.fused_sweep_plain(*args), 10)
    x4 = x.view(1, 1, N, N)
    lib_ms = time_ms(lambda: F.conv2d(x4, cross, padding=1), 20)
    b_ms, b_by = bound(N, N, 1, 4 * N)
    log(f"  sweep {N}x{N}: {ms:.4f} ms ({N * N / ms * 1e3:.4g} cells/s), "
        f"bound {b_ms:.4f} ms ({b_by}), plain {plain_ms:.4f} ms, "
        f"conv2d interior-average yardstick {lib_ms:.4f} ms")
    records.append({
        "name": f"stencil_sweep {N}x{N}", "route": "cuda",
        "source": "smi_tpu_torch/kernels/csrc/stencil_sweep.cu",
        "replaces": "smi_tpu/kernels/stencil.py:74",
        "launches": launches[(N, N)]["stencil_sweep"],
        "max_abs_err": max_err[("sweep", (N, N), 1)], "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
    })
    def plan_note(h, w, k):
        stripe, band = ktemporal._plan(h, w, k)
        blocks = -(-h // stripe) * -(-w // band)
        form = ktemporal.form(k)
        held = ktemporal.runtime_blocks_per_sm(band, k)
        return (f"plan (stripe {stripe}, band {band}), {form.groups} level "
                f"group(s) of {form.columns} columns a thread, "
                f"{ktemporal.threads(band, k)} threads, {blocks} blocks, "
                f"{held} an SM ({held * ktemporal.threads(band, k) // 32} "
                f"warps; the plan assumes "
                f"{ktemporal.blocks_per_sm(band, k)}), swept "
                f"{ktemporal.swept_ratio(h, w, k):.4g}x")

    k = TABLE_DEPTH   # rows 1-2 of PERF.md's table
    for (h, w), replaces in (((N, N), "smi_tpu/kernels/stencil_temporal.py:385"),
                             (BLOCK, "smi_tpu/kernels/stencil_temporal.py:195")):
        xt = x[:h, :w].contiguous()
        zt = torch.zeros(k, w + 2 * k, device=dev)
        zs = torch.zeros(h, k, device=dev)
        args = (xt, zt, zt, zs, zs, 0, 0, h, w, k)
        tree, early = in_turns(
            lambda: KernelTime.of(lambda: ktemporal.temporal_sweeps(*args)),
            earlier.get("stencil_temporal"))
        ms = tree.ms
        plain_ms = time_ms(lambda: ktemporal.temporal_sweeps_plain(*args), 3)
        b_ms, b_by = bound(h, w, k, 2 * k * (w + 2 * k) + 2 * h * k)
        earlier_note = ("" if early is None else
                        f", earlier {early.ms:.4f} ms in turns "
                        f"(equal outputs)")
        log(f"  temporal {h}x{w} k={k}: {ms:.4f} ms "
            f"({h * w * k / ms * 1e3:.4g} cell-sweeps/s){earlier_note}, "
            f"bound {b_ms:.4f} ms ({b_by}), plain {plain_ms:.4f} ms; "
            f"{plan_note(h, w, k)}")
        records.append({
            "name": f"stencil_temporal {h}x{w} k={k}", "route": "cuda",
            "source": "smi_tpu_torch/kernels/csrc/stencil_temporal.cu",
            "replaces": replaces,
            "launches": launches[(h, w)]["stencil_temporal"],
            "max_abs_err": max_err[("temporal", (h, w), k)], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None,
            "earlier_ms": None if early is None else early.ms,
        })

    # the depth picker's order on this card: ms a sweep at each depth
    for h, w in ((N, N), BLOCK):
        for k in (8, 16, 32):
            xt = x[:h, :w].contiguous()
            zt = torch.zeros(k, w + 2 * k, device=dev)
            zs = torch.zeros(h, k, device=dev)
            args = (xt, zt, zt, zs, zs, 0, 0, h, w, k)
            ms = time_ms(lambda: ktemporal.temporal_sweeps(*args), 20)
            log(f"  depth {k} at {h}x{w}: {ms:.4f} ms per pass, "
                f"{ms / k:.5f} ms per sweep; {plan_note(h, w, k)}")
    del x, xt, args
    log("  forms by depth (level groups x columns a thread): " + ", ".join(
        f"k={k} {ktemporal.form(k).groups}x{ktemporal.form(k).columns}"
        for k in sorted({TABLE_DEPTH, 8, 16, 32})))

    records += flash_phases(dev, gen, max_err, earlier.get("flash_fwd"))
    records += backward_phases(dev, gen, max_err, earlier.get("flash_bwd"))
    records += pipeline_phases(dev, gen, earlier.get("stencil_pipeline"))
    ring_records, ring_check = ring_phases(dev, gen, earlier.get("ring"))
    records += ring_records
    records += suite_phases(dev, gen, ring_check, earlier.get("ring"))
    records += surface_phases(dev, gen, earlier.get("roll_chain"))
    surface_launches = collective_surface_phase(dev, gen, smi_line)
    tuning_phase(dev, gen, smi_line)
    backward_launches = backward_world_phase(dev)
    elastic_launches = elastic_phase(dev, smi_line)
    fault_launches = fault_tier_phase(dev, smi_line)
    analysis_launches = analysis_obs_phase(dev, smi_line)
    serving_launches = serving_phase(dev, smi_line)
    cli_launches = cli_phase(dev, smi_line)
    # rows 5 and 7 count phase 31's launches beside phases 21-23's, and
    # the first record of each ring and flash kernel phases 33-38's, of
    # the pipeline kernel phase 36's
    later = {RING_REPLACES[k]: elastic_launches[k] + fault_launches[k]
             + analysis_launches.get(k, 0) + serving_launches.get(k, 0)
             + cli_launches.get(k, 0)
             for k in RING_REPLACES}
    later.update({REPLACES[k]: backward_launches[k] for k in REPLACES})
    later[PIPE_REPLACES] = analysis_launches["stencil_pipeline"]
    for record in records:
        for kernel in ("ring_all_reduce", "ring_neighbour_stream"):
            if record["replaces"] == RING_REPLACES[kernel]:
                record["launches"] += surface_launches[kernel]
        record["launches"] += later.pop(record["replaces"], 0)
    glue_records, step_launches = glue_phase(dev)
    records += glue_records
    records += junction_phase(dev, step_launches)
    records += mla_flash_phase(dev)
    log(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0




def time_ms(fn, reps):
    """Mean CUDA-event time of ``fn`` over ``reps`` calls, after three
    warm-up calls."""
    import torch

    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def timed(fn, min_reps=1):
    """:func:`time_ms` over about 0.3 s of calls (3 to 50)."""
    import torch

    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    reps = max(3, min(50, int(0.3 / max(time.perf_counter() - t0, 1e-4))))
    return time_ms(fn, max(min_reps, reps))


def flash_bound(ops, nbytes, bf16):
    """The least time of ``ops`` operations and ``nbytes`` bytes of
    device memory at the data sheet's rates: ``(ms, what binds)``."""
    t_ops = ops / (BF16_FLOPS if bf16 else F32_FLOPS) * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def live_pairs(s_q, s_k, q_off, k_off, causal, window=None):
    """Query-key pairs the mask leaves live, counted from the global
    positions: the work of a forward (4·D operations each) and of the
    backward kernels (6·D for dq, 8·D for dk/dv)."""
    import numpy as np

    q_pos = q_off + np.arange(s_q, dtype=np.int64)
    lo = np.full_like(q_pos, k_off)
    hi = np.full_like(q_pos, k_off + s_k - 1)
    if causal:
        hi = np.minimum(hi, q_pos)
    if window is not None:
        lo = np.maximum(lo, q_pos - (window - 1))
    return int(np.clip(hi - lo + 1, 0, None).sum())


def sdpa_kwargs(q, k, causal, window):
    """``scaled_dot_product_attention``'s arguments for head-major
    ``(H, S, D)`` q/k: ``is_causal``, or the boolean-mask form for a
    window, and ``enable_gqa`` for grouped K/V heads."""
    import torch

    kw = {"is_causal": causal}
    if window is not None:
        pos = torch.arange(q.shape[1], device=q.device)
        kw = {"attn_mask": (pos[None, :] <= pos[:, None])
              & (pos[None, :] > pos[:, None] - window)}
    if k.shape[0] != q.shape[0]:
        kw["enable_gqa"] = True
    return kw


def aten_ops(call, word):
    """The ``aten::_`` ops whose names hold ``word`` that ``call``
    dispatched to, by the profiler's CPU trace: a label, not a check."""
    import torch

    try:
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            call()
            torch.cuda.synchronize()
        ops = sorted({e.key for e in prof.key_averages()
                      if word in e.key and "aten::_" in e.key})
        return ", ".join(ops) or "not identified"
    except Exception as exc:  # the profiler is a label, not a check
        return f"not identified ({type(exc).__name__})"


def device_profile(call):
    """``call`` once under ``torch.profiler`` with CUDA activity: the
    kernels' device time by name from the trace, or None where the trace
    shows no device time. A reading for the breakdown, not a check."""
    import torch

    try:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        by_name = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                by_name[e.name] = (by_name.get(e.name, 0.0)
                                   + e.time_range.elapsed_us() / 1e3)
        return by_name or None
    except Exception as exc:  # a reading, not a check
        log(f"  profiler: no device trace ({type(exc).__name__}: {exc})")
        return None


def sdpa_failed(exc):
    import torch

    torch.cuda.empty_cache()
    return None, f"none ({type(exc).__name__}: {str(exc)[:120]})"


def sdpa_forward(q, k, v, causal, window):
    """One ``scaled_dot_product_attention`` call on (1, H, S, D): its time
    and the aten op it dispatched to; None where it fails."""
    import torch
    import torch.nn.functional as F

    kw = sdpa_kwargs(q, k, causal, window)

    def call():
        return F.scaled_dot_product_attention(q[None], k[None], v[None],
                                              **kw)

    try:
        call()
        torch.cuda.synchronize()
    except (RuntimeError, torch.cuda.OutOfMemoryError) as exc:
        return sdpa_failed(exc)
    return timed(call), aten_ops(call, "attention")


def sdpa_backward(q, k, v, dout, causal, window):
    """``scaled_dot_product_attention``'s backward (dq, dk and dv at once)
    on (1, H, S, D): forward plus backward less forward, and the aten ops
    of the backward; None where it fails."""
    import torch
    import torch.nn.functional as F

    kw = sdpa_kwargs(q, k, causal, window)
    leaves = [x[None].detach().clone().requires_grad_() for x in (q, k, v)]
    grad = dout[None]

    def forward():
        return F.scaled_dot_product_attention(*leaves, **kw)

    def both():
        for t in leaves:
            t.grad = None
        forward().backward(grad)

    try:
        both()
        torch.cuda.synchronize()
    except (RuntimeError, torch.cuda.OutOfMemoryError) as exc:
        return sdpa_failed(exc)
    ms = timed(both) - timed(forward)
    return ms, aten_ops(both, "backward")


FLASH_SRC = "smi_tpu_torch/kernels/csrc/flash_fwd.cu"
BWD_SRC = "smi_tpu_torch/kernels/csrc/flash_bwd.cu"
REPLACES = {"flash_fused": "smi_tpu/kernels/flash.py:492",
            "flash_block": "smi_tpu/kernels/flash.py:436",
            "flash_bwd_dq": "smi_tpu/kernels/flash.py:735",
            "flash_bwd_dkdv": "smi_tpu/kernels/flash.py:873"}
F32_TOL, STAT_TOL = 2e-5, 1e-5   # f32 out/acc/grads; m and l in either dtype
BF16_ROW_REL = 1e-2   # bf16 out/acc/grads: worst per-row relative error
CONTROL_TILE = 64     # rows a control drops: one bf16 key tile
#: bf16 gradient rows whose reference norm is at most this times the
#: median row's are left out of the worst-row reading: their gradient is
#: 0 in exact arithmetic (causal query row 0: dP = delta, so dq = 0)
GRAD_FLOOR = 1e-3

#: the 1-rank shapes: (name, S, H_kv, dtype, causal, window)
FUSED_CASES = [
    (f"S={SEQ} causal f32", SEQ, HEADS, "float32", True, None),
    (f"S={SEQ} causal bf16", SEQ, HEADS, "bfloat16", True, None),
    (f"S={SEQ // 2} non-causal f32", SEQ // 2, HEADS, "float32", False,
     None),
    (f"S={SEQ_LONG} GQA 8:1 window {WINDOW} bf16", SEQ_LONG, 1, "bfloat16",
     True, WINDOW),
]
#: phase 11: replays of a ring's folds for their device time (16 folds
#: of host launch cost each should fit in the card's first wait,
#: RING_HOLD_CYCLES)
FOLD_REPS = 7
#: phase 7's small ragged shapes at the other head dims, in f32 and
#: bf16: (name, S, H, H_kv, D, causal, window)
SMALL_CASES = [
    ("S=1000 D=64 GQA 2:1 causal", 1000, 4, 2, 64, True, None),
    ("S=200 D=256 window 100", 200, 4, 4, 256, True, 100),
]
#: the 4-layer stack's attention (PERF.json's `_l4` row: no GQA)
STACK_CASE = (f"S={SEQ_LONG} window {WINDOW} bf16", SEQ_LONG, HEADS,
              "bfloat16", True, WINDOW)
#: the emulated 4-rank rings over S=SEQ: (name, dtype, H_kv, window)
RING_CASES = [
    (f"S={SEQ} causal f32", "float32", HEADS, None),
    (f"S={SEQ} causal bf16", "bfloat16", HEADS, None),
    (f"S={SEQ} GQA 8:1 window {WINDOW} bf16", "bfloat16", 1, WINDOW),
]

EMBED = 1024          # PERF.json's transformer rows: E=1024, H=8, D=128
STACK = 4             # the `_l4` rows' depth
LR = {1: 1e-3, STACK: 1e-4}   # by depth: the loss falls over 3 steps
#: ||g - g'|| / ||g'|| of each parameter's gradient, the train step
#: against the plain tier's; the control must read above the bf16 bar
STEP_BAR = {"bfloat16": 1e-2, "float32": 2e-5}


class Bars:
    """The checks shared by the phases: each records the largest absolute
    error of its kernel's checks in ``max_err`` and raises when a reading
    is outside its bar."""

    def __init__(self, max_err):
        self.max_err = max_err

    def note(self, key, got, want):
        import torch

        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        if key is not None:
            self.max_err[key] = max(self.max_err.get(key, 0.0), err)
        return err

    def close(self, what, key, got, want, tol):
        """|got - want| <= tol + tol*|want| everywhere, as
        ``np.testing.assert_allclose(rtol=tol, atol=tol)``."""
        err = self.note(key, got, want)
        diff = (got.float() - want.float()).abs()
        bad = int((diff > tol + tol * want.float().abs()).sum())
        if bad:
            raise AssertionError(f"{what}: {bad} element(s) outside {tol}, "
                                 f"max abs err {err}")
        log(f"  {what}: within {tol} (max abs err {err:.3g})")

    @staticmethod
    def row_rel(got, want, floor=None):
        """Worst ||got - want|| / ||want|| over the rows (last axis), and
        how many rows a ``floor`` left out: those with ||want|| at most
        ``floor`` times the median row norm. Without a floor a row with
        ||want|| = 0 reads its absolute error."""
        import torch

        got, want = got.float(), want.float()
        err = (got - want).norm(dim=-1)
        ref = want.norm(dim=-1)
        if floor is None:
            return torch.where(ref > 0, err / ref, err).max().item(), 0
        keep = ref > floor * ref.median()
        return (err[keep] / ref[keep]).max().item(), int((~keep).sum())

    def rows(self, what, key, got, want, control=None, bar=None,
             floor=None):
        """bf16: every row within ``bar`` (BF16_ROW_REL) of the plain
        version; a ``control`` (the plain version with one live tile
        dropped) must read above the bar, or the bar is blind."""
        bar = BF16_ROW_REL if bar is None else bar
        err = self.note(key, got, want)
        rel, excluded = self.row_rel(got, want, floor)
        if rel > bar:
            raise AssertionError(f"{what}: worst row relative error {rel} "
                                 f"above {bar} (max abs err {err})")
        msg = (f"  {what}: worst row rel err {rel:.3g} <= {bar} "
               f"(max abs err {err:.3g}")
        msg += (f"; {excluded} of {got[..., 0].numel()} row(s) under the "
                f"floor)" if floor else ")")
        if control is not None:
            ctl, _ = self.row_rel(control, want, floor)
            if ctl <= bar:
                raise AssertionError(f"{what}: the control reads {ctl}, "
                                     f"inside the bar {bar}")
            msg += f"; control, one tile dropped: {ctl:.3g}"
        log(msg)

    def grads(self, what, keys, dtype, got, want, controls=None):
        """dq, dk, dv: f32 at F32_TOL everywhere, bf16 by the worst row
        above the GRAD_FLOOR, each beside its control."""
        import torch

        for i, (name, a, b) in enumerate(zip(("dq", "dk", "dv"), got,
                                             want)):
            key = keys[min(i, len(keys) - 1)]
            if dtype == torch.float32:
                self.close(f"{what} {name}", key, a, b, F32_TOL)
            else:
                self.rows(f"{what} {name}", key, a, b,
                          None if controls is None else controls[i],
                          floor=GRAD_FLOOR)


class ThreadRing:
    """An n-rank ring played by n threads of one process, one per rank, so
    the ring code itself runs on the card. :meth:`shift` stands in for
    ``ring_shift``: each rank leaves its block in its slot, the ranks meet
    at a barrier, each takes the block of the rank ``offset`` places to
    its left, and they meet again before a slot is reused. Every rank
    makes the same shifts in the same order, as on a real ring."""

    def __init__(self, n):
        import threading

        self.n, self.calls = n, 0
        self.slots = [None] * n
        self.barrier = threading.Barrier(n, timeout=600)
        self.lock = threading.Lock()

    def shift(self, x, comm, offset=1, axis_name=None, backend="xla"):
        r = comm.coords[comm._axis(axis_name or comm.axis_names[0])]
        self.slots[r] = x
        self.barrier.wait()
        got = self.slots[(r - offset) % self.n]
        self.barrier.wait()
        with self.lock:
            self.calls += 1
        return got

    def run(self, fn):
        """``fn(rank)`` on every rank's thread; the results in rank order.
        A failure aborts the barrier, so no rank waits for ever, and is
        raised here."""
        import threading

        out, errors = [None] * self.n, []

        def body(r):
            try:
                out[r] = fn(r)
            except BaseException as exc:  # raised again below
                errors.append(exc)
                self.barrier.abort()

        threads = [threading.Thread(target=body, args=(r,))
                   for r in range(self.n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            first = [e for e in errors
                     if not isinstance(e, threading.BrokenBarrierError)]
            raise (first or errors)[0]
        return out


@contextlib.contextmanager
def patched(module, **attrs):
    """Set ``module``'s attributes for the ``with`` block, then put the
    old ones back."""
    old = {name: getattr(module, name) for name in attrs}
    for name, value in attrs.items():
        setattr(module, name, value)
    try:
        yield
    finally:
        for name, value in old.items():
            setattr(module, name, value)


def earlier_bwd_plan(kernel, d, dtype, *shape, **kw):
    """The plan the first, ``mma.sync`` ``flash_bwd.cu`` checks: dq 64
    query rows a block and key tiles of 64 (bf16) or 32 (f32) rows; dk/dv
    32 query rows a tile and 64 keys a block, at every head dim and
    shape."""
    import torch

    from smi_tpu_torch.kernels import flash as kflash

    if kernel == kflash.KERNEL_BWD_DQ:
        return 64, 64 if dtype == torch.bfloat16 else 32
    return 32, 64



def earlier_temporal_plan(h, w, depth):
    """The plan of the first, shared-memory ``stencil_temporal.cu``: the
    largest square tile of 64, 32, 16 or 8 (cut to the block) whose two
    ``(tile + 2k)``-edged f32 windows fit a block's shared memory."""
    from smi_tpu_torch.kernels import _build

    for edge in (64, 32, 16, 8):
        th, tw = min(edge, h), min(edge, w)
        if (2 * 4 * (th + 2 * depth) * (tw + 2 * depth)
                <= _build.SMEM_BYTES_LIMIT):
            return th, tw
    return None


def earlier_pipeline_plan(h, w, depth, buffering=3, stripe=None):
    """The plan of the first, window-sweeping ``stencil_pipeline.cu``
    (its C entry refuses any other): an 8-aligned stripe dividing ``h``,
    no shorter than ``depth``, and a band of 32-224 columns whose
    ``(stripe + 2k) x (band + 2k)`` window fits the 256-edged TMA box, with
    ``buffering`` slots and a sweep buffer in shared memory; the fewest
    window cells per output cell, then the taller stripe."""
    from fractions import Fraction

    from smi_tpu_torch.kernels import _build

    if depth < 8 or depth % 8 or w < 128 or w % 128 or h < 8:
        return None
    best = None
    tallest = min(h, 256 - 2 * depth)
    for t in ([stripe] if stripe is not None else range(tallest, 7, -1)):
        if t < depth or t % 8 or h % t or t + 2 * depth > 256:
            continue
        for band in (32, 64, 96, 128, 160, 192, 224):
            if band > w or band + 2 * depth > 256:
                break
            window = 4 * (t + 2 * depth) * (band + 2 * depth)
            if ((buffering + 1) * (-(-window // 128) * 128) + 152
                    > _build.SMEM_BYTES_LIMIT):
                continue
            key = (Fraction((t + 2 * depth) * (band + 2 * depth), t * band),
                   -t)
            if best is None or key < best[0]:
                best = (key, t, band)
    return None if best is None else best[1:]


def earlier_roll_plan(rows, cols, chains, body):
    """The plan of the first, shared-memory ``roll_chain.cu``, whose C
    entry takes a tile in place of the registers and warps: each block a
    tile of every chain with the rolled axis whole and about 8192
    elements over all chains."""
    axis, other = (rows, cols) if body == "sublane" else (cols, rows)
    lines = max(1, min(other, 8192 // (chains * axis)))
    tile = (rows, lines) if body == "sublane" else (lines, cols)
    return {"tile": tile, "blocks": -(-other // lines), "args": tile}


class EarlierSource:
    """An earlier copy of a ``csrc/`` source with the tree's C entry
    points, named by its stem (``ring.cu``, ``flash_fwd.cu``,
    ``flash_bwd.cu``, ``stencil_temporal.cu``, ``stencil_pipeline.cu``,
    ``roll_chain.cu``),
    given as ``--earlier PATH`` (it is no file of the tree), built with the
    tree's flags for that source and the tree's ``csrc/`` headers into
    ``build/probe/earlier/`` beside the tree's kernels and swapped in
    where the phases time it against the tree's. It takes the tree's
    launch plan (:func:`kring.launch_plan`, ``kflash._plan``), but for an
    earlier ``flash_bwd.cu`` (:func:`earlier_bwd_plan`), and an earlier
    ``stencil_temporal.cu``, ``stencil_pipeline.cu`` or ``roll_chain.cu``
    (:func:`earlier_temporal_plan`, :func:`earlier_pipeline_plan`,
    :func:`earlier_roll_plan`), which take their first forms' plans."""

    def __init__(self, path):
        from pathlib import Path

        from smi_tpu_torch.kernels import _build

        self.path = path
        self.stem = Path(path).stem
        if self.stem not in _build.SOURCES:
            raise SystemExit(f"--earlier {path}: {self.stem}.cu is no "
                             f"source of the tree ({_build.SOURCES})")
        out_dir = Path(__file__).resolve().parent / "build" / "probe" / \
            "earlier"
        out_dir.mkdir(parents=True, exist_ok=True)
        # one library a source: a process loads a path only once
        self.lib_path = out_dir / f"lib{self.stem}.so"
        # the source's own flags and the tree's csrc/ headers, so that
        # only the source differs
        cmd = _build.nvcc_command(_build.find_nvcc(), Path(path).resolve(),
                                  self.lib_path)
        self.proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True)
        self.lib = None

    def load(self):
        """Wait for the build and load the library; raises if it
        failed."""
        import ctypes

        from smi_tpu_torch.kernels import _build

        out, _ = self.proc.communicate()
        if self.proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the earlier "
                               f"{self.stem}.cu:\n{out}")
        self.lib = _build._declare(self.stem, ctypes.CDLL(str(self.lib_path)))
        return out

    @contextlib.contextmanager
    def swapped(self):
        """The source's wrappers launch the earlier kernels in the
        block, on the earlier source's plan."""
        from smi_tpu_torch.kernels import _build
        from smi_tpu_torch.kernels import flash as kflash
        from smi_tpu_torch.kernels import roll
        from smi_tpu_torch.kernels import stencil_pipeline as kpipe
        from smi_tpu_torch.kernels import stencil_temporal as ktemporal

        module, plan = {
            "flash_bwd": (kflash, {"_bwd_plan": earlier_bwd_plan}),
            "stencil_temporal": (ktemporal,
                                 {"_plan": earlier_temporal_plan}),
            "stencil_pipeline": (kpipe, {"_plan": earlier_pipeline_plan}),
            "roll_chain": (roll, {"_plan": earlier_roll_plan}),
        }.get(self.stem, (kflash, {}))
        tree = _build._libs[self.stem]
        _build._libs[self.stem] = self.lib
        try:
            with patched(module, **plan):
                yield
        finally:
            _build._libs[self.stem] = tree


def same_outputs(tree_outs, earlier_outs):
    """:func:`in_turns`' default check: the earlier source's outputs
    equal the tree's bit for bit."""
    import torch

    for g, w in zip(tree_outs, earlier_outs):
        if not torch.equal(g, w):
            raise AssertionError("the earlier source and the tree's give "
                                 "different outputs")


def in_turns(measure, earlier, check=same_outputs):
    """``(tree, earlier)``: ``measure()`` on the tree's kernels and, with
    an earlier source (:class:`EarlierSource`), on it, in turns (earlier,
    tree, tree, earlier); ``check(tree outputs, earlier outputs)`` then
    holds the two first turns' outputs. ``measure`` returns a
    :class:`RingTime` or a :class:`KernelTime`; each side's times are the
    mean of its two turns and its outputs and record its own last
    turn's. Without an earlier source the earlier one is None."""
    if earlier is None:
        return measure(), None
    with earlier.swapped():
        e1 = measure()
    t1 = measure()
    t2 = measure()
    with earlier.swapped():
        e2 = measure()
    check(t1.outs, e1.outs)
    return t2.mean_with(t1), e2.mean_with(e1)


@dataclasses.dataclass
class KernelTime:
    """A kernel's :func:`timed` ms and the outputs of one call."""
    ms: float
    outs: object

    @classmethod
    def of(cls, call):
        return cls(timed(call), call())

    def mean_with(self, other):
        return KernelTime((self.ms + other.ms) / 2, self.outs)


def recording(fn, calls):
    """``fn`` that also appends each call's arguments to ``calls``."""
    def wrapped(*args, **kw):
        calls.append((args, kw))
        return fn(*args, **kw)
    return wrapped


def flash_phases(dev, gen, max_err, earlier=None):
    """Phases 7-11: ring attention's forward. Returns the flash kernels'
    records for the kernels line. With an earlier ``flash_fwd.cu``
    (:class:`EarlierSource`), phase 11 times it in turns with the
    tree's, each side held to the plain version's bars."""
    import numpy as np
    import torch

    import smi_tpu_torch as st
    from smi_tpu_torch.kernels import _build
    from smi_tpu_torch.kernels import flash as kflash
    from smi_tpu_torch.models import ring_attention as ra

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    f32, bf16 = torch.float32, torch.bfloat16
    scale = 1.0 / math.sqrt(HEAD_DIM)

    def heads(h, s, dtype, d=HEAD_DIM):
        return torch.randn((h, s, d), generator=gen, device=dev,
                           dtype=f32).to(dtype)

    def seq(s, h, dtype):
        return torch.randn((s, h, HEAD_DIM), generator=gen, device=dev,
                           dtype=f32).to(dtype)

    bars = Bars(max_err)
    expect_close, expect_rows = bars.close, bars.rows

    def dropped_tile(q, k, v, carry, q_off, k_off, causal, window):
        """The plain fold with the middle key tile left out: what a
        kernel that skipped one live tile would return."""
        j0 = k.shape[1] // 2 // CONTROL_TILE * CONTROL_TILE
        sc = 1.0 / math.sqrt(q.shape[2])
        for lo, hi in ((0, j0), (j0 + CONTROL_TILE, k.shape[1])):
            if lo < hi:
                carry = kflash.flash_block_attend_plain(
                    q, k[:, lo:hi], v[:, lo:hi], *carry, q_off, k_off + lo,
                    causal, sc, window=window)
        return carry

    def check_state(what, key, dtype, got, want, parts, control=None):
        """m and l at the f32 statistics bar; out/acc at F32_TOL in f32,
        by rows in bf16."""
        for part, a, b in zip(parts, got, want):
            name = f"{what} {part}"
            if part in ("m", "l"):
                expect_close(name, key, a, b, STAT_TOL)
            elif dtype == f32:
                expect_close(name, key, a, b, F32_TOL)
            else:
                expect_rows(name, key, a, b, control)

    # ---- 7. fused kernel vs its plain version -------------------------
    log("[7 fused flash kernel vs plain]")

    def check_fused(name, q, k, v, causal, window):
        h, s, d = q.shape
        args = (q, k, v, 0, 0, causal, 1.0 / math.sqrt(d))
        got = kflash.flash_attend_fused(*args, window=window)
        want = kflash.flash_attend_fused_plain(*args, window=window)
        control = None
        if q.dtype == bf16:
            _, l_c, acc_c = dropped_tile(
                q, k, v, kflash.fresh_state(h, s, d, dev), 0, 0, causal,
                window)
            control = ra._flash_finalize(acc_c, l_c, q.dtype)
        check_state(name, ("flash_fused", name), q.dtype, got, want,
                    ("out", "m", "l"), control)

    fused_inputs = {}
    for name, s, h_kv, dt, causal, window in FUSED_CASES:
        dtype = getattr(torch, dt)
        q, k, v = heads(HEADS, s, dtype), heads(h_kv, s, dtype), \
            heads(h_kv, s, dtype)
        fused_inputs[name] = (q, k, v, causal, window)
        check_fused(name, q, k, v, causal, window)
    # the redesign's edges: a ragged tail past the tiles, the other head
    # dims' box counts (one and four 128-byte boxes a row)
    for name, s, h, h_kv, d, causal, window in SMALL_CASES:
        for dtype in (f32, bf16):
            q, k, v = heads(h, s, dtype, d), heads(h_kv, s, dtype, d), \
                heads(h_kv, s, dtype, d)
            check_fused(f"{name} {str(dtype)[6:]}", q, k, v, causal, window)
    del q, k, v

    # ---- 8. carried kernel vs its plain version -----------------------
    log(f"[8 carried flash kernel vs plain] one rank's steps of a "
        f"{RING}-rank ring over S={SEQ}")
    s_loc = SEQ // RING
    q_off = (RING - 1) * s_loc
    block_cases = []   # (name, its ring, the carry's k_off, k_off)
    for ring in RING_CASES:
        ring_name, window = ring[0], ring[3]
        if window is None:
            block_cases += [
                (f"past block k_off={s_loc} {ring_name}", ring, 0, s_loc),
                (f"diagonal k_off={q_off} {ring_name}", ring, 0, q_off),
                (f"future k_off={SEQ} {ring_name}", ring, 0, SEQ),
            ]
        else:
            block_cases.append((f"window edge k_off={s_loc} {ring_name}",
                                ring, 2 * s_loc, s_loc))
    block_inputs = {}
    for name, (ring_name, dt, h_kv, window), carry_off, k_off in \
            block_cases:
        dtype = getattr(torch, dt)
        key = ("flash_block", ring_name)
        q = heads(HEADS, s_loc, dtype)
        k, v = heads(h_kv, s_loc, dtype), heads(h_kv, s_loc, dtype)
        carry = kflash.flash_block_attend_plain(
            q, k, v, *kflash.fresh_state(HEADS, s_loc, HEAD_DIM, dev),
            q_off, carry_off, True, scale, window=window)
        args = (q, k, v, *carry, q_off, k_off, True, scale)
        block_inputs[name] = (args, window)
        got = kflash.flash_block_attend(*args, window=window)
        if k_off >= SEQ:
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, carry)):
                raise AssertionError(f"{name}: the carry changed")
            max_err[key] = max(max_err.get(key, 0.0), 0.0)
            log(f"  {name}: the carry came back array_equal")
            continue
        want = kflash.flash_block_attend_plain(*args, window=window)
        control = None
        if dtype == bf16:
            control = dropped_tile(q, k, v, carry, q_off, k_off, True,
                                   window)[2]
        check_state(name, key, dtype, got, want, ("m", "l", "acc"), control)
        del got, want, control

    # ---- 9. the main path at full width -------------------------------
    log("[9 ring attention main path]")
    comm = st.make_communicator(shape=(1,), axis_names=("sp",))
    main_launches = {}
    for name, s, h_kv, dt, causal, window in FUSED_CASES:
        dtype = getattr(torch, dt)
        q, k, v = seq(s, HEADS, dtype), seq(s, h_kv, dtype), \
            seq(s, h_kv, dtype)
        fn = st.make_ring_attention_fn(comm, causal=causal, window=window)
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        out = fn(q, k, v)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        main_launches[name] = launches
        log(f"  {name} on {comm.device}: {wall * 1e3:.3f} ms host wall, "
            f"launches {launches}")
        if launches["flash_fused"] != 1 or launches["flash_block"] != 0:
            raise AssertionError(f"{name}: expected one fused launch and no "
                                 f"carried launch, got {launches}")
        if (tuple(out.shape) != (s, HEADS, HEAD_DIM) or out.dtype != dtype
                or not bool(torch.isfinite(out).all())):
            raise AssertionError(f"{name}: output is not a finite "
                                 f"{(s, HEADS, HEAD_DIM)} {dtype} tensor")
        rows = np.unique(np.linspace(0, s - 1, 256).astype(np.int64))
        group = HEADS // h_kv
        qn, kn, vn = (x.float().cpu().numpy() for x in (q, k, v))
        ref = torch.from_numpy(ra.reference_attention_rows(
            qn, np.repeat(kn, group, axis=1), np.repeat(vn, group, axis=1),
            rows, causal=causal, window=window))
        got = out[torch.from_numpy(rows).to(dev)].double().cpu()
        what = (f"{name} vs float64 reference on {len(rows)} rows "
                f"(first {rows[0]}, last {rows[-1]})")
        if dtype == f32:
            expect_close(what, ("main", name), got, ref, F32_TOL)
        else:
            expect_rows(what, ("main", name), got, ref)
        del qn, kn, vn, ref, out

    # ---- 10. the emulated ring ----------------------------------------
    log(f"[10 emulated {RING}-rank ring: make_ring_attention_fn on each "
        f"rank's shards, one thread per rank, ring_shift stood in]")
    ring_runs = {}
    for ring_name, dt, h_kv, window in RING_CASES:
        dtype = getattr(torch, dt)
        q, k, v = seq(SEQ, HEADS, dtype), seq(SEQ, h_kv, dtype), \
            seq(SEQ, h_kv, dtype)
        whole = st.make_ring_attention_fn(comm, causal=True,
                                          window=window)(q, k, v)
        ring = ThreadRing(RING)
        calls = []

        def rank(r):
            rows = slice(r * s_loc, (r + 1) * s_loc)
            return st.make_ring_attention_fn(
                st.Communicator(shape=(RING,), axis_names=("sp",), rank=r,
                                device=dev),
                causal=True, window=window)(q[rows], k[rows], v[rows])

        with patched(ra, ring_shift=ring.shift,
                     flash_block_attend=recording(
                         kflash.flash_block_attend, calls)):
            torch.cuda.synchronize()
            _build.reset_launches()
            outs = ring.run(rank)
            torch.cuda.synchronize()
            launches = dict(_build.LAUNCHES)
        log(f"  {ring_name}: launches {launches}, {ring.calls} shifts")
        if (launches["flash_block"] != RING * RING
                or launches["flash_fused"] != 0
                or ring.calls != 2 * RING * (RING - 1)):
            raise AssertionError(f"{ring_name}: expected {RING * RING} "
                                 f"carried launches and "
                                 f"{2 * RING * (RING - 1)} shifts, got "
                                 f"{launches}, {ring.calls}")
        for r, o in enumerate(outs):
            what = f"rank {r} vs its rows of the fused output"
            rows = whole[r * s_loc:(r + 1) * s_loc]
            if dtype == f32:
                expect_close(what, ("ring", ring_name), o, rows, F32_TOL)
            else:
                expect_rows(what, ("ring", ring_name), o, rows)
        ring_runs[ring_name] = (launches["flash_block"], calls)
        del q, k, v, whole, outs

    # ---- 11. times ----------------------------------------------------
    log("[11 flash times]")

    def block_work(args, window):
        """Operations and bytes of one carried fold: q/k/v are read only
        where a pair is live; the f32 carry is read and written."""
        q, k = args[0], args[1]
        h, s_q, d = q.shape
        pairs = live_pairs(s_q, k.shape[1], args[6], args[7], args[8],
                           window)
        carry = 4 * 2 * (2 * h * s_q + h * s_q * d)
        qkv = q.element_size() * (q.numel() + 2 * k.numel())
        return 4 * h * d * pairs, carry + (qkv if pairs else 0)

    def earlier_note(ms, e_ms):
        return "" if e_ms is None else \
            f"; earlier {e_ms:.4f} ms ({e_ms / ms:.3f}x)"

    def earlier_ms(e):
        return None if e is None else e.ms

    records = []
    for name, (q, k, v, causal, window) in fused_inputs.items():
        h, s, d = q.shape
        item = q.element_size()
        pairs = live_pairs(s, s, 0, 0, causal, window)
        b_ms, b_by = flash_bound(4 * h * d * pairs,
                                 item * (2 * h * s * d + 2 * k.numel())
                                 + 2 * 4 * h * s, q.dtype == bf16)
        args = (q, k, v, 0, 0, causal, scale)
        plain_ms = time_ms(
            lambda: kflash.flash_attend_fused_plain(*args, window=window), 2)
        want = kflash.flash_attend_fused_plain(*args, window=window)
        t, e = in_turns(
            lambda: KernelTime.of(
                lambda: kflash.flash_attend_fused(*args, window=window)),
            earlier,
            lambda _, got: check_state(f"earlier flash_fwd.cu, {name}", None,
                                       q.dtype, got, want, ("out", "m", "l")))
        ms, e_ms = t.ms, earlier_ms(e)
        del want
        lib_ms, backend = sdpa_forward(q, k, v, causal, window)
        tflops = 4 * h * d * pairs / ms / 1e9
        log(f"  fused {name}: {ms:.4f} ms ({tflops:.4g} TFLOP/s), bound "
            f"{b_ms:.4f} ms ({b_by}), plain {plain_ms:.4f} ms, sdpa "
            f"{lib_ms if lib_ms is None else f'{lib_ms:.4f}'} ms "
            f"[{backend}]{earlier_note(ms, e_ms)}")
        records.append({
            "name": f"flash_fused {name} H={h} D={d}", "route": "cuda",
            "source": FLASH_SRC, "replaces": REPLACES["flash_fused"],
            "launches": main_launches[name]["flash_fused"],
            "max_abs_err": max_err[("flash_fused", name)], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib_ms, "tflops": tflops, "earlier_ms": e_ms,
        })
    for name, (args, window) in block_inputs.items():
        ops, nbytes = block_work(args, window)
        b_ms, b_by = flash_bound(ops, nbytes, args[0].dtype == bf16)
        ms = timed(lambda: kflash.flash_block_attend(*args, window=window))
        plain_ms = time_ms(
            lambda: kflash.flash_block_attend_plain(*args, window=window), 2)
        log(f"  carried step, {name}: {ms:.4f} ms, bound {b_ms:.4f} ms "
            f"({b_by}), plain {plain_ms:.4f} ms")
    for ring_name, dt, h_kv, window in RING_CASES:
        launches, calls = ring_runs[ring_name]
        work = [block_work(a, kw.get("window")) for a, kw in calls]
        ops = sum(w[0] for w in work)
        b_ms, b_by = flash_bound(ops, sum(w[1] for w in work),
                                 dt == "bfloat16")
        plain_ms = time_ms(lambda: [kflash.flash_block_attend_plain(*a, **kw)
                                    for a, kw in calls], 2)

        wants = [kflash.flash_block_attend_plain(*a, **kw)
                 for a, kw in calls]

        def check_folds(side, outs):
            """Every fold's m and l, and its output so far (acc / l),
            stacked over the heads, against the plain folds' at the bars.
            acc itself is logged beside them, not held: it is a running
            sum over up to four blocks, and the elementwise f32 bar reads
            its cancelling elements at the rounding of the sums, which
            differs with the order of summation; its worst row's relative
            error reads the carry."""
            def parts(folds):
                m, l, acc = (torch.cat(x) for x in zip(*folds))
                safe_l = torch.where(l == 0, torch.ones_like(l), l)
                return m, l, acc / safe_l.transpose(1, 2), acc

            got, want = parts(outs), parts(wants)
            what = f"{side}, the {len(calls)} folds of {ring_name}"
            check_state(what, None, getattr(torch, dt), got[:3], want[:3],
                        ("m", "l", "acc / l"))
            err = bars.note(None, got[3], want[3])
            rel, _ = bars.row_rel(got[3], want[3])
            log(f"  {what} acc (logged, not held): max abs err {err:.3g}, "
                f"worst row rel err {rel:.3g}, largest |acc| "
                f"{want[3].abs().max().item():.4g}")

        def call():
            return [kflash.flash_block_attend(*a, **kw) for a, kw in calls]

        check_folds("tree", call())
        t, e = in_turns(lambda: KernelTime.of(call), earlier,
                        lambda _, outs: check_folds("earlier flash_fwd.cu",
                                                    outs))
        ms, e_ms = t.ms, earlier_ms(e)
        del wants
        # the card's own time: the folds enqueued behind a wait, so the
        # host's cost of each launch is hidden
        dev_ms = device_ms(call, FOLD_REPS)
        e_dev_ms = None
        if earlier is not None:
            with earlier.swapped():
                e_dev_ms = device_ms(call, FOLD_REPS)
        tflops = ops / ms / 1e9
        log(f"  carried, the {len(calls)} folds of the {RING}-rank ring "
            f"{ring_name}: {ms:.4f} ms ({tflops:.4g} TFLOP/s), bound "
            f"{b_ms:.4f} ms ({b_by}), plain {plain_ms:.4f} ms, no library "
            f"call folds into a carry{earlier_note(ms, e_ms)}; device time "
            f"{dev_ms:.4f} ms ({ops / dev_ms / 1e9:.4g} TFLOP/s)"
            + ("" if e_dev_ms is None else f", earlier {e_dev_ms:.4f} ms"))
        records.append({
            "name": f"flash_block {RING}-rank ring {ring_name} H={HEADS} "
                    f"D={HEAD_DIM} ({len(calls)} folds)",
            "route": "cuda", "source": FLASH_SRC,
            "replaces": REPLACES["flash_block"], "launches": launches,
            "max_abs_err": max_err[("flash_block", ring_name)], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None, "tflops": tflops, "earlier_ms": e_ms,
            "device_ms": dev_ms, "earlier_device_ms": e_dev_ms,
        })
    return records


def backward_phases(dev, gen, max_err, earlier=None):
    """Phases 12-16: the flash backward kernels, the ring's backward and
    the transformer's train step. Returns the backward kernels' records
    for the kernels line. With an earlier ``flash_bwd.cu``
    (:class:`EarlierSource`), phase 16 times it in turns with the
    tree's, each side held to the plain version's bars."""
    import torch

    import smi_tpu_torch as st
    from smi_tpu_torch.kernels import _build
    from smi_tpu_torch.kernels import flash as kflash
    from smi_tpu_torch.models import ring_attention as ra

    f32, bf16 = torch.float32, torch.bfloat16
    scale = 1.0 / math.sqrt(HEAD_DIM)
    bars = Bars(max_err)
    s_loc = SEQ // RING
    q_off = (RING - 1) * s_loc

    def randn(*shape, dtype=f32):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=f32).to(dtype)

    def kernels(args, window):
        return (kflash.flash_block_backward_dq(*args, window=window),
                *kflash.flash_block_backward_dkdv(*args, window=window))

    def plain(args, window):
        return (kflash.flash_block_backward_dq_plain(*args, window=window),
                *kflash.flash_block_backward_dkdv_plain(*args,
                                                        window=window))

    def dropped(args, window):
        """The plain versions with one live 64-row tile left out: dq
        without the middle key tile, dk and dv without the middle query
        tile. What a kernel that skipped a live tile would return."""
        q, k, v, dout, m, linv, delta, qo, ko, causal, sc = args
        s_q, s_k = q.shape[1], k.shape[1]
        kj = s_k // 2 // CONTROL_TILE * CONTROL_TILE
        qj = s_q // 2 // CONTROL_TILE * CONTROL_TILE
        dq = dk = dv = 0
        for lo, hi in ((0, kj), (kj + CONTROL_TILE, s_k)):
            if lo < hi:
                dq = dq + kflash.flash_block_backward_dq_plain(
                    q, k[:, lo:hi], v[:, lo:hi], dout, m, linv, delta, qo,
                    ko + lo, causal, sc, window=window)
        for lo, hi in ((0, qj), (qj + CONTROL_TILE, s_q)):
            if lo < hi:
                a, b = kflash.flash_block_backward_dkdv_plain(
                    q[:, lo:hi], k, v, dout[:, lo:hi], m[..., lo:hi],
                    linv[..., lo:hi], delta[..., lo:hi], qo + lo, ko,
                    causal, sc, window=window)
                dk, dv = dk + a, dv + b
        return dq, dk, dv

    def keys(name):
        return (("flash_bwd_dq", name), ("flash_bwd_dkdv", name))

    # ---- 12. backward kernels vs their plain versions -----------------
    log("[12 flash backward kernels vs plain] from a fused forward's "
        "statistics and a random dout")
    bwd_inputs = {}   # 1-rank shape -> (args, window)
    for name, s, h_kv, dt, causal, window in FUSED_CASES + [STACK_CASE]:
        dtype = getattr(torch, dt)
        q = randn(HEADS, s, HEAD_DIM, dtype=dtype)
        k, v = (randn(h_kv, s, HEAD_DIM, dtype=dtype) for _ in range(2))
        dout = randn(HEADS, s, HEAD_DIM, dtype=dtype)
        out, m, l = kflash.flash_attend_fused(q, k, v, 0, 0, causal, scale,
                                              window=window)
        args = (q, k, v, dout, m, *kflash.backward_rows(out, l, dout), 0, 0,
                causal, scale)
        bwd_inputs[name] = (args, window)
        got = kernels(args, window)
        want = plain(args, window)
        control = dropped(args, window) if dtype == bf16 else None
        bars.grads(name, keys(name), dtype, got, want, control)
        del out, got, want, control

    ring_steps = {}   # ring -> the steps' (args, window), for the record
    for ring_name, dt, h_kv, window in RING_CASES:
        dtype = getattr(torch, dt)
        q = randn(HEADS, s_loc, HEAD_DIM, dtype=dtype)
        dout = randn(HEADS, s_loc, HEAD_DIM, dtype=dtype)
        k_all, v_all = (randn(h_kv, SEQ, HEAD_DIM, dtype=dtype)
                        for _ in range(2))
        out, m, l = kflash.flash_attend_fused(q, k_all, v_all, q_off, 0,
                                              True, scale, window=window)
        rows = kflash.backward_rows(out, l, dout)
        steps = ([("past block", s_loc), ("diagonal", q_off),
                  ("future", SEQ)] if window is None
                 else [("window edge", s_loc)])
        for step_name, k_off in steps:
            what = f"{step_name} k_off={k_off} of the ring {ring_name}"
            if k_off < SEQ:
                k, v = (x[:, k_off:k_off + s_loc].contiguous()
                        for x in (k_all, v_all))
            else:
                k, v = (randn(h_kv, s_loc, HEAD_DIM, dtype=dtype)
                        for _ in range(2))
            args = (q, k, v, dout, m, *rows, q_off, k_off, True, scale)
            got = kernels(args, window)
            if k_off >= SEQ:
                torch.cuda.synchronize()
                nonzero = [int(torch.count_nonzero(t)) for t in got]
                if any(nonzero):
                    raise AssertionError(f"{what}: nonzero gradients "
                                         f"{nonzero}")
                for key in keys(ring_name):
                    max_err[key] = max(max_err.get(key, 0.0), 0.0)
                log(f"  {what}: dq, dk and dv array_equal to zeros")
                continue
            control = dropped(args, window) if dtype == bf16 else None
            bars.grads(what, keys(ring_name), dtype, got,
                       plain(args, window), control)
            ring_steps.setdefault(ring_name, []).append((args, window))
            del got, control

    # ---- 13. the ring's backward --------------------------------------
    log("[13 ring attention backward]")
    comm = st.make_communicator(shape=(1,), axis_names=("sp",))

    def seq(s, h, dtype):
        return randn(s, h, HEAD_DIM, dtype=dtype)

    def ring_grads(q, k, v, w, causal, window, **kw):
        """Autograd's q/k/v gradients of sum(out * w) on the 1-rank ring."""
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        out = st.make_ring_attention_fn(comm, causal=causal, window=window,
                                        **kw)(*leaves)
        (out.float() * w).sum().backward()
        return [t.grad for t in leaves]

    def plain_backward(q, k, v, w, causal, window):
        """The same gradients from the kernels' plain versions, forward
        and backward, without autograd: the oracle where autograd through
        the plain tier would hold H·S² probabilities."""
        qT, kT, vT = (x.transpose(0, 1).contiguous() for x in (q, k, v))
        out, m, l = kflash.flash_attend_fused_plain(qT, kT, vT, 0, 0, causal,
                                                    scale, window=window)
        doutT = w.transpose(0, 1).to(q.dtype).contiguous()
        args = (qT, kT, vT, doutT, m, *kflash.backward_rows(out, l, doutT),
                0, 0, causal, scale)
        return [g.transpose(0, 1).to(x.dtype)
                for g, x in zip(plain(args, window), (q, k, v))]

    def rel(a, b):
        return ((a.float() - b.float()).norm() / b.float().norm()).item()

    main_launches = {}
    for name, s, h_kv, dt, causal, window in FUSED_CASES:
        dtype = getattr(torch, dt)
        q, k, v = seq(s, HEADS, dtype), seq(s, h_kv, dtype), \
            seq(s, h_kv, dtype)
        w = seq(s, HEADS, f32)
        torch.cuda.synchronize()
        _build.reset_launches()
        got = ring_grads(q, k, v, w, causal, window)
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
        main_launches[name] = launches
        log(f"  1-rank {name}: launches {launches}")
        want_counts = {"flash_fused": 1, "flash_block": 0,
                       "flash_bwd_dq": 1, "flash_bwd_dkdv": 1}
        if any(launches[n] != c for n, c in want_counts.items()):
            raise AssertionError(f"{name}: expected {want_counts}, got "
                                 f"{launches}")
        for g, x in zip(got, (q, k, v)):
            if (g.shape != x.shape or g.dtype != x.dtype
                    or not bool(torch.isfinite(g).all())):
                raise AssertionError(f"{name}: a gradient is not a finite "
                                     f"{tuple(x.shape)} {x.dtype} tensor")
        bars.grads(f"1-rank {name} vs the plain versions", (None,), dtype,
                   got, plain_backward(q, k, v, w, causal, window))
        if s <= SEQ:
            # autograd through the plain tier rounds dP to bf16 (the
            # backward of its cast); the kernels, like the reference's
            # custom VJP, keep dP in f32: bf16 is held per tensor
            want = ring_grads(q, k, v, w, causal, window, use_flash=False)
            if dtype == f32:
                bars.grads(f"1-rank {name} vs the plain tier's autograd",
                           (None,), dtype, got, want)
            else:
                for gname, a, b in zip(("dq", "dk", "dv"), got, want):
                    r = rel(a, b)
                    worst, excl = Bars.row_rel(a, b, GRAD_FLOOR)
                    if r > STEP_BAR["bfloat16"]:
                        raise AssertionError(
                            f"{name} {gname} vs the plain tier's autograd: "
                            f"||g - g'|| / ||g'|| = {r}")
                    log(f"  1-rank {name} {gname} vs the plain tier's "
                        f"autograd: ||g - g'||/||g'|| {r:.3g} <= "
                        f"{STEP_BAR['bfloat16']} (worst row {worst:.3g}, "
                        f"{excl} row(s) under the floor)")
            del want
        del q, k, v, w, got

    ring_runs = {}
    shifts = 2 * RING * (RING - 1) * 2 + 2 * RING * RING
    for ring_name, dt, h_kv, window in RING_CASES:
        dtype = getattr(torch, dt)
        q, k, v = seq(SEQ, HEADS, dtype), seq(SEQ, h_kv, dtype), \
            seq(SEQ, h_kv, dtype)
        w = seq(SEQ, HEADS, f32)
        whole = ring_grads(q, k, v, w, True, window)
        ring = ThreadRing(RING)
        calls = {"flash_bwd_dq": [], "flash_bwd_dkdv": []}

        def rank(r):
            """One rank's forward and backward: the ring functions the
            flash tier's autograd.Function calls, on this rank's shards."""
            c = st.Communicator(shape=(RING,), axis_names=("sp",), rank=r,
                                device=dev)
            rows = slice(r * s_loc, (r + 1) * s_loc)
            out, m, l = ra._flash_forward(q[rows], k[rows], v[rows], c, True,
                                          "sp", window)
            return ra._flash_ring_backward(q[rows], k[rows], v[rows], out, m,
                                           l, w[rows], c, True, "sp", window)

        with patched(ra, ring_shift=ring.shift,
                     flash_block_backward_dq=recording(
                         kflash.flash_block_backward_dq,
                         calls["flash_bwd_dq"]),
                     flash_block_backward_dkdv=recording(
                         kflash.flash_block_backward_dkdv,
                         calls["flash_bwd_dkdv"])):
            torch.cuda.synchronize()
            _build.reset_launches()
            grads = ring.run(rank)
            torch.cuda.synchronize()
            launches = dict(_build.LAUNCHES)
        log(f"  emulated {RING}-rank ring {ring_name}: launches {launches}, "
            f"{ring.calls} shifts")
        n2 = RING * RING
        if (launches["flash_bwd_dq"] != n2 or launches["flash_bwd_dkdv"] != n2
                or launches["flash_block"] != n2
                or launches["flash_fused"] != 0 or ring.calls != shifts):
            raise AssertionError(f"{ring_name}: expected {n2} launches of "
                                 f"each backward kernel and {shifts} "
                                 f"shifts, got {launches}, {ring.calls}")
        for r, g in enumerate(grads):
            rows = slice(r * s_loc, (r + 1) * s_loc)
            bars.grads(f"rank {r} vs its rows of the 1-rank gradients",
                       (None,), dtype, g, [x[rows] for x in whole])
        ring_runs[ring_name] = (launches, calls)
        del q, k, v, w, whole, grads

    q, k, v = (seq(s_loc, HEADS, f32) for _ in range(3))
    w = seq(s_loc, HEADS, f32)
    saved = ring_grads(q, k, v, w, True, None, reps=2)
    remat = ring_grads(q, k, v, w, True, None, reps=2, remat_reps=True)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(saved, remat))
    bars.grads(f"remat_reps, 2 reps S={s_loc} f32, vs saved residuals "
               f"(array_equal: {same})", (None,), f32, remat, saved)
    del q, k, v, w, saved, remat

    # ---- 14. the train step at full width -----------------------------
    grid = st.make_communicator(shape=(1, 1), axis_names=("dp", "sp"))

    def train(cfg, params, x, y, layers, steps, use_flash=None):
        """``steps`` of ``make_train_step`` from fresh weights: the losses,
        the first step's gradients, each step's launches and host wall."""
        model = st.params_from_numpy(params, cfg)
        step = st.make_train_step(grid, cfg, lr=LR[layers],
                                  use_flash=use_flash, layers=layers)
        losses, counts, walls, grads = [], [], [], None
        for i in range(steps):
            torch.cuda.synchronize()
            _build.reset_launches()
            t0 = time.perf_counter()
            loss = float(step(model, x, y))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            counts.append(dict(_build.LAUNCHES))
            losses.append(loss)
            if i == 0:
                grads = {n: p.grad.clone()
                         for n, p in model.named_parameters()}
        return losses, grads, counts, walls, (model, step)

    def expect_steps(what, losses, counts, layers):
        want = {"flash_fused": 2 * layers if layers > 1 else 1,
                "flash_block": 0, "flash_bwd_dq": layers,
                "flash_bwd_dkdv": layers}
        for i, c in enumerate(counts):
            if any(c[n] != k for n, k in want.items()):
                raise AssertionError(f"{what} step {i}: expected {want}, "
                                     f"got {c}")
        if not all(math.isfinite(x) for x in losses) or not all(
                b < a for a, b in zip(losses, losses[1:])):
            raise AssertionError(f"{what}: the loss does not fall: {losses}")
        log(f"  {what}: losses {losses}, each step's launches {want}")

    def drop_key_tile():
        """The plain tier with the middle key tile of every fold left out:
        the control of the train step's gradients."""
        real = kflash.flash_block_attend_plain

        def fold(q, k, v, m, l, acc, qo, ko, causal, sc, precision=None,
                 window=None):
            j0 = k.shape[1] // 2 // CONTROL_TILE * CONTROL_TILE
            carry = (m, l, acc)
            for lo, hi in ((0, j0), (j0 + CONTROL_TILE, k.shape[1])):
                if lo < hi:
                    carry = real(q, k[:, lo:hi], v[:, lo:hi], *carry, qo,
                                 ko + lo, causal, sc, window=window)
            return carry
        return patched(ra, flash_block_attend_plain=fold)

    def attention_share(model, step, x, y):
        """One step with a CUDA event pair around every flash launch: the
        kernels' event time by name and the step's, on the one stream."""
        real, pairs = kflash._launch, []

        def launch(kernel, *args):
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            real(kernel, *args)
            b.record()
            pairs.append((kernel, a, b))

        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        with patched(kflash, _launch=launch):
            torch.cuda.synchronize()
            a.record()
            step(model, x, y)
            b.record()
            torch.cuda.synchronize()
        per = {}
        for kernel, s0, s1 in pairs:
            per[kernel] = per.get(kernel, 0.0) + s0.elapsed_time(s1)
        return per, a.elapsed_time(b)

    def report(what, tokens, walls, live, x, y):
        """The step's host wall and tokens/s, the three flash kernels'
        share of one step's event time, and one step's device trace."""
        per, step_ms = attention_share(*live, x, y)
        wall = sum(walls[1:]) / len(walls[1:])
        attn = sum(per.values())
        log(f"  {what}: {wall * 1e3:.3f} ms host wall per step (steps 2-"
            f"{len(walls)}), {tokens / wall:.6g} tokens/s; instrumented step "
            f"{step_ms:.3f} ms of events, attention kernels {attn:.3f} ms "
            f"({100 * attn / step_ms:.1f} %): "
            + ", ".join(f"{n} {t:.3f} ms" for n, t in sorted(per.items())))
        model, step = live
        trace = device_profile(lambda: step(model, x, y))
        if trace is not None:
            busy = sum(trace.values())
            kinds = {"flash kernels": 0.0, "matrix products": 0.0,
                     "elementwise, reductions, copies": 0.0}
            for n, t in trace.items():
                kind = ("flash kernels" if "flash_" in n else
                        "matrix products" if any(w in n.lower() for w in (
                            "gemm", "nvjet", "xmma", "cutlass")) else
                        "elementwise, reductions, copies")
                kinds[kind] += t
            top = sorted(trace.items(), key=lambda kv: -kv[1])[:8]
            log(f"  {what}, one step under the profiler: kernels busy "
                f"{busy:.3f} ms on the card, {100 * busy / (wall * 1e3):.1f} "
                f"% of the host wall per step ({len(trace)} kernel names): "
                + ", ".join(f"{k} {t:.3f} ms" for k, t in kinds.items())
                + "; most time: " + "; ".join(f"{n[:60]} {t:.3f} ms"
                                              for n, t in top))
        return wall

    log(f"[14 train step: E={EMBED}, H={HEADS}, D={HEAD_DIM}, B=1, S={SEQ}, "
        f"causal, 1 layer, on a 1x1 (dp, sp) grid]")
    step_counts = {}
    x, y = randn(1, SEQ, EMBED), randn(1, SEQ, EMBED)
    for cd in ("bfloat16", "float32"):
        cfg = st.BlockConfig(embed=EMBED, heads=HEADS, head_dim=HEAD_DIM,
                             compute_dtype=cd)
        params = st.init_params(cfg, seed=SEED)
        steps = 3 if cd == "bfloat16" else 1
        losses, grads, counts, walls, live = train(cfg, params, x, y, 1,
                                                   steps)
        expect_steps(f"{cd} compute, flash tier", losses, counts, 1)
        _, want, _, _, _ = train(cfg, params, x, y, 1, 1, use_flash=False)
        control = None
        if cd == "bfloat16":
            step_counts[1] = counts[0]
            with drop_key_tile():
                _, control, _, _, _ = train(cfg, params, x, y, 1, 1,
                                            use_flash=False)
        bar = STEP_BAR[cd]
        for n, g in grads.items():
            r = rel(g, want[n])
            if r > bar:
                raise AssertionError(f"{cd} step: {n}'s gradient reads "
                                     f"{r} against the plain tier, above "
                                     f"{bar}")
            msg = f"  {cd} {n}: ||g - g'||/||g'|| {r:.3g} <= {bar}"
            if control is not None:
                c = rel(control[n], want[n])
                # the attention's own weights must see a dropped key tile
                if n in ("wqkv", "wo") and c <= bar:
                    raise AssertionError(f"{n}: the control reads {c}, "
                                         f"inside the bar {bar}")
                msg += f"; control, one key tile dropped: {c:.3g}"
            log(msg)
        if cd == "bfloat16":
            wall_1 = report(f"{cd} step", SEQ, walls, live, x, y)
        del grads, want, control, live

    # ---- 15. the 4-layer stack ----------------------------------------
    log(f"[15 {STACK}-layer stack: S={SEQ_LONG}, window {WINDOW}, bf16, "
        f"per-block recompute]")
    cfg = st.BlockConfig(embed=EMBED, heads=HEADS, head_dim=HEAD_DIM,
                         window=WINDOW, compute_dtype="bfloat16")
    x, y = randn(1, SEQ_LONG, EMBED), randn(1, SEQ_LONG, EMBED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, _, counts, walls, live = train(
        cfg, st.init_stack_params(cfg, STACK, seed=SEED), x, y, STACK, 3)
    peak = torch.cuda.max_memory_allocated()
    expect_steps(f"{STACK}-layer stack", losses, counts, STACK)
    step_counts[STACK] = counts[0]
    log(f"  torch.cuda.max_memory_allocated over the 3 steps: {peak} bytes "
        f"({peak / 2**30:.3f} GiB)")
    wall_4 = report(f"{STACK}-layer stack step", SEQ_LONG, walls, live,
                    x, y)
    del x, y, live

    # ---- 16. times ----------------------------------------------------
    log("[16 flash backward times]")

    def work(kernel, args, window):
        """Operations and bytes of one backward launch: the inputs are
        read only where a pair is live; the f32 gradients are written."""
        q, k = args[0], args[1]
        h, s_q, d = q.shape
        pairs = live_pairs(s_q, k.shape[1], args[7], args[8], args[9],
                           window)
        ins = q.element_size() * (2 * q.numel() + 2 * k.numel()) \
            + 3 * 4 * h * s_q
        dq = kernel == "flash_bwd_dq"
        outs = 4 * (q.numel() if dq else 2 * k.numel())
        return (6 if dq else 8) * d * h * pairs, outs + (ins if pairs else 0)

    fns = {"flash_bwd_dq": (kflash.flash_block_backward_dq,
                            kflash.flash_block_backward_dq_plain),
           "flash_bwd_dkdv": (kflash.flash_block_backward_dkdv,
                              kflash.flash_block_backward_dkdv_plain)}
    records = []

    def hold(what, calls, outs, wants):
        """Every call's gradients against its plain version's at the
        bars, one line for all: f32 within F32_TOL everywhere, bf16 by
        the worst row above the GRAD_FLOOR; where the plain gradient is
        zeros (a future block), zeros."""
        worst = 0.0
        for (args, _), got, want in zip(calls, outs, wants):
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            for a, b in zip(got, want):
                a, b = a.float(), b.float()
                if not bool(b.any()):
                    if bool(a.any()):
                        raise AssertionError(f"{what}: nonzero gradients "
                                             f"where the plain ones are 0")
                elif args[0].dtype == f32:
                    diff = (a - b).abs()
                    if bool((diff > F32_TOL + F32_TOL * b.abs()).any()):
                        raise AssertionError(
                            f"{what}: outside {F32_TOL}, max abs err "
                            f"{diff.max().item()}")
                    worst = max(worst, diff.max().item())
                else:
                    rel, _ = Bars.row_rel(a, b, GRAD_FLOOR)
                    if rel > BF16_ROW_REL:
                        raise AssertionError(f"{what}: worst row relative "
                                             f"error {rel} above "
                                             f"{BF16_ROW_REL}")
                    worst = max(worst, rel)
        reading = ("max abs err" if calls[0][0][0].dtype == f32
                   else "row rel err")
        log(f"  {what}: every output within its bar (worst {reading} "
            f"{worst:.3g})")

    def record(kernel, name, err_key, launches, calls, lib_ms):
        ops = nbytes = 0
        for args, window in calls:
            o, b = work(kernel, args, window)
            ops, nbytes = ops + o, nbytes + b
        q, k = calls[0][0][:2]
        b_ms, b_by = flash_bound(ops, nbytes, q.dtype == bf16)
        fn, fn_plain = fns[kernel]
        plan = kflash._bwd_plan(kernel, q.shape[2], q.dtype, s_k=k.shape[1],
                                h_kv=k.shape[0], sms=kflash._sm_count(dev))
        blocks = kflash.bwd_blocks(kernel, plan, q.shape[0], k.shape[0],
                                   q.shape[1], k.shape[1], q.shape[2])

        def call():
            return [fn(*a, window=w) for a, w in calls]

        plain_ms = time_ms(lambda: [fn_plain(*a, window=w)
                                    for a, w in calls], 1)
        wants = None if earlier is None else [fn_plain(*a, window=w)
                                              for a, w in calls]
        t, e = in_turns(lambda: KernelTime.of(call), earlier,
                        lambda _, outs: hold(
                            f"earlier flash_bwd.cu, {kernel} {name}", calls,
                            outs, wants))
        ms, e_ms = t.ms, None if e is None else e.ms
        del wants, t, e
        # where the few-blocks rule chose bf16 dk/dv's 64-key form, the
        # 128-key form's time beside it
        unsplit_ms = None
        if plan != kflash._bwd_plan(kernel, q.shape[2], q.dtype):
            with patched(kflash, _sm_count=lambda device: 0):
                unsplit_ms = timed(call)
        log(f"  {kernel} {name}: {ms:.4f} ms ({ops / ms / 1e9:.4g} TFLOP/s), "
            f"bound {b_ms:.4f} ms ({b_by}), plain {plain_ms:.4f} ms, "
            f"launches on its main path {launches}, plan {plan}, {blocks} "
            f"blocks a launch"
            + ("" if unsplit_ms is None else
               f", the 128-key form {unsplit_ms:.4f} ms")
            + ("" if e_ms is None else
               f"; earlier {e_ms:.4f} ms ({e_ms / ms:.3f}x)"))
        records.append({
            "name": f"{kernel} {name}", "route": "cuda", "source": BWD_SRC,
            "replaces": REPLACES[kernel], "launches": launches,
            "max_abs_err": max_err[(kernel, err_key)],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": lib_ms,
            "tflops": ops / ms / 1e9, "blocks": blocks, "earlier_ms": e_ms,
            "unsplit_ms": unsplit_ms,
        })

    for name, s, h_kv, dt, causal, window in FUSED_CASES + [STACK_CASE]:
        args, _ = bwd_inputs[name]
        q, k, v, dout = args[:4]
        lib_ms, backend = sdpa_backward(q, k, v, dout, causal, window)
        log(f"  {name}: sdpa backward (dq, dk and dv) "
            f"{lib_ms if lib_ms is None else f'{lib_ms:.4f}'} ms "
            f"[{backend}]")
        if name == STACK_CASE[0]:
            path, counts = f"[{STACK}-layer stack step]", step_counts[STACK]
        elif name == f"S={SEQ} causal bf16":
            path, counts = "[train step]", step_counts[1]
        else:
            path, counts = "[1-rank ring backward]", main_launches[name]
        for kernel in fns:
            record(kernel, f"{name} H={HEADS} D={HEAD_DIM} {path}", name,
                   counts[kernel], [(args, window)], lib_ms)
    for ring_name, dt, h_kv, window in RING_CASES:
        launches, calls = ring_runs[ring_name]
        for kernel in fns:
            steps = [(a, kw.get("window")) for a, kw in calls[kernel]]
            record(kernel, f"{ring_name} [{RING}-rank ring, "
                   f"{len(steps)} steps, H={HEADS} D={HEAD_DIM}]", ring_name,
                   launches[kernel], steps, None)
    log(f"  train step {SEQ / wall_1:.6g} tokens/s, {STACK}-layer stack "
        f"{SEQ_LONG / wall_4:.6g} tokens/s (host wall, steps 2-3)")
    return records


PIPE_SRC = "smi_tpu_torch/kernels/csrc/stencil_pipeline.cu"
PIPE_REPLACES = "smi_tpu/kernels/stencil_pipeline.py:185"
PIPE_DEPTHS = (8, 16, 32)
#: phase 17: (depth, block, its offset, the grid, stripe) with random halos
PIPE_CASES = [
    # a ragged last band inside the grid (k=24: the generic loop)
    *((k, (512, 1408), (1024, 2048), (N, N), None) for k in (8, 16, 24, 32)),
    # the same block as the whole grid: all four global edges
    *((k, (512, 1408), (0, 0), (512, 1408), None) for k in (8, 16, 32)),
    (16, (72, 384), (8, 128), (200, 1024), 24),   # a named stripe
]


def pipeline_phases(dev, gen, earlier=None):
    """Phases 17-19: the explicit-copy stencil pipeline. Returns its
    records for the kernels line. With an earlier ``stencil_pipeline.cu``
    (:class:`EarlierSource`), phase 19 times it in turns with the tree's,
    on its own plan, outputs equal bit for bit."""
    import numpy as np
    import torch

    import smi_tpu_torch as st
    from smi_tpu_torch.kernels import _build
    from smi_tpu_torch.kernels import stencil as kstencil
    from smi_tpu_torch.kernels import stencil_pipeline as kpipe
    from smi_tpu_torch.kernels import stencil_temporal as ktemporal

    dtypes = kpipe.COMPUTE_DTYPES
    max_err = {}   # (compute dtype, depth) -> max abs err of its checks

    def extended(h, w, k, halos):
        """A random ``(h+2k, w+2k)`` extended state; zeros in its border
        unless ``halos`` (random corner-complete halos)."""
        ext = torch.rand((h + 2 * k, w + 2 * k), generator=gen, device=dev)
        if not halos:
            ext[:k], ext[h + k:] = 0.0, 0.0
            ext[:, :k], ext[:, w + k:] = 0.0, 0.0
        return ext

    # ---- 17. the pipeline kernel vs its plain version -----------------
    log("[17 pipeline kernel vs plain] torch.equal, every depth, dtype and "
        "buffering")
    for k in PIPE_DEPTHS:
        for (h, w), at, halos in (((N, N), (0, 0), False),
                                  (BLOCK, BLOCK_AT, True)):
            ext = extended(h, w, k, halos)
            for cd in dtypes:
                want = kpipe.pipeline_sweeps_plain(ext, *at, N, N, k, cd)
                for buffering in (1, kpipe.PIPELINE_SLOTS):
                    got = kpipe.pipeline_sweeps(ext, *at, N, N, k,
                                                compute_dtype=cd,
                                                buffering=buffering)
                    torch.cuda.synchronize()
                    err = (got - want).abs().max().item()
                    max_err[(cd, k)] = max(max_err.get((cd, k), 0.0), err)
                    what = (f"{h}x{w} at {at} k={k} {cd} buffering "
                            f"{buffering}, {'random' if halos else 'zero'} "
                            f"halos, plan {kpipe._plan(h, w, k, buffering)}")
                    if not torch.equal(got, want):
                        raise AssertionError(f"{what}: kernel != plain, max "
                                             f"abs err {err}")
                    log(f"  {what}: torch.equal")
                del want, got
            del ext
    for k, (h, w), at, grid, stripe in PIPE_CASES:
        ext = extended(h, w, k, True)
        for cd in dtypes:
            want = kpipe.pipeline_sweeps_plain(ext, *at, *grid, k, cd)
            for buffering in (1, kpipe.PIPELINE_SLOTS):
                got = kpipe.pipeline_sweeps(ext, *at, *grid, k,
                                            stripe=stripe, compute_dtype=cd,
                                            buffering=buffering)
                torch.cuda.synchronize()
                err = (got - want).abs().max().item()
                max_err[(cd, k)] = max(max_err.get((cd, k), 0.0), err)
                what = (f"{h}x{w} at {at} in {grid} k={k} {cd} buffering "
                        f"{buffering}, random halos, plan "
                        f"{kpipe._plan(h, w, k, buffering, stripe)}")
                if not torch.equal(got, want):
                    raise AssertionError(f"{what}: kernel != plain, max "
                                         f"abs err {err}")
                log(f"  {what}: torch.equal")
            del want, got
        del ext

    # ---- 18. the path at full width -----------------------------------
    log("[18 pipeline main path] make_pipeline_stencil_fn on a 1x1 grid")
    comm = st.make_communicator(shape=(1, 1), axis_names=("sx", "sy"))

    @contextlib.contextmanager
    def plain_kernels():
        """The path with both kernel wrappers on their plain versions."""
        def sweeps(ext, row0, col0, gh, gw, depth, stripe=None,
                   compute_dtype="float32", buffering=3, out=None):
            h, w = ext.shape[0] - 2 * depth, ext.shape[1] - 2 * depth
            interior = out[depth:depth + h, depth:depth + w]
            interior.copy_(kpipe.pipeline_sweeps_plain(
                ext, row0, col0, gh, gw, depth, compute_dtype))
            return interior

        with patched(kpipe, pipeline_sweeps=sweeps), \
                patched(kstencil, fused_sweep=kstencil.fused_sweep_plain):
            yield

    g = st.initial_grid(N, N)
    g[:, -1] = 2.0
    block = st.block_from_numpy(g, comm)
    launches = {}
    for k in PIPE_DEPTHS:
        iters = 16 * k + 3
        outs = {}
        for cd in dtypes:
            fn = st.make_pipeline_stencil_fn(comm, iters, N, N, depth=k,
                                             compute_dtype=cd)
            torch.cuda.synchronize()
            _build.reset_launches()
            t0 = time.perf_counter()
            out = fn(block)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            made = dict(_build.LAUNCHES)
            launches[(cd, k)] = made["stencil_pipeline"]
            log(f"  {N}x{N} k={k} {cd}, {iters} sweeps: {wall * 1e3:.3f} ms "
                f"host wall ({N * N * iters / wall:.4g} cells/s), launches "
                f"{made}")
            if made["stencil_pipeline"] <= 0 or made["stencil_sweep"] <= 0:
                raise AssertionError(f"k={k} {cd}: the path did not launch "
                                     f"both stencil_pipeline and "
                                     f"stencil_sweep: {made}")
            if (tuple(out.shape) != (N, N) or out.dtype != torch.float32
                    or not bool(torch.isfinite(out).all())):
                raise AssertionError(f"k={k} {cd}: not a finite {N}x{N} "
                                     f"f32 grid")
            if cd == "float32":
                want, against = (st.make_stencil_fn(comm, iters)(block),
                                 "the plain torch stencil")
            else:
                with plain_kernels():
                    _build.reset_launches()
                    want = fn(block)
                    if any(_build.LAUNCHES.values()):
                        raise AssertionError("the plain path launched a "
                                             "kernel")
                against = "the same path on the plain versions"
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                err = (out - want).abs().max().item()
                raise AssertionError(f"k={k} {cd}: path != {against}, max "
                                     f"abs err {err}")
            log(f"  k={k} {cd}: torch.equal to {against}")
            outs[cd] = out
            del want
        log(f"  k={k}: bf16 path vs f32 path, max abs diff "
            f"{(outs['bfloat16'] - outs['float32']).abs().max().item()}")
        del outs
    small = st.initial_grid(1024, 1024)
    small[:, -1] = 2.0
    iters = 16 * 16 + 3
    out_s = st.make_pipeline_stencil_fn(comm, iters, 1024, 1024, depth=16)(
        st.block_from_numpy(small, comm))
    if not np.array_equal(st.grid_to_numpy(out_s, comm),
                          st.reference_stencil(small, iters)):
        raise AssertionError("1024x1024 pipeline path != numpy "
                             "reference_stencil")
    log(f"  1024x1024 k=16, {iters} sweeps: array_equal to the numpy "
        f"reference_stencil")
    del block, out_s

    # ---- 19. times -----------------------------------------------------
    log(f"[19 pipeline times] {N}x{N}, one pass (CUDA events)")

    def launch(ext, out, k, cd, buffering, stripe, band):
        """One launch at an explicit plan (the overlap measurement: both
        bufferings at one window shape); not counted."""
        _build.check(kpipe.KERNEL, _build.entry(kpipe.KERNEL)(
            ext.data_ptr(), out.data_ptr(), N, N, 0, 0, N, N, k, stripe,
            band, int(cd == "bfloat16"), buffering,
            torch.cuda.current_stream().cuda_stream))

    def plan_note(k, cd, buffering):
        stripe, band = kpipe._plan(N, N, k, buffering)
        held = _build.runtime_blocks_per_sm(
            kpipe.KERNEL, k, stripe, band, int(cd == "bfloat16"), buffering)
        return (f"plan (stripe {stripe}, band {band}), "
                f"{kpipe.window_threads(band, k)} threads, "
                f"{kpipe.pipeline_smem_bytes(stripe, band, k, buffering)} B "
                f"of shared memory, {held} blocks an SM")

    records = []
    for k in PIPE_DEPTHS:
        ext = extended(N, N, k, False)
        out = torch.empty_like(ext)
        out_e = torch.empty_like(ext)
        nbytes = 4 * (ext.numel() + N * N)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = 4 * N * N * k / F32_FLOPS * 1e3
        b_ms, b_by = max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                           else "operations")
        zt = torch.zeros(k, N + 2 * k, device=dev)
        zs = torch.zeros(N, k, device=dev)
        xt = ext[k:k + N, k:k + N].contiguous()
        targs = (xt, zt, zt, zs, zs, 0, 0, N, N, k)
        temporal_ms = time_ms(lambda: ktemporal.temporal_sweeps(*targs), 20)
        stripe, band = kpipe._plan(N, N, k, kpipe.PIPELINE_SLOTS)
        sync_plan = kpipe._plan(N, N, k, 1)
        for cd in dtypes:
            sides = iter((out, out_e, out_e, out))   # the turns' buffers

            def measure():
                dst = next(sides)
                return KernelTime(time_ms(lambda: kpipe.pipeline_sweeps(
                    ext, 0, 0, N, N, k, compute_dtype=cd, out=dst), 20),
                    dst[k:k + N, k:k + N])

            tree, early = in_turns(measure, earlier)
            ms = tree.ms
            sync_same = time_ms(lambda: launch(ext, out, k, cd, 1, stripe,
                                               band), 20)
            ring_same = time_ms(lambda: launch(ext, out, k, cd, 3, stripe,
                                               band), 20)
            sync_own = time_ms(lambda: kpipe.pipeline_sweeps(
                ext, 0, 0, N, N, k, compute_dtype=cd, buffering=1, out=out),
                20)
            plain_ms = time_ms(lambda: kpipe.pipeline_sweeps_plain(
                ext, 0, 0, N, N, k, cd), 3)
            earlier_note = ("" if early is None else
                            f", earlier {early.ms:.4f} ms in turns (equal "
                            f"outputs)")
            log(f"  k={k} {cd}: ring {ms:.4f} ms per pass ("
                f"{N * N * k / ms * 1e3:.4g} cell-sweeps/s){earlier_note}, "
                f"{plan_note(k, cd, kpipe.PIPELINE_SLOTS)}, "
                f"bound {b_ms:.4f} ms ({b_by}), plain {plain_ms:.4f} ms, "
                f"temporal kernel at k={k} {temporal_ms:.4f} ms; at the "
                f"ring's window: buffering 1 {sync_same:.4f} ms, buffering 3 "
                f"{ring_same:.4f} ms (sync/ring {sync_same / ring_same:.4f}); "
                f"buffering 1 at its own plan {sync_plan}: {sync_own:.4f} "
                f"ms; no single PyTorch call does k sweeps (library none)")
            records.append({
                "name": f"stencil_pipeline {N}x{N} k={k} {cd}",
                "route": "cuda", "source": PIPE_SRC,
                "replaces": PIPE_REPLACES, "launches": launches[(cd, k)],
                "max_abs_err": max_err[(cd, k)], "ms": ms,
                "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": None,
                "earlier_ms": None if early is None else early.ms,
            })
        del ext, out, out_e, xt
    return records


RING_SRC = "smi_tpu_torch/kernels/csrc/ring.cu"
RING_REPLACES = {"ring_neighbour_stream": "smi_tpu/kernels/ring.py:838",
                 "ring_all_gather": "smi_tpu/kernels/ring.py:388",
                 "ring_all_reduce": "smi_tpu/kernels/ring.py:495",
                 "ring_reduce_scatter": "smi_tpu/kernels/ring.py:718"}
RING_KERNELS = tuple(RING_REPLACES)
SMI_RANKS = 8             # the reference's 8-device cluster
SMI_ELEMS = 1 << 20       # 4 MiB of f32 a rank: the priced all-reduce payload
HALF_MIB = 1 << 17        # 512 KiB of f32: the microbenchmarks' message
STREAM_CHUNKS = 16
#: the channel's stream of phase 21 (SMI_ELEMS in chunks of 2072)
CHANNEL_CHUNKS, CHANNEL_ELEMS = 507, 2072
#: phase 24: the stream's slice floors compared with the plan's
STREAM_FLOORS = (2048, 4096, 8192, 16384)
API_ROOT = 5
PROBE_ELEMS = 1024        # 4 KiB of f32: one block a rank (or a chunk)


RING_REPS = 21
RING_HOLD_CYCLES = 40_000_000   # the card's first wait while the host enqueues
HOLD_TRIES = 4                  # each try waits 4x as long as the one before


RING_LAUNCHES = 5


def device_ms(fn, reps=RING_REPS):
    """The device time of the work ``fn`` enqueues on the current
    stream: one call to warm up, then ``reps`` calls back to back behind
    a wait of the card, so the card runs them one after the other and
    the host's enqueue time is hidden; a CUDA event between calls, and
    the median of the ``reps`` times. The first wait is
    ``RING_HOLD_CYCLES``; a try whose wait ended before the host had
    enqueued every call is thrown away and made again behind a wait four
    times as long, since a host that shares its cores enqueues slower at
    times. Raises if the wait of the last of ``HOLD_TRIES`` tries ended
    first too."""
    import statistics

    import torch

    fn()
    hold = RING_HOLD_CYCLES
    for tries in range(HOLD_TRIES, 0, -1):
        marks = [torch.cuda.Event(enable_timing=True)
                 for _ in range(reps + 1)]
        torch.cuda._sleep(hold)
        marks[0].record()
        for mark in marks[1:]:
            fn()
            mark.record()
        ran_out = marks[0].query()
        marks[-1].synchronize()
        if not ran_out:
            return statistics.median(a.elapsed_time(b)
                                     for a, b in zip(marks, marks[1:]))
        if tries == 1:
            raise AssertionError(f"the card ran out of its wait before the "
                                 f"host had enqueued the calls, "
                                 f"{HOLD_TRIES} times up to {hold} cycles")
        log(f"  (the card's wait of {hold} cycles ran out before the host "
            f"had enqueued {reps} calls; timed again behind "
            f"{4 * hold} cycles)")
        hold *= 4


@dataclasses.dataclass
class RingTime:
    """One ring launch timed: ``ms`` its device time (:func:`device_ms`
    of the launch replayed), ``launch_ms`` one launch through the wrapper
    on an idle card (the median of ``RING_LAUNCHES`` by the wrapper's
    events, the host's launch cost included), and the outputs and credit
    record of the last such launch."""
    ms: float
    launch_ms: float
    outs: list
    record: dict

    def mean_with(self, other):
        return RingTime((self.ms + other.ms) / 2,
                        (self.launch_ms + other.launch_ms) / 2,
                        self.outs, self.record)


def ring_kernel_ms(world, fn):
    """The :class:`RingTime` of the one grid that ``world.run(fn)``
    launches. The launch (its arguments as the rendezvous made them) is
    replayed for :func:`device_ms` on the world's stream; a replay zeroes
    the flags (a fill of a few KiB, inside the time) and rewrites the
    same outputs, as every launch does."""
    import statistics

    import torch

    from smi_tpu_torch.kernels import ring as kring

    calls = []
    launch = kring._launch
    with patched(kring, _launch=recording(launch, calls)):
        outs = world.run(fn)
    (args, kw), = calls
    with torch.cuda.device(world.device), torch.cuda.stream(world.stream):
        ms = device_ms(lambda: launch(*args, **kw))
    launches = []
    for _ in range(RING_LAUNCHES):
        outs = world.run(fn)
        record = kring.last_record(world)
        launches.append(record["ms"])
    return RingTime(ms, statistics.median(launches), outs, record)


#: phase 24: host-clock repetitions of each part of one ring launch
SPLIT_REPS = 50
#: the C entry's codes for a grid of no blocks (refused before any CUDA
#: call) and for one too large to be resident (refused after the queries)
CUDA_INVALID_VALUE, CUDA_COOPERATIVE_TOO_LARGE = 1, 720


def launch_split(world, fn):
    """Where one ring launch's host time goes. ``world.run(fn)`` makes one
    launch (``RING_LAUNCHES`` times), whose ``_launch`` and C entry
    arguments are recorded; then each part runs ``SPLIT_REPS`` times on
    the host clock, the median in us: ``alone`` the whole ``_launch`` on
    the main thread (no rank thread alive), ``fill`` the zero fill of the
    flags, ``device`` the device context, ``stream`` the stream handle,
    ``ctypes`` the C call alone (a grid of no blocks, refused before any
    CUDA call), ``queries`` what the C entry asks before it launches (a
    grid too large, refused after that, less ``ctypes``), ``launch`` the
    launch (the whole entry less both), ``events`` the wrapper's two
    event records, and ``rest`` what ``_launch`` spends besides (the plan,
    the state and the table check); ``rendezvous`` is the host time of
    the same ``_launch`` at the rendezvous, where the other rank threads,
    released by the same barrier as the leader, go on to the next one
    meanwhile. ``event_rendezvous_ms`` and ``event_alone_ms`` are one
    launch's time by the wrapper's own events, at the rendezvous and from
    the main thread."""
    import statistics

    import torch

    from smi_tpu_torch.kernels import _build
    from smi_tpu_torch.kernels import ring as kring

    launch, entry = kring._launch, _build.entry
    calls, c_calls, at_rendezvous, event_rendezvous = [], [], [], []

    def timed_launch(*args, **kw):
        t0 = time.perf_counter()
        launch(*args, **kw)
        at_rendezvous.append((time.perf_counter() - t0) * 1e6)
        calls.append((args, kw))

    def recorded_entry(kernel):
        fn = entry(kernel)

        def call(*args):
            c_calls.append((fn, args))
            return fn(*args)
        return call

    with patched(kring, _launch=timed_launch), \
            patched(_build, entry=recorded_entry):
        for _ in range(RING_LAUNCHES):
            world.run(fn)
            event_rendezvous.append(kring.last_record(world)["ms"])
    (args, kw), (c_entry, c_args) = calls[-1], c_calls[-1]
    last = world.ring_state["last_launch"]
    state = world.ring_state[("stream", last["stream"])]
    flags = state["flags"][:, :last["chunks"] * last["blocks"]]
    begin, end = state["events"]

    def host_us(part, expect=None):
        times = []
        for _ in range(SPLIT_REPS):
            flags.zero_()
            torch.cuda.synchronize(world.device)
            t0 = time.perf_counter()
            got = part()
            times.append((time.perf_counter() - t0) * 1e6)
            torch.cuda.synchronize(world.device)
            if expect is not None and got != expect:
                raise AssertionError(f"launch split: the C entry returned "
                                     f"{got}, expected {expect}")
        return statistics.median(times)

    def entry_with(blocks):
        return lambda: c_entry(*c_args[:-2], blocks, c_args[-1])

    def alone():
        launch(*args, **kw)

    def device():
        with torch.cuda.device(world.device):
            pass

    queue = world.stream   # where the rendezvous launches

    def stream():
        torch.cuda.current_stream(world.device).cuda_stream

    def events():
        begin.record(queue)
        end.record(queue)

    event_alone = []
    with torch.cuda.device(world.device), torch.cuda.stream(world.stream):
        split = {
            "alone": host_us(alone),
            "fill": host_us(flags.zero_),
            "device": host_us(device),
            "stream": host_us(stream),
            "ctypes": host_us(entry_with(0), CUDA_INVALID_VALUE),
            "too_large": host_us(entry_with(1 << 20),
                                 CUDA_COOPERATIVE_TOO_LARGE),
            "entry": host_us(entry_with(c_args[-2]), 0),
            "events": host_us(events),
        }
        for _ in range(SPLIT_REPS):
            launch(*args, **kw)
            end.synchronize()
            event_alone.append(begin.elapsed_time(end))
    split["queries"] = split.pop("too_large") - split["ctypes"]
    split["launch"] = split.pop("entry") - split["queries"] - split["ctypes"]
    split["rest"] = split["alone"] - sum(
        split[k] for k in ("fill", "device", "stream", "ctypes", "queries",
                           "launch", "events"))
    split["rendezvous"] = statistics.median(at_rendezvous)
    split["event_rendezvous_ms"] = statistics.median(event_rendezvous)
    split["event_alone_ms"] = statistics.median(event_alone)
    return split


def ring_phases(dev, gen, earlier=None):
    """Phases 20-24: the SMI API on the ring tier, eight ranks on the
    card. Returns the ring kernels' records for the kernels line, and
    phase 20's check of one launch against its plain version. With an
    earlier ``ring.cu`` (:class:`EarlierSource`), phase 24 times it in
    turns with the tree's."""
    import numpy as np
    import torch

    import smi_tpu_torch as st
    from smi_tpu_torch.kernels import _build
    from smi_tpu_torch.kernels import ring as kring

    f32, i32 = torch.float32, torch.int32
    worlds = {}

    def world(n):
        if n not in worlds:
            worlds[n] = st.LocalWorld(n)
        return worlds[n]

    def rnd(shape, dtype):
        if dtype.is_floating_point:
            return torch.rand(shape, generator=gen, device=dev,
                              dtype=f32).add_(0.5).to(dtype)
        # nonzero, so that dropping even a 1-element input shows
        v = torch.randint(-100, 99, shape, generator=gen, device=dev,
                          dtype=i32)
        return (v + (v >= 0)).to(dtype)

    # what each kernel is called with, and its plain version per ring
    calls = {
        "ring_all_reduce": (
            lambda x, c, kw: kring.ring_all_reduce(x, c, **kw),
            lambda xs, kw: kring.ring_all_reduce_plain(
                xs, kw.get("op", "add"))),
        "ring_all_gather": (
            lambda x, c, kw: kring.ring_all_gather(x, c, **kw),
            lambda xs, kw: kring.ring_all_gather_plain(xs)),
        "ring_reduce_scatter": (
            lambda x, c, kw: kring.ring_reduce_scatter(x, c, **kw),
            lambda xs, kw: kring.ring_reduce_scatter_plain(
                xs, kw.get("op", "add"))),
        "ring_neighbour_stream": (
            lambda x, c, kw: kring.neighbour_stream(x, c, **kw),
            lambda xs, kw: kring.neighbour_stream_plain(
                xs, kw.get("direction", 1))),
    }
    max_err = {k: 0.0 for k in RING_KERNELS}
    checked = [0]

    def check(kernel, n, shape, dtype, w=None, **kw):
        """One launch against the plain version: equal on every rank,
        every credit domain drained, and the plain version less rank 1's
        contribution not equal. ``w`` is the world (a flat ring of ``n``
        by default); with ``axis_name`` in ``kw`` the launch plays every
        line of that axis and the plain version runs once a line."""
        w = w or world(n)
        n = w.size
        xs = [rnd(shape, dtype) for _ in range(n)]
        call, plain_ring = calls[kernel]
        got = w.run(lambda c: call(xs[c.rank], c, kw))
        record = kring.last_record(w)
        plain_kw = {k: v for k, v in kw.items()
                    if k in ("op", "direction")}
        lines = w.lines(kw.get("axis_name"))

        def plain(xs, plain_kw):
            outs = [None] * n
            for line in lines:
                for r, out in zip(line, plain_ring([xs[r] for r in line],
                                                   plain_kw)):
                    outs[r] = out
            return outs

        want = plain(xs, plain_kw)
        what = (f"{kernel} {len(lines)} ring(s) of {len(lines[0])} "
                f"{tuple(shape)} {str(dtype)[6:]} {kw or ''}")
        for r in range(n):
            err = (got[r].double() - want[r].double()).abs().max().item()
            max_err[kernel] = max(max_err[kernel], err)
            if not torch.equal(got[r], want[r]):
                raise AssertionError(f"{what}: rank {r} kernel != plain, "
                                     f"max abs err {err}")
        if not kring.drained(record):
            raise AssertionError(
                f"{what}: credits did not drain: granted "
                f"{int(record['granted'].sum())}, consumed "
                f"{int(record['consumed'].sum())}, received "
                f"{int(record['credits_received'].sum())}")
        if kernel == "ring_neighbour_stream" and record["flow_control"]:
            # every live block granted and consumed chunks - 2 credits
            live = record["barrier"] == 2
            credits = max(0, shape[0] - 2)
            if not (bool(live.any())
                    and bool((record["granted"][live] == credits).all())
                    and bool((record["consumed"][live] == credits).all())):
                raise AssertionError(f"{what}: a live block did not grant "
                                     f"and consume {credits} credits")
        dropped = list(xs)
        dropped[1] = torch.zeros_like(xs[1])
        control = plain(dropped, plain_kw)
        if all(torch.equal(got[r], control[r]) for r in range(n)):
            raise AssertionError(f"{what}: equal to the plain version "
                                 f"without rank 1's contribution")
        checked[0] += 1
        return (f"{what}: equal on {n} ranks, {record['blocks']} blocks a "
                f"rank, credits granted = consumed = "
                f"{int(record['granted'].sum())}")

    # ---- 20. each ring kernel vs its plain version --------------------
    log("[20 ring kernels vs plain]")
    n = SMI_RANKS
    full = [
        ("ring_all_reduce", (SMI_ELEMS,), f32, {}),
        ("ring_all_reduce", (SMI_ELEMS,), i32, {"op": "max"}),
        ("ring_all_gather", (HALF_MIB,), f32, {}),
        ("ring_reduce_scatter", (n * HALF_MIB,), f32, {}),
        ("ring_neighbour_stream", (STREAM_CHUNKS, HALF_MIB // STREAM_CHUNKS),
         f32, {}),
        ("ring_neighbour_stream", (STREAM_CHUNKS, HALF_MIB // STREAM_CHUNKS),
         f32, {"direction": -1, "stream": 1}),
    ]
    for kernel, shape, dtype, kw in full:
        log("  " + check(kernel, n, shape, dtype, **kw))
    # the shapes the main path gives the stream kernel: the channel's 507
    # chunks of 2072 elements against the ring's direction, and the
    # stencil's one-chunk halo slabs on the sub-rings of the 2x4 world,
    # every line of an axis in one launch, on stream slots 0-3
    log("  " + check("ring_neighbour_stream", n,
                     (CHANNEL_CHUNKS, CHANNEL_ELEMS), f32, direction=-1))
    w24 = st.LocalWorld((2, 4), ("sx", "sy"))
    for axis, width, slots in (("sx", 2048, (0, 1)), ("sy", 4096, (2, 3))):
        for direction, slot in zip((1, -1), slots):
            log("  " + check("ring_neighbour_stream", 8, (1, width), f32,
                             w=w24, axis_name=axis, direction=direction,
                             stream=slot))
    for m in (2, 3):
        small = []
        for dtype in (f32, torch.bfloat16, torch.int8):
            small += [
                ("ring_all_reduce", (3, 130), dtype, {}),
                ("ring_all_gather", (3, 130), dtype, {}),
                ("ring_reduce_scatter", (2 * m, 130), dtype, {"op": "min"}),
                ("ring_neighbour_stream", (5, 130), dtype, {}),
                ("ring_neighbour_stream", (5, 130), dtype,
                 {"direction": -1}),
            ]
        small += [
            ("ring_all_reduce", (1000,), f32, {"op": "max"}),
            ("ring_all_gather", (1000,), f32, {}),
            ("ring_reduce_scatter", (m, 1000), f32, {}),
            ("ring_neighbour_stream", (4, 250), f32, {}),
        ]
        for kernel, shape, dtype, kw in small:
            check(kernel, m, shape, dtype, **kw)
        log(f"  n={m}: {len(small)} cases (width 130 in f32, bf16 and "
            f"int8, both directions, 1000 elements) equal and drained")
    # without credits only what cannot be overwritten is safe: one step
    # (n=2), and a stream of two chunks, one a slot
    for kernel, m, shape in (("ring_all_reduce", 2, (SMI_ELEMS,)),
                             ("ring_all_gather", 2, (HALF_MIB,)),
                             ("ring_reduce_scatter", 2, (2 * HALF_MIB,)),
                             ("ring_neighbour_stream", n, (2, HALF_MIB // 2))):
        log("  " + check(kernel, m, shape, f32, flow_control=False))
    log(f"  {checked[0]} launches checked, each with its "
        f"dropped-contribution control unequal")

    launches = {k: 0 for k in RING_KERNELS}

    def counted(what, expect):
        """Read the launch counts of a path just driven; each must be
        what the path's calls add up to."""
        got = {k: _build.LAUNCHES[k] for k in RING_KERNELS}
        log(f"  {what}: launches {got}")
        if got != expect:
            raise AssertionError(f"{what}: launches {got}, expected "
                                 f"{expect}")
        for k, v in got.items():
            launches[k] += v

    # ---- 21. the SMI API at full width --------------------------------
    log("[21 SMI API through smi_kernel, 8 ranks]")
    w8 = world(n)
    rng = np.random.default_rng(SEED)
    x_np = (rng.random(n * SMI_ELEMS, dtype=np.float32) + 0.5)
    xi_np = rng.integers(-1000, 1000, n * SMI_ELEMS, dtype=np.int32)
    per = x_np.reshape(n, SMI_ELEMS)
    per_i = xi_np.reshape(n, SMI_ELEMS)

    def api(backend):
        @st.smi_kernel(w8, in_specs="smi", out_specs="smi", backend=backend)
        def run(ctx, x, xi):
            ch = ctx.open_channel(port=0, src=0, dst=API_ROOT,
                                  count=SMI_ELEMS, dtype="float")
            ch_s = ctx.open_channel(port=1, src=API_ROOT, dst=API_ROOT + 1,
                                    count=SMI_ELEMS, dtype="float",
                                    buffer_size=2048)
            streamed, total = ctx.stream(
                ch_s, x, consumer=lambda c, chunk: c + chunk.sum(),
                init_carry=torch.zeros((), device=x.device))
            return (
                ctx.bcast(x, root=API_ROOT),
                ctx.reduce(x, op="add", root=API_ROOT),
                ctx.reduce(xi, op="max", root=API_ROOT),
                ctx.allreduce(x),
                ctx.allreduce(xi),
                ctx.scatter(x, root=API_ROOT),
                ctx.gather(x[:HALF_MIB], root=API_ROOT)[None],
                ctx.transfer(ch, x),
                streamed, total[None],
                # two collectives back to back in different flag domains
                ctx.bcast(xi, root=1, port=1),
                ctx.reduce(xi, op="min", root=2, port=2),
            )
        return run

    names = ("bcast", "reduce add", "reduce max", "allreduce f32",
             "allreduce i32", "scatter", "gather", "transfer", "stream",
             "stream total", "bcast port 1", "reduce min port 2")
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    ring_out = api("ring")(x_np, xi_np)
    wall = time.perf_counter() - t0
    counted(f"ring tier ({wall * 1e3:.1f} ms host wall)",
            {"ring_all_reduce": 7, "ring_reduce_scatter": 1,
             "ring_all_gather": 1, "ring_neighbour_stream": 4})
    xla_out = api("xla")(x_np, xi_np)
    if any(_build.LAUNCHES[k] != launches[k] for k in RING_KERNELS):
        raise AssertionError("the xla tier launched a ring kernel")

    def rows(t):
        return t.reshape(n, -1)

    def zeros_off(what, t, root):
        for r in range(n):
            if r != root and bool(rows(t)[r].any()):
                raise AssertionError(f"{what}: rank {r} is not zeros")

    def dev_of(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def expect(what, got, want, rtol=0.0):
        want = dev_of(want)
        if rtol:
            ok = torch.allclose(got, want, rtol=rtol, atol=0.0)
        else:
            ok = torch.equal(got, want)
        if not ok:
            raise AssertionError(
                f"{what} != numpy, max abs err "
                f"{(got.double() - want.double()).abs().max().item()}")

    ring = dict(zip(names, ring_out))
    xla = dict(zip(names, xla_out))
    sum64 = per.astype(np.float64).sum(0)
    for r in range(n):
        expect(f"bcast rank {r}", rows(ring["bcast"])[r], per[API_ROOT])
        expect(f"allreduce f32 rank {r}", rows(ring["allreduce f32"])[r],
               sum64.astype(np.float32), rtol=1e-6)
        expect(f"allreduce i32 rank {r}", rows(ring["allreduce i32"])[r],
               per_i.sum(0, dtype=np.int32))
        expect(f"scatter rank {r}", rows(ring["scatter"])[r],
               per[API_ROOT][r * HALF_MIB:(r + 1) * HALF_MIB])
        expect(f"bcast port 1 rank {r}", rows(ring["bcast port 1"])[r],
               per_i[1])
    expect("reduce add at root", rows(ring["reduce add"])[API_ROOT],
           sum64.astype(np.float32), rtol=1e-6)
    expect("reduce max at root", rows(ring["reduce max"])[API_ROOT],
           per_i.max(0))
    expect("reduce min at root", rows(ring["reduce min port 2"])[2],
           per_i.min(0))
    expect("gather at root", rows(ring["gather"])[API_ROOT],
           per[:, :HALF_MIB].reshape(-1))
    expect("transfer at dst", rows(ring["transfer"])[API_ROOT], per[0])
    expect("stream at dst", rows(ring["stream"])[API_ROOT + 1],
           per[API_ROOT])
    expect("stream consumer at dst", ring["stream total"][API_ROOT + 1],
           np.float32(per[API_ROOT].astype(np.float64).sum()), rtol=1e-5)
    for what, root in (("reduce add", API_ROOT), ("reduce max", API_ROOT),
                       ("gather", API_ROOT), ("transfer", API_ROOT),
                       ("stream", API_ROOT + 1),
                       ("reduce min port 2", 2)):
        zeros_off(what, ring[what], root)
    for what in names:
        if what in ("reduce add", "allreduce f32", "stream total"):
            # another association of the same f32 sum
            if not torch.allclose(ring[what], xla[what], rtol=1e-6,
                                  atol=0.0):
                raise AssertionError(f"{what}: ring and xla tiers differ "
                                     f"beyond 1e-6")
        elif not torch.equal(ring[what], xla[what]):
            raise AssertionError(f"{what}: ring tier != xla tier")
    log(f"  12 results equal to numpy (f32 ADD within 1e-6 relative), "
        f"zeros off-root, and to the xla tier (exactly but for f32 ADD); "
        f"transfer 0->{API_ROOT} made 3 hops in direction -1, stream "
        f"{API_ROOT}->{API_ROOT + 1} moved "
        f"{CHANNEL_CHUNKS} chunks of {CHANNEL_ELEMS} elements in one launch")
    del ring, xla, ring_out, xla_out

    # ---- 22. the applications ----------------------------------------
    log("[22 k-means on 8 ranks, GESUMMV on 2]")
    points, k, dims, iters = 65536, 8, 2, 10
    prng = np.random.RandomState(0)
    pts = prng.rand(points, dims).astype(np.float32)
    init = pts[:k].copy()
    kmeans = st.make_kmeans_fn(w8, iters, backend="ring")
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    means = kmeans(pts, init)
    torch.cuda.synchronize()
    kmeans_wall = time.perf_counter() - t0
    counted(f"k-means {points} points k={k} {iters} iterations "
            f"({kmeans_wall * 1e3:.1f} ms host wall, "
            f"{points * iters / kmeans_wall:.4g} point-iterations/s)",
            {"ring_all_reduce": 4 * iters, "ring_reduce_scatter": 0,
             "ring_all_gather": 0, "ring_neighbour_stream": 0})
    np.testing.assert_allclose(means.cpu().numpy(),
                               st.reference_kmeans(pts, init, iters),
                               rtol=1e-3, atol=1e-4)
    log("  k-means within rtol 1e-3, atol 1e-4 of reference_kmeans")
    size = 1024
    grng = np.random.RandomState(0)
    a = grng.rand(size, size).astype(np.float32)
    b = grng.rand(size, size).astype(np.float32)
    xv = grng.rand(size).astype(np.float32)
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on for torch.matmul")
    gesummv = st.make_gesummv_fn(world(2), size, 1.5, 0.5, buffer_size=2048,
                                 backend="ring")
    _build.reset_launches()
    y = gesummv(np.stack([a, b]), xv)
    counted(f"GESUMMV n={size}",
            {"ring_all_reduce": 0, "ring_reduce_scatter": 0,
             "ring_all_gather": 0, "ring_neighbour_stream": 1})
    np.testing.assert_allclose(y.cpu().numpy(),
                               st.reference_gesummv(a, b, xv, 1.5, 0.5),
                               rtol=2e-3)
    log("  GESUMMV within rtol 2e-3 of reference_gesummv (torch.matmul "
        "in full f32: TF32 off)")

    # ---- 23. the stencil across ranks on the card ---------------------
    log("[23 8192x8192 stencil on the 2x4 world]")
    sweeps = 8
    grid = st.initial_grid(N, N)
    grid[:, -1] = 2.0
    grid[N // 2, :] = 0.5

    def stencil(backend):
        blocks = w24.run(lambda c: st.make_stencil_fn(
            c, sweeps, backend=backend)(st.block_from_numpy(grid, c)))
        return torch.cat([torch.cat(blocks[r * 4:(r + 1) * 4], dim=1)
                          for r in range(2)], dim=0)

    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    ring_grid = stencil("ring")
    wall = time.perf_counter() - t0
    counted(f"{sweeps} sweeps, backend ring ({wall * 1e3:.1f} ms host wall)",
            {"ring_all_reduce": 0, "ring_reduce_scatter": 0,
             "ring_all_gather": 0, "ring_neighbour_stream": 4 * sweeps})
    log("  four shifts a sweep, one launch each: a launch plays every "
        "line of its axis at once (the two sy rings of four ranks, or "
        "the four sx rings of two)")
    xla_grid = stencil("xla")
    if not torch.equal(ring_grid, xla_grid):
        raise AssertionError("2x4 stencil: ring tier != xla tier")
    del xla_grid
    comm11 = st.make_communicator(shape=(1, 1), axis_names=("sx", "sy"))
    one = st.make_stencil_fn(comm11, sweeps)(st.block_from_numpy(grid,
                                                                  comm11))
    torch.cuda.synchronize()
    if not torch.equal(ring_grid, one):
        raise AssertionError(
            f"2x4 stencil over the ring tier != the 1x1 plain stencil, max "
            f"abs err {(ring_grid - one).abs().max().item()}")
    log("  torch.equal to backend xla and to the 1x1 plain stencil")
    del ring_grid, one

    # ---- 24. times -----------------------------------------------------
    log("[24 ring kernel times, 8 ranks]")
    records = []

    def bound(nbytes):
        return nbytes / HBM_BYTES_PER_S * 1e3

    # the handshake's own price: one block a rank, 4 KiB units, so the
    # copies are a few loads a thread; us a step over the n-1 steps of a
    # collective, or over the stream's chunks. The all-reduce on rings of
    # 2, 4 and 8 ranks parts a step from the launch's fixed cost.
    step_us, ring_of = {}, {}
    for m in (2, 4):
        xs = [rnd((PROBE_ELEMS,), f32) for _ in range(m)]
        t, e = in_turns(lambda: ring_kernel_ms(
            world(m), lambda c: kring.ring_all_reduce(xs[c.rank], c)),
            earlier)
        ring_of[m] = (t.ms, e and e.ms)
    for kernel, shape, steps in (
            ("ring_all_reduce", (PROBE_ELEMS,), n - 1),
            ("ring_all_gather", (PROBE_ELEMS,), n - 1),
            ("ring_reduce_scatter", (n * PROBE_ELEMS,), n - 1),
            ("ring_neighbour_stream", (STREAM_CHUNKS, PROBE_ELEMS),
             STREAM_CHUNKS)):
        xs = [rnd(shape, f32) for _ in range(n)]
        call = calls[kernel][0]
        t, e = in_turns(
            lambda: ring_kernel_ms(w8, lambda c: call(xs[c.rank], c, {})),
            earlier)
        ms, e_ms, blocks = t.ms, e and e.ms, t.record["blocks"]
        step_us[kernel] = (ms * 1e3 / steps,
                           None if e_ms is None else e_ms * 1e3 / steps)
        if kernel == "ring_all_reduce":
            ring_of[n] = (ms, e_ms)
        log(f"  handshake probe {kernel} {tuple(shape)} f32, {blocks} "
            f"block(s) a rank: {ms:.4f} ms, {step_us[kernel][0]:.3f} us a "
            f"step over {steps}" + ("" if e_ms is None else
                                    f"; earlier {e_ms:.4f} ms, "
                                    f"{step_us[kernel][1]:.3f} us a step"))
    for i, what in ((0, "tree"), (1, "earlier")):
        if ring_of[n][i] is not None:
            t2, t4, t8 = (ring_of[m][i] * 1e3 for m in (2, 4, n))
            log(f"  handshake probe ring_all_reduce ({PROBE_ELEMS},) f32 on "
                f"rings of 2 / 4 / {n} ranks ({what}): {t2:.3f} / {t4:.3f} "
                f"/ {t8:.3f} us; {(t8 - t2) / (n - 2):.3f} us a step beyond "
                f"the first, {t2 - (t8 - t2) / (n - 2):.3f} us fixed")

    # one launch's host side by part, rows 5-9, at the shapes timed below
    # (the chunked all-reduce at phase 27's 4 MiB in four chunks)
    side = int(SMI_ELEMS ** 0.5)
    splits = {}
    for kernel, shape, call in (
            ("ring_neighbour_stream", (STREAM_CHUNKS, HALF_MIB // STREAM_CHUNKS),
             kring.neighbour_stream),
            ("ring_all_gather", (HALF_MIB,), kring.ring_all_gather),
            ("ring_all_reduce", (SMI_ELEMS,), kring.ring_all_reduce),
            ("ring_all_reduce_chunked", (side, side),
             lambda x, c: kring.ring_all_reduce(x, c, chunks=4)),
            ("ring_reduce_scatter", (n * HALF_MIB,),
             kring.ring_reduce_scatter)):
        xs = [rnd(shape, f32) for _ in range(n)]
        sides = [("tree", launch_split(
            w8, lambda c: call(xs[c.rank], c)))]
        if earlier is not None:
            with earlier.swapped():
                sides.append(("earlier", launch_split(
                    w8, lambda c: call(xs[c.rank], c))))
        for what, sp in sides:
            log(f"  host split of one {kernel} {shape} launch ({what}), us: "
                f"alone {sp['alone']:.2f} = fill {sp['fill']:.2f} + device "
                f"{sp['device']:.2f} + stream {sp['stream']:.2f} + ctypes "
                f"{sp['ctypes']:.2f} + C queries {sp['queries']:.2f} + "
                f"launch {sp['launch']:.2f} + events {sp['events']:.2f} + "
                f"rest {sp['rest']:.2f}; at the rendezvous "
                f"{sp['rendezvous']:.2f}; by the wrapper's events "
                f"{sp['event_rendezvous_ms']:.4f} ms "
                f"at the rendezvous, {sp['event_alone_ms']:.4f} ms alone")
        splits[kernel] = (shape, dict(sides))

    # the stream's slice floor: its device time at the plan's floor and at
    # others, at both of its timed shapes
    floor_ms = {}
    for shape in ((STREAM_CHUNKS, HALF_MIB // STREAM_CHUNKS),
                  (CHANNEL_CHUNKS, CHANNEL_ELEMS)):
        xs = [rnd(shape, f32) for _ in range(n)]
        got = {}
        for floor in STREAM_FLOORS:
            with patched(kring, STREAM_SLICE_BYTES=floor):
                t = ring_kernel_ms(
                    w8, lambda c: kring.neighbour_stream(xs[c.rank], c))
            got[floor] = (t.ms, t.record["blocks"])
        log(f"  stream {shape} f32 by slice floor (the plan's "
            f"{kring.STREAM_SLICE_BYTES}): " + "; ".join(
                f"{floor} B {ms:.4f} ms ({blocks} blocks a rank)"
                for floor, (ms, blocks) in got.items()))
        floor_ms[shape] = {str(f): ms for f, (ms, _) in got.items()}

    p_ar, p_half = 4 * SMI_ELEMS, 4 * HALF_MIB
    p_channel = 4 * CHANNEL_CHUNKS * CHANNEL_ELEMS
    timed_cases = [
        # kernel, name, shape, bytes of all ranks' inputs and outputs
        # (each once: the bound), bytes the ring schedule moves in device
        # memory (ring.cu's note; logged, not a bound), library call
        ("ring_all_reduce", f"n={n} {SMI_ELEMS} f32 add", (SMI_ELEMS,),
         n * 2 * p_ar, n * (3 * n - 1) * p_ar,
         lambda xs: torch.stack(xs).sum(0)),
        ("ring_all_gather", f"n={n} {HALF_MIB} f32 a rank", (HALF_MIB,),
         n * (1 + n) * p_half, n * (3 * n - 1) * p_half,
         lambda xs: torch.cat(xs)),
        # rank r's block is a view of the stacked sum: [r*c:(r+1)*c]
        ("ring_reduce_scatter", f"n={n} {n}x{HALF_MIB} f32 a rank",
         (n * HALF_MIB,), n * (n + 1) * p_half,
         n * (3 * n - 1) * p_half,
         lambda xs: torch.stack(xs).sum(0).chunk(n)),
        ("ring_neighbour_stream",
         f"n={n} {HALF_MIB} f32 in {STREAM_CHUNKS} chunks",
         (STREAM_CHUNKS, HALF_MIB // STREAM_CHUNKS), n * 2 * p_half,
         n * 4 * p_half, lambda xs: torch.roll(torch.stack(xs), 1, 0)),
        # the channel's stream of phase 21: 4 MiB a rank in chunks of
        # buffer_size 2048 rounded to packets
        ("ring_neighbour_stream",
         f"n={n} {CHANNEL_CHUNKS}x{CHANNEL_ELEMS} f32 (the channel's chunks)",
         (CHANNEL_CHUNKS, CHANNEL_ELEMS), n * 2 * p_channel,
         n * 4 * p_channel, lambda xs: torch.roll(torch.stack(xs), 1, 0)),
    ]
    for kernel, name, shape, io_bytes, sched_bytes, library in timed_cases:
        xs = [rnd(shape, f32) for _ in range(n)]
        call, plain = calls[kernel]
        t, e = in_turns(
            lambda: ring_kernel_ms(w8, lambda c: call(xs[c.rank], c, {})),
            earlier)
        ms, e_ms = t.ms, e and e.ms
        # the stream's us a chunk at this shape
        chunk_us = (ms * 1e3 / shape[0],
                    None if e_ms is None else e_ms * 1e3 / shape[0])
        plain_ms = time_ms(lambda: plain(xs, {}), 5)
        lib_ms = device_ms(lambda: library(xs))
        b_ms = bound(io_bytes)
        log(f"  {kernel} {name}: {ms:.4f} ms (one launch through the "
            f"wrapper {t.launch_ms:.4f} ms), bound {b_ms:.4f} ms "
            f"({io_bytes / 1e6:.1f} MB: all ranks' inputs and outputs "
            f"once), {ms / b_ms:.1f}x; the ring schedule moves "
            f"{sched_bytes / 1e6:.1f} MB in device memory "
            f"({sched_bytes / ms / 1e9:.4g} TB/s); plain {plain_ms:.4f} "
            f"ms, stacked library call {lib_ms:.4f} ms; launches on "
            f"phases 21-23: {launches[kernel]}" + (
                "" if kernel != "ring_neighbour_stream" else
                f"; {chunk_us[0]:.3f} us a chunk") + (
                "" if e is None else
                f"; earlier {e_ms:.4f} ms ({e_ms / ms:.3f}x), one launch "
                f"{e.launch_ms:.4f} ms" + (
                    "" if kernel != "ring_neighbour_stream" else
                    f", {chunk_us[1]:.3f} us a chunk")))
        records.append({
            "name": f"{kernel} {name}", "route": "cuda", "source": RING_SRC,
            "replaces": RING_REPLACES[kernel],
            "launches": launches[kernel], "max_abs_err": max_err[kernel],
            "ms": ms, "launch_ms": t.launch_ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": "bytes", "library_ms": lib_ms,
            "earlier_ms": e_ms, "earlier_launch_ms": e and e.launch_ms,
            "step_us": step_us[kernel][0],
            "earlier_step_us": step_us[kernel][1],
            **({} if kernel != "ring_neighbour_stream" else
               {"chunk_us": chunk_us[0], "earlier_chunk_us": chunk_us[1],
                "floor_ms": floor_ms[shape]}),
        })
        split_shape, split = splits[kernel]
        if split_shape == shape:
            records[-1]["launch_split_us"] = split["tree"]
            records[-1]["earlier_launch_split_us"] = split.get("earlier")
    # one collective through the API, host wall: the rendezvous' cost
    xs = [rnd((SMI_ELEMS,), f32) for _ in range(n)]
    t0 = time.perf_counter()
    for _ in range(5):
        w8.run(lambda c: st.allreduce(xs[c.rank], c, backend="ring"))
    api_ms = (time.perf_counter() - t0) / 5 * 1e3
    log(f"  one allreduce of {SMI_ELEMS} f32 a rank through LocalWorld.run: "
        f"{api_ms:.3f} ms host wall ({n * 4 * SMI_ELEMS / api_ms / 1e6:.4g} "
        f"GB/s payload bytes x ranks); k-means "
        f"{points * iters / kmeans_wall:.4g} point-iterations/s")
    return records, check


CHUNKED_REPLACES = "smi_tpu/kernels/ring.py:542"
#: phase 25b: launches of each ring entry at each of its shapes
STRESS_LAUNCHES = 200
#: phase 26: timed runs per benchmark, and the depth cut from the JAX
#: defaults (pingpongs and messages 100, rounds 16); widths stay
SUITE_RUNS = 3
SUITE_CUTS = {"latency": {"pingpongs": 20}, "injection": {"messages": 20},
              "pipeline": {"rounds": 4}, "pipeline_double_rail": {"rounds": 4}}


def suite_phases(dev, gen, ring_check, earlier=None):
    """Phases 25-27: the chunked ring all-reduce, every ring entry's
    repeated launches and the benchmark suite on eight ranks of the
    card; ``ring_check`` is phase 20's check of one ring launch. Returns
    the chunked kernel's records. With an earlier ``ring.cu``
    (:class:`EarlierSource`), phase 27 times it in turns with the
    tree's."""
    import torch

    import smi_tpu_torch as st
    from smi_tpu_torch.benchmarks.micro import BENCHMARKS, run_benchmark
    from smi_tpu_torch.kernels import _build
    from smi_tpu_torch.kernels import ring as kring

    f32, kernel = torch.float32, "ring_all_reduce_chunked"
    n = SMI_RANKS
    worlds = {}

    def world(m):
        if m not in worlds:
            worlds[m] = st.LocalWorld(m)
        return worlds[m]

    def rnd(shape, dtype):
        if dtype.is_floating_point:
            return torch.rand(shape, generator=gen, device=dev,
                              dtype=f32).add_(0.5).to(dtype)
        return torch.randint(-100, 100, shape, generator=gen, device=dev,
                             dtype=torch.int32).to(dtype)

    max_err = [0.0]

    def check(w, shape, dtype, chunks, op="add", axis=None):
        """One chunked launch against its plain version and the unchunked
        kernel, per line of ``axis``: equal on every rank, every credit
        domain drained, the control without rank 1 unequal."""
        xs = [rnd(shape, dtype) for _ in range(w.size)]
        before = _build.LAUNCHES[kernel]
        got = w.run(lambda c: kring.ring_all_reduce(
            xs[c.rank], c, axis, op=op, chunks=chunks))
        record = kring.last_record(w)
        if _build.LAUNCHES[kernel] != before + 1:
            raise AssertionError(f"{kernel}: not one launch")
        unchunked = w.run(lambda c: kring.ring_all_reduce(xs[c.rank], c,
                                                          axis, op=op))

        def plain(ys):
            outs = [None] * w.size
            for line in w.lines(axis):
                for r, o in zip(line, kring.ring_all_reduce_chunked_plain(
                        [ys[r] for r in line], chunks, op)):
                    outs[r] = o
            return outs

        want = plain(xs)
        what = (f"{len(w.lines(axis))} ring(s) of {len(w.lines(axis)[0])} "
                f"{tuple(shape)} {str(dtype)[6:]} {op} chunks={chunks}")
        for r in range(w.size):
            err = (got[r].double() - want[r].double()).abs().max().item()
            max_err[0] = max(max_err[0], err)
            if not torch.equal(got[r], want[r]):
                raise AssertionError(f"{what}: rank {r} kernel != plain, "
                                     f"max abs err {err}")
            if not torch.equal(got[r], unchunked[r]):
                raise AssertionError(f"{what}: rank {r} != the unchunked "
                                     f"kernel")
        if not kring.drained(record):
            raise AssertionError(f"{what}: credits did not drain: {record}")
        if record["chunks"] != min(chunks, shape[0]):
            raise AssertionError(f"{what}: {record['chunks']} chunks ran")
        dropped = list(xs)
        dropped[1] = torch.zeros_like(xs[1])
        control = plain(dropped)
        if all(torch.equal(got[r], control[r]) for r in range(w.size)):
            raise AssertionError(f"{what}: equal to the plain version "
                                 f"without rank 1's contribution")
        return (f"{what}: equal to plain and unchunked on {w.size} ranks, "
                f"{record['chunks']} x {record['blocks']} credit domains a "
                f"rank drained, {int(record['granted'].sum())} credits")

    # ---- 25. the chunked kernel vs its plain version -------------------
    log("[25 chunked ring all-reduce vs plain and unchunked]")
    side = int(SMI_ELEMS ** 0.5)   # SMI_ELEMS as (1024, 1024)
    for shape, dtype, chunks, op in (
            ((side, side), f32, 2, "add"), ((side, side), f32, 4, "add"),
            ((side, side), f32, 8, "add"),
            ((side, side), torch.int32, 4, "max"),
            ((side, side), torch.bfloat16, 4, "add"),
            ((65536,), f32, 4, "add"), ((16384,), f32, 4, "add"),
            ((4096,), f32, 4, "add"), ((1000, 256), f32, 3, "add")):
        log("  " + check(world(n), shape, dtype, chunks, op))
    small = 0
    for m in (2, 3):
        for dtype in (f32, torch.bfloat16, torch.int8):
            for chunks, op in ((2, "add"), (3, "min")):
                check(world(m), (5, 130), dtype, chunks, op)
                small += 1
    log(f"  n=2 and 3: {small} cases (5 x 130 in f32, bf16 and int8, "
        f"chunks 2 ADD with a pad row and 3 MIN) equal and drained")
    w24 = st.LocalWorld((2, 4), ("sx", "sy"))
    for axis in ("sx", "sy"):
        log("  " + check(w24, (9, 2048), f32, 4, axis=axis))

    # ---- 25b. every ring entry, launched again and again ----------------
    log(f"[25b every ring entry {STRESS_LAUNCHES} times a shape, fresh "
        f"inputs]")
    w8 = world(n)
    entries = {
        # entry: (call, plain, phase 20's first shape (phase 25's for the
        # chunked entry: 4 MiB in two chunks), one block a rank (4 KiB a
        # chunk, one block a chunk, for the chunked entry); the stream also
        # at the channel's shape, its other timed one)
        "ring_all_reduce": (
            kring.ring_all_reduce, kring.ring_all_reduce_plain,
            (SMI_ELEMS,), (PROBE_ELEMS,)),
        "ring_all_reduce_chunked": (
            lambda x, c: kring.ring_all_reduce(x, c, chunks=x.shape[0]),
            lambda ys: kring.ring_all_reduce_chunked_plain(ys,
                                                           ys[0].shape[0]),
            (2, SMI_ELEMS // 2), (4, PROBE_ELEMS)),
        "ring_all_gather": (
            kring.ring_all_gather, kring.ring_all_gather_plain,
            (HALF_MIB,), (PROBE_ELEMS,)),
        "ring_reduce_scatter": (
            kring.ring_reduce_scatter, kring.ring_reduce_scatter_plain,
            (n * HALF_MIB,), (n * PROBE_ELEMS,)),
        "ring_neighbour_stream": (
            kring.neighbour_stream, kring.neighbour_stream_plain,
            (STREAM_CHUNKS, HALF_MIB // STREAM_CHUNKS),
            (STREAM_CHUNKS, PROBE_ELEMS), (CHANNEL_CHUNKS, CHANNEL_ELEMS)),
    }
    for name, (call, plain, *shapes) in entries.items():
        for shape in shapes:
            t0 = time.perf_counter()
            before = _build.LAUNCHES[name]
            for i in range(STRESS_LAUNCHES):
                xs = [rnd(shape, f32) for _ in range(n)]
                got = w8.run(lambda c: call(xs[c.rank], c))
                record = kring.last_record(w8)
                want = plain(xs)
                for r in range(n):
                    if not torch.equal(got[r], want[r]):
                        err = (got[r] - want[r]).abs().max().item()
                        raise AssertionError(
                            f"{name} {shape} launch {i}: rank {r} kernel != "
                            f"plain, max abs err {err}")
                if not kring.drained(record):
                    raise AssertionError(f"{name} {shape} launch {i}: "
                                         f"credits did not drain: {record}")
            if _build.LAUNCHES[name] != before + STRESS_LAUNCHES:
                raise AssertionError(f"{name}: not one launch a call")
            log(f"  {name} {shape} f32, {record['chunks']} x "
                f"{record['blocks']} blocks a rank: {STRESS_LAUNCHES} "
                f"launches equal to the plain version and drained "
                f"({time.perf_counter() - t0:.1f} s)")

    # ---- 26. the benchmark suite on the card ---------------------------
    log(f"[26 the benchmark suite, {n} ranks, {SUITE_RUNS} runs each]")
    event_ms = [0.0]
    launch = kring._launch

    shapes = {}   # every distinct ring launch of the suite, replayed below

    def timed_launch(*args, **kwargs):
        # the grid's event time, summed: the rendezvous synchronises the
        # world's stream right after, so waiting here costs nothing
        launch(*args, **kwargs)
        kernel_, w, axis, stream, xs, _, _, extra, flow = args[:9]
        key = (kernel_, axis, stream, tuple(xs[0].shape), xs[0].dtype,
               tuple(extra), flow)
        shapes[key] = shapes.get(key, 0) + 1
        begin, end = w.ring_state[("stream", stream)]["events"]
        end.synchronize()
        event_ms[0] += begin.elapsed_time(end)

    launches = {}
    t_suite = time.perf_counter()
    kring._launch = timed_launch
    try:
        for backend in ("xla", "ring"):
            for name in sorted(BENCHMARKS):
                if name.startswith("app_") and backend == "ring":
                    continue
                params = dict(SUITE_CUTS.get(name, {}), runs=SUITE_RUNS)
                torch.cuda.synchronize()
                _build.reset_launches()
                event_ms[0] = 0.0
                t0 = time.perf_counter()
                m = run_benchmark(name, w8, backend=backend, **params)
                wall = (time.perf_counter() - t0) * 1e3
                got = {k: v for k, v in _build.LAUNCHES.items() if v}
                extra = {k: m.config[k] for k in ("sweep",
                                                  "serialized_mean_usec")
                         if k in m.config}
                if extra:
                    log(f"    {m.name}: {extra}")
                if backend == "ring":
                    log(f"    {m.name}: {wall:.1f} ms host wall for the "
                        f"benchmark, ring kernels {event_ms[0]:.3f} ms of "
                        f"events ({100 * event_ms[0] / wall:.2f} %), "
                        f"launches {got}")
                    if not got:
                        raise AssertionError(f"{m.name}: no ring kernel "
                                             f"ran")
                elif any(k.startswith("ring_") for k in got):
                    raise AssertionError(f"{m.name}: the xla tier "
                                         f"launched a ring kernel")
                else:
                    log(f"    {m.name}: {wall:.1f} ms host wall for the "
                        f"benchmark, its verification included")
                if name == "overlap" and backend == "ring":
                    launches = dict(_build.LAUNCHES)
                    if launches[kernel] <= 0:
                        raise AssertionError("overlap on ring: the chunked "
                                             "kernel was not launched")
    finally:
        kring._launch = launch
    log(f"  the suite: {time.perf_counter() - t_suite:.1f} s; overlap on "
        f"ring made {launches[kernel]} chunked and "
        f"{launches['ring_all_reduce']} unchunked launches")
    # the suite's inputs are ones and ranks alike; each launch shape it
    # made is held again on random inputs against its plain version
    ops = {code: op.name.lower() for op, code in kring.OP_CODES.items()}
    for (kernel_, axis, stream, shape, dtype, extra,
         flow), count in sorted(shapes.items(), key=str):
        if kernel_ == kernel:
            what = check(w8, shape, dtype, shape[0], ops[extra[0]], axis)
        else:
            kw = {"axis_name": axis, "stream": stream, "flow_control": flow}
            if kernel_ in ("ring_all_reduce", "ring_reduce_scatter"):
                kw["op"] = ops[extra[0]]
            if kernel_ == "ring_neighbour_stream":
                kw["direction"] = extra[1]
            what = ring_check(kernel_, n, shape, dtype, w=w8, **kw)
        log(f"    {count} launches of the suite: {what}")
    log(f"  {len(shapes)} launch shapes of the suite's ring tier equal to "
        f"their plain versions on random inputs")

    # ---- 27. times -------------------------------------------------------
    log("[27 chunked ring all-reduce times, 8 ranks]")
    records = []
    # the handshake's own price: 4 KiB a chunk, one block a chunk
    xs = [rnd((4, PROBE_ELEMS), f32) for _ in range(n)]
    t, e = in_turns(lambda: ring_kernel_ms(
        w8, lambda c: kring.ring_all_reduce(xs[c.rank], c, chunks=4)),
        earlier)
    probe_ms, probe_e_ms = t.ms, e and e.ms
    step_us = probe_ms * 1e3 / (n - 1)
    e_step_us = None if probe_e_ms is None else probe_e_ms * 1e3 / (n - 1)
    log(f"  handshake probe chunks=4 (4, {PROBE_ELEMS}) f32, "
        f"{t.record['blocks']} block(s) a chunk: "
        f"{probe_ms:.4f} ms, {step_us:.3f} us a step over {n - 1}" + (
            "" if probe_e_ms is None else
            f"; earlier {probe_e_ms:.4f} ms, {e_step_us:.3f} us a step"))

    xs = [rnd((side, side), f32) for _ in range(n)]
    io_bytes = n * 2 * 4 * SMI_ELEMS
    sched_bytes = n * (3 * n - 1) * 4 * SMI_ELEMS
    b_ms = io_bytes / HBM_BYTES_PER_S * 1e3
    lib_ms = device_ms(lambda: torch.stack(xs).sum(0))
    t, e = in_turns(lambda: ring_kernel_ms(
        w8, lambda c: kring.ring_all_reduce(xs[c.rank], c)), earlier)
    base_ms, base_e_ms = t.ms, e and e.ms
    log(f"  unchunked on the same payload: {base_ms:.4f} ms "
        f"({sched_bytes / base_ms / 1e9:.4g} TB/s of schedule traffic)" + (
            "" if base_e_ms is None else f"; earlier {base_e_ms:.4f} ms"))
    for chunks in (2, 4, 8):
        t, e = in_turns(lambda: ring_kernel_ms(
            w8, lambda c: kring.ring_all_reduce(xs[c.rank], c,
                                                chunks=chunks)), earlier)
        ms, e_ms = t.ms, e and e.ms
        plain_ms = time_ms(
            lambda: kring.ring_all_reduce_chunked_plain(xs, chunks), 5)
        log(f"  chunks={chunks}: {ms:.4f} ms (one launch through the "
            f"wrapper {t.launch_ms:.4f} ms; {ms / base_ms:.3f}x the "
            f"unchunked kernel; {sched_bytes / 1e6:.1f} MB of schedule "
            f"traffic, {sched_bytes / ms / 1e9:.4g} TB/s), bound "
            f"{b_ms:.4f} ms ({io_bytes / 1e6:.1f} MB: all ranks' inputs and "
            f"outputs once), {ms / b_ms:.1f}x; plain {plain_ms:.4f} ms, "
            f"stacked library call {lib_ms:.4f} ms; launches on overlap's "
            f"ring run: {launches[kernel]}" + (
                "" if e is None else
                f"; earlier {e_ms:.4f} ms ({e_ms / ms:.3f}x), one launch "
                f"{e.launch_ms:.4f} ms"))
        records.append({
            "name": f"{kernel} n={n} {side}x{side} f32 add chunks={chunks}",
            "route": "cuda", "source": RING_SRC,
            "replaces": CHUNKED_REPLACES, "launches": launches[kernel],
            "max_abs_err": max_err[0], "ms": ms, "launch_ms": t.launch_ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": "bytes",
            "library_ms": lib_ms, "earlier_ms": e_ms,
            "earlier_launch_ms": e and e.launch_ms, "unchunked_ms": base_ms,
            "step_us": step_us, "earlier_step_us": e_step_us,
        })
    return records


ROLL_SRC = "smi_tpu_torch/kernels/csrc/roll_chain.cu"
ROLL_REPLACES = "smi_tpu/benchmarks/surface.py:562"
#: phase 28: (shape, chains) and the lengths checked; 1000, 3 and 4097
#: leave a net shift, 1024 and 4096 are the timed lengths. 7x300 is
#: ragged on both axes; 8x4096 and 4096x8 put the longest axis the
#: kernel takes under lane and add, and under sublane
ROLL_CASES = (((512, 2048), 1), ((512, 2048), 2), ((256, 2048), 2),
              ((7, 300), 3), ((8, 4096), 1), ((4096, 8), 1))
ROLL_LENGTHS = (1, 3, 1000, 4097, 1024, 4096)
#: a roll_chain_kernel<ROTATE, K> instance's mangled name
ROLL_INSTANCE = re.compile(r"roll_chain_kernelILb([01])ELi(\d+)EE")
#: phase 29: the surface's harness depth (the JAX defaults: 3 runs a
#: point, escalate until 1 s apart); widths and lengths stay
SURFACE_RUNS = 1
SURFACE_MIN_DELTA = 0.1
SMEM_BYTES_PER_CLK = 128   # a Hopper SM: 32 banks of 4 B
SHFL_PER_CLK = 32          # shuffle results a clock an SM (CC 9.0)


def roll_instance(name):
    """``(rotate, regs)`` of a roll_chain_kernel instance named in
    ``name``, or None."""
    m = ROLL_INSTANCE.search(name)
    return None if m is None else (m.group(1) == "1", int(m.group(2)))


def roll_build_info(log_text):
    """Each roll_chain_kernel instance's registers and spill bytes (stores,
    loads) from its ``-Xptxas -v`` log (``parallel/aot.py``'s parser)."""
    from smi_tpu_torch.parallel import aot

    return {roll_instance(name): {"registers": figs["registers"],
                                  "spill": figs.get("spill")}
            for name, figs in aot.kernel_resources(log_text).items()
            if roll_instance(name) is not None}


def roll_shuffles(library):
    """SHFL instructions in each roll_chain_kernel instance of the built
    ``library``, from ``cuobjdump -sass``; None where the toolkit has no
    ``cuobjdump``."""
    from pathlib import Path

    from smi_tpu_torch.kernels import _build

    tool = Path(_build.find_nvcc()).parent / "cuobjdump"
    if not tool.is_file():
        return None
    sass = subprocess.run([str(tool), "-sass", str(library)], check=True,
                          capture_output=True, text=True,
                          timeout=300).stdout
    counts, current = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            current = roll_instance(line)
            if current is not None:
                counts[current] = 0
        elif current is not None and "SHFL" in line:
            counts[current] += 1
    return counts


def surface_phases(dev, gen, earlier=None):
    """Phases 28-30: the roll-chain kernel and the single-card surface.
    Returns the roll kernel's records. With an earlier ``roll_chain.cu``
    (:class:`EarlierSource`), phase 30 times it in turns on its own plan
    (:func:`earlier_roll_plan`), outputs equal bit for bit."""
    import os
    import tempfile

    import torch

    from smi_tpu_torch.benchmarks import surface
    from smi_tpu_torch.kernels import _build
    from smi_tpu_torch.kernels import roll

    bodies = tuple(roll.BODIES)

    def chains(shape, ilp):
        return tuple(torch.randn(shape, generator=gen, device=dev)
                     for _ in range(ilp))

    # ---- 28. the roll-chain kernel vs its plain version -----------------
    log("[28 roll-chain kernel vs plain]")
    built = roll_build_info(_build.build_log("roll_chain"))
    shuffles = roll_shuffles(_build.library_path("roll_chain"))
    log(f"  roll_chain: {len(built)} instances; SHFL counts " + (
        "not read (no cuobjdump)" if shuffles is None
        else "from cuobjdump -sass"))
    max_err = {}
    for shape, ilp in ROLL_CASES:
        for body in bodies:
            xs = chains(shape, ilp)
            for length in ROLL_LENGTHS:
                got = roll.roll_chain(xs, length, body)
                want = roll.roll_chain_plain(xs, length, body)
                torch.cuda.synchronize()
                err = max((g - w).abs().max().item()
                          for g, w in zip(got, want))
                max_err[(body, ilp)] = max(max_err.get((body, ilp), 0.0), err)
                if not all(torch.equal(g, w) for g, w in zip(got, want)):
                    raise AssertionError(
                        f"roll_chain {body} {shape} x{ilp} R={length}: "
                        f"kernel != plain, max abs err {err}")
            control = roll.roll_chain(xs, 1, body)
            if any(torch.equal(c, x) for c, x in zip(control, xs)):
                raise AssertionError(f"roll_chain {body} {shape} x{ilp}: "
                                     f"R=1 equals its input")
            p = roll.plan(*shape, ilp, body)
            key = (body != "add", p["regs"])
            shfl = ("" if shuffles is None else
                    f", {shuffles.get(key)} SHFL (a step {p['regs']} on "
                    f"whole lines, {p['regs'] + 1} on short ones)" if key[0]
                    else f", {shuffles.get(key)} SHFL")
            log(f"  {body} {shape[0]}x{shape[1]} x{ilp} chain(s): "
                f"{p['regs']} registers a line, {p['warps']} warps a "
                f"block, {p['blocks']} blocks; instance {key}: "
                f"{built.get(key, {}).get('registers')} registers, spill "
                f"stores/loads {built.get(key, {}).get('spill')} "
                f"bytes{shfl}; equal at R in {ROLL_LENGTHS}; the R=1 "
                f"control differs from its input")

    # ---- 29. the whole surface on the card -------------------------------
    log(f"[29 the single-card surface, runs {SURFACE_RUNS}, min delta "
        f"{SURFACE_MIN_DELTA} s]")
    with open("PERF.json") as f:
        want_names = {m["metric"] for m in json.load(f)["metrics"]}
    walls = {}

    def walled(name, section):
        def run(bench, quick=False):
            t0 = time.perf_counter()
            out = section(bench, quick=quick)
            walls[name] = time.perf_counter() - t0
            log(f"  section {name}: {walls[name]:.1f} s, {len(out)} "
                f"records")
            return out
        return run

    sections = {n: walled(n, f) for n, f in surface.SECTIONS.items()}
    # each record is printed as a JSON line as it is measured
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "surface.json")
        torch.cuda.synchronize()
        _build.reset_launches()
        with patched(surface, RUNS=SURFACE_RUNS,
                     MIN_DELTA=SURFACE_MIN_DELTA, SECTIONS=sections):
            rc = surface.main(["--fresh", "-o", path])
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
        with open(path) as f:
            artifact = json.load(f)
    log(f"  surface: exit {rc}, {sum(walls.values()):.1f} s in sections; "
        f"device {artifact['device']}; rooflines {artifact['rooflines']}")
    log(f"  launches {({k: v for k, v in launches.items() if v})}")
    if rc != 0:
        raise AssertionError(f"surface.main exited {rc}")
    metrics = artifact["metrics"]
    names = [m["metric"] for m in metrics]
    if len(names) != len(want_names) or set(names) != want_names:
        raise AssertionError(f"surface names differ from PERF.json's: "
                             f"{sorted(set(names) ^ want_names)}")
    bad = [m for m in metrics
           if not (math.isfinite(m["value"]) and m["value"] > 0)]
    if bad:
        raise AssertionError(f"surface values not finite and > 0: {bad}")
    for kernel in ("roll_chain", "flash_fused", "flash_bwd_dq",
                   "flash_bwd_dkdv", "stencil_temporal", "stencil_sweep"):
        if launches[kernel] <= 0:
            raise AssertionError(f"the surface did not launch {kernel}")

    # ---- 30. times -------------------------------------------------------
    log("[30 roll-chain kernel times]")
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits", "-i", "0"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip())
    rows, cols = surface.CARD_SHAPES.roll
    length = surface.CARD_SHAPES.roll_lengths[1]
    elems = rows * cols
    clocks_per_ms = _build.SMS * clock_mhz * 1e3
    smem_ms = 8 * elems * length / SMEM_BYTES_PER_CLK / clocks_per_ms
    shfl_ms = elems * length / SHFL_PER_CLK / clocks_per_ms
    records = []
    for body in bodies:
        for ilp in (1, 2):
            xs = chains((rows // ilp, cols), ilp)
            t, e = in_turns(lambda: KernelTime.of(
                lambda: roll.roll_chain(xs, length, body)), earlier)
            ms, e_ms = t.ms, None if e is None else e.ms
            plain_ms = time_ms(
                lambda: roll.roll_chain_plain(xs, length, body), 2)
            ops = elems * length if body == "add" else 0
            b_ms, b_by = flash_bound(ops, 2 * 4 * elems, False)
            # an FMA counts as two of F32_FLOPS' operations: adds alone
            # issue at half that rate
            fadd_ms = ops / (F32_FLOPS / 2) * 1e3 if ops else None
            # lane and sublane equal one torch.roll by R mod n a chain; add
            # has no such call (x + R rounds unlike R additions of 1.0)
            lib_ms, lib_call, shift = None, None, ""
            if body != "add":
                axis = 1 if body == "lane" else 0
                n = xs[0].shape[axis]
                lib_ms = time_ms(
                    lambda: [torch.roll(x, length % n, axis) for x in xs],
                    20)
                lib_call = f"torch.roll by R mod n ({length % n}), one a chain"
                shift = f"; {lib_call} {lib_ms:.4f} ms"
            log(f"  {body} x{ilp} {rows // ilp}x{cols} R={length}: "
                f"{ms:.4f} ms ({ms * 1e9 / (elems * length):.4f} ps/elem)"
                + ("" if e_ms is None else
                   f", earlier {e_ms:.4f} ms in turns (equal outputs, "
                   f"{e_ms / ms:.3f}x)")
                + f"; bound {b_ms:.4f} ms by {b_by}; "
                + (f"shuffle ceiling {shfl_ms:.4f} ms at {clock_mhz:.0f} "
                   f"MHz ({shfl_ms / ms:.1%} of it reached)" if ops == 0
                   else f"adds alone at 33.5 T/s {fadd_ms:.4f} ms "
                   f"({fadd_ms / ms:.1%} of it reached)")
                + f", the first form's shared-memory term {smem_ms:.4f} "
                f"ms at {clock_mhz:.0f} MHz; plain {plain_ms:.4f} "
                f"ms{shift}; launches on the surface run: "
                f"{launches['roll_chain']}")
            records.append({
                "name": f"roll_chain {body} {rows // ilp}x{cols} x{ilp} "
                        f"R={length}",
                "route": "cuda", "source": ROLL_SRC,
                "replaces": ROLL_REPLACES,
                "launches": launches["roll_chain"],
                "max_abs_err": max_err[(body, ilp)], "ms": ms,
                "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                "fadd_bound_ms": fadd_ms, "shfl_bound_ms": shfl_ms,
                "smem_bound_ms": smem_ms, "library_ms": lib_ms,
                "library_call": lib_call, "earlier_ms": e_ms,
            })
    return records


#: phase 31: the hybrid world's grid and its per-rank payload
HYBRID_GRID, HYBRID_AXES = (2, 4), ("dcn", "ici")
SIDE = 1024               # (1024, 1024) f32: SMI_ELEMS, 4 MiB a rank
#: repetitions of a collective through ``LocalWorld.run`` (host wall)
WALL_REPS = 5


def capture_rendezvous(world):
    """Record the joint work of every rendezvous ``world`` makes while the
    context is open: ``[(kind, work, payloads)]``, one per rendezvous
    (the leader's call). Used inside ``with``."""
    calls = []
    real = world.rendezvous

    def rendezvous(rank, kind, payload, work):
        def recorded(payloads):
            calls.append((kind, work, list(payloads)))
            return work(payloads)
        return real(rank, kind, payload, recorded)

    @contextlib.contextmanager
    def ctx():
        world.rendezvous = rendezvous
        try:
            yield calls
        finally:
            del world.rendezvous
    return ctx()


def collective_time(world, fn):
    """``(device_ms, wall_ms, kinds, outs)`` of ``world.run(fn)``:
    ``device_ms`` the device time of its rendezvous work (each recorded
    rendezvous replayed in order on the world's stream by
    :func:`device_ms`; the ranks' own copies are not in it), ``wall_ms``
    the median host wall of ``WALL_REPS`` runs, ``kinds`` the rendezvous
    kinds in order."""
    import statistics

    import torch

    with capture_rendezvous(world) as calls:
        outs = world.run(fn)
    with torch.cuda.device(world.device), torch.cuda.stream(world.stream):
        dev_ms = device_ms(lambda: [work(p) for _, work, p in calls])
    walls = []
    for _ in range(WALL_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        world.run(fn)
        walls.append((time.perf_counter() - t0) * 1e3)
    return dev_ms, statistics.median(walls), [k for k, _, _ in calls], outs


def collective_surface_phase(dev, gen, smi_line):
    """Phase 31: the rest of SMI's collective surface on the ``(2, 4)``
    world ``("dcn", "ici")``, 8 ranks at 4 MiB a rank: the all-to-all
    family, the three allreduce forms, the quantised allreduce on both
    tiers and the verified transfers. Launch counts are set to 0 before
    the checked runs and read after them; returns the ring kernels'
    launches there (rows 5 and 7 of the kernels line)."""
    import torch

    import smi_tpu_torch as st
    from smi_tpu_torch.kernels import _build
    from smi_tpu_torch.kernels import ring as kring
    from smi_tpu_torch.parallel import collectives as coll

    n = SMI_RANKS
    world = st.LocalWorld(HYBRID_GRID, HYBRID_AXES)
    f32, bf16, i32 = torch.float32, torch.bfloat16, torch.int32
    count = SIDE // n        # rows a block of the all-to-all

    def rnd(dtype):
        if dtype == i32:
            return [torch.randint(-1000, 1000, (SIDE, SIDE), generator=gen,
                                  device=dev, dtype=i32) for _ in range(n)]
        return [torch.rand((SIDE, SIDE), generator=gen, device=dev,
                           dtype=f32).add_(0.5).to(dtype) for _ in range(n)]

    torch.cuda.synchronize()
    _build.reset_launches()

    # ---- 31. the collective surface -----------------------------------
    log(f"[31 all-to-all, hybrid and quantised allreduce, verified "
        f"transfers on the {HYBRID_GRID} world {HYBRID_AXES}, {n} ranks]")
    inputs = {dtype: rnd(dtype) for dtype in (f32, bf16, i32)}
    for dtype, xs in inputs.items():
        want = torch.stack(xs).view(n, n, count, SIDE).transpose(0, 1)
        for algorithm in coll.ALLTOALL_ALGORITHMS:
            got = world.run(lambda c: st.all_to_all(
                xs[c.rank], c, algorithm=algorithm))
            if not torch.equal(torch.stack(got).view(n, n, count, SIDE),
                               want):
                raise AssertionError(f"all_to_all {algorithm} "
                                     f"{str(dtype)[6:]} != the block "
                                     f"transpose")
        log(f"  all_to_all {str(dtype)[6:]} ({SIDE}, {SIDE}) a rank: "
            f"pairwise, bruck and hierarchical torch.equal to each other "
            f"and to the stacked block transpose")

    xs, xi = inputs[f32], inputs[i32]
    forms = (("flat", dict(rs_ag=False)), ("default", {}),
             ("hierarchical", dict(hierarchical=True)))
    # the rendezvous each form makes; the default's is that of the form
    # the plan engine's gates name: at 4 MiB the seeded H100 entry's in
    # f32 (phase 32), the cost model's in int32 (no sweep covers it)
    schedule = {(what, dtype): allreduce_kinds(kw)
                for what, kw in forms if kw for dtype in (f32, i32)}
    for dtype, vals in ((f32, xs), (i32, xi)):
        schedule["default", dtype] = allreduce_kinds(
            engine_form(vals[0].view(-1), world.comms[0]))
    results = {}
    for what, kw in forms:
        for dtype, vals in ((f32, xs), (i32, xi)):
            with capture_rendezvous(world) as calls:
                results[what, dtype] = world.run(
                    lambda c: st.allreduce(vals[c.rank].view(-1), c, **kw))
            kinds = [k[0] for k, _, _ in calls]
            if kinds != schedule[what, dtype]:
                raise AssertionError(f"allreduce {what} {dtype}: rendezvous "
                                     f"{kinds}, expected "
                                     f"{schedule[what, dtype]}")
    exact = sum(x.view(-1).double() for x in xs)
    for what, _ in forms:
        for r in range(n):
            if not torch.equal(results[what, i32][r],
                               results["flat", i32][r]):
                raise AssertionError(f"allreduce {what} int32 rank {r} != "
                                     f"flat")
            if not torch.allclose(results[what, f32][r],
                                  results["flat", f32][r], rtol=1e-6,
                                  atol=0.0):
                raise AssertionError(f"allreduce {what} f32 rank {r} "
                                     f"beyond 1e-6 of flat")
        err = (results[what, f32][0].double() - exact).abs().max().item()
        log(f"  allreduce {what} ({SMI_ELEMS},) a rank: rendezvous "
            f"f32 {schedule[what, f32]}, int32 {schedule[what, i32]}; int32 "
            f"torch.equal to flat, f32 within 1e-6 of flat (max abs err "
            f"against float64 {err:.3g})")
    del results

    clean = torch.full((SMI_ELEMS,), 3.5, device=dev)
    quantised = {}
    for precision in ("bf16", "int8", "topk"):
        plain = kring.ring_all_reduce_plain(
            [coll._quantize(x.view(-1), precision) for x in xs], "add")
        for backend in ("ring", "xla"):
            coll.error_feedback_reset()
            got = world.run(lambda c: st.allreduce(
                xs[c.rank].view(-1), c, precision=precision,
                backend=backend))
            for r in range(n):
                if backend == "ring" and not torch.equal(got[r], plain[r]):
                    raise AssertionError(
                        f"precision {precision} ring rank {r} != "
                        f"quantise-then-ring_all_reduce_plain")
                if backend == "xla" and not torch.allclose(
                        got[r], plain[r], rtol=1e-6, atol=0.0):
                    raise AssertionError(
                        f"precision {precision} xla rank {r} beyond 1e-6 "
                        f"of the quantised sum")
            rel = ((got[0].double() - exact).norm() / exact.norm()).item()
            bound = {"bf16": 0.01, "int8": 0.02}.get(precision)
            if bound is not None and not rel < bound:
                raise AssertionError(f"precision {precision} {backend}: "
                                     f"relative error {rel} >= {bound}")
            coll.error_feedback_reset()
            sums = world.run(lambda c: st.allreduce(
                clean, c, precision=precision, backend=backend))
            if not all(torch.equal(s, torch.full_like(s, 28.0))
                       for s in sums):
                raise AssertionError(f"precision {precision} {backend}: "
                                     f"8 x 3.5 is not 28 exactly")
            quantised[precision, backend] = rel
        log(f"  allreduce precision={precision}: ring tier torch.equal to "
            f"quantise-then-ring_all_reduce_plain, xla tier within 1e-6 of "
            f"it; relative error against float64 {rel:.4g}"
            + ("" if bound is None else f" (JAX pin {bound})")
            + "; 8 x 3.5 sums to 28 exactly on both tiers")
    coll.error_feedback_reset()

    src, dst = API_ROOT, API_ROOT + 1
    payload = [x.view(-1) for x in xs]
    for backend in ("xla", "ring"):
        def verified(c):
            ch = st.P2PChannel(c, port=0, src=src, dst=dst,
                               count=SMI_ELEMS, buffer_size=2048)
            received, check = ch.transfer_verified(payload[c.rank],
                                                   backend=backend)
            streamed, _, s_check = ch.stream_verified(payload[c.rank],
                                                      backend=backend)
            ch.verify_frames(check)
            ch.verify_frames(s_check)
            return ch, received, streamed, s_check

        outs = world.run(verified)
        ch, received, streamed, check = outs[dst]
        chunk = min(ch.chunk_elements, ch.count)
        chunks = -(-ch.count // chunk)
        if (chunk, chunks) != (CHANNEL_ELEMS, CHANNEL_CHUNKS):
            raise AssertionError(f"channel chunks {chunks} x {chunk}, "
                                 f"expected {CHANNEL_CHUNKS} x "
                                 f"{CHANNEL_ELEMS}")
        if not (torch.equal(received, payload[src])
                and torch.equal(streamed, payload[src])):
            raise AssertionError(f"verified {backend}: dst did not receive "
                                 f"src's payload")
        if not torch.equal(check.expected, ch.chunk_checksums(payload[src])):
            raise AssertionError(f"verified {backend}: the moved checksums "
                                 f"are not src's")
        bad_chunk = 3 * chunks // 5
        tampered = streamed.clone()
        tampered.view(torch.int32)[bad_chunk * chunk + 1000] ^= 1 << 7
        try:
            ch.verify_frames(st.FrameCheck(check.expected,
                                           ch.chunk_checksums(tampered),
                                           check.at_dst))
        except st.IntegrityError as err:
            if (err.seq, err.kind, err.src, err.rank) != (
                    bad_chunk, "checksum", src, dst):
                raise AssertionError(f"verified {backend}: the error names "
                                     f"{err.seq} {err.kind}") from err
            log(f"  verified transfer and stream {src}->{dst} ({backend}): "
                f"{chunks} chunks of {chunk} f32 delivered, frames verified; "
                f"one bit flipped in chunk {bad_chunk}: IntegrityError "
                f"naming chunk {err.seq}")
        else:
            raise AssertionError(f"verified {backend}: a flipped bit passed")
    counts = {k: _build.LAUNCHES[k] for k in RING_KERNELS}
    log(f"  launches in phase 31: {counts}")
    expect = {"ring_all_reduce": 6, "ring_neighbour_stream": 4,
              "ring_all_gather": 0, "ring_reduce_scatter": 0}
    if counts != expect:
        raise AssertionError(f"phase 31 launches {counts}, expected "
                             f"{expect}")

    # times, after the counted runs
    for dtype, xs_t in inputs.items():
        nbytes = 2 * n * xs_t[0].numel() * xs_t[0].element_size()
        b_ms = nbytes / HBM_BYTES_PER_S * 1e3
        lib_ms = device_ms(lambda: torch.stack(xs_t).view(
            n, n, count, SIDE).transpose(0, 1).contiguous())
        for algorithm in coll.ALLTOALL_ALGORITHMS:
            d_ms, w_ms, kinds, _ = collective_time(
                world, lambda c: st.all_to_all(xs_t[c.rank], c,
                                               algorithm=algorithm))
            log(f"  all_to_all {algorithm} {str(dtype)[6:]}: rendezvous "
                f"work {d_ms:.4f} ms over {len(kinds)} rendezvous, host "
                f"wall through LocalWorld.run {w_ms:.3f} ms; bound "
                f"{b_ms:.4f} ms ({nbytes / 2**20:.0f} MiB in and out "
                f"once); one stacked transpose copy {lib_ms:.4f} ms "
                f"[{smi_line}]")
    for what, kw in forms:
        for dtype, vals in ((f32, xs), (i32, xi)):
            d_ms, w_ms, kinds, _ = collective_time(
                world, lambda c: st.allreduce(vals[c.rank].view(-1), c,
                                              **kw))
            log(f"  allreduce {what} {str(dtype)[6:]}: rendezvous work "
                f"{d_ms:.4f} ms ({', '.join(k[0] for k in kinds)}), host "
                f"wall through LocalWorld.run {w_ms:.3f} ms [{smi_line}]")
    for precision in ("bf16", "int8", "topk"):
        for backend in ("ring", "xla"):
            coll.error_feedback_reset()
            t0 = time.perf_counter()
            for _ in range(WALL_REPS):
                world.run(lambda c: st.allreduce(
                    xs[c.rank].view(-1), c, precision=precision,
                    backend=backend))
            w_ms = (time.perf_counter() - t0) / WALL_REPS * 1e3
            q_ms = device_ms(lambda: coll._quantize(xs[0].view(-1),
                                                    precision))
            log(f"  allreduce precision={precision} {backend}: host wall "
                f"through LocalWorld.run {w_ms:.3f} ms; one rank's "
                f"quantise {q_ms:.4f} ms [{smi_line}]")
    coll.error_feedback_reset()
    return counts


#: phase 32: the sweep grid (KiB a rank, f32), the chunk candidates of the
#: allreduce sweep and the timed runs a point (after one warm-up)
SWEEP_KB = (64, 256, 1024, 4096)
SWEEP_CHUNKS = (1, 2, 4)
SWEEP_RUNS = 5


def rendezvous_kinds(world, fn):
    """``(outs, kinds)`` of one ``world.run(fn)``: the kinds of the
    rendezvous it made, in order."""
    with capture_rendezvous(world) as calls:
        outs = world.run(fn)
    return outs, [kind for kind, _, _ in calls]


def seeded_forms():
    """The pinned forms the seeded H100 entries name for an untuned f32
    call of 4 MiB a rank: allreduce keywords on the 8-rank world
    (``"n8"``) and on the ``(2, 4)`` hybrid (``"n8:dcn2"``), and the
    all-to-all algorithm on each. On the hybrid world a flat answer's
    rs+ag and chunk gates read the ``n8`` entry, as the engine does."""
    from smi_tpu_torch.tuning import seeded
    from smi_tpu_torch.tuning.plan import PlanKey, payload_bucket

    cache = seeded.seeded_cache()

    def knobs(op, topology):
        hit = cache.lookup(PlanKey(op, payload_bucket(4 * SMI_ELEMS),
                                   "float32", seeded.SEEDED_H100_DEVICE_KIND,
                                   topology))
        if hit is None:
            raise AssertionError(f"no seeded H100 entry for {op} on "
                                 f"{topology} at 4 MiB a rank")
        return hit.knobs

    flat = knobs("all_reduce", "n8")
    chunks = int(flat.get("chunks", 1))
    pod = knobs("all_reduce", "n8:dcn2")["algorithm"]
    return {
        "n8": dict(rs_ag=flat["algorithm"] == "rs_ag", chunks=chunks),
        "n8:dcn2": (dict(hierarchical=True) if pod == "hierarchical" else
                    dict(rs_ag=flat["algorithm"] == "rs_ag", chunks=chunks)),
        "all_to_all n8": knobs("all_to_all", "n8")["algorithm"],
        "all_to_all n8:dcn2": knobs("all_to_all", "n8:dcn2")["algorithm"],
    }


def engine_form(x, comm):
    """The allreduce keywords the plan engine's gates name for an
    untuned ADD allreduce of ``x`` on ``comm``."""
    from smi_tpu_torch.ops.types import SmiOp
    from smi_tpu_torch.parallel import collectives as coll

    if coll._use_hierarchical(x, comm, SmiOp.ADD, None, None):
        return dict(hierarchical=True)
    return dict(rs_ag=coll._use_rs_ag(x, comm, SmiOp.ADD, None),
                chunks=coll._resolve_chunks(None, x, comm, "all_reduce"))


def allreduce_kinds(kw):
    """The rendezvous an allreduce pinned by ``kw`` makes on a
    ``LocalWorld`` at 4 MiB a rank."""
    if kw.get("hierarchical"):
        return ["reduce_scatter", "all_reduce", "all_gather"]
    one = ["reduce_scatter", "all_gather"] if kw.get("rs_ag") else [
        "all_reduce"]
    return one * kw.get("chunks", 1)


def modeled_us(cm, name, payload, world, candidate):
    """The cost model's (v5e-priced) time of one sweep candidate, or
    None where it prices none."""
    topo = cm.topology_from_comm(world)
    if name == "sweep_allreduce":
        table = cm.allreduce_candidates(payload, cm.TopologySpec(n=topo.n))
        candidate = candidate.split()[0]
    elif name == "sweep_allreduce_hierarchical":
        table = cm.allreduce_candidates(payload, topo)
        if candidate == "flat":
            return min(c.modeled_us for c in table
                       if c.name != "hierarchical")
    elif name == "sweep_allreduce_precision":
        table = cm.allreduce_precision_candidates(payload, topo)
    else:
        table = cm.alltoall_candidates(payload, topo)
    return next((c.modeled_us for c in table if c.name == candidate), None)


def tuning_phase(dev, gen, smi_line):
    """Phase 32: the plan engine on the card. The detected device kind;
    the four collective sweeps (and the flat forms on an 8-rank world)
    timed on the card over an engine that starts empty and takes each
    routing sweep's winners before the next sweep runs, each table
    printed with its winners; then, with the default engine (the seeded
    cache), each untuned 4 MiB call against the pinned form its seeded
    H100 entry names, and ``explain_plan`` on the hybrid world."""
    import torch

    import smi_tpu_torch as st
    from smi_tpu_torch.tuning import cost_model as cm
    from smi_tpu_torch.tuning import engine as eng
    from smi_tpu_torch.tuning import seeded, sweep
    from smi_tpu_torch.tuning.cache import PlanCache
    from smi_tpu_torch.tuning.plan import PlanKey

    log("[32 the plan engine: the collective sweeps on the card, the "
        "seeded H100 entries deciding untuned calls, explain_plan]")
    kind = eng.PlanEngine().device_kind()
    log(f"  detected device kind {kind!r} (torch.cuda.get_device_name: "
        f"{torch.cuda.get_device_name(0)!r})")
    if kind != seeded.SEEDED_H100_DEVICE_KIND:
        raise AssertionError(f"device kind {kind!r} is not the seeded "
                             f"{seeded.SEEDED_H100_DEVICE_KIND!r}")
    n = SMI_RANKS
    hybrid = st.LocalWorld(HYBRID_GRID, HYBRID_AXES)
    flat = st.LocalWorld(n)
    chunked = dict(chunk_candidates=SWEEP_CHUNKS)
    sweeps = (   # (sweep, world, keywords, whether its winners route)
        (sweep.sweep_allreduce, flat, chunked, True),
        (sweep.sweep_allreduce, hybrid, chunked, False),
        (sweep.sweep_allreduce_hierarchical, hybrid, {}, True),
        (sweep.sweep_allreduce_precision, hybrid, {}, False),
        (sweep.sweep_allreduce_precision, flat, {}, False),
        (sweep.sweep_alltoall, hybrid, {}, True),
        (sweep.sweep_alltoall, flat, {}, True),
    )
    saved = eng.get_engine()
    swept = PlanCache()     # the routing sweeps' winners, in order
    try:
        for fn, world, kw, routing in sweeps:
            eng.set_engine(eng.PlanEngine(
                cache=PlanCache.from_json(swept.to_json()), device_kind=kind))
            record = []
            t0 = time.perf_counter()
            got = fn(world, sizes_kb=SWEEP_KB, runs=SWEEP_RUNS, record=record,
                     **kw)
            where = "x".join(map(str, world.shape)) + " " + "/".join(
                world.axis_names)
            log(f"  {fn.__name__} on the {where} world, f32, {SWEEP_RUNS} "
                f"runs a point ({time.perf_counter() - t0:.1f} s): us of "
                f"one LocalWorld.run, beside the cost model's v5e price "
                f"[{smi_line}]")
            for kb in SWEEP_KB:
                rows = sorted((us, name) for k, name, us in record if k == kb)
                for us, name in rows:
                    mod = modeled_us(cm, fn.__name__, kb * 1024, world, name)
                    log(f"    {kb:>5} KiB  {name:<16} measured {us:>10.1f} "
                        f"us  modeled "
                        + ("-" if mod is None else f"{mod:.1f} us"))
                (win_us, win), (next_us, runner) = rows[0], rows[1]
                log(f"    {kb:>5} KiB  winner {win} {win_us:.1f} us, "
                    f"runner-up {runner} {next_us:.1f} us "
                    f"({next_us / win_us:.3f}x)")
            for sig, entry in sorted(got.entries.items()):
                log(f"    entry {sig}: {entry.knobs}")
            if routing:
                swept.merge(got)
    finally:
        eng.set_engine(saved)
    log("  routing entries of this run: " + json.dumps(swept.to_json()))
    shipped = seeded.seeded_cache()
    agree = []
    for sig, entry in sorted(swept.entries.items()):
        hit = shipped.lookup(PlanKey.from_signature(sig))
        # one chunk is the unchunked default: the seeded entries name
        # chunks only where a chunked form won
        won = {k: v for k, v in entry.knobs.items()
               if (k, v) != ("chunks", 1)}
        agree.append(hit is not None and hit.knobs == won)
        log(f"    {sig}: this run {won}, seeded "
            f"{None if hit is None else hit.knobs}")
    log(f"  {sum(agree)} of {len(agree)} of this run's routing winners are "
        f"the seeded entries'")

    # the default engine: the seeded H100 entries decide untuned calls
    forms = seeded_forms()
    xs = [torch.rand(SMI_ELEMS, generator=gen, device=dev) + 0.5
          for _ in range(n)]
    for topology, world in (("n8", flat), ("n8:dcn2", hybrid)):
        kw = forms[topology]
        untuned, kinds = rendezvous_kinds(
            world, lambda c: st.allreduce(xs[c.rank], c))
        pinned, pinned_kinds = rendezvous_kinds(
            world, lambda c: st.allreduce(xs[c.rank], c, **kw))
        want = allreduce_kinds(kw)
        if [k[0] for k in kinds] != want or kinds != pinned_kinds:
            raise AssertionError(f"untuned allreduce on {topology}: "
                                 f"rendezvous {kinds}, pinned {kw} "
                                 f"{pinned_kinds}, expected {want}")
        if not all(torch.equal(u, p) for u, p in zip(untuned, pinned)):
            raise AssertionError(f"untuned allreduce on {topology} != the "
                                 f"pinned {kw}")
        log(f"  untuned 4 MiB allreduce on {topology}: rendezvous {want}, "
            f"torch.equal on every rank to the pinned form {kw} its seeded "
            f"entry names")
        algorithm = forms[f"all_to_all {topology}"]
        untuned, kinds = rendezvous_kinds(
            world, lambda c: st.all_to_all(xs[c.rank], c))
        pinned, pinned_kinds = rendezvous_kinds(
            world, lambda c: st.all_to_all(xs[c.rank], c,
                                           algorithm=algorithm))
        if kinds != pinned_kinds or not all(
                torch.equal(u, p) for u, p in zip(untuned, pinned)):
            raise AssertionError(f"untuned all_to_all on {topology} != the "
                                 f"pinned algorithm={algorithm!r}")
        log(f"  untuned 4 MiB all_to_all on {topology}: {len(kinds)} "
            f"rendezvous, torch.equal on every rank to the pinned "
            f"algorithm={algorithm!r} its seeded entry names")
    ctx = st.SmiContext(hybrid.comms[0])
    for op in ("all_reduce", "all_to_all"):
        log(f"  SmiContext.explain_plan({op!r}) on the {HYBRID_GRID} world:")
        for line in ctx.explain_plan(op).splitlines():
            log(f"    {line}")


#: phase 33: the thread worlds' backward, (S a rank, H, D), f32 causal
BWD_WORLDS = (2, 4)
BWD_SHAPE = (512, 2, 64)
#: and one timed 4-rank flash backward at the attention phases' widths
BWD_TIMED = (4, SEQ // 4, HEADS, HEAD_DIM)
#: a hung rendezvous breaks after this long (the default is 600 s)
BWD_RENDEZVOUS_S = 30.0


def attention_grads(comm, arrays, weight, use_flash, threads):
    """``(dq, dk, dv)`` of ``sum(attention(q, k, v) * weight)`` on this
    rank's sequence shards by one ``.backward()``, and the seconds of that
    backward on this rank's stream. The thread that ran q's gradient node
    is appended to ``threads`` as ``(rank, name)``."""
    import threading

    import torch

    import smi_tpu_torch as st

    q, k, v = (st.sequence_shard_from_numpy(x, comm).requires_grad_(True)
               for x in arrays)
    q.register_hook(lambda g: threads.append(
        (comm.rank, threading.current_thread().name)))
    out = st.make_ring_attention_fn(comm, causal=True,
                                    use_flash=use_flash)(q, k, v)
    loss = (out * st.sequence_shard_from_numpy(weight, comm)).sum()
    torch.cuda.current_stream().synchronize()
    t0 = time.perf_counter()
    loss.backward()
    torch.cuda.current_stream().synchronize()
    return q.grad, k.grad, v.grad, time.perf_counter() - t0


def grads_within(what, got, want):
    """Each gradient within F32_TOL (atol = rtol) of the one-rank one;
    returns the largest absolute error."""
    import torch

    worst = 0.0
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        diff = (g - w).abs()
        worst = max(worst, diff.max().item())
        if bool((diff > F32_TOL + F32_TOL * w.abs()).any()):
            raise AssertionError(f"{what} {name}: outside {F32_TOL} of the "
                                 f"one-rank gradients, max abs err "
                                 f"{diff.max().item()}")
    if not all(bool(torch.isfinite(g).all()) for g in got):
        raise AssertionError(f"{what}: gradients are not finite")
    return worst


def backward_world_phase(dev):
    """Phase 33: ``.backward()`` on every rank of a CUDA ``LocalWorld``
    through autograd, the flash and plain tiers of ring attention at 2
    and 4 ranks and a 4-rank ``ring_shift``, each against the one-rank
    gradients, with the rendezvous timeout cut to ``BWD_RENDEZVOUS_S``;
    then one timed 4-rank flash backward at ``BWD_TIMED``, and a backward
    called on the outputs after ``run`` returned, which must fail at
    once. Launch counts are set to 0 before and read after; returns
    them."""
    import numpy as np
    import torch

    import smi_tpu_torch as st
    from smi_tpu_torch.kernels import _build
    from smi_tpu_torch.parallel import local

    log(f"[33 the backward on a thread world: .backward() on every rank of "
        f"CUDA LocalWorlds of {BWD_WORLDS} ranks, flash and plain tiers, "
        f"rendezvous timeout {BWD_RENDEZVOUS_S} s]")
    torch.cuda.synchronize()
    _build.reset_launches()
    one = st.make_communicator(shape=(1,), axis_names=("sp",))

    def check(n, s_local, h, d, use_flash, seed):
        rng = np.random.RandomState(seed)
        q, k, v, w = (rng.randn(s_local * n, h, d).astype(np.float32)
                      for _ in range(4))
        want = attention_grads(one, (q, k, v), w, use_flash, [])
        world = st.LocalWorld(n, ("sp",))
        threads = []
        t0 = time.perf_counter()
        got = world.run(lambda c: attention_grads(c, (q, k, v), w,
                                                  use_flash, threads))
        wall = time.perf_counter() - t0
        tier = "flash" if use_flash else "plain"
        what = f"{n} ranks {tier} S={s_local}x{n} H={h} D={d}"
        if wall >= BWD_RENDEZVOUS_S:
            raise AssertionError(f"{what}: {wall:.1f} s, not inside the "
                                 f"{BWD_RENDEZVOUS_S} s rendezvous timeout")
        if sorted(threads) != [(r, f"smi-rank-{r}") for r in range(n)]:
            raise AssertionError(f"{what}: q's gradient nodes ran on "
                                 f"{sorted(threads)}, not on the rank "
                                 f"threads")
        err = grads_within(what, [torch.cat([g[i] for g in got])
                                  for i in range(3)], want[:3])
        backward_s = max(g[3] for g in got)
        log(f"  {what}: .backward() on every rank, q's nodes on threads "
            f"{[name for _, name in sorted(threads)]}; gradients within "
            f"{F32_TOL} of the one-rank ones (max abs err {err:.3g}); "
            f"backward {backward_s * 1e3:.3f} ms (slowest rank's stream), "
            f"forward + backward {wall * 1e3:.3f} ms host wall "
            f"(one-rank backward {want[3] * 1e3:.3f} ms)")
        return backward_s

    with patched(local, RENDEZVOUS_TIMEOUT_S=BWD_RENDEZVOUS_S):
        s_local, h, d = BWD_SHAPE
        for n in BWD_WORLDS:
            for use_flash in (True, False):
                check(n, s_local, h, d, use_flash, SEED + n)
        n = 4
        world = st.LocalWorld(n)

        def shifted(c):
            x = torch.full((3, 130), float(c.rank), device=c.device,
                           requires_grad=True)
            (st.ring_shift(x, c) * (c.rank + 1)).sum().backward()
            return x.grad

        for r, g in enumerate(world.run(shifted)):
            if not torch.equal(g, torch.full_like(g, (r + 1) % n + 1)):
                raise AssertionError(f"ring_shift backward: rank {r}'s "
                                     f"gradient is not {(r + 1) % n + 1}")
        log(f"  ring_shift on {n} ranks: each rank's gradient is the next "
            f"rank's weight (torch.equal)")
        n, s_local, h, d = BWD_TIMED
        backward_s = check(n, s_local, h, d, True, SEED)

        world = st.LocalWorld(2, ("sp",))
        rng = np.random.RandomState(SEED)
        q = rng.randn(2 * s_local, 2, 64).astype(np.float32)
        outs = world.run(lambda c: st.make_ring_attention_fn(
            c, causal=True)(*(st.sequence_shard_from_numpy(
                q, c).requires_grad_(True) for _ in range(3))))
        t0 = time.perf_counter()
        try:
            torch.stack(outs).sum().backward()
        except RuntimeError as exc:
            if "world.run" not in str(exc):
                raise
            log(f"  a backward on the outputs after run returned fails in "
                f"{(time.perf_counter() - t0) * 1e3:.3f} ms: "
                f"{str(exc)[:160]}...")
        else:
            raise AssertionError("a backward outside world.run did not "
                                 "fail")
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    for name in ("flash_block", "flash_bwd_dq", "flash_bwd_dkdv"):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched by the "
                                 f"thread worlds' backward")
    log(f"  launches {launches}; the {BWD_TIMED[0]}-rank flash backward at "
        f"S={BWD_TIMED[1]}x{BWD_TIMED[0]} H={BWD_TIMED[2]} "
        f"D={BWD_TIMED[3]} f32: {backward_s * 1e3:.3f} ms")
    return launches


#: phase 34: the checkpointed Jacobi drivers (N x N f32)
ELASTIC_ITERS, ELASTIC_CADENCE, ELASTIC_CRASH_AT = 12, 4, 10
#: and k-means on 8 ranks, then on the 7 survivors
KMEANS_POINTS, KMEANS_K, KMEANS_DIMS, KMEANS_ITERS = 65520, 16, 2, 3
DROPPED = 5


class Crash(RuntimeError):
    """A step that raises: the stand-in for a crash mid-run."""


@contextlib.contextmanager
def crashing_sweeps(at):
    """``models.stencil.make_stencil_fn``'s sweeps raise :class:`Crash`
    from the ``at``-th call of each (every rank's sweep at iteration
    ``at``)."""
    from smi_tpu_torch.models import stencil

    real = stencil.make_stencil_fn

    def make(comm, iterations, **kw):
        fn, calls = real(comm, iterations, **kw), [0]

        def sweep(block):
            calls[0] += 1
            if calls[0] > at:
                raise Crash(f"crash at iteration {at}")
            return fn(block)

        return sweep

    with patched(stencil, make_stencil_fn=make):
        yield


def elastic_phase(dev, smi_line):
    """Phase 34: the elastic path. The checkpointed Jacobi driver at
    N x N f32 on a 1x1 communicator and on the 2x4 world, crashed at
    iteration ``ELASTIC_CRASH_AT`` and resumed, ``torch.equal`` to the
    uninterrupted run; one 256 MiB checkpoint's save and restore timed;
    checkpointed k-means on 8 ranks; ``recover_communicator`` dropping
    rank ``DROPPED`` (heirs, epoch, the stale epoch refused); the means
    restored on the 7 survivors and 3 more iterations on the ring tier
    against ``reference_kmeans``, and the neighbour stream on that
    7-rank ring against its plain version; the regrown 8-rank world's
    all-reduce ``torch.equal`` to its plain version. Launch counts are set to 0
    before and read after; returns them (rows 5 and 7 add them)."""
    import os
    import tempfile

    import numpy as np
    import torch

    import smi_tpu_torch as st
    from smi_tpu_torch.kernels import _build
    from smi_tpu_torch.kernels import ring as kring
    from smi_tpu_torch.parallel import checkpoint as ckpt

    log(f"[34 the elastic path: checkpointed Jacobi at {N}x{N} f32 crashed "
        f"at iteration {ELASTIC_CRASH_AT} of {ELASTIC_ITERS} and resumed; "
        f"k-means on 8 ranks, rank {DROPPED} lost, 7 survivors on the ring "
        f"tier, regrown to 8]")
    log(f"  {smi_line}")
    torch.cuda.synchronize()
    _build.reset_launches()
    grid = st.initial_grid(N, N)
    grid[:, -1] = 2.0
    with tempfile.TemporaryDirectory(prefix="smi-checkpoints-") as tmp:
        last = None
        for label, comm in (
                ("1x1 communicator", st.make_communicator(
                    shape=(1, 1), axis_names=("sx", "sy"))),
                ("2x4 LocalWorld", st.LocalWorld((2, 4), ("sx", "sy")))):
            t0 = time.perf_counter()
            want = ckpt.run_jacobi(grid, ELASTIC_ITERS, comm=comm)
            torch.cuda.synchronize()
            plain_s = time.perf_counter() - t0
            store = ckpt.CheckpointStore(os.path.join(
                tmp, label.replace(" ", "-")), keep=2)
            t0 = time.perf_counter()
            try:
                with crashing_sweeps(ELASTIC_CRASH_AT):
                    ckpt.run_jacobi(grid, ELASTIC_ITERS, comm=comm,
                                    store=store, cadence=ELASTIC_CADENCE)
            except Crash:
                pass
            else:
                raise AssertionError("the crashing step did not crash")
            crashed_s = time.perf_counter() - t0
            resumed_at = store.latest_step()
            t0 = time.perf_counter()
            got = ckpt.run_jacobi(grid, ELASTIC_ITERS, comm=comm,
                                  store=store, cadence=ELASTIC_CADENCE)
            torch.cuda.synchronize()
            resume_s = time.perf_counter() - t0
            if resumed_at != ELASTIC_CRASH_AT // ELASTIC_CADENCE * \
                    ELASTIC_CADENCE:
                raise AssertionError(f"{label}: the store holds step "
                                     f"{resumed_at}")
            if tuple(got.shape) != (N, N) or not torch.equal(got, want):
                raise AssertionError(f"{label}: the resumed run != the "
                                     f"uninterrupted run")
            _, bands, _ = store.restore()
            log(f"  {label}: crashed at iteration {ELASTIC_CRASH_AT} "
                f"({crashed_s:.3f} s with its checkpoints), resumed from "
                f"step {resumed_at} ({resume_s:.3f} s), torch.equal to the "
                f"uninterrupted run ({plain_s:.3f} s without a store); "
                f"{len(bands)} band(s) of {bands[0].shape} in the store")
            last = got
        ref = st.reference_stencil(grid[:1024, :1024].copy(), ELASTIC_ITERS)
        small = ckpt.run_jacobi(grid[:1024, :1024].copy(), ELASTIC_ITERS,
                                comm=st.LocalWorld((2, 4), ("sx", "sy")))
        if not np.array_equal(small.cpu().numpy(), ref):
            raise AssertionError("1024x1024 checkpointed Jacobi != numpy "
                                 "reference_stencil")
        log("  1024x1024 on the 2x4 world: array_equal to the numpy "
            "reference_stencil")

        store = ckpt.CheckpointStore(os.path.join(tmp, "timed"), keep=1)
        nbytes = last.numel() * last.element_size()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        store.save(0, {0: last})
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        _, shards, _ = store.restore()
        back = torch.from_numpy(shards[0]).to(dev)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        if not torch.equal(back, last):
            raise AssertionError("the restored checkpoint != the saved grid")
        log(f"  one {nbytes / 2**20:.0f} MiB checkpoint (one shard and its "
            f"manifest, fsync'd): save from the card {save_s * 1e3:.3f} ms "
            f"({nbytes / save_s / 1e9:.4g} GB/s), restore to the card "
            f"{restore_s * 1e3:.3f} ms ({nbytes / restore_s / 1e9:.4g} GB/s, "
            f"read back through the page cache); {smi_line}")

        rng = np.random.RandomState(SEED)
        centres = rng.rand(KMEANS_K, KMEANS_DIMS).astype(np.float32) * 10
        pts = (centres[rng.randint(0, KMEANS_K, KMEANS_POINTS)]
               + rng.randn(KMEANS_POINTS, KMEANS_DIMS).astype(np.float32)
               * 0.3).astype(np.float32)
        init = pts[:KMEANS_K].copy()
        world8 = st.LocalWorld(SMI_RANKS)
        store = ckpt.CheckpointStore(os.path.join(tmp, "kmeans"))
        means = ckpt.run_kmeans(pts, init, KMEANS_ITERS, comm=world8,
                                store=store, cadence=KMEANS_ITERS,
                                backend="ring")
        np.testing.assert_allclose(
            means.cpu().numpy(), st.reference_kmeans(pts, init, KMEANS_ITERS),
            rtol=1e-3, atol=1e-4)
        log(f"  k-means on {SMI_RANKS} ranks, {KMEANS_POINTS} points, "
            f"k={KMEANS_K}, {KMEANS_DIMS} dims, {KMEANS_ITERS} iterations "
            f"on the ring tier, checkpointed: within rtol 1e-3, atol 1e-4 "
            f"of reference_kmeans")
        t0 = time.perf_counter()
        survivors, heirs = st.recover_communicator(world8.comms[0],
                                                   {DROPPED})
        shrink_s = time.perf_counter() - t0
        if heirs != {DROPPED: DROPPED + 1} or survivors.epoch != 1 or \
                survivors.size != SMI_RANKS - 1:
            raise AssertionError(f"recover_communicator: heirs {heirs}, "
                                 f"epoch {survivors.epoch}, size "
                                 f"{survivors.size}")
        try:
            survivors.validate_epoch(DROPPED + 1, 0)
        except st.StaleEpochError as exc:
            refused = str(exc)
        else:
            raise AssertionError("validate_epoch took epoch 0 at epoch 1")
        log(f"  recover_communicator dropping rank {DROPPED}: heirs {heirs}, "
            f"epoch {survivors.epoch}, {survivors.size} ranks, "
            f"{shrink_s * 1e3:.3f} ms of host time; validate_epoch refuses "
            f"epoch 0: {refused[:90]}...")
        world7 = survivors.world
        before = dict(_build.LAUNCHES)
        t0 = time.perf_counter()
        means7 = ckpt.run_kmeans(pts, init, 2 * KMEANS_ITERS, comm=world7,
                                 store=store, cadence=KMEANS_ITERS,
                                 backend="ring")
        torch.cuda.synchronize()
        wall7 = time.perf_counter() - t0
        seven = _build.LAUNCHES["ring_all_reduce"] - before["ring_all_reduce"]
        if seven <= 0:
            raise AssertionError("the 7 survivors' k-means launched no ring "
                                 "all-reduce")
        if store.latest_step() != 2 * KMEANS_ITERS:
            raise AssertionError(f"the survivors' store holds step "
                                 f"{store.latest_step()}")
        np.testing.assert_allclose(
            means7.cpu().numpy(),
            st.reference_kmeans(pts, init, 2 * KMEANS_ITERS),
            rtol=1e-3, atol=1e-4)
        log(f"  the means restored at iteration {KMEANS_ITERS} on the "
            f"{world7.size} survivors (ranks {world7.parent_ranks}), "
            f"{KMEANS_ITERS} more on the ring tier ({wall7 * 1e3:.1f} ms, "
            f"{seven} ring all-reduce launches: k-means' reduce and bcast "
            f"are each one): within rtol 1e-3, atol 1e-4 of "
            f"reference_kmeans at {2 * KMEANS_ITERS} iterations")
        # the neighbour stream on the same 7-rank ring: its 16 chunks of
        # 512 KiB a rank, each rank's to the next
        xs = [torch.rand((STREAM_CHUNKS, HALF_MIB // STREAM_CHUNKS),
                         device=dev) for _ in range(world7.size)]
        got = world7.run(lambda c: kring.neighbour_stream(xs[c.rank], c))
        want = kring.neighbour_stream_plain(xs)
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError("the neighbour stream on the 7 survivors "
                                 "!= its plain version")
        log(f"  the neighbour stream on the {world7.size} survivors "
            f"({STREAM_CHUNKS} chunks, 512 KiB a rank): torch.equal to its "
            f"plain version")
        regrown = world8.regrow({DROPPED}, {DROPPED})
        if (regrown.size, regrown.epoch) != (SMI_RANKS, 2):
            raise AssertionError(f"regrow: {regrown.size} ranks at epoch "
                                 f"{regrown.epoch}")
        xs = [torch.rand(SMI_ELEMS, device=dev) for _ in range(SMI_RANKS)]
        got = regrown.run(lambda c: kring.ring_all_reduce(xs[c.rank], c))
        want = kring.ring_all_reduce_plain(xs)
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError("the regrown world's all-reduce != its "
                                 "plain version")
        log(f"  regrow to {regrown.size} ranks at epoch {regrown.epoch}: a "
            f"4 MiB ring all-reduce torch.equal to its plain version")
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    for kernel in ("ring_all_reduce", "ring_neighbour_stream"):
        if launches[kernel] <= 0:
            raise AssertionError(f"kernel {kernel} was not launched on the "
                                 f"elastic path")
    log(f"  launches {launches}")
    return launches


#: phase 35: the rank a simulated all-reduce loses (``tests/test_recovery.py``'s
#: input: crash-stop after 3 actions) and the heir that inherits from it
FAULT_RANK, FAULT_AFTER, FAULT_HEIR = 5, 3, 6
#: the watchdog's budget on the survivors' readbacks, seconds
READBACK_BUDGET_S = 60.0
#: the protocols of the recovery cells run on the card's host
RECOVERY_PROTOCOLS = ("all_gather", "all_reduce", "reduce_scatter",
                      "neighbour_stream")
#: the simulator cells phase 35 leaves out: each reaches ``networkx``
#: (through ``parallel.routing``), which the card's machine lacks
NETWORKX_CELLS = (
    "run_with_recovery under a DownLink (recovery._check_cut_routable)",
    "chaos_campaign (its plans draw DownLink faults)",
    "run_elastic_cell / elastic_campaign (regrow: plan_regrow_ring)",
    "run_pod_cell / pod_campaign (plan_pod_rings)",
    "MembershipView.failure_set",
)


def fault_tier_phase(dev, smi_line):
    """Phase 35: the fault-simulator tier on an 8-rank CUDA ``LocalWorld``.
    (a) ``Deadline(0.0)`` on ``bcast``, ``reduce``, ``allreduce``,
    ``scatter`` and ``gather`` (``backend="ring"``) and a channel's
    ``transfer`` and ``stream``: each rank raises ``WatchdogTimeout`` whose
    ``.state`` is ``faults.mirror_stall_dump`` of the family's protocol
    at n = 8, and no ring kernel launches. (b) The simulator's all-reduce
    at n = 8 with rank ``FAULT_RANK`` crash-stopped raises
    ``DeadlockError`` naming it stalled; ``recover_communicator`` on that
    error shrinks the world to 7 with heir ``FAULT_HEIR``; the survivors'
    4 MiB f32 ring all-reduce and 512 KiB neighbour stream, each
    ``torch.equal`` to its plain version with every credit domain
    drained, each rank's result read back under ``run_with_deadline``
    (c); one all-reduce through ``timed(deadline_s=, sink=)`` records
    one sample. (d) On the host: ``run_with_recovery`` for a crash-stop
    plan on each ring protocol at n = 8, healed to ``expected_results``,
    and the phi-accrual detector with a ``MembershipView`` on one
    heartbeat trace until the view confirms the silent rank. Launch
    counts are set to 0 before and read after; returns them (rows 5 and
    7 add them)."""
    import numpy as np
    import torch

    import smi_tpu_torch as st
    from smi_tpu_torch.kernels import _build
    from smi_tpu_torch.kernels import ring as kring
    from smi_tpu_torch.parallel import collectives as coll
    from smi_tpu_torch.parallel import credits as C
    from smi_tpu_torch.parallel import faults as F
    from smi_tpu_torch.parallel import membership as M
    from smi_tpu_torch.parallel import recovery as R
    from smi_tpu_torch.tuning.online import OnlineTuner
    from smi_tpu_torch.utils import tracing
    from smi_tpu_torch.utils import watchdog as W

    log(f"[35 the fault-simulator tier: the protocol mirror on {SMI_RANKS} "
        f"ranks' expired ring deadlines; a simulated crash of rank "
        f"{FAULT_RANK} shrinks the world; the survivors' ring kernels; "
        f"run_with_recovery and the detector on the host]")
    log(f"  {smi_line}")
    torch.cuda.synchronize()
    _build.reset_launches()
    world = st.LocalWorld(SMI_RANKS)
    x_rank = [torch.rand(SMI_ELEMS, device=dev) for _ in range(SMI_RANKS)]

    # ---- (a) the mirror on every ring-tier deadline ------------------
    def channel(c):
        return st.P2PChannel(comm=c, port=0, src=0, dst=3, count=SMI_ELEMS)

    families = {
        "bcast": ("all_reduce", lambda x, c, d: coll.bcast(
            x, c, root=FAULT_RANK, backend="ring", deadline=d)),
        "reduce": ("all_reduce", lambda x, c, d: coll.reduce(
            x, c, backend="ring", deadline=d)),
        "allreduce": ("all_reduce", lambda x, c, d: coll.allreduce(
            x, c, backend="ring", deadline=d)),
        "scatter": ("reduce_scatter", lambda x, c, d: coll.scatter(
            x, c, backend="ring", deadline=d)),
        "gather": ("all_gather", lambda x, c, d: coll.gather(
            x, c, backend="ring", deadline=d)),
        "transfer": ("neighbour_stream", lambda x, c, d: channel(
            c).transfer(x, backend="ring", deadline=d)),
        "stream": ("neighbour_stream", lambda x, c, d: channel(
            c).stream(x, backend="ring", deadline=d)),
    }
    ring_kernels = [k for k in _build.LAUNCHES if k.startswith("ring_")]
    before = {k: _build.LAUNCHES[k] for k in ring_kernels}
    for family, (protocol, call) in families.items():
        def expire(c):
            try:
                call(x_rank[c.rank], c, W.Deadline(0.0))
            except W.WatchdogTimeout as exc:
                return exc
            raise AssertionError(f"{family}: an expired deadline "
                                 f"dispatched on rank {c.rank}")

        t0 = time.perf_counter()
        errors = world.run(expire)
        wall = time.perf_counter() - t0
        want = F.mirror_stall_dump(protocol, SMI_RANKS)
        for r, exc in enumerate(errors):
            if exc.state != want or \
                    f"protocol mirror [{protocol}, n={SMI_RANKS}]" not in \
                    (exc.state_dump or ""):
                raise AssertionError(f"{family}: rank {r}'s timeout holds "
                                     f"no {protocol} mirror: {exc}")
        states = sorted({v["state"] for k, v in want.items()
                         if isinstance(k, int)})
        log(f"  {family}: all {SMI_RANKS} ranks raised WatchdogTimeout with "
            f"the {protocol} mirror (ranks {', '.join(states)}); "
            f"{wall * 1e3:.3f} ms for the world")
    moved = {k: _build.LAUNCHES[k] - before[k] for k in ring_kernels
             if _build.LAUNCHES[k] != before[k]}
    if moved:
        raise AssertionError(f"expired deadlines launched ring kernels: "
                             f"{moved}")
    log(f"  no ring kernel launched under an expired deadline "
        f"({', '.join(ring_kernels)} unmoved)")

    # ---- (b) recovery from a simulated crash, on the ring kernels ----
    try:
        C.simulate_all_reduce(SMI_RANKS, C.Strategy(0),
                              faults=F.FaultPlan.single(
                                  F.StalledRank(FAULT_RANK,
                                                after=FAULT_AFTER)))
    except C.DeadlockError as exc:
        dead = exc
    else:
        raise AssertionError("the crash-stopped all-reduce completed")
    if dead.state[FAULT_RANK]["state"] != "stalled" or \
            R.failed_ranks_of(dead) != {FAULT_RANK}:
        raise AssertionError(f"the deadlock names {R.failed_ranks_of(dead)}"
                             f" stalled")
    t0 = time.perf_counter()
    survivors, heirs = st.recover_communicator(world.comms[0], dead)
    shrink_s = time.perf_counter() - t0
    world7 = survivors.world
    if heirs != {FAULT_RANK: FAULT_HEIR} or world7.size != SMI_RANKS - 1 \
            or FAULT_RANK in world7.parent_ranks:
        raise AssertionError(f"recover_communicator: heirs {heirs}, ranks "
                             f"{world7.parent_ranks}")
    log(f"  DeadlockError of the simulated all-reduce names rank "
        f"{FAULT_RANK} stalled; recover_communicator: heirs {heirs}, "
        f"epoch {survivors.epoch}, ranks {world7.parent_ranks}, "
        f"{shrink_s * 1e3:.3f} ms of host time")

    readback_s = []

    def read_back(y):
        """This rank's result read back to the host under the watchdog,
        in the rank's thread (its own stream)."""
        t0 = time.perf_counter()
        host = W.run_with_deadline(
            lambda: y.cpu(), READBACK_BUDGET_S,
            state_provider=F.mirror_state_provider(
                "allreduce", world7.size, structured=True),
            context="survivor readback")
        readback_s.append(time.perf_counter() - t0)
        return host

    xs = x_rank[:world7.size]
    cases = (
        ("ring_all_reduce", xs, kring.ring_all_reduce,
         kring.ring_all_reduce_plain, "4 MiB f32 all-reduce"),
        ("ring_neighbour_stream",
         [torch.rand((STREAM_CHUNKS, HALF_MIB // STREAM_CHUNKS), device=dev)
          for _ in range(world7.size)],
         kring.neighbour_stream, kring.neighbour_stream_plain,
         f"{STREAM_CHUNKS}-chunk 512 KiB neighbour stream"),
    )
    for kernel, inputs, call, plain, what in cases:
        readback_s.clear()
        got = world7.run(lambda c: read_back(call(inputs[c.rank], c)))
        record = kring.last_record(world7)
        want = plain(inputs)
        for r, (g, w) in enumerate(zip(got, want)):
            if not torch.equal(g, w.cpu()):
                err = (g.double() - w.cpu().double()).abs().max().item()
                raise AssertionError(f"survivors' {what}: rank {r} kernel "
                                     f"!= plain, max abs err {err}")
        if not kring.drained(record):
            raise AssertionError(
                f"survivors' {what}: credits did not drain: granted "
                f"{int(record['granted'].sum())}, consumed "
                f"{int(record['consumed'].sum())}")
        log(f"  the {world7.size} survivors' {what} ({kernel}): torch.equal "
            f"to its plain version, credits drained "
            f"({int(record['granted'].sum())} granted); each rank's "
            f"readback under run_with_deadline({READBACK_BUDGET_S:g} s): "
            f"{min(readback_s) * 1e3:.3f}-{max(readback_s) * 1e3:.3f} ms; "
            f"{smi_line}")

    # ---- (c) timed with a deadline and a sink ------------------------
    tuner = OnlineTuner()
    out, secs = tracing.timed(
        lambda: world7.run(lambda c: kring.ring_all_reduce(xs[c.rank], c)),
        deadline_s=READBACK_BUDGET_S, sink=tuner, op="all_reduce",
        payload_bytes=4.0 * SMI_ELEMS, tenant="phase-35")
    if tuner.samples_ingested != 1 or len(tuner.cells) != 1:
        raise AssertionError(f"timed(sink=) recorded "
                             f"{tuner.samples_ingested} samples")
    want = kring.ring_all_reduce_plain(xs)
    if not all(torch.equal(g, w) for g, w in zip(out, want)):
        raise AssertionError("the timed all-reduce != its plain version")
    (cell,) = tuner.cells.values()
    log(f"  timed(deadline_s={READBACK_BUDGET_S:g}, sink=OnlineTuner): one "
        f"sample of {cell.mean_us:.1f} us for the 7 survivors' 4 MiB "
        f"all-reduce and its readback ({secs * 1e3:.3f} ms wall); "
        f"{smi_line}")

    # ---- (d) the simulators on this machine's host -------------------
    t0 = time.perf_counter()
    for protocol in RECOVERY_PROTOCOLS:
        out = R.run_with_recovery(
            protocol, SMI_RANKS,
            F.FaultPlan.single(F.StalledRank(FAULT_RANK, after=FAULT_AFTER)))
        expected = R.expected_results(
            protocol, SMI_RANKS,
            R.canonical_inputs(protocol, SMI_RANKS, 5), 5)
        if not out.ok or any(out.results[g] != expected[g]
                             for g in out.survivors):
            raise AssertionError(f"run_with_recovery({protocol}) did not "
                                 f"heal: {out.fault_trail}")
        log(f"  run_with_recovery({protocol}, n={SMI_RANKS}, rank "
            f"{FAULT_RANK} crash-stopped): healed to expected_results on "
            f"{len(out.survivors)} survivors, trail {out.fault_trail}, "
            f"{out.replayed_chunks} chunks replayed")
    recovery_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    clock = M.StepClock()
    detector = M.PhiAccrualDetector(clock, range(SMI_RANKS))
    view = M.MembershipView(SMI_RANKS)
    events, confirmed_at = [], None
    for tick in range(40 * M.HEARTBEAT_INTERVAL):
        if tick % M.HEARTBEAT_INTERVAL == 0:
            for r in range(SMI_RANKS):
                if r != FAULT_RANK or tick < 10 * M.HEARTBEAT_INTERVAL:
                    detector.heartbeat(r)
        clock.advance(1)
        for event in detector.poll():
            events.append(type(event).__name__)
            if isinstance(event, M.ConfirmedDead):
                view.confirm_dead(event.rank)
                confirmed_at = tick
        if confirmed_at is not None:
            break
    detector_s = time.perf_counter() - t0
    if confirmed_at is None or FAULT_RANK in view.members or \
            "SuspectRank" not in events:
        raise AssertionError(f"the detector never confirmed rank "
                             f"{FAULT_RANK}: {events}")
    log(f"  PhiAccrualDetector + MembershipView: rank {FAULT_RANK} silent "
        f"from tick {10 * M.HEARTBEAT_INTERVAL}, events {events}, confirmed "
        f"dead at tick {confirmed_at}; the view at epoch {view.epoch} with "
        f"{len(view.members)} members")
    log(f"  host cells: {len(RECOVERY_PROTOCOLS) + 1} ("
        f"{len(RECOVERY_PROTOCOLS)} recovery cells {recovery_s * 1e3:.1f} "
        f"ms, the detector cell {detector_s * 1e3:.1f} ms); left out, as "
        f"they need networkx: {'; '.join(NETWORKX_CELLS)}")

    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    for kernel in ("ring_all_reduce", "ring_neighbour_stream"):
        if launches[kernel] <= 0:
            raise AssertionError(f"kernel {kernel} was not launched on the "
                                 f"fault tier's path")
    log(f"  launches {launches}")
    return launches


#: phase 36: timed passes a candidate of the stencil sweep (after one
#: warm-up), as ``smi-tpu tune --ops stencil`` runs it
STENCIL_SWEEP_RUNS = 3
#: phase 36: the pipeline kernel's own stripes, below the cost model's
#: grid (32-256, the v5e's), timed beside it and not seeded
STENCIL_SIDE_STRIPES = (8, 16)


def analysis_obs_phase(dev, smi_line):
    """Phase 36: the analysis and observability tiers on the card's
    machine. (a) ``sweep_stencil`` at N x N f32 on the card, every
    candidate timed or refused with its reason, the winner's one pass
    held to its plain version. (b) On an 8-rank ``LocalWorld`` at 4 MiB
    f32 a rank: one ring all-reduce through ``timed(sink=SampleSink())``,
    equal to its plain version with credits drained, and an expired
    ``Deadline(0.0, recorder=FlightRecorder())`` on the ring
    ``allreduce``, which must raise with the recorder's tail on every
    rank and launch nothing. (c) ``perf_all`` and ``trace_protocol`` on
    the host. (d) The default engine's stencil plan must be the seeded
    H100 entry, admitted by the kernel. Launch counts of (a)'s sweep and
    (b)'s timed all-reduce are returned (rows 4 and 7 add them)."""
    import torch

    import smi_tpu_torch as st
    from smi_tpu_torch import analysis as A
    from smi_tpu_torch.kernels import _build
    from smi_tpu_torch.kernels import ring as kring
    from smi_tpu_torch.kernels import stencil_pipeline as kpipe
    from smi_tpu_torch.obs import events as E
    from smi_tpu_torch.obs import metrics as OM
    from smi_tpu_torch.obs import trace as OT
    from smi_tpu_torch.parallel import collectives as coll
    from smi_tpu_torch.parallel import credits as C
    from smi_tpu_torch.tuning.engine import PlanEngine
    from smi_tpu_torch.tuning.seeded import seeded_cache
    from smi_tpu_torch.tuning.sweep import sweep_stencil
    from smi_tpu_torch.utils import tracing
    from smi_tpu_torch.utils import watchdog as W

    log(f"[36 the analysis and observability tiers: the stencil sweep on "
        f"the card; timed(sink=SampleSink) and a recorder on an expired "
        f"ring deadline on {SMI_RANKS} ranks; perf_all and trace_protocol "
        f"on the host]")
    log(f"  {smi_line}")
    launches = {}

    # ---- (a) the stencil sweep on the card ---------------------------
    rows = []
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    cache = sweep_stencil(N, N, "float32", runs=STENCIL_SWEEP_RUNS,
                          record=rows)
    sweep_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches["stencil_pipeline"] = _build.LAUNCHES["stencil_pipeline"]
    timed_rows = sorted((us, name) for name, us, _ in rows if us is not None)
    for name, us, note in rows:
        log(f"  {name}: " + (f"{us:.3f} us a sweep ({note})" if us is not None
                             else note))
    (sig, entry), = cache.entries.items()
    knobs = entry.knobs
    if not timed_rows or launches["stencil_pipeline"] <= 0:
        raise AssertionError(f"the stencil sweep timed nothing: {rows}")
    log(f"  winner {sig}: {knobs}, {entry.cost_us:.3f} us a sweep "
        f"({entry.provenance}); runner-up "
        f"{timed_rows[1][1] if len(timed_rows) > 1 else None}; "
        f"{len(timed_rows)} timed, {len(rows) - len(timed_rows)} refused; "
        f"{launches['stencil_pipeline']} pipeline launches; sweep "
        f"{sweep_s:.3f} s; {smi_line}")
    depth, cdt = knobs["depth"], knobs["compute_dtype"]
    x = torch.from_numpy(st.initial_grid(N, N)).to(dev)
    x[:, -1] = 2.0
    comm = st.make_communicator(shape=(1, 1), axis_names=("sx", "sy"))
    got = kpipe.make_pipeline_stencil_fn(
        comm, depth, N, N, depth=depth, stripe=knobs["stripe"],
        compute_dtype=cdt, buffering=knobs["buffering"])(x)
    want = kpipe.pipeline_sweeps_plain(kpipe._extend(x, depth), 0, 0, N, N,
                                       depth, cdt)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    if not (torch.equal(got, want) if cdt == "float32" else err <= 0.05):
        raise AssertionError(f"the sweep's winner {knobs}: one pass != its "
                             f"plain version, max abs err {err}")
    log(f"  the winner's one pass at {N}x{N}: "
        + ("torch.equal to" if cdt == "float32" else "within 0.05 of")
        + f" its plain version (max abs err {err})")
    # where a timed call goes: the winner's kernel alone (CUDA events, on
    # an extended state made once) against the call through the driver
    ext = kpipe._extend(x, depth)
    nxt = torch.empty_like(ext)
    kernel_ms = time_ms(lambda: kpipe.pipeline_sweeps(
        ext, 0, 0, N, N, depth, knobs["stripe"], cdt, knobs["buffering"],
        out=nxt), 10)
    log(f"  the winner's kernel alone: {kernel_ms:.4f} ms a pass "
        f"({kernel_ms * 1e3 / depth:.3f} us a sweep) of the "
        f"{entry.cost_us * depth / 1e3:.4f} ms a timed call; {smi_line}")
    del x, got, want, ext, nxt
    # beside the v5e grid: the port's own stripes (its default is 8),
    # which the grid leaves out; logged, not seeded
    side = []
    sweep_stencil(N, N, "float32", stripes=STENCIL_SIDE_STRIPES,
                  runs=STENCIL_SWEEP_RUNS, record=side)
    for name, us, note in side:
        if name.startswith("pipe:"):
            log(f"  outside the grid {name}: "
                + (f"{us:.3f} us a sweep" if us is not None else note))

    # ---- (b) observability around the ring tier ----------------------
    world = st.LocalWorld(SMI_RANKS)
    xs = [torch.rand(SMI_ELEMS, device=dev) for _ in range(SMI_RANKS)]
    sink = OM.SampleSink()
    torch.cuda.synchronize()
    _build.reset_launches()
    out, secs = tracing.timed(
        lambda: world.run(lambda c: kring.ring_all_reduce(xs[c.rank], c)),
        sink=sink, op="all_reduce", payload_bytes=4.0 * SMI_ELEMS)
    torch.cuda.synchronize()
    launches["ring_all_reduce"] = _build.LAUNCHES["ring_all_reduce"]
    record = kring.last_record(world)
    want = kring.ring_all_reduce_plain(xs)
    if not all(torch.equal(g, w) for g, w in zip(out, want)):
        raise AssertionError("the timed all-reduce != its plain version")
    if not kring.drained(record):
        raise AssertionError("the timed all-reduce's credits did not drain")
    entries = sink.entries()
    if len(sink) != 1 or len(entries) != 1 or launches["ring_all_reduce"] != 1:
        raise AssertionError(f"timed(sink=SampleSink()) recorded "
                             f"{len(sink)} samples in {entries}, "
                             f"{launches['ring_all_reduce']} launches")
    log(f"  timed(sink=SampleSink()) of the {SMI_RANKS}-rank 4 MiB ring "
        f"all-reduce: one cell {entries[0]} ({secs * 1e3:.3f} ms wall); "
        f"torch.equal to its plain version, credits drained "
        f"({int(record['granted'].sum())} granted); {smi_line}")

    recorders = [E.FlightRecorder() for _ in range(SMI_RANKS)]
    for r, rec in enumerate(recorders):
        # each rank's recorder holds its own simulated all-reduce
        C.simulate_all_reduce(SMI_RANKS, C.Strategy(r), recorder=rec)
    ring_kernels = [k for k in _build.LAUNCHES if k.startswith("ring_")]
    before = {k: _build.LAUNCHES[k] for k in ring_kernels}

    def expire(c):
        try:
            coll.allreduce(xs[c.rank], c, backend="ring",
                           deadline=W.Deadline(0.0,
                                               recorder=recorders[c.rank]))
        except W.WatchdogTimeout as exc:
            return exc
        raise AssertionError(f"an expired deadline dispatched on rank "
                             f"{c.rank}")

    t0 = time.perf_counter()
    errors = world.run(expire)
    wall = time.perf_counter() - t0
    for r, exc in enumerate(errors):
        tail = getattr(exc, "recorder_tail", None)
        if not tail or not tail["events"] or \
                tail != recorders[r].tail() or \
                (exc.state or {}).get("flight_recorder") != tail:
            raise AssertionError(f"rank {r}'s WatchdogTimeout carries no "
                                 f"recorder tail: {exc}")
    moved = {k: _build.LAUNCHES[k] - before[k] for k in ring_kernels
             if _build.LAUNCHES[k] != before[k]}
    if moved:
        raise AssertionError(f"the expired deadline launched {moved}")
    tail = errors[0].recorder_tail
    log(f"  Deadline(0.0, recorder=FlightRecorder()) on the ring allreduce:"
        f" all {SMI_RANKS} ranks raised WatchdogTimeout with the recorder's"
        f" tail ({len(tail['events'])} of {tail['total_events']} events, "
        f"last {tail['events'][-1]['kind']}) on the error and in "
        f"state['flight_recorder']; no ring kernel launched; "
        f"{wall * 1e3:.3f} ms for the world")

    # ---- (c) the host tiers ------------------------------------------
    t0 = time.perf_counter()
    reports = A.perf_all()
    roofline = A.roofline_lint()
    perf_s = time.perf_counter() - t0
    n_findings = A.perf_reports_to_json(reports, roofline)["findings"]
    log(f"  perf_all(): {len(reports)} protocol instances decomposed, "
        f"{n_findings} finding(s) with roofline_lint(), "
        f"{perf_s * 1e3:.1f} ms of host time")
    t0 = time.perf_counter()
    payload = OT.trace_protocol("all_reduce", SMI_RANKS)
    trace_s = time.perf_counter() - t0
    other = payload["otherData"]
    makespan = A.decompose_protocol("all_reduce", n=SMI_RANKS,
                                    verify=False).makespan_s
    if other["span_makespan_us"] != other["makespan_us"] or \
            other["makespan_us"] != makespan * 1e6 or any(
                row["span_end_us"] != row["clock_us"]
                for row in other["per_rank"]):
        raise AssertionError(f"trace_protocol's track ends != the "
                             f"simulator's clocks: {other}")
    OT.validate_chrome_trace(payload)
    log(f"  trace_protocol('all_reduce', n={SMI_RANKS}): "
        f"{len(payload['traceEvents'])} events, every track's end equal "
        f"to its rank's clock and the makespan {other['makespan_us']!r} us"
        f" to elapsed_seconds() bit for bit; {trace_s * 1e3:.1f} ms of "
        f"host time")

    # ---- (d) the seeded H100 entry -----------------------------------
    engine = PlanEngine(cache=seeded_cache())
    plan = engine.stencil_pipeline_plan(N, N)
    text = plan.explain()
    p = plan.knobs
    if "[cache]" not in text or plan.decided_by.get("depth") != "cache" or \
            not kpipe.pipeline_supported(
                N, N, torch.float32, p["depth"], stripe=p["stripe"],
                compute_dtype=p["compute_dtype"], buffering=p["buffering"]):
        raise AssertionError(f"the default engine's stencil plan on "
                             f"{torch.cuda.get_device_name(0)} is no cache "
                             f"hit the kernel admits:\n{text}")
    log(f"  the default engine's stencil_pipeline_plan({N}, {N}): [cache] "
        f"{p}, {engine.cache.lookup(plan.key).cost_us} us a sweep seeded; "
        f"the sweep's winner in this run: {knobs}, {entry.cost_us:.3f} us")
    return launches


#: phase 37: the KV dataflow at full width — requests (one f32 row sum
#: each, so a 4 MiB fold a rank: row 7's shape), KV chunks a request
#: (32 MiB of KV a rank) and decode steps
KV_REQUESTS, KV_CHUNKS, KV_GEN = 1 << 20, 8, 4
#: phase 37: the reference's own shape (``tests/test_inference.py``)
KV_REF_SHAPE = (2, 8, 3)
#: phase 37: each wide token's relative distance from the float64 closed
#: form (the f32 products and row sums round past 2^24)
KV_RTOL = 1e-5
#: phase 37: the serving campaigns run on the host, each with seed 0, and
#: the sha256 of the JAX package's report of the same call as sorted-key
#: JSON (``tests/test_torch_serving.py`` holds these to the JAX package)
SERVING_CAMPAIGNS = {
    "serve_selftest":
        "7c86f06062ceddc349599323f876582ebbb41921e1c860c73bd0dfa1e0f2b349",
    "load_campaign":
        "420cb72b2e959d40c69889b82e4a61bf6f2b314fc45de016fd72a11d596e1e9f",
    "retune_selftest":
        "99657168ce806d045176d325c2e707cfb5ef3c6ff3921e151691272647a57aad",
    "moe_campaign":
        "a821a0d626399243e2fc7c91908ac8d16e7f8729ad7759d72e928ceb40b897fa",
    "infer_selftest":
        "ce8193bd2acf9904526801199ec6cbafe11b952f899bc1c8d34d708d59d12d31",
}
#: the serving campaigns phase 37 leaves out: each reaches ``networkx``
#: (membership's ``plan_regrow_ring``, through ``parallel.routing``),
#: which the card's machine lacks
SERVING_NETWORKX = (
    "autoscale_selftest (ElasticityController.bind parks its spares "
    "through shrink_pod -> plan_regrow_ring)",
    "partition_selftest (the heal's regrow_pod -> plan_regrow_ring)",
)


def kv_closed_form(n, requests, kv_chunks, gen_len):
    """``traced_kv_dataflow``'s tokens in float64: at step s rank i's row
    r sums ``(i + 1) * P_r + kv_chunks * s * (s + 1) / 2``, ``P_r`` the
    row's prompt sum, and the token is the prefix of the n ranks' folds."""
    import numpy as np

    prompts = np.arange(requests * kv_chunks, dtype=np.float64).reshape(
        requests, kv_chunks).sum(-1)
    folds = [n * (n + 1) / 2 * prompts + n * kv_chunks * s * (s + 1) / 2
             for s in range(gen_len)]
    return np.cumsum(np.array(folds).reshape(gen_len, requests), axis=0)


def serving_phase(dev, smi_line):
    """Phase 37: the rest of the serving tier. (a) The port's
    ``traced_kv_dataflow`` on an 8-rank CUDA ``LocalWorld`` at the
    reference's shape on both tiers, exact to the closed form, and at
    full width on the default tier and on the ring tier, every rank's
    tokens within ``KV_RTOL`` of it; the step-0 row sums folded through
    the ring all-reduce, ``torch.equal`` to its plain version with
    credits drained. (b) The serving campaigns on the host, twice each,
    gates green and digests equal. (c) The ring fold's device time.
    Launch counts of (a) are returned (row 7 adds them)."""
    import hashlib

    import numpy as np
    import torch

    import smi_tpu_torch as st
    from smi_tpu_torch.kernels import _build
    from smi_tpu_torch.kernels import ring as kring
    from smi_tpu_torch.serving import campaign as SC
    from smi_tpu_torch.serving import moe as SM
    from smi_tpu_torch.serving.inference import traced_kv_dataflow

    log(f"[37 the serving tier: traced_kv_dataflow on {SMI_RANKS} ranks at "
        f"{KV_REF_SHAPE} and at {KV_REQUESTS}x{KV_CHUNKS}, {KV_GEN} steps, "
        f"on both tiers; the serving campaigns on the host]")
    log(f"  {smi_line}")
    world = st.LocalWorld(SMI_RANKS)
    torch.cuda.synchronize()
    _build.reset_launches()

    # ---- (a) the dataflow on the card --------------------------------
    def dataflow(shape, backend):
        requests, kv_chunks, gen_len = shape
        t0 = time.perf_counter()
        outs = world.run(lambda c: traced_kv_dataflow(
            c, requests=requests, kv_chunks=kv_chunks, gen_len=gen_len,
            backend=backend))
        wall = time.perf_counter() - t0
        want = kv_closed_form(SMI_RANKS, *shape)
        worst = 0.0
        for r, (tokens, record) in enumerate(outs):
            if tuple(tokens.shape) != (gen_len, requests) or \
                    tokens.dtype != torch.float32 or \
                    tokens.device.type != "cuda" or \
                    not torch.isfinite(tokens).all():
                raise AssertionError(f"{backend} {shape}: rank {r}'s tokens "
                                     f"{tuple(tokens.shape)} {tokens.dtype}")
            if len(record.splitlines()) != gen_len or \
                    f"backend={backend}" not in record:
                raise AssertionError(f"{backend} {shape}: rank {r}'s record "
                                     f"{record!r}")
            got = tokens.double().cpu().numpy()
            worst = max(worst, float((np.abs(got - want) / want).max()))
        return outs, wall, worst

    for backend in ("xla", "ring"):
        outs, wall, worst = dataflow(KV_REF_SHAPE, backend)
        if worst != 0.0:
            raise AssertionError(f"the reference shape on {backend}: tokens "
                                 f"off the closed form by {worst}")
        log(f"  {KV_REF_SHAPE} on {backend}: every rank's tokens equal to "
            f"the float64 closed form; {wall * 1e3:.3f} ms of host wall")
    walls = {}
    for backend in ("xla", "ring"):
        outs, wall, worst = dataflow((KV_REQUESTS, KV_CHUNKS, KV_GEN),
                                     backend)
        if worst > KV_RTOL:
            raise AssertionError(f"the wide dataflow on {backend}: tokens "
                                 f"{worst:.3g} from the closed form, over "
                                 f"{KV_RTOL:g}")
        walls[backend] = wall
        spread = max((t - outs[0][0]).abs().max().item() for t, _ in outs)
        log(f"  {KV_REQUESTS}x{KV_CHUNKS}, {KV_GEN} steps on {backend}: "
            f"every rank's tokens within {worst:.3g} (relative) of the "
            f"closed form, bar {KV_RTOL:g}; ranks differ by at most "
            f"{spread:g}; {wall * 1e3:.3f} ms of host wall for the call on "
            f"{SMI_RANKS} ranks; {smi_line}")
        del outs
    prompts = torch.arange(KV_REQUESTS * KV_CHUNKS, dtype=torch.float32,
                           device=dev).reshape(KV_REQUESTS, KV_CHUNKS)
    rows = [(prompts * float(r + 1)).sum(-1) for r in range(SMI_RANKS)]
    del prompts
    got = world.run(lambda c: st.allreduce(rows[c.rank], c, backend="ring"))
    record = kring.last_record(world)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    want = kring.ring_all_reduce_plain(rows)
    for r, (g, w) in enumerate(zip(got, want)):
        if not torch.equal(g, w):
            err = (g.double() - w.double()).abs().max().item()
            raise AssertionError(f"the ring fold: rank {r} != its plain "
                                 f"version, max abs err {err}")
    if not kring.drained(record):
        raise AssertionError(f"the ring fold's credits did not drain: "
                             f"granted {int(record['granted'].sum())}, "
                             f"consumed {int(record['consumed'].sum())}")
    expected = KV_REF_SHAPE[2] + KV_GEN + 1
    if launches["ring_all_reduce"] != expected or \
            launches["ring_all_reduce_chunked"] != 0:
        raise AssertionError(f"phase 37 launches {launches}, expected "
                             f"{expected} of ring_all_reduce")
    log(f"  the step-0 row sums ({KV_REQUESTS} f32 a rank) through "
        f"allreduce(backend='ring'): torch.equal to ring_all_reduce_plain "
        f"on every rank, credits drained ({int(record['granted'].sum())} "
        f"granted); launches {launches}")
    del got, want

    # ---- (b) the campaigns on the host -------------------------------
    for name, reference in SERVING_CAMPAIGNS.items():
        run = getattr(SC, name, None) or getattr(SM, name)
        digests, seconds = [], []
        for _ in range(2):
            t0 = time.perf_counter()
            report = run(seed=0)
            seconds.append(time.perf_counter() - t0)
            if report.get("ok") is not True or report.get("failures"):
                raise AssertionError(f"{name}(seed=0) failed its gates: "
                                     f"{report.get('verdict')} "
                                     f"{report.get('failures')}")
            digests.append(hashlib.sha256(json.dumps(
                report, sort_keys=True).encode()).hexdigest())
        if digests[0] != digests[1]:
            raise AssertionError(f"{name}(seed=0): two runs' digests differ")
        if digests[0] != reference:
            raise AssertionError(f"{name}(seed=0): digest {digests[0]} is "
                                 f"not the JAX package's {reference}")
        cells = report.get("cells", 1)
        log(f"  {name}(seed=0): gates green, {cells} cell(s), digest "
            f"{digests[0][:16]} on both runs, the JAX package's; "
            f"{seconds[0] * 1e3:.1f} and {seconds[1] * 1e3:.1f} ms of host "
            f"wall")
    log(f"  left out, as they need networkx: {'; '.join(SERVING_NETWORKX)}")

    # ---- (c) the ring fold's device time -----------------------------
    fold = ring_kernel_ms(world, lambda c: kring.ring_all_reduce(
        rows[c.rank], c))
    nbytes = 2 * 4 * KV_REQUESTS * SMI_RANKS
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"  the ring fold of {KV_REQUESTS} f32 a rank on {SMI_RANKS} ranks: "
        f"{fold.ms:.4f} ms of device time (launch through the wrapper "
        f"{fold.launch_ms:.4f} ms), bound {bound:.4f} ms (bytes: every "
        f"rank's row sums read once and its fold written once); the "
        f"dataflow's host wall {walls['xla'] * 1e3:.3f} ms on the default "
        f"tier and {walls['ring'] * 1e3:.3f} ms on the ring, {KV_GEN} folds "
        f"each; {smi_line}")
    return launches



#: phase 38: the CLI's app (tests/test_cli.py's transfer -> reduce(max)
#: -> bcast program) written against the port's package
CLI_APP = '''\
import smi_tpu_torch as smi

def kernel(ctx, x):
    ch = ctx.open_channel(port=0, src=0, dst=1, count=64, dtype="float",
                          buffer_size=17)
    got = ctx.transfer(ch, x)
    r = ctx.reduce(got, op="max", port=1)
    return ctx.bcast(r, root=0, port=2)
'''
CLI_APP_REPS = 5
#: the app's launches on the ring tier: the transfer's one hop, then the
#: reduce and the bcast
CLI_APP_LAUNCHES = {"ring_neighbour_stream": 1, "ring_all_reduce": 2}


def cli_phase(dev, smi_line):
    """Phase 38: the command line. ``python -m smi_tpu_torch`` once as a
    subprocess (``topology -n 8``), then in-process ``build`` (manifest ->
    route -> device -> host) of the CLI's app with ``--report``; the
    generated host module bootstraps the 8 ranks from the written tables
    and the generated device module's symbols run the app on an 8-rank
    ``LocalWorld`` of the card at ``SMI_ELEMS`` f32 a rank on both tiers,
    ``torch.equal`` across tiers and to ``max(x, 0)`` on every rank,
    credits drained; each ring launch of the app replayed against its
    plain version and timed; ``aot-verify`` (every source built for sm_90a, every
    case of the JAX surface fitting, the ring kernels' ptxas-derived
    blocks an SM equal to the runtime's); ``lint --combined`` and
    ``serve --selftest``. Each command's wall time is logged. Returns the
    launches of the app and the report (rows 5 and 7 add them)."""
    import importlib.util
    import os

    import torch

    import smi_tpu_torch as st
    import smi_tpu_torch.__main__ as cli
    from smi_tpu_torch.kernels import _build
    from smi_tpu_torch.kernels import ring as kring
    from smi_tpu_torch.ops.types import SmiOp
    from smi_tpu_torch.utils import native

    log(f"[38 the command line: python -m smi_tpu_torch; build --report of "
        f"the CLI's app on {SMI_RANKS} ranks; the generated modules at "
        f"{SMI_ELEMS} f32 a rank on both tiers; aot-verify; lint; serve]")
    log(f"  {smi_line}")
    root = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(root, "build", "cli")
    os.makedirs(work, exist_ok=True)
    cluster = os.path.join(work, "cluster.json")
    app_py = os.path.join(work, "app.py")
    with open(app_py, "w") as f:
        f.write(CLI_APP)
    walls = {}

    def command(name, argv):
        """``cli.main(argv)``, its output kept in ``build/cli/<name>.log``
        and its last line logged."""
        text = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(text):
            rc = cli.main(argv)
        walls[name] = time.perf_counter() - t0
        path = os.path.join(work, name.split()[0] + ".log")
        with open(path, "w") as f:
            f.write(text.getvalue())
        last = (text.getvalue().strip().splitlines() or [""])[-1]
        log(f"  {name}: exit {rc} in {walls[name]:.3f} s; last line "
            f"{last!r} (the whole output in {os.path.relpath(path, root)})")
        if rc != 0:
            raise AssertionError(f"python -m smi_tpu_torch {' '.join(argv)} "
                                 f"exited {rc}")
        return rc

    # ---- (a) the entry point as a subprocess -------------------------
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "smi_tpu_torch", "topology", "-n",
         str(SMI_RANKS), "-p", "app", "-f", cluster],
        cwd=root, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=root))
    walls["python -m smi_tpu_torch topology"] = time.perf_counter() - t0
    if proc.returncode != 0 or not os.path.isfile(cluster):
        raise AssertionError(f"python -m smi_tpu_torch topology failed: "
                             f"{proc.returncode} {proc.stderr[-2000:]}")
    log(f"  native runtime in use: {native.native_available()} "
        f"({native.runtime_version()}); manifest tool "
        f"{native.manifest_tool()}")

    # ---- (b) build with --report --------------------------------------
    out = os.path.join(work, "app")
    command("build --report", ["build", cluster, app_py, "-o", out,
                               "--report"])
    with open(os.path.join(out, "report.json")) as f:
        report = json.load(f)
    got = [(e["op"], e["kernels"]) for e in report["operations"]]
    want = [("push", {"ring_neighbour_stream": 1}),
            ("reduce", {"ring_all_reduce": 1}),
            ("broadcast", {"ring_all_reduce": 1})]
    if got != want or report["comm_size"] != SMI_RANKS:
        raise AssertionError(f"build --report: {got} on "
                             f"{report['comm_size']} ranks, expected {want}")
    for e in report["operations"]:
        for kernel, figs in e["figures"].items():
            if figs["registers"] is None or figs["registers"] > 64:
                raise AssertionError(f"build --report: {kernel}'s figures "
                                     f"{figs}")
        log(f"  report {e['op']} port {e['port']} {e['dtype']}: "
            f"{e['kernels']}, {e['bytes']} B, figures {e['figures']}, "
            f"{e['predicted_us']} us at 3.35 TB/s")
    report_launches = {}
    for e in report["operations"]:
        for kernel, n in e["kernels"].items():
            report_launches[kernel] = report_launches.get(kernel, 0) + n

    # ---- (c) the generated modules -----------------------------------
    def load(name):
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(out, name + ".py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    host, dev_mod = load("smi_generated_host"), load("smi_generated_device")
    routes = os.path.join(out, "smi-routes")
    world, program = host.SmiInit_app(rank=0, ranks=SMI_RANKS,
                                      routing_dir=routes)
    for rank in range(1, SMI_RANKS):
        if native.bootstrap_rank(routes, rank, 4, SMI_RANKS) < \
                program.logical_port_count:
            raise AssertionError(f"rank {rank}'s tables are undersized")
    if not isinstance(world, st.LocalWorld) or world.size != SMI_RANKS \
            or world.device.type != dev.type:
        raise AssertionError(f"SmiInit_app returned {world!r}")
    log(f"  SmiInit_app: a {world.size}-rank LocalWorld on {world.device}, "
        f"{program.logical_port_count} ports, every rank's tables valid")

    def app_for(backend):
        @st.smi_kernel(world, in_specs=None, out_specs="smi",
                       program=dev_mod.PROGRAM, backend=backend)
        def app(ctx, v):
            ch = dev_mod.SMI_Open_send_channel_0_float(
                ctx, src=0, dst=1, count=v.shape[0])
            got = dev_mod.SMI_Push_0_float(ctx, ch, v)
            r = dev_mod.SMI_Reduce_1_int(ctx, got, root=0)
            return dev_mod.SMI_Bcast_2_int(ctx, r, root=0)[None]
        return app

    gen = torch.Generator(device=dev).manual_seed(SEED + 38)
    x = torch.randn(SMI_ELEMS, generator=gen, device=dev)
    outs, app_ms = {}, {}
    for backend in ("xla", "ring"):
        app = app_for(backend)
        torch.cuda.synchronize()
        _build.reset_launches()
        outs[backend] = app(x)
        torch.cuda.synchronize()
        launched = {k: v for k, v in _build.LAUNCHES.items() if v}
        if backend == "ring":
            app_launches = dict(_build.LAUNCHES)
            record = kring.last_record(world)
            if launched != CLI_APP_LAUNCHES:
                raise AssertionError(f"the app on the ring tier launched "
                                     f"{launched}, expected "
                                     f"{CLI_APP_LAUNCHES}")
            if not kring.drained(record):
                raise AssertionError("the app's last ring launch did not "
                                     "drain its credits")
        elif launched:
            raise AssertionError(f"the default tier launched {launched}")
        walls_ms = []
        for _ in range(CLI_APP_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            app(x)
            torch.cuda.synchronize()
            walls_ms.append((time.perf_counter() - t0) * 1e3)
        app_ms[backend] = sorted(walls_ms)[len(walls_ms) // 2]
    want = x.clamp(min=0).expand(SMI_RANKS, -1)
    if tuple(outs["ring"].shape) != (SMI_RANKS, SMI_ELEMS) or \
            not torch.equal(outs["ring"], outs["xla"]) or \
            not torch.equal(outs["ring"], want):
        err = (outs["ring"] - want).abs().max().item()
        raise AssertionError(f"the app: ring != default tier or max(x, 0), "
                             f"max abs err {err}")
    log(f"  the app at {SMI_ELEMS} f32 a rank: ring tier torch.equal to the "
        f"default tier and to max(x, 0) on all {SMI_RANKS} ranks; launches "
        f"{CLI_APP_LAUNCHES}, credits drained; median host wall of "
        f"{CLI_APP_REPS} calls {app_ms['xla']:.3f} ms on the default tier, "
        f"{app_ms['ring']:.3f} ms on the ring; {smi_line}")

    # each ring launch of the app against its plain version (not counted)
    xs = [x[None] if r == 0 else torch.zeros_like(x[None])
          for r in range(SMI_RANKS)]
    got = world.run(lambda c: kring.neighbour_stream(xs[c.rank], c))
    for r, (g, w) in enumerate(zip(got, kring.neighbour_stream_plain(xs,
                                                                     1))):
        if not torch.equal(g, w):
            raise AssertionError(f"the app's stream: rank {r} != plain")
    if not kring.drained(kring.last_record(world)):
        raise AssertionError("the app's stream did not drain its credits")
    parts = [g[0] for g in got]
    for op in (SmiOp.MAX, SmiOp.ADD):
        got = world.run(lambda c: kring.ring_all_reduce(
            parts[c.rank], c, op=op, chunks=1))
        for r, (g, w) in enumerate(zip(got, kring.ring_all_reduce_plain(
                parts, op))):
            if not torch.equal(g, w):
                raise AssertionError(f"the app's {op} all-reduce: rank {r} "
                                     f"!= plain")
        if not kring.drained(kring.last_record(world)):
            raise AssertionError(f"the app's {op} all-reduce did not drain")
    log("  the app's stream and its MAX and ADD all-reduces at the app's "
        "shapes: torch.equal to their plain versions, credits drained")
    # their device time (behind a wait, the median of the replays) beside
    # the bound: every rank's input read once and output written once
    bound = 2 * 4 * SMI_ELEMS * SMI_RANKS / HBM_BYTES_PER_S * 1e3
    for name, fn in (
            ("stream", lambda c: kring.neighbour_stream(xs[c.rank], c)),
            ("MAX all-reduce", lambda c: kring.ring_all_reduce(
                parts[c.rank], c, op=SmiOp.MAX, chunks=1))):
        t = ring_kernel_ms(world, fn)
        log(f"  the app's {name}: {t.ms:.4f} ms of device time, one launch "
            f"through the wrapper {t.launch_ms:.4f} ms, bound {bound:.4f} "
            f"ms (bytes); {smi_line}")
    del outs, xs, parts, got, want

    # ---- (d) aot-verify ----------------------------------------------
    aot_json = os.path.join(work, "AOT_H100.json")
    command("aot-verify", ["aot-verify", "-o", aot_json])
    with open(aot_json) as f:
        aot = json.load(f)
    if not aot["ok"]:
        raise AssertionError(f"aot-verify: {aot}")
    occupancy = {}
    for topo, entry in aot["topologies"].items():
        programs = entry["programs"]
        launches = [l for p in programs.values() for l in p["launches"]]
        for l in launches:
            if l["cooperative"] or l["kernel"] == "stencil_temporal":
                if l.get("runtime_blocks_per_sm") != l["blocks_per_sm"]:
                    raise AssertionError(f"aot-verify {topo}: {l}")
            if l["cooperative"]:
                key = (l["kernel"], l["dtype"], l["op"])
                occupancy[key] = (l["registers"], l["blocks_per_sm"],
                                  l["runtime_blocks_per_sm"],
                                  l["resident_blocks"])
            elif l["kernel"] == "stencil_temporal":
                key = (l["kernel"], "float32", f"k={l['k']}")
                occupancy[key] = (l["registers"], l["blocks_per_sm"],
                                  l["runtime_blocks_per_sm"],
                                  l["blocks_per_sm"] * l["threads"] // 32)
        most = max((l["smem"] for l in launches), default=0)
        log(f"  aot-verify {topo} ({entry['devices']} ranks): "
            f"{len(programs)} cases fit, {len(launches)} distinct launches, "
            f"the most shared memory a block {most} B of "
            f"{_build.SMEM_BYTES_LIMIT} B")
    for (kernel, dtype, op), (regs, ptxas, runtime, resident) in sorted(
            occupancy.items(), key=str):
        held = ("warps an SM" if kernel == "stencil_temporal"
                else "resident")
        log(f"  {kernel} {dtype} op {op}: {regs} registers, {ptxas} blocks "
            f"an SM by the ptxas figures, {runtime} by the runtime, "
            f"{resident} {held}")
    log(f"  sources built: " + ", ".join(
        f"{name} ({len(src['instances'])} instances)"
        for name, src in aot["sources"].items()))

    # ---- (e) lint and serve ------------------------------------------
    command("lint --combined", ["lint", "--combined", "-o",
                                os.path.join(work, "lint.json")])
    command("serve --selftest", ["serve", "--selftest", "-o",
                                 os.path.join(work, "serve.json")])
    log("  " + "; ".join(f"{name}: {s:.3f} s" for name, s in walls.items())
        + f"; {smi_line}")
    launches = {k: app_launches.get(k, 0) + report_launches.get(k, 0)
                for k in RING_REPLACES}
    log(f"  launches (the app and the report): {launches}")
    return launches


GLUE_SRC = "smi_tpu_torch/kernels/csrc/attn_glue.cu"
#: phase 39: trinity-train-2x8k's attention: 2 x 8192 tokens, 32 query and
#: 4 key/value heads of 128; its norm eps and rotary base
GLUE_CELL = dict(b=2, s=8192, h=32, kv=4, d=128)
GLUE_EPS = 1e-5
GLUE_THETA = 10000.0
#: phase 39: the step whose launches are read, Trinity-Mini's layer
#: pattern (three windowed layers, then a full one; two dense layers,
#: then expert layers) at a small width: heads of 64, GQA 4:1, 2 x 256
#: tokens
GLUE_STEP_MODEL = {
    "model_type": "afmoe", "num_hidden_layers": 32, "num_dense_layers": 2,
    "hidden_size": 256,
    "num_attention_heads": 4, "num_key_value_heads": 1, "head_dim": 64,
    "layer_types": (["sliding_attention"] * 3 + ["full_attention"]) * 8,
    "sliding_window": 64, "intermediate_size": 384,
    "moe_intermediate_size": 64, "num_experts": 4, "num_experts_per_tok": 2,
    "num_shared_experts": 1, "route_scale": 1.0, "route_norm": True,
    "score_func": "sigmoid", "rms_norm_eps": GLUE_EPS,
    "rope_theta": GLUE_THETA, "mup_enabled": True, "vocab_size": 512,
    "tie_word_embeddings": False,
}
#: phase 39: a 32-layer step's launches: each forward kernel in the
#: forward and in its recompute, each backward kernel once a layer; the
#: residual junctions three a layer, and the head's final norm once
GLUE_STEP_LAUNCHES = {"attn_prologue": 64, "attn_epilogue": 64,
                      "attn_prologue_bwd": 32, "attn_epilogue_bwd": 32,
                      "residual_norm": 3 * 32 * 2 + 1,
                      "residual_norm_bwd": 3 * 32 + 1}


def glue_phase(dev):
    """Phase 39: the afmoe attention glue kernels against their plain
    versions at ``GLUE_CELL``, their launches in one step of
    ``GLUE_STEP_MODEL`` (with the residual junctions') and their times
    beside their byte bounds. Returns their records for the kernels line
    and the step's launches."""
    import torch

    import smi_tpu_torch as st
    from smi_tpu_torch.kernels import _build
    from smi_tpu_torch.kernels import attn_glue as glue
    from smi_tpu_torch.models import transformer as ttf

    bf16 = torch.bfloat16
    b, s, h, kv, d = (GLUE_CELL[k] for k in ("b", "s", "h", "kv", "d"))
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).to(bf16)

    def leaves(*ts):
        return [t.detach().clone().requires_grad_() for t in ts]

    def ulps(got, want):
        """The largest distance in bf16 steps and the share of elements
        apart (signed values ordered as integers)."""
        def ordered(t):
            i = t.contiguous().view(torch.int16).int()
            return torch.where(i < 0, -(i & 0x7FFF), i)

        apart = (ordered(got) - ordered(want)).abs()
        return int(apart.max()), float((apart > 0).double().mean())

    def rel(got, want):
        return float((got.double() - want.double()).norm()
                     / want.double().norm())

    def hold(what, got, want, control):
        """``got`` within one bf16 step of ``want`` and ``control`` (a
        wrong kernel's output) outside it; the largest abs error."""
        got, want, control = got.detach(), want.detach(), control.detach()
        apart, share = ulps(got, want)
        wrong, _ = ulps(control, want)
        if apart > 1:
            raise AssertionError(f"{what}: {apart} bf16 steps from the "
                                 f"plain version")
        if wrong <= 1:
            raise AssertionError(f"{what}: the control passes the bar")
        log(f"  {what}: within 1 bf16 step ({100 * share:.4f} % of "
            f"elements 1 step apart; control {wrong} steps)")
        return float((got.float() - want.float()).abs().max())

    def twice(what, grads, again):
        for g, g2 in zip(grads, again):
            if not torch.equal(g, g2):
                raise AssertionError(f"{what}: two runs differ")

    log(f"[39 afmoe attention glue vs plain] B={b} S={s} H={h} KV={kv} "
        f"D={d}, windowed (rotary tables) and full")
    _build.build_kernels(["attn_glue"])
    records, errs = [], {}

    # ---- the prologue, on a windowed and a full layer -----------------
    qkv = randn(b * s, (h + 2 * kv) * d, scale=1.5)
    qn = torch.rand(d, generator=gen, device=dev) + 0.5
    kn = torch.rand(d, generator=gen, device=dev) + 0.5
    times = {}
    for kind in ("sliding", "full"):
        rope = (ttf._rope_tables(s, d, 0, GLUE_THETA, dev)
                if kind == "sliding" else None)
        got_in, want_in = leaves(qkv, qn, kn), leaves(qkv, qn, kn)
        got = glue.attn_prologue(*got_in, b, h, kv, GLUE_EPS, rope)
        want = glue.attn_prologue_plain(*want_in, b, h, kv, GLUE_EPS, rope)
        control = glue.attn_prologue_plain(qkv, kn, qn, b, h, kv, GLUE_EPS,
                                           rope)
        errs[("attn_prologue", kind)] = max(
            hold(f"{kind} {name}", g, w, c)
            for name, g, w, c in zip("qk", got, want, control))
        if not torch.equal(got[2], want[2]):
            raise AssertionError(f"{kind} v: not the plain version's bits")
        cot = [randn(*t.shape) for t in got]
        grads = torch.autograd.grad(got, got_in, cot, retain_graph=True)
        again = torch.autograd.grad(got, got_in, cot, retain_graph=True)
        wants = torch.autograd.grad(want, want_in, cot, retain_graph=True)
        twice(f"{kind} prologue backward", grads, again)
        for name, g, w, bar in zip(("d qkv", "d q_norm", "d k_norm"),
                                   grads, wants, (2.0 ** -8, 1e-3, 1e-3)):
            r = rel(g, w)
            if r > bar:
                raise AssertionError(f"{kind} {name}: relative error {r} "
                                     f"above {bar}")
            log(f"  {kind} {name}: relative error {r:.3e} (bar {bar:g})")
        errs[("attn_prologue_bwd", kind)] = float(
            (grads[0].float() - wants[0].float()).abs().max())
        # the backward timed on this thread (autograd runs it on its
        # device thread), and held to autograd's gradients
        ctx = types.SimpleNamespace(
            saved_tensors=(qkv, qn, kn) + (rope or (None, None)),
            shape=(b, h, kv, GLUE_EPS))
        backward = functools.partial(glue._Prologue.backward, ctx, *cot)
        if not all(torch.equal(g, g2) for g, g2 in zip(grads, backward())):
            raise AssertionError(f"{kind} prologue backward: the direct "
                                 f"call differs from autograd's")
        with torch.no_grad():
            times[("attn_prologue", kind)] = (
                timed(lambda: glue.attn_prologue(qkv, qn, kn, b, h, kv,
                                                 GLUE_EPS, rope), 50),
                timed(lambda: glue.attn_prologue_plain(
                    qkv, qn, kn, b, h, kv, GLUE_EPS, rope)))
        times[("attn_prologue_bwd", kind)] = (
            timed(backward, 50),
            timed(lambda: torch.autograd.grad(want, want_in, cot,
                                              retain_graph=True)))
        del got, want, control, grads, again, wants, cot
    tables = 2 * s * d * 4
    prologue_bytes = 2 * qkv.numel() * qkv.element_size()
    nbytes = {("attn_prologue", "sliding"): prologue_bytes + tables,
              ("attn_prologue", "full"): prologue_bytes,
              ("attn_prologue_bwd", "sliding"): 1.5 * prologue_bytes
              + tables,
              ("attn_prologue_bwd", "full"): 1.5 * prologue_bytes}
    del qkv

    # ---- the epilogue ---------------------------------------------------
    heads_major = randn(b * h, s, d)
    gate = randn(b * s, h * d, scale=3.0)
    got_in, want_in = leaves(heads_major, gate), leaves(heads_major, gate)
    got = glue.attn_epilogue(got_in[0].transpose(0, 1), got_in[1], b, h)
    want = glue.attn_epilogue_plain(want_in[0].transpose(0, 1), want_in[1],
                                    b, h)
    control = glue.attn_epilogue_plain(heads_major.transpose(0, 1), -gate,
                                       b, h)
    errs[("attn_epilogue", "")] = hold("gated output", got, want, control)
    cot = randn(*got.shape)
    grads = torch.autograd.grad([got], got_in, [cot], retain_graph=True)
    again = torch.autograd.grad([got], got_in, [cot], retain_graph=True)
    wants = torch.autograd.grad([want], want_in, [cot], retain_graph=True)
    twice("epilogue backward", grads, again)
    controls = torch.autograd.grad(
        [glue.attn_epilogue_plain(want_in[0].transpose(0, 1), -want_in[1],
                                  b, h)], want_in, [cot])
    errs[("attn_epilogue_bwd", "")] = max(
        hold(name, g, w, c)
        for name, g, w, c in zip(("d attn", "d gate"), grads, wants,
                                 controls))
    ctx = types.SimpleNamespace(saved_tensors=(heads_major, gate),
                                shape=(b, h))
    backward = functools.partial(glue._Epilogue.backward, ctx, cot)
    if not all(torch.equal(g, g2) for g, g2 in zip(
            (grads[0].transpose(0, 1), grads[1]), backward())):
        raise AssertionError("epilogue backward: the direct call differs "
                             "from autograd's")
    with torch.no_grad():
        times[("attn_epilogue", "")] = (
            timed(lambda: glue.attn_epilogue(heads_major.transpose(0, 1),
                                             gate, b, h), 50),
            timed(lambda: glue.attn_epilogue_plain(
                heads_major.transpose(0, 1), gate, b, h)))
    times[("attn_epilogue_bwd", "")] = (
        timed(backward, 50),
        timed(lambda: torch.autograd.grad([want], want_in, [cot],
                                          retain_graph=True)))
    attn_bytes = gate.numel() * gate.element_size()
    nbytes[("attn_epilogue", "")] = 3 * attn_bytes
    nbytes[("attn_epilogue_bwd", "")] = 5 * attn_bytes
    del heads_major, gate, got, want, control, grads, again, wants
    del controls, cot

    # ---- the launches of one 32-layer afmoe step ----------------------
    comm = st.make_communicator(shape=(1, 1), axis_names=("dp", "sp"),
                                device=dev)
    model = ttf.LanguageModel.from_config(GLUE_STEP_MODEL, device=dev,
                                          seed=SEED)
    step = ttf.make_train_step(comm, model.config, layers=len(model.blocks))
    cpu_gen = torch.Generator().manual_seed(SEED)
    ids, labels = (torch.randint(0, GLUE_STEP_MODEL["vocab_size"], (2, 256),
                                 generator=cpu_gen).to(dev) for _ in "ab")
    step(model, ids, labels)
    torch.cuda.synchronize()
    for k in GLUE_STEP_LAUNCHES:
        _build.LAUNCHES[k] = 0
    loss = float(step(model, ids, labels))
    torch.cuda.synchronize()
    launches = {k: _build.LAUNCHES[k] for k in GLUE_STEP_LAUNCHES}
    log(f"  one step of the {GLUE_STEP_MODEL['num_hidden_layers']}-layer "
        f"afmoe model (loss {loss:.4f}): launches {launches}")
    if launches != GLUE_STEP_LAUNCHES:
        raise AssertionError(f"the step launched {launches}, expected "
                             f"{GLUE_STEP_LAUNCHES}")
    del model, step

    # ---- the times --------------------------------------------------
    for (kernel, kind), (ms, plain_ms) in times.items():
        b_ms = nbytes[(kernel, kind)] / HBM_BYTES_PER_S * 1e3
        name = (f"{kernel}{' ' + kind if kind else ''} B={b} S={s} H={h} "
                f"KV={kv} D={d} [32-layer afmoe step]")
        log(f"  {name}: {ms:.4f} ms, bound {b_ms:.4f} ms "
            f"({nbytes[(kernel, kind)] / 1e6:.1f} MB; {100 * b_ms / ms:.1f} "
            f"%), plain {plain_ms:.4f} ms")
        records.append({
            "name": name, "route": "cuda", "source": GLUE_SRC,
            "replaces": None, "launches": launches[kernel],
            "max_abs_err": errs[(kernel, kind)], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": "bytes",
            "library_ms": plain_ms, "earlier_ms": None,
        })
    return records, launches


JUNCTION_SRC = "smi_tpu_torch/kernels/csrc/residual_norm.cu"
#: phase 40: trinity-train-2x8k's residual stream, 2 x 8192 tokens of 2048
JUNCTION_CELL = dict(t=2 * 8192, e=2048)


def junction_phase(dev, step_launches):
    """Phase 40: the afmoe residual junction kernels against their plain
    versions at ``JUNCTION_CELL``, each form each way, and their times
    beside their byte bounds; ``step_launches``: the launches of phase
    39's step. Returns their records for the kernels line."""
    import torch

    from smi_tpu_torch.kernels import _build
    from smi_tpu_torch.kernels import residual_norm as rn

    f32, bf16 = torch.float32, torch.bfloat16
    t, e = JUNCTION_CELL["t"], JUNCTION_CELL["e"]
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def randn(dtype, scale=1.0, shift=0.0):
        return (torch.randn(t, e, generator=gen, device=dev) * scale
                + shift).to(dtype)

    def rel(got, want):
        return float((got.double() - want.double()).norm()
                     / want.double().norm())

    def apart(got, want):
        """Whether ``got`` is off ``want`` by the outputs' bar: for bf16
        more than one bf16 step and 1e-5, for f32 1e-6 by norm; the
        largest abs error and the share of elements off."""
        err = (got.float() - want.float()).abs()
        if got.dtype != bf16:
            return rel(got, want) > 1e-6, float(err.max()), 0.0

        def ordered(v):
            i = v.contiguous().view(torch.int16).int()
            return torch.where(i < 0, -(i & 0x7FFF), i)

        ulps = (ordered(got) - ordered(want)).abs()
        off = bool(((ulps > 1) & (err > 1e-5)).any())
        return off, float(err.max()), float((ulps > 0).double().mean())

    def call(fused, form, ins, dtype):
        a, o, p0, p1 = ins
        if form == rn.ENTRY:
            fn = rn.entry_norm if fused else rn.entry_norm_plain
            return fn(a, p0, GLUE_EPS, dtype)
        if form == rn.MIDDLE:
            fn = rn.middle_norm if fused else rn.middle_norm_plain
            return fn(a, o, p0, p1, GLUE_EPS, dtype)
        fn = rn.exit_norm if fused else rn.exit_norm_plain
        return (fn(a, o, p0, GLUE_EPS),)

    log(f"[40 afmoe residual junctions vs plain] T={t} E={e}: entry, "
        f"middle (yn bf16, f32), exit, each way")
    _build.build_kernels(["residual_norm"])
    x, h = randn(f32, 2.0), randn(f32, 2.0)
    out_bf16, out_f32 = randn(bf16, 0.3, 0.1), randn(f32, 0.3, 0.1)
    w0 = torch.rand(e, generator=gen, device=dev) + 0.5
    w1 = torch.rand(e, generator=gen, device=dev) + 0.5
    #: (name, form, stream, sublayer output, yn dtype, bytes each way):
    #: each operand read once, each result written once (the rows' 1/rms
    #: and the weights' partial sums left out: < 1 %)
    n = t * e
    forms = (("entry", rn.ENTRY, x, None, bf16, 6 * n, 14 * n),
             ("middle yn bf16", rn.MIDDLE, x, out_bf16, bf16, 12 * n,
              18 * n),
             ("middle yn f32", rn.MIDDLE, x, out_bf16, f32, 14 * n, 20 * n),
             ("exit", rn.EXIT, h, out_f32, f32, 12 * n, 12 * n))
    errs, times = {}, {}
    for name, form, stream, out, dtype, _, _ in forms:
        weights = (w0, w1 if form == rn.MIDDLE else None)
        # the control: the weights swapped, or the one weight reversed
        wrong = ((w1, w0) if form == rn.MIDDLE else (w0.flip(0), None))
        got_in, want_in = ([None if v is None else
                            v.detach().clone().requires_grad_()
                            for v in (stream, out, *weights)]
                           for _ in "ab")
        got = call(True, form, got_in, dtype)
        want = call(False, form, want_in, dtype)
        control = call(False, form, (stream, out, *wrong), dtype)
        worst = 0.0
        # the entry's first output is x passed on, which nothing norms
        normed = range(1 if form == rn.ENTRY else 0, len(got))
        for i, (g, w) in enumerate(zip(got, want)):
            off, err, share = apart(g.detach(), w.detach())
            if off:
                raise AssertionError(f"{name} output {i}: off the plain "
                                     f"version (max abs {err:.3e})")
            if i in normed and not apart(control[i].detach(),
                                         w.detach())[0]:
                raise AssertionError(f"{name} output {i}: the control "
                                     f"passes the bar")
            worst = max(worst, err)
            log(f"  {name} output {i} ({g.dtype}): max abs {err:.3e}, "
                f"{100 * share:.4f} % of elements a bf16 step apart")
        errs[(rn.KERNEL, name)] = worst
        gen_cot = torch.Generator(device=dev).manual_seed(SEED + form)
        cot = [torch.randn(o.shape, generator=gen_cot, device=dev).to(
            o.dtype) for o in want]
        leaves = [v for v in got_in if v is not None]
        grads = torch.autograd.grad(got, leaves, cot, retain_graph=True)
        again = torch.autograd.grad(got, leaves, cot, retain_graph=True)
        wants = torch.autograd.grad(
            want, [v for v in want_in if v is not None], cot,
            retain_graph=True)
        bad_in = [None if v is None else v.detach().clone().requires_grad_()
                  for v in (stream, out, *wrong)]
        controls = torch.autograd.grad(
            call(False, form, bad_in, dtype),
            [v for v in bad_in if v is not None], cot)
        names = [k for k, v in zip(("d x", "d out", "d w0", "d w1"), got_in)
                 if v is not None]
        caught, worst = False, 0.0
        for k, g, g2, w, c in zip(names, grads, again, wants, controls):
            if not torch.equal(g, g2):
                raise AssertionError(f"{name} {k}: two backward runs "
                                     f"differ")
            bar = {"d out": 2.0 ** -8 if g.dtype == bf16 else 1e-5,
                   "d x": 1e-5}.get(k, 1e-3)
            r = rel(g, w)
            if r > bar:
                raise AssertionError(f"{name} {k}: relative error {r} "
                                     f"above {bar}")
            caught |= rel(c, w) > bar
            worst = max(worst, float((g.float() - w.float()).abs().max()))
            log(f"  {name} {k}: relative error {r:.3e} (bar {bar:g}; "
                f"control {rel(c, w):.3e}), twice bit for bit")
        if not caught:
            raise AssertionError(f"{name}: every gradient of the control "
                                 f"passes its bar")
        errs[(rn.KERNEL_BWD, name)] = worst
        with torch.no_grad():
            plain_fwd = timed(lambda: call(False, form, want_in, dtype))
        plain_bwd = timed(lambda: torch.autograd.grad(
            want, [v for v in want_in if v is not None], cot,
            retain_graph=True))
        times[name] = (plain_fwd, plain_bwd)
        del got, want, control, grads, again, wants, controls, cot

    # each kernel alone: its launches back to back, as the wrappers make
    # them (the backward with its weight-gradient sum)
    rstd = torch.empty(2, t, device=dev)
    blocks = rn.launch_blocks(rn.KERNEL_BWD, t)
    partial = torch.empty(blocks, 2, e, device=dev)
    dw = torch.empty(2, e, device=dev)
    dres, dx = randn(f32), torch.empty(t, e, device=dev)
    records = []
    for name, form, stream, out, dtype, fwd_bytes, bwd_bytes in forms:
        yn_bf16 = int(dtype == bf16)
        w1_ = w1 if form == rn.MIDDLE else None
        y0 = torch.empty(t, e, device=dev,
                         dtype=bf16 if form == rn.ENTRY else f32)
        y1 = (torch.empty(t, e, device=dev, dtype=dtype)
              if form == rn.MIDDLE else None)
        dy = None if form == rn.EXIT else randn(dtype)
        dout = None if form == rn.ENTRY else torch.empty_like(out)

        def fwd():
            _build.launch(rn.KERNEL, dev, stream, out, w0, w1_, y0, y1,
                          rstd, form, yn_bf16, t, e, GLUE_EPS)

        def bwd():
            _build.launch(rn.KERNEL_BWD, dev,
                          None if form == rn.EXIT else stream, out, w0, w1_,
                          rstd, dres, dy, None if form == rn.EXIT else dx,
                          dout, partial, dw, form, yn_bf16, t, e, blocks)

        for kernel, fn, nbytes, plain_ms in (
                (rn.KERNEL, fwd, fwd_bytes, times[name][0]),
                (rn.KERNEL_BWD, bwd, bwd_bytes, times[name][1])):
            ms = time_ms(fn, 50)
            b_ms = nbytes / HBM_BYTES_PER_S * 1e3
            label = (f"{kernel} {name} T={t} E={e} [32-layer afmoe step]")
            log(f"  {label}: {ms:.4f} ms, bound {b_ms:.4f} ms "
                f"({nbytes / 1e6:.1f} MB; {100 * b_ms / ms:.1f} %), plain "
                f"{plain_ms:.4f} ms")
            records.append({
                "name": label, "route": "cuda", "source": JUNCTION_SRC,
                "replaces": None, "launches": step_launches[kernel],
                "max_abs_err": errs[(kernel, name)], "ms": ms,
                "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": "bytes",
                "library_ms": None, "earlier_ms": None,
            })
    # a step of the cell: each form's launches in Trinity-Mini's pattern
    layers = GLUE_STEP_MODEL["num_hidden_layers"]
    dense = GLUE_STEP_MODEL["num_dense_layers"]
    each = {"entry": (2 * layers + 1, layers + 1),
            "middle yn bf16": (2 * dense, dense),
            "middle yn f32": (2 * (layers - dense), layers - dense),
            "exit": (2 * layers, layers)}
    step_ms = step_bound = 0.0
    for i, (name, *_rest) in enumerate(forms):
        for way in (0, 1):
            record = records[2 * i + way]
            step_ms += each[name][way] * record["ms"]
            step_bound += each[name][way] * record["bound_ms"]
    log(f"  the junctions in one step of the cell ({layers} layers, "
        f"{dense} dense): {step_ms:.2f} ms against a bound of "
        f"{step_bound:.2f} ms; launches {sum(w for w, _ in each.values())} "
        f"and {sum(b for _, b in each.values())}")
    return records


#: phase 41: moonlight-train-2x8k's attention, 2 sequences of 8192 with 16
#: heads each, queries and keys 192 wide, values 128, causal
MLA_CELL = dict(s=8192, h=32, d=192, dv=128)
#: phase 41: the model of moonlight-train-2x8k as the cell runs it: all 27
#: layers at Moonlight-16B-A3B's published widths, 8 of the router's 64
#: experts and 20,480 rows of the vocabulary held, a step of 2 x 8192
#: tokens
MLA_STEP_MODEL = {
    "model_type": "deepseek_v3", "num_hidden_layers": 27,
    "first_k_dense_replace": 1, "hidden_size": 2048,
    "num_attention_heads": 16, "num_key_value_heads": 16,
    "kv_lora_rank": 512, "qk_nope_head_dim": 128, "qk_rope_head_dim": 64,
    "v_head_dim": 128, "intermediate_size": 11264,
    "moe_intermediate_size": 1408, "n_routed_experts": 8,
    "router_experts": 64, "num_experts_per_tok": 6, "n_shared_experts": 2,
    "routed_scaling_factor": 2.446, "norm_topk_prob": True,
    "scoring_func": "sigmoid", "rms_norm_eps": 1e-5, "rope_theta": 50000,
    "vocab_size": 20480, "tie_word_embeddings": False,
}
MLA_STEP_TOKENS = (2, 8192)
#: phase 41: the flash launches of one step of MLA_STEP_MODEL: each forward
#: in the forward and in its recompute, each backward once a layer, all of
#: the split form; every other flash count stays 0
MLA_STEP_LAUNCHES = {"flash_fused_192x128": 54, "flash_bwd_dq_192x128": 27,
                     "flash_bwd_dkdv_192x128": 27}


def mla_flash_phase(dev):
    """Phase 41: the flash kernels' split form at ``MLA_CELL`` against
    their plain versions, their times beside their operations bounds and
    SDPA's, and their launches in one step of ``MLA_STEP_MODEL`` counted
    from 0. Returns
    their records for the kernels line."""
    import torch

    import smi_tpu_torch as st
    from smi_tpu_torch.kernels import _build
    from smi_tpu_torch.kernels import flash as kflash

    log("[41 flash split form (192, 128), MLA]")
    torch.backends.cuda.matmul.allow_tf32 = False
    for source in ("flash_fwd", "flash_bwd"):
        current = ""
        for line in _build.build_log(source).splitlines():
            named = re.search(r"(?:entry function|Function properties for)"
                              r"\s+'?([\w$]+)", line)
            if named:
                current = named.group(1)
            elif "192ELi128E" in current and ("registers" in line
                                              or "spill" in line):
                log(f"  {source} {current}: {line.strip()}")

    s, h, d, dv = (MLA_CELL[k] for k in ("s", "h", "d", "dv"))
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def heads(width):
        return torch.randn((h, s, width), generator=gen, device=dev).to(
            torch.bfloat16)

    q, k, dout = heads(d), heads(d), heads(dv)
    v = heads(dv)
    scale = d ** -0.5
    pairs = live_pairs(s, s, 0, 0, True)
    fwd = kflash.flash_attend_fused(q, k, v, 0, 0, True, scale)
    want = kflash.flash_attend_fused_plain(q, k, v, 0, 0, True, scale)
    row_rel = Bars.row_rel
    errs = {"flash_fused": row_rel(fwd[0], want[0])[0]}
    for part, a, b in zip(("m", "l"), fwd[1:], want[1:]):
        if not torch.allclose(a, b, rtol=STAT_TOL, atol=STAT_TOL):
            raise AssertionError(f"split forward {part} off the bar")
    out, m, l = fwd
    del want
    linv, delta = kflash.backward_rows(out, l, dout)
    args = (q, k, v, dout, m, linv, delta, 0, 0, True, scale)
    dq = kflash.flash_block_backward_dq(*args)
    errs["flash_bwd_dq"] = row_rel(
        dq, kflash.flash_block_backward_dq_plain(*args), GRAD_FLOOR)[0]
    dk, dv_ = kflash.flash_block_backward_dkdv(*args)
    want_k, want_v = kflash.flash_block_backward_dkdv_plain(*args)
    errs["flash_bwd_dkdv"] = max(row_rel(dk, want_k, GRAD_FLOOR)[0],
                                 row_rel(dv_, want_v, GRAD_FLOOR)[0])
    del dq, dk, dv_, want_k, want_v
    log(f"  worst row errors {errs} (bar {BF16_ROW_REL})")
    if max(errs.values()) > BF16_ROW_REL:
        raise AssertionError(f"split form off the bf16 bar: {errs}")

    per_pair = {"flash_fused": 2 * (d + dv), "flash_bwd_dq": 4 * d + 2 * dv,
                "flash_bwd_dkdv": 4 * d + 4 * dv}
    calls = {
        "flash_fused": lambda: kflash.flash_attend_fused(q, k, v, 0, 0, True,
                                                         scale),
        "flash_bwd_dq": lambda: kflash.flash_block_backward_dq(*args),
        "flash_bwd_dkdv": lambda: kflash.flash_block_backward_dkdv(*args),
    }
    times = {name: timed(call) for name, call in calls.items()}
    sdpa = {"flash_fused": sdpa_forward(q, k, v, True, None),
            "flash_bwd_dq": sdpa_backward(q, k, v, dout, True, None)}
    sdpa["flash_bwd_dkdv"] = sdpa["flash_bwd_dq"]

    # ---- the launches of one 27-layer step ----------------------------
    from smi_tpu_torch.models import transformer as ttf

    comm = st.make_communicator(shape=(1, 1), axis_names=("dp", "sp"),
                                device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    model = ttf.LanguageModel.from_config(MLA_STEP_MODEL, device=dev,
                                          seed=SEED)
    step = ttf.make_train_step(comm, model.config, layers=len(model.blocks))
    cpu_gen = torch.Generator().manual_seed(SEED)
    ids, labels = (torch.randint(0, MLA_STEP_MODEL["vocab_size"],
                                 MLA_STEP_TOKENS, generator=cpu_gen).to(dev)
                   for _ in "ab")
    step(model, ids, labels)
    torch.cuda.synchronize()
    flash_keys = [n for n in _build.LAUNCHES if n.startswith("flash_")]
    for n in flash_keys:
        _build.LAUNCHES[n] = 0
    loss = float(step(model, ids, labels))
    torch.cuda.synchronize()
    launches = {n: _build.LAUNCHES[n] for n in flash_keys
                if _build.LAUNCHES[n]}
    log(f"  one step of moonlight-train-2x8k's model, "
        f"{MLA_STEP_TOKENS[0]} x {MLA_STEP_TOKENS[1]} tokens (loss "
        f"{loss:.4f}, peak {torch.cuda.max_memory_allocated(dev) / 1e9:.2f}"
        f" GB): launches {launches}")
    if launches != MLA_STEP_LAUNCHES:
        raise AssertionError(f"the step launched {launches}, expected "
                             f"{MLA_STEP_LAUNCHES} and no other flash form")
    del model, step, ids, labels
    torch.cuda.empty_cache()

    records = []
    for name, ms in times.items():
        b_ms = pairs * h * per_pair[name] / BF16_FLOPS * 1e3
        lib_ms, lib_op = sdpa[name]
        label = (f"{name} split S={s} H={h} D={d} Dv={dv} causal bf16 "
                 f"[MLA]")
        log(f"  {label}: {ms:.4f} ms, bound {b_ms:.4f} ms "
            f"({100 * b_ms / ms:.1f} %), SDPA "
            f"{'none' if lib_ms is None else f'{lib_ms:.4f} ms'} ({lib_op})")
        records.append({
            "name": label, "route": "cuda",
            "source": FLASH_SRC if name == "flash_fused" else BWD_SRC,
            "replaces": None,
            "launches": launches.get(kflash.launch_name(name, d, dv), 0),
            "max_abs_err": errs[name], "ms": ms, "plain_ms": None,
            "bound_ms": b_ms, "bound_by": "operations", "library_ms": lib_ms,
            "earlier_ms": None,
        })
    return records


if __name__ == "__main__":
    sys.exit(main())
